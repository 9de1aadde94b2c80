// Spatial (3D) rigid-body rollout for one trajectory: the body of the
// spatial rollout kernel, written once for the device (spatial_rollout.cu)
// and the host (spatial_rollout_host.cpp, a test-only build with g++).
//
// It computes what icem_torch/envs/physics/spatial_batched.py::step_rows
// computes (the plain version), looped over the horizon:
// - once per control step: forward kinematics, the closed-form mass matrix
//   (Jacobian columns w_j x (p - o_j)) and the bias (recursive
//   velocity-product pass + gravity), the +1e-6 diagonal, implicit damping,
//   the Cholesky factor with inverse pivots, and, where the model turns the
//   energy valve on, the stored energy of the start state;
// - per substep: forward kinematics, penalty contacts with isotropic Coulomb
//   friction, spring and limit torques, the optional motor speed line,
//   b = M qd + dt * rhs, two triangular solves, the per-dof max_qd clip, a
//   semi-implicit Euler update and the actuator work;
// - at the end of the step: the energy valve (a second forward kinematics,
//   stored and kinetic energy, and the sqrt velocity scale).
//
// Layout: one warp per trajectory. Its state and scratch (Work: q, qd, the
// packed lower triangles of M and L, the frames, the per-body and per-geom
// terms) live in shared memory on the device. The step is a sequence of
// phases, each a function (params, workspace, lane): lane j takes dof j,
// body j, geom j or row j, whichever the phase says; bodies go one tree
// level per phase (SpatialParams::depth), the Cholesky factor and the solves
// one column per phase (a solve's running sums stay in the lanes' registers
// from one column to the next: sweep). A phase writes only its own lane's
// slots and reads only slots written in earlier phases, so the warp runs it
// at once and then meets at __syncwarp(), and the host runs it for lanes
// 0..31 one after the other with the same result (WarpLanes, HostLanes).
// Every sum adds its terms in the order of the serial body this replaces,
// except the back solve, whose rows now sum k descending. The device moves
// the workspace's and the parameter block's vectors in 16-byte rows.
//
// The tree is data in SpatialParams: a chain is a bit mask over rotational
// dofs; bodies and geoms are indexed by lane, parent or loop counter.
//
// Every term the plain version skips on the static model (a zero Rodrigues
// coefficient, a zero spring stiffness, an infinite limit, an unactuated dof,
// an infinite contact cap, a model without the valve) is skipped here too,
// through a mask or flag in SpatialParams: computing 0 * x instead would give
// a different result where x is not finite.

#pragma once

#include <math.h>

#include "lanes.cuh"

#ifdef __CUDACC__
#define SPATIAL_HD __host__ __device__ __forceinline__
// constexpr functions are host-only under nvcc unless marked for the device
#define SPATIAL_CE __host__ __device__ constexpr
#else
#define SPATIAL_HD inline
#define SPATIAL_CE constexpr
#endif

namespace icem {

// C++ has no zero-length arrays: a model without geoms or actuators keeps a
// one-element placeholder that no loop reads.
SPATIAL_CE int spatial_at_least_one(int n) { return n > 0 ? n : 1; }

constexpr int kSpatialLanes = 32;

// Phase groups of a control step, for the profile build (-DICEM_SPATIAL_PROFILE):
// lane 0 of the warp charges the clock64() cycles since the last mark to
// the group that just ended. Other builds compile the marks to nothing.
enum SpatialProfGroup {
  kProfIo,          // loading ctrl, storing q and qd
  kProfStepFk,      // the start of step's forward kinematics
  kProfVelocity,    // the velocity-product pass and the body forces
  kProfMassRows,    // rows of M, bias, the damped diagonal, tau_ctrl
  kProfEnergy,      // the valve's start and end energy (its FK included)
  kProfCholesky,
  kProfSubFk,       // the substeps' forward kinematics
  kProfContact,     // per-geom points and forces
  kProfRhs,         // contact torques, springs, b = dt * (...) + M qd
  kProfForward,     // L y = b
  kProfBackward,    // L^T x = y
  kProfEuler,       // the clip, the Euler step and the work sum
  kSpatialProfGroups
};

// Every field is 4 bytes wide, so the struct has no padding and its layout
// is the field order; ops/spatial_rollout.py::_param_dtype packs the same
// order and checks sizeof through spatial_params_bytes_*. Constants that the
// plain version folds in float64 arrive folded and rounded once. The tables
// a lane reads at its own body or geom come first, as 16-byte rows (a
// 3-vector padded to 4 floats, a 3x3 table to 3 rows of 4): the block lies
// at a 16-byte boundary in device memory, and one load moves each row.
template <int NDOF, int NBODY, int NGEOM, int NACT>
struct SpatialParams {
  float anchor[NBODY][4];
  float axis[NBODY][4];
  float com[NBODY][4];
  float inertia[NBODY][4];
  float rod_k[NBODY][12];                          // skew K of the hinge axis
  float rod_k2[NBODY][12];                         // K @ K, folded
  float geom_pos[spatial_at_least_one(NGEOM)][4];
  int parent[NBODY];                               // parent[0] == -1
  int depth[NBODY];                                // depth[0] == 0, depth[b] == depth[parent] + 1
  unsigned chain_mask[NBODY];                      // bit r: rotational dof r on root..b
  unsigned rod_k_mask[NBODY];                      // bit 3i+j: K[i][j] != 0
  unsigned rod_k2_mask[NBODY];                     // bit 3i+j: (K K)[i][j] != 0
  int geom_body[spatial_at_least_one(NGEOM)];
  unsigned geom_chain_mask[spatial_at_least_one(NGEOM)];
  int actuator_dof[spatial_at_least_one(NACT)];
  unsigned actuated_mask;                          // bit j: dof j has an actuator
  unsigned spring_mask;                            // bit j: stiffness[j] != 0
  unsigned hi_mask;                                // bit j: limit_hi[j] finite
  unsigned lo_mask;                                // bit j: limit_lo[j] finite
  int finite_motor;
  int finite_fmax;
  int valve;
  int n_substeps;
  int max_depth;                                   // the largest depth[b]
  float mass[NBODY];
  float grav_mass[NBODY];                          // gravity * mass[b], folded
  float root_rot_offset[3][3];
  float geom_radius[spatial_at_least_one(NGEOM)];
  float gear[spatial_at_least_one(NACT)];
  float damping[NDOF];
  float stiffness[NDOF];
  float springref[NDOF];
  float limit_lo[NDOF];
  float limit_hi[NDOF];
  float max_qd[NDOF];
  float trans_diag;                                // sum(mass) + 1e-6, folded
  float limit_stiffness;
  float limit_damping;
  float gravity;
  float contact_kp;
  float contact_kd;
  float contact_fmax;
  float pen_star;                                  // contact_fmax / contact_kp, folded
  float friction_mu;
  float friction_kt;
  float motor_omega_max;
  float valve_eps;
  float dt_sub;                                    // dt / n_substeps, folded
};

template <int NDOF, int NBODY, int NGEOM, int NACT>
struct Spatial {
  using Params = SpatialParams<NDOF, NBODY, NGEOM, NACT>;
  static constexpr bool FREE = (NDOF == NBODY + 5);
  static_assert(FREE || NDOF == NBODY, "a spatial tree has NBODY or NBODY+5 dofs");
  static_assert(NDOF <= 32, "per-dof flags are 32-bit masks");
  // rotational dofs: the root's roll/pitch/yaw (or its hinge), then a hinge
  // per further body
  static constexpr int NROT = FREE ? NDOF - 3 : NDOF;
  static constexpr int NTRI = NDOF * (NDOF + 1) / 2;

  SPATIAL_CE static int rot_dof(int r) { return FREE ? r + 3 : r; }
  // the body whose origin is the pivot of rotational dof r
  SPATIAL_CE static int rot_body(int r) { return FREE ? (r < 3 ? 0 : r - 2) : r; }
  // the rotational dof of body b's hinge (b > 0 for a free root)
  SPATIAL_CE static int body_rot(int b) { return FREE ? b + 2 : b; }
  SPATIAL_CE static int tri(int i, int j) { return i * (i + 1) / 2 + j; }
  SPATIAL_CE static int sym(int i, int j) { return i >= j ? tri(i, j) : tri(j, i); }

  static_assert(NBODY <= 32 && NGEOM <= 32 && NACT <= 32,
                "lane j of the warp owns body j, geom j and actuator j");

  static constexpr int NGEOM1 = spatial_at_least_one(NGEOM);
  static constexpr int NDOF4 = (NDOF + 3) / 4 * 4;

  // One trajectory's state and scratch: one per warp, in shared memory (one
  // per trajectory on the host). Lane j owns slot j of each per-dof,
  // per-body, per-geom and per-actuator array, and row j of M and L.
  //
  // The 16-byte rows come first: a 3-vector is padded to 4 floats and a 3x3
  // matrix to 3 rows of 4, so that the device moves each row in one 16-byte
  // access (ld3, st3, ld9, st9). Two unions share space between arrays
  // whose lifetimes do not overlap.
  struct alignas(16) Work {
#ifdef ICEM_SPATIAL_PROFILE
    static constexpr bool kProfile = true;
#else
    static constexpr bool kProfile = false;
#endif
    // world frames of one configuration (spatial_batched.fk_rows)
    float R[NBODY][12];     // rotations, row-major
    float o[NBODY][4];      // joint origins
    float com[NBODY][4];    // world COMs
    float w[NROT][4];       // world axes of the rotational dofs
    union {
      // within one forward kinematics: each hinge's rotation in its
      // parent's frame (b > 0)
      float E[NBODY][12];
      // in the velocity-product pass (qdd = 0): each body's omega, alpha and
      // origin acceleration
      float vel[3][NBODY][4];
    };
    union {
      // from the velocity-product pass to the rows of M: each body's force
      // and torque
      float ft[2][NBODY][4];
      // from then on: each geom's world point and contact force
      float geo[2][NGEOM1][4];
    };
    // per-dof arrays, padded to 16-byte rows (ld4)
    float q[NDOF4], qd[NDOF4];
    float taus[NDOF4];      // tau_ctrl after the motor speed line
    float tau_ctrl[NDOF4];  // gear * ctrl, summed per dof
    float bias[NDOF4];
    float b[NDOF4];         // right-hand side, then the solves' iterate
    float a_diag[NDOF4];    // M_jj + dt * damping: the pivot floor's reference
    float Linv[NDOF4];      // 1 / L_jj
    float M[NTRI], L[NTRI]; // packed lower triangles
    float ctrl[spatial_at_least_one(NACT)];
    float root_sc[3][2];    // sin and cos of a free root's roll, pitch, yaw
    float ke_lin[NBODY], ke_rot[NBODY];  // each body's kinetic energy terms
    float e0, work, sf;     // the energy valve's scalars
#ifdef ICEM_SPATIAL_PROFILE
    long long prof[kSpatialProfGroups];  // cycles per phase group (lane 0)
    long long prof_t;                    // clock64() at the last mark
#endif
    SPATIAL_HD float* om(int b) { return vel[0][b]; }
    SPATIAL_HD float* al(int b) { return vel[1][b]; }
    SPATIAL_HD float* ao(int b) { return vel[2][b]; }
    SPATIAL_HD float* f(int b) { return ft[0][b]; }
    SPATIAL_HD float* tr(int b) { return ft[1][b]; }
    SPATIAL_HD float* gp(int g) { return geo[0][g]; }
    SPATIAL_HD float* gf(int g) { return geo[1][g]; }
  };

  // a padded 3-vector and a 3x3 matrix of padded rows, to and from the
  // workspace or the parameter block: one 16-byte access a row on the device
  SPATIAL_HD static void ld3(const float* p, float* v) {
#ifdef __CUDA_ARCH__
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
#else
    for (int k = 0; k < 3; ++k) v[k] = p[k];
#endif
  }
  SPATIAL_HD static void st3(float* p, const float* v) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], 0.f);
#else
    for (int k = 0; k < 3; ++k) p[k] = v[k];
    p[3] = 0.f;
#endif
  }
  // four consecutive floats of a padded per-dof array
  SPATIAL_HD static void ld4(const float* p, float* v) {
#ifdef __CUDA_ARCH__
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
#else
    for (int k = 0; k < 4; ++k) v[k] = p[k];
#endif
  }
  SPATIAL_HD static void ld9(const float* p, float* R) {
    for (int i = 0; i < 3; ++i) ld3(p + 4 * i, R + 3 * i);
  }
  SPATIAL_HD static void st9(float* p, const float* R) {
    for (int i = 0; i < 3; ++i) st3(p + 4 * i, R + 3 * i);
  }

  SPATIAL_HD static float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
  }
  SPATIAL_HD static void cross(const float* a, const float* b, float* c) {
    c[0] = a[1] * b[2] - a[2] * b[1];
    c[1] = a[2] * b[0] - a[0] * b[2];
    c[2] = a[0] * b[1] - a[1] * b[0];
  }
  SPATIAL_HD static float dot(const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
  }
  // R v and R^T v for a row-major R
  SPATIAL_HD static void matvec(const float* R, const float* v, float* out) {
    for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
  }
  SPATIAL_HD static void matTvec(const float* R, const float* v, float* out) {
    for (int i = 0; i < 3; ++i) out[i] = R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2];
  }
  // p = o + R x, the world point of body-frame offset x
  SPATIAL_HD static void point(const float* o, const float* R, const float* x, float* p) {
    float t[3];
    matvec(R, x, t);
    for (int k = 0; k < 3; ++k) p[k] = o[k] + t[k];
  }

  // Rodrigues rotation of body b's hinge, given sin and cos of its angle:
  // entries whose K / K^2 coefficient is zero are the identity's constants
  SPATIAL_HD static void rodrigues(const Params& m, int b, float s, float c, float* E) {
    const float omc = 1.f - c;
    const unsigned km = m.rod_k_mask[b], k2m = m.rod_k2_mask[b];
    float K[9], K2[9];
    ld9(m.rod_k[b], K);
    ld9(m.rod_k2[b], K2);
    for (int e = 0; e < 9; ++e) {
      float v = (e % 4 == 0) ? 1.f : 0.f;
      if ((km >> e) & 1u) v = v + s * K[e];
      if ((k2m >> e) & 1u) v = v + omc * K2[e];
      E[e] = v;
    }
  }

  // ---- forward kinematics (spatial_batched.fk_rows)
  //
  // Every sine and cosine at once, the root's frame, then one phase per
  // level of the tree for the rotations and origins, which are the only
  // serial chain, then every hinge axis and COM at once.

  static_assert(!FREE || NBODY + 3 <= kSpatialLanes, "the root's angles take 3 spare lanes");

  // lane b > 0: its hinge's rotation E_b; a hinge root's lane 0: R_0; under
  // a free root, lanes NBODY..NBODY+2: sin and cos of roll, pitch and yaw
  SPATIAL_HD static void fk_angles(const Params& m, Work& W, int l) {
    float theta;
    if (l > 0 && l < NBODY)
      theta = W.q[rot_dof(body_rot(l))];
    else if (FREE && l >= NBODY && l < NBODY + 3)
      theta = W.q[3 + l - NBODY];
    else if (!FREE && l == 0)
      theta = W.q[0];
    else
      return;
    float s, c;
    sincosf(theta, &s, &c);
    if (FREE && l >= NBODY) {
      W.root_sc[l - NBODY][0] = s;
      W.root_sc[l - NBODY][1] = c;
    } else {
      float E[9];
      rodrigues(m, l, s, c, E);
      st9(l == 0 ? W.R[0] : W.E[l], E);
    }
  }

  // the root's frame and its rotational axes (lane 0)
  SPATIAL_HD static void fk_root(const Params& m, Work& W) {
    const float* q = W.q;
    if (FREE) {
      const float sr = W.root_sc[0][0], cr = W.root_sc[0][1];
      const float sp = W.root_sc[1][0], cp = W.root_sc[1][1];
      const float sy = W.root_sc[2][0], cy = W.root_sc[2][1];
      const float Rr[9] = {cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                           sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                           -sp, cp * sr, cp * cr};
      const auto& Ro = m.root_rot_offset;
      float R[9], o[3], wr[3], wp[3], wy[3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          R[3 * i + j] = Ro[i][0] * Rr[j] + Ro[i][1] * Rr[3 + j] + Ro[i][2] * Rr[6 + j];
      for (int k = 0; k < 3; ++k) o[k] = q[k] + m.anchor[0][k];
      for (int i = 0; i < 3; ++i) {
        wr[i] = Ro[i][0] * (cy * cp) + Ro[i][1] * (sy * cp) + Ro[i][2] * (-sp);  // roll
        wp[i] = Ro[i][0] * (-sy) + Ro[i][1] * cy;                              // pitch
        wy[i] = Ro[i][2];                                                      // yaw
      }
      st9(W.R[0], R);
      st3(W.o[0], o);
      st3(W.w[0], wr);
      st3(W.w[1], wp);
      st3(W.w[2], wy);
    } else {
      st3(W.o[0], m.anchor[0]);
      st3(W.w[0], m.axis[0]);
    }
  }

  // is `lane` a body at depth d >= 1?
  SPATIAL_HD static bool body_at(const Params& m, int lane, int d) {
    return lane < NBODY && m.depth[lane] == d;
  }

  // body b's rotation and origin from its parent's, which the previous level
  // wrote (lane b)
  SPATIAL_HD static void fk_body(const Params& m, Work& W, int b) {
    const int pa = m.parent[b];
    float Rp[9], E[9], op[3], R[9], o[3];
    ld9(W.R[pa], Rp);
    ld9(W.E[b], E);
    ld3(W.o[pa], op);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        R[3 * i + j] = Rp[3 * i] * E[j] + Rp[3 * i + 1] * E[3 + j] + Rp[3 * i + 2] * E[6 + j];
    float anchor[3];
    ld3(m.anchor[b], anchor);
    point(op, Rp, anchor, o);
    st9(W.R[b], R);
    st3(W.o[b], o);
  }

  // body b's hinge axis (b > 0) and COM in the world (lane b)
  SPATIAL_HD static void fk_axis_com(const Params& m, Work& W, int b) {
    float R[9], o[3], v[3];
    if (b > 0) {
      ld9(W.R[m.parent[b]], R);
      float axis[3];
      ld3(m.axis[b], axis);
      matvec(R, axis, v);
      st3(W.w[body_rot(b)], v);
    }
    ld9(W.R[b], R);
    ld3(W.o[b], o);
    float com[3];
    ld3(m.com[b], com);
    point(o, R, com, v);
    st3(W.com[b], v);
  }

  // the frames of q
  template <class Lanes>
  SPATIAL_HD static void fk(const Params& m, Work& W, const Lanes& for_lanes) {
    for_lanes([&](int l) { fk_angles(m, W, l); });
    for_lanes([&](int l) {
      if (l == 0) fk_root(m, W);
    });
    for (int d = 1; d <= m.max_depth; ++d)
      for_lanes([&](int l) {
        if (body_at(m, l, d)) fk_body(m, W, l);
      });
    for_lanes([&](int l) {
      if (l < NBODY) fk_axis_com(m, W, l);
    });
  }

  // ---- mass matrix and bias (spatial_batched.mass_bias_rows)

  // the recursive velocity-product pass (qdd = 0) at the root (lane 0)
  SPATIAL_HD static void vel_root(Work& W) {
    const float* qd = W.qd;
    float om[3], al[3];
    const float zero[3] = {0.f, 0.f, 0.f};
    if (FREE) {
      float w_r[3], w_p[3], w_y[3];
      ld3(W.w[0], w_r);
      ld3(W.w[1], w_p);
      ld3(W.w[2], w_y);
      float yr[3], pr[3], yp[3];
      cross(w_y, w_r, yr);
      cross(w_p, w_r, pr);
      cross(w_y, w_p, yp);
      for (int k = 0; k < 3; ++k) {
        om[k] = qd[3] * w_r[k] + qd[4] * w_p[k] + qd[5] * w_y[k];
        al[k] = qd[3] * (qd[5] * yr[k] + qd[4] * pr[k]) + qd[4] * qd[5] * yp[k];
      }
    } else {
      float w[3];
      ld3(W.w[0], w);
      for (int k = 0; k < 3; ++k) {
        om[k] = qd[0] * w[k];
        al[k] = 0.f;
      }
    }
    st3(W.om(0), om);
    st3(W.al(0), al);
    st3(W.ao(0), zero);
  }

  // the pass at body b, from its parent's values of the previous level (lane b)
  SPATIAL_HD static void vel_body(const Params& m, Work& W, int b) {
    const int pa = m.parent[b];
    const float qdj = W.qd[rot_dof(body_rot(b))];
    float w[3], ob[3], op[3], omp[3], alp[3], aop[3];
    ld3(W.w[body_rot(b)], w);
    ld3(W.o[b], ob);
    ld3(W.o[pa], op);
    ld3(W.om(pa), omp);
    ld3(W.al(pa), alp);
    ld3(W.ao(pa), aop);
    float r[3], t1[3], t2[3], t3[3], om[3], al[3], ao[3];
    for (int k = 0; k < 3; ++k) r[k] = ob[k] - op[k];
    cross(alp, r, t1);
    cross(omp, r, t2);
    cross(omp, t2, t3);
    for (int k = 0; k < 3; ++k) ao[k] = aop[k] + (t1[k] + t3[k]);
    cross(omp, w, t1);
    for (int k = 0; k < 3; ++k) {
      om[k] = omp[k] + qdj * w[k];
      al[k] = alp[k] + qdj * t1[k];
    }
    st3(W.om(b), om);
    st3(W.al(b), al);
    st3(W.ao(b), ao);
  }

  // body b's force f (gravity included) and torque tr (lane b)
  SPATIAL_HD static void body_force(const Params& m, Work& W, int b) {
    const float mb = m.mass[b];
    float I[3];
    ld3(m.inertia[b], I);
    float R[9], om[3], al[3], ao[3], c[3], o[3];
    ld9(W.R[b], R);
    ld3(W.om(b), om);
    ld3(W.al(b), al);
    ld3(W.ao(b), ao);
    ld3(W.com[b], c);
    ld3(W.o[b], o);
    float r[3], t1[3], t2[3], t3[3], ac[3], f[3], tr[3];
    for (int k = 0; k < 3; ++k) r[k] = c[k] - o[k];
    cross(al, r, t1);
    cross(om, r, t2);
    cross(om, t2, t3);
    for (int k = 0; k < 3; ++k) ac[k] = ao[k] + (t1[k] + t3[k]);
    f[0] = mb * ac[0];
    f[1] = mb * ac[1];
    f[2] = mb * (ac[2] + m.gravity);
    // R (I * R^T alpha) + omega x (R (I * R^T omega))
    float ual[3], uom[3], Ia[3], Io[3], RIa[3], RIo[3];
    matTvec(R, al, ual);
    matTvec(R, om, uom);
    for (int k = 0; k < 3; ++k) {
      Ia[k] = I[k] * ual[k];
      Io[k] = I[k] * uom[k];
    }
    matvec(R, Ia, RIa);
    matvec(R, Io, RIo);
    cross(om, RIo, t1);
    for (int k = 0; k < 3; ++k) tr[k] = RIa[k] + t1[k];
    st3(W.f(b), f);
    st3(W.tr(b), tr);
  }

  // the Jacobian column w x (x - o) of a rotational dof with axis w through
  // o, at world point x
  SPATIAL_HD static void jac_at(const float* o, const float* w, const float* x, float* J) {
    float d[3];
    for (int k = 0; k < 3; ++k) d[k] = x[k] - o[k];
    cross(w, d, J);
  }
  // ... of rotational dof r
  SPATIAL_HD static void jac(const Work& W, int r, const float* x, float* J) {
    float o[3], w[3];
    ld3(W.o[rot_body(r)], o);
    ld3(W.w[r], w);
    jac_at(o, w, x, J);
  }

  // row j of M (entries M_jk, k <= j) and bias[j] (lane j). Each entry adds
  // its bodies' terms in ascending body order, as the serial sum did; the
  // Jacobian columns of the row's and the column's dofs are recomputed per
  // body. The rotational diagonal takes its 1e-6 last; the translational
  // one arrives folded with it, as the plain version folds it.
  SPATIAL_HD static void mass_row(const Params& m, Work& W, int j) {
    float* Mrow = W.M + tri(j, 0);
    for (int k = 0; k <= j; ++k) Mrow[k] = 0.f;
    if (FREE && j < 3) {
      Mrow[j] = m.trans_diag;
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < NBODY; ++b) s = s + W.f(b)[j];
      W.bias[j] = s;
      return;
    }
    const int ri = FREE ? j - 3 : j;
    float wi[3];
    ld3(W.w[ri], wi);
    float bj = 0.f;
    for (int b = 0; b < NBODY; ++b) {
      const unsigned cm = m.chain_mask[b];
      if (!((cm >> ri) & 1u)) continue;
      const float mb = m.mass[b];
      float I[3];
      ld3(m.inertia[b], I);
      float R[9], c[3], f[3], tr[3];
      ld9(W.R[b], R);
      ld3(W.com[b], c);
      ld3(W.f(b), f);
      ld3(W.tr(b), tr);
      float Jvi[3], ui[3];
      jac(W, ri, c, Jvi);
      bj = bj + dot(Jvi, f) + dot(wi, tr);
      matTvec(R, wi, ui);
      // the chain's rotational dofs rj <= ri, ascending
      for (unsigned bits = cm & (0xffffffffu >> (31 - ri)); bits; bits &= bits - 1) {
        const int rj = lowest_bit(bits);
        float oj[3], wj[3], Jvj[3], uj[3];
        ld3(W.o[rot_body(rj)], oj);
        ld3(W.w[rj], wj);
        jac_at(oj, wj, c, Jvj);
        matTvec(R, wj, uj);
        const float val = mb * dot(Jvi, Jvj) +
                          (I[0] * ui[0] * uj[0] + I[1] * ui[1] * uj[1] + I[2] * ui[2] * uj[2]);
        Mrow[rot_dof(rj)] = Mrow[rot_dof(rj)] + val;
      }
      if (FREE)
        for (int t = 0; t < 3; ++t) Mrow[t] = Mrow[t] + mb * Jvi[t];
    }
    W.bias[j] = bj;
    Mrow[j] = Mrow[j] + 1e-6f;
  }

  // dof j's implicitly damped diagonal and its actuator torque (lane j,
  // after its row of M)
  SPATIAL_HD static void diag_ctrl(const Params& m, Work& W, int j) {
    const float qj = W.q[j];
    const bool viol = qj > m.limit_hi[j] || qj < m.limit_lo[j];
    const float d = m.damping[j] + (viol ? m.limit_damping : 0.f);
    W.a_diag[j] = W.M[tri(j, j)] + m.dt_sub * d;
    float t = 0.f;
#pragma unroll
    for (int a = 0; a < NACT; ++a)
      if (m.actuator_dof[a] == j) t += m.gear[a] * W.ctrl[a];
    W.tau_ctrl[j] = t;
  }

  // ---- the energy valve (spatial_batched.kinetic_rows, stored_energy_rows)

  // geom g's world point p, also stored in the workspace (lane g)
  SPATIAL_HD static void geom_point(const Params& m, Work& W, int g, float* p) {
    const int gb = m.geom_body[g];
    float o[3], R[9];
    ld3(W.o[gb], o);
    ld9(W.R[gb], R);
    float x[3];
    ld3(m.geom_pos[g], x);
    point(o, R, x, p);
    st3(W.gp(g), p);
  }

  // body l's two kinetic energy terms and geom l's world point (lane l)
  SPATIAL_HD static void energy_terms(const Params& m, Work& W, int l) {
    if (l < NGEOM) {
      float p[3];
      geom_point(m, W, l, p);
    }
    if (l >= NBODY) return;
    const int b = l;
    const unsigned cm = m.chain_mask[b];
    float c[3], v[3], om[3] = {0.f, 0.f, 0.f};
    ld3(W.com[b], c);
    for (int k = 0; k < 3; ++k) v[k] = FREE ? W.qd[k] : 0.f;
    for (unsigned bits = cm; bits; bits &= bits - 1) {
      const int rr = lowest_bit(bits);
      float o[3], w[3], Jv[3];
      ld3(W.o[rot_body(rr)], o);
      ld3(W.w[rr], w);
      jac_at(o, w, c, Jv);
      const float qj = W.qd[rot_dof(rr)];
      for (int k = 0; k < 3; ++k) {
        v[k] = v[k] + qj * Jv[k];
        om[k] = om[k] + qj * w[k];
      }
    }
    float R[9], u[3];
    ld9(W.R[b], R);
    matTvec(R, om, u);
    float I[3];
    ld3(m.inertia[b], I);
    W.ke_lin[b] = 0.5f * m.mass[b] * dot(v, v);
    W.ke_rot[b] = 0.5f * (I[0] * u[0] * u[0] + I[1] * u[1] * u[1] + I[2] * u[2] * u[2]);
  }

  // the kinetic energy ke and the stored energy e, summed from the terms in
  // the serial order (lane 0)
  SPATIAL_HD static void energy_sum(const Params& m, const Work& W, float& ke, float& e) {
    ke = 0.f;
#pragma unroll
    for (int b = 0; b < NBODY; ++b) {
      ke = ke + W.ke_lin[b];
      ke = ke + W.ke_rot[b];
    }
    e = ke;
#pragma unroll
    for (int b = 0; b < NBODY; ++b) e = e + m.grav_mass[b] * W.com[b][2];
    const float half_ls = 0.5f * m.limit_stiffness;
#pragma unroll
    for (int j = 0; j < NDOF; ++j) {
      const float qj = W.q[j];
      if ((m.spring_mask >> j) & 1u) {
        const float d = qj - m.springref[j];
        e = e + 0.5f * m.stiffness[j] * (d * d);
      }
      if ((m.hi_mask >> j) & 1u) {
        const float d = fmaxf(qj - m.limit_hi[j], 0.f);
        e = e + half_ls * (d * d);
      }
      if ((m.lo_mask >> j) & 1u) {
        const float d = fmaxf(m.limit_lo[j] - qj, 0.f);
        e = e + half_ls * (d * d);
      }
    }
    const float half_kp = 0.5f * m.contact_kp;
#pragma unroll
    for (int g = 0; g < NGEOM; ++g) {
      const float pen = fmaxf(m.geom_radius[g] - W.geo[0][g][2], 0.f);
      if (m.finite_fmax) {
        const float lo = fminf(pen, m.pen_star);
        e = e + half_kp * (lo * lo);
        e = e + m.contact_fmax * fmaxf(pen - m.pen_star, 0.f);
      } else {
        e = e + half_kp * (pen * pen);
      }
    }
  }

  // ---- per substep: contacts, right-hand side (spatial_batched.contact_tau_rows)

  // geom g's world point and penalty contact force (lane g)
  SPATIAL_HD static void contact_geom(const Params& m, Work& W, int g) {
    const float kp = m.contact_kp, kd = m.contact_kd, kt = m.friction_kt, mu = m.friction_mu;
    const unsigned cm = m.geom_chain_mask[g];
    float p[3], v[3];
    geom_point(m, W, g, p);
    for (int k = 0; k < 3; ++k) v[k] = FREE ? W.qd[k] : 0.f;
    for (unsigned bits = cm; bits; bits &= bits - 1) {
      const int rr = lowest_bit(bits);
      float Jc[3];
      jac(W, rr, p, Jc);
      const float qj = W.qd[rot_dof(rr)];
      for (int k = 0; k < 3; ++k) v[k] = v[k] + qj * Jc[k];
    }
    const float phi = p[2] - m.geom_radius[g];
    float fn = fmaxf(-kp * phi - kd * v[2], 0.f);
    if (m.finite_fmax) fn = fminf(fn, m.contact_fmax);
    fn = phi < 0.f ? fn : 0.f;
    const float ftx = -kt * v[0];
    const float fty = -kt * v[1];
    const float ft_norm = sqrtf(ftx * ftx + fty * fty);
    const float scale = fminf(mu * fn / fmaxf(ft_norm, 1e-9f), 1.f);
    const float f[3] = {ftx * scale, fty * scale, fn};
    st3(W.gf(g), f);
  }

  // dof j's contact torque (geoms in ascending order), motor line, spring
  // and limit torques, then b[j] = dt * (...) + sum_i M_ji qd_i (lane j)
  SPATIAL_HD static void rhs_row(const Params& m, Work& W, int j) {
    const float dt = m.dt_sub;
    float tau_c = 0.f;
    if (FREE && j < 3) {
#pragma unroll
      for (int g = 0; g < NGEOM; ++g) tau_c = tau_c + W.gf(g)[j];
    } else {
      const int rj = FREE ? j - 3 : j;
      float o[3], w[3];
      ld3(W.o[rot_body(rj)], o);
      ld3(W.w[rj], w);
#pragma unroll
      for (int g = 0; g < NGEOM; ++g) {
        if ((m.geom_chain_mask[g] >> rj) & 1u) {
          float p[3], f[3], Jc[3];
          ld3(W.gp(g), p);
          ld3(W.gf(g), f);
          jac_at(o, w, p, Jc);
          tau_c = tau_c + dot(Jc, f);
        }
      }
    }
    const float qj = W.q[j], qdj = W.qd[j];
    float t = W.tau_ctrl[j];
    if (m.finite_motor && ((m.actuated_mask >> j) & 1u)) {
      const float sgn = (t > 0.f) ? 1.f : ((t < 0.f) ? -1.f : 0.f);
      t = t * clampf(1.f - qdj * sgn / m.motor_omega_max, 0.f, 1.f);
    }
    W.taus[j] = t;
    float spring = 0.f;
    if ((m.spring_mask >> j) & 1u) spring = -m.stiffness[j] * (qj - m.springref[j]);
    if ((m.hi_mask >> j) & 1u)
      spring = spring - m.limit_stiffness * fmaxf(qj - m.limit_hi[j], 0.f);
    if ((m.lo_mask >> j) & 1u)
      spring = spring + m.limit_stiffness * fmaxf(m.limit_lo[j] - qj, 0.f);
    float acc = dt * (t + spring + tau_c - W.bias[j]);
#pragma unroll
    for (int i4 = 0; i4 < NDOF; i4 += 4) {
      float qd4[4];
      ld4(W.qd + i4, qd4);
#pragma unroll
      for (int i = i4; i < i4 + 4 && i < NDOF; ++i) acc = acc + W.M[sym(j, i)] * qd4[i - i4];
    }
    W.b[j] = acc;
  }

  // ---- the Cholesky factor and the two triangular solves

  // step s of the left-looking Cholesky factor, s = 0..NDOF: lanes i >= s
  // finish column s - 1 of their row, then lane s takes its pivot. Each
  // entry's k-sum runs k ascending, as the serial row-by-row factor did.
  SPATIAL_HD static void cholesky_step(Work& W, int i, int s) {
    if (i < s || i >= NDOF) return;
    if (s > 0) {
      const int c = s - 1;
      float acc = W.M[tri(i, c)];
      for (int k = 0; k < c; ++k) acc = acc - W.L[tri(i, k)] * W.L[tri(c, k)];
      W.L[tri(i, c)] = acc / W.L[tri(c, c)];
    }
    if (i == s) {
      const float a_ii = W.a_diag[i];
      float acc = a_ii;
      for (int k = 0; k < i; ++k) acc = acc - W.L[tri(i, k)] * W.L[tri(i, k)];
      // pivot floor relative to the diagonal, as in the JAX engine
      const float l_ii = sqrtf(fmaxf(acc, fmaxf(1e-5f * a_ii, 1e-9f)));
      W.L[tri(i, i)] = l_ii;
      W.Linv[i] = 1.f / l_ii;
    }
  }

  // a solve's running sum of row i and the row's inverse pivot, carried by
  // lane i from one column's phase to the next
  struct SolveCarry {
    float acc, linv;
  };

  // step s of L y = b by columns, s = 0..NDOF-1: lanes i >= s take y_{s-1}'s
  // term (k ascending, as before), then lane s divides by its pivot and
  // publishes y_s in b[s]
  SPATIAL_HD static void forward_step(Work& W, int i, int s, SolveCarry& r) {
    if (i < s || i >= NDOF) return;
    if (s == 0) {
      r.acc = W.b[i];
      r.linv = W.Linv[i];
    } else {
      r.acc = r.acc - W.L[tri(i, s - 1)] * W.b[s - 1];
    }
    if (i == s) W.b[i] = r.acc * r.linv;
  }

  // step t of L^T x = y by columns, s = NDOF-1-t: lanes i <= s take
  // x_{s+1}'s term, then lane s divides by its pivot and publishes x_s in
  // b[s]. Each row's sum now runs k descending where the serial solve ran it
  // ascending.
  SPATIAL_HD static void backward_step(Work& W, int i, int t, SolveCarry& r) {
    const int s = NDOF - 1 - t;
    if (i > s) return;
    if (t == 0) {
      r.acc = W.b[i];
      r.linv = W.Linv[i];
    } else {
      r.acc = r.acc - W.L[tri(s + 1, i)] * W.b[s + 1];
    }
    if (i == s) W.b[i] = r.acc * r.linv;
  }

  // the velocity clip and the semi-implicit Euler step of dof j (lane j)
  SPATIAL_HD static void euler_row(const Params& m, Work& W, int j) {
    const float qdj = clampf(W.b[j], -m.max_qd[j], m.max_qd[j]);
    W.qd[j] = qdj;
    W.q[j] = W.q[j] + m.dt_sub * qdj;
  }

  // the actuators' work over the substep, summed in dof order (lane 0)
  SPATIAL_HD static void add_work(const Params& m, Work& W) {
    float dw = 0.f;
#pragma unroll
    for (int j4 = 0; j4 < NDOF; j4 += 4) {
      float taus[4], qd[4];
      ld4(W.taus + j4, taus);
      ld4(W.qd + j4, qd);
#pragma unroll
      for (int j = j4; j < j4 + 4 && j < NDOF; ++j)
        if ((m.actuated_mask >> j) & 1u) dw = dw + taus[j - j4] * qd[j - j4];
    }
    W.work = W.work + m.dt_sub * dw;
  }

  // the valve's velocity scale from the end state's energy (lane 0)
  SPATIAL_HD static void valve_scale(const Params& m, Work& W) {
    const float bound = W.e0 + fmaxf(W.work, 0.f) + m.valve_eps;
    float ke1, e1;
    energy_sum(m, W, ke1, e1);
    const float excess = e1 - bound;
    const float scale2 = clampf((ke1 - excess) / fmaxf(ke1, 1e-9f), 0.f, 1.f);
    W.sf = sqrtf(scale2);
  }

  // One control step of the workspace's state (spatial_batched.step_rows);
  // W.ctrl already clipped.
  template <class Lanes>
  SPATIAL_HD static void control_step(const Params& m, Work& W, const Lanes& for_lanes) {
    // ---- once per control step: M, bias, the factor, the start energy
    fk(m, W, for_lanes);
    for_lanes.mark(W, kProfStepFk);
    for_lanes([&](int l) {
      if (l == 0) {
        vel_root(W);
        body_force(m, W, 0);
      }
    });
    for (int d = 1; d <= m.max_depth; ++d)
      for_lanes([&](int l) {
        if (body_at(m, l, d)) {
          vel_body(m, W, l);
          body_force(m, W, l);
        }
      });
    for_lanes.mark(W, kProfVelocity);
    for_lanes([&](int l) {
      if (l < NDOF) {
        mass_row(m, W, l);
        diag_ctrl(m, W, l);
      }
    });
    for_lanes.mark(W, kProfMassRows);
    if (m.valve) {
      for_lanes([&](int l) { energy_terms(m, W, l); });
      for_lanes([&](int l) {
        if (l == 0) {
          float ke;
          energy_sum(m, W, ke, W.e0);
          W.work = 0.f;
        }
      });
      for_lanes.mark(W, kProfEnergy);
    }
#pragma unroll
    for (int s = 0; s <= NDOF; ++s) for_lanes([&](int l) { cholesky_step(W, l, s); });
    for_lanes.mark(W, kProfCholesky);

    // ---- substeps
    for (int sub = 0; sub < m.n_substeps; ++sub) {
      fk(m, W, for_lanes);
      for_lanes.mark(W, kProfSubFk);
      for_lanes([&](int l) {
        if (l < NGEOM) contact_geom(m, W, l);
      });
      for_lanes.mark(W, kProfContact);
      for_lanes([&](int l) {
        if (l < NDOF) rhs_row(m, W, l);
      });
      for_lanes.mark(W, kProfRhs);
      for_lanes.template sweep<SolveCarry>(
          NDOF, [&](int l, int s, SolveCarry& r) { forward_step(W, l, s, r); });
      for_lanes.mark(W, kProfForward);
      for_lanes.template sweep<SolveCarry>(
          NDOF, [&](int l, int t, SolveCarry& r) { backward_step(W, l, t, r); });
      for_lanes.mark(W, kProfBackward);
      for_lanes([&](int l) {
        if (l < NDOF) euler_row(m, W, l);
      });
      if (m.valve)
        for_lanes([&](int l) {
          if (l == 0) add_work(m, W);
        });
      for_lanes.mark(W, kProfEuler);
    }

    // ---- the energy valve at the end state
    if (m.valve) {
      fk(m, W, for_lanes);
      for_lanes([&](int l) { energy_terms(m, W, l); });
      for_lanes([&](int l) {
        if (l == 0) valve_scale(m, W);
      });
      for_lanes([&](int l) {
        if (l < NDOF) W.qd[l] = W.qd[l] * W.sf;
      });
      for_lanes.mark(W, kProfEnergy);
    }
  }
};

// The whole rollout of trajectory p in workspace W. Layouts are
// trajectory-major, so that lane j's access to dof j (or actuator j) is
// contiguous across the warp: q0 [P, NDOF] with row stride ldq, qd0 the
// same with ldqd; acts [P, h, NACT]; qs, qds [h, P, NDOF].
template <int NDOF, int NBODY, int NGEOM, int NACT, class Lanes>
SPATIAL_HD void spatial_rollout_one(const SpatialParams<NDOF, NBODY, NGEOM, NACT>& m,
                                    typename Spatial<NDOF, NBODY, NGEOM, NACT>::Work& W,
                                    const Lanes& for_lanes, const float* q0, long long ldq,
                                    const float* qd0, long long ldqd, const float* acts,
                                    float* qs, float* qds, long long P, int h, long long p) {
  using Eng = Spatial<NDOF, NBODY, NGEOM, NACT>;
  for_lanes([&](int j) {
    if (j < NDOF) {
      W.q[j] = q0[p * ldq + j];
      W.qd[j] = qd0[p * ldqd + j];
    }
#if defined(ICEM_SPATIAL_PROFILE) && defined(__CUDA_ARCH__)
    if (j < kSpatialProfGroups) W.prof[j] = 0;
    if (j == 0) W.prof_t = clock64();
#endif
  });
  for (int t = 0; t < h; ++t) {
    for_lanes([&](int a) {
      if (a < NACT) W.ctrl[a] = acts[(p * h + t) * NACT + a];
    });
    for_lanes.mark(W, kProfIo);
    Eng::control_step(m, W, for_lanes);
    for_lanes([&](int j) {
      if (j < NDOF) {
        qs[((long long)t * P + p) * NDOF + j] = W.q[j];
        qds[((long long)t * P + p) * NDOF + j] = W.qd[j];
      }
    });
    for_lanes.mark(W, kProfIo);
  }
}

}  // namespace icem
