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
// Memory: the packed lower triangles of M and L (105 floats each at 14 dofs,
// 276 at 23) do not fit in 255 registers beside the rest, so this first
// design lets the compiler keep what it can in registers and spill the rest
// to local memory (cached in L1 and L2). Loops over dofs and over the
// rotational dofs of a chain are unrolled at compile time, so q, qd, tau, M
// and L are indexed by constants. The tree is data in SpatialParams: loops
// over bodies and geoms either unroll (where the loop reads q or qd by a
// body's dof) or run as plain loops over the per-body kinematics arrays
// (Frames, in local memory), indexed by the body or its parent; a chain is a
// bit mask over rotational dofs, read in uniform conditions. Unrolling every
// body against every rotational dof would be about 70,000 instructions at the
// Humanoid's shape; this layout is a few thousand.
//
// Every term the plain version skips on the static model (a zero Rodrigues
// coefficient, a zero spring stiffness, an infinite limit, an unactuated dof,
// an infinite contact cap, a model without the valve) is skipped here too,
// through a mask or flag in SpatialParams: computing 0 * x instead would give
// a different result where x is not finite.

#pragma once

#include <math.h>

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

// Every field is 4 bytes wide, so the struct has no padding and its layout
// is the field order; ops/spatial_rollout.py::_param_dtype packs the same
// order and checks sizeof through spatial_params_bytes_*. Constants that the
// plain version folds in float64 arrive folded and rounded once.
template <int NDOF, int NBODY, int NGEOM, int NACT>
struct SpatialParams {
  int parent[NBODY];                               // parent[0] == -1
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
  float anchor[NBODY][3];
  float axis[NBODY][3];
  float com[NBODY][3];
  float mass[NBODY];
  float inertia[NBODY][3];
  float grav_mass[NBODY];                          // gravity * mass[b], folded
  float rod_k[NBODY][9];                           // skew K of the hinge axis
  float rod_k2[NBODY][9];                          // K @ K, folded
  float root_rot_offset[3][3];
  float geom_pos[spatial_at_least_one(NGEOM)][3];
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

  // world frames of one configuration (spatial_batched.fk_rows)
  struct Frames {
    float o[NBODY][3];      // joint origins
    float R[NBODY][9];      // rotations, row-major
    float com[NBODY][3];    // world COMs
    float w[NROT][3];       // world axes of the rotational dofs
  };

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

  // Rodrigues rotation of body b's hinge: entries whose K / K^2 coefficient
  // is zero are the identity's constants
  SPATIAL_HD static void rodrigues(const Params& m, int b, float theta, float* E) {
    const float s = sinf(theta), c = cosf(theta);
    const float omc = 1.f - c;
    const unsigned km = m.rod_k_mask[b], k2m = m.rod_k2_mask[b];
    for (int e = 0; e < 9; ++e) {
      float v = (e % 4 == 0) ? 1.f : 0.f;
      if ((km >> e) & 1u) v = v + s * m.rod_k[b][e];
      if ((k2m >> e) & 1u) v = v + omc * m.rod_k2[b][e];
      E[e] = v;
    }
  }

  // spatial_batched.fk_rows. The body loop is unrolled: it reads q by each
  // body's dof; parents index the Frames arrays.
  SPATIAL_HD static void fk(const Params& m, const float* q, Frames& F) {
    if (FREE) {
      const float cr = cosf(q[3]), sr = sinf(q[3]);
      const float cp = cosf(q[4]), sp = sinf(q[4]);
      const float cy = cosf(q[5]), sy = sinf(q[5]);
      const float Rr[9] = {cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                           sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                           -sp, cp * sr, cp * cr};
      const auto& Ro = m.root_rot_offset;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          F.R[0][3 * i + j] = Ro[i][0] * Rr[j] + Ro[i][1] * Rr[3 + j] + Ro[i][2] * Rr[6 + j];
      for (int k = 0; k < 3; ++k) F.o[0][k] = q[k] + m.anchor[0][k];
      for (int i = 0; i < 3; ++i) {
        F.w[0][i] = Ro[i][0] * (cy * cp) + Ro[i][1] * (sy * cp) + Ro[i][2] * (-sp);  // roll
        F.w[1][i] = Ro[i][0] * (-sy) + Ro[i][1] * cy;                              // pitch
        F.w[2][i] = Ro[i][2];                                                      // yaw
      }
    } else {
      rodrigues(m, 0, q[0], F.R[0]);
      for (int k = 0; k < 3; ++k) {
        F.o[0][k] = m.anchor[0][k];
        F.w[0][k] = m.axis[0][k];
      }
    }
#pragma unroll
    for (int b = 1; b < NBODY; ++b) {
      const int pa = m.parent[b];
      const float* Rp = F.R[pa];
      float E[9];
      rodrigues(m, b, q[rot_dof(body_rot(b))], E);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          F.R[b][3 * i + j] = Rp[3 * i] * E[j] + Rp[3 * i + 1] * E[3 + j] + Rp[3 * i + 2] * E[6 + j];
      point(F.o[pa], Rp, m.anchor[b], F.o[b]);
      matvec(Rp, m.axis[b], F.w[body_rot(b)]);
    }
#pragma unroll 1
    for (int b = 0; b < NBODY; ++b) point(F.o[b], F.R[b], m.com[b], F.com[b]);
  }

  // spatial_batched.mass_bias_rows: M packed lower triangle, without the
  // 1e-6 regularizer of the rotational diagonal (the translational diagonal
  // arrives folded with it, as the plain version folds it).
  SPATIAL_HD static void mass_bias(const Params& m, const float* qd, const Frames& F,
                                   float* M, float* bias) {
    // ---- recursive velocity-product pass (qdd = 0)
    float om[NBODY][3], al[NBODY][3], ao[NBODY][3];
    if (FREE) {
      const float *w_r = F.w[0], *w_p = F.w[1], *w_y = F.w[2];
      float yr[3], pr[3], yp[3];
      cross(w_y, w_r, yr);
      cross(w_p, w_r, pr);
      cross(w_y, w_p, yp);
      for (int k = 0; k < 3; ++k) {
        om[0][k] = qd[3] * w_r[k] + qd[4] * w_p[k] + qd[5] * w_y[k];
        al[0][k] = qd[3] * (qd[5] * yr[k] + qd[4] * pr[k]) + qd[4] * qd[5] * yp[k];
      }
    } else {
      for (int k = 0; k < 3; ++k) {
        om[0][k] = qd[0] * F.w[0][k];
        al[0][k] = 0.f;
      }
    }
    for (int k = 0; k < 3; ++k) ao[0][k] = 0.f;
#pragma unroll
    for (int b = 1; b < NBODY; ++b) {
      const int pa = m.parent[b];
      const float qdj = qd[rot_dof(body_rot(b))];
      const float* w = F.w[body_rot(b)];
      float r[3], t1[3], t2[3], t3[3];
      for (int k = 0; k < 3; ++k) r[k] = F.o[b][k] - F.o[pa][k];
      cross(al[pa], r, t1);
      cross(om[pa], r, t2);
      cross(om[pa], t2, t3);
      for (int k = 0; k < 3; ++k) ao[b][k] = ao[pa][k] + (t1[k] + t3[k]);
      cross(om[pa], w, t1);
      for (int k = 0; k < 3; ++k) {
        om[b][k] = om[pa][k] + qdj * w[k];
        al[b][k] = al[pa][k] + qdj * t1[k];
      }
    }

    // ---- assemble M (lower triangle) and bias
#pragma unroll
    for (int k = 0; k < NTRI; ++k) M[k] = 0.f;
#pragma unroll
    for (int j = 0; j < NDOF; ++j) bias[j] = 0.f;
    if (FREE)
      for (int t = 0; t < 3; ++t) M[tri(t, t)] = m.trans_diag;

#pragma unroll 1
    for (int b = 0; b < NBODY; ++b) {
      const float mb = m.mass[b];
      const float* I = m.inertia[b];
      const float* R = F.R[b];
      const float* c = F.com[b];
      float r[3], t1[3], t2[3], t3[3], ac[3], f[3];
      for (int k = 0; k < 3; ++k) r[k] = c[k] - F.o[b][k];
      cross(al[b], r, t1);
      cross(om[b], r, t2);
      cross(om[b], t2, t3);
      for (int k = 0; k < 3; ++k) ac[k] = ao[b][k] + (t1[k] + t3[k]);
      f[0] = mb * ac[0];
      f[1] = mb * ac[1];
      f[2] = mb * (ac[2] + m.gravity);
      // R (I * R^T alpha) + omega x (R (I * R^T omega))
      float ual[3], uom[3], Ia[3], Io[3], RIa[3], RIo[3], tr[3];
      matTvec(R, al[b], ual);
      matTvec(R, om[b], uom);
      for (int k = 0; k < 3; ++k) {
        Ia[k] = I[k] * ual[k];
        Io[k] = I[k] * uom[k];
      }
      matvec(R, Ia, RIa);
      matvec(R, Io, RIo);
      cross(om[b], RIo, t1);
      for (int k = 0; k < 3; ++k) tr[k] = RIa[k] + t1[k];
      if (FREE)
        for (int k = 0; k < 3; ++k) bias[k] = bias[k] + f[k];

      const unsigned cm = m.chain_mask[b];
      float Jv[NROT][3], u[NROT][3];
#pragma unroll
      for (int rr = 0; rr < NROT; ++rr) {
        if ((cm >> rr) & 1u) {
          const float* w = F.w[rr];
          float d[3];
          for (int k = 0; k < 3; ++k) d[k] = c[k] - F.o[rot_body(rr)][k];
          cross(w, d, Jv[rr]);
          bias[rot_dof(rr)] = bias[rot_dof(rr)] + dot(Jv[rr], f) + dot(w, tr);
          matTvec(R, w, u[rr]);
        }
      }
#pragma unroll
      for (int ri = 0; ri < NROT; ++ri) {
        if ((cm >> ri) & 1u) {
#pragma unroll
          for (int rj = 0; rj <= ri; ++rj) {
            if ((cm >> rj) & 1u) {
              const float val = mb * dot(Jv[ri], Jv[rj]) +
                                (I[0] * u[ri][0] * u[rj][0] + I[1] * u[ri][1] * u[rj][1] +
                                 I[2] * u[ri][2] * u[rj][2]);
              M[tri(rot_dof(ri), rot_dof(rj))] = M[tri(rot_dof(ri), rot_dof(rj))] + val;
            }
          }
        }
      }
      if (FREE) {
#pragma unroll
        for (int rr = 0; rr < NROT; ++rr)
          if ((cm >> rr) & 1u)
            for (int t = 0; t < 3; ++t)
              M[tri(rot_dof(rr), t)] = M[tri(rot_dof(rr), t)] + mb * Jv[rr][t];
      }
    }
  }

  // spatial_batched.kinetic_rows
  SPATIAL_HD static float kinetic(const Params& m, const float* qd, const Frames& F) {
    float ke = 0.f;
#pragma unroll 1
    for (int b = 0; b < NBODY; ++b) {
      const unsigned cm = m.chain_mask[b];
      float v[3], om[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < 3; ++k) v[k] = FREE ? qd[k] : 0.f;
#pragma unroll
      for (int rr = 0; rr < NROT; ++rr) {
        if ((cm >> rr) & 1u) {
          const float* w = F.w[rr];
          float d[3], Jv[3];
          for (int k = 0; k < 3; ++k) d[k] = F.com[b][k] - F.o[rot_body(rr)][k];
          cross(w, d, Jv);
          const float qj = qd[rot_dof(rr)];
          for (int k = 0; k < 3; ++k) {
            v[k] = v[k] + qj * Jv[k];
            om[k] = om[k] + qj * w[k];
          }
        }
      }
      float u[3];
      matTvec(F.R[b], om, u);
      const float* I = m.inertia[b];
      ke = ke + 0.5f * m.mass[b] * dot(v, v);
      ke = ke + 0.5f * (I[0] * u[0] * u[0] + I[1] * u[1] * u[1] + I[2] * u[2] * u[2]);
    }
    return ke;
  }

  // spatial_batched.stored_energy_rows, given the kinetic energy ke
  SPATIAL_HD static float stored_energy(const Params& m, const float* q, const Frames& F,
                                        float ke) {
    float e = ke;
#pragma unroll 1
    for (int b = 0; b < NBODY; ++b) e = e + m.grav_mass[b] * F.com[b][2];
    const float half_ls = 0.5f * m.limit_stiffness;
#pragma unroll
    for (int j = 0; j < NDOF; ++j) {
      if ((m.spring_mask >> j) & 1u) {
        const float d = q[j] - m.springref[j];
        e = e + 0.5f * m.stiffness[j] * (d * d);
      }
      if ((m.hi_mask >> j) & 1u) {
        const float d = fmaxf(q[j] - m.limit_hi[j], 0.f);
        e = e + half_ls * (d * d);
      }
      if ((m.lo_mask >> j) & 1u) {
        const float d = fmaxf(m.limit_lo[j] - q[j], 0.f);
        e = e + half_ls * (d * d);
      }
    }
    const float half_kp = 0.5f * m.contact_kp;
#pragma unroll 1
    for (int g = 0; g < NGEOM; ++g) {
      const int gb = m.geom_body[g];
      float p[3];
      point(F.o[gb], F.R[gb], m.geom_pos[g], p);
      const float pen = fmaxf(m.geom_radius[g] - p[2], 0.f);
      if (m.finite_fmax) {
        const float lo = fminf(pen, m.pen_star);
        e = e + half_kp * (lo * lo);
        e = e + m.contact_fmax * fmaxf(pen - m.pen_star, 0.f);
      } else {
        e = e + half_kp * (pen * pen);
      }
    }
    return e;
  }

  // spatial_batched.contact_tau_rows, added into tau
  SPATIAL_HD static void add_contact_tau(const Params& m, const float* qd, const Frames& F,
                                         float* tau) {
    const float kp = m.contact_kp, kd = m.contact_kd, kt = m.friction_kt, mu = m.friction_mu;
#pragma unroll 1
    for (int g = 0; g < NGEOM; ++g) {
      const int gb = m.geom_body[g];
      const unsigned cm = m.geom_chain_mask[g];
      float p[3];
      point(F.o[gb], F.R[gb], m.geom_pos[g], p);
      float v[3];
      for (int k = 0; k < 3; ++k) v[k] = FREE ? qd[k] : 0.f;
      float Jc[NROT][3];
#pragma unroll
      for (int rr = 0; rr < NROT; ++rr) {
        if ((cm >> rr) & 1u) {
          float d[3];
          for (int k = 0; k < 3; ++k) d[k] = p[k] - F.o[rot_body(rr)][k];
          cross(F.w[rr], d, Jc[rr]);
          const float qj = qd[rot_dof(rr)];
          for (int k = 0; k < 3; ++k) v[k] = v[k] + qj * Jc[rr][k];
        }
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
      if (FREE)
        for (int k = 0; k < 3; ++k) tau[k] = tau[k] + f[k];
#pragma unroll
      for (int rr = 0; rr < NROT; ++rr)
        if ((cm >> rr) & 1u) tau[rot_dof(rr)] = tau[rot_dof(rr)] + dot(Jc[rr], f);
    }
  }

  // One control step in place (spatial_batched.step_rows); ctrl already clipped.
  SPATIAL_HD static void control_step(const Params& m, float* q, float* qd,
                                      const float* ctrl) {
    const float dt = m.dt_sub;
    Frames F;

    // ---- once per control step -----------------------------------------
    fk(m, q, F);
    float M[NTRI], bias[NDOF];
    mass_bias(m, qd, F, M, bias);
#pragma unroll
    for (int rr = 0; rr < NROT; ++rr) M[tri(rot_dof(rr), rot_dof(rr))] += 1e-6f;
    const float e0 = m.valve ? stored_energy(m, q, F, kinetic(m, qd, F)) : 0.f;

    float L[NTRI], Linv[NDOF];
#pragma unroll
    for (int i = 0; i < NDOF; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = M[tri(i, j)];
        if (i == j) {
          const bool viol = q[i] > m.limit_hi[i] || q[i] < m.limit_lo[i];
          const float d = m.damping[i] + (viol ? m.limit_damping : 0.f);
          s = s + dt * d;
        }
        const float a_ii = s;
#pragma unroll
        for (int k = 0; k < j; ++k) s = s - L[tri(i, k)] * L[tri(j, k)];
        if (i == j) {
          // pivot floor relative to the diagonal, as in the JAX engine
          L[tri(i, i)] = sqrtf(fmaxf(s, fmaxf(1e-5f * a_ii, 1e-9f)));
        } else {
          L[tri(i, j)] = s / L[tri(j, j)];
        }
      }
      Linv[i] = 1.f / L[tri(i, i)];
    }

    float tau_ctrl[NDOF];
#pragma unroll
    for (int j = 0; j < NDOF; ++j) {
      tau_ctrl[j] = 0.f;
#pragma unroll
      for (int a = 0; a < NACT; ++a)
        if (m.actuator_dof[a] == j) tau_ctrl[j] += m.gear[a] * ctrl[a];
    }

    // ---- substeps ---------------------------------------------------------
    float work = 0.f;
#pragma unroll 1
    for (int s = 0; s < m.n_substeps; ++s) {
      fk(m, q, F);
      float tau_c[NDOF];
#pragma unroll
      for (int j = 0; j < NDOF; ++j) tau_c[j] = 0.f;
      add_contact_tau(m, qd, F, tau_c);

      float taus[NDOF], b[NDOF];
#pragma unroll
      for (int j = 0; j < NDOF; ++j) {
        const bool actuated = (m.actuated_mask >> j) & 1u;
        float t = tau_ctrl[j];
        if (m.finite_motor && actuated) {
          const float sgn = (t > 0.f) ? 1.f : ((t < 0.f) ? -1.f : 0.f);
          t = t * clampf(1.f - qd[j] * sgn / m.motor_omega_max, 0.f, 1.f);
        }
        taus[j] = t;
        float spring = 0.f;
        if ((m.spring_mask >> j) & 1u) spring = -m.stiffness[j] * (q[j] - m.springref[j]);
        if ((m.hi_mask >> j) & 1u)
          spring = spring - m.limit_stiffness * fmaxf(q[j] - m.limit_hi[j], 0.f);
        if ((m.lo_mask >> j) & 1u)
          spring = spring + m.limit_stiffness * fmaxf(m.limit_lo[j] - q[j], 0.f);
        b[j] = dt * (t + spring + tau_c[j] - bias[j]);
      }
#pragma unroll
      for (int i = 0; i < NDOF; ++i) {
        float acc = b[i];
#pragma unroll
        for (int j = 0; j < NDOF; ++j) acc = acc + M[sym(i, j)] * qd[j];
        b[i] = acc;
      }
      // L y = b, then L^T x = y
#pragma unroll
      for (int i = 0; i < NDOF; ++i) {
        float acc = b[i];
#pragma unroll
        for (int k = 0; k < i; ++k) acc = acc - L[tri(i, k)] * b[k];
        b[i] = acc * Linv[i];
      }
#pragma unroll
      for (int i = NDOF - 1; i >= 0; --i) {
        float acc = b[i];
#pragma unroll
        for (int k = i + 1; k < NDOF; ++k) acc = acc - L[tri(k, i)] * b[k];
        b[i] = acc * Linv[i];
      }
      float dw = 0.f;
#pragma unroll
      for (int j = 0; j < NDOF; ++j) {
        qd[j] = clampf(b[j], -m.max_qd[j], m.max_qd[j]);
        q[j] = q[j] + dt * qd[j];
        if ((m.actuated_mask >> j) & 1u) dw = dw + taus[j] * qd[j];
      }
      if (m.valve) work = work + dt * dw;
    }

    // ---- energy valve ----------------------------------------------------
    if (m.valve) {
      const float bound = e0 + fmaxf(work, 0.f) + m.valve_eps;
      fk(m, q, F);
      const float ke1 = kinetic(m, qd, F);
      const float e1 = stored_energy(m, q, F, ke1);
      const float excess = e1 - bound;
      const float scale2 = clampf((ke1 - excess) / fmaxf(ke1, 1e-9f), 0.f, 1.f);
      const float sf = sqrtf(scale2);
#pragma unroll
      for (int j = 0; j < NDOF; ++j) qd[j] = qd[j] * sf;
    }
  }
};

// The whole rollout of trajectory p. Layouts are trajectory-minor, so that
// neighbouring trajectories read and write neighbouring addresses:
// q0, qd0 [NDOF, P]; acts [h, NACT, P]; qs, qds [h, NDOF, P].
template <int NDOF, int NBODY, int NGEOM, int NACT>
SPATIAL_HD void spatial_rollout_one(const SpatialParams<NDOF, NBODY, NGEOM, NACT>& m,
                                    const float* q0, const float* qd0, const float* acts,
                                    float* qs, float* qds, long long P, int h,
                                    long long p) {
  using Eng = Spatial<NDOF, NBODY, NGEOM, NACT>;
  float q[NDOF], qd[NDOF];
#pragma unroll
  for (int i = 0; i < NDOF; ++i) {
    q[i] = q0[i * P + p];
    qd[i] = qd0[i * P + p];
  }
#pragma unroll 1
  for (int t = 0; t < h; ++t) {
    float ctrl[spatial_at_least_one(NACT)];
#pragma unroll
    for (int a = 0; a < NACT; ++a) ctrl[a] = acts[((long long)t * NACT + a) * P + p];
    Eng::control_step(m, q, qd, ctrl);
#pragma unroll
    for (int i = 0; i < NDOF; ++i) {
      qs[((long long)t * NDOF + i) * P + p] = q[i];
      qds[((long long)t * NDOF + i) * P + p] = qd[i];
    }
  }
}

}  // namespace icem
