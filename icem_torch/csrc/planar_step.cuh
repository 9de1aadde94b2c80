// Planar rigid-body rollout for one trajectory: the body of the rollout
// kernel, written once for the device (planar_rollout.cu) and the host
// (planar_rollout_host.cpp, a test-only build with g++).
//
// It computes what icem_torch/envs/physics/batched.py::step_rows computes
// (the plain version), looped over the horizon:
// - once per control step: forward kinematics, the mass matrix and the bias
//   (Coriolis + gravity) from planar point-Jacobians, the +1e-6 diagonal,
//   implicit damping, and the Cholesky factor with inverse pivots;
// - per substep: forward kinematics, penalty contacts with clamped Coulomb
//   friction, spring and limit torques, the optional motor speed line, the
//   optional fluid drag, b = M qd + dt * rhs, two triangular solves, the
//   max_qd clip and a semi-implicit Euler update.
//
// Layout: a group of G lanes per trajectory (a template argument: the
// kernel has a throughput and a latency instantiation, planar_rollout.cu).
// What another lane reads (q, qd, the packed lower triangles of M and L,
// the inverse pivots, the frames, the per-body and per-geom terms, the
// right-hand side) lives in the trajectory's workspace (Work), in shared
// memory on the device; what
// only the owning lane reads (its dofs' bias and tau_ctrl) stays in its
// registers (Regs). The step is a sequence of phases, each a function
// (params, workspace, lane[, regs]): lane l takes items l, l + G, l + 2G,
// ... of whatever the phase runs over (dofs, bodies, geoms, rows), and lane
// 0 alone runs the Cholesky factor and the two triangular solves, chains of
// dependent rows. A phase writes only its own lane's slots and reads only
// slots written in earlier phases, so the lanes run it at once and then
// meet at __syncwarp(), and the host runs it for lanes 0..G-1 one after the
// other with the same result (lanes.cuh).
//
// Every sum adds its terms in the serial body's order. What still differs
// from the plain version is FMA contraction: built with -fmad=false the
// kernel gives the plain version's bits at every shape, but runs about 9 %
// slower (PERF.md).
//
// The tree (parents, ancestor chains, which body a geom sits on,
// which dof an actuator drives) is data in PlanarParams. A free root is
// recognised at compile time from NDOF == NBODY + 2.

#pragma once

#include <math.h>

#include "lanes.cuh"

#ifdef __CUDACC__
#define PLANAR_HD __host__ __device__ __forceinline__
// constexpr functions are host-only under nvcc unless marked for the device
#define PLANAR_CE __host__ __device__ constexpr
#else
#define PLANAR_HD inline
#define PLANAR_CE constexpr
#endif

namespace icem {

// C++ has no zero-length arrays: a model without geoms or actuators keeps a
// one-element placeholder that no loop reads.
PLANAR_CE int at_least_one(int n) { return n > 0 ? n : 1; }

// The lanes that run one trajectory, a group of consecutive lanes of a warp,
// in B1's two instantiations. Throughput: 2, so that the planner's largest
// population fills the card in one wave. Latency: the smallest power of two
// that holds the shape's largest item count, so that each lane takes at most
// one dof, body, geom and row in every phase and each phase is one pass.
constexpr int kPlanarThroughputLanes = 2;
PLANAR_CE int planar_latency_lanes(int ndof, int nbody, int ngeom, int nact) {
  int n = ndof > nbody ? ndof : nbody;
  n = n > ngeom ? n : ngeom;
  n = n > nact ? n : nact;
  int g = 2;
  while (g < n) g *= 2;
  return g;
}
template <int NDOF, int NBODY, int NGEOM, int NACT, int LATENCY>
PLANAR_CE int planar_lanes() {
  return LATENCY ? planar_latency_lanes(NDOF, NBODY, NGEOM, NACT) : kPlanarThroughputLanes;
}

// Phase groups of a control step, for the profile build (-DICEM_PLANAR_PROFILE):
// lane 0 of the group charges the clock64() cycles since the last mark to
// the group that just ended. Other builds compile the marks to nothing.
enum PlanarProfGroup {
  kPlanarProfIo,        // loading q, qd and ctrl, storing q and qd
  kPlanarProfStepFk,    // the start of step's forward kinematics
  kPlanarProfMassRows,  // COMs, velocities, rows of M, bias, tau_ctrl
  kPlanarProfCholesky,
  kPlanarProfSubFk,     // the substeps' forward kinematics
  kPlanarProfContact,   // per-geom contact forces, per-body drag
  kPlanarProfRhs,       // b = dt * (...) + M qd
  kPlanarProfSolve,     // L L^T qd = b, the clip and the Euler step
  kPlanarProfGroups
};

// Every field is 4 bytes wide, so the struct has no padding and its layout
// is the field order; ops/planar_rollout.py::_param_dtype packs the same
// order and checks sizeof through planar_params_bytes_*.
template <int NDOF, int NBODY, int NGEOM, int NACT>
struct PlanarParams {
  int parent[NBODY];                      // parent[0] == -1; parents first
  int anc_mask[NBODY];                    // bit c: body c on the chain root..b
  int geom_body[at_least_one(NGEOM)];
  int geom_anc_mask[at_least_one(NGEOM)];  // anc_mask of the geom's body
  int actuator_dof[at_least_one(NACT)];
  int actuated_mask;                      // bit j: dof j has an actuator
  int has_drag;
  int finite_motor;
  int n_substeps;
  float anchor[NBODY][2];
  float com[NBODY][2];
  float mass[NBODY];
  float inertia[NBODY];
  float geom_pos[at_least_one(NGEOM)][2];
  float geom_radius[at_least_one(NGEOM)];
  float gear[at_least_one(NACT)];
  float damping[NDOF];
  float stiffness[NDOF];
  float springref[NDOF];
  float limit_lo[NDOF];                   // -inf: no lower limit
  float limit_hi[NDOF];                   // +inf: no upper limit
  float drag_normal[NBODY];
  float drag_tangent[NBODY];
  float drag_angular[NBODY];
  float limit_stiffness;
  float limit_damping;
  float gravity;
  float contact_kp;
  float contact_kd;
  float contact_fmax;
  float friction_mu;
  float friction_kt;
  float max_qd;
  float motor_omega_max;
  float dt_sub;
  float root_mass;                        // free root: M_00 = M_11, the body masses + 1e-6
};

// Core followed by PAD floats of padding
template <class Core, int PAD>
struct PaddedTo : Core {
  float pad_[PAD];
};
template <class Core>
struct PaddedTo<Core, 0> : Core {};

template <int NDOF, int NBODY, int NGEOM, int NACT, int G>
struct Planar {
  using Params = PlanarParams<NDOF, NBODY, NGEOM, NACT>;
  static constexpr bool FREE = (NDOF == NBODY + 2);
  static_assert(FREE || NDOF == NBODY, "a planar tree has NBODY or NBODY+2 dofs");
  static_assert(NBODY <= 31, "ancestor chains are 32-bit masks");
  static_assert(G >= 2 && G <= 32 && 32 % G == 0, "the groups of lanes tile the warp");
  static constexpr int NTRI = NDOF * (NDOF + 1) / 2;
  static constexpr int NGEOM1 = at_least_one(NGEOM);
  static constexpr int KD = (NDOF + G - 1) / G;  // dofs a lane owns

  // The rotational dof of body c. For a free root, body 0's is the root
  // rotation (dof 2), so the formula holds for every body.
  PLANAR_CE static int dof(int c) { return FREE ? 2 + c : c; }
  // the body whose hinge is rotational dof j (j >= 2 for a free root)
  PLANAR_CE static int dof_body(int j) { return FREE ? j - 2 : j; }
  // Packed lower triangle, i >= j.
  PLANAR_CE static int tri(int i, int j) { return i * (i + 1) / 2 + j; }
  PLANAR_CE static int sym(int i, int j) { return i >= j ? tri(i, j) : tri(j, i); }

  static constexpr int NDOF4 = (NDOF + 3) / 4 * 4;

  // One trajectory's shared state and scratch: one per group of lanes, in
  // shared memory (one per trajectory on the host). Lane l owns the slots of
  // its items l, l + G, ... of each per-dof, per-body and per-geom array, and
  // those rows of M; lane 0 writes L, its inverse pivots, and the solves' q
  // and qd.
  //
  // The rows that a group reads at one body or geom come first, as 16-byte
  // rows, so that one access moves each: the groups of a warp read the same
  // slot of their own workspaces, 32 / G rows of 16 bytes. The union holds
  // arrays whose lifetimes do not overlap: the once-per-step kinematics end
  // with the rows of M, before the first substep writes its contact and
  // drag forces.
  struct alignas(16) WorkCore {
#ifdef ICEM_PLANAR_PROFILE
    static constexpr bool kProfile = true;
#else
    static constexpr bool kProfile = false;
#endif
    float fr[NBODY][4];                     // frames: ox, oz, cos, sin
    float qd[NDOF4];                        // padded to 16-byte rows
    union {
      struct {  // once per control step
        float kin[NBODY][4];                // COM cx, cz; joint-origin velocity vox, voz
        float acc[NBODY][2];                // COM acceleration ax, az at qdd = 0
      } st;
      struct {  // per substep
        float geo[NGEOM1][4];               // contact point px, pz; forces fn, ft
        float fx[NBODY], fz[NBODY], torque[NBODY];  // drag
      } sub;
    };
    float q[NDOF];
    float M[NTRI], L[NTRI];                 // packed lower triangles
    float linv[NDOF];                       // inverse pivots of L
    float b[NDOF];                          // the right-hand side of the solves
#ifdef ICEM_PLANAR_PROFILE
    long long prof[kPlanarProfGroups];      // cycles per phase group (lane 0)
    long long prof_t;                       // clock64() at the last mark
#endif
  };
  // The workspaces of a warp's groups lie one after the other. At G >= 4 a
  // stride of G (mod 32) words puts group k's lanes on banks k G ..
  // k G + G - 1, so the groups' accesses to the same slot of their own
  // workspaces do not meet on a bank. At G = 2 the 16 groups cannot take 16
  // banks with 16-byte rows; a stride of 4 (mod 8) words puts two on each of
  // 8, the fewest, and pads the least.
  static constexpr int kStrideMod = G < 4 ? 8 : 32;
  static constexpr int kStrideRem = G < 4 ? 4 : G;
  static constexpr int kWords = (int)(sizeof(WorkCore) / 4);
  using Work = PaddedTo<WorkCore, ((kStrideRem - kWords) % kStrideMod + kStrideMod) % kStrideMod>;
  static_assert(sizeof(Work) % 16 == 0 && (sizeof(Work) / 4) % kStrideMod == kStrideRem,
                "the workspace stride is G (mod 32) words, or 4 (mod 8) at G = 2");

  // What only the owning lane reads, for its dofs j = l + k G (index k):
  // held in registers for the whole control step.
  struct Regs {
    float bias[KD], tau_ctrl[KD];
  };

  // f(i, k) for the items i = l + k G < N of lane l
  template <int N, class F>
  PLANAR_HD static void items(int l, const F& f) {
#pragma unroll
    for (int k = 0; k < (N + G - 1) / G; ++k) {
      const int i = l + k * G;
      if (i < N) f(i, k);
    }
  }

  // 2 and 4 consecutive floats of the workspace, one access each on the device
  PLANAR_HD static void ld2(const float* p, float& a, float& b) {
#ifdef __CUDA_ARCH__
    const float2 t = *reinterpret_cast<const float2*>(p);
    a = t.x;
    b = t.y;
#else
    a = p[0];
    b = p[1];
#endif
  }
  PLANAR_HD static void st2(float* p, float a, float b) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
#else
    p[0] = a;
    p[1] = b;
#endif
  }
  PLANAR_HD static void ld4(const float* p, float* v) {
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
  PLANAR_HD static void st4(float* p, float a, float b, float c, float d) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
#else
    p[0] = a;
    p[1] = b;
    p[2] = c;
    p[3] = d;
#endif
  }

  PLANAR_HD static float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
  }

  // f(c) for the bodies c of `mask` (an ancestor chain), ascending, so root
  // first: a loop over the mask's set bits only, which issues fewer
  // instructions than one unrolled over every body with the chain as a
  // predicate
  template <class F>
  PLANAR_HD static void for_chain(unsigned mask, const F& f) {
    for (unsigned bits = mask; bits; bits &= bits - 1) f(lowest_bit(bits));
  }

  // Velocity of a point (px, pz) carried by the hinges in `mask`.
  PLANAR_HD static void point_vel(const Work& W, float px, float pz, unsigned mask,
                                  float& vx, float& vz) {
    if (FREE) {
      ld2(W.qd, vx, vz);
    } else {
      vx = 0.f;
      vz = 0.f;
    }
    for_chain(mask, [&](int c) {
      const float w = W.qd[dof(c)];
      float ox, oz;
      ld2(W.fr[c], ox, oz);
      vx = vx - w * (pz - oz);
      vz = vz + w * (px - ox);
    });
  }

  // body b's COM from its frame f = (ox, oz, cos, sin)
  PLANAR_HD static void com_of(const Params& m, const float* f, int b, float& cx, float& cz) {
    cx = f[0] + f[2] * m.com[b][0] - f[3] * m.com[b][1];
    cz = f[1] + f[3] * m.com[b][0] + f[2] * m.com[b][1];
  }

  // ---- forward kinematics (batched.py::_fk_core)

  // lane b: body b's angle, summed along its chain from the root as the
  // serial recursion sums it, and its sine and cosine; body 0's lane also
  // places the root
  PLANAR_HD static void fk_angles(const Params& m, Work& W, int l) {
    items<NBODY>(l, [&](int b, int) {
      float a = W.q[dof(0)];
      for_chain((unsigned)m.anc_mask[b] & ~1u, [&](int c) { a = a + W.q[dof(c)]; });
      float s, c;
      sincosf(a, &s, &c);
      st2(W.fr[b] + 2, c, s);
      if (b == 0) {
        if (FREE) st2(W.fr[0], W.q[0] + m.anchor[0][0], W.q[1] + m.anchor[0][1]);
        else st2(W.fr[0], m.anchor[0][0], m.anchor[0][1]);
      }
    });
  }

  // lane b: body b's origin, placed from the root's down its chain with the
  // serial recursion's expression at every joint, so with its roundings,
  // from the angles' sines and cosines. Each lane walks its own chain: one
  // phase in place of one per tree level.
  PLANAR_HD static void fk_origins(const Params& m, Work& W, int l) {
    items<NBODY>(l, [&](int b, int) {
      if (b == 0) return;
      float x, z;
      ld2(W.fr[0], x, z);
      for_chain((unsigned)m.anc_mask[b] & ~1u, [&](int c) {
        float cs, sn;  // the parent's, on the chain before c
        ld2(W.fr[m.parent[c]] + 2, cs, sn);
        const float nx = x + cs * m.anchor[c][0] - sn * m.anchor[c][1];
        z = z + sn * m.anchor[c][0] + cs * m.anchor[c][1];
        x = nx;
      });
      st2(W.fr[b], x, z);
    });
  }

  template <class Lanes>
  PLANAR_HD static void fk(const Params& m, Work& W, const Lanes& for_lanes) {
    for_lanes([&](int l) { fk_angles(m, W, l); });
    for_lanes([&](int l) { fk_origins(m, W, l); });
  }

  // ---- once per control step: M, bias, the factor (batched.py::mass_bias_batched)

  // lane b: body b's COM and the velocity of its joint origin, which moves
  // with its parent's chain
  PLANAR_HD static void step_kinematics(const Params& m, Work& W, int l) {
    items<NBODY>(l, [&](int b, int) {
      float f[4];
      ld4(W.fr[b], f);
      float cx, cz, vx, vz;
      com_of(m, f, b, cx, cz);
      point_vel(W, f[0], f[1], (unsigned)m.anc_mask[b] & ~(1u << b), vx, vz);
      st4(W.st.kin[b], cx, cz, vx, vz);
    });
  }

  // lane b: body b's COM acceleration at qdd = 0
  PLANAR_HD static void body_accel(const Params& m, Work& W, int l) {
    items<NBODY>(l, [&](int b, int) {
      const unsigned mask = (unsigned)m.anc_mask[b];
      float cx, cz, vcx, vcz;
      ld2(W.st.kin[b], cx, cz);
      point_vel(W, cx, cz, mask, vcx, vcz);
      float ax = 0.f, az = 0.f;
      for_chain(mask, [&](int c) {
        const float w = W.qd[dof(c)];
        float vox, voz;
        ld2(W.st.kin[c] + 2, vox, voz);
        ax = ax - w * (vcz - voz);
        az = az + w * (vcx - vox);
      });
      st2(W.st.acc[b], ax, az);
    });
  }

  // lane j: row j of M (entries M_jk, k <= j) with its +1e-6 diagonal,
  // bias[j] and tau_ctrl[j] from this step's
  // actions ctrl (device memory). Each entry adds its bodies' terms in
  // ascending body order, as the serial sum did.
  PLANAR_HD static void mass_row(const Params& m, Work& W, int l, Regs& r, const float* ctrl) {
    const float g = m.gravity;
    items<NDOF>(l, [&](int j, int k) {
      float row[NDOF];
#pragma unroll
      for (int i = 0; i < NDOF; ++i) row[i] = 0.f;
      float bias = 0.f;
      if (FREE && j < 2) {  // the root's translations: identity columns
#pragma unroll
        for (int b = 0; b < NBODY; ++b) {
          const float mb = m.mass[b];
          float ax, az;
          ld2(W.st.acc[b], ax, az);
          bias += j == 0 ? mb * ax : mb * (az + g);
        }
      } else {
        const int ci = dof_body(j);
        float oxi, ozi;
        ld2(W.fr[ci], oxi, ozi);
#pragma unroll
        for (int b = 0; b < NBODY; ++b) {
          const unsigned mask = (unsigned)m.anc_mask[b];
          if (!((mask >> ci) & 1u)) continue;
          const float mb = m.mass[b];
          float cx, cz, ax, az;
          ld2(W.st.kin[b], cx, cz);
          ld2(W.st.acc[b], ax, az);
          const float aix = -(cz - ozi);
          const float aiz = cx - oxi;
          if (FREE) {
            row[0] += mb * aix;
            row[1] += mb * aiz;
          }
#pragma unroll
          for (int cj = 0; cj < NBODY; ++cj) {
            if (cj <= ci && ((mask >> cj) & 1u)) {
              float oxj, ozj;
              ld2(W.fr[cj], oxj, ozj);
              const float ajx = -(cz - ozj);
              const float ajz = cx - oxj;
              row[dof(cj)] += mb * (aix * ajx + aiz * ajz);
              row[dof(cj)] += m.inertia[b];
            }
          }
          bias += mb * (aix * ax + aiz * (az + g));
        }
      }
      float diag = 0.f;
#pragma unroll
      for (int i = 0; i < NDOF; ++i) {
        if (i < j) W.M[tri(j, i)] = row[i];
        if (i == j) diag = row[i] + 1e-6f;  // in lhs and in M qd
      }
      if (FREE && j < 2) diag = m.root_mass;
      W.M[tri(j, j)] = diag;
      float t = 0.f;
#pragma unroll
      for (int a = 0; a < NACT; ++a)
        if (m.actuator_dof[a] == j) t += m.gear[a] * ctrl[a];
      r.bias[k] = bias;
      r.tau_ctrl[k] = t;
    });
  }

  // lane 0: the Cholesky factor of A = M + dt D (D: joint damping, plus
  // limit damping where a limit is violated), row by row as the serial
  // factor runs it: each entry's k-sum ascending, the pivot floored relative
  // to the damped diagonal, as in the JAX engine; and its inverse pivots.
  // Each row needs the rows above it, so one lane takes the factor whole, at
  // compile-time offsets, in one phase.
  PLANAR_HD static void cholesky(const Params& m, Work& W, int l) {
    if (l != 0) return;
#pragma unroll
    for (int i = 0; i < NDOF; ++i) {
#pragma unroll
      for (int j = 0; j < i; ++j) {
        float acc = W.M[tri(i, j)];
#pragma unroll
        for (int k = 0; k < j; ++k) acc = acc - W.L[tri(i, k)] * W.L[tri(j, k)];
        W.L[tri(i, j)] = acc / W.L[tri(j, j)];
      }
      const float qi = W.q[i];
      const bool viol = qi > m.limit_hi[i] || qi < m.limit_lo[i];
      const float a_ii =
          W.M[tri(i, i)] + m.dt_sub * (m.damping[i] + (viol ? m.limit_damping : 0.f));
      float acc = a_ii;
#pragma unroll
      for (int k = 0; k < i; ++k) acc = acc - W.L[tri(i, k)] * W.L[tri(i, k)];
      const float l_ii = sqrtf(fmaxf(acc, fmaxf(1e-5f * a_ii, 1e-9f)));
      W.L[tri(i, i)] = l_ii;
      W.linv[i] = 1.f / l_ii;
    }
  }

  // ---- per substep (batched.py::_contact_tau, _drag_tau, step_rows)

  // lane g: geom g's contact point and penalty forces; where the model has
  // drag, lane b: body b's drag force and torque
  PLANAR_HD static void contact_drag(const Params& m, Work& W, int l) {
    const float kp = m.contact_kp, kd = m.contact_kd, fmax = m.contact_fmax;
    const float mu = m.friction_mu, kt = m.friction_kt;
    items<NGEOM>(l, [&](int g, int) {
      float f[4];
      ld4(W.fr[m.geom_body[g]], f);
      const float gx = m.geom_pos[g][0], gz = m.geom_pos[g][1];
      const float px = f[0] + f[2] * gx - f[3] * gz;
      const float pz = f[1] + f[3] * gx + f[2] * gz;
      float vx, vz;
      point_vel(W, px, pz, (unsigned)m.geom_anc_mask[g], vx, vz);
      const float phi = pz - m.geom_radius[g];
      float fn = fmaxf(-kp * phi - kd * vz, 0.f);
      fn = fminf(fn, fmax);
      fn = phi < 0.f ? fn : 0.f;
      st4(W.sub.geo[g], px, pz, fn, -clampf(kt * vx, -mu * fn, mu * fn));
    });
    if (!m.has_drag) return;
    items<NBODY>(l, [&](int b, int) {
      const unsigned mask = (unsigned)m.anc_mask[b];
      float f[4], cx, cz;
      ld4(W.fr[b], f);
      com_of(m, f, b, cx, cz);
      float vcx = FREE ? W.qd[0] : 0.f, vcz = FREE ? W.qd[1] : 0.f, vang = 0.f;
      for_chain(mask, [&](int c) {
        const float w = W.qd[dof(c)];
        float ox, oz;
        ld2(W.fr[c], ox, oz);
        vcx = vcx - w * (cz - oz);
        vcz = vcz + w * (cx - ox);
        vang = vang + w;
      });
      const float cs = f[2], sn = f[3];
      const float vt = vcx * cs + vcz * sn;
      const float vn = -vcx * sn + vcz * cs;
      const float ct = m.drag_tangent[b], cn = m.drag_normal[b];
      W.sub.fx[b] = -(ct * vt * cs - cn * vn * sn);
      W.sub.fz[b] = -(ct * vt * sn + cn * vn * cs);
      W.sub.torque[b] = -m.drag_angular[b] * vang;
    });
  }

  // lane j: dof j's contact torque (geoms ascending), drag torque (bodies
  // ascending), motor line, spring and limit torques, then
  // b_j = dt * (...) + sum_i M_ji qd_i, i ascending
  PLANAR_HD static void rhs_row(const Params& m, Work& W, int l, const Regs& r) {
    const float dt = m.dt_sub;
    items<NDOF>(l, [&](int j, int k) {
      const bool trans = FREE && j < 2;
      const int c = trans ? 0 : dof_body(j);
      float oxc, ozc;
      ld2(W.fr[c], oxc, ozc);
      float tau_c = 0.f;
#pragma unroll
      for (int g = 0; g < NGEOM; ++g) {
        float e[4];  // px, pz, fn, ft
        ld4(W.sub.geo[g], e);
        if (trans) {
          tau_c += j == 0 ? e[3] : e[2];
        } else if ((m.geom_anc_mask[g] >> c) & 1) {
          const float dx = e[0] - oxc;
          const float dz = e[1] - ozc;
          tau_c += -dz * e[3] + dx * e[2];
        }
      }
      float tau_d = 0.f;
      if (m.has_drag) {
#pragma unroll
        for (int b = 0; b < NBODY; ++b) {
          if (trans) {
            tau_d += j == 0 ? W.sub.fx[b] : W.sub.fz[b];
          } else if ((m.anc_mask[b] >> c) & 1) {
            float f[4], cx, cz;
            ld4(W.fr[b], f);
            com_of(m, f, b, cx, cz);
            const float jx = -(cz - ozc);
            const float jz = cx - oxc;
            tau_d += jx * W.sub.fx[b] + jz * W.sub.fz[b] + W.sub.torque[b];
          }
        }
      }
      const float qj = W.q[j], qdj = W.qd[j];
      float t = r.tau_ctrl[k];
      if (m.finite_motor && ((m.actuated_mask >> j) & 1)) {
        const float sgn = (t > 0.f) ? 1.f : ((t < 0.f) ? -1.f : 0.f);
        t = t * clampf(1.f - qdj * sgn / m.motor_omega_max, 0.f, 1.f);
      }
      float spring = -m.stiffness[j] * (qj - m.springref[j]);
      spring = spring - m.limit_stiffness * fmaxf(qj - m.limit_hi[j], 0.f);
      spring = spring + m.limit_stiffness * fmaxf(m.limit_lo[j] - qj, 0.f);
      float rr = t + spring + tau_c - r.bias[k];
      if (m.has_drag) rr = rr + tau_d;
      float acc = dt * rr;
#pragma unroll
      for (int i4 = 0; i4 < NDOF; i4 += 4) {
        float v[4];
        ld4(W.qd + i4, v);
#pragma unroll
        for (int i = i4; i < i4 + 4 && i < NDOF; ++i) acc = acc + W.M[sym(j, i)] * v[i - i4];
      }
      W.b[j] = acc;
    });
  }

  // lane 0: L L^T qd = b by rows, as the serial solve runs it (each row's
  // sum k ascending, then times its inverse pivot), the velocity clip and
  // the semi-implicit Euler step. The solves are one chain of dependent
  // rows: one lane takes them whole, its operands at compile-time offsets,
  // where a sweep split by columns would meet the other lanes at a
  // __syncwarp() per column.
  PLANAR_HD static void solve_euler(const Params& m, Work& W, int l) {
    if (l != 0) return;
    float x[NDOF];
#pragma unroll
    for (int i = 0; i < NDOF; ++i) {
      float acc = W.b[i];
#pragma unroll
      for (int k = 0; k < i; ++k) acc = acc - W.L[tri(i, k)] * x[k];
      x[i] = acc * W.linv[i];
    }
#pragma unroll
    for (int i = NDOF - 1; i >= 0; --i) {
      float acc = x[i];
#pragma unroll
      for (int k = i + 1; k < NDOF; ++k) acc = acc - W.L[tri(k, i)] * x[k];
      x[i] = acc * W.linv[i];
    }
#pragma unroll
    for (int j = 0; j < NDOF; ++j) {
      const float qdj = clampf(x[j], -m.max_qd, m.max_qd);
      W.qd[j] = qdj;
      W.q[j] = W.q[j] + m.dt_sub * qdj;
    }
  }

  // One control step of the workspace's state (batched.py::step_rows) under
  // the step's clipped actions ctrl (device memory): once per step, 6
  // phases; per substep, 5.
  template <class Lanes>
  PLANAR_HD static void control_step(const Params& m, Work& W, const Lanes& for_lanes,
                                     const float* ctrl) {
    typename Lanes::template Own<Regs> regs{};
    // ---- once per control step: M, bias, the factor
    fk(m, W, for_lanes);
    for_lanes.mark(W, kPlanarProfStepFk);
    for_lanes([&](int l) { step_kinematics(m, W, l); });
    for_lanes([&](int l) { body_accel(m, W, l); });
    for_lanes([&](int l) { mass_row(m, W, l, regs(l), ctrl); });
    for_lanes.mark(W, kPlanarProfMassRows);
    for_lanes([&](int l) { cholesky(m, W, l); });
    for_lanes.mark(W, kPlanarProfCholesky);

    // ---- substeps; the first one's frames are the step's, q being unchanged
#pragma unroll 1
    for (int sub = 0; sub < m.n_substeps; ++sub) {
      if (sub > 0) fk(m, W, for_lanes);
      for_lanes.mark(W, kPlanarProfSubFk);
      for_lanes([&](int l) { contact_drag(m, W, l); });
      for_lanes.mark(W, kPlanarProfContact);
      for_lanes([&](int l) { rhs_row(m, W, l, regs(l)); });
      for_lanes.mark(W, kPlanarProfRhs);
      for_lanes([&](int l) { solve_euler(m, W, l); });
      for_lanes.mark(W, kPlanarProfSolve);
    }
  }
};

// The whole rollout of trajectory p in workspace W. Layouts are
// trajectory-major, so that a group's accesses to one trajectory's dofs are
// contiguous and a warp's groups take consecutive rows: q0 [P, NDOF] with
// row stride ldq, qd0 the same with ldqd; acts [P, h, NACT]; qs, qds
// [h, P, NDOF]. A group without a trajectory of its own (store == false)
// runs the phases on p's inputs with the others of its warp, and stores
// nothing.
template <int NDOF, int NBODY, int NGEOM, int NACT, int G, class Lanes>
PLANAR_HD void planar_rollout_one(const PlanarParams<NDOF, NBODY, NGEOM, NACT>& m,
                                  typename Planar<NDOF, NBODY, NGEOM, NACT, G>::Work& W,
                                  const Lanes& for_lanes, const float* q0, long long ldq,
                                  const float* qd0, long long ldqd, const float* acts,
                                  float* qs, float* qds, long long P, int h, long long p,
                                  bool store) {
  using Eng = Planar<NDOF, NBODY, NGEOM, NACT, G>;
  for_lanes([&](int l) {
    Eng::template items<NDOF>(l, [&](int j, int) {
      W.q[j] = q0[p * ldq + j];
      W.qd[j] = qd0[p * ldqd + j];
    });
#if defined(ICEM_PLANAR_PROFILE) && defined(__CUDA_ARCH__)
    Eng::template items<kPlanarProfGroups>(l, [&](int g, int) { W.prof[g] = 0; });
    if (l == 0) W.prof_t = clock64();
#endif
  });
#pragma unroll 1
  for (int t = 0; t < h; ++t) {
    Eng::control_step(m, W, for_lanes, acts + (p * h + t) * NACT);
    // every group meets at the phase's __syncwarp(), storing or not
    for_lanes([&](int l) {
      if (store)
        Eng::template items<NDOF>(l, [&](int j, int) {
          qs[((long long)t * P + p) * NDOF + j] = W.q[j];
          qds[((long long)t * P + p) * NDOF + j] = W.qd[j];
        });
    });
    for_lanes.mark(W, kPlanarProfIo);
  }
}

}  // namespace icem
