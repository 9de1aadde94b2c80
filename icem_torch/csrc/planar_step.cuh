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
// Register residency: every loop over dofs, bodies and geoms is unrolled at
// compile time (template <NDOF, NBODY, NGEOM, NACT>), so every index into
// q, qd, M, L and the kinematics arrays is a constant and the arrays live in
// registers. The tree (parents, ancestor chains, which body a geom sits on,
// which dof an actuator drives) is data in PlanarParams; it is read only in
// uniform conditions (`if (parent == c)`, `if (mask >> c & 1)`) and never
// used as an index into a per-thread array, which would force that array
// into local memory. A free root is recognised at compile time from
// NDOF == NBODY + 2.

#pragma once

#include <math.h>

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
};

template <int NDOF, int NBODY, int NGEOM, int NACT>
struct Planar {
  using Params = PlanarParams<NDOF, NBODY, NGEOM, NACT>;
  static constexpr bool FREE = (NDOF == NBODY + 2);
  static_assert(FREE || NDOF == NBODY, "a planar tree has NBODY or NBODY+2 dofs");
  static_assert(NBODY <= 31, "ancestor chains are 32-bit masks");
  static constexpr int NTRI = NDOF * (NDOF + 1) / 2;

  // The rotational dof of body c. For a free root, body 0's is the root
  // rotation (dof 2), so the formula holds for every body.
  PLANAR_CE static int dof(int c) { return FREE ? 2 + c : c; }
  // Packed lower triangle, i >= j.
  PLANAR_CE static int tri(int i, int j) { return i * (i + 1) / 2 + j; }
  PLANAR_CE static int sym(int i, int j) { return i >= j ? tri(i, j) : tri(j, i); }

  PLANAR_HD static float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
  }

  // Body origins and orientations (batched.py::_fk_core).
  PLANAR_HD static void fk(const Params& m, const float* q, float* ox,
                           float* oz, float* cs, float* sn) {
    float ang[NBODY];
#pragma unroll
    for (int b = 0; b < NBODY; ++b) {
      float a = 0.f, x = 0.f, z = 0.f;
      if (b == 0) {
        if (FREE) {
          a = q[2];
          x = q[0] + m.anchor[0][0];
          z = q[1] + m.anchor[0][1];
        } else {
          a = q[0];
          x = m.anchor[0][0];
          z = m.anchor[0][1];
        }
      } else {
        const int pa = m.parent[b];
#pragma unroll
        for (int c = 0; c < b; ++c) {
          if (pa == c) {
            a = ang[c] + q[dof(b)];
            x = ox[c] + cs[c] * m.anchor[b][0] - sn[c] * m.anchor[b][1];
            z = oz[c] + sn[c] * m.anchor[b][0] + cs[c] * m.anchor[b][1];
          }
        }
      }
      ox[b] = x;
      oz[b] = z;
      ang[b] = a;
      cs[b] = cosf(a);
      sn[b] = sinf(a);
    }
  }

  // Velocity of a point (px, pz) carried by the hinges in `mask`.
  PLANAR_HD static void point_vel(const float* qd, const float* ox,
                                  const float* oz, float px, float pz, int mask,
                                  float& vx, float& vz) {
    vx = FREE ? qd[0] : 0.f;
    vz = FREE ? qd[1] : 0.f;
#pragma unroll
    for (int c = 0; c < NBODY; ++c) {
      if ((mask >> c) & 1) {
        vx = vx - qd[dof(c)] * (pz - oz[c]);
        vz = vz + qd[dof(c)] * (px - ox[c]);
      }
    }
  }

  // Mass matrix (packed lower triangle) and bias (batched.py::mass_bias_batched).
  PLANAR_HD static void mass_bias(const Params& m, const float* q,
                                  const float* qd, float* M, float* bias) {
    float ox[NBODY], oz[NBODY], cs[NBODY], sn[NBODY], cx[NBODY], cz[NBODY];
    fk(m, q, ox, oz, cs, sn);
#pragma unroll
    for (int b = 0; b < NBODY; ++b) {
      cx[b] = ox[b] + cs[b] * m.com[b][0] - sn[b] * m.com[b][1];
      cz[b] = oz[b] + sn[b] * m.com[b][0] + cs[b] * m.com[b][1];
    }
#pragma unroll
    for (int k = 0; k < NTRI; ++k) M[k] = 0.f;

#pragma unroll
    for (int b = 0; b < NBODY; ++b) {
      const float mb = m.mass[b];
      const int mask = m.anc_mask[b];
      if (FREE) {  // identity columns of the root translations
        M[tri(0, 0)] += mb;
        M[tri(1, 1)] += mb;
      }
#pragma unroll
      for (int ci = 0; ci < NBODY; ++ci) {
        if ((mask >> ci) & 1) {
          const float aix = -(cz[b] - oz[ci]);
          const float aiz = cx[b] - ox[ci];
          if (FREE) {
            M[tri(dof(ci), 0)] += mb * aix;
            M[tri(dof(ci), 1)] += mb * aiz;
          }
#pragma unroll
          for (int cj = 0; cj <= ci; ++cj) {
            if ((mask >> cj) & 1) {
              const float ajx = -(cz[b] - oz[cj]);
              const float ajz = cx[b] - ox[cj];
              M[tri(dof(ci), dof(cj))] += mb * (aix * ajx + aiz * ajz);
              M[tri(dof(ci), dof(cj))] += m.inertia[b];
            }
          }
        }
      }
    }

    // velocities of the joint origins: a pivot moves with its parent's chain
    float vox[NBODY], voz[NBODY];
    vox[0] = FREE ? qd[0] : 0.f;
    voz[0] = FREE ? qd[1] : 0.f;
#pragma unroll
    for (int b = 1; b < NBODY; ++b)
      point_vel(qd, ox, oz, ox[b], oz[b], m.anc_mask[b] & ~(1 << b), vox[b], voz[b]);

#pragma unroll
    for (int j = 0; j < NDOF; ++j) bias[j] = 0.f;
    const float g = m.gravity;
#pragma unroll
    for (int b = 0; b < NBODY; ++b) {
      const float mb = m.mass[b];
      const int mask = m.anc_mask[b];
      float vcx, vcz;
      point_vel(qd, ox, oz, cx[b], cz[b], mask, vcx, vcz);
      float ax = 0.f, az = 0.f;
#pragma unroll
      for (int c = 0; c < NBODY; ++c) {
        if ((mask >> c) & 1) {
          ax = ax - qd[dof(c)] * (vcz - voz[c]);
          az = az + qd[dof(c)] * (vcx - vox[c]);
        }
      }
      if (FREE) {
        bias[0] += mb * ax;
        bias[1] += mb * (az + g);
      }
#pragma unroll
      for (int c = 0; c < NBODY; ++c) {
        if ((mask >> c) & 1) {
          const float jx = -(cz[b] - oz[c]);
          const float jz = cx[b] - ox[c];
          bias[dof(c)] += mb * (jx * ax + jz * (az + g));
        }
      }
    }
  }

  // Penalty contacts (batched.py::_contact_tau), added into tau.
  PLANAR_HD static void add_contact_tau(const Params& m, const float* qd,
                                        const float* ox, const float* oz,
                                        const float* cs, const float* sn,
                                        float* tau) {
    const float kp = m.contact_kp, kd = m.contact_kd, fmax = m.contact_fmax;
    const float mu = m.friction_mu, kt = m.friction_kt;
#pragma unroll
    for (int g = 0; g < NGEOM; ++g) {
      const int gb = m.geom_body[g];
      const int mask = m.geom_anc_mask[g];
      const float gx = m.geom_pos[g][0], gz = m.geom_pos[g][1];
      float px = 0.f, pz = 0.f;
#pragma unroll
      for (int b = 0; b < NBODY; ++b) {
        if (gb == b) {
          px = ox[b] + cs[b] * gx - sn[b] * gz;
          pz = oz[b] + sn[b] * gx + cs[b] * gz;
        }
      }
      float vx, vz;
      point_vel(qd, ox, oz, px, pz, mask, vx, vz);
      const float phi = pz - m.geom_radius[g];
      float fn = fmaxf(-kp * phi - kd * vz, 0.f);
      fn = fminf(fn, fmax);
      fn = phi < 0.f ? fn : 0.f;
      const float ft = -clampf(kt * vx, -mu * fn, mu * fn);
      if (FREE) {
        tau[0] += ft;
        tau[1] += fn;
      }
#pragma unroll
      for (int c = 0; c < NBODY; ++c) {
        if ((mask >> c) & 1) {
          const float dx = px - ox[c];
          const float dz = pz - oz[c];
          tau[dof(c)] += -dz * ft + dx * fn;
        }
      }
    }
  }

  // Anisotropic viscous drag (batched.py::_drag_tau), added into tau.
  PLANAR_HD static void add_drag_tau(const Params& m, const float* qd,
                                     const float* ox, const float* oz,
                                     const float* cs, const float* sn,
                                     float* tau) {
#pragma unroll
    for (int b = 0; b < NBODY; ++b) {
      const int mask = m.anc_mask[b];
      const float cx = ox[b] + cs[b] * m.com[b][0] - sn[b] * m.com[b][1];
      const float cz = oz[b] + sn[b] * m.com[b][0] + cs[b] * m.com[b][1];
      float vcx = FREE ? qd[0] : 0.f, vcz = FREE ? qd[1] : 0.f, vang = 0.f;
#pragma unroll
      for (int c = 0; c < NBODY; ++c) {
        if ((mask >> c) & 1) {
          vcx = vcx - qd[dof(c)] * (cz - oz[c]);
          vcz = vcz + qd[dof(c)] * (cx - ox[c]);
          vang = vang + qd[dof(c)];
        }
      }
      const float vt = vcx * cs[b] + vcz * sn[b];
      const float vn = -vcx * sn[b] + vcz * cs[b];
      const float ct = m.drag_tangent[b], cn = m.drag_normal[b];
      const float fx = -(ct * vt * cs[b] - cn * vn * sn[b]);
      const float fz = -(ct * vt * sn[b] + cn * vn * cs[b]);
      const float torque = -m.drag_angular[b] * vang;
      if (FREE) {
        tau[0] += fx;
        tau[1] += fz;
      }
#pragma unroll
      for (int c = 0; c < NBODY; ++c) {
        if ((mask >> c) & 1) {
          const float jx = -(cz - oz[c]);
          const float jz = cx - ox[c];
          tau[dof(c)] += jx * fx + jz * fz + torque;
        }
      }
    }
  }

  // One control step in place (batched.py::step_rows); ctrl already clipped.
  PLANAR_HD static void control_step(const Params& m, float* q, float* qd,
                                     const float* ctrl) {
    const float dt = m.dt_sub;

    // ---- once per control step -----------------------------------------
    float M[NTRI], bias[NDOF];
    mass_bias(m, q, qd, M, bias);
#pragma unroll
    for (int i = 0; i < NDOF; ++i) M[tri(i, i)] += 1e-6f;  // in lhs and in M qd

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
#pragma unroll 1
    for (int s = 0; s < m.n_substeps; ++s) {
      float ox[NBODY], oz[NBODY], cs[NBODY], sn[NBODY];
      fk(m, q, ox, oz, cs, sn);
      float tau_c[NDOF];
#pragma unroll
      for (int j = 0; j < NDOF; ++j) tau_c[j] = 0.f;
      add_contact_tau(m, qd, ox, oz, cs, sn, tau_c);
      float tau_d[NDOF];
#pragma unroll
      for (int j = 0; j < NDOF; ++j) tau_d[j] = 0.f;
      if (m.has_drag) add_drag_tau(m, qd, ox, oz, cs, sn, tau_d);

      float b[NDOF];
#pragma unroll
      for (int j = 0; j < NDOF; ++j) {
        float t = tau_ctrl[j];
        if (m.finite_motor && ((m.actuated_mask >> j) & 1)) {
          const float sgn = (t > 0.f) ? 1.f : ((t < 0.f) ? -1.f : 0.f);
          t = t * clampf(1.f - qd[j] * sgn / m.motor_omega_max, 0.f, 1.f);
        }
        float spring = -m.stiffness[j] * (q[j] - m.springref[j]);
        spring = spring - m.limit_stiffness * fmaxf(q[j] - m.limit_hi[j], 0.f);
        spring = spring + m.limit_stiffness * fmaxf(m.limit_lo[j] - q[j], 0.f);
        float r = t + spring + tau_c[j] - bias[j];
        if (m.has_drag) r = r + tau_d[j];
        b[j] = dt * r;
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
#pragma unroll
      for (int j = 0; j < NDOF; ++j) {
        qd[j] = clampf(b[j], -m.max_qd, m.max_qd);
        q[j] = q[j] + dt * qd[j];
      }
    }
  }
};

// The whole rollout of trajectory p. Layouts are trajectory-minor, so that
// neighbouring trajectories read and write neighbouring addresses:
// q0, qd0 [NDOF, P]; acts [h, NACT, P]; qs, qds [h, NDOF, P].
template <int NDOF, int NBODY, int NGEOM, int NACT>
PLANAR_HD void rollout_one(const PlanarParams<NDOF, NBODY, NGEOM, NACT>& m,
                           const float* q0, const float* qd0, const float* acts,
                           float* qs, float* qds, long long P, int h,
                           long long p) {
  using Eng = Planar<NDOF, NBODY, NGEOM, NACT>;
  float q[NDOF], qd[NDOF];
#pragma unroll
  for (int i = 0; i < NDOF; ++i) {
    q[i] = q0[i * P + p];
    qd[i] = qd0[i * P + p];
  }
#pragma unroll 1
  for (int t = 0; t < h; ++t) {
    float ctrl[at_least_one(NACT)];
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
