// Test-only host build of the rollout kernel's body (planar_step.cuh): the
// same per-trajectory code, looped over trajectories on the CPU, so that the
// kernel's arithmetic can be held against the plain PyTorch version where
// there is no GPU. Build: g++ -O2 -shared -fPIC -std=c++17. Never on the
// main path.

#include <cstring>

#include "planar_step.cuh"

namespace {

template <int NDOF, int NBODY, int NGEOM, int NACT>
int run(const void* params, const float* q0, const float* qd0, const float* acts,
        float* qs, float* qds, long long P, int h) {
  icem::PlanarParams<NDOF, NBODY, NGEOM, NACT> m;
  std::memcpy(&m, params, sizeof(m));
  for (long long p = 0; p < P; ++p)
    icem::rollout_one<NDOF, NBODY, NGEOM, NACT>(m, q0, qd0, acts, qs, qds, P, h, p);
  return 0;
}

}  // namespace

#define ICEM_PLANAR_HOST_INSTANTIATE(ND, NB, NG, NA)                                 \
  extern "C" int planar_params_bytes_##ND##_##NB##_##NG##_##NA() {                   \
    return (int)sizeof(icem::PlanarParams<ND, NB, NG, NA>);                          \
  }                                                                                  \
  extern "C" int planar_rollout_host_##ND##_##NB##_##NG##_##NA(                      \
      const void* params, const float* q0, const float* qd0, const float* acts,      \
      float* qs, float* qds, long long P, int h) {                                   \
    return run<ND, NB, NG, NA>(params, q0, qd0, acts, qs, qds, P, h);                \
  }

ICEM_PLANAR_HOST_INSTANTIATE(9, 7, 6, 6)  // HalfCheetah (the device's shape)
ICEM_PLANAR_HOST_INSTANTIATE(2, 2, 0, 2)  // two-link arm: hinge root
ICEM_PLANAR_HOST_INSTANTIATE(8, 6, 0, 5)  // six-link swimmer: fluid drag
