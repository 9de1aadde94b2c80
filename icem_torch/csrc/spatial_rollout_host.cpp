// Test-only host build of the spatial rollout kernel's body
// (spatial_step.cuh): the same per-trajectory code, looped over trajectories
// on the CPU, so that the kernel's arithmetic can be held against the plain
// PyTorch version where there is no GPU. Build: g++ -O2 -shared -fPIC
// -std=c++17. Never on the main path.

#include <cstring>

#include "spatial_step.cuh"

namespace {

template <int NDOF, int NBODY, int NGEOM, int NACT>
int run(const void* params, const float* q0, const float* qd0, const float* acts,
        float* qs, float* qds, long long P, int h) {
  icem::SpatialParams<NDOF, NBODY, NGEOM, NACT> m;
  std::memcpy(&m, params, sizeof(m));
  for (long long p = 0; p < P; ++p)
    icem::spatial_rollout_one<NDOF, NBODY, NGEOM, NACT>(m, q0, qd0, acts, qs, qds, P, h, p);
  return 0;
}

}  // namespace

#define ICEM_SPATIAL_HOST_INSTANTIATE(ND, NB, NG, NA)                                \
  extern "C" int spatial_params_bytes_##ND##_##NB##_##NG##_##NA() {                  \
    return (int)sizeof(icem::SpatialParams<ND, NB, NG, NA>);                         \
  }                                                                                  \
  extern "C" int spatial_rollout_host_##ND##_##NB##_##NG##_##NA(                     \
      const void* params, const float* q0, const float* qd0, const float* acts,      \
      float* qs, float* qds, long long P, int h) {                                   \
    return run<ND, NB, NG, NA>(params, q0, qd0, acts, qs, qds, P, h);                \
  }

ICEM_SPATIAL_HOST_INSTANTIATE(14, 9, 9, 8)     // Ant3D (the device's shape)
ICEM_SPATIAL_HOST_INSTANTIATE(23, 18, 13, 17)  // Humanoid3D (the device's shape)
ICEM_SPATIAL_HOST_INSTANTIATE(3, 3, 1, 3)      // three-link chain: hinge root
