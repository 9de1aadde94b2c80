// Test-only host build of the spatial rollout kernel's body
// (spatial_step.cuh): the same phase functions over one workspace per
// trajectory, each phase run for lanes 0..31 in turn (or 31..0), so that the
// kernel's arithmetic can be held against the plain PyTorch version where
// there is no GPU. Build: g++ -O2 -shared -fPIC -std=c++17. Never on the
// main path.

#include <cstring>

#include "spatial_step.cuh"

namespace {

template <int NDOF, int NBODY, int NGEOM, int NACT>
int run(const void* params, const float* q0, long long ldq, const float* qd0, long long ldqd,
        const float* acts, float* qs, float* qds, long long P, int h, int descending) {
  icem::SpatialParams<NDOF, NBODY, NGEOM, NACT> m;
  std::memcpy(&m, params, sizeof(m));
  typename icem::Spatial<NDOF, NBODY, NGEOM, NACT>::Work W;
  const icem::HostLanes<icem::kSpatialLanes> lanes{descending != 0};
  for (long long p = 0; p < P; ++p) {
    // every float a NaN, so that a slot read before it is written shows
    std::memset(&W, 0xff, sizeof(W));
    icem::spatial_rollout_one<NDOF, NBODY, NGEOM, NACT>(m, W, lanes, q0, ldq, qd0, ldqd,
                                                        acts, qs, qds, P, h, p);
  }
  return 0;
}

}  // namespace

// q0, qd0 [P, NDOF] with row strides ldq, ldqd (as the kernel takes them);
// acts [P, h, NACT]; qs, qds [h, P, NDOF]. descending != 0 runs each phase's
// lanes from 31 down to 0.
#define ICEM_SPATIAL_HOST_INSTANTIATE(ND, NB, NG, NA)                                \
  extern "C" int spatial_params_bytes_##ND##_##NB##_##NG##_##NA() {                  \
    return (int)sizeof(icem::SpatialParams<ND, NB, NG, NA>);                         \
  }                                                                                  \
  extern "C" int spatial_rollout_host_##ND##_##NB##_##NG##_##NA(                     \
      const void* params, const float* q0, long long ldq, const float* qd0,          \
      long long ldqd, const float* acts, float* qs, float* qds, long long P, int h,  \
      int descending) {                                                              \
    return run<ND, NB, NG, NA>(params, q0, ldq, qd0, ldqd, acts, qs, qds, P, h,      \
                               descending);                                          \
  }

ICEM_SPATIAL_HOST_INSTANTIATE(14, 9, 9, 8)     // Ant3D (the device's shape)
ICEM_SPATIAL_HOST_INSTANTIATE(23, 18, 13, 17)  // Humanoid3D (the device's shape)
ICEM_SPATIAL_HOST_INSTANTIATE(3, 3, 1, 3)      // three-link chain: hinge root
