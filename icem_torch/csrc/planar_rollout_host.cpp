// Test-only host build of the rollout kernel's body (planar_step.cuh): the
// same phase functions over one workspace per trajectory, each phase run for
// the group's lanes 0..G-1 in turn (or G-1..0), at the G of each of the
// kernel's two instantiations, so that the kernel's
// arithmetic can be held against the plain PyTorch version where there is no
// GPU. Build: g++ -O2 -shared -fPIC -std=c++17. Never on the main path.

#include <cstring>

#include "planar_step.cuh"

namespace {

template <int NDOF, int NBODY, int NGEOM, int NACT, int G>
int run(const void* params, const float* q0, long long ldq, const float* qd0, long long ldqd,
        const float* acts, float* qs, float* qds, long long P, int h, int descending) {
  icem::PlanarParams<NDOF, NBODY, NGEOM, NACT> m;
  std::memcpy(&m, params, sizeof(m));
  typename icem::Planar<NDOF, NBODY, NGEOM, NACT, G>::Work W;
  const icem::HostLanes<G> lanes{descending != 0};
  for (long long p = 0; p < P; ++p) {
    // every float a NaN, so that a slot read before it is written shows
    std::memset(static_cast<void*>(&W), 0xff, sizeof(W));
    icem::planar_rollout_one<NDOF, NBODY, NGEOM, NACT, G>(m, W, lanes, q0, ldq, qd0, ldqd, acts,
                                                          qs, qds, P, h, p, true);
  }
  return 0;
}

}  // namespace

// q0, qd0 [P, NDOF] with row strides ldq, ldqd (as the kernel takes them);
// acts [P, h, NACT]; qs, qds [h, P, NDOF]. descending != 0 runs each phase's
// lanes from G-1 down to 0. The kernel's two instantiations, LATENCY 0
// (throughput) and 1 (latency), differ here only in G, the lanes of a group:
// planar_lanes_<shape>_<LATENCY>, as in the device library.
#define ICEM_PLANAR_HOST_WIDTH(ND, NB, NG, NA, LAT)                                  \
  extern "C" int planar_lanes_##ND##_##NB##_##NG##_##NA##_##LAT() {                  \
    return icem::planar_lanes<ND, NB, NG, NA, LAT>();                                \
  }                                                                                  \
  extern "C" int planar_rollout_host_##ND##_##NB##_##NG##_##NA##_##LAT(              \
      const void* params, const float* q0, long long ldq, const float* qd0,          \
      long long ldqd, const float* acts, float* qs, float* qds, long long P, int h,  \
      int descending) {                                                              \
    return run<ND, NB, NG, NA, icem::planar_lanes<ND, NB, NG, NA, LAT>()>(           \
        params, q0, ldq, qd0, ldqd, acts, qs, qds, P, h, descending);                \
  }
#define ICEM_PLANAR_HOST_INSTANTIATE(ND, NB, NG, NA)                                 \
  extern "C" int planar_params_bytes_##ND##_##NB##_##NG##_##NA() {                   \
    return (int)sizeof(icem::PlanarParams<ND, NB, NG, NA>);                          \
  }                                                                                  \
  ICEM_PLANAR_HOST_WIDTH(ND, NB, NG, NA, 0)                                          \
  ICEM_PLANAR_HOST_WIDTH(ND, NB, NG, NA, 1)

// the device's shapes (planar_rollout.cu)
ICEM_PLANAR_HOST_INSTANTIATE(9, 7, 6, 6)     // HalfCheetah
ICEM_PLANAR_HOST_INSTANTIATE(6, 4, 3, 3)     // Hopper
ICEM_PLANAR_HOST_INSTANTIATE(2, 2, 0, 2)     // two-link arm: hinge root
ICEM_PLANAR_HOST_INSTANTIATE(7, 5, 6, 4)     // PlanarAnt
ICEM_PLANAR_HOST_INSTANTIATE(12, 10, 10, 9)  // PlanarHumanoid: the motor speed line
ICEM_PLANAR_HOST_INSTANTIATE(8, 6, 0, 5)     // six-link swimmer: fluid drag
