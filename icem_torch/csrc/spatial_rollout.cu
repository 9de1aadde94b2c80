// Open-loop spatial (3D) rollout on Hopper (sm_90a): one thread per
// trajectory.
//
// Replaces the TPU kernel icem_tpu/ops/spatial_rollout.py::rollout_spatial_pallas
// (its body is icem_tpu/envs/physics/spatial_batched.py::step_rows, looped
// over the horizon). The plain PyTorch version is
// icem_torch/ops/spatial_rollout.py::rollout_spatial_reference.
//
// What bounds it: FP32 arithmetic. A trajectory reads its start state and h
// actions and writes 2 * h states, 4 * (2 * NDOF + h * (NACT + 2 * NDOF))
// bytes (4,432 bytes for Ant3D at h = 30), while the plain version does
// 77,670 operations per control step of 20 substeps for Ant3D and 178,278
// for Humanoid3D (chip_smoke.py counts them): 500 to 700 operations per byte
// moved in device memory, far above the H100's FP32 ridge of 20 (67 TFLOP/s
// over 3.35 TB/s). So the design keeps the trajectory's state out of device
// memory for the whole horizon: q and qd in registers, the model's
// constants in one __grid_constant__ parameter block read through the
// constant cache, trajectory-minor loads and stores so a warp touches 32
// consecutive floats at a time. Unlike the planar kernel, the working set
// (the packed mass matrix and Cholesky factor, 105 floats each at 14 dofs
// and 276 at 23, plus the per-body frames) is larger than the register
// file gives a thread: what does not fit lives in local memory, which the
// L1 and L2 caches hold (spatial_step.cuh; chip_smoke.py prints nvcc's
// register, stack and spill report). The horizon is a loop inside the
// thread: the TPU's sequential grid axis with its VMEM scratch carry, its
// horizon padding and its pad-to-1024 population do not carry over; a
// bounds check masks the ragged last block.

#include <cuda_runtime.h>

#include <cstring>

#include "spatial_step.cuh"

namespace {

constexpr int kThreads = 128;

template <int NDOF, int NBODY, int NGEOM, int NACT>
__global__ void __launch_bounds__(kThreads)
spatial_rollout_kernel(const __grid_constant__ icem::SpatialParams<NDOF, NBODY, NGEOM, NACT> m,
                       const float* __restrict__ q0, const float* __restrict__ qd0,
                       const float* __restrict__ acts, float* __restrict__ qs,
                       float* __restrict__ qds, long long P, int h) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p < P)
    icem::spatial_rollout_one<NDOF, NBODY, NGEOM, NACT>(m, q0, qd0, acts, qs, qds, P, h, p);
}

template <int NDOF, int NBODY, int NGEOM, int NACT>
int launch(const void* params, const float* q0, const float* qd0,
           const float* acts, float* qs, float* qds, long long P, int h,
           void* stream) {
  icem::SpatialParams<NDOF, NBODY, NGEOM, NACT> m;
  std::memcpy(&m, params, sizeof(m));
  const long long blocks = (P + kThreads - 1) / kThreads;
  spatial_rollout_kernel<NDOF, NBODY, NGEOM, NACT>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(m, q0, qd0, acts, qs, qds, P, h);
  return (int)cudaGetLastError();
}

}  // namespace

// The plain C interface, one pair of functions per instantiated shape
// <NDOF, NBODY, NGEOM, NACT>. The launcher returns the cudaError_t of the
// launch; it does not synchronise.
#define ICEM_SPATIAL_INSTANTIATE(ND, NB, NG, NA)                                     \
  extern "C" int spatial_params_bytes_##ND##_##NB##_##NG##_##NA() {                  \
    return (int)sizeof(icem::SpatialParams<ND, NB, NG, NA>);                         \
  }                                                                                  \
  extern "C" int spatial_rollout_##ND##_##NB##_##NG##_##NA(                          \
      const void* params, const float* q0, const float* qd0, const float* acts,      \
      float* qs, float* qds, long long P, int h, void* stream) {                     \
    return launch<ND, NB, NG, NA>(params, q0, qd0, acts, qs, qds, P, h, stream);     \
  }

ICEM_SPATIAL_INSTANTIATE(14, 9, 9, 8)     // Ant3D
ICEM_SPATIAL_INSTANTIATE(23, 18, 13, 17)  // Humanoid3D, HumanoidStandup3D
