// Open-loop planar rollout on Hopper (sm_90a): one thread per trajectory.
//
// Replaces the TPU kernel icem_tpu/ops/planar_rollout.py::rollout_planar_pallas
// (its body is icem_tpu/envs/physics/batched.py::step_rows, looped over the
// horizon). The plain PyTorch version is
// icem_torch/ops/planar_rollout.py::rollout_planar_reference.
//
// What bounds it: FP32 arithmetic. A trajectory reads its start state and h
// actions and writes 2 * h states, 4 * (2 * NDOF + h * (NACT + 2 * NDOF))
// bytes (2,952 bytes for HalfCheetah at h = 30), while the plain version does
// 18,894 operations per control step of 20 substeps (chip_smoke.py counts
// them): about 190 operations per byte moved in device memory, far above the
// H100's FP32 ridge of 20 (67 TFLOP/s over 3.35 TB/s). So the design keeps
// everything that is reused out of memory: q, qd, the packed mass matrix and
// Cholesky factor (45 floats each at 9 dofs), the inverse pivots, the bias
// and the actuator torques stay in registers for the whole horizon
// (planar_step.cuh unrolls every loop over dofs and bodies at compile time so
// that they can; chip_smoke.py prints nvcc's register and spill report), the
// model's constants are one __grid_constant__ parameter block read through
// the constant cache, and the loads and stores are trajectory-minor so a
// warp touches 32 consecutive floats at a time. No shared memory, no
// synchronisation: trajectories are independent. The TPU's pad-to-1024 and
// VMEM gates do not carry over; a bounds check masks the ragged last block.

#include <cuda_runtime.h>

#include <cstring>

#include "planar_step.cuh"

namespace {

constexpr int kThreads = 128;

template <int NDOF, int NBODY, int NGEOM, int NACT>
__global__ void __launch_bounds__(kThreads)
planar_rollout_kernel(const __grid_constant__ icem::PlanarParams<NDOF, NBODY, NGEOM, NACT> m,
                      const float* __restrict__ q0, const float* __restrict__ qd0,
                      const float* __restrict__ acts, float* __restrict__ qs,
                      float* __restrict__ qds, long long P, int h) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p < P) icem::rollout_one<NDOF, NBODY, NGEOM, NACT>(m, q0, qd0, acts, qs, qds, P, h, p);
}

template <int NDOF, int NBODY, int NGEOM, int NACT>
int launch(const void* params, const float* q0, const float* qd0,
           const float* acts, float* qs, float* qds, long long P, int h,
           void* stream) {
  icem::PlanarParams<NDOF, NBODY, NGEOM, NACT> m;
  std::memcpy(&m, params, sizeof(m));
  const long long blocks = (P + kThreads - 1) / kThreads;
  planar_rollout_kernel<NDOF, NBODY, NGEOM, NACT>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(m, q0, qd0, acts, qs, qds, P, h);
  return (int)cudaGetLastError();
}

}  // namespace

// The plain C interface, one pair of functions per instantiated shape
// <NDOF, NBODY, NGEOM, NACT>. The launcher returns the cudaError_t of the
// launch; it does not synchronise.
#define ICEM_PLANAR_INSTANTIATE(ND, NB, NG, NA)                                      \
  extern "C" int planar_params_bytes_##ND##_##NB##_##NG##_##NA() {                   \
    return (int)sizeof(icem::PlanarParams<ND, NB, NG, NA>);                          \
  }                                                                                  \
  extern "C" int planar_rollout_##ND##_##NB##_##NG##_##NA(                           \
      const void* params, const float* q0, const float* qd0, const float* acts,      \
      float* qs, float* qds, long long P, int h, void* stream) {                     \
    return launch<ND, NB, NG, NA>(params, q0, qd0, acts, qs, qds, P, h, stream);     \
  }

ICEM_PLANAR_INSTANTIATE(9, 7, 6, 6)  // HalfCheetah
