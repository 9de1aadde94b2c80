// Open-loop planar rollout on Hopper (sm_90a): a group of kPlanarLanes lanes
// per trajectory.
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
// H100's FP32 ridge of 20 (67 TFLOP/s over 3.35 TB/s). So the trajectory's
// state stays on the SM for the whole horizon.
//
// One thread per trajectory kept the whole step in registers (255 of them)
// and left the SMs nearly empty: P = 32,921 was 2 blocks of 128 threads per
// SM, about 2 warps per scheduler, each thread one long dependent chain of
// solves, factor and sines. Here a group of G lanes takes a trajectory and
// splits each phase of the step (planar_step.cuh) by dof, body, geom or row;
// lanes exchange data only through the trajectory's workspace in shared
// memory, between __syncwarp()s. There are no shuffles, and no
// __syncthreads(), since the groups of a block are independent
// trajectories. 32 / G trajectories share a warp.
//
// A phase costs its warp a round trip through shared memory and a
// __syncwarp() whatever share of its lanes works, so a substep is 5
// phases: the bodies' angles, their origins (each lane walks its body's
// chain), the contacts, the right-hand side by rows, and the two triangular
// solves with the Euler step on one lane, whose operands then sit at
// compile-time offsets. Once per step, the factor too runs on one lane.
// G = 2: 16 trajectories a warp, and P = 32,921 is 2,058 warps, 15.6 an SM.
// G = 4 puts twice the warps on the card but, to fit them, caps a lane at
// 64 registers, where the body spills; G = 8 spends more of each warp on
// the serial phases (PERF.md has the A/B).
//
// The model's constants are one __grid_constant__ parameter block, read
// through the constant cache: a read at a compile-time offset (a loop over
// geoms, the model's scalars) is an operand of the instruction, and one at a
// lane's own body or dof serialises over only G addresses. Layouts are
// trajectory-major (Q, QD [P, NDOF] with a row stride; ACTS [P, h, NACT];
// qs, qds [h, P, NDOF]), so that the caller's tensors need no copies and a
// warp's groups touch consecutive rows.

#include <cuda_runtime.h>

#include <cstring>

#include "planar_step.cuh"

namespace {

constexpr int kLanes = icem::kPlanarLanes;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTrajPerBlock = kThreads / kLanes;
// Blocks an SM holds at once: enough that the planner's largest launch
// (P = 32,921, 32,921 G / 32 warps on 132 SMs) runs in one wave. At G = 2
// that is 16 warps, 4 blocks, up to 128 registers a lane; at G = 4, 32
// warps, 8 blocks, 64 registers.
constexpr int kMinBlocks = kLanes <= 2 ? 4 : 8;

template <int NDOF, int NBODY, int NGEOM, int NACT>
using Work = typename icem::Planar<NDOF, NBODY, NGEOM, NACT>::Work;

#ifdef ICEM_PLANAR_PROFILE
// the profile build: trajectory 0's cycles per phase group, last launch
__device__ long long g_planar_prof[icem::kPlanarProfGroups];
#endif

template <int NDOF, int NBODY, int NGEOM, int NACT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
planar_rollout_kernel(const __grid_constant__ icem::PlanarParams<NDOF, NBODY, NGEOM, NACT> m,
                      const float* __restrict__ q0, long long ldq,
                      const float* __restrict__ qd0, long long ldqd,
                      const float* __restrict__ acts, float* __restrict__ qs,
                      float* __restrict__ qds, long long P, int h) {
  extern __shared__ float4 smem[];
  const int slot = threadIdx.x / kLanes;  // the group's trajectory in the block
  const long long first = (long long)blockIdx.x * kTrajPerBlock;
  // a warp none of whose groups has a trajectory leaves at once; a group
  // whose warp holds a trajectory stays for the warp's __syncwarp()s
  if (first + (long long)(threadIdx.x / 32) * (32 / kLanes) >= P) return;
  const long long own = first + slot;
  const bool store = own < P;
  const long long p = store ? own : P - 1;
  auto& W = reinterpret_cast<Work<NDOF, NBODY, NGEOM, NACT>*>(smem)[slot];
  const icem::WarpLanes lanes{(int)(threadIdx.x % kLanes)};
  icem::planar_rollout_one<NDOF, NBODY, NGEOM, NACT>(m, W, lanes, q0, ldq, qd0, ldqd,
                                                     acts, qs, qds, P, h, p, store);
#ifdef ICEM_PLANAR_PROFILE
  __syncwarp();  // lane 0's last mark
  if (own == 0)
    for (int g = lanes.lane; g < icem::kPlanarProfGroups; g += kLanes) g_planar_prof[g] = W.prof[g];
#endif
}

template <int NDOF, int NBODY, int NGEOM, int NACT>
constexpr int smem_bytes() {
  return kTrajPerBlock * (int)sizeof(Work<NDOF, NBODY, NGEOM, NACT>);
}

// Once per instantiation: prefer shared memory over L1 (the workspaces are
// the kernel's working set), and allow more than 48 KB where a shape needs
// it. Returns a cudaError_t.
template <int NDOF, int NBODY, int NGEOM, int NACT>
int configure() {
  static int err = -1;
  if (err < 0) {
    const auto kernel = planar_rollout_kernel<NDOF, NBODY, NGEOM, NACT>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
    constexpr int bytes = smem_bytes<NDOF, NBODY, NGEOM, NACT>();
    if (e == cudaSuccess && bytes > 48 * 1024)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    err = (int)e;
  }
  return err;
}

template <int NDOF, int NBODY, int NGEOM, int NACT>
int launch(const void* params, const float* q0, long long ldq, const float* qd0,
           long long ldqd, const float* acts, float* qs, float* qds, long long P, int h,
           void* stream) {
  if (const int err = configure<NDOF, NBODY, NGEOM, NACT>()) return err;
  const long long blocks = (P + kTrajPerBlock - 1) / kTrajPerBlock;
  icem::PlanarParams<NDOF, NBODY, NGEOM, NACT> m;
  std::memcpy(&m, params, sizeof(m));
  planar_rollout_kernel<NDOF, NBODY, NGEOM, NACT>
      <<<(unsigned)blocks, kThreads, smem_bytes<NDOF, NBODY, NGEOM, NACT>(),
         (cudaStream_t)stream>>>(m, q0, ldq, qd0, ldqd, acts, qs, qds, P, h);
  return (int)cudaGetLastError();
}

// Warps of this kernel an SM holds at once, by the occupancy calculator;
// -1 on a CUDA error.
template <int NDOF, int NBODY, int NGEOM, int NACT>
int warps_per_sm() {
  if (configure<NDOF, NBODY, NGEOM, NACT>() != 0) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, planar_rollout_kernel<NDOF, NBODY, NGEOM, NACT>, kThreads,
          smem_bytes<NDOF, NBODY, NGEOM, NACT>()) != cudaSuccess)
    return -1;
  return blocks * kWarps;
}

}  // namespace

#ifdef ICEM_PLANAR_PROFILE
// Copies the last launch's cycles per phase group (icem::PlanarProfGroup
// order) to out[kPlanarProfGroups]; returns the count, or -1 on an error.
extern "C" int planar_profile_read(long long* out) {
  if (cudaMemcpyFromSymbol(out, g_planar_prof, sizeof(g_planar_prof)) != cudaSuccess) return -1;
  return icem::kPlanarProfGroups;
}
#endif

// The lanes of a group, one trajectory's (planar_step.cuh's kPlanarLanes).
extern "C" int planar_lanes_per_trajectory() { return kLanes; }

// The plain C interface, one set of functions per instantiated shape
// <NDOF, NBODY, NGEOM, NACT>. The launcher returns the cudaError_t of the
// launch; it does not synchronise. params is the parameter block in host
// memory (the launch copies it); q0 and qd0 are [P, NDOF] with row strides
// ldq and ldqd; acts [P, h, NACT] and qs, qds [h, P, NDOF] are contiguous.
#define ICEM_PLANAR_INSTANTIATE(ND, NB, NG, NA)                                      \
  extern "C" int planar_params_bytes_##ND##_##NB##_##NG##_##NA() {                   \
    return (int)sizeof(icem::PlanarParams<ND, NB, NG, NA>);                          \
  }                                                                                  \
  extern "C" int planar_smem_bytes_##ND##_##NB##_##NG##_##NA() {                     \
    return smem_bytes<ND, NB, NG, NA>();                                             \
  }                                                                                  \
  extern "C" int planar_warps_per_sm_##ND##_##NB##_##NG##_##NA() {                   \
    return warps_per_sm<ND, NB, NG, NA>();                                           \
  }                                                                                  \
  extern "C" int planar_rollout_##ND##_##NB##_##NG##_##NA(                           \
      const void* params, const float* q0, long long ldq, const float* qd0,          \
      long long ldqd, const float* acts, float* qs, float* qds, long long P, int h,  \
      void* stream) {                                                                \
    return launch<ND, NB, NG, NA>(params, q0, ldq, qd0, ldqd, acts, qs, qds, P, h,   \
                                  stream);                                           \
  }

// One line per planar env shape: a free root is NDOF == NBODY + 2, a hinge
// root NDOF == NBODY; a model without geoms keeps a placeholder no loop reads.
ICEM_PLANAR_INSTANTIATE(9, 7, 6, 6)     // HalfCheetah, the dm-suite cheetah
ICEM_PLANAR_INSTANTIATE(6, 4, 3, 3)     // Hopper
ICEM_PLANAR_INSTANTIATE(2, 2, 0, 2)     // Reacher's two-link arm: hinge root, no geoms
ICEM_PLANAR_INSTANTIATE(7, 5, 6, 4)     // PlanarAnt
ICEM_PLANAR_INSTANTIATE(12, 10, 10, 9)  // PlanarHumanoid(Standup): the motor speed line
ICEM_PLANAR_INSTANTIATE(8, 6, 0, 5)     // the swimmer: fluid drag, no geoms
