// Open-loop planar rollout on Hopper (sm_90a): a group of G lanes per
// trajectory, in two instantiations chosen per launch by the population.
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
//
// Throughput (LATENCY = 0): G = 2, 16 trajectories a warp, blocks of 4
// warps, and P = 32,921 is 2,058 warps, 15.6 an SM. G = 4 puts twice the
// warps on the card but, to fit them, caps a lane at 64 registers, where the
// body spills; G = 8 spends more of each warp on the serial phases (PERF.md
// has the A/B).
//
// Latency (LATENCY = 1): below one wave neither cost applies. The planner's
// small populations (i-cem-blitz's 43 / 32 / 25 rows, the real step's one)
// left one block on one SM of 132, paced by one group's chain of dependent
// phases. Here G is the smallest power of two that holds the shape's largest
// item count (16 for HalfCheetah), so each item loop of a phase is one pass,
// a block is one warp, and the registers are not capped. The host
// (ops/planar_rollout.py::takes_latency) takes it while its warps fit the
// card at two a scheduler, where the sweep over P (PERF.md) shows it faster
// at every shape.
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

// The launch configuration of each instantiation (see the head of the file).
template <int NDOF, int NBODY, int NGEOM, int NACT, int LATENCY>
struct Config {
  static constexpr int kLanes = icem::planar_lanes<NDOF, NBODY, NGEOM, NACT, LATENCY>();
  static constexpr int kWarps = LATENCY ? 1 : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kTrajPerBlock = kThreads / kLanes;
  // Blocks an SM holds at once. Throughput: enough that the planner's
  // largest launch (P = 32,921, 32,921 G / 32 warps on 132 SMs) runs in one
  // wave: 16 warps, 4 blocks, up to 128 registers a lane (at G = 4 it would
  // take 32 warps, 8 blocks, 64 registers). Latency: 1, no register cap.
  static constexpr int kMinBlocks = LATENCY ? 1 : 4;
  using Work = typename icem::Planar<NDOF, NBODY, NGEOM, NACT, kLanes>::Work;
  static constexpr int kSmemBytes = kTrajPerBlock * (int)sizeof(Work);
};

#ifdef ICEM_PLANAR_PROFILE
// the profile build: trajectory 0's cycles per phase group, last launch
__device__ long long g_planar_prof[icem::kPlanarProfGroups];
#endif

template <int NDOF, int NBODY, int NGEOM, int NACT, int LATENCY>
__global__ void __launch_bounds__(Config<NDOF, NBODY, NGEOM, NACT, LATENCY>::kThreads,
                                  Config<NDOF, NBODY, NGEOM, NACT, LATENCY>::kMinBlocks)
planar_rollout_kernel(const __grid_constant__ icem::PlanarParams<NDOF, NBODY, NGEOM, NACT> m,
                      const float* __restrict__ q0, long long ldq,
                      const float* __restrict__ qd0, long long ldqd,
                      const float* __restrict__ acts, float* __restrict__ qs,
                      float* __restrict__ qds, long long P, int h) {
  using C = Config<NDOF, NBODY, NGEOM, NACT, LATENCY>;
  constexpr int G = C::kLanes;
  extern __shared__ float4 smem[];
  const int slot = threadIdx.x / G;  // the group's trajectory in the block
  const long long first = (long long)blockIdx.x * C::kTrajPerBlock;
  // a warp none of whose groups has a trajectory leaves at once; a group
  // whose warp holds a trajectory stays for the warp's __syncwarp()s
  if (first + (long long)(threadIdx.x / 32) * (32 / G) >= P) return;
  const long long own = first + slot;
  const bool store = own < P;
  const long long p = store ? own : P - 1;
  auto& W = reinterpret_cast<typename C::Work*>(smem)[slot];
  const icem::WarpLanes lanes{(int)(threadIdx.x % G)};
  icem::planar_rollout_one<NDOF, NBODY, NGEOM, NACT, G>(m, W, lanes, q0, ldq, qd0, ldqd, acts,
                                                        qs, qds, P, h, p, store);
#ifdef ICEM_PLANAR_PROFILE
  __syncwarp();  // lane 0's last mark
  if (own == 0)
    for (int g = lanes.lane; g < icem::kPlanarProfGroups; g += G) g_planar_prof[g] = W.prof[g];
#endif
}

// Once per instantiation: prefer shared memory over L1 (the workspaces are
// the kernel's working set), and allow more than 48 KB where a shape needs
// it. Returns a cudaError_t.
template <int NDOF, int NBODY, int NGEOM, int NACT, int LATENCY>
int configure() {
  static int err = -1;
  if (err < 0) {
    const auto kernel = planar_rollout_kernel<NDOF, NBODY, NGEOM, NACT, LATENCY>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
    constexpr int bytes = Config<NDOF, NBODY, NGEOM, NACT, LATENCY>::kSmemBytes;
    if (e == cudaSuccess && bytes > 48 * 1024)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    err = (int)e;
  }
  return err;
}

template <int NDOF, int NBODY, int NGEOM, int NACT, int LATENCY>
int launch(const void* params, const float* q0, long long ldq, const float* qd0,
           long long ldqd, const float* acts, float* qs, float* qds, long long P, int h,
           void* stream) {
  using C = Config<NDOF, NBODY, NGEOM, NACT, LATENCY>;
  if (const int err = configure<NDOF, NBODY, NGEOM, NACT, LATENCY>()) return err;
  const long long blocks = (P + C::kTrajPerBlock - 1) / C::kTrajPerBlock;
  icem::PlanarParams<NDOF, NBODY, NGEOM, NACT> m;
  std::memcpy(&m, params, sizeof(m));
  planar_rollout_kernel<NDOF, NBODY, NGEOM, NACT, LATENCY>
      <<<(unsigned)blocks, C::kThreads, C::kSmemBytes, (cudaStream_t)stream>>>(
          m, q0, ldq, qd0, ldqd, acts, qs, qds, P, h);
  return (int)cudaGetLastError();
}

// Warps of this kernel an SM holds at once, by the occupancy calculator;
// -1 on a CUDA error.
template <int NDOF, int NBODY, int NGEOM, int NACT, int LATENCY>
int warps_per_sm() {
  using C = Config<NDOF, NBODY, NGEOM, NACT, LATENCY>;
  if (configure<NDOF, NBODY, NGEOM, NACT, LATENCY>() != 0) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, planar_rollout_kernel<NDOF, NBODY, NGEOM, NACT, LATENCY>, C::kThreads,
          C::kSmemBytes) != cudaSuccess)
    return -1;
  return blocks * C::kWarps;
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

// The plain C interface, one set of functions per instantiated shape
// <NDOF, NBODY, NGEOM, NACT> and instantiation LATENCY (0: throughput, 1:
// latency), named planar_*_<NDOF>_<NBODY>_<NGEOM>_<NACT>_<LATENCY>. The
// launcher returns the cudaError_t of the launch; it does not synchronise.
// params is the parameter block in host memory (the launch copies it); q0
// and qd0 are [P, NDOF] with row strides ldq and ldqd; acts [P, h, NACT] and
// qs, qds [h, P, NDOF] are contiguous.
#define ICEM_PLANAR_INSTANTIATE_WIDTH(ND, NB, NG, NA, LAT)                            \
  extern "C" int planar_lanes_##ND##_##NB##_##NG##_##NA##_##LAT() {                  \
    return Config<ND, NB, NG, NA, LAT>::kLanes;                                      \
  }                                                                                  \
  extern "C" int planar_smem_bytes_##ND##_##NB##_##NG##_##NA##_##LAT() {             \
    return Config<ND, NB, NG, NA, LAT>::kSmemBytes;                                  \
  }                                                                                  \
  extern "C" int planar_warps_per_sm_##ND##_##NB##_##NG##_##NA##_##LAT() {           \
    return warps_per_sm<ND, NB, NG, NA, LAT>();                                      \
  }                                                                                  \
  extern "C" int planar_rollout_##ND##_##NB##_##NG##_##NA##_##LAT(                   \
      const void* params, const float* q0, long long ldq, const float* qd0,          \
      long long ldqd, const float* acts, float* qs, float* qds, long long P, int h,  \
      void* stream) {                                                                \
    return launch<ND, NB, NG, NA, LAT>(params, q0, ldq, qd0, ldqd, acts, qs, qds, P, \
                                       h, stream);                                   \
  }
#define ICEM_PLANAR_INSTANTIATE(ND, NB, NG, NA)                                      \
  extern "C" int planar_params_bytes_##ND##_##NB##_##NG##_##NA() {                   \
    return (int)sizeof(icem::PlanarParams<ND, NB, NG, NA>);                          \
  }                                                                                  \
  ICEM_PLANAR_INSTANTIATE_WIDTH(ND, NB, NG, NA, 0)                                   \
  ICEM_PLANAR_INSTANTIATE_WIDTH(ND, NB, NG, NA, 1)

// One line per planar env shape: a free root is NDOF == NBODY + 2, a hinge
// root NDOF == NBODY; a model without geoms keeps a placeholder no loop reads.
ICEM_PLANAR_INSTANTIATE(9, 7, 6, 6)     // HalfCheetah, the dm-suite cheetah
ICEM_PLANAR_INSTANTIATE(6, 4, 3, 3)     // Hopper
ICEM_PLANAR_INSTANTIATE(2, 2, 0, 2)     // Reacher's two-link arm: hinge root, no geoms
ICEM_PLANAR_INSTANTIATE(7, 5, 6, 4)     // PlanarAnt
ICEM_PLANAR_INSTANTIATE(12, 10, 10, 9)  // PlanarHumanoid(Standup): the motor speed line
ICEM_PLANAR_INSTANTIATE(8, 6, 0, 5)     // the swimmer: fluid drag, no geoms
