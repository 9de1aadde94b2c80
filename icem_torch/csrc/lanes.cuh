// The lanes that run one trajectory's phases, shared by the rollout bodies
// (planar_step.cuh: a group of lanes per trajectory; spatial_step.cuh: a
// warp per trajectory).
//
// A step is a sequence of phases, each a function of the lane index. A phase
// writes only its own lane's slots of the trajectory's workspace and reads
// only slots written in earlier phases, so the lanes of one phase may run in
// any order, or at once: on the device they run at once and meet at
// __syncwarp() (WarpLanes); in the test-only host builds one thread runs them
// one after the other, in ascending or descending order (HostLanes), and the
// two orders must agree to the bit.

#pragma once

#ifdef __CUDACC__
#define LANES_HD __host__ __device__ __forceinline__
#else
#define LANES_HD inline
#endif

namespace icem {

// the index of the lowest set bit of x != 0: loops over a chain's dofs take
// its set bits in ascending order
LANES_HD int lowest_bit(unsigned x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// On the device each thread is one lane of the trajectory's lanes: it runs
// the phase for itself, then the warp meets at __syncwarp(). The whole warp
// meets, so every trajectory that shares a warp runs the same sequence of
// phases.
struct WarpLanes {
  int lane;
  template <class Phase>
  LANES_HD void operator()(const Phase& phase) const {
    phase(lane);
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  // n phases, phase(lane, s, carry) for s = 0..n-1; each lane's carry (a
  // Carry, in registers) goes from one phase to the next
  template <class Carry, class Phase>
  LANES_HD void sweep(int n, const Phase& phase) const {
    Carry carry{};
    for (int s = 0; s < n; ++s) {
      phase(lane, s, carry);
#ifdef __CUDA_ARCH__
      __syncwarp();
#endif
    }
  }
  // state that each lane keeps for itself across phases: in its registers
  template <class T>
  struct Own {
    T v;
    LANES_HD T& operator()(int) { return v; }
  };
  // the profile build (Work::kProfile): lane 0 of the trajectory charges the
  // clock64() cycles since the last mark to the group that just ended
  template <class Work>
  LANES_HD void mark(Work& W, int group) const {
#ifdef __CUDA_ARCH__
    if constexpr (Work::kProfile) {
      if (lane == 0) {
        const long long t = clock64();
        W.prof[group] += t - W.prof_t;
        W.prof_t = t;
      }
    }
#endif
    (void)W;
    (void)group;
  }
};

// On the host one thread runs the phase for lanes 0..N-1 in turn, or in the
// opposite order. Where no phase reads a slot that another lane writes in
// the same phase, the two orders give bit-identical results.
template <int N>
struct HostLanes {
  bool descending;
  template <class Phase>
  LANES_HD void operator()(const Phase& phase) const {
    for (int i = 0; i < N; ++i) phase(descending ? N - 1 - i : i);
  }
  template <class Carry, class Phase>
  LANES_HD void sweep(int n, const Phase& phase) const {
    Carry carry[N]{};
    for (int s = 0; s < n; ++s)
      (*this)([&](int l) { phase(l, s, carry[l]); });
  }
  template <class T>
  struct Own {
    T v[N];
    LANES_HD T& operator()(int l) { return v[l]; }
  };
  template <class Work>
  LANES_HD void mark(Work&, int) const {}
};

}  // namespace icem
