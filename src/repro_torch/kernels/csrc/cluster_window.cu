// The cluster env's window scan, for Hopper (sm_90a): one decision's
// MAX_WINDOW = 128 masked training steps of the P-requester fluid twin,
// for every env of a batch in one launch.
//
// It has no Pallas counterpart. It replaces the device loop XLA makes of
// the reference's lax.scan over `substep`
// (src/repro/envs/cluster_sim.py:383-545): the queue env's window (the
// ego's per-owner backlogs, its step cost and the reference action's)
// plus the scripted peers' window (static W = 16, or the reactive
// clip(16 / sqrt(max(sigma_seen, 1)), 4, 32)), their hit rate, miss and
// rebuild volumes and arrivals, queued FIFO ahead of the ego; the barrier
// wait on the slowest live peer; the ring collective's wall and CPU; the
// drain over the step's wall time (peer work, then the ego's rebuild,
// then its misses); and the accumulators.
//
// Design. One thread per env (up to 128 a block) runs
// fluid_window.cuh's window_scan<MAXP, true>: the queue env's kernel
// (queue_window.cu) runs the same code with CLUSTER = false, so with no
// live peer and clean factors the two give the same bits. The per-env
// constants (the live mask and count, the ring collective's cost, each
// peer's compute-scaled t_base and slack) come computed with the
// operands; the ego's compute-scaled t_base and slack come in the queue
// layout's columns. Built with -fmad=false, as the queue kernel is.
//
// Bound: bytes. The function reads the queue window's packed inputs, the
// peers' (N_PSCAL + N_POWN x P floats an env) and 3 x 128 x P uniforms an
// env, and writes its outputs once: about 160 KB at 32 envs and P = 3,
// 0.05 us at 3.35 TB/s. Like the queue kernel it is a chain of 128
// dependent steps per thread, far from that bound.
//
// Layout: fluid_window.cuh's enums (the queue layout's, and PScal, POwn,
// PState for the peers); the Python side is kernels/cluster_window/ref.py.

#include <cuda_runtime.h>

#include "fluid_window.cuh"

namespace {

using fluid::THREADS;

template <int MAXP>
__global__ void __launch_bounds__(THREADS)
cluster_window_kernel(const float* __restrict__ scal,
                      const int* __restrict__ ints,
                      const float* __restrict__ own,
                      const float* __restrict__ state,
                      const float* __restrict__ unif,
                      const float* __restrict__ pscal,
                      const float* __restrict__ pown,
                      float* __restrict__ acc_out,
                      float* __restrict__ acc_own_out,
                      float* __restrict__ state_out,
                      float* __restrict__ pstate_out,
                      float* __restrict__ pback_out,
                      int n, int P, int n_epochs, int steps_per_epoch) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= n) return;
  const fluid::PeerIo peers{pscal, pown, pstate_out, pback_out};
  fluid::window_scan<MAXP, true>(env, scal, ints, own, state, unif, acc_out,
                                 acc_own_out, state_out, peers, P, n_epochs,
                                 steps_per_epoch);
}

template <int MAXP>
void launch(const float* scal, const int* ints, const float* own,
            const float* state, const float* unif, const float* pscal,
            const float* pown, float* acc, float* acc_own, float* state_out,
            float* pstate_out, float* pback_out, int n, int P, int n_epochs,
            int steps_per_epoch, cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  cluster_window_kernel<MAXP><<<blocks, THREADS, 0, stream>>>(
      scal, ints, own, state, unif, pscal, pown, acc, acc_own, state_out,
      pstate_out, pback_out, n, P, n_epochs, steps_per_epoch);
}

}  // namespace

// One launch for n envs of P owners (1 <= P <= 16). The operands are
// contiguous float32 (ints: int32) in the layouts of fluid_window.cuh.
// Returns cudaGetLastError() after the launch.
extern "C" int cluster_window_f32(const void* scal, const void* ints,
                                  const void* own, const void* state,
                                  const void* unif, const void* pscal,
                                  const void* pown, void* acc, void* acc_own,
                                  void* state_out, void* pstate_out,
                                  void* pback_out, int n, int P,
                                  int n_epochs, int steps_per_epoch,
                                  void* stream) {
  if (n < 0 || P < 1 || P > 16 || steps_per_epoch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const auto* sc = static_cast<const float*>(scal);
    const auto* in = static_cast<const int*>(ints);
    const auto* ow = static_cast<const float*>(own);
    const auto* st = static_cast<const float*>(state);
    const auto* un = static_cast<const float*>(unif);
    const auto* ps = static_cast<const float*>(pscal);
    const auto* po = static_cast<const float*>(pown);
    auto* ac = static_cast<float*>(acc);
    auto* ao = static_cast<float*>(acc_own);
    auto* so = static_cast<float*>(state_out);
    auto* pso = static_cast<float*>(pstate_out);
    auto* pbo = static_cast<float*>(pback_out);
    auto s = static_cast<cudaStream_t>(stream);
    if (P <= 4) {
      launch<4>(sc, in, ow, st, un, ps, po, ac, ao, so, pso, pbo, n, P,
                n_epochs, steps_per_epoch, s);
    } else if (P <= 8) {
      launch<8>(sc, in, ow, st, un, ps, po, ac, ao, so, pso, pbo, n, P,
                n_epochs, steps_per_epoch, s);
    } else {
      launch<16>(sc, in, ow, st, un, ps, po, ac, ao, so, pso, pbo, n, P,
                 n_epochs, steps_per_epoch, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
