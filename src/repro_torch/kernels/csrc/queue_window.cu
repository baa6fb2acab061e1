// The queue env's window scan, for Hopper (sm_90a): one decision's
// MAX_WINDOW = 128 masked training steps through the fluid fabric twin,
// for every env of a batch in one launch.
//
// It has no Pallas counterpart. It replaces the device loop XLA makes of
// the reference's lax.scan over `substep`
// (src/repro/core/queue_sim.py:563-654): each step advances the Markov
// on/off chains and the step-trace levels, evaluates the scenario's
// utilization and injected delay, the service rate phi, the step cost of
// the action (behind the carried link backlogs) and of the reference
// action (no backlog), drains the link queues FIFO (rebuild work first),
// and adds the step to the window's accumulators. Steps at or past the
// env's eff_window change nothing, so the thread stops there.
//
// Design. One thread per env (up to 128 a block) runs the window code of
// fluid_window.cuh, window_scan<MAXP, false>: the env's fabric state and
// accumulators in registers across the steps, MAXP (4, 8 or 16; the
// entry picks the smallest that holds n_owners) sizing the per-owner
// register arrays. The cluster env's kernel (cluster_window.cu) runs the
// same code with its terms switched on.
//
// Arithmetic. Built with -fmad=false (kernels/_build.py), so no product
// and sum contract to an FMA, and without fast math: sinf and IEEE
// division, never the approximate intrinsics; each formula keeps the
// reference's operation order (fluid_window.cuh).
//
// Bound: bytes. The function reads its packed inputs and 3 x 128 x P
// uniforms an env and writes its outputs once: about 150 KB at 32 envs
// and P = 3, 0.05 us at 3.35 TB/s; its operations (a few hundred a step
// an env) are fewer still. The kernel is a chain of 128 dependent steps
// per thread, so its time is the chain's latency, far from that bound.
//
// Layout: the enums of fluid_window.cuh (Scal, Ints, Own, State, Acc,
// AccOwn); the Python side, kernels/queue_window/ref.py, names the same
// columns in the same order.

#include <cuda_runtime.h>

#include "fluid_window.cuh"

namespace {

using fluid::THREADS;

template <int MAXP>
__global__ void __launch_bounds__(THREADS)
queue_window_kernel(const float* __restrict__ scal,
                    const int* __restrict__ ints,
                    const float* __restrict__ own,
                    const float* __restrict__ state,
                    const float* __restrict__ unif,
                    float* __restrict__ acc_out,
                    float* __restrict__ acc_own_out,
                    float* __restrict__ state_out,
                    int n, int P, int n_epochs, int steps_per_epoch) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= n) return;
  const fluid::PeerIo no_peers{nullptr, nullptr, nullptr, nullptr};
  fluid::window_scan<MAXP, false>(env, scal, ints, own, state, unif,
                                  acc_out, acc_own_out, state_out, no_peers,
                                  P, n_epochs, steps_per_epoch);
}

template <int MAXP>
void launch(const float* scal, const int* ints, const float* own,
            const float* state, const float* unif, float* acc,
            float* acc_own, float* state_out, int n, int P, int n_epochs,
            int steps_per_epoch, cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  queue_window_kernel<MAXP><<<blocks, THREADS, 0, stream>>>(
      scal, ints, own, state, unif, acc, acc_own, state_out, n, P, n_epochs,
      steps_per_epoch);
}

}  // namespace

// One launch for n envs of P owners (1 <= P <= 16). The operands are
// contiguous float32 (ints: int32) in the layouts above. Returns
// cudaGetLastError() after the launch.
extern "C" int queue_window_f32(const void* scal, const void* ints,
                                const void* own, const void* state,
                                const void* unif, void* acc, void* acc_own,
                                void* state_out, int n, int P, int n_epochs,
                                int steps_per_epoch, void* stream) {
  if (n < 0 || P < 1 || P > 16 || steps_per_epoch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const auto* sc = static_cast<const float*>(scal);
    const auto* in = static_cast<const int*>(ints);
    const auto* ow = static_cast<const float*>(own);
    const auto* st = static_cast<const float*>(state);
    const auto* un = static_cast<const float*>(unif);
    auto* ac = static_cast<float*>(acc);
    auto* ao = static_cast<float*>(acc_own);
    auto* so = static_cast<float*>(state_out);
    auto s = static_cast<cudaStream_t>(stream);
    if (P <= 4) {
      launch<4>(sc, in, ow, st, un, ac, ao, so, n, P, n_epochs,
                steps_per_epoch, s);
    } else if (P <= 8) {
      launch<8>(sc, in, ow, st, un, ac, ao, so, n, P, n_epochs,
                steps_per_epoch, s);
    } else {
      launch<16>(sc, in, ow, st, un, ac, ao, so, n, P, n_epochs,
                 steps_per_epoch, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
