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
// env's eff_window change nothing, so the block runs only the live ones.
//
// Design. A block per env (the grid is the env count), running
// fluid_window.cuh's window_scan<MAXP, false>: the env's uniforms and
// packed rows staged in shared memory once; the chains walked a thread an
// owner; everything that does not depend on the carried backlogs (u, d,
// phi and its reciprocal, the walls' backlog-free terms, the CPU term,
// ar, the reference action's whole cost) priced step-parallel, a thread
// a live step; then the backlog recurrence alone, scanned by one warp
// with each step's queue-reading divisions one a lane; then the rebuild
// wait and per_row step-parallel, summed in step order. MAXP (1 to 4
// exact, or the bounds 8 and 16) fixes the owner loops. The cluster
// env's kernel (cluster_window.cu) runs the same code with its terms
// switched on. It replaces a one-thread-an-env loop, whose 32-env launch
// was one warp on one SM recomputing every term of a step in series
// (divergent across scenario codes, reading each step's uniforms with a
// 1.5 KB stride), and gives its outputs bit for bit.
//
// Arithmetic. Built with -fmad=false (kernels/_build.py), so no product
// and sum contract to an FMA, and without fast math: sinf and IEEE
// division, never the approximate intrinsics; each formula keeps the
// reference's operation order (fluid_window.cuh).
//
// Bound: bytes. The function reads its packed inputs and 3 x 128 x P
// uniforms an env and writes its outputs once: about 160 KB at 32 envs
// and P = 3, 0.05 us at 3.35 TB/s; its operations (a few hundred a step
// an env) are fewer still. The recurrence sets the floor that matters:
// the scan's dependent chain, 23 operations and a shuffle a step at P = 3
// (fluid_window.cuh), ~120 cycles, ~7.6 us for 128 steps at 1.98 GHz. The
// block per env runs the envs' chains side by side on as many SMs, so a
// launch costs about one env's scan (~2.4x that floor: one warp issuing
// ~118 instructions a step) plus the stage, chains, prologue and
// epilogue (~7.5 us together on an H100).
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
                    int n_owners, int n_epochs, int steps_per_epoch) {
  // up to 4 owners an instance holds exactly its bound: P is a constant
  const int P = MAXP <= 4 ? MAXP : n_owners;
  const fluid::PeerIo no_peers{nullptr, nullptr, nullptr, nullptr};
  fluid::window_scan<MAXP, false>(scal, ints, own, state, unif, acc_out,
                                  acc_own_out, state_out, no_peers, P,
                                  n_epochs, steps_per_epoch);
}

// One launch's operands, in the C entry's order.
struct Args {
  const float* scal;
  const int* ints;
  const float *own, *state, *unif;
  float *acc, *acc_own, *state_out;
  int n, P, n_epochs, steps_per_epoch;
  cudaStream_t stream;
};

template <int MAXP>
cudaError_t launch(const Args& a) {
  const size_t smem = fluid::smem_bytes<false>(a.P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        queue_window_kernel<MAXP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  queue_window_kernel<MAXP><<<a.n, THREADS, smem, a.stream>>>(
      a.scal, a.ints, a.own, a.state, a.unif, a.acc, a.acc_own, a.state_out,
      a.P, a.n_epochs, a.steps_per_epoch);
  return cudaSuccess;
}

}  // namespace

// One launch for n envs of P owners (1 <= P <= 16): n blocks. The
// operands are contiguous float32 (ints: int32) in the layouts above.
// Returns the error of raising the block's shared-memory limit, if any,
// else cudaGetLastError() after the launch.
extern "C" int queue_window_f32(const void* scal, const void* ints,
                                const void* own, const void* state,
                                const void* unif, void* acc, void* acc_own,
                                void* state_out, int n, int P, int n_epochs,
                                int steps_per_epoch, void* stream) {
  if (n < 0 || P < 1 || P > 16 || steps_per_epoch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const Args a{static_cast<const float*>(scal),
                 static_cast<const int*>(ints),
                 static_cast<const float*>(own),
                 static_cast<const float*>(state),
                 static_cast<const float*>(unif),
                 static_cast<float*>(acc),
                 static_cast<float*>(acc_own),
                 static_cast<float*>(state_out),
                 n, P, n_epochs, steps_per_epoch,
                 static_cast<cudaStream_t>(stream)};
    // an instance for each owner count up to 4 (the bound is P), then
    // bounds of 8 and 16
    const cudaError_t err = P == 1 ? launch<1>(a)
        : P == 2 ? launch<2>(a)
        : P == 3 ? launch<3>(a)
        : P == 4 ? launch<4>(a)
        : P <= 8 ? launch<8>(a)
        : launch<16>(a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
