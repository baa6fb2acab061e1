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
// Design. A block per env (the grid is the env count) runs
// fluid_window.cuh's window_scan<MAXP, true>: the queue env's kernel
// (queue_window.cu) runs the same code with CLUSTER = false, so with no
// live peer and clean factors the two give the same bits. Beyond the
// queue window's split (the stage, the chains, the step-parallel
// prologue, the warp's scan of the backlogs, the epilogue), the prologue
// prices the peers' w_target a step, one thread walks their window (a
// select chain: the rebuild boundary, w_peer, and the window their
// volumes were last priced at), and a thread a step prices their hit
// rate and volumes (two powf), arrivals, the own-NIC wall and the peer
// wall's backlog-free term; the scan adds each owner's peer wall behind
// the same queues (one more division item a lane), the barrier and the
// collective's energy, and drains the peer work first. The per-env
// constants (the live mask and count, the ring collective's cost, each
// peer's compute-scaled t_base and slack) come computed with the
// operands; the ego's compute-scaled t_base and slack come in the queue
// layout's columns. Built with -fmad=false, as the queue kernel is.
//
// Bound: bytes. The function reads the queue window's packed inputs, the
// peers' (N_PSCAL + N_POWN x P floats an env) and 3 x 128 x P uniforms an
// env, and writes its outputs once: about 165 KB at 32 envs and P = 3,
// 0.05 us at 3.35 TB/s. The scan's chain sets the floor that matters: 30
// dependent operations and a shuffle a step at P = 3 (the queue kernel's
// chain with the peer wall's maximum, the barrier's wait and the peer
// drain in it; read from the built code), ~145 cycles, ~9.4 us for 128
// steps at 1.98 GHz; one warp issuing ~174 instructions a step runs at
// ~2.5x that. The peers' walk and pricing add ~4.5 us to the queue
// kernel's stage, chains, prologue and epilogue.
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
                      int n_owners, int n_epochs, int steps_per_epoch) {
  // up to 4 owners an instance holds exactly its bound: P is a constant
  const int P = MAXP <= 4 ? MAXP : n_owners;
  const fluid::PeerIo peers{pscal, pown, pstate_out, pback_out};
  fluid::window_scan<MAXP, true>(scal, ints, own, state, unif, acc_out,
                                 acc_own_out, state_out, peers, P, n_epochs,
                                 steps_per_epoch);
}

// One launch's operands, in the C entry's order.
struct Args {
  const float* scal;
  const int* ints;
  const float *own, *state, *unif, *pscal, *pown;
  float *acc, *acc_own, *state_out, *pstate_out, *pback_out;
  int n, P, n_epochs, steps_per_epoch;
  cudaStream_t stream;
};

template <int MAXP>
cudaError_t launch(const Args& a) {
  const size_t smem = fluid::smem_bytes<true>(a.P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_window_kernel<MAXP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cluster_window_kernel<MAXP><<<a.n, THREADS, smem, a.stream>>>(
      a.scal, a.ints, a.own, a.state, a.unif, a.pscal, a.pown, a.acc,
      a.acc_own, a.state_out, a.pstate_out, a.pback_out, a.P, a.n_epochs,
      a.steps_per_epoch);
  return cudaSuccess;
}

}  // namespace

// One launch for n envs of P owners (1 <= P <= 16): n blocks. The
// operands are contiguous float32 (ints: int32) in the layouts of
// fluid_window.cuh. Returns the error of raising the block's
// shared-memory limit, if any, else cudaGetLastError() after the launch.
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
    const Args a{static_cast<const float*>(scal),
                 static_cast<const int*>(ints),
                 static_cast<const float*>(own),
                 static_cast<const float*>(state),
                 static_cast<const float*>(unif),
                 static_cast<const float*>(pscal),
                 static_cast<const float*>(pown),
                 static_cast<float*>(acc),
                 static_cast<float*>(acc_own),
                 static_cast<float*>(state_out),
                 static_cast<float*>(pstate_out),
                 static_cast<float*>(pback_out),
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
