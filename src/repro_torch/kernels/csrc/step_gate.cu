// A stream gate, so that two CUDA events time a step's device work only,
// for Hopper (sm_90a).
//
// No TPU kernel is replaced. The reference times its measured step as one
// compiled executable (src/repro/train/compute.py:303-307), in which no
// Python runs. The port's step is ~100 eager launches enqueued by Python,
// and an event pair around them also times any host stall while they are
// enqueued (another thread holding the interpreter, the OS), because the
// card runs each launch as soon as it arrives and then waits for the next.
//
// The gate holds the stream until the host has enqueued the whole step:
//
//   host:   gate  start.record()  step's launches  end.record()  open
//   device: spin ....................................... | start | step | end
//
// One thread of one block spins on a word of pinned, mapped host memory
// (flag) until the host writes the gate's token there, then writes the
// token to a second such word (status) and exits. The events then bracket
// work that was all enqueued before the first of it ran.
//
// A gate that is never opened would hold the stream for good, and a host
// wait on the stream inside the bracket (a pageable copy, an .item()) would
// never return. So the spin gives up after timeout_ns of the device's
// global timer and writes -token to status instead; the wrapper raises
// when it reads that back.
//
// Bound: 8 bytes (the flag read once, the status written once); a launch
// and one poll of host memory over the bus set the time of an open gate.
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void step_gate_kernel(const volatile int* flag,
                                 volatile int* status, int token,
                                 long long timeout_ns) {
  const unsigned long long t0 = global_ns();
  int out = token;
  while (*flag != token) {
    if (static_cast<long long>(global_ns() - t0) > timeout_ns) {
      out = -token;
      break;
    }
    __nanosleep(256);
  }
  *status = out;
  __threadfence_system();
}

// flag, status: host pointers into pinned memory (cudaHostAlloc or
// registered); their device addresses are looked up here.
extern "C" int step_gate_wait(void* flag, void* status, int token,
                              long long timeout_ns, void* stream) {
  if (token <= 0 || timeout_ns <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* dflag = nullptr;
  void* dstatus = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&dflag, flag, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaHostGetDevicePointer(&dstatus, status, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  step_gate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const volatile int*>(dflag),
      static_cast<volatile int*>(dstatus), token, timeout_ns);
  return static_cast<int>(cudaGetLastError());
}
