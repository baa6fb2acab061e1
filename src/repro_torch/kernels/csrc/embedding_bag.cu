// Sum-mode EmbeddingBag over segment-sorted lookups, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/embedding_bag/kernel.py::embedding_bag_kernel
// (body _bag_kernel):
//
//     out[seg[i]]  = w[i] * table[idx[i]]   for the first lookup of a bag
//     out[seg[i]] += w[i] * table[idx[i]]   for the later ones
//
// The TPU kernel walks the lookups in grid order, one (1, D) row per step,
// and relies on the sorted segments to revisit an output row only on
// consecutive steps. Here one warp owns one bag: the wrapper sorts the
// lookups by bag and hands the bag offsets (offsets[bag] .. offsets[bag+1]),
// so each warp reads its run of lookups and writes its output row once.
// A bag with no lookups writes zeros. The product is rounded before the
// sum (no FMA contraction), as in the TPU kernel, so one lookup per bag
// with unit weight is a bit-exact row gather.
//
// Bound: bytes. Each lookup reads one D-float table row and each bag writes
// one D-float row, with one multiply and one add per element. Lanes read
// consecutive columns of a row, so every warp load is one coalesced
// transaction of 32 floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
embedding_bag_kernel(const int* __restrict__ idx,
                     const float* __restrict__ w,
                     const int* __restrict__ offsets,
                     const float* __restrict__ table,
                     float* __restrict__ out,
                     int n_bags, int d) {
  const int bag = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (bag >= n_bags) return;
  const int begin = offsets[bag], end = offsets[bag + 1];
  float* dst = out + (size_t)bag * d;
  for (int c = lane; c < d; c += 32) {
    float acc = 0.f;
    for (int i = begin; i < end; ++i) {
      const float v = __fmul_rn(__ldg(table + (size_t)idx[i] * d + c), w[i]);
      acc = (i == begin) ? v : __fadd_rn(acc, v);
    }
    dst[c] = acc;
  }
}

}  // namespace

// idx, w: (L,) int32 / f32, sorted by bag; offsets: (n_bags + 1,) int32;
// table: (R, d) f32; out: (n_bags, d) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int embedding_bag_f32(const void* idx, const void* w,
                                 const void* offsets, const void* table,
                                 void* out, int n_bags, int d,
                                 void* stream) {
  if (n_bags > 0 && d > 0) {
    const int grid = (n_bags + WARPS - 1) / WARPS;
    embedding_bag_kernel<<<grid, WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), static_cast<const float*>(w),
        static_cast<const int*>(offsets), static_cast<const float*>(table),
        static_cast<float*>(out), n_bags, d);
  }
  return static_cast<int>(cudaGetLastError());
}
