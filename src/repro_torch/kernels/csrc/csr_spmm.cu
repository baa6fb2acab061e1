// CSR SpMM for the GNN aggregation, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/segment_mm/kernel.py::block_spmm_kernel
// (body _spmm_kernel), which computes Y = A @ X over dense 128 x 128
// adjacency blocks because the TPU's matrix unit wants dense tiles and the
// TPU has no atomics. At the trainer's sizes those blocks are 0.2-0.4%
// full, so here A travels as CSR (rowptr, col, val), and
//
//     Y[r, :] = sum over e in [rowptr[r], rowptr[r+1]) of val[e] * X[col[e], :]
//
// Bound: bytes. The least the function moves is the entries (8 B each),
// the row pointers, X and Y: about 2.8 MB at the trainer's layer 0, under a
// microsecond at 3.35 TB/s, and 2 * nnz * F operations, fewer still. At
// these sizes the kernel is latency-bound: a launch, one row-pointer load,
// one entry load and a few dependent X gathers set its time.
//
// Design. A group of G lanes (G = F / 4 rounded up to a power of two:
// 16 at F = 64, 4 at F = 16) owns one destination row outright; each lane
// holds one float4 of the row's accumulator. There are no atomics. The
// group walks its row in batches of B entries (16, or 32 at G = 32): each
// lane loads B / G of a batch's (col, val) pairs into fixed register slots
// (entry j in lane j % G, slot j / G), and the next batch's pairs are
// loaded before this batch's FMAs. The lanes broadcast the pairs with
// __shfl_sync and issue the X row gathers of U entries (16-byte
// ld.global.nc loads) before the first of their FMAs, so a short row costs
// about three dependent loads (row pointers, entries, X rows) and a long
// one (up to 105 entries in layer 1's transpose) one more X latency per U
// entries, while the FMAs retire in column order. No row is split; X (at
// most 2.1 MB) stays in the 50 MB L2 between gathers.
//
// Summation order. Each output element is acc = fmaf(val[e], x, acc) over
// the row's entries in ascending column order, from acc = +0. The dense
// kernel (block_spmm.cu) contracts acc += a * x to the same FFMA over the
// same columns in the same order, and its terms with a = 0 leave acc
// unchanged for finite X, so the two give identical bits; two launches of
// this kernel do too. Empty and padded rows are written as zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int G>
__global__ void __launch_bounds__(THREADS)
csr_spmm_kernel(const int* __restrict__ rowptr,
                const int* __restrict__ col,
                const float* __restrict__ val,
                const float* __restrict__ x,
                float* __restrict__ y,
                int n_rows, int f) {
  constexpr int B = G < 16 ? 16 : G;      // entries per batch
  constexpr int P = B / G;                // of them loaded by each lane
  constexpr int U = G < 32 ? 16 : 8;      // X gathers in flight per lane
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;               // lane within the row's group
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane - sub);
  const int row = (blockIdx.x * THREADS + threadIdx.x) / G;
  if (row >= n_rows) return;              // the whole group leaves
  const int c4 = sub * 4;
  const bool active = c4 < f;             // lanes past F only relay entries

  const int e_begin = __ldg(rowptr + row);
  const int e_end = __ldg(rowptr + row + 1);
  int c[P];
  float v[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int e = e_begin + p * G + sub;
    c[p] = e < e_end ? __ldg(col + e) : 0;
    v[p] = e < e_end ? __ldg(val + e) : 0.f;
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e0 = e_begin; e0 < e_end; e0 += B) {
    const int n = min(B, e_end - e0);
    int cn[P];
    float vn[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {           // the next batch, in flight now
      const int e = e0 + B + p * G + sub;
      cn[p] = e < e_end ? __ldg(col + e) : 0;
      vn[p] = e < e_end ? __ldg(val + e) : 0.f;
    }
#pragma unroll
    for (int k0 = 0; k0 < B; k0 += U) {
      if (k0 >= n) break;
      float vk[U];
      float4 xk[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int j = k0 + k;               // static: slot j / G, lane j % G
        const int ck = __shfl_sync(mask, c[j / G], j % G, G);
        vk[k] = __shfl_sync(mask, v[j / G], j % G, G);
        xk[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (active && j < n) {
          xk[k] = __ldg(reinterpret_cast<const float4*>(
              x + (size_t)ck * f + c4));
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (k0 + k < n) {
          acc.x = fmaf(vk[k], xk[k].x, acc.x);
          acc.y = fmaf(vk[k], xk[k].y, acc.y);
          acc.z = fmaf(vk[k], xk[k].z, acc.z);
          acc.w = fmaf(vk[k], xk[k].w, acc.w);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      c[p] = cn[p];
      v[p] = vn[p];
    }
  }
  if (active) {
    *reinterpret_cast<float4*>(y + (size_t)row * f + c4) = acc;
  }
}

template <int G>
void launch(const int* rowptr, const int* col, const float* val,
            const float* x, float* y, int n_rows, int f,
            cudaStream_t stream) {
  const long long threads = (long long)n_rows * G;
  const int grid = (int)((threads + THREADS - 1) / THREADS);
  csr_spmm_kernel<G><<<grid, THREADS, 0, stream>>>(rowptr, col, val, x, y,
                                                   n_rows, f);
}

}  // namespace

// rowptr: (n_rows + 1,) int32, col: (nnz,) int32 (< rows of x, ascending
// within a row), val: (nnz,) f32, x: (M, f) f32, y: (n_rows, f) f32.
// f % 4 == 0, 0 < f <= 128; x and y 16-byte aligned. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an f the
// kernel does not take).
extern "C" int csr_spmm_f32(const void* rowptr, const void* col,
                            const void* val, const void* x, void* y,
                            int n_rows, int f, void* stream) {
  if (f <= 0 || f > 128 || f % 4 != 0 || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0) {
    const auto* rp = static_cast<const int*>(rowptr);
    const auto* cl = static_cast<const int*>(col);
    const auto* vl = static_cast<const float*>(val);
    const auto* xs = static_cast<const float*>(x);
    auto* ys = static_cast<float*>(y);
    auto s = static_cast<cudaStream_t>(stream);
    const int lanes = f / 4;
    if (lanes <= 1) {
      launch<1>(rp, cl, vl, xs, ys, n_rows, f, s);
    } else if (lanes <= 2) {
      launch<2>(rp, cl, vl, xs, ys, n_rows, f, s);
    } else if (lanes <= 4) {
      launch<4>(rp, cl, vl, xs, ys, n_rows, f, s);
    } else if (lanes <= 8) {
      launch<8>(rp, cl, vl, xs, ys, n_rows, f, s);
    } else if (lanes <= 16) {
      launch<16>(rp, cl, vl, xs, ys, n_rows, f, s);
    } else {
      launch<32>(rp, cl, vl, xs, ys, n_rows, f, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
