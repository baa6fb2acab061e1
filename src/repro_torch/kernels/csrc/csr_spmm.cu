// CSR SpMM for the GNN aggregation, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/segment_mm/kernel.py:59
// (pl.pallas_call at :78, body _spmm_kernel), which computes Y = A @ X over dense 128 x 128
// adjacency blocks because the TPU's matrix unit wants dense tiles and the
// TPU has no atomics. At the trainer's sizes those blocks are 0.2-0.4%
// full, so here A travels as CSR (rowptr, col, val), and
//
//     Y[r, :] = sum over e in [rowptr[r], rowptr[r+1]) of val[e] * X[col[e], :]
//
// for any width F >= 1, X and Y with row strides ldx and ldy (in floats).
//
// Bound: bytes. The least the function moves is the entries (8 B each),
// the row pointers, X and Y, and it does 2 * nnz * F operations, fewer
// still per byte (F / 4 operations for every 8-byte entry and 4-byte X
// element): about 2.8 MB at the reddit trainer's layer 0 (F = 64), under a
// microsecond at 3.35 TB/s; at full_graph_sm's layer 0 (F = 1,433) X alone
// is 4 to 15 MB, a few microseconds. At these sizes the kernel is
// latency-bound: a launch, one row-pointer load, one entry load and a few
// dependent X gathers set its time.
//
// Design. A group of G lanes owns one destination row's column slab
// outright; each lane holds V floats of the slab's accumulator (V = 4, one
// float4, or V = 1). The slab is G * V columns wide, at most 128 (V = 4,
// G = 32) or 32 (V = 1), and blockIdx.y picks it, so a row wider than one
// slab is covered by several groups in one launch, each walking the row's
// entries again (they stay in L1/L2). G = the slab's lane count rounded up
// to a power of two: 16 at F = 64, 4 at F = 16, 32 above 128. V = 4 needs
// X and Y 16-byte aligned with row strides a multiple of 4 floats, and
// their rows readable and writable up to F rounded up to 4: the last lane
// of a row whose F is not a multiple of 4 loads and stores the pad columns
// (the trainer's input is laid out so, and the wrapper allocates Y so and
// returns the first F columns). Anything else runs the V = 1 instance, one
// coalesced float a lane. There are no atomics. The group walks its row in
// batches of B entries (16, or 32 at G = 32): each lane loads B / G of a
// batch's (col, val) pairs into fixed register slots (entry j in lane
// j % G, slot j / G), and the next batch's pairs are loaded before this
// batch's FMAs. The lanes broadcast the pairs with __shfl_sync and issue
// the X gathers of U entries (ld.global.nc) before the first of their
// FMAs, so a short row costs about three dependent loads (row pointers,
// entries, X rows) and a long one (up to 105 entries in layer 1's
// transpose) one more X latency per U entries, while the FMAs retire in
// column order. No row is split along its entries.
//
// Summation order. Each output element is acc = fmaf(val[e], x, acc) over
// the row's entries in ascending column order, from acc = +0, whatever the
// slab, V or G, so two launches give identical bits. Empty and padded rows
// are written as zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int V>
struct Vec;

template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <int G, int V>
__global__ void __launch_bounds__(THREADS)
csr_spmm_kernel(const int* __restrict__ rowptr,
                const int* __restrict__ col,
                const float* __restrict__ val,
                const float* __restrict__ x,
                float* __restrict__ y,
                int n_rows, int f, int ldx, int ldy) {
  constexpr int B = G < 16 ? 16 : G;      // entries per batch
  constexpr int P = B / G;                // of them loaded by each lane
  constexpr int U = G < 32 ? 16 : 8;      // X gathers in flight per lane
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;               // lane within the row's group
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane - sub);
  const int row = (blockIdx.x * THREADS + threadIdx.x) / G;
  if (row >= n_rows) return;              // the whole group leaves
  const int c0 = (blockIdx.y * G + sub) * V;  // this lane's first column
  const bool active = c0 < f;             // lanes past F only relay entries

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
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
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
      float xk[U][V];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int j = k0 + k;               // static: slot j / G, lane j % G
        const int ck = __shfl_sync(mask, c[j / G], j % G, G);
        vk[k] = __shfl_sync(mask, v[j / G], j % G, G);
#pragma unroll
        for (int i = 0; i < V; ++i) xk[k][i] = 0.f;
        if (active && j < n) {
          Vec<V>::load(x + (size_t)ck * ldx + c0, xk[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (k0 + k < n) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(vk[k], xk[k][i], acc[i]);
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
    Vec<V>::store(y + (size_t)row * ldy + c0, acc);
  }
}

template <int G, int V>
void launch(const int* rowptr, const int* col, const float* val,
            const float* x, float* y, int n_rows, int f, int ldx, int ldy,
            int n_slabs, cudaStream_t stream) {
  const long long threads = (long long)n_rows * G;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS),
                  (unsigned)n_slabs);
  csr_spmm_kernel<G, V><<<grid, THREADS, 0, stream>>>(
      rowptr, col, val, x, y, n_rows, f, ldx, ldy);
}

template <int V>
void launch_v(const int* rp, const int* cl, const float* vl, const float* xs,
              float* ys, int n_rows, int f, int ldx, int ldy,
              cudaStream_t s) {
  constexpr int SLAB = 32 * V;              // widest slab: 32 lanes of V
  const int n_slabs = (f + SLAB - 1) / SLAB;
  const int lanes = n_slabs > 1 ? 32 : (f + V - 1) / V;
  if (lanes <= 1) {
    launch<1, V>(rp, cl, vl, xs, ys, n_rows, f, ldx, ldy, n_slabs, s);
  } else if (lanes <= 2) {
    launch<2, V>(rp, cl, vl, xs, ys, n_rows, f, ldx, ldy, n_slabs, s);
  } else if (lanes <= 4) {
    launch<4, V>(rp, cl, vl, xs, ys, n_rows, f, ldx, ldy, n_slabs, s);
  } else if (lanes <= 8) {
    launch<8, V>(rp, cl, vl, xs, ys, n_rows, f, ldx, ldy, n_slabs, s);
  } else if (lanes <= 16) {
    launch<16, V>(rp, cl, vl, xs, ys, n_rows, f, ldx, ldy, n_slabs, s);
  } else {
    launch<32, V>(rp, cl, vl, xs, ys, n_rows, f, ldx, ldy, n_slabs, s);
  }
}

}  // namespace

// rowptr: (n_rows + 1,) int32, col: (nnz,) int32 (< rows of x, ascending
// within a row), val: (nnz,) f32, x: rows of f f32 at stride ldx, y: n_rows
// rows of f f32 at stride ldy. vec = 1 runs the float4 instance: x and y
// 16-byte aligned, ldx and ldy multiples of 4, and every row of x readable
// and of y writable up to f rounded up to 4; vec = 0 the scalar one (any
// f >= 1, ldx, ldy >= f). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int csr_spmm_f32(const void* rowptr, const void* col,
                            const void* val, const void* x, void* y,
                            int n_rows, int f, int ldx, int ldy, int vec,
                            void* stream) {
  const int v = vec ? 4 : 1;
  const int f_pad = (f + v - 1) / v * v;
  if (f <= 0 || n_rows < 0 || ldx < f_pad || ldy < f_pad
      || (vec && (ldx % 4 != 0 || ldy % 4 != 0
                  || reinterpret_cast<uintptr_t>(x) % 16 != 0
                  || reinterpret_cast<uintptr_t>(y) % 16 != 0))
      || (f + 32 * v - 1) / (32 * v) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 0) {
    const auto* rp = static_cast<const int*>(rowptr);
    const auto* cl = static_cast<const int*>(col);
    const auto* vl = static_cast<const float*>(val);
    const auto* xs = static_cast<const float*>(x);
    auto* ys = static_cast<float*>(y);
    auto s = static_cast<cudaStream_t>(stream);
    if (vec) {
      launch_v<4>(rp, cl, vl, xs, ys, n_rows, f, ldx, ldy, s);
    } else {
      launch_v<1>(rp, cl, vl, xs, ys, n_rows, f, ldx, ldy, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
