// Sum-mode EmbeddingBag over bag-sorted lookups, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/embedding_bag/kernel.py::embedding_bag_kernel
// (body _bag_kernel):
//
//     out[seg[i]]  = w[i] * table[idx[i]]   for the first lookup of a bag
//     out[seg[i]] += w[i] * table[idx[i]]   for the later ones
//
// and zeros for a bag with no lookups (the reference wrapper zeroes them).
// The TPU kernel walks the lookups in grid order, one (1, D) row a step,
// and relies on sorted segments to revisit an output row only on
// consecutive steps. Here the host hands over the lookups sorted by bag
// with the bag offsets (BagFormat: bag b owns lookups offsets[b] ..
// offsets[b+1]), and each bag is summed by lanes that own its columns.
//
// Bound: bytes. Each lookup reads one D-float row (and its index and
// weight), each bag writes one row: at the trainer's gather (5,047 bags of
// one lookup, D = 64) that is 2.6 MB, 0.8 us at 3.35 TB/s. At that size
// the time is latency: a bag is a chain of dependent loads (its offsets,
// then its indices and weights, then the rows) and a store.
//
// Design.
//  - A group of G lanes owns one bag's slab of G * V columns: V = 4 (one
//    16-byte ld.global.nc.v4.f32 a lane per row, __ldg) when D % 4 == 0
//    and the table and output are 16-byte aligned, else V = 1, the scalar
//    instance of the same kernel, chosen by shape in the C entry. G is
//    D / V rounded up to a power of two, at most 32: 16 at D = 64, so a
//    warp sums two bags and the trainer's 5,047 bags are resident at once
//    on the 132 SMs. A row wider than 32 * V columns is cut into slabs,
//    one group each; a group reads its bag's indices and weights once.
//  - Exactly one lookup per bag (the device tier's gather; the C entry is
//    told the lookup count and the longest bag) takes the U = 1 instance:
//    bag b's lookup is lookup b, so it reads no offsets, and every lane
//    loads the index and weight itself (one broadcast load) and then its
//    part of the row: a chain of two loads, not three. It holds no row
//    buffers, so it fits in 32 registers and 64 warps stay resident on
//    each SM: the latency is hidden across bags.
//  - Any other bags take the U = 8 instance: the group loads a batch of B
//    lookups (idx, w) at once, lookup j of the batch in lane j % G, slot
//    j / G, broadcasts them with __shfl_sync, and issues U row loads
//    before the first add, so a long bag costs one row latency per U
//    lookups, not one per lookup. Its row buffers cost registers (72 at
//    D = 64), which is why the gather does not run it: at 72 registers a
//    launch of 8,192 one-lookup bags needs two waves.
//  - Each lane writes its part of the output row once, with a streaming
//    store (st.global.cs): nothing in the kernel reads it again.
//
// Summation order. acc starts at -0.0f and every lookup adds
// __fmul_rn(w, x) with __fadd_rn, in lookup order: the product is rounded
// before the sum and nothing contracts to an FMA. Since -0.0f + y == y for
// every y, this is the TPU kernel's "the first lookup assigns, the later
// ones add" bit for bit, and one lookup of weight 1 copies its table row
// exactly. A bag with no lookups writes +0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int V>
struct Cols;

template <>
struct Cols<4> {
  using T = float4;
  static __device__ __forceinline__ T splat(float s) {
    return make_float4(s, s, s, s);
  }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    __stcs(reinterpret_cast<float4*>(p), v);
  }
  // acc + w * x, the product rounded first
  static __device__ __forceinline__ T add(T acc, float w, T x) {
    return make_float4(__fadd_rn(acc.x, __fmul_rn(w, x.x)),
                       __fadd_rn(acc.y, __fmul_rn(w, x.y)),
                       __fadd_rn(acc.z, __fmul_rn(w, x.z)),
                       __fadd_rn(acc.w, __fmul_rn(w, x.w)));
  }
};

template <>
struct Cols<1> {
  using T = float;
  static __device__ __forceinline__ T splat(float s) { return s; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, T v) { __stcs(p, v); }
  static __device__ __forceinline__ T add(T acc, float w, T x) {
    return __fadd_rn(acc, __fmul_rn(w, x));
  }
};

template <int G, int V, int U>
__global__ void __launch_bounds__(THREADS, U == 1 ? 2048 / THREADS : 1)
embedding_bag_kernel(const int* __restrict__ idx,
                     const float* __restrict__ w,
                     const int* __restrict__ offsets,
                     const float* __restrict__ table,
                     float* __restrict__ out,
                     int n_bags, int d, int n_slabs) {
  using C = Cols<V>;
  using T = typename C::T;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;               // lane within the bag's group
  const int group = blockIdx.x * (THREADS / G) + threadIdx.x / G;
  if (group >= n_bags * n_slabs) return;  // the whole group
  const int bag = group / n_slabs;
  const int col = (group % n_slabs * G + sub) * V;
  const bool active = col < d;            // lanes past D only relay

  if constexpr (U == 1) {                 // lookup b is bag b's only one
    if (active) {
      const int i = __ldg(idx + bag);
      const float we = __ldg(w + bag);
      C::store(out + (size_t)bag * d + col,
               C::add(C::splat(-0.0f), we,
                      C::load(table + (size_t)i * d + col)));
    }
  } else {
    const int begin = __ldg(offsets + bag);
    const int end = __ldg(offsets + bag + 1);
    T acc = C::splat(-0.0f);
    constexpr int B = G < 16 ? 16 : G;    // lookups per batch
    constexpr int P = B / G;              // of them loaded by each lane
    const unsigned mask =
        G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane - sub);
    for (int e0 = begin; e0 < end; e0 += B) {
      const int n = min(B, end - e0);     // the same in the whole group
      int ib[P];
      float wb[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int e = e0 + p * G + sub;
        ib[p] = e < end ? __ldg(idx + e) : 0;
        wb[p] = e < end ? __ldg(w + e) : 0.f;
      }
#pragma unroll
      for (int k0 = 0; k0 < B; k0 += U) {
        if (k0 >= n) break;
        float wk[U];
        T xk[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int j = k0 + k;           // static: slot j / G, lane j % G
          wk[k] = 0.f;
          xk[k] = C::splat(0.f);
          if (j < n) {
            const int ik = __shfl_sync(mask, ib[j / G], j % G, G);
            wk[k] = __shfl_sync(mask, wb[j / G], j % G, G);
            if (active) xk[k] = C::load(table + (size_t)ik * d + col);
          }
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
          if (k0 + k < n) acc = C::add(acc, wk[k], xk[k]);
        }
      }
    }
    if (active) {
      C::store(out + (size_t)bag * d + col,
               end > begin ? acc : C::splat(0.f));
    }
  }
}

struct Args {
  const int* idx;
  const float* w;
  const int* offsets;
  const float* table;
  float* out;
  int n_bags, d;
  cudaStream_t stream;
};

template <int G, int V, int U>
void launch(const Args& a, int n_slabs) {
  const long long groups = (long long)a.n_bags * n_slabs;
  const int grid = (int)((groups + THREADS / G - 1) / (THREADS / G));
  embedding_bag_kernel<G, V, U><<<grid, THREADS, 0, a.stream>>>(
      a.idx, a.w, a.offsets, a.table, a.out, a.n_bags, a.d, n_slabs);
}

int group_width(int d, int v) {
  const int lanes = (d + v - 1) / v;
  int g = 1;
  while (g < lanes && g < 32) g <<= 1;
  return g;
}

template <int V, int U>
void launch_cols(const Args& a) {
  const int g = group_width(a.d, V);
  const int n_slabs = (a.d + g * V - 1) / (g * V);
  switch (g) {
    case 1: launch<1, V, U>(a, n_slabs); break;
    case 2: launch<2, V, U>(a, n_slabs); break;
    case 4: launch<4, V, U>(a, n_slabs); break;
    case 8: launch<8, V, U>(a, n_slabs); break;
    case 16: launch<16, V, U>(a, n_slabs); break;
    default: launch<32, V, U>(a, n_slabs);
  }
}

}  // namespace

// idx, w: (L,) int32 / f32, sorted by bag; offsets: (n_bags + 1,) int32
// (offsets[0] = 0, non-decreasing, offsets[n_bags] = L); table: (R, d) f32
// with every idx < R; out: (n_bags, d) f32; n_lookups: L; max_len: the
// longest bag's lookup count. The float4 instance runs when d % 4 == 0 and
// table and out are 16-byte aligned, the scalar one otherwise; the U = 1
// instance when every bag has exactly one lookup (max_len == 1 and
// L == n_bags), U = 8 otherwise (both give the same bits). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// negative size, or more than 2^31 - 1 lane groups).
extern "C" int embedding_bag_f32(const void* idx, const void* w,
                                 const void* offsets, const void* table,
                                 void* out, int n_bags, int d, int n_lookups,
                                 int max_len, void* stream) {
  if (n_bags < 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_bags > 0 && d > 0) {
    const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0
                     && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int v = vec ? 4 : 1;
    const int g = group_width(d, v);
    // the kernel indexes lane groups (and their blocks' first) in int
    if ((long long)n_bags * ((d + g * v - 1) / (g * v))
        > 0x7fffffffLL - THREADS) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const Args a{static_cast<const int*>(idx), static_cast<const float*>(w),
                 static_cast<const int*>(offsets),
                 static_cast<const float*>(table), static_cast<float*>(out),
                 n_bags, d, static_cast<cudaStream_t>(stream)};
    const bool one_each = max_len == 1 && n_lookups == n_bags;
    if (vec) {
      one_each ? launch_cols<4, 1>(a) : launch_cols<4, 8>(a);
    } else {
      one_each ? launch_cols<1, 1>(a) : launch_cols<1, 8>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
