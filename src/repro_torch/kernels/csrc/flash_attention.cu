// FlashAttention-2 forward for Hopper (sm_90a), float32 and bf16 inputs.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (body _flash_kernel) and its GQA wrapper ops.py::flash_attention:
//
//     s     = (q . k) * scale                 float32, scale = 1/sqrt(D)
//     s     = NEG_INF where key j > query i   (causal)
//     m'    = max(m, rowmax(s))
//     p     = exp(s - m'), 0 where m' is still NEG_INF
//     alpha = exp(m - m'),  0 where m  is still NEG_INF
//     l     = l * alpha + rowsum(p)
//     acc   = acc * alpha + round_to_input_dtype(p) . v
//     out   = acc / max(l, 1e-30), cast once to the input dtype
//
// The TPU kernel walks the KV tiles along a sequential grid axis and keeps
// (m, l, acc) in VMEM scratch between grid steps. CUDA blocks run in no
// order, so here one CTA owns one (batch * head, 64-row q tile) and loops
// over the KV tiles itself, keeping m, l and acc in registers. The q tile
// stays in shared memory; each KV tile is staged there as float32, and so
// is p for the second product.
//
// Layout: q, k, v, o are (B, S, H, D) with unit stride along D and any
// other strides, so the model's tensors need no transpose. GQA: q head h
// reads KV head h / (Hq / Hkv), in-kernel, with no repeated copies.
// Causal CTAs stop at the last KV tile that meets the diagonal; the skipped
// tiles would add exactly zero, since every row sees key 0 in the first
// tile and so has a finite running max. Keys past Sk and rows past Sq (a
// ragged tail) are masked. The q tiles are dispatched longest first.
//
// Threads: 256 per CTA as 16 row groups x 16 column groups. Thread (rg, cg)
// holds scores for rows rg + 16 i (i < 4) and keys cg + 16 j (j < 4), and
// output columns cg + 16 e (e < D / 16) of the same rows; the 16 threads of
// a row group are one half-warp, so row max and row sum are shuffles.
// Shared rows of q and k are padded to D + 1 and of p to 65, so the column
// reads of both products are free of bank conflicts.
//
// Bound: operations. At TinyLlama's prefill shape the two products are
// 1.37e11 operations for the causal half against 75 MB of q, k, v and o;
// the tensor-core bound is 0.139 ms. Both products here run as float32 FMA
// on the CUDA cores (67 TFLOP/s at best) with two shared-memory loads per
// two FMAs, so this kernel is far from that bound; wgmma with TMA-fed
// tiles is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int RPT = BQ / 16;  // rows per thread
constexpr int CPT = BK / 16;  // score columns per thread
constexpr int PP = BK + 1;    // padded row of p
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

struct Strides {  // element strides of a (B, S, H, D) tensor, D contiguous
  long long b, s, h;
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PP);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int sq, int sk, int hq, int group,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal) {
  constexpr int DP = D + 1;   // padded row of q and k
  constexpr int CO = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x DP
  float* sK = sQ + BQ * DP;    // BK x DP
  float* sV = sK + BK * DP;    // BK x D
  float* sP = sV + BK * D;     // BQ x PP

  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    sQ[r * DP + c] =
        q0 + r < sq ? to_f32(qb[(long long)(q0 + r) * qs.s + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][CO];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CO; ++e) acc[i][e] = 0.f;
  }

  int n_tiles = (sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, sq) - 1) / BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < sk;
      sK[r * DP + c] = in ? to_f32(kb[(long long)(k0 + r) * ks.s + c]) : 0.f;
      sV[e] = in ? to_f32(vb[(long long)(k0 + r) * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RPT], kk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = sQ[(rg + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kk[j] = sK[(cg + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rg + 16 * i, qpos = q0 + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + cg + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= sk || (causal && kpos > qpos)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const bool live = m_new > NEG_INF / 2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = live ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        sP[row * PP + cg + 16 * j] = to_f32(from_f32<T>(p));
      }
      const float alpha = m[i] > NEG_INF / 2 ? expf(m[i] - m_new) : 0.f;
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < CO; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[CO];
#pragma unroll
      for (int e = 0; e < CO; ++e) vv[e] = sV[c * D + cg + 16 * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = sP[(rg + 16 * i) * PP + c];
#pragma unroll
        for (int e = 0; e < CO; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = ob + (long long)row * os.s;
#pragma unroll
    for (int e = 0; e < CO; ++e)
      dst[cg + 16 * e] = from_f32<T>(acc[i][e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int sq, int sk, int hq, int hkv, Strides qs, Strides ks,
           Strides vs, Strides os, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * hq, (sq + BQ - 1) / BQ);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, hq, hq / hkv,
      qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int batch, int sq, int sk, int hq, int hkv, Strides qs,
             Strides ks, Strides vs, Strides os, int causal,
             cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, sq, sk, hq, hkv, qs, ks, vs,
                           os, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, sq, sk, hq, hkv, qs, ks, vs,
                           os, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, sq, sk, hq, hkv, qs, ks, vs,
                            os, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (batch, sq, hq, d); k, v: (batch, sk, hkv, d); o: like q. Strides are
// in elements, (batch, seq, head) for each tensor; d has unit stride.
// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}.
// Returns cudaGetLastError() after the launch (or the attribute's error).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int d,
    int batch, int sq, int sk, int hq, int hkv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, void* stream) {
  if (batch <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, batch, sq, sk, hq, hkv, qs, ks, vs,
                           os, causal, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, batch, sq, sk, hq, hkv, qs,
                                   ks, vs, os, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
