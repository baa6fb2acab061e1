// FlashAttention-2 backward for Hopper (sm_90a): the exact gradient of the
// forward in flash_attention.cu, in three SIMT kernels behind one C entry.
//
// The reference has no Pallas backward: it trains through its XLA
// blockwise_attention (src/repro/models/lm/attention.py:40-84), and XLA's
// autodiff of that lax.scan is what this replaces. It differentiates the
// forward as the port defines it:
//
//     S  = (Q . K^T) * scale            float32, scale = 1/sqrt(D)
//     S  = NEG_INF where key j > query i  (causal, positions from 0)
//     P  = softmax(S) = exp(S - L),     L = the row's log-sum-exp
//     O  = P . V
//
// with the forward's bf16 rounding of P before P . V taken as the identity,
// as autodiff of astype takes it. Given dO:
//
//     delta_i = rowsum(dO_i * O_i)      (O as the forward returned it)
//     dV = P^T . dO
//     dP = dO . V^T
//     dS = P * (dP - delta)
//     dQ = scale * dS . K
//     dK = scale * dS^T . Q
//
// Three kernels, one after another on the caller's stream:
//   1. bwd_prep_kernel, one CTA per (batch * q head, q tile): recomputes
//      each row's L with an online max and sum over the KV tiles (as the
//      forward, without P . V) and delta_i, both float32, into scratch the
//      wrapper allocates.
//   2. bwd_dkdv_kernel, one CTA per (batch * KV head, key tile): holds its
//      K and V tile, loops over the g = Hq / Hkv query heads that read this
//      KV head and over the q tiles at or below the diagonal, and sums dK
//      and dV in registers. The GQA sum stays in one CTA: no atomics.
//   3. bwd_dq_kernel, one CTA per (batch * q head, q tile): loops over the
//      KV tiles at or below the diagonal and sums dQ in registers.
// Every sum runs in a fixed order, so two launches on the same inputs give
// the same bits.
//
// Tiles are 64 q rows by 64 keys; 256 threads as 16 row groups x 16 column
// groups, each thread owning a 4 x 4 block of the score tile (rows rg + 16 i,
// columns cg + 16 j) and, for the sums, 4 rows x D/16 columns of its
// accumulator. Operands are staged in shared memory as float32 (bf16
// inputs are widened on load), rows padded to D + 1 so that the column
// reads are free of bank conflicts; every product is FMA on the CUDA cores
// with float32 accumulation. Outputs are written in the input dtype.
//
// Layout: q, o, dO, dq are (B, Sq, Hq, D); k, v, dk, dv (B, Sk, Hkv, D);
// each with unit stride along D and any (b, s, h) strides. Rows past Sq
// and keys past Sk (a ragged tail) are masked.
//
// Bound: operations. At the training shape (B=1, S=4096, Hq=32, Hkv=4,
// D=64, bf16, causal) the five products of the gradient (Q.K^T recomputed,
// dV, dP, dQ, dK) over the causal half are 1.7e11 operations: 0.17 ms at
// the bf16 tensor-core peak. This design recomputes Q.K^T three times and
// dP twice (8 products) on the CUDA cores; a tensor-core (wgmma) design
// with L written by the forward is a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int RPT = BQ / 16;  // score rows per thread
constexpr int CPT = BK / 16;  // score columns per thread
constexpr int PP = BK + 1;    // padded row of P and dS

struct Strides {  // element strides of a (B, S, H, D) tensor, D contiguous
  long long b, s, h;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// rows [row0, row0 + ROWS) of one head's (S, D) view, zero at and past
// `lim`, into shared memory rows of D + 1 floats
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int row0,
                                          int lim) {
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        row0 + r < lim ? ld(src + (long long)(row0 + r) * stride + c) : 0.f;
  }
}

// acc[i][j] = sum_d a[rg + 16 i][d] * b[cg + 16 j][d] over tiles of rows
// D + 1 floats apart: the thread's 4 x 4 block of A . B^T
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc)[RPT][CPT],
                                         const float* a, const float* b,
                                         int rg, int cg) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[RPT], y[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) x[i] = a[(rg + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < CPT; ++j) y[j] = b[(cg + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk,
                                        int causal) {
  return qpos < sq && kpos < sk && !(causal && kpos > qpos);
}

// the number of KV tiles a q tile starting at q0 meets
__device__ __forceinline__ int kv_tiles(int q0, int sq, int sk, int causal) {
  int n = (sk + BK - 1) / BK;
  if (causal) n = min(n, (min(q0 + BQ, sq) - 1) / BK + 1);
  return n;
}

// ------------------------------------------------------------ 1. L, delta
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ lse, float* __restrict__ delta,
                int sq, int sk, int hq, int group, Strides qs, Strides ks,
                Strides os, Strides dos, float scale, int causal) {
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;          // BQ x DP
  float* sK = sQ + BQ * DP;  // BK x DP

  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const T* kb = k + b * ks.b + hk * ks.h;
  load_rows<T, D, BQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq);

  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  const int n_tiles = kv_tiles(q0, sq, sk, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of sK are done
    load_rows<T, D, BK>(sK, kb, ks.s, k0, sk);
    __syncthreads();
    float s[RPT][CPT];
    tile_abt<D>(s, sQ, sK, rg, cg);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + rg + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const bool vis = visible(qpos, k0 + cg + 16 * j, sq, sk, causal);
        s[i][j] = vis ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
      if (m_new > NEG_INF / 2) {
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          sum += s[i][j] > NEG_INF / 2 ? expf(s[i][j] - m_new) : 0.f;
      }
      const float alpha = m[i] > NEG_INF / 2 ? expf(m[i] - m_new) : 0.f;
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
    }
  }

  const T* ob = o + b * os.b + h * os.h;
  const T* dob = dout + b * dos.b + h * dos.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + 16 * i;
    float part = 0.f;
    if (row < sq) {
      for (int c = cg; c < D; c += 16)
        part = fmaf(ld(dob + (long long)row * dos.s + c),
                    ld(ob + (long long)row * os.s + c), part);
    }
    part = half_warp_sum(part);
    if (cg == 0 && row < sq) {
      const long long at = ((long long)b * hq + h) * sq + row;
      lse[at] = l[i] > 0.f ? m[i] + logf(l[i]) : NEG_INF;
      delta[at] = part;
    }
  }
}

// P and dS of the thread's 4 x 4 block of one (q tile, key tile) pair from
// the staged Q, dO, K, V, L and delta
template <int D>
__device__ __forceinline__ void p_and_ds(float (&p)[RPT][CPT],
                                         float (&ds)[RPT][CPT],
                                         const float* sQ, const float* sdO,
                                         const float* sK, const float* sV,
                                         const float* sL, const float* sD,
                                         int q0, int k0, int sq, int sk,
                                         float scale, int causal, int rg,
                                         int cg) {
  tile_abt<D>(p, sQ, sK, rg, cg);    // S / scale
  tile_abt<D>(ds, sdO, sV, rg, cg);  // dP
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = rg + 16 * i;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const bool vis = visible(q0 + row, k0 + cg + 16 * j, sq, sk, causal);
      p[i][j] = vis ? expf(p[i][j] * scale - sL[row]) : 0.f;
      ds[i][j] = p[i][j] * (ds[i][j] - sD[row]);
    }
  }
}

// L and delta of rows [q0, q0 + BQ) of head (b, h) into shared memory
__device__ __forceinline__ void load_stats(float* sL, float* sD,
                                           const float* lse,
                                           const float* delta, int b, int h,
                                           int hq, int q0, int sq) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const long long at = ((long long)b * hq + h) * sq + q0 + r;
    const bool in = q0 + r < sq;
    sL[r] = in ? lse[at] : 0.f;
    sD[r] = in ? delta[at] : 0.f;
  }
}

// --------------------------------------------------------------- 2. dK, dV
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int sq, int sk, int hq, int hkv,
                Strides qs, Strides ks, Strides vs, Strides dos,
                Strides dks, Strides dvs, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int CO = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sK = smem;            // BK x DP
  float* sV = sK + BK * DP;    // BK x DP
  float* sQ = sV + BK * DP;    // BQ x DP
  float* sdO = sQ + BQ * DP;   // BQ x DP
  float* sP = sdO + BQ * DP;   // BQ x PP
  float* sdS = sP + BQ * PP;   // BQ x PP
  float* sL = sdS + BQ * PP;   // BQ
  float* sD = sL + BQ;         // BQ

  const int group = hq / hkv;
  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int k0 = blockIdx.y * BK;  // key tile 0 meets the most q tiles
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  load_rows<T, D, BK>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, sk);
  load_rows<T, D, BK>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, sk);

  float acc_k[RPT][CO], acc_v[RPT][CO];  // keys rg + 16 i, cols cg + 16 e
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < CO; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  // the first q tile that reaches key k0 under the causal mask
  const int q_first = causal ? (k0 / BQ) * BQ : 0;
  for (int r = 0; r < group; ++r) {
    const int h = hk * group + r;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    for (int q0 = q_first; q0 < sq; q0 += BQ) {
      __syncthreads();  // the previous q tile's reads are done
      load_rows<T, D, BQ>(sQ, qb, qs.s, q0, sq);
      load_rows<T, D, BQ>(sdO, dob, dos.s, q0, sq);
      load_stats(sL, sD, lse, delta, b, h, hq, q0, sq);
      __syncthreads();
      float p[RPT][CPT], ds[RPT][CPT];
      p_and_ds<D>(p, ds, sQ, sdO, sK, sV, sL, sD, q0, k0, sq, sk, scale,
                  causal, rg, cg);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          sP[(rg + 16 * i) * PP + cg + 16 * j] = p[i][j];
          sdS[(rg + 16 * i) * PP + cg + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV += P^T . dO and dK += dS^T . Q over the tile's q rows
#pragma unroll 4
      for (int row = 0; row < BQ; ++row) {
        float pv[RPT], sv[RPT], ov[CO], qv[CO];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = sP[row * PP + rg + 16 * i];
          sv[i] = sdS[row * PP + rg + 16 * i];
        }
#pragma unroll
        for (int e = 0; e < CO; ++e) {
          ov[e] = sdO[row * DP + cg + 16 * e];
          qv[e] = sQ[row * DP + cg + 16 * e];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < CO; ++e) {
            acc_v[i][e] = fmaf(pv[i], ov[e], acc_v[i][e]);
            acc_k[i][e] = fmaf(sv[i], qv[e], acc_k[i][e]);
          }
      }
    }
  }

  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + rg + 16 * i;
    if (key >= sk) continue;
#pragma unroll
    for (int e = 0; e < CO; ++e) {
      st(dkb + (long long)key * dks.s + cg + 16 * e, acc_k[i][e] * scale);
      st(dvb + (long long)key * dvs.s + cg + 16 * e, acc_v[i][e]);
    }
  }
}

// ------------------------------------------------------------------ 3. dQ
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int sq, int sk, int hq, int group,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
              float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int CO = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x DP
  float* sdO = sQ + BQ * DP;   // BQ x DP
  float* sK = sdO + BQ * DP;   // BK x DP
  float* sV = sK + BK * DP;    // BK x DP
  float* sdS = sV + BK * DP;   // BQ x PP
  float* sL = sdS + BQ * PP;   // BQ
  float* sD = sL + BQ;         // BQ

  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  load_rows<T, D, BQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  load_rows<T, D, BQ>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, sq);
  load_stats(sL, sD, lse, delta, b, h, hq, q0, sq);

  float acc[RPT][CO];  // rows rg + 16 i, cols cg + 16 e
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < CO; ++e) acc[i][e] = 0.f;

  const int n_tiles = kv_tiles(q0, sq, sk, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of sK, sV, sdS are done
    load_rows<T, D, BK>(sK, kb, ks.s, k0, sk);
    load_rows<T, D, BK>(sV, vb, vs.s, k0, sk);
    __syncthreads();
    float p[RPT][CPT], ds[RPT][CPT];
    p_and_ds<D>(p, ds, sQ, sdO, sK, sV, sL, sD, q0, k0, sq, sk, scale,
                causal, rg, cg);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        sdS[(rg + 16 * i) * PP + cg + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ += dS . K over the tile's keys
#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      float sv[RPT], kv[CO];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = sdS[(rg + 16 * i) * PP + key];
#pragma unroll
      for (int e = 0; e < CO; ++e) kv[e] = sK[key * DP + cg + 16 * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < CO; ++e)
          acc[i][e] = fmaf(sv[i], kv[e], acc[i][e]);
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int e = 0; e < CO; ++e)
      st(dqb + (long long)row * dqs.s + cg + 16 * e, acc[i][e] * scale);
  }
}

template <int D>
constexpr size_t prep_smem() {
  return sizeof(float) * (BQ + BK) * (D + 1);
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * (BK + BQ) * (D + 1) + 2 * BQ * PP + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (BK + BQ) * (D + 1) + BQ * PP + 2 * BQ);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;
  int batch, sq, sk, hq, hkv, causal;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const int group = a.hq / a.hkv;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err = allow_smem(bwd_prep_kernel<T, D>, prep_smem<D>());
  if (err == cudaSuccess)
    err = allow_smem(bwd_dkdv_kernel<T, D>, dkdv_smem<D>());
  if (err == cudaSuccess) err = allow_smem(bwd_dq_kernel<T, D>, dq_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 q_grid(a.batch * a.hq, (a.sq + BQ - 1) / BQ);
  bwd_prep_kernel<T, D><<<q_grid, THREADS, prep_smem<D>(), stream>>>(
      q, k, o, dout, a.lse, a.delta, a.sq, a.sk, a.hq, group, a.qs, a.ks,
      a.os, a.dos, scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(a.batch * a.hkv, (a.sk + BK - 1) / BK);
  bwd_dkdv_kernel<T, D><<<kv_grid, THREADS, dkdv_smem<D>(), stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.sq, a.sk, a.hq, a.hkv, a.qs, a.ks, a.vs,
      a.dos, a.dks, a.dvs, scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<T, D><<<q_grid, THREADS, dq_smem<D>(), stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.sq, a.sk,
      a.hq, group, a.qs, a.ks, a.vs, a.dos, a.dqs, scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o, dout, dq: (batch, sq, hq, d); k, v, dk, dv: (batch, sk, hkv, d).
// Strides in elements, (batch, seq, head) for each tensor; d has unit
// stride. lse, delta: float32 scratch of batch * hq * sq each.
// dtype: 0 = float32, 1 = bfloat16 (inputs and outputs); d in {32, 64,
// 128}. Returns cudaGetLastError() after the launches (or the attribute's
// error).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse,
    float* delta, int dtype, int d, int batch, int sq, int sk, int hq,
    int hkv, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    int causal, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, delta,
               batch, sq, sk, hq, hkv, causal,
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {o_sb, o_ss, o_sh}, {do_sb, do_ss, do_sh},
               {dq_sb, dq_ss, dq_sh}, {dk_sb, dk_ss, dk_sh},
               {dv_sb, dv_ss, dv_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(d, a, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(d, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
