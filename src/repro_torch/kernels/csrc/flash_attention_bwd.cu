// FlashAttention-2 backward for Hopper (sm_90a): the gradient of the
// forward in flash_attention.cu, bf16 on the tensor cores (wgmma) and
// float32 on the CUDA cores, behind one C entry.
//
// The reference has no Pallas backward: it trains through its XLA
// blockwise_attention (src/repro/models/lm/attention.py:40-84), and XLA's
// autodiff of that lax.scan is what this replaces. It differentiates the
// forward as the port defines it:
//
//     S  = (Q . K^T) * scale            float32, scale = 1/sqrt(D), D
//                                       the q and k head dim
//     S  = NEG_INF where key j > query i  (causal, positions from 0)
//     P  = softmax(S) = exp(S - L),     L = the row's log-sum-exp
//     O  = P . V
//
// Given dO, O and L (both as the forward returned them; the forward
// writes L when asked, so no pass here recomputes it):
//
//     delta_i = rowsum(dO_i * O_i)
//     dV = round(P)^T . dO
//     dP = dO . V^T
//     dS = P * (dP - delta)
//     dQ = scale * round(dS) . K
//     dK = scale * round(dS)^T . Q
//
// round() is the inputs' dtype: bf16 P and dS are the A operands of the
// tensor-core products, as the forward rounds p before p . V (and as
// XLA's autodiff of the reference takes dV from bf16 p); at float32 it is
// the identity. Every sum has float32 accumulators.
//
// The kernels, one after another on the caller's stream:
//   1. bwd_prep_kernel: delta, one thread a (b, s, h) row, a bandwidth
//      pass over dO and O (D_v columns).
//   2. dK/dV, one CTA per (batch * KV head, key tile, part): holds its K
//      and V tile, loops over its part of the g = Hq / Hkv query heads
//      that read this KV head and over the q tiles at or below the
//      diagonal, and sums dK and dV in registers. With one part (split =
//      1) it stores them; with more, each part stores its float32 sums
//      (its dK rows, then its dV rows) and bwd_reduce_kernel adds the
//      parts in part order, one thread an 8-column chunk. So the GQA sum
//      needs no atomics. The parts exist for the causal load: key tile 0
//      meets every q tile of all g heads, and with one CTA a key tile it
//      is the launch's critical path (chip_smoke.py times both).
//   3. dQ, one CTA per (batch * q head, q tile): loops over the KV tiles
//      at or below the diagonal and sums dQ in registers.
// Every sum runs in a fixed order, so two launches on the same inputs give
// the same bits. Key tile 0 and the last q tile meet the most tiles under
// the causal mask, so both grids dispatch the longest CTAs first.
//
// bf16 (bwd_dkdv_wgmma_kernel, bwd_dq_wgmma_kernel): one warpgroup of 128
// threads a CTA, 64-row tiles of q and of keys, built from the forward's
// blocks (flash_wgmma.cuh): bf16 tiles in the swizzled layout by 16-byte
// cp.async into a ring of two stages (tile t+1 loads while tile t
// computes), and the two wgmma forms.
//   dK/dV, for each (head, q tile):
//     S^T  = K . Q^T and dP^T = V . dO^T    wgmma_ss, M = 64 keys, N = 64
//                                           q rows, K = D and D_v
//     P^T  = exp(scale S^T - L), dS^T = P^T * (dP^T - delta), on the
//            accumulator fragments; L and delta are indexed by column (the
//            q row) and ride in the ring with their Q and dO tiles
//     dV  += P^T . dO and dK += dS^T . Q    wgmma_rs_tb: P^T and dS^T
//            rounded to bf16 as A fragments straight from registers, dO
//            and Q read through the transpose bit (as the forward reads V)
//   dQ, for each KV tile:
//     S = Q . K^T and dP = dO . V^T         wgmma_ss
//     dS on the fragments, L and delta by row
//     dQ  += dS . K                         wgmma_rs_tb, K transposed
// Only the tiles that meet the diagonal, the ragged q tail or the ragged
// key tail are masked. Operands must be 16-byte aligned with (b, s, h)
// strides in multiples of 8 elements (checked by the wrapper and here).
//
// float32 (bwd_dkdv_kernel, bwd_dq_kernel): the same two loops on the CUDA
// cores, chosen by dtype and not as a fallback (the tensor cores take
// float32 only as TF32, which cannot meet the float32 tolerance): 256
// threads as 16 row groups x 16 column groups, each thread owning a 4 x 4
// block of the score tile; operands staged in shared memory as float32
// rows padded to D + 1; every product FMA.
//
// Layout: q, dq are (B, Sq, Hq, D); o, dO (B, Sq, Hq, D_v); k, dk (B, Sk,
// Hkv, D); v, dv (B, Sk, Hkv, D_v); each with unit stride along its head
// dim and any (b, s, h) strides; lse and delta (B, Hq, Sq) float32. Rows
// past Sq and keys past Sk are masked; keys that no query sees get dK =
// dV = 0. Every kernel is templated on the pair (D, D_v): (32, 32), (64,
// 64), (128, 128) and MLA's (96, 64) and (192, 128) (minicpm3's and
// deepseek-v2's q/k and v head dims). Each tile keeps its own dim's layout
// (flash_wgmma.cuh: D = 96 is three 32-column atoms with 64-byte swizzle,
// D = 192 three 64-column atoms with 128-byte swizzle): dV's product runs
// over D_v columns, dK's and dQ's over D (an N = 96 product is three
// m64n32k16, N = 192 three m64n64k16). At (192, 128) one warpgroup cannot
// hold dK's and dV's sums beside S^T and dP^T, so the dK/dV kernel runs
// on two (bwd_dkdv_wgmma2_kernel: one holds dK, the other dV, P^T handed
// over through shared memory), and so does dQ (bwd_dq_wgmma2_kernel: one
// computes S, dP and dS, the other holds dQ; in one warpgroup it
// spilled).
//
// Bound: operations. At the training shape (B=1, S=4096, Hq=32, Hkv=4,
// D=64, bf16, causal) the gradient's five products (Q.K^T recomputed, dV,
// dP, dQ, dK) over the causal half are 1.7e11 operations: 0.1738 ms at
// the bf16 tensor-core peak (989 TFLOP/s). A (query, key) pair costs
// 2 (3 D + 2 D_v) operations: at minicpm3's (B=1, S=4096, H=40, D=96,
// D_v=64) 2.79e11, 0.282 ms; at qwen3's (Hq=16, Hkv=8, D=128) 1.74e11; at
// deepseek-v2's (B=1, H=128, D=192, D_v=128) 1.79e12, 1.81 ms. This
// design does seven: S and
// dP once in each of the two kernels, the price of keeping dQ free of
// atomics (a dQ summed across the dK/dV CTAs would need them, and their
// order changes from run to run), a floor of ~0.24 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

namespace {

using flash::bf16;
using flash::Strides;

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // keys per tile

// the number of KV tiles a q tile starting at q0 meets
__device__ __forceinline__ int kv_tiles(int q0, int sq, int sk, int causal) {
  int n = (sk + BK - 1) / BK;
  if (causal) n = min(n, (min(q0 + BQ, sq) - 1) / BK + 1);
  return n;
}

// the first q tile that reaches key k0 under the causal mask
__device__ __forceinline__ int first_q_tile(int k0, int causal) {
  return causal ? (k0 / BQ) * BQ : 0;
}

// ------------------------------------------------------------ 1. delta
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// delta over the DV columns of O and dO
template <typename T, int DV>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int sq, int hq, Strides os,
                Strides dos, long long n_rows) {
  const long long row = blockIdx.x * 256LL + threadIdx.x;  // (b, s, h)
  if (row >= n_rows) return;
  const int h = row % hq, s = (row / hq) % sq;
  const long long b = row / ((long long)hq * sq);
  const T* orow = o + b * os.b + s * os.s + h * os.h;
  const T* drow = dout + b * dos.b + s * dos.s + h * dos.h;
  float acc = 0.f;
  if constexpr (sizeof(T) == 2) {  // bf16: 16-byte loads (aligned)
#pragma unroll
    for (int c = 0; c < DV; c += 8)
      acc = dot8(*reinterpret_cast<const uint4*>(drow + c),
                 *reinterpret_cast<const uint4*>(orow + c), acc);
  } else {
#pragma unroll 8
    for (int c = 0; c < DV; ++c) acc = fmaf(drow[c], orow[c], acc);
  }
  delta[(b * hq + h) * sq + s] = acc;
}

// ---------------------------------------------------- float32: SIMT
namespace simt {

constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int RPT = BQ / 16;  // score rows per thread
constexpr int CPT = BK / 16;  // score columns per thread
constexpr int PP = BK + 1;    // padded row of P and dS

// rows [row0, row0 + ROWS) of one head's (S, D) view, zero at and past
// `lim`, into shared memory rows of D + 1 floats
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int lim) {
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        row0 + r < lim ? src[(long long)(row0 + r) * stride + c] : 0.f;
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

// P and dS of the thread's 4 x 4 block of one (q tile, key tile) pair from
// the staged Q, K (rows of DQK + 1), dO, V (rows of DV + 1), L and delta
template <int DQK, int DV>
__device__ __forceinline__ void p_and_ds(float (&p)[RPT][CPT],
                                         float (&ds)[RPT][CPT],
                                         const float* sQ, const float* sdO,
                                         const float* sK, const float* sV,
                                         const float* sL, const float* sD,
                                         int q0, int k0, int sq, int sk,
                                         float scale, int causal, int rg,
                                         int cg) {
  tile_abt<DQK>(p, sQ, sK, rg, cg);   // S / scale
  tile_abt<DV>(ds, sdO, sV, rg, cg);  // dP
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

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int sq, int sk, int hq, int hkv,
                Strides qs, Strides ks, Strides vs, Strides dos,
                Strides dks, Strides dvs, float scale, int causal) {
  constexpr int QP = DQK + 1, VP = DV + 1;    // padded rows
  constexpr int CK = DQK / 16, CV = DV / 16;  // accumulator columns
  extern __shared__ float smem[];
  float* sK = smem;            // BK x QP
  float* sV = sK + BK * QP;    // BK x VP
  float* sQ = sV + BK * VP;    // BQ x QP
  float* sdO = sQ + BQ * QP;   // BQ x VP
  float* sP = sdO + BQ * VP;   // BQ x PP
  float* sdS = sP + BQ * PP;   // BQ x PP
  float* sL = sdS + BQ * PP;   // BQ
  float* sD = sL + BQ;         // BQ

  const int group = hq / hkv;
  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int k0 = blockIdx.y * BK;  // key tile 0 meets the most q tiles
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  load_rows<DQK, BK>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, sk);
  load_rows<DV, BK>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, sk);

  // keys rg + 16 i, columns cg + 16 e
  float acc_k[RPT][CK], acc_v[RPT][CV];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int e = 0; e < CK; ++e) acc_k[i][e] = 0.f;
#pragma unroll
    for (int e = 0; e < CV; ++e) acc_v[i][e] = 0.f;
  }

  for (int r = 0; r < group; ++r) {
    const int h = hk * group + r;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dout + b * dos.b + h * dos.h;
    for (int q0 = first_q_tile(k0, causal); q0 < sq; q0 += BQ) {
      __syncthreads();  // the previous q tile's reads are done
      load_rows<DQK, BQ>(sQ, qb, qs.s, q0, sq);
      load_rows<DV, BQ>(sdO, dob, dos.s, q0, sq);
      load_stats(sL, sD, lse, delta, b, h, hq, q0, sq);
      __syncthreads();
      float p[RPT][CPT], ds[RPT][CPT];
      p_and_ds<DQK, DV>(p, ds, sQ, sdO, sK, sV, sL, sD, q0, k0, sq, sk,
                        scale, causal, rg, cg);
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
        float pv[RPT], sv[RPT], ov[CV], qv[CK];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = sP[row * PP + rg + 16 * i];
          sv[i] = sdS[row * PP + rg + 16 * i];
        }
#pragma unroll
        for (int e = 0; e < CV; ++e) ov[e] = sdO[row * VP + cg + 16 * e];
#pragma unroll
        for (int e = 0; e < CK; ++e) qv[e] = sQ[row * QP + cg + 16 * e];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
#pragma unroll
          for (int e = 0; e < CV; ++e)
            acc_v[i][e] = fmaf(pv[i], ov[e], acc_v[i][e]);
#pragma unroll
          for (int e = 0; e < CK; ++e)
            acc_k[i][e] = fmaf(sv[i], qv[e], acc_k[i][e]);
        }
      }
    }
  }

  float* dkb = dk + b * dks.b + hk * dks.h;
  float* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + rg + 16 * i;
    if (key >= sk) continue;
#pragma unroll
    for (int e = 0; e < CK; ++e)
      dkb[(long long)key * dks.s + cg + 16 * e] = acc_k[i][e] * scale;
#pragma unroll
    for (int e = 0; e < CV; ++e)
      dvb[(long long)key * dvs.s + cg + 16 * e] = acc_v[i][e];
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int sq, int sk, int hq, int group,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
              float scale, int causal) {
  constexpr int QP = DQK + 1, VP = DV + 1;
  constexpr int CO = DQK / 16;
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x QP
  float* sdO = sQ + BQ * QP;   // BQ x VP
  float* sK = sdO + BQ * VP;   // BK x QP
  float* sV = sK + BK * QP;    // BK x VP
  float* sdS = sV + BK * VP;   // BQ x PP
  float* sL = sdS + BQ * PP;   // BQ
  float* sD = sL + BQ;         // BQ

  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  load_rows<DQK, BQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  load_rows<DV, BQ>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, sq);
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
    load_rows<DQK, BK>(sK, kb, ks.s, k0, sk);
    load_rows<DV, BK>(sV, vb, vs.s, k0, sk);
    __syncthreads();
    float p[RPT][CPT], ds[RPT][CPT];
    p_and_ds<DQK, DV>(p, ds, sQ, sdO, sK, sV, sL, sD, q0, k0, sq, sk,
                      scale, causal, rg, cg);
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
      for (int e = 0; e < CO; ++e) kv[e] = sK[key * QP + cg + 16 * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < CO; ++e)
          acc[i][e] = fmaf(sv[i], kv[e], acc[i][e]);
    }
  }

  float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int e = 0; e < CO; ++e)
      dqb[(long long)row * dqs.s + cg + 16 * e] = acc[i][e] * scale;
  }
}

template <int DQK, int DV>
constexpr size_t dkdv_smem() {
  return sizeof(float) * ((BK + BQ) * (DQK + 1) + (BK + BQ) * (DV + 1)
                          + 2 * BQ * PP + 2 * BQ);
}

template <int DQK, int DV>
constexpr size_t dq_smem() {
  return sizeof(float) * ((BK + BQ) * (DQK + 1) + (BK + BQ) * (DV + 1)
                          + BQ * PP + 2 * BQ);
}

}  // namespace simt

// ------------------------------------------------- bf16: tensor cores
namespace tc {

using namespace flash;

constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;     // the ring of streamed tiles

// a 64-row tile of D columns: its bytes and its atoms' bytes
template <int D>
struct Tile : Swz<D> {
  static constexpr int ATOM = 64 * Swz<D>::ROWB;
  static constexpr int BYTES = 64 * D * 2;
  static_assert(BYTES % 1024 == 0, "every tile on the 1024-byte repeat");
};

// a 64 x D accumulator fragment, one array of AW / 2 floats a column atom
template <int D>
using Acc = float[Swz<D>::NA][Swz<D>::AW / 2];

template <int DQK, int DV>
struct Cfg {
  static constexpr int QK = Tile<DQK>::BYTES;  // a q or k tile
  static constexpr int VT = Tile<DV>::BYTES;   // a v or dO tile
  static constexpr int STATS = 2 * BQ * 4;     // L and delta of a q tile
  // dK/dV: K, V, STAGES x (Q, dO), STAGES x (L, delta); dQ: Q, dO,
  // STAGES x (K, V). + 1 KB to align the tiles to the swizzle repeat.
  static constexpr int DKDV_SMEM =
      1024 + QK + VT + STAGES * (QK + VT + STATS);
  static constexpr int DQ_SMEM = 1024 + QK + VT + STAGES * (QK + VT);
  // dK/dV on two warpgroups: + the P^T hand-off, 16 words a thread
  static constexpr int DKDV2_SMEM = DKDV_SMEM + 16 * THREADS * 4;
  static constexpr int DQ2_SMEM = DQ_SMEM + 16 * THREADS * 4;
  // the q/k head dim whose dK/dV and dQ take two warpgroups. At D <= 128
  // one is faster: there the two-warpgroup kernels gave the same
  // gradients bit for bit in 1.49x (64, 64) and 1.53x (128, 128) the
  // time on an H100 (scripts/bwd_two_wg.py)
  static constexpr bool TWO_WG = DQK > 128;
};

// acc (+)= A . B^T over D for two 64-row tiles read row-wise (K-major)
template <int D>
__device__ __forceinline__ void tile_ss(float (&acc)[32], uint32_t a,
                                        uint32_t b) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int at = kk / (T::AW / 16);                // column atom
    const uint32_t off = (kk % (T::AW / 16)) * 32;   // bytes into its rows
    wgmma_ss(acc,
             make_desc(a + at * T::ATOM + off, 16, T::GROUP, T::SWZ),
             make_desc(b + at * T::ATOM + off, 16, T::GROUP, T::SWZ),
             kk > 0);
  }
}

// acc[a] += A . B over the 64 rows of B (D columns), A from registers (a
// 64 x 64 probability-shaped fragment, 4 k-steps), B read column-wise
// through the transpose bit, one instruction per k-step and column atom
template <int D>
__device__ __forceinline__ void tile_rs(Acc<D>& acc,
                                        const uint32_t (&a)[4][4],
                                        uint32_t b) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int at = 0; at < T::NA; ++at)
      wgmma_rs_tb(acc[at], a[kk],
                  make_desc(b + at * T::ATOM + kk * 16 * T::ROWB, T::ATOM,
                            T::GROUP, T::SWZ));
}

template <int D>
__device__ __forceinline__ void fence_acc(Acc<D>& acc) {
#pragma unroll
  for (int at = 0; at < Swz<D>::NA; ++at) fence_regs(acc[at]);
}

template <int D>
__device__ __forceinline__ void zero_acc(Acc<D>& acc) {
#pragma unroll
  for (int at = 0; at < Swz<D>::NA; ++at)
#pragma unroll
    for (int i = 0; i < Swz<D>::AW / 2; ++i) acc[at][i] = 0.f;
}

__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// the fragment (rows r0 + 8 i, columns 8 n + c2 + j) of a 64 x D product
// scaled by `mul`, stored as pairs of T at rows row0 + r0 + 8 i < lim
template <int D, typename T>
__device__ __forceinline__ void store_acc(T* base, long long stride,
                                          int row0, int lim, int r0, int c2,
                                          const Acc<D>& acc, float mul) {
  using S = Swz<D>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= lim) continue;
    T* dst = base + (long long)row * stride;
#pragma unroll
    for (int at = 0; at < S::NA; ++at)
#pragma unroll
      for (int n = 0; n < S::AW / 8; ++n)
        put2(dst + at * S::AW + 8 * n + c2, acc[at][4 * n + 2 * i] * mul,
             acc[at][4 * n + 2 * i + 1] * mul);
  }
}

// P^T and dS^T of the pair (key tile k0, q tile q0), rounded to bf16 as
// the A fragments of 4 k-steps, from the S^T and dP^T fragments (rows:
// keys k0 + r0 (+ 8), columns: q rows 8 n + c2 (+ 1)) and the q tile's L
// and delta in shared memory, indexed by column. Only a tile that meets
// the diagonal, the ragged q tail or the ragged key tail is masked.
__device__ __forceinline__ void pds_t_fragments(
    uint32_t (&pa)[4][4], uint32_t (&dsa)[4][4], const float (&s)[32],
    const float (&dp)[32], const float* sL, const float* sD, int k0, int q0,
    int sq, int sk, int causal, int r0, int c2, float scale_log2) {
  const bool edge = k0 + BK > sk || q0 + BQ > sq
                    || (causal && q0 < k0 + BK - 1);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 lc = *reinterpret_cast<const float2*>(sL + 8 * n + c2);
    const float2 dc = *reinterpret_cast<const float2*>(sD + 8 * n + c2);
    const float lb[2] = {lc.x * LOG2E, lc.y * LOG2E};
    const float dl[2] = {dc.x, dc.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p2[2], d2[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p = ex2(fmaf(s[4 * n + 2 * i + j], scale_log2, -lb[j]));
        if (edge) {
          const int key = k0 + r0 + 8 * i, qp = q0 + 8 * n + c2 + j;
          if (key >= sk || qp >= sq || (causal && key > qp)) p = 0.f;
        }
        p2[j] = p;
        d2[j] = p * (dp[4 * n + 2 * i + j] - dl[j]);
      }
      pa[n / 2][2 * (n % 2) + i] = pack_bf16(p2[0], p2[1]);
      dsa[n / 2][2 * (n % 2) + i] = pack_bf16(d2[0], d2[1]);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, DV <= 64 ? 2 : 1)
bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ part,
                      int split, int sq, int sk, int hq, int hkv, Strides qs,
                      Strides ks, Strides vs, Strides dos, Strides dks,
                      Strides dvs, float scale, int causal) {
  using C = Cfg<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + C::QK;
  const uint32_t sQ0 = sV + C::VT;  // stage st: Q, then dO
  const uint32_t sSt0 = sQ0 + STAGES * (C::QK + C::VT);  // stage: L, delta
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (sSt0 - raw));

  const int group = hq / hkv, heads = group / split;
  const int bh = blockIdx.x / split, pi = blockIdx.x % split;
  const int b = bh / hkv, hk = bh % hkv;
  const int h0 = hk * group + pi * heads;  // this part's first q head
  const int k0 = blockIdx.y * BK;  // key tile 0 meets the most q tiles
  const int t = threadIdx.x;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;  // keys k0 + r0 (+ 8)
  const int c2 = 2 * (t % 4);                   // q rows 8 n + c2 (+ 1)
  const int q_first = first_q_tile(k0, causal);
  const int n_q = q_first < sq ? (sq - q_first + BQ - 1) / BQ : 0;
  const int n_it = heads * n_q;  // (head, q tile) pairs, head-major

  // stage it % 2 <- the Q and dO tiles, L and delta of pair it
  auto load_pair = [&](int it) {
    const int h = h0 + it / n_q, q0 = q_first + (it % n_q) * BQ;
    const uint32_t st = sQ0 + (it % STAGES) * (C::QK + C::VT);
    load_tile<DQK, BQ, THREADS>(st, q + b * qs.b + h * qs.h, qs.s, q0, sq,
                                Tile<DQK>::ATOM);
    load_tile<DV, BQ, THREADS>(st + C::QK, dout + b * dos.b + h * dos.h,
                               dos.s, q0, sq, Tile<DV>::ATOM);
    const int r = t % BQ;  // threads 0-63 copy L, 64-127 delta
    const float* src = (t < BQ ? lse : delta) + ((long long)b * hq + h) * sq;
    const bool in = q0 + r < sq;
    cp_async4(sSt0 + (it % STAGES) * C::STATS + t * 4,
              in ? src + q0 + r : src, in);
  };

  if (n_it > 0) {
    load_tile<DQK, BK, THREADS>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, sk,
                                Tile<DQK>::ATOM);
    load_tile<DV, BK, THREADS>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, sk,
                               Tile<DV>::ATOM);
    load_pair(0);
  }
  cp_async_commit();

  Acc<DQK> acc_k;  // rows: keys r0 + 8 i
  Acc<DV> acc_v;
  zero_acc<DQK>(acc_k);
  zero_acc<DV>(acc_v);
  const float scale_log2 = scale * LOG2E;
  float s[32], dp[32];  // the scores' and dP's fragments, overwritten by
#pragma unroll          // each tile's first product (scale_d = 0)
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();  // this thread's copies of pair it
    fence_proxy_async();
    __syncthreads();      // everyone's copies landed; pair it-1 is consumed
    if (it + 1 < n_it) {  // the next pair loads while this one computes
      load_pair(it + 1);
      cp_async_commit();
    }
    const int q0 = q_first + (it % n_q) * BQ;
    const uint32_t sQ = sQ0 + (it % STAGES) * (C::QK + C::VT);
    const uint32_t sdO = sQ + C::QK;
    const float* sL = stats + (it % STAGES) * 2 * BQ;
    const float* sD = sL + BQ;

    // S^T = K . Q^T and dP^T = V . dO^T: rows are keys, columns q rows
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    tile_ss<DQK>(s, sK, sQ);
    tile_ss<DV>(dp, sV, sdO);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T on the fragments, L and delta by column
    uint32_t pa[4][4], dsa[4][4];  // as the A fragments of 4 k-steps
    pds_t_fragments(pa, dsa, s, dp, sL, sD, k0, q0, sq, sk, causal, r0, c2,
                    scale_log2);

    // dV += P^T . dO and dK += dS^T . Q over the tile's q rows
    fence_acc<DV>(acc_v);
    fence_acc<DQK>(acc_k);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
    tile_rs<DV>(acc_v, pa, sdO);
    tile_rs<DQK>(acc_k, dsa, sQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pa);  // the fragments stay live until the products end
    fence_regs(dsa);
    fence_acc<DV>(acc_v);
    fence_acc<DQK>(acc_k);
  }
  cp_async_wait_all();

  if (split == 1) {
    store_acc<DQK>(dk + b * dks.b + hk * dks.h, dks.s, k0, sk, r0, c2, acc_k,
                   scale);
    store_acc<DV>(dv + b * dvs.b + hk * dvs.h, dvs.s, k0, sk, r0, c2, acc_v,
                  1.f);
    return;
  }
  // this part's float32 sums for bwd_reduce_kernel: its dK rows
  // [b][key][hk][DQK], then its dV rows [b][key][hk][DV]
  const long long n_rows = (long long)(gridDim.x / split) * sk;
  const long long row = (long long)b * sk * hkv + hk;  // (b, key 0, hk)
  float* pk = part + pi * n_rows * (DQK + DV);
  store_acc<DQK>(pk + row * DQK, (long long)hkv * DQK, k0, sk, r0, c2,
                 acc_k, 1.f);
  store_acc<DV>(pk + n_rows * DQK + row * DV, (long long)hkv * DV, k0, sk,
                r0, c2, acc_v, 1.f);
}

// named barrier 1 over both warpgroups: warpgroup 1 arrives once its P^T
// fragments are in shared memory, warpgroup 0 waits for them
__device__ __forceinline__ void handoff_arrive() {
  asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void handoff_wait() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// dK/dV where one warpgroup cannot hold both sums: at (192, 128) dK is
// 96 f32 registers a thread and dV 64, and with S^T's and dP^T's 64 the
// one-warpgroup kernel would need ~230 live values and spill. So two
// warpgroups share the key tile (256 threads, one CTA an SM): warpgroup 1
// runs S^T, dP^T, P^T and dS^T as the one-warpgroup kernel does, holds dK
// and runs dK += dS^T . Q; it hands P^T, as the bf16 A fragments it
// already holds, to warpgroup 0 through shared memory (16 words a
// thread, thread t to thread t of the other warpgroup: the fragment
// layout is the same in both), and warpgroup 0 holds dV and runs dV +=
// P^T . dO while warpgroup 1 runs dK's product. One accumulator array a
// thread (dK's in warpgroup 1, dV's in the first atoms of warpgroup 0's),
// so neither warpgroup keeps the other's sum live. The products, their
// order and every rounding are the one-warpgroup kernel's. The block-wide
// barrier at the top of each pair also orders warpgroup 0's reads of the
// hand-off buffer before warpgroup 1's next writes.
template <int DQK, int DV>
__global__ void __launch_bounds__(2 * THREADS, 1)
bwd_dkdv_wgmma2_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, float* __restrict__ part,
                       int split, int sq, int sk, int hq, int hkv, Strides qs,
                       Strides ks, Strides vs, Strides dos, Strides dks,
                       Strides dvs, float scale, int causal) {
  using C = Cfg<DQK, DV>;
  constexpr int NT = 2 * THREADS;
  static_assert(sizeof(Acc<DV>) <= sizeof(Acc<DQK>)
                    && Swz<DV>::AW == Swz<DQK>::AW,
                "dV's fragment fits in the first atoms of dK's");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + C::QK;
  const uint32_t sQ0 = sV + C::VT;  // stage st: Q, then dO
  const uint32_t sSt0 = sQ0 + STAGES * (C::QK + C::VT);  // stage: L, delta
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (sSt0 - raw));
  uint32_t* hand = reinterpret_cast<uint32_t*>(
      smem_raw + (sSt0 + STAGES * C::STATS - raw));  // [16][THREADS]

  const int group = hq / hkv, heads = group / split;
  const int bh = blockIdx.x / split, pi = blockIdx.x % split;
  const int b = bh / hkv, hk = bh % hkv;
  const int h0 = hk * group + pi * heads;  // this part's first q head
  const int k0 = blockIdx.y * BK;  // key tile 0 meets the most q tiles
  const int wg = threadIdx.x / THREADS, t = threadIdx.x % THREADS;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;  // keys k0 + r0 (+ 8)
  const int c2 = 2 * (t % 4);                   // q rows 8 n + c2 (+ 1)
  const int q_first = first_q_tile(k0, causal);
  const int n_q = q_first < sq ? (sq - q_first + BQ - 1) / BQ : 0;
  const int n_it = heads * n_q;  // (head, q tile) pairs, head-major

  // stage it % 2 <- the Q and dO tiles, L and delta of pair it (all 256
  // threads copy the tiles; threads 0-63 L, 64-127 delta)
  auto load_pair = [&](int it) {
    const int h = h0 + it / n_q, q0 = q_first + (it % n_q) * BQ;
    const uint32_t st = sQ0 + (it % STAGES) * (C::QK + C::VT);
    load_tile<DQK, BQ, NT>(st, q + b * qs.b + h * qs.h, qs.s, q0, sq,
                           Tile<DQK>::ATOM);
    load_tile<DV, BQ, NT>(st + C::QK, dout + b * dos.b + h * dos.h, dos.s,
                          q0, sq, Tile<DV>::ATOM);
    if (threadIdx.x < THREADS) {
      const int r = t % BQ;
      const float* src =
          (t < BQ ? lse : delta) + ((long long)b * hq + h) * sq;
      const bool in = q0 + r < sq;
      cp_async4(sSt0 + (it % STAGES) * C::STATS + t * 4,
                in ? src + q0 + r : src, in);
    }
  };

  if (n_it > 0) {
    load_tile<DQK, BK, NT>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, sk,
                           Tile<DQK>::ATOM);
    load_tile<DV, BK, NT>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, sk,
                          Tile<DV>::ATOM);
    load_pair(0);
  }
  cp_async_commit();

  Acc<DQK> acc;  // warpgroup 1: dK; warpgroup 0: dV in its first atoms
  zero_acc<DQK>(acc);
  Acc<DV>& acc_v = reinterpret_cast<Acc<DV>&>(acc);
  const float scale_log2 = scale * LOG2E;
  float s[32], dp[32];  // warpgroup 1's S^T and dP^T fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();  // this thread's copies of pair it
    fence_proxy_async();
    __syncthreads();      // everyone's copies landed; pair it-1 is consumed
    if (it + 1 < n_it) {  // the next pair loads while this one computes
      load_pair(it + 1);
      cp_async_commit();
    }
    const uint32_t sQ = sQ0 + (it % STAGES) * (C::QK + C::VT);
    const uint32_t sdO = sQ + C::QK;
    uint32_t pa[4][4];
    if (wg == 1) {
      const int q0 = q_first + (it % n_q) * BQ;
      const float* sL = stats + (it % STAGES) * 2 * BQ;
      const float* sD = sL + BQ;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      tile_ss<DQK>(s, sK, sQ);
      tile_ss<DV>(dp, sV, sdO);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      uint32_t dsa[4][4];
      pds_t_fragments(pa, dsa, s, dp, sL, sD, k0, q0, sq, sk, causal, r0,
                      c2, scale_log2);
#pragma unroll
      for (int i = 0; i < 16; ++i) hand[i * THREADS + t] = pa[i / 4][i % 4];
      __threadfence_block();
      handoff_arrive();
      // dK += dS^T . Q over the tile's q rows
      fence_acc<DQK>(acc);
      fence_regs(dsa);
      wgmma_fence();
      tile_rs<DQK>(acc, dsa, sQ);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dsa);
      fence_acc<DQK>(acc);
    } else {
      handoff_wait();
#pragma unroll
      for (int i = 0; i < 16; ++i) pa[i / 4][i % 4] = hand[i * THREADS + t];
      // dV += P^T . dO over the tile's q rows
      fence_acc<DV>(acc_v);
      fence_regs(pa);
      wgmma_fence();
      tile_rs<DV>(acc_v, pa, sdO);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pa);
      fence_acc<DV>(acc_v);
    }
  }
  cp_async_wait_all();

  if (split == 1) {
    if (wg == 1)
      store_acc<DQK>(dk + b * dks.b + hk * dks.h, dks.s, k0, sk, r0, c2, acc,
                     scale);
    else
      store_acc<DV>(dv + b * dvs.b + hk * dvs.h, dvs.s, k0, sk, r0, c2,
                    acc_v, 1.f);
    return;
  }
  // this part's float32 sums for bwd_reduce_kernel, laid out as the
  // one-warpgroup kernel's
  const long long n_rows = (long long)(gridDim.x / split) * sk;
  const long long row = (long long)b * sk * hkv + hk;  // (b, key 0, hk)
  float* pk = part + pi * n_rows * (DQK + DV);
  if (wg == 1)
    store_acc<DQK>(pk + row * DQK, (long long)hkv * DQK, k0, sk, r0, c2, acc,
                   1.f);
  else
    store_acc<DV>(pk + n_rows * DQK + row * DV, (long long)hkv * DV, k0, sk,
                  r0, c2, acc_v, 1.f);
}

// dK and dV from the dK/dV kernel's `split` float32 parts, summed in part
// order: one thread an 8-column chunk of a (b, key, KV head) row of dK
// (DQK / 8 chunks a row) or of dV (DV / 8)
template <int DQK, int DV>
__global__ void __launch_bounds__(256)
bwd_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int split, int sk, int hkv,
                  Strides dks, Strides dvs, float scale, long long n_rows) {
  constexpr int CQ = DQK / 8, CV = DV / 8;
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= n_rows * (CQ + CV)) return;
  const long long row = e / (CQ + CV);  // (b, key, hk)
  const int cc = (int)(e % (CQ + CV));
  const bool is_k = cc < CQ;
  const int c = (is_k ? cc : cc - CQ) * 8;
  const int hk = row % hkv, key = (row / hkv) % sk;
  const long long b = row / ((long long)hkv * sk);
  const float* src0 =
      part + (is_k ? row * DQK : n_rows * DQK + row * DV) + c;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int p = 0; p < split; ++p) {
    const float4* src = reinterpret_cast<const float4*>(
        src0 + (long long)p * n_rows * (DQK + DV));
    const float4 x = src[0], y = src[1];
    acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
    acc[4] += y.x; acc[5] += y.y; acc[6] += y.z; acc[7] += y.w;
  }
  const float mul = is_k ? scale : 1.f;
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = pack_bf16(acc[2 * j] * mul, acc[2 * j + 1] * mul);
  bf16* dst = is_k ? dk + b * dks.b + key * dks.s + hk * dks.h
                   : dv + b * dvs.b + key * dvs.s + hk * dvs.h;
  *reinterpret_cast<uint4*>(dst + c) = out;
}

// dS of the pair (q tile q0, key tile k0), rounded to bf16 as the A
// fragments of 4 k-steps, from the S and dP fragments (rows: q rows q0 +
// r0 (+ 8), columns: keys 8 n + c2 (+ 1)) and the rows' L (log2 units) and
// delta. Only a tile that meets the diagonal or a ragged tail is masked.
__device__ __forceinline__ void ds_fragments(
    uint32_t (&dsa)[4][4], const float (&s)[32], const float (&dp)[32],
    const float (&lb)[2], const float (&dl)[2], int k0, int q0, int sq,
    int sk, int causal, int r0, int c2, float scale_log2) {
  const bool edge = k0 + BK > sk || q0 + BQ > sq
                    || (causal && k0 + BK - 1 > q0);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float d2[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p = ex2(fmaf(s[4 * n + 2 * i + j], scale_log2, -lb[i]));
        if (edge) {
          const int row = q0 + r0 + 8 * i, key = k0 + 8 * n + c2 + j;
          if (key >= sk || row >= sq || (causal && key > row)) p = 0.f;
        }
        d2[j] = p * (dp[4 * n + 2 * i + j] - dl[i]);
      }
      dsa[n / 2][2 * (n % 2) + i] = pack_bf16(d2[0], d2[1]);
    }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, DV <= 64 ? 2 : 1)
bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int sq, int sk, int hq, int group, Strides qs,
                    Strides ks, Strides vs, Strides dos, Strides dqs,
                    float scale, int causal) {
  using C = Cfg<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + C::QK;
  const uint32_t sKV0 = sdO + C::VT;  // stage st: K, then V

  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int t = threadIdx.x;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;  // q rows q0 + r0 (+ 8)
  const int c2 = 2 * (t % 4);                   // keys 8 n + c2 (+ 1)
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int n_tiles = kv_tiles(q0, sq, sk, causal);

  // stage st <- the K and V tiles of keys [k0, k0 + BK)
  auto load_kv = [&](uint32_t st, int k0) {
    load_tile<DQK, BK, THREADS>(st, kb, ks.s, k0, sk, Tile<DQK>::ATOM);
    load_tile<DV, BK, THREADS>(st + C::QK, vb, vs.s, k0, sk, Tile<DV>::ATOM);
  };
  load_tile<DQK, BQ, THREADS>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq,
                              Tile<DQK>::ATOM);
  load_tile<DV, BQ, THREADS>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0,
                             sq, Tile<DV>::ATOM);
  if (n_tiles > 0) load_kv(sKV0, 0);
  cp_async_commit();

  float lb[2], dl[2];  // L (log2 units) and delta of rows r0 + 8 i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    const long long at = ((long long)b * hq + h) * sq + row;
    lb[i] = row < sq ? lse[at] * LOG2E : 0.f;
    dl[i] = row < sq ? delta[at] : 0.f;
  }
  Acc<DQK> acc;
  zero_acc<DQK>(acc);
  const float scale_log2 = scale * LOG2E;
  float s[32], dp[32];  // the scores' and dP's fragments, overwritten by
#pragma unroll          // each tile's first product (scale_d = 0)
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_kv(sKV0 + ((it + 1) % STAGES) * (C::QK + C::VT), (it + 1) * BK);
      cp_async_commit();
    }
    const int k0 = it * BK;
    const uint32_t sK = sKV0 + (it % STAGES) * (C::QK + C::VT);
    const uint32_t sV = sK + C::QK;

    // S = Q . K^T and dP = dO . V^T: rows are q rows, columns keys
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    tile_ss<DQK>(s, sQ, sK);
    tile_ss<DV>(dp, sdO, sV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    uint32_t dsa[4][4];
    ds_fragments(dsa, s, dp, lb, dl, k0, q0, sq, sk, causal, r0, c2,
                 scale_log2);

    // dQ += dS . K over the tile's keys
    fence_acc<DQK>(acc);
    fence_regs(dsa);
    wgmma_fence();
    tile_rs<DQK>(acc, dsa, sK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dsa);
    fence_acc<DQK>(acc);
  }
  cp_async_wait_all();

  store_acc<DQK>(dq + b * dqs.b + h * dqs.h, dqs.s, q0, sq, r0, c2, acc,
                 scale);
}

// dQ where one warpgroup cannot hold dQ's sum beside S and dP without
// spilling: at (192, 128) dQ is 96 f32 registers a thread, S's and dP's
// 64 more (in one warpgroup ptxas spilled at its 255-register cap).
// So two warpgroups share the q tile (256 threads, one CTA an SM):
// warpgroup 1 runs S = Q . K^T and dP = dO . V^T and dS on the fragments,
// as the one-warpgroup kernel does, and hands dS, as the bf16 A fragments
// it holds, to warpgroup 0 through shared memory (16 words a thread,
// thread t to thread t); warpgroup 0 holds dQ and runs dQ += dS . K. The
// products, their order and every rounding are the one-warpgroup
// kernel's. The block-wide barrier at the top of each KV tile also orders
// warpgroup 0's reads of the hand-off buffer before warpgroup 1's next
// writes.
template <int DQK, int DV>
__global__ void __launch_bounds__(2 * THREADS, 1)
bwd_dq_wgmma2_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int sq, int sk, int hq, int group, Strides qs,
                     Strides ks, Strides vs, Strides dos, Strides dqs,
                     float scale, int causal) {
  using C = Cfg<DQK, DV>;
  constexpr int NT = 2 * THREADS;
  static_assert(Swz<DQK>::NA >= 2 && Swz<DQK>::AW == 64,
                "S and dP fit in dQ's first two atoms");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sdO = sQ + C::QK;
  const uint32_t sKV0 = sdO + C::VT;  // stage st: K, then V
  uint32_t* hand = reinterpret_cast<uint32_t*>(
      smem_raw + (sKV0 + STAGES * (C::QK + C::VT) - raw));  // [16][THREADS]

  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int wg = threadIdx.x / THREADS, t = threadIdx.x % THREADS;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;  // q rows q0 + r0 (+ 8)
  const int c2 = 2 * (t % 4);                   // keys 8 n + c2 (+ 1)
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int n_tiles = kv_tiles(q0, sq, sk, causal);

  // stage st <- the K and V tiles of keys [k0, k0 + BK), by all threads
  auto load_kv = [&](uint32_t st, int k0) {
    load_tile<DQK, BK, NT>(st, kb, ks.s, k0, sk, Tile<DQK>::ATOM);
    load_tile<DV, BK, NT>(st + C::QK, vb, vs.s, k0, sk, Tile<DV>::ATOM);
  };
  load_tile<DQK, BQ, NT>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq,
                         Tile<DQK>::ATOM);
  load_tile<DV, BQ, NT>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, sq,
                        Tile<DV>::ATOM);
  if (n_tiles > 0) load_kv(sKV0, 0);
  cp_async_commit();

  float lb[2], dl[2];  // L (log2 units) and delta of rows r0 + 8 i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    const long long at = ((long long)b * hq + h) * sq + row;
    lb[i] = row < sq ? lse[at] * LOG2E : 0.f;
    dl[i] = row < sq ? delta[at] : 0.f;
  }
  // one register array a thread: warpgroup 0's dQ, or in warpgroup 1 the
  // S and dP fragments (its first two atoms), so neither warpgroup keeps
  // the other's values live
  Acc<DQK> acc;
  zero_acc<DQK>(acc);
  float (&s)[32] = acc[0];
  float (&dp)[32] = acc[1];
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_kv(sKV0 + ((it + 1) % STAGES) * (C::QK + C::VT), (it + 1) * BK);
      cp_async_commit();
    }
    const int k0 = it * BK;
    const uint32_t sK = sKV0 + (it % STAGES) * (C::QK + C::VT);
    const uint32_t sV = sK + C::QK;
    uint32_t dsa[4][4];
    if (wg == 1) {
      // S = Q . K^T and dP = dO . V^T: rows are q rows, columns keys
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      tile_ss<DQK>(s, sQ, sK);
      tile_ss<DV>(dp, sdO, sV);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      ds_fragments(dsa, s, dp, lb, dl, k0, q0, sq, sk, causal, r0, c2,
                   scale_log2);
#pragma unroll
      for (int i = 0; i < 16; ++i) hand[i * THREADS + t] = dsa[i / 4][i % 4];
      __threadfence_block();
      handoff_arrive();
    } else {
      handoff_wait();
#pragma unroll
      for (int i = 0; i < 16; ++i) dsa[i / 4][i % 4] = hand[i * THREADS + t];
      // dQ += dS . K over the tile's keys
      fence_acc<DQK>(acc);
      fence_regs(dsa);
      wgmma_fence();
      tile_rs<DQK>(acc, dsa, sK);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dsa);
      fence_acc<DQK>(acc);
    }
  }
  cp_async_wait_all();

  if (wg == 0)
    store_acc<DQK>(dq + b * dqs.b + h * dqs.h, dqs.s, q0, sq, r0, c2, acc,
                   scale);
}

}  // namespace tc

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;
  float *delta, *part;
  int batch, sq, sk, hq, hkv, split, causal;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

template <typename T, int DV>
cudaError_t launch_prep(const Args& a, cudaStream_t stream) {
  const long long n_rows = (long long)a.batch * a.sq * a.hq;
  bwd_prep_kernel<T, DV><<<(unsigned)((n_rows + 255) / 256), 256, 0,
                           stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      a.sq, a.hq, a.os, a.dos, n_rows);
  return cudaGetLastError();
}

template <int DQK, int DV>
int launch_f32(const Args& a, cudaStream_t stream) {
  using namespace simt;
  const float scale = (float)(1.0 / sqrt((double)DQK));
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  cudaError_t err =
      allow_smem(bwd_dkdv_kernel<DQK, DV>, dkdv_smem<DQK, DV>());
  if (err == cudaSuccess)
    err = allow_smem(bwd_dq_kernel<DQK, DV>, dq_smem<DQK, DV>());
  if (err == cudaSuccess) err = launch_prep<float, DV>(a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(a.batch * a.hkv, (a.sk + BK - 1) / BK);
  bwd_dkdv_kernel<DQK, DV><<<kv_grid, THREADS, dkdv_smem<DQK, DV>(),
                             stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.sq, a.sk, a.hq, a.hkv, a.qs, a.ks, a.vs,
      a.dos, a.dks, a.dvs, scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid(a.batch * a.hq, (a.sq + BQ - 1) / BQ);
  bwd_dq_kernel<DQK, DV><<<q_grid, THREADS, dq_smem<DQK, DV>(), stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.sq, a.sk,
      a.hq, a.hq / a.hkv, a.qs, a.ks, a.vs, a.dos, a.dqs, scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch_bf16(const Args& a, cudaStream_t stream) {
  using namespace tc;
  using C = Cfg<DQK, DV>;
  const float scale = (float)(1.0 / sqrt((double)DQK));
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  // the dK/dV and dQ kernels: one warpgroup, or two where D is too wide
  // (only the ones each pair runs are instantiated)
  auto dkdv = [] {
    if constexpr (C::TWO_WG) return bwd_dkdv_wgmma2_kernel<DQK, DV>;
    else return bwd_dkdv_wgmma_kernel<DQK, DV>;
  }();
  auto dqk = [] {
    if constexpr (C::TWO_WG) return bwd_dq_wgmma2_kernel<DQK, DV>;
    else return bwd_dq_wgmma_kernel<DQK, DV>;
  }();
  const int threads = C::TWO_WG ? 2 * THREADS : THREADS;
  const int dkdv_smem = C::TWO_WG ? C::DKDV2_SMEM : C::DKDV_SMEM;
  const int dq_smem = C::TWO_WG ? C::DQ2_SMEM : C::DQ_SMEM;
  cudaError_t err = allow_smem(dkdv, dkdv_smem);
  if (err == cudaSuccess) err = allow_smem(dqk, dq_smem);
  if (err == cudaSuccess) err = launch_prep<bf16, DV>(a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(a.batch * a.hkv * a.split, (a.sk + BK - 1) / BK);
  dkdv<<<kv_grid, threads, dkdv_smem, stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.part, a.split, a.sq, a.sk, a.hq, a.hkv,
      a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.split > 1) {
    const long long n_rows = (long long)a.batch * a.sk * a.hkv;
    const long long n_chunks = n_rows * ((DQK + DV) / 8);
    bwd_reduce_kernel<DQK, DV><<<(unsigned)((n_chunks + 255) / 256), 256,
                                 0, stream>>>(
        a.part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.split,
        a.sk, a.hkv, a.dks, a.dvs, scale, n_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 q_grid(a.batch * a.hq, (a.sq + BQ - 1) / BQ);
  dqk<<<q_grid, threads, dq_smem, stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), a.sq, a.sk,
      a.hq, a.hq / a.hkv, a.qs, a.ks, a.vs, a.dos, a.dqs, scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// the (DQK, DV) instance for the dtype: 0 = float32 (SIMT; one part), 1 =
// bfloat16 (wgmma; 16-byte aligned pointers and strides, checked here)
template <int DQK, int DV>
int launch(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0 && a.split == 1) return launch_f32<DQK, DV>(a, stream);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Strides* all[] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos,
                          &a.dqs, &a.dks, &a.dvs};
  const void* ptrs[] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  for (int i = 0; i < 8; ++i)
    if (!flash::aligned(ptrs[i], *all[i]))
      return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<DQK, DV>(a, stream);
}

}  // namespace

// q, dq: (batch, sq, hq, d); o, dout: (batch, sq, hq, dv); k, dk: (batch,
// sk, hkv, d); v, dv: (batch, sk, hkv, dv). Strides in elements, (batch,
// seq, head) for each tensor; the head dim has unit stride. lse: the
// forward's float32 (batch, hq, sq) log-sum-exp, an input; delta: float32
// scratch of batch * hq * sq. split: the parts the bf16 dK/dV kernel cuts
// each KV head's hq / hkv query heads into (a divisor of it; 1 for
// float32); part: float32 scratch of split * batch * sk * hkv * (d + dv)
// when split > 1, else unused. dtype: 0 = float32 (SIMT kernels), 1 =
// bfloat16 (wgmma kernels; 16-byte aligned pointers and strides); (d, dv)
// in {(32, 32), (64, 64), (128, 128), (96, 64), (192, 128)}: any other
// pair returns cudaErrorInvalidValue. Returns cudaGetLastError() after the launches (or
// the attribute's error).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const float* lse,
    float* delta, float* part, int dtype, int d, int d_v, int batch, int sq,
    int sk, int hq, int hkv, int split, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh, long long dv_sb,
    long long dv_ss, long long dv_sh, int causal, void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || sq <= 0 || sk <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || split <= 0 || (hq / hkv) % split != 0
      || (split > 1 && (dtype != 1 || part == nullptr)))
    return kInvalid;
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, part,
               batch, sq, sk, hq, hkv, split, causal,
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {o_sb, o_ss, o_sh}, {do_sb, do_ss, do_sh},
               {dq_sb, dq_ss, dq_sh}, {dk_sb, dk_ss, dk_sh},
               {dv_sb, dv_ss, dv_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 32 && d_v == 32) return launch<32, 32>(dtype, a, st);
  if (d == 64 && d_v == 64) return launch<64, 64>(dtype, a, st);
  if (d == 128 && d_v == 128) return launch<128, 128>(dtype, a, st);
  if (d == 96 && d_v == 64) return launch<96, 64>(dtype, a, st);
  if (d == 192 && d_v == 128) return launch<192, 128>(dtype, a, st);
  return kInvalid;
}
