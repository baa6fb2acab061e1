// FlashAttention-2 backward for Hopper (sm_90a): the gradient of the
// forward in flash_attention.cu, bf16 on the tensor cores (wgmma) and
// float32 on the CUDA cores, behind one C entry.
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
//      pass over dO and O.
//   2. dK/dV, one CTA per (batch * KV head, key tile, part): holds its K
//      and V tile, loops over its part of the g = Hq / Hkv query heads
//      that read this KV head and over the q tiles at or below the
//      diagonal, and sums dK and dV in registers. With one part (split =
//      1) it stores them; with more, each part stores its float32 sums
//      and bwd_reduce_kernel adds the parts in part order. So the GQA sum
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
//                                           q rows, K = D
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
// Layout: q, o, dO, dq are (B, Sq, Hq, D); k, v, dk, dv (B, Sk, Hkv, D);
// each with unit stride along D and any (b, s, h) strides; lse and delta
// (B, Hq, Sq) float32. Rows past Sq and keys past Sk are masked; keys that
// no query sees get dK = dV = 0.
//
// Bound: operations. At the training shape (B=1, S=4096, Hq=32, Hkv=4,
// D=64, bf16, causal) the gradient's five products (Q.K^T recomputed, dV,
// dP, dQ, dK) over the causal half are 1.7e11 operations: 0.1738 ms at
// the bf16 tensor-core peak (989 TFLOP/s). This design does seven: S and
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

template <typename T, int D>
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
    for (int c = 0; c < D; c += 8)
      acc = dot8(*reinterpret_cast<const uint4*>(drow + c),
                 *reinterpret_cast<const uint4*>(orow + c), acc);
  } else {
#pragma unroll 8
    for (int c = 0; c < D; ++c) acc = fmaf(drow[c], orow[c], acc);
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

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int sq, int sk, int hq, int hkv,
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
  load_rows<D, BK>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, sk);
  load_rows<D, BK>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, sk);

  float acc_k[RPT][CO], acc_v[RPT][CO];  // keys rg + 16 i, cols cg + 16 e
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < CO; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int r = 0; r < group; ++r) {
    const int h = hk * group + r;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dout + b * dos.b + h * dos.h;
    for (int q0 = first_q_tile(k0, causal); q0 < sq; q0 += BQ) {
      __syncthreads();  // the previous q tile's reads are done
      load_rows<D, BQ>(sQ, qb, qs.s, q0, sq);
      load_rows<D, BQ>(sdO, dob, dos.s, q0, sq);
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

  float* dkb = dk + b * dks.b + hk * dks.h;
  float* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + rg + 16 * i;
    if (key >= sk) continue;
#pragma unroll
    for (int e = 0; e < CO; ++e) {
      dkb[(long long)key * dks.s + cg + 16 * e] = acc_k[i][e] * scale;
      dvb[(long long)key * dvs.s + cg + 16 * e] = acc_v[i][e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int sq, int sk, int hq, int group,
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
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  load_rows<D, BQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  load_rows<D, BQ>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, sq);
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
    load_rows<D, BK>(sK, kb, ks.s, k0, sk);
    load_rows<D, BK>(sV, vb, vs.s, k0, sk);
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

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * (BK + BQ) * (D + 1) + 2 * BQ * PP + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (BK + BQ) * (D + 1) + BQ * PP + 2 * BQ);
}

}  // namespace simt

// ------------------------------------------------- bf16: tensor cores
namespace tc {

using namespace flash;

constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;     // the ring of streamed tiles

template <int D>
struct Cfg : Swz<D> {
  static constexpr int ATOM = 64 * Swz<D>::ROWB;  // bytes of a tile's atom
  static constexpr int TILE = 64 * D * 2;         // bytes of a 64-row tile
  static constexpr int STATS = 2 * BQ * 4;        // L and delta of a q tile
  // dK/dV: K, V, STAGES x (Q, dO), STAGES x (L, delta); dQ: Q, dO,
  // STAGES x (K, V). + 1 KB to align the tiles to the swizzle repeat.
  static constexpr int DKDV_SMEM =
      1024 + 2 * TILE + STAGES * (2 * TILE + STATS);
  static constexpr int DQ_SMEM = 1024 + 2 * TILE + STAGES * 2 * TILE;
};

// acc (+)= A . B^T over D for two 64-row tiles read row-wise (K-major)
template <int D>
__device__ __forceinline__ void tile_ss(float (&acc)[32], uint32_t a,
                                        uint32_t b) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int at = kk / (C::AW / 16);                // column atom
    const uint32_t off = (kk % (C::AW / 16)) * 32;   // bytes into its rows
    wgmma_ss(acc,
             make_desc(a + at * C::ATOM + off, 16, C::GROUP, C::SWZ),
             make_desc(b + at * C::ATOM + off, 16, C::GROUP, C::SWZ),
             kk > 0);
  }
}

// acc[a] += A . B over the 64 rows of B, A from registers (a 64 x 64
// probability-shaped fragment, 4 k-steps), B read column-wise through the
// transpose bit, one instruction per k-step and column atom
template <int D>
__device__ __forceinline__ void tile_rs(float (&acc)[Cfg<D>::NA][Cfg<D>::AW / 2],
                                        const uint32_t (&a)[4][4],
                                        uint32_t b) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int at = 0; at < C::NA; ++at)
      wgmma_rs_tb(acc[at], a[kk],
                  make_desc(b + at * C::ATOM + kk * 16 * C::ROWB, C::ATOM,
                            C::GROUP, C::SWZ));
}

template <int D>
__device__ __forceinline__ void fence_acc(
    float (&acc)[Cfg<D>::NA][Cfg<D>::AW / 2]) {
#pragma unroll
  for (int at = 0; at < Cfg<D>::NA; ++at) fence_regs(acc[at]);
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
__device__ __forceinline__ void store_acc(
    T* base, long long stride, int row0, int lim, int r0, int c2,
    const float (&acc)[Cfg<D>::NA][Cfg<D>::AW / 2], float mul) {
  using C = Cfg<D>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= lim) continue;
    T* dst = base + (long long)row * stride;
#pragma unroll
    for (int at = 0; at < C::NA; ++at)
#pragma unroll
      for (int n = 0; n < C::AW / 8; ++n)
        put2(dst + at * C::AW + 8 * n + c2, acc[at][4 * n + 2 * i] * mul,
             acc[at][4 * n + 2 * i + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ part,
                      int split, int sq, int sk, int hq, int hkv, Strides qs,
                      Strides ks, Strides vs, Strides dos, Strides dks,
                      Strides dvs, float scale, int causal) {
  using C = Cfg<D>;
  constexpr int NA = C::NA, AW = C::AW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + C::TILE;
  const uint32_t sQ0 = sV + C::TILE;  // stage st: Q, then dO
  const uint32_t sSt0 = sQ0 + STAGES * 2 * C::TILE;  // stage st: L, delta
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
    const uint32_t st = sQ0 + (it % STAGES) * 2 * C::TILE;
    load_tile<D, BQ, THREADS>(st, q + b * qs.b + h * qs.h, qs.s, q0, sq,
                              C::ATOM);
    load_tile<D, BQ, THREADS>(st + C::TILE, dout + b * dos.b + h * dos.h,
                              dos.s, q0, sq, C::ATOM);
    const int r = t % BQ;  // threads 0-63 copy L, 64-127 delta
    const float* src = (t < BQ ? lse : delta) + ((long long)b * hq + h) * sq;
    const bool in = q0 + r < sq;
    cp_async4(sSt0 + (it % STAGES) * C::STATS + t * 4,
              in ? src + q0 + r : src, in);
  };

  if (n_it > 0) {
    load_tile<D, BK, THREADS>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, sk,
                              C::ATOM);
    load_tile<D, BK, THREADS>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, sk,
                              C::ATOM);
    load_pair(0);
  }
  cp_async_commit();

  float acc_k[NA][AW / 2], acc_v[NA][AW / 2];  // rows: keys r0 + 8 i
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < AW / 2; ++i) acc_k[a][i] = acc_v[a][i] = 0.f;
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
    const uint32_t sQ = sQ0 + (it % STAGES) * 2 * C::TILE;
    const uint32_t sdO = sQ + C::TILE;
    const float* sL = stats + (it % STAGES) * 2 * BQ;
    const float* sD = sL + BQ;

    // S^T = K . Q^T and dP^T = V . dO^T: rows are keys, columns q rows
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    tile_ss<D>(s, sK, sQ);
    tile_ss<D>(dp, sV, sdO);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T on the fragments, L and delta by column
    const bool edge = k0 + BK > sk || q0 + BQ > sq
                      || (causal && q0 < k0 + BK - 1);
    uint32_t pa[4][4], dsa[4][4];  // as the A fragments of 4 k-steps
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

    // dV += P^T . dO and dK += dS^T . Q over the tile's q rows
    fence_acc<D>(acc_v);
    fence_acc<D>(acc_k);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
    tile_rs<D>(acc_v, pa, sdO);
    tile_rs<D>(acc_k, dsa, sQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pa);  // the fragments stay live until the products end
    fence_regs(dsa);
    fence_acc<D>(acc_v);
    fence_acc<D>(acc_k);
  }
  cp_async_wait_all();

  if (split == 1) {
    store_acc<D>(dk + b * dks.b + hk * dks.h, dks.s, k0, sk, r0, c2, acc_k,
                 scale);
    store_acc<D>(dv + b * dvs.b + hk * dvs.h, dvs.s, k0, sk, r0, c2, acc_v,
                 1.f);
    return;
  }
  // this part's float32 sums, [part][dK, dV][b][key][hk][D], for
  // bwd_reduce_kernel
  const long long n_rows = (long long)(gridDim.x / split) * sk;
  float* pk = part + ((2LL * pi * n_rows + (long long)b * sk * hkv) + hk) * D;
  store_acc<D>(pk, (long long)hkv * D, k0, sk, r0, c2, acc_k, 1.f);
  store_acc<D>(pk + n_rows * D, (long long)hkv * D, k0, sk, r0, c2, acc_v,
               1.f);
}

// dK and dV from the dK/dV kernel's `split` float32 parts, summed in part
// order: one thread a (b, key, KV head) row's 8 columns
template <int D>
__global__ void __launch_bounds__(256)
bwd_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int split, int sk, int hkv,
                  Strides dks, Strides dvs, float scale, long long n_rows) {
  constexpr int CPR = D / 8;
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= n_rows * CPR) return;
  const long long row = e / CPR;  // (b, key, hk)
  const int c = (int)(e % CPR) * 8, hk = row % hkv, key = (row / hkv) % sk;
  const long long b = row / ((long long)hkv * sk);
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int p = 0; p < split; ++p) {
      const float4* src = reinterpret_cast<const float4*>(
          part + ((2LL * p + w) * n_rows + row) * D + c);
      const float4 x = src[0], y = src[1];
      acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
      acc[4] += y.x; acc[5] += y.y; acc[6] += y.z; acc[7] += y.w;
    }
    const float mul = w == 0 ? scale : 1.f;
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = pack_bf16(acc[2 * j] * mul, acc[2 * j + 1] * mul);
    bf16* dst = w == 0 ? dk + b * dks.b + key * dks.s + hk * dks.h
                       : dv + b * dvs.b + key * dvs.s + hk * dvs.h;
    *reinterpret_cast<uint4*>(dst + c) = out;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int sq, int sk, int hq, int group, Strides qs,
                    Strides ks, Strides vs, Strides dos, Strides dqs,
                    float scale, int causal) {
  using C = Cfg<D>;
  constexpr int NA = C::NA, AW = C::AW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + C::TILE;
  const uint32_t sKV0 = sdO + C::TILE;  // stage st: K, then V

  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int t = threadIdx.x;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;  // q rows q0 + r0 (+ 8)
  const int c2 = 2 * (t % 4);                   // keys 8 n + c2 (+ 1)
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int n_tiles = kv_tiles(q0, sq, sk, causal);

  load_tile<D, BQ, THREADS>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, sq,
                            C::ATOM);
  load_tile<D, BQ, THREADS>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0,
                            sq, C::ATOM);
  if (n_tiles > 0) {
    load_tile<D, BK, THREADS>(sKV0, kb, ks.s, 0, sk, C::ATOM);
    load_tile<D, BK, THREADS>(sKV0 + C::TILE, vb, vs.s, 0, sk, C::ATOM);
  }
  cp_async_commit();

  float lb[2], dl[2];  // L (log2 units) and delta of rows r0 + 8 i
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    const long long at = ((long long)b * hq + h) * sq + row;
    lb[i] = row < sq ? lse[at] * LOG2E : 0.f;
    dl[i] = row < sq ? delta[at] : 0.f;
  }
  float acc[NA][AW / 2];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < AW / 2; ++i) acc[a][i] = 0.f;
  const float scale_log2 = scale * LOG2E;
  float s[32], dp[32];  // the scores' and dP's fragments, overwritten by
#pragma unroll          // each tile's first product (scale_d = 0)
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const uint32_t nxt = sKV0 + ((it + 1) % STAGES) * 2 * C::TILE;
      load_tile<D, BK, THREADS>(nxt, kb, ks.s, (it + 1) * BK, sk, C::ATOM);
      load_tile<D, BK, THREADS>(nxt + C::TILE, vb, vs.s, (it + 1) * BK, sk,
                                C::ATOM);
      cp_async_commit();
    }
    const int k0 = it * BK;
    const uint32_t sK = sKV0 + (it % STAGES) * 2 * C::TILE;
    const uint32_t sV = sK + C::TILE;

    // S = Q . K^T and dP = dO . V^T: rows are q rows, columns keys
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    tile_ss<D>(s, sQ, sK);
    tile_ss<D>(dp, sdO, sV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = k0 + BK > sk || q0 + BQ > sq
                      || (causal && k0 + BK - 1 > q0);
    uint32_t dsa[4][4];
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

    // dQ += dS . K over the tile's keys
    fence_acc<D>(acc);
    fence_regs(dsa);
    wgmma_fence();
    tile_rs<D>(acc, dsa, sK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dsa);
    fence_acc<D>(acc);
  }
  cp_async_wait_all();

  store_acc<D>(dq + b * dqs.b + h * dqs.h, dqs.s, q0, sq, r0, c2, acc,
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

template <typename T, int D>
cudaError_t launch_prep(const Args& a, cudaStream_t stream) {
  const long long n_rows = (long long)a.batch * a.sq * a.hq;
  bwd_prep_kernel<T, D><<<(unsigned)((n_rows + 255) / 256), 256, 0,
                          stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      a.sq, a.hq, a.os, a.dos, n_rows);
  return cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  using namespace simt;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  cudaError_t err = allow_smem(bwd_dkdv_kernel<D>, dkdv_smem<D>());
  if (err == cudaSuccess) err = allow_smem(bwd_dq_kernel<D>, dq_smem<D>());
  if (err == cudaSuccess) err = launch_prep<float, D>(a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(a.batch * a.hkv, (a.sk + BK - 1) / BK);
  bwd_dkdv_kernel<D><<<kv_grid, THREADS, dkdv_smem<D>(), stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.sq, a.sk, a.hq, a.hkv, a.qs, a.ks, a.vs,
      a.dos, a.dks, a.dvs, scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid(a.batch * a.hq, (a.sq + BQ - 1) / BQ);
  bwd_dq_kernel<D><<<q_grid, THREADS, dq_smem<D>(), stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.sq, a.sk,
      a.hq, a.hq / a.hkv, a.qs, a.ks, a.vs, a.dos, a.dqs, scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  using namespace tc;
  using C = Cfg<D>;
  const float scale = (float)(1.0 / sqrt((double)D));
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  cudaError_t err = allow_smem(bwd_dkdv_wgmma_kernel<D>, C::DKDV_SMEM);
  if (err == cudaSuccess)
    err = allow_smem(bwd_dq_wgmma_kernel<D>, C::DQ_SMEM);
  if (err == cudaSuccess) err = launch_prep<bf16, D>(a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid(a.batch * a.hkv * a.split, (a.sk + BK - 1) / BK);
  bwd_dkdv_wgmma_kernel<D><<<kv_grid, THREADS, C::DKDV_SMEM, stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.part, a.split, a.sq, a.sk, a.hq, a.hkv,
      a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.split > 1) {
    const long long n_rows = (long long)a.batch * a.sk * a.hkv;
    bwd_reduce_kernel<D><<<(unsigned)((n_rows * (D / 8) + 255) / 256), 256,
                           0, stream>>>(
        a.part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.split,
        a.sk, a.hkv, a.dks, a.dvs, scale, n_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 q_grid(a.batch * a.hq, (a.sq + BQ - 1) / BQ);
  bwd_dq_wgmma_kernel<D><<<q_grid, THREADS, C::DQ_SMEM, stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), a.sq, a.sk,
      a.hq, a.hq / a.hkv, a.qs, a.ks, a.vs, a.dos, a.dqs, scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: (batch, sq, hq, d); k, v, dk, dv: (batch, sk, hkv, d).
// Strides in elements, (batch, seq, head) for each tensor; d has unit
// stride. lse: the forward's float32 (batch, hq, sq) log-sum-exp, an
// input; delta: float32 scratch of batch * hq * sq. split: the parts the
// bf16 dK/dV kernel cuts each KV head's hq / hkv query heads into (a
// divisor of it; 1 for float32); part: float32 scratch of split * 2 *
// batch * sk * hkv * d when split > 1, else unused. dtype: 0 = float32
// (SIMT kernels), 1 = bfloat16 (wgmma kernels; 16-byte aligned pointers
// and strides); d in {32, 64, 128}. Returns cudaGetLastError() after the
// launches (or the attribute's error).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const float* lse,
    float* delta, float* part, int dtype, int d, int batch, int sq, int sk,
    int hq, int hkv, int split, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    int causal, void* stream) {
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
  if (dtype == 0) {
    switch (d) {
      case 32: return launch_f32<32>(a, st);
      case 64: return launch_f32<64>(a, st);
      case 128: return launch_f32<128>(a, st);
    }
    return kInvalid;
  }
  if (dtype != 1) return kInvalid;
  const Strides* all[] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos,
                          &a.dqs, &a.dks, &a.dvs};
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  for (int i = 0; i < 8; ++i)
    if (!flash::aligned(ptrs[i], *all[i])) return kInvalid;
  switch (d) {
    case 32: return launch_bf16<32>(a, st);
    case 64: return launch_bf16<64>(a, st);
    case 128: return launch_bf16<128>(a, st);
  }
  return kInvalid;
}
