// FlashAttention-2 forward for Hopper (sm_90a): a bf16 tensor-core kernel
// and a float32 SIMT kernel behind one C entry.
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
// order, so here one CTA owns one (batch * head, q tile) and loops over the
// KV tiles itself, keeping m, l and acc in registers.
//
// Layout: q, k, v, o are (B, S, H, D) with unit stride along D and any
// other strides, so the model's tensors need no transpose. GQA: q head h
// reads KV head h / (Hq / Hkv), in-kernel, with no repeated copies.
// Causal CTAs stop at the last KV tile that meets the diagonal; the skipped
// tiles would add exactly zero, since every row sees key 0 in the first
// tile and so has a finite running max. The mask compares positions from 0
// on both sides, also when Sk > Sq. Keys past Sk and rows past Sq (a
// ragged tail) are masked. The q tiles are dispatched longest first.
//
// Bound: operations. At TinyLlama's prefill shape (B=2, S=4096, Hq=32,
// Hkv=4, D=64, bf16, causal) the two products are 1.37e11 operations for
// the causal half against 75 MB of q, k, v and o; the tensor-core bound is
// 0.139 ms.
//
// The kernel is chosen by dtype, not as a fallback: tensor cores take
// float32 only as TF32, which cannot meet the float32 contract (2e-5 /
// 1e-4), so float32 keeps the SIMT kernel and bf16 runs on wgmma.
//
// bf16 (flash_fwd_wgmma_kernel): 256 threads, two consumer warpgroups of
// 64 q rows each, so one CTA holds 128 q rows (TQ) and every K/V tile of
// 64 keys (BK) in shared memory serves both. Both products are
// wgmma.mma_async bf16 -> f32 (inline PTX):
//   S = Q . K^T: A = the warpgroup's Q rows, B = the K tile [keys][D],
//     both K-major in shared memory, m64n64k16 per 16 columns of D.
//   O += P . V: A = P from registers. The f32 accumulator fragment of S
//     (thread t holds rows 16 w + t/4 + {0, 8}, columns 8 n + 2 (t%4) +
//     {0, 1}) rounded to bf16 pairs is the A fragment of m64nXk16 as it
//     stands, so p never goes through shared memory. B = the V tile
//     [keys][D] read through the transpose bit (MN-major).
// Tiles live in shared memory in bf16 in the swizzled layout the wgmma
// descriptors read: rows of 64 columns (128 bytes, 128-byte swizzle) for
// D = 64 and 128 (two column atoms at D = 128), rows of 32 columns (64
// bytes, 64-byte swizzle) for D = 32. K and V arrive by 16-byte cp.async
// copies (zero fill past Sk and Sq) into a ring of two stages: tile t+1
// loads while tile t computes, one __syncthreads per tile. The online
// softmax runs on the accumulator fragments: row max and row sum reduce
// over the four threads of a row (shfl_xor 1, 2), alpha rescales the O
// fragment in place, l is kept per thread and reduced once at the end,
// and exp runs as one ex2.approx on the special-function units: at D = 64
// a score costs 256 tensor-core operations and one exponential, and 16
// exponentials per SM per clock only just keep pace with the tensor peak.
// At D <= 64 a thread needs under 128 registers, so two CTAs share an SM
// and one's softmax overlaps the other's products (64-key tiles measured
// faster than 128-key tiles at one CTA per SM). Only tiles that meet the
// diagonal or the ragged key tail are masked; a warpgroup skips the tiles
// wholly above its own rows. Operands must be 16-byte aligned, with
// (b, s, h) strides in multiples of 8 elements (checked by the wrapper,
// and again here).
//
// float32 (flash_fwd_kernel): 64-row q tiles, 256 threads as 16 row groups
// x 16 column groups; tiles staged in shared memory as float32 with rows
// padded for conflict-free reads; both products as FMA on the CUDA cores.
//
// Both kernels take an optional lse (B, Hq, Sq) float32: when it is not
// null, each row's log-sum-exp m + log(l) (natural units, NEG_INF for a
// row that sees no key) is stored from the m and l the kernel already
// holds, for the backward (flash_attention_bwd.cu), which then needs no
// pass of its own to recompute it. The wgmma and cp.async helpers live in
// flash_wgmma.cuh, shared with the backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

namespace {

using flash::NEG_INF;
using flash::Strides;

// ------------------------------------------------------ float32: SIMT
namespace simt {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr int RPT = BQ / 16;  // rows per thread
constexpr int CPT = BK / 16;  // score columns per thread
constexpr int PP = BK + 1;    // padded row of p

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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int hq, int group,
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    sQ[r * DP + c] =
        q0 + r < sq ? qb[(long long)(q0 + r) * qs.s + c] : 0.f;
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
      sK[r * DP + c] = in ? kb[(long long)(k0 + r) * ks.s + c] : 0.f;
      sV[e] = in ? vb[(long long)(k0 + r) * vs.s + c] : 0.f;
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
        sP[row * PP + cg + 16 * j] = p;
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
    if (lse != nullptr && cg == 0)
      lse[((long long)b * hq + h) * sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : NEG_INF;
    const float denom = fmaxf(l[i], 1e-30f);
    float* dst = ob + (long long)row * os.s;
#pragma unroll
    for (int e = 0; e < CO; ++e)
      dst[cg + 16 * e] = acc[i][e] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int sq, int sk, int hq, int hkv, Strides qs,
           Strides ks, Strides vs, Strides os, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * hq, (sq + BQ - 1) / BQ);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk,
      hq, hq / hkv, qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ------------------------------------------------- bf16: tensor cores
namespace tc {

using namespace flash;

constexpr int TQ = 128;       // q rows per CTA: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int STAGES = 2;     // K/V ring

template <int D>
struct Cfg : Swz<D> {
  static constexpr int BK = 64;                 // keys per KV tile
  static constexpr int Q_ATOM = TQ * Swz<D>::ROWB;   // bytes of a q atom
  static constexpr int KV_ATOM = BK * Swz<D>::ROWB;  // bytes of a K/V atom
  static constexpr int Q_BYTES = TQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one K or one V tile
  // + 1 KB to align the tiles to the 1024-byte swizzle repeat
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES;
};

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int sq, int sk, int hq,
                       int group,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, int causal) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, AW = C::AW, NA = C::NA;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::Q_BYTES;  // stage st: K, then V

  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;  // longest first
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row_lo = q0 + 64 * wg;                    // the warpgroup's rows
  const int r0 = row_lo + 16 * (t / 32) + (t % 32) / 4;  // rows r0, r0 + 8
  const int c2 = 2 * (t % 4);                         // columns c2, c2 + 1
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  const int n_kv = (sk + BK - 1) / BK;
  int n_tiles = n_kv, wg_tiles = n_kv;
  if (causal) {
    n_tiles = min(n_kv, (min(q0 + TQ, sq) - 1) / BK + 1);
    wg_tiles = min(n_kv, (min(row_lo + 64, sq) - 1) / BK + 1);
  }
  if (row_lo >= sq) wg_tiles = 0;  // no rows of this warpgroup in range

  load_tile<D, TQ, THREADS>(sQ, qb, qs.s, q0, sq, C::Q_ATOM);
  if (n_tiles > 0) {
    load_tile<D, BK, THREADS>(sKV, kb, ks.s, 0, sk, C::KV_ATOM);
    load_tile<D, BK, THREADS>(sKV + C::KV_BYTES, vb, vs.s, 0, sk, C::KV_ATOM);
  }
  cp_async_commit();

  float s[BK / 2];        // S fragment: s[4 n + 2 i + j] is row r0 + 8 i,
                          // column 8 n + c2 + j of the tile
  float acc[NA][AW / 2];  // O fragment, the same layout per column atom
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < AW / 2; ++i) acc[a][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();  // this thread's copies of tile it
    fence_proxy_async();
    __syncthreads();      // everyone's copies landed; tile it-1 is consumed
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      const uint32_t nxt = sKV + ((it + 1) % STAGES) * 2 * C::KV_BYTES;
      load_tile<D, BK, THREADS>(nxt, kb, ks.s, (it + 1) * BK, sk, C::KV_ATOM);
      load_tile<D, BK, THREADS>(nxt + C::KV_BYTES, vb, vs.s, (it + 1) * BK, sk,
                       C::KV_ATOM);
      cp_async_commit();
    }
    if (it >= wg_tiles) continue;  // wholly above this warpgroup's rows
    const int k0 = it * BK;
    const uint32_t sK = sKV + (it % STAGES) * 2 * C::KV_BYTES;
    const uint32_t sV = sK + C::KV_BYTES;

    // S = Q . K^T over D in steps of 16 (32 bytes within an atom row)
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int a = kk / (AW / 16);             // column atom
      const uint32_t off = (kk % (AW / 16)) * 32;  // bytes into its rows
      const uint64_t da = make_desc(
          sQ + a * C::Q_ATOM + wg * 64 * C::ROWB + off, 16, C::GROUP, C::SWZ);
      const uint64_t db = make_desc(sK + a * C::KV_ATOM + off, 16, C::GROUP,
                                    C::SWZ);
      wgmma_ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax on the fragment; only tiles that meet the diagonal
    // or the ragged key tail need the mask
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > row_lo);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[4 * n + 2 * i + j] * scale;
          if (edge) {
            const int kpos = k0 + 8 * n + c2 + j;
            if (kpos >= sk || (causal && kpos > r0 + 8 * i)) x = NEG_INF;
          }
          s[4 * n + 2 * i + j] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2], mb[2];
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      live[i] = m_new > NEG_INF / 2;
      alpha[i] = m[i] > NEG_INF / 2 ? ex2((m[i] - m_new) * LOG2E) : 0.f;
      m[i] = m_new;
      mb[i] = m_new * LOG2E;
      l[i] *= alpha[i];
    }
    uint32_t pa[BK / 16][4];  // P as the A fragments of BK / 16 k-steps
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float p2[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = s[4 * n + 2 * i + j];
          p2[j] = live[i] ? ex2(fmaf(x, LOG2E, -mb[i])) : 0.f;
          l[i] += p2[j];  // l sums the unrounded p
        }
        // columns 8 n + c2 (+1) of row r0 + 8 i: register 2 (n % 2) + i of
        // k-step n / 2
        pa[n / 2][2 * (n % 2) + i] = pack_bf16(p2[0], p2[1]);
      }
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int n = 0; n < AW / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[a][4 * n + 2 * i] *= alpha[i];
          acc[a][4 * n + 2 * i + 1] *= alpha[i];
        }

    // O += P . V over the tile's keys in steps of 16 (16 rows of V)
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const uint64_t db = make_desc(
            sV + a * C::KV_ATOM + kk * 16 * C::ROWB, C::KV_ATOM, C::GROUP,
            C::SWZ);
        wgmma_rs_tb(acc[a], pa[kk], db);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pa);  // p stays live until the products that read it end
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const float l_row = quad_sum(l[i]);
    const float denom = fmaxf(l_row, 1e-30f);
    if (row >= sq) continue;
    if (lse != nullptr && c2 == 0)
      lse[((long long)b * hq + h) * sq + row] =
          l_row > 0.f ? m[i] + logf(l_row) : NEG_INF;
    bf16* dst = ob + (long long)row * os.s;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int n = 0; n < AW / 8; ++n) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(
            acc[a][4 * n + 2 * i] / denom, acc[a][4 * n + 2 * i + 1] / denom);
        *reinterpret_cast<__nv_bfloat162*>(dst + a * AW + 8 * n + c2) = pair;
      }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int sq, int sk, int hq, int hkv, Strides qs,
           Strides ks, Strides vs, Strides os, int causal,
           cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * hq, (sq + TQ - 1) / TQ);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_wgmma_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, sk, hq,
      hq / hkv, qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q: (batch, sq, hq, d); k, v: (batch, sk, hkv, d); o: like q. Strides are
// in elements, (batch, seq, head) for each tensor; d has unit stride.
// lse: null, or float32 (batch, hq, sq) contiguous, where each row's
// log-sum-exp of its scaled, masked scores (natural units) is written for
// the backward; a null lse leaves the kernels' work and o as they are.
// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (wgmma kernel; 16-byte
// aligned pointers and strides); d in {32, 64, 128}.
// Returns cudaGetLastError() after the launch (or the attribute's error).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int d, int batch, int sq, int sk, int hq, int hkv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, void* stream) {
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || sq <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0) return kInvalid;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (d) {
      case 32:
        return simt::launch<32>(q, k, v, o, lse, batch, sq, sk, hq, hkv, qs,
                                ks, vs, os, causal, st);
      case 64:
        return simt::launch<64>(q, k, v, o, lse, batch, sq, sk, hq, hkv, qs,
                                ks, vs, os, causal, st);
      case 128:
        return simt::launch<128>(q, k, v, o, lse, batch, sq, sk, hq, hkv,
                                 qs, ks, vs, os, causal, st);
    }
    return kInvalid;
  }
  if (dtype == 1) {
    if (!flash::aligned(q, qs) || !flash::aligned(k, ks)
        || !flash::aligned(v, vs) || !flash::aligned(o, os))
      return kInvalid;
    switch (d) {
      case 32:
        return tc::launch<32>(q, k, v, o, lse, batch, sq, sk, hq, hkv, qs,
                              ks, vs, os, causal, st);
      case 64:
        return tc::launch<64>(q, k, v, o, lse, batch, sq, sk, hq, hkv, qs,
                              ks, vs, os, causal, st);
      case 128:
        return tc::launch<128>(q, k, v, o, lse, batch, sq, sk, hq, hkv, qs,
                               ks, vs, os, causal, st);
    }
  }
  return kInvalid;
}
