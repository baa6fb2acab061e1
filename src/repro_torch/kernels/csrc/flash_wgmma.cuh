// Hopper building blocks of the bf16 flash kernels, shared by the forward
// (flash_attention.cu) and the backward (flash_attention_bwd.cu).
//
// Tiles live in shared memory in bf16 in the swizzled layout the wgmma
// descriptors read: a tile of ROWS rows of D columns is NA column atoms of
// AW columns each, atom a at a * ROWS * ROWB bytes, row r of an atom at
// r * ROWB. Atoms are 64 columns (128 bytes, 128-byte swizzle) where 64
// divides D (one at D = 64, two at D = 128, three at D = 192, deepseek's
// MLA q/k head dim), else 32 columns (64 bytes, 64-byte swizzle: one at
// D = 32, three at D = 96, minicpm3's MLA q/k head dim).
// Every tile starts on the 1024-byte swizzle repeat, and every atom on its
// mode's repeat (512 bytes at 64-byte swizzle). Tiles arrive by 16-byte
// cp.async copies, zero-filled past the sequence's end. A kernel whose q/k
// and v head dims differ keeps each tile in its own dim's layout.
//
// The two product forms, both wgmma.mma_async bf16 -> f32 (inline PTX):
//   wgmma_ss (m64n64k16): A and B both from shared memory, K-major: A's
//     64 rows and B's 64 rows each hold the K dimension along their
//     columns, so C = A . B^T of two tiles read row-wise.
//   wgmma_rs_tb (m64n32k16, m64n64k16): A from registers, B from shared
//     memory through the transpose bit (MN-major): B's K dimension runs
//     along the tile's rows, so C += A . B of a tile read column-wise, one
//     instruction a column atom (N = 96 is three m64n32k16, N = 192 three
//     m64n64k16).
// The f32 accumulator fragment of a product (thread t of the warpgroup
// holds rows 16 w + t/4 + {0, 8}, columns 8 n + 2 (t%4) + {0, 1}, w the
// warp) rounded to bf16 pairs is the A fragment of m64nXk16 as it stands:
// pair (column 8 n + 2 (t%4), row + 8 i) is register 2 (n % 2) + i of
// k-step n / 2. So a probability tile never goes through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // element strides of a (B, S, H, D) tensor, D contiguous
  long long b, s, h;
};

// the swizzled layout of a bf16 tile with rows of D columns
template <int D>
struct Swz {
  static constexpr int AW = D % 64 == 0 ? 64 : 32;  // columns per atom
  static constexpr int NA = D / AW;                 // atoms per row of D
  static constexpr int ROWB = 2 * AW;               // bytes per atom row
  static constexpr int SWZ = ROWB == 128 ? 1 : 2;   // descriptor: 128B, 64B
  static constexpr int GROUP = 8 * ROWB;            // 8 rows: the SBO
  static_assert(D % 32 == 0 && (D <= 128 || D == 192),
                "D in {32, 64, 96, 128, 192}");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk c of row r in a tile whose atoms are
// atom_bytes apart: the swizzle XORs the chunk index with address bits 7-9
// (128B) or 7-8 (64B), as the descriptor's swizzle mode reads it.
template <int D>
__device__ __forceinline__ uint32_t swz_off(int r, int c, int atom_bytes) {
  using C = Swz<D>;
  constexpr int CPA = C::AW / 8;  // chunks per atom row
  const int x = C::ROWB == 128 ? (r & 7) : ((r >> 1) & 3);
  return (c / CPA) * atom_bytes + r * C::ROWB + (((c % CPA) ^ x) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// rows [row0, row0 + ROWS) of a (S, D) view with row stride `stride`,
// zero-filled at and past `lim`, into a swizzled tile at `dst`, by the
// NT threads of the CTA
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long stride, int row0,
                                          int lim, int atom_bytes) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * CPR) % NT == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int e = threadIdx.x + i * NT, r = e / CPR, c = e % CPR;
    const bool in = row0 + r < lim;
    const bf16* g = in ? src + (long long)(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + swz_off<D>(r, c, atom_bytes), g, in);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes (cp.async) made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets
// (16-byte units) and the swizzle mode (1 = 128B, 2 = 64B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of a wgmma operand held in
// registers (accumulator or A fragment) across the asynchronous window
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (rel. error ~2^-22; subnormal results
// flush to zero, which no bf16 p or float32 l can tell apart)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// d (+)= A . B, m64n64k16, A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A . B, m64n32k16, A from registers, B from shared memory read
// through the transpose bit (MN-major).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A . B, m64n64k16, A from registers, B from shared memory read
// through the transpose bit (MN-major).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 16-byte copies: every base address and (b, s, h) stride 16-byte aligned
inline bool aligned(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0
         && st.s % 8 == 0 && st.h % 8 == 0;
}

}  // namespace flash
