// Block-sparse SpMM over the segment_mm format, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/segment_mm/kernel.py::block_spmm_kernel
// (body _spmm_kernel). For every dense adjacency block b:
//
//     Y[rows[b]*128 : +128, :] += blocks[b] @ X[cols[b]*128 : +128, :]
//
// The blocks are sorted by destination row-block, so the blocks of one row
// form a contiguous run [rowptr[r], rowptr[r+1]). The TPU kernel walks the
// runs in grid order and flushes a VMEM accumulator when the row changes;
// here the grid's blocks run in parallel, so each CTA owns one output tile
// outright: (row-block r, a slice of ROWS destination rows, an F-tile of
// FT columns). It walks its row's run in order, accumulating in fp32
// registers, and writes its tile once. A row with no blocks writes zeros.
// There are no atomics, so the summation order is fixed and two launches
// give bit-identical output.
//
// Bound: bytes. The function reads nb*64 KB of dense blocks, and its
// nonzeros (about 0.4% of the blocks on the SAGE main path) need only
// 2*nnz*F operations. This kernel, though, executes the dense products,
// nb*128*128*F*2 fp32 operations, which at F = 64 take longer than the
// bytes: it runs far above its bound, on the FMA pipes. The design keeps
// each operand in shared memory once per block (the block's ROWS x 128
// slice, and the 128 x FT tile of X), reads both as 16-byte vectors and
// has each thread accumulate a 2 x 4 register tile, so the FMA pipes and
// not shared memory set the pace; ROWS-row slices give 8 CTAs per
// row-block and F-tile, enough to spread layer 0 (16 row-blocks) over
// the card. Skipping the zeros (CSR, or wgmma over the nonzero blocks)
// is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;       // TN = TM of the block format
constexpr int ROWS = 16;        // destination rows per CTA
constexpr int APAD = 4;         // keeps 16-byte alignment, spreads banks

template <int FT>
__global__ void __launch_bounds__(2 * FT)
block_spmm_kernel(const int* __restrict__ rowptr,
                  const int* __restrict__ cols,
                  const float* __restrict__ blocks,
                  const float* __restrict__ x,
                  float* __restrict__ y,
                  int f) {
  constexpr int TX = FT / 4;              // threads along F, 4 columns each
  constexpr int NT = 2 * FT;              // threads: TX * (ROWS / 2)
  __shared__ __align__(16) float As[ROWS][TILE + APAD];
  __shared__ __align__(16) float Xs[TILE][FT];

  const int r = blockIdx.x / (TILE / ROWS);
  const int slice = blockIdx.x % (TILE / ROWS);
  const int f0 = blockIdx.y * FT;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;                // rows 2*ty, 2*ty + 1 of the slice

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  const int b_end = rowptr[r + 1];
  for (int b = rowptr[r]; b < b_end; ++b) {
    const float* a_src =
        blocks + ((size_t)b * TILE + (size_t)slice * ROWS) * TILE;
    const float* x_src = x + (size_t)cols[b] * TILE * f;
    __syncthreads();                      // previous block's reads are done
    for (int i = tid; i < ROWS * TILE / 4; i += NT) {
      const int row = i / (TILE / 4), c4 = i % (TILE / 4);
      *reinterpret_cast<float4*>(&As[row][c4 * 4]) =
          __ldg(reinterpret_cast<const float4*>(a_src + row * TILE) + c4);
    }
    for (int i = tid; i < TILE * TX; i += NT) {
      const int k = i / TX, c = (i % TX) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (f0 + c < f) {
        v = __ldg(reinterpret_cast<const float4*>(x_src + (size_t)k * f +
                                                  f0 + c));
      }
      *reinterpret_cast<float4*>(&Xs[k][c]) = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < TILE; k += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[2 * ty][k]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[2 * ty + 1][k]);
      const float av0[4] = {a0.x, a0.y, a0.z, a0.w};
      const float av1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[k + q][tx * 4]);
        acc[0][0] += av0[q] * xv.x;
        acc[0][1] += av0[q] * xv.y;
        acc[0][2] += av0[q] * xv.z;
        acc[0][3] += av0[q] * xv.w;
        acc[1][0] += av1[q] * xv.x;
        acc[1][1] += av1[q] * xv.y;
        acc[1][2] += av1[q] * xv.z;
        acc[1][3] += av1[q] * xv.w;
      }
    }
  }

  const int col = f0 + tx * 4;
  if (col < f) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t row = (size_t)r * TILE + slice * ROWS + 2 * ty + i;
      *reinterpret_cast<float4*>(y + row * f + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <int FT>
void launch(const int* rowptr, const int* cols, const float* blocks,
            const float* x, float* y, int n_dst_blocks, int f,
            cudaStream_t stream) {
  const dim3 grid(n_dst_blocks * (TILE / ROWS), (f + FT - 1) / FT);
  block_spmm_kernel<FT><<<grid, 2 * FT, 0, stream>>>(rowptr, cols, blocks,
                                                      x, y, f);
}

}  // namespace

// rowptr: (n_dst_blocks + 1,) int32, cols: (nb,) int32,
// blocks: (nb, 128, 128) f32, x: (M, f) f32 with M % 128 == 0,
// y: (n_dst_blocks * 128, f) f32. f % 4 == 0; all pointers 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int block_spmm_f32(const void* rowptr, const void* cols,
                              const void* blocks, const void* x, void* y,
                              int n_dst_blocks, int f, void* stream) {
  if (n_dst_blocks > 0 && f > 0) {
    const auto* rp = static_cast<const int*>(rowptr);
    const auto* cl = static_cast<const int*>(cols);
    const auto* bl = static_cast<const float*>(blocks);
    const auto* xs = static_cast<const float*>(x);
    auto* ys = static_cast<float*>(y);
    auto s = static_cast<cudaStream_t>(stream);
    if (f <= 16) {
      launch<16>(rp, cl, bl, xs, ys, n_dst_blocks, f, s);
    } else if (f <= 32) {
      launch<32>(rp, cl, bl, xs, ys, n_dst_blocks, f, s);
    } else {
      launch<64>(rp, cl, bl, xs, ys, n_dst_blocks, f, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
