// Shared helpers of the package's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

namespace nw {

constexpr unsigned kFull = 0xffffffffu;

// two's-complement wrapping int32 arithmetic (signed overflow is
// undefined in C++; the reference fill wraps)
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// ---------------- the W-warp pipeline's protocol ----------------
// (nw_fill.cu's header describes it; nw_fill.cu's pipe_fill, nw_single.cu's
// single-pair fill across a grid and nw_affine.cu's Gotoh fill run it)

constexpr int kMaxWarps = 32;  // warps a block of the pipeline
constexpr int kSlots = 4;      // 32-column chunk slots of a warp's ring
constexpr int kRing = 32 * kSlots;
constexpr int kTopPad = -4;    // the staged top outside columns 1..A
constexpr int kSidePad = -5;   // a side row past Bs

// a compile-time flag, for a lambda's variants of a chunk
template <bool B> struct Flag { static constexpr bool value = B; };

// A column of a Needleman-Wunsch handoff row: its score, and with counts
// its count (bits of a uint32) beside it, one 64-bit access.
template <bool WITH_COUNTS> struct Cell { using type = int; };
template <> struct Cell<true> { using type = int2; };

// The staged top string's columns: 32*nchunks + 32.
__host__ __device__ inline int pipe_top_cols(int A) {
  return 32 * ((A + 1 + 31 + 31) >> 5) + 32;
}

// Dynamic shared memory of a pipeline block, in bytes: the W rings and
// warp 0's staged row above (cell_bytes a column), done[W], and
// (top_smem) the int16 top string.
// (nw_tpu_torch/ops/fill_banded.py:fill_smem computes the same.)
__host__ __device__ inline int pipe_smem(int warps, int A, int cell_bytes, bool top_smem) {
  return 4 * warps + cell_bytes * (warps * kRing + 32) + (top_smem ? 2 * pipe_top_cols(A) : 0);
}

// The pair's top string as int16, column c at c+31 (kTopPad outside
// 1..A), by every thread of the block.
__device__ __forceinline__ void pipe_stage_top(short* top_s, const int* top, int A) {
  for (int x = threadIdx.x; x < pipe_top_cols(A); x += blockDim.x) {
    const int c = x - 31;
    top_s[x] = static_cast<short>(c >= 1 && c <= A ? top[c - 1] : kTopPad);
  }
}

// Before a chunk: wait until warp in_warp has completed need_in chunks
// (the row above's columns are in) and, when the warp feeds a ring,
// warp out_warp need_out (the slots it overwrites have been read).
__device__ __forceinline__ void pipe_wait(volatile int* done, int in_warp, int need_in,
                                          bool to_ring, int out_warp, int need_out) {
  while (done[in_warp] < need_in || (to_ring && done[out_warp] < need_out)) {
  }
  __threadfence_block();
}

// After a chunk: its reads and writes precede its count, g + 1.
__device__ __forceinline__ void pipe_post(volatile int* done, int warp, int lane, int g) {
  __threadfence_block();
  __syncwarp();
  if (lane == 0) done[warp] = g + 1;
}

}  // namespace nw
