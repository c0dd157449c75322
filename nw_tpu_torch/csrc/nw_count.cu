// Optimal-path counts from stored tie masks for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernel
//   K6 nw_tpu/ops/fill_pallas.py:703 _count_kernel (count_packed_pallas_batch,
//      :757, launched at :784)                              -> nw_count_masks
// and, on the card, nw_tpu's jnp nw_tpu/ops/pathcount.py:count_paths over
// the masks of K10 (fill_arrows_fold_batch).
//
// Semantics are those of nw_tpu/ops/pathcount.py: the origin has one
// path and every other cell the sum, mod 2^32, of the paths of the
// predecessors its tie mask names (bit0 diag, bit1 left, bit2 up).  Row 0
// and column 0 count one path each, as every fill of this package writes
// them (LEFT, UP); the count is read at each pair's true corner.
//
// Design.  One warp a pair, the sweep of nw_fill.cu's WITH_COUNTS path
// with the masks as its input instead of the score compares: the table's
// rows are cut into bands of 32, one row a lane; at step t lane jj counts
// cell (row j0+jj, column t-jj), the up count arriving from lane jj-1 by
// __shfl_up_sync, the diagonal one being the up count of the previous
// step, the left one the lane's own last count.  Lane 0 reads the row
// above the band from a per-pair uint32 boundary row in device memory,
// which lane 31 overwrites with the band's last row, 31 columns behind.
// The masks (uint8[B, Bs+1, A+1], row-major, nw_fill_masks_batch's and
// fill_arrows_fold_batch's layout) are staged 32 columns at a time into
// the warp's 32-row x 64-column byte ring in shared memory: one
// coalesced 32-byte load a row, then each lane reads its cell from the
// ring (column c in slot c % 64; the live columns of a chunk span 63).
//
// What bounds it on the H100: as the fill, the serial chain of each step
// (one shuffle, a shared-memory byte load and a few dependent integer
// ops) for one warp, so a batch is latency-bound with throughput from
// many pairs in flight; the masks are read once (1 byte a cell: 537 MB
// at 128 x 2 kb, ~0.16 ms of HBM time against a sweep of milliseconds).

#include <cstdint>
#include <cuda_runtime.h>

#include "nw_common.cuh"

namespace {

using nw::kFull;

constexpr int kRingCols = 64;

__global__ void __launch_bounds__(32) nw_count_masks_kernel(
    const unsigned char* __restrict__ masks, const int* __restrict__ lens1,
    const int* __restrict__ lens2, int A, int Bs, unsigned* __restrict__ cbnd,
    unsigned* __restrict__ counts) {
  __shared__ unsigned char ring[32 * kRingCols];
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int M = A + 1;
  const int nchunks = (M + 31 + 31) >> 5;  // 32-step chunks of one band
  const int nbands = (Bs + 31) >> 5;
  const unsigned char* pm = masks + b * (Bs + 1) * static_cast<int64_t>(M);
  unsigned* crow = cbnd + b * M;
  const int l1 = lens1[b];
  const int l2 = lens2[b];

  for (int c = lane; c < M; c += 32) crow[c] = 1u;  // row 0: one path
  if (l2 == 0 && lane == 0) counts[b] = 1u;  // the corner is on row 0
  __syncwarp();

  for (int band = 0; band < nbands; ++band) {
    const int j = band * 32 + 1 + lane;  // this lane's row
    const int rows = min(32, Bs - band * 32);
    const unsigned char* band_rows = pm + static_cast<int64_t>(band * 32 + 1) * M;
    unsigned cnt = 0, cup_prev = 0;  // own last count, last up count
    for (int t0 = 0; t0 < 32 * nchunks; t0 += 32) {
      // stage columns t0 .. t0+31 of the band's rows; lane x holds column
      // t0 + x of the row above until step t0 + x hands it to lane 0
      const int cx = t0 + lane;
      if (cx < M) {
        for (int r = 0; r < rows; ++r)
          ring[r * kRingCols + (cx & (kRingCols - 1))] = band_rows[static_cast<int64_t>(r) * M + cx];
      }
      const unsigned cbval = cx < M ? crow[cx] : 0u;
      __syncwarp();
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const int c = t0 + s - lane;
        unsigned cup = __shfl_up_sync(kFull, cnt, 1);
        const unsigned cb_up = __shfl_sync(kFull, cbval, s);
        cup = lane == 0 ? cb_up : cup;
        // a slot of c < 0, c > A or a row past Bs holds bytes no stored count reads
        const unsigned v = ring[lane * kRingCols + (c & (kRingCols - 1))];
        unsigned cn = ((v & 1u) ? cup_prev : 0u) + ((v & 2u) ? cnt : 0u) + ((v & 4u) ? cup : 0u);
        cn = c == 0 ? 1u : cn;  // column 0: one path
        const bool in_row = c >= 0 && c <= A;
        if (in_row && j == l2 && c == l1) counts[b] = cn;
        if (lane == 31 && in_row) crow[c] = cn;  // this band's last row, for the next band
        cup_prev = cup;
        cnt = cn;
      }
      __syncwarp();  // the chunk's ring reads precede the next chunk's staging
    }
    __syncwarp();  // the band's boundary row is complete before the next band reads it
  }
}

}  // namespace

// K6 port: uint32 counts[B] at each pair's true corner (lens1, lens2)
// from tie masks uint8[B, Bs+1, A+1]; cbnd is uint32[B, A+1] scratch.
extern "C" int nw_count_masks(const void* masks, const int* lens1,
                              const int* lens2, int B, int A, int Bs,
                              void* cbnd, void* counts, void* stream) {
  if (B <= 0) return 0;
  if (A < 0 || Bs < 0) return static_cast<int>(cudaErrorInvalidValue);
  nw_count_masks_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(masks), lens1, lens2, A, Bs,
      static_cast<unsigned*>(cbnd), static_cast<unsigned*>(counts));
  return static_cast<int>(cudaGetLastError());
}
