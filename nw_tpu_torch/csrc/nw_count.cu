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
// The band sweep.  The table's rows are cut into bands of 32, one row a
// lane; at step t lane jj counts cell (row j0+jj, column t-jj), the up
// count arriving from lane jj-1 by __shfl_up_sync, the diagonal one being
// the up count of the previous step, the left one the lane's own last
// count.  The masks (uint8[B, Bs+1, A+1], row-major, nw_fill_masks_batch's
// and fill_arrows_fold_batch's layout) are staged 32 columns at a time
// into the warp's 32-row x 64-column byte ring in shared memory: one
// coalesced 32-byte load a row, then each lane reads its cell from the
// ring (column c in slot c % 64; the live columns of a chunk span 63).
// The chunk's loads are issued before the warp waits for the row above,
// so their latency overlaps the wait.
//
// The pipeline: a pipeline of its own, with the handoff of nw_fill.cu's
// nw_fill_pipe_kernel (its header, "The pipeline") and a uint32 count a
// cell where the fill hands on a score (or an int2).  A block of W warps
// (1 <= W <= 32, the rule nw_tpu_torch/ops/pathcount.py:count_warps) owns
// one pair, and band b runs on warp b % W, each band at least two chunks
// behind the band above it.  Dynamic shared memory (count_smem) holds the
// W byte rings, then W rings of kSlots 32-column chunk slots (a count a
// column: the band's last row, written by lane 31 and read by the next
// warp's lane 0, chunk g of a warp, counted over all its bands, in slot
// g % kSlots), warp 0's staged row above, and done[w], the chunks warp w
// has completed over its bands.  Before chunk g warp w+1 waits for
// done[w] >= g+2 (capped at the band's end) and warp w for done[w+1] >=
// g-kSlots+1 (its slots have been read).  The wrap-around, band b on warp
// W-1 to band b+1 on warp 0, goes through the per-pair boundary row in
// device memory (cbnd, uint32[A+1], row 0's ones at the start): warp W-1
// copies each finished chunk of its ring there and warp 0, once done[W-1]
// says the chunk is in, stages 32 columns of it in shared memory, one
// coalesced load.  Block-scope fences order data and counters on both
// sides.  The pipeline's arguments carry over unchanged: no chain of
// waits closes (warp W-1 never waits for a reader), a slot or a column
// of cbnd is rewritten only after its reader took it, and with W = 1
// warp 0 reads cbnd a chunk ahead of rewriting it in place.  No launch
// waits on another block.
//
// What bounds it on the H100: the serial chain of each step (one shuffle,
// a shared-memory byte load and a few dependent integer ops, ~75 ns a
// band step for one warp alone, PERF.md section 7).  With one warp a
// pair a batch of few long pairs put a few warps on the card (4 x 10 kb:
// 4 warps); with W warps a pair ~32 warps an SM interleave and the SM's
// issue slots and its shared-memory pipe bound it.  The masks are read
// once (1 byte a cell: 537 MB at 128 x 2 kb, ~0.16 ms of HBM time).

#include <cstdint>
#include <cuda_runtime.h>

#include "nw_common.cuh"

namespace {

using nw::kFull;

constexpr int kMaxWarps = 32;                // warps a block
constexpr int kRingCols = 64;                // columns of a warp's byte ring
constexpr int kMaskBytes = 32 * kRingCols;   // a warp's byte ring
constexpr int kSlots = 4;                    // 32-column chunk slots of a warp's count ring
constexpr int kRing = 32 * kSlots;           // words of a warp's count ring

// Dynamic shared memory of a block, in bytes: the W byte rings, the W
// count rings, warp 0's staged row above and done[W]
// (nw_tpu_torch/ops/pathcount.py:count_smem computes the same).
__host__ __device__ inline int count_smem(int warps) {
  return warps * kMaskBytes + 4 * (warps * kRing + 32 + warps);
}

__global__ void __launch_bounds__(32 * kMaxWarps, 1) nw_count_masks_kernel(
    const unsigned char* __restrict__ masks, const int* __restrict__ lens1,
    const int* __restrict__ lens2, int A, int Bs, unsigned* __restrict__ cbnd,
    unsigned* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char count_sh[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int64_t b = blockIdx.x;
  const int M = A + 1;
  const int nchunks = (M + 31 + 31) >> 5;  // 32-step chunks of one band
  const int nbands = (Bs + 31) >> 5;
  unsigned char* const mring = count_sh + warp * kMaskBytes;
  unsigned* const rings = reinterpret_cast<unsigned*>(count_sh + W * kMaskBytes);
  unsigned* const stage = rings + W * kRing;
  volatile int* done = reinterpret_cast<volatile int*>(stage + 32);
  const unsigned char* pm = masks + b * (Bs + 1) * static_cast<int64_t>(M);
  unsigned* crow = cbnd + b * M;
  const int l1 = lens1[b];
  const int l2 = lens2[b];

  for (int c = threadIdx.x; c < M; c += blockDim.x) crow[c] = 1u;  // row 0: one path
  if (threadIdx.x < W) done[threadIdx.x] = 0;
  if (l2 == 0 && threadIdx.x == 0) counts[b] = 1u;  // the corner is on row 0
  __syncthreads();

  const bool last_warp = warp == W - 1;
  unsigned* const out_ring = rings + warp * kRing;
  // the row above: the previous warp's ring, or (warp 0) the staged chunk
  const unsigned* const in_ring = warp > 0 ? rings + (warp - 1) * kRing : stage;
  const int in_warp = warp > 0 ? warp - 1 : W - 1;
  for (int band = warp, round = 0; band < nbands; band += W, ++round) {
    const int j = band * 32 + 1 + lane;  // this lane's row
    const int rows = min(32, Bs - band * 32);
    const unsigned char* band_rows = pm + static_cast<int64_t>(band * 32 + 1) * M;
    const bool feeds = band + 1 < nbands;  // a band below reads this one's last row
    const bool to_ring = feeds && !last_warp;  // ... from this warp's ring
    // warp 0 reads warp W-1's band of the round before (none in round 0:
    // the boundary row holds row 0)
    const int in_base = (warp > 0 ? round : round - 1) * nchunks;
    unsigned cnt = 0, cup_prev = 0;  // own last count, last up count

    for (int q = 0; q < nchunks; ++q) {
      const int g = round * nchunks + q;  // chunks of this warp before this one
      const int t0 = q << 5;
      const int cx = t0 + lane;
      // stage columns t0 .. t0+31 of the band's rows (the previous chunk's
      // reads of these slots ended at its __syncwarp)
      if (cx < M) {
        for (int r = 0; r < rows; ++r)
          mring[r * kRingCols + (cx & (kRingCols - 1))] = band_rows[static_cast<int64_t>(r) * M + cx];
      }
      // the row above's columns t0 .. t0+31 are in (the band above has
      // completed chunk q+1), and this chunk's slots have been read
      const int need_in = in_base + min(q + 2, nchunks);
      const int need_out = g - kSlots + 1;
      while (done[in_warp] < need_in || (to_ring && done[warp + 1] < need_out)) {
      }
      __threadfence_block();
      const unsigned* above = in_ring + (g & (kSlots - 1)) * 32;
      if (warp == 0) {  // stage the chunk of the boundary row
        stage[lane] = cx < M ? crow[cx] : 0u;
        above = stage;
      }
      __syncwarp();  // the byte ring and the staged row are in
      // lane 31 writes columns t0-31 .. t0-1 (steps 0..30, none in chunk 0)
      // into slot g-1 at 1..31 and column t0 (step 31) into slot g at 0
      unsigned* const out_lo = out_ring + ((g - 1) & (kSlots - 1)) * 32 + 1;
      unsigned* const out_hi = out_ring + (g & (kSlots - 1)) * 32;
      const bool pub_hi = lane == 31 && feeds;
      const bool pub_lo = pub_hi && q > 0;
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const int c = t0 + s - lane;
        unsigned cup = __shfl_up_sync(kFull, cnt, 1);
        const unsigned a = above[s];
        cup = lane == 0 ? a : cup;
        // a slot of c < 0, c > A or a row past Bs holds bytes no stored count reads
        const unsigned v = mring[lane * kRingCols + (c & (kRingCols - 1))];
        unsigned cn = ((v & 1u) ? cup_prev : 0u) + ((v & 2u) ? cnt : 0u) + ((v & 4u) ? cup : 0u);
        cn = c == 0 ? 1u : cn;  // column 0: one path
        if (c >= 0 && c <= A && j == l2 && c == l1) counts[b] = cn;
        if (s < 31 ? pub_lo : pub_hi) (s < 31 ? out_lo[s] : out_hi[0]) = cn;
        cup_prev = cup;
        cnt = cn;
      }
      __syncwarp();  // the chunk's ring writes are in, its byte reads done
      if (last_warp && feeds) {  // columns t0-31 .. t0 into the boundary row
        const int col = t0 - 31 + lane;
        if (col >= 0 && col < M) crow[col] = lane < 31 ? out_lo[lane] : out_hi[0];
      }
      __threadfence_block();  // the chunk's reads and writes precede its count
      __syncwarp();
      if (lane == 0) done[warp] = g + 1;
    }
  }
}

}  // namespace

// K6 port: uint32 counts[B] at each pair's true corner (lens1, lens2)
// from tie masks uint8[B, Bs+1, A+1], W = warps a pair; cbnd is
// uint32[B, A+1] scratch.
extern "C" int nw_count_masks(const void* masks, const int* lens1,
                              const int* lens2, int B, int A, int Bs, int warps,
                              void* cbnd, void* counts, void* stream) {
  if (B <= 0) return 0;
  if (A < 0 || Bs < 0 || warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = count_smem(warps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_count_masks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nw_count_masks_kernel<<<B, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(masks), lens1, lens2, A, Bs,
      static_cast<unsigned*>(cbnd), static_cast<unsigned*>(counts));
  return static_cast<int>(cudaGetLastError());
}
