// Single-pair Needleman-Wunsch fills for Hopper (sm_90a): the warps of
// one cooperative grid sweep ONE pair together.
//
// Replaces six TPU (Pallas) kernels, as modes of one template:
//   K8  nw_tpu/ops/fill_pallas_single.py:250 _make_score_count_kernel
//       (score_count_fold)                                 -> nw_score_count
//   K2  nw_tpu/ops/fill_pallas_banded.py:342 _make_banded_arrows_kernel
//       in its pack_bits=8 tie-mask mode for one pair (build_arrows_call,
//       fill_arrows_banded_single)                         -> nw_fill_masks
//   K14 nw_tpu/parallel/huge_pair.py:246 _make_fold_chunk_kernel_blocked
//       (config-5 fill with 2-bit walk words and the corner capture)
//                                                          -> nw_fill_codes_single
//       and its mesh half (one device's chunk: halo in, last-row edge
//       out, the corner; scores or 2-bit codes)              -> nw_fill_tile
//   K28 nw_tpu/parallel/huge_pair.py:70 _make_fold_chunk_kernel (the same
//       chunk with 8-bit packed tie masks)                 -> nw_fill_tile
//                                                             masks mode
//   K13 nw_tpu/ops/checkpoint_traceback.py:153 _make_refill_kernel
//       (re-fill of one block from its checkpoint)         -> nw_fill_codes_single
//                                                             with a seed row
//   K11 nw_tpu/ops/fill_strips.py:62 _make_strips_kernel
//       (strips_score: one huge pair's score)              -> nw_score_single
//   K12 nw_tpu/ops/checkpoint_traceback.py:61 _make_ckpt_kernel
//       (fill dumping its state every C diagonals)         -> nw_score_single
//                                                             with ckpt
//   K9  nw_tpu/ops/fill_pallas_single.py:83 _make_kernel
//       (last_row_pallas: one pair's row H[len2, 0..A], for
//       Hirschberg)                                        -> nw_last_row
//   K10 nw_tpu/ops/fill_pallas_single.py:422 _make_arrows_kernel
//       (fill_arrows_fold_batch: the tie masks of a batch of long pairs,
//       one pair at a time)                                -> nw_fill_masks,
//                                                             a pair at a time
//
// Semantics are those of nw_tpu/ops/fill_scan.py:24-28, 118-163 on the
// pair's exact (len2+1) x (len1+1) table, with row 0 (-c*d, LEFT, one
// path) and column 0 (-j*d, UP, one path) written explicitly: the result
// does not rest on the TPU kernels' NEG_INF decay
// (fill_pallas_single.py:277-284) and holds for every scoring.  Scores
// wrap as int32, counts as uint32.  The 0 x 0 pair gives score 0, count 1.
//
// Design.  The side string's rows are cut into bands of 32 rows, one row
// per lane; a warp sweeps its band as nw_fill.cu does (the up neighbour
// by __shfl_up_sync, the diagonal one the up value of the previous step,
// lane 0 fed the row above the band 32 columns at a time).  G blocks of
// W warps own the pair, P = G*W warps in all: global warp g = block*W +
// warp takes bands g, g+P, g+2P, ..., so up to P bands are in flight as a
// pipelined wavefront over the card, each one two 32-column chunks behind
// the band above it (consecutive bands share a block, W at a time).  Band
// b reads band b-1's last row (score and count) from a ring of P
// boundary rows in global memory (slot (b-1)%P) and writes its own into
// slot b%P, through L2 only (__ldcg / __stcg: another SM's L1 may hold a
// stale line).  After every chunk each warp publishes the number of
// chunks it has completed, over all its bands, in a global counter
// (monotonic, so a reader never sees a later band's reset); the next
// band's warp spins on it before it loads a chunk (gpu-scope fence after
// the data and before the flag, and after the flag and before the data).
// The launch is cooperative, so every block is co-resident and no spin
// can wait on a block that never runs.  Reusing slot b%P is safe: band
// b+P writes column c only after band b+P-1 has published past c, which
// by the same rule needs band b+1 to have loaded column c.  With one warp
// in all the ring is one row, read and written in place as nw_fill.cu
// does.
//
// nw_fill_masks also stores each cell's 3-bit tie mask (bit0 diag, bit1
// left, bit2 up; row 0 LEFT, column 0 UP, origin 0) into a rectangular
// row-major uint8[len2+1, len1+1] and, when asked, its int32 score into
// an int32 table of the same shape.  The masks' rows may be wider than the
// pair (a row stride ldm >= len1+1): K10's port writes each pair of a
// batch into its slice of one uint8[B, Bs+1, A+1] table.  The 32 lanes of a warp hold 32
// different rows, so a per-step store of a mask is 32 transactions,
// which made the masks cost ~6x the fill on the H100 (PERF.md, section
// 6).  So each lane writes
// its mask into the warp's 32-row x 64-column byte ring in shared memory
// (column c in slot c % 64; at any time the live columns span 63), and
// after every 32-step chunk the warp stores the 32 columns that every
// lane has finished, row by row: 32 lanes on 32 consecutive bytes, one
// coalesced store a row.  Scores (only for -t tables) keep the per-lane
// store.
//
// nw_fill_codes_single stores each cell's 2-bit greedy code (0 diag,
// 1 left, 2 up, by diag > left > up) in nw_fill.cu's band-major layout:
// a lane packs 16 steps into a word and after the step with
// (t & 15) == 15 the 32 lanes store their words together at
// [band, t >> 4, lane], one coalesced 128-byte store per 16 steps, so the
// tensor is bit-equal to nw_fill_codes's for the same pair, every word
// written (cells outside the table 0).  Given a seed row (row r0 of the
// pair, scores only) it fills rows r0+1 .. r0+Bs instead: band 0 reads
// its row above from the seed, column 0 stays -j*d with the global j.
// nw_score_single is the score pipeline without counts; given ckpt it
// also writes row r*C (lane 31 of a band, every column) into ckpt[r],
// row 0 included, through the ring's __stcg path.  nw_last_row (its
// LAST_ROW mode, K9) writes row Bs, whatever Bs, into an int32[A+1] row:
// the lane of row Bs stores each of its cells (row 0's -c*d when Bs is
// 0), column 0 explicit as everywhere, so the row follows fill_scan at
// every scoring (K9 rests on the NEG_INF decay).
//
// nw_fill_tile (TILE) fills one tile of a pair whose rows are sharded
// over ranks (nw_tpu_torch/parallel/huge_pair.py): rows r0+1 .. r0+Bs and
// columns c0+1 .. c0+C.  It is the same pipeline with the tile as its
// table: band 0 reads the top halo (row r0 at columns c0 .. c0+C, the
// corner first) as its seed, column 0 of the tile is the left edge input
// (column c0 at rows r0+1 .. r0+Bs) instead of -j*d, and it writes the
// right edge (column c0+C) and the bottom edge (row r0+Bs at columns
// c0+1 .. c0+C) for the next tile and the next rank, and its bottom-right
// cell as the score.  Its codes go into the rank's code table of the full
// width (the layout above, global step c0 + c + lane): a tile boundary
// cuts words, so a tile ORs its bits into the (zeroed) table's words
// that it shares with the tile on its left or right (the tiles of a rank
// run in order on one stream) and stores the others whole.  Its masks go into a
// row-major uint8[Bs, width+1] table of the rank's rows.  The tile with
// c0 = 0 also stores column 0 (UP); no tile stores row r0.
//
// What bounds it on the H100: the serial chain of each step (one shuffle
// and a few dependent integer ops, ~70-110 cycles for one warp alone,
// PERF.md section 6); with W warps interleaving on an SM the step's
// issued instructions (~40-50 a step for a warp, four schedulers) become
// the SM's bound, and across SMs the wavefront's critical path (two
// chunks a band, plus one band's sweep) bounds the pair.  The codes mode
// adds one coalesced 128-byte store a warp per 16 steps (2.5 GB for a
// 100 000 bp pair, ~2 ms over the score-only mode on an H100 80GB HBM3 at
// 700 W, PERF.md section 6); a checkpointed re-fill of a block of C rows
// has only C/32 bands, so it runs on few warps and its band's sweep
// (A+32 steps) is its critical path.

#include <cstdint>
#include <cuda_runtime.h>

#include "nw_common.cuh"

namespace {

using nw::kFull;
using nw::wadd;
using nw::wmul;
using nw::wsub;

constexpr int kMaxWarps = 32;
constexpr unsigned kMaskDiag = 1u;
constexpr unsigned kMaskLeft = 2u;
constexpr unsigned kMaskUp = 4u;

constexpr int kRingCols = 64;  // columns of a warp's mask ring
constexpr int kTileBytes = 32 * kRingCols;

constexpr unsigned kCodeLeft = 1u;
constexpr unsigned kCodeUp = 2u;

// The edges of a TILE launch (unused otherwise).
struct Tile {
  const int* left;  // int32[Bs]: column c0 at rows r0+1 .. r0+Bs
  int* right;       // int32[Bs]: column c0+C
  int* bottom;      // int32[C]: row r0+Bs at columns c0+1 .. c0+C
  int c0;           // first column of the tile's left edge
  int width;        // A of the whole pair: the code / mask tables' width
};

// What a launch writes besides its ring (null where the mode has none).
struct Outs {
  unsigned char* masks;  // uint8[Bs+1, A+1]
  int* hs;               // int32[Bs+1, A+1]
  unsigned* codes;       // uint32[nbands, TW, 32]
  int* ckpt;             // int32[ceil(Bs/every), A+1]
  int every;             // rows between two checkpoint rows
  int* score;
  unsigned* count;
  int* last;             // int32[A+1]: row Bs (LAST_ROW)
  int ldm;               // the masks' row stride (0: A+1)
};

template <bool WITH_COUNTS, bool EMIT_MASKS, bool EMIT_SCORES, bool EMIT_CODES,
          bool TILE = false>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) nw_single_kernel(
    const int* __restrict__ top, const int* __restrict__ side, int A, int Bs,
    int r0, const int* __restrict__ seed, int m, int k, int d, int* ring,
    unsigned* cring, int* done, Outs out, Tile tile) {
  static_assert(!TILE || (!WITH_COUNTS && !EMIT_SCORES), "a tile has no counts");
  // with TILE, A and top are the tile's (C columns from top + c0), seed
  // is the top halo; c0 and the tables' width come from tile
  extern __shared__ unsigned char rings[];  // EMIT_MASKS: one ring a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* mring = rings + warp * kTileBytes;
  const int W = blockDim.x >> 5;
  const int P = gridDim.x * W;  // warps in all
  const int gwarp = blockIdx.x * W + warp;
  const int M = A + 1;
  const int nchunks = (M + 31 + 31) >> 5;  // 32-step chunks of one band
  const int c0 = TILE ? tile.c0 : 0;
  const int Mw = TILE ? tile.width + 1 : M;  // the tables' row of columns
  const int ldm = TILE ? Mw : (out.ldm ? out.ldm : M);  // the masks' row stride
  const int TW = 2 * ((Mw + 31 + 31) >> 5);  // code words of a band row
  const int cmin = c0 > 0 ? 1 : 0;  // a tile's column 0 is the last tile's
  const int nbands = (Bs + 31) >> 5;
  volatile int* vdone = done;  // chunks completed, per global warp (zeroed)
  unsigned char* __restrict__ masks = out.masks;
  int* __restrict__ hs = out.hs;

  const int gthread = blockIdx.x * blockDim.x + threadIdx.x;
  for (int c = gthread; !TILE && c < M; c += gridDim.x * blockDim.x) {  // row 0
    if (EMIT_MASKS) masks[c] = c == 0 ? 0 : kMaskLeft;
    if (EMIT_SCORES) hs[c] = wsub(0, wmul(c, d));
    if (out.ckpt && Bs > 0) __stcg(out.ckpt + c, wsub(0, wmul(c, d)));
    if (out.last && Bs == 0) out.last[c] = wsub(0, wmul(c, d));
  }
  if (!TILE && Bs == 0 && gthread == 0) {  // the corner is on the row above
    *out.score = seed ? seed[A] : wsub(0, wmul(A, d));
    if (WITH_COUNTS) *out.count = 1u;
  }

  const int negk = wsub(0, k);
  const int prev_warp = (gwarp + P - 1) % P;
  for (int band = gwarp, round = 0; band < nbands; band += P, ++round) {
    const int j = band * 32 + 1 + lane;  // this lane's row in the launch
    const bool row_ok = j <= Bs;
    const int sch = row_ok ? side[j - 1] : -5;
    // H[r0+j][0], or a tile's left edge
    const int col0 = TILE ? (row_ok ? tile.left[j - 1] : 0) : wsub(0, wmul(r0 + j, d));
    const int64_t rowoff = static_cast<int64_t>(j) * M;
    const int64_t in_slot = static_cast<int64_t>((band + P - 1) % P) * M;
    const int64_t out_slot = static_cast<int64_t>(band % P) * M;
    // band-1's warp has completed this many chunks before band-1 began
    const int pred_base = band > 0 ? ((band - 1) / P) * nchunks : 0;
    unsigned* wbase = EMIT_CODES
        ? out.codes + static_cast<int64_t>(band) * TW * 32 + lane : nullptr;
    // rows r*C (C = out.every) below the last go to ckpt[r]
    const bool dump = out.ckpt && lane == 31 && j < Bs && j % out.every == 0;
    int* dump_row = dump ? out.ckpt + static_cast<int64_t>(j / out.every) * M : nullptr;
    int* const last = !TILE && out.last && j == Bs ? out.last : nullptr;  // row Bs's lane
    int h = 0, up_prev = 0, ch = -4;  // own last value, last up, top char
    unsigned cnt = 0, cup_prev = 0, pack = 0;

    for (int q = 0; q < nchunks; ++q) {
      const int t0 = q << 5;
      const int cx = t0 + lane;
      int bval;
      unsigned cbval = 0u;
      if (band == 0) {  // the row above is row 0 (-c*d, one path) or the seed
        bval = seed ? (cx < M ? seed[cx] : 0) : wsub(0, wmul(cx, d));
        cbval = 1u;
      } else {
        // columns t0 .. t0+31 of band-1's last row are written once
        // band-1 has completed chunk q+1 (lane 31 trails lane 0 by 31)
        const int target = pred_base + min(q + 2, nchunks);
        while (vdone[prev_warp] < target) {
        }
        __threadfence();
        bval = cx < M ? __ldcg(ring + in_slot + cx) : 0;
        if (WITH_COUNTS) cbval = cx < M ? __ldcg(cring + in_slot + cx) : 0u;
      }
      const int tval = (cx >= 1 && cx <= A) ? top[cx - 1] : -4;
#pragma unroll 8
      for (int s = 0; s < 32; ++s) {
        const int c = t0 + s - lane;
        int up = __shfl_up_sync(kFull, h, 1);
        const int ch_in = __shfl_up_sync(kFull, ch, 1);
        const int b_up = __shfl_sync(kFull, bval, s);
        const int b_ch = __shfl_sync(kFull, tval, s);
        unsigned cup = 0u;
        if (WITH_COUNTS) {
          cup = __shfl_up_sync(kFull, cnt, 1);
          const unsigned cb_up = __shfl_sync(kFull, cbval, s);
          cup = lane == 0 ? cb_up : cup;
        }
        up = lane == 0 ? b_up : up;
        ch = lane == 0 ? b_ch : ch_in;

        const int cand_d = wadd(up_prev, ch == sch ? m : negk);
        const int cand_u = wsub(up, d);
        const int cand_l = wsub(h, d);
        int hn = max(max(cand_d, cand_u), cand_l);
        const bool is_d = cand_d == hn, is_l = cand_l == hn, is_u = cand_u == hn;
        unsigned cn = 0u;
        if (WITH_COUNTS)
          cn = (is_d ? cup_prev : 0u) + (is_l ? cnt : 0u) + (is_u ? cup : 0u);
        unsigned mask = (is_d ? kMaskDiag : 0u) | (is_l ? kMaskLeft : 0u) |
                        (is_u ? kMaskUp : 0u);
        unsigned code = is_d ? 0u : (is_l ? kCodeLeft : kCodeUp);
        const bool col_zero = c == 0;  // column 0: -j*d, UP, one path
        hn = col_zero ? col0 : hn;
        cn = col_zero ? 1u : cn;
        mask = col_zero ? kMaskUp : mask;
        code = col_zero ? kCodeUp : code;
        const bool in_row = c >= 0 && c <= A;
        const bool kept = c >= cmin && c <= A && row_ok;  // stored here
        if (EMIT_MASKS) mring[lane * kRingCols + (c & (kRingCols - 1))] = mask;
        if (EMIT_SCORES && in_row && row_ok) hs[rowoff + c] = hn;
        if (EMIT_CODES) {
          const int g = c0 + t0 + s;  // step in the table's words
          pack |= (kept ? code : 0u) << (2 * (g & 15));
          if ((g & 15) == 15) {  // every lane stores together
            // the word holds columns g-15-lane .. g-lane: a tile's own
            // unless it reaches into the tile on the left or the right,
            // whose bits it then joins (a load in the chain: boundary
            // words only)
            // (a tile's sweep runs up to 31 steps past the table's last
            // word: those words, all zero, are not stored)
            const bool own = !TILE || ((c0 == 0 || g - 15 - lane > c0) &&
                                       (g - lane <= c0 + A || c0 + A == tile.width) &&
                                       (g >> 4) < TW);
            if (own) {
              wbase[static_cast<int64_t>(g >> 4) * 32] = pack;
            } else if (pack) {
              wbase[static_cast<int64_t>(g >> 4) * 32] |= pack;
            }
            pack = 0u;
          }
        }
        if (TILE && row_ok && c == A) tile.right[j - 1] = hn;
        if (TILE && j == Bs && c >= 1 && c <= A) tile.bottom[c - 1] = hn;
        if (in_row && j == Bs && c == A) {  // the corner
          *out.score = hn;
          if (WITH_COUNTS) *out.count = cn;
        }
        if (lane == 31 && in_row) {  // this band's last row, for band+1
          __stcg(ring + out_slot + c, hn);
          if (WITH_COUNTS) __stcg(cring + out_slot + c, cn);
        }
        if (dump && in_row) __stcg(dump_row + c, hn);
        if (last && in_row) last[c] = hn;
        up_prev = up;
        h = hn;
        if (WITH_COUNTS) {
          cup_prev = cup;
          cnt = cn;
        }
      }
      __syncwarp();  // the chunk's loads and stores precede the flag
      if (lane == 31) {
        __threadfence();
        vdone[gwarp] = round * nchunks + q + 1;
      }
      if (EMIT_MASKS) {  // every lane has finished columns t0-31 .. t0
        const int col = t0 - 31 + lane;
        const bool col_ok = col >= cmin && col <= A;
        const unsigned char* src = mring + (col & (kRingCols - 1));
        // a tile's table holds no row r0: its row of j is j - 1
        unsigned char* dst =
            masks + static_cast<int64_t>(band * 32 + (TILE ? 0 : 1)) * ldm + c0 + col;
#pragma unroll 4
        for (int r = 0; r < 32; ++r) {
          const unsigned char v = src[r * kRingCols];
          if (col_ok && band * 32 + 1 + r <= Bs) dst[static_cast<int64_t>(r) * ldm] = v;
        }
        __syncwarp();  // read before the next chunk overwrites the slots
      }
    }
    if (TILE && EMIT_CODES && pack) {  // the band's last word, when c0 % 16 > 0
      wbase[static_cast<int64_t>((c0 + nchunks * 32 - 1) >> 4) * 32] |= pack;
    }
  }
}

template <bool WITH_COUNTS, bool EMIT_MASKS, bool EMIT_SCORES, bool EMIT_CODES,
          bool TILE = false>
int launch_single(const int* top, const int* side, int A, int Bs, int r0,
                  const int* seed, int m, int k, int d, int blocks, int warps,
                  int* ring, unsigned* cring, int* done, Outs out,
                  cudaStream_t stream, Tile tile = Tile{}) {
  if (warps < 1 || warps > kMaxWarps || blocks < 1 || A < 0 || Bs < 0 ||
      r0 < 0 || (r0 > 0 && !seed) || (out.ckpt && (out.every < 32 || out.every % 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (TILE && (Bs < 1 || !seed || !tile.left || !tile.right || (A > 0 && !tile.bottom) ||
               tile.c0 < 0 || tile.c0 + A > tile.width))
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = EMIT_MASKS ? warps * kTileBytes : 0;  // up to 64 KB
  auto kernel = nw_single_kernel<WITH_COUNTS, EMIT_MASKS, EMIT_SCORES, EMIT_CODES, TILE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // cooperative: all blocks co-resident (or the launch is refused), since
  // a band spins on the band above it, which another block may run
  void* args[] = {&top, &side, &A, &Bs, &r0, &seed, &m, &k, &d, &ring,
                  &cring, &done, &out, &tile};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(blocks), dim3(32 * warps), args,
      static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller gets this launch's error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8 port: one pair's corner score and uint32 solution count, O(A+B)
// device memory.  top int32[A], side int32[Bs] (exact lengths); blocks x
// warps warps; ring / cring are [min(blocks*warps, bands), A+1] scratch,
// done int32[blocks*warps] zeroed; score / count one element each.
extern "C" int nw_score_count(const int* top, const int* side, int A, int Bs,
                              int m, int k, int d, int blocks, int warps,
                              int* ring, void* cring, int* done, int* score,
                              void* count, void* stream) {
  const Outs out{nullptr, nullptr, nullptr, nullptr, 0, score,
                 static_cast<unsigned*>(count)};
  return launch_single<true, false, false, false>(
      top, side, A, Bs, 0, nullptr, m, k, d, blocks, warps, ring,
      static_cast<unsigned*>(cring), done, out, static_cast<cudaStream_t>(stream));
}

// K2 pack_bits=8 port for one pair (and K10's, a pair at a time): tie
// masks uint8[Bs+1, A+1] in rows of ldm >= A+1 bytes, the int32 scores of
// the table (rows of A+1) when hs is not null, the corner score and the
// fused uint32 count.
extern "C" int nw_fill_masks(const int* top, const int* side, int A, int Bs,
                             int m, int k, int d, int blocks, int warps,
                             int* ring, void* cring, int* done, void* masks,
                             int ldm, int* hs, int* score, void* count,
                             void* stream) {
  if (ldm < A + 1) return static_cast<int>(cudaErrorInvalidValue);
  auto cr = static_cast<unsigned*>(cring);
  auto s = static_cast<cudaStream_t>(stream);
  const Outs out{static_cast<unsigned char*>(masks), hs, nullptr, nullptr, 0,
                 score, static_cast<unsigned*>(count), nullptr, ldm};
  if (hs)
    return launch_single<true, true, true, false>(
        top, side, A, Bs, 0, nullptr, m, k, d, blocks, warps, ring, cr, done, out, s);
  return launch_single<true, true, false, false>(
      top, side, A, Bs, 0, nullptr, m, k, d, blocks, warps, ring, cr, done, out, s);
}

// K14 port (seed null, r0 0): the 2-bit greedy codes of the whole pair,
// uint32[ceil(Bs/32), 2*ceil((A+32)/32), 32], and its corner score.
// K13 port (seed int32[A+1] = row r0 of the pair): the codes of rows
// r0+1 .. r0+Bs (side = the pair's side from row r0+1 on, Bs rows), in
// the same layout, and H[r0+Bs][A].  ring is [min(blocks*warps, bands),
// A+1] scratch, done int32[blocks*warps] zeroed.
extern "C" int nw_fill_codes_single(const int* top, const int* side, int A,
                                    int Bs, int r0, const int* seed, int m,
                                    int k, int d, int blocks, int warps,
                                    int* ring, int* done, void* codes,
                                    int* score, void* stream) {
  const Outs out{nullptr, nullptr, static_cast<unsigned*>(codes), nullptr, 0,
                 score, nullptr};
  return launch_single<false, false, false, true>(
      top, side, A, Bs, r0, seed, m, k, d, blocks, warps, ring, nullptr, done,
      out, static_cast<cudaStream_t>(stream));
}

// K11 port (ckpt null): one pair's corner score, nothing stored per cell.
// K12 port: also rows 0, C, 2C, ... below the last row into ckpt,
// int32[ceil(Bs/C), A+1]; C = every, a multiple of 32.  ring / done as
// nw_fill_codes_single.
extern "C" int nw_score_single(const int* top, const int* side, int A, int Bs,
                               int m, int k, int d, int blocks, int warps,
                               int* ring, int* done, int* ckpt, int every,
                               int* score, void* stream) {
  const Outs out{nullptr, nullptr, nullptr, ckpt, every, score, nullptr};
  return launch_single<false, false, false, false>(
      top, side, A, Bs, 0, nullptr, m, k, d, blocks, warps, ring, nullptr, done,
      out, static_cast<cudaStream_t>(stream));
}

// K9 port: one pair's row Bs, H[Bs][0..A], into last int32[A+1], and its
// corner score; ring / done as nw_score_single.
extern "C" int nw_last_row(const int* top, const int* side, int A, int Bs,
                           int m, int k, int d, int blocks, int warps,
                           int* ring, int* done, int* last, int* score,
                           void* stream) {
  const Outs out{nullptr, nullptr, nullptr, nullptr, 0, score, nullptr, last, 0};
  return launch_single<false, false, false, false>(
      top, side, A, Bs, 0, nullptr, m, k, d, blocks, warps, ring, nullptr, done,
      out, static_cast<cudaStream_t>(stream));
}

// K14's mesh half (codes non-null: 2-bit codes; masks and codes null:
// scores only) and K28 (masks non-null: 3-bit tie masks) on one tile of a
// pair whose rows are sharded: rows r0+1 .. r0+H (side = the pair's side
// from row r0+1 on, H >= 1 rows) and columns c0+1 .. c0+C of a pair of
// width A (top = the whole top string).  halo int32[C+1] is row r0 at
// columns c0 .. c0+C, left int32[H] column c0 at rows r0+1 .. r0+H; right
// int32[H] and bottom int32[C] receive column c0+C and row r0+H, score the
// cell (r0+H, c0+C).  codes uint32[ceil(H/32), 2*ceil((A+32)/32), 32]
// (zeroed before the rank's first tile: tiles OR their bits in) or masks
// uint8[H, A+1] hold the rank's rows; the tile with c0 = 0 also writes
// column 0.  ring is [min(blocks*warps, bands), C+1] scratch, done
// int32[blocks*warps] zeroed.
extern "C" int nw_fill_tile(const int* top, const int* side, int A, int C,
                            int H, int c0, const int* halo, const int* left,
                            int m, int k, int d, int blocks, int warps,
                            int* ring, int* done, void* codes, void* masks,
                            int* right, int* bottom, int* score, void* stream) {
  if (codes && masks) return static_cast<int>(cudaErrorInvalidValue);
  const Outs out{static_cast<unsigned char*>(masks), nullptr,
                 static_cast<unsigned*>(codes), nullptr, 0, score, nullptr};
  const Tile tile{left, right, bottom, c0, A};
  auto s = static_cast<cudaStream_t>(stream);
  const int* tp = top + c0;
  if (codes)
    return launch_single<false, false, false, true, true>(
        tp, side, C, H, 0, halo, m, k, d, blocks, warps, ring, nullptr, done, out, s, tile);
  if (masks)
    return launch_single<false, true, false, false, true>(
        tp, side, C, H, 0, halo, m, k, d, blocks, warps, ring, nullptr, done, out, s, tile);
  return launch_single<false, false, false, false, true>(
      tp, side, C, H, 0, halo, m, k, d, blocks, warps, ring, nullptr, done, out, s, tile);
}
