// Batched Needleman-Wunsch, Smith-Waterman and overlap fill kernels for
// Hopper (sm_90a).
//
// Replaces these TPU (Pallas) kernels:
//   K1 nw_tpu/ops/fill_pallas_banded.py:_make_banded_scores_kernel
//      (build_scores_call, fill_scores_banded_batch)      -> nw_scores
//   K2 nw_tpu/ops/fill_pallas_banded.py:_make_banded_arrows_kernel
//      (build_arrows_call) in its pack_bits=2 greedy-code, with_counts
//      and with_words=False modes                          -> nw_fill_codes
//   K22 nw_tpu/ops/variants_pallas.py:_sw_kernel, K15
//      nw_tpu/ops/variants_rowsweep.py:_make_sw_kernel and K18
//      nw_tpu/ops/variants_banded.py:_make_banded_sw_kernel (scores)
//                                                          -> sw_scores
//   K24 nw_tpu/ops/variants_pallas.py:_sw_arrows_kernel and K18 with
//      words and argmax                                    -> sw_fill_codes
//   K16 nw_tpu/ops/variants_rowsweep.py:_make_overlap_kernel and K19
//      nw_tpu/ops/variants_banded.py:_make_banded_overlap_kernel
//      (scores)                                            -> overlap_scores
//   K19 with words and argmax                              -> overlap_fill_codes
//   K2 in its batched pack_bits=8 tie-mask mode, with and without
//      with_counts (fill_arrows_banded_batch / fill_arrows_banded_single,
//      launched at fill_pallas_banded.py:969)              -> nw_fill_masks_batch
//   K2 in its with_runs mode (run bytes for the run-skip walk,
//      banded_traceback.py:_banded_walk_runs_device), here with
//      optional fused counts                               -> nw_fill_runs_batch
//   K1 and K2 (pack_bits=2) called band by band with the boundary row
//      carried in and out, as the two-pass engine and the resumable
//      fill run them (banded_traceback.py:77-110,
//      runtime/checkpoint.py:560-580)                      -> nw_fill_span
//
// Semantics are those of nw_tpu/ops/fill_scan.py:24-28, 118-163, with
// the boundaries written explicitly (row 0: -c*d, LEFT, one path;
// column 0: -j*d, UP, one path), so the result does not depend on a
// NEG_INF decay and holds for every scoring.  Score arithmetic wraps as
// int32, counts wrap mod 2^32.
//
// One design.  The pipeline (pipe_fill) runs W warps on each pair, for
// three recurrences: Needleman-Wunsch, with scores, codes or counts
// (nw_fill_pipe_kernel: nw_scores, nw_fill_codes) or a byte a cell
// (bytes_pipe_kernel: the MASKS and RUNS modes below,
// nw_fill_masks_batch and nw_fill_runs_batch), and the LOCAL and
// OVERLAP fills, scores (free_pipe_kernel: sw_scores, overlap_scores)
// and codes with the best cell (free_codes_pipe_kernel: sw_fill_codes,
// overlap_fill_codes).  The pipeline's protocol (its waits, fences and
// staging) lives in nw_common.cuh, which nw_affine.cu's Gotoh fills run
// too.
//
// The band sweep.  The side string's rows are cut into
// bands of 32 rows, one row per lane; at step t lane jj computes cell
// (row j0+jj, column c = t-jj), so a band is a 32-wide wavefront that
// sweeps the whole top string in A+32 steps, 32 steps a chunk.  The up
// neighbour arrives from lane jj-1 by __shfl_up_sync; the diagonal
// neighbour is the up value of the previous step; the left neighbour is
// the lane's own previous value.  Lane 0 takes the row above the band
// from the band before it, and lane 31 hands its row, the band's last,
// to the band after: the TPU kernel's band handoff
// (fill_pallas_banded.py:32-51) mapped onto warps.  Codes are stored 16
// steps at a time by all lanes together, one coalesced 128-byte store.
// The only per-step stores are predicated (lane 31's row, the corner):
// no step branches, so a warp never diverges.
//
// The pipeline (nw_fill_pipe_kernel).  A block of W warps (1 <= W <= 32,
// the rule nw_tpu_torch/ops/fill_banded.py:fill_warps) owns one pair.
// Band b runs on warp b % W, so up to W bands of a pair are in flight,
// each at least two chunks behind the band above it.  Dynamic shared
// memory (pipe_smem) holds:
//  - done[w], the chunks warp w has completed, counted over its bands;
//  - a ring of kSlots 32-column chunk slots a warp, a cell a column (the
//    score, with counts an int2 of score and count): the columns of a
//    band's chunk g, counting the chunks of all the warp's bands, go to
//    slot g % kSlots, written by lane 31 and read by the next warp's
//    lane 0, one shared access a step (no broadcast shuffles).  Counting
//    over all bands, not within one, makes a slot's reuse wait for its
//    last reader also where a band's chunks are no multiple of kSlots;
//  - warp 0's row above for its current chunk (see the wrap-around);
//  - the pair's top string, staged once as int16 (column c at c+31, -4
//    outside 1..A), which every lane reads at its own column each step
//    (no shuffle chain for the top character).  Characters are byte
//    values or the encoder's negative pads (nw_tpu_torch/ops/encode.py),
//    so int16 keeps them and -4 never equals one; a top of 10 240 bp
//    takes 20 KB, of 100 000 bp 200 KB.  A top past ~115 000 columns,
//    too long for a block's shared memory, is staged the same way in the
//    pair's int16 row of a device-memory scratch (TOP_SMEM false) and
//    read through L1.
// Consecutive warps w -> w+1 of one round (bands b, b+1) hand off through
// w's ring: before chunk g (counted over the warp's bands) warp w+1
// waits for done[w] >= g+2 (capped at the band's end: lane 31 trails
// lane 0 by 31 columns), and warp w waits for done[w+1] >= g-kSlots+1 (the
// slots it is about to overwrite have been read).  The wrap-around, band
// b on warp W-1 to band b+1 on warp 0, needs a whole row: warp 0 is
// still on band b+1-W when warp W-1 starts band b.  So warp W-1 copies
// each finished chunk of its ring into the per-pair boundary row in
// device memory (bnd / cbnd, int32[A+1], row 0 at the start), and warp
// 0, after done[W-1] says the chunk is there, stages 32 columns of it in
// shared memory, one coalesced load.  Data and counter are ordered by a
// block-scope fence on both sides.  No launch waits on another block.
// It cannot deadlock: warp W-1 never waits for a reader (bnd is a whole
// row), so a chain of "ring full" waits w -> w+1 -> ... ends at W-1; a
// warp that waits on an empty ring cannot have a producer that waits on
// the same ring full (kSlots >= 2; kSlots = 4 lets the two run 2-3
// chunks apart at once); and warp 0 waits on warp W-1's band of the
// round before, which does not wait on warp 0's current band.  Reusing
// bnd is safe: band b+W-1 writes column c only after band b has staged
// it, through the chain of ring waits between them.  With W = 1, warp 0
// reads bnd a chunk ahead of rewriting it in place.
//
// What bounds it on the H100: the serial dependence of each cell on the
// lane above.  Every step waits for one shuffle and a short chain of
// integer ops (sub, max, select), ~86 cycles a step for one warp alone
// (PERF.md, section 6), so one warp a pair with ~2 warps an SM (256
// pairs) was latency-bound.  With W warps a pair, 16-32 warps an SM
// interleave, and the SM's issue slots and its shared-memory pipe
// (shuffles, shared loads and stores) bound it.  So the step is short:
// the ring, the staged top and a 64-bit (score, count) cell take the
// broadcast shuffles and lane 31's device-memory store off it (two
// shuffles with counts instead of six), and a chunk whose every column
// lies in 1..A and that holds no corner (all but a few chunks of a band)
// runs a step with no test of column 0, of the row's end or of the
// corner: 24 SASS instructions with codes and counts against 40 in a
// tested chunk, five of them in the shared-memory pipe.  With counts or
// codes the three-way max is one DPX instruction (__vimax3_s32).  The
// only large memory traffic is the code store (2 bits per cell, written
// once: 26 MB for one 10240 x 10240 pair).  W = 1 keeps a warp a pair
// for batches that fill the card.
//
// The band-span mode (nw_fill_span_kernel, SPAN): the global sweep of
// bands r0 .. r0 + nb - 1 only, nb = min(span, ceil(Bs/32) - r0), from a
// boundary row that bnd / cbnd bring in (the row above band r0, row 0
// from the caller for r0 = 0) instead of row 0 written by the block.  The
// launch sweeps them as its bands 0 .. nb - 1, local band b on warp b % W,
// so the rounds, in_base and the wrap-around are the whole sweep's; only
// the rows (j, column 0's -j*d, the corner's chunk, the pads past Bs) are
// the table's.  A pair's score and count are written by the span that
// holds its row len2 (len2 = 0 by the span from band 0, off the seed
// row's column len1).  The span's last band leaves its last row in bnd /
// cbnd whichever warp runs it: lane 31 puts it into the warp's ring and
// the warp copies each finished chunk into bnd, as warp W - 1 does.  On
// warp w < W - 1 the ring's slots were last read by warp w + 1 in the
// round before, so the band waits for done[w + 1] to reach min(g -
// kSlots + 1, its final count) (never for a band w + 1 does not have).
// The in-place argument above holds for this write too: the span's last
// band, at chunk q, runs behind warp 0's band of its round by the chain
// of ring waits, so warp 0 has staged columns up to t0 + 63 of bnd before
// the band writes columns t0 - 31 .. t0 (on warp 0 itself, up to t0 + 31
// at the chunk's start, as with W = 1); and every other writer of those
// columns (warp W - 1's bands of the round before) precedes warp 0's
// staging of them.  Codes go to codes[b, band - r0], the span's bands in
// nw_fill_codes's layout.
//
// The free recurrences take the same span (free_span_kernel,
// free_fill_span: the variant tracebacks' checkpoint pass and group
// re-fill).  A span from band 0 writes row 0 (all 0) itself; column 0 is
// 0 on every row and gets STOP, as in the code fills.  The best cell
// needs the whole table, so the span is the code fill's ARGMAX sweep
// (every chunk of the bucket's rows, the window tests global), with or
// without the stores, and its key (score, kk, j) crosses spans in
// key[b]: thread 0 merges the spans before (ignored at r0 = 0) into the
// span's own by the whole key, as the lanes and warps merge (a later
// span can hold an equal score on an earlier anti-diagonal), and writes
// the merged key and the best's cell as the code fills give it.
//
// The free score fills on the pipeline (MODE kLocal, kOverlap; scores
// only) change the global sweep in four places.  Row 0 and column 0 are
// 0.  No corner: the result is a running best, kept per lane over its
// rows' cells in a loop-invariant window of columns [lo, hi] (LOCAL:
// 1..len1 on rows <= len2, the true rectangle; OVERLAP: the end window,
// row len2's 1..len1 and column len1 of the rows above), reduced over the
// warp's lanes and then, after the sweep, over the warps through done[]
// (no warp reads it by then; the shared memory is nw_scores').  LOCAL
// clamps every cell at 0 (DPX __vimax3_s32_relu).  And as
// nothing past the true table reaches the best, a free fill sweeps its
// pair's own ceil(len2/32) bands of ceil((len1+32)/32) chunks.  A chunk
// reads the best in one of three ways (BEST): untested, max(best, h), in
// an inner chunk of a LOCAL band above the last (every cell lies in the
// rectangle); not at all in an inner chunk of an OVERLAP band above the
// last before column len1's chunks (every cell lies outside the window:
// the global step without its corner test); tested, best = max(best, h)
// where lo <= c <= hi, elsewhere.  From a best of 0 that is exactly
// "h > best in the window" for both recurrences.
//
// The free code fills on the pipeline (free_codes_pipe_kernel; Smith-
// Waterman codes, nw_tpu/models/smith_waterman.py:25-97, and end-gap-free
// codes, nw_tpu/models/overlap.py:49-153) are the score fills with codes
// and the best's cell.  They write every code of the bucket table, so
// they sweep nw_fill_codes's ceil(Bs/32) bands of ceil((A+32)/32)
// chunks, the cells past the true table on the encoder's pads.  Row 0
// and column 0 are 0, written as the global recurrence writes its
// boundaries, so the result holds for every scoring (K22 and K18 leave
// column 0 free and differ at d < 0).  Column 0 gets code 3 (STOP),
// where the walk (sw_walk, nw_walk.cu) ends; LOCAL also gets STOP on
// every cell of score 0 (a local start); OVERLAP's interior cells take
// the global codes in wrapping int32, never STOP.  The best cell follows
// the scan's tie rule: the key ranks a higher score, then a smaller
// anti-diagonal kk = i + j, then a smaller row j (ranks_above;
// nw_tpu/ops/variants_banded.py:1230-1240).  A lane is one row and
// sweeps its columns in order, so in a band it keeps its row's first
// best on a strictly greater score (a compare and two selects; DPX
// __vibmax_s32 with its predicate gave as many SASS instructions); every
// lane at band step t lies on kk = 32 band + 1 + t, so it keeps t, not
// kk.  A later band can hold an equal score on an earlier diagonal,
// so at a band's end the lane merges its row's best into its own by the
// whole key; after the sweep a butterfly merges the lanes and thread 0
// the warps, whose bests cross through the rings, free after the
// barrier (the shared memory stays nw_scores').  The window and the
// chunk classes are the score fills', with one more: a chunk of no row
// of the true table, past column len1, or (OVERLAP) above row len2
// before column len1 reads no best.  When no cell beats 0 the cell is
// (0, 0) for LOCAL and the zero-cost corner (0, len1), or (len2, 0) when
// len1 is 0, for OVERLAP (overlap.py:91-97).
//
// Code layout, band-major as on the TPU (fill_pallas_banded.py:356-362):
// codes is uint32[B, nbands, TW, 32] with nbands = ceil(Bs/32) and
// TW = 2*ceil((A+32)/32).  Cell (j >= 1, i) lives in band (j-1)/32 at
// lane jj = (j-1)%32, band-local step t = i + jj: bits 2*(t%16) of
// codes[b, band, t/16, jj].  0 diag, 1 left, 2 up (ties diag > left >
// up, the first alignment the reference emits,
// needleman-wunsch.c:305-324).  Fields of cells outside the table are 0.
// Row 0 is not stored: every step there is LEFT.  All offsets are
// 64-bit: the codes of one 128 x 10 kb sub-batch pass 3 GB.
//
// The MASKS mode (bytes_pipe_kernel<kMasks>) is the global sweep on the
// pipeline storing each cell's 3-bit tie mask (bit0 diag, bit1 left,
// bit2 up; the ARROW_* bits) instead of a code, one byte a cell,
// row-major: uint8[B, Bs+1, A+1], a pair's rows one after another.  Row
// 0 is LEFT, column 0 UP, the origin 0, and every cell outside the
// pair's true (len2+1) x (len1+1) table is 0, all written explicitly
// (nothing is zeroed first).  The 32 lanes hold 32 rows, so a per-step
// byte store would be 32 transactions; instead each lane writes its byte
// into its warp's ring in shared memory (after the pipeline's rings,
// counters, staged row and top): 32 rows of 64 slots, step t in slot t %
// 64 (an immediate offset a step), a row every 68 bytes so that the 32
// lanes' bytes of one step fall in 32 banks.  After every chunk, past its
// count, and once after the band, the warp stores each row's next 32
// bytes aligned in device memory: rows start at any byte (A+1 is seldom
// a multiple of 32), and a 32-byte store across two sectors held
// every byte mode at ~40 ms at 128 x 10 kb, 2.5x the sweep (PERF.md,
// section 6).  Each row's piece starts at t0 - 32 or t0 from its
// 32-aligned base (t0 where its column 0 lies past its r-th byte): its
// columns are finished and still in the ring, and the pieces follow one
// another.  Four rows a store, a word a lane, funnel-shifted from the two
// ring words that hold it; the tests (columns 0..A, 0 past len1 and
// len2, a byte at a time across a row's ends) only outside the inner
// pieces of the true table.  The byte ring is its warp's alone, so the
// flush adds no wait to the pipeline's protocol; a __syncwarp orders it
// before the next chunk's ring writes.  The bytes go into the ring as
// computed, so the run chain below reads them unmasked.  Counts ride the
// int2 ring cell as in the global mode.  A top that does not fit beside
// W warps' int rings and byte rings is staged in device memory.
//
// The RUNS mode is the MASKS mode storing, instead of a tie mask, the
// byte min(run, 63) << 2 | code: the greedy code (0 diag, 1 left, 2 up,
// the global mode's choice) and the length of the maximal same-code run
// ending at the cell, for the run-skip walk (nw_walk.cu, nw_walk_runs),
// which consumes a whole run a load.  A diag run chains through the
// diagonal predecessor, a left run through the left one; up cells store
// run 0.  The left predecessor's byte is the lane's own byte of the
// previous step; the diagonal predecessor's is lane jj-1's byte of two
// steps back, moved by one more __shfl_up_sync beside the scores' (lane
// 0 takes 0: diag runs restart at each band's first row, as K2's
// restart at its band's row 0; a capped or band-split run only shortens
// a jump).  The byte is computed on the bytes themselves: a predecessor
// of the same code gives its byte plus 4 (one more cell, capped), any
// other a run of one, and the score's two compares pick diag, left or
// up, so the run adds 3 dependent ops after the score.  Written as the
// run's min, add and selects on separate fields instead, the step took
// 1.6x as long on the one-warp design before the pipeline (chip_smoke.py
// phase 14, PERF.md).  No byte crosses a band or a warp: lane 0's
// restart needs none, and a left run lives in the lane's own row, so the
// pipeline hands on scores and counts alone, and a chunk with no column
// 0, none past A and no corner runs untested.  Row 0 stores min(c, 63)
// << 2 | LEFT, column 0 UP (run 0), the origin and every cell outside
// the true table 0, all explicitly, through the same ring and stores as
// the masks; counts ride along as in the MASKS mode (K2's with_runs has
// none).

#include <cstdint>
#include <cuda_runtime.h>

#include "nw_common.cuh"

namespace {

using nw::Cell;
using nw::Flag;
using nw::kFull;
using nw::kMaxWarps;
using nw::kRing;
using nw::kSidePad;
using nw::kSlots;
using nw::pipe_post;
using nw::pipe_smem;
using nw::pipe_stage_top;
using nw::pipe_top_cols;
using nw::pipe_wait;
using nw::wadd;
using nw::wmul;
using nw::wsub;

constexpr int kCodeDiag = 0;
constexpr int kCodeLeft = 1;
constexpr int kCodeUp = 2;
constexpr int kCodeStop = 3;
constexpr unsigned kMaskDiag = 1u;
constexpr unsigned kMaskLeft = 2u;
constexpr unsigned kMaskUp = 4u;
// a warp's byte ring (MASKS, RUNS): 32 rows of 64 slots, a row every
// 68 bytes (17 words: the 32 lanes' stores of one slot fall in 32 banks)
constexpr int kRingCols = 64;
constexpr int kRingRow = 68;
constexpr int kRingBytes = 32 * kRingRow;

// the pipeline's recurrences besides kGlobal (below): the free ones, and
// Needleman-Wunsch storing a byte a cell
constexpr int kLocal = 1;    // Smith-Waterman
constexpr int kOverlap = 2;  // overlap: free end gaps
constexpr int kMasks = 3;    // Needleman-Wunsch storing tie masks
constexpr int kRuns = 4;     // Needleman-Wunsch storing run bytes
constexpr unsigned kRunCap = 63;  // the longest run a byte holds

// (score, kk, j) ranks above (tb, tk, tj): higher score, then the
// earlier anti-diagonal, then the lower row
__device__ __forceinline__ bool ranks_above(int sb, int sk, int sj, int tb,
                                            int tk, int tj) {
  return sb > tb || (sb == tb && (sk < tk || (sk == tk && sj < tj)));
}

// ---------------- the pipeline: W warps a pair (nw_scores, nw_fill_codes, the free fills) ----------------

constexpr int kGlobal = 0;  // the pipeline's Needleman-Wunsch recurrence (kLocal, kOverlap above)
// the cells of a chunk whose scores the running best of LOCAL / OVERLAP reads
constexpr int kBestNone = 0;    // none (every chunk of the global sweep)
constexpr int kBestAll = 1;     // all (LOCAL: a chunk inside the true rectangle)
constexpr int kBestTested = 2;  // those in the lane's window of columns [lo, hi]

template <int V> struct Best { static constexpr int value = V; };

// The pipeline's body, for the recurrence MODE (kGlobal, kLocal or
// kOverlap, the free ones without counts; kMasks or kRuns, the global
// recurrence storing a byte a cell into codes, read as uint8[B, Bs+1,
// A+1]).  TOP_SMEM: the top string is staged in shared memory; else in
// the pair's row of top16 (int16[B, pipe_top_cols(A)]) in device memory,
// for a top too long for a block's shared memory, read through L1.
// jstar, istar: the free code fills' best cell.
template <int MODE, bool EMIT_CODES, bool WITH_COUNTS, bool TOP_SMEM, bool SPAN = false>
__device__ __forceinline__ void pipe_fill(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2,
    int A, int Bs, int m, int k, int d, int* bnd, unsigned* cbnd,
    unsigned* __restrict__ codes, int* __restrict__ scores,
    unsigned* __restrict__ counts, short* top16, int* __restrict__ jstar = nullptr,
    int* __restrict__ istar = nullptr, int r0 = 0, int span = 0, int* key = nullptr) {
  constexpr bool LOCAL = MODE == kLocal;
  constexpr bool OVERLAP = MODE == kOverlap;
  constexpr bool FREE = LOCAL || OVERLAP;  // row 0 and column 0 are 0; a best cell is kept
  // the code fills and the free spans: the best's cell too
  constexpr bool ARGMAX = FREE && (EMIT_CODES || SPAN);
  constexpr bool TRIM = FREE && !EMIT_CODES && !SPAN;  // the score fills: the true table alone
  constexpr bool MASKS = MODE == kMasks;
  constexpr bool RUNS = MODE == kRuns;
  constexpr bool BYTES = MASKS || RUNS;  // a byte a cell, through the warp's byte ring
  static_assert(MODE == kGlobal || (FREE && !WITH_COUNTS) || (BYTES && !EMIT_CODES),
                "the pipeline's local and overlap fills keep no counts; the byte modes store no codes");
  static_assert(!SPAN || MODE == kGlobal || FREE, "the band-span mode is the global and free recurrences'");
  using C = typename Cell<WITH_COUNTS>::type;
  extern __shared__ __align__(16) int pipe_sh[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int64_t b = blockIdx.x;
  const int M = A + 1;
  // 32-step chunks of one band, and the bands; a free score fill's best
  // reads no cell past the true table, so it sweeps that table alone (a
  // code fill writes every code of the bucket table)
  const int nchunks = ((TRIM ? lens1[b] + 1 : M) + 31 + 31) >> 5;
  // SPAN: bands r0 .. r0 + nbands - 1 of the table, swept as bands 0 ..
  // nbands - 1 of this launch (band is local, gband global)
  const int nbands = SPAN ? min(span, ((Bs + 31) >> 5) - r0) : ((TRIM ? lens2[b] : Bs) + 31) >> 5;
  C* const rings = reinterpret_cast<C*>(pipe_sh);
  C* const stage = rings + W * kRing;
  volatile int* done = reinterpret_cast<int*>(stage + 32);
  short* const top_s = TOP_SMEM ? reinterpret_cast<short*>(const_cast<int*>(done) + W)
                                : top16 + b * pipe_top_cols(A);
  const int* top = tops + b * A;
  const int* side = sides + b * Bs;
  int* brow = bnd + b * M;
  unsigned* crow = WITH_COUNTS ? cbnd + b * M : nullptr;
  const int l1 = lens1[b];
  const int l2 = lens2[b];
  // BYTES: this pair's table, uint8[Bs+1, A+1], and the warp's 32-row x
  // 64-column byte ring, past the staged top (or past done[W])
  [[maybe_unused]] unsigned char* const pm =
      BYTES ? reinterpret_cast<unsigned char*>(codes) + b * (Bs + 1) * static_cast<int64_t>(M)
            : nullptr;
  [[maybe_unused]] unsigned char* const mring =
      BYTES ? (TOP_SMEM ? reinterpret_cast<unsigned char*>(top_s + pipe_top_cols(A))
                        : reinterpret_cast<unsigned char*>(const_cast<int*>(done) + W)) +
                  warp * kRingBytes
            : nullptr;

  // the top string, row 0 (-c*d, one path; 0 in the free fills) into the
  // boundary row and (BYTES) the table, counters
  pipe_stage_top(top_s, top, A);
  // SPAN: bnd / cbnd hold the row above band r0 (a free span from band 0
  // writes row 0, all 0, itself)
  if (!SPAN || (FREE && r0 == 0)) {
    for (int c = threadIdx.x; c < M; c += blockDim.x) {
      brow[c] = FREE ? 0 : wsub(0, wmul(c, d));
      if (WITH_COUNTS) crow[c] = 1u;
      // row 0: LEFT (RUNS: a left run from the origin), the origin and the
      // columns past len1 0
      if constexpr (MASKS) pm[c] = c >= 1 && c <= l1 ? kMaskLeft : 0u;
      if constexpr (RUNS) pm[c] = c >= 1 && c <= l1 ? min(static_cast<unsigned>(c), kRunCap) << 2 | kCodeLeft : 0u;
    }
  }
  if (threadIdx.x < W) done[threadIdx.x] = 0;
  // a corner on row 0 (SPAN: the seed row, which only the span from band
  // 0 reads as row 0)
  if (!FREE && l2 == 0 && threadIdx.x == 0 && (!SPAN || r0 == 0)) {
    scores[b] = SPAN ? brow[l1] : wsub(0, wmul(l1, d));
    if (WITH_COUNTS) counts[b] = SPAN ? crow[l1] : 1u;
  }
  __syncthreads();

  const int negk = wsub(0, k);
  const bool last_warp = warp == W - 1;
  C* const out_ring = rings + warp * kRing;
  // the row above: the previous warp's ring, or (warp 0) the staged chunk
  const C* const in_ring = warp > 0 ? rings + (warp - 1) * kRing : stage;
  const int in_warp = warp > 0 ? warp - 1 : W - 1;
  const short* const top_lane = top_s + 31 - lane;  // column t - lane at [t]
  // LOCAL, OVERLAP: the best of this lane's rows so far (ARGMAX: of its
  // row in this band, and lt the band step of that row's first such cell)
  int lbest = 0;
  [[maybe_unused]] int lt = 0;
  [[maybe_unused]] int rb = 0, rk = 0, rj = 0;  // ARGMAX: the lane's best cell (score, kk, j)
  for (int band = warp, round = 0; band < nbands; band += W, ++round) {
    const int gband = SPAN ? r0 + band : band;  // the band in the table
    const int j = gband * 32 + 1 + lane;  // this lane's row
    const bool row_ok = j <= Bs;
    const int sch = row_ok ? side[j - 1] : kSidePad;
    const int col0 = FREE ? 0 : wsub(0, wmul(j, d));  // H[j][0]
    const bool feeds = band + 1 < nbands;  // a band below reads this one's last row
    const bool to_ring = feeds && !last_warp;  // ... from this warp's ring
    // SPAN: the span's last band leaves its last row in bnd / cbnd,
    // through its ring (whose slots warp + 1, done with its last band a
    // round before, no longer reads) and the copy after each chunk
    [[maybe_unused]] const bool leaves = SPAN && !feeds;
    const bool hands = feeds || leaves;  // lane 31 writes the last row into the ring
    const bool waits_out = to_ring || (leaves && !last_warp);
    // warp 0 reads warp W-1's band of the round before (none in round 0:
    // the boundary row holds row 0)
    const int in_base = (warp > 0 ? round : round - 1) * nchunks;
    // the chunk of the true corner's step, in the band that holds row len2
    const int jj_c = l2 - 1 - gband * 32;
    const int corner_q = !FREE && jj_c >= 0 && jj_c < 32 ? (l1 + jj_c) >> 5 : -1;
    // LOCAL, OVERLAP: the columns of this lane's row that the best reads,
    // [lo, hi]: LOCAL 1..len1 (the true rectangle), OVERLAP the end
    // window (row len2's 1..len1, column len1 of the rows above it);
    // none below row len2
    const int lo = OVERLAP && j != l2 ? max(l1, 1) : 1;
    const int hi = j <= l2 ? l1 : 0;
    // ARGMAX: every row of the band lies in the true table (rows_in), none
    // does (rows_out), every row lies above row len2 (rows_above)
    [[maybe_unused]] const bool rows_in = gband * 32 + 32 <= l2;
    [[maybe_unused]] const bool rows_out = gband * 32 >= l2;
    [[maybe_unused]] const bool rows_above = gband * 32 + 32 < l2;
    unsigned* wbase = EMIT_CODES
        ? codes + ((b * nbands + band) * static_cast<int64_t>(2 * nchunks)) * 32 + lane
        : nullptr;
    int h = 0, up_prev = 0;  // own last value, last up
    unsigned cnt = 0, cup_prev = 0, pack = 0;
    [[maybe_unused]] unsigned run1 = 0, run2 = 0;  // RUNS: own byte of the last step and of the one before
    // BYTES: the band's rows of the bucket table and of the true table,
    // and its first row in the table
    [[maybe_unused]] const int band_rows = Bs - band * 32;
    [[maybe_unused]] const int true_rows = l2 - band * 32;
    [[maybe_unused]] unsigned char* const prow =
        BYTES ? pm + static_cast<int64_t>(band * 32 + 1) * M : nullptr;
    // BYTES: after the chunk that ends at step t0 + 31 (and once more
    // after the band), store the next aligned 32-byte piece of each row r:
    // addresses [xs, xs+31] from the row's 32-aligned base, xs = t0 - 32,
    // or t0 where the row's column 0 lies past its r-th byte (off > r),
    // so that its columns x - off are finished (lane r has done t0 + 31 -
    // r) and still in the ring (which holds steps t0 - 32 .., columns t0 -
    // 32 - r ..), and the pieces follow one another.  Column c of row r is
    // in slot (c + r) % 64.  0 outside the true table (rows past len2,
    // columns past len1).  The ring is the warp's alone: no other warp
    // waits on this.
    [[maybe_unused]] auto flush = [&](int t0) {
      // 4 rows a store (r, r + 8, r + 16, r + 24: banks apart), a word a
      // lane, each word from the two ring words that hold it
      const bool inner = true_rows >= 32 && t0 >= 64 && t0 + 31 <= l1;  // every cell of every piece in the true table
      const int w4 = (lane & 7) << 2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = i + 8 * (lane >> 3);
        unsigned char* const p = prow + static_cast<int64_t>(r) * M;
        const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 31);
        const int c = t0 - 32 + (off > r ? 32 : 0) - off + w4;  // the word's first column
        const int q = (c + r) & (kRingCols - 1);
        const unsigned* const ring_r = reinterpret_cast<const unsigned*>(mring + r * kRingRow);
        unsigned v = __funnelshift_r(ring_r[q >> 2], ring_r[((q >> 2) + 1) & 15], (q & 3) << 3);
        if (inner) {
          *reinterpret_cast<unsigned*>(p + c) = v;
        } else if (r < band_rows) {
          // 0 past column len1 and row len2; a word across either end of
          // the row (columns 0..A) a byte at a time
          const int keep = r < true_rows ? min(max(l1 - c + 1, 0), 4) : 0;  // its bytes up to len1
          v = keep == 4 ? v : v & ((1u << (8 * keep)) - 1u);
          if (c >= 0 && c + 3 <= A) {
            *reinterpret_cast<unsigned*>(p + c) = v;
          } else {
            for (int k = 0; k < 4; ++k) {
              if (c + k >= 0 && c + k <= A) p[c + k] = static_cast<unsigned char>(v >> (8 * k));
            }
          }
        }
      }
      __syncwarp();  // read before the next chunk overwrites the slots
    };

    for (int q = 0; q < nchunks; ++q) {
      const int g = round * nchunks + q;  // chunks of this warp before this one
      const int t0 = q << 5;
      // the row above's columns t0 .. t0+31 are in (the band above has
      // completed chunk q+1), and this chunk's slots have been read
      pipe_wait(done, in_warp, in_base + min(q + 2, nchunks), waits_out, warp + 1,
                SPAN && !to_ring ? min(g - kSlots + 1, round * nchunks) : g - kSlots + 1);
      const C* above = in_ring + (g & (kSlots - 1)) * 32;
      if (warp == 0) {  // stage the chunk of the boundary row
        const int cx = t0 + lane;
        const int v = cx < M ? brow[cx] : 0;
        if constexpr (WITH_COUNTS) {
          stage[lane] = make_int2(v, static_cast<int>(cx < M ? crow[cx] : 0u));
        } else {
          stage[lane] = v;
        }
        above = stage;
        __syncwarp();
      }
      // lane 31 writes columns t0-31 .. t0-1 (steps 0..30, none in chunk 0)
      // into slot g-1 at 1..31 and column t0 (step 31) into slot g at 0
      C* const out_lo = out_ring + ((g - 1) & (kSlots - 1)) * 32 + 1;
      C* const out_hi = out_ring + (g & (kSlots - 1)) * 32;
      const bool pub_hi = lane == 31 && hands;
      const bool pub_lo = pub_hi && q > 0;
      const short* const tq = top_lane + t0;
      // BYTES: this chunk's 32 slots of the lane's row of the byte ring
      [[maybe_unused]] unsigned char* const bring =
          BYTES ? mring + lane * kRingRow + (t0 & kRingCols / 2) : nullptr;

      // one chunk of 32 steps; FAST: every lane's column lies in 1..A
      // (free score fills: 1..len1) and the corner is not in it, so column
      // 0, the columns past A and the corner need no test; BEST: the cells
      // the free fills' best reads
      auto sweep = [&](auto fast, auto best) {
        constexpr bool FAST = decltype(fast)::value;
        constexpr int BEST = decltype(best)::value;
#pragma unroll
        for (int s = 0; s < 32; ++s) {
          int up = __shfl_up_sync(kFull, h, 1);
          [[maybe_unused]] unsigned vdiag = 0;
          if constexpr (RUNS) {  // lane jj-1's byte two steps back, (j-1, c-1); lane 0 restarts the chain
            vdiag = __shfl_up_sync(kFull, run2, 1);
            vdiag = lane == 0 ? 0u : vdiag;
          }
          [[maybe_unused]] unsigned cup = 0;
          if constexpr (WITH_COUNTS) {
            cup = __shfl_up_sync(kFull, cnt, 1);
            const int2 a = above[s];
            up = lane == 0 ? a.x : up;
            cup = lane == 0 ? static_cast<unsigned>(a.y) : cup;
          } else {
            const int a = above[s];
            up = lane == 0 ? a : up;
          }
          const int ch = tq[s];

          const int cand_d = wadd(up_prev, ch == sch ? m : negk);
          const int cand_u = wsub(up, d);
          const int cand_l = wsub(h, d);
          int hn;
          if constexpr (LOCAL) {  // clamped at 0: one DPX instruction
            hn = __vimax3_s32_relu(cand_d, cand_u, cand_l);
          } else {
            // where the candidates are compared again, one DPX three-way
            // max (exact: the wrapping is in the candidates); for the
            // score alone nvcc fuses each subtract into its max (VIADDMNMX)
            hn = EMIT_CODES || WITH_COUNTS || BYTES ? __vimax3_s32(cand_d, cand_u, cand_l)
                                                    : max(max(cand_d, cand_u), cand_l);
          }
          unsigned code = cand_d == hn ? kCodeDiag : (cand_l == hn ? kCodeLeft : kCodeUp);
          if constexpr (LOCAL && ARGMAX) code = hn == 0 ? kCodeStop : code;  // a local start
          unsigned cn = 0;
          if constexpr (WITH_COUNTS) {
            cn = (cand_d == hn ? cup_prev : 0u) + (cand_l == hn ? cnt : 0u) +
                 (cand_u == hn ? cup : 0u);
          }
          [[maybe_unused]] unsigned byte = 0;
          if constexpr (MASKS) {
            byte = (cand_d == hn ? kMaskDiag : 0u) | (cand_l == hn ? kMaskLeft : 0u) |
                   (cand_u == hn ? kMaskUp : 0u);
          } else if constexpr (RUNS) {
            // a predecessor of the same code extends its run by one (a byte
            // plus 4, capped), any other starts one; the score picks the code
            const unsigned dbyte = (vdiag & 3u) == kCodeDiag ? min(vdiag + 4u, kRunCap << 2 | kCodeDiag)
                                                             : 1u << 2 | kCodeDiag;
            const unsigned lbyte = (run1 & 3u) == kCodeLeft ? min(run1 + 4u, kRunCap << 2 | kCodeLeft)
                                                            : 1u << 2 | kCodeLeft;
            byte = cand_d == hn ? dbyte : (cand_l == hn ? lbyte : kCodeUp);
          }
          bool in_row = true;
          if constexpr (!FAST) {
            const int c = t0 + s - lane;
            const bool col_zero = c == 0;  // column 0: -j*d, UP, one path (free: 0, STOP)
            hn = col_zero ? col0 : hn;
            code = col_zero ? (FREE ? kCodeStop : kCodeUp) : code;
            cn = col_zero ? 1u : cn;
            if constexpr (BYTES) byte = col_zero ? (MASKS ? kMaskUp : kCodeUp) : byte;  // RUNS: run 0
            in_row = c >= 0 && c <= A;
            if (!FREE && in_row && j == l2 && c == l1) {  // the true corner
              scores[b] = hn;
              if (WITH_COUNTS) counts[b] = cn;
            }
          }
          if constexpr (ARGMAX && BEST != kBestNone) {  // a tie keeps the row's first step
            bool gain = hn > lbest;
            if constexpr (BEST == kBestTested) {
              const int c = t0 + s - lane;
              gain = gain && c >= lo && c <= hi;
            }
            lbest = gain ? hn : lbest;
            lt = gain ? t0 + s : lt;
          } else if constexpr (BEST == kBestAll) {
            lbest = max(lbest, hn);
          } else if constexpr (BEST == kBestTested) {  // from a best of 0: "hn > lbest" in the window
            const int c = t0 + s - lane;
            lbest = c >= lo && c <= hi ? max(lbest, hn) : lbest;
          }
          if (s < 31 ? pub_lo : pub_hi) {  // this band's last row, for the band below
            C v;
            if constexpr (WITH_COUNTS) {
              v = make_int2(hn, static_cast<int>(cn));
            } else {
              v = hn;
            }
            (s < 31 ? out_lo[s] : out_hi[0]) = v;
          }
          if constexpr (EMIT_CODES) {
            // rows past Bs store 0: per cell in a tested chunk, per word here
            pack |= (FAST || (in_row && row_ok) ? code : 0u) << (2 * (s & 15));
            if ((s & 15) == 15) {  // static: every lane stores together
              wbase[static_cast<int64_t>((t0 + s) >> 4) * 32] = FAST && !row_ok ? 0u : pack;
              pack = 0;
            }
          }
          if constexpr (BYTES) {
            // step t0 + s (column t0 + s - lane) in slot (t0 + s) % 64 of
            // the lane's row of the ring, as computed (the flush zeroes the
            // cells outside the true table); a slot of c < 0 is written
            // again before it is stored
            bring[s] = byte;
          }
          if constexpr (RUNS) {
            run2 = run1;
            run1 = byte;
          }
          up_prev = up;
          h = hn;
          if constexpr (WITH_COUNTS) {
            cup_prev = cup;
            cnt = cn;
          }
        }
      };
      const bool inner = q > 0 && t0 + 31 <= (TRIM ? l1 : A);  // no column 0, none past the row
      if constexpr (ARGMAX) {
        // the window's cells in this chunk: none (no row in the true
        // table, the columns past len1, or OVERLAP's rows above len2 before
        // column len1), all (LOCAL: a chunk inside the true rectangle) or
        // some; only a chunk that crosses the window tests its cells
        const bool none = rows_out || t0 - 31 > l1 || (OVERLAP && rows_above && t0 + 31 < l1);
        if (!inner) {
          sweep(Flag<false>{}, Best<kBestTested>{});
        } else if (none) {
          sweep(Flag<true>{}, Best<kBestNone>{});
        } else if (LOCAL && rows_in && t0 + 31 <= l1) {
          sweep(Flag<true>{}, Best<kBestAll>{});
        } else {
          sweep(Flag<true>{}, Best<kBestTested>{});
        }
      } else if constexpr (LOCAL) {
        // a band above the last lies whole in the true rectangle: an
        // inner chunk reads the best untested
        if (!inner) {
          sweep(Flag<false>{}, Best<kBestTested>{});
        } else if (feeds) {
          sweep(Flag<true>{}, Best<kBestAll>{});
        } else {
          sweep(Flag<true>{}, Best<kBestTested>{});
        }
      } else if constexpr (OVERLAP) {
        // the end window crosses the last band (row len2) and, in a band
        // above it, the chunks from column len1's first (lane 0's, at
        // chunk len1 >> 5) on: an inner chunk before those reads no best
        if (!inner) {
          sweep(Flag<false>{}, Best<kBestTested>{});
        } else if (feeds && q < (l1 >> 5)) {
          sweep(Flag<true>{}, Best<kBestNone>{});
        } else {
          sweep(Flag<true>{}, Best<kBestTested>{});
        }
      } else if (inner && q != corner_q) {
        sweep(Flag<true>{}, Best<kBestNone>{});
      } else {
        sweep(Flag<false>{}, Best<kBestNone>{});
      }

      __syncwarp();  // the chunk's ring writes are in
      if ((last_warp && feeds) || leaves) {  // columns t0-31 .. t0 into the boundary row
        const int col = t0 - 31 + lane;
        if (col >= 0 && col < M) {
          const C v = lane < 31 ? out_lo[lane] : out_hi[0];
          if constexpr (WITH_COUNTS) {
            brow[col] = v.x;
            crow[col] = static_cast<unsigned>(v.y);
          } else {
            brow[col] = v;
          }
        }
      }
      pipe_post(done, warp, lane, g);
      if constexpr (BYTES) flush(t0);
    }
    if constexpr (BYTES) flush(nchunks << 5);  // the pieces that reach column A
    if constexpr (ARGMAX) {  // this row's best cell into the lane's, by the key
      const int kk = gband * 32 + 1 + lt;
      if (ranks_above(lbest, kk, j, rb, rk, rj)) {
        rb = lbest;
        rk = kk;
        rj = j;
      }
      lbest = 0;
    }
  }
  if constexpr (ARGMAX) {
    // the pair's best cell: the warp's over its lanes (butterfly), then
    // the block's over the warps through the rings, which no warp reads
    // after the barrier
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_xor_sync(kFull, rb, off);
      const int ok = __shfl_xor_sync(kFull, rk, off);
      const int oj = __shfl_xor_sync(kFull, rj, off);
      if (ranks_above(ob, ok, oj, rb, rk, rj)) {
        rb = ob;
        rk = ok;
        rj = oj;
      }
    }
    int* const cells = reinterpret_cast<int*>(rings);
    __syncthreads();
    if (lane == 0) {
      cells[3 * warp] = rb;
      cells[3 * warp + 1] = rk;
      cells[3 * warp + 2] = rj;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < W; ++w) {
        if (ranks_above(cells[3 * w], cells[3 * w + 1], cells[3 * w + 2], rb, rk, rj)) {
          rb = cells[3 * w];
          rk = cells[3 * w + 1];
          rj = cells[3 * w + 2];
        }
      }
      if constexpr (SPAN) {
        // the spans before this one: their best cell, merged by the whole
        // key (a later band can hold an equal score on an earlier
        // anti-diagonal); a span from band 0 starts the key
        int* const kb = key + 3 * b;
        if (r0 > 0 && ranks_above(kb[0], kb[1], kb[2], rb, rk, rj)) {
          rb = kb[0];
          rk = kb[1];
          rj = kb[2];
        }
        kb[0] = rb;
        kb[1] = rk;
        kb[2] = rj;
      }
      // no positive cell: LOCAL (0, 0); OVERLAP the zero-cost corner
      // (0, len1), or (len2, 0) when len1 is 0
      scores[b] = rb;
      jstar[b] = rb > 0 ? rj : (OVERLAP && l1 == 0 ? l2 : 0);
      istar[b] = rb > 0 ? rk - rj : (OVERLAP ? l1 : 0);
    }
  } else if constexpr (FREE) {
    // the pair's best: the warp's over its lanes, then the block's over
    // the warps, through done[], which no warp reads after the barrier
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lbest = max(lbest, __shfl_xor_sync(kFull, lbest, off));
    __syncthreads();
    if (lane == 0) done[warp] = lbest;
    __syncthreads();
    if (threadIdx.x == 0) {
      int best = 0;
      for (int w = 0; w < W; ++w) best = max(best, done[w]);
      scores[b] = best;
    }
  }
}

// Needleman-Wunsch on the pipeline (nw_scores, nw_fill_codes).
template <bool EMIT_CODES, bool WITH_COUNTS, bool TOP_SMEM>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) nw_fill_pipe_kernel(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2,
    int A, int Bs, int m, int k, int d, int* bnd, unsigned* cbnd,
    unsigned* __restrict__ codes, int* __restrict__ scores,
    unsigned* __restrict__ counts, short* top16) {
  pipe_fill<kGlobal, EMIT_CODES, WITH_COUNTS, TOP_SMEM>(
      tops, sides, lens1, lens2, A, Bs, m, k, d, bnd, cbnd, codes, scores, counts, top16);
}

// Needleman-Wunsch on the pipeline, bands r0 .. r0 + span - 1 (cut at
// the table's last) from the row above band r0 in bnd / cbnd, which it
// leaves holding the span's last row (nw_fill_span): a kernel of its own,
// so nw_fill_pipe_kernel keeps its machine code.
template <bool EMIT_CODES, bool WITH_COUNTS, bool TOP_SMEM>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) nw_fill_span_kernel(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2,
    int A, int Bs, int m, int k, int d, int r0, int span, int* bnd, unsigned* cbnd,
    unsigned* __restrict__ codes, int* __restrict__ scores,
    unsigned* __restrict__ counts, short* top16) {
  pipe_fill<kGlobal, EMIT_CODES, WITH_COUNTS, TOP_SMEM, true>(
      tops, sides, lens1, lens2, A, Bs, m, k, d, bnd, cbnd, codes, scores, counts, top16,
      nullptr, nullptr, r0, span);
}

// The LOCAL and OVERLAP score fills on the pipeline (sw_scores,
// overlap_scores): a kernel of their own, so the global instantiations
// keep their machine code.
template <int MODE, bool TOP_SMEM>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) free_pipe_kernel(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2,
    int A, int Bs, int m, int k, int d, int* bnd, unsigned* cbnd,
    unsigned* __restrict__ codes, int* __restrict__ scores,
    unsigned* __restrict__ counts, short* top16) {
  pipe_fill<MODE, false, false, TOP_SMEM>(
      tops, sides, lens1, lens2, A, Bs, m, k, d, bnd, cbnd, codes, scores, counts, top16);
}

// The LOCAL and OVERLAP code fills on the pipeline (sw_fill_codes,
// overlap_fill_codes): the codes of the whole bucket table, the best and
// its cell; a kernel of their own, as the score fills'.
template <int MODE, bool TOP_SMEM>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) free_codes_pipe_kernel(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2,
    int A, int Bs, int m, int k, int d, int* bnd, unsigned* __restrict__ codes,
    int* __restrict__ best, int* __restrict__ jstar, int* __restrict__ istar,
    short* top16) {
  pipe_fill<MODE, true, false, TOP_SMEM>(tops, sides, lens1, lens2, A, Bs, m, k, d, bnd,
                                         nullptr, codes, best, nullptr, top16, jstar, istar);
}

// The LOCAL and OVERLAP fills band by band (free_fill_span): bands r0 ..
// r0 + span - 1 (cut at the table's last) from the row above band r0 in
// bnd (row 0 written here when r0 is 0), left holding the span's last
// row; the best cell merged into key (int32[B, 3]: score, kk, j) and
// written out as the code fills write it, and with EMIT_CODES the span's
// codes.  A kernel of its own, as the score fills'.
template <int MODE, bool EMIT_CODES, bool TOP_SMEM>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) free_span_kernel(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2,
    int A, int Bs, int m, int k, int d, int r0, int span, int* bnd,
    unsigned* __restrict__ codes, int* key, int* __restrict__ best,
    int* __restrict__ jstar, int* __restrict__ istar, short* top16) {
  pipe_fill<MODE, EMIT_CODES, false, TOP_SMEM, true>(tops, sides, lens1, lens2, A, Bs, m, k, d, bnd,
                                                     nullptr, codes, best, nullptr, top16, jstar,
                                                     istar, r0, span, key);
}

// The byte modes on the pipeline (nw_fill_masks_batch: MODE kMasks,
// nw_fill_runs_batch: kRuns): the global recurrence storing a byte a cell
// into bytes, uint8[B, Bs+1, A+1]; a kernel of their own, as the free
// fills'.
template <int MODE, bool WITH_COUNTS, bool TOP_SMEM>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) bytes_pipe_kernel(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2,
    int A, int Bs, int m, int k, int d, int* bnd, unsigned* cbnd,
    unsigned* __restrict__ bytes, int* __restrict__ scores,
    unsigned* __restrict__ counts, short* top16) {
  pipe_fill<MODE, false, WITH_COUNTS, TOP_SMEM>(
      tops, sides, lens1, lens2, A, Bs, m, k, d, bnd, cbnd, bytes, scores, counts, top16);
}

template <int MODE, bool EMIT_CODES, bool WITH_COUNTS, bool TOP_SMEM>
auto pipe_kernel() {
  if constexpr (MODE == kMasks || MODE == kRuns) {
    return bytes_pipe_kernel<MODE, WITH_COUNTS, TOP_SMEM>;
  } else if constexpr (MODE == kGlobal) {
    return nw_fill_pipe_kernel<EMIT_CODES, WITH_COUNTS, TOP_SMEM>;
  } else if constexpr (EMIT_CODES) {
    return free_codes_pipe_kernel<MODE, TOP_SMEM>;
  } else {
    return free_pipe_kernel<MODE, TOP_SMEM>;
  }
}

// top16 null: the top in shared memory; else int16[B, pipe_top_cols(A)].
// jstar, istar: the free code fills' best cell.  The byte modes add each
// warp's byte ring to the block's shared memory.
template <int MODE, bool EMIT_CODES, bool WITH_COUNTS>
int launch_pipe(const int* tops, const int* sides, const int* lens1,
                const int* lens2, int B, int A, int Bs, int m, int k, int d,
                int warps, short* top16, int* bnd, unsigned* cbnd,
                unsigned* codes, int* scores, unsigned* counts,
                cudaStream_t stream, int* jstar = nullptr, int* istar = nullptr) {
  if (B <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps || A < 0 || Bs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pipe_smem(warps, A, sizeof(typename Cell<WITH_COUNTS>::type), !top16) +
                   (MODE == kMasks || MODE == kRuns ? warps * kRingBytes : 0);
  auto kernel = top16 ? pipe_kernel<MODE, EMIT_CODES, WITH_COUNTS, false>()
                      : pipe_kernel<MODE, EMIT_CODES, WITH_COUNTS, true>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if constexpr (MODE != kGlobal && EMIT_CODES) {
    kernel<<<B, 32 * warps, smem, stream>>>(tops, sides, lens1, lens2, A, Bs, m, k, d,
                                            bnd, codes, scores, jstar, istar, top16);
  } else {
    kernel<<<B, 32 * warps, smem, stream>>>(tops, sides, lens1, lens2, A, Bs, m, k,
                                            d, bnd, cbnd, codes, scores, counts, top16);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool EMIT_CODES, bool WITH_COUNTS>
int launch_span(const int* tops, const int* sides, const int* lens1, const int* lens2, int B,
                int A, int Bs, int m, int k, int d, int r0, int span, int warps, short* top16,
                int* bnd, unsigned* cbnd, unsigned* codes, int* scores, unsigned* counts,
                cudaStream_t stream) {
  if (B <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps || A < 0 || Bs < 0 || r0 < 0 || span < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pipe_smem(warps, A, sizeof(typename Cell<WITH_COUNTS>::type), !top16);
  auto kernel = top16 ? nw_fill_span_kernel<EMIT_CODES, WITH_COUNTS, false>
                      : nw_fill_span_kernel<EMIT_CODES, WITH_COUNTS, true>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, 32 * warps, smem, stream>>>(tops, sides, lens1, lens2, A, Bs, m, k, d, r0, span,
                                          bnd, cbnd, codes, scores, counts, top16);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool EMIT_CODES>
int launch_free_span(const int* tops, const int* sides, const int* lens1, const int* lens2, int B,
                     int A, int Bs, int m, int k, int d, int r0, int span, int warps, short* top16,
                     int* bnd, unsigned* codes, int* key, int* best, int* jstar, int* istar,
                     cudaStream_t stream) {
  if (B <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps || A < 0 || Bs < 0 || r0 < 0 || span < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pipe_smem(warps, A, sizeof(int), !top16);
  auto kernel = top16 ? free_span_kernel<MODE, EMIT_CODES, false>
                      : free_span_kernel<MODE, EMIT_CODES, true>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, 32 * warps, smem, stream>>>(tops, sides, lens1, lens2, A, Bs, m, k, d, r0, span,
                                          bnd, codes, key, best, jstar, istar, top16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 port: int32 corner scores, W = warps a pair.  bnd is int32[B, A+1]
// scratch; top16 null, or int16[B, 32*ceil((A+32)/32) + 32] scratch for a
// top that does not fit a block's shared memory.
extern "C" int nw_scores(const int* tops, const int* sides, const int* lens1,
                         const int* lens2, int B, int A, int Bs, int m, int k,
                         int d, int warps, void* top16, int* bnd, int* scores,
                         void* stream) {
  return launch_pipe<kGlobal, false, false>(tops, sides, lens1, lens2, B, A, Bs,
                                            m, k, d, warps, static_cast<short*>(top16),
                                            bnd, nullptr, nullptr, scores, nullptr,
                                            static_cast<cudaStream_t>(stream));
}

// K2 port: scores, plus greedy codes (emit_codes) and/or uint32 counts
// (with_counts), W = warps a pair.  bnd / cbnd are [B, A+1] scratch,
// top16 as nw_scores's; codes is uint32[B, ceil(Bs/32), 2*ceil((A+32)/32),
// 32] when emit_codes.
extern "C" int nw_fill_codes(const int* tops, const int* sides,
                             const int* lens1, const int* lens2, int B, int A,
                             int Bs, int m, int k, int d, int emit_codes,
                             int with_counts, int warps, void* top16, int* bnd,
                             void* cbnd, void* codes, int* scores, void* counts,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto t16 = static_cast<short*>(top16);
  auto cb = static_cast<unsigned*>(cbnd);
  auto cw = static_cast<unsigned*>(codes);
  auto ct = static_cast<unsigned*>(counts);
  if (emit_codes && with_counts)
    return launch_pipe<kGlobal, true, true>(tops, sides, lens1, lens2, B, A, Bs, m,
                                            k, d, warps, t16, bnd, cb, cw, scores, ct, s);
  if (emit_codes)
    return launch_pipe<kGlobal, true, false>(tops, sides, lens1, lens2, B, A, Bs, m,
                                             k, d, warps, t16, bnd, cb, cw, scores, ct, s);
  if (with_counts)
    return launch_pipe<kGlobal, false, true>(tops, sides, lens1, lens2, B, A, Bs, m,
                                             k, d, warps, t16, bnd, cb, cw, scores, ct, s);
  return launch_pipe<kGlobal, false, false>(tops, sides, lens1, lens2, B, A, Bs, m,
                                            k, d, warps, t16, bnd, cb, cw, scores, ct, s);
}

// K22 / K15 / K18 port: int32 best local scores (>= 0), W = warps a
// pair.  bnd is int32[B, A+1] scratch, top16 as nw_scores's.
extern "C" int sw_scores(const int* tops, const int* sides, const int* lens1,
                         const int* lens2, int B, int A, int Bs, int m, int k,
                         int d, int warps, void* top16, int* bnd, int* best,
                         void* stream) {
  return launch_pipe<kLocal, false, false>(tops, sides, lens1, lens2, B, A, Bs,
                                           m, k, d, warps, static_cast<short*>(top16),
                                           bnd, nullptr, nullptr, best, nullptr,
                                           static_cast<cudaStream_t>(stream));
}

// K24 / K18 words port: local 2-bit codes (0 diag, 1 left, 2 up,
// 3 STOP) in nw_fill_codes's layout, best local scores and their cells
// (j*, i*), int32[B] each, W = warps a pair.  bnd is int32[B, A+1]
// scratch, top16 as nw_scores's.
extern "C" int sw_fill_codes(const int* tops, const int* sides,
                             const int* lens1, const int* lens2, int B, int A,
                             int Bs, int m, int k, int d, int warps, void* top16,
                             int* bnd, void* codes, int* best, int* jstar,
                             int* istar, void* stream) {
  return launch_pipe<kLocal, true, false>(tops, sides, lens1, lens2, B, A, Bs, m, k,
                                          d, warps, static_cast<short*>(top16), bnd,
                                          nullptr, static_cast<unsigned*>(codes), best,
                                          nullptr, static_cast<cudaStream_t>(stream),
                                          jstar, istar);
}

// K16 / K19 port: int32 best overlap scores (>= 0), W = warps a pair.
// bnd is int32[B, A+1] scratch, top16 as nw_scores's.
extern "C" int overlap_scores(const int* tops, const int* sides,
                              const int* lens1, const int* lens2, int B, int A,
                              int Bs, int m, int k, int d, int warps, void* top16,
                              int* bnd, int* best, void* stream) {
  return launch_pipe<kOverlap, false, false>(tops, sides, lens1, lens2, B, A, Bs,
                                             m, k, d, warps, static_cast<short*>(top16),
                                             bnd, nullptr, nullptr, best, nullptr,
                                             static_cast<cudaStream_t>(stream));
}

// K19 words + argmax port: overlap 2-bit codes (0 diag, 1 left, 2 up,
// 3 STOP on column 0) in nw_fill_codes's layout, best overlap scores and
// their end cells (j*, i*), int32[B] each, W = warps a pair.  bnd is
// int32[B, A+1] scratch, top16 as nw_scores's.
extern "C" int overlap_fill_codes(const int* tops, const int* sides,
                                  const int* lens1, const int* lens2, int B,
                                  int A, int Bs, int m, int k, int d, int warps,
                                  void* top16, int* bnd, void* codes, int* best,
                                  int* jstar, int* istar, void* stream) {
  return launch_pipe<kOverlap, true, false>(tops, sides, lens1, lens2, B, A, Bs, m, k,
                                            d, warps, static_cast<short*>(top16), bnd,
                                            nullptr, static_cast<unsigned*>(codes), best,
                                            nullptr, static_cast<cudaStream_t>(stream),
                                            jstar, istar);
}

// K2 pack_bits=8 port for a batch: tie masks uint8[B, Bs+1, A+1]
// (row-major, a pair's table after another; 0 outside each true table),
// scores int32[B] and, with with_counts, uint32 counts[B], W = warps a
// pair.  bnd / cbnd are [B, A+1] scratch (cbnd only with counts); top16
// null, or int16[B, 32*ceil((A+32)/32) + 32] scratch for a top that does
// not fit a block's shared memory beside the W warps' rings.
extern "C" int nw_fill_masks_batch(const int* tops, const int* sides,
                                   const int* lens1, const int* lens2, int B,
                                   int A, int Bs, int m, int k, int d,
                                   int with_counts, int warps, void* top16,
                                   int* bnd, void* cbnd, void* masks,
                                   int* scores, void* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto t16 = static_cast<short*>(top16);
  auto cb = static_cast<unsigned*>(cbnd);
  auto mk = static_cast<unsigned*>(masks);  // the kernel reads it as bytes
  auto ct = static_cast<unsigned*>(counts);
  if (with_counts)
    return launch_pipe<kMasks, false, true>(tops, sides, lens1, lens2, B, A, Bs, m, k,
                                            d, warps, t16, bnd, cb, mk, scores, ct, s);
  return launch_pipe<kMasks, false, false>(tops, sides, lens1, lens2, B, A, Bs, m, k,
                                           d, warps, t16, bnd, cb, mk, scores, ct, s);
}

// K2 with_runs port for a batch: run bytes min(run, 63) << 2 | code,
// uint8[B, Bs+1, A+1] (row-major, a pair's table after another; 0
// outside each true table), scores int32[B] and, with with_counts,
// uint32 counts[B], W = warps a pair.  Scratch as nw_fill_masks_batch's.
extern "C" int nw_fill_runs_batch(const int* tops, const int* sides,
                                  const int* lens1, const int* lens2, int B,
                                  int A, int Bs, int m, int k, int d,
                                  int with_counts, int warps, void* top16,
                                  int* bnd, void* cbnd, void* runs,
                                  int* scores, void* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto t16 = static_cast<short*>(top16);
  auto cb = static_cast<unsigned*>(cbnd);
  auto rb = static_cast<unsigned*>(runs);  // the kernel reads it as bytes
  auto ct = static_cast<unsigned*>(counts);
  if (with_counts)
    return launch_pipe<kRuns, false, true>(tops, sides, lens1, lens2, B, A, Bs, m, k,
                                           d, warps, t16, bnd, cb, rb, scores, ct, s);
  return launch_pipe<kRuns, false, false>(tops, sides, lens1, lens2, B, A, Bs, m, k,
                                          d, warps, t16, bnd, cb, rb, scores, ct, s);
}

// K1 and K2 as nw_tpu's two-pass engine calls them, band by band with
// the boundary row carried (the checkpoint pass and the group re-fill):
// bands r0 .. min(r0 + span, ceil(Bs/32)) - 1 from the row above band r0
// in bnd (int32[B, A+1]) and, with with_counts, cbnd (uint32[B, A+1]),
// both left holding the span's last row (its rows past Bs swept over
// pads).  Writes scores[b] (and counts[b]) only for a pair whose row len2
// lies in the span (len2 = 0: the span from band 0, off bnd's column
// len1), and with emit_codes the span's codes, uint32[B, nb, TW, 32] in
// nw_fill_codes's band-major layout, nb the span's bands.  Three
// variants: scores, scores + counts, codes (no counts).  W = warps a pair,
// top16 as nw_scores's.
extern "C" int nw_fill_span(const int* tops, const int* sides, const int* lens1,
                            const int* lens2, int B, int A, int Bs, int m, int k, int d,
                            int r0, int span, int emit_codes, int with_counts, int warps,
                            void* top16, int* bnd, void* cbnd, void* codes, int* scores,
                            void* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto t16 = static_cast<short*>(top16);
  auto cb = static_cast<unsigned*>(cbnd);
  auto cw = static_cast<unsigned*>(codes);
  auto ct = static_cast<unsigned*>(counts);
  if (emit_codes && with_counts) return static_cast<int>(cudaErrorInvalidValue);
  if (emit_codes)
    return launch_span<true, false>(tops, sides, lens1, lens2, B, A, Bs, m, k, d, r0, span,
                                    warps, t16, bnd, cb, cw, scores, ct, s);
  if (with_counts)
    return launch_span<false, true>(tops, sides, lens1, lens2, B, A, Bs, m, k, d, r0, span,
                                    warps, t16, bnd, cb, cw, scores, ct, s);
  return launch_span<false, false>(tops, sides, lens1, lens2, B, A, Bs, m, k, d, r0, span,
                                   warps, t16, bnd, cb, cw, scores, ct, s);
}

// K18 and K19 as nw_tpu's variant two-pass tracebacks call them, band by
// band with the boundary row carried (the checkpoint pass with its argmax,
// and the group re-fill): the LOCAL (local != 0) or OVERLAP fill of bands
// r0 .. min(r0 + span, ceil(Bs/32)) - 1 from the row above band r0 in bnd
// (int32[B, A+1]; row 0 is written here when r0 is 0), left holding the
// span's last row (its rows past Bs swept over pads).  key (int32[B, 3]:
// score, kk = i + j, j) carries the best cell of the spans before; the
// span's is merged into it by the scan's tie rule (a span from band 0
// starts it), and best / jstar / istar (int32[B]) get the merged best and
// its cell as sw_fill_codes / overlap_fill_codes give them.  With
// emit_codes, the span's codes, uint32[B, nb, TW, 32] in nw_fill_codes's
// band-major layout, nb the span's bands.  W = warps a pair, top16 as
// nw_scores's.
extern "C" int free_fill_span(const int* tops, const int* sides, const int* lens1,
                              const int* lens2, int B, int A, int Bs, int m, int k, int d,
                              int local, int r0, int span, int emit_codes, int warps, void* top16,
                              int* bnd, void* codes, int* key, int* best, int* jstar, int* istar,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto t16 = static_cast<short*>(top16);
  auto cw = static_cast<unsigned*>(codes);
  if (local && emit_codes)
    return launch_free_span<kLocal, true>(tops, sides, lens1, lens2, B, A, Bs, m, k, d, r0, span,
                                          warps, t16, bnd, cw, key, best, jstar, istar, s);
  if (local)
    return launch_free_span<kLocal, false>(tops, sides, lens1, lens2, B, A, Bs, m, k, d, r0, span,
                                           warps, t16, bnd, cw, key, best, jstar, istar, s);
  if (emit_codes)
    return launch_free_span<kOverlap, true>(tops, sides, lens1, lens2, B, A, Bs, m, k, d, r0, span,
                                            warps, t16, bnd, cw, key, best, jstar, istar, s);
  return launch_free_span<kOverlap, false>(tops, sides, lens1, lens2, B, A, Bs, m, k, d, r0, span,
                                           warps, t16, bnd, cw, key, best, jstar, istar, s);
}

extern "C" const char* nw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
