// Single-pair Needleman-Wunsch fills for Hopper (sm_90a): the warps of
// one cooperative grid sweep ONE pair together.
//
// Replaces these TPU (Pallas) kernels, in two kernels (the template
// single_pipe_kernel, nw_refill_kernel):
//   K8  nw_tpu/ops/fill_pallas_single.py:250 _make_score_count_kernel
//       (score_count_fold)                                 -> nw_score_count
//   K2  nw_tpu/ops/fill_pallas_banded.py:342 _make_banded_arrows_kernel
//       in its pack_bits=8 tie-mask mode for one pair (build_arrows_call,
//       fill_arrows_banded_single)                         -> nw_fill_masks
//   K10 nw_tpu/ops/fill_pallas_single.py:422 _make_arrows_kernel
//       (fill_arrows_fold_batch: the tie masks of a batch of long pairs,
//       one pair at a time)                                -> nw_fill_masks,
//                                                             a pair at a time
//   K14 nw_tpu/parallel/huge_pair.py:246 _make_fold_chunk_kernel_blocked
//       (config-5 fill with 2-bit walk words and the corner capture)
//                                                          -> nw_fill_codes_single
//       and its mesh half (one device's chunk: halo in, last-row edge
//       out, the corner; scores or 2-bit codes)              -> nw_fill_tile
//   K28 nw_tpu/parallel/huge_pair.py:70 _make_fold_chunk_kernel (the same
//       chunk with 8-bit packed tie masks)                 -> nw_fill_tile
//                                                             masks mode
//   K13 nw_tpu/ops/checkpoint_traceback.py:153 _make_refill_kernel
//       (re-fill of one block from its checkpoint)         -> nw_refill_blocks
//                                                             (G blocks a launch;
//       one block a launch: nw_fill_codes_single with a seed row)
//   K11 nw_tpu/ops/fill_strips.py:62 _make_strips_kernel
//       (strips_score: one huge pair's score)              -> nw_score_single
//   K12 nw_tpu/ops/checkpoint_traceback.py:61 _make_ckpt_kernel
//       (fill dumping its state every C diagonals)         -> nw_score_single
//                                                             with ckpt
//   K9  nw_tpu/ops/fill_pallas_single.py:83 _make_kernel
//       (last_row_pallas: one pair's row H[len2, 0..A], for
//       Hirschberg)                                        -> nw_last_row
// nw_score_count, nw_fill_masks, nw_fill_codes_single, nw_score_single,
// nw_last_row and nw_fill_tile run single_pipe_kernel (the single-pair
// pipeline, below), each in a mode of its own; nw_refill_blocks runs
// nw_refill_kernel.
//
// Semantics are those of nw_tpu/ops/fill_scan.py:24-28, 118-163 on the
// pair's exact (len2+1) x (len1+1) table, with row 0 (-c*d, LEFT, one
// path) and column 0 (-j*d, UP, one path) written explicitly: the result
// does not rest on the TPU kernels' NEG_INF decay
// (fill_pallas_single.py:277-284) and holds for every scoring.  Scores
// wrap as int32, counts as uint32.  The 0 x 0 pair gives score 0, count 1.
//
// The tiles (nw_fill_tile: single_pipe_kernel's kOutTile* modes) fill one
// tile of a pair whose rows are sharded over ranks
// (nw_tpu_torch/parallel/huge_pair.py): rows r0+1 .. r0+Bs and columns
// c0+1 .. c0+C.  A tile is a pair with a seed row and a left edge: the
// kernel runs it as a table of A = e + C columns, e = c0 % 16, whose
// column x is the pair's column c0 - e + x.  Its first e columns are
// idle (their values are never read past column e, and nothing of them
// is stored), so that the kernel's step t is the pair's step c0 - e + t
// and a code word's index and bits are static in t, as in the whole
// pair's codes mode.  Column e is the tile's left edge (column c0 at rows
// r0+1 .. r0+Bs, from left[] where the other modes compute -(r0+j)*d),
// block 0's boundary row holds the top halo (row r0 at columns c0 ..
// c0+C, the corner first) from column e on, the right edge (column c0+C)
// is stored by each row's lane at its step off the chain, the bottom edge
// (row r0+Bs) is the rows mode's row Bs, stored a cell a step by its lane
// in the last band, and the cell (r0+Bs, c0+C) is the corner score.  The
// codes go into the rank's table of the pair's width (the band-major
// layout below at the pair's steps): a tile's code words hold only its
// own columns except a few at each end of a band, which share columns
// with the tile on the left or the right (a lane's word spans 16 steps,
// its lanes 31 columns apart); those it ORs into the zeroed table (the
// tiles of a rank run in order on one stream), the others it stores
// whole, and the chunks whose columns all lie strictly inside the tile
// test nothing.  The tie masks go into a row-major uint8[Bs, width+1]
// table of the rank's rows (no row r0) through the masks mode's ring and
// whole-band flush.  The tile with c0 = 0 also stores column 0 (UP); no
// tile stores row r0.
//
// The tie masks (nw_fill_masks; nw_fill_tile's masks mode): each cell's
// 3-bit tie mask (bit0 diag, bit1 left, bit2 up; row 0 LEFT, column 0 UP,
// origin 0) into a rectangular row-major uint8[len2+1, len1+1], in rows
// of ldm >= len1+1 bytes (K10's port writes each pair of a batch into its
// slice of one uint8[B, Bs+1, A+1] table) and, when asked, its int32
// score into an int32 table of the same shape (rows of len1+1).  The 32
// lanes of a warp hold 32 different rows, so a per-step store of a mask
// is 32 transactions, which made the masks cost ~6x the fill on the H100
// (PERF.md, section 6).  So each lane writes its mask into the warp's
// 32-row x 64-column byte ring in shared memory (column c in slot c % 64;
// at any time the live columns span 63), and after every 32-step chunk
// the warp stores the 32 columns that every lane has finished, row by
// row: 32 lanes on 32 consecutive bytes, one coalesced store a row (a
// whole band's 32 rows with no test a row, which took a sixth off a
// 10 240 bp pair's fill on the H100, PERF.md section 6; a row test only
// in a short last band).
// Scores (only for -t tables, which are small) keep a store a lane a
// cell.
//
// The codes (nw_fill_codes_single; nw_fill_tile's codes mode): each
// cell's 2-bit greedy code (0 diag, 1 left, 2 up, by diag > left > up)
// in nw_fill.cu's band-major layout: a lane packs 16 steps into a word
// and after the step with (t & 15) == 15 the 32 lanes store their words
// together at [band, t >> 4, lane], one coalesced 128-byte store per 16
// steps, so the tensor is bit-equal to nw_fill_codes's for the same
// pair, every word written (cells outside the table 0).  Given a seed
// row (row r0 of the pair, scores only) nw_fill_codes_single fills rows
// r0+1 .. r0+Bs instead: band 0 reads its row above from the seed,
// column 0 stays -j*d with the global j.
//
// The rows of scores (nw_score_single, nw_last_row).  nw_score_single
// stores nothing per cell; given ckpt it also writes rows 0, C, 2C, ...
// below row Bs into ckpt[0], ckpt[1], ...: row r*C (r >= 1) is lane 31's
// row of band r*C/32 - 1, which feeds the band below and so has that row
// in its ring slots already; after each chunk the warp copies the chunk's
// 32 columns from there into the checkpoint row, one coalesced store a
// chunk (block 0 writes row 0 beside its boundary row).  nw_last_row
// writes row Bs, whatever Bs, into an int32[A+1] row: the lane of row Bs
// in the last band (which feeds no ring) stores each of its cells, A+1
// stores off the step's chain in one band (row 0's -c*d when Bs is 0),
// column 0 explicit as everywhere, so the row follows fill_scan at every
// scoring (K9 rests on the NEG_INF decay).
//
// The grouped re-fill (nw_refill_blocks, nw_refill_kernel: the codes
// mode's step, every band handing off through L2).  A checkpointed
// traceback re-fills every block of C rows from its checkpoint row; one
// block is only C/32 bands, too few for the card, and given their seed
// rows the blocks are independent.  So one cooperative launch re-fills G
// consecutive blocks: bands are numbered over the group (band b is block
// b / (C/32)), one row a lane, and a warp sweeps its band as nw_fill.cu
// does (the up neighbour by __shfl_up_sync, the diagonal one the up
// value of the previous step, lane 0 fed the row above 32 columns at a
// time).  The launch's P warps in all (blocks x warps) take bands g,
// g+P, g+2P, ... (global warp g), so up to P bands are in flight, each
// two 32-column chunks behind the band above it.  A band that starts a
// block reads its row above from that block's seed and waits on no band;
// the others read band b-1's last row from a ring of boundary rows in
// device memory, through L2 only (__ldcg / __stcg: another SM's L1 may
// hold a stale line), column 0 is -(r0+j)*d with the group's r0, and
// each block's last row stores its corner.  After every chunk each warp
// publishes the chunks it has completed, over all its bands, in a global
// counter (monotonic, so a reader never sees a later band's reset); the
// next band's warp spins on it before it loads a chunk (a gpu-scope
// fence after the data and before the count, and after the count and
// before the data); the launch is cooperative, so no spin waits on a
// block that never runs.  The ring: block g owns slots g*S .. g*S+S-1,
// S = min(P, C/32), and band b of it (its l-th) writes slot g*S + l%S.
// With S = C/32 (P >= C/32) no slot is reused.  Else band b+P reuses
// band b's slot, which is safe: band b+P writes column c only after band
// b+P-1 has published past c, which by the same rule needs band b+1 to
// have loaded column c, an unbroken chain of waits from band b+1 to band
// b+P-1 inside one block (no band there starts a block: a block start
// would break the chain).  The ring holds G*S rows, at most a row a
// band: half the bytes of the group's codes.
//
// The single-pair pipeline (single_pipe_kernel, in the mode OUT: counts
// for nw_score_count; codes for nw_fill_codes_single; rows of scores for
// nw_score_single and nw_last_row; tie masks, with counts, for
// nw_fill_masks; a tile's edges, with codes or tie masks, for
// nw_fill_tile).  nw_fill.cu's pipeline (its
// header, "The pipeline") on G blocks of W warps of a cooperative grid,
// one pair a grid (W and G: nw_tpu_torch/ops/fill_banded.py single_warps,
// single_blocks).  Band b runs on block (b / W) % G, warp b % W, so up to
// P = G*W bands are in flight, and a warp takes its bands b, b+P, ... in
// rounds.  Within a block consecutive bands hand off as in nw_fill.cu,
// through the warps' shared rings of kSlots chunk slots (nw_common.cuh's
// pipe_wait / pipe_post, block-scope fences), and a step is pipe_fill's
// Needleman-Wunsch step: an int2 (score, count) ring cell with counts,
// an int32 one without, the int16 staged top (in shared memory, or in the
// block's row of a device scratch past ~115 000 columns, or where W
// warps' mask rings leave no room for it), the untested
// inner chunk and DPX __vimax3_s32.  Only warp W-1 of block g hands its
// band's last row on, to warp 0 of block (g+1) % G: after each chunk it
// copies the chunk from its ring into bnd[(g+1) % G], the boundary row
// of the block after, through L2 (__stcg: another SM's L1 may hold a
// stale line), and after chunks 0, kHandoff, 2*kHandoff, ... and the last
// it publishes the chunks it has completed, counted over its bands, in
// flags[g] (a __threadfence first).  Warp 0 of block g+1, before chunks
// 0, kHandoff, ..., spins until flags[g] covers the chunk after the
// group's last (lane 31 trails lane 0 by 31 columns), fences, loads the
// group's kHandoff chunks of its row (__ldcg, a cell a lane a chunk, into
// registers) and stages one chunk a chunk in shared memory, as pipe_fill
// stages bnd.  So L2 carries one handoff every W bands, with one fence
// and one spin every kHandoff chunks (a kernel whose every band handed
// off through L2 paid them for every band and chunk, and ran at the pace
// of that handoff: 2.6-2.9x slower on a 100 kb pair, PERF.md section 6).
// Block 0's row holds row 0 (-c*d, one path), the seed or a tile's halo
// first; block 0's warp 0 then reads block G-1's bands of the
// round before.  The modes' outputs ride on this without a wait of their
// own: the masks mode's ring is the warp's alone (a __syncwarp orders its
// flush before the next chunk's writes), a checkpoint row is copied out of
// slots that only their writer rewrites, after the chunk (as warp W-1
// copies its row into bnd), and row Bs and a tile's right edge need no
// ring.
//
// It cannot deadlock.  The launch is cooperative, so every block is
// co-resident and no spin waits on a block that never runs.  A band
// waits on the band above it (its row) and, inside a block, on the band
// below it in the same round (the ring slots it overwrites have been
// read); warp W-1 never waits for a reader (a boundary row is a whole
// row), so every wait between blocks is a "row above" wait, on a smaller
// band, and nw_fill.cu's argument for its rings covers the rest.  A
// warp's band of round r waits on nothing of a later round.
//
// Reusing a boundary row.  bnd[g+1] is rewritten by band b+P (block g's
// warp W-1, one round later) while band b+1 (block g+1's warp 0) reads
// band b's row from it.  Band b+P copies its chunk q's columns (t0-31 ..
// t0) only after completing chunk q, which needed band b+P-1 to have
// completed chunk q+1, which needed band b+P-2 to have completed chunk
// q+2, and so on: the unbroken chain of "row above" waits from band b+P
// down to band b+1 (kHandoff's groups only lengthen a link) gives band
// b+1 at least q+1 chunks completed, so it has loaded every column up to
// t0 before any of them is overwritten; each link's fence (block-scope in
// a block, gpu-scope between blocks) orders its load before the store.
// With P = 1 the one warp loads a group of its row before rewriting any
// of its columns.  The checkpoint and mask copies change no slot and add
// no wait, so the argument stands as it is.  The boundary rows are G rows
// of A+1 cells: 8 bytes with counts, 4 without (105.6 MB for
// nw_score_count at 100 kb on 132 blocks).
//
// What bounds it on the H100.  The codes modes add one coalesced 128-byte
// store a warp per 16 steps (2.5 GB for a 100 000 bp pair, ~2 ms, PERF.md
// section 6); the masks modes a shared-memory byte store a step and 32
// coalesced 32-byte row stores a chunk (a byte a cell: 0.1 GB for a
// 10 240 bp pair).  The grouped re-fill puts every band of G blocks in
// flight at once (up to 32 warps an SM), so its G blocks take about one
// band's sweep with the SMs' issue slots shared by ~24 warps each, its
// every band handing off through L2.  single_pipe_kernel: the
// wavefront's critical path, about 2*nbands + nchunks chunks of 32 steps
// (each band two chunks behind the one above, then the last band's
// sweep: ~9 400 chunks at 100 kb), at the step's latency, plus kHandoff-1
// chunks of lag and an L2 round trip every W bands.  A block's W bands
// start two chunks apart, so ~nchunks/(2W) consecutive blocks hold the
// wavefront at once: W near nchunks/(2*SMs) spreads it over every SM
// (12 warps an SM at 100 kb), and more warps an SM slow each one's step
// (~127 cycles with counts, ~104 with codes at 12 warps an SM, against
// ~86 for a warp alone; PERF.md section 6), which, not the
// handoff, holds a 100 kb pair at ~2x its bound.  A tile pays the same
// path for its own bands and chunks (a tile of H rows x C columns: about
// 2*H/32 + (C+e)/32 chunks), so a rank's tiles in a row pay the 2*H/32
// chunks of its wavefront's depth once a tile.

#include <cstdint>
#include <cuda_runtime.h>

#include "nw_common.cuh"

namespace {

using nw::Cell;
using nw::Flag;
using nw::kFull;
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

constexpr int kMaxWarps = 32;
// chunks a handoff between blocks carries (a power of 2): warp W-1
// publishes its boundary row every kHandoff chunks, and warp 0 loads
// kHandoff chunks of it at once, one fence and one spin for them all.
// In a build-flag trial on an H100 2 was a few percent faster than 1 at
// 20 and 100 kb, and 4 no faster than 2 (PERF.md section 6)
constexpr int kHandoff = 2;

// warp W-1 publishes its count after chunk q: after chunks 0, kHandoff,
// 2*kHandoff, ... (counts 1, kHandoff+1, ...: where warp 0's group of
// kHandoff chunks from chunk q' needs count q'+kHandoff+1) and the last
__device__ __forceinline__ bool publishes_after(int q, int nchunks) {
  return (q & (kHandoff - 1)) == 0 || q + 1 == nchunks;
}
constexpr unsigned kMaskDiag = 1u;
constexpr unsigned kMaskLeft = 2u;
constexpr unsigned kMaskUp = 4u;

constexpr int kRingCols = 64;  // columns of a warp's mask ring
constexpr int kTileBytes = 32 * kRingCols;

constexpr unsigned kCodeLeft = 1u;
constexpr unsigned kCodeUp = 2u;

// The modes of single_pipe_kernel (its OUT): what a launch writes
// besides the corner score (header, "The single-pair pipeline").
constexpr int kOutCount = 0;        // with counts: the corner count (K8)
constexpr int kOutCodes = 1;        // the 2-bit codes (K14, K13 a block a launch)
constexpr int kOutRows = 2;         // rows of scores: checkpoint rows, row Bs (K11, K12, K9)
constexpr int kOutMasks = 3;        // with counts: the tie masks and the count (K2 one pair, K10)
constexpr int kOutMasksScores = 4;  // ... and the int32 scores of every cell (-t)
// a tile (K14's mesh half, K28): its right and bottom edges and corner ...
constexpr int kOutTile = 5;       // ... alone (scores)
constexpr int kOutTileCodes = 6;  // ... and the 2-bit codes
constexpr int kOutTileMasks = 7;  // ... and the tie masks

// The outputs of single_pipe_kernel's rows, masks and tile modes (null
// where the mode or the caller has none).
struct PipeOuts {
  int* ckpt;             // int32[ceil(Bs/every), A+1]: rows 0, every, 2*every, ... below row Bs
  int every;             // a multiple of 32
  int* last;             // int32[A+1]: row Bs (a tile's bottom edge from column e+1 on)
  unsigned char* masks;  // uint8 rows 0 .. Bs of ldm >= A+1 bytes (a tile's: rows 1 .. Bs)
  int ldm;
  int* hs;               // int32[Bs+1, A+1]
  // a tile (header, "The tiles"), in the kernel's columns: the pair's
  // column c0 - e + x is column x
  const int* left;  // int32[Bs]: column e, the tile's left edge
  int* right;       // int32[Bs]: column A, the tile's right edge
  int e;            // idle columns before the left edge: c0 % 16
  int keep;         // the first column the tile stores: e, or e+1 past a tile on its left
  int lo_own;       // a code word whose columns lie in lo_own .. hi_own is
  int hi_own;       // the tile's alone (stored whole); else OR'd into the table
  int tw;           // code words of a band row of the rank's table
  int words;        // ... from the tile's first, (c0 - e) / 16, on
};

// ---------------- K13, grouped: G blocks of one pair in one launch ----------------

// The grouped re-fill (header comment): rows r0+1 .. r0+Bs of a pair in
// blocks of C rows (C a multiple of 32; the last block may be short),
// block g from its seed row seeds[g] (row r0 + g*C), its codes into its
// bands of one band-major table and H[r0 + min(Bs, (g+1)*C)][A] into
// corners[g].  ring is [G * min(P, C/32), A+1] scratch, done int32[P]
// zeroed.
__global__ void __launch_bounds__(32 * kMaxWarps, 1) nw_refill_kernel(
    const int* __restrict__ top, const int* __restrict__ side, int A, int Bs,
    int C, int r0, const int* __restrict__ seeds, int m, int k, int d,
    int* ring, int* done, unsigned* __restrict__ codes, int* __restrict__ corners) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int P = gridDim.x * W;  // warps in all
  const int gwarp = blockIdx.x * W + warp;
  const int M = A + 1;
  const int nchunks = (M + 31 + 31) >> 5;  // 32-step chunks of one band
  const int TW = 2 * nchunks;              // code words of a band row
  const int nbc = C >> 5;                  // bands of a whole block
  const int S = min(P, nbc);               // ring slots of a block
  const int nbands = (Bs + 31) >> 5;       // bands of the group
  volatile int* vdone = done;  // chunks completed, per global warp (zeroed)
  const int negk = wsub(0, k);
  const int prev_warp = (gwarp + P - 1) % P;
  for (int band = gwarp, round = 0; band < nbands; band += P, ++round) {
    const int g = band / nbc;         // the block
    const int lb = band - g * nbc;    // the band within its block
    const int j = band * 32 + 1 + lane;  // this lane's row in the group
    const bool row_ok = j <= Bs;
    const int sch = row_ok ? side[j - 1] : -5;
    const int col0 = wsub(0, wmul(r0 + j, d));  // H[r0+j][0]
    const int corner_row = min(Bs, (g + 1) * C);  // the block's last row
    const bool feeds = lb + 1 < nbc && band + 1 < nbands;  // a band of this block below
    const int* const seed = seeds + static_cast<int64_t>(g) * M;
    const int64_t in_slot = static_cast<int64_t>(g * S + (lb + S - 1) % S) * M;
    const int64_t out_slot = static_cast<int64_t>(g * S + lb % S) * M;
    // band-1's warp has completed this many chunks before band-1 began
    const int pred_base = lb > 0 ? ((band - 1) / P) * nchunks : 0;
    unsigned* const wbase = codes + static_cast<int64_t>(band) * TW * 32 + lane;
    int h = 0, up_prev = 0, ch = -4;  // own last value, last up, top char
    unsigned pack = 0;

    for (int q = 0; q < nchunks; ++q) {
      const int t0 = q << 5;
      const int cx = t0 + lane;
      int bval;
      if (lb == 0) {  // a block's first band: the row above is its seed
        bval = cx < M ? seed[cx] : 0;
      } else {
        // columns t0 .. t0+31 of band-1's last row are written once
        // band-1 has completed chunk q+1 (lane 31 trails lane 0 by 31)
        const int target = pred_base + min(q + 2, nchunks);
        while (vdone[prev_warp] < target) {
        }
        __threadfence();
        bval = cx < M ? __ldcg(ring + in_slot + cx) : 0;
      }
      const int tval = (cx >= 1 && cx <= A) ? top[cx - 1] : -4;
#pragma unroll 8
      for (int s = 0; s < 32; ++s) {
        const int c = t0 + s - lane;
        int up = __shfl_up_sync(kFull, h, 1);
        const int ch_in = __shfl_up_sync(kFull, ch, 1);
        const int b_up = __shfl_sync(kFull, bval, s);
        const int b_ch = __shfl_sync(kFull, tval, s);
        up = lane == 0 ? b_up : up;
        ch = lane == 0 ? b_ch : ch_in;

        const int cand_d = wadd(up_prev, ch == sch ? m : negk);
        const int cand_u = wsub(up, d);
        const int cand_l = wsub(h, d);
        int hn = max(max(cand_d, cand_u), cand_l);
        unsigned code = cand_d == hn ? 0u : (cand_l == hn ? kCodeLeft : kCodeUp);
        const bool col_zero = c == 0;  // column 0: -j*d, UP
        hn = col_zero ? col0 : hn;
        code = col_zero ? kCodeUp : code;
        const bool in_row = c >= 0 && c <= A;
        pack |= (in_row && row_ok ? code : 0u) << (2 * (s & 15));
        if ((s & 15) == 15) {  // every lane stores together
          wbase[static_cast<int64_t>((t0 + s) >> 4) * 32] = pack;
          pack = 0u;
        }
        if (in_row && j == corner_row && c == A) corners[g] = hn;
        if (lane == 31 && in_row && feeds) __stcg(ring + out_slot + c, hn);
        up_prev = up;
        h = hn;
      }
      __syncwarp();  // the chunk's loads and stores precede the flag
      if (lane == 31) {
        __threadfence();
        vdone[gwarp] = round * nchunks + q + 1;
      }
    }
  }
}


// ---------------- the W-warp pipeline across a cooperative grid ----------------

// The pipeline's NW fill of one pair on G blocks of W warps (header,
// "The single-pair pipeline"): band b on block (b / W) % G, warp b % W.
// TOP_SMEM: the top string is staged in shared memory; else in the
// block's row of top16 (int16[G, pipe_top_cols(A)]).  bnd is [G, A+1]
// cells, row g the row above block g's warp 0 (row 0, or the seed, in
// row 0 first); flags int32[G] zeroed.  With a seed (row r0 of the pair)
// rows r0+1 .. r0+Bs are filled, column 0 -(r0+j)*d.  OUT (kOut*) picks
// what is written besides the corner: codes, or out's rows or masks; a
// tile (kOutTile*: header, "The tiles") has seed = its halo from column
// out.e on and out.left as its column out.e.
template <bool WITH_COUNTS, int OUT, bool TOP_SMEM>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) single_pipe_kernel(
    const int* __restrict__ top, const int* __restrict__ side, int A, int Bs,
    int r0, const int* __restrict__ seed, int m, int k, int d, short* top16,
    typename Cell<WITH_COUNTS>::type* bnd, int* flags, unsigned* __restrict__ codes,
    int* __restrict__ score, unsigned* __restrict__ count, PipeOuts out) {
  using C = typename Cell<WITH_COUNTS>::type;
  constexpr bool TILE = OUT >= kOutTile;
  constexpr bool EMIT_CODES = OUT == kOutCodes || OUT == kOutTileCodes;
  constexpr bool ROWS = OUT == kOutRows;
  constexpr bool MASKS = OUT == kOutMasks || OUT == kOutMasksScores || OUT == kOutTileMasks;
  constexpr bool HS = OUT == kOutMasksScores;
  constexpr bool LASTROW = ROWS || TILE;  // row Bs stored by its lane (a tile's bottom edge)
  static_assert(TILE ? !WITH_COUNTS : !MASKS || WITH_COUNTS,
                "the masks mode carries the count; a tile has none");
  extern __shared__ __align__(16) int single_sh[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int G = gridDim.x;
  const int blk = blockIdx.x;
  const int M = A + 1;
  const int nchunks = (M + 31 + 31) >> 5;  // 32-step chunks of one band
  const int nbands = (Bs + 31) >> 5;
  C* const rings = reinterpret_cast<C*>(single_sh);
  C* const stage = rings + W * kRing;
  volatile int* done = reinterpret_cast<int*>(stage + 32);
  short* const top_s = TOP_SMEM ? reinterpret_cast<short*>(const_cast<int*>(done) + W)
                                : top16 + static_cast<int64_t>(blk) * pipe_top_cols(A);
  // MASKS: the warp's 32-row x 64-column byte ring of tie masks, past the
  // staged top (or past done[W])
  [[maybe_unused]] unsigned char* const mring =
      (TOP_SMEM ? reinterpret_cast<unsigned char*>(top_s + pipe_top_cols(A))
                : reinterpret_cast<unsigned char*>(const_cast<int*>(done) + W)) +
      warp * kTileBytes;
  // warp 0 reads its row above from bnd[blk], published by flags[blk-1]
  // (block 0: by flags[G-1]); warp W-1 writes bnd[blk+1], flags[blk]
  const C* const bnd_in = bnd + static_cast<int64_t>(blk) * M;
  C* const bnd_out = bnd + static_cast<int64_t>((blk + 1) % G) * M;
  volatile int* const flag_in = flags + (blk + G - 1) % G;
  volatile int* const flag_out = flags + blk;

  // the top string; row 0 (-c*d, one path) or the seed into block 0's
  // boundary row; counters
  pipe_stage_top(top_s, top, A);
  if (blk == 0) {
    for (int c = threadIdx.x; c < M; c += blockDim.x) {
      int v;
      if constexpr (TILE) {  // the halo from the left edge's column on; 0 in the idle ones
        v = c >= out.e ? seed[c - out.e] : 0;
      } else {
        v = seed ? seed[c] : wsub(0, wmul(c, d));
      }
      if constexpr (WITH_COUNTS) {
        __stcg(bnd + c, make_int2(v, 1));
      } else {
        __stcg(bnd + c, v);
      }
      if constexpr (ROWS) {  // row 0: checkpoint row 0, or row Bs when Bs is 0
        if (out.ckpt && Bs > 0) out.ckpt[c] = v;
        if (out.last && Bs == 0) out.last[c] = v;
      }
      if constexpr (MASKS && !TILE) {  // row 0: LEFT, the origin 0
        out.masks[c] = c == 0 ? 0 : kMaskLeft;
        if constexpr (HS) out.hs[c] = v;
      }
    }
    if (!TILE && Bs == 0 && threadIdx.x == 0) {  // the corner is on the row above
      *score = seed ? seed[A] : wsub(0, wmul(A, d));
      if (WITH_COUNTS) *count = 1u;
    }
  }
  if (threadIdx.x < W) done[threadIdx.x] = 0;
  __syncthreads();

  const int negk = wsub(0, k);
  const bool last_warp = warp == W - 1;
  C* const out_ring = rings + warp * kRing;
  // the row above: the previous warp's ring, or (warp 0) the staged chunk
  const C* const in_ring = warp > 0 ? rings + (warp - 1) * kRing : stage;
  const short* const top_lane = top_s + 31 - lane;  // column t - lane at [t]
  // column 0: the left edge (a tile's column e); the first column stored
  const int cl = TILE ? out.e : 0;
  [[maybe_unused]] const int ck = TILE ? out.keep : 0;
  int seen = 0;  // warp 0: the last value read from flag_in
  C pre[kHandoff];  // warp 0: the row above's next kHandoff chunks, a cell a lane
  for (int band = blk * W + warp, round = 0; band < nbands; band += G * W, ++round) {
    const int j = band * 32 + 1 + lane;  // this lane's row
    const bool row_ok = j <= Bs;
    const int sch = row_ok ? side[j - 1] : kSidePad;
    // H[r0+j][0], or a tile's left edge
    const int col0 = TILE ? (row_ok ? out.left[j - 1] : 0) : wsub(0, wmul(r0 + j, d));
    const bool feeds = band + 1 < nbands;  // a band below reads this one's last row
    const bool to_ring = feeds && !last_warp;  // ... from this warp's ring
    // warp 0 reads block blk-1's warp W-1 band of this round; block 0 block
    // G-1's of the round before (none in round 0: bnd[0] holds row 0)
    const int in_base = (warp > 0 || blk > 0 ? round : round - 1) * nchunks;
    // the chunk of the corner's step, in the band that holds row Bs
    const int jj_c = Bs - 1 - band * 32;
    const int corner_q = jj_c >= 0 && jj_c < 32 ? (A + jj_c) >> 5 : -1;
    // a tile's rows in the rank's table: tw words a band row, codes from
    // the tile's first word on
    unsigned* wbase = EMIT_CODES
        ? codes + (band * static_cast<int64_t>(TILE ? out.tw : 2 * nchunks)) * 32 + lane : nullptr;
    // ROWS: a checkpoint row r*every (r >= 1) is lane 31's row of a band
    // that feeds the band below, so this warp's ring holds it: copied out
    // after each chunk
    [[maybe_unused]] int* const ckpt_row =
        ROWS && out.ckpt && feeds && (band * 32 + 32) % out.every == 0
            ? out.ckpt + static_cast<int64_t>((band * 32 + 32) / out.every) * M : nullptr;
    // LASTROW: row Bs, stored a cell a step by its lane of the last band
    [[maybe_unused]] const bool last_band = LASTROW && out.last && band == nbands - 1;
    [[maybe_unused]] const int last_lane = (Bs - 1) & 31;
    [[maybe_unused]] const int64_t rowoff = static_cast<int64_t>(j) * M;  // HS: row j
    int h = 0, up_prev = 0;  // own last value, last up
    unsigned cnt = 0, cup_prev = 0, pack = 0;

    for (int q = 0; q < nchunks; ++q) {
      const int g = round * nchunks + q;  // chunks of this warp before this one
      const int t0 = q << 5;
      const C* above = in_ring + (g & (kSlots - 1)) * 32;
      if (warp > 0) {
        // the row above's columns t0 .. t0+31 are in (the band above has
        // completed chunk q+1), and this chunk's slots have been read
        pipe_wait(done, warp - 1, in_base + min(q + 2, nchunks), to_ring, warp + 1, g - kSlots + 1);
      } else {
        pipe_wait(done, 0, 0, to_ring, 1, g - kSlots + 1);  // the slots alone
        // every kHandoff chunks, the next kHandoff chunks of the row above
        // (the band above has completed the chunk after the last of them)
        const int slot = q & (kHandoff - 1);
        if (slot == 0) {
          const int need = in_base + min(q + kHandoff + 1, nchunks);
          if (seen < need) {
            while ((seen = *flag_in) < need) {
            }
            __threadfence();
          }
#pragma unroll
          for (int i = 0; i < kHandoff; ++i) {
            const int cx = t0 + 32 * i + lane;
            pre[i] = cx < M ? __ldcg(bnd_in + cx) : C{};
          }
        }
        C v = pre[0];
#pragma unroll
        for (int i = 1; i < kHandoff; ++i) v = slot == i ? pre[i] : v;
        stage[lane] = v;
        above = stage;
        __syncwarp();
      }
      // lane 31 writes columns t0-31 .. t0-1 (steps 0..30, none in chunk 0)
      // into slot g-1 at 1..31 and column t0 (step 31) into slot g at 0
      C* const out_lo = out_ring + ((g - 1) & (kSlots - 1)) * 32 + 1;
      C* const out_hi = out_ring + (g & (kSlots - 1)) * 32;
      const bool pub_hi = lane == 31 && feeds;
      const bool pub_lo = pub_hi && q > 0;
      const short* const tq = top_lane + t0;

      // one chunk of 32 steps; FAST: every lane's column lies in 1..A and
      // the corner is not in it, so column 0, the columns past A and the
      // corner need no test (a tile's: in e+1 .. A-1, so its idle columns,
      // its right edge and its shared code words need none either); LAST
      // (LASTROW): the band of row Bs, whose lane stores its cells
      auto sweep = [&](auto fast, auto lastrow) {
        constexpr bool FAST = decltype(fast)::value;
        constexpr bool LAST = decltype(lastrow)::value;
#pragma unroll
        for (int s = 0; s < 32; ++s) {
          int up = __shfl_up_sync(kFull, h, 1);
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
          // one DPX three-way max (exact: the wrapping is in the candidates)
          int hn = __vimax3_s32(cand_d, cand_u, cand_l);
          unsigned code = cand_d == hn ? 0u : (cand_l == hn ? kCodeLeft : kCodeUp);
          unsigned cn = 0;
          if constexpr (WITH_COUNTS) {
            cn = (cand_d == hn ? cup_prev : 0u) + (cand_l == hn ? cnt : 0u) +
                 (cand_u == hn ? cup : 0u);
          }
          [[maybe_unused]] unsigned mask = 0;
          if constexpr (MASKS) {
            mask = (cand_d == hn ? kMaskDiag : 0u) | (cand_l == hn ? kMaskLeft : 0u) |
                   (cand_u == hn ? kMaskUp : 0u);
          }
          bool in_row = true;
          [[maybe_unused]] bool kept = true;  // TILE: a cell the tile stores
          if constexpr (!FAST) {
            const int c = t0 + s - lane;
            const bool col_zero = c == cl;  // column 0: -(r0+j)*d, UP, one path
            hn = col_zero ? col0 : hn;
            code = col_zero ? kCodeUp : code;
            cn = col_zero ? 1u : cn;
            if constexpr (MASKS) mask = col_zero ? kMaskUp : mask;
            in_row = c >= cl && c <= A;
            if (in_row && j == Bs && c == A) {  // the corner
              *score = hn;
              if (WITH_COUNTS) *count = cn;
            }
            if constexpr (TILE) {
              kept = c >= ck && c <= A && row_ok;
              if (row_ok && c == A) out.right[j - 1] = hn;  // the right edge
            }
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
          if constexpr (EMIT_CODES && TILE && !FAST) {
            pack |= (kept ? code : 0u) << (2 * (s & 15));
            if ((s & 15) == 15) {  // static: every lane stores together
              // the word holds columns t0+s-15-lane .. t0+s-lane; one past
              // the table's last word (a band's sweep ends up to 31 steps
              // past it) holds none and is not stored
              const int w = (t0 + s) >> 4;
              if (w < out.words) {
                unsigned* const p = wbase + static_cast<int64_t>(w) * 32;
                if (t0 + s - 15 - lane >= out.lo_own && t0 + s - lane <= out.hi_own) {
                  *p = pack;
                } else if (pack) {  // shared with a neighbouring tile
                  *p |= pack;
                }
              }
              pack = 0;
            }
          } else if constexpr (EMIT_CODES) {
            // rows past Bs store 0: per cell in a tested chunk, per word here
            pack |= (FAST || (in_row && row_ok) ? code : 0u) << (2 * (s & 15));
            if ((s & 15) == 15) {  // static: every lane stores together
              wbase[static_cast<int64_t>((t0 + s) >> 4) * 32] = FAST && !row_ok ? 0u : pack;
              pack = 0;
            }
          }
          if constexpr (MASKS) {  // column c in slot c % 64 of the lane's row
            mring[lane * kRingCols + ((t0 + s - lane) & (kRingCols - 1))] = mask;
            if constexpr (HS) {
              if (in_row && row_ok) out.hs[rowoff + t0 + s - lane] = hn;
            }
          }
          if constexpr (LAST) {  // (a tile's row holds its idle columns and column e too)
            if (lane == last_lane && in_row) out.last[t0 + s - lane] = hn;
          }
          up_prev = up;
          h = hn;
          if constexpr (WITH_COUNTS) {
            cup_prev = cup;
            cnt = cn;
          }
        }
      };
      const bool fast_chunk = TILE ? t0 - 31 > cl && t0 + 31 < A  // none of the tile's ends
                                   : q > 0 && t0 + 31 <= A && q != corner_q;  // no column 0, none past the row, no corner
      if (LASTROW && last_band) {
        if constexpr (LASTROW) fast_chunk ? sweep(Flag<true>{}, Flag<true>{}) : sweep(Flag<false>{}, Flag<true>{});
      } else if (fast_chunk) {
        sweep(Flag<true>{}, Flag<false>{});
      } else {
        sweep(Flag<false>{}, Flag<false>{});
      }

      __syncwarp();  // the chunk's ring writes are in
      if (last_warp && feeds) {  // columns t0-31 .. t0 into block blk+1's boundary row
        const int col = t0 - 31 + lane;
        if (col >= 0 && col < M) __stcg(bnd_out + col, lane < 31 ? out_lo[lane] : out_hi[0]);
        // published after chunks 0, kHandoff, 2*kHandoff, ... and the last,
        // as g+1: the counts the reader's groups of kHandoff chunks wait for
        if (publishes_after(q, nchunks)) {
          __syncwarp();
          if (lane == 0) {
            __threadfence();
            *flag_out = g + 1;
          }
        }
      }
      pipe_post(done, warp, lane, g);
      if constexpr (ROWS) {
        if (ckpt_row) {  // columns t0-31 .. t0 of lane 31's row, from the ring
          const int col = t0 - 31 + lane;
          if (col >= 0 && col < M) ckpt_row[col] = lane < 31 ? out_lo[lane] : out_hi[0];
        }
      }
      if constexpr (MASKS) {  // every lane has finished columns t0-31 .. t0
        const int col = t0 - 31 + lane;
        const bool col_ok = col >= ck && col <= A;
        const int rows = Bs - band * 32;  // this band's rows, if fewer than 32
        const unsigned char* src = mring + (col & (kRingCols - 1));
        // (a tile's table has no row r0: row j at j-1)
        unsigned char* dst = out.masks + static_cast<int64_t>(band * 32 + (TILE ? 0 : 1)) * out.ldm + col;
        if (col_ok && rows >= 32) {  // a whole band: no test a row
#pragma unroll 8
          for (int r = 0; r < 32; ++r) {  // 32 lanes on 32 consecutive bytes of a row
            *dst = src[r * kRingCols];
            dst += out.ldm;
          }
        } else {
#pragma unroll 4
          for (int r = 0; r < 32; ++r) {
            const unsigned char v = src[r * kRingCols];
            if (col_ok && r < rows) dst[static_cast<int64_t>(r) * out.ldm] = v;
          }
        }
        __syncwarp();  // read before the next chunk overwrites the slots
      }
    }
  }
}

// top16 null: the top in shared memory; else int16[blocks, pipe_top_cols(A)].
// The masks modes add each warp's mask ring to the block's shared memory.
template <bool WITH_COUNTS, int OUT>
int launch_single_pipe(const int* top, const int* side, int A, int Bs, int r0,
                       const int* seed, int m, int k, int d, int blocks, int warps,
                       short* top16, void* bnd, int* flags, unsigned* codes, int* score,
                       unsigned* count, cudaStream_t stream, PipeOuts out = PipeOuts{}) {
  using C = typename Cell<WITH_COUNTS>::type;
  constexpr bool TILE = OUT >= kOutTile;
  constexpr bool MASKS = OUT == kOutMasks || OUT == kOutMasksScores || OUT == kOutTileMasks;
  if (warps < 1 || warps > kMaxWarps || blocks < 1 || A < 0 || Bs < 0 || r0 < 0 ||
      (r0 > 0 && !seed) || (out.ckpt && (out.every < 32 || out.every % 32)) ||
      (MASKS && (!out.masks || out.ldm < A + 1 || r0 > 0)) ||
      (TILE && (Bs < 1 || !seed || !out.left || !out.right || !out.last || out.e < 0 ||
                out.e > A || (OUT == kOutTileCodes && !codes))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pipe_smem(warps, A, sizeof(C), !top16) + (MASKS ? warps * kTileBytes : 0);
  auto kernel = top16 ? single_pipe_kernel<WITH_COUNTS, OUT, false>
                      : single_pipe_kernel<WITH_COUNTS, OUT, true>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // cooperative: all blocks co-resident (or the launch is refused), since
  // a block's warp 0 spins on the block before it
  C* cells = static_cast<C*>(bnd);
  void* args[] = {&top, &side, &A, &Bs, &r0, &seed, &m, &k, &d, &top16,
                  &cells, &flags, &codes, &score, &count, &out};
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

// K8 port: one pair's corner score and uint32 count, O(A+B) device
// memory, on the single-pair pipeline of blocks x warps warps.  top
// int32[A], side int32[Bs] (exact lengths); top16 null, or
// int16[blocks, 32*ceil((A+32)/32) + 32] scratch for a top that does not
// fit a block's shared memory; bnd int32[blocks, A+1, 2] scratch, flags
// int32[blocks] zeroed; score / count one element each.
extern "C" int nw_score_count(const int* top, const int* side, int A, int Bs,
                              int m, int k, int d, int blocks, int warps,
                              void* top16, void* bnd, int* flags, int* score,
                              void* count, void* stream) {
  return launch_single_pipe<true, kOutCount>(
      top, side, A, Bs, 0, nullptr, m, k, d, blocks, warps, static_cast<short*>(top16), bnd,
      flags, nullptr, score, static_cast<unsigned*>(count), static_cast<cudaStream_t>(stream));
}

// K2 pack_bits=8 port for one pair (and K10's, a pair at a time): tie
// masks uint8[Bs+1, A+1] in rows of ldm >= A+1 bytes, the int32 scores of
// the table (rows of A+1) when hs is not null, the corner score and the
// fused uint32 count, on the single-pair pipeline; top16 (sized for W
// warps' mask rings beside the top), bnd and flags as nw_score_count's.
extern "C" int nw_fill_masks(const int* top, const int* side, int A, int Bs,
                             int m, int k, int d, int blocks, int warps,
                             void* top16, void* bnd, int* flags, void* masks,
                             int ldm, int* hs, int* score, void* count,
                             void* stream) {
  const PipeOuts out{nullptr, 0, nullptr, static_cast<unsigned char*>(masks), ldm, hs};
  auto t16 = static_cast<short*>(top16);
  auto cnt = static_cast<unsigned*>(count);
  auto s = static_cast<cudaStream_t>(stream);
  if (hs)
    return launch_single_pipe<true, kOutMasksScores>(
        top, side, A, Bs, 0, nullptr, m, k, d, blocks, warps, t16, bnd, flags, nullptr, score,
        cnt, s, out);
  return launch_single_pipe<true, kOutMasks>(
      top, side, A, Bs, 0, nullptr, m, k, d, blocks, warps, t16, bnd, flags, nullptr, score,
      cnt, s, out);
}

// K14 port (seed null, r0 0): the 2-bit greedy codes of the whole pair,
// uint32[ceil(Bs/32), 2*ceil((A+32)/32), 32], and its corner score, on
// the single-pair pipeline of blocks x warps warps.  K13 port a block a
// launch (seed int32[A+1] = row r0 of the pair; the checkpointed
// traceback runs nw_refill_blocks): the codes of rows r0+1 .. r0+Bs (side
// = the pair's side from row r0+1 on, Bs rows), in the same layout, and
// H[r0+Bs][A].  top16 as nw_score_count's, bnd int32[blocks, A+1]
// scratch, flags int32[blocks] zeroed.
extern "C" int nw_fill_codes_single(const int* top, const int* side, int A,
                                    int Bs, int r0, const int* seed, int m,
                                    int k, int d, int blocks, int warps,
                                    void* top16, void* bnd, int* flags, void* codes,
                                    int* score, void* stream) {
  return launch_single_pipe<false, kOutCodes>(
      top, side, A, Bs, r0, seed, m, k, d, blocks, warps, static_cast<short*>(top16), bnd,
      flags, static_cast<unsigned*>(codes), score, nullptr, static_cast<cudaStream_t>(stream));
}

// K11 port (ckpt null): one pair's corner score, nothing stored per cell.
// K12 port: also rows 0, C, 2C, ... below the last row into ckpt,
// int32[ceil(Bs/C), A+1]; C = every, a multiple of 32.  On the
// single-pair pipeline; top16, bnd and flags as nw_fill_codes_single's.
extern "C" int nw_score_single(const int* top, const int* side, int A, int Bs,
                               int m, int k, int d, int blocks, int warps,
                               void* top16, void* bnd, int* flags, int* ckpt, int every,
                               int* score, void* stream) {
  return launch_single_pipe<false, kOutRows>(
      top, side, A, Bs, 0, nullptr, m, k, d, blocks, warps, static_cast<short*>(top16), bnd,
      flags, nullptr, score, nullptr, static_cast<cudaStream_t>(stream),
      PipeOuts{ckpt, every, nullptr, nullptr, 0, nullptr});
}

// K9 port: one pair's row Bs, H[Bs][0..A], into last int32[A+1], and its
// corner score; top16, bnd and flags as nw_score_single's.
extern "C" int nw_last_row(const int* top, const int* side, int A, int Bs,
                           int m, int k, int d, int blocks, int warps,
                           void* top16, void* bnd, int* flags, int* last, int* score,
                           void* stream) {
  return launch_single_pipe<false, kOutRows>(
      top, side, A, Bs, 0, nullptr, m, k, d, blocks, warps, static_cast<short*>(top16), bnd,
      flags, nullptr, score, nullptr, static_cast<cudaStream_t>(stream),
      PipeOuts{nullptr, 0, last, nullptr, 0, nullptr});
}

// K14's mesh half (codes non-null: 2-bit codes; masks and codes null:
// scores only) and K28 (masks non-null: 3-bit tie masks) on one tile of a
// pair whose rows are sharded: rows r0+1 .. r0+H (side = the pair's side
// from row r0+1 on, H >= 1 rows) and columns c0+1 .. c0+C of a pair of
// width A (top = the whole top string), on the single-pair pipeline of
// blocks x warps warps (header, "The tiles").  halo int32[C+1] is row r0
// at columns c0 .. c0+C, left int32[H] column c0 at rows r0+1 .. r0+H;
// right int32[H] receives column c0+C, bottom int32[c0 % 16 + C + 1] row
// r0+H at columns c0 - c0 % 16 .. c0+C (the tile's bottom edge from
// bottom[c0 % 16 + 1] on), score the cell (r0+H, c0+C).  codes
// uint32[ceil(H/32), 2*ceil((A+32)/32), 32] (zeroed before the rank's
// first tile: a tile ORs the words it shares with its neighbours) or
// masks uint8[H, A+1] hold the rank's rows; the tile with c0 = 0 also
// writes column 0.  top16, bnd and flags as nw_fill_codes_single's at
// c0 % 16 + C columns.
extern "C" int nw_fill_tile(const int* top, const int* side, int A, int C,
                            int H, int c0, const int* halo, const int* left,
                            int m, int k, int d, int blocks, int warps,
                            void* top16, void* bnd, int* flags, void* codes, void* masks,
                            int* right, int* bottom, int* score, void* stream) {
  if ((codes && masks) || c0 < 0 || C < 0 || c0 > A - C)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = c0 & 15;
  const int first = (c0 - e) >> 4;        // the tile's first code word of a band row
  const int tw = 2 * ((A + 1 + 31 + 31) >> 5);  // code words of a band row
  const int last = e + C;                 // the kernel's last column: the tile's right edge
  PipeOuts out{};
  out.last = bottom;
  out.masks = masks ? static_cast<unsigned char*>(masks) + (c0 - e) : nullptr;
  out.ldm = A + 1;
  out.left = left;
  out.right = right;
  out.e = e;
  out.keep = c0 > 0 ? e + 1 : 0;       // column c0 is the tile's on the left
  out.lo_own = c0 > 0 ? e + 1 : -32;  // (left of column 0: no column)
  out.hi_own = c0 + C < A ? last : 1 << 30;  // (past column A: no column)
  out.tw = tw;
  out.words = tw - first;
  auto cw = codes ? static_cast<unsigned*>(codes) + static_cast<int64_t>(first) * 32 : nullptr;
  auto t16 = static_cast<short*>(top16);
  auto s = static_cast<cudaStream_t>(stream);
  const int* tp = top + (c0 - e);  // the kernel's column x is the pair's c0 - e + x
  if (codes)
    return launch_single_pipe<false, kOutTileCodes>(
        tp, side, last, H, 0, halo, m, k, d, blocks, warps, t16, bnd, flags, cw, score, nullptr,
        s, out);
  if (masks)
    return launch_single_pipe<false, kOutTileMasks>(
        tp, side, last, H, 0, halo, m, k, d, blocks, warps, t16, bnd, flags, nullptr, score,
        nullptr, s, out);
  return launch_single_pipe<false, kOutTile>(
      tp, side, last, H, 0, halo, m, k, d, blocks, warps, t16, bnd, flags, nullptr, score,
      nullptr, s, out);
}

// K13 port, grouped: rows r0+1 .. r0+Bs of a pair (side = the pair's side
// from row r0+1 on, Bs >= 1 rows) in blocks of C rows (C a multiple of
// 32; only the last block short), block g re-filled from seeds[g], the
// pair's row r0 + g*C (int32[G, A+1], G = ceil(Bs/C)), all in one
// cooperative launch of blocks x warps warps.  codes uint32[ceil(Bs/32),
// 2*ceil((A+32)/32), 32]: block g's bands are bands g*C/32 on, each as
// nw_fill_codes_single writes it; corners int32[G] the blocks' last
// cells H[r0 + min(Bs, (g+1)*C)][A].  ring is [G * min(blocks*warps,
// C/32), A+1] scratch, done int32[blocks*warps] zeroed.
extern "C" int nw_refill_blocks(const int* top, const int* side, int A, int Bs,
                                int C, int r0, const int* seeds, int m, int k,
                                int d, int blocks, int warps, int* ring,
                                int* done, void* codes, int* corners,
                                void* stream) {
  if (warps < 1 || warps > kMaxWarps || blocks < 1 || A < 0 || Bs < 1 || C < 32 ||
      C % 32 || r0 < 0 || !seeds)
    return static_cast<int>(cudaErrorInvalidValue);
  auto cw = static_cast<unsigned*>(codes);
  // cooperative: all blocks co-resident (or the launch is refused), since
  // a band spins on the band above it, which another block may run
  void* args[] = {&top, &side, &A, &Bs, &C, &r0, &seeds, &m, &k, &d,
                  &ring, &done, &cw, &corners};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(nw_refill_kernel), dim3(blocks), dim3(32 * warps), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it; the caller gets this launch's error
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
