// Batched greedy traceback walk for Hopper (sm_90a).
//
// Replaces the JAX walk loops that read K2's 2-bit greedy words on the
// TPU: nw_tpu/ops/banded_traceback.py:_make_walk_loop (the group walk
// of the one-pass and two-pass engines) and
// nw_tpu/ops/traceback.py:traceback_greedy2.  Those were jnp code, not
// Pallas; in eager PyTorch a 20 000-step loop of small ops is bound by
// launch overhead, so the walk is a kernel too.  The codes engine fills
// the codes of the whole sub-batch at once (nw_fill.cu) and walks each
// pair in one pass (nw_walk).  The two-pass engines re-fill one group of
// bands at a time (nw_fill_span) and walk every pair whose cursor lies in
// it (nw_walk_groups: _make_walk_loop with global_bands=False, a warp a
// pair from its (i, j, n) in device memory to the group's top row); its
// ops go in place at the running n, the on-device stitch
// (device_stitch_pack) done as they are written, or as a per-group
// prefix that the host stitches.  The variant tracebacks' two-pass route
// walks the same way over its own re-filled groups: sw_walk_groups (the
// local walk over SW and overlap codes, _sw_walk_device's and
// _overlap_walk_device's group walks), whose finished walk lies below
// every group above it and so walks nowhere there, its (i, j) the cell
// where it stopped; and gotoh_walk_groups (_affine_walk_device's), whose
// cursor carries the walk's state (0 M, 1 IX, 2 IY) across the groups'
// edges, the state walk_staged's Gotoh mode leaves on row j0.
//
// Contract.  A walk starts at the true corner (len2, len1), reads the
// 2-bit code of its cell from the band-major layout of nw_fill.cu (word
// (band, t >> 4, jj) of code row 32 * band + jj, column i, t = i + jj;
// 0 diag, 1 left, 2 up: the code IS the op), writes it, and steps to the
// predecessor until it reaches the origin; on row 0, which is not
// stored, it steps LEFT.  ops[b] must arrive filled with OP_NONE (3); the
// walk writes its n real ops in walk order (corner -> origin).
//
// What holds it back on the H100: the chain of dependent loads.  Each
// step's address depends on the previous step's code, so a walk of N
// steps is N loads in series whatever the card's bandwidth: its bytes (the
// codes it reads, 2 bits a step; the bound) would take under a
// microsecond.  A design that takes one dependent load a step has a
// latency floor, the span: the longest walk's steps times one dependent
// shared-memory load (23 cycles on an H100, by nw_smem_chase below).  The
// span is this design's floor, not the function's bound: a walk that
// composed steps ahead (a table of two-step deltas, say) would halve the
// chain.  So the design keeps each step's load in shared memory, its
// chain short, and a warp's lanes on one path.
//
// Design (walk_staged, shared by nw_walk and nw_walk_window's codes
// mode, and in modes of their own by sw_walk and gotoh_walk).  A warp a
// walk; nw_walk packs kWalkWarps walks a block so that a batch spreads
// over the SMs.  The walk's geometry makes its reads
// predictable: inside a band a step takes (t, jj) to (t-2, jj-1) (DIAG),
// (t-1, jj) (LEFT) or (t-1, jj-1) (UP), so t never rises and the band's
// word columns t >> 4 are read in falling order; and since i never rises,
// every band above is entered at a column <= (i + 31) >> 4.  So the warp
// keeps a ring of R = D + 1 slots in shared memory, each a segment of K
// word columns [top - K + 1, top] of one band (K x 128 contiguous bytes,
// a column's 32 words), copied by the TMA's one-dimensional form
// (cp.async.bulk, completing on the slot's mbarrier).  On entering band b
// it waits for b's slot and issues band b - D's copy with top = (i + 31)
// >> 4, so D bands are in flight while the walk runs; a walk that leaves
// its segment below (a LEFT run longer than it, or a band entered past its
// columns) re-copies the band's slot at its column and waits.  From the
// slot the warp expands kTableCols columns, lane jj its row, into a table
// of byte deltas (walk_staged's note), so that a step is one shared-memory
// byte load and one subtract, the next cell's address; every lane walks
// the same path (broadcast loads, no divergence), lane 0 stages the op
// bytes in a 128-byte buffer and the warp stores them 32 bytes an
// instruction, row 0's LEFT run likewise.  Tensor cores have no part in a
// walk.  K = kSegCols, D = kDepth and the warps a block are constants (16,
// 2, 2, from the sweep of scripts/walk_profile.py --sweep, which rebuilds
// this file with -DNW_WALK_SEG_COLS= and the others: K and D hardly
// matter once a segment covers the drift of the band D bands ahead).
//
// What the card showed (an H100, scripts/walk_profile.py's clock64
// counters and scripts/walk_shapes.py): a step costs ~80 cycles at 100 kb
// (42 ns, 3.6x the span): ~48 walking the table (its chain is two
// SASS instructions, LDS.U8 -> IADD: a 23-cycle load and an add; the rest
// is the loop's tests and the steps a group of kUnroll spends on a band's
// last sentinel), ~13 expanding it, ~7 issuing the next band's copy, ~2
// waiting for one, ~2 storing ops.  Hiding the per-band work behind the
// walk (a second warp a walk) is left for later.
//
// nw_walk_masks is the same walk over the rectangular 3-bit tie masks of
// a batch, uint8[B, Bs+1, A+1] (nw_fill.cu's MASKS mode, or
// nw_fill_masks a pair at a time): the jnp walk of
// nw_tpu/ops/traceback.py:38 traceback_greedy, vmapped at :197-207 over
// the masks of K2's pack_bits=8 mode and of K10.  Each step takes the
// first set bit of bits 0-2 in diag > left > up order, UP where none is
// set (bits 3-7 are not read); row 0 steps LEFT, as nw_walk.  Its design
// (walk_masks_staged) is walk_staged's over row-major bytes.  A warp a
// walk, kMaskWarps walks a block.  The walk's cells again fall in column
// and row, so each band's columns [top - kMaskCols + 1, top], top = the
// walk's i on entering the band D below, are copied into a ring slot D
// bands ahead.  A band's slot is 32 row pieces, not one contiguous run:
// rows start A+1 bytes apart, at any offset mod 16, so a 2-D TMA copy
// (whose global stride is a multiple of 16 bytes) cannot take them.
// Each piece is widened to the 16-byte blocks that hold it and copied by
// 16-byte cp.async (LDGSTS), the band's blocks spread over the warp's
// lanes, each lane arriving on the slot's mbarrier when its copies land;
// a one-dimensional bulk copy a row (cp.async.bulk) cost five times as
// many cycles a step to issue (~50 against ~10, walk_profile.py's
// counters on an H100).  Row jj's lane keeps its offset in its first
// block.  A widened copy never touches an unmapped page:
// each 16-byte block it reads holds a byte of the row piece, which lies
// in the table, and a page is a whole number of aligned 16-byte blocks.
// From the slot, each lane expands kMaskTableCols bytes of its row, from
// the walk's column down, into a table of byte deltas (LEFT 1, UP a
// table row, DIAG a table row + 1) with a funnel shift and four byte
// operations a word of four cells, so that a step is again one
// shared-memory byte load and one subtract on the chain; a walk that
// leaves the table's columns expands it again, one that leaves the slot's
// re-copies it at its column and waits.  Tensor cores have no part in a
// walk.  A table whose column 0 is not UP (no fill writes one) stops the
// walk where it leaves column 0.
//
// nw_walk_runs is the run-skip walk over the run bytes min(run, 63) << 2
// | code of nw_fill.cu's RUNS mode (nw_fill_runs_batch), the counterpart
// of nw_tpu/ops/banded_traceback.py:187 _make_runs_walk_loop.  Each
// dependent load consumes a whole run: diag K moves to (j-K, i-K), left
// K to (j, i-K), up to (j-1, i); row 0 steps LEFT and column 0 UP to the
// origin with no load.  The walk writes the expanded op string straight
// into its row of ops, so it needs no record buffer: the TPU engine's
// record cap (_runs_record_cap, RunsRecordOverflow and its fallback to
// the per-cell engine) was a limit of its traced loop and has no
// counterpart.  The run table has the tie masks' layout, so its design is
// walk_masks_staged's in a runs mode: a warp a walk, kRunsWarps walks a
// block, each band's row pieces staged one band ahead by 16-byte cp.async
// as for the masks.  What is new is the step.  A run's jump (K rows and
// columns, K columns, a row) no longer fits a byte.  Each lane expands
// its row into a table of the run bytes themselves, and the walk decodes
// each on its chain: a load, the code's multiplier picked by a byte
// permute, and one multiply-add of the run into the address (run_step).
// A table of 16-bit cells, each its run's whole jump (a load and a
// subtract on the chain), was measured and dropped: on an H100 its longer
// expansion and its decode of the ops off the chain cost more than the
// two operations it saved on it (scripts/walk_profile.py --runs: 106
// cycles a run walking and 87 expanding against 69 and 46, 0.72 ms a
// launch at config 3 against 0.49; PERF.md).  A byte whose run lands outside the table (a LEFT run of up
// to 63 columns, a DIAG run of up to 32, against a table of
// kRunsTableCols) is expanded as 0, the sentinel of every table here, so
// the walk expands the table again at its cell, and copies the band's
// slot again at its column where the slot cut the table.  No fill
// writes a 0 byte in the true table (a DIAG run is >= 1, LEFT >= 1, UP
// and column 0 are the byte 2; nw_fill.cu zeroes only the cells outside
// it).  The expansion works on four bytes at a time with no branch
// (run_word; a branch a byte, divergent across the lanes, took 4.5-7x
// its cycles).
// Each run's K ops go from the warp's lanes straight to device memory,
// up to 32 bytes a store, the next run's load issued first.
//
// nw_walk_window is the same walk over ONE block of rows (j0, j0+rows]
// of one pair, re-filled from a checkpoint row by nw_fill_codes_single:
// the block walk of nw_tpu/ops/checkpoint_traceback.py:353-373 and the
// relay walk of nw_tpu/parallel/huge_pair.py:871 (_make_relay_walk,
// _make_arrow_at_pallasb), both jnp loops on the TPU.  It reads
// (i, j, n) from device memory, walks until it reaches row j0 (or, when
// j0 is 0, the origin, stepping LEFT along row 0), and writes (i, j, n)
// back, so the blocks of a pair chain on one stream with no host sync.
// Its codes mode is one warp on walk_staged's ring (a launch a window);
// code row of cell row j: j - j0 - 1.  Its masks mode walks the 3-bit tie
// masks (bit0 diag, bit1 left, bit2 up) of a rank's rows of a sharded pair
// instead, uint8[rows, A+1] row-major from nw_fill_tile's masks mode
// (K28): the first set bit in diag > left > up order, UP where none is
// set, as the relay walk over K28's words does
// (nw_tpu/parallel/huge_pair.py:894-903, _make_arrow_at_pallas); one warp
// on walk_masks_staged's ring, a launch a window.
//
// sw_walk is the Smith-Waterman walk over the local codes of
// nw_fill.cu's LOCAL mode (sw_fill_codes): the jnp loops
// nw_tpu/models/smith_waterman.py:220 _sw_walk_packed (over K24's words)
// and nw_tpu/ops/variants_banded.py:1177 _sw_walk_device (over K18's).  A
// walk starts at its best cell (j*, i*), follows the codes and stops on a
// STOP code (a cell of score 0, a local start) or on row 0 or column 0,
// whose cells are 0 and not read: not nw_walk's rule, which steps LEFT
// along row 0.  It writes its ops in walk order and the cell where it
// stopped.  It walks the overlap codes of nw_fill.cu's OVERLAP mode
// (overlap_fill_codes) unchanged, from the end cell to row 0 or column 0:
// the jnp loops nw_tpu/models/overlap.py:178 _overlap_walk_diag and
// nw_tpu/ops/variants_banded.py:752 _overlap_walk_device.  Its design is
// walk_staged's in the local mode: a warp a walk on the same ring and
// table, which ends where the walk reads 0 (a STOP's delta, or column 0,
// over which each lane writes 0 when it expands its row), kLocalWarps
// walks a block (1: at 128 pairs a walk an SM).
//
// gotoh_walk is Gotoh's three-state walk over the 4-bit codes of
// nw_affine.cu's CODES mode (gotoh_fill_codes): the jnp loops
// nw_tpu/models/affine.py:340 _affine_walk_packed (over K25's words) and
// nw_tpu/ops/variants_banded.py:1698 _affine_walk_device (over K21's).  A
// walk starts at the true corner in the corner's state.  In state M it
// emits DIAG and moves to the state in bits 0-1 of its cell (3 as IY); in
// IX it emits LEFT and stays in IX when bit 2 is set, else moves to M; in
// IY it emits UP and stays in IY when bit 3 is set, else M.  On row 0 it
// steps LEFT to the origin and on column 0 UP, whatever its state: it
// never reads a cell outside the rectangle (nw_tpu's walks read side[j-1]
// at j = 0 when the states near the sentinel send them there).  Its design
// is walk_staged's in the Gotoh mode: a warp a walk on a ring of its own
// sizes (kGotohSegCols columns of 8 cells, kGotohDepth bands ahead), with
// the state in the table's address so that a step stays one byte load and
// one subtract (walk_staged's note); the warp writes the UP run along
// column 0 as it writes the row-0 LEFT run.  What the card showed
// for both (an H100, scripts/walk_profile.py --sw / --gotoh): PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOpDiag = 0;
constexpr int kOpLeft = 1;
constexpr int kOpUp = 2;
constexpr int kCodeStop = 3;

// ---- the staged walk over band-major 2-bit codes ----

// The staged walks' own min and max: the kernels' machine code was checked
// with these (CUDA's min and max compile to other instructions in places)
__device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }
__device__ __forceinline__ int imax(int x, int y) { return x > y ? x : y; }

constexpr int kOpBuf = 128;  // op bytes a warp stages before a store
constexpr int kColBytes = 128;  // a word column: a band's 32 rows x 4 bytes
constexpr int kUnroll = 8;  // steps between two tests of the walk's loop
// The delta table: word columns expanded at a time (a band's walk spans
// ~5 on a diagonal path), and its row: a 16-byte block of sentinels, then
// 16 cells a byte a column; its deltas (up to kRowBytes + 2) fit a byte
constexpr int kTableCols = 6;
constexpr int kRowBytes = 16 * (kTableCols + 1);

// The staging: K word columns a segment, D bands copied ahead of the walk
// into a ring of R = D + 1 slots, walks (warps) a block of nw_walk.  From
// a sweep on an H100; scripts/walk_profile.py --sweep rebuilds this file
// with others.
#ifndef NW_WALK_SEG_COLS
#define NW_WALK_SEG_COLS 16
#endif
#ifndef NW_WALK_DEPTH
#define NW_WALK_DEPTH 2
#endif
#ifndef NW_WALK_WARPS
#define NW_WALK_WARPS 2
#endif
constexpr int kSegCols = NW_WALK_SEG_COLS;
constexpr int kDepth = NW_WALK_DEPTH;
constexpr int kRing = kDepth + 1;
constexpr int kWalkWarps = NW_WALK_WARPS;

// A warp's shared memory: the ring's slots, the delta table (33 rows),
// the 256-entry expansion table, the ring's mbarriers and segment starts,
// the op buffer; a multiple of 128 bytes
constexpr int kWarpBytes =
    (kRing * kSegCols * kColBytes + 33 * kRowBytes + 1024 + kRing * 12 + kOpBuf + 127) & ~127;
static_assert(kWalkWarps * kWarpBytes <= 48 * 1024, "a block's staging past 48 KB of shared memory");

// The walks walk_staged serves: Needleman-Wunsch's and Smith-Waterman's
// (and overlap's) over 2-bit codes, Gotoh's three states over 4-bit codes
enum WalkMode { kGlobal, kLocal, kGotoh };

// The local walk's walks (warps) a block of sw_walk; the rest of its
// staging is the code walk's.  From a sweep on an H100
// (scripts/walk_profile.py --sw --sweep): at 128 pairs one walk an SM.
#ifndef NW_WALK_LOCAL_WARPS
#define NW_WALK_LOCAL_WARPS 1
#endif
constexpr int kLocalWarps = NW_WALK_LOCAL_WARPS;
static_assert(kLocalWarps * kWarpBytes <= 48 * 1024, "a block's staging past 48 KB of shared memory");

// Gotoh's staging: K word columns (8 cells each) a segment, D bands ahead,
// walks a block of gotoh_walk, and the words a delta-table row expands.
// From a sweep on an H100 (scripts/walk_profile.py --gotoh --sweep, which
// rebuilds this file with others): one walk a block, the fewest bytes
// copied ahead (K 16, D 1) and 6 words (48 cells, ~1.5 a band's path) were
// 6% faster at 128 x 3 kb and 28% at 4 096 x 150 bp than K 24, D 2, 2
// warps and 7 words.
#ifndef NW_WALK_GOTOH_SEG_COLS
#define NW_WALK_GOTOH_SEG_COLS 16
#endif
#ifndef NW_WALK_GOTOH_DEPTH
#define NW_WALK_GOTOH_DEPTH 1
#endif
#ifndef NW_WALK_GOTOH_WARPS
#define NW_WALK_GOTOH_WARPS 1
#endif
#ifndef NW_WALK_GOTOH_TABLE
#define NW_WALK_GOTOH_TABLE 6
#endif
constexpr int kGotohSegCols = NW_WALK_GOTOH_SEG_COLS;
constexpr int kGotohDepth = NW_WALK_GOTOH_DEPTH;
constexpr int kGotohWarps = NW_WALK_GOTOH_WARPS;
constexpr int kGotohWords = NW_WALK_GOTOH_TABLE;
// a Gotoh delta-table row: a 16-byte block of sentinels, then 8 cells a
// word of 4 bytes, one a state (M, IY, IX, unused); its deltas (up to
// kGotohRowBytes + 4) fit a byte
constexpr int kGotohRowBytes = 16 + 32 * kGotohWords;
constexpr int kSlotIY = 1, kSlotIX = 2;  // a state's byte in a cell (M's is 0)
static_assert(kGotohRowBytes + 4 < 256 && kGotohWords > 0, "a Gotoh delta past a byte");
// A warp's shared memory, as kWarpBytes with a 2 KB expansion table
constexpr int kGotohWarpBytes = ((kGotohDepth + 1) * kGotohSegCols * kColBytes + 33 * kGotohRowBytes + 2048 +
                                 (kGotohDepth + 1) * 12 + kOpBuf + 127) & ~127;
static_assert(kGotohWarps * kGotohWarpBytes <= 48 * 1024, "a block's staging past 48 KB of shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One warp's ring of R segments of K code columns.  Every lane holds the
// same copy of its registers; lane 0 alone issues the copies, every lane
// waits.
template <int K, int R>
struct CodeRing {
  const unsigned* codes;  // the walk's table: word (band, w, jj) at (band*TW + w)*32 + jj
  int TW;
  unsigned* seg;          // R slots of K*32 words
  uint32_t bars;          // shared address of slot 0's mbarrier (8 bytes a slot)
  int* lo;                // each slot's first column; below 0 past a wrap (see load)
  unsigned phase;         // bit s: the parity of slot s's next completion
  unsigned pending;       // bit s: slot s has a copy in flight
  bool lane0;

  __device__ void init() {
    if (lane0) {
      for (int s = 0; s < R; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bars + 8 * s) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    phase = pending = 0;
    __syncwarp();
  }

  // Copy word columns [top - K + 1, top] (cut at 0) of band b into slot
  // s, top = tv, a column t >> 4.  A tv below 0 (a walk that left column 0,
  // which codes a fill writes never send it to) wraps to the band's last
  // columns, as the plain versions' negative indexing reads them.  The
  // warp's reads of the slot are done (their values used) and ordered
  // before the copy by __syncwarp, as a consumer's release orders them in
  // a TMA pipeline.
  __device__ void load(int s, int b, int tv) {
    const int wrap = tv < 0 ? TW : 0;
    const int top = imax(imin(tv + wrap, TW - 1), 0);
    const int l = imax(top - K + 1, 0);
    lo[s] = l - wrap;
    __syncwarp();
    if (lane0) {
      const uint32_t bar = bars + 8 * s;
      const uint32_t bytes = (top - l + 1) * kColBytes;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(smem_u32(seg + s * K * 32)),
          "l"(codes + (static_cast<int64_t>(b) * TW + l) * 32), "r"(bytes), "r"(bar)
          : "memory");
    }
    pending |= 1u << s;
  }

  __device__ void wait(int s) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(bars + 8 * s), "r"((phase >> s) & 1u) : "memory");
    phase ^= 1u << s;
    pending &= ~(1u << s);
  }

  // No copy may outlive the block: wait for the ones the walk left behind
  __device__ void drain() {
    for (int s = 0; s < R; ++s)
      if (pending >> s & 1u) wait(s);
  }
};

// The op of a delta-table cell's value v
__device__ __forceinline__ signed char delta_op(unsigned v) {
  return static_cast<signed char>(v == 1u ? kOpLeft
                                  : v == kRowBytes + 1u ? kOpUp
                                  : v == kRowBytes + 2u ? kOpDiag : kCodeStop);
}

// A Gotoh delta-table cell of code c (bits 0-1 M's next state, bit 2 IX
// extends, bit 3 IY extends): its three state bytes, each how far back the
// next state's byte of the predecessor lies (rows kGotohRowBytes apart,
// columns 4).  M (byte 0) steps DIAG into the state of bits 0-1 (3 as IY),
// kGotohRowBytes + 4 - that state's byte; IY (byte 1) UP into IY or M,
// kGotohRowBytes + 1 - its byte; IX (byte 2) LEFT into IX or M, 4 + 2 -
// its byte.  So LEFT is 4 or 6, UP kGotohRowBytes or + 1 and DIAG
// kGotohRowBytes + 2 to + 4: a delta names its op.
__host__ __device__ constexpr unsigned gotoh_cell(unsigned c) {
  return ((c & 3) == 0 ? kGotohRowBytes + 4u : (c & 3) == 1 ? kGotohRowBytes + 4u - kSlotIX
                                                            : kGotohRowBytes + 4u - kSlotIY) |
         (c & 8 ? kGotohRowBytes : kGotohRowBytes + kSlotIY) << 8 | (c & 4 ? 4u : 4u + kSlotIX) << 16;
}

// The op of a walk's step by its delta: the state it left
template <int MODE>
__device__ __forceinline__ signed char walk_op(unsigned v) {
  if constexpr (MODE == kGotoh)
    return static_cast<signed char>(v < 16u ? kOpLeft : v < kGotohRowBytes + 2u ? kOpUp : kOpDiag);
  else
    return delta_op(v);
}

// One step of the walk over the delta table: the byte at shared address p,
// and p moved back by it (one PTX load and subtract, so that the chain of
// steps stays a load and a subtract a step)
__device__ __forceinline__ unsigned step(uint32_t& p) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];\n\tsub.s32 %1, %1, %0;" : "=r"(v), "+r"(p) : : "memory");
  return v;
}

// out[from .. to) from the op buffer's values (to - from <= kOpBuf), OP
// the op of a value, 32 bytes an instruction across the warp
template <signed char (*OP)(unsigned)>
__device__ __forceinline__ void flush_ops(const unsigned char* buf, int from, int to, int lane,
                                          signed char* __restrict__ out) {
  __syncwarp();
  for (int q = lane; q < to - from; q += 32) out[from + q] = OP(buf[q]);
  __syncwarp();
}

// Steps from the delta table's cell at shared address p until it reads 0
// (the walk has left the table), the op buffer is full or the walk has n
// = S ops; lane 0 puts each step's byte at buf[n - flushed].  Returns the
// last byte read.
__device__ __forceinline__ unsigned walk_table(uint32_t& p, int& n, int flushed, int S,
                                               unsigned char* buf, int lane) {
  const int lim = imin(S, flushed + kOpBuf);
  unsigned v = 1;
  while (n + kUnroll <= lim) {
    unsigned char* at = buf + (n - flushed);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v = step(p);
      if (lane == 0) at[u] = v;
      n += v != 0;
    }
    if (v == 0) break;
  }
  if (v != 0) {
    while (n < lim) {
      v = step(p);
      if (lane == 0) buf[n - flushed] = v;
      n += v != 0;
      if (v == 0) break;
    }
  }
  return v;
}

// Walk from (i, j) over the codes of rows j0+1 .. j0+32*nbands (`codes`,
// band-major, TW words a band row), writing ops from out[n], in one of
// three modes.  kGlobal (2-bit codes): stops at row j0 when j0 > 0, else
// at the origin (LEFT along row 0), or after S ops.  kLocal (2-bit codes,
// 3 STOP): stops on a STOP cell, on row j0 or on column 0, neither of
// which it reads, or after S ops, and returns the cell where it stopped.
// kGotoh (4-bit codes, 8 a word): from state st (0 M, 1 IX, else IY) to
// row j0 when j0 > 0, else to the origin (LEFT along row 0), UP along
// column 0 down to row j0 whatever the state, or S ops, and returns the
// state it is in there (the state it reached column 0 or row 0 in).  A
// warp, every lane with the same (i, j, n) in and out; wsmem is its
// kWarpBytes (kGotohWarpBytes) of shared memory.
//
// 2-bit codes: on entering a band (or leaving its table below) the warp
// expands the kTableCols word columns of the staged segment from the
// walk's cell's column down into a table of bytes, lane jj its row: cell
// (t, jj), t = i + jj, at byte (jj + 1) * kRowBytes + 16 + t - 16 * c0
// holds how far back its predecessor lies, 1 (LEFT), kRowBytes + 1 (UP) or
// kRowBytes + 2 (DIAG).  Row jj = -1 and each row's first 16 bytes hold 0,
// and so does a cell of code 3: a walk that reads 0 has left the band, the
// table, or met such a code, and stays there.  kGlobal emits code 3's op
// and moves on the diagonal, as the plain walk does (no fill writes one);
// kLocal stops there, and its lane jj writes 0 at column 0 (t = jj), so
// that it stops there whatever the code.  A step is then one byte load
// and one subtract on the walk's shared-memory pointer; its byte goes to
// the op buffer at a fixed offset, and the op comes from it at the flush.
//
// Gotoh: the state goes into the address.  A cell is 4 bytes, one a state
// (gotoh_cell), and the table's rows are rectangular: cell (i, jj) in
// state slot z at byte (jj + 1) * kGotohRowBytes + 16 + 4 * (i - c0) + z,
// so that one byte load and one subtract step the walk to its next cell
// in its next state.  Lane jj expands its row from column c0 = the walk's
// column less 8 * kGotohWords - 1 (cut at the slot's first cell), reading
// its own words of the slot (t = i + jj: a funnel shift a word) through a
// 256-entry table of two cells; it writes 0 over column 0.  A band's path
// spans ~32 columns of i but ~64 of t, so one expansion of 48 cells serves
// a band where rows of t as wide would take two.  A walk that reads 0 has
// left the band, the table's columns, or reached column 0.
template <int MODE>
__device__ __forceinline__ int walk_staged(const unsigned* __restrict__ codes, int TW,
                                           unsigned char* wsmem, int j0, int S,
                                           int& i, int& j, int& n,
                                           signed char* __restrict__ out, int st = 0) {
  constexpr bool kG = MODE == kGotoh;
  constexpr int K = kG ? kGotohSegCols : kSegCols, D = kG ? kGotohDepth : kDepth, R = D + 1;
  constexpr int kShift = kG ? 3 : 4;  // the cells a word: 1 << kShift
  constexpr int kRow = kG ? kGotohRowBytes : kRowBytes;
  const int lane = threadIdx.x & 31;
  unsigned char* table = wsmem + R * K * kColBytes;
  unsigned* lut = reinterpret_cast<unsigned*>(table + 33 * kRow);
  unsigned char* books = reinterpret_cast<unsigned char*>(lut + (kG ? 512 : 256));  // mbarriers, then lo
  unsigned char* buf = books + R * 12;
  int flushed = n;  // out[flushed .. n) wait in buf
  if (j > j0 && n < S) {
    CodeRing<K, R> ring{codes, TW, reinterpret_cast<unsigned*>(wsmem), smem_u32(books),
                        reinterpret_cast<int*>(books + 8 * R), 0, 0, lane == 0};
    ring.init();
    const int r = j - j0 - 1;
    // t: the walk's column in the table, i + jj (2-bit codes) or i (Gotoh)
    int band = r >> 5, jj = r & 31, t = kG ? i : i + jj;
    int s = band % R;  // band's slot; band - q's is (s - q) mod R
    ring.load(s, band, (kG ? t + jj : t) >> kShift);
    for (int q = 1; q <= D && band - q >= 0; ++q)
      ring.load((s - q + R) % R, band - q, (i + 31) >> kShift);
    // the sentinels, and the expansion of a byte of codes into cells
    for (int q = lane; q < 33 * kRow / 16; q += 32)
      reinterpret_cast<uint4*>(table)[q] = make_uint4(0, 0, 0, 0);
    if constexpr (kG) {
      for (int q = lane; q < 256; q += 32)
        reinterpret_cast<uint2*>(lut)[q] = make_uint2(gotoh_cell(q & 15), gotoh_cell(q >> 4));
    } else {
      constexpr unsigned deltas = (kRowBytes + 2) | 1u << 8 | (kRowBytes + 1) << 16;  // codes 0-2; 3 -> 0
      for (int q = lane; q < 256; q += 32)
        lut[q] = __byte_perm(deltas, 0, (q & 3) | (q & 12) << 2 | (q & 48) << 4 | (q & 192) << 6);
    }
    __syncwarp();
    int c0 = 0;
    int z = st == 0 ? 0 : st == 1 ? kSlotIX : kSlotIY;  // Gotoh: the state's byte in its cell
    uint32_t p = 0;  // the shared address of the walk's cell in the table
    for (bool cut = false; !cut;) {  // a band a pass, from its first row jj down
      ring.wait(s);
      for (bool fresh = true;;) {
        if (fresh) {  // the table from t's column down, from the staged segment
          __syncwarp();  // every lane's reads of the table before it is rewritten
          if constexpr (kG) {
            if ((t >> 3) < ring.lo[s]) {  // left of the segment: copy the band's columns at the cell
              ring.load(s, band, (t + jj) >> 3);
              ring.wait(s);
            }
            // lane jj's row from column c0 on: cell i holds the code at
            // i + jj, its words from (c0 + jj) >> 3 on, each funnel-shifted
            // to its first cell, cut at the walk's word (t + jj) >> 3, the
            // highest any row it reaches needs (a cell past the walk's,
            // never visited, repeats it)
            const int lo = ring.lo[s], ctop = (t + jj) >> 3;
            c0 = imax(t - 8 * kGotohWords + 1, 8 * lo);
            const int tl = c0 + lane;
            const unsigned* col = ring.seg + s * K * 32 + lane;
            unsigned w[kGotohWords + 1];
            uint2 d[4 * kGotohWords];
#pragma unroll
            for (int c = 0; c <= kGotohWords; ++c) w[c] = col[32 * (imin((tl >> 3) + c, ctop) - lo)];
#pragma unroll
            for (int c = 0; c < kGotohWords; ++c) {
              const unsigned x = __funnelshift_r(w[c], w[c + 1], 4 * (tl & 7));
#pragma unroll
              for (int q = 0; q < 4; ++q) d[4 * c + q] = reinterpret_cast<const uint2*>(lut)[x >> 8 * q & 255];
            }
            uint4* row = reinterpret_cast<uint4*>(table + (lane + 1) * kGotohRowBytes + 16);
#pragma unroll
            for (int c = 0; c < 2 * kGotohWords; ++c)
              row[c] = make_uint4(d[2 * c].x, d[2 * c].y, d[2 * c + 1].x, d[2 * c + 1].y);
            if (c0 == 0) reinterpret_cast<unsigned*>(row)[0] = 0;  // column 0: UP whatever its code
            __syncwarp();
            p = smem_u32(table) + (jj + 1) * kGotohRowBytes + 16 + 4 * (t - c0) + z;
          } else {
            if ((t >> 4) < ring.lo[s]) {  // below the segment: copy the band's columns at t
              if (t < -16 * TW) {  // off the table (codes no fill writes): stop
                cut = true;
                break;
              }
              ring.load(s, band, t >> 4);
              ring.wait(s);
            }
            const int ctop = t >> 4, lo = ring.lo[s];
            c0 = imax(ctop - kTableCols + 1, lo);
            const unsigned* col = ring.seg + (s * K + c0 - lo) * 32 + lane;
            uint4* row = reinterpret_cast<uint4*>(table + (lane + 1) * kRowBytes + 16);
            // every column, without a branch (a column past ctop, where the
            // walk never goes, repeats ctop's), all loads before any store so
            // that they overlap
            unsigned w[kTableCols], d[4 * kTableCols];
#pragma unroll
            for (int c = 0; c < kTableCols; ++c) w[c] = col[32 * imin(c, ctop - c0)];
#pragma unroll
            for (int q = 0; q < 4 * kTableCols; ++q) d[q] = lut[w[q >> 2] >> 8 * (q & 3) & 255];
#pragma unroll
            for (int c = 0; c < kTableCols; ++c)
              row[c] = make_uint4(d[4 * c], d[4 * c + 1], d[4 * c + 2], d[4 * c + 3]);
            if constexpr (MODE == kLocal) {  // column 0 (t = jj): a stop whatever its code
              if (lane >= 16 * c0) table[(lane + 1) * kRowBytes + 16 + lane - 16 * c0] = 0;
            }
            __syncwarp();
            p = smem_u32(table) + (jj + 1) * kRowBytes + 16 + t - 16 * c0;
          }
          fresh = false;
        }
        const unsigned v = walk_table(p, n, flushed, S, buf, lane);
        const int a = static_cast<int>(p - smem_u32(table)), row = a / kRow, off = a - row * kRow;
        jj = row - 1;
        if constexpr (kG) {
          t = c0 + ((off - 16) >> 2);
          z = (off - 16) & 3;
        } else {
          t = 16 * c0 + off - 16;
        }
        if (v != 0) {  // the buffer is full, or the cut after S ops
          flush_ops<walk_op<MODE>>(buf, flushed, n, lane, out);
          flushed = n;
          if (n == S) {
            cut = true;
            break;
          }
          continue;
        }
        if (jj < 0) break;  // the band's last row is done
        if (off < 16) {  // below the table's columns
          fresh = true;
          continue;
        }
        if constexpr (MODE == kGlobal) {
          // a code 3: its op, and the diagonal's move, as the plain walks
          if (lane == 0) buf[n - flushed] = kCodeStop;
          ++n;
          p -= kRowBytes + 2;
        } else {  // a STOP, or column 0: the walk ends on this cell
          cut = true;
          break;
        }
      }
      if (cut || band == 0) break;  // band 0's last row done: row j0
      // into the band above at its row jj = 31: i = t + 1 (jj was -1) over
      // 2-bit codes, i = t over Gotoh's; its slot s - 1, band - D's the
      // slot just left
      --band;
      jj = 31;
      if constexpr (!kG) t += 32;
      const int left = s;
      s = s ? s - 1 : R - 1;
      if (band - D >= 0) ring.load(left, band - D, ((kG ? t : t - jj) + 31) >> kShift);
    }
    i = kG ? t : t - jj;
    j = j0 + 32 * band + jj + 1;
    if constexpr (kG) st = z == 0 ? 0 : (z == kSlotIX ? 1 : 2);
    ring.drain();
  }
  flush_ops<walk_op<MODE>>(buf, flushed, n, lane, out);
  if constexpr (MODE != kLocal) {
    if (j0 == 0 && j == 0 && i > 0 && n < S) {  // row 0: LEFT to the origin
      const int m = imin(i, S - n);
      for (int q = lane; q < m; q += 32) out[n + q] = static_cast<signed char>(kOpLeft);
      n += m;
      i -= m;
    }
  }
  if constexpr (kG) {
    if (i == 0 && j > j0 && n < S) {  // column 0: UP to row j0 (the origin)
      const int m = imin(j - j0, S - n);
      for (int q = lane; q < m; q += 32) out[n + q] = static_cast<signed char>(kOpUp);
      n += m;
      j -= m;
    }
  }
  return st;
}

// A batch of pairs, a warp a pair, kWalkWarps pairs a block: a pair's
// nbands bands of 2-bit codes, TW words a band row
__global__ void nw_walk_staged_kernel(const unsigned* __restrict__ codes,
                                      const int* __restrict__ lens1,
                                      const int* __restrict__ lens2, int B,
                                      int nbands, int TW, int S,
                                      signed char* __restrict__ ops,
                                      int* __restrict__ ns) {
  __shared__ __align__(128) unsigned char smem[kWalkWarps * kWarpBytes];
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWalkWarps + warp;
  if (b >= B) return;
  int i = lens1[b];
  int j = lens2[b];
  int n = 0;
  walk_staged<kGlobal>(codes + b * nbands * TW * 32, TW, smem + warp * kWarpBytes, 0, S, i, j, n,
                       ops + b * S);
  if ((threadIdx.x & 31) == 0) ns[b] = n;
}

// One block of rows of one pair, one warp: nbands bands of 2-bit codes
__global__ void nw_walk_window_staged_kernel(const unsigned* __restrict__ codes,
                                             int nbands, int TW, int j0,
                                             int* __restrict__ state, int S,
                                             signed char* __restrict__ ops) {
  __shared__ __align__(128) unsigned char smem[kWarpBytes];
  int i = state[0], j = state[1], n = state[2];
  // a start outside the block's codes walks nowhere (n stays short)
  if (j < j0 || j > j0 + 32 * nbands || i < 0 || i >= 16 * TW - 31 || n < 0) return;
  walk_staged<kGlobal>(codes, TW, smem, j0, S, i, j, n, ops);
  if (threadIdx.x == 0) {
    state[0] = i;
    state[1] = j;
    state[2] = n;
  }
}

// One group of rows of each pair of a batch, a warp a pair, kWalkWarps
// pairs a block: nbands bands of 2-bit codes a pair (rows j0+1 ..
// j0+32*nbands), each walk from its (i, j, n) in state[b] to row j0 (or
// the origin when j0 is 0), its ops at ops[b * stride + off[b] + t] for
// its t-th step here (off null: off[b] = n, the op string stitched in
// place), at most stride - off[b] of them
__global__ void nw_walk_groups_kernel(const unsigned* __restrict__ codes, int B, int nbands,
                                      int TW, int j0, int* __restrict__ state,
                                      const int* __restrict__ off, int stride,
                                      signed char* __restrict__ ops) {
  __shared__ __align__(128) unsigned char smem[kWalkWarps * kWarpBytes];
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWalkWarps + warp;
  if (b >= B) return;
  int* const st = state + 3 * b;
  int i = st[0], j = st[1], n = st[2];
  // a start outside the group's codes walks nowhere
  if (j < j0 || j > j0 + 32 * nbands || i < 0 || i >= 16 * TW - 31 || n < 0) return;
  const int n0 = n, o = off ? off[b] : n0;
  if (o < 0 || o > stride) return;
  // walk_staged writes step n at out[n]: out[n0] is ops[b, o]
  walk_staged<kGlobal>(codes + b * nbands * TW * 32, TW, smem + warp * kWarpBytes, j0,
                       n0 + stride - o, i, j, n, ops + b * stride + o - n0);
  if ((threadIdx.x & 31) == 0) {
    st[0] = i;
    st[1] = j;
    st[2] = n;
  }
}

// The local walk of a batch, a warp a pair, kLocalWarps pairs a block:
// from each best cell (j*, i*) to its STOP, row 0 or column 0
__global__ void sw_walk_staged_kernel(const unsigned* __restrict__ codes,
                                      const int* __restrict__ jstar,
                                      const int* __restrict__ istar, int B,
                                      int nbands, int TW, int S,
                                      signed char* __restrict__ ops,
                                      int* __restrict__ ns, int* __restrict__ iend,
                                      int* __restrict__ jend) {
  __shared__ __align__(128) unsigned char smem[kLocalWarps * kWarpBytes];
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kLocalWarps + warp;
  if (b >= B) return;
  int i = istar[b];
  int j = jstar[b];
  int n = 0;
  walk_staged<kLocal>(codes + b * nbands * TW * 32, TW, smem + warp * kWarpBytes, 0, S, i, j, n,
                      ops + b * S);
  if ((threadIdx.x & 31) == 0) {
    ns[b] = n;
    iend[b] = i;
    jend[b] = j;
  }
}

// The local walk of one group of rows of each pair of a batch, a warp a
// pair, kLocalWarps pairs a block: nw_walk_groups_kernel's contract over
// local or overlap codes.  A walk goes from its (i, j, n) in state[b] to
// its STOP, column 0 or row j0; one that stopped on a STOP or on column 0
// lies below row j0 and so walks nowhere in the groups above, and (i, j)
// is then the cell where it stopped (sw_walk's i_end, j_end).
__global__ void sw_walk_groups_kernel(const unsigned* __restrict__ codes, int B, int nbands,
                                      int TW, int j0, int* __restrict__ state,
                                      const int* __restrict__ off, int stride,
                                      signed char* __restrict__ ops) {
  __shared__ __align__(128) unsigned char smem[kLocalWarps * kWarpBytes];
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kLocalWarps + warp;
  if (b >= B) return;
  int* const st = state + 3 * b;
  int i = st[0], j = st[1], n = st[2];
  // a start outside the group's codes walks nowhere
  if (j < j0 || j > j0 + 32 * nbands || i < 0 || i >= 16 * TW - 31 || n < 0) return;
  const int n0 = n, o = off ? off[b] : n0;
  if (o < 0 || o > stride) return;
  walk_staged<kLocal>(codes + b * nbands * TW * 32, TW, smem + warp * kWarpBytes, j0,
                      n0 + stride - o, i, j, n, ops + b * stride + o - n0);
  if ((threadIdx.x & 31) == 0) {
    st[0] = i;
    st[1] = j;
    st[2] = n;
  }
}

// Gotoh's walk of one group of rows of each pair of a batch, a warp a
// pair, kGotohWarps pairs a block: nw_walk_groups_kernel's contract over
// 4-bit codes, the cursor state[b] = (i, j, n, st) carrying the walk's
// state across the groups' edges.
__global__ void gotoh_walk_groups_kernel(const unsigned* __restrict__ codes, int B, int nbands,
                                         int TW, int j0, int* __restrict__ state,
                                         const int* __restrict__ off, int stride,
                                         signed char* __restrict__ ops) {
  __shared__ __align__(128) unsigned char smem[kGotohWarps * kGotohWarpBytes];
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kGotohWarps + warp;
  if (b >= B) return;
  int* const st = state + 4 * b;
  int i = st[0], j = st[1], n = st[2];
  // a start outside the group's codes walks nowhere
  if (j < j0 || j > j0 + 32 * nbands || i < 0 || i >= 8 * TW - 31 || n < 0) return;
  const int n0 = n, o = off ? off[b] : n0;
  if (o < 0 || o > stride) return;
  const int s = walk_staged<kGotoh>(codes + b * nbands * TW * 32, TW, smem + warp * kGotohWarpBytes,
                                    j0, n0 + stride - o, i, j, n, ops + b * stride + o - n0, st[3]);
  if ((threadIdx.x & 31) == 0) {
    st[0] = i;
    st[1] = j;
    st[2] = n;
    st[3] = s;
  }
}

// Gotoh's walk of a batch, a warp a pair, kGotohWarps pairs a block: from
// each true corner in its state to the origin
__global__ void gotoh_walk_staged_kernel(const unsigned* __restrict__ codes,
                                         const int* __restrict__ lens1,
                                         const int* __restrict__ lens2,
                                         const int* __restrict__ states, int B,
                                         int nbands, int TW, int S,
                                         signed char* __restrict__ ops,
                                         int* __restrict__ ns) {
  __shared__ __align__(128) unsigned char smem[kGotohWarps * kGotohWarpBytes];
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kGotohWarps + warp;
  if (b >= B) return;
  int i = lens1[b];
  int j = lens2[b];
  int n = 0;
  walk_staged<kGotoh>(codes + b * nbands * TW * 32, TW, smem + warp * kGotohWarpBytes, 0, S, i, j, n,
                      ops + b * S, states[b]);
  if ((threadIdx.x & 31) == 0) ns[b] = n;
}

// ---- the staged walk over row-major tie masks ----

// Its staging: columns a row piece (a multiple of 16), bands copied ahead
// into a ring of D + 1 slots, walks (warps) a block of nw_walk_masks, and
// the columns of the delta table.  From a sweep on an H100 (a deeper ring
// copies a band at a column further right of where the walk enters it,
// so more re-copies); scripts/walk_profile.py --masks --sweep rebuilds
// this file with others.
#ifndef NW_WALK_MASK_COLS
#define NW_WALK_MASK_COLS 128
#endif
#ifndef NW_WALK_MASK_DEPTH
#define NW_WALK_MASK_DEPTH 1
#endif
#ifndef NW_WALK_MASK_WARPS
#define NW_WALK_MASK_WARPS 2
#endif
#ifndef NW_WALK_MASK_TABLE
#define NW_WALK_MASK_TABLE 64
#endif
constexpr int kMaskCols = NW_WALK_MASK_COLS;
constexpr int kMaskDepth = NW_WALK_MASK_DEPTH;
constexpr int kMaskRing = kMaskDepth + 1;
constexpr int kMaskWarps = NW_WALK_MASK_WARPS;
constexpr int kMaskTableCols = NW_WALK_MASK_TABLE;
constexpr int kMaskPitch = kMaskCols + 16;  // a slot's row: the piece widened to 16-byte blocks
// a delta table row: a 16-byte block of sentinels, then a byte a column;
// its deltas (up to kMaskRowBytes + 1) fit a byte
constexpr int kMaskRowBytes = 16 + kMaskTableCols;
static_assert(kMaskCols % 16 == 0 && kMaskTableCols % 16 == 0 && kMaskTableCols <= kMaskCols &&
              kMaskRowBytes + 1 < 256, "the masks walk's staging");
// A warp's shared memory: the ring's slots, the delta table (33 rows), the
// ring's mbarriers and segment starts, the op buffer; a multiple of 128
constexpr int kMaskWarpBytes =
    (kMaskRing * 32 * kMaskPitch + 33 * kMaskRowBytes + kMaskRing * 12 + kOpBuf + 127) & ~127;
static_assert(kMaskWarps * kMaskWarpBytes <= 48 * 1024, "a block's staging past 48 KB of shared memory");

// The run walk's staging, as the masks walk's: columns a row piece, bands
// copied ahead, walks a block of nw_walk_runs, columns of the table.  From
// a sweep on an H100 (scripts/walk_profile.py --runs --sweep rebuilds this
// file with others): the masks walk's values stayed best (0.49 ms a
// launch at config 3; 1 or 3 walks a block as fast, narrower or wider
// pieces and tables, a deeper ring 3-80% slower).
#ifndef NW_WALK_RUNS_COLS
#define NW_WALK_RUNS_COLS 128
#endif
#ifndef NW_WALK_RUNS_DEPTH
#define NW_WALK_RUNS_DEPTH 1
#endif
#ifndef NW_WALK_RUNS_WARPS
#define NW_WALK_RUNS_WARPS 2
#endif
#ifndef NW_WALK_RUNS_TABLE
#define NW_WALK_RUNS_TABLE 64
#endif
constexpr int kRunsCols = NW_WALK_RUNS_COLS;
constexpr int kRunsRing = NW_WALK_RUNS_DEPTH + 1;
constexpr int kRunsWarps = NW_WALK_RUNS_WARPS;
constexpr int kRunsTableCols = NW_WALK_RUNS_TABLE;
constexpr int kRunCap = 63;  // nw_fill.cu's run cap: a LEFT run's longest jump
// a table row: a 16-byte block of sentinels, then a byte a column
constexpr int kRunsRowBytes = 16 + kRunsTableCols;
// every run's landing lies in a table expanded at its cell (a LEFT run of
// the cap included); a code's multiplier (a DIAG cell's row + 1) fits a
// byte
static_assert(kRunsCols % 16 == 0 && kRunsTableCols % 16 == 0 && kRunsTableCols <= kRunsCols &&
              kRunsTableCols > kRunCap && kRunsRowBytes + 1 < 256, "the run walk's staging");
// A warp's shared memory: the ring's slots, the table (33 rows), the ring's
// mbarriers and segment starts (the ops go straight to device memory)
constexpr int kRunsWarpBytes = (kRunsRing * 32 * (kRunsCols + 16) + 33 * kRunsRowBytes + kRunsRing * 12 + 127) & ~127;
static_assert(kRunsWarps * kRunsWarpBytes <= 48 * 1024, "a block's staging past 48 KB of shared memory");

// One warp's ring of RING band segments of a row-major table: slot s
// holds, in row jj of 32, the 16-byte blocks of band b's row 32b + jj that
// cover columns [lo[s], top], COLS columns at most.  Every lane holds the
// same copy of the registers but `lane`; the lanes share a band's copies,
// every lane waits.
template <int COLS, int RING>
struct ByteRing {
  static constexpr int kPitch = COLS + 16;  // a slot's row: the piece widened to 16-byte blocks
  static constexpr int kBlocks = kPitch / 16;

  const unsigned char* masks;  // row r of the walk's table at masks + r * TW
  int TW, rows;
  unsigned char* seg;  // RING slots of 32 rows of kPitch bytes
  uint32_t bars;       // shared address of slot 0's mbarrier (8 bytes a slot)
  int* lo;             // each slot's first column
  unsigned phase;      // bit s: the parity of slot s's next completion
  unsigned pending;    // bit s: slot s has a copy in flight
  int lane;

  __device__ void init() {
    if (lane == 0) {
      for (int s = 0; s < RING; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;" ::"r"(bars + 8 * s) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    phase = pending = 0;
    __syncwarp();
  }

  // The row's offset in its slot: where column lo[s] lies in its first block
  __device__ int offset(int s, int b) const {
    return static_cast<int>(reinterpret_cast<uintptr_t>(masks + static_cast<int64_t>(32 * b + lane) * TW + lo[s]) &
                            15);
  }

  // Copy band b's columns [top - COLS + 1, top] (cut at 0 and A) into
  // slot s by 16-byte cp.async, each lane arriving on the slot's mbarrier
  // when its copies land (a row past the table copies nothing).  The
  // warp's reads of the slot are done and ordered before the copy by
  // __syncwarp, as in CodeRing::load.
  __device__ void load(int s, int b, int top) {
    top = imax(imin(top, TW - 1), 0);
    const int l = imax(top - COLS + 1, 0);
    const int row = 32 * b + lane;
    const uintptr_t from = reinterpret_cast<uintptr_t>(masks + static_cast<int64_t>(row) * TW + l);
    const uintptr_t first = from & ~static_cast<uintptr_t>(15);
    // the row's last block that holds a byte of its piece, -1 past the table
    const int last = row < rows ? static_cast<int>((from + (top - l) - first) >> 4) : -1;
    const uint32_t dst = smem_u32(seg + s * 32 * kPitch);
    __syncwarp();
    lo[s] = l;
    // turn k: lane q copies block c of row r, 32k + q = r * kBlocks + c,
    // so that a turn reads a few rows' neighbouring blocks, not 32 rows
    // (5-7% faster a walk)
    for (int k = 0; k < kBlocks; ++k) {
      const int q = 32 * k + lane, r = q / kBlocks, c = q - r * kBlocks;
      const uint64_t at = static_cast<uint64_t>(__shfl_sync(0xffffffffu, static_cast<unsigned>(first >> 32), r)) << 32 |
                          __shfl_sync(0xffffffffu, static_cast<unsigned>(first), r);
      if (c <= __shfl_sync(0xffffffffu, last, r))
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     ::"r"(dst + r * kPitch + 16 * c), "l"(at + 16 * c) : "memory");
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bars + 8 * s) : "memory");
    pending |= 1u << s;
  }

  __device__ void wait(int s) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "MWAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra MWAIT;\n"
        "}\n" ::"r"(bars + 8 * s), "r"((phase >> s) & 1u) : "memory");
    phase ^= 1u << s;
    pending &= ~(1u << s);
  }

  // No copy may outlive the block: wait for the ones the walk left behind
  __device__ void drain() {
    for (int s = 0; s < RING; ++s)
      if (pending >> s & 1u) wait(s);
  }
};

// Four tie masks (a byte each) -> their delta-table bytes: DIAG
// kMaskRowBytes + 1 where bit 0 is set, else LEFT 1 where bit 1 is, else
// UP kMaskRowBytes; bits 2-7 are not read
__device__ __forceinline__ unsigned mask_deltas(unsigned x) {
  const unsigned diag = x & 0x01010101u;
  const unsigned left = (x >> 1) & ~x & 0x01010101u;
  return kMaskRowBytes * 0x01010101u + diag - left * (kMaskRowBytes - 1);
}

// The op of a masks delta-table cell's value v (never a sentinel's 0)
__device__ __forceinline__ signed char mask_delta_op(unsigned v) {
  return static_cast<signed char>(v == 1u ? kOpLeft : v == kMaskRowBytes ? kOpUp : kOpDiag);
}

// The row-major byte tables walk_masks_staged walks
enum ByteTable { kMasks, kRuns };

// Four run bytes b = min(run, 63) << 2 | code, a word x at columns 4q ..
// 4q + 3 of the run table (columns from 0) in row jj (J4: jj + 1 in each
// byte) -> their decoded cells: a byte as it is where its run lands in the
// table, UP as a run of 1 (6), and 0 where it lands outside (a LEFT or
// DIAG run past column 0, a DIAG run past row -1) or no fill writes it
// (a run of 0, code 3).  The bytes side by side, with no branch (a branch
// a byte diverges across the lanes): the test y >= z of two bytes below
// 128 is bit 7 of (y | 0x80) - z, and a column past 127 counts as 127 (a
// run is at most 63).
__device__ __forceinline__ unsigned run_word(unsigned x, int q, unsigned J4) {
  constexpr unsigned kOnes = 0x01010101u, kHigh = 0x80808080u;
  const unsigned X4 = 4 * q + 3 < 128 ? 4u * q * kOnes + 0x03020100u : 0x7f7f7f7fu;
  const unsigned K4 = x >> 2 & 0x3f3f3f3fu;
  const unsigned hi = x >> 1;  // bit 0 of a byte: its code's bit 1
  const unsigned up = hi & ~x & kOnes, diag = ~(hi | x) & kOnes, left = x & ~hi & kOnes;
  const unsigned xj = ((((X4 | kHigh) - J4) & kHigh) >> 7) * 0xffu;  // X >= J
  const unsigned dm = diag * 0xffu;
  const unsigned lim = (((J4 & xj) | (X4 & ~xj)) & dm) | (X4 & ~dm);  // DIAG min(X, J), else X
  const unsigned fits = ((lim | kHigh) - K4) & ((K4 | kHigh) - kOnes) & kHigh;  // 1 <= K <= lim
  return (x & (((fits >> 7) & (diag | left)) * 0xffu)) | up * 6u;
}

// One run of the walk over the run table: the byte at shared address p,
// and p moved back by its jump: the byte's load, the code's multiplier
// (DIAG kRunsRowBytes + 1, LEFT 1, UP kRunsRowBytes, code 3 0) picked by a
// byte permute, and p less the run times it (one PTX sequence, so that
// the chain stays these four operations)
__device__ __forceinline__ unsigned run_step(uint32_t& p) {
  unsigned v;
  asm volatile(
      "{\n\t.reg .u32 s, m, k;\n\t"
      "ld.shared.u8 %0, [%1];\n\t"
      "and.b32 s, %0, 3;\n\t"
      "or.b32 s, s, 0x4440;\n\t"
      "prmt.b32 m, %2, %3, s;\n\t"
      "shr.u32 k, %0, 2;\n\t"
      "neg.s32 k, k;\n\t"
      "mad.lo.s32 %1, k, m, %1;\n\t}"
      : "=r"(v), "+r"(p)
      : "r"((kRunsRowBytes + 1u) | 1u << 8 | kRunsRowBytes << 16), "r"(0u)
      : "memory");
  return v;
}

// Runs from the run table's cell at shared address p until the walk reads
// 0 (its run's landing is not in the table, or it has left the band or
// met column 0) or has n >= S ops, kUnroll runs between two tests.  Every
// lane walks the same path; a run's K ops (K <= 63) go straight to
// out[n ..), lane q writing ops n + q and n + 32 + q, none from S on.
// Each run is loaded before the one before it is written out, so that
// its stores (in program order before the next load) wait for nothing.
// A 0 moves and writes nothing, so the runs after it change nothing; p
// stays on the 0.  Returns the cell read last (0, or any value once n >=
// S).
__device__ __forceinline__ unsigned walk_runs_table(uint32_t& p, int& n, int S, int lane,
                                                    signed char* __restrict__ out) {
  unsigned v = run_step(p);
  while (n < S) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned next = run_step(p);
      const int a = v & 3u, K = v >> 2;
      const int q = n + lane;
      if (lane < K && q < S) out[q] = static_cast<signed char>(a);
      if (lane + 32 < K && q + 32 < S) out[q + 32] = static_cast<signed char>(a);
      n += K;
      v = next;
    }
    if (v == 0) break;
  }
  return v;
}

// Walk from (i, j) over a row-major byte table of rows j0+1 .. j0+rows
// (`masks`, TW = A+1 bytes a row: cell row j at row j - j0 - 1), writing
// ops from out[n]; stops at row j0 when j0 > 0, else at the origin (LEFT
// along row 0; the run table: UP along column 0 too), or after S ops.  A
// warp, every lane with the same (i, j, n) in and out; wsmem is its
// kMaskWarpBytes (kRunsWarpBytes) of shared memory.  TABLE kMasks: 3-bit
// tie masks, a step a cell; kRuns: run bytes, a run a load.
//
// On entering a band (or leaving its table's columns) each lane jj
// expands columns [c0, c0 + E) of its row from the slot into row jj + 1
// of a table: a tie mask's cell (jj, i), a byte at (jj + 1) *
// kMaskRowBytes + 16 + i - c0, holds how far back its predecessor lies, 1
// (LEFT), kMaskRowBytes (UP) or kMaskRowBytes + 1 (DIAG).  Row jj = -1 and
// each row's first 16 bytes hold 0: a walk that reads 0 has left the band
// or the table's columns, and stays there.  c0 is the walk's column less
// E - 1, cut at the slot's first column, so that every cell the walk can
// reach from its cell in the table (rows jj and below, columns c0 .. i)
// lies in the slot.  A step is one byte load and one subtract; its byte
// goes to the op buffer, and its op comes from it at the flush.
//
// The run table's cell (jj, i), a byte at (jj + 1) * kRunsRowBytes + 16 +
// i - c0, is the run byte as it is, UP as a run of 1, or 0 where the run
// lands outside the table (run_word), and the lane of row jj writes 0
// over column 0.  A run is a load and three operations (run_step), the
// ops written from its byte.  A run of the cap lands in a table
// expanded at its cell (E > 63) unless the slot cut the table: so a walk
// that reads 0 on a row jj >= 0 right of column 0 goes on from a table
// expanded at its cell, and if that cell reads 0 too, from the band's
// slot copied again at its column.  A run writes its ops straight to
// device memory, so a run table has no op buffer.
template <int TABLE>
__device__ __forceinline__ void walk_masks_staged(const unsigned char* __restrict__ masks, int TW,
                                                  int rows, unsigned char* wsmem, int j0, int S,
                                                  int& i, int& j, int& n,
                                                  signed char* __restrict__ out) {
  constexpr bool kR = TABLE == kRuns;
  constexpr int RING = kR ? kRunsRing : kMaskRing, E = kR ? kRunsTableCols : kMaskTableCols;
  constexpr int ROW = kR ? kRunsRowBytes : kMaskRowBytes;
  using Ring = ByteRing<kR ? kRunsCols : kMaskCols, RING>;
  const int lane = threadIdx.x & 31;
  unsigned char* table = wsmem + RING * 32 * Ring::kPitch;
  unsigned char* books = table + 33 * ROW;  // the mbarriers, then lo
  unsigned char* buf = books + RING * 12;
  int flushed = n;  // out[flushed .. n) wait in buf
  if (j > j0 && n < S && (!kR || i > 0)) {
    Ring slots{masks, TW, rows, wsmem, smem_u32(books), reinterpret_cast<int*>(books + 8 * RING), 0, 0, lane};
    slots.init();
    const int r = j - j0 - 1;
    int band = r >> 5, jj = r & 31;
    int s = band % RING;  // band's slot; band - q's is (s - q) mod RING
    for (int q = 0; q < RING && band - q >= 0; ++q)
      slots.load((s - q + RING) % RING, band - q, i);
    for (int q = lane; q < 33 * ROW / 16; q += 32)
      reinterpret_cast<uint4*>(table)[q] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    int c0 = 0;
    uint32_t p = 0;  // the shared address of the walk's cell in the table
    uint32_t pf = 0;  // the run table: the walk's cell when the table was expanded
    bool recopy = false;  // the run table: copy the band's slot at the walk's column
    for (bool cut = false; !cut;) {  // a band a pass, from its row jj down
      slots.wait(s);
      for (bool fresh = true;;) {
        if (fresh) {  // the table from i's column down, from the band's slot
          __syncwarp();  // every lane's reads of the table before it is rewritten
          if (i < 0) {  // left column 0 (whose cells a fill writes UP): stop
            cut = true;
            break;
          }
          bool below = i < slots.lo[s];  // left of the slot: copy the band's columns at i
          if constexpr (kR) below = below || recopy;
          if (below) {
            slots.load(s, band, i);
            slots.wait(s);
          }
          const int lo = slots.lo[s];
          c0 = imax(i - E + 1, lo);
          // the lane's row from byte `at` of its slot row, a word of four
          // cells at a time: loads first, so that they overlap
          const int at = slots.offset(s, band) + c0 - lo;
          const unsigned* src =
              reinterpret_cast<const unsigned*>(slots.seg + (s * 32 + lane) * Ring::kPitch) + (at >> 2);
          unsigned w[E / 4 + 1], d[E / 4];
#pragma unroll
          for (int q = 0; q <= E / 4; ++q) w[q] = src[q];
          if constexpr (kR) {
            const unsigned J4 = (lane + 1) * 0x01010101u;
#pragma unroll
            for (int q = 0; q < E / 4; ++q) d[q] = run_word(__funnelshift_r(w[q], w[q + 1], 8 * (at & 3)), q, J4);
          } else {
#pragma unroll
            for (int q = 0; q < E / 4; ++q) d[q] = mask_deltas(__funnelshift_r(w[q], w[q + 1], 8 * (at & 3)));
          }
          uint4* row = reinterpret_cast<uint4*>(table + (lane + 1) * ROW + 16);
#pragma unroll
          for (int c = 0; c < E / 16; ++c)
            row[c] = make_uint4(d[4 * c], d[4 * c + 1], d[4 * c + 2], d[4 * c + 3]);
          if constexpr (kR) {  // column 0: the walk leaves the table there, UP to the origin
            if (c0 == 0) reinterpret_cast<unsigned char*>(row)[0] = 0;
          }
          __syncwarp();
          p = smem_u32(table) + (jj + 1) * ROW + 16 + i - c0;
          pf = p;
          recopy = false;
          fresh = false;
        }
        unsigned v;
        if constexpr (kR)
          v = walk_runs_table(p, n, S, lane, out);
        else
          v = walk_table(p, n, flushed, S, buf, lane);
        const int a = static_cast<int>(p - smem_u32(table)), row = a / ROW;
        jj = row - 1;
        i = c0 + a - row * ROW - 16;
        if constexpr (kR) {
          if (n >= S) {  // the cut after S ops (p may be a run past it)
            cut = true;
            break;
          }
          if (jj < 0) break;  // the band's last row is done
          if (i == 0) {  // column 0: UP to the origin, below
            cut = true;
            break;
          }
          if (p == pf) {  // no landing in a table expanded at the cell
            if (c0 <= imax(i - E + 1, 0)) {  // the slot did not cut it: not a fill's run
              cut = true;
              break;
            }
            recopy = true;
          }
          fresh = true;
          continue;
        } else {
          if (v != 0) {  // the buffer is full, or the cut after S ops
            flush_ops<mask_delta_op>(buf, flushed, n, lane, out);
            flushed = n;
            if (n == S) {
              cut = true;
              break;
            }
            continue;
          }
          if (jj < 0) break;  // the band's last row is done
          fresh = true;  // left of the table's columns
        }
      }
      if (cut || band == 0) break;  // band 0's last row done: row j0
      // into the band above at its row 31, column i; its slot s - 1,
      // band - D's the slot just left
      --band;
      jj = 31;
      const int left = s;
      s = s ? s - 1 : RING - 1;
      if (band - (RING - 1) >= 0) slots.load(left, band - (RING - 1), i);
    }
    j = j0 + 32 * band + jj + 1;
    slots.drain();
  }
  if constexpr (kR)
    n = imin(n, S);
  else
    flush_ops<mask_delta_op>(buf, flushed, n, lane, out);
  if (j0 == 0 && j == 0 && i > 0 && n < S) {  // row 0: LEFT to the origin
    const int m = imin(i, S - n);
    for (int q = lane; q < m; q += 32) out[n + q] = static_cast<signed char>(kOpLeft);
    n += m;
    i -= m;
  }
  if constexpr (kR) {
    if (j0 == 0 && i == 0 && j > 0 && n < S) {  // column 0: UP to the origin
      const int m = imin(j, S - n);
      for (int q = lane; q < m; q += 32) out[n + q] = static_cast<signed char>(kOpUp);
      n += m;
      j -= m;
    }
  }
}

// A batch of pairs, a warp a pair, kMaskWarps pairs a block: a pair's Bs+1
// rows of TW = A+1 tie masks, row 0 not read
__global__ void nw_walk_masks_staged_kernel(const unsigned char* __restrict__ masks,
                                            const int* __restrict__ lens1,
                                            const int* __restrict__ lens2, int B, int Bs,
                                            int TW, int S, signed char* __restrict__ ops,
                                            int* __restrict__ ns) {
  __shared__ __align__(128) unsigned char smem[kMaskWarps * kMaskWarpBytes];
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kMaskWarps + warp;
  if (b >= B) return;
  int i = lens1[b];
  int j = lens2[b];
  int n = 0;
  walk_masks_staged<kMasks>(masks + (b * (Bs + 1) + 1) * TW, TW, Bs, smem + warp * kMaskWarpBytes, 0, S, i,
                            j, n, ops + b * S);
  if ((threadIdx.x & 31) == 0) ns[b] = n;
}

// The run-skip walk of a batch, a warp a pair, kRunsWarps pairs a block: a
// pair's Bs+1 rows of TW = A+1 run bytes, row 0 not read
__global__ void nw_walk_runs_staged_kernel(const unsigned char* __restrict__ runs,
                                           const int* __restrict__ lens1,
                                           const int* __restrict__ lens2, int B, int Bs,
                                           int TW, int S, signed char* __restrict__ ops,
                                           int* __restrict__ ns) {
  __shared__ __align__(128) unsigned char smem[kRunsWarps * kRunsWarpBytes];
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRunsWarps + warp;
  if (b >= B) return;
  int i = lens1[b];
  int j = lens2[b];
  int n = 0;
  walk_masks_staged<kRuns>(runs + (b * (Bs + 1) + 1) * TW, TW, Bs, smem + warp * kRunsWarpBytes, 0, S, i, j,
                           n, ops + b * S);
  if ((threadIdx.x & 31) == 0) ns[b] = n;
}

// One block of rows of one pair, one warp: `rows` rows of TW = A+1 tie masks
__global__ void nw_walk_window_masks_staged_kernel(const unsigned char* __restrict__ masks, int rows,
                                                   int TW, int j0, int* __restrict__ state, int S,
                                                   signed char* __restrict__ ops) {
  __shared__ __align__(128) unsigned char smem[kMaskWarpBytes];
  int i = state[0], j = state[1], n = state[2];
  // a start outside the block's masks walks nowhere (n stays short)
  if (j < j0 || j > j0 + rows || i < 0 || i >= TW || n < 0) return;
  walk_masks_staged<kMasks>(masks, TW, rows, smem, j0, S, i, j, n, ops);
  if (threadIdx.x == 0) {
    state[0] = i;
    state[1] = j;
    state[2] = n;
  }
}

// A measurement probe, on no path: the cycles of `steps` dependent
// shared-memory loads (a chase through 1 024 words whose values are
// shared addresses), for the walks' span floor
__global__ void smem_chase_kernel(int steps, long long* __restrict__ out) {
  __shared__ unsigned next[1024];
  for (int q = threadIdx.x; q < 1024; q += blockDim.x) next[q] = smem_u32(&next[(q + 33) & 1023]);
  __syncthreads();
  if (threadIdx.x) return;
  unsigned p = smem_u32(&next[0]);
  for (int q = 0; q < 64; ++q) asm volatile("ld.shared.u32 %0, [%0];" : "+r"(p));
  const long long c0 = clock64();
  for (int q = 0; q < steps; q += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) asm volatile("ld.shared.u32 %0, [%0];" : "+r"(p));
  }
  const long long c1 = clock64();
  out[0] = c1 - c0;
  out[1] = p;  // keeps the chain live
}

}  // namespace

// A table of codes the bulk copies can read: 16-byte aligned (an empty
// one is never read)
static bool codes_aligned(const void* codes, int64_t words) {
  return words == 0 || (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
}

// codes: uint32[B, nbands, TW, 32] from nw_fill_codes, 16-byte aligned;
// ops: int8[B, S] prefilled with OP_NONE; ns: int32[B].  S must be >=
// every len1 + len2.
extern "C" int nw_walk(const void* codes, const int* lens1, const int* lens2,
                       int B, int nbands, int TW, int S, signed char* ops,
                       int* ns, void* stream) {
  if (B <= 0) return 0;
  if (!codes_aligned(codes, static_cast<int64_t>(nbands) * TW))
    return static_cast<int>(cudaErrorInvalidValue);
  nw_walk_staged_kernel<<<(B + kWalkWarps - 1) / kWalkWarps, 32 * kWalkWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(codes), lens1, lens2, B, nbands, TW, S, ops, ns);
  return static_cast<int>(cudaGetLastError());
}

// The cycles of `steps` (a multiple of 8) dependent shared-memory loads
// into out[0] (int64[2], out[1] the chase's end): a probe for the walks'
// span floor, on no path
extern "C" int nw_smem_chase(int steps, long long* out, void* stream) {
  if (steps < 8 || steps % 8) return static_cast<int>(cudaErrorInvalidValue);
  smem_chase_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(steps, out);
  return static_cast<int>(cudaGetLastError());
}

// masks: uint8[B, Bs+1, A+1] tie masks (row-major, a pair's table after
// another, at any alignment); ops: int8[B, S] prefilled with OP_NONE; ns:
// int32[B].  S must be >= every len1 + len2.  A warp a pair on
// walk_masks_staged's ring.
extern "C" int nw_walk_masks(const void* masks, const int* lens1,
                             const int* lens2, int B, int A, int Bs, int S,
                             signed char* ops, int* ns, void* stream) {
  if (B <= 0) return 0;
  if (A < 0 || Bs < 0) return static_cast<int>(cudaErrorInvalidValue);
  nw_walk_masks_staged_kernel<<<(B + kMaskWarps - 1) / kMaskWarps, 32 * kMaskWarps, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(masks), lens1, lens2, B, Bs, A + 1, S, ops, ns);
  return static_cast<int>(cudaGetLastError());
}

// runs: uint8[B, Bs+1, A+1] run bytes from nw_fill_runs_batch (row-major,
// a pair's table after another, at any alignment); ops: int8[B, S]
// prefilled with OP_NONE; ns: int32[B].  S must be >= every len1 + len2.
// A warp a pair on walk_masks_staged's ring, in its runs mode.
extern "C" int nw_walk_runs(const void* runs, const int* lens1,
                            const int* lens2, int B, int A, int Bs, int S,
                            signed char* ops, int* ns, void* stream) {
  if (B <= 0) return 0;
  if (A < 0 || Bs < 0) return static_cast<int>(cudaErrorInvalidValue);
  nw_walk_runs_staged_kernel<<<(B + kRunsWarps - 1) / kRunsWarps, 32 * kRunsWarps, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(runs), lens1, lens2, B, Bs, A + 1, S, ops, ns);
  return static_cast<int>(cudaGetLastError());
}

// codes: uint32[B, nbands, TW, 32] from sw_fill_codes or
// overlap_fill_codes, 16-byte aligned; jstar / istar: int32[B] start
// cells, inside the code table; ops: int8[B, S] prefilled with OP_NONE;
// ns, iend, jend: int32[B] (ops written, stop cell).  A warp a pair on
// walk_staged's ring.
extern "C" int sw_walk(const void* codes, const int* jstar, const int* istar,
                       int B, int nbands, int TW, int S, signed char* ops,
                       int* ns, int* iend, int* jend, void* stream) {
  if (B <= 0) return 0;
  if (!codes_aligned(codes, static_cast<int64_t>(nbands) * TW))
    return static_cast<int>(cudaErrorInvalidValue);
  sw_walk_staged_kernel<<<(B + kLocalWarps - 1) / kLocalWarps, 32 * kLocalWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(codes), jstar, istar, B, nbands, TW, S, ops,
      ns, iend, jend);
  return static_cast<int>(cudaGetLastError());
}

// codes: uint32[1, nbands, TW, 32] of rows j0+1 .. j0+32*nbands (from
// nw_fill_codes_single or nw_fill_tile), 16-byte aligned; state: int32[3]
// = (i, j, n), read and written back; ops: int8[S], written from ops[n].
// A start with j outside [j0, j0 + 32*nbands] or i + 32 > 16*TW leaves
// state as it was.  One warp on walk_staged's ring.  masks != 0: codes is
// uint8[nbands, TW] instead, the tie masks of rows j0+1 .. j0+nbands with
// TW = A+1 columns (nw_fill_tile's masks mode, at any alignment), walked
// by one warp on walk_masks_staged's ring; a start outside [j0, j0 +
// nbands] x [0, TW) leaves state as it was.
extern "C" int nw_walk_window(const void* codes, int nbands, int TW, int j0,
                              int* state, int S, signed char* ops, int masks,
                              void* stream) {
  if (nbands < 0 || TW < 0 || j0 < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (masks) {
    nw_walk_window_masks_staged_kernel<<<1, 32, 0, s>>>(static_cast<const unsigned char*>(codes), nbands,
                                                       TW, j0, state, S, ops);
    return static_cast<int>(cudaGetLastError());
  }
  if (!codes_aligned(codes, static_cast<int64_t>(nbands) * TW))
    return static_cast<int>(cudaErrorInvalidValue);
  nw_walk_window_staged_kernel<<<1, 32, 0, s>>>(static_cast<const unsigned*>(codes), nbands, TW,
                                                j0, state, S, ops);
  return static_cast<int>(cudaGetLastError());
}

// codes: uint32[B, nbands, TW, 32], one group's codes of each pair, rows
// j0+1 .. j0+32*nbands (nw_fill_span's codes mode), 16-byte aligned;
// state: int32[B, 3] = (i, j, n), read and written back; off: int32[B]
// or null; ops: int8[B, stride].  Each pair walks from its state to row
// j0 (the origin when j0 is 0), writing its t-th op here at ops[b, off[b]
// + t] (off null: at ops[b, n], the op string stitched in place), at most
// stride - off[b] ops.  A start with j outside [j0, j0 + 32*nbands] or i
// + 32 > 16*TW leaves its state as it was.  A warp a pair on
// walk_staged's ring, kWalkWarps pairs a block.
extern "C" int nw_walk_groups(const void* codes, int B, int nbands, int TW, int j0, int* state,
                              const int* off, int stride, signed char* ops, void* stream) {
  if (B <= 0) return 0;
  if (nbands < 0 || TW < 0 || j0 < 0 || stride < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!codes_aligned(codes, static_cast<int64_t>(nbands) * TW))
    return static_cast<int>(cudaErrorInvalidValue);
  nw_walk_groups_kernel<<<(B + kWalkWarps - 1) / kWalkWarps, 32 * kWalkWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(codes), B, nbands, TW, j0, state, off, stride, ops);
  return static_cast<int>(cudaGetLastError());
}

// codes: uint32[B, nbands, TW, 32] of 4-bit codes from gotoh_fill_codes,
// 16-byte aligned; states: int32[B] corner states; ops: int8[B, S]
// prefilled with OP_NONE; ns: int32[B].  S must be >= every len1 + len2.
// A warp a pair on walk_staged's ring, in Gotoh's mode.
extern "C" int gotoh_walk(const void* codes, const int* lens1,
                          const int* lens2, const int* states, int B,
                          int nbands, int TW, int S, signed char* ops,
                          int* ns, void* stream) {
  if (B <= 0) return 0;
  if (!codes_aligned(codes, static_cast<int64_t>(nbands) * TW))
    return static_cast<int>(cudaErrorInvalidValue);
  gotoh_walk_staged_kernel<<<(B + kGotohWarps - 1) / kGotohWarps, 32 * kGotohWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(codes), lens1, lens2, states, B, nbands,
      TW, S, ops, ns);
  return static_cast<int>(cudaGetLastError());
}

// The local walk of one group, as nw_walk_groups: codes uint32[B, nbands,
// TW, 32] of rows j0+1 .. j0+32*nbands from free_fill_span, 16-byte
// aligned; state int32[B, 3] = (i, j, n); ops int8[B, stride].
extern "C" int sw_walk_groups(const void* codes, int B, int nbands, int TW, int j0, int* state,
                              const int* off, int stride, signed char* ops, void* stream) {
  if (B <= 0) return 0;
  if (nbands < 0 || TW < 0 || j0 < 0 || stride < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!codes_aligned(codes, static_cast<int64_t>(nbands) * TW))
    return static_cast<int>(cudaErrorInvalidValue);
  sw_walk_groups_kernel<<<(B + kLocalWarps - 1) / kLocalWarps, 32 * kLocalWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(codes), B, nbands, TW, j0, state, off, stride, ops);
  return static_cast<int>(cudaGetLastError());
}

// Gotoh's walk of one group, as nw_walk_groups: codes uint32[B, nbands,
// TW, 32] of 4-bit codes of rows j0+1 .. j0+32*nbands from
// gotoh_fill_span, 16-byte aligned; state int32[B, 4] = (i, j, n, state:
// 0 M, 1 IX, 2 IY); ops int8[B, stride].
extern "C" int gotoh_walk_groups(const void* codes, int B, int nbands, int TW, int j0, int* state,
                                 const int* off, int stride, signed char* ops, void* stream) {
  if (B <= 0) return 0;
  if (nbands < 0 || TW < 0 || j0 < 0 || stride < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!codes_aligned(codes, static_cast<int64_t>(nbands) * TW))
    return static_cast<int>(cudaErrorInvalidValue);
  gotoh_walk_groups_kernel<<<(B + kGotohWarps - 1) / kGotohWarps, 32 * kGotohWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(codes), B, nbands, TW, j0, state, off, stride, ops);
  return static_cast<int>(cudaGetLastError());
}
