// Batched Gotoh affine-gap global fill kernels for Hopper (sm_90a).
//
// Replaces these TPU (Pallas) kernels, which compute one function on
// three shapes:
//   K17 nw_tpu/ops/variants_rowsweep.py:_make_affine_kernel (sides <= 512)
//   K23 nw_tpu/ops/variants_pallas.py:_affine_kernel (flat, sides <= 3 072)
//   K20 nw_tpu/ops/variants_banded.py:_make_banded_affine_kernel (any side)
//                                                          -> gotoh_scores
// and these two, which emit the walk's state codes:
//   K21 nw_tpu/ops/variants_banded.py:_make_banded_affine_full_kernel
//       (build_affine_full_call; 4-bit codes, any side)
//   K25 nw_tpu/ops/variants_pallas.py:_affine_arrows_kernel
//       (affine_arrows_pallas_batch; 8-bit codes, sides <= 1 024)
//                                                          -> gotoh_fill_codes
//
// Semantics are those of nw_tpu/models/affine.py:28-100 (affine_score),
// bit for bit, with (j = side row, i = top column):
//   M[j,i]  = best[j-1,i-1] + (m | -k)
//   IX[j,i] = max(M[j,i-1] - open, IX[j,i-1] - extend)   (from the left)
//   IY[j,i] = max(M[j-1,i] - open, IY[j-1,i] - extend)   (from above)
//   best    = max(max(M, IX), IY)
// in wrapping int32.  A state that does not exist is kNeg = NEG_INF / 2:
// M on row 0 and column 0 but M(0,0) = 0, IX on column 0, IY on row 0.
// The boundary gaps are IX(0,i) = -(open + (i-1)*extend) and IY(j,0) =
// -(open + (j-1)*extend), and a boundary cell's best is the max of its
// three states, so at a huge open the max picks kNeg, as the scan does.
// IY is the scan's unfused max(M - open, IY - extend): K20 and K23 fold
// it as max(M - (open - extend), IY) - extend, which differs on
// overflow.  The score is best(len2, len1); best(0, len1) when len2 is
// 0, and 0 for the empty pair.  Padding never reaches the true
// rectangle: the recurrence reads only smaller indices.
//
// The CODES mode (gotoh_fill_codes) also writes each interior cell's
// 4-bit code, the bits of nw_tpu/models/affine.py:109
// affine_fill_arrows: bits 0-1 M's predecessor, the argmax state of
// cell (j-1, i-1) (0 M, 1 IX, 2 IY; ties M > IX > IY); bit 2 IX extends
// (IX - extend > M - open at (j, i-1)); bit 3 IY extends (the same at
// (j-1, i)), both compared strictly on the candidates of the cell's
// predecessors, as those stand after the boundary selects.  The corner's
// state, where the walk starts, is written beside its score (row 0's
// when len2 is 0, 0 for the empty pair).  Codes use nw_fill.cu's
// band-major layout at 8 a word: uint32[B, nbands, TW, 32],
// TW = 4*ceil((A+32)/32), cell (j, i) at band (j-1)/32, lane jj =
// (j-1)%32, step t = i + jj, bits 4*(t%8) of word t/8; column 0, rows
// past Bs and columns past A are 0.  The codes are stored 8 steps at a
// time by all lanes together, 4 words a 32-step chunk.
//
// Design: nw_fill.cu's W-warp pipeline (its header, "The pipeline"),
// with a Gotoh cell.  The side string's rows are cut into bands of 32
// rows, one row a lane; at step t lane jj computes cell (row j0+jj,
// column c = t-jj).  A block of W warps (1 <= W <= 32, the rule
// nw_tpu_torch/ops/variants_banded.py:gotoh_warps) owns one pair, and
// band b runs on warp b % W.  The protocol is nw_common.cuh's: done[w]
// counts the chunks warp w has completed over its bands; before chunk g
// a warp waits for done[w-1] >= g+2 (capped at the band's end) and, if
// it feeds a ring, for done[w+1] >= g-kSlots+1; each warp's ring has
// kSlots = 4 chunk slots, written by lane 31 and read by the next warp's
// lane 0, one shared access a step; warp W-1 copies each finished chunk
// into the pair's boundary rows in device memory, which warp 0 stages 32
// columns at a time, a block-scope fence on both sides; the top string
// is staged once as int16, in shared memory or in the pair's row of the
// device scratch top16 when it does not fit (about 114 000 columns), and
// each lane reads it at its own column.
//
// What crosses a band's edge.  IX comes from the left and stays in the
// lane: each step computes IX of its next cell, max(M - open, IX -
// extend), and carries that.  The cell below needs best h (for its M
// one step later, as the diagonal), and IY: the lane above computes the
// row below's IY = max(M - open, IY - extend) from its own M and IY
// (M - open is IX's term too) and hands that over, so IY costs the
// receiving lane no arithmetic and M and IY need not cross separately.
// With codes, a third value: the cell's argmax state in bits 0-1 (the
// cell below-right's bits 0-1, one step later), the next cell's
// IX-extend bit in bit 2 (the lane's own, read a step later) and the
// row below's IY-extend bit in bit 3, both compared on the candidates
// just formed.  So a step shuffles two values (three with codes) from
// the lane above, lane 31 publishes a 64-bit ring cell (int2: h, IY
// below) or a 128-bit one (int4: h, IY below, state bits, unused), and
// lane 0 reads it with one LDS.64 / LDS.128; the boundary rows are 2
// (scores) or 3 (codes) int32 rows of A+1 columns a pair, bnd
// int32[B, 2|3, A+1].  Row 0 is written into them first: h(0,c),
// max(M(0,c) - open, kNeg - extend), and its states.
//
// A shared load may not pass the last step's ring store, so the ring
// cell and the top character of step s+1 are loaded in step s, off the
// step's chain.
//
// It cannot deadlock, by nw_fill.cu's argument, which does not depend on
// the cell: warp W-1 never waits for a reader (the boundary
// rows hold a whole row), so a chain of "ring full" waits w -> w+1 ->
// ... ends at W-1; a warp that waits on an empty ring cannot have a
// producer that waits on the same ring full (kSlots >= 2); and warp 0
// waits on warp W-1's band of the round before, which does not wait on
// warp 0's current band.  Band b+W-1 rewrites a column of the boundary
// rows only after band b has staged it, through the chain of ring waits
// between them; with W = 1, warp 0 reads the rows a chunk ahead of
// rewriting them in place.
//
// The band-span mode (gotoh_span_kernel, gotoh_fill_span: the Gotoh
// traceback's checkpoint pass and group re-fill) is nw_fill.cu's span
// over the Gotoh cell: bands r0 .. r0 + nb - 1 from the hand-on row in
// bnd (best h, IY of the row below, state bits; row 0 written here when
// r0 is 0, its gap costs only then), the rows, column 0's IY gap and the
// corner global, the span's last band leaving its row in bnd whichever
// warp runs it (nw_fill.cu's waits and in-place argument, which do not
// depend on the cell).  The ring cell always carries the state bits, so
// the seeded row enters exactly as a band's hand-off does, at every
// scoring (a row of true values: the sentinel's decay never enters);
// each pair's score and corner state are written by the span that holds
// its row len2, so the checkpoint pass is the scores sweep and needs no
// codes.
//
// A chunk whose every column lies in 1..A and that holds no corner (all
// but a few chunks of a band) runs a step with no test of column 0, of
// the row's end or of the corner (FAST).  A tested chunk applies the
// column-0 selects: M and IX kNeg, IY the gap, best the max of the three.
//
// What bounds it on the H100.  A step of one warp waits on the lane
// above: two shuffles (three with codes), then best is one DPX
// three-way max (__vimax3_s32) of M, the carried IX and the received IY,
// and the next IY a subtract and a max; M (compare, select, add on the
// diagonal received a step before) and the next IX are off that chain.
// So, as the pipeline's other fills, a warp is bound by latency and many
// warps a pair interleave: with W warps the SM's issue slots and its
// shared-memory pipe (shuffles, the ring's load and store, the top's
// load) bound it.  The function's own work is 10 int32 ops a cell (22
// with codes; chip_smoke.py's OPS_GOTOH, OPS_GOTOH_CODE: one M - open
// serves both IX and IY), and the only
// large memory traffic is the code store, 4 bits a cell written once
// (~0.6 GB at 128 x 3 072 bp).  W = 1 keeps a warp a pair for batches
// that fill the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "nw_common.cuh"

namespace {

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

constexpr int kNeg = -(1 << 29);  // NEG_INF / 2: NEG - open cannot wrap

// -(open + (L-1)*extend), wrapping: a boundary gap of length L >= 1
__device__ __forceinline__ int gap_cost(int L, int op, int ex) {
  return wsub(0, wadd(op, wmul(L - 1, ex)));
}

// the state that holds best h of (M, IX, IY): 0 M, 1 IX, 2 IY, ties M > IX > IY
__device__ __forceinline__ int argmax_state(int mv, int xv, int yv, int h) {
  return mv >= h ? 0 : (xv >= yv ? 1 : 2);
}

// A column of a handoff row: best h and IY of the row below; with codes
// also the state bits (argmax state | the lane's next IX-extend bit << 2
// | the row below's IY-extend bit << 3)
template <bool CODES> struct Cell { using type = int2; };
template <> struct Cell<true> { using type = int4; };

// The Gotoh fill on the pipeline.  TOP_SMEM: the top string is staged in
// shared memory; else in the pair's row of top16 (int16[B,
// pipe_top_cols(A)]) in device memory.  bnd is int32[B, 2|3, A+1].
// CODES: the ring cell carries the state bits (and the corner's state is
// written); STORE: the codes are stored.  SPAN: bands r0 .. r0 + nbands -
// 1 only, nbands = min(span, ceil(Bs/32) - r0), from the row above band
// r0 in bnd (row 0 written here when r0 is 0), left holding the span's
// last row (nw_fill.cu's band-span mode, its header): codes at
// codes[b, band - r0], the corner's score and state by the span that
// holds row len2.
template <bool CODES, bool TOP_SMEM, bool SPAN, bool STORE>
__device__ __forceinline__ void gotoh_fill(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2, int A, int Bs,
    int m, int k, int op, int ex, int* bnd, short* top16,
    unsigned* __restrict__ codes, int* __restrict__ scores,
    int* __restrict__ states, int r0, int span) {
  static_assert(CODES || !STORE, "codes are stored from the state bits");
  using C = typename Cell<CODES>::type;
  extern __shared__ __align__(16) int gotoh_sh[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int64_t b = blockIdx.x;
  const int M = A + 1;
  const int nchunks = (M + 31 + 31) >> 5;  // 32-step chunks of one band
  const int nbands = SPAN ? min(span, ((Bs + 31) >> 5) - r0) : (Bs + 31) >> 5;
  C* const rings = reinterpret_cast<C*>(gotoh_sh);
  C* const stage = rings + W * kRing;
  volatile int* done = reinterpret_cast<int*>(stage + 32);
  short* const top_s = TOP_SMEM ? reinterpret_cast<short*>(const_cast<int*>(done) + W)
                                : top16 + b * pipe_top_cols(A);
  const int* top = tops + b * A;
  const int* side = sides + b * Bs;
  // the row above a band: best h at [c], IY of the row below at [M + c],
  // and with codes the state bits at [2M + c]
  int* brow = bnd + b * (CODES ? 3 : 2) * M;
  const int l1 = lens1[b];
  const int l2 = lens2[b];

  // the top string; row 0 into the boundary rows (M(0,0) = 0, else M
  // and IY do not exist; IX(0,c) is the gap); counters
  pipe_stage_top(top_s, top, A);
  for (int c = threadIdx.x; c < M && (!SPAN || r0 == 0); c += blockDim.x) {
    const int mv = c == 0 ? 0 : kNeg;
    const int xv = c == 0 ? kNeg : gap_cost(c, op, ex);
    const int hv = max(max(mv, xv), kNeg);
    const int yo = wsub(mv, op), ye = wsub(kNeg, ex);
    brow[c] = hv;
    brow[M + c] = max(yo, ye);
    if (CODES) brow[2 * M + c] = argmax_state(mv, xv, kNeg, hv) | (ye > yo) << 3;
  }
  if (threadIdx.x < W) done[threadIdx.x] = 0;
  if (l2 == 0 && threadIdx.x == 0 && (!SPAN || r0 == 0)) {
    scores[b] = l1 == 0 ? 0 : max(gap_cost(l1, op, ex), kNeg);
    if (CODES) {  // the corner (0, l1) of row 0
      const int xv = gap_cost(l1, op, ex);
      states[b] = l1 == 0 ? 0 : argmax_state(kNeg, xv, kNeg, max(xv, kNeg));
    }
  }
  __syncthreads();

  const int negk = wsub(0, k);
  const bool last_warp = warp == W - 1;
  C* const out_ring = rings + warp * kRing;
  // the row above: the previous warp's ring, or (warp 0) the staged chunk
  const C* const in_ring = warp > 0 ? rings + (warp - 1) * kRing : stage;
  const int in_warp = warp > 0 ? warp - 1 : W - 1;
  const short* const top_lane = top_s + 31 - lane;  // column t - lane at [t]
  for (int band = warp, round = 0; band < nbands; band += W, ++round) {
    const int gband = SPAN ? r0 + band : band;  // the band in the table
    const int j = gband * 32 + 1 + lane;  // this lane's row
    const bool row_ok = j <= Bs;
    const int sch = row_ok ? side[j - 1] : kSidePad;
    const bool feeds = band + 1 < nbands;  // a band below reads this one's last row
    const bool to_ring = feeds && !last_warp;  // ... from this warp's ring
    // SPAN: the span's last band leaves its last row in bnd, as
    // nw_fill.cu's span does (its waits and in-place argument hold here)
    [[maybe_unused]] const bool leaves = SPAN && !feeds;
    const bool hands = feeds || leaves;  // lane 31 writes the last row into the ring
    const bool waits_out = to_ring || (leaves && !last_warp);
    // warp 0 reads warp W-1's band of the round before (none in round 0:
    // the boundary rows hold row 0)
    const int in_base = (warp > 0 ? round : round - 1) * nchunks;
    // the chunk of the true corner's step, in the band that holds row len2
    const int jj_c = l2 - 1 - gband * 32;
    const int corner_q = jj_c >= 0 && jj_c < 32 ? (l1 + jj_c) >> 5 : -1;
    unsigned* wbase = STORE
        ? codes + ((b * nbands + band) * static_cast<int64_t>(4 * nchunks)) * 32 + lane
        : nullptr;
    // own best at the last column, the row above's best one column back,
    // IX of this row's next cell and IY of the row below at the last column
    int h = 0, h_diag = 0, xc = 0, yb = 0;
    // codes: own state bits at the last column (with the next cell's
    // IX-extend bit), the row above's one column back, the codes of the
    // word being packed
    int v = 0, v_diag = 0;
    unsigned pack = 0;

    for (int q = 0; q < nchunks; ++q) {
      const int g = round * nchunks + q;  // chunks of this warp before this one
      const int t0 = q << 5;
      // the row above's columns t0 .. t0+31 are in (the band above has
      // completed chunk q+1), and this chunk's slots have been read
      pipe_wait(done, in_warp, in_base + min(q + 2, nchunks), waits_out, warp + 1,
                SPAN && !to_ring ? min(g - kSlots + 1, round * nchunks) : g - kSlots + 1);
      const C* above = in_ring + (g & (kSlots - 1)) * 32;
      if (warp == 0) {  // stage the chunk of the boundary rows
        const int cx = t0 + lane;
        const bool in = cx < M;
        C cell{};
        cell.x = in ? brow[cx] : 0;
        cell.y = in ? brow[M + cx] : 0;
        if constexpr (CODES) cell.z = in ? brow[2 * M + cx] : 0;
        stage[lane] = cell;
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

      // one chunk of 32 steps; FAST: every lane's column lies in 1..A
      // and the corner is not in it, so column 0, the columns past A and
      // the corner need no test
      auto sweep = [&](auto fast) {
        constexpr bool FAST = decltype(fast)::value;
        // column 0: M and IX do not exist, IY(j,0) is the gap; best is
        // the max of the three
        [[maybe_unused]] int y_col0 = 0, h_col0 = 0;
        if constexpr (!FAST) {
          y_col0 = gap_cost(j, op, ex);
          h_col0 = max(kNeg, y_col0);
        }
        // the row above's cell and the top character of a step, loaded a
        // step ahead: a shared load may not pass the last step's ring store
        C a = above[0];
        int ch = tq[0];
#pragma unroll
        for (int s = 0; s < 32; ++s) {
          C a_next = a;
          int ch_next = ch;
          if (s < 31) {
            a_next = above[s + 1];
            ch_next = tq[s + 1];
          }
          int h_up = __shfl_up_sync(kFull, h, 1);
          int yn = __shfl_up_sync(kFull, yb, 1);  // IY: the lane above's candidate
          [[maybe_unused]] int v_up = 0;
          h_up = lane == 0 ? a.x : h_up;
          yn = lane == 0 ? a.y : yn;
          if constexpr (CODES) {
            v_up = __shfl_up_sync(kFull, v, 1);
            v_up = lane == 0 ? a.z : v_up;
          }

          int mn = wadd(h_diag, ch == sch ? m : negk);
          int xn = xc;
          int hn = __vimax3_s32(mn, xn, yn);  // exact: the wrapping is in the candidates
          [[maybe_unused]] unsigned code = 0;
          if constexpr (CODES) {  // from the candidates, before the column-0 selects
            code = static_cast<unsigned>((v_diag & 3) | (v & 4) | (v_up & 8));
          }
          [[maybe_unused]] bool keep = true;  // codes: the cell's code is stored
          if constexpr (!FAST) {
            const int c = t0 + s - lane;
            const bool col_zero = c == 0;
            mn = col_zero ? kNeg : mn;
            xn = col_zero ? kNeg : xn;
            yn = col_zero ? y_col0 : yn;
            hn = col_zero ? h_col0 : hn;
            keep = c >= 1 && c <= A && row_ok;
            if (j == l2 && c == l1) {  // the true corner (0 <= len1 <= A)
              scores[b] = hn;
              if (CODES) states[b] = argmax_state(mn, xn, yn, hn);
            }
          }
          // IX of the next cell and IY of the row below (both open M), and
          // with codes their extend bits
          const int mo = wsub(mn, op), xe = wsub(xn, ex), ye = wsub(yn, ex);
          const int xc_n = max(mo, xe), yb_n = max(mo, ye);
          [[maybe_unused]] int vn = 0;
          if constexpr (CODES) vn = argmax_state(mn, xn, yn, hn) | (xe > mo) << 2 | (ye > mo) << 3;
          if (s < 31 ? pub_lo : pub_hi) {  // this band's last row, for the band below
            C cell;
            if constexpr (CODES) {
              cell = make_int4(hn, yb_n, vn, 0);
            } else {
              cell = make_int2(hn, yb_n);
            }
            (s < 31 ? out_lo[s] : out_hi[0]) = cell;
          }
          if constexpr (STORE) {
            // rows past Bs store 0: per cell in a tested chunk, per word here
            pack |= (keep ? code : 0u) << (4 * (s & 7));
            if ((s & 7) == 7) {  // static: every lane stores together
              wbase[static_cast<int64_t>((t0 + s) >> 3) * 32] = FAST && !row_ok ? 0u : pack;
              pack = 0;
            }
          }
          if constexpr (CODES) {
            v_diag = v_up;
            v = vn;
          }
          h_diag = h_up;
          h = hn;
          xc = xc_n;
          yb = yb_n;
          a = a_next;
          ch = ch_next;
        }
      };
      if (q > 0 && t0 + 31 <= A && q != corner_q) {  // no column 0, none past the row, no corner
        sweep(Flag<true>{});
      } else {
        sweep(Flag<false>{});
      }

      __syncwarp();  // the chunk's ring writes are in
      if ((last_warp && feeds) || leaves) {  // columns t0-31 .. t0 into the boundary rows
        const int col = t0 - 31 + lane;
        if (col >= 0 && col < M) {
          const C cell = lane < 31 ? out_lo[lane] : out_hi[0];
          brow[col] = cell.x;
          brow[M + col] = cell.y;
          if constexpr (CODES) brow[2 * M + col] = cell.z;
        }
      }
      pipe_post(done, warp, lane, g);
    }
  }
}

template <bool CODES, bool TOP_SMEM>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) gotoh_pipe_kernel(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2, int A, int Bs,
    int m, int k, int op, int ex, int* bnd, short* top16,
    unsigned* __restrict__ codes, int* __restrict__ scores,
    int* __restrict__ states) {
  gotoh_fill<CODES, TOP_SMEM, false, CODES>(tops, sides, lens1, lens2, A, Bs, m, k, op, ex, bnd,
                                            top16, codes, scores, states, 0, 0);
}

// The band-span mode (gotoh_fill_span): a kernel of its own, so
// gotoh_pipe_kernel keeps its machine code.  The ring cell always carries
// the state bits (a re-fill reads them off its checkpoint row); STORE: the
// span's codes are stored.
template <bool STORE, bool TOP_SMEM>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) gotoh_span_kernel(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2, int A, int Bs,
    int m, int k, int op, int ex, int r0, int span, int* bnd, short* top16,
    unsigned* __restrict__ codes, int* __restrict__ scores,
    int* __restrict__ states) {
  gotoh_fill<true, TOP_SMEM, true, STORE>(tops, sides, lens1, lens2, A, Bs, m, k, op, ex, bnd,
                                          top16, codes, scores, states, r0, span);
}

// top16 null: the top in shared memory; else int16[B, pipe_top_cols(A)].
template <bool CODES>
int launch_gotoh(const int* tops, const int* sides, const int* lens1,
                 const int* lens2, int B, int A, int Bs, int m, int k, int op,
                 int ex, int warps, short* top16, int* bnd, unsigned* codes,
                 int* scores, int* states, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps || A < 0 || Bs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pipe_smem(warps, A, sizeof(typename Cell<CODES>::type), !top16);
  auto kernel = top16 ? gotoh_pipe_kernel<CODES, false> : gotoh_pipe_kernel<CODES, true>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, 32 * warps, smem, stream>>>(tops, sides, lens1, lens2, A, Bs, m, k, op,
                                          ex, bnd, top16, codes, scores, states);
  return static_cast<int>(cudaGetLastError());
}

template <bool STORE>
int launch_gotoh_span(const int* tops, const int* sides, const int* lens1, const int* lens2,
                      int B, int A, int Bs, int m, int k, int op, int ex, int r0, int span,
                      int warps, short* top16, int* bnd, unsigned* codes, int* scores,
                      int* states, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps || A < 0 || Bs < 0 || r0 < 0 || span < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pipe_smem(warps, A, sizeof(typename Cell<true>::type), !top16);
  auto kernel = top16 ? gotoh_span_kernel<STORE, false> : gotoh_span_kernel<STORE, true>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, 32 * warps, smem, stream>>>(tops, sides, lens1, lens2, A, Bs, m, k, op, ex, r0,
                                          span, bnd, top16, codes, scores, states);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K17 / K23 / K20 port: int32 Gotoh global scores at the true corners,
// W = warps a pair.  bnd is int32[B, 2, A+1] scratch; top16 null, or
// int16[B, 32*ceil((A+32)/32) + 32] scratch for a top that does not fit
// a block's shared memory.
extern "C" int gotoh_scores(const int* tops, const int* sides,
                            const int* lens1, const int* lens2, int B, int A,
                            int Bs, int m, int k, int open, int extend,
                            int warps, void* top16, int* bnd, int* scores,
                            void* stream) {
  return launch_gotoh<false>(tops, sides, lens1, lens2, B, A, Bs, m, k, open,
                             extend, warps, static_cast<short*>(top16), bnd,
                             nullptr, scores, nullptr,
                             static_cast<cudaStream_t>(stream));
}

// K21 / K25 port: 4-bit walk codes (bits 0-1 M's predecessor state,
// bit 2 IX extends, bit 3 IY extends) in the band-major layout above,
// the int32 Gotoh scores and the argmax states (0 M, 1 IX, 2 IY) at the
// true corners, W = warps a pair.  codes is uint32[B, ceil(Bs/32),
// 4*ceil((A+32)/32), 32]; bnd is int32[B, 3, A+1] scratch, top16 as
// gotoh_scores's.
extern "C" int gotoh_fill_codes(const int* tops, const int* sides,
                                const int* lens1, const int* lens2, int B,
                                int A, int Bs, int m, int k, int open,
                                int extend, int warps, void* top16, int* bnd,
                                void* codes, int* scores, int* states,
                                void* stream) {
  return launch_gotoh<true>(tops, sides, lens1, lens2, B, A, Bs, m, k, open,
                            extend, warps, static_cast<short*>(top16), bnd,
                            static_cast<unsigned*>(codes), scores, states,
                            static_cast<cudaStream_t>(stream));
}

// K21 (and K20, its scores) as nw_tpu's Gotoh two-pass traceback calls
// them, band by band with the boundary rows carried (the checkpoint pass
// and the group re-fill): bands r0 .. min(r0 + span, ceil(Bs/32)) - 1
// from the rows above band r0 in bnd (int32[B, 3, A+1]: best h, IY of the
// row below, state bits; row 0 is written here when r0 is 0), left
// holding the span's last row (its rows past Bs swept over pads).  Writes
// scores[b] and states[b] only for a pair whose row len2 lies in the span
// (len2 = 0: the span from band 0), and with emit_codes the span's 4-bit
// codes, uint32[B, nb, 4*ceil((A+32)/32), 32] in gotoh_fill_codes's
// layout, nb the span's bands.  W = warps a pair, top16 as gotoh_scores's.
extern "C" int gotoh_fill_span(const int* tops, const int* sides, const int* lens1,
                               const int* lens2, int B, int A, int Bs, int m, int k, int open,
                               int extend, int r0, int span, int emit_codes, int warps,
                               void* top16, int* bnd, void* codes, int* scores, int* states,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto t16 = static_cast<short*>(top16);
  auto cw = static_cast<unsigned*>(codes);
  if (emit_codes)
    return launch_gotoh_span<true>(tops, sides, lens1, lens2, B, A, Bs, m, k, open, extend, r0,
                                   span, warps, t16, bnd, cw, scores, states, s);
  return launch_gotoh_span<false>(tops, sides, lens1, lens2, B, A, Bs, m, k, open, extend, r0,
                                  span, warps, t16, bnd, cw, scores, states, s);
}
