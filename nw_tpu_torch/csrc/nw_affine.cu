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
// Design: nw_fill.cu's geometry.  One warp per pair; the side string's
// rows are cut into bands of 32 rows, one row a lane, and at step t lane
// jj computes cell (row j0+jj, column c = t-jj).  IX comes from the left
// and stays in the lane's registers; M and IY of the cell above and the
// best for the next step's diagonal come from lane jj-1 by
// __shfl_up_sync: three values a step where the linear fill has one.
// Lane 0 reads the row above the band from three per-pair int32 boundary
// rows in device memory (best, M, IY), 32 columns at a time, one
// coalesced load a lane, handed to lane 0 by shuffle; lane 31 overwrites
// them with its row, 31 columns behind lane 0's reads.  Scratch is
// 3 x 4 B x (A+1) a pair.  All offsets are 64-bit.
//
// What bounds it on the H100: as the linear fill, the serial chain of
// each step on the lane above: eight shuffles (the linear fill has
// four), then 11 integer ops of the recurrence (the substitution's
// compare and select, M's add, two subtracts and a max for IX and again
// for IY, two maxes for best) and the boundary selects, so a warp is
// bound by latency and its own instruction rate, and throughput comes from
// many pairs in flight.  Memory traffic is the boundary rows, 12 bytes a
// column a band, in L2.
//
// The CODES mode (gotoh_fill_codes) is the same sweep, a template
// argument of the one body, and also writes each interior cell's 4-bit
// code, the bits of nw_tpu/models/affine.py:109 affine_fill_arrows:
// bits 0-1 M's predecessor, the argmax state of cell (j-1, i-1) (0 M,
// 1 IX, 2 IY; ties M > IX > IY); bit 2 IX extends (IX - extend > M -
// open at (j, i-1), lane-local); bit 3 IY extends (the same at (j-1, i),
// from the values already shuffled).  Each lane computes its cell's
// argmax state after the boundary selects and hands it down with h by
// one more shuffle, so it reaches the cell below-right as h_diag does;
// lane 0 reads it from a fourth boundary row (scratch 4 x 4 B x (A+1) a
// pair).  The corner's state, where the walk starts, is written beside
// its score.  Codes use nw_fill.cu's band-major layout at 8 a word:
// uint32[B, nbands, TW, 32], TW = 4*ceil((A+32)/32), cell (j, i) at
// band (j-1)/32, lane jj = (j-1)%32, step t = i + jj, bits 4*(t%8) of
// word t/8; column 0 and cells outside the table are 0.  The codes are
// stored 8 steps at a time by all lanes together; 4 bits a cell of one
// 128 x 3 072 bp sub-batch is ~0.6 GB, written once.  The mode adds a
// shuffle, the state's two compares and selects, the two extend
// compares and the packing to a step.

#include <cstdint>
#include <cuda_runtime.h>

#include "nw_common.cuh"

namespace {

using nw::kFull;
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

template <bool CODES>
__device__ __forceinline__ void gotoh_fill(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2, int A,
    int Bs, int m, int k, int op, int ex, int* __restrict__ bnd,
    int* __restrict__ scores, unsigned* __restrict__ codes,
    int* __restrict__ states) {
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int M = A + 1;
  const int nchunks = (M + 31 + 31) >> 5;  // 32-step chunks of one band
  const int nbands = (Bs + 31) >> 5;
  const int* top = tops + b * A;
  const int* side = sides + b * Bs;
  // best, M and IY of the row above the band (and its argmax state)
  int* hrow = bnd + b * (CODES ? 4 : 3) * M;
  int* mrow = hrow + M;
  int* yrow = mrow + M;
  int* srow = yrow + M;
  const int l1 = lens1[b];
  const int l2 = lens2[b];

  // row 0: M(0,0) = 0, else M and IY do not exist; IX(0,c) is the gap
  for (int c = lane; c < M; c += 32) {
    const int mv = c == 0 ? 0 : kNeg;
    const int xv = c == 0 ? kNeg : gap_cost(c, op, ex);
    hrow[c] = max(max(mv, xv), kNeg);
    mrow[c] = mv;
    yrow[c] = kNeg;
    if (CODES) srow[c] = argmax_state(mv, xv, kNeg, max(max(mv, xv), kNeg));
  }
  if (l2 == 0 && lane == 0) {
    scores[b] = l1 == 0 ? 0 : max(gap_cost(l1, op, ex), kNeg);
    if (CODES) {  // the corner (0, l1) of row 0
      const int xv = gap_cost(l1, op, ex);
      states[b] = l1 == 0 ? 0 : argmax_state(kNeg, xv, kNeg, max(xv, kNeg));
    }
  }
  __syncwarp();

  const int negk = wsub(0, k);
  for (int band = 0; band < nbands; ++band) {
    const int j = band * 32 + 1 + lane;  // this lane's row
    const bool row_ok = j <= Bs;
    const int sch = row_ok ? side[j - 1] : -5;
    // column 0: M and IX do not exist, IY(j,0) is the gap; best is the
    // max of the three
    const int y_col0 = gap_cost(j, op, ex);
    const int h_col0 = max(kNeg, y_col0);
    int h = 0, mm = 0, x = 0, y = 0;  // own best, M, IX, IY at the last column
    int h_diag = 0, ch = -4;          // best of the row above one column back; top char
    // codes: own state at the last column, the row above's one column
    // back, the codes of the word being packed, the band's first word
    int st = 0, st_diag = 0;
    unsigned pack = 0;
    unsigned* wbase = CODES
        ? codes + ((b * nbands + band) * static_cast<int64_t>(4 * nchunks)) * 32 + lane
        : nullptr;

    for (int t0 = 0; t0 < 32 * nchunks; t0 += 32) {
      // the next 32 columns of the row above and of the top string;
      // lane x holds column t0 + x until step t0 + x hands it to lane 0
      const int cx = t0 + lane;
      const int hval = cx < M ? hrow[cx] : 0;
      const int mval = cx < M ? mrow[cx] : 0;
      const int yval = cx < M ? yrow[cx] : 0;
      const int tval = (cx >= 1 && cx <= A) ? top[cx - 1] : -4;
      const int sval = (CODES && cx < M) ? srow[cx] : 0;
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const int c = t0 + s - lane;
        int h_up = __shfl_up_sync(kFull, h, 1);
        int m_up = __shfl_up_sync(kFull, mm, 1);
        int y_up = __shfl_up_sync(kFull, y, 1);
        const int ch_in = __shfl_up_sync(kFull, ch, 1);
        const int b_h = __shfl_sync(kFull, hval, s);
        const int b_m = __shfl_sync(kFull, mval, s);
        const int b_y = __shfl_sync(kFull, yval, s);
        const int b_ch = __shfl_sync(kFull, tval, s);
        h_up = lane == 0 ? b_h : h_up;
        m_up = lane == 0 ? b_m : m_up;
        y_up = lane == 0 ? b_y : y_up;
        ch = lane == 0 ? b_ch : ch_in;
        int st_up = 0;
        if (CODES) {
          st_up = __shfl_up_sync(kFull, st, 1);
          const int b_st = __shfl_sync(kFull, sval, s);
          st_up = lane == 0 ? b_st : st_up;
        }

        int mn = wadd(h_diag, ch == sch ? m : negk);
        int xn = max(wsub(mm, op), wsub(x, ex));
        int yn = max(wsub(m_up, op), wsub(y_up, ex));
        int hn = max(max(mn, xn), yn);
        unsigned code = 0;
        if (CODES) {  // from the candidates, before the column-0 selects
          code = static_cast<unsigned>(st_diag) |
                 static_cast<unsigned>(wsub(x, ex) > wsub(mm, op)) << 2 |
                 static_cast<unsigned>(wsub(y_up, ex) > wsub(m_up, op)) << 3;
        }
        const bool col_zero = c == 0;
        mn = col_zero ? kNeg : mn;
        xn = col_zero ? kNeg : xn;
        yn = col_zero ? y_col0 : yn;
        hn = col_zero ? h_col0 : hn;
        const int sn = CODES ? argmax_state(mn, xn, yn, hn) : 0;
        const bool in_row = c >= 0 && c <= A;
        if (in_row && j == l2 && c == l1) {  // the true corner
          scores[b] = hn;
          if (CODES) states[b] = sn;
        }
        // lane 31 writes its row over the boundary rows, 31 columns
        // behind lane 0's reads of them: lane 31's values of column c
        // depend, through the shuffle chain, on lane 0's loads of c
        if (lane == 31 && in_row) {
          hrow[c] = hn;
          mrow[c] = mn;
          yrow[c] = yn;
          if (CODES) srow[c] = sn;
        }
        if (CODES) {
          pack |= (c >= 1 && c <= A && row_ok ? code : 0u) << (4 * (s & 7));
          if ((s & 7) == 7) {  // static: every lane stores together
            wbase[static_cast<int64_t>((t0 + s) >> 3) * 32] = pack;
            pack = 0;
          }
          st_diag = st_up;
          st = sn;
        }
        h_diag = h_up;
        h = hn;
        mm = mn;
        x = xn;
        y = yn;
      }
    }
    __syncwarp();  // the band's boundary rows are complete before the next band reads them
  }
}

__global__ void __launch_bounds__(32) gotoh_scores_kernel(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2, int A,
    int Bs, int m, int k, int op, int ex, int* __restrict__ bnd,
    int* __restrict__ scores) {
  gotoh_fill<false>(tops, sides, lens1, lens2, A, Bs, m, k, op, ex, bnd,
                    scores, nullptr, nullptr);
}

__global__ void __launch_bounds__(32) gotoh_codes_kernel(
    const int* __restrict__ tops, const int* __restrict__ sides,
    const int* __restrict__ lens1, const int* __restrict__ lens2, int A,
    int Bs, int m, int k, int op, int ex, int* __restrict__ bnd,
    unsigned* __restrict__ codes, int* __restrict__ scores,
    int* __restrict__ states) {
  gotoh_fill<true>(tops, sides, lens1, lens2, A, Bs, m, k, op, ex, bnd,
                   scores, codes, states);
}

}  // namespace

// K17 / K23 / K20 port: int32 Gotoh global scores at the true corners.
// bnd is int32[B, 3, A+1] scratch.
extern "C" int gotoh_scores(const int* tops, const int* sides,
                            const int* lens1, const int* lens2, int B, int A,
                            int Bs, int m, int k, int open, int extend,
                            int* bnd, int* scores, void* stream) {
  if (B <= 0) return 0;
  gotoh_scores_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      tops, sides, lens1, lens2, A, Bs, m, k, open, extend, bnd, scores);
  return static_cast<int>(cudaGetLastError());
}

// K21 / K25 port: 4-bit walk codes (bits 0-1 M's predecessor state,
// bit 2 IX extends, bit 3 IY extends) in the band-major layout above,
// the int32 Gotoh scores and the argmax states (0 M, 1 IX, 2 IY) at the
// true corners.  codes is uint32[B, ceil(Bs/32), 4*ceil((A+32)/32), 32];
// bnd is int32[B, 4, A+1] scratch.
extern "C" int gotoh_fill_codes(const int* tops, const int* sides,
                                const int* lens1, const int* lens2, int B,
                                int A, int Bs, int m, int k, int open,
                                int extend, int* bnd, void* codes,
                                int* scores, int* states, void* stream) {
  if (B <= 0) return 0;
  gotoh_codes_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      tops, sides, lens1, lens2, A, Bs, m, k, open, extend, bnd,
      static_cast<unsigned*>(codes), scores, states);
  return static_cast<int>(cudaGetLastError());
}
