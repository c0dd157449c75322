// Batched greedy traceback walk for Hopper (sm_90a).
//
// Replaces the JAX walk loops that read K2's 2-bit greedy words on the
// TPU: nw_tpu/ops/banded_traceback.py:_make_walk_loop (the group walk
// of the one-pass and two-pass engines) and
// nw_tpu/ops/traceback.py:traceback_greedy2.  Those were jnp code, not
// Pallas; in eager PyTorch a 20 000-step loop of small ops is bound by
// launch overhead, so the walk is a kernel too.  Because the port fills
// the codes of the whole sub-batch at once (nw_fill.cu), the group walk
// and its on-device stitch (device_stitch_pack) have no counterpart:
// each pair's ops come out in order in one pass.
//
// Design.  One thread per pair.  It starts at the true corner
// (len2, len1), reads the 2-bit code of its cell from the band-major
// layout of nw_fill.cu (0 diag, 1 left, 2 up; the code IS the op),
// writes it, and steps to the predecessor until it reaches the origin;
// on row 0, which is not stored, it steps LEFT.  ops[b] must arrive
// filled with OP_NONE (3); the thread writes its n real ops in walk
// order (corner -> origin).
//
// What bounds it on the H100: the chain of dependent loads — each step's
// address depends on the previous step's code, and a diagonal step moves
// to another row, i.e. another cache line, so one walk of 20 000 steps
// is ~20 000 serial L2/HBM round trips.  Pairs walk in parallel; nothing
// in the design hides the per-step latency (prefetching the words around
// the path is left for later).
//
// nw_walk_masks is the same walk over the rectangular 3-bit tie masks of
// a batch, uint8[B, Bs+1, A+1] (nw_fill.cu's MASKS mode, or
// nw_fill_masks a pair at a time): the jnp walk of
// nw_tpu/ops/traceback.py:38 traceback_greedy, vmapped at :197-207 over
// the masks of K2's pack_bits=8 mode and of K10.  Each step takes the
// first set bit in diag > left > up order, UP where none is set; row 0
// steps LEFT, as nw_walk.  One thread a pair, bound by the same chain of
// dependent loads (a byte a cell: a diagonal step moves to another row).
//
// nw_walk_runs is nw_walk_masks's kernel in its third mode: the run-skip
// walk over the run bytes min(run, 63) << 2 | code of nw_fill.cu's RUNS
// mode (nw_fill_runs_batch), the counterpart of
// nw_tpu/ops/banded_traceback.py:187 _make_runs_walk_loop.  Each
// dependent load consumes a whole run: diag K moves to (j-K, i-K), left
// K to (j, i-K), up to (j-1, i); row 0 steps LEFT and column 0 UP to the
// origin with no load.  The thread writes the expanded op string
// straight into its row of ops, so the walk needs no record buffer: the
// TPU engine's record cap (_runs_record_cap, RunsRecordOverflow and its
// fallback to the per-cell engine) was a limit of its traced loop and
// has no counterpart.  Bound by the chain of dependent loads, one a run
// instead of one a step, each to another row of the table on a diagonal
// run; the op stores are the same as nw_walk's.
//
// nw_walk_window is the same walk over ONE block of rows (j0, j0+rows]
// of one pair, re-filled from a checkpoint row by nw_fill_codes_single:
// the block walk of nw_tpu/ops/checkpoint_traceback.py:353-373 and the
// relay walk of nw_tpu/parallel/huge_pair.py:871 (_make_relay_walk,
// _make_arrow_at_pallasb), both jnp loops on the TPU.  One thread reads
// (i, j, n) from device memory, walks until it reaches row j0 (or, when
// j0 is 0, the origin, stepping LEFT along row 0), and writes (i, j, n)
// back, so the blocks of a pair chain on one stream with no host sync.
// Code row of cell row j: j - j0 - 1.  Its masks mode walks the 3-bit tie
// masks (bit0 diag, bit1 left, bit2 up) of a rank's rows of a sharded pair
// instead, uint8[rows, A+1] row-major from nw_fill_tile's masks mode
// (K28): the first set bit in diag > left > up order, UP where none is
// set, as the relay walk over K28's words does
// (nw_tpu/parallel/huge_pair.py:894-903, _make_arrow_at_pallas).
//
// sw_walk is the Smith-Waterman walk over the local codes of
// nw_fill.cu's LOCAL mode (sw_fill_codes): the jnp loops
// nw_tpu/models/smith_waterman.py:220 _sw_walk_packed (over K24's words)
// and nw_tpu/ops/variants_banded.py:1300-1360 (_sw_walk_device, over
// K18's).  One thread a pair starts at its best cell (j*, i*), follows
// the codes with walk()'s lookup and stops on a STOP code (a cell of
// score 0, a local start) or on row 0 or column 0, whose cells are 0 and
// not stored: not nw_walk's rule, which steps LEFT along row 0.  It
// writes its ops in walk order and the cell where it stopped.  It walks
// the overlap codes of nw_fill.cu's OVERLAP mode (overlap_fill_codes)
// unchanged, from the end cell to row 0 or column 0 (whose cells are
// STOP): the jnp loops nw_tpu/models/overlap.py:178 _overlap_walk_diag
// and nw_tpu/ops/variants_banded.py:752 _overlap_walk_device.
//
// gotoh_walk is Gotoh's three-state walk over the 4-bit codes of
// nw_affine.cu's CODES mode (gotoh_fill_codes): the jnp loops
// nw_tpu/models/affine.py:340 _affine_walk_packed (over K25's words) and
// nw_tpu/ops/variants_banded.py:1803-1873 (the group walk of
// _affine_walk_device, over K21's).  One thread a pair starts at the
// true corner in the corner's state.  In state M it emits DIAG and
// moves to the state in bits 0-1 of its cell; in IX it emits LEFT and
// stays in IX when bit 2 is set, else moves to M; in IY it emits UP and
// stays in IY when bit 3 is set, else M.  On row 0 it steps LEFT to the
// origin and on column 0 UP, whatever its state: it never reads a cell
// outside the rectangle (nw_tpu's walks read side[j-1] at j = 0 when
// the states near the sentinel send them there).  Each step reads one
// 4-bit code, so the walk is bound by the same chain of dependent loads
// as the others, over twice the bytes of 2-bit codes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOpDiag = 0;
constexpr int kOpLeft = 1;
constexpr int kOpUp = 2;
constexpr int kCodeStop = 3;

// what nw_walk_kernel walks
constexpr int kWalkCodes = 0;  // band-major 2-bit codes (nw_fill_codes)
constexpr int kWalkMasks = 1;  // row-major 3-bit tie masks
constexpr int kWalkRuns = 2;   // row-major run bytes (nw_fill_runs_batch)

// The 2-bit code of code row r, column i (band-major, TW words a band row)
__device__ __forceinline__ int code_at(const unsigned* __restrict__ base,
                                       int TW, int r, int i) {
  const int band = r >> 5;
  const int jj = r & 31;
  const int t = i + jj;
  const unsigned w = base[(static_cast<int64_t>(band) * TW + (t >> 4)) * 32 + jj];
  return (w >> (2 * (t & 15))) & 3u;
}

// The op of a 3-bit tie mask: its first set bit, diag > left > up
__device__ __forceinline__ int mask_op(unsigned v) {
  return (v & 1u) ? kOpDiag : ((v & 2u) ? kOpLeft : kOpUp);
}

// The op of row r (of the stored rows), column i: a 2-bit code (stride =
// TW) or, with MASKS, a tie mask of a row-major table (stride = A+1)
template <bool MASKS>
__device__ __forceinline__ int op_at(const void* __restrict__ base, int stride,
                                     int r, int i) {
  if (MASKS)
    return mask_op(static_cast<const unsigned char*>(base)[static_cast<int64_t>(r) * stride + i]);
  return code_at(static_cast<const unsigned*>(base), stride, r, i);
}

// Walk from (i, j) over the ops of rows j0+1 .. , writing ops from out[n];
// stops at row j0 when j0 > 0, else at the origin, or after S ops.
template <bool MASKS = false>
__device__ __forceinline__ void walk(const void* __restrict__ base, int stride,
                                     int j0, int S, int& i, int& j, int& n,
                                     signed char* __restrict__ out) {
  while ((j > j0 || (j0 == 0 && i > 0)) && n < S) {
    int a = kOpLeft;  // row 0 is not stored: LEFT to the origin
    if (j > 0) a = op_at<MASKS>(base, stride, j - j0 - 1, i);
    out[n++] = static_cast<signed char>(a);
    i -= a != kOpUp;
    j -= a != kOpLeft;
  }
}

// The run-skip walk from (i, j) to the origin over run bytes of rows
// 1 .. (row r at base + r * stride), writing ops from out[n]; stops after
// S ops.  A run's cells all carry its code, so a jump never leaves the
// table: a diag run stops above row 1 (bands restart it) and column 1, a
// left run at column 1 (column 0 is UP).
__device__ __forceinline__ void walk_runs(const unsigned char* __restrict__ base,
                                          int stride, int S, int& i, int& j,
                                          int& n, signed char* __restrict__ out) {
  while ((i > 0 || j > 0) && n < S) {
    int a = kOpLeft, K = i;  // row 0: LEFT to the origin
    if (j > 0 && i == 0) {
      a = kOpUp;  // column 0: UP to the origin
      K = j;
    } else if (j > 0) {
      const unsigned v = base[static_cast<int64_t>(j - 1) * stride + i];
      a = v & 3u;
      K = a == kOpUp ? 1 : max(static_cast<int>(v >> 2), 1);
    }
    K = min(K, S - n);
    for (int q = 0; q < K; ++q) out[n + q] = static_cast<signed char>(a);
    n += K;
    i -= a != kOpUp ? K : 0;
    j -= a != kOpLeft ? K : 0;
  }
}

// kWalkCodes: a pair's nbands bands of 2-bit codes, TW words a band row;
// kWalkMasks / kWalkRuns: a pair's nbands = Bs+1 rows of TW = A+1 tie
// masks / run bytes
template <int LAYOUT>
__global__ void nw_walk_kernel(const void* __restrict__ codes,
                               const int* __restrict__ lens1,
                               const int* __restrict__ lens2, int B,
                               int nbands, int TW, int S,
                               signed char* __restrict__ ops,
                               int* __restrict__ ns) {
  constexpr bool BYTES = LAYOUT != kWalkCodes;
  const int bi = blockIdx.x * blockDim.x + threadIdx.x;
  if (bi >= B) return;
  const int64_t b = bi;
  int i = lens1[b];
  int j = lens2[b];
  int n = 0;
  // the stored rows start at row 1: a byte table's row 0 is skipped
  const void* base = BYTES
      ? static_cast<const void*>(static_cast<const unsigned char*>(codes) +
                                 (b * nbands + 1) * static_cast<int64_t>(TW))
      : static_cast<const void*>(static_cast<const unsigned*>(codes) + b * nbands * TW * 32);
  if (LAYOUT == kWalkRuns)
    walk_runs(static_cast<const unsigned char*>(base), TW, S, i, j, n, ops + b * S);
  else
    walk<LAYOUT == kWalkMasks>(base, TW, 0, S, i, j, n, ops + b * S);
  ns[b] = n;
}

// codes mode: nbands bands of 2-bit codes, TW words a band row; MASKS:
// `nbands` rows of `TW` = A+1 masks
template <bool MASKS>
__global__ void nw_walk_window_kernel(const void* __restrict__ codes,
                                      int nbands, int TW, int j0,
                                      int* __restrict__ state, int S,
                                      signed char* __restrict__ ops) {
  int i = state[0], j = state[1], n = state[2];
  // a start outside the block's codes walks nowhere (n stays short)
  const int rows = MASKS ? nbands : 32 * nbands;
  const int cols = MASKS ? TW : 16 * TW - 31;
  if (j < j0 || j > j0 + rows || i < 0 || i >= cols || n < 0) return;
  walk<MASKS>(codes, TW, j0, S, i, j, n, ops);
  state[0] = i;
  state[1] = j;
  state[2] = n;
}

__global__ void sw_walk_kernel(const unsigned* __restrict__ codes,
                               const int* __restrict__ jstar,
                               const int* __restrict__ istar, int B,
                               int nbands, int TW, int S,
                               signed char* __restrict__ ops,
                               int* __restrict__ ns, int* __restrict__ iend,
                               int* __restrict__ jend) {
  const int bi = blockIdx.x * blockDim.x + threadIdx.x;
  if (bi >= B) return;
  const int64_t b = bi;
  const unsigned* base = codes + b * nbands * TW * 32;
  signed char* out = ops + b * S;
  int i = istar[b];
  int j = jstar[b];
  int n = 0;
  while (i > 0 && j > 0 && n < S) {
    const int a = code_at(base, TW, j - 1, i);
    if (a == kCodeStop) break;
    out[n++] = static_cast<signed char>(a);
    i -= a != kOpUp;
    j -= a != kOpLeft;
  }
  ns[b] = n;
  iend[b] = i;
  jend[b] = j;
}

// The 4-bit Gotoh code of code row r, column i (band-major, TW words a band row)
__device__ __forceinline__ int code4_at(const unsigned* __restrict__ base,
                                        int TW, int r, int i) {
  const int band = r >> 5;
  const int jj = r & 31;
  const int t = i + jj;
  const unsigned w = base[(static_cast<int64_t>(band) * TW + (t >> 3)) * 32 + jj];
  return (w >> (4 * (t & 7))) & 15u;
}

__global__ void gotoh_walk_kernel(const unsigned* __restrict__ codes,
                                  const int* __restrict__ lens1,
                                  const int* __restrict__ lens2,
                                  const int* __restrict__ states, int B,
                                  int nbands, int TW, int S,
                                  signed char* __restrict__ ops,
                                  int* __restrict__ ns) {
  const int bi = blockIdx.x * blockDim.x + threadIdx.x;
  if (bi >= B) return;
  const int64_t b = bi;
  const unsigned* base = codes + b * nbands * TW * 32;
  signed char* out = ops + b * S;
  int i = lens1[b];
  int j = lens2[b];
  int st = states[b];
  int n = 0;
  while ((i > 0 || j > 0) && n < S) {
    int a = kOpLeft;  // row 0: LEFT to the origin
    if (j > 0 && i == 0) {
      a = kOpUp;  // column 0: UP to the origin
    } else if (j > 0) {
      const int c = code4_at(base, TW, j - 1, i);
      if (st == 0) {  // M: the diagonal, into the state of bits 0-1
        a = kOpDiag;
        st = c & 3;
      } else if (st == 1) {  // IX: LEFT, extending on bit 2
        st = (c >> 2) & 1;
      } else {  // IY: UP, extending on bit 3
        a = kOpUp;
        st = (c >> 3) & 1 ? 2 : 0;
      }
    }
    out[n++] = static_cast<signed char>(a);
    i -= a != kOpUp;
    j -= a != kOpLeft;
  }
  ns[b] = n;
}

}  // namespace

// codes: uint32[B, nbands, TW, 32] from nw_fill_codes; ops: int8[B, S]
// prefilled with OP_NONE; ns: int32[B].  S must be >= every len1 + len2.
extern "C" int nw_walk(const void* codes, const int* lens1, const int* lens2,
                       int B, int nbands, int TW, int S, signed char* ops,
                       int* ns, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  nw_walk_kernel<kWalkCodes><<<(B + threads - 1) / threads, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      codes, lens1, lens2, B, nbands, TW, S, ops, ns);
  return static_cast<int>(cudaGetLastError());
}

// masks: uint8[B, Bs+1, A+1] tie masks (row-major, a pair's table after
// another); ops: int8[B, S] prefilled with OP_NONE; ns: int32[B].  S must
// be >= every len1 + len2.
extern "C" int nw_walk_masks(const void* masks, const int* lens1,
                             const int* lens2, int B, int A, int Bs, int S,
                             signed char* ops, int* ns, void* stream) {
  if (B <= 0) return 0;
  if (A < 0 || Bs < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  nw_walk_kernel<kWalkMasks><<<(B + threads - 1) / threads, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      masks, lens1, lens2, B, Bs + 1, A + 1, S, ops, ns);
  return static_cast<int>(cudaGetLastError());
}

// runs: uint8[B, Bs+1, A+1] run bytes from nw_fill_runs_batch (row-major,
// a pair's table after another); ops: int8[B, S] prefilled with OP_NONE;
// ns: int32[B].  S must be >= every len1 + len2.
extern "C" int nw_walk_runs(const void* runs, const int* lens1,
                            const int* lens2, int B, int A, int Bs, int S,
                            signed char* ops, int* ns, void* stream) {
  if (B <= 0) return 0;
  if (A < 0 || Bs < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  nw_walk_kernel<kWalkRuns><<<(B + threads - 1) / threads, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      runs, lens1, lens2, B, Bs + 1, A + 1, S, ops, ns);
  return static_cast<int>(cudaGetLastError());
}

// codes: uint32[B, nbands, TW, 32] from sw_fill_codes; jstar / istar:
// int32[B] start cells, inside the code table; ops: int8[B, S] prefilled
// with OP_NONE; ns, iend, jend: int32[B] (ops written, stop cell).
extern "C" int sw_walk(const void* codes, const int* jstar, const int* istar,
                       int B, int nbands, int TW, int S, signed char* ops,
                       int* ns, int* iend, int* jend, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  sw_walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(codes), jstar, istar, B, nbands, TW, S, ops,
      ns, iend, jend);
  return static_cast<int>(cudaGetLastError());
}

// codes: uint32[1, nbands, TW, 32] of rows j0+1 .. j0+32*nbands (from
// nw_fill_codes_single or nw_fill_tile); state: int32[3] = (i, j, n), read
// and written back; ops: int8[S], written from ops[n].  A start with j
// outside [j0, j0 + 32*nbands] or i + 32 > 16*TW leaves state as it was.
// masks != 0: codes is uint8[nbands, TW] instead, the tie masks of rows
// j0+1 .. j0+nbands with TW = A+1 columns (nw_fill_tile's masks mode), and
// a start outside [j0, j0 + nbands] x [0, TW) leaves state as it was.
extern "C" int nw_walk_window(const void* codes, int nbands, int TW, int j0,
                              int* state, int S, signed char* ops, int masks,
                              void* stream) {
  if (nbands < 0 || TW < 0 || j0 < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (masks)
    nw_walk_window_kernel<true><<<1, 1, 0, s>>>(codes, nbands, TW, j0, state, S, ops);
  else
    nw_walk_window_kernel<false><<<1, 1, 0, s>>>(codes, nbands, TW, j0, state, S, ops);
  return static_cast<int>(cudaGetLastError());
}

// codes: uint32[B, nbands, TW, 32] of 4-bit codes from gotoh_fill_codes;
// states: int32[B] corner states; ops: int8[B, S] prefilled with
// OP_NONE; ns: int32[B].  S must be >= every len1 + len2.
extern "C" int gotoh_walk(const void* codes, const int* lens1,
                          const int* lens2, const int* states, int B,
                          int nbands, int TW, int S, signed char* ops,
                          int* ns, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  gotoh_walk_kernel<<<(B + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(codes), lens1, lens2, states, B, nbands,
      TW, S, ops, ns);
  return static_cast<int>(cudaGetLastError());
}
