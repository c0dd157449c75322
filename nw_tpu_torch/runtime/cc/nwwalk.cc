// nwwalk.cc — native all-optimal-alignments walker.
//
// From-scratch C++ implementation of the capability of the reference's
// construct_alignments_for_subtable (needleman-wunsch.c:209-331): depth-
// first enumeration of every optimal alignment encoded in a packed arrow
// matrix, emitting alignments in the same diag > left > up descend order.
//
// Differences from the reference by design:
//   * walk state is an explicit stack of (i, j, stage) frames instead of
//     32 bytes of done-flags per table cell — the arrow matrix stays
//     read-only (1 byte/cell), so one walk table serves concurrent walks
//     and huge tables don't pay 32x memory;
//   * an optional max_solutions cap (the reference can run forever).
//
// Built as a plain shared library; loaded from Python with ctypes
// (see nw_tpu/runtime/native.py).  No Python.h dependency.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr std::uint8_t kDiag = 1;
constexpr std::uint8_t kLeft = 2;
constexpr std::uint8_t kUp = 4;
constexpr char kGap = '-';

struct Frame {
  std::int32_t i;
  std::int32_t j;
  std::int8_t stage;  // 0 = try diag, 1 = try left, 2 = try up, 3 = pop
};

}  // namespace

extern "C" {

// Called once per optimal alignment with forward-order (print-order)
// aligned strings X and Y of length n.  ctx is passed through verbatim.
typedef void (*nw_emit_fn)(const unsigned char* X, const unsigned char* Y,
                           std::int64_t n, void* ctx);

// Enumerate all optimal alignments.
//   arrows: row-major uint8[N * M] packed arrow matrix
//           (M = len1 + 1 columns, N = len2 + 1 rows)
//   s1, s2: the raw sequences (len1 / len2 bytes, no terminator needed)
//   emit:   per-alignment callback (may be null to count only)
//   max_solutions: stop after this many alignments; < 0 means unlimited
// Returns the number of alignments emitted (uint64).
std::uint64_t nw_enumerate(const unsigned char* arrows, std::int64_t M,
                           std::int64_t N, const unsigned char* s1,
                           const unsigned char* s2, nw_emit_fn emit, void* ctx,
                           std::int64_t max_solutions) {
  if (M == 1 && N == 1) {
    // Degenerate 1x1 table: the reference DFS loop guard is false on
    // entry and emits nothing.
    return 0;
  }

  const std::int64_t maxlen = M + N;
  std::vector<unsigned char> X(maxlen), Y(maxlen);          // corner->origin
  std::vector<unsigned char> Xf(maxlen + 1), Yf(maxlen + 1);  // print order

  std::vector<Frame> stack;
  stack.reserve(maxlen + 1);
  stack.push_back(Frame{static_cast<std::int32_t>(M - 1),
                        static_cast<std::int32_t>(N - 1), 0});
  std::int64_t n = 0;
  std::uint64_t emitted = 0;

  while (!stack.empty()) {
    Frame& f = stack.back();
    if (f.stage == 0 && f.i == 0 && f.j == 0) {
      if (emit != nullptr) {
        for (std::int64_t t = 0; t < n; ++t) {
          Xf[t] = X[n - 1 - t];
          Yf[t] = Y[n - 1 - t];
        }
        Xf[n] = 0;
        Yf[n] = 0;
        emit(Xf.data(), Yf.data(), n, ctx);
      }
      ++emitted;
      if (max_solutions >= 0 &&
          emitted >= static_cast<std::uint64_t>(max_solutions)) {
        return emitted;
      }
      f.stage = 3;
      continue;
    }
    const std::uint8_t a = arrows[static_cast<std::int64_t>(f.j) * M + f.i];
    switch (f.stage) {
      case 0:
        f.stage = 1;
        if (a & kDiag) {
          X[n] = s1[f.i - 1];
          Y[n] = s2[f.j - 1];
          ++n;
          stack.push_back(Frame{f.i - 1, f.j - 1, 0});
        }
        break;
      case 1:
        f.stage = 2;
        if (a & kLeft) {
          X[n] = s1[f.i - 1];
          Y[n] = kGap;
          ++n;
          stack.push_back(Frame{f.i - 1, f.j, 0});
        }
        break;
      case 2:
        f.stage = 3;
        if (a & kUp) {
          X[n] = kGap;
          Y[n] = s2[f.j - 1];
          ++n;
          stack.push_back(Frame{f.i, f.j - 1, 0});
        }
        break;
      default:
        stack.pop_back();
        if (!stack.empty()) --n;
        break;
    }
  }
  return emitted;
}

}  // extern "C"
