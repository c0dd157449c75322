// nwrender.cc — native score-table renderer.
//
// Byte-exact C++ implementation of the reference's table printer
// (print-table.c:50-208), operating on the packed arrow matrix and the
// rectangular score/optimal-path views the device kernels produce.
// The Python renderer (nw_tpu/utils/render.py) is the semantic
// specification; this is the fast path for large tables (interpreted
// Python costs ~microseconds per cell, this costs nanoseconds).
//
// All reference quirks preserved: column width derived from *interior*
// |score| maxima only, %*s padding measured in BYTES (3-byte UTF-8
// arrows), and the header row's set-bold-without-reset format bleed.

#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

const char* kReset = "\x1b[0m";
const char* kBold = "\x1b[1m";
const char* kGreen = "\x1b[32;1m";
const char* kCyan = "\x1b[36;1m";
const char* kRed = "\x1b[31;1m";
const char* kYellow = "\x1b[33;1m";

int width_needed(std::int64_t x) {
  if (x < 0) x = -x;
  int w = 0;
  do {
    x /= 10;
    ++w;
  } while (x != 0);
  return w + 1;  // sign column (print-table.c:184-193)
}

void pad_spaces(std::string& out, int n) {
  for (int i = 0; i < n; ++i) out.push_back(' ');
}

}  // namespace

extern "C" {

void nw_buffer_free(char* p) { std::free(p); }

// scores: int32[N*M] row-major; arrows/in_path: uint8[N*M];
// s1: M-1 bytes (top), s2: N-1 bytes (side).
// Returns a malloc'd buffer (caller frees with nw_buffer_free); length in
// *out_size.
char* nw_render_table(const std::int32_t* scores, const std::uint8_t* arrows,
                      const std::uint8_t* in_path, std::int64_t N,
                      std::int64_t M, const unsigned char* s1,
                      const unsigned char* s2, int unicode, int color,
                      std::int64_t* out_size) {
  const char* left_a = unicode ? "\xe2\x86\x90" : "<";
  const char* up_a = unicode ? "\xe2\x86\x91" : "^";
  const char* diag_a = unicode ? "\xe2\x86\x96" : "\\";
  const int up_alen = unicode ? 3 : 1;

  std::int64_t gav = 0;
  for (std::int64_t r = 1; r < N; ++r)
    for (std::int64_t c = 1; c < M; ++c) {
      std::int64_t v = scores[r * M + c];
      if (v < 0) v = -v;
      if (v > gav) gav = v;
    }
  const int w = width_needed(gav);
  const int up_width = unicode ? w + 2 : w;  // %*s pads by bytes

  std::string out;
  out.reserve(static_cast<size_t>(N) * M * (w + 10) + 256);

  // header (print_top_string, :172-182) — bold without reset (quirk)
  if (color) out += kBold;
  out += "*    ";
  pad_spaces(out, w - 1);
  out.push_back('-');
  for (std::int64_t i = 0; i + 1 < M; ++i) {
    out += "    ";
    pad_spaces(out, w - 1);
    out.push_back(static_cast<char>(s1[i]));
  }
  out.push_back('\n');

  char num[32];
  for (std::int64_t r = 0; r < N; ++r) {
    // directional row (:88-118)
    out.push_back(' ');
    for (std::int64_t c = 0; c < M; ++c) {
      const std::uint8_t a = arrows[r * M + c];
      const bool opt = in_path[r * M + c] != 0;
      if (a & 1) {  // diag
        if (opt && color) {
          const bool match = c >= 1 && r >= 1 && s1[c - 1] == s2[r - 1];
          out += match ? kCyan : kRed;
        }
        out += "  ";
        out += diag_a;
        out.push_back(' ');
        if (opt && color) out += kReset;
      } else {
        out += "    ";
      }
      if (a & 4) {  // up
        if (opt && color) out += kYellow;
        pad_spaces(out, up_width - up_alen);
        out += up_a;
        if (opt && color) out += kReset;
      } else {
        pad_spaces(out, w);
      }
    }
    out.push_back('\n');

    // score row (:120-157)
    if (color) out += kBold;  // side_string_fmt
    out.push_back(r == 0 ? '-' : static_cast<char>(s2[r - 1]));
    if (color) out += kReset;
    for (std::int64_t c = 0; c < M; ++c) {
      const std::uint8_t a = arrows[r * M + c];
      const bool opt = in_path[r * M + c] != 0;
      if (a & 2) {  // left
        if (opt && color) out += kYellow;
        out += "  ";
        out += left_a;
        out.push_back(' ');
        if (opt && color) out += kReset;
      } else {
        out += "    ";
      }
      if (opt && color) out += kGreen;
      std::snprintf(num, sizeof(num), "%+*d", w,
                    static_cast<int>(scores[r * M + c]));
      out += num;
      if (opt && color) out += kReset;
    }
    out.push_back('\n');
  }

  char* buf = static_cast<char*>(std::malloc(out.size()));
  if (buf == nullptr) {
    *out_size = 0;
    return nullptr;
  }
  std::memcpy(buf, out.data(), out.size());
  *out_size = static_cast<std::int64_t>(out.size());
  return buf;
}

}  // extern "C"
