// Native sequence reader — the C++ equivalent of the reference's
// read-sequences.c (read_two_sequences_from_stream, :102-122):
//
//   * sequence 1 = bytes up to the first C-whitespace byte; hitting EOF
//     first is an error even if characters were read (:50-53)
//   * whitespace before sequence 2 is skipped; EOF there is an error
//   * sequence 2 = bytes up to whitespace or EOF (eof_ok, :57)
//
// Reads from a file descriptor in chunks (the reference's fgetc is
// buffered the same way); bytes past sequence 2's terminator are left
// unread up to chunk granularity, exactly like stdio buffering.

#include <cerrno>
#include <cstdlib>
#include <cstring>
#include <unistd.h>

namespace {

struct Buf {
  char* data = nullptr;
  size_t len = 0, cap = 0;
  bool push(char c) {
    if (len == cap) {
      size_t ncap = cap ? cap * 2 : 4096;  // BUFSIZ-style growth
      char* nd = static_cast<char*>(realloc(data, ncap));
      if (!nd) return false;
      data = nd;
      cap = ncap;
    }
    data[len++] = c;
    return true;
  }
};

inline bool c_isspace(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
         c == '\r';
}

struct Reader {
  int fd;
  char chunk[1 << 16];
  ssize_t n = 0, pos = 0;
  int err = 0;  // errno of a failed read(2), 0 otherwise
  // returns -1 on EOF or read error (err distinguishes), else the byte
  int next() {
    if (pos >= n) {
      n = read(fd, chunk, sizeof chunk);
      pos = 0;
      if (n <= 0) {
        if (n < 0) err = errno;  // ferror() analogue (EISDIR on a dir fd)
        return -1;
      }
    }
    return static_cast<unsigned char>(chunk[pos++]);
  }
  void unget() { --pos; }
};

}  // namespace

extern "C" {

// Returns 0 on success, 1 on early EOF (the reference's fatal case),
// 2 on allocation failure, 3 on a read(2) error with *out_errno set —
// the reference's check_stream_for_err_and_eof tests ferror() BEFORE
// feof() (read-sequences.c:46-55), so a stream error ("fgetc failed",
// e.g. EISDIR on a directory fd) wins even where EOF would be legal.
// *s1/*s2 are malloc'd (never null on success; possibly empty); free
// with nw_read_free.
int nw_read_two_sequences(int fd, char** s1, long long* n1, char** s2,
                          long long* n2, int* out_errno) {
  Reader r{fd};
  Buf a, b;
  *s1 = *s2 = nullptr;
  *n1 = *n2 = 0;
  *out_errno = 0;

  // sequence 1: up to first whitespace; EOF is fatal (eof_ok == 0)
  for (;;) {
    int c = r.next();
    if (c < 0) {
      free(a.data);
      if (r.err) {
        *out_errno = r.err;
        return 3;
      }
      return 1;
    }
    if (c_isspace(static_cast<unsigned char>(c))) break;
    if (!a.push(static_cast<char>(c))) {
      free(a.data);
      return 2;
    }
  }
  // skip whitespace; EOF here is fatal too (discard + first char of 2)
  int c;
  for (;;) {
    c = r.next();
    if (c < 0) {
      free(a.data);
      if (r.err) {
        *out_errno = r.err;
        return 3;
      }
      return 1;
    }
    if (!c_isspace(static_cast<unsigned char>(c))) break;
  }
  r.unget();
  // sequence 2: up to whitespace or EOF (eof_ok == 1; error still fatal)
  for (;;) {
    c = r.next();
    if (c < 0) {
      if (r.err) {
        free(a.data);
        free(b.data);
        *out_errno = r.err;
        return 3;
      }
      break;
    }
    if (c_isspace(static_cast<unsigned char>(c))) break;
    if (!b.push(static_cast<char>(c))) {
      free(a.data);
      free(b.data);
      return 2;
    }
  }

  if (!a.data) a.data = static_cast<char*>(malloc(1));
  if (!b.data) b.data = static_cast<char*>(malloc(1));
  if (!a.data || !b.data) {
    free(a.data);
    free(b.data);
    return 2;
  }
  *s1 = a.data;
  *n1 = static_cast<long long>(a.len);
  *s2 = b.data;
  *n2 = static_cast<long long>(b.len);
  return 0;
}

void nw_read_free(void* p) { free(p); }

}  // extern "C"
