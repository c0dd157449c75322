// Batch aligned-string materialization from walk op codes.
//
// Native counterpart of nw_tpu.ops.traceback.ops_to_strings_batch: the
// reference prints its walk buffers back-to-front (origin -> corner,
// needleman-wunsch.c:137-182); the device walkers emit op codes
// corner -> origin, so each pair's characters are written back-to-front
// into a caller-provided output slab in one pass.  Op codes are the
// reference DFS descend encoding: 0 diag (consumes s1[i-1], s2[j-1]),
// 1 left (s1[i-1], gap), 2 up (gap, s2[j-1]) — needleman-wunsch.c:305-324.
//
// Layout: per pair b, X occupies out[2*off[b] .. 2*off[b]+n) and Y
// follows at out[2*off[b]+n .. 2*off[b]+2n) with n = ns[b]; off is the
// exclusive prefix sum of ns.  Sequences arrive as two concatenated
// byte buffers with their own prefix-sum offsets.

#include <cstdint>

extern "C" void nw_ops_to_strings(
    const int8_t *ops, int64_t B, int64_t S, const int32_t *ns,
    const uint8_t *s1cat, const int64_t *off1,
    const uint8_t *s2cat, const int64_t *off2,
    const int64_t *out_off, uint8_t *out, uint8_t gap) {
  for (int64_t b = 0; b < B; ++b) {
    const int8_t *o = ops + b * S;
    int64_t n = ns[b];
    const uint8_t *s1 = s1cat + off1[b];
    const uint8_t *s2 = s2cat + off2[b];
    int64_t i = off1[b + 1] - off1[b];  // len1
    int64_t j = off2[b + 1] - off2[b];  // len2
    uint8_t *X = out + 2 * out_off[b];
    uint8_t *Y = X + n;
    for (int64_t t = 0; t < n; ++t) {
      int8_t op = o[t];
      int64_t p = n - 1 - t;  // write back-to-front: origin -> corner
      if (op == 0) {
        X[p] = s1[--i];
        Y[p] = s2[--j];
      } else if (op == 1) {
        X[p] = s1[--i];
        Y[p] = gap;
      } else {
        X[p] = gap;
        Y[p] = s2[--j];
      }
    }
  }
}
