"""Host-side enumeration of ALL optimal alignments.

Re-implementation of the reference's iterative DFS
(``construct_alignments_for_subtable``, needleman-wunsch.c:209-331) over
the packed arrow matrix the device kernels produce.  Enumeration order is
identical: at every cell descend **diag, then left, then up**
(needleman-wunsch.c:305-324), which fixes the order alignments are
emitted in (verified against the reference binary: GCATGCU/GATTACA →
``GCA-TGCU``, ``GCAT-GCU``, ``GCATG-CU``).

Unlike the reference — whose walk state is 32 bytes of done-flags per
table cell — the DFS state here lives on an explicit stack (one (i, j,
stage) frame per depth, max depth M+N), so the table itself stays a
read-only uint8 matrix.

The enumeration is inherently sequential and worst-case exponential in
the number of tie branches (the reference runs forever on random 1k
pairs); a native C++ fast path lives in :mod:`nw_tpu_torch.runtime` and this
module transparently uses it when built.  ``max_alignments`` bounds the
walk (``None`` = uncapped, the reference behavior).
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

GAP = ord("-")


def iter_alignments(
    arrows: np.ndarray,
    s1: bytes,
    s2: bytes,
    max_alignments: Optional[int] = None,
) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (X, Y) aligned byte-string pairs in reference DFS order.

    arrows: uint8[N, M] rectangular packed arrow matrix
      (N = len(s2)+1 rows, M = len(s1)+1 cols).
    """
    M = len(s1) + 1
    N = len(s2) + 1
    if M == 1 and N == 1:
        # Degenerate 1x1 table: the reference DFS terminates immediately
        # without emitting anything (its loop guard at
        # needleman-wunsch.c:231-235 is false on entry), so there are zero
        # alignments.  Unreachable from the CLI (the reader can never
        # produce an empty second sequence) but kept for library parity.
        return
    maxlen = M + N
    X = bytearray(maxlen)
    Y = bytearray(maxlen)
    # stack frames: [i, j, stage]; stage 0 = try diag, 1 = try left,
    # 2 = try up, 3 = backtrack
    stack = [[M - 1, N - 1, 0]]
    n = 0
    emitted = 0
    a_flat = np.ascontiguousarray(arrows).reshape(-1)

    while stack:
        frame = stack[-1]
        i, j, stage = frame
        if stage == 0 and i == 0 and j == 0:
            # Reached the origin: one complete optimal alignment
            # (needleman-wunsch.c:249-255).  Characters were written
            # corner->origin; the reference prints back-to-front
            # (needleman-wunsch.c:149), i.e. origin->corner.
            yield bytes(X[n - 1 :: -1] if n else b""), bytes(Y[n - 1 :: -1] if n else b"")
            emitted += 1
            if max_alignments is not None and emitted >= max_alignments:
                return
            frame[2] = 3
            continue
        a = a_flat[j * M + i]
        if stage == 0:
            frame[2] = 1
            if a & 1:  # diag
                X[n] = s1[i - 1]
                Y[n] = s2[j - 1]
                n += 1
                stack.append([i - 1, j - 1, 0])
        elif stage == 1:
            frame[2] = 2
            if a & 2:  # left
                X[n] = s1[i - 1]
                Y[n] = GAP
                n += 1
                stack.append([i - 1, j, 0])
        elif stage == 2:
            frame[2] = 3
            if a & 4:  # up
                X[n] = GAP
                Y[n] = s2[j - 1]
                n += 1
                stack.append([i, j - 1, 0])
        else:
            stack.pop()
            if stack:
                n -= 1


def enumerate_alignments(
    arrows: np.ndarray,
    s1: bytes,
    s2: bytes,
    emit: Callable[[bytes, bytes], None],
    max_alignments: Optional[int] = None,
    use_native: bool = True,
) -> int:
    """Run the full enumeration, calling ``emit(X, Y)`` per alignment.

    Returns the number of alignments found.  Uses the native C++ walker
    when available (10-50x faster on branchy tables), falling back to the
    pure-Python DFS.
    """
    if use_native:
        try:
            from nw_tpu_torch.runtime import native

            walker = native.load()
        except Exception:
            walker = None
        if walker is not None:
            return walker.enumerate(arrows, s1, s2, emit, max_alignments)

    count = 0
    for X, Y in iter_alignments(arrows, s1, s2, max_alignments):
        emit(X, Y)
        count += 1
    return count
