"""Score-table renderer — byte-parity with ``print-table.c``.

Renders the filled DP table with direction arrows, optional Unicode
glyphs, and optional ANSI coloring of the optimal path(s).  All spacing
rules are reproduced from the reference, including the ones that are
subtle or arguably bugs:

* column width is derived from the largest *interior* |score| only —
  boundary row/column values never update ``greatest_abs_val``
  (needleman-wunsch.c:534-541 runs only for rows/cols >= 1);
* printf pads ``%*s`` by **bytes**, so a 3-byte UTF-8 up-arrow is padded
  to ``col_width + 2`` bytes (print-table.c:64-66);
* the header row sets bold but never resets it — the format bleeds into
  the rest of the output when ``-c`` is on (print-table.c:172-182).
"""

from __future__ import annotations

import numpy as np

from nw_tpu_torch.utils import cformat as cf

ASCII_LEFT = b"<"
ASCII_UP = b"^"
ASCII_DIAG = b"\\"
UNI_LEFT = "←".encode("utf-8")
UNI_UP = "↑".encode("utf-8")
UNI_DIAG = "↖".encode("utf-8")


def width_needed_to_print_integer(x: int) -> int:
    """Digits of |x| plus one sign column (print-table.c:184-193)."""
    x = abs(int(x))
    w = 0
    while True:
        x //= 10
        w += 1
        if x == 0:
            break
    return w + 1


def greatest_interior_abs(scores: np.ndarray) -> int:
    """Max |score| over interior cells (row >= 1 and col >= 1) — the
    reference's ``greatest_abs_val`` (score-table.h:73, updated only in
    score_cell_column, needleman-wunsch.c:534-541)."""
    if scores.shape[0] < 2 or scores.shape[1] < 2:
        return 0
    return int(np.abs(scores[1:, 1:]).max())


def render_table(
    scores: np.ndarray,
    arrows: np.ndarray,
    in_path: np.ndarray,
    s1: bytes,
    s2: bytes,
    unicode: bool = False,
    color: bool = False,
) -> bytes:
    """Render the full table (print_table, print-table.c:195-208).

    Dispatches to the native C++ renderer when built (identical bytes,
    ~100x faster on large tables); this Python body is the
    specification and fallback.
    """
    try:
        from nw_tpu_torch.runtime import native

        rt = native.load()
    except Exception:
        rt = None
    if rt is not None:
        return rt.render_table(
            np.asarray(scores, np.int32), arrows, in_path, s1, s2, unicode, color
        )
    return render_table_py(scores, arrows, in_path, s1, s2, unicode, color)


def render_table_py(
    scores: np.ndarray,
    arrows: np.ndarray,
    in_path: np.ndarray,
    s1: bytes,
    s2: bytes,
    unicode: bool = False,
    color: bool = False,
) -> bytes:
    """Pure-Python renderer: scores int[N, M]; arrows/in_path uint8/bool."""
    N, M = scores.shape
    w = width_needed_to_print_integer(greatest_interior_abs(scores))
    out = bytearray()

    # --- header row (print_top_string, print-table.c:172-182) ---
    out += cf.set_fmt(cf.Fmt.top_string, color)
    out += b"*    " + b" " * (w - 1) + b"-"
    for i in range(M - 1):
        out += b"    " + b" " * (w - 1) + s1[i : i + 1]
    out += b"\n"
    # NOTE: no reset — reference format-bleed quirk.

    left_a = UNI_LEFT if unicode else ASCII_LEFT
    up_a = UNI_UP if unicode else ASCII_UP
    diag_a = UNI_DIAG if unicode else ASCII_DIAG
    up_width = w + 2 if unicode else w  # %*s pads by bytes

    for row in range(N):
        # --- directional row (print_directional_row, :88-118) ---
        out += b" "
        for col in range(M):
            a = int(arrows[row, col])
            opt = bool(in_path[row, col])
            if a & 1:  # diag
                if opt:
                    match = col >= 1 and row >= 1 and s1[col - 1] == s2[row - 1]
                    out += cf.set_fmt(
                        cf.Fmt.match_arrow if match else cf.Fmt.mismatch_arrow, color
                    )
                out += b"  " + diag_a + b" "
                if opt:
                    out += cf.reset_fmt(color)
            else:
                out += b"    "
            if a & 4:  # up
                if opt:
                    out += cf.set_fmt(cf.Fmt.gap_arrow, color)
                out += b" " * (up_width - len(up_a)) + up_a
                if opt:
                    out += cf.reset_fmt(color)
            else:
                out += b" " * w
        out += b"\n"

        # --- score row (print_score_row, :120-157) ---
        out += cf.set_fmt(cf.Fmt.side_string, color)
        out += b"-" if row == 0 else s2[row - 1 : row]
        out += cf.reset_fmt(color)
        for col in range(M):
            a = int(arrows[row, col])
            opt = bool(in_path[row, col])
            if a & 2:  # left
                if opt:
                    out += cf.set_fmt(cf.Fmt.gap_arrow, color)
                out += b"  " + left_a + b" "
                if opt:
                    out += cf.reset_fmt(color)
            else:
                out += b"    "
            if opt:
                out += cf.set_fmt(cf.Fmt.opt_path, color)
            out += f"{int(scores[row, col]):+{w}d}".encode("ascii")
            if opt:
                out += cf.reset_fmt(color)
        out += b"\n"

    return bytes(out)
