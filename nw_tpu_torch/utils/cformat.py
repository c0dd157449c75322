"""ANSI escape formatting — byte-parity with the reference.

Mirrors ``format.h:44-109`` / ``format.c:47-97``: nine format roles, all
of which are no-ops unless color is enabled (the reference's global
``cflag``).  Note the reference quirks preserved deliberately:

* ``MATCH_CHAR_FMT`` and ``GAP_CHAR_FMT`` are *empty strings* — when
  color is on, matching/gap characters get no prefix but still get a
  trailing reset (needleman-wunsch.c:101-119 always calls reset_fmt()).
* ``top_string_fmt`` is set before the table's header row but never reset
  (print-table.c:172-182) — the bold "bleeds" into subsequent output.
  The renderer reproduces this.
"""

from __future__ import annotations

import enum

CSI = b"\x1b["

TOP_STRING = CSI + b"1m"
SIDE_STRING = CSI + b"1m"
OPT_PATH = CSI + b"32;1m"
MATCH_ARROW = CSI + b"36;1m"
MISMATCH_ARROW = CSI + b"31;1m"
GAP_ARROW = CSI + b"33;1m"
MATCH_CHAR = b""
MISMATCH_CHAR = MISMATCH_ARROW
GAP_CHAR = b""
RESET = CSI + b"0m"


class Fmt(enum.Enum):
    top_string = TOP_STRING
    side_string = SIDE_STRING
    opt_path = OPT_PATH
    match_arrow = MATCH_ARROW
    mismatch_arrow = MISMATCH_ARROW
    gap_arrow = GAP_ARROW
    match_char = MATCH_CHAR
    mismatch_char = MISMATCH_CHAR
    gap_char = GAP_CHAR


def set_fmt(f: Fmt, color: bool) -> bytes:
    """Bytes that ``set_fmt()`` (format.c:47) would print."""
    return f.value if color else b""


def reset_fmt(color: bool) -> bytes:
    """Bytes that ``reset_fmt()`` (format.c:92) would print."""
    return RESET if color else b""
