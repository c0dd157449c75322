"""Aligned-pair output formatting — byte-parity with
``print_aligned_strings_and_counts`` (needleman-wunsch.c:91-182).
"""

from __future__ import annotations

from typing import Tuple

from nw_tpu_torch.utils import cformat as cf

GAP = ord("-")


def _char_fmt(c1: int, c2: int) -> cf.Fmt:
    """Format role for printing c1 against c2
    (print_aligned_string_char, needleman-wunsch.c:101-119)."""
    if c1 == c2:
        return cf.Fmt.match_char
    if c1 == GAP or c2 == GAP:
        return cf.Fmt.gap_char
    return cf.Fmt.mismatch_char


def pair_counts(X: bytes, Y: bytes) -> Tuple[int, int, int]:
    """(matches, mismatches, indels) for an aligned pair
    (needleman-wunsch.c:153-161)."""
    match = mismatch = gap = 0
    for c1, c2 in zip(X, Y):
        if c1 == c2:
            match += 1
        elif c1 == GAP or c2 == GAP:
            gap += 1
        else:
            mismatch += 1
    return match, mismatch, gap


def format_aligned_pair(
    X: bytes,
    Y: bytes,
    no_print_strings: bool,
    print_counts: bool,
    color: bool,
) -> bytes:
    """Bytes for one optimal alignment, exactly as the reference prints it:
    X line, Y line (each character formatted against its partner), an
    optional counts line (note: "indels", with exact pluralization —
    needleman-wunsch.c:175-178), and a trailing blank line.
    """
    out = bytearray()
    if not no_print_strings:
        for c1, c2 in zip(X, Y):
            out += cf.set_fmt(_char_fmt(c1, c2), color)
            out.append(c1)
            out += cf.reset_fmt(color)
        out += b"\n"
        for c1, c2 in zip(Y, X):
            out += cf.set_fmt(_char_fmt(c1, c2), color)
            out.append(c1)
            out += cf.reset_fmt(color)
        out += b"\n"
    if print_counts:
        match, mismatch, gap = pair_counts(X, Y)
        out += (
            f"{match} match{'' if match == 1 else 'es'}, "
            f"{mismatch} mismatch{'' if mismatch == 1 else 'es'}, "
            f"{gap} indel{'' if gap == 1 else 's'}\n"
        ).encode("ascii")
    out += b"\n"
    return bytes(out)
