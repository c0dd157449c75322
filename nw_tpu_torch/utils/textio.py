"""Byte-exact input parsing: sequence reading and C ``atoi`` semantics.

Mirrors ``read-sequences.c`` and the reference's unvalidated
``atoi``-based operand parsing (needleman-wunsch.c:783-785).
"""

from __future__ import annotations

from typing import BinaryIO, Tuple

# C isspace() set in the default locale (ctype.h)
C_WHITESPACE = b" \t\n\v\f\r"


class EarlyEOFError(Exception):
    """Raised where the reference dies with
    "got EOF too early when reading input strings"
    (read-sequences.c:50-53)."""


_CHUNK = 1 << 16
_WS_SET = frozenset(C_WHITESPACE)


def _find_ws(buf: bytes, start: int) -> int:
    """Index of the first C-whitespace byte at/after ``start``, or -1."""
    best = -1
    for w in C_WHITESPACE:
        i = buf.find(w, start)
        if i != -1 and (best == -1 or i < best):
            best = i
    return best


def read_two_sequences(stream: BinaryIO) -> Tuple[bytes, bytes]:
    """Read two whitespace-separated sequences
    (read_two_sequences_from_stream, read-sequences.c:102-122).

    Semantics reproduced exactly: sequence 1 ends at the first
    whitespace byte -- EOF instead is fatal even if characters were read
    (read-sequences.c:50-53); whitespace before sequence 2 is skipped,
    EOF there is fatal too; sequence 2 ends at whitespace or EOF.

    Reads the stream in chunks but never past what is needed (as with
    the reference's fgetc loop, input after sequence 2's terminator is
    left unread, up to chunk granularity), so piped/endless inputs
    terminate.

    Streams backed by a real file descriptor take the native C++ reader
    (runtime/cc/nwread.cc); in-memory streams use the Python path below
    (identical semantics, equivalence-tested).
    """
    fd = None
    try:
        fd = stream.fileno()
    except Exception:
        fd = None
    if fd is not None:
        import os as _os

        if not _os.environ.get("NW_TPU_NO_NATIVE"):
            from nw_tpu_torch.runtime import native

            rt = native.load()
            if rt is not None:
                try:
                    return rt.read_two_sequences(fd)
                except EOFError:
                    raise EarlyEOFError(
                        "got EOF too early when reading input strings"
                    )

    buf = bytearray()

    def fill() -> bool:
        chunk = stream.read(_CHUNK)
        if not chunk:
            return False
        buf.extend(chunk)
        return True

    # sequence 1: bytes up to the first whitespace (consumed)
    pos = 0
    while True:
        i = _find_ws(bytes(buf), pos)
        if i != -1:
            break
        pos = len(buf)
        if not fill():
            raise EarlyEOFError()  # EOF before seq 1's terminator
    s1 = bytes(buf[:i])

    # skip whitespace; EOF here is fatal (read-sequences.c:109-110)
    j = i + 1
    while True:
        while j < len(buf) and buf[j] in _WS_SET:
            j += 1
        if j < len(buf):
            break
        if not fill():
            raise EarlyEOFError()

    # sequence 2: until whitespace or EOF (EOF ok, :117)
    e = j
    while True:
        i = _find_ws(bytes(buf), e)
        if i != -1:
            return s1, bytes(buf[j:i])
        e = len(buf)
        if not fill():
            return s1, bytes(buf[j:])


_LONG_MAX = 2**63 - 1
_LONG_MIN = -(2**63)


def c_atoi(s: str | bytes) -> int:
    """C ``atoi(3)`` semantics, including silent garbage -> 0.

    The reference never validates operands (needleman-wunsch.c:783-785):
    ``atoi("x") == 0`` silently.  glibc atoi is ``(int)strtol(s, 0, 10)``:
    leading C whitespace skipped, optional sign, digits until the first
    non-digit; saturates at long range then truncates to int.
    """
    if isinstance(s, str):
        s = s.encode("utf-8", "surrogateescape")
    i = 0
    while i < len(s) and s[i : i + 1] in C_WHITESPACE:
        i += 1
    sign = 1
    if i < len(s) and s[i] in b"+-":
        if s[i] == ord("-"):
            sign = -1
        i += 1
    v = 0
    while i < len(s) and 0x30 <= s[i] <= 0x39:
        v = v * 10 + (s[i] - 0x30)
        i += 1
    v *= sign
    v = max(_LONG_MIN, min(_LONG_MAX, v))  # strtol saturation
    return ((v + 2**31) % 2**32) - 2**31  # (int) truncation
