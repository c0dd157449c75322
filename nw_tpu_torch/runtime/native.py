"""Build/load the native C++ runtime (ctypes, no pybind11 dependency).

Port of ``nw_tpu/runtime/native.py``.  The C++ sources are the port's
own copy of ``nw_tpu``'s, byte for byte, in ``nw_tpu_torch/runtime/cc/``:
every ``*.cc`` there goes into one shared library built with g++ on
first use (into ``nw_tpu_torch/_build/``, keyed by a source hash, so
edits trigger rebuilds); nothing of ``nw_tpu`` is imported or built.
:func:`load` returns a thin wrapper over:

* ``nw_enumerate`` — the all-optimal-alignments DFS walker (cc/nwwalk.cc)
* ``nw_render_table`` — the score-table renderer (cc/nwrender.cc)
* ``nw_ops_to_strings`` — batch op codes to aligned strings (cc/nwstrings.cc)
* ``nw_read_two_sequences`` — the input reader (cc/nwread.cc)

These are host code, not device kernels.  Any failure — missing
compiler, read-only filesystem — degrades silently to ``None`` and
callers fall back to the pure-Python implementations.  Set
``NW_TPU_NO_NATIVE=1`` to force the Python paths.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from typing import Callable, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "runtime", "cc")
_BUILD = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_cached: Optional["NativeRuntime"] = None
_failed = False

_EMIT_FN = ctypes.CFUNCTYPE(
    None,
    ctypes.POINTER(ctypes.c_ubyte),
    ctypes.POINTER(ctypes.c_ubyte),
    ctypes.c_int64,
    ctypes.c_void_p,
)


def _sources():
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cc")))


def _build_so() -> str:
    h = hashlib.sha256()
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    so_path = os.path.join(_BUILD, f"libnwnative-{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    if not _sources():
        raise RuntimeError(f"no native sources under {_SRC_DIR}")
    os.makedirs(_BUILD, exist_ok=True)
    tmp = so_path + f".tmp{os.getpid()}"
    subprocess.run(
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp] + _sources(),
        check=True,
        capture_output=True,
    )
    os.replace(tmp, so_path)
    return so_path


class NativeRuntime:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        fn = lib.nw_enumerate
        fn.restype = ctypes.c_uint64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte),  # arrows
            ctypes.c_int64,  # M
            ctypes.c_int64,  # N
            ctypes.POINTER(ctypes.c_ubyte),  # s1
            ctypes.POINTER(ctypes.c_ubyte),  # s2
            _EMIT_FN,  # emit
            ctypes.c_void_p,  # ctx
            ctypes.c_int64,  # max_solutions
        ]
        self._enumerate = fn

        rt = lib.nw_render_table
        rt.restype = ctypes.POINTER(ctypes.c_char)
        rt.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int64,  # N
            ctypes.c_int64,  # M
            ctypes.POINTER(ctypes.c_ubyte),  # s1
            ctypes.POINTER(ctypes.c_ubyte),  # s2
            ctypes.c_int,  # unicode
            ctypes.c_int,  # color
            ctypes.POINTER(ctypes.c_int64),  # out_size
        ]
        self._render = rt
        self._free = lib.nw_buffer_free
        self._free.argtypes = [ctypes.POINTER(ctypes.c_char)]

        st = lib.nw_ops_to_strings
        st.restype = None
        st.argtypes = [
            ctypes.POINTER(ctypes.c_int8),  # ops [B, S]
            ctypes.c_int64,  # B
            ctypes.c_int64,  # S
            ctypes.POINTER(ctypes.c_int32),  # ns
            ctypes.POINTER(ctypes.c_ubyte),  # s1cat
            ctypes.POINTER(ctypes.c_int64),  # off1 (B+1)
            ctypes.POINTER(ctypes.c_ubyte),  # s2cat
            ctypes.POINTER(ctypes.c_int64),  # off2 (B+1)
            ctypes.POINTER(ctypes.c_int64),  # out_off (B+1)
            ctypes.POINTER(ctypes.c_ubyte),  # out (2*sum ns)
            ctypes.c_ubyte,  # gap
        ]
        self._ops_to_strings = st

        rd = lib.nw_read_two_sequences
        rd.restype = ctypes.c_int
        rd.argtypes = [
            ctypes.c_int,  # fd
            ctypes.POINTER(ctypes.c_void_p),  # s1
            ctypes.POINTER(ctypes.c_longlong),  # n1
            ctypes.POINTER(ctypes.c_void_p),  # s2
            ctypes.POINTER(ctypes.c_longlong),  # n2
            ctypes.POINTER(ctypes.c_int),  # out_errno (read errors)
        ]
        self._read_two = rd
        self._read_free = lib.nw_read_free
        self._read_free.argtypes = [ctypes.c_void_p]

    # ---- all-optimal-alignments walker ----

    def enumerate(
        self,
        arrows: np.ndarray,
        s1: bytes,
        s2: bytes,
        emit: Optional[Callable[[bytes, bytes], None]],
        max_alignments: Optional[int] = None,
    ) -> int:
        arrows = np.ascontiguousarray(arrows, dtype=np.uint8)
        N, M = arrows.shape
        assert M == len(s1) + 1 and N == len(s2) + 1

        exc: list = []
        if emit is not None:

            def trampoline(xp, yp, n, _ctx):
                try:
                    emit(ctypes.string_at(xp, n), ctypes.string_at(yp, n))
                except BaseException as e:  # don't unwind through C
                    exc.append(e)

            cb = _EMIT_FN(trampoline)
        else:
            cb = _EMIT_FN()

        s1b = (ctypes.c_ubyte * max(1, len(s1))).from_buffer_copy(s1 or b"\0")
        s2b = (ctypes.c_ubyte * max(1, len(s2))).from_buffer_copy(s2 or b"\0")
        count = self._enumerate(
            arrows.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            M,
            N,
            s1b,
            s2b,
            cb,
            None,
            -1 if max_alignments is None else max_alignments,
        )
        if exc:
            raise exc[0]
        return int(count)

    # ---- batch op codes to aligned strings ----

    def ops_to_strings_batch(self, ops, ns, pairs, gap: int = ord("-")):
        """One-pass native version of traceback.ops_to_strings_batch."""
        ops = np.ascontiguousarray(ops, dtype=np.int8)
        ns = np.ascontiguousarray(ns, dtype=np.int32)
        B, S = ops.shape
        if B == 0:
            return []
        l1 = np.fromiter(
            (len(a) for a, _ in pairs), np.int64, count=B
        )
        l2 = np.fromiter(
            (len(b) for _, b in pairs), np.int64, count=B
        )
        off1 = np.zeros(B + 1, np.int64)
        np.cumsum(l1, out=off1[1:])
        off2 = np.zeros(B + 1, np.int64)
        np.cumsum(l2, out=off2[1:])
        out_off = np.zeros(B + 1, np.int64)
        np.cumsum(ns.astype(np.int64), out=out_off[1:])
        s1cat = np.frombuffer(
            b"".join(a for a, _ in pairs) or b"\0", np.uint8
        )
        s2cat = np.frombuffer(
            b"".join(b for _, b in pairs) or b"\0", np.uint8
        )
        out = np.empty(max(2 * int(out_off[-1]), 1), np.uint8)
        self._ops_to_strings(
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            B, S,
            ns.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            s1cat.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            off1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            s2cat.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            off2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            gap,
        )
        blob = out.tobytes()
        result = []
        for b in range(B):
            o = 2 * int(out_off[b])
            n = int(ns[b])
            result.append((blob[o : o + n], blob[o + n : o + 2 * n]))
        return result

    # ---- input reader ----

    def read_two_sequences(self, fd: int):
        """Native read-sequences.c equivalent over a file descriptor.

        Returns (s1, s2) bytes; raises EOFError on the reference's
        fatal early-EOF case (read-sequences.c:50-53).
        """
        s1 = ctypes.c_void_p()
        s2 = ctypes.c_void_p()
        n1 = ctypes.c_longlong()
        n2 = ctypes.c_longlong()
        err = ctypes.c_int()
        rc = self._read_two(
            fd, ctypes.byref(s1), ctypes.byref(n1),
            ctypes.byref(s2), ctypes.byref(n2), ctypes.byref(err),
        )
        if rc == 1:
            raise EOFError("got EOF too early when reading input strings")
        if rc == 3:
            # read(2) failed — the reference's "fgetc failed" case
            # (ferror checked before feof, read-sequences.c:46-55)
            import os as _os

            raise OSError(err.value, _os.strerror(err.value))
        if rc != 0:
            raise MemoryError("nw_read_two_sequences allocation failed")
        try:
            return (
                ctypes.string_at(s1, n1.value),
                ctypes.string_at(s2, n2.value),
            )
        finally:
            self._read_free(s1)
            self._read_free(s2)

    # ---- table renderer ----

    def render_table(
        self,
        scores: np.ndarray,
        arrows: np.ndarray,
        in_path: np.ndarray,
        s1: bytes,
        s2: bytes,
        unicode: bool = False,
        color: bool = False,
    ) -> bytes:
        scores = np.ascontiguousarray(scores, dtype=np.int32)
        arrows = np.ascontiguousarray(arrows, dtype=np.uint8)
        in_path = np.ascontiguousarray(in_path, dtype=np.uint8)
        N, M = scores.shape
        s1b = (ctypes.c_ubyte * max(1, len(s1))).from_buffer_copy(s1 or b"\0")
        s2b = (ctypes.c_ubyte * max(1, len(s2))).from_buffer_copy(s2 or b"\0")
        size = ctypes.c_int64()
        buf = self._render(
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            arrows.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            in_path.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            N,
            M,
            s1b,
            s2b,
            1 if unicode else 0,
            1 if color else 0,
            ctypes.byref(size),
        )
        if not buf:
            raise MemoryError("nw_render_table allocation failed")
        try:
            return ctypes.string_at(buf, size.value)
        finally:
            self._free(buf)


def load() -> Optional[NativeRuntime]:
    """Build (once) and load the native runtime; None when unavailable."""
    global _cached, _failed
    if _cached is not None or _failed:
        return _cached
    with _lock:
        if _cached is not None or _failed:
            return _cached
        if os.environ.get("NW_TPU_NO_NATIVE"):
            _failed = True
            return None
        try:
            so_path = _build_so()
            _cached = NativeRuntime(ctypes.CDLL(so_path))
        except Exception:
            _failed = True
    return _cached
