"""Build and bind the package's CUDA kernels.

``nw_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` (one process per
source, all started together) and linked into one shared library with a
plain C interface, loaded with ctypes: every pointer and the stream go
as ``c_void_p``, sizes as ``c_int``.  The library is built on first use
into ``nw_tpu_torch/_build/``, under a name keyed by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.

Each C entry point enqueues its kernel on the stream it is given and
returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0
(a refused launch never runs and is otherwise silent).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

P = ctypes.c_void_p
I = ctypes.c_int
# argument types of each C entry point (csrc/*.cu), stream last
SIGNATURES = {
    "nw_scores": [P, P, P, P, I, I, I, I, I, I, I, P, P, P, P],
    "nw_fill_codes": [P, P, P, P, I, I, I, I, I, I, I, I, I, P, P, P, P, P, P, P],
    "nw_walk": [P, P, P, I, I, I, I, P, P, P],
    "nw_score_count": [P, P, I, I, I, I, I, I, I, P, P, P, P, P, P],
    "nw_fill_masks": [P, P, I, I, I, I, I, I, I, P, P, P, P, I, P, P, P, P],
    "nw_fill_masks_batch": [P, P, P, P, I, I, I, I, I, I, I, P, P, P, P, P, P],
    "nw_count_masks": [P, P, P, I, I, I, I, P, P, P],
    "nw_walk_masks": [P, P, P, I, I, I, I, P, P, P],
    "nw_fill_runs_batch": [P, P, P, P, I, I, I, I, I, I, I, P, P, P, P, P, P],
    "nw_walk_runs": [P, P, P, I, I, I, I, P, P, P],
    "nw_last_row": [P, P, I, I, I, I, I, I, I, P, P, P, P, P, P],
    "nw_fill_codes_single": [P, P, I, I, I, P, I, I, I, I, I, P, P, P, P, P, P],
    "nw_refill_blocks": [P, P, I, I, I, I, P, I, I, I, I, I, P, P, P, P, P],
    "nw_score_single": [P, P, I, I, I, I, I, I, I, P, P, P, P, I, P, P],
    "nw_walk_window": [P, I, I, I, P, I, P, I, P],
    "nw_fill_tile": [P, P, I, I, I, I, P, P, I, I, I, I, I, P, P, P, P, P, P, P, P, P],
    "sw_scores": [P, P, P, P, I, I, I, I, I, I, I, P, P, P, P],
    "sw_fill_codes": [P, P, P, P, I, I, I, I, I, I, P, P, P, P, P, P],
    "sw_walk": [P, P, P, I, I, I, I, P, P, P, P, P],
    "overlap_scores": [P, P, P, P, I, I, I, I, I, I, I, P, P, P, P],
    "overlap_fill_codes": [P, P, P, P, I, I, I, I, I, I, P, P, P, P, P, P],
    "gotoh_scores": [P, P, P, P, I, I, I, I, I, I, I, I, P, P, P, P],
    "gotoh_fill_codes": [P, P, P, P, I, I, I, I, I, I, I, I, P, P, P, P, P, P],
    "gotoh_walk": [P, P, P, P, I, I, I, I, P, P, P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libnw_tpu_torch-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this version is already built."""
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmpdir:
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
            objs.append(obj)
        failed = []
        for cmd, proc in procs:  # wait for every compile before raising
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(tmpdir, so.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent build sees old or new
    return so


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nw_error_string.argtypes = [ctypes.c_int]
    lib.nw_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream and
    raise if the launch was refused."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err:
        msg = lib.nw_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
