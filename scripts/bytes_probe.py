"""Where the byte fills' time goes: copies of ``nw_tpu_torch/csrc/nw_fill.cu``
built apart from the package, each with one change to the flush of the
byte ring (all compiles started together), timed on the same inputs.

    python3 scripts/bytes_probe.py

Variants (text substitutions on the source's ring and flush):
``kernel`` the source as it is (each row's next aligned 32-byte piece,
4 rows a word store); ``no stores`` the flush reads the ring but stores
no piece that lies inside the true table (a store under a test no word
passes; the few pieces at the table's edges stay), so the sweep and the
ring stay; ``unaligned`` the first design: column
c in slot c % 64, and columns t0-31 .. t0 of every row a byte a lane,
each row's 32 bytes across two 32-byte sectors wherever they are not
aligned (every row but one in 32 at a pitch of 32 k + 1 bytes, every
row at 32 k).
Shapes: ``nw_fill_masks_batch`` (2 1 1, no counts, the rule's W) on 128
random pairs of 2 048 / 2 047 bp and 10 240 / 10 239 bp (row pitches
2 049 / 2 048 and 10 241 / 10 240 bytes), and ``nw_fill_runs_batch`` with
counts at 128 x 10 240 bp.  A line a variant: mean device ms by CUDA
events after a warm-up.  Prints the card's name and power limit first.
Needs the card and nvcc.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
OUT = HERE / "build" / "bytes_probe"
sys.path.insert(0, str(HERE))

INNER = ("        if (inner) {\n"
         "          *reinterpret_cast<unsigned*>(p + c) = v;\n")
RING = "            bring[s] = byte;\n"
LAST = "    if constexpr (BYTES) flush(nchunks << 5);  // the pieces that reach column A\n"
# the first design: column c in slot c % 64, and after each chunk columns
# t0-31 .. t0 of every row, a byte a lane, each row's 32 bytes across two
# 32-byte sectors wherever its column t0-31 is not 32-aligned
UNALIGNED_FLUSH = """    [[maybe_unused]] auto flush = [&](int t0) {
      const int col = t0 - 31 + lane;
      if (col >= 0 && col <= A) {
        const unsigned char* src = mring + (col & (kRingCols - 1));
        unsigned char* dst = prow + col;
        if (true_rows >= 32 && col <= l1) {
#pragma unroll 8
          for (int r = 0; r < 32; ++r) {
            *dst = src[r * kRingRow];
            dst += M;
          }
        } else {
          const int nr = min(32, band_rows);
          for (int r = 0; r < nr; ++r) {
            const unsigned char x = src[r * kRingRow];
            dst[static_cast<int64_t>(r) * M] = col <= l1 && r < true_rows ? x : 0;
          }
        }
      }
      __syncwarp();
    };
"""
VARIANTS = {
    "kernel": [],
    "no stores": [(INNER, "        if (inner) {\n"
                          "          if (v == 0xffffffffu) *reinterpret_cast<unsigned*>(p + c) = v;\n")],
    "unaligned": [("FLUSH", UNALIGNED_FLUSH),
                  (RING, "            mring[lane * kRingRow + ((t0 + s - lane) & (kRingCols - 1))] = byte;\n"),
                  (LAST, "")],
}


def flush_block(text):
    """The source's flush lambda, whole."""
    start = text.index("    [[maybe_unused]] auto flush = [&](int t0) {\n")
    return text[start : text.index("\n    };\n", start) + len("\n    };\n")]


def build(kernels):
    """One shared library a variant, all nvcc processes at once."""
    src = (kernels.CSRC / "nw_fill.cu").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            old = flush_block(text) if old == "FLUSH" else old
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        d = OUT / str(i)
        d.mkdir(parents=True)
        (d / "nw_fill.cu").write_text(text)
        shutil.copy(kernels.CSRC / "nw_common.cuh", d)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / "nw_fill.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for entry in ("nw_fill_masks_batch", "nw_fill_runs_batch"):
            getattr(lib, entry).argtypes = kernels.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.runtime import kernels

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build(kernels)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = __import__("numpy").random.default_rng(210)
    shapes = []
    for entry, L, wc, reps in (("nw_fill_masks_batch", 2048, False, 5), ("nw_fill_masks_batch", 2047, False, 5),
                               ("nw_fill_masks_batch", 10240, False, 1), ("nw_fill_masks_batch", 10239, False, 1),
                               ("nw_fill_runs_batch", 10240, True, 1)):
        T = enc.upload(enc.encode_batch(cs.rand_pairs(rng, 128, L, L), L, L), dev)
        shapes.append((f"{entry} {'+counts ' if wc else ''}128x{L}bp", entry, T, wc, reps))
    for name, lib in libs.items():
        out = {}
        for label, entry, T, wc, reps in shapes:
            B, A, Bs = T[0].shape[0], T[0].shape[1], T[1].shape[1]
            cell = 8 if wc else 4
            W = fb.fill_warps(B, A, Bs, cell, sms, ring=fb.BYTE_RING)
            table = torch.empty((B, Bs + 1, A + 1), dtype=torch.uint8, device=dev)
            scores = torch.empty(B, dtype=torch.int32, device=dev)
            counts = torch.empty(B, dtype=torch.int32, device=dev)
            bnd = torch.empty((B, A + 1), dtype=torch.int32, device=dev)
            cbnd = torch.empty((B, A + 1), dtype=torch.int32, device=dev)

            def run():
                err = getattr(lib, entry)(*(t.data_ptr() for t in T), B, A, Bs, 2, 1, 1, int(wc), W, None,
                                          bnd.data_ptr(), cbnd.data_ptr(), table.data_ptr(), scores.data_ptr(),
                                          counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} {label}: launch failed ({err})")

            out[f"{label} W={W}"] = round(cs.cuda_ms(run, reps), 4)
            del table
            torch.cuda.empty_cache()
        print(json.dumps({"variant": name, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
