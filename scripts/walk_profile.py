"""Where a staged walk's cycles go, and how its staging's constants move
its time: copies of ``nw_tpu_torch/csrc/nw_walk.cu`` built apart from the
package, one a staging, with ``-D`` (all compiles started together).

    python3 scripts/walk_profile.py [--sweep] [--masks | --runs | --sw | --gotoh]

The code walk (``walk_staged``): K = ``NW_WALK_SEG_COLS`` word columns a
segment, D = ``NW_WALK_DEPTH`` bands copied ahead, ``NW_WALK_WARPS`` walks
a block; its ``nw_walk`` runs on ``chip_smoke.py``'s 100 000 bp pair, one
walk, and on config 3's 256 x 10 240 bp pairs (the package's library fills
the codes).  With ``--masks`` the masks walk (``walk_masks_staged``)
instead: w = ``NW_WALK_MASK_COLS`` columns a row piece, D =
``NW_WALK_MASK_DEPTH``, ``NW_WALK_MASK_WARPS`` walks a block, E =
``NW_WALK_MASK_TABLE`` columns of the delta table; its
``nw_walk_masks`` runs on ``chip_smoke.py`` phase 13's 128 x 2 048 bp and
4 x 10 240 bp tie masks (from ``fill_arrows_auto``).  With ``--runs``
the run-skip walk (``walk_masks_staged`` in its runs mode): w =
``NW_WALK_RUNS_COLS``, D = ``NW_WALK_RUNS_DEPTH``, ``NW_WALK_RUNS_WARPS``
walks a block, E = ``NW_WALK_RUNS_TABLE`` columns of its table; its
``nw_walk_runs`` on the run bytes of config
3's two launches (``strings_sub_batch`` pairs each) and of 128 x 10 240
bp, where a line gives cycles a run (a load: the counters over
``walk_runs_loads``' loads) as well as a step.  With ``--sw`` the
local walk (``walk_staged`` in its local mode, the code walk's K and D,
``NW_WALK_LOCAL_WARPS`` walks a block, which its sweep varies): its
``sw_walk`` on the SW and the overlap codes of phases 9-10's 128 x
3 072 bp and 4 096 x 150 bp alignment batches
(``chip_smoke.variant_align_pairs``, 2 1 1).  With ``--gotoh`` Gotoh's
walk (``walk_staged`` in its Gotoh mode): K = ``NW_WALK_GOTOH_SEG_COLS``,
D = ``NW_WALK_GOTOH_DEPTH``, ``NW_WALK_GOTOH_WARPS`` walks a block, and
``NW_WALK_GOTOH_TABLE`` words (8 cells each) a delta-table row; its
``gotoh_walk`` on phase 11's batches (2 1 3 1).
Without ``--sweep``: an instrumented copy in ``build/walk_profile/``,
``clock64()`` counters around the walk's sections (waiting for a band's
copy, expanding the delta table (for the masks and run walks with their
re-copies),
issuing the next band's copy, walking the table, storing ops, the whole
walk; summed over a launch's walks by ``atomicAdd``), at the source's
staging and two others.  A line a run: its device ms (CUDA events) and
each section's cycles a step.  The counters cost a few cycles a section,
so the copy runs a little slower than the package's kernel.
``--sweep``: uninstrumented copies at the stagings of ``SWEEP`` (or
``MASK_SWEEP``), timed (mean device ms by CUDA events after a warm-up) on
the same walks and, for the code and masks walks, on the chained windows
of ``nw_walk_window``'s mode (the code walk: the 100 000 bp pair's 79
windows; the masks walk: ``chip_smoke.py`` phase 12's 20 000 bp relay, 4
blocks of tie masks); a
staging whose block passes 48 KB of shared memory does not compile and
prints as such.  Prints the card's name and power limit first.  Needs the
card and nvcc.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
OUT = HERE / "build" / "walk_profile"
SECTIONS = ("wait", "expand", "prefetch", "walk", "flush", "total")
# (K, D, warps): the profiled stagings, the source's first; the sweep's
PROFILED = [(16, 2, 2), (16, 1, 4), (8, 2, 4)]
SWEEP = [(4, 2, 2), (8, 1, 2), (8, 2, 2), (8, 3, 2), (16, 1, 2), (16, 2, 2), (16, 3, 2), (16, 4, 2),
         (32, 2, 2), (32, 3, 2), (16, 2, 1), (16, 2, 3), (16, 2, 4), (8, 2, 4), (8, 2, 6), (4, 1, 8)]
# (w, D, warps, E): the masks walk's, the source's first
MASK_PROFILED = [(128, 1, 2, 64), (128, 2, 2, 64), (64, 1, 2, 32)]
MASK_SWEEP = [(128, 1, 2, 64), (128, 2, 2, 64), (64, 1, 2, 32), (64, 2, 2, 32), (96, 1, 2, 64), (128, 3, 2, 64),
              (128, 1, 1, 64), (128, 1, 4, 64), (128, 1, 2, 32), (128, 1, 2, 96), (128, 1, 2, 128), (160, 1, 2, 64),
              (192, 1, 2, 64), (256, 1, 2, 64), (256, 1, 1, 128)]
# (K, D, warps, words): Gotoh's, the source's first
GOTOH_PROFILED = [(16, 1, 1, 6), (24, 2, 2, 7), (16, 1, 1, 4)]
GOTOH_SWEEP = [(16, 1, 1, 6), (24, 2, 2, 7), (24, 2, 2, 6), (24, 2, 2, 5), (24, 2, 1, 7), (24, 2, 1, 6),
               (24, 2, 1, 5), (24, 1, 1, 6), (32, 2, 1, 6), (24, 3, 1, 6), (16, 2, 2, 7), (8, 1, 4, 7),
               (24, 2, 2, 4), (16, 1, 4, 4), (48, 2, 1, 7), (16, 1, 1, 5), (16, 1, 2, 6), (8, 1, 1, 6)]
# (w, D, warps, E): the run walk's, the source's first
RUNS_PROFILED = [(128, 1, 2, 64), (128, 1, 2, 128), (96, 1, 2, 64)]
RUNS_SWEEP = [(128, 1, 2, 64), (64, 1, 2, 64), (96, 1, 2, 64), (160, 1, 2, 64), (192, 1, 2, 64), (256, 1, 1, 64),
              (128, 2, 2, 64), (128, 3, 1, 64), (128, 1, 1, 64), (128, 1, 3, 64), (96, 1, 4, 64), (128, 1, 2, 80),
              (128, 1, 2, 96), (128, 1, 2, 128), (160, 1, 2, 96), (192, 1, 2, 192)]
# walks a block of the local walk (its K and D are the code walk's)
LOCAL_PROFILED, LOCAL_SWEEP = [(1,), (2,)], [(1,), (2,), (3,), (4,), (6,)]
CODE_DEFS = ("NW_WALK_SEG_COLS", "NW_WALK_DEPTH", "NW_WALK_WARPS")
LOCAL_DEFS = ("NW_WALK_LOCAL_WARPS",)
MASK_DEFS = ("NW_WALK_MASK_COLS", "NW_WALK_MASK_DEPTH", "NW_WALK_MASK_WARPS", "NW_WALK_MASK_TABLE")
RUNS_DEFS = ("NW_WALK_RUNS_COLS", "NW_WALK_RUNS_DEPTH", "NW_WALK_RUNS_WARPS", "NW_WALK_RUNS_TABLE")
GOTOH_DEFS = ("NW_WALK_GOTOH_SEG_COLS", "NW_WALK_GOTOH_DEPTH", "NW_WALK_GOTOH_WARPS", "NW_WALK_GOTOH_TABLE")
# where the masks walk starts in nw_walk.cu: EDITS apply before it, MASK_EDITS after
MASK_PART = "// ---- the staged walk over row-major tie masks ----\n"

# (anchor in nw_walk.cu, text to put in its place): the counters
WALK_TABLE = "        const unsigned v = walk_table(p, n, flushed, S, buf, lane);\n"
# walk_masks_staged's walk: the run table's or the tie masks'
BYTE_WALK = ("        unsigned v;\n        if constexpr (kR)\n          v = walk_runs_table(p, n, S, lane, out);\n"
             "        else\n          v = walk_table(p, n, flushed, S, buf, lane);\n")
BAND_LOAD = "      if (band - D >= 0) ring.load(left, band - D, ((kG ? t : t - jj) + 31) >> kShift);\n"
EDITS = [
    ("namespace {\n", "__device__ unsigned long long g_prof[8];\nnamespace {\n"),
    ("  int flushed = n;  // out[flushed .. n) wait in buf\n",
     "  int flushed = n;  // out[flushed .. n) wait in buf\n"
     "  long long T0, tw = 0, te = 0, tl = 0, tk = 0, tf = 0, tt = clock64();\n"),
    ("      ring.wait(s);\n      for (bool fresh = true;;) {\n",
     "      T0 = clock64();\n      ring.wait(s);\n      tw += clock64() - T0;\n      for (bool fresh = true;;) {\n"),
    ("        if (fresh) {  // the table from t's column down, from the staged segment\n",
     "        if (fresh) {  // the table from t's column down, from the staged segment\n          T0 = clock64();\n"),
    ("          fresh = false;\n", "          fresh = false;\n          te += clock64() - T0;\n"),
    (WALK_TABLE, "        T0 = clock64();\n" + WALK_TABLE + "        tk += clock64() - T0;\n"),
    ("          flush_ops<walk_op<MODE>>(buf, flushed, n, lane, out);\n          flushed = n;\n",
     "          T0 = clock64();\n          flush_ops<walk_op<MODE>>(buf, flushed, n, lane, out);\n"
     "          tf += clock64() - T0;\n          flushed = n;\n"),
    (BAND_LOAD, "      T0 = clock64();\n" + BAND_LOAD + "      tl += clock64() - T0;\n"),
    ("    ring.drain();\n",
     "    ring.drain();\n    if (lane == 0) {\n"
     "      const long long c[8] = {tw, te, tl, tk, tf, clock64() - tt, n, 1};\n"
     "      for (int q = 0; q < 8; ++q) atomicAdd(&g_prof[q], static_cast<unsigned long long>(c[q]));\n"
     "    }\n"),
]
MASK_EDITS = [
    ("  int flushed = n;  // out[flushed .. n) wait in buf\n",
     "  int flushed = n;  // out[flushed .. n) wait in buf\n"
     "  long long T0, tw = 0, te = 0, tl = 0, tk = 0, tf = 0, tt = clock64();\n"),
    ("      slots.wait(s);\n      for (bool fresh = true;;) {\n",
     "      T0 = clock64();\n      slots.wait(s);\n      tw += clock64() - T0;\n      for (bool fresh = true;;) {\n"),
    ("        if (fresh) {  // the table from i's column down, from the band's slot\n",
     "        if (fresh) {  // the table from i's column down, from the band's slot\n          T0 = clock64();\n"),
    ("          fresh = false;\n", "          fresh = false;\n          te += clock64() - T0;\n"),
    (BYTE_WALK, "        T0 = clock64();\n" + BYTE_WALK + "        tk += clock64() - T0;\n"),
    ("            flush_ops<mask_delta_op>(buf, flushed, n, lane, out);\n            flushed = n;\n",
     "            T0 = clock64();\n            flush_ops<mask_delta_op>(buf, flushed, n, lane, out);\n"
     "            tf += clock64() - T0;\n            flushed = n;\n"),
    ("      if (band - (RING - 1) >= 0) slots.load(left, band - (RING - 1), i);\n",
     "      T0 = clock64();\n      if (band - (RING - 1) >= 0) slots.load(left, band - (RING - 1), i);\n"
     "      tl += clock64() - T0;\n"),
    ("    slots.drain();\n",
     "    slots.drain();\n    if (lane == 0) {\n"
     "      const long long c[8] = {tw, te, tl, tk, tf, clock64() - tt, n, 1};\n"
     "      for (int q = 0; q < 8; ++q) atomicAdd(&g_prof[q], static_cast<unsigned long long>(c[q]));\n"
     "    }\n"),
]
TAIL = r'''
extern "C" int prof_get(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));
}
extern "C" int prof_zero() {
  const unsigned long long z[8] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
}
'''


def instrumented_source() -> str:
    """nw_walk.cu with EDITS' counters in the code walk and MASK_EDITS' in
    the masks and run walks' template (each anchor once in its part)."""
    src = (HERE / "nw_tpu_torch" / "csrc" / "nw_walk.cu").read_text()
    if src.count(MASK_PART) != 1:
        raise SystemExit("walk_profile: the masks walk's section not found once in nw_walk.cu")
    head, tail = src.split(MASK_PART)
    parts = []
    for part, edits in ((head, EDITS), (tail, MASK_EDITS)):
        for anchor, text in edits:
            if part.count(anchor) != 1:
                raise SystemExit(f"walk_profile: anchor not found once in its part of nw_walk.cu: {anchor!r}")
            part = part.replace(anchor, text)
        parts.append(part)
    return MASK_PART.join(parts) + TAIL


def label(defs, staging) -> str:
    return " ".join(f"{d.removeprefix('NW_WALK_')}={v}" for d, v in zip(defs, staging))


def build(src: Path, defs, stagings) -> dict:
    """{staging: ctypes library, or None where it does not compile} of
    ``src`` built once a staging (``defs`` = its values), every nvcc
    started together."""
    from nw_tpu_torch.runtime import kernels

    procs = {}
    for st in stagings:
        so = OUT / f"lib{src.stem}-{'-'.join(map(str, st))}.so"
        flags = [f"-D{d}={v}" for d, v in zip(defs, st)]
        procs[st] = (so, subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-shared", "-o",
                                           str(so), str(src)], stderr=subprocess.PIPE, text=True))
    libs = {}
    for st, (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            print(f"{label(defs, st)}: does not compile: {err.strip().splitlines()[-1:]}")
            libs[st] = None
            continue
        lib = ctypes.CDLL(str(so))
        for name in ("nw_walk", "nw_walk_window", "nw_walk_masks", "nw_walk_runs", "sw_walk", "gotoh_walk"):
            getattr(lib, name).argtypes = kernels.SIGNATURES[name]
        libs[st] = lib
    return libs


def main(argv) -> int:
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from nw_tpu_torch import AlignConfig
    from nw_tpu_torch.ops import checkpoint_traceback as ckt
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_auto
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.ops import variants_banded as vb

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    sweep, masks = "--sweep" in argv, "--masks" in argv
    walk = ("masks" if masks else "runs" if "--runs" in argv else "sw" if "--sw" in argv
            else "gotoh" if "--gotoh" in argv else "codes")
    defs, stagings = {"masks": (MASK_DEFS, (MASK_PROFILED, MASK_SWEEP)),
                      "runs": (RUNS_DEFS, (RUNS_PROFILED, RUNS_SWEEP)),
                      "gotoh": (GOTOH_DEFS, (GOTOH_PROFILED, GOTOH_SWEEP)),
                      "sw": (LOCAL_DEFS, (LOCAL_PROFILED, LOCAL_SWEEP))}.get(walk, (CODE_DEFS, (PROFILED, SWEEP)))
    if sweep:
        libs = build(HERE / "nw_tpu_torch" / "csrc" / "nw_walk.cu", defs, stagings[1])
    else:
        src = OUT / "nw_walk_prof.cu"
        src.write_text(instrumented_source())
        libs = build(src, defs, stagings[0])
    stream = torch.cuda.current_stream().cuda_stream

    def check(err):
        if err:
            raise SystemExit(f"walk_profile: a launch failed ({err})")

    def walk_fn(lib, cd, l1, l2, S, st=None):
        """The walk's launch on ``cd``; its outputs stay allocated while the
        launch lives (the kernel writes them through raw pointers)."""
        B = cd.shape[0]
        out = (torch.full((B, S), tb.OP_NONE, dtype=torch.int8, device="cuda"),
               torch.empty(3, B, dtype=torch.int32, device="cuda"))
        ptrs = (out[0].data_ptr(), out[1][0].data_ptr())
        if walk == "sw":  # (codes, j*, i*, B, nbands, TW, S, ops, n, i_end, j_end): l1 is i*, l2 j*
            fn, args = lib.sw_walk, (cd.data_ptr(), l2.data_ptr(), l1.data_ptr(), B, cd.shape[1], cd.shape[2], S,
                                     *ptrs, out[1][1].data_ptr(), out[1][2].data_ptr())
        elif walk == "gotoh":
            fn, args = lib.gotoh_walk, (cd.data_ptr(), l1.data_ptr(), l2.data_ptr(), st.data_ptr(), B, cd.shape[1],
                                        cd.shape[2], S, *ptrs)
        elif walk in ("masks", "runs"):  # (table, lens1, lens2, B, A, Bs, S, ...)
            fn, args = (lib.nw_walk_masks if masks else lib.nw_walk_runs), (
                cd.data_ptr(), l1.data_ptr(), l2.data_ptr(), B, cd.shape[2] - 1, cd.shape[1] - 1, S, *ptrs)
        else:
            fn, args = lib.nw_walk, (cd.data_ptr(), l1.data_ptr(), l2.data_ptr(), B, cd.shape[1], cd.shape[2], S,
                                     *ptrs)
        return lambda out=out: check(fn(*args, stream))

    big = cs.rand_pairs(np.random.default_rng(cs.L_HUGE), 1, cs.L_HUGE, cs.L_HUGE)[0]
    # runs: (name, table, lens1 or i*, lens2 or j*, S, Gotoh's states)
    if walk in ("sw", "gotoh"):  # phases 9-11's alignment batches
        runs = []
        batches = cs.variant_align_pairs()
        for kind in (("sw", "overlap") if walk == "sw" else ("gotoh",)):
            for shape, ps in batches[kind].items():
                L = max(max(len(a), len(b)) for a, b in ps)
                T = enc.upload(enc.encode_batch(ps, L, L), "cuda")
                if kind == "gotoh":
                    codes, _, st = vb.affine_fill_codes_banded_batch(*T, 2, 1, 3, 1)
                    runs.append((f"{shape}", codes, T[2], T[3], 2 * L, st))
                else:
                    codes, _, js, is_ = getattr(vb, f"{kind}_fill_codes_banded_batch")(*T, 2, 1, 1)
                    runs.append((f"{kind} {shape}", codes, is_, js, tb._sw_max_steps(codes), None))
    elif walk == "runs":  # config 3's two launches and 128 x 10 240 bp of run bytes
        from nw_tpu_torch.models import needleman_wunsch as nwm

        c3, _ = cs.config_pairs()
        LB = cs.L_LONG
        T3 = enc.upload(enc.encode_batch(c3, LB, LB), "cuda")
        sub = nwm.strings_sub_batch(LB, LB, "runs")
        parts = [(f"config3 launch {q} ({min(sub, len(c3) - lo)}x{LB}bp)", tuple(t[lo : lo + sub] for t in T3))
                 for q, lo in enumerate(range(0, len(c3), sub))] + [(f"128x{LB}bp", tuple(t[:128] for t in T3))]
        runs = [(name, fb.fill_runs_banded_batch(*p, 2, 1, 1)[0], p[2], p[3], 2 * LB, None) for name, p in parts]
        run_loads = {name: int(tb.walk_runs_loads(r, l1, l2, S)[2].sum()) for name, r, l1, l2, S, _ in runs}
    elif masks:  # phase 13's 128 x 2 048 bp and 4 x 10 240 bp tie masks
        runs = []
        for _, nb, L, ps in cs.mask_path_batches()[1:]:
            T = enc.upload(enc.encode_batch(ps, L, L), "cuda")
            runs.append((f"{nb}x{L}bp", fill_auto.fill_arrows_auto(*T, 2, 1, 1)[0], T[2], T[3], 2 * L, None))
    else:
        top, side = (torch.from_numpy(enc.encode(x)).cuda() for x in big)
        codes, _ = fs.fill_codes_single(top, side, 2, 1, 1)
        lh = torch.tensor([cs.L_HUGE], dtype=torch.int32, device="cuda")
        c3, _ = cs.config_pairs()
        LB = AlignConfig().bucket_for(cs.L_LONG)
        T3 = enc.upload(enc.encode_batch(c3, LB, LB), "cuda")
        codes3 = fb.fill_greedy_counts_banded_batch(*T3, 2, 1, 1)[0]
        runs = [(f"1x{cs.L_HUGE}bp", codes, lh, lh, 2 * cs.L_HUGE, None),
                (f"256x{cs.L_LONG}bp", codes3, T3[2], T3[3], 2 * LB, None)]
    if sweep:
        if walk in ("sw", "gotoh", "runs"):
            for st, lib in libs.items():
                if lib is not None:
                    ms = {name: cs.cuda_ms(walk_fn(lib, *r), 3) for name, *r in runs}
                    print(f"{label(defs, st)}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)
            return 0
        if masks:
            tables, H = cs.relay_tables(big)
            chain_name = f"{len(tables)} windows at {cs.L_PALLAS}bp"
        else:
            C = ckt.auto_block_diagonals(cs.L_HUGE, cs.L_HUGE)
            _, ck = fs.score_fold(top, side, 2, 1, 1, checkpoint_every=C)
            group, _ = fs.fill_codes_blocks(top, side, 2, 1, 1, cs.L_HUGE, cs.L_HUGE, 0, C, ck)
            blocks = [(r * C, min(cs.L_HUGE, r * C + C)) for r in range(ck.shape[0])][::-1]
            chain = [(r0, group[:, r0 // 32 : -(-r1 // 32)]) for r0, r1 in blocks]
            chain_name = f"{len(chain)} windows at {cs.L_HUGE}bp"
        for st, lib in libs.items():
            if lib is None:
                continue
            ms = {name: cs.cuda_ms(walk_fn(lib, *r), 3) for name, *r in runs}

            def window(codes, state, r0, ops, lib=lib):
                rows, TW = (codes.shape[0], codes.shape[1]) if masks else (codes.shape[1], codes.shape[2])
                check(lib.nw_walk_window(codes.data_ptr(), rows, TW, r0, state.data_ptr(), ops.shape[0],
                                         ops.data_ptr(), int(masks), stream))

            ms[chain_name] = cs.cuda_ms(
                (lambda: cs.relay(window, tables, H)) if masks
                else (lambda: cs.walk_chain(window, chain, cs.L_HUGE, cs.L_HUGE)), 3)
            print(f"{label(defs, st)}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)
        return 0
    host = (ctypes.c_ulonglong * 8)()
    for st, lib in libs.items():
        if lib is None:
            continue
        lib.prof_get.argtypes = [ctypes.c_void_p]
        for name, *r in runs:
            fn = walk_fn(lib, *r)
            fn()  # warm-up
            lib.prof_zero()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            lib.prof_get(host)
            steps = host[6]
            cyc = {k: round(host[q] / steps, 1) for q, k in enumerate(SECTIONS)}
            per_run = ""
            if walk == "runs":
                loads = run_loads[name]
                per_run = f"; {loads} loads, cycles a run {({k: round(host[q] / loads, 1) for q, k in enumerate(SECTIONS)})}"
            print(f"{name} {label(defs, st)}: {e0.elapsed_time(e1):.3f} ms, {steps} steps in "
                  f"{host[7]} walks; cycles a step {cyc}{per_run}", flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main(sys.argv))
