"""Time the single-pair fills ``nw_score_count`` (K8) and
``nw_fill_codes_single`` (K14) through their public wrappers, and the
walls of the paths that run them, so that two trees can be compared on
one card in turns.

    python3 scripts/single_shapes.py [--check] [--sweep] [ROOT]

ROOT (default: this checkout) is the tree whose ``nw_tpu_torch`` is
imported and built; the inputs and the timing come from this checkout's
``chip_smoke.py`` (``rand_pairs``, its lengths and seeds).  Times, m k d
= 2 1 1: ``score_count_fold`` and ``fill_codes_single`` on random ACGT
pairs of 10 240, 20 000 and 100 000 bp (mean device ms by CUDA events
after a warm-up), then the walls of the CLI's ``-q -s`` (in-process, the
whole call: read, fill, print) and of ``align_huge`` on its codes route
at 100 000 bp (median of 3 warm runs after a cold one, host clock, each
ending in a host copy).  ``--check`` first holds ROOT's single-pair
pipeline against the plain versions under every scoring: every forced W
of ``WARPS`` and the rule's, blocks that wrap (2 x 3 warps over 22
bands), the edge pairs, K14's seeded mode, and a top past shared memory
against ``nw_fill_codes`` at B = 1.  ``--sweep`` ends with the time of
both kernels at each W of ``SWEEP`` (blocks by the rule) at each
length of ``SWEEP_BP``, and at 100 000 bp at the rule's W with the top
string staged in device memory instead of shared memory (the cost of
the placement where it does not fit).  Both options need a tree with
the single-pair pipeline.  To compare a change with its parent, unpack the parent into a
git-ignored directory (``git archive HEAD | tar -x -C build/parent``) and
run, in one call on the card: parent, change, change, parent.  Prints the
card's name and power limit, then one JSON line {shape: ms}.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
WARPS = (1, 2, 3, 4, 8, 16, 32, None)  # --check: None is the rule's
SWEEP = (4, 8, 12, 16, 20, 24, 32)  # --sweep: W
SWEEP_BP = (10_240, 20_000, 50_000, 100_000, 200_000)  # --sweep: the pairs' lengths


def check(cs, dev) -> dict:
    """Max |diff| of each kernel against its plain version (module doc)."""
    import numpy as np
    import torch

    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs

    rng = np.random.default_rng(14)
    pairs = (cs.rand_pairs(rng, 6, 0, 700) + cs.rand_pairs(rng, 3, 100, 400, b"AC") + cs.EDGE
             + [(b"A" * 24, b"A" * 16)] + cs.rand_pairs(rng, 1, 700, 701))
    shapes = [(None, w) for w in WARPS] + [(2, 3), (3, 1)]  # 2 x 3 and 3 x 1 wrap at 700 bp
    errs = {"nw_score_count": 0, "nw_fill_codes_single": 0, "seeded": 0}
    for mkd in cs.SCORINGS:
        for s1, s2 in pairs:
            top, side = (torch.from_numpy(enc.encode(x)) for x in (s1, s2))
            t, s = top.to(dev), side.to(dev)
            want_sc = fs.score_count_fold_plain(top, side, *mkd)
            want_codes, want_score = fs.fill_codes_single_plain(top, side, *mkd)
            for blocks, warps in shapes:
                got = fs.score_count_fold(t, s, *mkd, warps=warps, blocks=blocks)
                errs["nw_score_count"] = max([errs["nw_score_count"]]
                                             + [abs(g - w) for g, w in zip(got, want_sc)])
                codes, score = fs.fill_codes_single(t, s, *mkd, warps=warps, blocks=blocks)
                errs["nw_fill_codes_single"] = max(
                    errs["nw_fill_codes_single"], cs.max_abs_err(codes, want_codes),
                    abs(int(score) - int(want_score)))
            ck = fs.score_fold_plain(top, side, *mkd, checkpoint_every=64)[1]
            for r in range(1, ck.shape[0]):
                kw = {"len2": min(len(s2), 64 * r + 64), "r0": 64 * r}
                want = fs.fill_codes_single_plain(top, side, *mkd, seed=ck[r], **kw)
                for blocks, warps in shapes[::3]:
                    got = fs.fill_codes_single(t, s, *mkd, seed=ck[r].to(dev), warps=warps,
                                               blocks=blocks, **kw)
                    errs["seeded"] = max(errs["seeded"], cs.max_abs_err(got[0], want[0]),
                                         abs(int(got[1]) - int(want[1])))
        print(f"m k d = {mkd}: max |diff| {errs}", flush=True)
    # a top past shared memory, against nw_fill_codes at B = 1 (its top in
    # device memory too)
    A, Bs = 117_000, 200
    big = cs.rand_pairs(np.random.default_rng(A), 1, A, A)[0][0], cs.rand_pairs(rng, 1, Bs, Bs)[0][0]
    T = enc.upload(enc.encode_batch([big], A, Bs), dev)
    assert not fb.top_in_smem(A, 4) and not fb.top_in_smem(A, 8)
    for mkd in ((2, 1, 1), (1, 1, 2**30)):
        codes, score, count = fb.fill_greedy_counts_banded_batch(*T, *mkd, with_counts=True)
        for warps in (1, 3, 32, None):
            got = fs.score_count_fold(T[0][0], T[1][0], *mkd, warps=warps)
            errs["nw_score_count"] = max(errs["nw_score_count"], abs(got[0] - int(score[0])),
                                         abs(got[1] - int(count[0])))
            got = fs.fill_codes_single(T[0][0], T[1][0], *mkd, warps=warps)
            errs["nw_fill_codes_single"] = max(errs["nw_fill_codes_single"],
                                               cs.max_abs_err(got[0], codes), abs(int(got[1]) - int(score[0])))
    print(f"with a {A}-column top in device memory: max |diff| {errs}", flush=True)
    return errs


def main(argv) -> int:
    do_check, sweep = "--check" in argv, "--sweep" in argv
    args = [a for a in argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))  # root's nw_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_single as fs

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    if do_check and any(check(cs, dev).values()):
        print("FAIL: a single-pair kernel differs from its plain version", file=sys.stderr)
        return 1
    pairs = {L: cs.rand_pairs(np.random.default_rng(L), 1, L, L)[0]
             for L in (cs.L_LONG, cs.L_CROSS, cs.L_HUGE)}
    tensors = {L: tuple(torch.from_numpy(enc.encode(x)).to(dev) for x in p) for L, p in pairs.items()}
    out = {}
    for L, (t, s) in tensors.items():
        out[f"nw_score_count {L}x{L}bp"] = cs.cuda_ms(lambda: fs.score_count_fold(t, s, 2, 1, 1), 3)
        out[f"nw_fill_codes_single {L}x{L}bp"] = cs.cuda_ms(lambda: fs.fill_codes_single(t, s, 2, 1, 1), 3)
    big = pairs[cs.L_HUGE]
    aligner = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")
    walls = {"cli -q -s": [], "align_huge codes route": []}
    for _ in range(4):
        t0 = time.perf_counter()
        rc, _, err = cs.run_cli(["-q", "-s", "2", "1", "1"], big[0] + b" " + big[1])
        walls["cli -q -s"].append(time.perf_counter() - t0)
        if rc != 0:
            print(f"FAIL: the CLI exited {rc}: {err!r}", file=sys.stderr)
            return 1
        t0 = time.perf_counter()
        aligner.align_huge(*big)
        walls["align_huge codes route"].append(time.perf_counter() - t0)
    for name, ws in walls.items():
        out[f"{name} {cs.L_HUGE}bp wall, median of 3 warm"] = statistics.median(ws[1:]) * 1e3
        out[f"{name} {cs.L_HUGE}bp walls"] = [round(w * 1e3, 3) for w in ws]
    print(json.dumps({"root": str(root), "package": str(Path(fs.__file__).parent.parent), "ms": out}),
          flush=True)
    if sweep:
        from nw_tpu_torch.ops import fill_banded as fb

        kernels = (("nw_score_count", fs.score_count_fold), ("nw_fill_codes_single", fs.fill_codes_single))
        res = {}
        for L in SWEEP_BP:
            t, s = tensors.get(L) or tuple(
                torch.from_numpy(enc.encode(x)).to(dev) for x in cs.rand_pairs(np.random.default_rng(L), 1, L, L)[0])
            for w in SWEEP:
                for name, fn in kernels:
                    res[f"{name} {L}x{L}bp W={w}"] = cs.cuda_ms(lambda: fn(t, s, 2, 1, 1, warps=w), 2)
            print(json.dumps({"sweep_ms": res}), flush=True)
            res = {}
        t, s = tensors[cs.L_HUGE]
        staged = fb._top_scratch
        fb._top_scratch = lambda B, A, cell, device, warps=1: torch.empty(
            (B, fb.top_cols(A)), dtype=torch.int16, device=device)
        try:
            for name, fn in kernels:
                res[f"{name} {cs.L_HUGE}x{cs.L_HUGE}bp top in device memory"] = cs.cuda_ms(
                    lambda: fn(t, s, 2, 1, 1), 2)
        finally:
            fb._top_scratch = staged
        for name, fn in kernels:
            res[f"{name} {cs.L_HUGE}x{cs.L_HUGE}bp top staged"] = cs.cuda_ms(lambda: fn(t, s, 2, 1, 1), 2)
        print(json.dumps({"placement_ms": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
