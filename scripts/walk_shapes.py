"""Time the walks through their public wrappers at ``chip_smoke.py``'s
shapes, so that two trees can be compared on one card in turns:
``nw_walk`` (``walk_codes_batch``) on the 100 000 bp pair's codes (from
``fill_codes_single``), at config 3 (256 x 10 240 bp) and at 4 x 10 240
bp, ``nw_walk_window``'s codes mode (``walk_codes_window``) chained over
the 100 000 bp pair's 79 blocks (re-filled in one ``fill_codes_blocks``
launch, as ``traceback_checkpointed`` walks them); ``nw_walk_masks``
(``walk_masks_batch``) on phase 13's tie masks at 128 x 2 048 bp and 4 x
10 240 bp (from ``fill_arrows_auto``), ``nw_walk_window``'s masks mode
(``walk_masks_window``) relayed over phase 12's 20 000 bp pair in 4
blocks of K28 masks; and the walls of ``align_huge`` at 100 000 bp on
both routes, of config 3's ``align_batch`` (strings and counts), of phase
13 (b)'s ``fill_arrows_auto`` + count + walk + host strings at 128 x 2 048
bp and of ``align_batch``'s mask route at phase 13 (d)'s batches around
the route rule's crossing.  ``--variants`` times the local and Gotoh
walks instead: ``sw_walk`` (``walk_sw_codes_batch``) on the SW and the
overlap codes, ``gotoh_walk`` (``walk_gotoh_codes_batch``) on Gotoh's, at
phases 9-11's 128 x 3 072 bp and 4 096 x 150 bp alignment batches
(``chip_smoke.variant_align_pairs``), through their wrappers (``ms``) and
their C entries alone (``launch_ms``: no length check, so no host sync),
and the walls of ``sw_align_batch``, ``overlap_align_batch`` and
``affine_align_batch`` on those batches, each split into its fill and its
walk (``route_split_ms``, medians of 5 warm runs).  ``--runs`` times the
run-skip walk instead: ``nw_walk_runs`` (``walk_runs_batch``) on the runs
fill's bytes at config 3 (its two sub-batches of ``strings_sub_batch``
pairs, the runs engine's launches, and their sum) and at 128 x 10 240
bp, through its wrapper (``ms``) and its C entry alone (``launch_ms``),
each launch's loads (its longest walk's and the sum, from
``walk_runs_loads``) and steps, ns a run of the longest walk and its
span floor, and the config-3 wall (strings and counts) of the runs
engine and of the codes engine, each split into its fill and its walk
(``route_split_ms``, medians of 3 warm runs, the two engines in turns).

    python3 scripts/walk_shapes.py [--check] [--sass] [--masks | --variants | --runs] [ROOT]

ROOT (default: this checkout) is the tree whose ``nw_tpu_torch`` is
imported and built; the inputs (``chip_smoke.py``'s seeds) and the timing
come from this checkout's ``chip_smoke.py``.  To compare a change with its
parent, unpack the parent into a git-ignored directory (``git archive
HEAD | tar -x -C build/parent``) and run, in one call on the card: parent,
change, change, parent.  Prints the card's name and power limit, then
one JSON line: {shape: ms} of the kernels (mean device time by CUDA
events after a warm-up), each walk's steps (its longest walk; the
windows' sum) and ns a step, {shape: s} of the walls (median of 3 warm
runs, host to host) and, where ROOT has the ``nw_smem_chase`` probe, the
cycles of one dependent shared-memory load and each walk's span floor
(its steps times that load over ``clocks.max.sm``: the latency floor of a
walk that takes one dependent load a step); the mask route's split at
phase 13 (d)'s batches (``mask_route_split_ms``: its wall and the device
ms of its fill and of its walk, from CUDA events around each call) and
its walls against the codes route's at the rule's crossing, in turns
(``crossing_ms``).  ``--masks`` times only the masks walks and their
walls.
``--check`` first holds ROOT's walks against their plain versions at
``chip_smoke.py``'s walk edge shapes (phase 3's, phase 8's and the masks
walks' of phases 12 and 13; with ``--variants`` the variant walks' of
phases 9 and 11; with ``--runs`` the run walk's of phase 14).
``--sass`` runs ``scripts/sass_compare.py --diff`` on ``build/parent``'s
``nw_walk.cu`` against ROOT's, prints ``ptxas -v`` of both and writes
the staged kernels' SASS to ``build/walk_sass.txt``.
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
# phase 13 (d)'s batches around the mask route rule's crossing: (pairs, bp)
MASK_ROUTE_SHAPES = [(4, 10_240), (5, 10_240), (2, 4_096), (4, 4_096)]
# the rule's crossing at 10 240 bp: (pairs, bp) of the two routes in turns
CROSSING_SHAPES = [(6, 10_240), (7, 10_240)]
CROSSING_ROUNDS = 10  # rounds of mask, codes, codes, mask


def route_split(cs, a211, ps) -> dict:
    """The forced mask route on ``ps`` (strings and counts): its wall and
    the device ms of its fill (``fill_arrows_fold_batch``) and of its walk
    (``walk_masks_batch``), ``chip_smoke.route_split``'s medians of 3 warm
    runs."""
    from nw_tpu_torch.models import needleman_wunsch as nwm
    from nw_tpu_torch.ops import traceback as tb

    with cs.forced_route(True):
        return cs.route_split(lambda: a211.align_batch(ps, traceback_strings=True, count=True),
                              {"fill": (nwm, "fill_arrows_fold_batch"), "walk": (tb, "walk_masks_batch")})


def variant_walks(cs, dev) -> tuple:
    """({name: (walk, reps, launch)}, {name: (alignment, split targets)})
    of the local and Gotoh walks at phases 9-11's alignment batches (2 1
    1, Gotoh's 2 1 3 1): the walk through its wrapper, and its C entry
    alone on outputs allocated once (no wrapper: no length check, whose
    read-back of the lengths is a host sync)."""
    import torch

    from nw_tpu_torch.models import affine as af
    from nw_tpu_torch.models import overlap as ov
    from nw_tpu_torch.models import smith_waterman as sw
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.ops import variants_banded as vb
    from nw_tpu_torch.runtime import kernels

    def entry(name, *args, B, S):
        ops = torch.full((B, S), tb.OP_NONE, dtype=torch.int8, device=dev)
        outs = torch.empty((3, B), dtype=torch.int32, device=dev)
        ptrs = [ops.data_ptr(), outs[0].data_ptr()] + ([outs[1].data_ptr(), outs[2].data_ptr()] if name == "sw_walk"
                                                       else [])
        return lambda keep=(ops, outs): kernels.launch(name, dev, *args, *ptrs)  # keep: the outputs stay allocated

    walks, routes = {}, {}
    for kind, batches in cs.variant_align_pairs().items():
        for shape, ps in batches.items():
            L = max(max(len(a), len(b)) for a, b in ps)
            T = enc.upload(enc.encode_batch(ps, L, L), dev)
            reps = 5 if len(ps) == 128 else 10
            if kind == "gotoh":
                codes, _, st = vb.affine_fill_codes_banded_batch(*T, 2, 1, 3, 1)
                B, nbands, TW, _ = codes.shape
                walks[f"gotoh_walk {shape}"] = (
                    lambda c=codes, T=T, st=st, L=L: tb.walk_gotoh_codes_batch(c, T[2], T[3], st, 2 * L), reps,
                    entry("gotoh_walk", codes.data_ptr(), T[2].data_ptr(), T[3].data_ptr(), st.data_ptr(), B,
                          nbands, TW, 2 * L, B=B, S=2 * L))
                routes[f"affine_align_batch {shape}"] = (
                    lambda ps=ps: af.affine_align_batch(ps, 2, 1, 3, 1),
                    {"fill": (vb, "affine_fill_codes_banded_batch"), "walk": (vb, "walk_gotoh_codes_batch")})
                continue
            model = sw if kind == "sw" else ov
            fill_name = f"{kind}_fill_codes_banded_batch"
            codes, _, js, is_ = getattr(vb, fill_name)(*T, 2, 1, 1)
            B, nbands, TW, _ = codes.shape
            S = tb._sw_max_steps(codes)
            walks[f"sw_walk {kind} {shape}"] = (
                lambda c=codes, js=js, is_=is_: tb.walk_sw_codes_batch(c, js, is_), reps,
                entry("sw_walk", codes.data_ptr(), js.data_ptr(), is_.data_ptr(), B, nbands, TW, S, B=B, S=S))
            routes[f"{kind}_align_batch {shape}"] = (
                lambda ps=ps, f=getattr(model, f"{kind}_align_batch"): f(ps, 2, 1, 1),
                {"fill": (vb, fill_name), "walk": (vb, "walk_sw_codes_batch")})
    return walks, routes


def route_turns(cs, a211, ps) -> dict:
    """Walls (host ms) of ``align_batch`` on ``ps`` (strings and counts) on
    the mask and the codes route, ``CROSSING_ROUNDS`` rounds in turns; the
    first run of each route is a warm-up and left out."""
    runs = {True: [], False: []}
    for _ in range(CROSSING_ROUNDS):
        for masks_route in (True, False, False, True):
            with cs.forced_route(masks_route):
                t0 = time.perf_counter()
                a211.align_batch(ps, traceback_strings=True, count=True)
                runs[masks_route].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for flag, name in ((True, "masks"), (False, "codes")):
        out[name] = runs[flag][1:]
        out[name + "_median"] = statistics.median(runs[flag][1:])
    out["masks_won"] = sum(m < c for m, c in zip(runs[True][1:], runs[False][1:]))
    return out


def wall(fn) -> float:
    """Median of 3 warm host-to-host runs of ``fn()``."""
    runs = []
    for _ in range(4):  # a warm-up, then 3 timed
        t0 = time.perf_counter()
        fn()
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs[1:])


def sass_report(root: Path) -> None:
    """sass_compare.py parent vs ROOT, ptxas -v of both, the staged
    kernels' SASS into build/walk_sass.txt."""
    from nw_tpu_torch.runtime import kernels

    old = HERE / "build" / "parent" / "nw_tpu_torch" / "csrc" / "nw_walk.cu"
    new = root / "nw_tpu_torch" / "csrc" / "nw_walk.cu"
    subprocess.run([sys.executable, str(HERE / "scripts" / "sass_compare.py"), "--diff", str(old), str(new)])
    for src in (old, new):
        res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", "/dev/null",
                              str(src)], capture_output=True, text=True, cwd=src.parent)
        print(f"ptxas -v {src}:\n{res.stderr}")
    spec = importlib.util.spec_from_file_location("sass_compare", HERE / "scripts" / "sass_compare.py")
    sc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sc)
    import tempfile

    with tempfile.TemporaryDirectory() as tmpdir:
        code = sc.sass(new, tmpdir)
    out = HERE / "build" / "walk_sass.txt"
    out.parent.mkdir(exist_ok=True)
    with open(out, "w") as f:
        for name, ins in code.items():
            if "staged" in name or "chase" in name:
                f.write(f"Function : {name} ({len(ins)} instructions)\n")
                f.writelines(f"{q:5d}  {x}\n" for q, x in enumerate(ins))
    print(f"SASS of the staged walks and the chase: {out}")


def time_variants(cs, dev, root, clock_mhz, check) -> int:
    """``--variants``: the local and Gotoh walks' ms, steps, ns a step and
    span, and their alignments' walls split into fill and walk."""
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.runtime import kernels

    if check:
        errs = {}
        cs.local_walk_edges_vs_plain(dev, errs)
        cs.gotoh_walk_edges_vs_plain(dev, errs)
    cycles = cs.smem_load_cycles() if "nw_smem_chase" in kernels.SIGNATURES else None
    walks, routes = variant_walks(cs, dev)
    ms, launch_ms, steps = {}, {}, {}
    for name, (fn, reps, launch) in walks.items():
        ms[name] = cs.cuda_ms(fn, reps)
        launch_ms[name] = cs.cuda_ms(launch, reps)
        steps[name] = int(fn()[1].max())
    rec = {"root": str(root), "package": str(Path(tb.__file__).parent.parent), "ms": ms, "launch_ms": launch_ms,
           "steps": steps,
           "ns_per_step": {k: ms[k] * 1e6 / steps[k] for k in ms}, "smem_load_cycles": cycles,
           "span_ms": {k: steps[k] * cycles / (clock_mhz * 1e3) for k in ms} if cycles else None}
    del walks
    rec["route_split_ms"] = {name: cs.route_split(run, targets, reps=5) for name, (run, targets) in routes.items()}
    print(json.dumps(rec))
    return 0


def time_runs(cs, dev, root, clock_mhz, check) -> int:
    """``--runs``: the run-skip walk's ms, loads, steps, ns a run and span
    at config 3's launches and 128 x 10 240 bp, and both engines' config-3
    walls split into fill and walk."""
    import torch

    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.models import needleman_wunsch as nwm
    from nw_tpu_torch.ops import banded_traceback as bt
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.runtime import kernels

    if check:
        cs.runs_walk_edges_vs_plain(dev, {"nw_walk_runs": 0})
    cycles = cs.smem_load_cycles()
    c3, _ = cs.config_pairs()
    LB, S = cs.L_LONG, 2 * cs.L_LONG
    T3 = enc.upload(enc.encode_batch(c3, LB, LB), dev)
    sub = nwm.strings_sub_batch(LB, LB, "runs")
    shapes = {f"config3 launch {q} ({min(sub, len(c3) - lo)}x{LB}bp)": tuple(t[lo : lo + sub] for t in T3)
              for q, lo in enumerate(range(0, len(c3), sub))}
    shapes[f"128x{LB}bp"] = tuple(t[:128] for t in T3)
    ms, launch_ms, loads, loads_max, steps = {}, {}, {}, {}, {}
    for name, p in shapes.items():
        runs = fb.fill_runs_banded_batch(*p, 2, 1, 1)[0]
        B = runs.shape[0]
        ops = torch.full((B, S), tb.OP_NONE, dtype=torch.int8, device=dev)
        n = torch.empty(B, dtype=torch.int32, device=dev)
        ms[name] = cs.cuda_ms(lambda: tb.walk_runs_batch(runs, *p[2:], S), 5)
        launch_ms[name] = cs.cuda_ms(lambda: kernels.launch(
            "nw_walk_runs", dev, runs.data_ptr(), p[2].data_ptr(), p[3].data_ptr(), B, runs.shape[2] - 1,
            runs.shape[1] - 1, S, ops.data_ptr(), n.data_ptr()), 5)
        _, nn, ld = tb.walk_runs_loads(runs, *p[2:], S)
        loads[name], loads_max[name], steps[name] = int(ld.sum()), int(ld.max()), int(nn.max())
        del runs, ops, n
        torch.cuda.empty_cache()
    parts = [k for k in shapes if k.startswith("config3")]
    for d in (ms, launch_ms):
        d["config3 (both launches)"] = sum(d[k] for k in parts)
    rec = {"root": str(root), "package": str(Path(tb.__file__).parent.parent), "ms": ms, "launch_ms": launch_ms,
           "loads": loads, "loads_max": loads_max, "steps": steps, "smem_load_cycles": cycles,
           "ns_per_run": {k: launch_ms[k] * 1e6 / loads_max[k] for k in shapes},
           "span_ms": {k: loads_max[k] * cycles / (clock_mhz * 1e3) for k in shapes}}
    rec["span_ms"]["config3 (both launches)"] = sum(rec["span_ms"][k] for k in parts)
    del T3
    torch.cuda.empty_cache()
    a211 = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")
    targets = {"runs": {"fill": (bt, "fill_runs_banded_batch"), "walk": (bt, "walk_runs_batch")},
               "auto": {"fill": (bt, "fill_greedy_counts_banded_batch"), "walk": (bt, "walk_codes_batch")}}
    split = {"runs": [], "auto": []}
    for engine in ("runs", "auto", "auto", "runs"):
        with cs.walk_engine(engine):
            split[engine].append(cs.route_split(
                lambda: a211.align_batch(c3, traceback_strings=True, count=True).alignment_strings(),
                targets[engine]))
    rec["route_split_ms"] = {("runs" if e == "runs" else "codes") + " engine config3": v for e, v in split.items()}
    print(json.dumps(rec))
    return 0


def main(argv) -> int:
    flags = {a for a in argv[1:] if a.startswith("--")}
    args = [a for a in argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))  # root's nw_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.ops import checkpoint_traceback as ckt
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_auto
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops import pathcount as pc
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.runtime import kernels

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    dev = torch.device("cuda")
    kernels.load()
    if "--sass" in flags:
        sass_report(root)
    masks_only = "--masks" in flags
    if "--variants" in flags:
        return time_variants(cs, dev, root, clock_mhz, "--check" in flags)
    if "--runs" in flags:
        return time_runs(cs, dev, root, clock_mhz, "--check" in flags)
    if "--check" in flags:
        errs = {"nw_walk": 0, "nw_walk_masks": 0}
        if not masks_only:
            cs.walk_edges_vs_plain(dev, errs)
            cs.window_edges_vs_plain(dev, errs)
        cs.mask_walk_edges_vs_plain(dev, errs)
        cs.mask_window_edges_vs_plain(dev, errs)
        if any(errs.values()):
            print(f"FAIL: a walk differs from its plain version: {errs}", file=sys.stderr)
            return 1
    cycles = cs.smem_load_cycles() if "nw_smem_chase" in kernels.SIGNATURES else None

    big = cs.rand_pairs(np.random.default_rng(cs.L_HUGE), 1, cs.L_HUGE, cs.L_HUGE)[0]  # phase 8's pair
    walks = {}
    if not masks_only:
        top, side = (torch.from_numpy(enc.encode(x)).to(dev) for x in big)
        lh = torch.tensor([cs.L_HUGE], dtype=torch.int32, device=dev)
        codes, _ = fs.fill_codes_single(top, side, 2, 1, 1)
        c3, _ = cs.config_pairs()
        LB = AlignConfig().bucket_for(cs.L_LONG)
        T3 = enc.upload(enc.encode_batch(c3, LB, LB), dev)
        codes3 = fb.fill_greedy_counts_banded_batch(*T3, 2, 1, 1)[0]
        T4, codes4 = tuple(x[:4] for x in T3), codes3[:4]
        # the checkpointed route's 79 blocks, re-filled in one launch, walked last first
        C = ckt.auto_block_diagonals(cs.L_HUGE, cs.L_HUGE)
        _, ck = fs.score_fold(top, side, 2, 1, 1, checkpoint_every=C)
        group, _ = fs.fill_codes_blocks(top, side, 2, 1, 1, cs.L_HUGE, cs.L_HUGE, 0, C, ck)
        blocks = [(r * C, min(cs.L_HUGE, r * C + C)) for r in range(ck.shape[0])][::-1]
        chain = [(r0, group[:, r0 // 32 : -(-r1 // 32)]) for r0, r1 in blocks]
        walks.update({
            f"nw_walk 1x{cs.L_HUGE}bp": (lambda: tb.walk_codes_batch(codes, lh, lh, 2 * cs.L_HUGE), 3),
            f"nw_walk 256x{cs.L_LONG}bp": (lambda: tb.walk_codes_batch(codes3, *T3[2:], 2 * LB), 5),
            f"nw_walk 4x{cs.L_LONG}bp": (lambda: tb.walk_codes_batch(codes4, *T4[2:], 2 * LB), 5),
            f"nw_walk_window {len(chain)} windows at {cs.L_HUGE}bp": (
                lambda: cs.walk_chain(tb.walk_codes_window, chain, cs.L_HUGE, cs.L_HUGE), 3),
        })
    # phase 13's tie masks, phase 12's relay
    mask_inputs = []
    for _, nb, L, ps in cs.mask_path_batches()[1:]:
        T = enc.upload(enc.encode_batch(ps, L, L), dev)
        masks = fill_auto.fill_arrows_auto(*T, 2, 1, 1)[0]
        mask_inputs.append((ps, T, masks))
        walks[f"nw_walk_masks {nb}x{L}bp"] = (lambda m=masks, T=T, L=L: tb.walk_masks_batch(m, *T[2:], 2 * L), 5)
    tables, H = cs.relay_tables(big)
    walks[f"nw_walk_window/masks {len(tables)} windows at {cs.L_PALLAS}bp"] = (
        lambda: cs.relay(tb.walk_masks_window, tables, H), 3)
    ms, steps = {}, {}
    for name, (fn, reps) in walks.items():
        ms[name] = cs.cuda_ms(fn, reps)
        out = fn()
        steps[name] = int(out[0][2]) if "window" in name else int(out[1].max())
    rec = {"root": str(root), "package": str(Path(tb.__file__).parent.parent), "ms": ms, "steps": steps,
           "ns_per_step": {k: ms[k] * 1e6 / steps[k] for k in ms}, "smem_load_cycles": cycles,
           "span_ms": {k: steps[k] * cycles / (clock_mhz * 1e3) for k in ms} if cycles else None}
    walls = {}
    ps, T, _ = mask_inputs[0]

    def arrows_path():  # phase 13 (b): fill, count, walk, host strings
        masks, _, _ = fill_auto.fill_arrows_auto(*T, 2, 1, 1)
        pc.count_masks_batch(masks, *T[2:])
        ops, n = tb.walk_masks_batch(masks, *T[2:], 2 * cs.L_ARROWS)
        tb.ops_to_strings_batch(ops.cpu().numpy(), n.cpu().numpy(), ps)

    walls[f"fill_arrows_auto+count+walk+strings {len(ps)}x{cs.L_ARROWS}bp"] = wall(arrows_path)
    del walks, mask_inputs, tables
    if not masks_only:
        del codes, codes3, codes4, group, chain
    torch.cuda.empty_cache()
    a211 = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")
    split = {}
    with cs.forced_route(True):
        for nb, L in MASK_ROUTE_SHAPES:
            rp = cs.rand_pairs(np.random.default_rng(nb * L), nb, L, L)  # phase 13 (d)'s pairs
            walls[f"align_batch mask route {nb}x{L}bp strings+counts"] = wall(
                lambda: a211.align_batch(rp, traceback_strings=True, count=True))
            split[f"{nb}x{L}bp"] = route_split(cs, a211, rp)
    rec["mask_route_split_ms"] = split
    rec["crossing_ms"] = {f"{nb}x{L}bp": route_turns(cs, a211, cs.rand_pairs(np.random.default_rng(nb * L), nb, L, L))
                          for nb, L in CROSSING_SHAPES}
    if not masks_only:
        walls[f"align_huge {cs.L_HUGE}bp codes route"] = wall(lambda: a211.align_huge(*big))
        walls[f"align_huge {cs.L_HUGE}bp checkpointed (C = {C})"] = wall(
            lambda: a211.align_huge(*big, block_diagonals=C))
        walls[f"config3 align_batch 256x{cs.L_LONG}bp strings+counts"] = wall(
            lambda: a211.align_batch(c3, traceback_strings=True, count=True).alignment_strings())
    rec["walls_s"] = walls
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
