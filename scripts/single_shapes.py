"""Time the single-pair fills of ``csrc/nw_single.cu`` through their
public wrappers, and the walls of the paths that run them, so that two
trees can be compared on one card in turns.

    python3 scripts/single_shapes.py [--check] [--sweep] [--routes] [--kernels] [--tiles] [ROOT]

ROOT (default: this checkout) is the tree whose ``nw_tpu_torch`` is
imported and built; the inputs and the timing come from this checkout's
``chip_smoke.py`` (``rand_pairs``, its lengths and seeds).  Times, m k d
= 2 1 1, random ACGT pairs (mean device ms by CUDA events after a
warm-up): ``score_count_fold`` (K8), ``fill_codes_single`` (K14) and
``score_fold`` (K11) at 10 240, 20 000 and 100 000 bp, ``score_fold``
with checkpoint rows (K12) at 100 000 bp every 1 280 rows
(``align_huge``'s block there); ``last_row`` (K9) at the top-level
splits of Hirschberg's 10 240 and 20 000 bp pairs (10 240 x 5 120,
20 000 x 10 000) and at three of its small splits (2 560 x 1 280, 640 x
320, 256 x 128); ``fill_arrows_banded_single`` (``nw_fill_masks``, K2
for one pair) at 10 240 and 20 000 bp and ``fill_arrows_fold_batch``
(K10) at 4 x 10 240 bp.  Then the walls (host clock, each ending in a
host copy; median of 3 warm runs after a cold one): the CLI's ``-q -s``
at 100 000 bp and ``-l -s`` of a 10 240 bp pair with itself (in-process,
the whole call: read, fill, print), ``align_huge`` at 100 000 bp on its
codes route and checkpointed (``block_diagonals`` 1 280), and
``hirschberg_align`` at 100 000 bp (median of 2 warm runs after a cold
one) with its host leaves, host rows and card rows (``nw_last_row``)
timed apart.

``--kernels`` times the kernels alone, not the walls.  ``--tiles`` times
``fill_tile`` (``nw_fill_tile``) alone, in each mode at the sharded
path's tile shapes (``TILES``: rank 0's first tile at 2 ranks of the
100 000 bp pair, codes and scores, and at 4 ranks of its 20 000 bp
prefix, masks, with row 0 and column 0 as its edges) and the 1-rank
path's one tile (the whole pair, codes) beside ``fill_codes_single``
(mean of 3 after a warm-up, CUDA events).
``--check`` first holds ROOT's single-pair pipeline against the plain
versions under every scoring, on random, tie-dense and edge pairs: K8
and K14 (and K14's seeded mode) at every forced W of ``WARPS`` and the
rule's, blocks that wrap (2 x 3 warps over 22 bands); K11, K12 (C = 32
and 224), K9 (rows 0, len2 / 3 and len2), ``nw_fill_masks`` (with and
without the scores table) and K10 (rows of a wider bucket: ldm > A+1)
at every W of 1 .. 32, the rule's and wrapping blocks; the same modes on
sides one short of, on and one past 32 W and 32 G W rows and r C rows
(C = 32, 224, 1 280; r = 1, 2) at a few shapes; a top past shared
memory against the batched kernels at B = 1 (``nw_fill_codes``,
``nw_fill_masks_batch``, ``nw_scores``) and the modes against each
other.  ``--sweep`` ends with the time of K8 and K14 at each W of
``SWEEP`` (blocks by the rule) at each length of ``SWEEP_BP``, of K11
at each W of ``SWEEP``, of K9 and ``nw_fill_masks`` at each W of
``MASK_SWEEP`` (K9 also at its small splits) at their shapes, and at 100 000 bp at
the rule's W with the top string staged in device memory instead of
shared memory (the cost of the placement where it does not fit).
``--routes`` times the two route rules these kernels decide: the scores
of small batches through the K11 route (a pair at a time) against the K1
route (a block a pair), and ``align_batch``'s mask route against its
codes route at ``chip_smoke.py`` phase 13 (d)'s batches, in turns.  The
options need a tree whose single-pair modes all run the pipeline.  To
compare a change with its parent, unpack the parent into a git-ignored
directory (``git archive HEAD | tar -x -C build/parent``) and run, in one
call on the card: parent, change, change, parent.  Prints the card's name
and power limit, then one JSON line {shape: ms} (and one a sweep or
route table).
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
WARPS = (1, 2, 3, 4, 8, 16, 32, None)  # --check, K8 and K14: None is the rule's
SWEEP = (4, 8, 12, 16, 20, 24, 32)  # --sweep: W
MASK_SWEEP = (2, 3, 4, 6, 8, 12, 16)  # --sweep: W of nw_fill_masks and K9
SWEEP_BP = (10_240, 20_000, 50_000, 100_000, 200_000)  # --sweep: the pairs' lengths
C_HUGE = 1_280  # align_huge's block at 100 000 bp (checkpoint_traceback.auto_block_diagonals)
K9_SPLITS = ((10_240, 5_120), (20_000, 10_000), (2_560, 1_280), (640, 320), (256, 128))
# --check: sides at the cuts of 32 W (W = 2, 3) and 32 G W rows (G = 2, W
# = 3), and r C checkpoint rows (C = 32, 224, 1 280; r = 1, 2)
CUT_SIDES = sorted({63, 64, 65, 95, 96, 97, 191, 192, 193}
                   | {r * C + e for C in (32, 224, 1280) for r in (1, 2) for e in (-1, 0, 1)})
CUT_SHAPES = ((None, None), (None, 1), (None, 2), (None, 3), (2, 3), (None, 32))
# --tiles: (mode, ranks, bp, rows H, columns C) of the timed tiles, as
# tile_chunk cut the path's first tiles when they were taken
TILES = (("codes", 2, 100_000, 50_000, 100_000), ("scores", 2, 100_000, 50_000, 100_000),
         ("masks", 4, 20_000, 5_000, 10_016), ("codes", 1, 100_000, 100_000, 100_000))
# --routes: (pairs, bp) of the K11 route against the K1 route
SCORE_ROUTES = [(nb, 10_240) for nb in (2, 4, 6, 8, 23)] + [(nb, 4_096) for nb in (1, 2, 4)] + [(2, 100_000)]


def check(cs, dev) -> dict:
    """Max |diff| of K8 and K14 against their plain versions (module doc)."""
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


MODES = ("nw_score_single", "nw_score_single/ckpt", "nw_last_row", "nw_fill_masks", "nw_fill_masks/fold")


def check_modes_on(cs, dev, pairs, shapes, mkd, errs, cuts=(32, 224)) -> None:
    """K11, K12 (every C of ``cuts``), K9 (rows 0, len2 / 3, len2),
    ``nw_fill_masks`` (with and without scores) and K10 (into a bucket
    7 columns wider than the widest pair) on ``pairs`` at every (blocks,
    warps) of ``shapes``, against the plain versions' body (the
    anti-diagonal fill with scores and counts, every pair at once), max
    |diff| into ``errs``."""
    import torch

    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops.fill_scan import diag_to_matrix, fill_diag_batch

    A, B = max(len(a) for a, _ in pairs) + 7, max(len(b) for _, b in pairs)
    T = enc.upload(enc.encode_batch(pairs, A, B), dev)
    ref = fill_diag_batch(*T, *mkd, with_counts=True, with_scores=True)
    want_fold = torch.zeros((len(pairs), B + 1, A + 1), dtype=torch.uint8, device=dev)
    for b, (s1, s2) in enumerate(pairs):
        la, lb = len(s1), len(s2)
        t, s = T[0][b, :la], T[1][b, :lb]
        masks = diag_to_matrix(ref["arrows"][b], la, lb)
        hs = diag_to_matrix(ref["scores"][b], la, lb)
        want_fold[b, : lb + 1, : la + 1] = masks
        score, count = int(ref["score"][b]), int(ref["count"][b])
        for blocks, warps in shapes:
            kw = {"warps": warps, "blocks": blocks}
            sc, ck = fs.score_fold(t, s, *mkd, **kw)
            errs["nw_score_single"] = max(errs["nw_score_single"], abs(int(sc) - score), int(ck is not None))
            for C in cuts:
                sc, ck = fs.score_fold(t, s, *mkd, checkpoint_every=C, **kw)
                errs["nw_score_single/ckpt"] = max(errs["nw_score_single/ckpt"], abs(int(sc) - score),
                                                   cs.max_abs_err(ck, hs[0:lb:C]))
            for j in sorted({0, lb // 3, lb}):
                row = fs.last_row(t, s, *mkd, len2=j, **kw)
                errs["nw_last_row"] = max(errs["nw_last_row"], cs.max_abs_err(row, hs[j]))
            for ws in (False, True):
                got = fb.fill_arrows_banded_single(t, s, *mkd, with_scores=ws, **kw)
                errs["nw_fill_masks"] = max([errs["nw_fill_masks"], cs.max_abs_err(got[0], masks),
                                             abs(got[2] - score), abs(got[3] - count)]
                                            + ([cs.max_abs_err(got[1], hs)] if ws else []))
    for blocks, warps in shapes:
        got = fs.fill_arrows_fold_batch(*T, *mkd, warps=warps, blocks=blocks)
        errs["nw_fill_masks/fold"] = max(
            errs["nw_fill_masks/fold"], cs.max_abs_err(got[0], want_fold),
            cs.max_abs_err(got[1], ref["score"]), cs.max_abs_err(got[2], ref["count"]))


def check_modes(cs, dev) -> dict:
    """Max |diff| of K11, K12, K9, ``nw_fill_masks`` and K10 against their
    plain versions (module doc)."""
    import numpy as np
    import torch

    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs

    rng = np.random.default_rng(15)
    pairs = (cs.rand_pairs(rng, 6, 0, 700) + cs.rand_pairs(rng, 3, 100, 400, b"AC") + cs.EDGE
             + [(b"A" * 24, b"A" * 16)] + cs.rand_pairs(rng, 1, 700, 701))
    shapes = [(None, w) for w in range(1, 33)] + [(None, None), (2, 3), (3, 1)]
    letters = np.frombuffer(b"ACGT", np.uint8)
    top75 = letters[rng.integers(0, 4, 75)].tobytes()
    cut_pairs = [(top75, letters[rng.integers(0, 4, n)].tobytes()) for n in CUT_SIDES]
    errs = dict.fromkeys(MODES, 0)
    for mkd in cs.SCORINGS:
        check_modes_on(cs, dev, pairs, shapes, mkd, errs)
        check_modes_on(cs, dev, cut_pairs, CUT_SHAPES, mkd, errs, cuts=(32, 224, 1280))
        # the plain versions themselves, on short pairs
        for s1, s2 in cs.EDGE + [(b"A" * 24, b"A" * 16), (b"ACCATTG" * 9, b"CATAG" * 14)]:
            t, s = (torch.from_numpy(enc.encode(x)).to(dev) for x in (s1, s2))
            errs["nw_score_single"] = max(errs["nw_score_single"], cs.max_abs_err(
                fs.score_fold(t, s, *mkd)[0], fs.score_fold_plain(t, s, *mkd)[0]))
            got, want = fs.score_fold(t, s, *mkd, checkpoint_every=32), fs.score_fold_plain(t, s, *mkd, checkpoint_every=32)
            errs["nw_score_single/ckpt"] = max(errs["nw_score_single/ckpt"], cs.max_abs_err(got[0], want[0]),
                                               cs.max_abs_err(got[1], want[1]))
            errs["nw_last_row"] = max(errs["nw_last_row"], cs.max_abs_err(
                fs.last_row(t, s, *mkd), fs.last_row_plain(t, s, *mkd)))
            got = fb.fill_arrows_banded_single(t, s, *mkd, with_scores=True)
            want = fb.fill_arrows_banded_single_plain(t, s, *mkd, with_scores=True)
            errs["nw_fill_masks"] = max([errs["nw_fill_masks"], cs.max_abs_err(got[0], want[0]),
                                         cs.max_abs_err(got[1], want[1])] + [abs(g - w) for g, w in zip(got[2:], want[2:])])
        T = enc.upload(enc.encode_batch(cs.EDGE + [(b"ACCATTG" * 9, b"CATAG" * 14)], 70, 75), dev)
        for g, w in zip(fs.fill_arrows_fold_batch(*T, *mkd), fs.fill_arrows_fold_batch_plain(*T, *mkd)):
            errs["nw_fill_masks/fold"] = max(errs["nw_fill_masks/fold"], cs.max_abs_err(g, w))
        print(f"m k d = {mkd}: max |diff| {errs}", flush=True)
    # a top past shared memory at every W (7 bands): the modes against the
    # batched kernels at B = 1 and against each other
    A, Bs = 117_000, 200
    big = cs.rand_pairs(np.random.default_rng(A), 1, A, A)[0][0], cs.rand_pairs(rng, 1, Bs, Bs)[0][0]
    T = enc.upload(enc.encode_batch([big], A, Bs), dev)
    t, s = T[0][0], T[1][0]
    assert not fb.top_in_smem(A, 4) and not fb.top_in_smem(A, 8)
    for mkd in ((2, 1, 1), (1, 1, 2**30)):
        masks, score, count = fb.fill_masks_banded_batch(*T, *mkd, with_counts=True)
        score = int(score[0])
        for warps in (1, 3, 32, None):
            got = fb.fill_arrows_banded_single(t, s, *mkd, with_scores=True, warps=warps)
            hs = got[1]
            errs["nw_fill_masks"] = max(errs["nw_fill_masks"], cs.max_abs_err(got[0], masks[0]),
                                        abs(got[2] - score), abs(got[3] - int(count[0])))
            sc, ck = fs.score_fold(t, s, *mkd, checkpoint_every=32, warps=warps)
            errs["nw_score_single/ckpt"] = max(errs["nw_score_single/ckpt"], abs(int(sc) - score),
                                               cs.max_abs_err(ck, hs[0:Bs:32]))
            errs["nw_score_single"] = max(errs["nw_score_single"],
                                          abs(int(fs.score_fold(t, s, *mkd, warps=warps)[0]) - score))
            for j in (0, 64, 131, Bs):
                errs["nw_last_row"] = max(errs["nw_last_row"],
                                          cs.max_abs_err(fs.last_row(t, s, *mkd, len2=j, warps=warps), hs[j]))
        errs["nw_score_single"] = max(errs["nw_score_single"], abs(
            int(fb.fill_scores_banded_batch(*T, *mkd)[0]) - score))
    print(f"with a {A}-column top in device memory: max |diff| {errs}", flush=True)
    return errs


def wall(fn, runs=4):
    """(median of the warm runs, every run) in ms: host clock around
    ``fn``, which ends in a host copy."""
    ws = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ws.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ws[1:]), [round(w, 3) for w in ws]


def hirschberg_walls(big, runs=3):
    """``hirschberg_align`` of ``big`` at 2 1 1: (median wall of the warm
    runs in ms, every run's (wall, host leaves, host rows, card rows) in
    s)."""
    from nw_tpu_torch.ops import hirschberg as hb

    names = ("_small_align", "_host_last_row", "_device_last_row")
    saved = {n: getattr(hb, n) for n in names}
    timers = dict.fromkeys(names, 0.0)

    def timed(name):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return saved[name](*a, **kw)
            finally:
                timers[name] += time.perf_counter() - t0
        return run

    for n in names:
        setattr(hb, n, timed(n))
    out = []
    try:
        for _ in range(runs):
            for n in names:
                timers[n] = 0.0
            t0 = time.perf_counter()
            hb.hirschberg_align(*big, 2, 1, 1, device="cuda")
            out.append([round(time.perf_counter() - t0, 4)] + [round(timers[n], 4) for n in names])
    finally:
        for n, fn in saved.items():
            setattr(hb, n, fn)
    return statistics.median(w[0] for w in out[1:]) * 1e3, out


def routes(cs, dev, card) -> dict:
    """The K11 route against the K1 route, and align_batch's mask route
    against its codes route, in turns (module doc)."""
    import numpy as np
    import torch

    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_auto
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs

    out = {}
    for nb, L in SCORE_ROUTES:
        ps = cs.rand_pairs(np.random.default_rng(L + nb), nb, L, L)
        T = enc.upload(enc.encode_batch(ps, L, L), dev)
        reps = 0 if L > 20_000 else 2
        times = {}
        for name in ("K1", "K11", "K11", "K1"):
            fn = ((lambda: fb.fill_scores_banded_batch(*T, 2, 1, 1)) if name == "K1" else
                  (lambda: torch.stack([fs.score_fold(T[0][b], T[1][b], 2, 1, 1, L, L)[0] for b in range(nb)])))
            times.setdefault(name, []).append(cs.cuda_ms(fn, reps))
        rule = "K11" if fill_auto.takes_single_pair_route(nb, L, L) else "K1"
        out[f"scores {nb}x{L}bp"] = {**times, "rule": rule}
        print(f"scores of {nb} x {L} bp in turns: K1 route {times['K1']} ms, K11 route {times['K11']} ms; "
              f"the rule takes {rule} [{card}]", flush=True)
    a211 = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")
    for nb, L in cs.ROUTE_SHAPES:
        ps = cs.rand_pairs(np.random.default_rng(nb * L), nb, L, L)
        runs = {}
        for masks_route in (True, False, False, True, True, False, False, True):
            with cs.forced_route(masks_route):
                t0 = time.perf_counter()
                a211.align_batch(ps, traceback_strings=True, count=True)
                runs.setdefault(masks_route, []).append((time.perf_counter() - t0) * 1e3)
        med = {flag: statistics.median(ws[1:]) for flag, ws in runs.items()}
        rule = "masks" if fill_auto.takes_mask_route(nb, L, L) else "codes"
        out[f"align_batch {nb}x{L}bp"] = {"masks": med[True], "codes": med[False], "rule": rule}
        print(f"align_batch {nb}x{L}bp strings+counts: mask route {med[True]:.2f} ms, codes route "
              f"{med[False]:.2f} ms (median of 3 warm in turns); the rule takes {rule} [{card}]", flush=True)
    return out


def times(cs, dev, walls=True) -> dict:
    """The kernels' device ms and (``walls``) the walls (module doc)."""
    import numpy as np
    import torch

    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs

    pairs = {L: cs.rand_pairs(np.random.default_rng(L), 1, L, L)[0]
             for L in (cs.L_LONG, cs.L_CROSS, cs.L_HUGE)}
    tensors = {L: tuple(torch.from_numpy(enc.encode(x)).to(dev) for x in p) for L, p in pairs.items()}
    out = {}
    for L, (t, s) in tensors.items():
        out[f"nw_score_count {L}x{L}bp"] = cs.cuda_ms(lambda: fs.score_count_fold(t, s, 2, 1, 1), 3)
        out[f"nw_fill_codes_single {L}x{L}bp"] = cs.cuda_ms(lambda: fs.fill_codes_single(t, s, 2, 1, 1), 3)
        out[f"nw_score_single {L}x{L}bp"] = cs.cuda_ms(lambda: fs.score_fold(t, s, 2, 1, 1), 3)
    t, s = tensors[cs.L_HUGE]
    out[f"nw_score_single/ckpt {cs.L_HUGE}x{cs.L_HUGE}bp C={C_HUGE}"] = cs.cuda_ms(
        lambda: fs.score_fold(t, s, 2, 1, 1, checkpoint_every=C_HUGE), 3)
    for A, B in K9_SPLITS:  # a split's top row range and its forward half of the side
        t, s = tensors[cs.L_CROSS if A > cs.L_LONG else cs.L_LONG]
        out[f"nw_last_row {A}x{B}"] = cs.cuda_ms(lambda: fs.last_row(t[:A], s[:B], 2, 1, 1), 5)
    for L in (cs.L_LONG, cs.L_CROSS):
        t, s = tensors[L]
        out[f"nw_fill_masks {L}x{L}bp"] = cs.cuda_ms(lambda: fb.fill_arrows_banded_single(t, s, 2, 1, 1), 3)
    ps = cs.rand_pairs(np.random.default_rng(131), 4, cs.L_LONG, cs.L_LONG)
    T = enc.upload(enc.encode_batch(ps, cs.L_LONG, cs.L_LONG), dev)
    out[f"nw_fill_masks/fold 4x{cs.L_LONG}bp"] = cs.cuda_ms(lambda: fs.fill_arrows_fold_batch(*T, 2, 1, 1), 3)
    if not walls:
        return out

    big = pairs[cs.L_HUGE]
    aligner = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")
    self10 = pairs[cs.L_LONG][0]
    calls = {
        f"cli -q -s {cs.L_HUGE}bp": lambda: cs.run_cli(["-q", "-s", "2", "1", "1"], big[0] + b" " + big[1]),
        f"cli -l -s self {cs.L_LONG}bp": lambda: cs.run_cli(["-l", "-s", "1", "1", "1"], self10 + b" " + self10),
        f"align_huge codes route {cs.L_HUGE}bp": lambda: aligner.align_huge(*big),
        f"align_huge checkpointed {cs.L_HUGE}bp": lambda: aligner.align_huge(*big, block_diagonals=C_HUGE),
    }
    for name, fn in calls.items():
        if name.startswith("cli") and fn()[0] != 0:
            raise SystemExit(f"FAIL: the CLI exited non-zero: {name}")
        out[f"{name} wall, median of 3 warm"], out[f"{name} walls"] = wall(fn)
    med, runs = hirschberg_walls(big)
    out[f"hirschberg_align {cs.L_HUGE}bp wall, median of 2 warm"] = med
    out[f"hirschberg_align {cs.L_HUGE}bp runs [wall, host leaves, host rows, card rows] s"] = runs
    return out


def tiles(cs, dev) -> dict:
    """--tiles (module doc): {shape: device ms}."""
    import numpy as np
    import torch

    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_single as fs

    big = cs.rand_pairs(np.random.default_rng(cs.L_HUGE), 1, cs.L_HUGE, cs.L_HUGE)[0]
    top, side = (torch.from_numpy(enc.encode(x)).to(dev) for x in big)
    out = {}
    for mode, world, L, H, C in TILES:
        halo = torch.arange(0, -(C + 1), -1, dtype=torch.int32, device=dev)  # row 0 at 2 1 1
        left = torch.arange(-1, -(H + 1), -1, dtype=torch.int32, device=dev)  # column 0
        table = cs.tile_table(mode, L, H)
        out[f"nw_fill_tile {mode} {H}x{C} ({world} ranks, {L} bp)"] = cs.cuda_ms(
            lambda: cs.first_tile(fs.fill_tile, top[:L], side[:H], (2, 1, 1), C, halo, left, mode, table), 3)
        del table
        torch.cuda.empty_cache()
    out[f"nw_fill_codes_single {cs.L_HUGE}x{cs.L_HUGE}bp"] = cs.cuda_ms(
        lambda: fs.fill_codes_single(top, side, 2, 1, 1), 3)
    return out


def sweep(cs, dev, tensors_of) -> None:
    """--sweep (module doc)."""
    import torch

    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs

    kernels = (("nw_score_count", fs.score_count_fold), ("nw_fill_codes_single", fs.fill_codes_single))
    for L in SWEEP_BP:
        t, s = tensors_of(L)
        res = {f"{name} {L}x{L}bp W={w}": cs.cuda_ms(lambda: fn(t, s, 2, 1, 1, warps=w), 2)
               for w in SWEEP for name, fn in kernels}
        print(json.dumps({"sweep_ms": res}), flush=True)
    res = {}
    for L in (cs.L_LONG, cs.L_CROSS, cs.L_HUGE):
        t, s = tensors_of(L)
        for w in (None, *SWEEP):
            res[f"nw_score_single {L}x{L}bp W={w}"] = cs.cuda_ms(lambda: fs.score_fold(t, s, 2, 1, 1, warps=w), 2)
        for w in (None, *MASK_SWEEP) if L < cs.L_HUGE else ():
            res[f"nw_fill_masks {L}x{L}bp W={w}"] = cs.cuda_ms(
                lambda: fb.fill_arrows_banded_single(t, s, 2, 1, 1, warps=w), 2)
            res[f"nw_last_row {L}x{L // 2} W={w}"] = cs.cuda_ms(
                lambda: fs.last_row(t, s[: L // 2], 2, 1, 1, warps=w), 2)
    for A, B in K9_SPLITS[2:]:
        t, s = tensors_of(cs.L_LONG)
        for w in (None, 1, 2, 4, 8):
            res[f"nw_last_row {A}x{B} W={w}"] = cs.cuda_ms(lambda: fs.last_row(t[:A], s[:B], 2, 1, 1, warps=w), 5)
    print(json.dumps({"sweep_ms": res}), flush=True)
    t, s = tensors_of(cs.L_HUGE)
    res = {}
    staged = fb._top_scratch
    fb._top_scratch = lambda B, A, cell, device, warps=1, masks=False: torch.empty(
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


def main(argv) -> int:
    do_check, do_sweep, do_routes = "--check" in argv, "--sweep" in argv, "--routes" in argv
    do_walls, do_tiles = "--kernels" not in argv, "--tiles" in argv
    args = [a for a in argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))  # root's nw_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_single as fs

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    if do_check:
        errs = {**check(cs, dev), **check_modes(cs, dev)}
        print(json.dumps({"check_max_abs_err": errs}), flush=True)
        if any(errs.values()):
            print("FAIL: a single-pair kernel differs from its plain version", file=sys.stderr)
            return 1
    out = tiles(cs, dev) if do_tiles else times(cs, dev, do_walls)
    print(json.dumps({"root": str(root), "package": str(Path(fs.__file__).parent.parent), "ms": out}),
          flush=True)
    if do_sweep:
        def tensors_of(L):
            p = cs.rand_pairs(np.random.default_rng(L), 1, L, L)[0]
            return tuple(torch.from_numpy(enc.encode(x)).to(dev) for x in p)

        sweep(cs, dev, tensors_of)
    if do_routes:
        print(json.dumps({"routes_ms": routes(cs, dev, card)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
