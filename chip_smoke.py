"""Smoke run of nw_tpu_torch on one NVIDIA card: the batched aligner
and the byte-parity CLI.

    python3 chip_smoke.py

Phases, in order; any mismatch or exception exits non-zero:

1. the card (nvidia-smi name and power limit), torch / CUDA / Triton;
2. build the CUDA kernels from nw_tpu_torch/csrc (seconds printed);
3. every kernel bit for bit against its plain PyTorch version on the card:
   64 random pairs of 0-700 bp, tie-dense two-letter pairs and the edge
   pairs, under the scorings (2,1,1), (1,1,1), (0,0,0) and (3,-1,2);
4. the main path, ``NWAligner(...).align_batch``, with every launch
   counter set to 0 first: config 3 (256 random 10240 bp pairs, strings
   and counts; each alignment re-scored on the host, 4 pairs against the
   plain path on the card), then config 2 (10240 x 150 bp, scores only,
   all against the plain path) and 128 x 10240 bp scores only; every
   kernel must have launched;
5. wall times (median of 4 warm runs), pairs/s and GCUPS of the
   configs, and each kernel's time beside its plain version's, with the
   card's name and power limit;
6. the single-pair kernels (``nw_score_count``, ``nw_fill_masks``) bit
   for bit against their plain versions, one pair at a time: 24 random
   pairs of 0-700 bp, tie-dense pairs, the edge pairs and all-'A'
   24 x 16 (the count wraps), under every scoring; ``nw_score_count`` on
   a 20 000 x 20 000 pair (above 2^28 cells) against its plain version
   and ``nw_fill_codes`` counts-only, and its time at 1 to 32 warps;
7. the CLI (``python3 -m nw_tpu_torch``, the native runtime built from
   nw_tpu/runtime/cc): goldens of tests/test_cli.py as subprocesses;
   then, in-process with every launch counter set to 0 until the last
   CLI call, the same cases and 8 mixed-length tie-dense pairs under
   ``-l -s`` (BASELINE config 4) on the card against
   ``NW_TPU_PLATFORM=cpu`` byte for byte, a 10 240 bp pair aligned to
   itself, a random 10 240 x 10 240 pair under ``-q -s`` with and
   without ``NW_TPU_DEBUG`` (``nw_fill_masks`` / ``nw_score_count``) and
   a 100 000 x 100 000 pair under ``-q -s``, all three against
   ``nw_fill_codes`` counts-only; both single-pair kernels must have
   launched; ``nw_fill_masks`` against its plain version on the 10 kb
   pair; the CLI's cold start.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)]
EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"A", b"A"), (b"GCATGCU", b"GATTACA")]
L_LONG = 10240  # bench.py:231 bench_config3 / bench.py:127 banded scores
L_SHORT = 150  # BASELINE config 2
L_HUGE = 100_000  # BASELINE config 5's pair length
L_CROSS = 20_000  # (L+1)^2 > 2^28: past nw_tpu's huge-route threshold
# (args, stdin, stdout, stderr) of tests/test_cli.py, run as subprocesses
GOLDENS = [
    (["1", "1", "1"], b"GT GT", b"GT\nGT\n\n", b""),
    (["-l", "1", "1", "1"], b"GT GA", b"GT\nGA\n1 match, 1 mismatch, 0 indels\n\n", b""),
    (["1", "1", "1"], b"GAT GTA", b"G-AT\nGTA-\n\nGAT-\nG-TA\n\n", b""),
    (
        ["-s", "1", "1", "1"], b"GCATGCU GATTACA",
        b"GCA-TGCU\nG-ATTACA\n\nGCAT-GCU\nG-ATTACA\n\nGCATG-CU\nG-ATTACA\n\n",
        b"3 optimal alignments\nOptimal score is 0\n",
    ),
    (
        ["-c", "1", "1", "1"], b"GT GA",
        b"G\x1b[0m\x1b[31;1mT\x1b[0m\nG\x1b[0m\x1b[31;1mA\x1b[0m\n\n", b"",
    ),
    (
        ["-q", "-s", "-t", "1", "1", "1"], b"GCATGCU GATTACA",
        b"\n"
        b"*     -     G     C     A     T     G     C     U\n"
        b"                                                 \n"
        b"-    +0  < -1  < -2  < -3  < -4  < -5  < -6  < -7\n"
        b"      ^  \\                       \\               \n"
        b"G    -1    +1  < +0  < -1  < -2  < -3  < -4  < -5\n"
        b"      ^     ^  \\     \\                           \n"
        b"A    -2    +0    +0    +1  < +0  < -1  < -2  < -3\n"
        b"      ^     ^  \\  ^     ^  \\                     \n"
        b"T    -3    -1    -1    +0    +2  < +1  < +0  < -1\n"
        b"      ^     ^  \\  ^     ^  \\  ^  \\     \\     \\   \n"
        b"T    -4    -2    -2    -1    +1    +1  < +0  < -1\n"
        b"      ^     ^  \\  ^  \\        ^  \\  ^  \\     \\   \n"
        b"A    -5    -3    -3    -1    +0    +0    +0  < -1\n"
        b"      ^     ^  \\        ^     ^  \\  ^  \\         \n"
        b"C    -6    -4    -2    -2    -1    -1    +1  < +0\n"
        b"      ^     ^     ^  \\        ^  \\  ^     ^  \\   \n"
        b"A    -7    -5    -3    -1  < -2    -2    +0    +0\n",
        b"3 optimal alignments\nOptimal score is 0\n",
    ),
]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def rand_pairs(rng, n, lo, hi, alphabet=b"ACGT"):
    letters = np.frombuffer(alphabet, np.uint8)
    return [
        (
            letters[rng.integers(0, len(letters), int(rng.integers(lo, hi + 1)))].tobytes(),
            letters[rng.integers(0, len(letters), int(rng.integers(lo, hi + 1)))].tobytes(),
        )
        for _ in range(n)
    ]


def max_abs_err(got, want) -> int:
    """Largest |got - want| over integer outputs (codes compared as
    uint32 words)."""
    g = got.to(torch.int64).cpu()
    w = want.to(torch.int64).cpu()
    if g.shape != w.shape:
        fail(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    if got.dtype == torch.int32 and got.dim() == 3:
        g, w = g & 0xFFFFFFFF, w & 0xFFFFFFFF
    return int((g - w).abs().max()) if g.numel() else 0


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up,
    by CUDA events; ``reps`` 0 times the one run itself."""
    if reps == 0:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rescore(pairs, aligned, m, k, d) -> np.ndarray:
    """Host re-score of aligned strings; also checks that each aligned
    string is its input with gaps added."""
    out = np.zeros(len(pairs), np.int64)
    for b, ((s1, s2), (X, Y)) in enumerate(zip(pairs, aligned)):
        x = np.frombuffer(X, np.uint8)
        y = np.frombuffer(Y, np.uint8)
        if len(x) != len(y):
            fail(f"pair {b}: aligned lengths differ")
        gx, gy = x == ord("-"), y == ord("-")
        if x[~gx].tobytes() != s1 or y[~gy].tobytes() != s2:
            fail(f"pair {b}: alignment does not spell its input")
        if (gx & gy).any():
            fail(f"pair {b}: a column of two gaps")
        gap = gx | gy
        match = ~gap & (x == y)
        out[b] = m * match.sum() - k * (~gap & ~match).sum() - d * gap.sum()
    return out


def signed_count(line: bytes) -> int:
    """The count of a "-s" summary's first line, as uint32."""
    return int(line.split()[0]) & 0xFFFFFFFF


def run_cli(args, stdin: bytes, platform=None):
    """nw_tpu_torch.cli.main in-process; platform None = the card."""
    from nw_tpu_torch import cli

    saved = os.environ.pop("NW_TPU_PLATFORM", None)
    if platform:
        os.environ["NW_TPU_PLATFORM"] = platform
    try:
        out, err = io.BytesIO(), io.BytesIO()
        rc = cli.main(["needleman-wunsch", *args], io.BytesIO(stdin), out, err)
        return rc, out.getvalue(), err.getvalue()
    finally:
        os.environ.pop("NW_TPU_PLATFORM", None)
        if saved is not None:
            os.environ["NW_TPU_PLATFORM"] = saved


def exact_count(masks: np.ndarray) -> int:
    """Unbounded number of optimal alignments from rectangular masks."""
    N, M = masks.shape
    paths = [[0] * M for _ in range(N)]
    paths[0][0] = 1
    for j in range(N):
        for i in range(M):
            a = int(masks[j, i])
            p = paths[j][i]
            if a & 1:
                p += paths[j - 1][i - 1]
            if a & 2:
                p += paths[j][i - 1]
            if a & 4:
                p += paths[j - 1][i]
            paths[j][i] = p
    return paths[N - 1][M - 1]


def config4_pairs(rng, n, limit):
    """Mixed-length tie-dense (AC) pairs: a random string and a copy with
    a few substitutions and indels, cut from the ends until every optimal
    alignment (1 1 1) can be printed (at most ``limit``)."""
    from nw_tpu_torch.ops.encode import encode
    from nw_tpu_torch.ops.fill_banded import fill_arrows_banded_single

    letters = np.frombuffer(b"AC", np.uint8)
    pairs = []
    for L in np.linspace(20, 400, n).astype(int):
        s1 = bytearray(letters[rng.integers(0, 2, int(L))].tobytes())
        s2 = bytearray(s1)
        for _ in range(3):
            pos = int(rng.integers(0, len(s2)))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                s2[pos] = ord("A") + ord("C") - s2[pos]
            elif kind == 1:
                del s2[pos]
            else:
                s2.insert(pos, letters[int(rng.integers(0, 2))])
        s1, s2 = bytes(s1), bytes(s2)
        while True:
            masks = fill_arrows_banded_single(
                torch.from_numpy(encode(s1)).cuda(), torch.from_numpy(encode(s2)).cuda(), 1, 1, 1
            )[0].cpu().numpy()
            if exact_count(masks) <= limit:
                break
            s1, s2 = s1[:-8], s2[:-8]
        pairs.append((s1, s2))
    return pairs


def single_phase(card, errs):
    """Phase 6: nw_score_count / nw_fill_masks against their plain
    versions, the 2^28+ cross-check and the warps sweep.  Returns the
    plain and kernel times of ``nw_score_count`` at L_CROSS."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops.fill_scan import diag_to_matrix, fill_diag_batch

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    pairs = (
        rand_pairs(rng, 24, 0, 700) + rand_pairs(rng, 6, 100, 400, b"AC") + EDGE
        + [(b"A" * 24, b"A" * 16)]
    )
    L1 = max(len(a) for a, _ in pairs)
    L2 = max(len(b) for _, b in pairs)
    tops, sides, l1, l2 = enc.upload(enc.encode_batch(pairs, L1, L2), dev)
    errs["nw_score_count"] = errs["nw_fill_masks"] = 0
    for mkd in SCORINGS:
        # the plain versions' body (fill_diag), on every pair at once
        ref = fill_diag_batch(
            tops, sides, l1, l2, *mkd, with_counts=True, with_scores=True
        )
        e_sc = e_fm = 0
        for b, (s1, s2) in enumerate(pairs):
            top, side = tops[b], sides[b]
            want_masks = diag_to_matrix(ref["arrows"][b], len(s1), len(s2))
            want_scores = diag_to_matrix(ref["scores"][b], len(s1), len(s2))
            want = (int(ref["score"][b]), int(ref["count"][b]))
            got = fs.score_count_fold(top, side, *mkd, len1=len(s1), len2=len(s2))
            e_sc = max([e_sc] + [abs(g - w) for g, w in zip(got, want)])
            for with_scores in (False, True):
                masks, scores, *sc = fb.fill_arrows_banded_single(
                    top, side, *mkd, len1=len(s1), len2=len(s2), with_scores=with_scores
                )
                e_fm = max(
                    [e_fm, max_abs_err(masks, want_masks)]
                    + [abs(g - w) for g, w in zip(sc, want)]
                    + ([max_abs_err(scores, want_scores)] if with_scores else [])
                )
        # the plain twins themselves, on the short pairs
        for s1, s2 in EDGE + [(b"A" * 24, b"A" * 16), (b"ACCATTG", b"CATAG")]:
            top, side = (torch.from_numpy(enc.encode(x)).to(dev) for x in (s1, s2))
            got, want = fs.score_count_fold(top, side, *mkd), fs.score_count_fold_plain(top, side, *mkd)
            e_sc = max([e_sc] + [abs(g - w) for g, w in zip(got, want)])
            got = fb.fill_arrows_banded_single(top, side, *mkd, with_scores=True)
            want = fb.fill_arrows_banded_single_plain(top, side, *mkd, with_scores=True)
            e_fm = max(
                [e_fm, max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1])]
                + [abs(g - w) for g, w in zip(got[2:], want[2:])]
            )
        errs["nw_score_count"] = max(errs["nw_score_count"], e_sc)
        errs["nw_fill_masks"] = max(errs["nw_fill_masks"], e_fm)
        log(f"single-pair kernels vs plain, {len(pairs)} pairs, m k d = {mkd}: "
            f"nw_score_count {e_sc} nw_fill_masks {e_fm}")
    del ref
    if errs["nw_score_count"] or errs["nw_fill_masks"]:
        fail(f"a single-pair kernel differs from its plain version: {errs}")

    # above 2^28 cells: the K8 port against its plain version and the K2
    # port's counts-only mode
    pair = rand_pairs(np.random.default_rng(20), 1, L_CROSS, L_CROSS)[0]
    tb_, sb_, l1b, l2b = enc.upload(enc.encode_batch([pair], L_CROSS, L_CROSS), dev)
    ref = fb.fill_scores_counts_banded_batch(tb_, sb_, l1b, l2b, 2, 1, 1)
    want = (int(ref[0][0]), int(ref[1][0]))
    got = fs.score_count_fold(tb_[0], sb_[0], 2, 1, 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain = fs.score_count_fold_plain(tb_[0], sb_[0], 2, 1, 1)
    end.record()
    torch.cuda.synchronize()
    plain_sc_ms = start.elapsed_time(end)
    e = max(abs(g - w) for g, w in zip(got, plain))
    errs["nw_score_count"] = max(errs["nw_score_count"], e)
    log(f"{L_CROSS} x {L_CROSS} (score, count): nw_score_count {got}, plain {plain} "
        f"({plain_sc_ms:.1f} ms), nw_fill_codes {want}")
    if got != want or e:
        fail("nw_score_count differs from its plain version or nw_fill_codes above 2^28 cells")
    # (blocks, warps): one warp alone, one SM, and one block an SM
    # (blocks None) at 4 to 32 warps; the default (None, 8) twice
    sweep = {}
    for blocks, warps in [(None, 8), (1, 1), (1, 32), (None, 4), (None, 16), (None, 32), (None, 8)]:
        sweep.setdefault((blocks, warps), []).append(cuda_ms(
            lambda: fs.score_count_fold(tb_[0], sb_[0], 2, 1, 1, warps=warps, blocks=blocks), 1
        ))
    for (blocks, warps), ms in sweep.items():
        log(f"nw_score_count {L_CROSS}x{L_CROSS}bp, blocks {blocks or 'one an SM'} x {warps} warps: "
            f"{[round(x, 3) for x in ms]} ms = {L_CROSS * L_CROSS / (min(ms) * 1e6):.2f} GCUPS [{card}]")
    log(f"nw_score_count {L_CROSS}x{L_CROSS}bp plain version: {plain_sc_ms:.1f} ms [{card}]")
    return {"plain_sc_ms": plain_sc_ms, "sc_ms_cross": min(sweep[(None, 8)])}


def cli_phase(card, errs):
    """Phase 7: the CLI.  Returns (launches per new kernel, walls, the
    time of each new kernel at its full CLI shape); ``nw_fill_masks``
    against its plain version at 10 kb goes into ``errs``."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.runtime import native

    if native.load() is None:
        fail("the native runtime (nw_tpu/runtime/cc) did not build or load")
    env = {k: v for k, v in os.environ.items() if k != "NW_TPU_PLATFORM"}
    for args, stdin, want_out, want_err in GOLDENS:
        res = subprocess.run(
            [sys.executable, "-m", "nw_tpu_torch", *args], input=stdin,
            capture_output=True, env=env, timeout=300,
        )
        if (res.returncode, res.stdout, res.stderr) != (0, want_out, want_err):
            fail(f"python3 -m nw_tpu_torch {args}: got {res.returncode} {res.stdout!r} {res.stderr!r}")
    log(f"CLI subprocess goldens: {len(GOLDENS)} byte-equal")

    # inputs first: config4_pairs calls nw_fill_masks itself
    rng = np.random.default_rng(7)
    cases = [(a, s) for a, s, _, _ in GOLDENS] + [
        (["-q", "-t", "-s", "--", "3", "-1", "2"], b"ACCATGCA CATTGA"),
        (["-t", "-u", "-c", "2", "1", "1"], b"GATTACA GCATGCU"),
        (["-q", "-s", "0", "0", "0"], b"A" * 24 + b" " + b"A" * 16),
        (["-s", "-p", "3", "1", "1", "1"], b"\x00 \x00"),
    ]
    c4 = config4_pairs(rng, 8, 1000)
    cases += [(["-l", "-s", "1", "1", "1"], a + b" " + b) for a, b in c4]
    letters = np.frombuffer(b"ACGT", np.uint8)
    s = letters[rng.integers(0, 4, L_LONG)].tobytes()
    big = {L: rand_pairs(np.random.default_rng(L), 1, L, L)[0] for L in (L_LONG, L_HUGE)}

    # the CLI runs, every launch counter from 0; the card's CLI calls a
    # wrapper nowhere else until the counts are read (CPU runs launch
    # nothing)
    fs.score_count_fold.launches = fb.fill_arrows_banded_single.launches = 0
    walls = {}
    for args, stdin in cases:
        got, want = run_cli(args, stdin), run_cli(args, stdin, "cpu")
        if got != want or got[0] != 0:
            fail(f"CLI {args} on the card != NW_TPU_PLATFORM=cpu: {got!r} {want!r}")
    os.environ["NW_TPU_DEBUG"] = "1"
    got, want = run_cli(["-s", "1", "1", "1"], b"GCATGCU GATTACA"), run_cli(["-s", "1", "1", "1"], b"GCATGCU GATTACA", "cpu")
    os.environ["NW_TPU_HUGE_CELLS"] = "1"
    del os.environ["NW_TPU_DEBUG"]
    forced = [run_cli(["-q", "-s", "2", "1", "1"], a + b" " + b) for a, b in c4[:4]]
    forced_cpu = [run_cli(["-q", "-s", "2", "1", "1"], a + b" " + b, "cpu") for a, b in c4[:4]]
    del os.environ["NW_TPU_HUGE_CELLS"]
    if got != want or forced != forced_cpu:
        fail("CLI debug trace or forced huge route differs between the card and the CPU")
    log(f"CLI in-process, card vs NW_TPU_PLATFORM=cpu: {len(cases) + 5} cases byte-equal "
        f"(config 4: {len(c4)} tie-dense pairs of {[(len(a), len(b)) for a, b in c4]} bp under -l -s)")

    t0 = time.perf_counter()
    res = run_cli(["-l", "-s", "1", "1", "1"], s + b" " + s)
    walls["self10k_l_s"] = time.perf_counter() - t0
    want = (0, s + b"\n" + s + b"\n" + b"%d matches, 0 mismatches, 0 indels\n\n" % L_LONG,
            b"1 optimal alignment\nOptimal score is %d\n" % L_LONG)
    if res != want:
        fail("CLI: a 10240 bp pair aligned to itself is not one alignment of score 10240")

    # -q -s takes nw_score_count; under NW_TPU_DEBUG (the branch count
    # needs the masks) the same call takes nw_fill_masks
    big_runs = {}
    for L, name, debug in (
        (L_LONG, "rand10k_q_s", False), (L_LONG, "rand10k_q_s_debug", True),
        (L_HUGE, "rand100k_q_s", False),
    ):
        if debug:
            os.environ["NW_TPU_DEBUG"] = "1"
        t0 = time.perf_counter()
        big_runs[name] = (L, run_cli(["-q", "-s", "2", "1", "1"], big[L][0] + b" " + big[L][1]))
        walls[name] = time.perf_counter() - t0
        os.environ.pop("NW_TPU_DEBUG", None)
    launches = {
        "nw_score_count": fs.score_count_fold.launches,
        "nw_fill_masks": fb.fill_arrows_banded_single.launches,
    }
    log(f"CLI launches: {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the CLI path never launched: {launches}")

    refs = {}
    for L, pair in big.items():
        tops, sides, l1, l2 = enc.upload(enc.encode_batch([pair], L, L), torch.device("cuda"))
        t0 = time.perf_counter()
        sc, ct = fb.fill_scores_counts_banded_batch(tops, sides, l1, l2, 2, 1, 1)
        refs[L] = (int(sc[0]), int(ct[0]))
        walls[f"nw_fill_codes_1warp_{L}"] = time.perf_counter() - t0
    for name, (L, (rc, out, err)) in big_runs.items():
        lines = [x for x in err.split(b"\n") if x and b": debug: " not in x]
        got = (int(lines[1].split()[-1]), signed_count(lines[0])) if rc == 0 else None
        log(f"CLI {name} {L}x{L}: rc {rc} (score, count) {got}, nw_fill_codes {refs[L]}")
        if rc != 0 or out != b"" or got != refs[L] or len(lines) != 2:
            fail(f"CLI {name} at {L} bp differs from nw_fill_codes counts-only")
    if b"branches in walk table" not in big_runs["rand10k_q_s_debug"][1][2]:
        fail("CLI debug trace at 10 kb has no branch count")

    # nw_fill_masks against its plain version at the CLI's 10 kb shape
    top, side = (torch.from_numpy(enc.encode(x)).cuda() for x in big[L_LONG])
    got = fb.fill_arrows_banded_single(top, side, 2, 1, 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = fb.fill_arrows_banded_single_plain(top, side, 2, 1, 1)
    end.record()
    torch.cuda.synchronize()
    plain_fm_ms = start.elapsed_time(end)
    e = max([max_abs_err(got[0], want[0])] + [abs(g - w) for g, w in zip(got[2:], want[2:])])
    errs["nw_fill_masks"] = max(errs["nw_fill_masks"], e)
    log(f"nw_fill_masks {L_LONG}x{L_LONG}bp vs plain ({plain_fm_ms:.1f} ms): max |diff| {e}; "
        f"(score, count) {got[2:]} [{card}]")
    if e or got[2:] != refs[L_LONG]:
        fail(f"nw_fill_masks differs from its plain version or nw_fill_codes at {L_LONG} bp")
    del got, want
    torch.cuda.empty_cache()

    cold = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "nw_tpu_torch", "-s", "1", "1", "1"],
            input=b"GCATGCU GATTACA", capture_output=True, env=env, timeout=300,
        )
        cold.append(time.perf_counter() - t0)
        if res.returncode != 0 or res.stderr != GOLDENS[3][3]:
            fail("CLI cold start: wrong output")
    walls["cold_start"] = cold
    for name, w in walls.items():
        log(f"CLI wall {name}: {w} s [{card}]")

    # the new kernels alone at their CLI shapes
    times = {
        "fm_ms": cuda_ms(lambda: fb.fill_arrows_banded_single(top, side, 2, 1, 1), 3),
        "plain_fm_ms": plain_fm_ms,
    }
    top, side = (torch.from_numpy(enc.encode(x)).cuda() for x in big[L_HUGE])
    times["sc_ms"] = cuda_ms(lambda: fs.score_count_fold(top, side, 2, 1, 1), 3)
    one_warp = cuda_ms(lambda: fs.score_count_fold(top, side, 2, 1, 1, warps=1, blocks=1), 0)
    log(f"nw_fill_masks {L_LONG}x{L_LONG}bp: {times['fm_ms']:.3f} ms; nw_score_count "
        f"{L_HUGE}x{L_HUGE}bp: {times['sc_ms']:.3f} ms = "
        f"{L_HUGE * L_HUGE / (times['sc_ms'] * 1e6):.2f} GCUPS, one warp alone "
        f"{one_warp:.1f} ms [{card}]")
    return launches, walls, times


def main() -> None:
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to run", file=sys.stderr)
        sys.exit(2)
    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.runtime import kernels

    dev = torch.device("cuda")
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    card = f"{smi.splitlines()[0]}"
    log(smi)
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"triton {'installed' if importlib.util.find_spec('triton') else 'absent'} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}"
    )

    # 2. build
    t0 = time.perf_counter()
    kernels.load()
    log(f"kernel build+load: {time.perf_counter() - t0:.1f} s ({kernels.library_path().name})")

    # 3. each kernel bit for bit against its plain version
    rng = np.random.default_rng(0)
    cfg = AlignConfig()
    small = rand_pairs(rng, 64, 0, 700) + rand_pairs(rng, 8, 100, 400, b"AC") + EDGE
    L1 = cfg.bucket_for(max(len(a) for a, _ in small))
    L2 = cfg.bucket_for(max(len(b) for _, b in small))
    tops, sides, l1, l2 = enc.upload(enc.encode_batch(small, L1, L2), dev)
    errs = {"nw_scores": 0, "nw_fill_codes": 0, "nw_walk": 0}
    for mkd in SCORINGS:
        e = max_abs_err(
            fb.fill_scores_banded_batch(tops, sides, l1, l2, *mkd),
            fb.fill_scores_banded_batch_plain(tops, sides, l1, l2, *mkd),
        )
        errs["nw_scores"] = max(errs["nw_scores"], e)
        got = fb.fill_scores_counts_banded_batch(tops, sides, l1, l2, *mkd)
        want = fb.fill_scores_counts_banded_batch_plain(tops, sides, l1, l2, *mkd)
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        for with_counts in (False, True):
            got = fb.fill_greedy_counts_banded_batch(
                tops, sides, l1, l2, *mkd, with_counts=with_counts
            )
            want = fb.fill_greedy_counts_banded_batch_plain(
                tops, sides, l1, l2, *mkd, with_counts=with_counts
            )
            e = max([e] + [max_abs_err(g, w) for g, w in zip(got, want) if w is not None])
        errs["nw_fill_codes"] = max(errs["nw_fill_codes"], e)
        ops_k = tb.walk_codes_batch(got[0], l1, l2, L1 + L2)
        ops_p = tb.walk_codes_batch_plain(want[0], l1, l2, L1 + L2)
        errs["nw_walk"] = max(
            [errs["nw_walk"]] + [max_abs_err(g, w) for g, w in zip(ops_k, ops_p)]
        )
        torch.cuda.synchronize()
        log(f"kernel vs plain, {len(small)} pairs {L1}x{L2} bucket, m k d = {mkd}: {errs}")
    if any(errs.values()):
        fail(f"kernel differs from its plain version: {errs}")

    # 4. the main path; counters from 0
    rng = np.random.default_rng(4)
    letters = np.frombuffer(b"ACGT", np.uint8)
    c3 = [
        (letters[rng.integers(0, 4, L_LONG)].tobytes(), letters[rng.integers(0, 4, L_LONG)].tobytes())
        for _ in range(256)
    ]
    c2 = [
        (letters[rng.integers(0, 4, L_SHORT)].tobytes(), letters[rng.integers(0, 4, L_SHORT)].tobytes())
        for _ in range(10240)
    ]
    c128 = c3[:128]
    LB = cfg.bucket_for(L_LONG)  # 10240 is a bucket of its own
    m, k, d = 2, 1, 1
    aligner = NWAligner(AlignConfig(scoring=ScoringParams(m, k, d)), device="cuda")
    wrappers = {
        "nw_scores": [fb.fill_scores_banded_batch],
        "nw_fill_codes": [fb.fill_scores_counts_banded_batch, fb.fill_greedy_counts_banded_batch],
        "nw_walk": [tb.walk_codes_batch],
    }

    def counts():
        return {n: sum(w.launches for w in ws) for n, ws in wrappers.items()}

    for ws in wrappers.values():
        for w in ws:
            w.launches = 0
    walls = {}
    t0 = time.perf_counter()
    r3 = aligner.align_batch(c3, traceback_strings=True, count=True)
    aligned = r3.alignment_strings()
    walls["config3"] = [time.perf_counter() - t0]
    after3 = counts()
    t0 = time.perf_counter()
    r2 = aligner.align_batch(c2)
    walls["config2"] = [time.perf_counter() - t0]
    t0 = time.perf_counter()
    r128 = aligner.align_batch(c128)
    walls["score128"] = [time.perf_counter() - t0]
    torch.cuda.synchronize()
    launches = counts()
    log(f"launches: config 3 {after3}; main path total {launches}")
    if after3["nw_fill_codes"] < 1 or after3["nw_walk"] < 1:
        fail("config 3 did not run through nw_fill_codes and nw_walk")
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")

    # correctness of the main path's outputs
    if r3.scores.shape != (256,) or r3.counts.dtype != np.uint32 or r3.ops.shape != (256, 2 * LB):
        fail("config 3: unexpected output shapes")
    want = rescore(c3, aligned, m, k, d)
    if not np.array_equal(want, r3.scores.astype(np.int64)):
        fail("config 3: reported scores differ from the re-scored alignments")
    log("config 3: all 256 alignments spell their inputs and re-score to the reported scores")
    sub = c3[:4]
    tops, sides, l1, l2 = enc.upload(enc.encode_batch(sub, LB, LB), dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    p_codes, p_sc, p_ct = fb.fill_greedy_counts_banded_batch_plain(
        tops, sides, l1, l2, m, k, d, with_counts=True
    )
    end.record()
    torch.cuda.synchronize()
    plain_fill_ms = start.elapsed_time(end)
    start.record()
    p_ops, p_n = tb.walk_codes_batch_plain(p_codes, l1, l2, 2 * LB)
    end.record()
    torch.cuda.synchronize()
    plain_walk_ms = start.elapsed_time(end)
    k_codes, k_sc, k_ct = fb.fill_greedy_counts_banded_batch(
        tops, sides, l1, l2, m, k, d, with_counts=True
    )
    k_ops, k_n = tb.walk_codes_batch(k_codes, l1, l2, 2 * LB)
    e_fill = max(max_abs_err(k_codes, p_codes), max_abs_err(k_sc, p_sc), max_abs_err(k_ct, p_ct))
    e_walk = max(max_abs_err(k_ops, p_ops), max_abs_err(k_n, p_n))
    e_path = max(
        int(np.abs(r3.scores[:4].astype(np.int64) - p_sc.cpu().numpy()).max()),
        int(np.abs(r3.counts[:4].astype(np.int64) - p_ct.cpu().numpy()).max()),
        int(np.abs(r3.ops[:4].astype(np.int64) - p_ops.cpu().numpy()).max()),
        int(np.abs(r3.ops_len[:4].astype(np.int64) - p_n.cpu().numpy()).max()),
    )
    log(f"config 3, 4 pairs vs plain on the card: fill {e_fill} walk {e_walk} align_batch {e_path}")
    if e_fill or e_walk or e_path:
        fail("config 3: kernel or main path differs from the plain path")
    errs["nw_fill_codes"] = max(errs["nw_fill_codes"], e_fill)
    errs["nw_walk"] = max(errs["nw_walk"], e_walk)

    tops2, sides2, l1s, l2s = enc.upload(
        enc.encode_batch(c2, cfg.bucket_for(L_SHORT), cfg.bucket_for(L_SHORT)), dev
    )
    start.record()
    p2 = fb.fill_scores_banded_batch_plain(tops2, sides2, l1s, l2s, m, k, d)
    end.record()
    torch.cuda.synchronize()
    plain_scores_ms = start.elapsed_time(end)
    e2 = int(np.abs(r2.scores.astype(np.int64) - p2.cpu().numpy()).max())
    log(f"config 2: {len(c2)} scores vs plain on the card: max |diff| {e2}")
    if e2 or r2.scores.shape != (len(c2),):
        fail("config 2: scores differ from the plain path")
    errs["nw_scores"] = max(errs["nw_scores"], e2)
    if r128.scores.shape != (128,) or not np.array_equal(r128.scores, r3.scores[:128]):
        fail("128 x 10240 scores differ from config 3's scores of the same pairs")
    log("128 x 10240 score-only: equal to config 3's scores of the same pairs")

    # 5. times: 4 warm runs of each configuration, in turns
    for _ in range(4):
        t0 = time.perf_counter()
        aligner.align_batch(c3, traceback_strings=True, count=True).alignment_strings()
        walls["config3"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        aligner.align_batch(c2)
        walls["config2"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        aligner.align_batch(c128)
        walls["score128"].append(time.perf_counter() - t0)
    cells = {
        "config3": 256 * L_LONG * L_LONG,
        "config2": len(c2) * L_SHORT * L_SHORT,
        "score128": 128 * L_LONG * L_LONG,
    }
    npairs = {"config3": 256, "config2": len(c2), "score128": 128}
    for name, ws in walls.items():
        med = statistics.median(ws[1:])
        log(
            f"e2e {name}: walls {[round(w, 4) for w in ws]} s (first includes "
            f"warm-up); median warm {med:.4f} s = {npairs[name] / med:.1f} pairs/s, "
            f"{cells[name] / med / 1e9:.2f} GCUPS [{card}]"
        )

    k_scores_ms = cuda_ms(lambda: fb.fill_scores_banded_batch(tops2, sides2, l1s, l2s, m, k, d), 20)
    k_fill_ms = cuda_ms(
        lambda: fb.fill_greedy_counts_banded_batch(tops, sides, l1, l2, m, k, d, with_counts=True), 3
    )
    k_walk_ms = cuda_ms(lambda: tb.walk_codes_batch(k_codes, l1, l2, 2 * LB), 5)
    log(f"nw_scores 10240x150bp: kernel {k_scores_ms:.3f} ms, plain {plain_scores_ms:.1f} ms [{card}]")
    log(f"nw_fill_codes codes+counts 4x10240bp: kernel {k_fill_ms:.3f} ms, plain {plain_fill_ms:.1f} ms [{card}]")
    log(f"nw_walk 4x10240bp: kernel {k_walk_ms:.3f} ms, plain {plain_walk_ms:.1f} ms [{card}]")
    del p_codes, k_codes
    torch.cuda.empty_cache()

    # kernel times at the main path's full shapes
    tops3, sides3, l13, l23 = enc.upload(enc.encode_batch(c3, LB, LB), dev)
    full = {
        "nw_scores 128x10240bp": cuda_ms(
            lambda: fb.fill_scores_banded_batch(tops3[:128], sides3[:128], l13[:128], l23[:128], m, k, d), 3
        ),
        "nw_fill_codes counts only 256x10240bp": cuda_ms(
            lambda: fb.fill_scores_counts_banded_batch(tops3, sides3, l13, l23, m, k, d), 2
        ),
        "nw_fill_codes codes+counts 256x10240bp": cuda_ms(
            lambda: fb.fill_greedy_counts_banded_batch(tops3, sides3, l13, l23, m, k, d, with_counts=True), 2
        ),
    }
    codes3, _, _ = fb.fill_greedy_counts_banded_batch(tops3, sides3, l13, l23, m, k, d)
    full["nw_walk 256x10240bp"] = cuda_ms(lambda: tb.walk_codes_batch(codes3, l13, l23, 2 * LB), 3)
    for name, ms in full.items():
        log(f"kernel {name}: {ms:.3f} ms [{card}]")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del codes3, tops3, sides3
    torch.cuda.empty_cache()

    # 6. the single-pair kernels; 7. the CLI (its own launch counters)
    single = single_phase(card, errs)
    cli_launches, cli_walls, cli_times = cli_phase(card, errs)

    record = {
        "kernels": [
            {
                "name": "nw_scores", "route": "cuda", "source": "nw_tpu_torch/csrc/nw_fill.cu",
                "replaces": "nw_tpu/ops/fill_pallas_banded.py:98",
                "launches": launches["nw_scores"], "max_abs_err": errs["nw_scores"],
                "ms": k_scores_ms, "plain_ms": plain_scores_ms,
                "shape": f"{len(c2)}x{L_SHORT}bp scores",
            },
            {
                "name": "nw_fill_codes", "route": "cuda", "source": "nw_tpu_torch/csrc/nw_fill.cu",
                "replaces": "nw_tpu/ops/fill_pallas_banded.py:342",
                "launches": launches["nw_fill_codes"], "max_abs_err": errs["nw_fill_codes"],
                "ms": k_fill_ms, "plain_ms": plain_fill_ms,
                "shape": f"4x{L_LONG}bp codes+counts",
            },
            {
                "name": "nw_walk", "route": "cuda", "source": "nw_tpu_torch/csrc/nw_walk.cu",
                "replaces": "nw_tpu/ops/banded_traceback.py:115",
                "launches": launches["nw_walk"], "max_abs_err": errs["nw_walk"],
                "ms": k_walk_ms, "plain_ms": plain_walk_ms,
                "shape": f"4x{L_LONG}bp walk",
            },
            {
                "name": "nw_fill_masks", "route": "cuda", "source": "nw_tpu_torch/csrc/nw_single.cu",
                "replaces": "nw_tpu/ops/fill_pallas_banded.py:342",
                "launches": cli_launches["nw_fill_masks"], "max_abs_err": errs["nw_fill_masks"],
                "ms": cli_times["fm_ms"], "plain_ms": cli_times["plain_fm_ms"],
                "shape": f"1x{L_LONG}bp masks+count",
            },
            {
                "name": "nw_score_count", "route": "cuda", "source": "nw_tpu_torch/csrc/nw_single.cu",
                "replaces": "nw_tpu/ops/fill_pallas_single.py:250",
                "launches": cli_launches["nw_score_count"], "max_abs_err": errs["nw_score_count"],
                "ms": cli_times["sc_ms"], "plain_ms": single["plain_sc_ms"],
                "shape": f"1x{L_HUGE}bp score+count (plain_ms at {L_CROSS}x{L_CROSS}bp, "
                         f"kernel there {single['sc_ms_cross']:.3f} ms)",
            },
        ]
    }
    log(json.dumps(record))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
