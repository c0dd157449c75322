"""Smoke run of nw_tpu_torch's batched aligner on one NVIDIA card.

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
   card's name and power limit.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib.util
import json
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
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
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
