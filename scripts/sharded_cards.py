"""BASELINE config 5 on a host with a card for each rank: one random
100 000 x 100 000 pair through ``huge_pair_align_sharded`` on NCCL
ranks, against ``NWAligner.align_huge`` on card 0, at several chunk
widths: the comparison behind ``tile_chunk``'s rule.

    python3 scripts/sharded_cards.py [RANKS ...]     (default: 4 2)

First, on card 0, for each number of ranks and each candidate number of
column chunks: the device time of one ``nw_fill_tile`` (codes mode) of
that rank count's tile shape, rank 0's first tile with its real edges
(mean of 3 after a warm-up, CUDA events), and the fill that a card a
rank would take by the pipeline's count, ``nphases`` such tiles in a
row.  Then, for each number of ranks the host has cards for, a
``RankGroup`` on NCCL runs the alignment at each candidate chunk (three
times; the group's first call pays NCCL's communicators and the
kernels' loading), checks every rank's ops and score against
``align_huge``'s, and prints the wall and each rank's fill, halo
staging, waits, walk and stitch seconds and peak device memory; then
``huge_pair_score_sharded`` at the default chunk and the ranks' tile and
walk launch counts.  Exits 1 on any difference.  Scoring 2 1 1; the
pair is ``chip_smoke.py``'s 100 000 bp pair.  The candidates: 1, 2, 3,
4, 6 and 8 chunks, ``tile_chunk``'s, and the 87.5%-of-phases rule of
``nw_tpu``'s ``auto_chunk``.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams  # noqa: E402
from nw_tpu_torch.ops import encode as enc  # noqa: E402
from nw_tpu_torch.ops import fill_single as fs  # noqa: E402
from nw_tpu_torch.ops import traceback as tb  # noqa: E402
from nw_tpu_torch.ops.fill_scan import code_shape  # noqa: E402
from nw_tpu_torch.parallel import huge_pair as hp  # noqa: E402
from nw_tpu_torch.parallel.workers import MESH, RankGroup, launch_counts  # noqa: E402

L = 100_000
COUNTERS = [("nw_tpu_torch.ops.fill_single", "fill_tile", "launches"),
            ("nw_tpu_torch.ops.traceback", "walk_codes_window", "launches")]


def width(nch: int) -> int:
    """The chunk, a multiple of 32 columns, that cuts L into ``nch``."""
    return max(32, (-(-L // nch) + 31) // 32 * 32)


def chunks(world: int) -> list:
    """The candidate chunk widths at ``world`` ranks, widest first."""
    eighths = 7 * (world - 1)  # the least nch with nch / (nch + world - 1) >= 7/8
    widths = {hp.tile_chunk(L, L, world), width(max(eighths, 1))}
    widths |= {width(n) for n in (1, 2, 3, 4, 6, 8)}
    return sorted(widths, reverse=True)


def tile_ms(top, side, world: int, C: int) -> float:
    """Device ms of rank 0's first tile at ``world`` ranks, chunk ``C``."""
    H = -(-L // world)
    halo = torch.arange(0, -(C + 1), -1, dtype=torch.int32, device="cuda")
    left = torch.arange(-1, -(H + 1), -1, dtype=torch.int32, device="cuda")
    codes = torch.zeros(code_shape(1, L, H), dtype=torch.int32, device="cuda")
    call = lambda: fs.fill_tile(top, side[:H], 2, 1, 1, 0, C, halo, left, codes)  # noqa: E731
    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 3


def main() -> None:
    worlds = [int(x) for x in sys.argv[1:]] or [4, 2]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print("cards", torch.cuda.device_count(), "torch", torch.__version__, flush=True)
    rng = np.random.default_rng(L)
    letters = np.frombuffer(b"ACGT", np.uint8)
    pair = tuple(letters[rng.integers(0, 4, L)].tobytes() for _ in range(2))
    aligner = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")
    for rep in range(3):
        t0 = time.perf_counter()
        ref = aligner.align_huge(*pair)
        print(f"align_huge run {rep}: {time.perf_counter() - t0:.4f} s, score {ref.score}", flush=True)
    top, side = (torch.from_numpy(enc.encode(x)).cuda() for x in pair)
    for world in worlds:
        for C in chunks(world):
            H, nch, nphases = hp.tile_geometry(L, L, world, C)
            ms = tile_ms(top, side, world, C)
            print(f"tile {world} ranks, chunk {C} ({nch} chunks, {nphases} phases): one tile "
                  f"{H} x {C} {ms:.3f} ms; a card a rank by the count: fill "
                  f"{nphases * ms:.1f} ms; steps (nphases x (2H + C)) {nphases * (2 * H + C)}",
                  flush=True)
            torch.cuda.empty_cache()
    del top, side
    torch.cuda.empty_cache()
    for world in worlds:
        if world > torch.cuda.device_count():
            print(f"{world} ranks: {torch.cuda.device_count()} card(s), not run", flush=True)
            continue
        t0 = time.perf_counter()
        with RankGroup(world, "nccl", "cuda", timeout=300) as group:
            print(f"{world} NCCL ranks started in {time.perf_counter() - t0:.1f} s", flush=True)
            group.run(launch_counts, COUNTERS, reset=True)
            for C in chunks(world):
                for rep in range(3):
                    t0 = time.perf_counter()
                    res = group.run_timed(hp.huge_pair_align_sharded, enc.encode(pair[0]),
                                          enc.encode(pair[1]), 2, 1, 1, MESH, chunk=C, timeout=600)
                    wall = time.perf_counter() - t0
                    ok = all(tb.ops_to_strings(r.ops, r.n, *pair) == (ref.X, ref.Y)
                             and r.score == ref.score for r, _, _ in res)
                    print(f"{world} ranks, chunk {C}, run {rep}: "
                          f"{'equal to align_huge' if ok else 'DIFFERENT'}, wall {wall:.4f} s; " +
                          "; ".join(
                              f"rank {p}: fill {r.timings['fill']:.4f} (halo staging "
                              f"{r.timings['halo']:.4f}, waiting {r.timings['halo_wait']:.4f}), "
                              f"walk {r.timings['walk']:.4f}, stitch {r.timings['stitch']:.4f} s, "
                              f"peak {peak / 2**30:.2f} GiB" for p, (r, _, peak) in enumerate(res)),
                          flush=True)
                    if not ok:
                        sys.exit(1)
            scores = group.run(hp.huge_pair_score_sharded, enc.encode(pair[0]), enc.encode(pair[1]),
                               2, 1, 1, MESH, timeout=600)
            print(f"scores {scores}, launches (tile, walk) {group.run(launch_counts, COUNTERS)}",
                  flush=True)
            if scores != [ref.score] * world:
                sys.exit(1)


if __name__ == "__main__":
    main()
