"""Smoke run of nw_tpu_torch on one NVIDIA card: the batched aligner,
the byte-parity CLI, the variant models, the batch CLI, the sharded
runs, the tie-mask routes, Hirschberg, the runs walk engine and the
flat-fill API.

    python3 chip_smoke.py

Phases, in order; any mismatch or exception exits non-zero:

1. the card (nvidia-smi name and power limit), torch / CUDA / Triton;
2. build the CUDA kernels from nw_tpu_torch/csrc (seconds printed);
3. every kernel bit for bit against its plain PyTorch version on the card:
   64 random pairs of 0-700 bp, tie-dense two-letter pairs and the edge
   pairs, under the scorings (2,1,1), (1,1,1), (0,0,0), (3,-1,2) and,
   where the int32 arithmetic wraps, (1,1,2^30), (1,2^30,1) and
   (2^31-1,-2^31,2^30) (``SCORINGS``; phases 6, 8, 9 and 10 use them too);
   ``nw_scores`` and ``nw_fill_codes`` (counts, codes, codes + counts) at
   every W of ``PIPE_WARPS`` warps a pair and at the rule's W;
4. the main path, ``NWAligner(...).align_batch``, with every launch
   counter set to 0 first: config 3 (256 random 10240 bp pairs, strings
   and counts; each alignment re-scored on the host, 4 pairs against the
   plain path on the card), then config 2 (10240 x 150 bp, scores only,
   all against the plain path) and 128 x 10240 bp scores only; every
   kernel must have launched;
5. wall times (median of 4 warm runs), pairs/s and GCUPS of the
   configs, and each kernel's time beside its plain version's, with the
   card's name and power limit; the pipeline's shared memory, its time
   at W = 1 against the rule's W in turns (1, rule, rule, 1) at config
   3's fill, 128 x 10 240 bp scores, 4 x 10 240 bp codes + counts,
   config 2's scores and scores + counts, K5's and K7's shapes (outputs
   equal at both W), and the sweep of W (``SWEEP_WARPS``) at config 3
   and 128 x 10 240 bp;
6. the single-pair kernels (``nw_score_count``, ``nw_fill_masks``) bit
   for bit against their plain versions, one pair at a time: 24 random
   pairs of 0-700 bp, tie-dense pairs, the edge pairs and all-'A'
   24 x 16 (the count wraps), under every scoring; ``nw_score_count`` on
   a 20 000 x 20 000 pair (above 2^28 cells) against its plain version
   and ``nw_fill_codes`` counts-only; the time of both kernels of the
   single-pair pipeline (``nw_score_count``, ``nw_fill_codes_single``)
   at the rule's W and each W of ``SINGLE_SWEEP`` at 20 000 and 100 000
   bp;
7. the CLI (``python3 -m nw_tpu_torch``, the native runtime built from
   nw_tpu_torch/runtime/cc): goldens of tests/test_cli.py as subprocesses;
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

8. huge pairs: (a) the single-pair modes ``nw_fill_codes_single`` (K14,
   and K13 from a seed row, a block a launch), ``nw_refill_blocks`` (K13,
   every block of a pair in one launch, and from the second block on),
   ``nw_score_single`` (K11, and K12 dumping checkpoint rows) and
   ``nw_walk_window`` bit for bit against their plain versions (24 random
   pairs of 0-700 bp, tie-dense pairs, the edge pairs, every scoring, 1
   to 8 warps and several blocks), the codes also against
   ``nw_fill_codes`` at B = 1; ``nw_refill_blocks`` over every block of a
   4 096 bp pair (C = 128) at its default launch and at 2 blocks of 3
   warps against its plain version under every scoring; then, with every
   launch counter set to 0, (b) ``align_huge`` on both routes at 10 240 bp
   against ``align(...).best_alignment()``, (c) a random 100 000 x
   100 000 bp pair on both routes (identical strings that spell both
   inputs and re-score to the reported, ``summary_huge``'s and
   ``score_fold``'s score), (d) ``align_batch`` of 2 x 100 000 bp pairs
   with strings and counts and scores only; every new kernel must have
   launched; (c') a 200 000 bp pair on ``align_huge``'s default route
   (checkpointed: its codes pass the 8 GiB budget) equal to the codes
   route under a raised budget, both walls; each mode against its plain
   version at the sizes (b) and (c) run: on both 10 240 bp pairs (ACGT,
   and the tie-dense AC) at ``align_huge``'s block size there (whole-pair
   codes, checkpoint rows, score, a middle block re-filled from the
   kernel's checkpoint, every block in one launch, the chained window
   walks), the score at 20 000 bp, a 1 280-row block (the 100 000 bp
   path's height) of the pair's 20 000 bp prefixes re-filled from the
   kernel's checkpoint, and at 100 000 bp every block of the one-launch
   group against the one-block launches and the 79 chained window walks
   over it (ending at the origin after ``nw_walk``'s steps); (e) times:
   ``align_huge`` walls, the kernels apart, the 79 refills one block a
   launch against all in one launch in turns and the sweep of blocks a
   launch (``REFILL_GROUPS``), the scores-only crossover of ``nw_scores``
   (a block a pair) against ``score_fold``, peak device memory.

9. Smith-Waterman: (a) ``sw_scores`` (at the rule's W and every W of
   ``PIPE_WARPS``), ``sw_fill_codes`` (codes, best, argmax) and
   ``sw_walk`` bit for bit against their plain versions (40 random pairs
   of 0-60 bp and 48 of 0-700 bp, tie-dense pairs, the edge pairs, equal
   bests in two bands, under ``SW_SCORINGS``: ``SCORINGS`` and
   (1,1,-1)); then, with every launch counter set to 0, (b)
   ``sw_align_batch`` of 128 x 3 072 bp (bench.py:414) and 4 096 x 150 bp
   (bench.py:291), ``sw_score_batch`` of 10 240 x 150 bp (bench.py:517)
   and 128 x 10 240 bp (bench.py:583), all at (2,1,1): every alignment
   spells ``s1[i_end:i*]`` / ``s2[j_end:j*]`` and re-scores to its best,
   every score equals ``sw_fill_codes``'s best, 4 pairs of each batch
   equal the plain path on the card, every new kernel has launched; (c)
   walls (median of 4 warm runs), pairs/s, GCUPS, each kernel's time
   beside its plain version's and its bound, ``sw_scores`` at W = 1
   against the rule's W in turns (1, rule, rule, 1) at 128 x 10 240 bp
   and 10 240 x 150 bp (scores equal at both W) and the sweep of W
   (``SWEEP_WARPS``) at 128 x 10 240 bp.

10. Overlap and Gotoh scores: (a) ``overlap_scores`` and ``gotoh_scores``
   (each at the rule's W and every W of ``PIPE_WARPS``),
   ``overlap_fill_codes`` (codes, best, end cell) with ``sw_walk`` on its
   codes bit for bit against their plain versions (phase 9's pairs and a
   pair whose best lies on the last column in band 0 and on the last row
   in band 2; overlap under phase 9's scorings, Gotoh under (2,1,3,1),
   (1,1,1,1), (0,0,0,0), (3,-1,2,1), (2,1,1,3), (1,1,-1,-1) and
   (1,1,2^28,2^28)); then, with every launch counter set
   to 0, (b) ``overlap_align_batch`` of 128 x 3 072 bp and 4 096 x 150 bp,
   ``overlap_score_batch`` of 10 240 x 150 bp and 128 x 10 240 bp, at
   (2,1,1), and ``affine_score_pairs`` of 10 240 x 150 bp and 128 x
   10 240 bp at (2,1,3,1): every alignment spells ``s1[i_start:i_end]`` /
   ``s2[j_start:j_end]``, starts on row 0 or column 0, ends on the last
   row or column and re-scores to its best, its best and end cell are
   ``overlap_fill_codes``'s, every overlap score equals its best, the
   150 bp scores all and 4 pairs of every other batch equal the plain
   path on the card, every new kernel and ``sw_walk`` has launched; and
   ``affine_score_pairs(..., 2, 1, 1, 1)`` of the 10 kb pairs equals
   ``align_batch``'s scores at (2,1,1) (open == extend, k < 2 open: the
   linear score); (c) walls (median of 4 warm runs), pairs/s, GCUPS, each
   kernel's time beside its plain version's and its bound, and
   ``overlap_scores``' and ``gotoh_scores``' turns and sweeps of W as
   phase 9's.

11. Gotoh tracebacks and the batch CLI: (a) ``gotoh_fill_codes`` (4-bit
   codes, scores, corner states; the scores also against
   ``gotoh_scores``; at the rule's W and every W of ``PIPE_WARPS``) and
   ``gotoh_walk`` (on each W's codes) bit for bit against their plain
   versions (phase 9's pairs and the edge pairs, under phase 10's seven
   Gotoh scorings, (3,1,4,0) and (1,1,1,2^29)); then, with every launch
   counter set to 0, (b) ``affine_align_batch`` of 128 x 3 072 bp
   (bench.py:414) and 4 096 x 150 bp (bench.py:291) at (2,1,3,1): every
   alignment spells both inputs and re-scores on the host (affine gap
   costs in Python ints) to its score, every score equals
   ``affine_score_pairs``'s, 4 pairs of each batch equal the plain path on
   the card, both kernels have launched; ``nw-tpu-torch-batch``
   (``batch_cli.main``) on a 30-pair file in all four modes, with
   ``--counts`` / ``--alignments``, plain and resumed through
   ``--checkpoint-dir``, byte-equal to ``NW_TPU_PLATFORM=cpu``, and
   ``python3 -m nw_tpu_torch.batch_cli`` once; (c) walls (median of 4
   warm runs), pairs/s, GCUPS, each kernel's time beside its plain
   version's and its bound, the walk's ns a step, ``gotoh_fill_codes`` at
   W = 1 against the rule's W in turns at 128 x 3 072 bp and 4 096 x
   150 bp and the sweep of W at 128 x 3 072 bp, and the host
   ``ops_to_strings_batch``, native against numpy, at config 3 and at
   4 096 x 150 bp.

12. Sharded runs (``nw_tpu_torch.parallel``), with ranks as child
   processes (``RankGroup``: 1 rank on NCCL, 2 and 4 ranks on gloo
   sharing the card), started while (a) runs: (a) ``nw_fill_tile`` in its
   codes, scores and masks modes (K14's mesh half, K28) chained in one
   process over 4 row blocks x 5 chunks of a 3 000 bp pair, under every
   scoring against the whole pair's ``nw_fill_codes_single`` codes and
   corner and ``nw_fill_masks`` masks, and at (2,1,1) tile by tile
   against the plain tile (on the host CPU); 7 pairs of 1-160 bp and the
   edge pairs in 4 blocks x chunks of 45 columns against the plain tile
   under every scoring; ``nw_walk_window``'s masks mode relayed over
   each pair's blocks against its plain version and ``nw_walk``; then,
   with every rank's launch counters set to 0, (b)
   ``huge_pair_align_sharded`` (twice: cold, as a rank's first launch of
   a kernel loads it, and warm) and ``huge_pair_score_sharded`` on phase
   8's 100 000 x 100 000 pair at (2,1,1) on 1 rank (NCCL) and 2 ranks
   (gloo, one card), equal to ``align_huge``'s codes route byte for
   byte, and ``engine="pallas"`` on its 20 000 bp prefixes on 4 ranks,
   equal to ``align_huge`` there; (c) ``align_batch_sharded`` of
   10 240 x 150 bp with and without counts on 1 and 2 ranks, equal to
   ``align_batch`` with exact statistics; every kernel of the path must
   have launched in some rank; the walls, each rank's fill (of which
   staging and posting halos, and waiting for them), walk and stitch
   seconds and peak device memory; (d) each tile mode on one tile of the
   path's shape (rank 0's first, as ``tile_chunk`` cuts it, with row 0
   and column 0 as its edges: codes and scores at 2 ranks and 100 000 bp,
   masks at 4 ranks and 20 000 bp) against the plain tile on the same
   inputs on the card (both edges, the corner and the table), the mask
   walk's 20 000 bp relay against the plain relay (ops and final state),
   each timed; the 1-rank path's one tile (the whole 100 000 bp pair)
   against ``nw_fill_codes_single`` (codes and corner), both timed (the
   ``nw_fill_tile`` record's ``one_rank_tile_ms`` and
   ``fill_codes_single_ms``).

13. The tie-mask routes and Hirschberg: (a) ``nw_fill_masks_batch`` (K2's
   batched tie masks, with and without counts), ``nw_count_masks`` (K6,
   at the rule's W and at every W of ``COUNT_WARPS``), ``nw_walk_masks``, ``nw_fill_masks`` a pair at a time
   (``fill_arrows_fold_batch``, K10) and ``nw_last_row`` (K9, rows 0,
   len2/3 and len2) bit for bit against their plain versions under every
   scoring (30 random and tie-dense pairs of 0-700 bp, the edge pairs,
   all-'A' 24 x 16); then, with every launch counter set to 0,
   (b) ``fill_arrows_auto`` + count + walk + host strings at 10 240 x
   150 bp and 128 x 2 048 bp and (c) at 4 x 10 240 bp (the pair-at-a-time
   route): every alignment re-scores to its score, scores and counts
   equal ``nw_fill_codes``'s, every pair (one 10 240 bp pair) against the
   plain path on the card; (d) ``align_batch`` with strings and counts of
   4 x 10 240 bp, 16 x 4 096 bp and more small batches of long pairs on
   the mask route and the codes route, outputs equal, both timed (median
   of 3 warm runs, in turns); (e) ``hirschberg_align`` of phase 8's
   100 000 bp pair (spells both inputs, re-scores to ``summary_huge``'s
   score; wall, host leaves' share) and of a 10 240 bp pair, on the card
   against ``device="cpu"`` (run in a process of its own meanwhile) byte
   for byte, and ``nw_last_row`` against ``fill_last_row`` on the card at
   the top-level split of the 10 240 and 20 000 bp pairs; every new
   kernel must have launched; ``nw_count_masks`` at one warp a pair
   against the rule's W in turns (1, W, W, 1) at 4 x 10 240 bp, 128 x
   2 048 bp and 1 024 x 256 bp, and the sweep of W (``COUNT_SWEEP``);
   each kernel's time beside its plain version's and its bound.

14. The runs walk engine and the flat-fill API: (a) ``nw_fill_runs_batch``
   (the ``RUNS`` mode of ``nw_fill_kernel``, K2's ``with_runs``, with and
   without counts) and ``nw_walk_runs`` bit for bit against their plain
   versions under every scoring, on phase 3's pairs and identical 700 bp
   pairs (diagonal runs past the 63 cap and across bands), the run walk's
   ops also against ``nw_walk``'s; then, with every launch counter set to
   0, (b) ``align_batch`` of config 3 (256 x 10 240 bp, strings and
   counts, two sub-batches of run bytes) and of 128 x 3 072 bp under
   ``NW_TPU_WALK_ENGINE=runs``: scores, counts, ops and strings equal the
   codes engine's byte for byte, every alignment re-scores to its score,
   both runs kernels launched and no codes kernel; (d) config 3's wall on
   both engines (median of 3 warm runs, in turns), the runs fill at
   config 3 (two launches) beside ``nw_fill_codes`` (one launch, and both
   at 128 x 10 240 bp in turns), the run walk beside ``nw_walk`` with its
   dependent loads a pair against ``nw_walk``'s steps, both kernels
   against their plain versions on the first config-3 pair; (c) with the
   serving wrappers' counters from 0, ``ops/fill_flat.py`` at K26's shape
   (10 240 x 150 bp scores and counts), K27's (masks with and without
   counts, and K6's count over them, at 1 024 x 256 bp and 128 x 2 048 bp)
   and K7's (1 024 x 256 bp scores) against its plain versions and the
   serving kernels' wrappers on the same inputs, and K5's shape (4 096 x
   150 bp strings through ``align_batch``, ``nw_fill_codes`` + ``nw_walk``
   against plain); each shape's kernel time, bound and plain time.

Phase 2 also prints ``ptxas -v`` of ``nw_fill.cu``, ``nw_walk.cu``,
``nw_affine.cu``, ``nw_single.cu`` and ``nw_count.cu``: registers, static
shared memory and spills of every instantiation, the ``RUNS`` mode's
(template mode 4) and the pipeline's (``nw_fill_pipe_kernel``) among
them; the pipeline's dynamic shared memory is printed in phase 5.

Each kernel's ``bound_ms`` is the larger of its int32 operations (per
cell: 7 for a score, 8 more for a count, 6 more for a 2-bit code or a
tie mask, 2 more for the local clamp and running best, 3 more for the
local argmax and STOP, 4 more for overlap's end window and running best
(the scores' bound charges them to the window's len1 + len2 cells a
pair, the function's work; the codes' to every cell), 2 more for its
argmax; 10 for a Gotoh score, 12 more for its 4-bit code
(``OPS_GOTOH_CODE``); 9 more than a code for a run byte (``OPS_RUN``);
12 a walk step, or a run walk's load) over the card's SMs x 64 INT32
lanes x ``clocks.max.sm``, and its bytes (inputs read once, outputs
written once) over 3.35 TB/s.  The last lines before the record give
the script's total seconds.

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

# ordinary scorings, and scorings whose arithmetic wraps int32
SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2), (1, 1, 2**30), (1, 2**30, 1),
            (2**31 - 1, -(2**31), 2**30)]
EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"A", b"A"), (b"GCATGCU", b"GATTACA")]
L_LONG = 10240  # bench.py:231 bench_config3 / bench.py:127 banded scores
L_SHORT = 150  # BASELINE config 2
L_HUGE = 100_000  # BASELINE config 5's pair length
L_CROSS = 20_000  # (L+1)^2 > 2^28: past nw_tpu's huge-route threshold
SINGLE_SWEEP = (4, 8, 12, 16, 24, 32)  # phase 6: the single-pair pipeline's sweep of W
CROSSOVER = (1024, 2048, 4096, 10240, L_HUGE)  # scores of 2, 8, 23 pairs: K1 vs K11 route
# int32 operations a cell (or a walk step) of each kernel mode, for the bound
OPS_SCORE, OPS_COUNT, OPS_CODE, OPS_WALK_STEP = 7, 8, 6, 12
# the run byte, beyond the code, as the function needs it (the kernel
# computes both predecessors' bytes and picks one, 12 ops, to keep them off
# the score's chain): the predecessor's byte picked by the diag compare
# (select), its code bits matched to the code (and, compare), one cell more
# under the 63 cap (compare, add, select), a run of one where they differ
# (or, select), up's byte where the code is up (select)
OPS_RUN = 9
OPS_LOCAL, OPS_ARGMAX = 2, 3  # Smith-Waterman: clamp + running best; kk select + STOP
# overlap: the end window's two compares, the score compare and the
# running best's select; the kk add and its select (no per-cell STOP)
OPS_OVERLAP, OPS_OVERLAP_ARGMAX = 4, 2
# Gotoh: the substitution's compare and select, M's add, one M - open
# (IX's and IY's open alike), an extend subtract and a max each for IX
# and IY, two maxes for best
OPS_GOTOH = 10
# Gotoh's codes: the argmax state's two compares and two selects, the
# extend bits' two compares, the code's two shifts and two ors, the
# pack's shift and or (the padded sweep's guards are not the function's)
OPS_GOTOH_CODE = 12
GOTOH_SCORINGS = [(2, 1, 3, 1), (1, 1, 1, 1), (0, 0, 0, 0), (3, -1, 2, 1), (2, 1, 1, 3),
                  (1, 1, -1, -1), (1, 1, 2**28, 2**28)]
# phase 11: the alignments' scorings (tests/test_variants_pallas.py:103 adds
# 3 1 4 0) and a second one near the sentinel
GOTOH_ALIGN_SCORINGS = [*GOTOH_SCORINGS, (3, 1, 4, 0), (1, 1, 1, 2**29)]
# overlap's best 40 (2 1 1) on the last column in band 0, (j, i) = (20, 80),
# and on the last row in band 2, (70, 20): the later band's earlier diagonal wins
OVERLAP_TWO_BANDS = (b"C" * 20 + b"G" * 40 + b"A" * 20, b"A" * 20 + b"T" * 30 + b"C" * 20)
SW_SCORINGS = [*SCORINGS, (1, 1, -1)]
L_SW_TB = 3072  # bench.py:414 bench_variant_tracebacks: 128 x 3 072 bp
SW_EDGE = [
    (b"", b""), (b"ACGT", b""), (b"", b"ACGT"), (b"AAAA", b"TTTT"), (b"A" * 40, b"A" * 70),
    # equal bests in band 0 on diagonal 60 and in band 1 on diagonal 53
    (b"T" * 10 + b"C" * 30 + b"A" * 10 + b"C" * 10, b"A" * 10 + b"G" * 23 + b"T" * 10 + b"G" * 2),
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT32_LANES_PER_SM = 64
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


def variant_pairs(seed, extra=()):
    """Phases 9-11's check pairs: 40 random of 0-60 bp, 48 of 0-700 bp, 8
    tie-dense two-letter pairs of 100-400 bp, the edge pairs."""
    rng = np.random.default_rng(seed)
    return (
        rand_pairs(rng, 40, 0, 60) + rand_pairs(rng, 48, 0, 700)
        + rand_pairs(rng, 8, 100, 400, b"AC") + SW_EDGE + list(extra)
    )


def max_abs_err(got, want) -> int:
    """Largest |got - want| over integer outputs (codes compared as
    uint32 words)."""
    g = got.to(torch.int64).cpu()
    w = want.to(torch.int64).cpu()
    if g.shape != w.shape:
        fail(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    if got.dtype == torch.int32 and got.dim() >= 3:
        g, w = g & 0xFFFFFFFF, w & 0xFFFFFFFF
    return int((g - w).abs().max()) if g.numel() else 0


def cuda_once(fn):
    """(``fn()``, the device ms of that one run by CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up,
    by CUDA events; ``reps`` 0 times the one run itself."""
    if reps == 0:
        return cuda_once(fn)[1]
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


class Bound:
    """The least time the card could take for a kernel's work: the larger
    of its int32 operations over every SM's INT32 lanes at the highest SM
    clock and its bytes over the HBM rate."""

    def __init__(self, sms: int, clock_hz: float):
        self.ops_per_s = sms * INT32_LANES_PER_SM * clock_hz

    def __call__(self, ops: float, nbytes: float) -> dict:
        t_ops, t_bytes = ops / self.ops_per_s, nbytes / HBM_BYTES_PER_S
        return {
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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
    log(f"nw_score_count {L_CROSS}x{L_CROSS}bp plain version: {plain_sc_ms:.1f} ms [{card}]")
    # the sweep of W (warps a block, blocks by the rule) of both kernels of
    # the single-pair pipeline; the rule's W (None) first and last
    sweep = {}
    big = rand_pairs(np.random.default_rng(L_HUGE), 1, L_HUGE, L_HUGE)[0]  # phase 7's and 8's pair
    for L, (t, s) in ((L_CROSS, (tb_[0], sb_[0])),
                      (L_HUGE, tuple(torch.from_numpy(enc.encode(x)).to(dev) for x in big))):
        for name, fn in (("nw_score_count", fs.score_count_fold),
                         ("nw_fill_codes_single", fs.fill_codes_single)):
            for warps in (None, *SINGLE_SWEEP, None):
                sweep.setdefault((name, L, warps), []).append(
                    cuda_ms(lambda: fn(t, s, 2, 1, 1, warps=warps), 1))
            rule = fs.pipe_shape(L, L, dev)
            log(f"{name} {L}x{L}bp by W (blocks by the rule; the rule: {rule[0]} blocks x {rule[1]} "
                f"warps): { {w or 'rule': [round(x, 3) for x in ms] for (n, l, w), ms in sweep.items() if (n, l) == (name, L)} } "
                f"ms [{card}]")
    return {"plain_sc_ms": plain_sc_ms, "sc_ms_cross": min(sweep["nw_score_count", L_CROSS, None])}


def cli_phase(card, errs):
    """Phase 7: the CLI.  Returns (launches per new kernel, walls, the
    time of each new kernel at its full CLI shape); ``nw_fill_masks``
    against its plain version at 10 kb goes into ``errs``."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.runtime import native

    if native.load() is None:
        fail("the native runtime (nw_tpu_torch/runtime/cc) did not build or load")
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
        walls[f"nw_fill_codes_counts_{L}"] = time.perf_counter() - t0
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


# the single-pair modes of phase 8: record name -> (wrapper, counter attribute)
HUGE_KERNELS = {
    "nw_fill_codes_single": ("fill_codes_single", "launches"),  # K14
    "nw_refill_blocks": ("fill_codes_blocks", "launches"),  # K13, G blocks a launch
    "nw_score_single": ("score_fold", "launches"),  # K11
    "nw_score_single/ckpt": ("score_fold", "ckpt_launches"),  # K12
    "nw_walk_window": ("walk_codes_window", "launches"),
}
SEEDED = "nw_fill_codes_single/seeded"  # K13 a block a launch: the grouped re-fill's yardstick
L_REFILL, C_REFILL = 4096, 128  # phase 8: the grouped re-fill of every block vs plain
L_HUGE2 = 200_000  # phase 8: a pair whose codes pass align_huge's 8 GiB budget
REFILL_GROUPS = (1, 4, 16, 40)  # phase 8's sweep of G at 100 kb (and all blocks)


def against_plain(name, kern, plain, errs):
    """One kernel call's outputs against its plain version's on the same
    inputs, max |diff| into ``errs[name]``; returns (kernel outputs,
    the plain version's device ms)."""
    got = kern()
    want, ms = cuda_once(plain)
    e = max(max_abs_err(g, w) for g, w in zip(got, want) if w is not None)
    errs[name] = max(errs.get(name, 0), e)
    return got, ms


def walk_chain(walk, chain, len1, len2):
    """(state, ops) of ``walk`` (``walk_codes_window`` or its plain
    version) chained over ``chain``, (r0, codes) of every block, last
    block first, as ``traceback_checkpointed`` walks them."""
    from nw_tpu_torch.ops.traceback import OP_NONE

    dev = chain[0][1].device
    state = torch.tensor([len1, len2, 0], dtype=torch.int32, device=dev)
    ops = torch.full((len1 + len2,), OP_NONE, dtype=torch.int8, device=dev)
    for r0, codes in chain:
        walk(codes, state, r0, ops)
    return state, ops


def modes_vs_plain_10k(pair, C, errs, plain):
    """Phase 8: K14, K12, K11, K13 and the window walk against their
    plain versions on a 10 240 bp pair at ``align_huge``'s block size C
    there, m k d = 1 1 1 as in (b): the whole pair's codes and corner,
    the score and the checkpoint rows, the middle block re-filled from
    the kernel's checkpoint row, and the chained walks over every block
    the kernel re-filled.  With ``plain`` a dict, each plain version's
    ms and the kernel's there go into it."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops import traceback as tb

    t, s = (torch.from_numpy(enc.encode(x)).cuda() for x in pair)
    L1, L2 = len(pair[0]), len(pair[1])
    kw_ck = {"checkpoint_every": C}
    runs = {
        "nw_fill_codes_single": (fs.fill_codes_single, fs.fill_codes_single_plain, {}),
        "nw_score_single/ckpt": (fs.score_fold, fs.score_fold_plain, kw_ck),
    }
    for name, (kern, plain_fn, kw) in runs.items():
        got, ms = against_plain(
            name, lambda: kern(t, s, 1, 1, 1, **kw), lambda: plain_fn(t, s, 1, 1, 1, **kw), errs
        )
        if plain is not None:
            kern_ms = cuda_ms(lambda: kern(t, s, 1, 1, 1, **kw), 2)
            plain[name] = (ms, f"{L1}x{L2}bp, m k d = 1 1 1", kern_ms)
    score, ck = got
    errs["nw_score_single"] = max(
        errs["nw_score_single"], max_abs_err(fs.score_fold(t, s, 1, 1, 1)[0], score)
    )
    blocks = [(r0, min(L2, r0 + C)) for r0 in range(0, L2, C)]
    r0, r1 = blocks[len(blocks) // 2]
    kw = {"len2": r1, "r0": r0, "seed": ck[r0 // C]}
    against_plain(
        SEEDED, lambda: fs.fill_codes_single(t, s, 1, 1, 1, **kw),
        lambda: fs.fill_codes_single_plain(t, s, 1, 1, 1, **kw), errs,
    )
    # every block in one launch, as traceback_checkpointed re-fills them
    kw = {"len1": L1, "len2": L2, "r0": 0, "C": C, "seeds": ck}
    (codes, _), _ = against_plain(
        "nw_refill_blocks", lambda: fs.fill_codes_blocks(t, s, 1, 1, 1, **kw),
        lambda: fs.fill_codes_blocks_plain(t, s, 1, 1, 1, **kw), errs,
    )
    chain = [(r0, codes[:, r0 // 32 : -(-r1 // 32)]) for r0, r1 in blocks[::-1]]
    (st, _), _ = against_plain(
        "nw_walk_window", lambda: walk_chain(tb.walk_codes_window, chain, L1, L2),
        lambda: walk_chain(tb.walk_codes_window_plain, chain, L1, L2), errs,
    )
    if st[:2].tolist() != [0, 0]:
        fail(f"the chained window walks at {L1}x{L2} bp stopped at {st.tolist()}")


def huge_modes_vs_plain(dev, errs):
    """Phase 8 (a): every single-pair mode bit for bit against its plain
    version on the card, several launch shapes; the plain versions' body
    (fill_diag) runs on every pair at once, each mode's output is cut
    from it."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.ops.fill_scan import (
        diag_to_matrix, fill_diag_batch, greedy_codes_from_arrows, matrix_to_diag,
    )

    def block_codes(masks, r0, r1):  # greedy codes of rows r0+1 .. r1
        return greedy_codes_from_arrows(matrix_to_diag(masks[r0 : r1 + 1])[None])

    def lens(x):
        return torch.tensor([x], dtype=torch.int32, device=dev)

    rng = np.random.default_rng(8)
    pairs = (
        rand_pairs(rng, 24, 0, 700) + rand_pairs(rng, 6, 100, 400, b"AC") + EDGE
        + [(b"A" * 24, b"A" * 16)]
    )
    L1 = max(len(a) for a, _ in pairs)
    L2 = max(len(b) for _, b in pairs)
    tops, sides, l1, l2 = enc.upload(enc.encode_batch(pairs, L1, L2), dev)
    # (blocks, warps): warps 1, 3 and 8 with blocks for every band, one
    # block of 8 warps, and 5 blocks of 2 warps (several bands a warp)
    shapes = [(None, 1), (None, 3), (None, 8), (1, 8), (5, 2)]
    for mkd in SCORINGS:
        ref = fill_diag_batch(tops, sides, l1, l2, *mkd, with_scores=True)
        e = dict.fromkeys([*HUGE_KERNELS, SEEDED], 0)
        e_batch = 0
        for b, (s1, s2) in enumerate(pairs):
            la, lb = len(s1), len(s2)
            top, side = tops[b, :la], sides[b, :lb]
            masks = diag_to_matrix(ref["arrows"][b], la, lb)
            hs = diag_to_matrix(ref["scores"][b], la, lb)
            score = int(ref["score"][b])
            full = block_codes(masks, 0, lb)
            blocks_of = {
                C: [(r * C, min(lb, r * C + C)) for r in range(-(-lb // C))] for C in (32, 64)
            }
            want_blocks = {
                (r0, r1): (block_codes(masks, r0, r1), int(hs[r1, la]))
                for bl in blocks_of.values() for r0, r1 in bl
            }
            # the K2 port at B = 1 writes the same codes
            batch = fb.fill_greedy_counts_banded_batch(top[None], side[None], lens(la), lens(lb), *mkd)
            e_batch = max(e_batch, max_abs_err(batch[0], full), abs(int(batch[1][0]) - score))
            ops_w, n_w = tb.walk_codes_batch(batch[0], lens(la), lens(lb), max(la + lb, 1))
            for blocks, warps in shapes:
                kw = {"warps": warps, "blocks": blocks}
                codes, sc = fs.fill_codes_single(top, side, *mkd, **kw)
                e["nw_fill_codes_single"] = max(
                    e["nw_fill_codes_single"], max_abs_err(codes, full), abs(int(sc) - score)
                )
                sc, _ = fs.score_fold(top, side, *mkd, **kw)
                e["nw_score_single"] = max(e["nw_score_single"], abs(int(sc) - score))
                for C, bl in blocks_of.items():
                    sc, ck = fs.score_fold(top, side, *mkd, checkpoint_every=C, **kw)
                    e["nw_score_single/ckpt"] = max(
                        e["nw_score_single/ckpt"], max_abs_err(ck, hs[0:lb:C]), abs(int(sc) - score)
                    )
                    # K13 block by block from the kernel's checkpoints, each
                    # block walked by the kernel and by its plain version
                    ops_k = torch.full((max(la + lb, 1),), tb.OP_NONE, dtype=torch.int8, device=dev)
                    ops_p = ops_k.clone()
                    st_k = torch.tensor([la, lb, 0], dtype=torch.int32, device=dev)
                    st_p = st_k.clone()
                    for r in range(len(bl) - 1, -1, -1):
                        r0, r1 = bl[r]
                        codes, sc = fs.fill_codes_single(
                            top, side, *mkd, len2=r1, r0=r0, seed=ck[r] if r0 else None, **kw
                        )
                        want_c, want_s = want_blocks[(r0, r1)]
                        name = SEEDED if r0 else "nw_fill_codes_single"
                        e[name] = max(e[name], max_abs_err(codes, want_c), abs(int(sc) - want_s))
                        tb.walk_codes_window(codes, st_k, r0, ops_k)
                        tb.walk_codes_window_plain(codes, st_p, r0, ops_p)
                        e["nw_walk_window"] = max(e["nw_walk_window"], max_abs_err(st_k, st_p))
                    # K13 grouped: every block in one launch, and from the second on
                    for lo in range(min(2, len(bl))):
                        codes, corners = fs.fill_codes_blocks(
                            top, side, *mkd, la, lb, lo * C, C, ck[lo:], **kw
                        )
                        for g, (r0, r1) in enumerate(bl[lo:]):
                            want_c, want_s = want_blocks[(r0, r1)]
                            first = (r0 - lo * C) // 32
                            e["nw_refill_blocks"] = max(
                                e["nw_refill_blocks"], abs(int(corners[g]) - want_s),
                                max_abs_err(codes[:, first : first + want_c.shape[1]], want_c),
                            )
                    e["nw_walk_window"] = max(e["nw_walk_window"], max_abs_err(ops_k, ops_p))
                    if lb:  # the chained windows walk as nw_walk over the whole pair
                        e["nw_walk_window"] = max(
                            e["nw_walk_window"], max_abs_err(ops_k[: la + lb], ops_w[0, : la + lb]),
                            abs(int(st_k[2]) - int(n_w[0])),
                        )
        # the plain versions themselves, on short pairs
        for s1, s2 in EDGE + [(b"A" * 24, b"A" * 16), (b"ACCATTG" * 9, b"CATAG" * 14)]:
            top, side = (torch.from_numpy(enc.encode(x)).to(dev) for x in (s1, s2))
            got, want = fs.fill_codes_single(top, side, *mkd), fs.fill_codes_single_plain(top, side, *mkd)
            e["nw_fill_codes_single"] = max(
                e["nw_fill_codes_single"], max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1])
            )
            got, want = fs.score_fold(top, side, *mkd), fs.score_fold_plain(top, side, *mkd)
            e["nw_score_single"] = max(e["nw_score_single"], max_abs_err(got[0], want[0]))
            got = fs.score_fold(top, side, *mkd, checkpoint_every=32)
            want = fs.score_fold_plain(top, side, *mkd, checkpoint_every=32)
            e["nw_score_single/ckpt"] = max(
                e["nw_score_single/ckpt"], max_abs_err(got[1], want[1]), max_abs_err(got[0], want[0])
            )
            ck = want[1]
            for r in range(1, ck.shape[0]):
                kw = {"len2": min(len(s2), 32 * r + 32), "r0": 32 * r, "seed": ck[r]}
                got = fs.fill_codes_single(top, side, *mkd, **kw)
                want = fs.fill_codes_single_plain(top, side, *mkd, **kw)
                e[SEEDED] = max(e[SEEDED], max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
            if s2:
                kw = {"len1": len(s1), "len2": len(s2), "r0": 0, "C": 32, "seeds": ck}
                got = fs.fill_codes_blocks(top, side, *mkd, **kw)
                want = fs.fill_codes_blocks_plain(top, side, *mkd, **kw)
                e["nw_refill_blocks"] = max(
                    e["nw_refill_blocks"], max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1])
                )
        torch.cuda.synchronize()
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0), v)
        log(f"single-pair modes vs plain, {len(pairs)} pairs x {len(shapes)} launch shapes, "
            f"m k d = {mkd}: {e}; codes vs nw_fill_codes at B = 1: {e_batch}")
        if any(e.values()) or e_batch:
            fail(f"a single-pair mode differs from its plain version or nw_fill_codes: {e} {e_batch}")


def grouped_refill_vs_plain(dev, errs, plain):
    """Phase 8 (a): the grouped re-fill of every block of a 4 096 bp pair
    (C = 128 rows: 32 blocks of 4 bands) from the kernel's checkpoint
    rows, at its default launch (a warp a band) and at 2 blocks of 3
    warps (fewer warps than bands, 3 ring slots for a block's 4 bands),
    against its plain version on the same inputs on the card, under
    every scoring; the plain version's ms at (2,1,1) and the kernel's
    there go into ``plain``."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_single as fs

    pair = rand_pairs(np.random.default_rng(L_REFILL), 1, L_REFILL, L_REFILL)[0]
    t, s = (torch.from_numpy(enc.encode(x)).to(dev) for x in pair)
    for mkd in SCORINGS:
        _, ck = fs.score_fold(t, s, *mkd, checkpoint_every=C_REFILL)
        kw = {"len1": L_REFILL, "len2": L_REFILL, "r0": 0, "C": C_REFILL, "seeds": ck}
        want, ms = cuda_once(lambda: fs.fill_codes_blocks_plain(t, s, *mkd, **kw))
        e = 0
        for shape in ({}, {"blocks": 2, "warps": 3}):
            got = fs.fill_codes_blocks(t, s, *mkd, **kw, **shape)
            e = max(e, max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        errs["nw_refill_blocks"] = max(errs.get("nw_refill_blocks", 0), e)
        if mkd == (2, 1, 1):
            kern_ms = cuda_ms(lambda: fs.fill_codes_blocks(t, s, *mkd, **kw), 2)
            plain["nw_refill_blocks"] = (
                ms, f"{L_REFILL}x{L_REFILL}bp, all {ck.shape[0]} blocks of {C_REFILL} rows", kern_ms
            )
    log(f"phase 8 (a) nw_refill_blocks vs plain, every block of a {L_REFILL} bp pair (C = {C_REFILL}), "
        f"2 launch shapes x {len(SCORINGS)} scorings: max |diff| {errs['nw_refill_blocks']}")
    if errs["nw_refill_blocks"]:
        fail(f"the grouped re-fill differs from its plain version: {errs['nw_refill_blocks']}")


def huge_phase(card, bound):
    """Phase 8: huge pairs.  Returns each new kernel's record fields."""
    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.ops import checkpoint_traceback as ckt
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_auto
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops import traceback as tb

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    errs = {}
    plain = {}
    huge_modes_vs_plain(dev, errs)
    grouped_refill_vs_plain(dev, errs, plain)

    wrappers = {"fill_codes_single": fs.fill_codes_single, "fill_codes_blocks": fs.fill_codes_blocks,
                "score_fold": fs.score_fold, "walk_codes_window": tb.walk_codes_window}
    rng = np.random.default_rng(9)
    p10 = rand_pairs(rng, 1, L_LONG, L_LONG) + rand_pairs(rng, 1, L_LONG, L_LONG, b"AC")
    big = rand_pairs(np.random.default_rng(L_HUGE), 1, L_HUGE, L_HUGE)[0]
    big2 = [big, rand_pairs(np.random.default_rng(L_HUGE + 1), 1, L_HUGE, L_HUGE)[0]]
    C_big = ckt.auto_block_diagonals(L_HUGE, L_HUGE)
    a111 = NWAligner(AlignConfig(scoring=ScoringParams(1, 1, 1)), device="cuda")
    a211 = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")

    # (b)-(d), the main path, every launch counter from 0
    for name, attr in HUGE_KERNELS.values():
        setattr(wrappers[name], attr, 0)
    tb.walk_codes_batch.launches = fs.score_count_fold.launches = 0
    r10 = {}
    for i, p in enumerate(p10):
        r10[i, "codes"] = a111.align_huge(*p)
        os.environ["NW_TPU_HUGE_WALK_HBM"] = "0"
        r10[i, "ckpt"] = a111.align_huge(*p)
        del os.environ["NW_TPU_HUGE_WALK_HBM"]
    walls = {"codes": [], "ckpt": []}
    t0 = time.perf_counter()
    r_codes = a211.align_huge(*big)
    walls["codes"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    r_ckpt = a211.align_huge(*big, block_diagonals=C_big)
    walls["ckpt"].append(time.perf_counter() - t0)
    rb = a211.align_batch(big2, traceback_strings=True, count=True)
    k11_before = fs.score_fold.launches
    rs = a211.align_batch(big2)
    k11_route = fs.score_fold.launches - k11_before
    torch.cuda.synchronize()
    launches = {n: getattr(wrappers[w], a) for n, (w, a) in HUGE_KERNELS.items()}
    launches["nw_walk"] = tb.walk_codes_batch.launches
    launches["nw_score_count"] = fs.score_count_fold.launches
    log(f"huge-pair path launches: {launches}; scores-only align_batch of 2 x {L_HUGE} bp: "
        f"{k11_route} nw_score_single launches")
    if not all(launches.values()) or k11_route != 2:
        fail(f"a kernel of the huge-pair path never launched, or the K11 route was not taken: {launches}")

    # (b) 10 240 bp against the mask kernel + native enumeration
    for i, p in enumerate(p10):
        want = a111.align(*p)
        for route in ("codes", "ckpt"):
            r = r10[i, route]
            if (r.X, r.Y) != want.best_alignment() or r.score != want.score:
                fail(f"align_huge {route} route at {L_LONG} bp != align().best_alignment()")
    log(f"align_huge {L_LONG} bp, 2 pairs (ACGT, AC), m k d = 1 1 1: both routes equal "
        "align().best_alignment() and its score")
    # every mode against its plain version at the sizes (b) and (c) run:
    # here each 10 240 bp pair at the block size align_huge picks there
    t0 = time.perf_counter()
    C10 = ckt.auto_block_diagonals(L_LONG, L_LONG)
    for i, p in enumerate(p10):
        modes_vs_plain_10k(p, C10, errs, plain if i == 0 else None)
    log(f"single-pair modes vs plain on both {L_LONG} bp pairs (ACGT, AC; C = {C10} rows): "
        f"{ {n: errs[n] for n in [*HUGE_KERNELS, SEEDED]} } in {time.perf_counter() - t0:.1f} s")

    # (c) 100 000 bp, both routes
    sc8, ct8 = a211.summary_huge(*big)
    top, side = (torch.from_numpy(enc.encode(x)).to(dev) for x in big)
    sc11 = int(fs.score_fold(top, side, 2, 1, 1)[0])
    re = int(rescore([big], [(r_codes.X, r_codes.Y)], 2, 1, 1)[0])
    log(f"align_huge {L_HUGE} bp: codes route score {r_codes.score}, checkpointed (C = {C_big} rows) "
        f"{r_ckpt.score}, re-scored {re}, summary_huge {sc8}, score_fold {sc11}; "
        f"{len(r_codes.X)} columns")
    if (r_codes.X, r_codes.Y) != (r_ckpt.X, r_ckpt.Y):
        fail(f"align_huge at {L_HUGE} bp: the two routes' alignments differ")
    if not r_codes.score == r_ckpt.score == re == sc8 == sc11:
        fail(f"align_huge at {L_HUGE} bp: scores disagree")

    # (d) 2 x 100 000 bp through align_batch
    aligned = rb.alignment_strings()
    want8 = [(sc8, ct8), a211.summary_huge(*big2[1])]
    if aligned[0] != (r_codes.X, r_codes.Y):
        fail("align_batch of 2 huge pairs: strings differ from align_huge's")
    if not np.array_equal(rescore(big2, aligned, 2, 1, 1), rb.scores.astype(np.int64)):
        fail("align_batch of 2 huge pairs: alignments do not re-score to the scores")
    if [(int(s), int(c)) for s, c in zip(rb.scores, rb.counts)] != want8:
        fail("align_batch of 2 huge pairs: (score, count) differ from summary_huge's")
    if not np.array_equal(rs.scores, rb.scores):
        fail("align_batch of 2 huge pairs: scores-only (K11 route) differ")
    log(f"align_batch 2 x {L_HUGE} bp: strings equal align_huge's, (score, count) {want8} equal "
        "summary_huge's, scores-only through nw_score_single equal")
    del r10, rb, rs, aligned

    # (c') 200 000 bp: align_huge's default route (its 10 GB of codes pass
    # the 8 GiB budget: checkpointed, two groups) against the codes route
    # under a raised budget
    pair2 = rand_pairs(np.random.default_rng(L_HUGE2), 1, L_HUGE2, L_HUGE2)[0]
    C2 = ckt.auto_block_diagonals(L_HUGE2, L_HUGE2)
    G2 = ckt.refill_group(L_HUGE2, L_HUGE2, C2, dev)
    before = fs.fill_codes_blocks.launches
    t0 = time.perf_counter()
    r_def = a211.align_huge(*pair2)
    wall_def = time.perf_counter() - t0
    refills2 = fs.fill_codes_blocks.launches - before
    groups2 = -(-(-(-L_HUGE2 // C2)) // G2)  # ceil(blocks / G)
    os.environ["NW_TPU_HUGE_WALK_HBM"] = str(12 << 30)
    try:
        t0 = time.perf_counter()
        r_big = a211.align_huge(*pair2)
        wall_big = time.perf_counter() - t0
    finally:
        del os.environ["NW_TPU_HUGE_WALK_HBM"]
    torch.cuda.empty_cache()
    log(f"align_huge {L_HUGE2} bp (2 1 1): default route checkpointed (C = {C2} rows, G = {G2}, "
        f"{refills2} nw_refill_blocks launches) {wall_def:.4f} s, codes route under a 12 GiB budget "
        f"{wall_big:.4f} s (cold); scores {r_def.score} / {r_big.score} [{card}]")
    if refills2 != groups2 or (r_def.X, r_def.Y) != (r_big.X, r_big.Y):
        fail(f"align_huge at {L_HUGE2} bp: the default route's strings differ from the codes route's, "
             f"or it did not take the checkpointed route ({refills2} group launches)")
    if r_def.score != r_big.score or r_def.score != int(rescore([pair2], [(r_big.X, r_big.Y)], 2, 1, 1)[0]):
        fail(f"align_huge at {L_HUGE2} bp: the routes' scores differ")
    del r_def, r_big

    # (e) times
    for _ in range(3):
        t0 = time.perf_counter()
        r = a211.align_huge(*big)
        walls["codes"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        r = a211.align_huge(*big, block_diagonals=C_big)
        walls["ckpt"].append(time.perf_counter() - t0)
    del r
    for route, ws in walls.items():
        log(f"align_huge {L_HUGE} bp {route} route: walls {[round(w, 4) for w in ws]} s (first cold); "
            f"median warm {statistics.median(ws[1:]):.4f} s [{card}]")
    cells = L_HUGE * L_HUGE
    in_bytes = tensor_bytes(top, side)
    rec = {}
    ms14 = cuda_ms(lambda: fs.fill_codes_single(top, side, 2, 1, 1), 2)
    codes, _ = fs.fill_codes_single(top, side, 2, 1, 1)
    l1, l2 = (torch.tensor([L_HUGE], dtype=torch.int32, device=dev) for _ in range(2))
    ms_walk = cuda_ms(lambda: tb.walk_codes_batch(codes, l1, l2, 2 * L_HUGE), 2)
    steps = int(tb.walk_codes_batch(codes, l1, l2, 2 * L_HUGE)[1][0])
    rec["nw_fill_codes_single"] = dict(
        ms=ms14, **bound(cells * (OPS_SCORE + OPS_CODE), in_bytes + tensor_bytes(codes) + 4),
        shape=f"1x{L_HUGE}bp codes + corner",
    )
    del codes
    torch.cuda.empty_cache()
    ms12 = cuda_ms(lambda: fs.score_fold(top, side, 2, 1, 1, checkpoint_every=C_big), 2)
    _, ck = fs.score_fold(top, side, 2, 1, 1, checkpoint_every=C_big)
    rec["nw_score_single/ckpt"] = dict(
        ms=ms12, **bound(cells * OPS_SCORE, in_bytes + tensor_bytes(ck) + 4),
        shape=f"1x{L_HUGE}bp score + {ck.shape[0]} checkpoint rows (C = {C_big})",
    )
    blocks = [(r * C_big, min(L_HUGE, r * C_big + C_big)) for r in range(ck.shape[0])][::-1]
    block_codes = []

    def refill_each():  # one block a launch (nw_fill_codes_single from a seed)
        block_codes.clear()
        for r0, r1 in blocks:
            block_codes.append(fs.fill_codes_single(
                top, side, 2, 1, 1, len2=r1, r0=r0, seed=ck[r0 // C_big] if r0 else None
            )[0])

    def refill_groups(G):  # G blocks a launch, the last group first, as the route runs them
        for hi in range(len(blocks), 0, -G):
            lo = max(0, hi - G)
            out = fs.fill_codes_blocks(top, side, 2, 1, 1, L_HUGE, min(L_HUGE, hi * C_big), lo * C_big,
                                       C_big, ck[lo:hi])
        return out

    G_big = ckt.refill_group(L_HUGE, L_HUGE, C_big, dev)
    refill_each()
    group_codes, corners = fs.fill_codes_blocks(top, side, 2, 1, 1, L_HUGE, L_HUGE, 0, C_big, ck)
    torch.cuda.synchronize()
    e_blocks = 0
    for (r0, r1), codes in zip(blocks, block_codes):
        e_blocks = max(e_blocks, max_abs_err(group_codes[:, r0 // 32 : r0 // 32 + codes.shape[1]], codes))
    e_blocks = max(e_blocks, max_abs_err(corners, torch.stack(
        [ck[r + 1, L_HUGE] for r in range(len(blocks) - 1)] + [fs.score_fold(top, side, 2, 1, 1)[0]])))
    errs["nw_refill_blocks"] = max(errs["nw_refill_blocks"], e_blocks)
    log(f"{len(blocks)} blocks of {C_big} rows x {L_HUGE} bp in one nw_refill_blocks launch "
        f"vs one launch a block: max |diff| {e_blocks} (codes, and corners vs the checkpoint rows)")
    turns = {}
    for name in ("each", "group", "group", "each"):
        fn = refill_each if name == "each" else (lambda: refill_groups(G_big))
        turns.setdefault(name, []).append(cuda_ms(fn, 1))
    ms13, ms13_old = min(turns["group"]), min(turns["each"])
    log(f"{len(blocks)} refills at {L_HUGE} bp in turns: one block a launch {turns['each']} ms, "
        f"{G_big} blocks a launch {turns['group']} ms [{card}]")
    sweep_g = {G: cuda_ms(lambda: refill_groups(G), 1) for G in (*REFILL_GROUPS, G_big)}
    log(f"{len(blocks)} refills at {L_HUGE} bp by blocks a launch G: {sweep_g} ms [{card}]")
    # one block's refill at 8 (the default), 4, 2 and 1 warps a block
    r0, r1 = blocks[len(blocks) // 2]
    sweep = {}
    for w in (8, 4, 2, 1, 8):
        sweep.setdefault(w, []).append(cuda_ms(lambda: fs.fill_codes_single(
            top, side, 2, 1, 1, len2=r1, r0=r0, seed=ck[r0 // C_big], warps=w
        ), 2))
    log(f"one refill of rows {r0}..{r1} x {L_HUGE} bp by warps a block: {sweep} ms [{card}]")
    # a block of the path's height (C_big rows) against its plain version,
    # seeded from the kernel's row, on the 20 000 bp prefixes of the pair:
    # the plain fill takes ~0.5 ms a diagonal on an H100, so a block across
    # 100 000 columns takes over 50 s
    t20, s20 = top[:L_CROSS], side[:L_CROSS]
    _, ck20 = fs.score_fold(t20, s20, 2, 1, 1, checkpoint_every=C_big)
    b20 = ck20.shape[0] // 2
    kw = {"len2": min(L_CROSS, (b20 + 1) * C_big), "r0": b20 * C_big, "seed": ck20[b20]}
    _, ms = against_plain(
        SEEDED, lambda: fs.fill_codes_single(t20, s20, 2, 1, 1, **kw),
        lambda: fs.fill_codes_single_plain(t20, s20, 2, 1, 1, **kw), errs,
    )
    ms20 = cuda_ms(lambda: fs.fill_codes_single(t20, s20, 2, 1, 1, **kw), 2)
    plain[SEEDED] = (ms, f"one block of rows {kw['r0']}..{kw['len2']} x {L_CROSS}bp", ms20)
    del ck20
    seeded_bytes = tensor_bytes(*block_codes) + tensor_bytes(ck)
    del block_codes[:]
    # the route's walk: each block's slice of the one-launch codes
    chain = [(r0, group_codes[:, r0 // 32 : -(-r1 // 32)]) for r0, r1 in blocks]
    ms_ww = cuda_ms(lambda: walk_chain(tb.walk_codes_window, chain, L_HUGE, L_HUGE), 2)
    (state, _), ms = against_plain(
        "nw_walk_window", lambda: walk_chain(tb.walk_codes_window, chain, L_HUGE, L_HUGE),
        lambda: walk_chain(tb.walk_codes_window_plain, chain, L_HUGE, L_HUGE), errs,
    )
    plain["nw_walk_window"] = (ms, f"the same {len(blocks)} windows", ms_ww)
    if state.tolist() != [0, 0, steps]:
        fail(f"the chained window walks at 100 kb end at {state.tolist()}, nw_walk after {steps} steps")
    log(f"vs plain: {plain[SEEDED][1]} re-filled from the kernel's checkpoint (one block a launch), "
        f"max |diff| {errs[SEEDED]} (plain {plain[SEEDED][0]:.1f} ms, kernel {ms20:.3f} ms); {L_HUGE} bp: "
        f"{len(blocks)} chained window walks over the one-launch codes {errs['nw_walk_window']} "
        f"(plain {ms:.1f} ms) [{card}]")
    del chain, group_codes
    rec["nw_refill_blocks"] = dict(
        ms=ms13, **bound(cells * (OPS_SCORE + OPS_CODE), in_bytes + seeded_bytes),
        shape=f"1x{L_HUGE}bp, all {len(blocks)} blocks of {C_big} rows re-filled in "
              f"{-(-len(blocks) // G_big)} launch(es); one block a launch {ms13_old:.3f} ms in turns",
        group=G_big, one_block_ms=ms13_old,
    )
    rec["nw_walk_window"] = dict(
        ms=ms_ww, **bound(steps * OPS_WALK_STEP, steps * 5),
        shape=f"1x{L_HUGE}bp, {steps} steps in {len(blocks)} chained windows",
    )
    log(f"align_huge {L_HUGE} bp kernels: codes fill {ms14:.3f} ms, nw_walk {ms_walk:.3f} ms "
        f"({steps} steps); checkpointed: dump {ms12:.3f} ms, {len(blocks)} refills {ms13:.3f} ms "
        f"(G = {G_big}; one block a launch {ms13_old:.3f} ms), {len(blocks)} window walks {ms_ww:.3f} ms "
        f"[{card}]")
    del ck
    torch.cuda.empty_cache()

    # K11 against K8 at 20 kb and 100 kb, in turns
    k11_k8 = {}
    for L in (L_CROSS, L_HUGE):
        t, s = (x[:L] for x in (top, side))
        for name in ("k8", "k11", "k11", "k8"):
            fn = fs.score_count_fold if name == "k8" else fs.score_fold
            k11_k8.setdefault((L, name), []).append(cuda_ms(lambda: fn(t, s, 2, 1, 1), 2))
        log(f"score only {L}x{L}bp: nw_score_single {k11_k8[L, 'k11']} ms, nw_score_count "
            f"{k11_k8[L, 'k8']} ms [{card}]")
        if L == L_CROSS:  # K11 against its plain version, as phase 6 holds K8
            _, ms = against_plain(
                "nw_score_single", lambda: fs.score_fold(t, s, 2, 1, 1),
                lambda: fs.score_fold_plain(t, s, 2, 1, 1), errs,
            )
            plain["nw_score_single"] = (ms, f"{L}x{L}bp", min(k11_k8[L, "k11"]))
    rec["nw_score_single"] = dict(
        ms=min(k11_k8[L_HUGE, "k11"]), **bound(cells * OPS_SCORE, in_bytes + 4),
        shape=f"1x{L_HUGE}bp score",
    )

    # the K11 route against the K1 route (a block a pair): scores of
    # nb pairs of L bp, as fill_scores_auto would run them
    for L in CROSSOVER:
        for nb in ((2,) if L == L_HUGE else (2, 8, 23)):
            ps = rand_pairs(np.random.default_rng(L + nb), nb, L, L)
            tops, sides, l1s, l2s = enc.upload(enc.encode_batch(ps, L, L), dev)
            reps = 0 if L == L_HUGE else 2
            k1 = cuda_ms(lambda: fb.fill_scores_banded_batch(tops, sides, l1s, l2s, 2, 1, 1), reps)
            k11 = cuda_ms(lambda: torch.stack([
                fs.score_fold(tops[b], sides[b], 2, 1, 1, L, L)[0] for b in range(nb)
            ]), 2)
            rule = "K11" if fill_auto.takes_single_pair_route(nb, L, L) else "K1"
            log(f"scores of {nb} x {L} bp: K1 route (nw_scores, a block a pair) {k1:.3f} ms, "
                f"K11 route (nw_score_single a pair) {k11:.3f} ms; fill_scores_auto takes {rule} [{card}]")

    if any(errs.values()):
        fail(f"a single-pair mode differs from its plain version at full size: {errs}")
    for name in rec:
        ms, where, k_ms = plain[name]
        rec[name]["shape"] += f" (plain_ms at {where}, kernel there {k_ms:.3f} ms)"
        rec[name].update(plain_ms=ms, launches=launches[name], max_abs_err=errs[name])
    log(f"phase 8 peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase seconds {time.perf_counter() - t_phase:.1f} [{card}]")
    return rec


def start_ptxas_report():
    """Start ``nvcc -Xptxas -v`` on the batched fill, walk, Gotoh and
    single-pair sources (the kernels' own flags), one process each;
    returns the processes."""
    from nw_tpu_torch.runtime import kernels

    nvcc = kernels._nvcc()
    return [
        subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
             str(kernels.CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for src in ("nw_fill.cu", "nw_walk.cu", "nw_affine.cu", "nw_single.cu", "nw_count.cu")
    ]


def print_ptxas_report(procs) -> None:
    """Registers and spills of every kernel instantiation, from the
    processes of :func:`start_ptxas_report`."""
    rows, name = [], None
    for proc in procs:
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"nvcc -Xptxas -v failed:\n{err}")
        for line in err.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "spill stores" in line and name:
                spill = line.strip()
            elif "Used" in line and "registers" in line and name:
                rows.append((name, line.split("Used")[1].strip(), spill))
                name = None
    filt = "/usr/local/cuda/bin/cu++filt"
    names = [r[0] for r in rows]
    if os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(names), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
    for (_, regs, spill), name in zip(rows, names):
        if name.endswith(")"):  # drop the parameter list, keep the template arguments
            depth = 0
            for i in range(len(name) - 1, -1, -1):
                depth += {")": 1, "(": -1}.get(name[i], 0)
                if depth == 0:
                    name = name[:i]
                    break
        log(f"ptxas: {name}: {regs}; {spill}")


def free_fill_vs_plain(vb_name, batch, mkd):
    """One scoring of a free-boundary fill (``sw`` or ``overlap``): its
    scores kernel at the rule's W and at every W of ``PIPE_WARPS``, its
    codes kernel and ``sw_walk`` on its codes against their plain
    versions, the scores also against the codes kernel's best.  Returns
    the three max |diff| and the codes kernel's outputs."""
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.ops import variants_banded as vb

    scores_fn = getattr(vb, f"{vb_name}_scores_banded_batch")
    codes_fn = getattr(vb, f"{vb_name}_fill_codes_banded_batch")
    scores = scores_fn(*batch, *mkd)
    want_s = getattr(vb, f"{vb_name}_scores_banded_batch_plain")(*batch, *mkd)
    e_s = max(max_abs_err(scores, want_s),
              *(max_abs_err(pipe_fill(vb_name, batch, mkd, W)[0], want_s) for W in PIPE_WARPS))
    got = codes_fn(*batch, *mkd)
    want = getattr(vb, f"{vb_name}_fill_codes_banded_batch_plain")(*batch, *mkd)
    e_s = max(e_s, max_abs_err(scores, got[1]))
    e_c = max(max_abs_err(g, w) for g, w in zip(got, want))
    walk_k = tb.walk_sw_codes_batch(got[0], got[2], got[3])
    walk_p = tb.walk_sw_codes_batch_plain(want[0], want[2], want[3])
    e_w = max(max_abs_err(g, w) for g, w in zip(walk_k, walk_p))
    torch.cuda.synchronize()
    return e_s, e_c, e_w, got


def sw_kernels_vs_plain(dev, errs):
    """Phase 9 (a): the three Smith-Waterman kernels bit for bit against
    their plain versions on the card, every scoring; the scores kernel's
    best also against the codes kernel's."""
    from nw_tpu_torch.ops import encode as enc

    pairs = variant_pairs(10)
    L1 = max(len(a) for a, _ in pairs)
    L2 = max(len(b) for _, b in pairs)
    batch = enc.upload(enc.encode_batch(pairs, L1, L2), dev)
    for name in ("sw_scores", "sw_fill_codes", "sw_walk"):
        errs.setdefault(name, 0)
    for mkd in SW_SCORINGS:
        e_s, e_c, e_w, _ = free_fill_vs_plain("sw", batch, mkd)
        for name, e in (("sw_scores", e_s), ("sw_fill_codes", e_c), ("sw_walk", e_w)):
            errs[name] = max(errs[name], e)
        log(f"SW kernels vs plain, {len(pairs)} pairs {L1}x{L2}, m k d = {mkd}: "
            f"sw_scores {e_s} sw_fill_codes {e_c} sw_walk {e_w}")
    if any(errs.values()):
        fail(f"a Smith-Waterman kernel differs from its plain version: {errs}")


def check_local_alignments(pairs, got, best, j_star, i_star, m, k, d) -> None:
    """Each (best, X, Y, (j_end, i_end)) of ``sw_align_batch``: its best
    and end cell are ``sw_fill_codes``'s, X / Y spell ``s1[i_end:i*]`` /
    ``s2[j_end:j*]`` with gaps added and re-score to the best."""
    if [g[0] for g in got] != best.tolist():
        fail("sw_align_batch: a best differs from sw_fill_codes's")
    subs = [
        (s1[g[3][1] : i], s2[g[3][0] : j])
        for (s1, s2), g, j, i in zip(pairs, got, j_star.tolist(), i_star.tolist())
    ]
    if not np.array_equal(rescore(subs, [g[1:3] for g in got], m, k, d), best.astype(np.int64)):
        fail("sw_align_batch: an alignment does not re-score to its best")


def sw_phase(card, bound):
    """Phase 9: Smith-Waterman.  Returns each new kernel's record fields."""
    from nw_tpu_torch.models import smith_waterman as sw
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.ops import variants_banded as vb

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    errs = {}
    sw_kernels_vs_plain(dev, errs)

    rng = np.random.default_rng(11)
    configs = {  # name: (entry point, pairs, source)
        "align128x3072": (sw.sw_align_batch, rand_pairs(rng, 128, L_SW_TB, L_SW_TB), "bench.py:414"),
        "align4096x150": (sw.sw_align_batch, rand_pairs(rng, 4096, L_SHORT, L_SHORT), "bench.py:291"),
        "score10240x150": (sw.sw_score_batch, rand_pairs(rng, 10240, L_SHORT, L_SHORT), "bench.py:517"),
        "score128x10240": (sw.sw_score_batch, rand_pairs(rng, 128, L_LONG, L_LONG), "bench.py:583"),
    }
    m, k, d = 2, 1, 1
    wrappers = {
        "sw_scores": vb.sw_scores_banded_batch,
        "sw_fill_codes": vb.sw_fill_codes_banded_batch,
        "sw_walk": tb.walk_sw_codes_batch,
    }
    # (b) the main path, every launch counter from 0
    for w in wrappers.values():
        w.launches = 0
    results, walls = {}, {}
    for name, (fn, pairs, _) in configs.items():
        t0 = time.perf_counter()
        results[name] = fn(pairs, m, k, d)
        walls[name] = [time.perf_counter() - t0]
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    log(f"SW main path launches: {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the Smith-Waterman path never launched: {launches}")

    # every output against sw_fill_codes on the same batch; 4 pairs of
    # each against the plain path on the card
    plain, kern4 = {}, {}
    for name, (fn, pairs, src) in configs.items():
        L = len(pairs[0][0])
        batch = enc.upload(enc.encode_batch(pairs, L, L), dev)
        best, j_star, i_star = (t.cpu().numpy() for t in vb.sw_fill_codes_banded_batch(*batch, m, k, d)[1:])
        got = results[name]
        four = [t[:4] for t in batch]
        if fn is sw.sw_align_batch:
            check_local_alignments(pairs, got, best, j_star, i_star, m, k, d)
            codes, b4, js, is_ = vb.sw_fill_codes_banded_batch(*four, m, k, d)
            kern4[name] = (cuda_ms(lambda: vb.sw_fill_codes_banded_batch(*four, m, k, d), 2),
                           cuda_ms(lambda: tb.walk_sw_codes_batch(codes, js, is_), 2))
            p_fill, ms_fill = cuda_once(lambda: vb.sw_fill_codes_banded_batch_plain(*four, m, k, d))
            p_walk, ms_walk = cuda_once(lambda: tb.walk_sw_codes_batch_plain(p_fill[0], p_fill[2], p_fill[3]))
            plain[name] = (ms_fill, ms_walk)
            trunc = [(s1[:i], s2[:j]) for (s1, s2), j, i in zip(pairs[:4], js.tolist(), is_.tolist())]
            ops, n, i_end, j_end = (t.cpu().numpy() for t in p_walk)
            strs = tb.ops_to_strings_batch(ops, n, trunc)
            want4 = [(int(p_fill[1][b]), X, Y, (int(j_end[b]), int(i_end[b]))) for b, (X, Y) in enumerate(strs)]
            e = max(max_abs_err(g, w) for g, w in zip((codes, b4, js, is_), p_fill))
            errs["sw_fill_codes"] = max(errs["sw_fill_codes"], e)
            errs["sw_walk"] = max(errs["sw_walk"], max(
                max_abs_err(g, w) for g, w in zip(tb.walk_sw_codes_batch(codes, js, is_), p_walk)
            ))
            lens = [len(x) for _, x, _, _ in got]
            log(f"SW {name} ({src}): {len(got)} alignments spell their substrings and re-score "
                f"to sw_fill_codes's best (best {min(best)}-{max(best)}, {min(lens)}-{max(lens)} columns); "
                f"4 pairs vs plain: {'equal' if got[:4] == want4 else 'DIFFER'}, kernels max |diff| {e}")
            if got[:4] != want4:
                fail(f"SW {name}: 4 pairs differ from the plain path on the card")
        else:
            if not np.array_equal(got, best):
                fail(f"SW {name}: scores differ from sw_fill_codes's best")
            sub = batch if L == L_SHORT else four
            want, ms = cuda_once(lambda: vb.sw_scores_banded_batch_plain(*sub, m, k, d))
            plain[name] = ms
            e = int(np.abs(got[: len(want)].astype(np.int64) - want.cpu().numpy()).max())
            errs["sw_scores"] = max(errs["sw_scores"], e)
            log(f"SW {name} ({src}): {len(got)} scores equal sw_fill_codes's best "
                f"({min(got)}-{max(got)}); {sub[0].shape[0]} vs plain: max |diff| {e} ({ms:.1f} ms)")
            if e:
                fail(f"SW {name}: scores differ from the plain path on the card")
        del batch, four
    torch.cuda.empty_cache()
    if any(errs.values()):
        fail(f"a Smith-Waterman kernel differs from its plain version at full size: {errs}")

    # (c) times: 4 warm runs of each configuration, in turns
    for _ in range(4):
        for name, (fn, pairs, _) in configs.items():
            t0 = time.perf_counter()
            fn(pairs, m, k, d)
            walls[name].append(time.perf_counter() - t0)
    for name, (_, pairs, src) in configs.items():
        med = statistics.median(walls[name][1:])
        cells = sum(len(a) * len(b) for a, b in pairs)
        log(f"e2e SW {name} ({src}): walls {[round(w, 4) for w in walls[name]]} s (first includes "
            f"warm-up); median warm {med:.4f} s = {len(pairs) / med:.1f} pairs/s, "
            f"{cells / med / 1e9:.2f} GCUPS [{card}]")

    def batch_of(name):
        pairs = configs[name][1]
        L = len(pairs[0][0])
        return pairs, enc.upload(enc.encode_batch(pairs, L, L), dev)

    rec = {}
    pairs, b150 = batch_of("score10240x150")
    cells = sum(len(a) * len(b) for a, b in pairs)
    rec["sw_scores"] = dict(
        ms=cuda_ms(lambda: vb.sw_scores_banded_batch(*b150, m, k, d), 20),
        plain_ms=plain["score10240x150"],
        **bound(cells * (OPS_SCORE + OPS_LOCAL), tensor_bytes(*b150) + 4 * len(pairs)),
    )
    pairs, b10k = batch_of("score128x10240")
    ms_10k = cuda_ms(lambda: vb.sw_scores_banded_batch(*b10k, m, k, d), 2)
    shapes = [(f"sw_scores 128x{L_LONG}bp", "sw", b10k, 2),
              (f"sw_scores {len(b150[0])}x{L_SHORT}bp", "sw", b150, 20)]
    (w10k, one10k, _), (w150, one150, _) = pipe_turns(card, shapes).values()
    pipe_sweep(card, [shapes[0][:3]])
    rec["sw_scores"].update(
        warps=w150, one_warp_ms=statistics.median(one150),
        shape=(f"{len(b150[0])}x{L_SHORT}bp scores, {w150} warp(s) a pair (at 128x{L_LONG}bp: "
               f"{ms_10k:.3f} ms at W = {w10k}, W = 1 {statistics.median(one10k):.3f} ms in turns)"),
    )
    del b10k
    pairs, b3k = batch_of("align128x3072")
    cells = sum(len(a) * len(b) for a, b in pairs)
    ms_fill = cuda_ms(lambda: vb.sw_fill_codes_banded_batch(*b3k, m, k, d), 3)
    codes, best, js, is_ = vb.sw_fill_codes_banded_batch(*b3k, m, k, d)
    ms_walk = cuda_ms(lambda: tb.walk_sw_codes_batch(codes, js, is_), 5)
    steps = int(tb.walk_sw_codes_batch(codes, js, is_)[1].sum())
    k4_fill, k4_walk = kern4["align128x3072"]
    p_fill, p_walk = plain["align128x3072"]
    rec["sw_fill_codes"] = dict(
        ms=ms_fill, plain_ms=p_fill,
        **bound(cells * (OPS_SCORE + OPS_LOCAL + OPS_ARGMAX + OPS_CODE),
                tensor_bytes(*b3k, codes, best, js, is_)),
        shape=f"128x{L_SW_TB}bp codes+best+argmax (plain_ms at 4x{L_SW_TB}bp, kernel there {k4_fill:.3f} ms)",
    )
    rec["sw_walk"] = dict(
        ms=ms_walk, plain_ms=p_walk,
        **bound(steps * OPS_WALK_STEP, tensor_bytes(js, is_) + 12 * len(pairs) + 5 * steps),
        shape=f"128x{L_SW_TB}bp, {steps} steps (plain_ms at 4x{L_SW_TB}bp, kernel there {k4_walk:.3f} ms)",
    )
    del codes
    _, b4k = batch_of("align4096x150")
    ms_fill150 = cuda_ms(lambda: vb.sw_fill_codes_banded_batch(*b4k, m, k, d), 10)
    for name in rec:
        rec[name].update(launches=launches[name], max_abs_err=errs[name])
        log(f"{name}: {rec[name]['ms']:.3f} ms at {rec[name]['shape']}, bound {rec[name]['bound_ms']:.4f} ms "
            f"({rec[name]['bound_by']}), plain {rec[name]['plain_ms']:.1f} ms [{card}]")
    b10k = bound(128 * L_LONG * L_LONG * (OPS_SCORE + OPS_LOCAL), 128 * (2 * 4 * L_LONG + 12))
    log(f"sw_fill_codes 4096x{L_SHORT}bp: {ms_fill150:.3f} ms; sw_scores 128x{L_LONG}bp: {ms_10k:.3f} ms, "
        f"bound {b10k['bound_ms']:.3f} ms ({b10k['bound_by']}) [{card}]")
    log(f"phase 9 peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase seconds {time.perf_counter() - t_phase:.1f} [{card}]")
    return rec


def variant_kernels_vs_plain(dev, errs):
    """Phase 10 (a): the overlap and Gotoh kernels (and ``sw_walk`` on
    overlap codes) bit for bit against their plain versions on the card,
    every scoring; the overlap scores kernel's best also against the
    codes kernel's."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import variants_banded as vb

    pairs = variant_pairs(12, [OVERLAP_TWO_BANDS])
    L1 = max(len(a) for a, _ in pairs)
    L2 = max(len(b) for _, b in pairs)
    batch = enc.upload(enc.encode_batch(pairs, L1, L2), dev)
    for name in ("overlap_scores", "overlap_fill_codes", "sw_walk", "gotoh_scores"):
        errs.setdefault(name, 0)
    for mkd in SW_SCORINGS:
        e_s, e_c, e_w, got = free_fill_vs_plain("overlap", batch, mkd)
        for name, e in (("overlap_scores", e_s), ("overlap_fill_codes", e_c), ("sw_walk", e_w)):
            errs[name] = max(errs[name], e)
        log(f"overlap kernels vs plain, {len(pairs)} pairs {L1}x{L2}, m k d = {mkd}: "
            f"overlap_scores {e_s} overlap_fill_codes {e_c} sw_walk {e_w}")
        if mkd == (2, 1, 1):  # the two-band pair's end cell, by the scan's tie rule
            cell = (int(got[1][-1]), int(got[2][-1]), int(got[3][-1]))
            log(f"overlap two-band pair: (best, j*, i*) = {cell}")
            if cell != (40, 70, 20):
                fail(f"overlap_fill_codes: the two-band pair gives {cell}, not (40, 70, 20)")
    for sc in GOTOH_SCORINGS:
        want = vb.affine_scores_banded_batch_plain(*batch, *sc)
        e = max(max_abs_err(pipe_fill("gotoh", batch, sc, W)[0], want) for W in (*PIPE_WARPS, None))
        errs["gotoh_scores"] = max(errs["gotoh_scores"], e)
        log(f"gotoh_scores vs plain at W in {PIPE_WARPS} and the rule's {pipe_rule('gotoh', batch)}, "
            f"{len(pairs)} pairs {L1}x{L2}, m k open extend = {sc}: {e}")
    if any(errs.values()):
        fail(f"an overlap or Gotoh kernel differs from its plain version: {errs}")


def check_overlap_alignments(pairs, got, best, j_star, i_star, m, k, d) -> None:
    """Each (best, X, Y, (j_start, i_start), (j_end, i_end)) of
    ``overlap_align_batch``: its best and end cell are
    ``overlap_fill_codes``'s, it starts on row 0 or column 0 and ends on
    the last row or column, and X / Y spell ``s1[i_start:i_end]`` /
    ``s2[j_start:j_end]`` with gaps added and re-score to the best."""
    if [g[0] for g in got] != best.tolist():
        fail("overlap_align_batch: a best differs from overlap_fill_codes's")
    if [g[4] for g in got] != list(zip(j_star.tolist(), i_star.tolist())):
        fail("overlap_align_batch: an end cell differs from overlap_fill_codes's")
    for (s1, s2), g in zip(pairs, got):
        (js, is_), (je, ie) = g[3], g[4]
        if not (js == 0 or is_ == 0) or not (je == len(s2) or ie == len(s1)):
            fail(f"overlap_align_batch: start {g[3]} or end {g[4]} off its boundary")
    subs = [(s1[g[3][1] : g[4][1]], s2[g[3][0] : g[4][0]]) for (s1, s2), g in zip(pairs, got)]
    if not np.array_equal(rescore(subs, [g[1:3] for g in got], m, k, d), best.astype(np.int64)):
        fail("overlap_align_batch: an alignment does not re-score to its best")


def variants_phase(card, bound):
    """Phase 10: overlap and Gotoh scores.  Returns each new kernel's
    record fields, and ``sw_walk``'s launches and time on this path."""
    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.models import affine as af
    from nw_tpu_torch.models import overlap as ov
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.ops import variants_banded as vb

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    errs = {}
    variant_kernels_vs_plain(dev, errs)

    rng = np.random.default_rng(13)
    mkd, gotoh = (2, 1, 1), (2, 1, 3, 1)
    long_pairs = rand_pairs(rng, 128, L_LONG, L_LONG)
    short_pairs = rand_pairs(rng, 10240, L_SHORT, L_SHORT)
    configs = {  # name: (entry point, pairs, scoring, source)
        "overlap_align128x3072": (ov.overlap_align_batch, rand_pairs(rng, 128, L_SW_TB, L_SW_TB), mkd,
                                  "bench.py:414"),
        "overlap_align4096x150": (ov.overlap_align_batch, rand_pairs(rng, 4096, L_SHORT, L_SHORT), mkd,
                                  "bench.py:291"),
        "overlap_score10240x150": (ov.overlap_score_batch, short_pairs, mkd, "bench.py:517"),
        "overlap_score128x10240": (ov.overlap_score_batch, long_pairs, mkd, "bench.py:583"),
        "gotoh_score10240x150": (af.affine_score_pairs, short_pairs, gotoh, "bench.py:517"),
        "gotoh_score128x10240": (af.affine_score_pairs, long_pairs, gotoh, "bench.py:583"),
    }
    wrappers = {
        "overlap_scores": vb.overlap_scores_banded_batch,
        "overlap_fill_codes": vb.overlap_fill_codes_banded_batch,
        "sw_walk": tb.walk_sw_codes_batch,
        "gotoh_scores": vb.affine_scores_banded_batch,
    }
    # (b) the main path, every launch counter from 0
    for w in wrappers.values():
        w.launches = 0
    results, walls = {}, {}
    for name, (fn, pairs, sc, _) in configs.items():
        t0 = time.perf_counter()
        results[name] = fn(pairs, *sc)
        walls[name] = [time.perf_counter() - t0]
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    log(f"overlap / Gotoh main path launches: {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the overlap / Gotoh path never launched: {launches}")

    # every output against the kernels on the same batch; the 150 bp
    # scores all, 4 pairs of every other batch against the plain path
    plain, kern4 = {}, {}
    for name, (fn, pairs, sc, src) in configs.items():
        L = len(pairs[0][0])
        batch = enc.upload(enc.encode_batch(pairs, L, L), dev)
        four = [t[:4] for t in batch]
        got = results[name]
        if fn is ov.overlap_align_batch:
            best, j_star, i_star = (t.cpu().numpy() for t in vb.overlap_fill_codes_banded_batch(*batch, *sc)[1:])
            check_overlap_alignments(pairs, got, best, j_star, i_star, *sc)
            codes, b4, js, is_ = vb.overlap_fill_codes_banded_batch(*four, *sc)
            kern4[name] = (cuda_ms(lambda: vb.overlap_fill_codes_banded_batch(*four, *sc), 2),
                           cuda_ms(lambda: tb.walk_sw_codes_batch(codes, js, is_), 2))
            p_fill, ms_fill = cuda_once(lambda: vb.overlap_fill_codes_banded_batch_plain(*four, *sc))
            p_walk, ms_walk = cuda_once(lambda: tb.walk_sw_codes_batch_plain(p_fill[0], p_fill[2], p_fill[3]))
            plain[name] = (ms_fill, ms_walk)
            trunc = [(s1[:i], s2[:j]) for (s1, s2), j, i in zip(pairs[:4], js.tolist(), is_.tolist())]
            ops, n, i_st, j_st = (t.cpu().numpy() for t in p_walk)
            strs = tb.ops_to_strings_batch(ops, n, trunc)
            want4 = [
                (int(p_fill[1][b]), X, Y, (int(j_st[b]), int(i_st[b])), (int(js[b]), int(is_[b])))
                for b, (X, Y) in enumerate(strs)
            ]
            e = max(max_abs_err(g, w) for g, w in zip((codes, b4, js, is_), p_fill))
            errs["overlap_fill_codes"] = max(errs["overlap_fill_codes"], e)
            errs["sw_walk"] = max(errs["sw_walk"], max(
                max_abs_err(g, w) for g, w in zip(tb.walk_sw_codes_batch(codes, js, is_), p_walk)
            ))
            lens = [len(x) for _, x, _, _, _ in got]
            log(f"{name} ({src}): {len(got)} alignments spell their substrings, lie on their boundaries "
                f"and re-score to overlap_fill_codes's best (best {min(best)}-{max(best)}, "
                f"{min(lens)}-{max(lens)} columns); 4 pairs vs plain: "
                f"{'equal' if got[:4] == want4 else 'DIFFER'}, kernels max |diff| {e}")
            if got[:4] != want4:
                fail(f"{name}: 4 pairs differ from the plain path on the card")
        else:
            if fn is ov.overlap_score_batch:
                best = vb.overlap_fill_codes_banded_batch(*batch, *sc)[1].cpu().numpy()
                if not np.array_equal(got, best):
                    fail(f"{name}: scores differ from overlap_fill_codes's best")
                plain_fn, kname = vb.overlap_scores_banded_batch_plain, "overlap_scores"
            else:
                plain_fn, kname = vb.affine_scores_banded_batch_plain, "gotoh_scores"
            sub = batch if L == L_SHORT else four
            want, ms = cuda_once(lambda: plain_fn(*sub, *sc))
            plain[name] = ms
            e = int(np.abs(got[: len(want)].astype(np.int64) - want.cpu().numpy()).max())
            errs[kname] = max(errs[kname], e)
            log(f"{name} ({src}): {len(got)} scores ({min(got)}-{max(got)}); {sub[0].shape[0]} vs plain: "
                f"max |diff| {e} ({ms:.1f} ms)")
            if e:
                fail(f"{name}: scores differ from the plain path on the card")
        del batch, four
    torch.cuda.empty_cache()
    if any(errs.values()):
        fail(f"an overlap or Gotoh kernel differs from its plain version at full size: {errs}")
    # open == extend with k < 2 open: the Gotoh score is the linear one,
    # held against the Needleman-Wunsch kernels (an independent check)
    lin = af.affine_score_pairs(long_pairs, *mkd, mkd[2])
    nw_scores = NWAligner(AlignConfig(scoring=ScoringParams(*mkd)), device="cuda").align_batch(long_pairs).scores
    log(f"affine_score_pairs 128x{L_LONG}bp at 2 1 1 1 vs align_batch at 2 1 1: "
        f"{'equal' if np.array_equal(lin, nw_scores) else 'DIFFER'} ({min(lin)}-{max(lin)})")
    if not np.array_equal(lin, nw_scores):
        fail("affine_score_pairs with open == extend differs from the linear-gap scores")

    # (c) times: 4 warm runs of each configuration, in turns
    for _ in range(4):
        for name, (fn, pairs, sc, _) in configs.items():
            t0 = time.perf_counter()
            fn(pairs, *sc)
            walls[name].append(time.perf_counter() - t0)
    for name, (_, pairs, _, src) in configs.items():
        med = statistics.median(walls[name][1:])
        cells = sum(len(a) * len(b) for a, b in pairs)
        log(f"e2e {name} ({src}): walls {[round(w, 4) for w in walls[name]]} s (first includes "
            f"warm-up); median warm {med:.4f} s = {len(pairs) / med:.1f} pairs/s, "
            f"{cells / med / 1e9:.2f} GCUPS [{card}]")

    def batch_of(pairs):
        L = len(pairs[0][0])
        return enc.upload(enc.encode_batch(pairs, L, L), dev)

    rec = {}
    b150, b10k = batch_of(short_pairs), batch_of(long_pairs)
    io150 = tensor_bytes(*b150) + 4 * len(short_pairs)

    def overlap_ops(pairs):  # a score a cell, the end window's ops on its len1 + len2 cells a pair
        return sum(len(a) * len(b) * OPS_SCORE + (len(a) + len(b)) * OPS_OVERLAP for a, b in pairs)

    def gotoh_ops(pairs):
        return sum(len(a) * len(b) for a, b in pairs) * OPS_GOTOH

    for kname, fn, sc, ops in (
        ("overlap_scores", vb.overlap_scores_banded_batch, mkd, overlap_ops),
        ("gotoh_scores", vb.affine_scores_banded_batch, gotoh, gotoh_ops),
    ):
        ms_10k = cuda_ms(lambda: fn(*b10k, *sc), 2)
        b_10k = bound(ops(long_pairs), tensor_bytes(*b10k) + 4 * 128)
        cfg = "overlap_score" if kname == "overlap_scores" else "gotoh_score"
        rec[kname] = dict(
            ms=cuda_ms(lambda: fn(*b150, *sc), 20), plain_ms=plain[f"{cfg}10240x150"],
            **bound(ops(short_pairs), io150),
            shape=(f"{len(short_pairs)}x{L_SHORT}bp scores (at 128x{L_LONG}bp: {ms_10k:.3f} ms, "
                   f"bound {b_10k['bound_ms']:.3f} ms {b_10k['bound_by']}, plain {plain[f'{cfg}128x10240']:.1f} ms "
                   f"at 4 pairs)"),
        )
    shapes = [(f"{kname} {len(b[0])}x{L}bp", mode, b, reps)
              for kname, mode in (("overlap_scores", "overlap"), ("gotoh_scores", "gotoh"))
              for b, L, reps in ((b10k, L_LONG, 2), (b150, L_SHORT, 20))]
    turns = list(pipe_turns(card, shapes).values())
    pipe_sweep(card, [shapes[0][:3], shapes[2][:3]])  # at 128 x 10 240 bp
    for kname, (w10k, one10k, _), (w150, one150, _) in (("overlap_scores", *turns[:2]), ("gotoh_scores", *turns[2:])):
        rec[kname].update(warps=w150, one_warp_ms=statistics.median(one150))
        rec[kname]["shape"] += (f"; {w150} warp(s) a pair, at 128x{L_LONG}bp W = {w10k}, W = 1 "
                                f"{statistics.median(one10k):.3f} ms in turns")
    del b10k
    pairs3k = configs["overlap_align128x3072"][1]
    b3k = batch_of(pairs3k)
    cells = len(pairs3k) * L_SW_TB * L_SW_TB
    ms_fill = cuda_ms(lambda: vb.overlap_fill_codes_banded_batch(*b3k, *mkd), 3)
    codes, best, js, is_ = vb.overlap_fill_codes_banded_batch(*b3k, *mkd)
    ms_walk = cuda_ms(lambda: tb.walk_sw_codes_batch(codes, js, is_), 5)
    steps = int(tb.walk_sw_codes_batch(codes, js, is_)[1].sum())
    k4_fill, k4_walk = kern4["overlap_align128x3072"]
    p_fill, p_walk = plain["overlap_align128x3072"]
    rec["overlap_fill_codes"] = dict(
        ms=ms_fill, plain_ms=p_fill,
        **bound(cells * (OPS_SCORE + OPS_OVERLAP + OPS_OVERLAP_ARGMAX + OPS_CODE),
                tensor_bytes(*b3k, codes, best, js, is_)),
        shape=f"128x{L_SW_TB}bp codes+best+argmax (plain_ms at 4x{L_SW_TB}bp, kernel there {k4_fill:.3f} ms)",
    )
    walk_bound = bound(steps * OPS_WALK_STEP, tensor_bytes(js, is_) + 12 * len(pairs3k) + 5 * steps)
    del codes
    b4k = batch_of(configs["overlap_align4096x150"][1])
    ms_fill150 = cuda_ms(lambda: vb.overlap_fill_codes_banded_batch(*b4k, *mkd), 10)
    for name in rec:
        rec[name].update(launches=launches[name], max_abs_err=errs[name])
        log(f"{name}: {rec[name]['ms']:.3f} ms at {rec[name]['shape']}, bound {rec[name]['bound_ms']:.4f} ms "
            f"({rec[name]['bound_by']}), plain {rec[name]['plain_ms']:.1f} ms [{card}]")
    log(f"sw_walk on overlap codes 128x{L_SW_TB}bp: {ms_walk:.3f} ms, {steps} steps, bound "
        f"{walk_bound['bound_ms']:.4f} ms ({walk_bound['bound_by']}), plain {p_walk:.1f} ms at 4 pairs "
        f"(kernel there {k4_walk:.3f} ms) [{card}]")
    log(f"overlap_fill_codes 4096x{L_SHORT}bp: {ms_fill150:.3f} ms [{card}]")
    log(f"phase 10 peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase seconds {time.perf_counter() - t_phase:.1f} [{card}]")
    walk = dict(launches=launches["sw_walk"], max_abs_err=errs["sw_walk"], ms=ms_walk)
    return rec, walk


def gotoh_kernels_vs_plain(dev, errs):
    """Phase 11 (a): ``gotoh_fill_codes`` (codes, scores, corner states)
    and ``gotoh_walk`` bit for bit against their plain versions on the
    card, every scoring; the scores also against ``gotoh_scores``."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.ops import variants_banded as vb

    pairs = variant_pairs(10, EDGE)
    L1 = max(len(a) for a, _ in pairs)
    L2 = max(len(b) for _, b in pairs)
    batch = enc.upload(enc.encode_batch(pairs, L1, L2), dev)
    _, _, l1, l2 = batch
    errs.setdefault("gotoh_fill_codes", 0)
    errs.setdefault("gotoh_walk", 0)
    for sc in GOTOH_ALIGN_SCORINGS:
        want = vb.affine_fill_codes_banded_batch_plain(*batch, *sc)
        walk_p = tb.walk_gotoh_codes_batch_plain(want[0], l1, l2, want[2], L1 + L2)
        e_f = e_w = 0
        for W in (*PIPE_WARPS, None):
            got = pipe_fill("gotoh_codes", batch, sc, W)
            e_f = max([e_f] + [max_abs_err(g, w) for g, w in zip(got, want)]
                      + [max_abs_err(got[1], vb.affine_scores_banded_batch(*batch, *sc))])
            walk_k = tb.walk_gotoh_codes_batch(got[0], l1, l2, got[2], L1 + L2)
            e_w = max([e_w] + [max_abs_err(g, w) for g, w in zip(walk_k, walk_p)])
        torch.cuda.synchronize()
        errs["gotoh_fill_codes"] = max(errs["gotoh_fill_codes"], e_f)
        errs["gotoh_walk"] = max(errs["gotoh_walk"], e_w)
        log(f"Gotoh codes and walk vs plain at W in {PIPE_WARPS} and the rule's "
            f"{pipe_rule('gotoh_codes', batch)}, {len(pairs)} pairs {L1}x{L2}, m k open extend = {sc}: "
            f"gotoh_fill_codes {e_f} gotoh_walk {e_w}")
    if any(errs.values()):
        fail(f"a Gotoh traceback kernel differs from its plain version: {errs}")


def affine_rescore(pairs, aligned, m, k, op, ex) -> np.ndarray:
    """Host re-score of Gotoh alignments in Python ints: a gap run of
    length L costs op + (L-1)*ex; also checks that each aligned string is
    its input with gaps added."""
    out = np.zeros(len(pairs), np.int64)
    rescore(pairs, aligned, 0, 0, 0)  # spelling checks only
    for b, (X, Y) in enumerate(aligned):
        x = np.frombuffer(X, np.uint8)
        y = np.frombuffer(Y, np.uint8)
        gx, gy = x == ord("-"), y == ord("-")
        match = ~gx & ~gy & (x == y)
        score = m * int(match.sum()) - k * int((~gx & ~gy & ~match).sum())
        for g in (gx, gy):
            runs = int((g & ~np.concatenate([[False], g[:-1]])).sum())
            score -= runs * op + (int(g.sum()) - runs) * ex
        out[b] = score
    return out


def gotoh_phase(card, bound, c3_strings):
    """Phase 11: Gotoh tracebacks and the batch CLI.  ``c3_strings`` is
    config 3's (ops, ops_len, pairs), for the host strings' times.
    Returns each new kernel's record fields."""
    import tempfile

    from nw_tpu_torch import batch_cli
    from nw_tpu_torch.models import affine as af
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.ops import variants_banded as vb
    from nw_tpu_torch.runtime import kernels, native

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    if native.load() is None:
        fail("the native runtime (nw_tpu_torch/runtime/cc) did not build or load")
    errs = {}
    gotoh_kernels_vs_plain(dev, errs)

    rng = np.random.default_rng(14)
    sc = (2, 1, 3, 1)
    configs = {  # name: (pairs, source)
        "gotoh_align128x3072": (rand_pairs(rng, 128, L_SW_TB, L_SW_TB), "bench.py:414"),
        "gotoh_align4096x150": (rand_pairs(rng, 4096, L_SHORT, L_SHORT), "bench.py:291"),
    }
    wrappers = {"gotoh_fill_codes": vb.affine_fill_codes_banded_batch, "gotoh_walk": tb.walk_gotoh_codes_batch}
    # (b) the main path, every launch counter from 0
    for w in wrappers.values():
        w.launches = 0
    results, walls = {}, {}
    for name, (pairs, _) in configs.items():
        t0 = time.perf_counter()
        results[name] = af.affine_align_batch(pairs, *sc)
        walls[name] = [time.perf_counter() - t0]
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    log(f"Gotoh traceback main path launches: {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the Gotoh traceback path never launched: {launches}")

    # every alignment spells its inputs and re-scores to its score, every
    # score is gotoh_scores's; 4 pairs of each against the plain path
    plain, kern4 = {}, {}
    for name, (pairs, src) in configs.items():
        got = results[name]
        scores = np.array([g[0] for g in got], np.int64)
        if not np.array_equal(scores, af.affine_score_pairs(pairs, *sc).astype(np.int64)):
            fail(f"{name}: a score differs from affine_score_pairs (gotoh_scores)")
        if not np.array_equal(affine_rescore(pairs, [g[1:] for g in got], *sc), scores):
            fail(f"{name}: an alignment does not re-score to its score")
        L = len(pairs[0][0])
        four = enc.upload(enc.encode_batch(pairs[:4], L, L), dev)
        _, _, l1, l2 = four
        codes, sc4, st4 = vb.affine_fill_codes_banded_batch(*four, *sc)
        kern4[name] = (cuda_ms(lambda: vb.affine_fill_codes_banded_batch(*four, *sc), 2),
                       cuda_ms(lambda: tb.walk_gotoh_codes_batch(codes, l1, l2, st4, 2 * L), 2))
        p_fill, ms_fill = cuda_once(lambda: vb.affine_fill_codes_banded_batch_plain(*four, *sc))
        p_walk, ms_walk = cuda_once(lambda: tb.walk_gotoh_codes_batch_plain(p_fill[0], l1, l2, p_fill[2], 2 * L))
        plain[name] = (ms_fill, ms_walk)
        strs = tb.ops_to_strings_batch(*(t.cpu().numpy() for t in p_walk), pairs[:4])
        want4 = [(int(p_fill[1][b]), X, Y) for b, (X, Y) in enumerate(strs)]
        e_f = max(max_abs_err(g, w) for g, w in zip((codes, sc4, st4), p_fill))
        e_w = max(max_abs_err(g, w) for g, w in zip(tb.walk_gotoh_codes_batch(codes, l1, l2, st4, 2 * L), p_walk))
        errs["gotoh_fill_codes"] = max(errs["gotoh_fill_codes"], e_f)
        errs["gotoh_walk"] = max(errs["gotoh_walk"], e_w)
        lens = [len(g[1]) for g in got]
        log(f"{name} ({src}): {len(got)} alignments spell their inputs, re-score to their scores "
            f"({min(scores)}-{max(scores)}, {min(lens)}-{max(lens)} columns) and equal gotoh_scores's; "
            f"4 pairs vs plain: {'equal' if got[:4] == want4 else 'DIFFER'}, kernels max |diff| {e_f} {e_w} "
            f"(plain fill {ms_fill:.1f} ms, walk {ms_walk:.1f} ms)")
        if got[:4] != want4:
            fail(f"{name}: 4 pairs differ from the plain path on the card")
        del four, codes, p_fill, p_walk
    torch.cuda.empty_cache()
    if any(errs.values()):
        fail(f"a Gotoh traceback kernel differs from its plain version at full size: {errs}")

    # the batch CLI in all four modes, on the card against NW_TPU_PLATFORM=cpu
    cli_pairs = rand_pairs(np.random.default_rng(15), 24, 1, 300) + rand_pairs(
        np.random.default_rng(16), 6, 20, 120, b"AC"
    )
    cases = [
        ["--mode", "nw", "--counts", "--alignments", "-m", "2", "-k", "1", "-d", "1", "--chunk", "8"],
        ["--mode", "sw", "--alignments", "-m", "2", "-k", "1", "-d", "1", "--sort-by-length"],
        ["--mode", "overlap", "--alignments", "-m", "2", "-k", "1", "-d", "1"],
        ["--mode", "affine", "--alignments", "-m", "2", "-k", "1", "--open", "3", "--extend", "1",
         "--chunk", "8"],
        ["--mode", "affine", "-m", "2", "-k", "1", "--open", "3", "--extend", "1"],
    ]
    saved = os.environ.pop("NW_TPU_PLATFORM", None)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD) as tmp:
        src = os.path.join(tmp, "pairs.txt")
        with open(src, "wb") as f:
            f.write(b"".join(a + b" " + b + b"\n" for a, b in cli_pairs))

        def run(args, out, platform=None):
            if platform:
                os.environ["NW_TPU_PLATFORM"] = platform
            try:
                rc = batch_cli.main(["--pairs", src, "--out", os.path.join(tmp, out), *args])
            finally:
                os.environ.pop("NW_TPU_PLATFORM", None)
            with open(os.path.join(tmp, out), "rb") as f:
                return rc, f.read()

        for i, args in enumerate(cases):
            got, want = run(args, f"card{i}.tsv"), run(args, f"cpu{i}.tsv", "cpu")
            ck = ["--checkpoint-dir", os.path.join(tmp, f"ck{i}")]
            first, resumed = run([*args, *ck], f"ck{i}a.tsv"), run([*args, *ck], f"ck{i}b.tsv")
            if got != want or got[0] != 0 or first != got or resumed != got:
                fail(f"nw-tpu-torch-batch {args}: the card, the CPU and the resumed run differ")
        res = subprocess.run(
            [sys.executable, "-m", "nw_tpu_torch.batch_cli", "--pairs", src, *cases[3]],
            capture_output=True, timeout=300,
        )
        if res.returncode != 0 or res.stdout != run(cases[3], "cpu3.tsv", "cpu")[1]:
            fail(f"python3 -m nw_tpu_torch.batch_cli on the card: rc {res.returncode} {res.stderr[-2000:]!r}")
    if saved is not None:
        os.environ["NW_TPU_PLATFORM"] = saved
    log(f"nw-tpu-torch-batch, {len(cli_pairs)} pairs of 1-300 bp, {len(cases)} runs in all four modes "
        "(--counts, --alignments, --chunk, --sort-by-length): the card equals NW_TPU_PLATFORM=cpu byte "
        "for byte, resumed through --checkpoint-dir too; python3 -m nw_tpu_torch.batch_cli as well")

    # (c) times: 4 warm runs of each configuration, in turns
    for _ in range(4):
        for name, (pairs, _) in configs.items():
            t0 = time.perf_counter()
            af.affine_align_batch(pairs, *sc)
            walls[name].append(time.perf_counter() - t0)
    for name, (pairs, src) in configs.items():
        med = statistics.median(walls[name][1:])
        cells = sum(len(a) * len(b) for a, b in pairs)
        log(f"e2e {name} ({src}): walls {[round(w, 4) for w in walls[name]]} s (first includes "
            f"warm-up); median warm {med:.4f} s = {len(pairs) / med:.1f} pairs/s, "
            f"{cells / med / 1e9:.2f} GCUPS [{card}]")

    rec = {}
    pairs3k = configs["gotoh_align128x3072"][0]
    b3k = enc.upload(enc.encode_batch(pairs3k, L_SW_TB, L_SW_TB), dev)
    _, _, l1, l2 = b3k
    cells = len(pairs3k) * L_SW_TB * L_SW_TB
    ms_fill = cuda_ms(lambda: vb.affine_fill_codes_banded_batch(*b3k, *sc), 3)
    codes, scores, states = vb.affine_fill_codes_banded_batch(*b3k, *sc)
    S = 2 * L_SW_TB
    ms_walk = cuda_ms(lambda: tb.walk_gotoh_codes_batch(codes, l1, l2, states, S), 5)
    ops, n = tb.walk_gotoh_codes_batch(codes, l1, l2, states, S)
    steps = int(n.sum())
    k4_fill, k4_walk = kern4["gotoh_align128x3072"]
    p_fill, p_walk = plain["gotoh_align128x3072"]
    rec["gotoh_fill_codes"] = dict(
        ms=ms_fill, plain_ms=p_fill,
        **bound(cells * (OPS_GOTOH + OPS_GOTOH_CODE), tensor_bytes(*b3k, codes, scores, states)),
        shape=f"128x{L_SW_TB}bp codes+scores+states (plain_ms at 4x{L_SW_TB}bp, kernel there {k4_fill:.3f} ms)",
    )
    rec["gotoh_walk"] = dict(
        ms=ms_walk, plain_ms=p_walk,
        **bound(steps * OPS_WALK_STEP, tensor_bytes(l1, l2, states, n) + 5 * steps),
        shape=f"128x{L_SW_TB}bp, {steps} steps (plain_ms at 4x{L_SW_TB}bp, kernel there {k4_walk:.3f} ms)",
    )
    ns_step = ms_walk * 1e6 / (steps / len(pairs3k))
    log(f"gotoh_walk 128x{L_SW_TB}bp: {steps} steps, {ns_step:.1f} ns a step of one walk; codes "
        f"{tensor_bytes(codes) / 1e9:.3f} GB [{card}]")
    del codes, ops
    pairs150 = configs["gotoh_align4096x150"][0]
    b150 = enc.upload(enc.encode_batch(pairs150, L_SHORT, L_SHORT), dev)
    ms_fill150 = cuda_ms(lambda: vb.affine_fill_codes_banded_batch(*b150, *sc), 10)
    codes150, _, st150 = vb.affine_fill_codes_banded_batch(*b150, *sc)
    ops150, n150 = (t.cpu().numpy() for t in tb.walk_gotoh_codes_batch(codes150, b150[2], b150[3], st150, 2 * L_SHORT))
    log(f"gotoh_fill_codes 4096x{L_SHORT}bp: {ms_fill150:.3f} ms, bound "
        f"{bound(len(pairs150) * L_SHORT * L_SHORT * (OPS_GOTOH + OPS_GOTOH_CODE), tensor_bytes(*b150, codes150))['bound_ms']:.4f} ms [{card}]")
    del codes150
    shapes = [(f"gotoh_fill_codes {len(b[0])}x{L}bp", "gotoh_codes", b, reps)
              for b, L, reps in ((b3k, L_SW_TB, 2), (b150, L_SHORT, 10))]
    (w3k, one3k, _), (w150, one150, _) = pipe_turns(card, shapes).values()
    pipe_sweep(card, [shapes[0][:3]])
    rec["gotoh_fill_codes"].update(warps=w3k, one_warp_ms=statistics.median(one3k))
    rec["gotoh_fill_codes"]["shape"] += (f"; {w3k} warps a pair, W = 1 {statistics.median(one3k):.3f} ms in "
                                         f"turns; at 4096x{L_SHORT}bp W = {w150}, {statistics.median(one150):.3f} ms")
    for name in rec:
        rec[name].update(launches=launches[name], max_abs_err=errs[name])
        log(f"{name}: {rec[name]['ms']:.3f} ms at {rec[name]['shape']}, bound {rec[name]['bound_ms']:.4f} ms "
            f"({rec[name]['bound_by']}), plain {rec[name]['plain_ms']:.1f} ms [{card}]")

    # host strings: the native builder against the numpy path
    for name, (o, ns, ps) in (("config3 256x10240bp", c3_strings), (f"gotoh 4096x{L_SHORT}bp", (ops150, n150, pairs150))):
        t = {}
        for route, fn in (("native", tb.ops_to_strings_batch), ("numpy", tb.ops_to_strings_batch_plain),
                          ("native", tb.ops_to_strings_batch), ("numpy", tb.ops_to_strings_batch_plain)):
            t0 = time.perf_counter()
            out = fn(o, ns, ps)
            t.setdefault(route, []).append((time.perf_counter() - t0) * 1e3)
            t.setdefault(f"{route}_out", out)
        if t["native_out"] != t["numpy_out"]:
            fail(f"ops_to_strings_batch {name}: the native builder differs from numpy")
        log(f"host ops_to_strings_batch {name}: native {[round(x, 2) for x in t['native']]} ms, numpy "
            f"{[round(x, 2) for x in t['numpy']]} ms, equal strings [{card}]")
    log(f"phase 11 peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"phase seconds {time.perf_counter() - t_phase:.1f} [{card}]")
    return rec


# phase 12: every launch counter of the sharded path, read in each rank
# (module, wrapper, attribute) -> record name
SHARDED_COUNTERS = {
    ("nw_tpu_torch.ops.fill_single", "fill_tile", "launches"): "nw_fill_tile",
    ("nw_tpu_torch.ops.fill_single", "fill_tile", "score_launches"): "nw_fill_tile/scores",
    ("nw_tpu_torch.ops.fill_single", "fill_tile", "mask_launches"): "nw_fill_tile/masks",
    ("nw_tpu_torch.ops.traceback", "walk_masks_window", "launches"): "nw_walk_window/masks",
    ("nw_tpu_torch.ops.traceback", "walk_codes_window", "launches"): "nw_walk_window (relay)",
    ("nw_tpu_torch.ops.fill_banded", "fill_scores_banded_batch", "launches"): "nw_scores (ranks)",
    ("nw_tpu_torch.ops.fill_banded", "fill_scores_counts_banded_batch", "launches"):
        "nw_fill_codes (ranks)",
}
TILE_MODES = {"codes": "nw_fill_tile", "scores": "nw_fill_tile/scores", "masks": "nw_fill_tile/masks"}
L_TILE = 3000  # phase 12 (a): the pair whose 4 row blocks x 5 chunks are checked
L_PALLAS = 20_000  # phase 12 (b): the masks engine's pair, 4 ranks


def tile_table(mode, A, H):
    """A zeroed table of H rows for the tile ``mode``: 2-bit codes, tie
    masks or (scores) none."""
    from nw_tpu_torch.ops.fill_scan import code_shape

    if mode == "codes":
        return torch.zeros(code_shape(1, A, H), dtype=torch.int32, device="cuda")
    if mode == "masks":
        return torch.zeros((H, A + 1), dtype=torch.uint8, device="cuda")
    return None


def first_tile(tile, top, side, mkd, C, halo, left, mode, table):
    """``tile`` (``fill_tile`` or ``fill_tile_plain``) on columns 1 .. C
    of ``side``'s rows into ``table``: (right, bottom, corner)."""
    codes, masks = (table, None) if mode == "codes" else (None, table)
    return tile(top, side, *mkd, 0, C, halo, left, codes, masks)


def decode_codes(codes, A, rows):
    """Band-major 2-bit codes -> their cells, int64[rows, A+1]."""
    r = torch.arange(rows, device=codes.device)[:, None]
    t = torch.arange(A + 1, device=codes.device)[None, :] + (r & 31)
    w = codes[0][r >> 5, t >> 4, r & 31].to(torch.int64) & 0xFFFFFFFF
    return (w >> (2 * (t & 15))) & 3


def tiles_vs_plain(pair, mkd, H, C, errs, plain_tiles=True):
    """Phase 12 (a): the tiles of ``pair`` chained over blocks of H rows
    and chunks of C columns in one process, in all three modes: the
    stitched codes against ``nw_fill_codes_single``'s, the masks against
    ``nw_fill_masks``'s, the scores mode's last row against the codes
    mode's; with ``plain_tiles`` every table, edge and corner against the
    plain tile's (on the host CPU); the masks relayed by the walk's masks
    mode against its plain version and ``nw_walk``.  Returns {record
    name: (plain ms, kernel ms)} of the chains."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.parallel import huge_pair as hp

    top, side = (torch.from_numpy(enc.encode(x)) for x in pair)
    tc, sc = top.cuda(), side.cuda()
    A, B = len(pair[0]), len(pair[1])
    whole, score = fs.fill_codes_single(tc, sc, *mkd)
    masks = fb.fill_arrows_banded_single(tc, sc, *mkd)[0]
    got = {}
    for mode, name in TILE_MODES.items():
        got[mode] = hp.chain_tiles(tc, sc, *mkd, H, C, mode)
        tables, last, corner = got[mode]
        e = abs(corner - int(score)) + max_abs_err(last, got["codes"][1])
        if mode == "codes":
            if H % 32 == 0:
                e = max(e, max_abs_err(torch.cat(tables, 1), whole))
            cells = torch.cat([decode_codes(t, A, min(H, B - p * H)) for p, t in enumerate(tables)])
            e = max(e, max_abs_err(cells, decode_codes(whole, A, B)))
        if mode == "masks":
            e = max(e, max_abs_err(torch.cat(tables), masks[1:]))
        if plain_tiles:
            want = hp.chain_tiles(top, side, *mkd, H, C, mode, tile=fs.fill_tile_plain)
            e = max([e, abs(corner - want[2]), max_abs_err(last, want[1])]
                    + [max_abs_err(g, w) for g, w in zip(tables, want[0]) if w is not None])
        errs[name] = max(errs[name], e)
    # the masks relayed from the corner's block down to row 0
    S = max(A + B, 1)
    ops = {}
    for walk, where in ((tb.walk_masks_window, "cuda"), (tb.walk_masks_window_plain, "cpu")):
        state = torch.tensor([A, B, 0], dtype=torch.int32, device=where)
        ops[where] = torch.full((S,), tb.OP_NONE, dtype=torch.int8, device=where)
        for p in range(len(got["masks"][0]) - 1, -1, -1):
            walk(got["masks"][0][p].to(where), state, p * H, ops[where])
        ops[where + " end"] = state.tolist()
    l1, l2 = (torch.tensor([x], dtype=torch.int32, device="cuda") for x in (A, B))
    want_ops, n = tb.walk_codes_batch(whole, l1, l2, S)
    e = max(max_abs_err(ops["cuda"], ops["cpu"]), max_abs_err(ops["cuda"], want_ops[0]),
            int(ops["cuda end"] != ops["cpu end"] or ops["cpu end"] != [0, 0, int(n[0])]))
    errs["nw_walk_window/masks"] = max(errs["nw_walk_window/masks"], e)


def sharded_phase(card, bound):
    """Phase 12: sharded runs.  Returns the new kernels' record fields."""
    from concurrent.futures import ThreadPoolExecutor

    from nw_tpu_torch.parallel.workers import RankGroup

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    errs = {name: 0 for name in (*TILE_MODES.values(), "nw_walk_window/masks")}
    # the ranks start while (a) runs: 1 on NCCL, 2 and 4 on gloo sharing the card
    starts = {}

    def start(key, world, backend):
        t0 = time.perf_counter()
        group = RankGroup(world, backend, "cuda", timeout=300)
        starts[key] = time.perf_counter() - t0
        return group

    pool = ThreadPoolExecutor(3)
    pending = {key: pool.submit(start, key, w, b)
               for key, w, b in (("1 nccl", 1, "nccl"), ("2 gloo", 2, "gloo"), ("4 gloo", 4, "gloo"))}

    # (a) the tiles and the mask walk against their plain versions
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    p3k = rand_pairs(rng, 1, L_TILE, L_TILE)[0]
    small = rand_pairs(rng, 3, 1, 160) + rand_pairs(rng, 1, 100, 160, b"AC") + [p for p in EDGE if p[1]]
    H3k = 768  # 4 row blocks, a multiple of 32: the stitched codes are nw_fill_codes_single's
    for mkd in SCORINGS:
        tiles_vs_plain(p3k, mkd, H3k, 700, errs, plain_tiles=mkd == (2, 1, 1))
        for pair in small:
            tiles_vs_plain(pair, mkd, -(-len(pair[1]) // 4), 45, errs)
    log(f"phase 12 (a) tiles vs plain: a {L_TILE} bp pair in 4 blocks of {H3k} rows x chunks of 700 "
        f"columns (every mode vs nw_fill_codes_single / nw_fill_masks under every scoring, vs the plain "
        f"tile at 2 1 1) and {len(small)} pairs of 1-160 bp in 4 blocks x chunks of 45 (vs the plain tile "
        f"under every scoring): max |diff| {errs} in {time.perf_counter() - t0:.1f} s")
    if any(errs.values()):
        fail(f"a tile mode or the mask walk differs from its plain version: {errs}")

    # (b) the path at full width, (c) the data-parallel batch
    groups = {}
    try:
        for key, f in pending.items():
            groups[key] = f.result()
        pool.shutdown()
        return sharded_path(card, bound, groups, starts, errs, t_phase)
    finally:
        for g in groups.values():
            g.close(kill=True)


def path_tiles_vs_plain(card, bound, big, launches, errs):
    """Phase 12 (d): the kernels at the path's shapes against their plain
    versions on the same inputs, timed.  Returns their record fields."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.parallel import huge_pair as hp

    dev = torch.device("cuda")
    # each tile mode on its rank 0's first tile of the path (real edges: row 0, column 0)
    rec = {}
    t_all, s_all = (torch.from_numpy(enc.encode(x)).to(dev) for x in big)
    mkd = (2, 1, 1)
    plain_runs = {}  # (ranks, L) -> (plain ms, its outputs): the codes mode's edges are the scores mode's
    for name, mode, world, L in (("nw_fill_tile", "codes", 2, L_HUGE),
                                 ("nw_fill_tile/scores", "scores", 2, L_HUGE),
                                 ("nw_fill_tile/masks", "masks", 4, L_PALLAS)):
        top, side = t_all[:L], s_all[:L]
        H, nch, _ = hp.tile_geometry(L, L, world, hp.tile_chunk(L, L, world))
        C = min(hp.tile_chunk(L, L, world), L)
        halo = torch.arange(0, -(C + 1), -1, dtype=torch.int32, device=dev)
        left = torch.arange(-1, -(H + 1), -1, dtype=torch.int32, device=dev)
        table = tile_table(mode, L, H)
        ms = cuda_ms(lambda: first_tile(fs.fill_tile, top, side[:H], mkd, C, halo, left, mode, table), 2)
        table = tile_table(mode, L, H)
        got = first_tile(fs.fill_tile, top, side[:H], mkd, C, halo, left, mode, table)
        if (world, L) not in plain_runs:
            want_table = tile_table(mode, L, H)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = first_tile(fs.fill_tile_plain, top, side[:H], mkd, C, halo, left, mode, want_table)
            torch.cuda.synchronize()
            plain_runs[world, L] = ((time.perf_counter() - t0) * 1e3, want, want_table)
        p_ms, want, want_table = plain_runs[world, L]
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        if table is not None:
            e = max(e, 0 if torch.equal(table, want_table) else max_abs_err(table, want_table))
        errs[name] = max(errs[name], e)
        cells = H * C
        ops_cell = OPS_SCORE + (OPS_CODE if mode != "scores" else 0)
        out_bytes = {"codes": cells // 4, "scores": 0, "masks": cells}[mode]
        in_bytes = 4 * (C + H + C + 1 + H)  # top chunk, side rows, halo, left
        rec[name] = dict(
            ms=ms, **bound(cells * ops_cell, in_bytes + out_bytes + 4 * (H + C + 1)),
            plain_ms=p_ms, launches=launches[name], max_abs_err=errs[name],
            shape=f"one tile of {H} rows x {C} columns (rank 0's first of {nch} at {world} ranks, "
                  f"{L} bp); plain_ms: fill_tile_plain on the card on the same inputs"
                  + (", in codes mode (its edges are this mode's)" if mode == "scores" else ""),
        )
        del table, got
    del plain_runs, want, want_table
    torch.cuda.empty_cache()
    # the 1-rank path's one tile (the whole pair) against nw_fill_codes_single, which it generalises
    row0 = torch.arange(0, -(L_HUGE + 1), -1, dtype=torch.int32, device=dev)
    table = tile_table("codes", L_HUGE, L_HUGE)
    ms_whole = cuda_ms(lambda: first_tile(fs.fill_tile, t_all, s_all, mkd, L_HUGE, row0, row0[1:].clone(),
                                         "codes", table), 2)
    whole, score = fs.fill_codes_single(t_all, s_all, *mkd)
    ms_single = cuda_ms(lambda: fs.fill_codes_single(t_all, s_all, *mkd), 2)
    corner = first_tile(fs.fill_tile, t_all, s_all, mkd, L_HUGE, row0, row0[1:].clone(), "codes", table)[2]
    if not torch.equal(table, whole) or int(corner) != int(score):
        fail("the 1-rank tile's codes or corner differ from nw_fill_codes_single's")
    log(f"1-rank tile (the whole {L_HUGE} bp pair, codes) {ms_whole:.3f} ms against nw_fill_codes_single "
        f"{ms_single:.3f} ms: codes and corner equal [{card}]")
    rec["nw_fill_tile"].update(one_rank_tile_ms=ms_whole, fill_codes_single_ms=ms_single)
    del table, whole
    torch.cuda.empty_cache()
    # the mask walk relayed over the 20 kb pair's 4 blocks of K28 masks, against its plain relay
    H = -(-L_PALLAS // 4)
    tables, _, _ = hp.chain_tiles(t_all[:L_PALLAS], s_all[:L_PALLAS], *mkd, H,
                                  hp.tile_chunk(L_PALLAS, L_PALLAS, 4), "masks")

    def relay(walk, where):
        state = torch.tensor([L_PALLAS, L_PALLAS, 0], dtype=torch.int32, device=where)
        ops = torch.full((2 * L_PALLAS,), tb.OP_NONE, dtype=torch.int8, device=where)
        for p in range(len(tables) - 1, -1, -1):
            walk(tables[p] if where == "cuda" else tables[p].cpu(), state, p * H, ops)
        return state, ops

    ms_walk = cuda_ms(lambda: relay(tb.walk_masks_window, "cuda"), 2)
    k_state, k_ops = relay(tb.walk_masks_window, "cuda")
    steps = int(k_state[2])
    t0 = time.perf_counter()
    p_state, p_ops = relay(tb.walk_masks_window_plain, "cpu")
    plain_walk = (time.perf_counter() - t0) * 1e3
    errs["nw_walk_window/masks"] = max(errs["nw_walk_window/masks"], max_abs_err(k_ops, p_ops),
                                       max_abs_err(k_state, p_state))
    rec["nw_walk_window/masks"] = dict(
        ms=ms_walk, **bound(steps * OPS_WALK_STEP, steps * 2),
        plain_ms=plain_walk, launches=launches["nw_walk_window/masks"],
        max_abs_err=errs["nw_walk_window/masks"],
        shape=f"{L_PALLAS}bp, {steps} steps relayed over 4 blocks of {H} rows of tie masks "
              f"(plain_ms: the plain relay on the host CPU, ops and state compared)",
    )
    del tables
    torch.cuda.empty_cache()
    return rec


def sharded_path(card, bound, groups, starts, errs, t_phase):
    """Phase 12 (b), (c) on the started rank groups, then (d) the kernels
    at the path's tile shapes against their plain versions, and their
    times."""
    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.parallel import data_parallel as dpar
    from nw_tpu_torch.parallel import huge_pair as hp
    from nw_tpu_torch.parallel.workers import MESH, PerRank, launch_counts

    log(f"rank groups started (s, concurrently with (a)): { {k: round(v, 1) for k, v in starts.items()} }")
    a211 = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")
    big = rand_pairs(np.random.default_rng(L_HUGE), 1, L_HUGE, L_HUGE)[0]  # phase 8's pair
    ref = a211.align_huge(*big)
    p20 = (big[0][:L_PALLAS], big[1][:L_PALLAS])
    ref20 = a211.align_huge(*p20)
    rng = np.random.default_rng(L_SHORT)
    c2 = rand_pairs(rng, 10240, L_SHORT, L_SHORT)
    refs_dp = {wc: a211.align_batch(c2, count=wc) for wc in (False, True)}
    tops, sides, l1, l2 = enc.encode_batch(c2, L_SHORT, L_SHORT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counters = list(SHARDED_COUNTERS)
    for g in groups.values():  # every rank's counters to 0 just before the path
        g.run(launch_counts, counters, reset=True)
    runs = {}  # each run twice: a rank's first launch of a kernel loads it
    for key, pair, want, engine in (("1 nccl", big, ref, None), ("2 gloo", big, ref, None),
                                    ("4 gloo, engine pallas", p20, ref20, "pallas")):
        group = groups[key.split(",")[0]]
        for rep in ("cold", "warm"):
            t0 = time.perf_counter()
            res = group.run_timed(hp.huge_pair_align_sharded, enc.encode(pair[0]), enc.encode(pair[1]),
                                  2, 1, 1, MESH, engine=engine, timeout=600)
            runs[f"{key} ({rep})"] = (time.perf_counter() - t0, res)
            for r, _, _ in res:
                if tb.ops_to_strings(r.ops, r.n, *pair) != (want.X, want.Y) or r.score != want.score:
                    fail(f"huge_pair_align_sharded on {key} ({len(pair[0])} bp) differs from align_huge")
        scores = group.run(hp.huge_pair_score_sharded, enc.encode(pair[0]), enc.encode(pair[1]),
                           2, 1, 1, MESH, engine=engine, timeout=600)
        if scores != [want.score] * len(res):
            fail(f"huge_pair_score_sharded on {key}: {scores} != {want.score}")
    dp_walls = {}
    for key in ("1 nccl", "2 gloo"):
        n = groups[key].world_size
        shards = [PerRank(np.split(x, n)) for x in (tops, sides, l1, l2)]
        for wc, want in refs_dp.items():
            t0 = time.perf_counter()
            out = groups[key].run(dpar.align_batch_sharded, *shards, m=2, k=1, d=1, mesh=MESH,
                                  axis="seq", with_counts=wc, timeout=600)
            dp_walls[key, wc] = time.perf_counter() - t0
            cells = int((l1.astype(np.int64) * l2).sum())
            for scores, stats in out:
                exact = {"pairs": len(c2), "score_sum": int(want.scores.astype(np.int64).sum()),
                         "score_min": int(want.scores.min()), "score_max": int(want.scores.max()),
                         "cells": cells}
                if wc:
                    exact["solutions"] = int(want.counts.astype(np.int64).sum()) % 2**32
                if not np.array_equal(scores.numpy(), want.scores) or \
                        {k: int(v) for k, v in stats.items()} != exact:
                    fail(f"align_batch_sharded on {key} (counts {wc}) differs from align_batch")
    launches = {name: 0 for name in SHARDED_COUNTERS.values()}
    for g in groups.values():
        for got in g.run(launch_counts, counters):
            for c, v in zip(counters, got):
                launches[SHARDED_COUNTERS[c]] += v
    log(f"sharded path launches (all ranks): {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the sharded path never launched: {launches}")
    log(f"huge_pair_align_sharded {L_HUGE} bp (2 1 1), score {ref.score}: ops equal align_huge's "
        f"codes route on 1 rank (NCCL) and 2 ranks (gloo, one card); engine='pallas' at {L_PALLAS} bp "
        f"on 4 ranks equals align_huge there; huge_pair_score_sharded equal")
    for key, (wall, res) in runs.items():
        log(f"sharded {key}: wall {wall:.3f} s; per rank " + "; ".join(
            f"rank {p}: {sec:.3f} s, fill {r.timings['fill']:.3f} (halo staging {r.timings['halo']:.4f}, "
            f"waiting for halos {r.timings['halo_wait']:.4f}), "
            f"walk {r.timings['walk']:.4f}, stitch {r.timings['stitch']:.4f} s, peak "
            f"{peak / 2**30:.2f} GiB" for p, (r, sec, peak) in enumerate(res)) + f" [{card}]")
    log(f"align_batch_sharded {len(c2)}x{L_SHORT}bp walls (s): "
        f"{ {f'{k} counts={wc}': round(v, 4) for (k, wc), v in dp_walls.items()} }; equal align_batch, "
        f"exact statistics [{card}]")
    for g in groups.values():
        g.close()

    rec = path_tiles_vs_plain(card, bound, big, launches, errs)
    for name, fields in rec.items():
        log(f"kernel {name}: {fields['ms']:.3f} ms, bound {fields['bound_ms']:.4f} ms "
            f"({fields['bound_by']}), plain {fields['plain_ms']:.1f} ms, {fields['shape']} [{card}]")
    log(f"phase 12 (d) max |diff| against the plain versions at the path's shapes: {errs}")
    if any(errs.values()):
        fail(f"a tile mode or the mask walk differs from its plain version at the path's shapes: {errs}")
    log(f"phase 12 seconds {time.perf_counter() - t_phase:.1f} [{card}]")
    return rec


# ---------------- phase 13: the tie-mask routes and Hirschberg ----------------

L_ARROWS = 2048  # fill_arrows_auto's batched-masks limit (LANES_ARROWS_MAX_SIDE): 128 pairs of it
L_ROUTE = 4096  # align_batch's mask route against its codes route: 16 x 4 096 bp
# (pairs, bp) of the route comparison: the two the rule is held to first,
# then both sides of its crossover
ROUTE_SHAPES = [(4, L_LONG), (16, L_ROUTE), (1, L_ROUTE), (2, L_ROUTE), (3, L_ROUTE), (4, L_ROUTE),
                (8, L_ROUTE), (2, L_LONG), (3, L_LONG), (5, L_LONG), (6, L_LONG), (8, L_LONG), (16, L_LONG),
                (23, L_LONG)]
COUNT_WARPS = (1, 2, 3, 4, 8, 16, 32)  # phase 13 (a): nw_count_masks at each forced W
COUNT_SWEEP = (1, 2, 4, 8, 16, 32)  # phase 13: the sweep of W at the timed shapes
MASK_KERNELS = {  # record name -> (module, wrapper) whose .launches count its kernel
    "nw_fill_masks_batch": ("fill_banded", "fill_masks_banded_batch"),
    "nw_count_masks": ("pathcount", "count_masks_batch"),
    "nw_walk_masks": ("traceback", "walk_masks_batch"),
    "nw_fill_masks/fold": ("fill_single", "fill_arrows_fold_batch"),
    "nw_last_row": ("fill_single", "last_row"),
}
# the 10 240 bp Hirschberg pair on the host CPU, in a process of its own
# that runs while the phase's card work does
HIRSCHBERG_CPU = (
    "import sys, torch\n"
    "torch.set_num_threads(1)\n"
    "from nw_tpu_torch.ops.hirschberg import hirschberg_align\n"
    "s1, s2 = (x.encode() for x in sys.argv[1:])\n"
    "X, Y = hirschberg_align(s1, s2, 2, 1, 1, device='cpu')\n"
    "sys.stdout.buffer.write(X + b' ' + Y)\n"
)


def mask_wrappers():
    import importlib

    return {name: getattr(importlib.import_module(f"nw_tpu_torch.ops.{mod}"), fn)
            for name, (mod, fn) in MASK_KERNELS.items()}


def mask_kernels_vs_plain(dev, errs):
    """Phase 13 (a): every new kernel against its plain version under
    every scoring, on random 0-700 bp pairs, tie-dense pairs, the edge
    pairs and all-'A' 24 x 16; the plain versions' body (the
    anti-diagonal fill with scores and counts) runs on every pair at
    once, the plain wrappers themselves on the short pairs."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops import pathcount as pc
    from nw_tpu_torch.ops import traceback as tb
    from nw_tpu_torch.ops.fill_scan import diag_to_matrix_batch, fill_diag_batch, zero_outside

    rng = np.random.default_rng(130)
    pairs = (rand_pairs(rng, 24, 0, 700) + rand_pairs(rng, 6, 100, 400, b"AC") + EDGE
             + [(b"A" * 24, b"A" * 16)])
    short = EDGE + [(b"A" * 24, b"A" * 16), (b"ACCATTG", b"CATAG")] + rand_pairs(rng, 2, 30, 90)
    batches = [enc.upload(enc.encode_batch(ps, max(len(a) for a, _ in ps), max(len(b) for _, b in ps)), dev)
               for ps in (pairs, short)]
    (tops, sides, l1, l2), st = batches
    S = tops.shape[1] + sides.shape[1]
    for mkd in SCORINGS:
        e = {name: 0 for name in MASK_KERNELS}
        ref = fill_diag_batch(tops, sides, l1, l2, *mkd, with_counts=True, with_scores=True)
        want = zero_outside(diag_to_matrix_batch(ref["arrows"]), l1, l2)
        for wc in (False, True):
            got = fb.fill_masks_banded_batch(tops, sides, l1, l2, *mkd, with_counts=wc)
            e["nw_fill_masks_batch"] = max([e["nw_fill_masks_batch"], max_abs_err(got[0], want),
                                            max_abs_err(got[1], ref["score"])]
                                           + ([max_abs_err(got[2], ref["count"])] if wc else []))
        fold = fs.fill_arrows_fold_batch(tops, sides, l1, l2, *mkd)
        e["nw_fill_masks/fold"] = max(max_abs_err(g, w) for g, w in zip(fold, (want, ref["score"], ref["count"])))
        want_count = pc.count_masks_batch_plain(want, l1, l2)
        e["nw_count_masks"] = max(max_abs_err(pc.count_masks_batch(got[0], l1, l2, warps=w), want_count)
                                  for w in (None, *COUNT_WARPS))
        e["nw_walk_masks"] = max(max_abs_err(g, w) for g, w in zip(
            tb.walk_masks_batch(got[0], l1, l2, S), tb.walk_masks_batch_plain(want, l1, l2, S)))
        for b, (n1, n2) in enumerate(zip(l1.tolist(), l2.tolist())):
            for j in sorted({0, n2 // 3, n2}):
                row = fs.last_row(tops[b], sides[b], *mkd, len1=n1, len2=j)
                idx = torch.arange(n1 + 1, device=dev)
                e["nw_last_row"] = max(e["nw_last_row"], max_abs_err(row, ref["scores"][b, j + idx, j]))
        # the plain wrappers themselves, on the short pairs
        for g, w in zip(fb.fill_masks_banded_batch(*st, *mkd, with_counts=True),
                        fb.fill_masks_banded_batch_plain(*st, *mkd, with_counts=True)):
            e["nw_fill_masks_batch"] = max(e["nw_fill_masks_batch"], max_abs_err(g, w))
        for g, w in zip(fs.fill_arrows_fold_batch(*st, *mkd),
                        fs.fill_arrows_fold_batch_plain(*st, *mkd)):
            e["nw_fill_masks/fold"] = max(e["nw_fill_masks/fold"], max_abs_err(g, w))
        for b, (n1, n2) in enumerate(zip(st[2].tolist(), st[3].tolist())):
            e["nw_last_row"] = max(e["nw_last_row"], max_abs_err(
                fs.last_row(st[0][b], st[1][b], *mkd, n1, n2), fs.last_row_plain(st[0][b], st[1][b], *mkd, n1, n2)))
        for name, v in e.items():
            errs[name] = max(errs[name], v)
        log(f"phase 13 (a) kernels vs plain, {len(pairs)} pairs + {len(short)} short, m k d = {mkd} "
            f"(nw_count_masks at the rule's W and W = {COUNT_WARPS}): {e}")
        del ref, want
    if any(errs.values()):
        fail(f"a mask-route kernel differs from its plain version: {errs}")


class forced_route:
    """``NWAligner.align_batch`` with the small-long-batch rule forced to
    one route (True: the mask route, False: the codes route)."""

    def __init__(self, masks: bool):
        self.masks = masks

    def __enter__(self):
        from nw_tpu_torch.models import needleman_wunsch as nwm

        self.saved = nwm.takes_mask_route
        nwm.takes_mask_route = lambda *_: self.masks

    def __exit__(self, *exc):
        from nw_tpu_torch.models import needleman_wunsch as nwm

        nwm.takes_mask_route = self.saved


def masks_path(card, a211, route_pairs, big, p10, timers):
    """Phase 13 (b)-(e) with every new kernel's launch counter from 0:
    fill_arrows_auto, count and walk at 10 240 x 150 bp, 128 x 2 048 bp
    and 4 x 10 240 bp; align_batch of small batches of long pairs on both
    routes; hirschberg_align at 100 000 and 10 240 bp.  Returns the
    outputs, walls and launches."""
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_auto
    from nw_tpu_torch.ops import hirschberg as hb
    from nw_tpu_torch.ops import pathcount as pc
    from nw_tpu_torch.ops import traceback as tb

    dev = torch.device("cuda")
    wrappers = mask_wrappers()
    for w in wrappers.values():
        w.launches = 0
    rng = np.random.default_rng(131)
    out = {}
    for key, nb, L in (("b", 10240, L_SHORT), ("b", 128, L_ARROWS), ("c", 4, L_LONG)):
        ps = rand_pairs(rng, nb, L, L)
        T = enc.upload(enc.encode_batch(ps, L, L), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, axis, scores = fill_auto.fill_arrows_auto(*T, 2, 1, 1)
        counts = pc.count_masks_batch(masks, T[2], T[3])
        ops, n = tb.walk_masks_batch(masks, T[2], T[3], 2 * L)
        aligned = tb.ops_to_strings_batch(ops.cpu().numpy(), n.cpu().numpy(), ps)
        wall = time.perf_counter() - t0
        if axis != 0 or masks.shape != (len(ps), L + 1, L + 1):
            fail(f"fill_arrows_auto {nb}x{L}bp: masks {tuple(masks.shape)}, batch axis {axis}")
        out[nb, L] = dict(key=key, pairs=ps, T=T, masks=masks, scores=scores, counts=counts,
                          ops=ops, n=n, aligned=aligned, wall=wall)
    routes = {}
    for nb, L in ROUTE_SHAPES:
        ps = route_pairs[nb, L]
        for masks_route in (True, False, False, True, True, False, False, True):
            with forced_route(masks_route):
                t0 = time.perf_counter()
                r = a211.align_batch(ps, traceback_strings=True, count=True)
                routes.setdefault((nb, L, masks_route), []).append((time.perf_counter() - t0, r))
    # Hirschberg: the host leaves, host rows and card rows timed apart
    saved = {name: getattr(hb, name) for name in timers}

    def timed(name):
        fn = saved[name]

        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                timers[name] += time.perf_counter() - t0
        return run

    for name in timers:
        setattr(hb, name, timed(name))
    try:
        t0 = time.perf_counter()
        big_xy = hb.hirschberg_align(*big, 2, 1, 1, device="cuda")
        hb_wall = time.perf_counter() - t0
        hb_split = dict(timers)
        t0 = time.perf_counter()
        p10_xy = hb.hirschberg_align(*p10, 2, 1, 1, device="cuda")
        hb10_wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(hb, name, fn)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"phase 13 path launches: {launches}")
    if not all(launches.values()):
        fail(f"a kernel of the mask routes or Hirschberg never launched: {launches}")
    return out, routes, (big_xy, hb_wall, hb_split, p10_xy, hb10_wall), launches


def masks_phase(card, bound):
    """Phase 13: the tie-mask routes and Hirschberg.  Returns the new
    kernels' record fields."""
    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.models import needleman_wunsch as nwm
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_auto
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_single as fs
    from nw_tpu_torch.ops import hirschberg as hb
    from nw_tpu_torch.ops import pathcount as pc
    from nw_tpu_torch.ops import traceback as tb

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    a211 = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")
    big = rand_pairs(np.random.default_rng(L_HUGE), 1, L_HUGE, L_HUGE)[0]  # phase 8's pair
    p10 = rand_pairs(np.random.default_rng(132), 1, L_LONG, L_LONG)[0]
    cpu_proc = subprocess.Popen([sys.executable, "-c", HIRSCHBERG_CPU, *(s.decode() for s in p10)],
                                stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
    t_cpu = time.perf_counter()
    try:
        errs = {name: 0 for name in MASK_KERNELS}
        t0 = time.perf_counter()
        mask_kernels_vs_plain(dev, errs)
        log(f"phase 13 (a) seconds {time.perf_counter() - t0:.1f}")
        route_pairs = {(nb, L): rand_pairs(np.random.default_rng(nb * L), nb, L, L) for nb, L in ROUTE_SHAPES}
        timers = {"_small_align": 0.0, "_host_last_row": 0.0, "_device_last_row": 0.0}
        out, routes, hbr, launches = masks_path(card, a211, route_pairs, big, p10, timers)
        big_xy, hb_wall, hb_split, p10_xy, hb10_wall = hbr
        rec = {}

        # (b), (c): fill_arrows_auto, count and walk
        for (nb, L), o in out.items():
            T, ps = o["T"], o["pairs"]
            if not np.array_equal(rescore(ps, o["aligned"], 2, 1, 1), o["scores"].cpu().numpy().astype(np.int64)):
                fail(f"fill_arrows_auto {nb}x{L}bp: an alignment does not re-score to its score")
            ref = fb.fill_scores_counts_banded_batch(*T, 2, 1, 1)  # nw_fill_codes's fused counts
            if max_abs_err(o["scores"], ref[0]) or max_abs_err(o["counts"], ref[1]):
                fail(f"fill_arrows_auto {nb}x{L}bp: scores or counts differ from nw_fill_codes's")
            sub = slice(None) if o["key"] == "b" else slice(0, 1)  # all pairs; one 10 240 bp pair
            Ts = [t[sub] for t in T]
            plain_fill, kw = ((fb.fill_masks_banded_batch_plain, {"with_counts": True}) if o["key"] == "b"
                              else (fs.fill_arrows_fold_batch_plain, {}))
            (pm, psc, pct), o["plain_fill_ms"] = cuda_once(lambda: plain_fill(*Ts, 2, 1, 1, **kw))
            pcnt, o["plain_count_ms"] = cuda_once(lambda: pc.count_masks_batch_plain(pm, *Ts[2:]))
            (pops, pn), o["plain_walk_ms"] = cuda_once(lambda: tb.walk_masks_batch_plain(pm, *Ts[2:], 2 * L))
            e_fill = max(max_abs_err(o["masks"][sub], pm), max_abs_err(o["scores"][sub], psc),
                         max_abs_err(o["counts"][sub], pct))
            e_count = max_abs_err(o["counts"][sub], pcnt)
            e_walk = max(max_abs_err(o["ops"][sub], pops), max_abs_err(o["n"][sub], pn))
            fill_name = "nw_fill_masks_batch" if o["key"] == "b" else "nw_fill_masks/fold"
            errs[fill_name] = max(errs[fill_name], e_fill)
            errs["nw_count_masks"] = max(errs["nw_count_masks"], e_count)
            errs["nw_walk_masks"] = max(errs["nw_walk_masks"], e_walk)
            log(f"phase 13 ({o['key']}) fill_arrows_auto {nb}x{L}bp (2 1 1), count, walk, host strings: "
                f"wall {o['wall']:.4f} s; every alignment re-scores to its score, scores and counts equal "
                f"nw_fill_codes's; {'all' if o['key'] == 'b' else 'one'} pair(s) vs plain on the card: fill "
                f"{e_fill} ({o['plain_fill_ms']:.1f} ms), count {e_count} ({o['plain_count_ms']:.1f} ms), "
                f"walk {e_walk} ({o['plain_walk_ms']:.1f} ms) [{card}]")
            del pm, pcnt, pops
        if any(errs.values()):
            fail(f"a mask-route kernel differs from its plain version at the path's shapes: {errs}")

        # (d): align_batch's small-long-batch route against its codes route
        for nb, L in ROUTE_SHAPES:
            runs = {flag: routes[nb, L, flag] for flag in (True, False)}
            rm, rc = runs[True][0][1], runs[False][0][1]
            for r in (rm, rc):
                if r.ops.shape != (nb, 2 * a211.config.bucket_for(L)):
                    fail(f"align_batch {nb}x{L}bp: ops {r.ops.shape}")
            if not all(np.array_equal(getattr(rm, f), getattr(rc, f)) for f in ("scores", "counts", "ops", "ops_len")):
                fail(f"align_batch {nb}x{L}bp: the mask route's outputs differ from the codes route's")
            med = {flag: statistics.median(w for w, _ in rs[1:]) for flag, rs in runs.items()}
            rule = "masks" if fill_auto.takes_mask_route(nb, L, L) else "codes"
            log(f"phase 13 (d) align_batch {nb}x{L}bp strings+counts (2 1 1): mask route {med[True] * 1e3:.2f} ms, "
                f"codes route {med[False] * 1e3:.2f} ms (median of 3 warm; cold {runs[True][0][0] * 1e3:.1f} / "
                f"{runs[False][0][0] * 1e3:.1f} ms); outputs equal; the rule takes {rule} [{card}]")

        # (e): Hirschberg
        X, Y = big_xy
        score = nwm._rescore(X, Y, 2, 1, 1)
        want = a211.summary_huge(*big)[0]
        rescore([big], [big_xy], 2, 1, 1)  # spells both inputs, no gap column
        if score != want:
            fail(f"hirschberg_align {L_HUGE} bp re-scores to {score}, summary_huge says {want}")
        log(f"phase 13 (e) hirschberg_align {L_HUGE} bp (2 1 1): spells both inputs, re-scores to "
            f"summary_huge's {want}; wall {hb_wall:.2f} s, of which host leaves (_small_align) "
            f"{hb_split['_small_align']:.2f} s ({100 * hb_split['_small_align'] / hb_wall:.1f}%), host rows "
            f"{hb_split['_host_last_row']:.2f} s, card rows (nw_last_row) {hb_split['_device_last_row']:.2f} s "
            f"[{card}]")
        stdout, stderr = cpu_proc.communicate(timeout=max(60.0, 900 - (time.perf_counter() - t_cpu)))
        if cpu_proc.returncode != 0:
            fail(f"hirschberg_align(device='cpu') failed:\n{stderr.decode()[-2000:]}")
        if tuple(stdout.split(b" ")) != p10_xy:
            fail(f"hirschberg_align {L_LONG} bp: the card's bytes differ from device='cpu'")
        log(f"phase 13 (e) hirschberg_align {L_LONG} bp: card ({hb10_wall:.2f} s) equals device='cpu' "
            f"(its own process, {time.perf_counter() - t_cpu:.1f} s after its start) byte for byte [{card}]")
        k9 = {}
        for L, pair in ((L_LONG, p10), (L_CROSS, (big[0][:L_CROSS], big[1][:L_CROSS]))):
            top, side = (torch.from_numpy(np.frombuffer(s, np.uint8).astype(np.int32)).to(dev) for s in pair)
            h = L // 2  # the top-level split's forward row
            got = fs.last_row(top, side[:h], 2, 1, 1)
            plain, plain_ms = cuda_once(lambda: fs.last_row_plain(top, side[:h], 2, 1, 1))
            errs["nw_last_row"] = max(errs["nw_last_row"], max_abs_err(got, plain))
            k9[L] = (cuda_ms(lambda: fs.last_row(top, side[:h], 2, 1, 1), 3), plain_ms, top, side[:h])
            log(f"phase 13 (e) nw_last_row at the top-level split of {L} bp ({L}x{h}): max |diff| vs "
                f"fill_last_row {errs['nw_last_row']}; kernel {k9[L][0]:.3f} ms, plain {plain_ms:.1f} ms [{card}]")
        if errs["nw_last_row"]:
            fail(f"nw_last_row differs from fill_last_row at the path's splits: {errs}")

        # nw_count_masks: one warp a pair against the rule's W in turns, and the sweep of W
        flat = rand_pairs(np.random.default_rng(133), 1024, L_FLAT, L_FLAT)
        Tf = enc.upload(enc.encode_batch(flat, L_FLAT, L_FLAT), dev)
        count_shapes = [(f"{nb}x{L}bp", out[nb, L]["masks"], out[nb, L]["T"])
                        for nb, L in ((4, L_LONG), (128, L_ARROWS))]
        count_shapes.append((f"1024x{L_FLAT}bp", fb.fill_masks_banded_batch(*Tf, 2, 1, 1)[0], Tf))
        count_turns = {}
        for label, masks, T in count_shapes:
            B, N, _ = masks.shape
            W = pc.count_warps(B, N - 1, torch.cuda.get_device_properties(dev).multi_processor_count)
            turns = {}
            for w in (1, W, W, 1):
                turns.setdefault(w, []).append(cuda_ms(lambda: pc.count_masks_batch(masks, *T[2:], warps=w), 2))
            sweep = {w: cuda_ms(lambda: pc.count_masks_batch(masks, *T[2:], warps=w), 2) for w in COUNT_SWEEP}
            cells = int((T[2].to(torch.int64) * T[3]).sum())
            bnd = bound(cells * OPS_COUNT, tensor_bytes(masks, *T[2:]) + 4 * B)
            count_turns[label] = (W, turns)
            log(f"phase 13 nw_count_masks {label} in turns: one warp a pair {turns[1]} ms, the rule's "
                f"W = {W} {turns[W]} ms; sweep of W {sweep} ms; bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_by']}) [{card}]")

        # times at the path's shapes, and the record
        o = out[128, L_ARROWS]
        T, masks = o["T"], o["masks"]
        cells = int((T[2].to(torch.int64) * T[3]).sum())
        fill_ms = cuda_ms(lambda: fb.fill_masks_banded_batch(*T, 2, 1, 1), 3)
        fill_c_ms = cuda_ms(lambda: fb.fill_masks_banded_batch(*T, 2, 1, 1, with_counts=True), 3)
        count_ms = cuda_ms(lambda: pc.count_masks_batch(masks, *T[2:]), 3)
        walk_ms = cuda_ms(lambda: tb.walk_masks_batch(masks, *T[2:], 2 * L_ARROWS), 3)
        steps = int(o["n"].sum())
        rec["nw_fill_masks_batch"] = dict(
            ms=fill_ms, plain_ms=o["plain_fill_ms"],
            **bound(cells * (OPS_SCORE + OPS_CODE), tensor_bytes(*T, masks, o["scores"])),
            shape=f"128x{L_ARROWS}bp masks (with counts {fill_c_ms:.3f} ms; plain_ms with counts)")
        W, turns = count_turns[f"128x{L_ARROWS}bp"]
        W4, turns4 = count_turns[f"4x{L_LONG}bp"]
        rec["nw_count_masks"] = dict(
            ms=count_ms, plain_ms=o["plain_count_ms"],
            **bound(cells * OPS_COUNT, tensor_bytes(masks, *T[2:]) + 4 * len(o["pairs"])),
            shape=f"128x{L_ARROWS}bp masks, {W} warps a pair; 4x{L_LONG}bp {min(turns4[W4]):.3f} ms at "
                  f"W = {W4} (one warp a pair {min(turns4[1]):.3f} ms in turns)",
            warps=W, one_warp_ms=min(turns[1]))
        rec["nw_walk_masks"] = dict(
            ms=walk_ms, plain_ms=o["plain_walk_ms"],
            **bound(steps * OPS_WALK_STEP, tensor_bytes(*T[2:], o["n"]) + 2 * steps),
            shape=f"128x{L_ARROWS}bp, {steps} steps")
        for nb, L in ((10240, L_SHORT), (4, L_LONG)):
            ob = out[nb, L]
            log(f"phase 13 kernels at {nb}x{L}bp: nw_fill_masks_batch "
                f"{cuda_ms(lambda: fb.fill_masks_banded_batch(*ob['T'], 2, 1, 1), 3):.3f} ms, nw_count_masks "
                f"{cuda_ms(lambda: pc.count_masks_batch(ob['masks'], *ob['T'][2:]), 2):.3f} ms, nw_walk_masks "
                f"{cuda_ms(lambda: tb.walk_masks_batch(ob['masks'], *ob['T'][2:], 2 * L), 2):.3f} ms [{card}]")
        oc = out[4, L_LONG]
        fold_ms = cuda_ms(lambda: fs.fill_arrows_fold_batch(*oc["T"], 2, 1, 1), 2)
        one_ms = cuda_ms(lambda: fs.fill_arrows_fold_batch(*(t[:1] for t in oc["T"]), 2, 1, 1), 3)
        rec["nw_fill_masks/fold"] = dict(
            ms=fold_ms, plain_ms=oc["plain_fill_ms"],
            **bound(4 * L_LONG * L_LONG * (OPS_SCORE + OPS_COUNT + OPS_CODE),
                    tensor_bytes(*oc["T"], oc["masks"], oc["scores"], oc["counts"])),
            shape=f"4x{L_LONG}bp masks+counts, a pair at a time (plain_ms at 1x{L_LONG}bp, "
                  f"kernel there {one_ms:.3f} ms)")
        k9_ms, k9_plain, top, side = k9[L_LONG]
        rec["nw_last_row"] = dict(
            ms=k9_ms, plain_ms=k9_plain,
            **bound(top.shape[0] * side.shape[0] * OPS_SCORE, tensor_bytes(top, side) + 4 * (top.shape[0] + 1)),
            shape=f"1x{L_LONG}bp, the top-level split's row ({L_LONG}x{side.shape[0]}); at {L_CROSS}bp "
                  f"{k9[L_CROSS][0]:.3f} ms, plain {k9[L_CROSS][1]:.1f} ms")
        for name, fields in rec.items():
            fields.update(launches=launches[name], max_abs_err=errs[name])
            log(f"kernel {name}: {fields['ms']:.3f} ms, bound {fields['bound_ms']:.4f} ms "
                f"({fields['bound_by']}), plain {fields['plain_ms']:.1f} ms, {fields['shape']} [{card}]")
        log(f"phase 13 seconds {time.perf_counter() - t_phase:.1f} [{card}]")
        return rec
    finally:
        if cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.wait()


# ---------------- phase 14: the runs walk engine and the flat-fill API ----------------

L_FLAT = 256  # K7's and K27's flat batch: 1 024 x 256 bp
L_RUNS_TB = 3072  # the runs engine's second shape: 128 x 3 072 bp
RUNS_KERNELS = {  # record name -> (module, wrapper) whose .launches count its kernel
    "nw_fill_runs_batch": ("fill_banded", "fill_runs_banded_batch"),
    "nw_walk_runs": ("traceback", "walk_runs_batch"),
}
# the flat-fill API (nw_tpu/ops/fill_pallas.py's public functions): function
# -> (module, serving wrapper) whose .launches count its kernel
FLAT_FUNCTIONS = {
    "fill_scores_flat_batch": ("fill_banded", "fill_scores_banded_batch"),
    "fill_scores_counts_flat_batch": ("fill_banded", "fill_scores_counts_banded_batch"),
    "fill_arrows_flat_batch": ("fill_banded", "fill_masks_banded_batch"),
    "count_flat_batch": ("pathcount", "count_masks_batch"),
}


def wrappers_of(table):
    import importlib

    return {name: getattr(importlib.import_module(f"nw_tpu_torch.ops.{mod}"), fn)
            for name, (mod, fn) in table.items()}


class walk_engine:
    """``NW_TPU_WALK_ENGINE`` set to ``engine`` inside the block."""

    def __init__(self, engine: str):
        self.engine = engine

    def __enter__(self):
        self.saved = os.environ.get("NW_TPU_WALK_ENGINE")
        os.environ["NW_TPU_WALK_ENGINE"] = self.engine

    def __exit__(self, *exc):
        os.environ.pop("NW_TPU_WALK_ENGINE")
        if self.saved is not None:
            os.environ["NW_TPU_WALK_ENGINE"] = self.saved


def runs_kernels_vs_plain(dev, small, errs):
    """Phase 14 (a): nw_fill_runs_batch (with and without counts) and
    nw_walk_runs against their plain versions under every scoring, on
    phase 3's pairs and identical 700 bp pairs (diagonal runs past the 63
    cap and across 22 bands); the run walk's ops also against nw_walk's
    over nw_fill_codes's codes."""
    from nw_tpu_torch import AlignConfig
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import traceback as tb

    rng = np.random.default_rng(140)
    same = [(s, s) for s, _ in rand_pairs(rng, 3, 700, 700)] + [(s, s) for s, _ in rand_pairs(rng, 1, 700, 700, b"AC")]
    pairs = small + same + [(same[0][0], same[0][0][:450]), (same[1][0][:500], same[1][0])]
    cfg = AlignConfig()
    L1 = cfg.bucket_for(max(len(a) for a, _ in pairs))
    L2 = cfg.bucket_for(max(len(b) for _, b in pairs))
    T = enc.upload(enc.encode_batch(pairs, L1, L2), dev)
    S = L1 + L2
    for mkd in SCORINGS:
        want = fb.fill_runs_banded_batch_plain(*T, *mkd, with_counts=True)
        e_fill = 0
        for wc in (False, True):
            got = fb.fill_runs_banded_batch(*T, *mkd, with_counts=wc)
            e_fill = max([e_fill] + [max_abs_err(g, w) for g, w in zip(got[: 2 + wc], want)])
        ops, n = tb.walk_runs_batch(got[0], *T[2:], S)
        e_walk = max(max_abs_err(g, w) for g, w in zip((ops, n), tb.walk_runs_batch_plain(want[0], *T[2:], S)))
        codes = fb.fill_greedy_counts_banded_batch(*T, *mkd)[0]
        e_codes = max(max_abs_err(g, w) for g, w in zip((ops, n), tb.walk_codes_batch(codes, *T[2:], S)))
        errs["nw_fill_runs_batch"] = max(errs["nw_fill_runs_batch"], e_fill)
        errs["nw_walk_runs"] = max(errs["nw_walk_runs"], e_walk, e_codes)
        log(f"phase 14 (a) runs kernels vs plain, {len(pairs)} pairs {L1}x{L2} bucket, m k d = {mkd}: "
            f"fill {e_fill}, walk {e_walk}, walk vs nw_walk's ops {e_codes}")
        del want, got, codes
    if any(errs.values()):
        fail(f"a runs kernel differs from its plain version: {errs}")


def runs_path(card, aligner, c3, r3, aligned3, pairs3k):
    """Phase 14 (b) with the runs kernels' and the codes kernels' launch
    counters from 0: align_batch of config 3 and of 128 x 3 072 bp on the
    runs engine, held to the codes engine byte for byte.  Returns the
    launches and the 3 kb outputs of both engines."""
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import traceback as tb

    wrappers = wrappers_of(RUNS_KERNELS)
    codes_wrappers = (fb.fill_greedy_counts_banded_batch, tb.walk_codes_batch)
    for w in (*wrappers.values(), *codes_wrappers):
        w.launches = 0
    with walk_engine("runs"):
        t0 = time.perf_counter()
        rr = aligner.align_batch(c3, traceback_strings=True, count=True)
        aligned = rr.alignment_strings()
        wall = time.perf_counter() - t0
        r3k = aligner.align_batch(pairs3k, traceback_strings=True, count=True)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    codes_launches = sum(w.launches for w in codes_wrappers)
    log(f"phase 14 (b) path launches: {launches}; the codes kernels {codes_launches}")
    if not all(launches.values()) or codes_launches:
        fail(f"the runs engine did not run on its own kernels: {launches}, codes kernels {codes_launches}")
    for f in ("scores", "counts", "ops", "ops_len"):
        if not np.array_equal(getattr(rr, f), getattr(r3, f)):
            fail(f"config 3 on the runs engine: {f} differ from the codes engine's")
    if aligned != aligned3:
        fail("config 3 on the runs engine: strings differ from the codes engine's")
    if not np.array_equal(rescore(c3, aligned, 2, 1, 1), rr.scores.astype(np.int64)):
        fail("config 3 on the runs engine: an alignment does not re-score to its score")
    with walk_engine("auto"):
        c3k = aligner.align_batch(pairs3k, traceback_strings=True, count=True)
    for f in ("scores", "counts", "ops", "ops_len"):
        if not np.array_equal(getattr(r3k, f), getattr(c3k, f)):
            fail(f"128x{L_RUNS_TB}bp on the runs engine: {f} differ from the codes engine's")
    al3k = r3k.alignment_strings()
    if al3k != c3k.alignment_strings() or not np.array_equal(
            rescore(pairs3k, al3k, 2, 1, 1), r3k.scores.astype(np.int64)):
        fail(f"128x{L_RUNS_TB}bp on the runs engine: strings differ or do not re-score")
    log(f"phase 14 (b) align_batch config 3 ({len(c3)}x{L_LONG}bp, strings+counts) and {len(pairs3k)}x{L_RUNS_TB}bp on "
        f"NW_TPU_WALK_ENGINE=runs: scores, counts, ops and strings equal the codes engine's byte for byte, "
        f"every alignment re-scores to its score; config 3 cold wall {wall:.4f} s [{card}]")
    return launches


def flat_path(card, bound, c2):
    """Phase 14 (c) with the serving wrappers' launch counters from 0: K26's
    function at 10 240 x 150 bp, K27's (masks with and without counts) and
    K6's at 1 024 x 256 bp and 128 x 2 048 bp, K7's at 1 024 x 256 bp, all
    driven through ops/fill_flat.py before the counts are read; then each
    against its plain version and the serving kernel's wrapper on the same
    inputs; then K5's shape, 4 096 x 150 bp strings through align_batch.
    Returns the record fields."""
    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import fill_flat as ff
    from nw_tpu_torch.ops import pathcount as pc
    from nw_tpu_torch.ops import traceback as tb

    dev = torch.device("cuda")
    rng = np.random.default_rng(141)
    serving = wrappers_of(FLAT_FUNCTIONS)
    T2 = enc.upload(enc.encode_batch(c2, L_SHORT, L_SHORT), dev)
    shapes = [(nb, L, enc.upload(enc.encode_batch(rand_pairs(rng, nb, L, L), L, L), dev))
              for nb, L in ((1024, L_FLAT), (128, L_ARROWS))]
    T7 = shapes[0][2]
    for w in serving.values():
        w.launches = 0
    got = ff.fill_scores_counts_flat_batch(*T2, 2, 1, 1)
    masks_out = {}
    for nb, L, T in shapes:
        m0, s0 = ff.fill_arrows_flat_batch(*T, 2, 1, 1)
        masks, sc, ct = ff.fill_arrows_flat_batch(*T, 2, 1, 1, with_counts=True)
        masks_out[nb, L] = dict(T=T, m0=m0, s0=s0, masks=masks, sc=sc, ct=ct,
                                counts=ff.count_flat_batch(masks, *T[2:]))
    s7 = ff.fill_scores_flat_batch(*T7, 2, 1, 1)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in serving.items()}

    (p_sc, p_ct), k26_plain_ms = cuda_once(lambda: ff.fill_scores_counts_flat_batch_plain(*T2, 2, 1, 1))
    e26 = max(max_abs_err(got[0], p_sc), max_abs_err(got[1], p_ct))
    e26 = max([e26] + [max_abs_err(g, w) for g, w in zip(got, fb.fill_scores_counts_banded_batch(*T2, 2, 1, 1))])
    for (nb, L), o in masks_out.items():
        T = o["T"]
        (pm, psc, pct), plain_ms = cuda_once(lambda: ff.fill_arrows_flat_batch_plain(*T, 2, 1, 1, with_counts=True))
        pcnt, count_plain_ms = cuda_once(lambda: ff.count_flat_batch_plain(pm, *T[2:]))
        e27 = max(max_abs_err(o["masks"], pm), max_abs_err(o["sc"], psc), max_abs_err(o["ct"], pct),
                  max_abs_err(o["m0"], pm), max_abs_err(o["s0"], psc))
        e27 = max([e27] + [max_abs_err(g, w) for g, w in zip((o["masks"], o["sc"], o["ct"]),
                                                           fb.fill_masks_banded_batch(*T, 2, 1, 1, with_counts=True))])
        e6 = max(max_abs_err(o["counts"], pcnt), max_abs_err(o["counts"], o["ct"]),
                 max_abs_err(o["counts"], pc.count_masks_batch(o["masks"], *T[2:])))
        o.update(e27=e27, e6=e6, plain_ms=plain_ms, count_plain_ms=count_plain_ms)
        log(f"phase 14 (c) fill_arrows_flat_batch + count_flat_batch {nb}x{L}bp (2 1 1): max |diff| vs plain "
            f"and nw_fill_masks_batch / nw_count_masks: masks {e27}, counts {e6}; plain {plain_ms:.1f} ms "
            f"(masks+counts), {count_plain_ms:.1f} ms (count) [{card}]")
        del pm, pcnt
    p7, k7_plain_ms = cuda_once(lambda: ff.fill_scores_flat_batch_plain(*T7, 2, 1, 1))
    e7 = max(max_abs_err(s7, p7), max_abs_err(s7, fb.fill_scores_banded_batch(*T7, 2, 1, 1)),
             max_abs_err(s7, masks_out[1024, L_FLAT]["sc"]))
    log(f"phase 14 (c) flat API launches (the serving wrappers' counters): {launches}; max |diff| K26 {e26}, "
        f"K7 {e7} [{card}]")
    if not all(launches.values()):
        fail(f"a function of the flat-fill API never launched its kernel: {launches}")
    e_flat = max([e26, e7] + [o["e27"] for o in masks_out.values()] + [o["e6"] for o in masks_out.values()])
    if e_flat:
        fail(f"the flat-fill API differs from its plain versions or its serving kernels: {e_flat}")

    # K5's shape: 4 096 x 150 bp strings through align_batch on the codes engine
    p5 = rand_pairs(rng, 4096, L_SHORT, L_SHORT)
    a211 = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cuda")
    fill5, walk5 = fb.fill_greedy_counts_banded_batch, tb.walk_codes_batch
    fill5.launches = walk5.launches = 0
    with walk_engine("auto"):
        r5 = a211.align_batch(p5, traceback_strings=True)
    k5_launches = (fill5.launches, walk5.launches)
    if not np.array_equal(rescore(p5, r5.alignment_strings(), 2, 1, 1), r5.scores.astype(np.int64)):
        fail(f"4096x{L_SHORT}bp strings: an alignment does not re-score to its score")
    L5 = a211.config.bucket_for(L_SHORT)  # align_batch's bucket
    T5 = enc.upload(enc.encode_batch(p5, L5, L5), dev)
    codes5, sc5, _ = fb.fill_greedy_counts_banded_batch(*T5, 2, 1, 1)
    ops5, n5 = tb.walk_codes_batch(codes5, *T5[2:], 2 * L5)
    (pcodes5, psc5, _), k5_plain_ms = cuda_once(lambda: fb.fill_greedy_counts_banded_batch_plain(*T5, 2, 1, 1))
    (pops5, pn5), k5_walk_plain_ms = cuda_once(lambda: tb.walk_codes_batch_plain(pcodes5, *T5[2:], 2 * L5))
    e5 = max(max_abs_err(codes5, pcodes5), max_abs_err(sc5, psc5), max_abs_err(ops5, pops5), max_abs_err(n5, pn5),
             int(np.abs(r5.ops.astype(np.int64) - ops5.cpu().numpy()).max()))
    if e5:
        fail(f"4096x{L_SHORT}bp: nw_fill_codes / nw_walk differ from plain or from align_batch: {e5}")

    # times and record fields
    rec = {}
    cells2 = len(c2) * L_SHORT * L_SHORT
    rec["nw_fill_codes/flat"] = dict(
        ms=cuda_ms(lambda: ff.fill_scores_counts_flat_batch(*T2, 2, 1, 1), 10), plain_ms=k26_plain_ms,
        launches=launches["fill_scores_counts_flat_batch"], max_abs_err=e26,
        **bound(cells2 * (OPS_SCORE + OPS_COUNT), tensor_bytes(*T2) + 8 * len(c2)),
        shape=f"{len(c2)}x{L_SHORT}bp scores+counts (K26's function; K4's shape)")
    o = masks_out[1024, L_FLAT]
    cells7 = 1024 * L_FLAT * L_FLAT
    rec["nw_fill_masks_batch/flat"] = dict(
        ms=cuda_ms(lambda: ff.fill_arrows_flat_batch(*o["T"], 2, 1, 1, with_counts=True), 5), plain_ms=o["plain_ms"],
        launches=launches["fill_arrows_flat_batch"], max_abs_err=max(x["e27"] for x in masks_out.values()),
        **bound(cells7 * (OPS_SCORE + OPS_COUNT + OPS_CODE), tensor_bytes(*o["T"], o["masks"], o["sc"], o["ct"])),
        shape=f"1024x{L_FLAT}bp masks+counts (K27's function; masks only "
              f"{cuda_ms(lambda: ff.fill_arrows_flat_batch(*o['T'], 2, 1, 1), 5):.3f} ms; at 128x{L_ARROWS}bp "
              f"masks+counts {cuda_ms(lambda: ff.fill_arrows_flat_batch(*masks_out[128, L_ARROWS]['T'], 2, 1, 1, with_counts=True), 2):.3f} ms)")
    rec["nw_count_masks/flat"] = dict(
        ms=cuda_ms(lambda: ff.count_flat_batch(o["masks"], *o["T"][2:]), 5), plain_ms=o["count_plain_ms"],
        launches=launches["count_flat_batch"], max_abs_err=max(x["e6"] for x in masks_out.values()),
        **bound(cells7 * OPS_COUNT, tensor_bytes(o["masks"], *o["T"][2:]) + 4 * 1024),
        shape=f"1024x{L_FLAT}bp masks (K6 over K27's function)")
    rec["nw_scores/flat"] = dict(
        ms=cuda_ms(lambda: ff.fill_scores_flat_batch(*T7, 2, 1, 1), 10), plain_ms=k7_plain_ms,
        launches=launches["fill_scores_flat_batch"], max_abs_err=e7,
        **bound(cells7 * OPS_SCORE, tensor_bytes(*T7) + 4 * 1024),
        shape=f"1024x{L_FLAT}bp scores (K7's function and shape)")
    cells5 = len(p5) * L_SHORT * L_SHORT
    steps5 = int(n5.sum())
    rec["nw_fill_codes/K5"] = dict(
        ms=cuda_ms(lambda: fb.fill_greedy_counts_banded_batch(*T5, 2, 1, 1), 10), plain_ms=k5_plain_ms,
        launches=k5_launches[0], max_abs_err=e5,
        **bound(cells5 * (OPS_SCORE + OPS_CODE), tensor_bytes(*T5, codes5, sc5)),
        shape=f"{len(p5)}x{L_SHORT}bp codes (K5's shape, align_batch strings)")
    rec["nw_walk/K5"] = dict(
        ms=cuda_ms(lambda: tb.walk_codes_batch(codes5, *T5[2:], 2 * L5), 10), plain_ms=k5_walk_plain_ms,
        launches=k5_launches[1], max_abs_err=e5,
        **bound(steps5 * OPS_WALK_STEP, tensor_bytes(*T5[2:], n5) + 5 * steps5),
        shape=f"{len(p5)}x{L_SHORT}bp, {steps5} steps (K5's shape)")
    for name, fields in rec.items():
        log(f"kernel {name}: {fields['ms']:.3f} ms, bound {fields['bound_ms']:.4f} ms ({fields['bound_by']}), "
            f"plain {fields['plain_ms']:.1f} ms, {fields['launches']} launches, {fields['shape']} [{card}]")
    return rec


def runs_phase(card, bound, aligner, small, c3, r3, aligned3, c2):
    """Phase 14: the runs walk engine (K2's with_runs mode and the
    run-skip walk) and the flat-fill API (K7, K26, K27, K6).  Returns the
    record fields of the new kernels and of the flat API's shapes."""
    from nw_tpu_torch.models import needleman_wunsch as nwm
    from nw_tpu_torch.ops import encode as enc
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import traceback as tb

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    errs = {name: 0 for name in RUNS_KERNELS}
    t0 = time.perf_counter()
    runs_kernels_vs_plain(dev, small, errs)
    log(f"phase 14 (a) seconds {time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    pairs3k = rand_pairs(np.random.default_rng(L_RUNS_TB), 128, L_RUNS_TB, L_RUNS_TB)
    launches = runs_path(card, aligner, c3, r3, aligned3, pairs3k)

    # (d) config 3's wall on both engines, in turns
    walls = {"auto": [], "runs": []}
    for turn in range(3):
        for engine in (("auto", "runs") if turn % 2 == 0 else ("runs", "auto")):
            with walk_engine(engine):
                t0 = time.perf_counter()
                aligner.align_batch(c3, traceback_strings=True, count=True).alignment_strings()
                walls[engine].append(time.perf_counter() - t0)
    med = {e: statistics.median(ws) for e, ws in walls.items()}
    nb = len(c3)
    log(f"phase 14 (d) config 3 ({nb}x{L_LONG}bp, strings+counts) walls: codes engine {[round(w, 4) for w in walls['auto']]} "
        f"s, median {med['auto']:.4f} s = {nb / med['auto']:.1f} pairs/s; runs engine "
        f"{[round(w, 4) for w in walls['runs']]} s, median {med['runs']:.4f} s = {nb / med['runs']:.1f} pairs/s; "
        f"runs / codes {med['runs'] / med['auto']:.3f} (3 warm runs each, in turns) [{card}]")

    # (d) the kernels at config 3: the runs engine's two sub-batches beside the codes engine's one launch
    LB = L_LONG
    T3 = enc.upload(enc.encode_batch(c3, LB, LB), dev)
    sub = nwm.strings_sub_batch(LB, LB, "runs")
    parts = [tuple(t[lo : lo + sub] for t in T3) for lo in range(0, len(c3), sub)]
    fill_ms = [cuda_ms(lambda: fb.fill_runs_banded_batch(*p, 2, 1, 1, with_counts=True), 1) for p in parts]
    codes_fill_ms = cuda_ms(lambda: fb.fill_greedy_counts_banded_batch(*T3, 2, 1, 1, with_counts=True), 1)
    codes3 = fb.fill_greedy_counts_banded_batch(*T3, 2, 1, 1)[0]
    walk_codes_ms = cuda_ms(lambda: tb.walk_codes_batch(codes3, *T3[2:], 2 * LB), 3)
    steps = int(tb.walk_codes_batch(codes3, *T3[2:], 2 * LB)[1].to(torch.int64).sum())
    del codes3
    torch.cuda.empty_cache()
    walk_ms, loads, runs_parts = [], [], []
    for p in parts:
        runs, sc, ct = fb.fill_runs_banded_batch(*p, 2, 1, 1, with_counts=True)
        walk_ms.append(cuda_ms(lambda: tb.walk_runs_batch(runs, *p[2:], 2 * LB), 3))
        loads.append(tb.walk_runs_loads(runs, *p[2:], 2 * LB)[2])
        runs_parts.append(tensor_bytes(runs, sc, ct))
        del runs, sc, ct
        torch.cuda.empty_cache()
    loads = torch.cat(loads)
    n_loads = int(loads.sum())
    # 128 x 10 kb: one launch of each fill on the same inputs, in turns
    h = tuple(t[:128] for t in T3)
    fills = {
        "runs": lambda: fb.fill_runs_banded_batch(*h, 2, 1, 1, with_counts=True),
        "codes": lambda: fb.fill_greedy_counts_banded_batch(*h, 2, 1, 1, with_counts=True),
        "masks": lambda: fb.fill_masks_banded_batch(*h, 2, 1, 1, with_counts=True),
        "runs, no counts": lambda: fb.fill_runs_banded_batch(*h, 2, 1, 1),
    }
    same = {kind: [] for kind in fills}
    for turn in range(2):
        for kind in (list(fills) if turn == 0 else list(fills)[::-1]):
            same[kind].append(cuda_ms(fills[kind], 0))
    log(f"phase 14 (d) fills at 128x{LB}bp with counts, one launch each, in turns: "
        f"{ {k: [round(x, 3) for x in v] for k, v in same.items()} } ms [{card}]")
    # the plain versions on the first config-3 pair, against the kernels there
    one = tuple(t[:1] for t in T3)
    (p_runs, p_sc, p_ct), plain_fill_ms = cuda_once(lambda: fb.fill_runs_banded_batch_plain(*one, 2, 1, 1, with_counts=True))
    (p_ops, p_n), plain_walk_ms = cuda_once(lambda: tb.walk_runs_batch_plain(p_runs, *one[2:], 2 * LB))
    k_runs = fb.fill_runs_banded_batch(*one, 2, 1, 1, with_counts=True)
    e_fill = max(max_abs_err(g, w) for g, w in zip(k_runs, (p_runs, p_sc, p_ct)))
    e_walk = max(max_abs_err(g, w) for g, w in zip(tb.walk_runs_batch(k_runs[0], *one[2:], 2 * LB), (p_ops, p_n)))
    del p_runs, k_runs
    errs["nw_fill_runs_batch"] = max(errs["nw_fill_runs_batch"], e_fill)
    errs["nw_walk_runs"] = max(errs["nw_walk_runs"], e_walk)
    log(f"phase 14 (d) the first config-3 pair (1x{LB}bp) vs plain on the card: fill {e_fill} "
        f"({plain_fill_ms:.1f} ms), walk {e_walk} ({plain_walk_ms:.1f} ms) [{card}]")
    if e_fill or e_walk:
        fail(f"a runs kernel differs from its plain version at the path's width: {errs}")
    cells3 = nb * LB * LB
    rec = {
        "nw_fill_runs_batch": dict(
            ms=sum(fill_ms), plain_ms=plain_fill_ms,
            **bound(cells3 * (OPS_SCORE + OPS_COUNT + OPS_CODE + OPS_RUN), tensor_bytes(*T3) + sum(runs_parts)),
            shape=f"{nb}x{LB}bp run bytes+counts in {len(parts)} launches of {sub} and {nb - sub} pairs "
                  f"({' + '.join(f'{x:.3f}' for x in fill_ms)} ms; nw_fill_codes codes+counts at {nb}x{LB}bp "
                  f"{codes_fill_ms:.3f} ms in one; at 128x{LB}bp, in turns, runs {[round(x, 3) for x in same['runs']]} "
                  f"ms, codes {[round(x, 3) for x in same['codes']]} ms, masks {[round(x, 3) for x in same['masks']]} "
                  f"ms; plain_ms at 1x{LB}bp)"),
        "nw_walk_runs": dict(
            ms=sum(walk_ms), plain_ms=plain_walk_ms,
            **bound(n_loads * OPS_WALK_STEP, tensor_bytes(*T3[2:]) + 4 * nb + n_loads + steps),
            shape=f"{nb}x{LB}bp in {len(parts)} launches ({' + '.join(f'{x:.3f}' for x in walk_ms)} ms), "
                  f"{n_loads} loads for {steps} steps ({n_loads / nb:.1f} a pair, max {int(loads.max())}, "
                  f"against nw_walk's {steps / nb:.1f} steps a pair; nw_walk {walk_codes_ms:.3f} ms at {nb}x{LB}bp; "
                  f"plain_ms at 1x{LB}bp)"),
    }
    for name, fields in rec.items():
        fields.update(launches=launches[name], max_abs_err=errs[name])
        log(f"kernel {name}: {fields['ms']:.3f} ms, bound {fields['bound_ms']:.4f} ms ({fields['bound_by']}), "
            f"plain {fields['plain_ms']:.1f} ms, {fields['shape']} [{card}]")
    del T3, parts, h, one
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec.update(flat_path(card, bound, c2))
    log(f"phase 14 (c) seconds {time.perf_counter() - t0:.1f}")
    log(f"phase 14 peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"seconds {time.perf_counter() - t_phase:.1f} [{card}]")
    return rec


# the pipeline at a forced W (warps a pair): phase 3 holds nw_scores and
# nw_fill_codes at each W against plain, phases 9 and 10 sw_scores,
# overlap_scores and gotoh_scores, phase 11 gotoh_fill_codes; phases 5
# and 9-11 time W = 1 against the rule's in turns and sweep W
PIPE_WARPS = (1, 2, 3, 4, 8, 16, 32)
SWEEP_WARPS = (1, 2, 4, 8, 16, 32)
PIPE_MODES = ("scores", "counts", "codes", "codes+counts")


def pipe_fill(mode, T, mkd, warps=None):
    """``nw_scores`` (mode "scores"), ``sw_scores`` ("sw"),
    ``overlap_scores`` ("overlap"), ``gotoh_scores`` ("gotoh"),
    ``gotoh_fill_codes`` ("gotoh_codes") or ``nw_fill_codes``
    counts-only, codes or codes + counts on T = (tops, sides, lens1,
    lens2) under scoring ``mkd`` at ``warps`` warps a pair (None: the
    rule's); the outputs the mode has."""
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import variants_banded as vb

    if mode == "gotoh":
        return (vb.affine_scores_banded_batch(*T, *mkd, warps=warps),)
    if mode == "gotoh_codes":
        return vb.affine_fill_codes_banded_batch(*T, *mkd, warps=warps)
    if mode == "scores":
        return (fb._fill_scores_kernel(fb.fill_scores_banded_batch, *T, *mkd, warps=warps),)
    if mode in ("sw", "overlap"):
        wrapper = getattr(vb, f"{mode}_scores_banded_batch")
        return (fb._fill_scores_kernel(wrapper, *T, *mkd, warps=warps, entry=f"{mode}_scores"),)
    wrapper = fb.fill_scores_counts_banded_batch if mode == "counts" else fb.fill_greedy_counts_banded_batch
    out = fb._fill_codes_kernel(wrapper, *T, *mkd, emit_codes=mode != "counts",
                                with_counts=mode != "codes", warps=warps)
    return tuple(x for x in out if x is not None)


def pipe_plain(mode, T, mkd):
    """The plain version of :func:`pipe_fill`."""
    from nw_tpu_torch.ops import fill_banded as fb

    if mode == "scores":
        return (fb.fill_scores_banded_batch_plain(*T, *mkd),)
    if mode == "counts":
        return fb.fill_scores_counts_banded_batch_plain(*T, *mkd)
    out = fb.fill_greedy_counts_banded_batch_plain(*T, *mkd, with_counts=mode == "codes+counts")
    return tuple(x for x in out if x is not None)


def pipe_vs_plain(T, mkd, errs):
    """Phase 3: ``nw_scores`` and ``nw_fill_codes``' three modes at every
    W of ``PIPE_WARPS`` and at the rule's W bit for bit against their
    plain versions under one scoring; raises the records' max |diff| and
    returns the plain outputs by mode."""
    e, plain = {}, {}
    for mode in PIPE_MODES:
        want = plain[mode] = pipe_plain(mode, T, mkd)
        for W in (*PIPE_WARPS, None):
            got = pipe_fill(mode, T, mkd, W)
            e[mode, W or "rule"] = max(max_abs_err(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    for (mode, _), v in e.items():
        name = "nw_scores" if mode == "scores" else "nw_fill_codes"
        errs[name] = max(errs[name], v)
    bad = {f"{mode} W={W}": v for (mode, W), v in e.items() if v}
    log(f"pipeline vs plain, {T[0].shape[0]} pairs {T[0].shape[1]}x{T[1].shape[1]} bucket, "
        f"{len(PIPE_MODES)} modes at W in {PIPE_WARPS} and the rule's {pipe_rule('scores', T)}, "
        f"m k d = {mkd}: max |diff| {max(e.values())}" + (f", differs at {bad}" if bad else ""))
    return plain


def pipe_rule(mode, T):
    """The rule's W for ``mode`` on T on this card: ``fill_warps``, or
    for the Gotoh modes ``gotoh_warps``."""
    from nw_tpu_torch.ops import fill_banded as fb
    from nw_tpu_torch.ops import variants_banded as vb

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if mode in ("gotoh", "gotoh_codes"):
        return vb.gotoh_warps(T[0].shape[0], T[0].shape[1], T[1].shape[1], mode == "gotoh_codes", sms)
    return fb.fill_warps(T[0].shape[0], T[0].shape[1], T[1].shape[1],
                         8 if mode in ("counts", "codes+counts") else 4, sms)


def pipe_scoring(mode):
    """The scoring phases 5, 9-11 time ``mode`` at: 2 1 1, Gotoh's 2 1 3 1."""
    return (2, 1, 3, 1) if mode in ("gotoh", "gotoh_codes") else (2, 1, 1)


def k7_inputs(dev):
    """K7's shape: 1 024 random pairs of 256 bp (seed 141)."""
    from nw_tpu_torch.ops import encode as enc

    return enc.upload(enc.encode_batch(rand_pairs(np.random.default_rng(141), 1024, L_FLAT, L_FLAT),
                                       L_FLAT, L_FLAT), dev)


def pipe_shapes(T3, T2, T7):
    """(label, mode, T, reps) of every shape phase 5 times the pipeline
    at: config 3's fill, 128 x 10 240 bp scores, 4 x 10 240 bp codes +
    counts (from config 3's inputs T3), config 2's scores and scores +
    counts, K5's codes (T2), K7's scores (T7)."""
    return [
        (f"config 3 codes+counts 256x{L_LONG}bp", "codes+counts", T3, 1),
        (f"scores 128x{L_LONG}bp", "scores", tuple(t[:128] for t in T3), 2),
        (f"codes+counts 4x{L_LONG}bp", "codes+counts", tuple(t[:4] for t in T3), 2),
        (f"scores {T2[0].shape[0]}x{L_SHORT}bp (config 2, K1, K3)", "scores", T2, 20),
        (f"scores+counts {T2[0].shape[0]}x{L_SHORT}bp (K4, K26)", "counts", T2, 20),
        (f"codes 4096x{L_SHORT}bp (K5)", "codes", tuple(t[:4096] for t in T2), 20),
        (f"scores 1024x{L_FLAT}bp (K7)", "scores", T7, 20),
    ]


def pipe_turns(card, shapes):
    """Phases 5, 9-11: each (label, mode, T, reps) of ``shapes`` at W = 1
    and at the rule's W, timed in turns (1, rule, rule, 1), after checking
    that both give the same outputs on the card (``pipe_scoring``).  Returns
    {label: (rule's W, [ms at W = 1], [ms at the rule's W])}."""
    out = {}
    for label, mode, T, reps in shapes:
        rule, sc = pipe_rule(mode, T), pipe_scoring(mode)
        a = pipe_fill(mode, T, sc, 1)
        b = pipe_fill(mode, T, sc, rule)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"{label}: the outputs at W = {rule} differ from W = 1")
        del a, b
        times = {"one": [], "rule": []}
        for key, W in (("one", 1), ("rule", rule), ("rule", rule), ("one", 1)):
            times[key].append(cuda_ms(lambda: pipe_fill(mode, T, sc, W), reps))
        out[label] = (rule, times["one"], times["rule"])
        log(f"turns {label}: W = 1 {[round(x, 3) for x in times['one']]} ms, W = {rule} (the rule's) "
            f"{[round(x, 3) for x in times['rule']]} ms (outputs equal) [{card}]")
    return out


def pipe_sweep(card, shapes):
    """Phases 5, 9-11: each (label, mode, T) of ``shapes`` at every W
    of ``SWEEP_WARPS`` (one warm-up, one timed run each)."""
    for label, mode, T in shapes:
        ms = {W: cuda_ms(lambda: pipe_fill(mode, T, pipe_scoring(mode), W), 1) for W in SWEEP_WARPS}
        log(f"sweep {label} (the rule's W {pipe_rule(mode, T)}): "
            + ", ".join(f"W={W} {x:.3f} ms" for W, x in ms.items()) + f" [{card}]")


def check_pairs():
    """Phase 3's pairs (seed 0): 64 random of 0-700 bp, 8 tie-dense of
    100-400 bp, and ``EDGE``."""
    rng = np.random.default_rng(0)
    return rand_pairs(rng, 64, 0, 700) + rand_pairs(rng, 8, 100, 400, b"AC") + EDGE


def config_pairs():
    """The main path's configs (seed 4): config 3's 256 random 10 240 bp
    pairs and config 2's 10 240 random 150 bp pairs."""
    rng = np.random.default_rng(4)
    letters = np.frombuffer(b"ACGT", np.uint8)

    def pairs(n, length):
        return [(letters[rng.integers(0, 4, length)].tobytes(), letters[rng.integers(0, 4, length)].tobytes())
                for _ in range(n)]

    c3 = pairs(256, L_LONG)
    return c3, pairs(10240, L_SHORT)


def main() -> None:
    t_start = time.perf_counter()
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
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bound = Bound(sms, clock_mhz * 1e6)
    log(f"bounds: {sms} SMs x {INT32_LANES_PER_SM} INT32 lanes x {clock_mhz:.0f} MHz "
        f"(clocks.max.sm), {HBM_BYTES_PER_S / 1e12} TB/s")
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"triton {'installed' if importlib.util.find_spec('triton') else 'absent'} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}"
    )

    # 2. build, and beside it ptxas -v of the batched fill and walk
    t0 = time.perf_counter()
    ptxas = start_ptxas_report()
    kernels.load()
    log(f"kernel build+load: {time.perf_counter() - t0:.1f} s ({kernels.library_path().name})")
    print_ptxas_report(ptxas)

    # 3. each kernel bit for bit against its plain version
    cfg = AlignConfig()
    small = check_pairs()
    L1 = cfg.bucket_for(max(len(a) for a, _ in small))
    L2 = cfg.bucket_for(max(len(b) for _, b in small))
    tops, sides, l1, l2 = enc.upload(enc.encode_batch(small, L1, L2), dev)
    errs = {"nw_scores": 0, "nw_fill_codes": 0, "nw_walk": 0}
    for mkd in SCORINGS:
        want = pipe_vs_plain((tops, sides, l1, l2), mkd, errs)["codes+counts"]
        got = fb.fill_greedy_counts_banded_batch(tops, sides, l1, l2, *mkd, with_counts=True)
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
    c3, c2 = config_pairs()
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
    bounds = {
        "nw_scores": bound(
            sum(len(a) * len(b) for a, b in c2) * OPS_SCORE,
            tensor_bytes(tops2, sides2, l1s, l2s) + 4 * len(c2),
        ),
        "nw_fill_codes": bound(
            len(sub) * L_LONG * L_LONG * (OPS_SCORE + OPS_COUNT + OPS_CODE),
            tensor_bytes(tops, sides, l1, l2, k_codes, k_sc, k_ct),
        ),
        "nw_walk": bound(
            int(k_n.sum()) * OPS_WALK_STEP, tensor_bytes(l1, l2, k_n) + 5 * int(k_n.sum())
        ),
    }
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
    T3, T2 = (tops3, sides3, l13, l23), (tops2, sides2, l1s, l2s)
    T7 = k7_inputs(dev)
    for mode, T in (("codes+counts", T3), ("scores", T3[:128]), ("counts", (tops3[:1], sides3[:1], l13[:1], l23[:1]))):
        log(f"pipeline shared memory, {mode} {T[0].shape[0]}x{T[0].shape[1]}bp at W = {pipe_rule(mode, T)}: "
            f"{fb.fill_smem(pipe_rule(mode, T), T[0].shape[1], 4 if mode == 'scores' else 8)} bytes")
    shapes = pipe_shapes(T3, T2, T7)
    turns = pipe_turns(card, shapes)
    turn_c, turn_s = turns[shapes[2][0]], turns[shapes[3][0]]  # the records' shapes
    pipe_sweep(card, [shape[:3] for shape in shapes[:2]])  # config 3's fill, 128 x 10 240 bp scores
    codes3, _, _ = fb.fill_greedy_counts_banded_batch(tops3, sides3, l13, l23, m, k, d)
    full["nw_walk 256x10240bp"] = cuda_ms(lambda: tb.walk_codes_batch(codes3, l13, l23, 2 * LB), 3)
    cells3 = 256 * L_LONG * L_LONG
    full_bounds = {  # bytes: inputs, plus codes (2 bits a cell), scores and counts out
        "nw_scores 128x10240bp": bound(cells3 // 2 * OPS_SCORE, tensor_bytes(*T3) // 2 + 4 * 128),
        "nw_fill_codes counts only 256x10240bp": bound(cells3 * (OPS_SCORE + OPS_COUNT),
                                                       tensor_bytes(*T3) + 8 * 256),
        "nw_fill_codes codes+counts 256x10240bp": bound(cells3 * (OPS_SCORE + OPS_COUNT + OPS_CODE),
                                                        tensor_bytes(*T3) + cells3 // 4 + 8 * 256),
        "nw_walk 256x10240bp": None,
    }
    for name, ms in full.items():
        b = full_bounds[name]
        log(f"kernel {name}: {ms:.3f} ms" + (f", bound {b['bound_ms']:.3f} ms ({b['bound_by']})" if b else "")
            + f" [{card}]")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    c3_strings = (r3.ops, r3.ops_len, c3)  # phase 11 times the host strings on them
    del codes3, tops3, sides3
    torch.cuda.empty_cache()

    # 6. the single-pair kernels; 7. the CLI (its own launch counters)
    single = single_phase(card, errs)
    cli_launches, cli_walls, cli_times = cli_phase(card, errs)
    # 8. huge pairs; 9. Smith-Waterman (their own launch counters)
    huge = huge_phase(card, bound)
    sw_rec = sw_phase(card, bound)
    # 10. overlap and Gotoh scores; 11. Gotoh tracebacks and the batch
    # CLI (their own launch counters)
    var_rec, overlap_walk = variants_phase(card, bound)
    gotoh_rec = gotoh_phase(card, bound, c3_strings)
    # 12. sharded runs (their own ranks and launch counters)
    sharded_rec = sharded_phase(card, bound)
    # 13. the tie-mask routes and Hirschberg (their own launch counters)
    masks_rec = masks_phase(card, bound)
    # 14. the runs walk engine and the flat-fill API (their own launch counters)
    runs_rec = runs_phase(card, bound, aligner, small, c3, r3, aligned, c2)
    sw_rec["sw_walk"]["launches"] += overlap_walk["launches"]
    sw_rec["sw_walk"]["max_abs_err"] = max(sw_rec["sw_walk"]["max_abs_err"], overlap_walk["max_abs_err"])
    sw_rec["sw_walk"]["shape"] += f"; overlap walks 128x{L_SW_TB}bp {overlap_walk['ms']:.3f} ms"

    single_src = "nw_tpu_torch/csrc/nw_single.cu"
    kernels_line = [
        {
            "name": "nw_scores", "route": "cuda", "source": "nw_tpu_torch/csrc/nw_fill.cu",
            "replaces": "nw_tpu/ops/fill_pallas_banded.py:98",
            "launches": launches["nw_scores"], "max_abs_err": errs["nw_scores"],
            "ms": k_scores_ms, "plain_ms": plain_scores_ms, **bounds["nw_scores"],
            "shape": f"{len(c2)}x{L_SHORT}bp scores, {turn_s[0]} warp(s) a pair; 128x{L_LONG}bp "
                     f"{full['nw_scores 128x10240bp']:.3f} ms at the rule's W",
            "warps": turn_s[0], "one_warp_ms": statistics.median(turn_s[1]),
        },
        {
            "name": "nw_fill_codes", "route": "cuda", "source": "nw_tpu_torch/csrc/nw_fill.cu",
            "replaces": "nw_tpu/ops/fill_pallas_banded.py:342",
            "launches": launches["nw_fill_codes"], "max_abs_err": errs["nw_fill_codes"],
            "ms": k_fill_ms, "plain_ms": plain_fill_ms, **bounds["nw_fill_codes"],
            "shape": f"4x{L_LONG}bp codes+counts, {turn_c[0]} warps a pair; config 3 "
                     f"{full['nw_fill_codes codes+counts 256x10240bp']:.3f} ms at the rule's W",
            "warps": turn_c[0], "one_warp_ms": statistics.median(turn_c[1]),
        },
        {
            "name": "nw_walk", "route": "cuda", "source": "nw_tpu_torch/csrc/nw_walk.cu",
            "replaces": "nw_tpu/ops/banded_traceback.py:115",
            "launches": launches["nw_walk"], "max_abs_err": errs["nw_walk"],
            "ms": k_walk_ms, "plain_ms": plain_walk_ms, **bounds["nw_walk"],
            "shape": f"4x{L_LONG}bp walk",
        },
        {
            "name": "nw_fill_masks", "route": "cuda", "source": single_src,
            "replaces": "nw_tpu/ops/fill_pallas_banded.py:342",
            "launches": cli_launches["nw_fill_masks"], "max_abs_err": errs["nw_fill_masks"],
            "ms": cli_times["fm_ms"], "plain_ms": cli_times["plain_fm_ms"],
            **bound(L_LONG * L_LONG * (OPS_SCORE + OPS_COUNT + OPS_CODE),
                    (L_LONG + 1) ** 2 + 8 * L_LONG + 8),
            "shape": f"1x{L_LONG}bp masks+count",
        },
        {
            "name": "nw_score_count", "route": "cuda", "source": single_src,
            "replaces": "nw_tpu/ops/fill_pallas_single.py:250",
            "launches": cli_launches["nw_score_count"], "max_abs_err": errs["nw_score_count"],
            "ms": cli_times["sc_ms"], "plain_ms": single["plain_sc_ms"],
            **bound(L_HUGE * L_HUGE * (OPS_SCORE + OPS_COUNT), 8 * L_HUGE + 8),
            "shape": f"1x{L_HUGE}bp score+count (plain_ms at {L_CROSS}x{L_CROSS}bp, "
                     f"kernel there {single['sc_ms_cross']:.3f} ms)",
        },
    ]
    replaces = {
        "nw_fill_codes_single": "nw_tpu/parallel/huge_pair.py:246",
        "nw_refill_blocks": "nw_tpu/ops/checkpoint_traceback.py:153 (K13, launched :241)",
        "nw_score_single": "nw_tpu/ops/fill_strips.py:62",
        "nw_score_single/ckpt": "nw_tpu/ops/checkpoint_traceback.py:61",
        "nw_walk_window": "nw_tpu/ops/checkpoint_traceback.py:353",
    }
    for name, fields in huge.items():
        src = "nw_tpu_torch/csrc/nw_walk.cu" if name == "nw_walk_window" else single_src
        kernels_line.append({"name": name, "route": "cuda", "source": src,
                             "replaces": replaces[name], **fields})
    sw_replaces = {
        "sw_scores": "nw_tpu/ops/variants_pallas.py:38 (K22), nw_tpu/ops/variants_rowsweep.py:85 (K15), "
                     "nw_tpu/ops/variants_banded.py:60 (K18 scores)",
        "sw_fill_codes": "nw_tpu/ops/variants_pallas.py:253 (K24), nw_tpu/ops/variants_banded.py:60 "
                         "(K18 words + argmax)",
        "sw_walk": "nw_tpu/models/smith_waterman.py:220, nw_tpu/ops/variants_banded.py:1300, "
                   "nw_tpu/models/overlap.py:178, nw_tpu/ops/variants_banded.py:752",
    }
    for name, fields in sw_rec.items():
        src = "nw_tpu_torch/csrc/nw_walk.cu" if name == "sw_walk" else "nw_tpu_torch/csrc/nw_fill.cu"
        kernels_line.append({"name": name, "route": "cuda", "source": src,
                             "replaces": sw_replaces[name], **fields})
    var_replaces = {
        "overlap_scores": "nw_tpu/ops/variants_rowsweep.py:183 (K16), nw_tpu/ops/variants_banded.py:423 "
                          "(K19 scores)",
        "overlap_fill_codes": "nw_tpu/ops/variants_banded.py:423 (K19 words + argmax)",
        "gotoh_scores": "nw_tpu/ops/variants_rowsweep.py:291 (K17), nw_tpu/ops/variants_pallas.py:131 (K23), "
                        "nw_tpu/ops/variants_banded.py:980 (K20)",
    }
    for name, fields in var_rec.items():
        src = "nw_tpu_torch/csrc/nw_affine.cu" if name == "gotoh_scores" else "nw_tpu_torch/csrc/nw_fill.cu"
        kernels_line.append({"name": name, "route": "cuda", "source": src,
                             "replaces": var_replaces[name], **fields})
    gotoh_replaces = {
        "gotoh_fill_codes": "nw_tpu/ops/variants_banded.py:1413 (K21), nw_tpu/ops/variants_pallas.py:429 (K25)",
        "gotoh_walk": "nw_tpu/models/affine.py:340, nw_tpu/ops/variants_banded.py:1803",
    }
    for name, fields in gotoh_rec.items():
        src = "nw_tpu_torch/csrc/nw_walk.cu" if name == "gotoh_walk" else "nw_tpu_torch/csrc/nw_affine.cu"
        kernels_line.append({"name": name, "route": "cuda", "source": src,
                             "replaces": gotoh_replaces[name], **fields})
    sharded_replaces = {
        "nw_fill_tile": "nw_tpu/parallel/huge_pair.py:246 (K14's mesh half)",
        "nw_fill_tile/scores": "nw_tpu/parallel/huge_pair.py:246 (K14's mesh half, scores)",
        "nw_fill_tile/masks": "nw_tpu/parallel/huge_pair.py:70 (K28)",
        "nw_walk_window/masks": "nw_tpu/parallel/huge_pair.py:871 (_make_relay_walk over K28's masks, :944)",
    }
    for name, fields in sharded_rec.items():
        src = "nw_tpu_torch/csrc/nw_walk.cu" if name.startswith("nw_walk") else single_src
        kernels_line.append({"name": name, "route": "cuda", "source": src,
                             "replaces": sharded_replaces[name], **fields})
    masks_replaces = {
        "nw_fill_masks_batch": "nw_tpu/ops/fill_pallas_banded.py:342 (K2's batched pack_bits=8 mode, "
                               "launched :969)",
        "nw_count_masks": "nw_tpu/ops/fill_pallas.py:703 (K6, launched :784)",
        "nw_walk_masks": "nw_tpu/ops/traceback.py:38 (traceback_greedy, vmapped :197-207)",
        "nw_fill_masks/fold": "nw_tpu/ops/fill_pallas_single.py:422 (K10, launched :561)",
        "nw_last_row": "nw_tpu/ops/fill_pallas_single.py:83 (K9, launched :198)",
    }
    masks_src = {"nw_fill_masks_batch": "nw_tpu_torch/csrc/nw_fill.cu", "nw_count_masks": "nw_tpu_torch/csrc/nw_count.cu",
                 "nw_walk_masks": "nw_tpu_torch/csrc/nw_walk.cu"}
    for name, fields in masks_rec.items():
        kernels_line.append({"name": name, "route": "cuda", "source": masks_src.get(name, single_src),
                             "replaces": masks_replaces[name], **fields})
    runs_replaces = {
        "nw_fill_runs_batch": "nw_tpu/ops/fill_pallas_banded.py:342 (K2's with_runs mode, launched :969)",
        "nw_walk_runs": "nw_tpu/ops/banded_traceback.py:187 (_make_runs_walk_loop)",
        "nw_fill_codes/flat": "nw_tpu/ops/fill_pallas.py:268 (K26, launched :363; K4's shape, "
                              "nw_tpu/ops/fill_rowsweep.py:154)",
        "nw_fill_masks_batch/flat": "nw_tpu/ops/fill_pallas.py:432/456 (K27, launched :648)",
        "nw_count_masks/flat": "nw_tpu/ops/fill_pallas.py:703 (K6 over K27's words, launched :784)",
        "nw_scores/flat": "nw_tpu/ops/fill_pallas.py:103 (K7, launched :230)",
        "nw_fill_codes/K5": "nw_tpu/ops/arrows_rowsweep.py:63 (K5's shape, launched :250)",
        "nw_walk/K5": "nw_tpu/ops/traceback.py:141 (traceback_greedy2_rowmajor over K5's codes, at K5's shape)",
    }
    runs_src = {"nw_walk_runs": "nw_tpu_torch/csrc/nw_walk.cu", "nw_walk/K5": "nw_tpu_torch/csrc/nw_walk.cu",
                "nw_count_masks/flat": "nw_tpu_torch/csrc/nw_count.cu"}
    for name, fields in runs_rec.items():
        kernels_line.append({"name": name, "route": "cuda",
                             "source": runs_src.get(name, "nw_tpu_torch/csrc/nw_fill.cu"),
                             "replaces": runs_replaces[name], **fields})
    for kern in kernels_line:
        kern["library_ms"] = None  # no one PyTorch call computes a DP fill or walk
    record = {"kernels": kernels_line}
    log(f"chip_smoke seconds {time.perf_counter() - t_start:.1f}, the kernels' build included [{card}]")
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
