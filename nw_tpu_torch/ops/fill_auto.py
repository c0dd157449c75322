"""Routing for the batched fills.

Counterpart of ``nw_tpu/ops/fill_auto.py``.  The TPU routes by its own
geometry (flat, row-sweep, banded and fold kernels, K3-K8, K11); on the
H100 a batch of scores goes through the K1 port (a block a pair), except
a batch of fewer than ``BANDED_MIN_BATCH`` pairs whose buckets are long
enough for their number (:func:`takes_single_pair_route`): its pairs go
one at a time through the K11 port
(:func:`nw_tpu_torch.ops.fill_single.score_fold`, every SM on one pair),
as ``nw_tpu`` sends them to K11 / K8 (``fill_auto.py:233-276``).

The same two batch constants send a small batch of pairs over
``HUGE_PAIR_MIN_SIDE`` through ``NWAligner``'s huge-pair routes when it
asks for counts or strings.

:func:`fill_arrows_auto` is the counterpart of ``nw_tpu``'s
``fill_arrows_auto`` (``fill_auto.py:283``): a batch's tie masks through
the batched ``MASKS`` fill (K2's ``pack_bits=8`` mode, W warps a pair)
for sides up to ``LANES_ARROWS_MAX_SIDE``, else a pair at a time through
``nw_fill_masks`` (K10's port, every SM on one pair).
"""

from __future__ import annotations

import torch

from nw_tpu_torch.ops.fill_banded import fill_masks_banded_batch, fill_scores_banded_batch
from nw_tpu_torch.ops.fill_single import fill_arrows_fold_batch, score_fold

# a batch smaller than this, of pairs longer than HUGE_PAIR_MIN_SIDE,
# goes pair by pair through the huge-pair routes (nw_tpu
# models/needleman_wunsch.py:498-509)
BANDED_MIN_BATCH = 24
HUGE_PAIR_MIN_SIDE = 32768
# The K1 port runs a batch's pairs side by side, a block of W warps each,
# in a time ~L^2 whatever their number up to one pair an SM; the K11
# port runs them one after another, each on every SM, in ~L a pair.
# Timed in turns by scripts/single_shapes.py --routes on an H100 80GB
# HBM3 at 700 W (PERF.md, section 6), K1 took 1.43-1.56, 8.15-8.36 and
# 765 ms at 4 096, 10 240 and 100 000 bp, K11 0.61, 1.47 and 14.8 ms a
# pair: K11's route won at 2 pairs of 4 096 bp (1.18-1.22 against
# 1.45-1.51 ms) and 4 of 10 240 (5.89 against 8.24-8.26), K1's at 4 of
# 4 096 (1.49-1.56 against 2.39) and 6 of 10 240 (8.21-8.24 against
# 8.76-8.79): the costs cross at ~1 650-1 850 bp for each pair of the
# batch (at 100 kb past the 24 pairs that BANDED_MIN_BATCH allows).
# Timed from 1 024 bp up (chip_smoke.py phase 8).
SINGLE_PAIR_MIN_SIDE = 1024
SINGLE_PAIR_SIDE_PER_PAIR = 2000
# sides up to this go through the batched mask fill in fill_arrows_auto,
# longer ones a pair at a time (nw_tpu fill_auto.py:294-309)
LANES_ARROWS_MAX_SIDE = 2048
# align_batch's mask route (tie masks a pair at a time, every SM on it,
# then one walk, a warp a pair) against its codes route (a block a pair),
# strings and counts, timed in turns by scripts/single_shapes.py --routes
# (chip_smoke.py phase 13's batches) on an H100 80GB HBM3 at 700 W
# (PERF.md, section 6): the mask route costs ~2.6 ms a pair at 10 240 bp
# (12.1 ms for 4 pairs, 16.8 for 6), the codes route 18.7-21.2 ms at
# 10 240 bp for 2 to 23 pairs and 3.6-4.3 ms at 4 096 bp for 1 to 16.  The
# mask route won at 6 x 10 240 bp (16.8 against 18.9 ms) and 2 x 4 096 bp
# (3.1 against 3.8), the codes route at 7 x 10 240 bp (19.8 against 20.1)
# and 3 x 4 096 bp (3.9 against 4.2) and every larger batch timed.  Timed
# again by scripts/walk_shapes.py --masks, 19 pairs of runs in turns, twice
# (medians): at 6 x 10 240 bp the mask route won all 38 (16.9, 17.4
# against 18.9, 19.3 ms), at 7 the codes route all 38 (18.9, 19.0 against
# 19.5, 19.5).  The costs cross at nb ~ L / 1 500
MASK_SIDE_PER_PAIR = 1500


def takes_single_pair_route(nb: int, L1: int, L2: int) -> bool:
    """Whether the scores of ``nb`` pairs at buckets (L1, L2) go one pair
    at a time through the K11 port."""
    L = min(L1, L2)
    return 0 < nb < BANDED_MIN_BATCH and L >= max(
        SINGLE_PAIR_MIN_SIDE, SINGLE_PAIR_SIDE_PER_PAIR * nb
    )


def takes_mask_route(nb: int, L1: int, L2: int) -> bool:
    """Whether ``NWAligner.align_batch`` sends the counts or strings of
    ``nb`` pairs at buckets (L1, L2) through the mask route (tie masks a
    pair at a time, then one walk), as ``nw_tpu`` sends a small batch
    whose longer side passes ``LANES_ARROWS_MAX_SIDE``
    (``needleman_wunsch.py:636-647``), rather than through the codes
    route (a block a pair): only where the pairs are long enough for
    their number (``MASK_SIDE_PER_PAIR``) for the mask route to be the
    faster."""
    return (
        0 < nb < BANDED_MIN_BATCH
        and LANES_ARROWS_MAX_SIDE < max(L1, L2) <= HUGE_PAIR_MIN_SIDE
        and min(L1, L2) >= MASK_SIDE_PER_PAIR * nb
    )


def fill_scores_auto(tops, sides, lens1, lens2, m, k, d) -> torch.Tensor:
    """int32[B] optimal scores through the fill for this batch shape."""
    nb = tops.shape[0]
    if takes_single_pair_route(nb, tops.shape[1], sides.shape[1]):
        l1s, l2s = lens1.tolist(), lens2.tolist()
        return torch.stack([
            score_fold(tops[b], sides[b], m, k, d, l1s[b], l2s[b])[0]
            for b in range(nb)
        ])
    return fill_scores_banded_batch(tops, sides, lens1, lens2, m, k, d)


def fill_arrows_auto(tops, sides, lens1, lens2, m, k, d):
    """(masks uint8[B, Bs+1, A+1], batch_axis, scores int32[B]): the
    rectangular tie masks of a batch (0 outside each true table) and its
    scores, through the fill for this batch shape.  ``batch_axis`` is
    always 0; it keeps ``nw_tpu``'s signature, whose layouts put the
    batch on axis 0 or 2.  Sides up to ``LANES_ARROWS_MAX_SIDE`` go
    through :func:`nw_tpu_torch.ops.fill_banded.fill_masks_banded_batch`,
    longer ones through :func:`nw_tpu_torch.ops.fill_single.fill_arrows_fold_batch`;
    CPU tensors take their plain versions.  Count the masks with
    :func:`nw_tpu_torch.ops.pathcount.count_masks_batch`, walk them with
    :func:`nw_tpu_torch.ops.traceback.walk_masks_batch`."""
    fill = fill_masks_banded_batch if sides.shape[1] <= LANES_ARROWS_MAX_SIDE else fill_arrows_fold_batch
    masks, scores, _ = fill(tops, sides, lens1, lens2, m, k, d)
    return masks, 0, scores
