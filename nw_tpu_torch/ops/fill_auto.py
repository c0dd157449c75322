"""Routing for the batched fills.

Counterpart of ``nw_tpu/ops/fill_auto.py``.  The TPU routes by its own
geometry (flat, row-sweep, banded and fold kernels, K3-K8, K11); on the
H100 a batch of scores goes through the K1 port (one warp a pair), except
a batch of fewer than ``BANDED_MIN_BATCH`` pairs whose buckets are long
enough for their number (:func:`takes_single_pair_route`): its pairs go
one at a time through the K11 port
(:func:`nw_tpu_torch.ops.fill_single.score_fold`, every SM on one pair),
as ``nw_tpu`` sends them to K11 / K8 (``fill_auto.py:233-276``).

The same two batch constants send a small batch of pairs over
``HUGE_PAIR_MIN_SIDE`` through ``NWAligner``'s huge-pair routes when it
asks for counts or strings.
"""

from __future__ import annotations

import torch

from nw_tpu_torch.ops.fill_banded import fill_scores_banded_batch
from nw_tpu_torch.ops.fill_single import score_fold

# a batch smaller than this, of pairs longer than HUGE_PAIR_MIN_SIDE,
# goes pair by pair through the huge-pair routes (nw_tpu
# models/needleman_wunsch.py:498-509)
BANDED_MIN_BATCH = 24
HUGE_PAIR_MIN_SIDE = 32768
# The K1 port runs a batch's pairs side by side, one warp each, in a time
# ~L^2 whatever their number; the K11 port runs them one after another,
# each on every SM, in ~L a pair.  Timed by chip_smoke.py on an H100
# 80GB HBM3 at 700 W (PERF.md, section 6: 2, 8 and 23 pairs of 1 024 to
# 100 000 bp), K11's route wins once L passes ~256 bp for each pair of
# the batch; it was timed from 1 024 bp up.
SINGLE_PAIR_MIN_SIDE = 1024
SINGLE_PAIR_SIDE_PER_PAIR = 256


def takes_single_pair_route(nb: int, L1: int, L2: int) -> bool:
    """Whether the scores of ``nb`` pairs at buckets (L1, L2) go one pair
    at a time through the K11 port."""
    L = min(L1, L2)
    return 0 < nb < BANDED_MIN_BATCH and L >= max(
        SINGLE_PAIR_MIN_SIDE, SINGLE_PAIR_SIDE_PER_PAIR * nb
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
