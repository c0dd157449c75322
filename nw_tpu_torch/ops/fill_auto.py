"""Routing for the batched fills.

Counterpart of ``nw_tpu/ops/fill_auto.py``.  The TPU routes by its own
geometry (flat, row-sweep, banded and fold kernels, K3-K8); on the H100
every batch shape goes through the K1 port for now, until measurements
on the card give the other ports a place.

The two constants below send a small batch of huge pairs, one pair at
a time, to ``NWAligner.summary_huge`` (counts; the K8 port); their
strings need the huge-pair engines, not ported yet.
"""

from __future__ import annotations

import torch

from nw_tpu_torch.ops.fill_banded import fill_scores_banded_batch

# a batch smaller than this, of pairs longer than HUGE_PAIR_MIN_SIDE,
# goes pair by pair through the huge-pair routes (nw_tpu
# models/needleman_wunsch.py:498-509)
BANDED_MIN_BATCH = 24
HUGE_PAIR_MIN_SIDE = 32768


def fill_scores_auto(tops, sides, lens1, lens2, m, k, d) -> torch.Tensor:
    """int32[B] optimal scores through the fill for this batch shape."""
    return fill_scores_banded_batch(tops, sides, lens1, lens2, m, k, d)
