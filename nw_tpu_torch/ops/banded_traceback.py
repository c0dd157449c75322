"""Exact greedy traceback of a batch at any side length.

Counterpart of ``nw_tpu/ops/banded_traceback.py``
(``traceback_banded_dispatch`` / ``_finalize`` / ``_batch``).  On the TPU
the walk words of a 16 GB chip had to be re-filled or walked group by
group and stitched on the device.  Here one fill emits the 2-bit greedy
code of every cell of the whole sub-batch (``nw_fill_codes``: ~26 MB for
a 10 kb pair, 3.4 GB for 128 of them, well inside 80 GB), and one walk
(``nw_walk``) reads them — the result is the first alignment the
reference emits, identical to :func:`nw_tpu_torch.ops.traceback.traceback_greedy_batch`
on full tie masks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from nw_tpu_torch.ops.fill_banded import fill_greedy_counts_banded_batch
from nw_tpu_torch.ops.traceback import walk_codes_batch


class BandedWalk(NamedTuple):
    """Device outputs of one dispatched sub-batch."""

    scores: torch.Tensor  # int32[B]
    counts: Optional[torch.Tensor]  # int64[B] in [0, 2^32), or None
    ops: torch.Tensor  # int8[B, A + Bs]
    n: torch.Tensor  # int32[B]


def traceback_banded_dispatch(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False
) -> BandedWalk:
    """Enqueue the code fill and the walk of one sub-batch; nothing is
    copied to the host.  The codes are freed when this returns (the
    caching allocator keeps their memory in stream order)."""
    A, Bs = tops.shape[1], sides.shape[1]
    codes, scores, counts = fill_greedy_counts_banded_batch(
        tops, sides, lens1, lens2, m, k, d, with_counts=with_counts
    )
    ops, n = walk_codes_batch(codes, lens1, lens2, max(A + Bs, 1))
    return BandedWalk(scores, counts, ops, n)


def traceback_banded_finalize(out: BandedWalk):
    """Copy one dispatched sub-batch to the host: (scores int32[B],
    [counts uint32[B],] ops int8[B, S], n int32[B])."""
    scores = out.scores.cpu().numpy()
    ops = out.ops.cpu().numpy()
    n = out.n.cpu().numpy()
    if out.counts is None:
        return scores, ops, n
    counts = out.counts.cpu().numpy().astype(np.uint32)
    return scores, counts, ops, n


def traceback_banded_batch(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False
):
    """Greedy traceback of a batch: (scores, ops, n), or (scores,
    counts, ops, n) with ``with_counts`` — host numpy arrays with the
    op-code semantics of :func:`nw_tpu_torch.ops.traceback.traceback_greedy_batch`
    (corner -> origin, diag > left > up, OP_NONE padded)."""
    return traceback_banded_finalize(
        traceback_banded_dispatch(
            tops, sides, lens1, lens2, m, k, d, with_counts=with_counts
        )
    )
