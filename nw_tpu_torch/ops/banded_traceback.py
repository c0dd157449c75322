"""Exact greedy traceback of a batch at any side length.

Counterpart of ``nw_tpu/ops/banded_traceback.py``
(``traceback_banded_dispatch`` / ``_finalize`` / ``_batch`` and
``default_walk_engine``).  On the TPU the walk words of a 16 GB chip had
to be re-filled or walked group by group and stitched on the device.
Here one fill emits a value for every cell of the whole sub-batch, and
one walk reads them; the result is the first alignment the reference
emits, identical to :func:`nw_tpu_torch.ops.traceback.traceback_greedy_batch`
on full tie masks.  The walk engine (``engine=``, else
``NW_TPU_WALK_ENGINE``, as in ``nw_tpu``) picks what is stored:

* ``auto`` and ``onepass``: the 2-bit greedy code of every cell
  (``nw_fill_codes``: ~26 MB for a 10 kb pair, 3.4 GB for 128 of them,
  well inside 80 GB) and the step-by-step walk (``nw_walk``);
* ``runs``: the run byte of every cell, the greedy code and the length
  of its same-code run (``nw_fill_runs_batch``, K2's ``with_runs`` mode:
  a byte a cell, 105 MB for a 10 kb pair) and the run-skip walk
  (``nw_walk_runs``), one load a run.  Kept for parity with ``nw_tpu``'s
  engine choice only: on the H100 it gives the codes engine's outputs
  more slowly (4x the bytes a cell, two sub-batches at config 3; PERF.md
  section 5), so no workload should pick it.  It goes, with its branch
  here, once no counterpart of K2's ``with_runs`` mode is asked for;
* ``twopass`` and ``hoststitch``: ``nw_tpu``'s checkpointed re-fill
  engines, not ported (they need a batched checkpoint sweep and a
  seeded re-fill); they raise ``NotImplementedError``, never run another
  engine in their place.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from nw_tpu_torch.ops.fill_banded import fill_greedy_counts_banded_batch, fill_runs_banded_batch
from nw_tpu_torch.ops.traceback import walk_codes_batch, walk_runs_batch

# bits each engine stores a cell (the strings route's sub-batch rule)
ENGINE_CELL_BITS = {"auto": 2, "onepass": 2, "runs": 8}
UNPORTED_ENGINES = ("twopass", "hoststitch")


def default_walk_engine() -> str:
    """The walk engine ``NW_TPU_WALK_ENGINE`` names, ``auto`` by default."""
    return os.environ.get("NW_TPU_WALK_ENGINE", "auto")


def resolve_walk_engine(engine: Optional[str] = None) -> str:
    """``engine`` (None: :func:`default_walk_engine`) checked: a ported
    engine is returned, ``twopass`` / ``hoststitch`` raise
    ``NotImplementedError``, any other name ``ValueError``."""
    if engine is None:
        engine = default_walk_engine()
    if engine in UNPORTED_ENGINES:
        raise NotImplementedError(
            f"walk engine {engine!r} is not ported (ROADMAP.md queue 1 item 5: it needs a "
            "batched checkpoint sweep and a seeded re-fill); use 'auto', 'onepass' or 'runs'"
        )
    if engine not in ENGINE_CELL_BITS:
        raise ValueError(f"unknown walk engine {engine!r}; expected one of {sorted(ENGINE_CELL_BITS)}")
    return engine


class BandedWalk(NamedTuple):
    """Device outputs of one dispatched sub-batch."""

    scores: torch.Tensor  # int32[B]
    counts: Optional[torch.Tensor]  # int64[B] in [0, 2^32), or None
    ops: torch.Tensor  # int8[B, A + Bs]
    n: torch.Tensor  # int32[B]
    engine: str  # the walk engine that made them


def traceback_banded_dispatch(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False,
    engine: Optional[str] = None,
) -> BandedWalk:
    """Enqueue the fill and the walk of one sub-batch on ``engine``'s
    route; nothing is copied to the host.  The per-cell table is freed
    when this returns (the caching allocator keeps its memory in stream
    order)."""
    engine = resolve_walk_engine(engine)
    A, Bs = tops.shape[1], sides.shape[1]
    if engine == "runs":
        fill, walk = fill_runs_banded_batch, walk_runs_batch
    else:
        fill, walk = fill_greedy_counts_banded_batch, walk_codes_batch
    table, scores, counts = fill(tops, sides, lens1, lens2, m, k, d, with_counts=with_counts)
    ops, n = walk(table, lens1, lens2, max(A + Bs, 1))
    return BandedWalk(scores, counts, ops, n, engine)


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
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False,
    engine: Optional[str] = None,
):
    """Greedy traceback of a batch: (scores, ops, n), or (scores,
    counts, ops, n) with ``with_counts`` — host numpy arrays with the
    op-code semantics of :func:`nw_tpu_torch.ops.traceback.traceback_greedy_batch`
    (corner -> origin, diag > left > up, OP_NONE padded), the same on
    every engine."""
    return traceback_banded_finalize(
        traceback_banded_dispatch(
            tops, sides, lens1, lens2, m, k, d, with_counts=with_counts, engine=engine
        )
    )
