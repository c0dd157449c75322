"""Data-parallel batched alignment over the ranks of a mesh axis: the
counterpart of ``nw_tpu/parallel/data_parallel.py``.

Each rank holds its own shard of a pair batch and fills it on its
device; the run statistics merge with ``all_reduce`` — the replacement of
the reference's rwlock-guarded global counters (``solution_count``,
computation.c:223-260), and of ``nw_tpu``'s ``psum``.  Unlike
``nw_tpu``'s, whose ``.astype(jnp.int64)`` is int32 unless JAX runs with
``jax_enable_x64``, the sums here are exact int64: a batch of config 3's
26 843 545 600 cells reports that many.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nw_tpu_torch.models.needleman_wunsch import resolve_device
from nw_tpu_torch.ops.fill_auto import fill_scores_auto
from nw_tpu_torch.ops.fill_banded import fill_scores_counts_banded_batch
from nw_tpu_torch.ops.fill_scan import U32
from nw_tpu_torch.parallel.distributed import coll_device
from nw_tpu_torch.parallel.mesh import axis_group

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _as_tensor(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=torch.int32)


def batch_stats(
    scores: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    counts: Optional[torch.Tensor] = None, group=None,
) -> Dict[str, torch.Tensor]:
    """The run statistics of a shard, merged over ``group`` when given.

    ``pairs`` (pairs with a nonempty side), ``score_sum`` (over those
    pairs) and ``cells`` (sum of len1 * len2) are exact int64;
    ``score_min`` / ``score_max`` are int32, 2^31-1 / -2^31 where no pair
    is real; with ``counts``, ``solutions`` is their sum mod 2^32 (the
    reference's uint32 global counter), as int64.  Returns 0-d CPU
    tensors.
    """
    lens1 = lens1.to("cpu", torch.int64)
    lens2 = lens2.to("cpu", torch.int64)
    scores = scores.to("cpu", torch.int64)
    real = (lens1 > 0) | (lens2 > 0)
    sums = torch.stack([
        real.sum(),
        torch.where(real, scores, 0).sum(),
        (lens1 * lens2).sum(),
        torch.tensor(0) if counts is None else counts.to("cpu", torch.int64).sum() & U32,
    ])
    # one MIN reduction carries both extremes: max(x) = -min(-x)
    ext = torch.stack([
        torch.where(real, scores, INT32_MAX).min() if len(scores) else torch.tensor(INT32_MAX),
        -(torch.where(real, scores, INT32_MIN).max() if len(scores) else torch.tensor(INT32_MIN)),
    ])
    if group is not None and dist.get_world_size(group) > 1:
        dev = coll_device(group)
        sums, ext = sums.to(dev), ext.to(dev)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(ext, op=dist.ReduceOp.MIN, group=group)
        sums, ext = sums.cpu(), ext.cpu()
    stats = {
        "pairs": sums[0],
        "score_sum": sums[1],
        "score_min": ext[0].to(torch.int32),
        "score_max": (-ext[1]).to(torch.int32),
        "cells": sums[2],
    }
    if counts is not None:
        stats["solutions"] = sums[3] & U32
    return stats


def align_batch_sharded(
    tops, sides, lens1, lens2, *, m: int, k: int, d: int, mesh, axis: str = "data",
    with_counts: bool = False, device: str | torch.device = "cuda",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fill this rank's shard of a pair batch and merge the run
    statistics over ``axis`` (collective).

    Args:
      tops: int32[b, A]; sides: int32[b, Bs]; lens1 / lens2: int32[b] —
        this rank's shard (numpy or torch, as
        :func:`~nw_tpu_torch.ops.encode.encode_batch` makes it); every
        rank's shard has the same shape, so the batch divides evenly by
        the axis, as in ``nw_tpu``.
      device: ``"cuda"`` (the rank's current card: ``nw_scores``, or
        ``nw_fill_codes`` counts only with ``with_counts``) or ``"cpu"``
        (their plain versions).
    Returns:
      (scores int32[b * ranks] on the host, the whole batch in rank
      order as ``nw_tpu``'s global array reads; stats of
      :func:`batch_stats`, merged over the axis).
    """
    dev = resolve_device(device, "align_batch_sharded")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    group = axis_group(mesh, axis)
    tops, sides, lens1, lens2 = (_as_tensor(x, dev) for x in (tops, sides, lens1, lens2))
    if with_counts:
        scores, counts = fill_scores_counts_banded_batch(tops, sides, lens1, lens2, m, k, d)
    else:
        scores, counts = fill_scores_auto(tops, sides, lens1, lens2, m, k, d), None
    stats = batch_stats(scores, lens1, lens2, counts, group)
    local = scores.to(coll_device(group))
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts).cpu(), stats


def shard_batch(mesh, axis: str, *arrays):
    """This rank's slice of host arrays that hold the whole batch (the
    batch must divide evenly by the axis)."""
    group = axis_group(mesh, axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = []
    for a in arrays:
        if a.shape[0] % n:
            raise ValueError(f"a batch of {a.shape[0]} does not divide by {n} ranks")
        b = a.shape[0] // n
        out.append(a[r * b : (r + 1) * b])
    return tuple(out)
