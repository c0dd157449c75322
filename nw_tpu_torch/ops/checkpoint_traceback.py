"""Checkpointed exact traceback of one huge pair.

Counterpart of ``nw_tpu/ops/checkpoint_traceback.py``: the exact
first-emitted alignment (greedy diag > left > up, needleman-wunsch.c:305-324)
of a pair whose 2-bit codes do not fit the device, in
``O(A * B / C + C * A)`` memory, by the two-pass checkpoint scheme:

1. **Checkpoint pass**: one score-only fill that keeps the DP rows 0, C,
   2C, ... (:func:`nw_tpu_torch.ops.fill_single.score_fold` with
   ``checkpoint_every=C``; ``nw_score_single``, the K12 port).  The TPU
   kernel keeps its anti-diagonal state every C diagonals; here a block is
   C rows, so a checkpoint is one row.
2. **Backward block pass**: from the last block to the first, each block
   of rows (r0, r0 + C] is re-filled from its checkpoint row r0
   (:func:`~nw_tpu_torch.ops.fill_single.fill_codes_single` with a seed;
   ``nw_fill_codes_single``, the K13 port) and walked from where the walk
   of the block below stopped until it reaches row r0
   (:func:`~nw_tpu_torch.ops.traceback.walk_codes_window`;
   ``nw_walk_window``).  The walk's position lives in device memory, so
   the whole pass is enqueued on one stream with no host sync.

The fill work is twice one fill; the codes live at any moment are one
block's, ``C * (A + 32) / 4`` bytes.  The ops are those of
:func:`nw_tpu_torch.ops.traceback.walk_codes_batch` on the whole pair's
codes (corner -> origin).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from nw_tpu_torch.ops.fill_single import fill_codes_single, score_fold
from nw_tpu_torch.ops.traceback import OP_LEFT, OP_NONE, walk_codes_window

BLOCK_QUANTUM = 32  # a block is whole 32-row bands


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def auto_block_diagonals(A: int, B: int) -> int:
    """Memory-optimal rows per block C: the checkpoint rows cost
    ``4 (A+1) ceil(B/C)`` bytes and one block's codes ``C (A+32) / 4``, so
    the sum is least near ``C = 4 sqrt(B)``; rounded up to whole bands.
    (The name is ``nw_tpu``'s, whose blocks are anti-diagonals.)"""
    return max(BLOCK_QUANTUM, _round_up(int(4 * math.sqrt(max(B, 1))), BLOCK_QUANTUM))


def traceback_checkpointed(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
    len1: Optional[int] = None, len2: Optional[int] = None,
    block_diagonals: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ops int8[len1+len2], n int32 0-d tensor): the greedy first-emitted
    walk of one pair, corner -> origin, padded with OP_NONE.

    top / side: int32[A] / int32[Bs] encoded strings on the CPU (plain
    versions) or a card (kernels); len1 / len2 default to A / Bs.
    ``block_diagonals`` keeps ``nw_tpu``'s name: here it is the rows a
    block re-fills, rounded up to a multiple of 32 (default
    :func:`auto_block_diagonals`).  It changes memory and time, never
    the output.  Raises RuntimeError when the chained walks do not end at
    the origin (one host sync, after the last block).
    """
    len1 = top.shape[0] if len1 is None else int(len1)
    len2 = side.shape[0] if len2 is None else int(len2)
    dev = top.device
    ops = torch.full((len1 + len2,), OP_NONE, dtype=torch.int8, device=dev)
    if len2 == 0:  # row 0 alone: LEFT to the origin, nothing to fill
        ops.fill_(OP_LEFT)
        return ops, torch.tensor(len1, dtype=torch.int32, device=dev)
    C = _round_up(block_diagonals or auto_block_diagonals(len1, len2), BLOCK_QUANTUM)
    _, ckpt = score_fold(top, side, m, k, d, len1, len2, checkpoint_every=C)
    state = torch.tensor([len1, len2, 0], dtype=torch.int32, device=dev)
    for b in range(ckpt.shape[0] - 1, -1, -1):
        r0 = b * C
        r1 = min(len2, r0 + C)
        codes, _ = fill_codes_single(
            top, side, m, k, d, len1, r1, r0=r0, seed=ckpt[b] if r0 else None
        )
        walk_codes_window(codes, state, r0, ops)
    i, j, n = state.tolist()
    if (i, j) != (0, 0):
        raise RuntimeError(
            f"the chained block walks stopped at ({i}, {j}) after {n} ops, "
            "not at the origin: a block's codes disagree with its checkpoint"
        )
    return ops, state[2]
