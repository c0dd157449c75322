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
2. **Backward block pass**: from the last block to the first, groups of
   G blocks of rows (r0, r0 + C] are re-filled from their checkpoint rows
   in one launch (:func:`~nw_tpu_torch.ops.fill_single.fill_codes_blocks`;
   ``nw_refill_blocks``, the K13 port), and each block of the group, last
   first, is walked from where the walk of the block below stopped until
   it reaches row r0 (:func:`~nw_tpu_torch.ops.traceback.walk_codes_window`;
   ``nw_walk_window``).  The walk's position lives in device memory, so
   the whole pass is enqueued on one stream with no host sync.

The fill work is twice one fill; the codes live at any moment are one
group's, G blocks of ``C * (A + 32) / 4`` bytes, with G from
:func:`refill_group`.  The ops are those of
:func:`nw_tpu_torch.ops.traceback.walk_codes_batch` on the whole pair's
codes (corner -> origin).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

from nw_tpu_torch.ops.fill_scan import code_shape
from nw_tpu_torch.ops.fill_single import fill_codes_blocks, resident_warps, score_fold
from nw_tpu_torch.ops.traceback import OP_LEFT, OP_NONE, walk_codes_window

BLOCK_QUANTUM = 32  # a block is whole 32-row bands
# default of NW_TPU_HUGE_WALK_HBM, the device bytes a huge pair's walk
# may spend on 2-bit codes (nw_tpu's default; a 100 000 bp pair needs
# 2.5 GB)
HUGE_WALK_BUDGET_BYTES = 8 << 30


def huge_walk_budget() -> int:
    """Device bytes a huge pair's walk may spend on its codes:
    ``NW_TPU_HUGE_WALK_HBM``, default :data:`HUGE_WALK_BUDGET_BYTES`."""
    return int(os.environ.get("NW_TPU_HUGE_WALK_HBM", HUGE_WALK_BUDGET_BYTES))


def refill_bytes(A: int, C: int) -> int:
    """Device bytes one block of C rows takes in a grouped re-fill: its
    2-bit codes and, at most, a ring row a band."""
    _, nbands, TW, lanes = code_shape(1, A, C)
    return nbands * (TW * lanes * 4 + 4 * (A + 1))


def refill_group(A: int, B: int, C: int, device) -> int:
    """G, the blocks of C rows of an A x B pair that one launch re-fills:
    the most whose codes and rings fit :func:`huge_walk_budget` and, on a
    card, whose bands all fit the warps one cooperative launch holds at
    once; at least one block, at most all ``ceil(B / C)``."""
    blocks = max(1, -(-B // C))
    G = min(blocks, huge_walk_budget() // refill_bytes(A, C))
    if torch.device(device).type == "cuda":
        G = min(G, resident_warps(device) // (C // 32))
    return max(1, G)


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
    G = refill_group(len1, len2, C, dev)
    state = torch.tensor([len1, len2, 0], dtype=torch.int32, device=dev)
    nbc = C // BLOCK_QUANTUM  # bands of a block
    for hi in range(ckpt.shape[0], 0, -G):
        lo = max(0, hi - G)
        r1 = min(len2, hi * C)
        codes, _ = fill_codes_blocks(top, side, m, k, d, len1, r1, lo * C, C, ckpt[lo:hi])
        for b in range(hi - 1, lo - 1, -1):
            first = (b - lo) * nbc
            walk_codes_window(codes[:, first : first + nbc], state, b * C, ops)
    i, j, n = state.tolist()
    if (i, j) != (0, 0):
        raise RuntimeError(
            f"the chained block walks stopped at ({i}, {j}) after {n} ops, "
            "not at the origin: a block's codes disagree with its checkpoint"
        )
    return ops, state[2]
