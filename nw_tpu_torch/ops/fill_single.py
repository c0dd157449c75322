"""One pair's score and solution count in O(A+B) memory: the K8 port.

Counterpart of ``nw_tpu/ops/fill_pallas_single.py:335 score_count_fold``.
:func:`score_count_fold` launches ``nw_score_count`` (``csrc/nw_single.cu``:
``blocks`` co-resident blocks of ``warps`` warps on the pair, a pipelined
wavefront of 32-row bands, nothing stored per cell) on CUDA tensors, and
runs :func:`score_count_fold_plain` on CPU tensors.  It counts its
launches in ``.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nw_tpu_torch.ops.fill_scan import U32, fill_diag
from nw_tpu_torch.runtime import kernels

WARPS = 8  # warps a block (1..32): past ~8 an SM is issue-bound
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def check_pair(top, side, m, k, d, len1, len2, warps, blocks) -> Tuple[int, int]:
    """Validate one pair's inputs; returns the true (len1, len2)."""
    if top.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CPU or CUDA tensors expected, got {top.device}")
    if top.dim() != 1 or side.dim() != 1:
        raise ValueError("top / side must be 1-D")
    if top.dtype != torch.int32 or side.dtype != torch.int32:
        raise ValueError("int32 tensors expected")
    if side.device != top.device:
        raise ValueError("top and side must be on one device")
    if not all(INT32_MIN <= v <= INT32_MAX for v in (m, k, d)):
        raise ValueError(f"scoring ({m}, {k}, {d}) must fit int32")
    len1 = top.shape[0] if len1 is None else int(len1)
    len2 = side.shape[0] if len2 is None else int(len2)
    if not (0 <= len1 <= top.shape[0] and 0 <= len2 <= side.shape[0]):
        raise ValueError("lengths must lie in [0, len(top)] / [0, len(side)]")
    if not 1 <= warps <= 32:
        raise ValueError(f"warps must lie in [1, 32], not {warps}")
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be at least 1, not {blocks}")
    # the kernels' chunk counters are int32: bands * chunks < 2^31
    if (len2 // 32 + 1) * (len1 // 32 + 3) >= 2**31:
        raise ValueError(f"a {len1} x {len2} table is too large")
    return len1, len2


def launch_shape(len2: int, warps: int, blocks: Optional[int], device) -> Tuple[int, int]:
    """(blocks, warps) of a single-pair launch: by default one block an
    SM, no more than the pair's 32-row bands fill."""
    if blocks is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = max(1, min(sms, -(-len2 // (32 * warps))))
    return blocks, warps


def single_scratch(len1: int, len2: int, blocks: int, warps: int, device):
    """The ring of boundary rows (scores, counts) one pair's band
    pipeline hands down (one per warp, no more than there are bands),
    the zeroed per-warp chunk counters, and the two one-element
    outputs."""
    rows = max(1, min(blocks * warps, -(-len2 // 32)))
    ring = torch.empty((rows, len1 + 1), dtype=torch.int32, device=device)
    cring = torch.empty((rows, len1 + 1), dtype=torch.int32, device=device)
    done = torch.zeros(blocks * warps, dtype=torch.int32, device=device)
    score = torch.empty(1, dtype=torch.int32, device=device)
    count = torch.empty(1, dtype=torch.int32, device=device)
    return ring, cring, done, score, count


def score_count_fold(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
    len1: Optional[int] = None, len2: Optional[int] = None,
    warps: int = WARPS, blocks: Optional[int] = None,
) -> Tuple[int, int]:
    """(optimal score, solution count mod 2^32) of one pair.

    top / side: int32[A] / int32[Bs] encoded strings (padding past the
    true lengths is ignored); len1 / len2 default to A / Bs.  ``blocks``
    defaults to one an SM, as many as the pair's bands fill.
    """
    len1, len2 = check_pair(top, side, m, k, d, len1, len2, warps, blocks)
    if top.device.type == "cpu":
        return score_count_fold_plain(top, side, m, k, d, len1, len2)
    dev = top.device
    top = top[:len1].contiguous()
    side = side[:len2].contiguous()
    blocks, warps = launch_shape(len2, warps, blocks, dev)
    ring, cring, done, score, count = single_scratch(len1, len2, blocks, warps, dev)
    kernels.launch(
        "nw_score_count", dev,
        top.data_ptr(), side.data_ptr(), len1, len2, m, k, d, blocks, warps,
        ring.data_ptr(), cring.data_ptr(), done.data_ptr(),
        score.data_ptr(), count.data_ptr(),
    )
    score_count_fold.launches += 1
    return int(score.item()), int(count.item()) & U32


score_count_fold.launches = 0


def score_count_fold_plain(top, side, m, k, d, len1=None, len2=None) -> Tuple[int, int]:
    """Plain version of :func:`score_count_fold`: the anti-diagonal fill
    with counts and nothing stored."""
    out = fill_diag(top, side, m, k, d, len1, len2, with_arrows=False, with_counts=True)
    return int(out["score"]), int(out["count"])
