"""O(M*N) optimal-path counting over tie masks, in plain PyTorch.

Port of ``count_paths`` (``nw_tpu/ops/pathcount.py:36-73``): paths[0,0]
= 1, and every other cell sums the paths of its optimal predecessors
(the tie-mask bits).  The count at the true corner is the number of
optimal alignments, in uint32 arithmetic that wraps exactly as the
reference's ``unsigned int solution_count`` (computation.h:65).
"""

from __future__ import annotations

import torch

from nw_tpu_torch.ops.fill_scan import U32, _shift_down


def count_paths_batch(
    arrows: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor
) -> torch.Tensor:
    """Optimal-alignment counts, int64[B] in ``[0, 2^32)``.

    arrows: uint8[B, K, N] diagonal-major tie masks (bit0 diag, bit1
    left, bit2 up) from :func:`nw_tpu_torch.ops.fill_scan.fill_diag_batch`;
    lens1/lens2: int[B] true lengths.
    """
    B, K, N = arrows.shape
    dev = arrows.device
    lens1 = lens1.to(device=dev, dtype=torch.int64)
    lens2 = lens2.to(device=dev, dtype=torch.int64)
    k_corner = lens1 + lens2
    b_ar = torch.arange(B, device=dev)
    j_idx = torch.arange(N, device=dev)
    prev = (j_idx == 0).to(torch.int64).expand(B, N)
    prev2 = torch.zeros((B, N), dtype=torch.int64, device=dev)
    out = torch.where(k_corner == 0, prev[:, 0], 0)
    for kk in range(1, K):
        a = arrows[:, kk].to(torch.int64)
        cnt = (
            torch.where((a & 1) != 0, _shift_down(prev2, 0), 0)
            + torch.where((a & 2) != 0, prev, 0)
            + torch.where((a & 4) != 0, _shift_down(prev, 0), 0)
        ) & U32
        out = torch.where(kk == k_corner, cnt[b_ar, lens2.clamp(max=N - 1)], out)
        prev, prev2 = cnt, prev
    return out
