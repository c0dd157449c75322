"""O(M*N) dynamic programs over tie masks, in plain PyTorch.

Port of ``nw_tpu/ops/pathcount.py``:

* **count** (``count_paths_batch``, ``count_paths``): paths[0,0] = 1, and
  every other cell sums the paths of its optimal predecessors (the
  tie-mask bits).  The count at the true corner is the number of optimal
  alignments, in uint32 arithmetic that wraps exactly as the reference's
  ``unsigned int solution_count`` (computation.h:65).
* **mark** (``mark_optimal_cells``): the cells backward-reachable from
  the corner, which the reference's DFS marks for ``-t``
  (needleman-wunsch.c:239-241).
* **branches** (``count_branches``): interior cells with more than one
  optimal direction, the debug build's ``branch_count``
  (needleman-wunsch.c:507-509, :624-625).

The single-pair functions take one pair's rectangular masks
uint8[len2+1, len1+1] (as ``nw_fill_masks`` writes them); the TPU
package's take diagonal-major tables and the true lengths.  These are
``jnp`` in ``nw_tpu``, not Pallas, so PyTorch ops on the device are
their port.
"""

from __future__ import annotations

import torch

from nw_tpu_torch.ops.fill_scan import U32, _shift_down, diag_to_matrix, matrix_to_diag


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


def count_paths(masks: torch.Tensor) -> int:
    """Optimal-alignment count of one pair, in ``[0, 2^32)``, from its
    rectangular masks uint8[len2+1, len1+1]."""
    N, M = masks.shape
    lens = torch.tensor([M - 1], device=masks.device)
    return int(count_paths_batch(matrix_to_diag(masks)[None], lens, lens.new_tensor([N - 1]))[0])


def mark_optimal_cells(masks: torch.Tensor) -> torch.Tensor:
    """bool[len2+1, len1+1]: the cells on some optimal path, i.e.
    backward-reachable from the corner along the mask bits
    (``pathcount.py:119``).  Swept backward over anti-diagonals: a cell
    is reached from its successor to the right (LEFT bit), below (UP)
    or below-right (DIAG)."""
    N, M = masks.shape
    diag = matrix_to_diag(masks)  # [K, N], K = M + N - 1
    K = diag.shape[0]
    false = torch.zeros(1, dtype=torch.bool, device=masks.device)
    reach = torch.zeros((K, N), dtype=torch.bool, device=masks.device)
    reach[K - 1, N - 1] = True  # the corner
    for kk in range(K - 2, -1, -1):
        a1 = diag[kk + 1]
        via_left = reach[kk + 1] & ((a1 & 2) != 0)
        # the successor one row below sits one lane up
        via_up = torch.cat([(reach[kk + 1] & ((a1 & 4) != 0))[1:], false])
        if kk + 2 < K:
            via_diag = torch.cat([(reach[kk + 2] & ((diag[kk + 2] & 1) != 0))[1:], false])
            via_left = via_left | via_diag
        reach[kk] = via_left | via_up
    return diag_to_matrix(reach, M - 1, N - 1)


def count_branches(masks: torch.Tensor) -> int:
    """Interior cells (row, column >= 1) with more than one bit set in
    one pair's rectangular masks (``pathcount.py:163``)."""
    a = masks[1:, 1:].to(torch.int32)
    nbits = (a & 1) + ((a >> 1) & 1) + ((a >> 2) & 1)
    return int((nbits > 1).sum())
