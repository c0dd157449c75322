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

:func:`count_masks_batch` counts a batch's rectangular masks
uint8[B, Bs+1, A+1] (``fill_masks_banded_batch``, ``fill_arrows_fold_batch``):
the ``nw_count_masks`` kernel (``csrc/nw_count.cu``, W warps a pair,
W from :func:`count_warps`) on a CUDA tensor, the port of K6
(``nw_tpu/ops/fill_pallas.py:703 _count_kernel``,
``count_packed_pallas_batch`` at ``:757``) and of ``count_paths`` over
K10's masks; :func:`count_masks_batch_plain` on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from nw_tpu_torch.ops.fill_banded import MAX_WARPS, SLOTS, SMEM_LIMIT, WARPS_PER_SM, _sms
from nw_tpu_torch.ops.fill_scan import (
    U32, _shift_down, diag_to_matrix, matrix_to_diag, matrix_to_diag_batch,
)
from nw_tpu_torch.runtime import kernels

MASK_RING_BYTES = 32 * 64  # a warp's 32-row x 64-column byte ring


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


def check_masks(masks, lens1, lens2):
    """Validate a batch of rectangular masks and the true lengths the
    kernels index them with."""
    if masks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CPU or CUDA tensors expected, got {masks.device}")
    if masks.dim() != 3 or masks.dtype != torch.uint8:
        raise ValueError("masks must be uint8[B, Bs+1, A+1]")
    for t in (lens1, lens2):
        if t.shape != (masks.shape[0],) or t.dtype != torch.int32 or t.device != masks.device:
            raise ValueError("lens must be int32[B] on the masks' device")
    if masks.shape[0]:
        lo, hi = torch.aminmax(torch.stack([lens1, lens2]), dim=1)
        (lo1, lo2), (hi1, hi2) = lo.tolist(), hi.tolist()
        if min(lo1, lo2) < 0 or hi1 >= masks.shape[2] or hi2 >= masks.shape[1]:
            raise ValueError("lengths must lie inside the mask tables")


def count_smem(warps: int) -> int:
    """Bytes of dynamic shared memory of one ``nw_count_masks`` block
    (the kernel's ``count_smem``): the warps' byte rings, count rings
    and chunk counters, and warp 0's staged row above."""
    return warps * MASK_RING_BYTES + 4 * (warps * 32 * SLOTS + 32 + warps)


def count_warps(B: int, Bs: int, sms: int) -> int:
    """W, the warps a pair of a batch of ``B`` mask tables of ``Bs`` rows
    below row 0: about ``WARPS_PER_SM`` warps on each of the ``sms`` SMs
    from the whole batch, never more than the pair's 32-row bands,
    ``MAX_WARPS`` or what the shared memory holds (the rule of
    :func:`nw_tpu_torch.ops.fill_banded.fill_warps`)."""
    nbands = -(-Bs // 32)
    per_sm = max(1, -(-B // sms))  # pairs an SM takes
    warps = max(1, min(MAX_WARPS, nbands, -(-WARPS_PER_SM // per_sm)))
    while warps > 1 and count_smem(warps) > SMEM_LIMIT:
        warps -= 1
    return warps


def count_masks_batch(
    masks: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    warps: Optional[int] = None,
) -> torch.Tensor:
    """Optimal-alignment counts, int64[B] in ``[0, 2^32)``, read at each
    pair's true corner (lens2[b], lens1[b]) of rectangular tie masks
    uint8[B, Bs+1, A+1].  Row 0 and column 0 count one path each, as
    every fill of the package writes them (LEFT, UP).

    A CUDA tensor goes through the ``nw_count_masks`` kernel, ``warps``
    warps a pair (default :func:`count_warps`); a CPU tensor through
    :func:`count_masks_batch_plain`.
    """
    check_masks(masks, lens1, lens2)
    if warps is not None and not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"warps must lie in [1, {MAX_WARPS}], not {warps}")
    if masks.device.type == "cpu":
        return count_masks_batch_plain(masks, lens1, lens2)
    B, N, M = masks.shape
    counts = torch.empty(B, dtype=torch.int32, device=masks.device)
    if B:
        if warps is None:
            warps = count_warps(B, N - 1, _sms(masks.device))
        masks, lens1, lens2 = (t.contiguous() for t in (masks, lens1, lens2))
        cbnd = torch.empty((B, M), dtype=torch.int32, device=masks.device)
        kernels.launch(
            "nw_count_masks", masks.device,
            masks.data_ptr(), lens1.data_ptr(), lens2.data_ptr(), B, M - 1, N - 1, warps,
            cbnd.data_ptr(), counts.data_ptr(),
        )
        count_masks_batch.launches += 1
    return counts.to(torch.int64) & U32


count_masks_batch.launches = 0


def count_masks_batch_plain(
    masks: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`count_masks_batch`:
    :func:`count_paths_batch` over the masks made diagonal-major."""
    return count_paths_batch(matrix_to_diag_batch(masks), lens1, lens2)


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
