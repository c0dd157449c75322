"""Smith-Waterman banded fills: the ports of TPU kernels K15, K18, K22
and K24.

Counterpart of ``nw_tpu/ops/variants_banded.py`` (K18, the module that
serves every side length).  Two wrappers, each with its plain PyTorch
version in this module:

* :func:`sw_scores_banded_batch` — int32 best local scores at any batch
  size and side length (``sw_scores``).  It stands in for K22
  (``nw_tpu/ops/variants_pallas.py:38 _sw_kernel``, flat, sides <= 4 096),
  K15 (``nw_tpu/ops/variants_rowsweep.py:85 _make_sw_kernel``, row-sweep,
  many short pairs) and K18's score mode
  (``nw_tpu/ops/variants_banded.py:60 _make_banded_sw_kernel``, sides
  > 4 096); ``nw_tpu`` picks among them with TPU break-evens.
* :func:`sw_fill_codes_banded_batch` — local 2-bit codes, best scores and
  their cells (``sw_fill_codes``).  It stands in for K24
  (``nw_tpu/ops/variants_pallas.py:253 _sw_arrows_kernel``, 3-bit tie
  masks + argmax, sides <= 2 048) and K18's words + argmax mode (sides
  > 2 048); the greedy local walk reads nothing but the 2-bit code.

Both are the ``LOCAL`` mode of the batched fill kernel
(``csrc/nw_fill.cu``), one warp a pair.  A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches the kernel or
raises.  Each counts its launches in ``.launches``.

Inputs are those of :mod:`nw_tpu_torch.ops.fill_banded`.  Codes have
``nw_fill_codes``'s band-major layout with 0 diag / 1 left / 2 up /
3 STOP; STOP marks a cell of score 0 (a local start) and every cell of
column 0.  The argmax is ``nw_tpu``'s scan tie rule: the first
anti-diagonal that reaches the best, then the lowest row; (0, 0) when
the best is 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nw_tpu_torch.ops.fill_banded import _check, _contig, _dims
from nw_tpu_torch.ops.fill_scan import code_shape, greedy_codes_from_arrows, sw_fill_diag_batch
from nw_tpu_torch.runtime import kernels


def sw_scores_banded_batch(tops, sides, lens1, lens2, m, k, d) -> torch.Tensor:
    """int32[B] best local scores (>= 0), one per pair."""
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return sw_scores_banded_batch_plain(tops, sides, lens1, lens2, m, k, d)
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    best = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        tops, sides, lens1, lens2 = _contig(tops, sides, lens1, lens2)
        bnd = torch.empty((B, A + 1), dtype=torch.int32, device=dev)
        kernels.launch(
            "sw_scores", dev,
            tops.data_ptr(), sides.data_ptr(), lens1.data_ptr(),
            lens2.data_ptr(), B, A, Bs, m, k, d,
            bnd.data_ptr(), best.data_ptr(),
        )
        sw_scores_banded_batch.launches += 1
    return best


sw_scores_banded_batch.launches = 0


def sw_scores_banded_batch_plain(tops, sides, lens1, lens2, m, k, d):
    """Plain version of :func:`sw_scores_banded_batch`."""
    return sw_fill_diag_batch(
        tops, sides, lens1, lens2, m, k, d, with_arrows=False
    )["score"]


def sw_fill_codes_banded_batch(
    tops, sides, lens1, lens2, m, k, d
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes int32[B, nbands, TW, 32], best int32[B], j* int32[B],
    i* int32[B]): the local code of every cell of the bucket table, the
    best local score and its cell."""
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return sw_fill_codes_banded_batch_plain(tops, sides, lens1, lens2, m, k, d)
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    codes = torch.empty(code_shape(B, A, Bs), dtype=torch.int32, device=dev)
    best, j_star, i_star = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    if B:
        tops, sides, lens1, lens2 = _contig(tops, sides, lens1, lens2)
        bnd = torch.empty((B, A + 1), dtype=torch.int32, device=dev)
        kernels.launch(
            "sw_fill_codes", dev,
            tops.data_ptr(), sides.data_ptr(), lens1.data_ptr(),
            lens2.data_ptr(), B, A, Bs, m, k, d, bnd.data_ptr(),
            codes.data_ptr(), best.data_ptr(), j_star.data_ptr(), i_star.data_ptr(),
        )
        sw_fill_codes_banded_batch.launches += 1
    return codes, best, j_star, i_star


sw_fill_codes_banded_batch.launches = 0


def sw_fill_codes_banded_batch_plain(tops, sides, lens1, lens2, m, k, d):
    """Plain version of :func:`sw_fill_codes_banded_batch`: the local
    anti-diagonal fill's tie masks turned into codes, STOP where a cell
    has none."""
    out = sw_fill_diag_batch(tops, sides, lens1, lens2, m, k, d, with_arrows=True)
    codes = greedy_codes_from_arrows(out["arrows"], local=True)
    j_star, i_star = out["argmax"].T.contiguous()
    return codes, out["score"], j_star, i_star
