"""Variant-model banded fills: the ports of TPU kernels K15-K20 and
K22-K24 (Smith-Waterman, overlap and Gotoh scores).

Counterpart of ``nw_tpu/ops/variants_banded.py`` (K18, K19 and K20, the
kernels that serve every side length).  Five wrappers, each with its
plain PyTorch version in this module:

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
* :func:`overlap_scores_banded_batch` — int32 best overlap scores
  (``overlap_scores``), for K16
  (``nw_tpu/ops/variants_rowsweep.py:183 _make_overlap_kernel``, sides
  <= 512) and K19's score mode
  (``nw_tpu/ops/variants_banded.py:423 _make_banded_overlap_kernel``,
  ``overlap_scores_banded_batch`` at ``:702``).
* :func:`overlap_fill_codes_banded_batch` — overlap 2-bit codes, best
  scores and their end cells (``overlap_fill_codes``), for K19's words +
  argmax mode (``overlap_traceback_banded_batch``, ``:939``).
* :func:`affine_scores_banded_batch` — int32 Gotoh global scores
  (``gotoh_scores``), for K17
  (``nw_tpu/ops/variants_rowsweep.py:291 _make_affine_kernel``, sides
  <= 512), K23 (``nw_tpu/ops/variants_pallas.py:131 _affine_kernel``,
  sides <= 3 072) and K20
  (``nw_tpu/ops/variants_banded.py:980 _make_banded_affine_kernel``, any
  side).
* :func:`affine_fill_codes_banded_batch` — Gotoh 4-bit walk codes, the
  corner scores and the corner states (``gotoh_fill_codes``), for K21
  (``nw_tpu/ops/variants_banded.py:1413 _make_banded_affine_full_kernel``,
  4-bit codes, any side) and K25
  (``nw_tpu/ops/variants_pallas.py:429 _affine_arrows_kernel``, 8-bit
  codes, sides <= 1 024).

The four free fills run the ``LOCAL`` and ``OVERLAP`` recurrences of the
W-warp pipeline of ``csrc/nw_fill.cu`` (``nw_scores``'s: a block of W
warps a pair, W from :func:`nw_tpu_torch.ops.fill_banded.fill_warps`):
the score fills launched through
:func:`nw_tpu_torch.ops.fill_banded._fill_scores_kernel`, the code fills
(a kernel of their own, ``free_codes_pipe_kernel``, with the best's
cell) through :func:`_launch_codes`, W forced by ``warps`` there.  The
last two wrappers run the Gotoh fill of ``csrc/nw_affine.cu`` on the same
pipeline, with a ring cell of their own (:data:`GOTOH_CELL`), W from
:func:`gotoh_warps` or forced by ``warps``.  A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches the kernel or
raises.  Each counts its launches in ``.launches``.

Inputs are those of :mod:`nw_tpu_torch.ops.fill_banded`.  Codes have
``nw_fill_codes``'s band-major layout with 0 diag / 1 left / 2 up /
3 STOP.  Local codes get STOP on a cell of score 0 (a local start) and on
every cell of column 0; overlap codes only on column 0 (its free start
boundary; row 0 is not stored), so one walk (``sw_walk``) reads both.
The argmax follows ``nw_tpu``'s scan tie rule, the first anti-diagonal
that reaches the best, then the lowest row: over the whole rectangle,
(0, 0) when the best is 0, for local alignment; over the end boundary
(row len2 or column len1), seeded by the zero-cost corner (0, len1), or
(len2, 0) when len1 is 0, for overlap.  Gotoh codes have the same layout
at 4 bits a cell, 8 a word (``code_shape(..., bits=4)``): the state bits
of :func:`nw_tpu_torch.ops.fill_scan.affine_fill_diag_batch` on interior
cells, 0 on column 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nw_tpu_torch.ops.fill_banded import (
    _check, _contig, _dims, _fill_scores_kernel, _pipe_warps, _top_scratch, fill_warps,
)
from nw_tpu_torch.ops.fill_scan import (
    affine_fill_diag_batch,
    code_shape,
    gotoh_codes_from_arrows,
    greedy_codes_from_arrows,
    overlap_fill_diag_batch,
    sw_fill_diag_batch,
)
from nw_tpu_torch.runtime import kernels


def _launch_codes(wrapper, name, tops, sides, lens1, lens2, m, k, d, warps=None):
    """Launch C entry point ``name`` (``sw_fill_codes`` or
    ``overlap_fill_codes``) for ``wrapper`` (whose count it raises) at
    ``warps`` warps a pair (default: :func:`fill_warps`): codes, best and
    its cell (j*, i*)."""
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    codes = torch.empty(code_shape(B, A, Bs), dtype=torch.int32, device=dev)
    best, j_star, i_star = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    if B:
        warps = _pipe_warps(B, A, Bs, 4, dev, warps)
        tops, sides, lens1, lens2 = _contig(tops, sides, lens1, lens2)
        top16 = _top_scratch(B, A, 4, dev)
        bnd = torch.empty((B, A + 1), dtype=torch.int32, device=dev)
        kernels.launch(
            name, dev,
            tops.data_ptr(), sides.data_ptr(), lens1.data_ptr(),
            lens2.data_ptr(), B, A, Bs, m, k, d, warps,
            None if top16 is None else top16.data_ptr(), bnd.data_ptr(),
            codes.data_ptr(), best.data_ptr(), j_star.data_ptr(), i_star.data_ptr(),
        )
        wrapper.launches += 1
    return codes, best, j_star, i_star


def _codes_plain(fill, tops, sides, lens1, lens2, m, k, d):
    """A free-boundary fill's tie masks turned into codes, STOP where a
    cell has none, with its best and argmax."""
    out = fill(tops, sides, lens1, lens2, m, k, d, with_arrows=True)
    codes = greedy_codes_from_arrows(out["arrows"], local=True)
    j_star, i_star = out["argmax"].T.contiguous()
    return codes, out["score"], j_star, i_star


def sw_scores_banded_batch(tops, sides, lens1, lens2, m, k, d) -> torch.Tensor:
    """int32[B] best local scores (>= 0), one per pair."""
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return sw_scores_banded_batch_plain(tops, sides, lens1, lens2, m, k, d)
    return _fill_scores_kernel(sw_scores_banded_batch, tops, sides, lens1, lens2, m, k, d, entry="sw_scores")


sw_scores_banded_batch.launches = 0


def sw_scores_banded_batch_plain(tops, sides, lens1, lens2, m, k, d):
    """Plain version of :func:`sw_scores_banded_batch`."""
    return sw_fill_diag_batch(
        tops, sides, lens1, lens2, m, k, d, with_arrows=False
    )["score"]


def sw_fill_codes_banded_batch(
    tops, sides, lens1, lens2, m, k, d, warps=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes int32[B, nbands, TW, 32], best int32[B], j* int32[B],
    i* int32[B]): the local code of every cell of the bucket table, the
    best local score and its cell.  ``warps``: the kernel's warps a pair
    (default :func:`fill_warps`; a CUDA launch only)."""
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return sw_fill_codes_banded_batch_plain(tops, sides, lens1, lens2, m, k, d)
    return _launch_codes(sw_fill_codes_banded_batch, "sw_fill_codes", tops, sides, lens1, lens2, m, k, d,
                         warps)


sw_fill_codes_banded_batch.launches = 0


def sw_fill_codes_banded_batch_plain(tops, sides, lens1, lens2, m, k, d):
    """Plain version of :func:`sw_fill_codes_banded_batch`: the local
    anti-diagonal fill's tie masks turned into codes, STOP where a cell
    has none."""
    return _codes_plain(sw_fill_diag_batch, tops, sides, lens1, lens2, m, k, d)


def overlap_scores_banded_batch(tops, sides, lens1, lens2, m, k, d) -> torch.Tensor:
    """int32[B] best overlap (end-gap-free) scores (>= 0), one per pair."""
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return overlap_scores_banded_batch_plain(tops, sides, lens1, lens2, m, k, d)
    return _fill_scores_kernel(
        overlap_scores_banded_batch, tops, sides, lens1, lens2, m, k, d, entry="overlap_scores"
    )


overlap_scores_banded_batch.launches = 0


def overlap_scores_banded_batch_plain(tops, sides, lens1, lens2, m, k, d):
    """Plain version of :func:`overlap_scores_banded_batch`."""
    return overlap_fill_diag_batch(
        tops, sides, lens1, lens2, m, k, d, with_arrows=False
    )["score"]


def overlap_fill_codes_banded_batch(
    tops, sides, lens1, lens2, m, k, d, warps=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes int32[B, nbands, TW, 32], best int32[B], j* int32[B],
    i* int32[B]): the overlap code of every cell of the bucket table
    (STOP on column 0), the best overlap score and its end cell.
    ``warps`` as :func:`sw_fill_codes_banded_batch`'s."""
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return overlap_fill_codes_banded_batch_plain(tops, sides, lens1, lens2, m, k, d)
    return _launch_codes(
        overlap_fill_codes_banded_batch, "overlap_fill_codes", tops, sides, lens1, lens2, m, k, d, warps
    )


overlap_fill_codes_banded_batch.launches = 0


def overlap_fill_codes_banded_batch_plain(tops, sides, lens1, lens2, m, k, d):
    """Plain version of :func:`overlap_fill_codes_banded_batch`: the
    overlap fill's tie masks turned into codes, STOP on column 0 (whose
    cells have none)."""
    return _codes_plain(overlap_fill_diag_batch, tops, sides, lens1, lens2, m, k, d)


# bytes of a Gotoh ring cell (the kernel's Cell<CODES>): best h and IY of
# the row below, and with codes the state bits and an unused word
GOTOH_CELL = {False: 8, True: 16}


def gotoh_warps(B: int, A: int, Bs: int, codes: bool, sms: int) -> int:
    """W, the warps a pair of ``gotoh_scores`` (``codes`` False) or
    ``gotoh_fill_codes``: :func:`nw_tpu_torch.ops.fill_banded.fill_warps`
    with the Gotoh ring cell."""
    return fill_warps(B, A, Bs, GOTOH_CELL[codes], sms)


def _gotoh_kernel(wrapper, tops, sides, lens1, lens2, scoring, codes, warps):
    """Launch ``gotoh_fill_codes`` (``codes``) or ``gotoh_scores`` for
    ``wrapper`` (whose count it raises) at ``warps`` warps a pair
    (default: :func:`gotoh_warps`): (codes or None, scores, states or
    None)."""
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    cell = GOTOH_CELL[codes]
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    states = torch.empty(B, dtype=torch.int32, device=dev) if codes else None
    words = torch.empty(code_shape(B, A, Bs, bits=4), dtype=torch.int32, device=dev) if codes else None
    if B:
        warps = _pipe_warps(B, A, Bs, cell, dev, warps)
        tops, sides, lens1, lens2 = _contig(tops, sides, lens1, lens2)
        top16 = _top_scratch(B, A, cell, dev)
        # the boundary rows a pair: best h and IY of a band's last row for
        # the row below, and with codes its state bits
        bnd = torch.empty((B, 3 if codes else 2, A + 1), dtype=torch.int32, device=dev)
        out = (words.data_ptr(), scores.data_ptr(), states.data_ptr()) if codes else (scores.data_ptr(),)
        kernels.launch(
            "gotoh_fill_codes" if codes else "gotoh_scores", dev,
            tops.data_ptr(), sides.data_ptr(), lens1.data_ptr(), lens2.data_ptr(),
            B, A, Bs, *scoring, warps, None if top16 is None else top16.data_ptr(),
            bnd.data_ptr(), *out,
        )
        wrapper.launches += 1
    return words, scores, states


def affine_scores_banded_batch(tops, sides, lens1, lens2, m, k, open_, extend, warps=None) -> torch.Tensor:
    """int32[B] Gotoh affine-gap global scores, one per pair (true
    corner; 0 for the empty pair).  ``warps``: the kernel's warps a pair
    (default :func:`gotoh_warps`; a CUDA launch only)."""
    _check(tops, sides, lens1, lens2, m, k, open_, extend)
    if tops.device.type == "cpu":
        return affine_scores_banded_batch_plain(tops, sides, lens1, lens2, m, k, open_, extend)
    return _gotoh_kernel(affine_scores_banded_batch, tops, sides, lens1, lens2,
                         (m, k, open_, extend), False, warps)[1]


affine_scores_banded_batch.launches = 0


def affine_scores_banded_batch_plain(tops, sides, lens1, lens2, m, k, open_, extend):
    """Plain version of :func:`affine_scores_banded_batch`."""
    return affine_fill_diag_batch(tops, sides, lens1, lens2, m, k, open_, extend)["score"]


def affine_fill_codes_banded_batch(
    tops, sides, lens1, lens2, m, k, open_, extend, warps=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes int32[B, nbands, TW, 32], scores int32[B], states int32[B]):
    the 4-bit Gotoh code of every cell of the bucket table (bits 0-1 M's
    predecessor state, bit 2 IX extends, bit 3 IY extends), the Gotoh
    global score and the argmax state (0 M, 1 IX, 2 IY) at each true
    corner, where the walk starts.  ``warps`` as
    :func:`affine_scores_banded_batch`'s."""
    _check(tops, sides, lens1, lens2, m, k, open_, extend)
    if tops.device.type == "cpu":
        return affine_fill_codes_banded_batch_plain(tops, sides, lens1, lens2, m, k, open_, extend)
    return _gotoh_kernel(affine_fill_codes_banded_batch, tops, sides, lens1, lens2,
                         (m, k, open_, extend), True, warps)


affine_fill_codes_banded_batch.launches = 0


def affine_fill_codes_banded_batch_plain(tops, sides, lens1, lens2, m, k, open_, extend):
    """Plain version of :func:`affine_fill_codes_banded_batch`: the Gotoh
    anti-diagonal fill's state bits packed into the kernel's layout."""
    out = affine_fill_diag_batch(tops, sides, lens1, lens2, m, k, open_, extend, with_arrows=True)
    return gotoh_codes_from_arrows(out["arrows"]), out["score"], out["state"]
