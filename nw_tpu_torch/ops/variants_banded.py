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

The three variant tracebacks of ``nw_tpu`` at any side length, host
numpy outputs as ``nw_tpu`` returns them (its TPU geometry arguments
dropped): :func:`sw_traceback_banded_batch` (``:1372``),
:func:`overlap_traceback_banded_batch` (``:939``) and
:func:`affine_traceback_banded_batch` (``:1886``).  Each takes the
one-pass route (one code fill of the whole table, one walk) when the
batch's codes fit :func:`onepass_budget` (``CODE_BUDGET_BYTES``, or
``NW_TPU_ONEPASS_HBM`` when set, ``nw_tpu``'s own switch), else the
two-pass route (:class:`FreeTwoPass`, :class:`GotohTwoPass`, on
:class:`nw_tpu_torch.ops.banded_traceback.TwoPass`'s passes): pass 1
sweeps the table group by group (``GROUP_BANDS`` bands a group) with the
span fills below, keeping each group's entering boundary row and the
best cell (local, overlap: merged across spans by the whole key) or the
corners (Gotoh); pass 2 re-fills each group's codes from its row, last
group first, and walks every pair through it.  Both routes give the same
bits.  Two more wrappers, each with its plain version:

* :func:`free_fill_span_banded_batch` — bands r0 .. r0+S-1 of the local
  or overlap fill from a boundary row (``free_fill_span``: the free
  pipeline's band-span mode, ``free_span_kernel``), the best cell's key
  carried in and out, the span's codes when asked; for K18 and K19 band
  by band (``_sw_walk_device`` ``:1177``, ``_overlap_walk_device``
  ``:752``);
* :func:`affine_fill_span_banded_batch` — the same for Gotoh
  (``gotoh_fill_span``, ``gotoh_span_kernel``), the boundary row the
  pipeline's hand-on row (best h, IY of the row below, state bits),
  each pair's score and corner state written by the span holding its
  row len2; for K21 (and K20's scores) band by band
  (``_affine_walk_device`` ``:1698``).

The group walks are :func:`nw_tpu_torch.ops.traceback.walk_sw_codes_groups`
and :func:`~nw_tpu_torch.ops.traceback.walk_gotoh_codes_groups`.

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

import os
from typing import NamedTuple, Optional, Tuple

import torch

from nw_tpu_torch.ops.banded_traceback import TwoPass, group_bands
from nw_tpu_torch.ops.fill_banded import (
    SIDE_PAD, _check, _contig, _dims, _fill_scores_kernel, _pipe_warps, _top_scratch, fill_warps, span_bands,
)
from nw_tpu_torch.ops.fill_scan import (
    NEG_GOTOH,
    U32,
    _argmax_state,
    _free_fill_diag_batch,
    _shift_down,
    affine_fill_diag_batch,
    code_shape,
    code_table_bytes,
    diag_to_matrix_batch,
    gotoh_codes_from_arrows,
    greedy_codes_from_arrows,
    overlap_fill_diag_batch,
    pack_band_major,
    sw_fill_diag_batch,
)
from nw_tpu_torch.ops.traceback import (
    OP_NONE,
    walk_gotoh_codes_batch,
    walk_gotoh_codes_groups,
    walk_sw_codes_batch,
    walk_sw_codes_groups,
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


# ---------------- the two-pass route: a span of bands from a boundary row ----------------


def _check_span_bufs(tops, r0, span, bufs):
    if r0 < 0 or span < 1:
        raise ValueError(f"a span needs r0 >= 0 and span >= 1, not {r0}, {span}")
    for name, t, shape in bufs:
        if t.shape != shape or t.dtype != torch.int32 or not t.is_contiguous() or t.device != tops.device:
            raise ValueError(f"{name} must be a contiguous int32{list(shape)} on the inputs' device")


def free_fill_span_banded_batch(
    tops, sides, lens1, lens2, m, k, d, r0: int, span: int, bnd: torch.Tensor, key: torch.Tensor,
    best: torch.Tensor, j_star: torch.Tensor, i_star: torch.Tensor, local: bool,
    emit_codes: bool = False, warps=None,
) -> Optional[torch.Tensor]:
    """Bands r0 .. r0+span-1 (cut at the table's last) of a batch's local
    (``local``) or overlap fill, from the boundary row above band r0, in
    place: K18 and K19 as ``nw_tpu``'s variant two-pass tracebacks call
    them band by band (``nw_tpu/ops/variants_banded.py:1177
    _sw_walk_device``, ``:752 _overlap_walk_device``).

    bnd: int32[B, A+1], the scores of row 32*r0 (ignored, and row 0 of
    zeros taken, when r0 is 0), left holding the span's last row
    32*(r0+nb) (its rows past Bs swept over the pads).  key: int32[B, 3],
    the best cell (score, kk = i + j, j) of the spans before (ignored
    when r0 is 0), into which the span's own is merged by the scan's tie
    rule (a higher score, then the earlier anti-diagonal, then the lower
    row).  best, j_star, i_star (int32[B]): written with the merged best
    and its cell as :func:`sw_fill_codes_banded_batch` /
    :func:`overlap_fill_codes_banded_batch` give them, so that after the
    table's last span they hold the whole table's.  With ``emit_codes``,
    returns the span's codes int32[B, nb, TW, 32] in those fills'
    band-major layout (STOP on column 0, and for ``local`` on cells of
    score 0); else None.  ``free_fill_span`` at ``warps`` warps a pair
    (default :func:`fill_warps` at the span's bands) on CUDA tensors,
    :func:`free_fill_span_banded_batch_plain` on CPU tensors.
    """
    _check(tops, sides, lens1, lens2, m, k, d)
    B, A, _ = _dims(tops, sides)
    _check_span_bufs(tops, r0, span, (
        ("bnd", bnd, (B, A + 1)), ("key", key, (B, 3)), ("best", best, (B,)),
        ("j_star", j_star, (B,)), ("i_star", i_star, (B,)),
    ))
    return free_span_checked(tops, sides, lens1, lens2, m, k, d, r0, span, bnd, key, best, j_star, i_star,
                             local, emit_codes, warps)


free_fill_span_banded_batch.launches = 0


def free_span_checked(tops, sides, lens1, lens2, m, k, d, r0, span, bnd, key, best, j_star, i_star, local,
                      emit_codes=False, warps=None):
    """:func:`free_fill_span_banded_batch` on inputs already checked (for
    callers that sweep one checked batch span by span)."""
    if tops.device.type == "cpu":
        return free_fill_span_banded_batch_plain(tops, sides, lens1, lens2, m, k, d, r0, span, bnd, key, best,
                                                 j_star, i_star, local, emit_codes)
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    nb = span_bands(Bs, r0, span)
    codes = torch.empty(code_shape(B, A, 32 * nb), dtype=torch.int32, device=dev) if emit_codes else None
    if B:
        warps = _pipe_warps(B, A, 32 * max(nb, 1), 4, dev, warps)
        tops, sides, lens1, lens2 = _contig(tops, sides, lens1, lens2)
        top16 = _top_scratch(B, A, 4, dev)
        kernels.launch(
            "free_fill_span", dev,
            tops.data_ptr(), sides.data_ptr(), lens1.data_ptr(), lens2.data_ptr(),
            B, A, Bs, m, k, d, int(local), r0, span, int(emit_codes), warps,
            None if top16 is None else top16.data_ptr(), bnd.data_ptr(),
            codes.data_ptr() if emit_codes else None, key.data_ptr(), best.data_ptr(),
            j_star.data_ptr(), i_star.data_ptr(),
        )
        free_fill_span_banded_batch.launches += 1
    return codes


def _ranks_above(a, b):
    """Keys a over keys b ([..., 3] = score, kk, j): the scan's tie rule."""
    return (a[:, 0] > b[:, 0]) | ((a[:, 0] == b[:, 0]) & (
        (a[:, 1] < b[:, 1]) | ((a[:, 1] == b[:, 1]) & (a[:, 2] < b[:, 2]))))


def free_fill_span_banded_batch_plain(
    tops, sides, lens1, lens2, m, k, d, r0: int, span: int, bnd, key, best, j_star, i_star, local: bool,
    emit_codes: bool = False,
) -> Optional[torch.Tensor]:
    """Plain version of :func:`free_fill_span_banded_batch` (the same
    updates of bnd, key, best, j_star and i_star, and the same codes): the
    anti-diagonal free fill of the span's rows seeded with bnd."""
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    nb = span_bands(Bs, r0, span)
    if r0 == 0:  # row 0, and no best cell yet
        bnd.zero_()
        key.zero_()
    codes = torch.zeros(code_shape(B, A, 0), dtype=torch.int32, device=dev) if emit_codes else None
    if nb > 0:
        codes = free_fill_rows_plain(tops, sides, lens1, lens2, m, k, d, 32 * r0, 32 * nb, bnd, key, local,
                                     emit_codes)
    # no positive cell: (0, 0) for local, the zero-cost corner (0, len1),
    # or (len2, 0) when len1 is 0, for overlap
    pos = key[:, 0] > 0
    l1, l2 = lens1.to(torch.int32), lens2.to(torch.int32)
    best.copy_(key[:, 0])
    j_star.copy_(torch.where(pos, key[:, 2], 0 if local else torch.where(l1 == 0, l2, 0)))
    i_star.copy_(torch.where(pos, key[:, 1] - key[:, 2], 0 if local else l1))
    return codes


def free_fill_rows_plain(tops, sides, lens1, lens2, m, k, d, row0: int, rows: int, bnd, key, local: bool,
                         emit_codes: bool = False) -> Optional[torch.Tensor]:
    """The plain free span at any rows: rows row0+1 .. row0+rows of each
    local (``local``) or overlap table (past Bs over ``SIDE_PAD``), seeded
    with row row0 in bnd, in place as
    :func:`free_fill_span_banded_batch_plain`: bnd left holding row
    row0+rows, the rows' best cell merged into key (positive scores
    only).  With ``emit_codes``, returns the codes of rows row0+1 ..
    min(row0+rows, Bs), band-major from row row0+1."""
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    real = max(0, min(rows, Bs - row0))
    side = torch.cat([sides[:, row0 : row0 + real].to(torch.int32),
                      torch.full((B, rows - real), SIDE_PAD, dtype=torch.int32, device=dev)], 1)
    out = _free_fill_diag_batch(tops, side, lens1, lens2.to(torch.int64) - row0, m, k, d, emit_codes,
                                local, seed=bnd, with_last=True)
    aj, ai = out["argmax"].T
    mine = torch.stack([out["score"], aj + ai + row0, aj + row0], 1).to(torch.int32)
    take = (out["score"] > 0) & _ranks_above(mine, key)
    key.copy_(torch.where(take[:, None], mine, key))
    bnd.copy_(out["last"])
    if not emit_codes:
        return None
    rect = diag_to_matrix_batch(out["arrows"])[:, 1 : real + 1]
    code = torch.where((rect & 1) != 0, 0, torch.where((rect & 2) != 0, 1, 2))
    return pack_band_major(torch.where(rect == 0, 3, code).to(torch.uint8), 2)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrapping."""
    return (((x + 2**31) & U32) - 2**31).to(torch.int32)


def _gotoh_gap(L: torch.Tensor, open_: int, extend: int) -> torch.Tensor:
    """-(open + (L-1)*extend) in wrapping int32: a boundary gap of L >= 1."""
    return _wrap32(-(open_ + (L.to(torch.int64) - 1) * extend))


def gotoh_span_row0(B: int, A: int, open_: int, extend: int, device) -> torch.Tensor:
    """Row 0 as the Gotoh span reads a boundary row, int32[B, 3, A+1]: best
    h, IY of the row below (max(M - open, IY - extend)) and the state bits
    (the argmax state | IY-extend bit << 3), as ``gotoh_fill_span`` writes
    it for a span from band 0."""
    c = torch.arange(A + 1, device=device)
    mv = torch.where(c == 0, 0, NEG_GOTOH).to(torch.int32)
    xv = torch.where(c == 0, NEG_GOTOH, _gotoh_gap(c, open_, extend)).to(torch.int32)
    neg = torch.full_like(mv, NEG_GOTOH)
    hv = torch.maximum(torch.maximum(mv, xv), neg)
    yo, ye = _wrap32(mv.to(torch.int64) - open_), _wrap32(neg.to(torch.int64) - extend)
    bits = _argmax_state(mv, xv, neg, hv) | ((ye > yo).to(torch.int32) << 3)
    return torch.stack([hv, torch.maximum(yo, ye), bits]).expand(B, 3, A + 1).contiguous()


def affine_fill_span_banded_batch(
    tops, sides, lens1, lens2, m, k, open_, extend, r0: int, span: int, bnd: torch.Tensor,
    scores: torch.Tensor, states: torch.Tensor, emit_codes: bool = False, warps=None,
) -> Optional[torch.Tensor]:
    """Bands r0 .. r0+span-1 (cut at the table's last) of a batch's Gotoh
    fill, from the boundary rows above band r0, in place: K21 (and K20,
    its scores) as ``nw_tpu``'s Gotoh two-pass traceback calls them band
    by band (``nw_tpu/ops/variants_banded.py:1698 _affine_walk_device``).

    bnd: int32[B, 3, A+1], the row above band r0 as the pipeline hands it
    on (best h, IY of the row below, state bits: :func:`gotoh_span_row0`'s
    layout; ignored, and row 0 taken, when r0 is 0), left holding the
    span's last row (its rows past Bs swept over the pads).  scores,
    states (int32[B]): the Gotoh score and corner state, written only for
    the pairs whose row len2 lies in the span (len2 = 0: the span from
    band 0), the others kept.  With ``emit_codes``, returns the span's
    4-bit codes int32[B, nb, TW, 32] in
    :func:`affine_fill_codes_banded_batch`'s layout; else None.
    ``gotoh_fill_span`` at ``warps`` warps a pair (default
    :func:`gotoh_warps` at the span's bands) on CUDA tensors,
    :func:`affine_fill_span_banded_batch_plain` on CPU tensors.
    """
    _check(tops, sides, lens1, lens2, m, k, open_, extend)
    B, A, _ = _dims(tops, sides)
    _check_span_bufs(tops, r0, span, (
        ("bnd", bnd, (B, 3, A + 1)), ("scores", scores, (B,)), ("states", states, (B,)),
    ))
    return affine_span_checked(tops, sides, lens1, lens2, m, k, open_, extend, r0, span, bnd, scores, states,
                               emit_codes, warps)


affine_fill_span_banded_batch.launches = 0


def affine_span_checked(tops, sides, lens1, lens2, m, k, open_, extend, r0, span, bnd, scores, states,
                        emit_codes=False, warps=None):
    """:func:`affine_fill_span_banded_batch` on inputs already checked."""
    if tops.device.type == "cpu":
        return affine_fill_span_banded_batch_plain(tops, sides, lens1, lens2, m, k, open_, extend, r0, span,
                                                   bnd, scores, states, emit_codes)
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    nb = span_bands(Bs, r0, span)
    codes = (torch.empty(code_shape(B, A, 32 * nb, bits=4), dtype=torch.int32, device=dev)
             if emit_codes else None)
    if B:
        cell = GOTOH_CELL[True]
        warps = _pipe_warps(B, A, 32 * max(nb, 1), cell, dev, warps)
        tops, sides, lens1, lens2 = _contig(tops, sides, lens1, lens2)
        top16 = _top_scratch(B, A, cell, dev)
        kernels.launch(
            "gotoh_fill_span", dev,
            tops.data_ptr(), sides.data_ptr(), lens1.data_ptr(), lens2.data_ptr(),
            B, A, Bs, m, k, open_, extend, r0, span, int(emit_codes), warps,
            None if top16 is None else top16.data_ptr(), bnd.data_ptr(),
            codes.data_ptr() if emit_codes else None, scores.data_ptr(), states.data_ptr(),
        )
        affine_fill_span_banded_batch.launches += 1
    return codes


def affine_fill_span_banded_batch_plain(
    tops, sides, lens1, lens2, m, k, open_, extend, r0: int, span: int, bnd, scores, states,
    emit_codes: bool = False,
) -> Optional[torch.Tensor]:
    """Plain version of :func:`affine_fill_span_banded_batch` (the same
    updates of bnd, scores and states, and the same codes)."""
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    nb = span_bands(Bs, r0, span)
    if r0 == 0:  # row 0, and a corner on it
        bnd.copy_(gotoh_span_row0(B, A, open_, extend, dev))
        l1 = lens1.to(device=dev, dtype=torch.int64)
        xv = _gotoh_gap(l1.clamp(min=1), open_, extend)
        h = torch.maximum(xv, torch.full_like(xv, NEG_GOTOH))
        st = torch.where(h > NEG_GOTOH, 1, 0).to(torch.int32)  # IX, unless the gap fell below kNeg
        on0 = lens2 == 0
        scores.copy_(torch.where(on0, torch.where(l1 == 0, 0, h), scores))
        states.copy_(torch.where(on0, torch.where(l1 == 0, 0, st), states))
    if nb > 0:
        return affine_fill_rows_plain(tops, sides, lens1, lens2, m, k, open_, extend, 32 * r0, 32 * nb, bnd,
                                      scores, states, emit_codes)
    return torch.zeros(code_shape(B, A, 0, bits=4), dtype=torch.int32, device=dev) if emit_codes else None


def affine_fill_rows_plain(tops, sides, lens1, lens2, m, k, open_, extend, row0: int, rows: int, bnd,
                           scores=None, states=None, emit_codes=False):
    """The plain Gotoh span at any rows: rows row0+1 .. row0+rows of each
    table (past Bs over ``SIDE_PAD``), seeded with row row0 in bnd as the
    pipeline hands a row on (:func:`gotoh_span_row0`'s layout), in place
    as :func:`affine_fill_span_banded_batch_plain`: the anti-diagonal
    recurrence of :func:`affine_fill_diag_batch` with each cell's
    hand-on values (best h, IY of the row below, the argmax state, the
    IX- and IY-extend bits) carried, so that row row0 enters as the
    kernel's handoff does.  With ``emit_codes``, returns the codes of rows
    row0+1 .. min(row0+rows, Bs), band-major from row row0+1."""
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    i32 = torch.int32
    real = max(0, min(rows, Bs - row0))
    side = torch.cat([sides[:, row0 : row0 + real].to(i32),
                      torch.full((B, rows - real), SIDE_PAD, dtype=i32, device=dev)], 1)
    N, K = rows + 1, A + rows + 1
    side_sh = torch.cat([torch.full((B, 1), -3, dtype=i32, device=dev), side], 1)
    pad = torch.full((B, N), -4, dtype=i32, device=dev)
    top_ext = torch.cat([pad, tops.to(i32).flip(1), pad], 1)
    j_idx = torch.arange(N, device=dev)
    l1 = lens1.to(device=dev, dtype=torch.int64)
    jc = lens2.to(device=dev, dtype=torch.int64) - row0  # the corner's lane
    has_corner = (jc >= 1) & (jc <= rows)
    b_ar = torch.arange(B, device=dev)
    m_t, negk_t = torch.tensor(m, dtype=i32, device=dev), -torch.tensor(k, dtype=i32, device=dev)
    op_t, ex_t = torch.tensor(open_, dtype=i32, device=dev), torch.tensor(extend, dtype=i32, device=dev)
    col0_iy = _gotoh_gap(j_idx + row0, open_, extend)[None, :]  # IY(j, 0)
    seed_h, seed_y, seed_b = bnd[:, 0].to(i32), bnd[:, 1].to(i32), bnd[:, 2].to(i32)

    def fresh(fill):
        return torch.full((B, N), fill, dtype=i32, device=dev)

    # per lane, the cell of the diagonal before (1) and the one before that
    # (2): best h, argmax state, IY of the row below and its extend bit,
    # IX of the next cell and its extend bit; lane 0 is the seed row
    H1, ST1, YB1, EY1, XC1, EX1 = fresh(NEG_GOTOH), fresh(0), fresh(NEG_GOTOH), fresh(0), fresh(NEG_GOTOH), fresh(0)
    H1[:, 0], YB1[:, 0] = seed_h[:, 0], seed_y[:, 0]
    ST1[:, 0], EY1[:, 0] = seed_b[:, 0] & 3, (seed_b[:, 0] >> 3) & 1
    H2, ST2 = fresh(NEG_GOTOH), fresh(0)
    code_l = [torch.zeros((B, N), dtype=torch.uint8, device=dev)]
    last_h, last_y, last_b = [], [], []
    got_s = scores.clone() if scores is not None else None
    got_t = states.clone() if states is not None else None
    for kk in range(1, K):
        i_idx = kk - j_idx
        sub = torch.where(top_ext[:, N + A - kk : N + A - kk + N] == side_sh, m_t, negk_t)
        mn = _shift_down(H2, NEG_GOTOH) + sub
        xn = XC1
        yn = _shift_down(YB1, NEG_GOTOH)
        code = _shift_down(ST2, 0) | (EX1 << 2) | (_shift_down(EY1, 0) << 3)
        col0 = (i_idx == 0)[None, :]
        mn = torch.where(col0, NEG_GOTOH, mn)
        xn = torch.where(col0, NEG_GOTOH, xn)
        yn = torch.where(col0, col0_iy, yn)
        hn = torch.maximum(torch.maximum(mn, xn), yn)
        stn = _argmax_state(mn, xn, yn, hn)
        mo, xe, ye = mn - op_t, xn - ex_t, yn - ex_t
        XCn, YBn = torch.maximum(mo, xe), torch.maximum(mo, ye)
        EXn, EYn = (xe > mo).to(i32), (ye > mo).to(i32)
        if kk <= A:  # the seed row in lane 0
            hn[:, 0], YBn[:, 0] = seed_h[:, kk], seed_y[:, kk]
            stn[:, 0], EYn[:, 0] = seed_b[:, kk] & 3, (seed_b[:, kk] >> 3) & 1
        hit = has_corner & (kk == l1 + jc)
        jcc = jc.clamp(0, rows)
        if got_s is not None:
            got_s = torch.where(hit, hn[b_ar, jcc], got_s)
        if got_t is not None:
            got_t = torch.where(hit, stn[b_ar, jcc], got_t)
        if emit_codes:
            keep = (i_idx >= 1) & (i_idx <= A) & (j_idx >= 1) & (j_idx <= real)
            code_l.append(torch.where(keep[None, :], code, 0).to(torch.uint8))
        if rows <= kk <= A + rows:
            last_h.append(hn[:, rows])
            last_y.append(YBn[:, rows])
            last_b.append(stn[:, rows] | (EXn[:, rows] << 2) | (EYn[:, rows] << 3))
        H2, ST2 = H1, ST1
        H1, ST1, YB1, EY1, XC1, EX1 = hn, stn, YBn, EYn, XCn, EXn
    bnd.copy_(torch.stack([torch.stack(last_h, 1), torch.stack(last_y, 1), torch.stack(last_b, 1)], 1))
    if scores is not None:
        scores.copy_(got_s)
    if states is not None:
        states.copy_(got_t)
    if not emit_codes:
        return None
    return pack_band_major(diag_to_matrix_batch(torch.stack(code_l, 1))[:, 1 : real + 1], 4)


# ---------------- the variant tracebacks: one-pass or two-pass ----------------


def onepass_budget(default: Optional[int] = None) -> int:
    """Device bytes a variant traceback's batch may spend on its whole
    code table before it takes the two-pass route: ``NW_TPU_ONEPASS_HBM``
    when set (``nw_tpu``'s own switch, ``onepass_auto``), else ``default``
    (None: :data:`nw_tpu_torch.models.needleman_wunsch.CODE_BUDGET_BYTES`)."""
    env = os.environ.get("NW_TPU_ONEPASS_HBM")
    if env is not None:
        return int(env)
    if default is None:
        from nw_tpu_torch.models.needleman_wunsch import CODE_BUDGET_BYTES as default
    return default


def twopass_pair_bytes(A: int, Bs: int, bits: int = 2) -> int:
    """Device bytes one pair spends on the two-pass route at buckets (A,
    Bs), ``bits`` a code (2: local and overlap, 4: Gotoh): its checkpoint
    rows (one boundary row a group; Gotoh's is three int32 rows), one
    group's codes and its op string."""
    S = group_bands(Bs)
    ngroups = max(1, -(-(-(-Bs // 32)) // S))
    rows = 3 if bits == 4 else 1
    return ngroups * rows * 4 * (A + 1) + code_table_bytes(A, 32 * S, bits) + A + Bs


class FreeTwoPass(TwoPass):
    """The two-pass route of :func:`sw_traceback_banded_batch` (``local``)
    and :func:`overlap_traceback_banded_batch`, on one encoded batch:
    :class:`nw_tpu_torch.ops.banded_traceback.TwoPass`'s passes over the
    free fill's span (``free_fill_span``: pass 1 sweeps the scores and
    merges the best cell span by span, pass 2 re-fills a group's codes)
    and the local group walk (``sw_walk_groups``).  The carry is (bnd,
    key, best, j*, i*); the cursor (i, j, n) starts at (i*, j*)."""

    def __init__(self, tops, sides, lens1, lens2, m, k, d, local: bool):
        _check(tops, sides, lens1, lens2, m, k, d)
        self._setup(tops, sides, lens1, lens2, (m, k, d))
        self.local = local

    def start(self):
        """Pass 1's carry: (bnd, key, best, j*, i*); the span from band 0
        writes row 0 and starts the key."""
        dev = self.device
        return (torch.empty((self.B, self.A + 1), dtype=torch.int32, device=dev),
                torch.empty((self.B, 3), dtype=torch.int32, device=dev),
                *(torch.empty(self.B, dtype=torch.int32, device=dev) for _ in range(3)))

    def _sweep(self, g, carry) -> None:
        free_span_checked(*self.T, *self.mkd, g * self.S, self.S, *carry, self.local)

    def _refill(self, g, row) -> torch.Tensor:
        _, *scratch = self.start()
        return free_span_checked(*self.T, *self.mkd, g * self.S, self.S, row, *scratch, self.local, True)

    def _walk(self, codes, state, j0, ops, off=None) -> None:
        walk_sw_codes_groups(codes, state, j0, ops, off)

    def cursor(self, j_star, i_star) -> torch.Tensor:
        """Every walk's start, int32[B, 3]: the best cell, no ops yet."""
        return torch.stack([i_star, j_star, torch.zeros_like(i_star)], 1).to(torch.int32).contiguous()


class GotohTwoPass(TwoPass):
    """The two-pass route of :func:`affine_traceback_banded_batch` on one
    encoded batch: :class:`nw_tpu_torch.ops.banded_traceback.TwoPass`'s
    passes over the Gotoh span (``gotoh_fill_span``: pass 1 carries the
    three hand-on rows without storing codes, and writes each pair's
    score and corner state in the span that holds its row len2; pass 2
    re-fills a group's codes) and the Gotoh group walk
    (``gotoh_walk_groups``).  The carry is (bnd int32[B, 3, A+1], scores,
    states); the cursor (i, j, n, state) starts at the corner."""

    def __init__(self, tops, sides, lens1, lens2, m, k, open_, extend):
        _check(tops, sides, lens1, lens2, m, k, open_, extend)
        self._setup(tops, sides, lens1, lens2, (m, k, open_, extend))

    def start(self):
        """Pass 1's carry: (bnd, scores, states); the span from band 0
        writes row 0."""
        dev = self.device
        return (torch.empty((self.B, 3, self.A + 1), dtype=torch.int32, device=dev),
                *(torch.empty(self.B, dtype=torch.int32, device=dev) for _ in range(2)))

    def _sweep(self, g, carry) -> None:
        affine_span_checked(*self.T, *self.mkd, g * self.S, self.S, *carry)

    def _refill(self, g, row) -> torch.Tensor:
        junk = [torch.empty(self.B, dtype=torch.int32, device=self.device) for _ in range(2)]
        return affine_span_checked(*self.T, *self.mkd, g * self.S, self.S, row, *junk, True)

    def _walk(self, codes, state, j0, ops, off=None) -> None:
        walk_gotoh_codes_groups(codes, state, j0, ops, off)

    def cursor(self, states) -> torch.Tensor:
        """Every walk's start, int32[B, 4]: the true corner in its state."""
        l1, l2 = self.T[2], self.T[3]
        return torch.stack([l1, l2, torch.zeros_like(l1), states], 1).to(torch.int32).contiguous()


class VariantWalk(NamedTuple):
    """Device outputs of one variant traceback (see
    :func:`free_traceback_dispatch`, :func:`affine_traceback_dispatch`)."""

    scores: torch.Tensor  # int32[B]: best (local, overlap) or Gotoh score
    ops: torch.Tensor  # int8[B, A + Bs], OP_NONE padded
    n: torch.Tensor  # int32[B]
    j_star: Optional[torch.Tensor] = None  # local, overlap: where the walk started
    i_star: Optional[torch.Tensor] = None
    j_end: Optional[torch.Tensor] = None  # ... and where it stopped
    i_end: Optional[torch.Tensor] = None


def variant_sub_batch(L1: int, L2: int, bits: int, budget: int) -> int:
    """Pairs a sub-batch of a variant traceback at buckets (L1, L2),
    ``bits`` a code (2: local and overlap, 4: Gotoh), under ``budget``
    device bytes: as many as whole code tables fit (so that the
    dispatchers, given the same budget, take the one-pass route); or, when
    one pair's table does not fit (the two-pass route), as many as fit
    :func:`twopass_pair_bytes`; at least one."""
    per = code_table_bytes(L1, L2, bits)
    if per <= budget:
        return max(1, budget // max(per, 1))
    return max(1, budget // twopass_pair_bytes(L1, L2, bits))


def _takes_onepass(B: int, A: int, Bs: int, bits: int, budget: Optional[int]) -> bool:
    """Whether the batch's whole code table fits ``budget`` (None:
    :func:`onepass_budget`)."""
    return B * code_table_bytes(A, Bs, bits) <= (onepass_budget() if budget is None else budget)


def _group_checkpoints(tp: TwoPass, carry, shape) -> torch.Tensor:
    """Pass 1 of ``tp`` in place on ``carry``; returns the checkpoint rows,
    [ngroups, *shape] (each group's entering boundary row)."""
    cps = torch.empty((tp.ngroups, *shape), dtype=torch.int32, device=tp.device)
    tp.checkpoint_pass(carry, lambda g, bnd: cps[g].copy_(bnd))
    return cps


def free_traceback_dispatch(tops, sides, lens1, lens2, m, k, d, local: bool,
                            budget: Optional[int] = None) -> VariantWalk:
    """Enqueue a local (``local``) or overlap traceback of one encoded
    batch on the device; nothing is copied to the host.  The batch's whole
    code table against ``budget`` (None: :func:`onepass_budget`) picks
    the route: when it fits, one fill of the whole table's codes
    (``sw_fill_codes`` / ``overlap_fill_codes``) and one ``sw_walk``, or
    :class:`FreeTwoPass`'s two passes."""
    _check(tops, sides, lens1, lens2, m, k, d)
    B, A, Bs = _dims(tops, sides)
    width = A + Bs
    if _takes_onepass(B, A, Bs, 2, budget):
        fill = sw_fill_codes_banded_batch if local else overlap_fill_codes_banded_batch
        codes, best, j_star, i_star = fill(tops, sides, lens1, lens2, m, k, d)
        ops, n, i_end, j_end = walk_sw_codes_batch(codes, j_star, i_star)
        return VariantWalk(best, ops[:, :width], n, j_star, i_star, j_end, i_end)
    tp = FreeTwoPass(tops, sides, lens1, lens2, m, k, d, local)
    carry = tp.start()
    cps = _group_checkpoints(tp, carry, (B, A + 1))
    _, _, best, j_star, i_star = carry
    state = tp.cursor(j_star, i_star)
    ops = torch.full((B, max(width, 1)), OP_NONE, dtype=torch.int8, device=tp.device)
    tp.walk_pass(cps.__getitem__, state, ops)
    return VariantWalk(best, ops[:, :width], state[:, 2], j_star, i_star, state[:, 1], state[:, 0])


def affine_traceback_dispatch(tops, sides, lens1, lens2, m, k, open_, extend,
                              budget: Optional[int] = None) -> VariantWalk:
    """Enqueue a Gotoh traceback of one encoded batch on the device, as
    :func:`free_traceback_dispatch`: one ``gotoh_fill_codes`` and one
    ``gotoh_walk``, or :class:`GotohTwoPass`'s two passes."""
    _check(tops, sides, lens1, lens2, m, k, open_, extend)
    B, A, Bs = _dims(tops, sides)
    width = A + Bs
    if _takes_onepass(B, A, Bs, 4, budget):
        codes, scores, states = affine_fill_codes_banded_batch(tops, sides, lens1, lens2, m, k, open_, extend)
        ops, n = walk_gotoh_codes_batch(codes, lens1, lens2, states, max(width, 1))
        return VariantWalk(scores, ops[:, :width], n)
    tp = GotohTwoPass(tops, sides, lens1, lens2, m, k, open_, extend)
    carry = tp.start()
    cps = _group_checkpoints(tp, carry, (B, 3, A + 1))
    _, scores, states = carry
    state = tp.cursor(states)
    ops = torch.full((B, max(width, 1)), OP_NONE, dtype=torch.int8, device=tp.device)
    tp.walk_pass(cps.__getitem__, state, ops)
    return VariantWalk(scores, ops[:, :width], state[:, 2])


def _host(*ts):
    return tuple(t.cpu().numpy() for t in ts)


def sw_traceback_banded_batch(tops, sides, lens1, lens2, m, k, d):
    """Batched Smith-Waterman alignments at any side length: (best
    int32[B], j* int32[B], i* int32[B] — the best cell, where the walk
    starts —, j_end, i_end — the cell where it stopped —, ops int8[B,
    A+Bs] in walk order, OP_NONE padded, n int32[B]), host numpy arrays,
    as ``nw_tpu/ops/variants_banded.py:1372 sw_traceback_banded_batch``
    returns them (its TPU geometry arguments have no counterpart).  The
    route is the code budget's (:func:`free_traceback_dispatch`); both
    give the same outputs."""
    out = free_traceback_dispatch(tops, sides, lens1, lens2, m, k, d, True)
    return _host(out.scores, out.j_star, out.i_star, out.j_end, out.i_end, out.ops, out.n)


def overlap_traceback_banded_batch(tops, sides, lens1, lens2, m, k, d):
    """Batched overlap (end-gap-free) alignments at any side length, as
    :func:`sw_traceback_banded_batch`: (best, j*, i* — the end cell —,
    j_end, i_end — the start cell on row 0 or column 0 —, ops, n), as
    ``nw_tpu/ops/variants_banded.py:939 overlap_traceback_banded_batch``
    returns them."""
    out = free_traceback_dispatch(tops, sides, lens1, lens2, m, k, d, False)
    return _host(out.scores, out.j_star, out.i_star, out.j_end, out.i_end, out.ops, out.n)


def affine_traceback_banded_batch(tops, sides, lens1, lens2, m, k, open_, extend):
    """Batched Gotoh affine-gap global alignments at any side length:
    (scores int32[B], ops int8[B, A+Bs] in walk order, OP_NONE padded, n
    int32[B]), host numpy arrays, as ``nw_tpu/ops/variants_banded.py:1886
    affine_traceback_banded_batch`` returns them.  The route is the code
    budget's (:func:`affine_traceback_dispatch`)."""
    out = affine_traceback_dispatch(tops, sides, lens1, lens2, m, k, open_, extend)
    return _host(out.scores, out.ops, out.n)
