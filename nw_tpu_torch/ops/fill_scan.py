"""Anti-diagonal Needleman-Wunsch fill in plain PyTorch.

Port of ``nw_tpu/ops/fill_scan.py``: every cell on anti-diagonal
``kk = i + j`` depends only on diagonals ``kk-1`` and ``kk-2``, so one
diagonal is one vectorized step over the whole batch.  This is the plain
version that every fill kernel of the package is held against.

Table orientation: the top string ``s1`` spans columns ``i`` (A+1 of
them), the side string ``s2`` spans rows ``j`` (Bs+1).  Outputs are
diagonal-major: ``D[b, kk, j]`` holds cell ``(row=j, col=kk-j)``.

Semantics, bit for bit those of ``fill_scan.py:24-28, 118-163``:

* boundary row 0: ``score = i * (-d)``, arrow LEFT;
* boundary col 0: ``score = j * (-d)``, arrow UP;
* interior: ``max(diag + (m | -k), up - d, left - d)`` with an arrow bit
  (bit0 diag, bit1 left, bit2 up) for every candidate equal to the max.

Scores are int32 and wrap as int32 does.  Solution counts (the number of
optimal paths, ``pathcount.py``) ride the same sweep when asked and wrap
mod 2^32; they are returned as int64 in ``[0, 2^32)``.

:func:`sw_fill_diag_batch` is the same sweep with Smith-Waterman's local
recurrence (``nw_tpu/models/smith_waterman.py:25-97``): the plain version
of the local fill kernels.  :func:`overlap_fill_diag_batch` is the same
with overlap's free end gaps (``nw_tpu/models/overlap.py:49-153``), and
:func:`affine_fill_diag_batch` carries Gotoh's three states
(``nw_tpu/models/affine.py:28-100``): the plain versions of the overlap
and Gotoh kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

NEG_INF = -(2**30)
NEG_GOTOH = NEG_INF // 2  # a Gotoh state that does not exist: NEG - open cannot wrap
U32 = 0xFFFFFFFF
BAND_ROWS = 32  # one row per lane of a warp


def _shift_down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """Lane j reads former lane j-1; lane 0 reads ``fill``."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def fill_diag_batch(
    tops: torch.Tensor,
    sides: torch.Tensor,
    lens1: torch.Tensor,
    lens2: torch.Tensor,
    m: int,
    k: int,
    d: int,
    with_arrows: bool = True,
    with_counts: bool = False,
    with_scores: bool = False,
    seed: Optional[torch.Tensor] = None,
    row0: int = 0,
    left: Optional[torch.Tensor] = None,
    with_edges: bool = False,
) -> Dict[str, torch.Tensor]:
    """Fill a batch of DP tables along anti-diagonals.

    Args:
      tops: int32[B, A] encoded top strings (PAD_TOP padded).
      sides: int32[B, Bs] encoded side strings (PAD_SIDE padded).
      lens1, lens2: int[B] true lengths; scores and counts are read at
        the true corner (len2, len1).
      m, k, d: match bonus, mismatch penalty, indel penalty.
      with_arrows: return the uint8[B, A+Bs+1, Bs+1] tie masks.
      with_counts: return the optimal-path counts at the true corner.
      with_scores: return the int32[B, A+Bs+1, Bs+1] scores of every
        cell (``NEG_INF`` outside the table), as ``fill_scan.py:48
        fill_diag(..., with_scores=True)``.
      seed, row0: the plain row-block fill.  The side strings are rows
        ``row0+1 ..`` of larger tables and ``seed`` int32[B, A+1] holds
        their row ``row0``, which takes row 0's place (its arrows stay
        LEFT, its counts 1); column 0 is ``-(row0+j)*d``.  Without a seed
        ``row0`` must be 0.
      left: int32[B, Bs], column 0's scores at rows 1 .. Bs in place of
        ``-(row0+j)*d`` (a tile of a larger table: with ``seed`` as its
        top halo, the plain version of ``nw_fill_tile``).
      with_edges: return ``right`` int32[B, Bs] (column A at rows 1 ..
        Bs) and ``bottom`` int32[B, A] (row Bs at columns 1 .. A), the
        bucket's last column and row, without keeping every cell.

    Returns:
      dict with ``score`` int32[B], and ``arrows`` / ``count`` (int64[B]
      in [0, 2^32)) / ``scores`` / ``right`` and ``bottom`` when asked.
    """
    B, A = tops.shape
    Bs = sides.shape[1]
    if seed is None and row0:
        raise ValueError("a fill from row row0 > 0 needs its seed row")
    N = Bs + 1
    K = A + Bs + 1
    dev = tops.device
    i32 = torch.int32
    tops = tops.to(i32)
    sides = sides.to(i32)
    lens1 = lens1.to(device=dev, dtype=torch.int64)
    lens2 = lens2.to(device=dev, dtype=torch.int64)
    k_corner = lens1 + lens2
    j_corner = lens2.clamp(max=Bs)
    b_ar = torch.arange(B, device=dev)

    # row 0 gets a sentinel side character (it is never an interior row)
    side_sh = torch.cat([torch.full((B, 1), -3, dtype=i32, device=dev), sides], 1)
    # the top char of cell (kk, j) is top[kk-1-j]: a contiguous slice of
    # the reversed top string, padded so that every slice is in bounds
    pad = torch.full((B, N), -4, dtype=i32, device=dev)
    top_ext = torch.cat([pad, tops.flip(1), pad], 1)

    j_idx = torch.arange(N, device=dev)
    prev = torch.where(j_idx == 0, 0, NEG_INF).to(i32).expand(B, N)
    if seed is not None:
        seed = seed.to(device=dev, dtype=i32)
        prev = torch.where(j_idx == 0, seed[:, :1], prev)
    prev2 = torch.full((B, N), NEG_INF, dtype=i32, device=dev)
    captured = torch.zeros(B, dtype=i32, device=dev)
    m_t = torch.tensor(m, dtype=i32, device=dev)
    negk_t = -torch.tensor(k, dtype=i32, device=dev)
    d_t = torch.tensor(d, dtype=i32, device=dev)
    # column 0 of every diagonal, made once: no host copy inside the loop
    edges = -((torch.arange(K, dtype=i32, device=dev) + row0) * d_t)
    if left is not None:
        left = left.to(device=dev, dtype=i32)
    if with_counts:
        cprev = (j_idx == 0).to(torch.int64).expand(B, N)
        cprev2 = torch.zeros((B, N), dtype=torch.int64, device=dev)
        ccaptured = torch.ones(B, dtype=torch.int64, device=dev)
    arrows_l = [torch.zeros((B, N), dtype=torch.uint8, device=dev)]
    scores_l = [prev]
    right_l, bottom_l = [], []  # cell (Bs, kk - Bs) and (kk - A, A) of diagonal kk

    for kk in range(1, K):
        i_idx = kk - j_idx
        valid = (i_idx >= 0) & (i_idx <= A)
        interior = valid & (j_idx >= 1) & (i_idx >= 1)
        on_top_row = valid & (j_idx == 0)
        on_left_col = valid & (i_idx == 0)

        ch_top = top_ext[:, N + A - kk : N + A - kk + N]
        sub = torch.where(ch_top == side_sh, m_t, negk_t)
        cand_diag = _shift_down(prev2, NEG_INF) + sub
        prev_sh = _shift_down(prev, NEG_INF)
        cand_up = prev_sh - d_t
        cand_left = prev - d_t
        score = torch.maximum(torch.maximum(cand_diag, cand_up), cand_left)
        b_diag = (cand_diag == score) & interior
        b_left = ((cand_left == score) & interior) | on_top_row
        b_up = ((cand_up == score) & interior) | on_left_col

        edge = edges[kk] if left is None or not Bs else left[:, min(kk, Bs) - 1 : min(kk, Bs)]
        top_edge = edge if seed is None else seed[:, min(kk, A)][:, None]
        score = torch.where(interior, score, NEG_INF)
        score = torch.where(on_left_col, edge, score)
        score = torch.where(on_top_row, top_edge, score)
        hit = kk == k_corner
        captured = torch.where(hit, score[b_ar, j_corner], captured)

        if with_scores:
            scores_l.append(score)
        if with_edges:
            if kk > Bs:
                bottom_l.append(score[:, Bs].clone())
            if kk > A:
                right_l.append(score[:, kk - A].clone())
        if with_arrows:
            arrows_l.append(
                b_diag.to(torch.uint8)
                | (b_left.to(torch.uint8) << 1)
                | (b_up.to(torch.uint8) << 2)
            )
        if with_counts:
            cnt = (
                torch.where(b_diag, _shift_down(cprev2, 0), 0)
                + torch.where(b_left, cprev, 0)
                + torch.where(b_up, _shift_down(cprev, 0), 0)
            ) & U32
            ccaptured = torch.where(hit, cnt[b_ar, j_corner], ccaptured)
            cprev, cprev2 = cnt, cprev
        prev, prev2 = score, prev

    out = {"score": captured}
    if with_arrows:
        out["arrows"] = torch.stack(arrows_l, dim=1)
    if with_counts:
        out["count"] = ccaptured
    if with_scores:
        out["scores"] = torch.stack(scores_l, dim=1)
    if with_edges:
        empty = torch.empty((B, 0), dtype=i32, device=dev)
        out["right"] = torch.stack(right_l, dim=1) if right_l else empty
        out["bottom"] = torch.stack(bottom_l, dim=1) if bottom_l else empty
    return out


def sw_fill_diag_batch(
    tops: torch.Tensor,
    sides: torch.Tensor,
    lens1: torch.Tensor,
    lens2: torch.Tensor,
    m: int,
    k: int,
    d: int,
    with_arrows: bool = True,
) -> Dict[str, torch.Tensor]:
    """Smith-Waterman (local) fill of a padded batch along anti-diagonals.

    The local recurrence of ``nw_tpu/models/smith_waterman.py:25-97
    sw_fill_diag`` over the bucket tables: row 0 and column 0 are 0,
    interior cells ``max(diag + (m | -k), up - d, left - d, 0)`` in
    wrapping int32, and tie masks (bit0 diag, bit1 left, bit2 up) only
    where the cell is > 0 (a local start has none).  The best score and
    its cell are taken over each pair's true rectangle (1 <= i <= len1,
    1 <= j <= len2) with the scan's tie rule: the first anti-diagonal that
    reaches the best, then the lowest row on it; (0, 0) when the best is 0.

    Returns a dict with ``score`` int32[B] (>= 0), ``argmax`` int32[B, 2]
    as (j, i), and ``arrows`` uint8[B, A+Bs+1, Bs+1] when asked.
    """
    return _free_fill_diag_batch(tops, sides, lens1, lens2, m, k, d, with_arrows, local=True)


def overlap_fill_diag_batch(
    tops: torch.Tensor,
    sides: torch.Tensor,
    lens1: torch.Tensor,
    lens2: torch.Tensor,
    m: int,
    k: int,
    d: int,
    with_arrows: bool = True,
) -> Dict[str, torch.Tensor]:
    """Overlap (semi-global, end-gap-free) fill of a padded batch along
    anti-diagonals.

    The recurrence of ``nw_tpu/models/overlap.py:49-153
    overlap_fill_diag`` over the bucket tables: row 0 and column 0 are 0
    and carry no arrows, interior cells ``max(diag + (m | -k), up - d,
    left - d)`` in wrapping int32 (no clamp) with every tie in their
    masks.  The best is taken over each pair's end boundary (interior
    cells of its true rectangle on row len2 or column len1), seeded by
    the zero-cost corner (j, i) = (0, len1), or (len2, 0) when len1 is 0:
    a cell replaces it only with a strictly greater score, the first
    anti-diagonal then the lowest row.

    Returns a dict with ``score`` int32[B] (>= 0), ``argmax`` int32[B, 2]
    as (j, i), and ``arrows`` uint8[B, A+Bs+1, Bs+1] when asked.
    """
    return _free_fill_diag_batch(tops, sides, lens1, lens2, m, k, d, with_arrows, local=False)


def _free_fill_diag_batch(tops, sides, lens1, lens2, m, k, d, with_arrows, local):
    """The sweep of :func:`sw_fill_diag_batch` (``local``) and
    :func:`overlap_fill_diag_batch`: both pin row 0 and column 0 to 0 and
    keep a best cell; local alignment also clamps at 0 and reads the
    whole rectangle, overlap only its end boundary."""
    B, A = tops.shape
    Bs = sides.shape[1]
    N = Bs + 1
    K = A + Bs + 1
    dev = tops.device
    i32 = torch.int32
    tops = tops.to(i32)
    sides = sides.to(i32)
    lens1 = lens1.to(device=dev, dtype=torch.int64)[:, None]
    lens2 = lens2.to(device=dev, dtype=torch.int64)[:, None]

    side_sh = torch.cat([torch.full((B, 1), -3, dtype=i32, device=dev), sides], 1)
    pad = torch.full((B, N), -4, dtype=i32, device=dev)
    top_ext = torch.cat([pad, tops.flip(1), pad], 1)
    j_idx = torch.arange(N, device=dev)
    rows_ok = (j_idx >= 1) & (j_idx <= lens2)  # [B, N]

    prev = torch.zeros((B, N), dtype=i32, device=dev)
    prev2 = torch.zeros((B, N), dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    if local:  # no positive cell: (0, 0)
        arg = torch.zeros((B, 2), dtype=torch.int64, device=dev)
    else:  # the zero-cost corner (0, len1), or (len2, 0) when len1 is 0
        arg = torch.where(
            lens1 == 0, torch.cat([lens2, lens1], 1), torch.cat([torch.zeros_like(lens1), lens1], 1)
        )
    m_t = torch.tensor(m, dtype=i32, device=dev)
    negk_t = -torch.tensor(k, dtype=i32, device=dev)
    d_t = torch.tensor(d, dtype=i32, device=dev)
    arrows_l = [torch.zeros((B, N), dtype=torch.uint8, device=dev)]

    for kk in range(1, K):
        i_idx = kk - j_idx
        interior = (i_idx >= 1) & (i_idx <= A) & (j_idx >= 1)
        ch_top = top_ext[:, N + A - kk : N + A - kk + N]
        sub = torch.where(ch_top == side_sh, m_t, negk_t)
        cand_diag = _shift_down(prev2, NEG_INF) + sub
        cand_up = _shift_down(prev, NEG_INF) - d_t
        cand_left = prev - d_t
        score = torch.maximum(torch.maximum(cand_diag, cand_up), cand_left)
        if local:
            score = score.clamp(min=0)
            live = interior & (score > 0)
        else:
            live = interior
        score = torch.where(interior, score, 0)
        if with_arrows:
            arrows_l.append(
                ((cand_diag == score) & live).to(torch.uint8)
                | (((cand_left == score) & live).to(torch.uint8) << 1)
                | (((cand_up == score) & live).to(torch.uint8) << 2)
            )
        # running best: a strictly greater diagonal maximum wins, so the
        # first diagonal keeps ties; argmax takes the lowest row on it.
        # Cells outside the candidates count as 0, which never wins.
        cand = rows_ok & (i_idx >= 1) & (i_idx <= lens1)
        if not local:
            cand = cand & ((i_idx == lens1) | (j_idx == lens2))
        sc = torch.where(cand, score, 0)
        diag_best = sc.amax(dim=1)
        diag_row = sc.argmax(dim=1)  # the first maximal index
        take = diag_best > best
        best = torch.where(take, diag_best, best)
        arg = torch.where(
            take[:, None], torch.stack([diag_row, kk - diag_row], 1), arg
        )
        prev, prev2 = score, prev

    out = {"score": best, "argmax": arg.to(i32)}
    if with_arrows:
        out["arrows"] = torch.stack(arrows_l, dim=1)
    return out


def affine_fill_diag_batch(
    tops: torch.Tensor,
    sides: torch.Tensor,
    lens1: torch.Tensor,
    lens2: torch.Tensor,
    m: int,
    k: int,
    open_: int,
    extend: int,
    with_arrows: bool = False,
) -> Dict[str, torch.Tensor]:
    """Gotoh affine-gap global scores of a padded batch along
    anti-diagonals: ``nw_tpu/models/affine.py:28-100 affine_score`` over
    the bucket tables, read at each pair's true corner (len2, len1); with
    ``with_arrows``, also the walk's state bits of every cell
    (``affine.py:109 affine_fill_arrows``).

    Three states a cell, (j = side row, i = top column), in wrapping
    int32::

        M[j,i]  = best[j-1,i-1] + (m | -k)
        IX[j,i] = max(M[j,i-1] - open, IX[j,i-1] - extend)
        IY[j,i] = max(M[j-1,i] - open, IY[j-1,i] - extend)
        best    = max(M, IX, IY)

    A state that does not exist is ``NEG_GOTOH`` (NEG_INF // 2): M on row
    0 and column 0 but M(0,0) = 0, IX on column 0, IY on row 0.  The
    boundary gaps are IX(0,i) = -(open + (i-1)*extend) and IY(j,0) =
    -(open + (j-1)*extend), and a boundary cell's best is the max of its
    three states, as the scan has it.  The empty pair scores 0.

    The state bits of an interior cell (1 <= i <= A, 1 <= j <= Bs; 0
    elsewhere) are bits 0-1: the argmax state of cell (j-1, i-1), M's
    predecessor (0 M, 1 IX, 2 IY; ties M > IX > IY); bit 2: IX extends
    (``IX - extend > M - open`` at (j, i-1); a tie opens); bit 3: IY
    extends, the same at (j-1, i).  The corner state is the argmax state
    of the corner cell, 0 for the empty pair: where the walk starts.

    Returns a dict with ``score`` int32[B] and, with ``with_arrows``,
    ``arrows`` uint8[B, A+Bs+1, Bs+1] (diagonal-major) and ``state``
    int32[B].
    """
    B, A = tops.shape
    Bs = sides.shape[1]
    N = Bs + 1
    K = A + Bs + 1
    dev = tops.device
    i32 = torch.int32
    tops = tops.to(i32)
    sides = sides.to(i32)
    lens1 = lens1.to(device=dev, dtype=torch.int64)
    lens2 = lens2.to(device=dev, dtype=torch.int64)
    k_corner = lens1 + lens2
    j_corner = lens2.clamp(max=Bs)
    b_ar = torch.arange(B, device=dev)

    side_sh = torch.cat([torch.full((B, 1), -3, dtype=i32, device=dev), sides], 1)
    pad = torch.full((B, N), -4, dtype=i32, device=dev)
    top_ext = torch.cat([pad, tops.flip(1), pad], 1)
    j_idx = torch.arange(N, device=dev)

    neg = torch.full((B, N), NEG_GOTOH, dtype=i32, device=dev)
    Mp, IXp, IYp = torch.where(j_idx == 0, 0, NEG_GOTOH).to(i32).expand(B, N), neg, neg
    Mp2, IXp2, IYp2 = neg, neg, neg
    captured = torch.zeros(B, dtype=i32, device=dev)
    cstate = torch.zeros(B, dtype=i32, device=dev)
    m_t = torch.tensor(m, dtype=i32, device=dev)
    negk_t = -torch.tensor(k, dtype=i32, device=dev)
    op_t = torch.tensor(open_, dtype=i32, device=dev)
    ex_t = torch.tensor(extend, dtype=i32, device=dev)
    # gap[L] = -(open + (L-1)*extend) in wrapping int32, made once
    gaps = -(open_ + (torch.arange(K, dtype=torch.int64) - 1) * extend)
    gaps = (((gaps + 2**31) & U32) - 2**31).to(device=dev, dtype=i32)
    arrows_l = [torch.zeros((B, N), dtype=torch.uint8, device=dev)]

    for kk in range(1, K):
        i_idx = kk - j_idx
        valid = (i_idx >= 0) & (i_idx <= A)
        interior = valid & (j_idx >= 1) & (i_idx >= 1)
        ch_top = top_ext[:, N + A - kk : N + A - kk + N]
        sub = torch.where(ch_top == side_sh, m_t, negk_t)

        best_p2 = torch.maximum(torch.maximum(Mp2, IXp2), IYp2)
        M = _shift_down(best_p2, NEG_GOTOH) + sub
        open_x, ext_x = Mp - op_t, IXp - ex_t  # from (j, i-1)
        IX = torch.maximum(open_x, ext_x)
        open_y = _shift_down(Mp, NEG_GOTOH) - op_t  # from (j-1, i)
        ext_y = _shift_down(IYp, NEG_GOTOH) - ex_t
        IY = torch.maximum(open_y, ext_y)
        if with_arrows:
            mpred = _shift_down(_argmax_state(Mp2, IXp2, IYp2, best_p2), 0)
            bits = mpred | ((ext_x > open_x).to(i32) << 2) | ((ext_y > open_y).to(i32) << 3)
            arrows_l.append(torch.where(interior, bits, 0).to(torch.uint8))
        M = torch.where(interior, M, NEG_GOTOH)
        IX = torch.where(interior, IX, NEG_GOTOH)
        IY = torch.where(interior, IY, NEG_GOTOH)
        IX = torch.where(valid & (j_idx == 0), gaps[kk], IX)  # row 0
        IY = torch.where(valid & (i_idx == 0), gaps[kk], IY)  # column 0
        best = torch.maximum(torch.maximum(M, IX), IY)
        hit = kk == k_corner
        captured = torch.where(hit, best[b_ar, j_corner], captured)
        if with_arrows:
            cstate = torch.where(hit, _argmax_state(M, IX, IY, best)[b_ar, j_corner], cstate)
        Mp2, IXp2, IYp2 = Mp, IXp, IYp
        Mp, IXp, IYp = M, IX, IY

    out = {"score": captured}
    if with_arrows:
        out["arrows"] = torch.stack(arrows_l, dim=1)
        out["state"] = cstate
    return out


def _argmax_state(M, IX, IY, best):
    """The Gotoh state that holds ``best``: 0 M, 1 IX, 2 IY, ties M > IX >
    IY (``affine.py:191``)."""
    return torch.where(M >= best, 0, torch.where(IX >= IY, 1, 2)).to(torch.int32)


def fill_diag(
    top: torch.Tensor,
    side: torch.Tensor,
    m: int,
    k: int,
    d: int,
    len1: int | None = None,
    len2: int | None = None,
    with_arrows: bool = True,
    with_counts: bool = False,
    with_scores: bool = False,
    seed: Optional[torch.Tensor] = None,
    row0: int = 0,
    left: Optional[torch.Tensor] = None,
    with_edges: bool = False,
) -> Dict[str, torch.Tensor]:
    """:func:`fill_diag_batch` on one pair (``fill_scan.py:48
    fill_diag``): int32 top[A] / side[Bs], true lengths defaulting to
    A / Bs, ``seed`` int32[A+1], ``left`` int32[Bs]; the same dict with
    the batch dimension dropped."""
    len1 = top.shape[0] if len1 is None else len1
    len2 = side.shape[0] if len2 is None else len2
    dev = top.device
    out = fill_diag_batch(
        top[None], side[None],
        torch.tensor([len1], device=dev), torch.tensor([len2], device=dev),
        m, k, d, with_arrows=with_arrows, with_counts=with_counts,
        with_scores=with_scores, seed=None if seed is None else seed[None],
        row0=row0, left=None if left is None else left[None], with_edges=with_edges,
    )
    return {key: v[0] for key, v in out.items()}


def fill_last_row(top, side, m, k, d, len1=None, len2=None, every=None) -> torch.Tensor:
    """int32[A+1]: the scores of DP row ``len2`` for columns 0..A (valid
    through ``len1``; ``fill_scan.py:238 fill_last_row``), read off the
    anti-diagonal fill of ``side[:len2]``: ``H[j, i]`` sits on diagonal
    ``j + i``.  With ``every`` = C, int32[ceil(len2/C) + 1, A+1]: the rows
    0, C, 2C, ... below ``len2`` and row ``len2`` last, all from that one
    fill: the plain version behind K12's checkpoint rows and its corner
    (:func:`nw_tpu_torch.ops.fill_single.score_fold_plain`)."""
    A = top.shape[0]
    len2 = side.shape[0] if len2 is None else int(len2)
    out = fill_diag(
        top, side[:len2], m, k, d, len1, len2, with_arrows=False, with_scores=True
    )
    rows = [len2] if every is None else [*range(0, len2, every), len2]
    rows = torch.tensor(rows, device=top.device)[:, None]
    got = out["scores"][rows + torch.arange(A + 1, device=top.device), rows]
    return got[0] if every is None else got


def diag_to_matrix_batch(diag: torch.Tensor) -> torch.Tensor:
    """Diagonal-major ``D[b, kk, j]`` -> rectangular ``H[b, j, i]``.

    ``H[b, j, i] = D[b, i + j, j]``: with ``D`` transposed to (B, N, K),
    row j of H starts at offset ``j * (K + 1)``, so H is a strided view.
    Returns a contiguous (B, N, K - N + 1) tensor."""
    B, K, N = diag.shape
    dt = diag.transpose(1, 2).contiguous()
    M = K - N + 1
    return dt.as_strided((B, N, M), (N * K, K + 1, 1)).contiguous()


def diag_to_matrix(diag: torch.Tensor, len1: int, len2: int) -> torch.Tensor:
    """One pair's diagonal-major ``D[kk, j]`` -> its true rectangle
    ``H[j, i] = D[i + j, j]``, (len2+1, len1+1) (``fill_scan.py:208``)."""
    jj = torch.arange(len2 + 1, device=diag.device)[:, None]
    ii = torch.arange(len1 + 1, device=diag.device)[None, :]
    return diag[ii + jj, jj]


def matrix_to_diag(rect: torch.Tensor) -> torch.Tensor:
    """Rectangular ``H[j, i]`` (N, M) -> diagonal-major ``D[kk, j] =
    H[j, kk - j]`` (M + N - 1, N); cells outside the table are 0."""
    N, M = rect.shape
    kk = torch.arange(M + N - 1, device=rect.device)[:, None]
    jj = torch.arange(N, device=rect.device)[None, :]
    ii = kk - jj
    inside = (ii >= 0) & (ii < M)
    vals = rect[jj.expand_as(ii), ii.clamp(0, M - 1)]
    return torch.where(inside, vals, torch.zeros((), dtype=rect.dtype, device=rect.device))


def code_shape(B: int, A: int, Bs: int, bits: int = 2) -> Tuple[int, int, int, int]:
    """Shape of the band-major code tensor of ``B`` pairs at buckets (A,
    Bs), ``bits`` a code: int32[B, ceil(Bs/32), TW, 32], TW =
    ceil((A+32)/32) * bits (the layout of
    :mod:`nw_tpu_torch.ops.fill_banded`; 2-bit greedy codes, 16 a word,
    or 4-bit Gotoh codes, 8 a word)."""
    nbands = -(-Bs // BAND_ROWS)
    steps = -(-(A + BAND_ROWS) // BAND_ROWS) * BAND_ROWS  # whole 32-step chunks
    return (B, nbands, steps * bits // 32, BAND_ROWS)


def greedy_codes_from_arrows(arrows: torch.Tensor, local: bool = False) -> torch.Tensor:
    """Diagonal-major tie masks uint8[B, K, N] -> packed greedy codes in
    the kernels' band-major layout (diag > left > up).  With ``local``
    (Smith-Waterman masks) a cell without arrows, a local start and
    every cell of column 0, gets STOP (3)."""
    rect = diag_to_matrix_batch(arrows)[:, 1:]  # rows 1..Bs, [B, Bs, A+1]
    code = torch.where(
        (rect & 1) != 0, 0, torch.where((rect & 2) != 0, 1, 2)
    ).to(torch.uint8)
    if local:
        code = torch.where(rect == 0, 3, code).to(torch.uint8)
    return pack_band_major(code, 2)


def gotoh_codes_from_arrows(arrows: torch.Tensor) -> torch.Tensor:
    """Diagonal-major Gotoh state bits uint8[B, K, N]
    (:func:`affine_fill_diag_batch` with ``with_arrows``) -> 4-bit codes
    in the kernels' band-major layout, 8 a word: the bits as they are."""
    return pack_band_major(diag_to_matrix_batch(arrows)[:, 1:], 4)


def pack_band_major(code: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 codes of rows 1..Bs, [B, Bs, A+1], each below ``2**bits`` ->
    int32 words in the kernels' band-major layout (:func:`code_shape`):
    cell (j, i) of band (j-1)//32, lane jj = (j-1)%32, sits at band step
    t = i + jj, bits ``bits*(t % (32/bits))`` of word t // (32/bits)."""
    B, Bs, M = code.shape
    A = M - 1
    per_word = 32 // bits
    _, nbands, TW, _ = code_shape(B, A, Bs, bits)
    code = torch.nn.functional.pad(code, (0, 0, 0, nbands * BAND_ROWS - Bs))
    code = code.view(B, nbands, BAND_ROWS, A + 1)
    by_step = torch.zeros(
        (B, nbands, BAND_ROWS, TW * per_word), dtype=torch.uint8, device=code.device,
    )
    for jj in range(BAND_ROWS):
        by_step[:, :, jj, jj : jj + A + 1] = code[:, :, jj]
    shifts = bits * torch.arange(per_word, device=code.device)
    words = (
        by_step.view(B, nbands, BAND_ROWS, TW, per_word).to(torch.int64) << shifts
    ).sum(-1)
    # reinterpret the uint32 words as int32; lanes last
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return words.transpose(2, 3).contiguous()
