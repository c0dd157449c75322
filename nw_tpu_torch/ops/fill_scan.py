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
"""

from __future__ import annotations

from typing import Dict

import torch

NEG_INF = -(2**30)
U32 = 0xFFFFFFFF


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

    Returns:
      dict with ``score`` int32[B], and ``arrows`` / ``count`` (int64[B]
      in [0, 2^32)) / ``scores`` when asked.
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
    b_ar = torch.arange(B, device=dev)

    # row 0 gets a sentinel side character (it is never an interior row)
    side_sh = torch.cat([torch.full((B, 1), -3, dtype=i32, device=dev), sides], 1)
    # the top char of cell (kk, j) is top[kk-1-j]: a contiguous slice of
    # the reversed top string, padded so that every slice is in bounds
    pad = torch.full((B, N), -4, dtype=i32, device=dev)
    top_ext = torch.cat([pad, tops.flip(1), pad], 1)

    j_idx = torch.arange(N, device=dev)
    prev = torch.where(j_idx == 0, 0, NEG_INF).to(i32).expand(B, N)
    prev2 = torch.full((B, N), NEG_INF, dtype=i32, device=dev)
    captured = torch.zeros(B, dtype=i32, device=dev)
    m_t = torch.tensor(m, dtype=i32, device=dev)
    negk_t = -torch.tensor(k, dtype=i32, device=dev)
    d_t = torch.tensor(d, dtype=i32, device=dev)
    if with_counts:
        cprev = (j_idx == 0).to(torch.int64).expand(B, N)
        cprev2 = torch.zeros((B, N), dtype=torch.int64, device=dev)
        ccaptured = torch.ones(B, dtype=torch.int64, device=dev)
    arrows_l = [torch.zeros((B, N), dtype=torch.uint8, device=dev)]
    scores_l = [prev]

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

        edge = -(torch.tensor(kk, dtype=i32, device=dev) * d_t)
        score = torch.where(interior, score, NEG_INF)
        score = torch.where(on_top_row | on_left_col, edge, score)
        hit = kk == k_corner
        captured = torch.where(hit, score[b_ar, lens2.clamp(max=Bs)], captured)

        if with_scores:
            scores_l.append(score)
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
            ccaptured = torch.where(
                hit, cnt[b_ar, lens2.clamp(max=Bs)], ccaptured
            )
            cprev, cprev2 = cnt, cprev
        prev, prev2 = score, prev

    out = {"score": captured}
    if with_arrows:
        out["arrows"] = torch.stack(arrows_l, dim=1)
    if with_counts:
        out["count"] = ccaptured
    if with_scores:
        out["scores"] = torch.stack(scores_l, dim=1)
    return out


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
) -> Dict[str, torch.Tensor]:
    """:func:`fill_diag_batch` on one pair (``fill_scan.py:48
    fill_diag``): int32 top[A] / side[Bs], true lengths defaulting to
    A / Bs; the same dict with the batch dimension dropped."""
    len1 = top.shape[0] if len1 is None else len1
    len2 = side.shape[0] if len2 is None else len2
    dev = top.device
    out = fill_diag_batch(
        top[None], side[None],
        torch.tensor([len1], device=dev), torch.tensor([len2], device=dev),
        m, k, d, with_arrows=with_arrows, with_counts=with_counts,
        with_scores=with_scores,
    )
    return {key: v[0] for key, v in out.items()}


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
