"""Overlap (semi-global, end-gap-free) alignment with linear gap penalties.

Counterpart of ``nw_tpu/models/overlap.py``.  Needleman-Wunsch's interior
recurrence with free end gaps: row 0 and column 0 are 0 (leading gaps
cost nothing), every interior cell is ``max(diag + (m | -k), up - d,
left - d)`` in wrapping int32 with no clamp, and the result is the best
cell of the end boundary, the last true row or column (trailing gaps cost
nothing).  The zero-cost corner (j, i) = (0, len1), or (len2, 0) when
len1 is 0, seeds it: a cell replaces it only with a strictly greater
score, the first anti-diagonal then the lowest row, so the score is
always >= 0.  The alignment is the greedy walk (diag > left > up) from
that cell back to row 0 or column 0.

* :func:`overlap_fill_diag` and :func:`overlap_traceback` — one pair in
  plain PyTorch / on the host, the oracle the rest is held to
  (``overlap.py:49-255``);
* :func:`overlap_score_batch` — best overlap scores of a batch: one
  launch of ``overlap_scores`` (the port of K16 and K19's score mode) at
  every batch size and side length, W warps a pair on the pipeline of
  ``nw_scores`` (W from :func:`nw_tpu_torch.ops.fill_banded.fill_warps`);
* :func:`overlap_align_batch` — one overlap alignment a pair: sub-batches
  whose 2-bit codes fit
  :data:`nw_tpu_torch.models.needleman_wunsch.CODE_BUDGET_BYTES`, each one
  ``overlap_fill_codes`` (K19's words + argmax mode, W warps a pair on
  the same pipeline: codes with STOP on column 0, best, end cell), one
  ``sw_walk`` (the walk of the local
  codes, which stops at row 0, column 0 or STOP alike: for
  ``_overlap_walk_diag`` and ``_overlap_walk_device``) and the host
  strings; a pair whose codes alone pass the budget takes the two-pass
  route of :func:`nw_tpu_torch.ops.variants_banded.overlap_traceback_banded_batch`
  (``free_fill_span``, ``sw_walk_groups``);
* :func:`overlap_align` — :func:`overlap_align_batch` of one pair.

``device="cuda"`` (the default) launches the kernels and raises without a
card; ``device="cpu"`` runs their plain versions.  Every output follows
``nw_tpu``'s scan (``overlap_fill_diag``) at every scoring.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from nw_tpu_torch.models.needleman_wunsch import _as_bytes, resolve_device
from nw_tpu_torch.models.smith_waterman import walk_align_batch
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops.fill_scan import overlap_fill_diag_batch
from nw_tpu_torch.ops.variants_banded import overlap_scores_banded_batch

Pair = Tuple[str | bytes, str | bytes]
Cell = Tuple[int, int]


def overlap_fill_diag(top, side, m: int, k: int, d: int, len1: int | None = None,
                      len2: int | None = None, with_arrows: bool = True) -> Dict[str, torch.Tensor]:
    """Overlap fill of one pair along anti-diagonals.

    top / side: encoded int32[A] / int32[Bs] (any array torch takes),
    possibly padded: ``len1`` / ``len2`` are the true lengths (default A /
    Bs).  Returns ``score`` (int32, >= 0), ``argmax`` (int32[2]: the (j, i)
    end-boundary cell of the best) and, with ``with_arrows``, ``arrows``
    uint8[A+Bs+1, Bs+1] diagonal-major tie masks, none on row 0 and
    column 0 (``overlap.py:49 overlap_fill_diag``).
    """
    top = torch.as_tensor(top, dtype=torch.int32)
    side = torch.as_tensor(side, dtype=torch.int32, device=top.device)
    len1 = top.shape[0] if len1 is None else int(len1)
    len2 = side.shape[0] if len2 is None else int(len2)
    lens = [torch.tensor([x], dtype=torch.int32, device=top.device) for x in (len1, len2)]
    out = overlap_fill_diag_batch(top[None], side[None], *lens, m, k, d, with_arrows=with_arrows)
    return {key: v[0] for key, v in out.items()}


def overlap_traceback(arrows_diag, argmax, top: bytes, side: bytes) -> Tuple[bytes, bytes, Cell]:
    """Host traceback of one overlap alignment: greedy diag > left > up
    from the end cell (j, i) until row 0 or column 0.

    Returns (X, Y, (j_start, i_start)): the aligned overlap segment and
    the cell where it begins (``overlap.py:224 overlap_traceback``).
    """
    arrows = np.asarray(arrows_diag)
    j, i = (int(x) for x in np.asarray(argmax))
    X, Y = bytearray(), bytearray()
    while i > 0 and j > 0:
        a = int(arrows[i + j, j])
        if a & 1:
            i, j = i - 1, j - 1
            X.append(top[i])
            Y.append(side[j])
        elif a & 2:
            i -= 1
            X.append(top[i])
            Y.append(ord("-"))
        elif a & 4:
            j -= 1
            X.append(ord("-"))
            Y.append(side[j])
        else:  # a boundary cell reached exactly
            break
    return bytes(X[::-1]), bytes(Y[::-1]), (j, i)


def overlap_score_batch(pairs: Sequence[Pair], m: int = 2, k: int = 1, d: int = 1,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Best overlap score of each pair, int32[B] (>= 0): one
    ``overlap_scores`` launch over the batch padded to its longest strings
    (``overlap.py:278 overlap_score_batch``)."""
    dev = resolve_device(device, "overlap_score_batch")
    norm = [(_as_bytes(a), _as_bytes(b)) for a, b in pairs]
    if not norm:
        return np.zeros(0, np.int32)
    tops, sides, l1, l2 = enc.upload(enc.encode_batch(norm), dev)
    return overlap_scores_banded_batch(tops, sides, l1, l2, m, k, d).cpu().numpy()


def overlap_align_batch(pairs: Sequence[Pair], m: int = 2, k: int = 1, d: int = 1,
                        device: str | torch.device = "cuda") -> List[Tuple[int, bytes, bytes, Cell, Cell]]:
    """One overlap alignment a pair: ``(score, X, Y, (j_start, i_start),
    (j_end, i_end))``, equal to :func:`overlap_align` (the scan's tie
    rules) and to ``nw_tpu``'s ``overlap_align_batch`` (``overlap.py:329``).
    ``s1[i_start:i_end]`` and ``s2[j_start:j_end]`` are the overlapped
    substrings.

    The batch is padded to its longest strings and cut into sub-batches
    (:func:`nw_tpu_torch.models.smith_waterman.walk_align_batch`: one
    ``overlap_fill_codes`` and one ``sw_walk`` each, or the two-pass route
    of :func:`nw_tpu_torch.ops.variants_banded.overlap_traceback_banded_batch`
    for a pair whose codes alone pass ``CODE_BUDGET_BYTES``), then the
    strings of ``(s1[:i_end], s2[:j_end])`` are built on the host.
    """
    dev = resolve_device(device, "overlap_align_batch")
    return walk_align_batch(False, pairs, m, k, d, dev)


def overlap_align(s1: str | bytes, s2: str | bytes, m: int = 2, k: int = 1, d: int = 1,
                  device: str | torch.device = "cuda") -> Tuple[int, bytes, bytes, Cell, Cell]:
    """One overlap alignment: (score, X, Y, start cell, end cell), each
    cell (j, i), as ``overlap.py:258 overlap_align``;
    :func:`overlap_align_batch` of one pair, so on the card the kernels
    run."""
    return overlap_align_batch([(s1, s2)], m, k, d, device)[0]
