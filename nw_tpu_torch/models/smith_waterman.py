"""Smith-Waterman local alignment with linear gap penalties.

Counterpart of ``nw_tpu/models/smith_waterman.py``.  The local recurrence
is the global one clamped at 0: row 0 and column 0 are 0, every cell is
``max(diag + (m | -k), up - d, left - d, 0)`` in wrapping int32, the
result is the best cell of the table, and the alignment is the greedy
walk (diag > left > up) from that cell back to the first cell of score 0.

* :func:`sw_fill_diag` and :func:`sw_traceback` — one pair in plain
  PyTorch / on the host, the oracle the rest is held to
  (``smith_waterman.py:25-138``);
* :func:`sw_score_batch` — best local scores of a batch: one launch of
  ``sw_scores`` (the port of K22, K15 and K18's score mode) at every batch
  size and side length, W warps a pair on the pipeline of ``nw_scores``
  (W from :func:`nw_tpu_torch.ops.fill_banded.fill_warps`: 32 at 128 x
  10 kb, 1 at 10 240 x 150 bp);
* :func:`sw_align_batch` — one local alignment a pair: sub-batches whose
  2-bit codes fit :data:`nw_tpu_torch.models.needleman_wunsch.CODE_BUDGET_BYTES`,
  each one ``sw_fill_codes`` (K24 and K18's words mode: codes, best,
  argmax; W warps a pair on the same pipeline, a kernel of its own), one
  ``sw_walk`` and the host strings; a pair whose codes alone pass the
  budget takes the two-pass route of
  :func:`nw_tpu_torch.ops.variants_banded.sw_traceback_banded_batch`
  (``free_fill_span``, ``sw_walk_groups``);
* :func:`sw_align` — :func:`sw_align_batch` of one pair.

``device="cuda"`` (the default) launches the kernels and raises without a
card; ``device="cpu"`` runs their plain versions.  There is no
single-pair route, as ``nw_tpu`` has no single-pair SW engine either: a
small batch of very long pairs takes up to 32 warps a pair for its scores
and for its codes (``sw_fill_codes``).

Every output follows ``nw_tpu``'s scan (``sw_fill_diag``) at every
scoring.  At d < 0 or k < 0 ``nw_tpu``'s K22, K18 and K24, and so its
``sw_score_batch`` and ``sw_align_batch``, leave column 0 free and differ
from its own scan; the port writes row 0 and column 0 as 0 and does not.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from nw_tpu_torch.models.needleman_wunsch import (
    CODE_BUDGET_BYTES,
    _as_bytes,
    resolve_device,
)
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops.fill_scan import sw_fill_diag_batch
from nw_tpu_torch.ops.traceback import ops_to_strings_batch
from nw_tpu_torch.ops.variants_banded import (
    free_traceback_dispatch,
    onepass_budget,
    sw_scores_banded_batch,
    variant_sub_batch,
)

Pair = Tuple[str | bytes, str | bytes]


def sw_fill_diag(top, side, m: int, k: int, d: int, with_arrows: bool = True) -> Dict[str, torch.Tensor]:
    """Local-alignment fill of one pair along anti-diagonals.

    top / side: encoded int32[A] / int32[Bs] (any array torch takes).
    Returns ``score`` (int32, the best local score, >= 0), ``argmax``
    (int32[2]: the (j, i) cell of the best, first hit in diagonal order,
    lowest row within a diagonal; (0, 0) when the best is 0) and, with
    ``with_arrows``, ``arrows`` uint8[A+Bs+1, Bs+1] diagonal-major tie
    masks, none where a cell is 0 (``smith_waterman.py:25 sw_fill_diag``).
    """
    top = torch.as_tensor(top, dtype=torch.int32)
    side = torch.as_tensor(side, dtype=torch.int32, device=top.device)
    lens = [torch.tensor([x], dtype=torch.int32, device=top.device) for x in (top.shape[0], side.shape[0])]
    out = sw_fill_diag_batch(top[None], side[None], *lens, m, k, d, with_arrows=with_arrows)
    return {key: v[0] for key, v in out.items()}


def sw_traceback(arrows_diag, argmax, top: bytes, side: bytes) -> Tuple[bytes, bytes, Tuple[int, int]]:
    """Host traceback of one local alignment: greedy diag > left > up from
    the argmax cell (j, i) until a cell with no arrows (score 0).

    Returns (X, Y, (j_start, i_start)): the aligned substrings and the
    cell where the local alignment begins (``smith_waterman.py:110``).
    """
    arrows = np.asarray(arrows_diag)
    j, i = (int(x) for x in np.asarray(argmax))
    X, Y = bytearray(), bytearray()
    while True:
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
        else:
            break
    return bytes(X[::-1]), bytes(Y[::-1]), (j, i)


def sw_score_batch(pairs: Sequence[Pair], m: int = 2, k: int = 1, d: int = 1,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Best local-alignment score of each pair, int32[B] (>= 0): one
    ``sw_scores`` launch over the batch padded to its longest strings
    (``smith_waterman.py:152 sw_score_batch``)."""
    dev = resolve_device(device, "sw_score_batch")
    norm = [(_as_bytes(a), _as_bytes(b)) for a, b in pairs]
    if not norm:
        return np.zeros(0, np.int32)
    tops, sides, l1, l2 = enc.upload(enc.encode_batch(norm), dev)
    return sw_scores_banded_batch(tops, sides, l1, l2, m, k, d).cpu().numpy()


def sw_align_batch(pairs: Sequence[Pair], m: int = 2, k: int = 1, d: int = 1,
                   device: str | torch.device = "cuda") -> List[Tuple[int, bytes, bytes, Tuple[int, int]]]:
    """One local alignment a pair: ``(best, X, Y, (j_end, i_end))``, equal
    to :func:`sw_align` (the scan's tie rules) and to ``nw_tpu``'s
    ``sw_align_batch`` (``smith_waterman.py:269``).

    The batch is padded to its longest strings and cut into sub-batches
    (:func:`walk_align_batch`); each runs
    :func:`nw_tpu_torch.ops.variants_banded.free_traceback_dispatch`'s
    route, then the strings of ``(s1[:i*], s2[:j*])`` are built on the
    host.
    """
    dev = resolve_device(device, "sw_align_batch")
    return [row[:4] for row in walk_align_batch(True, pairs, m, k, d, dev)]


def walk_align_batch(local: bool, pairs: Sequence[Pair], m: int, k: int, d: int,
                     dev: torch.device) -> List[Tuple[int, bytes, bytes, Tuple[int, int], Tuple[int, int]]]:
    """The alignments of a free-boundary fill, local (``local``) or
    overlap: ``(best, X, Y, (j, i) where the walk stopped, (j*, i*))`` a
    pair.

    The batch is padded to its longest strings and cut into sub-batches by
    :func:`nw_tpu_torch.ops.variants_banded.variant_sub_batch` under
    ``CODE_BUDGET_BYTES`` (``NW_TPU_ONEPASS_HBM`` when set): as many pairs
    as whole 2-bit code tables fit, each sub-batch one fill of its codes
    (``sw_fill_codes`` / ``overlap_fill_codes``) and one ``sw_walk`` from
    (j*, i*); or, when one pair's table does not fit, sub-batches on the
    two-pass route (pass 1's span fills, then each group re-filled and
    walked, last first: ``free_fill_span``, ``sw_walk_groups``).  Then the
    strings of ``(s1[:i*], s2[:j*])`` are built on the host.
    """
    norm = [(_as_bytes(a), _as_bytes(b)) for a, b in pairs]
    if not norm:
        return []
    L1 = max(len(a) for a, _ in norm)
    L2 = max(len(b) for _, b in norm)
    budget = onepass_budget(CODE_BUDGET_BYTES)
    chunk = variant_sub_batch(L1, L2, 2, budget)
    out = []
    for lo in range(0, len(norm), chunk):
        sub = norm[lo : lo + chunk]
        tops, sides, l1, l2 = enc.upload(enc.encode_batch(sub, L1, L2), dev)
        res = free_traceback_dispatch(tops, sides, l1, l2, m, k, d, local, budget)
        best, j_star, i_star, n, i_end, j_end = (
            t.cpu().numpy() for t in (res.scores, res.j_star, res.i_star, res.n, res.i_end, res.j_end)
        )
        trunc = [(s1[: i_star[b]], s2[: j_star[b]]) for b, (s1, s2) in enumerate(sub)]
        strs = ops_to_strings_batch(res.ops.cpu().numpy(), n, trunc)
        out.extend(
            (int(best[b]), X, Y, (int(j_end[b]), int(i_end[b])), (int(j_star[b]), int(i_star[b])))
            for b, (X, Y) in enumerate(strs)
        )
    return out


def sw_align(s1: str | bytes, s2: str | bytes, m: int = 2, k: int = 1, d: int = 1,
             device: str | torch.device = "cuda") -> Tuple[int, bytes, bytes, Tuple[int, int]]:
    """One local alignment: (score, X, Y, start cell (j, i)), as
    ``smith_waterman.py:141 sw_align``; :func:`sw_align_batch` of one pair,
    so on the card the kernels run."""
    return sw_align_batch([(s1, s2)], m, k, d, device)[0]
