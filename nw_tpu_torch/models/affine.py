"""Gotoh affine-gap global alignment.

Counterpart of ``nw_tpu/models/affine.py``.  Three states a cell (M:
match or mismatch, IX: a gap in the side string, from the left, IY: a gap
in the top string, from above), and a gap run of length L costs
``open + (L-1) * extend``::

    M[j,i]  = max(M, IX, IY)[j-1,i-1] + (m | -k)
    IX[j,i] = max(M[j,i-1] - open, IX[j,i-1] - extend)
    IY[j,i] = max(M[j-1,i] - open, IY[j-1,i] - extend)

in wrapping int32, with ``nw_tpu``'s sentinel NEG_INF // 2 for a state
that does not exist and its boundary gaps (``affine.py:28-100``).  With
``extend == open`` the score is the linear-gap one at ``d = open`` when
``k < 2 * open``.

* :func:`affine_score` — one pair, the plain oracle (``affine.py:28``);
* :func:`affine_score_batch` — the plain uniform-length batch
  (``affine.py:103``);
* :func:`affine_score_pairs` — ragged pairs: one launch of
  ``gotoh_scores`` (the port of K17, K23 and K20) over the padded batch,
  at every batch size and side length;
* :func:`affine_fill_arrows` and :func:`affine_traceback` — one pair's
  state bits and its host walk, the plain oracle of the alignments
  (``affine.py:109``, ``:218``);
* :func:`affine_align_batch` — one alignment a pair: sub-batches whose
  4-bit codes fit
  :data:`nw_tpu_torch.models.needleman_wunsch.CODE_BUDGET_BYTES`, each
  one ``gotoh_fill_codes`` (the port of K21 and K25: codes, corner
  scores and states), one ``gotoh_walk`` and the host strings, at every
  batch size and side length; a pair whose codes alone pass the budget
  takes the two-pass route of
  :func:`nw_tpu_torch.ops.variants_banded.affine_traceback_banded_batch`
  (``gotoh_fill_span``, ``gotoh_walk_groups``);
* :func:`affine_align` — :func:`affine_align_batch` of one pair.

``device="cuda"`` (the default) launches the kernels and raises without
a card, ``device="cpu"`` runs their plain versions.  The tie rules are
``nw_tpu``'s: M > IX > IY, and open over extend (``affine.py:250-254``).
The walk keeps to the rectangle: on row 0 it steps LEFT and on column 0
UP, whatever its state.  ``nw_tpu``'s walks read there by the state,
which at gap costs near the sentinel (``1 1 2^28 2^28``) sends them off
the rectangle (ROADMAP queue 3); at every other scoring the two agree.

Every score follows ``nw_tpu``'s scan (``affine_score``) at every
scoring; at gap costs near the sentinel ``nw_tpu``'s K17, K20, K23 and
K25 leave it (ROADMAP queue 3).
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
from nw_tpu_torch.ops.fill_scan import affine_fill_diag_batch
from nw_tpu_torch.ops.traceback import ops_to_strings_batch
from nw_tpu_torch.ops.variants_banded import (
    affine_scores_banded_batch,
    affine_traceback_dispatch,
    onepass_budget,
    variant_sub_batch,
)

GAP = ord("-")

Pair = Tuple[str | bytes, str | bytes]


def affine_score(top, side, m: int, k: int, open_: int, extend: int) -> torch.Tensor:
    """Optimal affine-gap global score of one pair, an int32 scalar.

    top / side: encoded int32[A] / int32[Bs] (any array torch takes)."""
    top = torch.as_tensor(top, dtype=torch.int32)
    side = torch.as_tensor(side, dtype=torch.int32, device=top.device)
    return affine_score_batch(top[None], side[None], m, k, open_, extend)[0]


def affine_score_batch(tops, sides, m: int, k: int, open_: int, extend: int) -> torch.Tensor:
    """int32[B] optimal affine-gap global scores of equal-length pairs:
    encoded int32[B, A] tops and int32[B, Bs] sides, every pair scored at
    its full lengths (A, Bs)."""
    tops = torch.as_tensor(tops, dtype=torch.int32)
    sides = torch.as_tensor(sides, dtype=torch.int32, device=tops.device)
    B, A = tops.shape
    lens = [torch.full((B,), x, dtype=torch.int32, device=tops.device) for x in (A, sides.shape[1])]
    return affine_fill_diag_batch(tops, sides, *lens, m, k, open_, extend)["score"]


def affine_score_pairs(pairs: Sequence[Pair], m: int, k: int, open_: int, extend: int,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """Optimal affine-gap global score of each pair, int32[B], ragged
    lengths: one ``gotoh_scores`` launch over the batch padded to its
    longest strings (``affine.py:267 affine_score_pairs``)."""
    dev = resolve_device(device, "affine_score_pairs")
    norm = [(_as_bytes(a), _as_bytes(b)) for a, b in pairs]
    if not norm:
        return np.zeros(0, np.int32)
    tops, sides, l1, l2 = enc.upload(enc.encode_batch(norm), dev)
    return affine_scores_banded_batch(tops, sides, l1, l2, m, k, open_, extend).cpu().numpy()


def affine_fill_arrows(top, side, m: int, k: int, open_: int, extend: int) -> Dict[str, torch.Tensor]:
    """Gotoh fill of one pair with the walk's state bits
    (``affine.py:109 affine_fill_arrows``).

    top / side: encoded int32[A] / int32[Bs] (any array torch takes).
    Returns ``score`` (int32), ``state`` (int32: the corner cell's argmax
    state, 0 M, 1 IX, 2 IY, ties M > IX > IY; the walk's start) and
    ``arrows`` uint8[A+Bs+1, Bs+1], diagonal-major: on each interior cell
    bits 0-1 M's predecessor state, bit 2 IX extends, bit 3 IY extends
    (ties open); 0 on row 0 and column 0, which the walk does not read.
    """
    top = torch.as_tensor(top, dtype=torch.int32)
    side = torch.as_tensor(side, dtype=torch.int32, device=top.device)
    lens = [torch.tensor([x], dtype=torch.int32, device=top.device) for x in (top.shape[0], side.shape[0])]
    out = affine_fill_diag_batch(top[None], side[None], *lens, m, k, open_, extend, with_arrows=True)
    return {key: v[0] for key, v in out.items()}


def affine_traceback(bits_diag, state, top: bytes, side: bytes) -> Tuple[bytes, bytes]:
    """Host walk over :func:`affine_fill_arrows` bits -> (X, Y)
    (``affine.py:218 affine_traceback``), from the corner in ``state``:
    M consumes both characters and moves to the state of bits 0-1, IX
    the top character and stays in IX on bit 2, IY the side character and
    stays in IY on bit 3 (else back to M).  On row 0 it steps LEFT and on
    column 0 UP, whatever its state, so it reads no cell outside the
    rectangle and the alignment spells both inputs."""
    bits = np.asarray(bits_diag)
    i, j = len(top), len(side)
    st = int(state)
    X, Y = bytearray(), bytearray()
    while i > 0 or j > 0:
        if j == 0:  # row 0: LEFT to the origin
            st = 1
        elif i == 0:  # column 0: UP to the origin
            st = 2
        b = int(bits[i + j, j]) if i and j else 0
        if st == 0:  # M: consume both
            X.append(top[i - 1])
            Y.append(side[j - 1])
            i -= 1
            j -= 1
            st = b & 3
        elif st == 1:  # IX: consume the top char
            X.append(top[i - 1])
            Y.append(GAP)
            i -= 1
            st = 1 if (b >> 2) & 1 else 0
        else:  # IY: consume the side char
            X.append(GAP)
            Y.append(side[j - 1])
            j -= 1
            st = 2 if (b >> 3) & 1 else 0
    return bytes(X[::-1]), bytes(Y[::-1])


def affine_align_batch(pairs: Sequence[Pair], m: int, k: int, open_: int, extend: int,
                       device: str | torch.device = "cuda") -> List[Tuple[int, bytes, bytes]]:
    """One optimal affine-gap global alignment a pair: ``(score, X, Y)``,
    equal to ``nw_tpu``'s ``affine_align`` (the scan's tie rules; ``affine.py:394
    affine_align_batch``).

    The batch is padded to its longest strings and cut into sub-batches
    by :func:`nw_tpu_torch.ops.variants_banded.variant_sub_batch` under
    ``CODE_BUDGET_BYTES`` (``NW_TPU_ONEPASS_HBM`` when set): as many pairs
    as whole 4-bit code tables fit, each sub-batch one ``gotoh_fill_codes``
    and one ``gotoh_walk`` from the corners in their states; or, when one
    pair's table does not fit, sub-batches on the two-pass route of
    :func:`nw_tpu_torch.ops.variants_banded.affine_traceback_banded_batch`
    (``gotoh_fill_span``, ``gotoh_walk_groups``).  Then the strings are
    built on the host.  Scores are the scan's (``affine_fill_arrows``) at
    every scoring.
    """
    dev = resolve_device(device, "affine_align_batch")
    norm = [(_as_bytes(a), _as_bytes(b)) for a, b in pairs]
    if not norm:
        return []
    L1 = max(len(a) for a, _ in norm)
    L2 = max(len(b) for _, b in norm)
    budget = onepass_budget(CODE_BUDGET_BYTES)
    chunk = variant_sub_batch(L1, L2, 4, budget)
    out = []
    for lo in range(0, len(norm), chunk):
        sub = norm[lo : lo + chunk]
        tops, sides, l1, l2 = enc.upload(enc.encode_batch(sub, L1, L2), dev)
        res = affine_traceback_dispatch(tops, sides, l1, l2, m, k, open_, extend, budget)
        strs = ops_to_strings_batch(res.ops.cpu().numpy(), res.n.cpu().numpy(), sub)
        scores = res.scores.cpu().numpy()
        out.extend((int(scores[b]), X, Y) for b, (X, Y) in enumerate(strs))
    return out


def affine_align(s1: str | bytes, s2: str | bytes, m: int, k: int, open_: int, extend: int,
                 device: str | torch.device = "cuda") -> Tuple[int, bytes, bytes]:
    """One optimal affine-gap global alignment: (score, X, Y), as
    ``affine.py:247 affine_align``; :func:`affine_align_batch` of one
    pair, so on the card the kernels run."""
    return affine_align_batch([(s1, s2)], m, k, open_, extend, device)[0]
