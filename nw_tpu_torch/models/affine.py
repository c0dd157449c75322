"""Gotoh affine-gap global alignment scores.

Counterpart of the score half of ``nw_tpu/models/affine.py``.  Three
states a cell (M: match or mismatch, IX: a gap in the side string, from
the left, IY: a gap in the top string, from above), and a gap run of
length L costs ``open + (L-1) * extend``::

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
  at every batch size and side length; ``device="cuda"`` (the default)
  launches it and raises without a card, ``device="cpu"`` runs its plain
  version.

Every score follows ``nw_tpu``'s scan (``affine_score``) at every
scoring; at gap costs near the sentinel (``1 1 2^28 2^28``) ``nw_tpu``'s
K17, K20 and K23 leave it (ROADMAP queue 3).  The traceback half,
``affine_fill_arrows``, ``affine_traceback``, ``affine_align`` and
``affine_align_batch`` (K21, K25 and a three-state walk), comes in the
next slice of the port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from nw_tpu_torch.models.needleman_wunsch import _as_bytes, resolve_device
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops.fill_scan import affine_fill_diag_batch
from nw_tpu_torch.ops.variants_banded import affine_scores_banded_batch

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
