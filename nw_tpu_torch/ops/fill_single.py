"""Single-pair fills: the ports of K8 to K14 and K28.

Each wrapper launches its kernel of ``csrc/nw_single.cu`` on CUDA
tensors (``blocks`` co-resident blocks of ``warps`` warps on one pair, a
pipelined wavefront of 32-row bands) and runs its plain PyTorch version
on CPU tensors.  :func:`score_count_fold`, :func:`score_fold`,
:func:`last_row`, :func:`fill_arrows_fold_batch` (and
:func:`nw_tpu_torch.ops.fill_banded.fill_arrows_banded_single`) and
:func:`fill_codes_single` run the W-warp pipeline across the grid
(``single_pipe_kernel``, a mode each: bands hand off through shared
memory inside a block and through one device-memory row between blocks;
W and G from :func:`pipe_shape`); :func:`fill_codes_blocks` runs
``nw_refill_kernel`` and :func:`fill_tile` ``nw_single_kernel``, whose
bands hand off through L2, both at :data:`WARPS` warps a block:

* :func:`score_count_fold` — score and uint32 count, nothing stored per
  cell (``nw_score_count``; K8,
  ``nw_tpu/ops/fill_pallas_single.py:250``, ``score_count_fold`` at
  ``:335``);
* :func:`score_fold` — the score alone (``nw_score_single``; K11,
  ``nw_tpu/ops/fill_strips.py:62 strips_score``), optionally dumping
  every C-th row as checkpoints (K12,
  ``nw_tpu/ops/checkpoint_traceback.py:61 _make_ckpt_kernel``);
* :func:`fill_codes_single` — the 2-bit greedy codes of the whole pair
  and its corner score (``nw_fill_codes_single``; K14,
  ``nw_tpu/parallel/huge_pair.py:246 _make_fold_chunk_kernel_blocked``),
  or of the rows below a seed row (K13,
  ``nw_tpu/ops/checkpoint_traceback.py:153 _make_refill_kernel``, one
  block a launch);
* :func:`fill_codes_blocks` — K13's port as the checkpointed traceback
  runs it: G consecutive blocks of rows re-filled from their seed rows
  in one launch (``nw_refill_blocks``);
* :func:`last_row` — one pair's DP row ``H[len2, 0..len1]``
  (``nw_last_row``, the rows mode of ``nw_score_single``; K9,
  ``nw_tpu/ops/fill_pallas_single.py:83``, ``last_row_pallas`` at
  ``:169``), for :mod:`nw_tpu_torch.ops.hirschberg`;
* :func:`fill_arrows_fold_batch` — the rectangular tie masks, scores
  and fused counts of a batch of long pairs, one pair at a time with
  every SM on it (``nw_fill_masks``; K10,
  ``nw_tpu/ops/fill_pallas_single.py:422``, ``fill_arrows_fold_batch`` at
  ``:530``);
* :func:`fill_tile` — one tile of a pair whose rows are sharded over
  ranks, from its top halo and left edge to its right and bottom edges,
  with the rank's scores only or 2-bit codes (``nw_fill_tile``; K14's mesh
  half, ``nw_tpu/parallel/huge_pair.py:246``) or 3-bit tie masks (K28,
  ``nw_tpu/parallel/huge_pair.py:70 _make_fold_chunk_kernel``).

Each wrapper counts its launches: ``.launches``, and for the other modes
of a wrapper ``score_fold.ckpt_launches`` / ``fill_codes_single.seeded_launches``
/ ``fill_tile.score_launches`` and ``fill_tile.mask_launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nw_tpu_torch.ops.encode import PAD_SIDE
from nw_tpu_torch.ops.fill_scan import (
    U32, code_shape, diag_to_matrix, diag_to_matrix_batch, fill_diag, fill_diag_batch, fill_last_row,
    greedy_codes_from_arrows, pack_band_major,
)
from nw_tpu_torch.runtime import kernels

# warps a block (1..32) of nw_fill_tile (nw_single_kernel) and
# nw_refill_blocks, whose bands hand off through L2: the handoff, not
# issue, sets the pace (4 warps beat 8 on nw_score_count's old kernel at
# 20 kb, PERF.md section 6)
WARPS = 8
# warps an SM holds at once: the kernels' launch bounds cap a thread at 64
# registers, so 32 warps fill an SM's 65 536 (a cooperative launch of more
# is refused)
RESIDENT_WARPS_PER_SM = 32
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def check_pair(top, side, m, k, d, len1, len2, warps, blocks) -> Tuple[int, int]:
    """Validate one pair's inputs; returns the true (len1, len2)."""
    if top.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CPU or CUDA tensors expected, got {top.device}")
    if top.dim() != 1 or side.dim() != 1:
        raise ValueError("top / side must be 1-D")
    if top.dtype != torch.int32 or side.dtype != torch.int32:
        raise ValueError("int32 tensors expected")
    if side.device != top.device:
        raise ValueError("top and side must be on one device")
    if not all(INT32_MIN <= v <= INT32_MAX for v in (m, k, d)):
        raise ValueError(f"scoring ({m}, {k}, {d}) must fit int32")
    len1 = top.shape[0] if len1 is None else int(len1)
    len2 = side.shape[0] if len2 is None else int(len2)
    if not (0 <= len1 <= top.shape[0] and 0 <= len2 <= side.shape[0]):
        raise ValueError("lengths must lie in [0, len(top)] / [0, len(side)]")
    check_shape(warps, blocks)
    # the kernels' chunk counters are int32: bands * chunks < 2^31
    if (len2 // 32 + 1) * (len1 // 32 + 3) >= 2**31:
        raise ValueError(f"a {len1} x {len2} table is too large")
    return len1, len2


def check_shape(warps, blocks) -> None:
    """Validate a forced launch shape (None: the rule's)."""
    if warps is not None and not 1 <= warps <= 32:
        raise ValueError(f"warps must lie in [1, 32], not {warps}")
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be at least 1, not {blocks}")


def check_batch(tops, sides, lens1, lens2, *scoring):
    """Validate what the kernels index with: a length beyond its bucket
    would read outside the tensors.  ``scoring`` is (m, k, d), or Gotoh's
    (m, k, open, extend)."""
    if tops.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CPU or CUDA tensors expected, got {tops.device}")
    if tops.dim() != 2 or sides.dim() != 2 or tops.shape[0] != sides.shape[0]:
        raise ValueError("tops / sides must be [B, A] / [B, Bs]")
    for t in (tops, sides, lens1, lens2):
        if t.dtype != torch.int32:
            raise ValueError(f"int32 tensors expected, got {t.dtype}")
        if t.device != tops.device:
            raise ValueError("all inputs must be on one device")
    if lens1.shape != (tops.shape[0],) or lens2.shape != (tops.shape[0],):
        raise ValueError("lens must be [B]")
    if not all(INT32_MIN <= v <= INT32_MAX for v in scoring):
        raise ValueError(f"scoring {scoring} must fit int32")
    if tops.shape[0]:
        lo, hi = torch.aminmax(torch.stack([lens1, lens2]), dim=1)
        (lo1, lo2), (hi1, hi2) = lo.tolist(), hi.tolist()
        if min(lo1, lo2) < 0 or hi1 > tops.shape[1] or hi2 > sides.shape[1]:
            raise ValueError("lengths must lie in [0, bucket]")


def launch_shape(len2: int, warps: int, blocks: Optional[int], device) -> Tuple[int, int]:
    """(blocks, warps) of a ``nw_single_kernel`` launch (``nw_fill_tile``):
    by default one block an SM, no more than the tile's 32-row bands
    fill."""
    if blocks is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = max(1, min(sms, -(-len2 // (32 * warps))))
    return blocks, warps


def single_scratch(len1: int, len2: int, blocks: int, warps: int, device):
    """The scratch of a ``nw_single_kernel`` launch (``nw_fill_tile``):
    the ring of boundary rows its band pipeline hands down (one per
    warp, no more than there are bands), the zeroed per-warp chunk
    counters, and the one-element score."""
    rows = max(1, min(blocks * warps, -(-len2 // 32)))
    ring = torch.empty((rows, len1 + 1), dtype=torch.int32, device=device)
    done = torch.zeros(blocks * warps, dtype=torch.int32, device=device)
    score = torch.empty(1, dtype=torch.int32, device=device)
    return ring, done, score


def pipe_shape(len1: int, len2: int, device, warps=None, blocks=None) -> Tuple[int, int]:
    """(blocks, warps) of a single-pipeline launch (every mode of
    ``single_pipe_kernel``) on an (len1, len2) pair: by default the
    rule's (:func:`~nw_tpu_torch.ops.fill_banded.single_warps`,
    ``single_blocks``) where not forced (:func:`check_pair` checks a
    forced shape)."""
    from nw_tpu_torch.ops import fill_banded as fb  # fill_banded imports this module

    if warps is None:
        warps = fb.single_warps(len1, len2, fb._sms(device))
    if blocks is None:
        blocks = fb.single_blocks(len2, warps, fb._sms(device))
    return blocks, warps


def pipe_scratch(len1: int, blocks: int, warps: int, cell: int, device, masks: bool = False):
    """The scratch of a single-pipeline launch of ``blocks`` blocks of
    ``warps`` warps: (top16, bnd, flags).  top16 is the blocks' int16 rows
    of the staged top string, or None where it fits shared memory beside
    the warps' rings (with ``masks``, ``nw_fill_masks``'s, their rings of
    tie masks too; :func:`~nw_tpu_torch.ops.fill_banded._top_scratch`);
    bnd the blocks' boundary rows, int32[blocks, len1+1, cell/4] (row g
    the row above block g's first warp: a score a column, with counts a
    score and a count); flags the blocks' zeroed chunk counters."""
    from nw_tpu_torch.ops import fill_banded as fb

    top16 = fb._top_scratch(blocks, len1, cell, device, warps, masks)
    bnd = torch.empty((blocks, len1 + 1, cell // 4), dtype=torch.int32, device=device)
    flags = torch.zeros(blocks, dtype=torch.int32, device=device)
    return top16, bnd, flags


def score_count_fold(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
    len1: Optional[int] = None, len2: Optional[int] = None,
    warps: Optional[int] = None, blocks: Optional[int] = None,
) -> Tuple[int, int]:
    """(optimal score, solution count mod 2^32) of one pair.

    top / side: int32[A] / int32[Bs] encoded strings (padding past the
    true lengths is ignored); len1 / len2 default to A / Bs.  ``warps``
    (a block) and ``blocks`` default to :func:`pipe_shape`'s rule.
    """
    len1, len2 = check_pair(top, side, m, k, d, len1, len2, warps, blocks)
    if top.device.type == "cpu":
        return score_count_fold_plain(top, side, m, k, d, len1, len2)
    dev = top.device
    top = top[:len1].contiguous()
    side = side[:len2].contiguous()
    blocks, warps = pipe_shape(len1, len2, dev, warps, blocks)
    top16, bnd, flags = pipe_scratch(len1, blocks, warps, 8, dev)  # a score and a count a cell
    score = torch.empty(1, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    kernels.launch(
        "nw_score_count", dev,
        top.data_ptr(), side.data_ptr(), len1, len2, m, k, d, blocks, warps,
        None if top16 is None else top16.data_ptr(), bnd.data_ptr(), flags.data_ptr(),
        score.data_ptr(), count.data_ptr(),
    )
    score_count_fold.launches += 1
    return int(score.item()), int(count.item()) & U32


score_count_fold.launches = 0


def score_count_fold_plain(top, side, m, k, d, len1=None, len2=None) -> Tuple[int, int]:
    """Plain version of :func:`score_count_fold`: the anti-diagonal fill
    with counts and nothing stored."""
    out = fill_diag(top, side, m, k, d, len1, len2, with_arrows=False, with_counts=True)
    return int(out["score"]), int(out["count"])


# ---------------- K11 / K12: the score, checkpoint rows ----------------


def checkpoint_rows(len2: int, every: int) -> int:
    """Rows 0, C, 2C, ... below row ``len2``: ceil(len2 / C)."""
    return -(-len2 // every)


def score_fold(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
    len1: Optional[int] = None, len2: Optional[int] = None,
    checkpoint_every: Optional[int] = None, warps: Optional[int] = None,
    blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(score, checkpoints) of one pair: the score as an int32 0-d tensor
    on the pair's device, and with ``checkpoint_every`` = C (a multiple of
    32) the rows 0, C, 2C, ... below row len2, int32[ceil(len2/C), len1+1]
    (else None).

    The K11 port (``nw_tpu/ops/fill_strips.py:62``) without checkpoints,
    the K12 port (``nw_tpu/ops/checkpoint_traceback.py:61``) with them:
    the TPU kernel dumps its rolling anti-diagonal state every C
    diagonals, the port a DP row every C rows.  ``nw_score_single``, the
    single-pair pipeline's rows mode, copies each checkpoint row out of
    the ring that hands it to the band below.  top / side / len1 / len2
    / ``warps`` / ``blocks`` as :func:`score_count_fold`.
    """
    len1, len2 = check_pair(top, side, m, k, d, len1, len2, warps, blocks)
    C = checkpoint_every
    if C is not None and (C < 32 or C % 32):
        raise ValueError(f"checkpoint_every must be a positive multiple of 32, not {C}")
    if top.device.type == "cpu":
        return score_fold_plain(top, side, m, k, d, len1, len2, C)
    dev = top.device
    top = top[:len1].contiguous()
    side = side[:len2].contiguous()
    blocks, warps = pipe_shape(len1, len2, dev, warps, blocks)
    top16, bnd, flags = pipe_scratch(len1, blocks, warps, 4, dev)  # a score a cell
    score = torch.empty(1, dtype=torch.int32, device=dev)
    ckpt = (
        torch.empty((checkpoint_rows(len2, C), len1 + 1), dtype=torch.int32, device=dev)
        if C is not None else None
    )
    kernels.launch(
        "nw_score_single", dev,
        top.data_ptr(), side.data_ptr(), len1, len2, m, k, d, blocks, warps,
        None if top16 is None else top16.data_ptr(), bnd.data_ptr(), flags.data_ptr(),
        ckpt.data_ptr() if C is not None and len2 else None, C or 0,
        score.data_ptr(),
    )
    if C is None:
        score_fold.launches += 1
    else:
        score_fold.ckpt_launches += 1
    return score[0], ckpt


score_fold.launches = 0
score_fold.ckpt_launches = 0


def score_fold_plain(top, side, m, k, d, len1=None, len2=None, checkpoint_every=None):
    """Plain version of :func:`score_fold`: the anti-diagonal fill; with
    checkpoint rows, :func:`~nw_tpu_torch.ops.fill_scan.fill_last_row`'s
    rows every C, whose last row holds the corner."""
    len1 = top.shape[0] if len1 is None else len1
    len2 = side.shape[0] if len2 is None else len2
    if checkpoint_every is None:
        return fill_diag(top[:len1], side[:len2], m, k, d, with_arrows=False)["score"], None
    rows = fill_last_row(top[:len1], side[:len2], m, k, d, every=checkpoint_every)
    return rows[-1, len1], rows[:-1]


# ---------------- K9: one pair's last row ----------------


def last_row(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
    len1: Optional[int] = None, len2: Optional[int] = None,
    warps: Optional[int] = None, blocks: Optional[int] = None,
) -> torch.Tensor:
    """int32[len1+1]: row ``len2`` of one pair's table, ``H[len2, 0..len1]``,
    in O(len1 + len2) device memory, for Hirschberg's split.

    The K9 port (``nw_tpu/ops/fill_pallas_single.py:83 _make_kernel``,
    ``last_row_pallas`` at ``:169``): ``nw_last_row``, the single-pair
    pipeline's rows mode (the lane of row len2 stores it), on CUDA
    tensors; :func:`last_row_plain` on CPU tensors.  Row 0 and column 0
    are written explicitly, so the row is ``fill_scan``'s at every
    scoring (K9's rests on its NEG_INF decay).  Arguments as
    :func:`score_count_fold`.
    """
    len1, len2 = check_pair(top, side, m, k, d, len1, len2, warps, blocks)
    if top.device.type == "cpu":
        return last_row_plain(top, side, m, k, d, len1, len2)
    dev = top.device
    top = top[:len1].contiguous()
    side = side[:len2].contiguous()
    blocks, warps = pipe_shape(len1, len2, dev, warps, blocks)
    top16, bnd, flags = pipe_scratch(len1, blocks, warps, 4, dev)  # a score a cell
    score = torch.empty(1, dtype=torch.int32, device=dev)
    row = torch.empty(len1 + 1, dtype=torch.int32, device=dev)
    kernels.launch(
        "nw_last_row", dev,
        top.data_ptr(), side.data_ptr(), len1, len2, m, k, d, blocks, warps,
        None if top16 is None else top16.data_ptr(), bnd.data_ptr(), flags.data_ptr(),
        row.data_ptr(), score.data_ptr(),
    )
    last_row.launches += 1
    return row


last_row.launches = 0


def last_row_plain(top, side, m, k, d, len1=None, len2=None) -> torch.Tensor:
    """Plain version of :func:`last_row`:
    :func:`~nw_tpu_torch.ops.fill_scan.fill_last_row`."""
    len1 = top.shape[0] if len1 is None else len1
    return fill_last_row(top[:len1], side, m, k, d, len1, len2)


# ---------------- K10: tie masks of a batch of long pairs ----------------


def fill_arrows_fold_batch(
    tops, sides, lens1, lens2, m, k, d, warps: Optional[int] = None, blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(masks uint8[B, Bs+1, A+1], scores int32[B], counts int64[B] in
    [0, 2^32)): the rectangular tie masks of a batch, in the
    layout of :func:`nw_tpu_torch.ops.fill_banded.fill_masks_banded_batch`
    (0 outside each true table), one pair at a time.

    The K10 port (``nw_tpu/ops/fill_pallas_single.py:422
    _make_arrows_kernel``, ``fill_arrows_fold_batch`` at ``:530``): each
    pair's table goes through ``nw_fill_masks`` (the single-pair
    pipeline's masks mode, every SM on the pair, the fused count with it)
    straight into its slice of the batch's table (rows of A+1 bytes), on
    CUDA tensors; :func:`fill_arrows_fold_batch_plain` on CPU tensors.
    ``warps`` / ``blocks`` force every pair's shape, else each takes
    :func:`pipe_shape`'s rule.
    """
    check_batch(tops, sides, lens1, lens2, m, k, d)
    check_shape(warps, blocks)
    if tops.device.type == "cpu":
        return fill_arrows_fold_batch_plain(tops, sides, lens1, lens2, m, k, d)
    B, A = tops.shape
    Bs = sides.shape[1]
    dev = tops.device
    masks = torch.zeros((B, Bs + 1, A + 1), dtype=torch.uint8, device=dev)
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    for b, (l1, l2) in enumerate(zip(lens1.tolist(), lens2.tolist())):
        check_pair(tops[b], sides[b], m, k, d, l1, l2, warps, blocks)
        top = tops[b, :l1].contiguous()
        side = sides[b, :l2].contiguous()
        nb, nw = pipe_shape(l1, l2, dev, warps, blocks)
        top16, bnd, flags = pipe_scratch(l1, nb, nw, 8, dev, masks=True)
        kernels.launch(
            "nw_fill_masks", dev,
            top.data_ptr(), side.data_ptr(), l1, l2, m, k, d, nb, nw,
            None if top16 is None else top16.data_ptr(), bnd.data_ptr(), flags.data_ptr(),
            masks[b].data_ptr(), A + 1, None, scores[b:].data_ptr(), counts[b:].data_ptr(),
        )
        fill_arrows_fold_batch.launches += 1
    return masks, scores, counts.to(torch.int64) & U32


fill_arrows_fold_batch.launches = 0


def fill_arrows_fold_batch_plain(tops, sides, lens1, lens2, m, k, d):
    """Plain version of :func:`fill_arrows_fold_batch`: each pair through
    :func:`fill_arrows_banded_single_plain` into its slice."""
    B, A = tops.shape
    Bs = sides.shape[1]
    masks = torch.zeros((B, Bs + 1, A + 1), dtype=torch.uint8, device=tops.device)
    scores, counts = [], []
    for b, (l1, l2) in enumerate(zip(lens1.tolist(), lens2.tolist())):
        mk, _, score, count = fill_arrows_banded_single_plain(tops[b, :l1], sides[b, :l2], m, k, d)
        masks[b, : l2 + 1, : l1 + 1] = mk
        scores.append(score)
        counts.append(count)
    scores = torch.tensor(scores, dtype=torch.int32, device=tops.device)
    return masks, scores, torch.tensor(counts, dtype=torch.int64, device=tops.device)


def fill_arrows_banded_single_plain(
    top, side, m, k, d, len1=None, len2=None, with_scores: bool = False
):
    """Plain version of :func:`nw_tpu_torch.ops.fill_banded.fill_arrows_banded_single`
    (one pair's ``nw_fill_masks``): the anti-diagonal fill of the pair,
    turned into rectangles."""
    len1 = top.shape[0] if len1 is None else len1
    len2 = side.shape[0] if len2 is None else len2
    out = fill_diag(
        top, side, m, k, d, len1, len2, with_counts=True, with_scores=with_scores
    )
    masks = diag_to_matrix(out["arrows"], len1, len2)
    scores = diag_to_matrix(out["scores"], len1, len2) if with_scores else None
    return masks, scores, int(out["score"]), int(out["count"])


# ---------------- K14 / K13: greedy codes, whole or from a seed ----------------


def fill_codes_single(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
    len1: Optional[int] = None, len2: Optional[int] = None,
    r0: int = 0, seed: Optional[torch.Tensor] = None,
    warps: Optional[int] = None, blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, score): the 2-bit greedy codes of rows r0+1 .. len2 of one
    pair and ``H[len2][len1]`` as an int32 0-d tensor.

    Without ``seed`` (r0 = 0) this is the K14 port
    (``nw_tpu/parallel/huge_pair.py:246``): the whole pair's codes,
    int32[1, ceil(len2/32), TW, 32] in the band-major layout of
    :mod:`nw_tpu_torch.ops.fill_banded`, bit-equal to ``nw_fill_codes``'s
    for the pair at buckets (len1, len2), and its corner score.  With
    ``seed`` int32[>= len1+1], the scores of row ``r0`` of the pair, it
    is the K13 port (``nw_tpu/ops/checkpoint_traceback.py:153``) a block
    a launch: the codes of rows r0+1 .. len2 in the same layout (code
    row j - r0 - 1), as if ``side[r0:len2]`` were the whole side string
    and the seed its row 0; column 0 stays ``-j*d`` with the pair's row
    j.  (The checkpointed traceback re-fills its blocks G at a time,
    :func:`fill_codes_blocks`.)  Other arguments as
    :func:`score_count_fold`.
    """
    len1, len2 = check_pair(top, side, m, k, d, len1, len2, warps, blocks)
    if not 0 <= r0 <= len2:
        raise ValueError(f"r0 must lie in [0, len2], not {r0}")
    if (seed is None) != (r0 == 0):
        raise ValueError("a seed row is given exactly when r0 > 0")
    if seed is not None and (
        seed.dim() != 1 or seed.dtype != torch.int32 or seed.shape[0] < len1 + 1
        or seed.device != top.device
    ):
        raise ValueError("seed must be int32[>= len1+1] on the pair's device")
    if top.device.type == "cpu":
        return fill_codes_single_plain(top, side, m, k, d, len1, len2, r0, seed)
    dev = top.device
    top = top[:len1].contiguous()
    side = side[r0:len2].contiguous()
    rows = len2 - r0
    blocks, warps = pipe_shape(len1, rows, dev, warps, blocks)
    top16, bnd, flags = pipe_scratch(len1, blocks, warps, 4, dev)  # a score a cell
    score = torch.empty(1, dtype=torch.int32, device=dev)
    codes = torch.empty(code_shape(1, len1, rows), dtype=torch.int32, device=dev)
    seed = None if seed is None else seed[: len1 + 1].contiguous()
    kernels.launch(
        "nw_fill_codes_single", dev,
        top.data_ptr(), side.data_ptr(), len1, rows, r0,
        None if seed is None else seed.data_ptr(), m, k, d, blocks, warps,
        None if top16 is None else top16.data_ptr(), bnd.data_ptr(), flags.data_ptr(),
        codes.data_ptr(), score.data_ptr(),
    )
    if seed is None:
        fill_codes_single.launches += 1
    else:
        fill_codes_single.seeded_launches += 1
    return codes, score[0]


fill_codes_single.launches = 0
fill_codes_single.seeded_launches = 0


def fill_codes_single_plain(top, side, m, k, d, len1=None, len2=None, r0=0, seed=None):
    """Plain version of :func:`fill_codes_single`: the anti-diagonal fill
    of rows r0+1 .. len2 from the seed row (``fill_diag(..., seed=,
    row0=)``), its tie masks turned into greedy codes."""
    len1 = top.shape[0] if len1 is None else len1
    len2 = side.shape[0] if len2 is None else len2
    out = fill_diag(
        top[:len1], side[r0:len2], m, k, d,
        seed=None if seed is None else seed[: len1 + 1], row0=r0,
    )
    return greedy_codes_from_arrows(out["arrows"][None]), out["score"]


# ---------------- K13, grouped: many blocks of one pair in one launch ----------------


def resident_warps(device) -> int:
    """Warps a cooperative single-pair launch can hold on ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count * RESIDENT_WARPS_PER_SM


def fill_codes_blocks(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
    len1: int, len2: int, r0: int, C: int, seeds: torch.Tensor,
    warps: int = WARPS, blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, corners): rows r0+1 .. len2 of one pair re-filled in G =
    ceil((len2 - r0) / C) blocks of C rows, block g from its seed row
    ``seeds[g]``, the pair's row r0 + g*C.

    codes is int32[1, ceil((len2-r0)/32), TW, 32] in the band-major
    layout of :func:`fill_codes_single`: block g's bands start at band
    g*C/32, and its slice is what :func:`fill_codes_single` writes for
    rows r0+g*C+1 .. min(len2, r0+(g+1)*C) from the same seed.  corners
    int32[G] holds each block's last cell, H[min(len2, r0+(g+1)*C)][len1].
    C is a multiple of 32; seeds int32[G, >= len1+1] (row 0 where r0 is
    0: ``score_fold``'s checkpoint rows ckpt[r0/C : ...] as they are).

    The K13 port (``nw_tpu/ops/checkpoint_traceback.py:153``) as
    ``traceback_checkpointed`` runs it: every band of the G blocks in one
    cooperative launch of ``nw_refill_blocks`` (``blocks`` x ``warps``
    warps; by default as many blocks as the bands fill, no more than
    the card holds at once) on CUDA tensors;
    :func:`fill_codes_blocks_plain` on CPU tensors.
    """
    len1, len2 = check_pair(top, side, m, k, d, len1, len2, warps, blocks)
    if C < 32 or C % 32:
        raise ValueError(f"C must be a positive multiple of 32, not {C}")
    if not 0 <= r0 < len2:
        raise ValueError(f"r0 must lie in [0, len2), not {r0}")
    G = -(-(len2 - r0) // C)
    if (
        seeds.dim() != 2 or seeds.shape[0] != G or seeds.shape[1] < len1 + 1
        or seeds.dtype != torch.int32 or seeds.device != top.device
    ):
        raise ValueError(f"seeds must be int32[{G}, >= {len1 + 1}] on the pair's device")
    if top.device.type == "cpu":
        return fill_codes_blocks_plain(top, side, m, k, d, len1, len2, r0, C, seeds)
    dev = top.device
    top = top[:len1].contiguous()
    side = side[r0:len2].contiguous()
    seeds = seeds[:, : len1 + 1].contiguous()
    rows = len2 - r0
    nbands = -(-rows // 32)
    if blocks is None:
        blocks = max(1, min(-(-nbands // warps), resident_warps(dev) // warps))
    P = blocks * warps
    ring = torch.empty((G * min(P, C // 32), len1 + 1), dtype=torch.int32, device=dev)
    done = torch.zeros(P, dtype=torch.int32, device=dev)
    codes = torch.empty(code_shape(1, len1, rows), dtype=torch.int32, device=dev)
    corners = torch.empty(G, dtype=torch.int32, device=dev)
    kernels.launch(
        "nw_refill_blocks", dev,
        top.data_ptr(), side.data_ptr(), len1, rows, C, r0, seeds.data_ptr(), m, k, d,
        blocks, warps, ring.data_ptr(), done.data_ptr(), codes.data_ptr(), corners.data_ptr(),
    )
    fill_codes_blocks.launches += 1
    return codes, corners


fill_codes_blocks.launches = 0


PLAIN_BLOCK_BYTES = 1 << 30  # tie masks the plain grouped re-fill holds at once


def fill_codes_blocks_plain(top, side, m, k, d, len1, len2, r0, C, seeds):
    """Plain version of :func:`fill_codes_blocks`: the blocks filled side
    by side as a batch of tables of their own (``fill_diag_batch``, each
    with its seed row as row 0 and its column 0, ``-j*d`` with the
    pair's row j, as its left edge; as many at once as
    :data:`PLAIN_BLOCK_BYTES` of tie masks hold), the masks turned into
    greedy codes, rows past a short last block's end 0, the blocks'
    bands one after another."""
    dev = top.device
    starts = list(range(r0, len2, C))
    at_once = max(1, PLAIN_BLOCK_BYTES // ((len1 + C + 1) * (C + 1)))
    j = torch.arange(1, C + 1, dtype=torch.int64, device=dev)
    codes, corners = [], []
    for lo in range(0, len(starts), at_once):
        part = starts[lo : lo + at_once]
        G = len(part)
        rows = [min(C, len2 - b0) for b0 in part]
        sides = torch.full((G, C), PAD_SIDE, dtype=torch.int32, device=dev)
        for g, (b0, n) in enumerate(zip(part, rows)):
            sides[g, :n] = side[b0 : b0 + n]
        left = -(torch.tensor(part, dtype=torch.int64, device=dev)[:, None] + j) * d
        left = ((left + 2**31) % 2**32 - 2**31).to(torch.int32)  # wrapped as int32
        rows_t = torch.tensor(rows, dtype=torch.int32, device=dev)
        out = fill_diag_batch(
            top[:len1].expand(G, len1), sides, torch.full_like(rows_t, len1), rows_t, m, k, d,
            seed=seeds[lo : lo + G, : len1 + 1], left=left,
        )
        rect = diag_to_matrix_batch(out["arrows"])[:, 1:]  # rows 1..C of each block
        code = torch.where((rect & 1) != 0, 0, torch.where((rect & 2) != 0, 1, 2)).to(torch.uint8)
        code[torch.arange(C, device=dev)[None, :] >= rows_t[:, None].to(torch.int64)] = 0
        codes.append(pack_band_major(code, 2).flatten(0, 1))
        corners.append(out["score"])
    nbands = -(-(len2 - r0) // 32)
    return torch.cat(codes)[None, :nbands], torch.cat(corners).to(torch.int32)


# ---------------- K14's mesh half / K28: one tile of a sharded pair ----------------


def _check_tile(top, side, m, k, d, c0, C, halo, left, codes, masks, warps, blocks) -> None:
    A, H = top.shape[0], side.shape[0]
    check_pair(top, side, m, k, d, None, None, warps, blocks)
    if H < 1 or not (0 <= c0 and C >= 0 and c0 + C <= A):
        raise ValueError(f"a tile needs rows and columns ({c0}, {c0 + C}] inside [0, {A}]")
    for name, t, n in (("halo", halo, C + 1), ("left", left, H)):
        if t.shape != (n,) or t.dtype != torch.int32 or t.device != top.device:
            raise ValueError(f"{name} must be int32[{n}] on the pair's device")
    if codes is not None and masks is not None:
        raise ValueError("a tile emits codes or masks, not both")
    if codes is not None and (
        tuple(codes.shape) != code_shape(1, A, H) or codes.dtype != torch.int32
        or codes.device != top.device or not codes.is_contiguous()
    ):
        raise ValueError(f"codes must be contiguous int32{list(code_shape(1, A, H))} on the pair's device")
    if masks is not None and (
        tuple(masks.shape) != (H, A + 1) or masks.dtype != torch.uint8
        or masks.device != top.device or not masks.is_contiguous()
    ):
        raise ValueError(f"masks must be contiguous uint8[{H}, {A + 1}] on the pair's device")


def fill_tile(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int, c0: int, C: int,
    halo: torch.Tensor, left: torch.Tensor,
    codes: Optional[torch.Tensor] = None, masks: Optional[torch.Tensor] = None,
    warps: int = WARPS, blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fill rows r0+1 .. r0+H, columns c0+1 .. c0+C of one pair:
    (right, bottom, score).

    top: int32[A], the pair's whole top string; side: int32[H], its rows
    r0+1 .. r0+H; halo: int32[C+1], row r0 at columns c0 .. c0+C (the
    corner first); left: int32[H], column c0 at rows r0+1 .. r0+H.
    Returns right int32[H] (column c0+C), bottom int32[C] (row r0+H at
    columns c0+1 .. c0+C) and the score of cell (r0+H, c0+C), a 0-d
    tensor.  With ``codes`` (int32[1, ceil(H/32), TW, 32] of
    :func:`~nw_tpu_torch.ops.fill_scan.code_shape` at (A, H), zeroed
    before the rank's first tile) the tile ORs its cells' 2-bit greedy
    codes in, code row j - r0 - 1 at the pair's column; with ``masks``
    (uint8[H, A+1]) it writes their tie masks.  The tile with c0 = 0
    also stores column 0 (UP); row r0 is the halo, not the tile's.

    K14's mesh half (scores, codes; ``nw_tpu/parallel/huge_pair.py:246``)
    and K28 (masks; ``:70``) as the ``nw_fill_tile`` kernel on CUDA
    tensors, :func:`fill_tile_plain` on CPU tensors.
    """
    _check_tile(top, side, m, k, d, c0, C, halo, left, codes, masks, warps, blocks)
    if top.device.type == "cpu":
        return fill_tile_plain(top, side, m, k, d, c0, C, halo, left, codes, masks)
    dev = top.device
    H = side.shape[0]
    top, side, halo, left = (t.contiguous() for t in (top, side, halo, left))
    blocks, warps = launch_shape(H, warps, blocks, dev)
    ring, done, score = single_scratch(C, H, blocks, warps, dev)
    right = torch.empty(H, dtype=torch.int32, device=dev)
    bottom = torch.empty(max(C, 1), dtype=torch.int32, device=dev)
    kernels.launch(
        "nw_fill_tile", dev,
        top.data_ptr(), side.data_ptr(), top.shape[0], C, H, c0, halo.data_ptr(),
        left.data_ptr(), m, k, d, blocks, warps, ring.data_ptr(), done.data_ptr(),
        None if codes is None else codes.data_ptr(),
        None if masks is None else masks.data_ptr(),
        right.data_ptr(), bottom.data_ptr(), score.data_ptr(),
    )
    if codes is not None:
        fill_tile.launches += 1
    elif masks is not None:
        fill_tile.mask_launches += 1
    else:
        fill_tile.score_launches += 1
    return right, bottom[:C], score[0]


fill_tile.launches = 0
fill_tile.score_launches = 0
fill_tile.mask_launches = 0


def fill_tile_plain(top, side, m, k, d, c0, C, halo, left, codes=None, masks=None):
    """Plain version of :func:`fill_tile`: the anti-diagonal fill of the
    tile as a table of its own (``fill_diag`` with the halo as its row 0
    and the left edge as its column 0, keeping its edges and tie masks,
    not its scores), the masks and greedy codes written into the rank's
    tables, the codes packed a window of columns at a time."""
    H = side.shape[0]
    emit = codes is not None or masks is not None
    out = fill_diag(
        top[c0 : c0 + C], side, m, k, d, seed=halo, left=left,
        with_arrows=emit, with_edges=True,
    )
    if emit:
        cmin = 1 if c0 > 0 else 0  # column c0 is the last tile's
        arr = diag_to_matrix_batch(out.pop("arrows")[None])[0, 1:, cmin:]
        if masks is not None:
            masks[:, c0 + cmin : c0 + C + 1] = arr
        else:
            _or_codes(codes, arr, c0 + cmin)
    return out["right"], out["bottom"], out["score"]


CODE_WINDOW = 8192  # columns packed at once (a multiple of 16): bounds the packing's int64 words


def _or_codes(codes, arr, first):
    """OR the greedy codes of tie masks ``arr`` (uint8[H, n], columns
    ``first`` ..) into the band-major ``codes``, a window of columns at a
    time: a window from column w0 (a multiple of 16) packs into the
    table's words from w0/16 on."""
    H, n = arr.shape
    for w0 in range(first // 16 * 16, first + n, CODE_WINDOW):
        lo, hi = max(w0, first), min(w0 + CODE_WINDOW, first + n)
        a = arr[:, lo - first : hi - first]
        code = torch.zeros((1, H, hi - w0), dtype=torch.uint8, device=arr.device)
        code[0, :, lo - w0 :] = (2 - ((a >> 1) & 1)) * (1 - (a & 1))  # DIAG 0, LEFT 1, UP 2
        words = pack_band_major(code, 2)
        w = w0 // 16
        cnt = min(words.shape[2], codes.shape[2] - w)
        codes[:, :, w : w + cnt] |= words[:, :, :cnt]