"""Single-pair fills: the ports of K8, K11, K12, K13 and K14.

All launch modes of one kernel template (``csrc/nw_single.cu``:
``blocks`` co-resident blocks of ``warps`` warps on the pair, a pipelined
wavefront of 32-row bands) on CUDA tensors, and run their plain PyTorch
versions on CPU tensors:

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
  ``nw_tpu/ops/checkpoint_traceback.py:153 _make_refill_kernel``);
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

from nw_tpu_torch.ops.fill_scan import (
    U32, code_shape, diag_to_matrix_batch, fill_diag, fill_last_row, greedy_codes_from_arrows,
    pack_band_major,
)
from nw_tpu_torch.runtime import kernels

WARPS = 8  # warps a block (1..32): past ~8 an SM is issue-bound
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
    if not 1 <= warps <= 32:
        raise ValueError(f"warps must lie in [1, 32], not {warps}")
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be at least 1, not {blocks}")
    # the kernels' chunk counters are int32: bands * chunks < 2^31
    if (len2 // 32 + 1) * (len1 // 32 + 3) >= 2**31:
        raise ValueError(f"a {len1} x {len2} table is too large")
    return len1, len2


def launch_shape(len2: int, warps: int, blocks: Optional[int], device) -> Tuple[int, int]:
    """(blocks, warps) of a single-pair launch: by default one block an
    SM, no more than the pair's 32-row bands fill."""
    if blocks is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = max(1, min(sms, -(-len2 // (32 * warps))))
    return blocks, warps


def single_scratch(len1: int, len2: int, blocks: int, warps: int, device,
                   with_counts: bool = True):
    """The ring of boundary rows (scores, and counts when asked) one
    pair's band pipeline hands down (one per warp, no more than there
    are bands), the zeroed per-warp chunk counters, and the two
    one-element outputs."""
    rows = max(1, min(blocks * warps, -(-len2 // 32)))
    ring = torch.empty((rows, len1 + 1), dtype=torch.int32, device=device)
    cring = (
        torch.empty((rows, len1 + 1), dtype=torch.int32, device=device)
        if with_counts else None
    )
    done = torch.zeros(blocks * warps, dtype=torch.int32, device=device)
    score = torch.empty(1, dtype=torch.int32, device=device)
    count = torch.empty(1, dtype=torch.int32, device=device)
    return ring, cring, done, score, count


def score_count_fold(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
    len1: Optional[int] = None, len2: Optional[int] = None,
    warps: int = WARPS, blocks: Optional[int] = None,
) -> Tuple[int, int]:
    """(optimal score, solution count mod 2^32) of one pair.

    top / side: int32[A] / int32[Bs] encoded strings (padding past the
    true lengths is ignored); len1 / len2 default to A / Bs.  ``blocks``
    defaults to one an SM, as many as the pair's bands fill.
    """
    len1, len2 = check_pair(top, side, m, k, d, len1, len2, warps, blocks)
    if top.device.type == "cpu":
        return score_count_fold_plain(top, side, m, k, d, len1, len2)
    dev = top.device
    top = top[:len1].contiguous()
    side = side[:len2].contiguous()
    blocks, warps = launch_shape(len2, warps, blocks, dev)
    ring, cring, done, score, count = single_scratch(len1, len2, blocks, warps, dev)
    kernels.launch(
        "nw_score_count", dev,
        top.data_ptr(), side.data_ptr(), len1, len2, m, k, d, blocks, warps,
        ring.data_ptr(), cring.data_ptr(), done.data_ptr(),
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
    checkpoint_every: Optional[int] = None, warps: int = WARPS,
    blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(score, checkpoints) of one pair: the score as an int32 0-d tensor
    on the pair's device, and with ``checkpoint_every`` = C (a multiple of
    32) the rows 0, C, 2C, ... below row len2, int32[ceil(len2/C), len1+1]
    (else None).

    The K11 port (``nw_tpu/ops/fill_strips.py:62``) without checkpoints,
    the K12 port (``nw_tpu/ops/checkpoint_traceback.py:61``) with them:
    the TPU kernel dumps its rolling anti-diagonal state every C
    diagonals, the port a DP row every C rows.  Arguments as
    :func:`score_count_fold`.
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
    blocks, warps = launch_shape(len2, warps, blocks, dev)
    ring, _, done, score, _ = single_scratch(len1, len2, blocks, warps, dev, with_counts=False)
    ckpt = (
        torch.empty((checkpoint_rows(len2, C), len1 + 1), dtype=torch.int32, device=dev)
        if C is not None else None
    )
    kernels.launch(
        "nw_score_single", dev,
        top.data_ptr(), side.data_ptr(), len1, len2, m, k, d, blocks, warps,
        ring.data_ptr(), done.data_ptr(),
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


# ---------------- K14 / K13: greedy codes, whole or from a seed ----------------


def fill_codes_single(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
    len1: Optional[int] = None, len2: Optional[int] = None,
    r0: int = 0, seed: Optional[torch.Tensor] = None,
    warps: int = WARPS, blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, score): the 2-bit greedy codes of rows r0+1 .. len2 of one
    pair and ``H[len2][len1]`` as an int32 0-d tensor.

    Without ``seed`` (r0 = 0) this is the K14 port
    (``nw_tpu/parallel/huge_pair.py:246``): the whole pair's codes,
    int32[1, ceil(len2/32), TW, 32] in the band-major layout of
    :mod:`nw_tpu_torch.ops.fill_banded`, bit-equal to ``nw_fill_codes``'s
    for the pair at buckets (len1, len2), and its corner score.  With
    ``seed`` int32[>= len1+1], the scores of row ``r0`` of the pair, it
    is the K13 port (``nw_tpu/ops/checkpoint_traceback.py:153``): the
    codes of rows r0+1 .. len2 in the same layout (code row j - r0 - 1),
    as if ``side[r0:len2]`` were the whole side string and the seed its
    row 0; column 0 stays ``-j*d`` with the pair's row j.  Other
    arguments as :func:`score_count_fold`.
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
    blocks, warps = launch_shape(rows, warps, blocks, dev)
    ring, _, done, score, _ = single_scratch(len1, rows, blocks, warps, dev, with_counts=False)
    codes = torch.empty(code_shape(1, len1, rows), dtype=torch.int32, device=dev)
    seed = None if seed is None else seed[: len1 + 1].contiguous()
    kernels.launch(
        "nw_fill_codes_single", dev,
        top.data_ptr(), side.data_ptr(), len1, rows, r0,
        None if seed is None else seed.data_ptr(), m, k, d, blocks, warps,
        ring.data_ptr(), done.data_ptr(), codes.data_ptr(), score.data_ptr(),
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
    ring, _, done, score, _ = single_scratch(C, H, blocks, warps, dev, with_counts=False)
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