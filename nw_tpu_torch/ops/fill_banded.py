"""Banded fills: the ports of TPU kernels K1 and K2.

Counterpart of ``nw_tpu/ops/fill_pallas_banded.py``.  Four wrappers,
each with its plain PyTorch version in this module:

* :func:`fill_scores_banded_batch` — int32 corner scores at any side
  length (``nw_scores``, the K1 port);
* :func:`fill_scores_counts_banded_batch` — scores and uint32 solution
  counts with nothing stored per cell (``nw_fill_codes`` without codes,
  K2's ``with_words=False`` mode);
* :func:`fill_greedy_counts_banded_batch` — the 2-bit greedy code of
  every cell, scores, and optionally counts (``nw_fill_codes``, K2's
  ``pack_bits=2`` / ``with_counts`` modes);
* :func:`fill_masks_banded_batch` — the rectangular 3-bit tie masks of
  a batch, scores and optionally counts (``nw_fill_masks_batch``, the
  ``MASKS`` mode of ``csrc/nw_fill.cu``'s pipeline; K2's batched
  ``pack_bits=8`` mode);
* :func:`fill_runs_banded_batch` — the rectangular run bytes of a batch
  (greedy code and same-code run length a cell, for the run-skip walk),
  scores and optionally counts (``nw_fill_runs_batch``, the ``RUNS``
  mode of ``csrc/nw_fill.cu``'s pipeline; K2's ``with_runs`` mode);
* :func:`fill_arrows_banded_single` — one pair's rectangular 3-bit tie
  masks, optionally its per-cell scores, its score and its fused count
  (``nw_fill_masks`` in ``csrc/nw_single.cu``, the single-pair pipeline's
  masks mode; K2's ``pack_bits=8`` mode for one pair; its plain version
  lives in :mod:`nw_tpu_torch.ops.fill_single`, whose K10 port uses it
  too).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (``csrc/nw_fill.cu``, ``csrc/nw_single.cu``) or
raises.  Each wrapper counts
its launches in ``.launches``.

``nw_scores``, ``nw_fill_codes``, ``nw_fill_masks_batch`` and
``nw_fill_runs_batch`` run W warps on each pair, a pipeline of 32-row
bands in one block (``csrc/nw_fill.cu``'s header; the byte modes add a
byte ring a warp to the block's shared memory), as do
``sw_scores`` and ``overlap_scores`` (:mod:`nw_tpu_torch.ops.variants_banded`,
through :func:`_fill_scores_kernel`) and, with cells of their own,
``gotoh_scores`` and ``gotoh_fill_codes`` (``csrc/nw_affine.cu``):
:func:`fill_warps` picks W from the batch and its buckets, and
:func:`fill_smem` gives a block's shared memory.  The block stages the
pair's top string as int16, so top characters are the encoder's (byte
values and negative pads): in shared memory, or, for a bucket too long
for it (:func:`top_in_smem`, about 115 000 columns), in an int16 scratch
row in device memory.  :func:`single_warps` and :func:`single_blocks`
give the shape of the same pipeline across a cooperative grid, one pair
on G blocks of W warps (``nw_score_count``, ``nw_fill_codes_single``,
``nw_score_single``, ``nw_last_row`` in :mod:`nw_tpu_torch.ops.fill_single`;
``nw_fill_masks``, whose warps each add a ring of tie masks to the
block's shared memory).

Inputs are int32 tops[B, A] / sides[B, Bs] encoded with the PAD_TOP /
PAD_SIDE sentinels, and int32 lens1 / lens2[B].  Counts come back as
int64 in ``[0, 2^32)`` (uint32 wraparound, the reference's
``unsigned int solution_count``).  Codes are band-major, as the TPU
kernel's words: int32[B, ceil(Bs/32), TW, 32] with
``TW = 2 * ceil((A+32)/32)``.  Cell (j >= 1, i) belongs to band
``(j-1) // 32`` at lane ``jj = (j-1) % 32`` and band step
``t = i + jj``: bits ``2 * (t % 16)`` of ``codes[b, band, t // 16, jj]``,
0 diag / 1 left / 2 up.  Fields of cells outside the table are 0; row 0
is not stored (every step there is LEFT).  Tie masks are rectangular
and row-major, uint8[B, Bs+1, A+1] (bits of
:mod:`nw_tpu_torch.ops.arrows`; row 0 LEFT, column 0 UP, the origin 0,
0 outside each pair's true table), not the TPU kernel's packed
band-major words.  Run bytes share that layout (uint8[B, Bs+1, A+1]);
:func:`fill_runs_banded_batch_plain` states what each byte holds.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from nw_tpu_torch.ops.fill_scan import (
    BAND_ROWS,
    U32,
    code_shape,
    diag_to_matrix_batch,
    fill_diag_batch,
    greedy_codes_from_arrows,
    pack_band_major,
    zero_outside,
)
from nw_tpu_torch.ops.fill_single import (
    check_batch as _check, check_pair, fill_arrows_banded_single_plain, pipe_scratch, pipe_shape,
)
from nw_tpu_torch.runtime import kernels


def _dims(tops, sides):
    return tops.shape[0], tops.shape[1], sides.shape[1]


def _contig(*ts):
    return tuple(t.contiguous() for t in ts)


def _wrap_counts(counts: torch.Tensor) -> torch.Tensor:
    """int32 counts from a kernel -> int64 in [0, 2^32)."""
    return counts.to(torch.int64) & U32


# ---------------- the pipeline's shape: W warps a pair ----------------

# nw_scores, nw_fill_codes, the byte fills, sw_scores and overlap_scores run
# a block of W warps on each pair (the pipeline of csrc/nw_fill.cu); these
# mirror its limits
MAX_WARPS = 32  # a block of 1 024 threads
SLOTS = 4  # the kernel's kSlots: 32-column chunk slots of a warp's ring
MASK_RING = 32 * 64  # bytes of a warp's ring of tie masks (nw_single.cu's kTileBytes)
BYTE_RING = 32 * 68  # bytes of a warp's byte ring in the byte fills (nw_fill.cu's kRingBytes)
SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on an H100
# the warps an SM should hold: the sweep of W (scripts/fill_shapes.py
# --sweep, chip_smoke.py phase 5; PERF.md section 6) on an H100 80GB
# HBM3 at 700 W gave config 3's fill (256 x 10 240 bp, two pairs an SM)
# 43.0 / 38.5 / 36.7 ms at W = 8 / 16 / 32 and 128 x 10 240 bp scores
# (one pair an SM) 14.6 / 8.7 / 8.0 ms at W = 8 / 16 / 32
WARPS_PER_SM = 32
# the single-pair pipeline's W: its wavefront's bands spread over the
# SMs, no fewer than SINGLE_WARPS_MIN (a narrow wavefront: fewer blocks,
# fewer handoffs between them) and no more than SINGLE_WARPS_MAX (more
# warps an SM slow each one's step more than they add).  The sweep of W
# (scripts/single_shapes.py --sweep; PERF.md section 6) on an H100 80GB
# HBM3 at 700 W gave nw_score_count at W = 4 / 8 / 12 / 16 / 24: 2.11 /
# 2.04 / 2.14 / 2.39 / 3.09 ms at 10 240 bp, 10.52 / 9.41 / 9.86 / 11.01 /
# 14.58 at 50 000 bp, 33.85 / 21.29 / 19.62 / 21.99 / 29.15 at 100 000 bp
# and 146.9 / 84.0 / 65.3 / 59.0 / 61.3 at 200 000 bp (nw_fill_codes_single
# alike)
SINGLE_WARPS_MIN = 8
SINGLE_WARPS_MAX = 16


def top_cols(A: int) -> int:
    """Columns of a staged top string (the kernel's ``pipe_top_cols``)."""
    return 32 * ((A + 1 + 62) // 32) + 32


def fill_smem(warps: int, A: int, cell: int, staged: bool = True, masks: bool = False,
              ring: int = 0) -> int:
    """Bytes of dynamic shared memory of one pipeline block (the kernel's
    ``pipe_smem``): the warps' chunk counters, rings and warp 0's staged
    row above (``cell`` bytes a column: 4 for a score, 8 for a score and
    a count, Gotoh's ``variants_banded.GOTOH_CELL``), when ``staged`` the
    top string as int16, with ``masks`` (``nw_fill_masks``) each warp's
    ring of tie masks, and ``ring`` bytes a warp more (the byte fills'
    ``BYTE_RING``)."""
    return (4 * warps + cell * (warps * 32 * SLOTS + 32) + (2 * top_cols(A) if staged else 0)
            + (MASK_RING * warps if masks else 0) + ring * warps)


def top_in_smem(A: int, cell: int, ring: int = 0) -> bool:
    """Whether a block stages an A-column top in shared memory (it fits
    beside one warp's ring of ``cell``-byte columns and its ``ring``
    bytes), else in device memory."""
    return fill_smem(1, A, cell, ring=ring) <= SMEM_LIMIT


def fill_warps(B: int, A: int, Bs: int, cell: int, sms: int, ring: int = 0) -> int:
    """W, the warps a pair of a batch of ``B`` pairs at buckets (A, Bs):
    one where the batch alone gives every one of the ``sms`` SMs
    ``WARPS_PER_SM`` warps, else enough to give each about that many,
    never more than the pair's 32-row bands, ``MAX_WARPS`` or what the
    shared memory holds (rings of ``cell`` bytes a column and ``ring``
    bytes a warp, the byte fills' ``BYTE_RING``, as :func:`fill_smem`)."""
    nbands = -(-Bs // 32)
    per_sm = max(1, -(-B // sms))  # pairs an SM takes
    warps = max(1, min(MAX_WARPS, nbands, -(-WARPS_PER_SM // per_sm)))
    staged = top_in_smem(A, cell, ring)
    while warps > 1 and fill_smem(warps, A, cell, staged, ring=ring) > SMEM_LIMIT:
        warps -= 1
    return warps


def single_warps(A: int, Bs: int, sms: int) -> int:
    """W, the warps a block of the single-pair pipeline (``nw_score_count``,
    ``nw_fill_codes_single``: one pair on a cooperative grid of blocks) at
    an (A, Bs) pair: the bands in flight at once (each band two chunks
    behind the one above it: about half a band's ``ceil((A+32)/32)``
    chunks, or all the pair's bands) spread over the ``sms`` SMs, within
    ``SINGLE_WARPS_MIN`` .. ``SINGLE_WARPS_MAX`` and no more than the
    bands.  (The top goes to device memory where it does not fit beside
    W warps' rings: :func:`_top_scratch`.)"""
    nbands = -(-Bs // 32)
    wave = min(nbands, -(-((A + 63) // 32) // 2))
    return max(1, min(nbands, SINGLE_WARPS_MAX, max(SINGLE_WARPS_MIN, -(-wave // sms))))


def single_blocks(Bs: int, warps: int, sms: int) -> int:
    """G, the blocks of a single-pair pipeline launch of ``warps`` warps a
    block: as many as the pair's bands fill, one an SM at most (past that
    the bands wrap around to block 0)."""
    return max(1, min(sms, -(-Bs // (32 * warps))))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _pipe_warps(B, A, Bs, cell, device, warps, ring=0):
    """The rule's W, or ``warps`` checked against the kernel's limits
    (``cell`` and ``ring`` as :func:`fill_smem`).  With a ``ring`` (the
    byte fills) a top that does not fit beside W warps' rings goes to
    device memory (:func:`_top_scratch`), so only the rings must fit."""
    if warps is None:
        warps = fill_warps(B, A, Bs, cell, _sms(device), ring)
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"warps must lie in [1, {MAX_WARPS}], not {warps}")
    if fill_smem(warps, A, cell, not ring and top_in_smem(A, cell), ring=ring) > SMEM_LIMIT:
        raise ValueError(
            f"a {A}-column top string does not fit a block's shared memory at {warps} warps"
        )
    return warps


def _top_scratch(B, A, cell, device, warps=1, masks=False, ring=0):
    """The int16 rows a pipeline launch stages its tops in (a row a pair;
    the single-pair pipeline's, a row a block), when they do not fit
    shared memory beside ``warps`` warps' rings (the batched pipeline's
    ``warps`` 1: :func:`top_in_smem`; with ``masks``, their rings of tie
    masks too; with ``ring``, those bytes a warp), else None: the
    kernel's argument is null."""
    if fill_smem(warps, A, cell, masks=masks, ring=ring) <= SMEM_LIMIT:
        return None
    return torch.empty((B, top_cols(A)), dtype=torch.int16, device=device)


# ---------------- K1: scores ----------------


def fill_scores_banded_batch(tops, sides, lens1, lens2, m, k, d) -> torch.Tensor:
    """int32[B] optimal scores, one per pair (true corner)."""
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return fill_scores_banded_batch_plain(tops, sides, lens1, lens2, m, k, d)
    return _fill_scores_kernel(fill_scores_banded_batch, tops, sides, lens1, lens2, m, k, d)


fill_scores_banded_batch.launches = 0


def _fill_scores_kernel(wrapper, tops, sides, lens1, lens2, m, k, d, warps=None, entry="nw_scores"):
    """Launch ``entry``, a score-only fill of the pipeline (``nw_scores``,
    ``sw_scores`` or ``overlap_scores``), for ``wrapper`` (whose count it
    raises) at ``warps`` warps a pair (default: :func:`fill_warps`)."""
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        warps = _pipe_warps(B, A, Bs, 4, dev, warps)
        tops, sides, lens1, lens2 = _contig(tops, sides, lens1, lens2)
        top16 = _top_scratch(B, A, 4, dev)
        bnd = torch.empty((B, A + 1), dtype=torch.int32, device=dev)
        kernels.launch(
            entry, dev,
            tops.data_ptr(), sides.data_ptr(), lens1.data_ptr(),
            lens2.data_ptr(), B, A, Bs, m, k, d, warps,
            None if top16 is None else top16.data_ptr(),
            bnd.data_ptr(), scores.data_ptr(),
        )
        wrapper.launches += 1
    return scores


def fill_scores_banded_batch_plain(tops, sides, lens1, lens2, m, k, d):
    """Plain version of :func:`fill_scores_banded_batch`."""
    return fill_diag_batch(
        tops, sides, lens1, lens2, m, k, d, with_arrows=False
    )["score"]


# ---------------- K2: codes and/or counts ----------------


def _fill_codes_kernel(wrapper, tops, sides, lens1, lens2, m, k, d, emit_codes, with_counts,
                      warps=None):
    """Launch ``nw_fill_codes`` for ``wrapper`` (whose count it raises) at
    ``warps`` warps a pair (default: :func:`fill_warps`)."""
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev) if with_counts else None
    codes = (
        torch.empty(code_shape(B, A, Bs), dtype=torch.int32, device=dev)
        if emit_codes else None
    )
    if B:
        cell = 8 if with_counts else 4  # a score, and a count
        warps = _pipe_warps(B, A, Bs, cell, dev, warps)
        tops, sides, lens1, lens2 = _contig(tops, sides, lens1, lens2)
        top16 = _top_scratch(B, A, cell, dev)
        bnd = torch.empty((B, A + 1), dtype=torch.int32, device=dev)
        cbnd = torch.empty((B, A + 1), dtype=torch.int32, device=dev) if with_counts else None
        kernels.launch(
            "nw_fill_codes", dev,
            tops.data_ptr(), sides.data_ptr(), lens1.data_ptr(),
            lens2.data_ptr(), B, A, Bs, m, k, d,
            int(emit_codes), int(with_counts), warps,
            None if top16 is None else top16.data_ptr(), bnd.data_ptr(),
            cbnd.data_ptr() if with_counts else None,
            codes.data_ptr() if emit_codes else None,
            scores.data_ptr(),
            counts.data_ptr() if with_counts else None,
        )
        wrapper.launches += 1
    return codes, scores, (_wrap_counts(counts) if with_counts else None)


def fill_scores_counts_banded_batch(
    tops, sides, lens1, lens2, m, k, d
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores int32[B], counts int64[B] in [0, 2^32)); nothing is
    stored per cell."""
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return fill_scores_counts_banded_batch_plain(tops, sides, lens1, lens2, m, k, d)
    _, scores, counts = _fill_codes_kernel(
        fill_scores_counts_banded_batch, tops, sides, lens1, lens2, m, k, d,
        emit_codes=False, with_counts=True,
    )
    return scores, counts


fill_scores_counts_banded_batch.launches = 0


def fill_scores_counts_banded_batch_plain(tops, sides, lens1, lens2, m, k, d):
    """Plain version of :func:`fill_scores_counts_banded_batch`."""
    out = fill_diag_batch(
        tops, sides, lens1, lens2, m, k, d, with_arrows=False, with_counts=True
    )
    return out["score"], out["count"]


def fill_greedy_counts_banded_batch(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(codes int32[B, nbands, TW, 32], scores int32[B], counts int64[B]
    or None): the greedy code of every cell of the bucket table."""
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return fill_greedy_counts_banded_batch_plain(
            tops, sides, lens1, lens2, m, k, d, with_counts
        )
    return _fill_codes_kernel(
        fill_greedy_counts_banded_batch, tops, sides, lens1, lens2, m, k, d,
        emit_codes=True, with_counts=with_counts,
    )


fill_greedy_counts_banded_batch.launches = 0


def fill_greedy_counts_banded_batch_plain(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False
):
    """Plain version of :func:`fill_greedy_counts_banded_batch`."""
    out = fill_diag_batch(
        tops, sides, lens1, lens2, m, k, d,
        with_arrows=True, with_counts=with_counts,
    )
    codes = greedy_codes_from_arrows(out["arrows"])
    return codes, out["score"], out.get("count")


# ---------------- K1 / K2 band by band: a span of bands from a boundary row ----------------

SIDE_PAD = -5  # the pipeline's side character past Bs (nw_common.cuh's kSidePad)


def span_bands(Bs: int, r0: int, span: int) -> int:
    """The bands a span from band ``r0`` of ``span`` bands sweeps in a
    table of ``Bs`` rows (32 a band): it stops at the table's last."""
    return max(0, min(span, -(-Bs // 32) - r0))


def span_row0(B: int, A: int, d: int, with_counts: bool, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The boundary row a span from band 0 reads, row 0 of every table:
    (bnd int32[B, A+1] = -c*d in wrapping int32, cbnd int32[B, A+1] = 1
    or None)."""
    c = torch.arange(A + 1, dtype=torch.int64, device=device) * -d
    row = (((c + 2**31) & U32) - 2**31).to(torch.int32)
    bnd = row.expand(B, A + 1).contiguous()
    cbnd = torch.ones((B, A + 1), dtype=torch.int32, device=device) if with_counts else None
    return bnd, cbnd


def _check_span(tops, sides, r0, span, bnd, cbnd, scores, counts, emit_codes):
    B, A, _ = _dims(tops, sides)
    if r0 < 0 or span < 1:
        raise ValueError(f"a span needs r0 >= 0 and span >= 1, not {r0}, {span}")
    if emit_codes and cbnd is not None:
        raise ValueError("the span's codes variant keeps no counts")
    if (cbnd is None) != (counts is None):
        raise ValueError("cbnd and counts go together")
    for name, t, shape in (("bnd", bnd, (B, A + 1)), ("cbnd", cbnd, (B, A + 1)),
                           ("scores", scores, (B,)), ("counts", counts, (B,))):
        if t is None:
            continue
        if t.shape != shape or t.dtype != torch.int32 or not t.is_contiguous() or t.device != tops.device:
            raise ValueError(f"{name} must be a contiguous int32{list(shape)} on the inputs' device")


def fill_span_banded_batch(
    tops, sides, lens1, lens2, m, k, d, r0: int, span: int, bnd: torch.Tensor,
    cbnd: Optional[torch.Tensor] = None, scores: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None, emit_codes: bool = False, warps: Optional[int] = None,
) -> Optional[torch.Tensor]:
    """Bands r0 .. r0+span-1 (cut at the table's last) of a batch's fill,
    from the boundary row above band r0, in place.

    The port of K1 and K2 as ``nw_tpu``'s two-pass engine and resumable
    fill call them, band by band with the boundary row carried
    (``banded_traceback.py:77-110``, ``runtime/checkpoint.py:560-580``).
    bnd: int32[B, A+1], row 32*r0 of every table (:func:`span_row0` for
    r0 = 0); with cbnd (int32[B, A+1], uint32 bits) its counts.  Both are
    left holding the span's last row, 32*(r0+nb) (its rows past Bs swept
    over the pads).  scores / counts (int32[B], counts as uint32 bits):
    written only for the pairs whose row len2 lies in the span (len2 = 0:
    the span from band 0, off bnd's column len1), the others kept.
    Three variants: scores (no cbnd), scores + counts (cbnd and counts),
    and ``emit_codes``, which returns the span's codes int32[B, nb, TW,
    32] in :func:`fill_greedy_counts_banded_batch`'s band-major layout
    (no counts; else None).  ``nw_fill_span`` at ``warps`` warps a pair
    (default :func:`fill_warps` at the span's bands) on CUDA tensors,
    :func:`fill_span_banded_batch_plain` on CPU tensors.
    """
    _check(tops, sides, lens1, lens2, m, k, d)
    if scores is None:
        scores = torch.empty(tops.shape[0], dtype=torch.int32, device=tops.device)
    _check_span(tops, sides, r0, span, bnd, cbnd, scores, counts, emit_codes)
    return fill_span_checked(tops, sides, lens1, lens2, m, k, d, r0, span, bnd, cbnd, scores, counts,
                             emit_codes, warps)


fill_span_banded_batch.launches = 0


def fill_span_checked(tops, sides, lens1, lens2, m, k, d, r0, span, bnd, cbnd, scores, counts,
                      emit_codes=False, warps=None):
    """:func:`fill_span_banded_batch` on inputs already checked (scores
    given): ``nw_fill_span`` on CUDA tensors, the plain version on CPU
    tensors.  For callers that sweep one checked batch span by span,
    which :func:`fill_span_banded_batch`'s length check would sync each
    time."""
    if tops.device.type == "cpu":
        return fill_span_banded_batch_plain(
            tops, sides, lens1, lens2, m, k, d, r0, span, bnd, cbnd, scores, counts, emit_codes
        )
    return _fill_span_kernel(tops, sides, lens1, lens2, m, k, d, r0, span, bnd, cbnd, scores, counts,
                             emit_codes, warps)


def _fill_span_kernel(tops, sides, lens1, lens2, m, k, d, r0, span, bnd, cbnd, scores, counts,
                      emit_codes, warps=None):
    """Launch ``nw_fill_span`` (inputs checked) for
    :func:`fill_span_banded_batch`, whose count it raises."""
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    nb = span_bands(Bs, r0, span)
    codes = (
        torch.empty(code_shape(B, A, 32 * nb), dtype=torch.int32, device=dev) if emit_codes else None
    )
    if B:
        with_counts = cbnd is not None
        cell = 8 if with_counts else 4  # a score, and a count
        warps = _pipe_warps(B, A, 32 * max(nb, 1), cell, dev, warps)
        tops, sides, lens1, lens2 = _contig(tops, sides, lens1, lens2)
        top16 = _top_scratch(B, A, cell, dev)
        kernels.launch(
            "nw_fill_span", dev,
            tops.data_ptr(), sides.data_ptr(), lens1.data_ptr(), lens2.data_ptr(),
            B, A, Bs, m, k, d, r0, span, int(emit_codes), int(with_counts), warps,
            None if top16 is None else top16.data_ptr(), bnd.data_ptr(),
            cbnd.data_ptr() if with_counts else None,
            codes.data_ptr() if emit_codes else None, scores.data_ptr(),
            counts.data_ptr() if with_counts else None,
        )
        fill_span_banded_batch.launches += 1
    return codes


def _as_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same bits."""
    return (((x & U32) + 2**31) & U32).sub(2**31).to(torch.int32)


def fill_span_banded_batch_plain(
    tops, sides, lens1, lens2, m, k, d, r0: int, span: int, bnd: torch.Tensor,
    cbnd: Optional[torch.Tensor] = None, scores: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None, emit_codes: bool = False,
) -> Optional[torch.Tensor]:
    """Plain version of :func:`fill_span_banded_batch` (the same updates
    of bnd, cbnd, scores and counts, and the same codes): the
    anti-diagonal fill of the span's rows seeded with bnd / cbnd."""
    B, A, Bs = _dims(tops, sides)
    if scores is None:
        scores = torch.empty(B, dtype=torch.int32, device=tops.device)
    nb = span_bands(Bs, r0, span)
    codes = None
    if r0 == 0:  # a corner on row 0: the seed row's
        on0 = lens2 == 0
        l1 = lens1.to(torch.int64)[:, None]
        scores.copy_(torch.where(on0, bnd.gather(1, l1)[:, 0], scores))
        if counts is not None:
            counts.copy_(torch.where(on0, cbnd.gather(1, l1)[:, 0], counts))
    if nb > 0:
        codes = fill_rows_plain(tops, sides, lens1, lens2, m, k, d, 32 * r0, 32 * nb, bnd, cbnd,
                                scores, counts, emit_codes)
    elif emit_codes:
        codes = torch.zeros(code_shape(B, A, 0), dtype=torch.int32, device=tops.device)
    return codes


def fill_rows_plain(tops, sides, lens1, lens2, m, k, d, row0: int, rows: int, bnd, cbnd=None,
                    scores=None, counts=None, emit_codes=False):
    """The plain span at any rows: rows row0+1 .. row0+rows of each table
    (past Bs over ``SIDE_PAD``), seeded with row row0 in bnd (and its
    counts in cbnd), in place as :func:`fill_span_banded_batch_plain`;
    with ``emit_codes`` the codes of rows row0+1 .. min(row0+rows, Bs),
    band-major from row row0+1."""
    B, A, Bs = _dims(tops, sides)
    real = max(0, min(rows, Bs - row0))
    side = torch.cat([sides[:, row0 : row0 + real].to(torch.int32),
                      torch.full((B, rows - real), SIDE_PAD, dtype=torch.int32, device=tops.device)], 1)
    l2 = lens2.to(torch.int64) - row0
    inside = (l2 >= 1) & (l2 <= rows)
    with_counts = cbnd is not None
    out = fill_diag_batch(
        tops, side, lens1, l2.clamp(0, rows), m, k, d, with_arrows=emit_codes,
        with_counts=with_counts, seed=bnd, cseed=cbnd, row0=row0, with_last=True,
    )
    if scores is not None:
        scores.copy_(torch.where(inside, out["score"], scores))
    if with_counts and counts is not None:
        counts.copy_(torch.where(inside, _as_u32_bits(out["count"]), counts))
    bnd.copy_(out["last"])
    if with_counts:
        cbnd.copy_(_as_u32_bits(out["clast"]))
    if not emit_codes:
        return None
    rect = diag_to_matrix_batch(out["arrows"])[:, 1 : real + 1]
    code = torch.where((rect & 1) != 0, 0, torch.where((rect & 2) != 0, 1, 2)).to(torch.uint8)
    return pack_band_major(code, 2)


# ---------------- K2 pack_bits=8 and with_runs, a batch: a byte a cell ----------------


def _fill_bytes_kernel(wrapper, entry, tops, sides, lens1, lens2, m, k, d, with_counts,
                       warps=None):
    """Launch ``entry`` (``nw_fill_masks_batch`` or ``nw_fill_runs_batch``,
    the pipeline's byte modes) for ``wrapper`` (whose count it raises) at
    ``warps`` warps a pair (default: :func:`fill_warps` with a
    ``BYTE_RING`` a warp): (table uint8[B, Bs+1, A+1], scores int32[B],
    counts int64[B] or None)."""
    B, A, Bs = _dims(tops, sides)
    dev = tops.device
    table = torch.empty((B, Bs + 1, A + 1), dtype=torch.uint8, device=dev)
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev) if with_counts else None
    if B:
        cell = 8 if with_counts else 4  # a score, and a count
        warps = _pipe_warps(B, A, Bs, cell, dev, warps, ring=BYTE_RING)
        tops, sides, lens1, lens2 = _contig(tops, sides, lens1, lens2)
        top16 = _top_scratch(B, A, cell, dev, warps, ring=BYTE_RING)
        bnd = torch.empty((B, A + 1), dtype=torch.int32, device=dev)
        cbnd = torch.empty((B, A + 1), dtype=torch.int32, device=dev) if with_counts else None
        kernels.launch(
            entry, dev,
            tops.data_ptr(), sides.data_ptr(), lens1.data_ptr(), lens2.data_ptr(),
            B, A, Bs, m, k, d, int(with_counts), warps,
            None if top16 is None else top16.data_ptr(), bnd.data_ptr(),
            cbnd.data_ptr() if with_counts else None, table.data_ptr(), scores.data_ptr(),
            counts.data_ptr() if with_counts else None,
        )
        wrapper.launches += 1
    return table, scores, (_wrap_counts(counts) if with_counts else None)


def fill_masks_banded_batch(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False, warps: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(masks uint8[B, Bs+1, A+1], scores int32[B], counts int64[B] or
    None): the 3-bit tie masks of every cell of a batch, row-major, 0
    outside each pair's true table, and the fused counts when asked.

    The port of K2's batched ``pack_bits=8`` mode: ``nw_tpu``'s
    ``fill_arrows_banded_batch`` (``ops/fill_pallas_banded.py:655``) and
    ``fill_arrows_banded_single`` (``:810``, one band over the whole
    table; not this module's one-pair :func:`fill_arrows_banded_single`),
    with ``with_counts``.  ``nw_fill_masks_batch`` (the pipeline's
    ``MASKS`` mode, ``warps`` warps a pair, default :func:`fill_warps`
    with the byte rings counted) on CUDA tensors,
    :func:`fill_masks_banded_batch_plain` on CPU tensors.
    """
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return fill_masks_banded_batch_plain(tops, sides, lens1, lens2, m, k, d, with_counts)
    return _fill_bytes_kernel(
        fill_masks_banded_batch, "nw_fill_masks_batch", tops, sides, lens1, lens2, m, k, d,
        with_counts, warps,
    )


fill_masks_banded_batch.launches = 0


def fill_masks_banded_batch_plain(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False
):
    """Plain version of :func:`fill_masks_banded_batch`: the
    anti-diagonal fill's tie masks turned into rectangles, zeroed outside
    each true table."""
    out = fill_diag_batch(
        tops, sides, lens1, lens2, m, k, d, with_arrows=True, with_counts=with_counts
    )
    masks = zero_outside(diag_to_matrix_batch(out["arrows"]), lens1, lens2)
    return masks, out["score"], out.get("count")


def fill_runs_banded_batch(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False, warps: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(runs uint8[B, Bs+1, A+1], scores int32[B], counts int64[B] or
    None): the run byte of every cell of a batch, row-major, 0 outside
    each pair's true table, and the fused counts when asked.

    The port of K2's ``with_runs`` mode (``nw_tpu``'s
    ``_make_banded_arrows_kernel``, ``ops/fill_pallas_banded.py:342``,
    launched through ``build_arrows_call`` at ``:969`` by the ``runs``
    walk engine), which has no counts; here they ride along.
    ``nw_fill_runs_batch`` (the pipeline's ``RUNS`` mode, ``warps`` warps
    a pair as :func:`fill_masks_banded_batch`) on CUDA tensors,
    :func:`fill_runs_banded_batch_plain` on CPU tensors.
    """
    _check(tops, sides, lens1, lens2, m, k, d)
    if tops.device.type == "cpu":
        return fill_runs_banded_batch_plain(tops, sides, lens1, lens2, m, k, d, with_counts)
    return _fill_bytes_kernel(
        fill_runs_banded_batch, "nw_fill_runs_batch", tops, sides, lens1, lens2, m, k, d,
        with_counts, warps,
    )


fill_runs_banded_batch.launches = 0

RUN_CAP = 63  # the longest run a byte holds


def run_bytes(masks: torch.Tensor) -> torch.Tensor:
    """Rectangular tie masks uint8[B, N, M] (row 0 LEFT, column 0 UP, the
    origin 0, 0 outside each table, as the fills write them) -> the run
    bytes of :func:`fill_runs_banded_batch_plain`."""
    B, N, M = masks.shape
    a = masks.to(torch.int64)
    code = torch.where((a & 1) != 0, 0, torch.where((a & 2) != 0, 1, 2))
    live = a != 0  # the table but its origin
    idx = torch.arange(M, device=masks.device).expand(B, N, M)
    # a left run: back to the last cell of its row that is not LEFT
    lrun = idx - torch.cummax(torch.where(live & (code == 1), 0, idx), dim=2).values
    diag = live & (code == 0)
    drun = torch.zeros_like(a)
    for j in range(1, N):  # a diag run restarts at each band's first row
        above = 0 if j % BAND_ROWS == 1 else drun[:, j - 1, :-1]
        drun[:, j, 1:] = torch.where(diag[:, j, 1:], above + 1, 0)
    run = torch.where(code == 0, drun, torch.where(code == 1, lrun, 0)).clamp(max=RUN_CAP)
    return torch.where(live, run << 2 | code, 0).to(torch.uint8)


def fill_runs_banded_batch_plain(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False
):
    """Plain version of :func:`fill_runs_banded_batch`.

    Cell (j, i) of a pair's true table holds ``min(run, 63) << 2 | code``.
    ``code`` is the greedy choice, 0 diag / 1 left / 2 up (diag > left >
    up, the first set bit of the cell's tie mask).  ``run`` is the length
    of the maximal run of cells of that code ending at the cell: a diag
    run chains through (j-1, i-1) while that cell is DIAG and row j is not
    the first row of a 32-row band (j % 32 != 1), a left run through
    (j, i-1) while that cell is LEFT; an up cell stores run 0.  Row 0
    holds ``min(i, 63) << 2 | LEFT`` (a left run from the origin), column
    0 holds UP (run 0), the origin and every cell outside the table 0.
    """
    masks, scores, counts = fill_masks_banded_batch_plain(tops, sides, lens1, lens2, m, k, d, with_counts)
    return run_bytes(masks), scores, counts


# ---------------- K2 pack_bits=8, one pair: tie masks ----------------


def fill_arrows_banded_single(
    top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
    len1: Optional[int] = None, len2: Optional[int] = None,
    with_scores: bool = False, warps: Optional[int] = None, blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], int, int]:
    """One pair's whole table: (masks uint8[len2+1, len1+1], scores
    int32[len2+1, len1+1] or None, score, count mod 2^32).

    Masks are rectangular and row-major, bit0 diag / bit1 left / bit2
    up (row 0 LEFT, column 0 UP, the origin 0), not the TPU kernel's
    packed band-major words.  top / side: int32[A] / int32[Bs]; len1 /
    len2 default to A / Bs.  ``nw_fill_masks`` (the single-pair
    pipeline's masks mode; ``warps`` a block and ``blocks`` default to
    :func:`nw_tpu_torch.ops.fill_single.pipe_shape`'s rule) on CUDA
    tensors, :func:`fill_arrows_banded_single_plain` on CPU tensors.
    """
    len1, len2 = check_pair(top, side, m, k, d, len1, len2, warps, blocks)
    if top.device.type == "cpu":
        return fill_arrows_banded_single_plain(top, side, m, k, d, len1, len2, with_scores)
    dev = top.device
    top = top[:len1].contiguous()
    side = side[:len2].contiguous()
    masks = torch.empty((len2 + 1, len1 + 1), dtype=torch.uint8, device=dev)
    scores = (
        torch.empty((len2 + 1, len1 + 1), dtype=torch.int32, device=dev)
        if with_scores else None
    )
    blocks, warps = pipe_shape(len1, len2, dev, warps, blocks)
    top16, bnd, flags = pipe_scratch(len1, blocks, warps, 8, dev, masks=True)
    score = torch.empty(1, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    kernels.launch(
        "nw_fill_masks", dev,
        top.data_ptr(), side.data_ptr(), len1, len2, m, k, d, blocks, warps,
        None if top16 is None else top16.data_ptr(), bnd.data_ptr(), flags.data_ptr(),
        masks.data_ptr(), len1 + 1, scores.data_ptr() if with_scores else None,
        score.data_ptr(), count.data_ptr(),
    )
    fill_arrows_banded_single.launches += 1
    return masks, scores, int(score.item()), int(count.item()) & U32


fill_arrows_banded_single.launches = 0
