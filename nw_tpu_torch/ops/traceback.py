"""Greedy single-path traceback and op-string building.

The reference's walk (needleman-wunsch.c:209-331) enumerates every
optimal alignment; when one per pair is needed the walk is a
deterministic backward scan from the true corner (len2, len1) that
follows the highest-priority direction, diag > left > up — the order the
reference DFS descends in (needleman-wunsch.c:305-324), so the path is
exactly the *first* alignment the reference emits.

* :func:`traceback_greedy_batch` walks diagonal-major tie masks (port
  of ``nw_tpu/ops/traceback.py:38-85``), plain PyTorch.
* :func:`walk_masks_batch` walks rectangular tie masks uint8[B, Bs+1, A+1]
  (:func:`nw_tpu_torch.ops.fill_banded.fill_masks_banded_batch`,
  :func:`nw_tpu_torch.ops.fill_single.fill_arrows_fold_batch`): the
  ``nw_walk_masks`` kernel on a CUDA tensor (the counterpart of
  ``traceback_greedy`` vmapped over K2's and K10's masks,
  ``traceback.py:197-207``), :func:`traceback_greedy_batch` on a CPU
  tensor.
* :func:`walk_runs_batch` walks rectangular run bytes uint8[B, Bs+1, A+1]
  (:func:`nw_tpu_torch.ops.fill_banded.fill_runs_banded_batch`) a whole
  same-code run a load: the ``nw_walk_runs`` kernel on a CUDA tensor
  (the counterpart of ``nw_tpu/ops/banded_traceback.py:187
  _make_runs_walk_loop``, the ``runs`` walk engine), its plain version
  on a CPU tensor.  Both write the expanded ops, so no run record, record
  cap or fallback engine exists here.
* :func:`walk_codes_batch` walks the band-major 2-bit greedy codes that
  :func:`nw_tpu_torch.ops.fill_banded.fill_greedy_counts_banded_batch`
  emits (the counterpart of ``traceback_greedy2``, ``traceback.py:88-122``):
  the ``nw_walk`` kernel on a CUDA tensor, its plain version on a CPU
  tensor.
* :func:`walk_codes_window` walks one block of rows of one pair's codes
  (re-filled from a checkpoint row) from a start kept in device memory
  (the block walk of ``nw_tpu/ops/checkpoint_traceback.py:353-373``): the
  ``nw_walk_window`` kernel on CUDA tensors, its plain version on CPU
  tensors.  It walks the codes of one rank's rows of a sharded pair too
  (:mod:`nw_tpu_torch.parallel.huge_pair`, the relay walk of
  ``nw_tpu/parallel/huge_pair.py:871``), and :func:`walk_masks_window`
  walks that rank's 3-bit tie masks instead (``nw_walk_window``'s masks
  mode; ``_make_arrow_at_pallas``, ``huge_pair.py:944``).
* :func:`walk_codes_groups` walks one group of rows of every pair of a
  batch (re-filled from a checkpoint row by the two-pass engines) from
  cursors kept in device memory (``nw_tpu/ops/banded_traceback.py:115
  _make_walk_loop``): the ``nw_walk_groups`` kernel on CUDA tensors, its
  plain version on CPU tensors.
* :func:`walk_sw_codes_batch` walks the local (Smith-Waterman) codes of
  :func:`nw_tpu_torch.ops.variants_banded.sw_fill_codes_banded_batch`
  from each pair's best cell to its first STOP (the counterpart of
  ``nw_tpu/models/smith_waterman.py:220 _sw_walk_packed`` and the walk of
  ``nw_tpu/ops/variants_banded.py:1177 _sw_walk_device``): the
  ``sw_walk`` kernel on a CUDA tensor, its plain version on a CPU tensor.
  It walks the overlap codes of
  :func:`nw_tpu_torch.ops.variants_banded.overlap_fill_codes_banded_batch`
  unchanged, from the end cell to row 0 or column 0 (for
  ``nw_tpu/models/overlap.py:178 _overlap_walk_diag`` and
  ``nw_tpu/ops/variants_banded.py:752 _overlap_walk_device``).
* :func:`walk_gotoh_codes_batch` walks the 4-bit Gotoh codes of
  :func:`nw_tpu_torch.ops.variants_banded.affine_fill_codes_banded_batch`
  with the three-state machine, from each true corner in its corner
  state to the origin (the counterpart of
  ``nw_tpu/models/affine.py:340 _affine_walk_packed`` and the group walk
  of ``nw_tpu/ops/variants_banded.py:1698 _affine_walk_device``): the
  ``gotoh_walk`` kernel on a CUDA tensor, its plain version on a CPU
  tensor.
* :func:`ops_to_strings_batch` builds the aligned byte strings on the
  host through the native one-pass builder (``runtime/cc/nwstrings.cc``)
  when the native runtime loads, as ``traceback.py:212-228`` does, else
  through :func:`ops_to_strings_batch_plain`, the numpy path;
  :func:`ops_to_strings` does one pair (``traceback.py:270``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from nw_tpu_torch.ops.fill_scan import matrix_to_diag_batch
from nw_tpu_torch.ops.pathcount import check_masks
from nw_tpu_torch.runtime import kernels, native

OP_DIAG = 0
OP_LEFT = 1
OP_UP = 2
OP_NONE = 3


def traceback_greedy_batch(
    arrows: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy backward walk over diagonal-major tie masks.

    arrows: uint8[B, K, N] (cell (j, i) at ``arrows[b, i + j, j]``).
    Returns ops int8[B, max_steps] in walk order (corner -> origin),
    padded with OP_NONE, and n int32[B], the number of real ops.
    """
    B = arrows.shape[0]
    dev = arrows.device
    b_ar = torch.arange(B, device=dev)
    i = lens1.to(device=dev, dtype=torch.int64).clone()
    j = lens2.to(device=dev, dtype=torch.int64).clone()
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    ops = torch.full((B, max_steps), OP_NONE, dtype=torch.int8, device=dev)
    for t in range(max_steps):
        active = (i > 0) | (j > 0)
        if t % 256 == 0 and not bool(active.any()):  # every walk has ended
            break
        a = arrows[b_ar, i + j, j].to(torch.int64)
        take_diag = (a & 1) != 0
        take_left = ~take_diag & ((a & 2) != 0)
        op = torch.where(take_diag, OP_DIAG, torch.where(take_left, OP_LEFT, OP_UP))
        ops[:, t] = torch.where(active, op, OP_NONE).to(torch.int8)
        i = i - (active & (op != OP_UP)).to(torch.int64)
        j = j - (active & (op != OP_LEFT)).to(torch.int64)
        n = n + active.to(torch.int32)
    return ops, n


def walk_masks_batch(
    masks: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy backward walk over rectangular tie masks.

    masks: uint8[B, Bs+1, A+1] (bit0 diag, bit1 left, bit2 up); each
    walk starts at its true corner (lens2[b], lens1[b]) and takes the
    first set bit in diag > left > up order, UP where none is set, LEFT
    along row 0.  max_steps must be >= every len1 + len2.  Returns ops
    int8[B, max_steps] (OP_NONE padded) and n int32[B], as
    :func:`traceback_greedy_batch`.

    A CUDA tensor goes through the ``nw_walk_masks`` kernel (a warp a
    pair, each band's row pieces copied into shared memory one band ahead
    of it by 16-byte ``cp.async``, the band's blocks spread over the
    warp's lanes, and expanded into a table of byte deltas); a CPU
    tensor through :func:`walk_masks_batch_plain`.
    """
    check_masks(masks, lens1, lens2)
    if masks.device.type == "cpu":
        return walk_masks_batch_plain(masks, lens1, lens2, max_steps)
    B, N, M = masks.shape
    ops = torch.full((B, max_steps), OP_NONE, dtype=torch.int8, device=masks.device)
    n = torch.empty(B, dtype=torch.int32, device=masks.device)
    if B:
        masks, lens1, lens2 = (t.contiguous() for t in (masks, lens1, lens2))
        kernels.launch(
            "nw_walk_masks", masks.device,
            masks.data_ptr(), lens1.data_ptr(), lens2.data_ptr(), B, M - 1, N - 1,
            max_steps, ops.data_ptr(), n.data_ptr(),
        )
        walk_masks_batch.launches += 1
    return ops, n


walk_masks_batch.launches = 0


def walk_masks_batch_plain(
    masks: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`walk_masks_batch`:
    :func:`traceback_greedy_batch` over the masks made diagonal-major."""
    return traceback_greedy_batch(matrix_to_diag_batch(masks), lens1, lens2, max_steps)


def walk_runs_batch(
    runs: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run-skip greedy walk over rectangular run bytes.

    runs: uint8[B, Bs+1, A+1], ``min(run, 63) << 2 | code`` a cell
    (:func:`nw_tpu_torch.ops.fill_banded.fill_runs_banded_batch`).  Each
    walk starts at its true corner (lens2[b], lens1[b]); a load consumes
    a whole run: diag K moves to (j-K, i-K), left K to (j, i-K), up to
    (j-1, i).  Row 0 steps LEFT and column 0 UP to the origin.
    max_steps must be >= every len1 + len2.  Returns ops int8[B,
    max_steps] (OP_NONE padded) and n int32[B], the same as
    :func:`walk_codes_batch` over the same cells' codes.

    A CUDA tensor goes through the ``nw_walk_runs`` kernel (a warp a
    pair); a CPU tensor through :func:`walk_runs_batch_plain`.
    """
    check_masks(runs, lens1, lens2)
    if runs.device.type == "cpu":
        return walk_runs_batch_plain(runs, lens1, lens2, max_steps)
    B, N, M = runs.shape
    ops = torch.full((B, max_steps), OP_NONE, dtype=torch.int8, device=runs.device)
    n = torch.empty(B, dtype=torch.int32, device=runs.device)
    if B:
        runs, lens1, lens2 = (t.contiguous() for t in (runs, lens1, lens2))
        kernels.launch(
            "nw_walk_runs", runs.device,
            runs.data_ptr(), lens1.data_ptr(), lens2.data_ptr(), B, M - 1, N - 1,
            max_steps, ops.data_ptr(), n.data_ptr(),
        )
        walk_runs_batch.launches += 1
    return ops, n


walk_runs_batch.launches = 0


def walk_runs_batch_plain(
    runs: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`walk_runs_batch` (same outputs)."""
    ops, n, _ = walk_runs_loads(runs, lens1, lens2, max_steps)
    return ops, n


def walk_runs_loads(
    runs: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`walk_runs_batch_plain`'s (ops, n) and loads int64[B], the run
    bytes each walk read (its runs off row 0 and column 0), in plain
    PyTorch on the tensors' device: one iteration a run, every pair at
    once, then the runs expanded into ops."""
    B, N, M = runs.shape
    dev = runs.device
    b_ar = torch.arange(B, device=dev)
    i = lens1.to(torch.int64).clone()
    j = lens2.to(torch.int64).clone()
    loads = torch.zeros(B, dtype=torch.int64, device=dev)
    recs_a, recs_k = [], []
    for t in range(max_steps + 1):  # a run is at least one step
        active = (i > 0) | (j > 0)
        if t % 64 == 0 and not bool(active.any()):
            break
        v = runs[b_ar, j.clamp(max=N - 1), i.clamp(max=M - 1)].to(torch.int64)
        a = v & 3
        K = torch.where(a == OP_UP, 1, (v >> 2).clamp(min=1))
        row0, col0 = j == 0, (j > 0) & (i == 0)
        a = torch.where(row0, OP_LEFT, torch.where(col0, OP_UP, a))
        K = torch.where(active, torch.where(row0, i, torch.where(col0, j, K)), 0)
        loads += (active & ~row0 & ~col0).to(torch.int64)
        recs_a.append(a)
        recs_k.append(K)
        i = i - torch.where(a != OP_UP, K, 0)
        j = j - torch.where(a != OP_LEFT, K, 0)
    ops = torch.full((B, max_steps), OP_NONE, dtype=torch.int8, device=dev)
    if not recs_k:
        return ops, torch.zeros(B, dtype=torch.int32, device=dev), loads
    ends = torch.cumsum(torch.stack(recs_k, dim=1), dim=1)  # [B, R]
    n = ends[:, -1].clamp(max=max_steps)
    pos = torch.arange(max_steps, device=dev).expand(B, max_steps).contiguous()
    rec = torch.searchsorted(ends, pos, right=True).clamp(max=ends.shape[1] - 1)
    a_all = torch.gather(torch.stack(recs_a, dim=1), 1, rec)
    ops = torch.where(pos < n[:, None], a_all, OP_NONE).to(torch.int8)
    return ops, n.to(torch.int32), loads


def _check_walk_args(codes, lens1, lens2, per_word=16):
    """Validate what the walk indexes with: a length beyond the code
    table (``per_word`` codes a word) would read outside it."""
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CPU or CUDA tensors expected, got {codes.device}")
    if codes.dim() != 4 or codes.dtype != torch.int32 or codes.shape[3] != 32:
        raise ValueError("codes must be int32[B, nbands, TW, 32]")
    for t in (lens1, lens2):
        if t.shape != (codes.shape[0],) or t.dtype != torch.int32:
            raise ValueError("lens must be int32[B]")
        if t.device != codes.device:
            raise ValueError("codes and lens must be on one device")
    if codes.shape[0]:
        _, nbands, TW, lanes = codes.shape
        lo, hi = torch.aminmax(torch.stack([lens1, lens2]), dim=1)
        (lo1, lo2), (hi1, hi2) = lo.tolist(), hi.tolist()
        if min(lo1, lo2) < 0 or hi1 + lanes > per_word * TW or hi2 > lanes * nbands:
            raise ValueError("lengths must lie inside the code table")


def _check_codes_aligned(codes):
    """The code walks' bulk copies read a table of codes that starts on a
    16-byte boundary."""
    if codes.device.type == "cuda" and codes.numel() and codes.data_ptr() % 16:
        raise ValueError("codes must start on a 16-byte boundary")


def walk_codes_batch(
    codes: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy backward walk over band-major 2-bit greedy codes.

    codes: int32[B, nbands, TW, 32] in the layout of
    :mod:`nw_tpu_torch.ops.fill_banded` (0 diag / 1 left / 2 up — the
    code IS the op; row 0 is not stored and walks LEFT).  max_steps must
    be >= every len1 + len2.  Returns ops int8[B, max_steps] (OP_NONE
    padded) and n int32[B].

    A CUDA tensor goes through the ``nw_walk`` kernel (a warp a pair,
    each reading its codes from segments of word columns copied into
    shared memory bands ahead of it, six columns at a time expanded into a
    table of byte deltas); a CPU tensor through
    :func:`walk_codes_batch_plain`.
    """
    _check_walk_args(codes, lens1, lens2)
    codes = codes.contiguous()
    _check_codes_aligned(codes)
    if codes.device.type == "cpu":
        return walk_codes_batch_plain(codes, lens1, lens2, max_steps)
    B, nbands, TW, _ = codes.shape
    ops = torch.full(
        (B, max_steps), OP_NONE, dtype=torch.int8, device=codes.device
    )
    n = torch.empty(B, dtype=torch.int32, device=codes.device)
    if B:
        lens1, lens2 = lens1.contiguous(), lens2.contiguous()
        kernels.launch(
            "nw_walk", codes.device,
            codes.data_ptr(), lens1.data_ptr(), lens2.data_ptr(),
            B, nbands, TW, max_steps, ops.data_ptr(), n.data_ptr(),
        )
        walk_codes_batch.launches += 1
    return ops, n


walk_codes_batch.launches = 0


def walk_codes_batch_plain(
    codes: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``nw_walk`` kernel (same outputs)."""
    B = codes.shape[0]
    dev = codes.device
    b_ar = torch.arange(B, device=dev)
    i = lens1.to(torch.int64).clone()
    j = lens2.to(torch.int64).clone()
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    ops = torch.full((B, max_steps), OP_NONE, dtype=torch.int8, device=dev)
    for t in range(max_steps):
        active = (i > 0) | (j > 0)
        jm = (j - 1).clamp(min=0)
        step = i + (jm & 31)
        if codes.shape[1]:
            w = codes[b_ar, jm >> 5, step >> 4, jm & 31].to(torch.int64)
            a = (w >> (2 * (step & 15))) & 3
        else:
            a = torch.zeros_like(i)
        a = torch.where(j == 0, OP_LEFT, a)
        ops[:, t] = torch.where(active, a, OP_NONE).to(torch.int8)
        i = i - (active & (a != OP_UP)).to(torch.int64)
        j = j - (active & (a != OP_LEFT)).to(torch.int64)
        n = n + active.to(torch.int32)
    return ops, n


def _check_window_args(codes, state, ops, masks=False):
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CPU or CUDA tensors expected, got {codes.device}")
    if masks and (codes.dim() != 2 or codes.dtype != torch.uint8 or not codes.is_contiguous()):
        raise ValueError("masks must be a contiguous uint8[rows, A+1]")
    if not masks and (
        codes.dim() != 4 or codes.dtype != torch.int32 or codes.shape[0] != 1 or codes.shape[3] != 32
    ):
        raise ValueError("codes must be int32[1, nbands, TW, 32]")
    if state.shape != (3,) or state.dtype != torch.int32 or not state.is_contiguous():
        raise ValueError("state must be a contiguous int32[3]: (i, j, n)")
    if ops.dim() != 1 or ops.dtype != torch.int8 or not ops.is_contiguous():
        raise ValueError("ops must be a contiguous int8[S]")
    if state.device != codes.device or ops.device != codes.device:
        raise ValueError("codes, state and ops must be on one device")


def walk_codes_window(
    codes: torch.Tensor, state: torch.Tensor, j0: int, ops: torch.Tensor
) -> None:
    """Greedy backward walk over one block of rows of one pair, in place.

    codes: int32[1, nbands, TW, 32], the codes of rows j0+1 .. of the pair
    (:func:`nw_tpu_torch.ops.fill_single.fill_codes_single`, seeded from
    row j0; code row j - j0 - 1).  state: int32[3] = (i, j, n), the start
    cell and the number of ops written so far, read and written back.
    ops: int8[S], written from ops[n].  The walk stops on reaching row j0
    when j0 > 0; when j0 is 0 it steps LEFT along row 0 to the origin.
    Because the start lives in device memory, the blocks of one pair
    chain on one stream with no host sync.

    A CUDA tensor goes through the ``nw_walk_window`` kernel (one warp
    on :func:`walk_codes_batch`'s staging); a CPU tensor through
    :func:`walk_codes_window_plain`.
    """
    _check_window_args(codes, state, ops)
    if j0 < 0:
        raise ValueError(f"j0 must be >= 0, not {j0}")
    codes = codes.contiguous()
    _check_codes_aligned(codes)
    if codes.device.type == "cpu":
        return walk_codes_window_plain(codes, state, j0, ops)
    _, nbands, TW, _ = codes.shape
    kernels.launch(
        "nw_walk_window", codes.device,
        codes.data_ptr(), nbands, TW, j0, state.data_ptr(), ops.shape[0],
        ops.data_ptr(), 0,
    )
    walk_codes_window.launches += 1


walk_codes_window.launches = 0


def walk_codes_window_plain(
    codes: torch.Tensor, state: torch.Tensor, j0: int, ops: torch.Tensor
) -> None:
    """Plain version of :func:`walk_codes_window` (the same updates of
    ``state`` and ``ops``), one step at a time on the host."""
    _check_window_args(codes, state, ops)
    _, nbands, TW, _ = codes.shape
    words = codes[0].cpu().numpy().view(np.uint32)

    def op_at(r, i):
        t = i + (r & 31)
        return (int(words[r >> 5, t >> 4, r & 31]) >> (2 * (t & 15))) & 3

    _walk_window_plain(op_at, 32 * nbands, 16 * TW - 31, state, j0, ops)


def _walk_window_plain(op_at, rows: int, width: int, state, j0: int, ops) -> None:
    """The window walk on the host: ``op_at(r, i)`` is the op of stored
    row r (cell row j0 + r + 1), column i; a start outside ``rows`` rows
    above j0 or ``width`` columns walks nowhere, as the kernel."""
    i, j, n = state.tolist()
    if j < j0 or j > j0 + rows or i < 0 or i >= width or n < 0:
        return
    steps = []
    S = ops.shape[0]
    while (j > j0 or (j0 == 0 and i > 0)) and n + len(steps) < S:
        a = op_at(j - j0 - 1, i) if j > 0 else OP_LEFT  # row 0 is not stored
        steps.append(a)
        i -= a != OP_UP
        j -= a != OP_LEFT
    if steps:
        ops[n : n + len(steps)] = torch.tensor(steps, dtype=torch.int8)
    state.copy_(torch.tensor([i, j, n + len(steps)], dtype=torch.int32))


def _check_groups_args(codes, state, j0, ops, off, cursor=3):
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CPU or CUDA tensors expected, got {codes.device}")
    if codes.dim() != 4 or codes.dtype != torch.int32 or codes.shape[3] != 32:
        raise ValueError("codes must be int32[B, nbands, TW, 32]")
    B = codes.shape[0]
    if state.shape != (B, cursor) or state.dtype != torch.int32 or not state.is_contiguous():
        what = "(i, j, n)" if cursor == 3 else "(i, j, n, state)"
        raise ValueError(f"state must be a contiguous int32[B, {cursor}]: {what} a pair")
    if ops.dim() != 2 or ops.shape[0] != B or ops.dtype != torch.int8 or not ops.is_contiguous():
        raise ValueError("ops must be a contiguous int8[B, stride]")
    if off is not None and (off.shape != (B,) or off.dtype != torch.int32 or not off.is_contiguous()):
        raise ValueError("off must be a contiguous int32[B]")
    if any(t.device != codes.device for t in (state, ops) + ((off,) if off is not None else ())):
        raise ValueError("codes, state, off and ops must be on one device")
    if j0 < 0:
        raise ValueError(f"j0 must be >= 0, not {j0}")


def walk_codes_groups(
    codes: torch.Tensor, state: torch.Tensor, j0: int, ops: torch.Tensor,
    off: torch.Tensor = None,
) -> None:
    """Greedy backward walk of a batch over one group of rows, in place.

    The counterpart of ``nw_tpu/ops/banded_traceback.py:115
    _make_walk_loop`` (``global_bands=False``): the group walk of the
    two-pass engines.  codes: int32[B, nbands, TW, 32], each pair's codes
    of rows j0+1 .. j0+32*nbands (:func:`nw_tpu_torch.ops.fill_banded.fill_span_banded_batch`
    with ``emit_codes``; code row j - j0 - 1).  state: int32[B, 3] = (i, j,
    n) a pair, read and written back.  Each pair walks from its cell to
    row j0 (to the origin, LEFT along row 0, when j0 is 0); a pair whose
    row lies outside [j0, j0 + 32*nbands] (or whose column lies outside
    the codes) walks nowhere.  Its t-th op here goes to ``ops[b, off[b] +
    t]``, at most ``stride - off[b]`` of them (ops: int8[B, stride]);
    with ``off`` None to ``ops[b, n + t]``, the pair's op string stitched
    in place.  Because the cursor lives in device memory, the groups chain
    on one stream with no host sync.

    CUDA tensors go through the ``nw_walk_groups`` kernel (a warp a pair on
    :func:`walk_codes_batch`'s staging); CPU tensors through
    :func:`walk_codes_groups_plain`.
    """
    _check_groups_args(codes, state, j0, ops, off)
    codes = codes.contiguous()
    _check_codes_aligned(codes)
    if codes.device.type == "cpu":
        return walk_codes_groups_plain(codes, state, j0, ops, off)
    B, nbands, TW, _ = codes.shape
    if B:
        kernels.launch(
            "nw_walk_groups", codes.device,
            codes.data_ptr(), B, nbands, TW, j0, state.data_ptr(),
            None if off is None else off.data_ptr(), ops.shape[1], ops.data_ptr(),
        )
        walk_codes_groups.launches += 1


walk_codes_groups.launches = 0


def walk_codes_groups_plain(
    codes: torch.Tensor, state: torch.Tensor, j0: int, ops: torch.Tensor,
    off: torch.Tensor = None,
) -> None:
    """Plain version of :func:`walk_codes_groups` (the same updates of
    ``state`` and ``ops``), a step of every pair at a time."""
    _check_groups_args(codes, state, j0, ops, off)
    B, nbands, TW, _ = codes.shape
    stride = ops.shape[1]
    b_ar = torch.arange(B, device=codes.device)
    i, j, n = (state[:, x].to(torch.int64) for x in range(3))
    n0 = n.clone()
    o = n0 if off is None else off.to(torch.int64)
    ok = ((j >= j0) & (j <= j0 + 32 * nbands) & (i >= 0) & (i < 16 * TW - 31) & (n >= 0)
          & (o >= 0) & (o <= stride))
    lim = n0 + stride - o
    while True:
        active = ok & (n < lim) & ((j > j0) | ((j0 == 0) & (j == 0) & (i > 0)))
        if not bool(active.any()):
            break
        r = (j - j0 - 1).clamp(0, max(32 * nbands - 1, 0))
        t = (i + (r & 31)).clamp(0, 16 * TW - 1)
        if nbands:
            w = codes[b_ar, r >> 5, t >> 4, r & 31].to(torch.int64)
            a = (w >> (2 * (t & 15))) & 3
        else:
            a = torch.zeros_like(i)
        a = torch.where(j == 0, OP_LEFT, a)
        at = (o + n - n0).clamp(0, max(stride - 1, 0))
        ops[b_ar[active], at[active]] = a[active].to(torch.int8)
        i = i - (active & (a != OP_UP)).to(torch.int64)
        j = j - (active & (a != OP_LEFT)).to(torch.int64)
        n = n + active.to(torch.int64)
    state.copy_(torch.where(ok[:, None], torch.stack([i, j, n], 1), state.to(torch.int64)).to(torch.int32))


def _launch_groups(wrapper, entry, codes, state, j0, ops, off) -> None:
    """Launch group walk ``entry`` (``sw_walk_groups``, ``gotoh_walk_groups``)
    for ``wrapper``, whose count it raises."""
    B, nbands, TW, _ = codes.shape
    if B:
        kernels.launch(
            entry, codes.device,
            codes.data_ptr(), B, nbands, TW, j0, state.data_ptr(),
            None if off is None else off.data_ptr(), ops.shape[1], ops.data_ptr(),
        )
        wrapper.launches += 1


def walk_sw_codes_groups(
    codes: torch.Tensor, state: torch.Tensor, j0: int, ops: torch.Tensor,
    off: torch.Tensor = None,
) -> None:
    """Greedy local walk of a batch over one group of rows, in place: the
    group walk of the variant tracebacks' two-pass route
    (``nw_tpu/ops/variants_banded.py:1300`` and ``:868``, the group walks
    of ``_sw_walk_device`` and ``_overlap_walk_device``).

    :func:`walk_codes_groups`'s contract over local or overlap codes of
    rows j0+1 .. j0+32*nbands
    (:func:`nw_tpu_torch.ops.variants_banded.free_fill_span_banded_batch`
    with ``emit_codes``): each pair walks from its cursor (i, j, n) as
    :func:`walk_sw_codes_batch` walks, and stops on a STOP cell or on
    column 0 (the walk's end: (i, j) is then the cell it stopped on, its
    i_end / j_end) or on row j0 (the group above goes on from there; row
    0 ends it too).  A walk that ended lies below row j0, so the groups
    above leave it as it is.

    CUDA tensors go through the ``sw_walk_groups`` kernel (a warp a pair
    on ``sw_walk``'s staging); CPU tensors through
    :func:`walk_sw_codes_groups_plain`.
    """
    _check_groups_args(codes, state, j0, ops, off)
    codes = codes.contiguous()
    _check_codes_aligned(codes)
    if codes.device.type == "cpu":
        return walk_sw_codes_groups_plain(codes, state, j0, ops, off)
    _launch_groups(walk_sw_codes_groups, "sw_walk_groups", codes, state, j0, ops, off)


walk_sw_codes_groups.launches = 0


def _groups_cursor(codes, state, j0, ops, off, per_word):
    """The plain group walks' start: (i, j, n, the pairs whose cursor lies
    in the group, the ops' offsets, each pair's op cap)."""
    B, nbands, TW, _ = codes.shape
    stride = ops.shape[1]
    i, j, n = (state[:, x].to(torch.int64) for x in range(3))
    o = n.clone() if off is None else off.to(torch.int64)
    ok = ((j >= j0) & (j <= j0 + 32 * nbands) & (i >= 0) & (i < per_word * TW - 31) & (n >= 0)
          & (o >= 0) & (o <= stride))
    return i, j, n, ok, o, n + stride - o


def walk_sw_codes_groups_plain(
    codes: torch.Tensor, state: torch.Tensor, j0: int, ops: torch.Tensor,
    off: torch.Tensor = None,
) -> None:
    """Plain version of :func:`walk_sw_codes_groups` (the same updates of
    ``state`` and ``ops``), a step of every pair at a time."""
    _check_groups_args(codes, state, j0, ops, off)
    B, nbands, TW, _ = codes.shape
    b_ar = torch.arange(B, device=codes.device)
    i, j, n, live, o, lim = _groups_cursor(codes, state, j0, ops, off, 16)
    ok, n0 = live.clone(), n.clone()
    while True:
        live = live & (n < lim) & (j > j0) & (i > 0)
        if not bool(live.any()):
            break
        r = (j - j0 - 1).clamp(0, max(32 * nbands - 1, 0))
        t = (i + (r & 31)).clamp(0, 16 * TW - 1)
        w = codes[b_ar, r >> 5, t >> 4, r & 31].to(torch.int64)
        a = (w >> (2 * (t & 15))) & 3
        live = live & (a != 3)
        at = (o + n - n0).clamp(0, max(ops.shape[1] - 1, 0))
        ops[b_ar[live], at[live]] = a[live].to(torch.int8)
        i = i - (live & (a != OP_UP)).to(torch.int64)
        j = j - (live & (a != OP_LEFT)).to(torch.int64)
        n = n + live.to(torch.int64)
    state.copy_(torch.where(ok[:, None], torch.stack([i, j, n], 1), state.to(torch.int64)).to(torch.int32))


def walk_gotoh_codes_groups(
    codes: torch.Tensor, state: torch.Tensor, j0: int, ops: torch.Tensor,
    off: torch.Tensor = None,
) -> None:
    """Gotoh's three-state walk of a batch over one group of rows, in
    place: the group walk of the Gotoh traceback's two-pass route
    (``nw_tpu/ops/variants_banded.py:1803``, ``_affine_walk_device``).

    :func:`walk_codes_groups`'s contract over 4-bit codes of rows j0+1 ..
    j0+32*nbands
    (:func:`nw_tpu_torch.ops.variants_banded.affine_fill_span_banded_batch`
    with ``emit_codes``), the cursor ``state`` int32[B, 4] = (i, j, n,
    st) carrying the walk's state (0 M, 1 IX, 2 IY) across the groups'
    edges: each pair walks as :func:`walk_gotoh_codes_batch` walks, down
    to row j0 (the origin when j0 is 0), UP along column 0 and LEFT along
    row 0 in any state.

    CUDA tensors go through the ``gotoh_walk_groups`` kernel (a warp a
    pair on ``gotoh_walk``'s staging); CPU tensors through
    :func:`walk_gotoh_codes_groups_plain`.
    """
    _check_groups_args(codes, state, j0, ops, off, cursor=4)
    codes = codes.contiguous()
    _check_codes_aligned(codes)
    if codes.device.type == "cpu":
        return walk_gotoh_codes_groups_plain(codes, state, j0, ops, off)
    _launch_groups(walk_gotoh_codes_groups, "gotoh_walk_groups", codes, state, j0, ops, off)


walk_gotoh_codes_groups.launches = 0


def walk_gotoh_codes_groups_plain(
    codes: torch.Tensor, state: torch.Tensor, j0: int, ops: torch.Tensor,
    off: torch.Tensor = None,
) -> None:
    """Plain version of :func:`walk_gotoh_codes_groups` (the same updates
    of ``state`` and ``ops``), a step of every pair at a time."""
    _check_groups_args(codes, state, j0, ops, off, cursor=4)
    B, nbands, TW, _ = codes.shape
    b_ar = torch.arange(B, device=codes.device)
    i, j, n, ok, o, lim = _groups_cursor(codes, state, j0, ops, off, 8)
    st = state[:, 3].to(torch.int64)
    n0 = n.clone()
    while True:
        active = ok & (n < lim) & ((j > j0) | ((j0 == 0) & (j == 0) & (i > 0)))
        if not bool(active.any()):
            break
        r = (j - j0 - 1).clamp(0, max(32 * nbands - 1, 0))
        t = (i + (r & 31)).clamp(0, 8 * TW - 1)
        if nbands:
            w = codes[b_ar, r >> 5, t >> 3, r & 31].to(torch.int64)
            c = (w >> (4 * (t & 7))) & 15
        else:
            c = torch.zeros_like(i)
        a = torch.where(st == 0, OP_DIAG, torch.where(st == 1, OP_LEFT, OP_UP))
        nxt = torch.where(
            st == 0, c & 3,
            torch.where(st == 1, (c >> 2) & 1, torch.where(((c >> 3) & 1) != 0, 2, 0)),
        )
        edge = (j == 0) | (i == 0)  # row 0: LEFT, column 0: UP, in any state
        a = torch.where(j == 0, OP_LEFT, torch.where(i == 0, OP_UP, a))
        st = torch.where(active & ~edge, nxt, st)
        at = (o + n - n0).clamp(0, max(ops.shape[1] - 1, 0))
        ops[b_ar[active], at[active]] = a[active].to(torch.int8)
        i = i - (active & (a != OP_UP)).to(torch.int64)
        j = j - (active & (a != OP_LEFT)).to(torch.int64)
        n = n + active.to(torch.int64)
    state.copy_(torch.where(ok[:, None], torch.stack([i, j, n, st], 1), state.to(torch.int64)).to(torch.int32))


def walk_masks_window(
    masks: torch.Tensor, state: torch.Tensor, j0: int, ops: torch.Tensor
) -> None:
    """:func:`walk_codes_window` over 3-bit tie masks: the rows j0+1 ..
    j0+rows of one pair as uint8[rows, A+1] (bit0 diag, bit1 left, bit2
    up; row j at j - j0 - 1), as
    :func:`nw_tpu_torch.ops.fill_single.fill_tile` writes them in its
    masks mode.  Each step takes the first set bit in diag > left > up
    order, UP where none is set (``nw_tpu/parallel/huge_pair.py:894-903``);
    the same stops and ``state`` / ``ops`` updates.

    A CUDA tensor goes through ``nw_walk_window``'s masks mode (one warp
    on :func:`walk_masks_batch`'s staging); a CPU tensor through
    :func:`walk_masks_window_plain`.
    """
    _check_window_args(masks, state, ops, masks=True)
    if j0 < 0:
        raise ValueError(f"j0 must be >= 0, not {j0}")
    if masks.device.type == "cpu":
        return walk_masks_window_plain(masks, state, j0, ops)
    rows, M = masks.shape
    kernels.launch(
        "nw_walk_window", masks.device,
        masks.data_ptr(), rows, M, j0, state.data_ptr(), ops.shape[0], ops.data_ptr(), 1,
    )
    walk_masks_window.launches += 1


walk_masks_window.launches = 0


def walk_masks_window_plain(
    masks: torch.Tensor, state: torch.Tensor, j0: int, ops: torch.Tensor
) -> None:
    """Plain version of :func:`walk_masks_window` (the same updates of
    ``state`` and ``ops``), one step at a time on the host."""
    _check_window_args(masks, state, ops, masks=True)
    cells = masks.cpu().numpy()

    def op_at(r, i):
        v = int(cells[r, i])
        return OP_DIAG if v & 1 else (OP_LEFT if v & 2 else OP_UP)

    _walk_window_plain(op_at, *cells.shape, state, j0, ops)


def _sw_max_steps(codes: torch.Tensor) -> int:
    """Ops room of a local walk: i* + j* over any start inside the table."""
    _, nbands, TW, lanes = codes.shape
    return max(16 * TW - lanes + lanes * nbands, 1)


def walk_sw_codes_batch(
    codes: torch.Tensor, j_star: torch.Tensor, i_star: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy local (Smith-Waterman) walk over band-major 2-bit codes.

    codes: int32[B, nbands, TW, 32] from
    :func:`nw_tpu_torch.ops.variants_banded.sw_fill_codes_banded_batch`
    (0 diag / 1 left / 2 up / 3 STOP), or the overlap codes of
    ``overlap_fill_codes_banded_batch`` (STOP on column 0 only); j_star /
    i_star: int32[B], the best cells.  Each walk starts at (j*, i*) and
    stops on a STOP cell,
    on row 0 or on column 0 (cells of score 0, not stored), not at the
    origin as :func:`walk_codes_batch` does.  Returns ops int8[B, S] in
    walk order (OP_NONE padded; S bounds i* + j* for any start in the
    table), n int32[B], and the stop cell i_end, j_end int32[B].

    A CUDA tensor goes through the ``sw_walk`` kernel (a warp a pair on
    :func:`walk_codes_batch`'s staging, which writes a stop over column
    0 and ends on the first cell that reads 0); a CPU tensor through
    :func:`walk_sw_codes_batch_plain`.
    """
    _check_walk_args(codes, i_star, j_star)  # a start is checked as a corner is
    codes = codes.contiguous()
    _check_codes_aligned(codes)
    if codes.device.type == "cpu":
        return walk_sw_codes_batch_plain(codes, j_star, i_star)
    B, nbands, TW, _ = codes.shape
    S = _sw_max_steps(codes)
    dev = codes.device
    ops = torch.full((B, S), OP_NONE, dtype=torch.int8, device=dev)
    n, i_end, j_end = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    if B:
        j_star, i_star = j_star.contiguous(), i_star.contiguous()
        kernels.launch(
            "sw_walk", dev,
            codes.data_ptr(), j_star.data_ptr(), i_star.data_ptr(),
            B, nbands, TW, S, ops.data_ptr(), n.data_ptr(),
            i_end.data_ptr(), j_end.data_ptr(),
        )
        walk_sw_codes_batch.launches += 1
    return ops, n, i_end, j_end


walk_sw_codes_batch.launches = 0


def walk_sw_codes_batch_plain(
    codes: torch.Tensor, j_star: torch.Tensor, i_star: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``sw_walk`` kernel (same outputs)."""
    B = codes.shape[0]
    S = _sw_max_steps(codes)
    dev = codes.device
    b_ar = torch.arange(B, device=dev)
    i = i_star.to(torch.int64).clone()
    j = j_star.to(torch.int64).clone()
    live = torch.ones(B, dtype=torch.bool, device=dev)
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    ops = torch.full((B, S), OP_NONE, dtype=torch.int8, device=dev)
    for t in range(S):
        if t % 256 == 0 and not bool(live.any()):  # every walk has stopped
            break
        jm = (j - 1).clamp(min=0)
        step = i + (jm & 31)
        if codes.shape[1]:
            w = codes[b_ar, jm >> 5, step >> 4, jm & 31].to(torch.int64)
            a = (w >> (2 * (step & 15))) & 3
        else:
            a = torch.full_like(i, 3)
        live = live & (i > 0) & (j > 0) & (a != 3)
        ops[:, t] = torch.where(live, a, OP_NONE).to(torch.int8)
        i = i - (live & (a != OP_UP)).to(torch.int64)
        j = j - (live & (a != OP_LEFT)).to(torch.int64)
        n = n + live.to(torch.int32)
    return ops, n, i.to(torch.int32), j.to(torch.int32)


def walk_gotoh_codes_batch(
    codes: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    states: torch.Tensor, max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gotoh's three-state walk over band-major 4-bit codes.

    codes: int32[B, nbands, TW, 32] from
    :func:`nw_tpu_torch.ops.variants_banded.affine_fill_codes_banded_batch`
    (8 a word); states: int32[B], the corner states (0 M, 1 IX, 2 IY).
    From (len2, len1) in its state a walk emits DIAG in M and moves to
    the state of bits 0-1, LEFT in IX and stays on bit 2, UP in IY and
    stays on bit 3 (else back to M); on row 0 it steps LEFT and on
    column 0 UP to the origin, in any state.  max_steps must be >= every
    len1 + len2.  Returns ops int8[B, max_steps] in walk order (OP_NONE
    padded) and n int32[B].

    A CUDA tensor goes through the ``gotoh_walk`` kernel (a warp a pair:
    each band's code columns copied into shared memory bands ahead of it
    and expanded into a table of byte deltas with the state in the
    address, a step one shared-memory load and one subtract); a CPU
    tensor through :func:`walk_gotoh_codes_batch_plain`.
    """
    _check_walk_args(codes, lens1, lens2, per_word=8)
    if states.shape != lens1.shape or states.dtype != torch.int32 or states.device != codes.device:
        raise ValueError("states must be int32[B] on the codes' device")
    codes = codes.contiguous()
    _check_codes_aligned(codes)
    if codes.device.type == "cpu":
        return walk_gotoh_codes_batch_plain(codes, lens1, lens2, states, max_steps)
    B, nbands, TW, _ = codes.shape
    ops = torch.full((B, max_steps), OP_NONE, dtype=torch.int8, device=codes.device)
    n = torch.empty(B, dtype=torch.int32, device=codes.device)
    if B:
        lens1, lens2, states = (t.contiguous() for t in (lens1, lens2, states))
        kernels.launch(
            "gotoh_walk", codes.device,
            codes.data_ptr(), lens1.data_ptr(), lens2.data_ptr(), states.data_ptr(),
            B, nbands, TW, max_steps, ops.data_ptr(), n.data_ptr(),
        )
        walk_gotoh_codes_batch.launches += 1
    return ops, n


walk_gotoh_codes_batch.launches = 0


def walk_gotoh_codes_batch_plain(
    codes: torch.Tensor, lens1: torch.Tensor, lens2: torch.Tensor,
    states: torch.Tensor, max_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``gotoh_walk`` kernel (same outputs)."""
    B = codes.shape[0]
    dev = codes.device
    b_ar = torch.arange(B, device=dev)
    i = lens1.to(torch.int64).clone()
    j = lens2.to(torch.int64).clone()
    st = states.to(torch.int64).clone()
    n = torch.zeros(B, dtype=torch.int32, device=dev)
    ops = torch.full((B, max_steps), OP_NONE, dtype=torch.int8, device=dev)
    for t in range(max_steps):
        active = (i > 0) | (j > 0)
        if t % 256 == 0 and not bool(active.any()):  # every walk has ended
            break
        jm = (j - 1).clamp(min=0)
        step = i + (jm & 31)
        if codes.shape[1]:
            w = codes[b_ar, jm >> 5, step >> 3, jm & 31].to(torch.int64)
            c = (w >> (4 * (step & 7))) & 15
        else:
            c = torch.zeros_like(i)
        a = torch.where(st == 0, OP_DIAG, torch.where(st == 1, OP_LEFT, OP_UP))
        nxt = torch.where(
            st == 0, c & 3,
            torch.where(st == 1, (c >> 2) & 1, torch.where(((c >> 3) & 1) != 0, 2, 0)),
        )
        edge = (j == 0) | (i == 0)  # row 0: LEFT, column 0: UP, in any state
        a = torch.where(j == 0, OP_LEFT, torch.where(i == 0, OP_UP, a))
        st = torch.where(active & ~edge, nxt, st)
        ops[:, t] = torch.where(active, a, OP_NONE).to(torch.int8)
        i = i - (active & (a != OP_UP)).to(torch.int64)
        j = j - (active & (a != OP_LEFT)).to(torch.int64)
        n = n + active.to(torch.int32)
    return ops, n


def ops_to_strings(ops, n: int, s1: bytes, s2: bytes, gap: int = ord("-")) -> Tuple[bytes, bytes]:
    """Host: the aligned (X, Y) byte strings of one pair's walk, ops
    int8[>= n] (corner -> origin; ``traceback.py:270 ops_to_strings``)."""
    ops = np.asarray(ops)[:n]
    return ops_to_strings_batch(ops[None], np.array([n], np.int32), [(s1, s2)], gap)[0]


def ops_to_strings_batch(
    ops: np.ndarray, ns: np.ndarray, pairs: Sequence[Tuple[bytes, bytes]],
    gap: int = ord("-"),
) -> List[Tuple[bytes, bytes]]:
    """Host: aligned (X, Y) byte strings for a batch of walks.

    ops: int8[B, S] walk op codes (corner -> origin); ns: int32[B];
    pairs: the (s1, s2) byte strings.  The walk consumes characters from
    the ends of the sequences; the reference prints origin -> corner
    (needleman-wunsch.c:149), so each row is reversed.  One pass of the
    native builder when the native runtime loads (``traceback.py:224-228``),
    else :func:`ops_to_strings_batch_plain`; both give the same bytes.
    """
    rt = native.load()
    if rt is not None:
        return rt.ops_to_strings_batch(ops, ns, pairs, gap)
    return ops_to_strings_batch_plain(ops, ns, pairs, gap)


def ops_to_strings_batch_plain(
    ops: np.ndarray, ns: np.ndarray, pairs: Sequence[Tuple[bytes, bytes]],
    gap: int = ord("-"),
) -> List[Tuple[bytes, bytes]]:
    """The numpy path of :func:`ops_to_strings_batch` (a few vectorized
    passes over the ops matrix)."""
    ops = np.asarray(ops)
    ns = np.asarray(ns)
    B, S = ops.shape
    if B == 0:
        return []
    l1 = np.array([len(a) for a, _ in pairs], np.int32)
    l2 = np.array([len(b) for _, b in pairs], np.int32)
    valid = np.arange(S, dtype=np.int32)[None, :] < ns[:, None]
    take1 = (ops != OP_UP) & valid  # diag/left consume an s1 char
    take2 = (ops != OP_LEFT) & valid  # diag/up consume an s2 char
    # index of the consumed char: lengths minus running consumption
    i_idx = l1[:, None] - np.cumsum(take1, axis=1, dtype=np.int32)
    j_idx = l2[:, None] - np.cumsum(take2, axis=1, dtype=np.int32)
    s1m = np.full((B, max(int(l1.max()), 1)), gap, np.uint8)
    s2m = np.full((B, max(int(l2.max()), 1)), gap, np.uint8)
    m1 = np.arange(s1m.shape[1], dtype=np.int32)[None, :] < l1[:, None]
    m2 = np.arange(s2m.shape[1], dtype=np.int32)[None, :] < l2[:, None]
    if l1.sum():
        s1m[m1] = np.frombuffer(b"".join(a for a, _ in pairs), np.uint8)
    if l2.sum():
        s2m[m2] = np.frombuffer(b"".join(b for _, b in pairs), np.uint8)
    rows = np.arange(B)[:, None]
    X = np.where(take1, s1m[rows, np.clip(i_idx, 0, s1m.shape[1] - 1)], np.uint8(gap))
    Y = np.where(take2, s2m[rows, np.clip(j_idx, 0, s2m.shape[1] - 1)], np.uint8(gap))
    return [
        (X[b, : int(ns[b])][::-1].tobytes(), Y[b, : int(ns[b])][::-1].tobytes())
        for b in range(B)
    ]
