"""Exact greedy traceback of a batch at any side length.

Counterpart of ``nw_tpu/ops/banded_traceback.py``
(``traceback_banded_dispatch`` / ``_finalize`` / ``_batch``,
``default_walk_engine``, the two-pass engine's ``_make_group_fns`` /
``_banded_walk_device`` and ``_compact_group_ops``).  Every engine gives
the first alignment the reference emits, identical to
:func:`nw_tpu_torch.ops.traceback.traceback_greedy_batch` on full tie
masks.  The walk engine (``engine=``, else ``NW_TPU_WALK_ENGINE``, as in
``nw_tpu``) picks what is stored:

* ``auto`` and ``onepass``: the 2-bit greedy code of every cell
  (``nw_fill_codes``: ~26 MB for a 10 kb pair, 3.4 GB for 128 of them,
  well inside 80 GB) and the step-by-step walk (``nw_walk``);
* ``runs``: the run byte of every cell, the greedy code and the length
  of its same-code run (``nw_fill_runs_batch``, K2's ``with_runs`` mode:
  a byte a cell, 105 MB for a 10 kb pair) and the run-skip walk
  (``nw_walk_runs``), one load a run.  Kept for parity with ``nw_tpu``'s
  engine choice only: on the H100 it gives the codes engine's outputs
  more slowly (4x the bytes a cell, two sub-batches at config 3; PERF.md
  section 5), so no workload should pick it.  It goes, with its branch
  here, once no counterpart of K2's ``with_runs`` mode is asked for;
* ``twopass`` and ``hoststitch``: the checkpointed re-fill engines
  (:class:`TwoPass`).  Pass 1 sweeps the scores (and counts) group by
  group, :data:`GROUP_BANDS` 32-row bands a group (``nw_fill_span``), and
  keeps the boundary row entering each group; pass 2 visits the groups
  last first, re-fills a group's codes from its row (``nw_fill_span``'s
  codes variant) and walks every pair whose cursor lies in it
  (``nw_walk_groups``).  ``twopass`` writes each pair's ops in place at
  its running count (the stitch done on the device); ``hoststitch``
  writes each group's ops as a prefix of its own, copies the prefixes to
  the host 2-bit packed and stitches them there
  (:func:`compact_group_ops`).  A sub-batch holds the checkpoint rows
  and one group's codes, not a whole table (:func:`engine_pair_bytes`).
  They are for parity with ``nw_tpu`` and for the resumable walk
  (:class:`nw_tpu_torch.runtime.checkpoint.ResumableBandedTraceback`):
  ``auto`` never needs them for memory, since it cuts sub-batches under
  the code budget.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from nw_tpu_torch.ops.fill_banded import (
    _check,
    fill_greedy_counts_banded_batch,
    fill_runs_banded_batch,
    fill_span_checked,
    span_row0,
)
from nw_tpu_torch.ops.fill_scan import U32, code_shape
from nw_tpu_torch.ops.traceback import (
    OP_NONE,
    walk_codes_batch,
    walk_codes_groups,
    walk_runs_batch,
)

ENGINES = ("auto", "onepass", "runs", "twopass", "hoststitch")
# A two-pass group: 64 bands of 32 rows.  Each span launch re-pays the
# pipeline's ramp (band b + 1 starts two chunks behind band b: ~2(W-1)
# chunks of the span's first round), and each group is one walk launch;
# at 10 kb (320 bands) 64 makes 5 groups, whose ramps add ~2% to a whole
# sweep at W = 16, while a group's codes stay 1/5 of the table
GROUP_BANDS = 64


def default_walk_engine() -> str:
    """The walk engine ``NW_TPU_WALK_ENGINE`` names, ``auto`` by default."""
    return os.environ.get("NW_TPU_WALK_ENGINE", "auto")


def resolve_walk_engine(engine: Optional[str] = None) -> str:
    """``engine`` (None: :func:`default_walk_engine`) checked: one of
    :data:`ENGINES`, any other name raises ``ValueError``."""
    if engine is None:
        engine = default_walk_engine()
    if engine not in ENGINES:
        raise ValueError(f"unknown walk engine {engine!r}; expected one of {sorted(ENGINES)}")
    return engine


def group_bands(Bs: int) -> int:
    """The two-pass engines' group height in 32-row bands at a side bucket
    of ``Bs`` rows: :data:`GROUP_BANDS`, no more than the table's bands."""
    return max(1, min(GROUP_BANDS, -(-Bs // 32)))


def engine_pair_bytes(L1: int, L2: int, engine: str) -> int:
    """Device bytes one pair spends on ``engine``'s per-cell state at
    buckets (L1, L2): the 2-bit codes of the whole table (``auto``,
    ``onepass``), its run bytes (``runs``, uint8[L2+1, L1+1]), or, on the
    two-pass engines, the checkpoint rows (int32[L1+1] a group) and one
    group's codes, with ``hoststitch``'s op prefixes (a byte an op, a
    group's at most 32 * GROUP_BANDS + L1)."""
    if engine == "runs":
        return (L1 + 1) * (L2 + 1)
    if engine in ("twopass", "hoststitch"):
        S = group_bands(L2)
        ngroups = max(1, -(-(-(-L2 // 32)) // S))
        _, _, TW, lanes = code_shape(1, L1, 32 * S)
        out = ngroups * 4 * (L1 + 1) + S * TW * lanes * 4
        if engine == "hoststitch":
            out += ngroups * _group_cap(L1, S)
        return out
    _, nbands, TW, lanes = code_shape(1, L1, L2)
    return nbands * TW * lanes * 4


def _group_cap(A: int, S: int) -> int:
    """A pair's ops in one group at most (32 * S rows up, A columns
    left), rounded up to whole packed bytes of four."""
    return -(-(32 * S + A) // 4) * 4


class BandedWalk(NamedTuple):
    """Device outputs of one dispatched sub-batch."""

    scores: torch.Tensor  # int32[B]
    counts: Optional[torch.Tensor]  # int64[B] in [0, 2^32), or None
    ops: torch.Tensor  # int8[B, A + Bs]; hoststitch: uint8[ngroups, B, cap // 4], packed prefixes
    n: torch.Tensor  # int32[B]; hoststitch: int32[ngroups, B], each prefix's ops
    engine: str  # the walk engine that made them
    width: int = 0  # hoststitch: the stitched op strings' width, A + Bs


class TwoPass:
    """The two-pass engines' passes on one encoded sub-batch (int32
    tops[B, A] / sides[B, Bs] / lens1 / lens2[B] on one device), shared
    by :func:`traceback_banded_dispatch` and the resumable runner: the
    counterpart of ``nw_tpu/ops/banded_traceback.py:55 _make_group_fns``.
    The variant tracebacks' two-pass route runs the same passes over
    their own fills and walks
    (:class:`nw_tpu_torch.ops.variants_banded.FreeTwoPass`,
    :class:`~nw_tpu_torch.ops.variants_banded.GotohTwoPass`), which
    override :meth:`start`, :meth:`_sweep`, :meth:`_refill`, :meth:`_walk`
    and the cursor.

    Group g holds bands g*S .. g*S+S-1 (rows 32*g*S+1 .. 32*(g+1)*S, the
    last group cut at the table's last band), S = :func:`group_bands`.
    :meth:`checkpoint_pass` sweeps the scores (and counts) and hands over
    the boundary row entering each group, the group's checkpoint;
    :meth:`walk_pass` re-fills each group's codes from its checkpoint and
    walks every pair through it, last group first.  Both start at any
    group (a resumed run's) and call ``on_span`` after every ``every``
    groups, where the resumable runner saves.  Nothing is copied to the
    host."""

    def __init__(self, tops, sides, lens1, lens2, m, k, d, with_counts: bool = False):
        _check(tops, sides, lens1, lens2, m, k, d)
        self._setup(tops, sides, lens1, lens2, (m, k, d))
        self.with_counts = with_counts

    def _setup(self, tops, sides, lens1, lens2, scoring) -> None:
        """The groups' geometry of a checked batch, ``scoring`` the fill's."""
        self.T = (tops, sides, lens1, lens2)
        self.mkd = scoring
        self.B, self.A = tops.shape
        self.Bs = sides.shape[1]
        self.S = group_bands(self.Bs)
        self.ngroups = max(1, -(-(-(-self.Bs // 32)) // self.S))
        self.width = max(self.A + self.Bs, 1)
        self.cap = _group_cap(self.A, self.S)
        self.device = tops.device

    def start(self):
        """Pass 1's carry before group 0: (bnd, cbnd or None, scores,
        counts or None), int32, row 0 in bnd / cbnd."""
        bnd, cbnd = span_row0(self.B, self.A, self.mkd[2], self.with_counts, self.device)
        scores = torch.zeros(self.B, dtype=torch.int32, device=self.device)
        counts = torch.zeros_like(scores) if self.with_counts else None
        return bnd, cbnd, scores, counts

    def _span(self, g, bnd, cbnd, scores, counts, emit_codes):
        return fill_span_checked(*self.T, *self.mkd, g * self.S, self.S, bnd, cbnd, scores, counts, emit_codes)

    def _sweep(self, g, carry) -> None:
        """Pass 1 over group g, in place on ``carry``."""
        bnd, cbnd, scores, counts = carry
        self._span(g, bnd, cbnd, scores, counts, False)

    def _refill(self, g, row) -> torch.Tensor:
        """Group g's codes, re-filled from its checkpoint ``row``
        (consumed)."""
        junk = torch.empty(self.B, dtype=torch.int32, device=self.device)
        return self._span(g, row, None, junk, None, True)

    def _walk(self, codes, state, j0, ops, off=None) -> None:
        walk_codes_groups(codes, state, j0, ops, off)

    def checkpoint_pass(self, carry, keep, done: int = 0, every: Optional[int] = None, on_span=None) -> None:
        """Pass 1 from group ``done`` on, in place on ``carry`` = (bnd,
        cbnd, scores, counts) (:meth:`start`'s, or a saved one; a
        variant's own carry, its boundary row first):
        ``keep(g, bnd)`` takes the checkpoint row entering group g before
        ``nw_fill_span`` (scores, or scores + counts) sweeps the group, and
        ``on_span(done)`` follows every ``every`` groups (default: all),
        ``done`` the groups swept so far."""
        every = every or self.ngroups
        while done < self.ngroups:
            for g in range(done, min(done + every, self.ngroups)):
                keep(g, carry[0])
                self._sweep(g, carry)
            done = min(done + every, self.ngroups)
            if on_span is not None:
                on_span(done)

    def cursor(self) -> torch.Tensor:
        """Every walk's start, int32[B, 3]: the true corner, no ops yet."""
        l1, l2 = self.T[2], self.T[3]
        return torch.stack([l1, l2, torch.zeros_like(l1)], 1).to(torch.int32).contiguous()

    def walk_pass(self, checkpoint, state: torch.Tensor, ops: Optional[torch.Tensor] = None, done: int = 0,
                  every: Optional[int] = None, on_span=None) -> None:
        """Pass 2, the groups last first from the ``done``-th on: group
        g's codes re-filled from ``checkpoint(g)`` (int32[B, A+1],
        consumed) and every pair walked from its cursor ``state``
        (:meth:`cursor`'s, or a saved one; int32[B, 3] = (i, j, n), in
        place) up to the group's top row
        (:func:`nw_tpu_torch.ops.traceback.walk_codes_groups`).  With
        ``ops`` (int8[B, A+Bs]) each pair's ops go in place at its running
        n, the stitch done on the device (``twopass``); without, each
        group's ops go to a prefix of their own.  ``on_span(done, ops4,
        ng)`` follows every ``every`` groups (default: all), ``done`` the
        groups walked so far, with the span's prefixes 2-bit packed
        (uint8[n, B, cap // 4], :func:`pack_ops4`) and their lengths
        (int32[n, B]), or None, None with ``ops``."""
        G, dev = self.ngroups, self.device
        every = every or G
        zero = torch.zeros(self.B, dtype=torch.int32, device=dev)
        while done < G:
            n = min(every, G - done)
            if ops is None:
                prefixes = torch.full((n, self.B, self.cap), OP_NONE, dtype=torch.int8, device=dev)
                ng = torch.empty((n, self.B), dtype=torch.int32, device=dev)
            for idx in range(n):
                g = G - 1 - (done + idx)
                codes = self._refill(g, checkpoint(g))
                if ops is None:
                    before = state[:, 2].clone()
                    self._walk(codes, state, 32 * g * self.S, prefixes[idx], zero)
                    ng[idx] = state[:, 2] - before
                else:
                    self._walk(codes, state, 32 * g * self.S, ops)
                del codes
            done += n
            if on_span is not None:
                on_span(done, *((None, None) if ops is not None else (pack_ops4(prefixes), ng)))


def pack_ops4(ops: torch.Tensor) -> torch.Tensor:
    """int8 ops [..., cap] (cap a multiple of 4, each op 0-3) -> uint8
    [..., cap // 4], four ops a byte, the first in the low bits."""
    o = ops.to(torch.uint8) & 3
    return o[..., 0::4] | o[..., 1::4] << 2 | o[..., 2::4] << 4 | o[..., 3::4] << 6


# the four ops of each packed byte, int8[256, 4]
_UNPACK = ((np.arange(256)[:, None] >> (2 * np.arange(4))[None, :]) & 3).astype(np.int8)


def compact_group_ops(ops4: np.ndarray, ng_stack: np.ndarray, s_total: int):
    """Stitch per-group op prefixes into per-pair op strings on the host.

    The port's copy of ``nw_tpu/ops/banded_traceback.py:935
    _compact_group_ops``, in the port's layout: ops4 uint8[ngroups, B,
    cap // 4], each group's ops in walk order (groups last first) packed
    by :func:`pack_ops4`, pair b's real ops of group gi its first
    ng_stack[gi, b].  A copy a prefix, each unpacked alone (``nw_tpu``'s
    masked scatter over every slot took ~40x as long at config 3's
    shapes).  Returns (ops int8[B, max(s_total, 1)] OP_NONE padded, n
    int32[B])."""
    ops4 = np.asarray(ops4)
    ng = np.asarray(ng_stack).astype(np.int64)
    out = np.full((ops4.shape[1], max(s_total, 1)), OP_NONE, np.int8)
    n = ng.sum(0)
    for b in np.flatnonzero(n):
        c = 0
        for gi in np.flatnonzero(ng[:, b]):
            k = int(ng[gi, b])
            out[b, c : c + k] = _UNPACK[ops4[gi, b, : (k + 3) // 4]].reshape(-1)[:k]
            c += k
    return out, n.astype(np.int32)


def _twopass_dispatch(tops, sides, lens1, lens2, m, k, d, with_counts, engine):
    tp = TwoPass(tops, sides, lens1, lens2, m, k, d, with_counts)
    carry = tp.start()
    cps = torch.empty((tp.ngroups, tp.B, tp.A + 1), dtype=torch.int32, device=tp.device)
    tp.checkpoint_pass(carry, lambda g, bnd: cps[g].copy_(bnd))
    scores, counts = carry[2], carry[3]
    del carry
    counts = counts.to(torch.int64) & U32 if with_counts else None
    state = tp.cursor()
    if engine == "twopass":
        ops = torch.full((tp.B, tp.width), OP_NONE, dtype=torch.int8, device=tp.device)
        tp.walk_pass(cps.__getitem__, state, ops)
        return BandedWalk(scores, counts, ops, state[:, 2].clone(), engine)
    spans = []
    tp.walk_pass(cps.__getitem__, state, on_span=lambda done, ops4, ng: spans.append((ops4, ng)))
    (ops4, ng), = spans
    return BandedWalk(scores, counts, ops4, ng, engine, tp.width)


def traceback_banded_dispatch(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False,
    engine: Optional[str] = None,
) -> BandedWalk:
    """Enqueue the fill and the walk of one sub-batch on ``engine``'s
    route; nothing is copied to the host.  The per-cell table is freed
    when this returns (the caching allocator keeps its memory in stream
    order)."""
    engine = resolve_walk_engine(engine)
    if engine in ("twopass", "hoststitch"):
        return _twopass_dispatch(tops, sides, lens1, lens2, m, k, d, with_counts, engine)
    A, Bs = tops.shape[1], sides.shape[1]
    if engine == "runs":
        fill, walk = fill_runs_banded_batch, walk_runs_batch
    else:
        fill, walk = fill_greedy_counts_banded_batch, walk_codes_batch
    table, scores, counts = fill(tops, sides, lens1, lens2, m, k, d, with_counts=with_counts)
    ops, n = walk(table, lens1, lens2, max(A + Bs, 1))
    return BandedWalk(scores, counts, ops, n, engine)


def traceback_banded_finalize(out: BandedWalk):
    """Copy one dispatched sub-batch to the host: (scores int32[B],
    [counts uint32[B],] ops int8[B, S], n int32[B]); ``hoststitch``'s
    per-group prefixes are stitched here (:func:`compact_group_ops`)."""
    scores = out.scores.cpu().numpy()
    if out.engine == "hoststitch":
        ops, n = compact_group_ops(out.ops.cpu().numpy(), out.n.cpu().numpy(), out.width)
    else:
        ops = out.ops.cpu().numpy()
        n = out.n.cpu().numpy()
    if out.counts is None:
        return scores, ops, n
    counts = out.counts.cpu().numpy().astype(np.uint32)
    return scores, counts, ops, n


def traceback_banded_batch(
    tops, sides, lens1, lens2, m, k, d, with_counts: bool = False,
    engine: Optional[str] = None,
):
    """Greedy traceback of a batch: (scores, ops, n), or (scores,
    counts, ops, n) with ``with_counts`` — host numpy arrays with the
    op-code semantics of :func:`nw_tpu_torch.ops.traceback.traceback_greedy_batch`
    (corner -> origin, diag > left > up, OP_NONE padded), the same on
    every engine."""
    return traceback_banded_finalize(
        traceback_banded_dispatch(
            tops, sides, lens1, lens2, m, k, d, with_counts=with_counts, engine=engine
        )
    )
