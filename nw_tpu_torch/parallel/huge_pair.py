"""Cross-rank huge-pair mode: one DP table tiled over the ranks of a mesh
axis, the counterpart of ``nw_tpu/parallel/huge_pair.py`` (BASELINE
config 5: a pair too large for one device, or one device's patience).

Geometry (the port's own; ``nw_tpu``'s row quanta and fold layouts are TPU
tuning).  The side string's rows are cut into blocks of
``H = ceil(B / ranks)``: rank ``p`` owns rows ``(p*H, (p+1)*H]`` (ranks
past the last row own none and sit the fill out).  The top string's
columns are cut into chunks of ``C`` (``chunk``): tile ``(p, c)`` is rows
``(p*H, (p+1)*H]`` x columns ``(c*C, (c+1)*C]``, one ``nw_fill_tile``
launch (:func:`~nw_tpu_torch.ops.fill_single.fill_tile`: K14's mesh half,
or K28 in the masks mode).  A chunk of columns, not of diagonals: the
tile kernel sweeps its rows band by band from a top halo and a left edge,
so a rectangle is what it takes.

The fill is the pipelined wavefront of ``nw_tpu``'s phase loop: at phase
``s`` rank ``p`` fills chunk ``c = s - p`` from the halo rank ``p-1``
sent for it (its last row over the chunk's columns; rank 0's halo is row
0) and its own right edge of chunk ``c-1``, then sends its last row to
rank ``p+1`` — ``nphases = nch + ranks - 1`` phases for ``nch`` chunks,
so once the pipeline has filled every rank works on its own chunk.  No
rank waits for a phase barrier: a rank blocks only on the halo it needs.
:class:`_TiledFill` holds a rank's whole carry (its rows' table, its left
edge, the corner of its next halo) and runs any span of phases, so a
caller can run phases ``s0 .. s1`` alone.

The halo is the last row's *values*; every decision (code or tie mask)
is recomputed from values on the rank that owns the cell, so the table is
the one-device table bit for bit.  Every halo value is a true int32 value
of the table: rank 0's top halo is row 0 (``-i*d``, wrapped) and column 0
is ``-j*d`` on every rank, so nothing rests on ``nw_tpu``'s NEG_INF
decay, and the corner score is broadcast from the rank that owns it (not
``nw_tpu``'s ``pmax`` over ranks, whose NEG_INF sentinels beat any true
corner below -2^30).

The exact greedy walk is a relay (``_make_relay_walk``): the rank that
owns the corner walks its rows from ``(A, B)`` (``nw_walk_window``, the
codes or the masks mode) until it reaches its top row ``p*H``, sends the
head ``(i, j)`` to rank ``p-1``, which walks on; rank 0 steps LEFT along
row 0 to the origin.  The segments are gathered and stitched in walk
order (``_stitch_segments``).  A segment ends one row lower than
``nw_tpu``'s (its device ``p`` owns rows ``[pH, (p+1)H)``), which moves
no op.

Transport: ``torch.distributed`` point-to-point on the axis's group —
device tensors under NCCL (a card a rank), host tensors under gloo (ranks
that share a card, or CPU ranks), staged through pinned host memory when
the kernels run on a card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from nw_tpu_torch.models.needleman_wunsch import resolve_device
from nw_tpu_torch.ops.fill_scan import code_shape
from nw_tpu_torch.ops.fill_single import fill_tile
from nw_tpu_torch.ops.traceback import OP_LEFT, OP_NONE, walk_codes_window, walk_masks_window
from nw_tpu_torch.parallel.distributed import coll_device
from nw_tpu_torch.parallel.mesh import axis_group

LANES = 128  # nw_tpu's fold width, for auto_chunk's arithmetic
ENGINES = ("pallasb", "pallas", "scan")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _wrap32(x):
    """int64 values as the int32 values they wrap to."""
    return (x + 2**31) % 2**32 - 2**31


def _gaps(start: int, stop: int, d: int, device) -> torch.Tensor:
    """int32[stop - start]: ``-i*d`` for i in [start, stop), wrapped — row
    0 at columns start.., or column 0 at rows start.."""
    vals = _wrap32(np.arange(start, stop, dtype=np.int64) * np.int64(-d))
    return torch.from_numpy(vals.astype(np.int32)).to(device)


def _new_table(mode: str, A: int, rows: int, device) -> Optional[torch.Tensor]:
    """A rank's zeroed table of ``rows`` rows: 2-bit codes, tie masks or
    (scores) none."""
    if mode == "codes":
        return torch.zeros(code_shape(1, A, rows), dtype=torch.int32, device=device)
    if mode == "masks":
        return torch.zeros((rows, A + 1), dtype=torch.uint8, device=device)
    return None


# ---------------- nw_tpu's chunk geometry (auto_chunk, pipeline_efficiency) ----------------


def _pick_fb(B: int, nseq: int) -> int:
    """``nw_tpu``'s fold-row block height (``huge_pair.py:610``), which
    sets its row quantum and so :func:`auto_chunk`'s numbers."""
    base = B + 1
    best, best_cost = 1, float("inf")
    for fb, pen in (
        (96, 1.0), (128, 1.01), (64, 1.17), (32, 2.0), (16, 3.5),
        (8, 6.0), (4, 9.0), (2, 13.0), (1, 20.0),
    ):
        n_pad = _round_up(base, nseq * LANES * fb)
        cost = (n_pad / base) * pen
        if cost < best_cost:
            best, best_cost = fb, cost
    return best


def _row_quantum(B, nseq, engine):
    if engine == "pallasb":
        return nseq * LANES * _pick_fb(B, nseq)
    if engine == "pallas":
        return nseq * LANES
    return nseq


def auto_chunk(
    A: int, B: int, nseq: int, engine: str = "pallas",
    target_eff: float = 0.875, c_min: int = 128, c_max: int = 2048,
    traceback: bool = False,
) -> int:
    """``nw_tpu``'s halo-chunk size C (``huge_pair.py:1316``), number for
    number: the largest C of diagonals (clamped to [c_min, c_max] and the
    engine's word quantum) whose ``nch / (nch + nseq - 1)`` meets
    ``target_eff`` over ``nw_tpu``'s padded rows.  The port's own chunk of
    columns is :func:`tile_chunk`."""
    N_pad = _round_up(B + 1, _row_quantum(B, nseq, engine))
    q = 16 if engine == "pallasb" else 4
    if engine == "pallasb" and traceback:
        c_max = min(c_max, 1024)
    if nseq <= 1:
        return max(q, min(c_max, A + N_pad) // q * q)
    need = int(np.ceil((nseq - 1) * target_eff / (1.0 - target_eff)))
    C = max(c_min, min(c_max, (A + N_pad) // max(need, 1)))
    C = min(C, A + N_pad)
    return max(q, C // q * q)


def pipeline_efficiency(A: int, B: int, nseq: int, chunk: int, engine: str = "pallas") -> float:
    """``nw_tpu``'s useful-phase fraction ``nch / nphases`` of its tiled
    fill at ``chunk`` diagonals (``huge_pair.py:1350``).  The port's own
    is ``nch / nphases`` of :func:`tile_geometry`."""
    N_pad = _round_up(B + 1, _row_quantum(B, nseq, engine))
    nch = _round_up(A + N_pad, chunk) // chunk
    return nch / (nch + nseq - 1)


# ---------------- the port's tiles ----------------


def tile_chunk(A: int, B: int, nseq: int) -> int:
    """The port's default chunk: the width (a multiple of 32 columns)
    whose phase loop takes the fewest band steps,
    ``nphases x (2H + C)``.  A tile of H rows x C columns runs its 32-row
    bands as a wavefront of its own (``nw_fill_tile`` on the single-pair
    pipeline: each band two 32-column chunks behind the one above), so
    each launch pays a depth of 2H steps again: more chunks overlap the
    ranks better and pay that depth more often.  A tile's time follows
    its 2H + C steps (5.6-6.0 us per 100 steps for every chunk of a
    100 kb pair at 1, 2 and 4 ranks on an H100 80GB HBM3 at 700 W,
    ``scripts/sharded_cards.py 4 2 1``), and the count picks the fills
    it times fastest: one tile of the whole width at 1 or 2 ranks of a
    square pair (16.9 / 22.3 ms), 3 chunks at 4 (28.7 ms, within 2.5% of
    2 chunks' 28.0), 2 for a 20 kb pair."""
    H = max(1, -(-B // nseq))
    best = None
    for nch in range(1, max(1, -(-A // 32)) + 1):
        C = max(32, _round_up(-(-A // nch), 32))
        steps = tile_geometry(A, B, nseq, C)[2] * (2 * H + C)
        if best is None or steps < best[0]:
            best = (steps, C)
    return best[1]


def tile_geometry(A: int, B: int, nseq: int, chunk: int):
    """(H, nch, nphases): rows a rank, column chunks, pipeline phases."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, not {chunk}")
    H = max(1, -(-B // nseq))
    nch = max(1, -(-A // chunk))  # A = 0: one tile of column 0 alone
    return H, nch, nch + nseq - 1


def _pick_engine(engine: Optional[str]) -> str:
    """The tile kernel's mode by ``nw_tpu``'s engine names: ``pallasb``
    (the default) 2-bit codes, ``pallas`` tie masks (K28), ``scan`` the
    plain tile."""
    engine = "pallasb" if engine is None else engine
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES} or None, not {engine!r}")
    return engine


# ---------------- transport ----------------


class _Links:
    """One rank's two neighbours on the axis: halos go down (p to p+1),
    the walk's head goes up.  Sends are asynchronous and kept until they
    complete.  Host seconds: ``seconds`` staging and posting messages,
    ``wait_seconds`` blocked until a message arrives (which includes the
    sender's compute: the pipeline's stalls)."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.p = dist.get_rank(group)
        self.n = dist.get_world_size(group)
        self.wire = coll_device(group)
        self.pinned = self.wire.type == "cpu" and device.type == "cuda"
        self.seconds = self.wait_seconds = 0.0
        self._sends = []

    def _host(self, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=self.pinned)

    def send(self, t: torch.Tensor, q: int) -> None:
        if self.wire != t.device:
            if t.is_cuda:  # the kernel that made t is compute, not exchange
                torch.cuda.current_stream(t.device).synchronize()
            t0 = time.perf_counter()
            buf = self._host(t)
            buf.copy_(t)
        else:
            t0 = time.perf_counter()
            buf = t
        self._sends.append((dist.isend(buf, dist.get_global_rank(self.group, q), group=self.group), buf))
        self._sends = [(w, b) for w, b in self._sends if not w.is_completed()]
        self.seconds += time.perf_counter() - t0

    def recv(self, like: torch.Tensor, q: int) -> torch.Tensor:
        """A tensor shaped as ``like`` from rank ``q``, on ``like``'s device."""
        buf = like if self.wire == like.device else self._host(like)
        t0 = time.perf_counter()
        dist.recv(buf, dist.get_global_rank(self.group, q), group=self.group)
        t1 = time.perf_counter()
        out = buf.to(like.device, non_blocking=True)
        self.wait_seconds += t1 - t0
        self.seconds += time.perf_counter() - t1
        return out

    def flush(self) -> None:
        for w, _ in self._sends:
            w.wait()
        self._sends = []


# ---------------- the fill ----------------


class _TiledFill:
    """One rank's carry of the tiled fill and its phase loop.

    ``mode``: ``"scores"`` (edges and the corner only), ``"codes"``
    (2-bit greedy codes of the rank's rows, the K14 tile) or ``"masks"``
    (tie masks, the K28 tile).  The carry: ``table`` (the rank's codes or
    masks), ``left`` (its column ``c*C`` at its rows, on the device),
    ``tail`` (its halo's corner, row ``p*H`` at column ``c*C``) and
    ``score`` (the corner, on its owner, after the last chunk).
    """

    def __init__(self, top, side, m, k, d, chunk, mode, links: _Links, device):
        self.A, self.B = top.shape[0], side.shape[0]
        self.m, self.k, self.d = m, k, d
        self.C = chunk
        self.H, self.nch, self.nphases = tile_geometry(self.A, self.B, links.n, chunk)
        self.links = links
        p = links.p
        self.r0 = p * self.H
        self.rows = max(0, min(self.B, self.r0 + self.H) - self.r0)
        self.next_rows = min(self.B, self.r0 + 2 * self.H) > self.r0 + self.H
        self.top = top.to(device)
        self.side = side[self.r0 : self.r0 + self.rows].to(device)
        self.device = device
        self.left = _gaps(self.r0 + 1, self.r0 + self.rows + 1, d, device)
        self.tail = _gaps(self.r0, self.r0 + 1, d, device)
        self.table = _new_table(mode, self.A, self.rows, device)
        self.mode = mode
        self.score = None

    def phase(self, s: int) -> None:
        """Phase ``s``: this rank's chunk ``s - p``, when it has one."""
        p, c = self.links.p, s - self.links.p
        if not self.rows or not 0 <= c < self.nch:
            return
        c0 = c * self.C
        cc = min(self.C, self.A - c0)
        if p == 0:  # row 0
            halo = _gaps(c0, c0 + cc + 1, self.d, self.device)
        elif cc:
            got = self.links.recv(torch.empty(cc, dtype=torch.int32, device=self.device), p - 1)
            halo = torch.cat([self.tail, got])
            self.tail = got[-1:]
        else:
            halo = self.tail
        codes = self.table if self.mode == "codes" else None
        masks = self.table if self.mode == "masks" else None
        self.left, bottom, score = fill_tile(
            self.top, self.side, self.m, self.k, self.d, c0, cc, halo, self.left, codes, masks,
        )
        if cc and self.next_rows:
            self.links.send(bottom, p + 1)
        if c == self.nch - 1:
            self.score = score

    def run(self, s0: int, s1: int) -> None:
        for s in range(s0, s1):
            self.phase(s)


def chain_tiles(top: torch.Tensor, side: torch.Tensor, m: int, k: int, d: int,
                H: int, C: int, mode: str = "codes", tile=fill_tile, **launch):
    """Every rank's tiles in one process, block after block: the tiled
    fill without transport, for checking the tile kernel against one
    fill of the whole pair.  ``top`` / ``side`` int32 on one device;
    blocks of ``H`` rows, chunks of ``C`` columns; ``mode`` as
    :class:`_TiledFill`; ``tile`` is
    :func:`~nw_tpu_torch.ops.fill_single.fill_tile` (or its plain
    version, on any device), ``launch`` its ``warps`` / ``blocks``.
    Returns (the blocks' tables, the last row int32[A+1], the corner
    score)."""
    A, B = top.shape[0], side.shape[0]
    dev = top.device
    row = _gaps(0, A + 1, d, dev)
    tables, score = [], int(row[A])
    for r0 in range(0, B, H):
        h = min(H, B - r0)
        left = _gaps(r0 + 1, r0 + h + 1, d, dev)
        table = _new_table(mode, A, h, dev)
        nxt = row.clone()
        nxt[0] = left[-1]
        for c0 in range(0, max(A, 1), C):
            cc = min(C, A - c0)
            left, bottom, sc = tile(
                top, side[r0 : r0 + h], m, k, d, c0, cc, row[c0 : c0 + cc + 1].clone(), left,
                table if mode == "codes" else None, table if mode == "masks" else None, **launch,
            )
            nxt[c0 + 1 : c0 + cc + 1] = bottom
        row, score = nxt, int(sc)
        tables.append(table)
    return tables, row, score


# ---------------- the walk ----------------


def _relay_walk(fill: _TiledFill) -> torch.Tensor:
    """This rank's segment of the greedy walk (int8 ops on the host, in
    walk order), relayed from the corner's owner down to rank 0."""
    links, H, A, B = fill.links, fill.H, fill.A, fill.B
    p = links.p
    owner = (B - 1) // H
    if p > owner:
        return torch.empty(0, dtype=torch.int8)
    dev = fill.device
    state = torch.tensor([A, B, 0], dtype=torch.int32, device=dev)
    if p < owner:
        state[:2] = links.recv(torch.empty(2, dtype=torch.int32, device=dev), p + 1)
    ops = torch.full((A + fill.rows + 1,), OP_NONE, dtype=torch.int8, device=dev)
    walk = walk_masks_window if fill.mode == "masks" else walk_codes_window
    walk(fill.table, state, fill.r0, ops)
    i, j, n = state.tolist()
    if j != fill.r0 or (p == 0 and i != 0):
        raise RuntimeError(f"rank {p}'s walk stopped at ({i}, {j}), not on row {fill.r0}")
    if p > 0:
        links.send(state[:2].clone(), p - 1)
    return ops[:n].cpu()


def _gather_segments(seg: torch.Tensor, group, n: int) -> np.ndarray:
    """Every rank's segment, stitched in walk order (the corner's owner
    first, rank 0 last)."""
    if n == 1:
        return seg.numpy()
    dev = coll_device(group)
    lens = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(seg)], dtype=torch.int64, device=dev), group=group)
    lens = [int(x) for x in lens]
    width = max(max(lens), 1)
    mine = torch.full((width,), OP_NONE, dtype=torch.int8, device=dev)
    mine[: len(seg)] = seg.to(dev)
    parts = [torch.empty(width, dtype=torch.int8, device=dev) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    return torch.cat([parts[q][: lens[q]] for q in reversed(range(n))]).cpu().numpy()


def _broadcast_score(score: Optional[torch.Tensor], owner: int, group, n: int) -> int:
    if n == 1:
        return int(score)
    dev = coll_device(group)
    t = torch.zeros(1, dtype=torch.int32, device=dev)
    if score is not None:
        t.copy_(score.reshape(1))
    dist.broadcast(t, dist.get_global_rank(group, owner), group=group)
    return int(t)


# ---------------- API ----------------


@dataclasses.dataclass
class HugeShardedResult:
    score: int
    ops: np.ndarray  # int8[n] op codes, corner -> origin
    n: int
    # host seconds of this rank: "fill" (its phases, to the end of its
    # last tile), of which "halo" staging and posting halos and
    # "halo_wait" blocked for one; "walk" and "stitch"
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sharded(top, side, m, k, d, mesh, axis, chunk, engine, device, traceback):
    dev = resolve_device(device, "huge_pair_sharded")
    engine = _pick_engine(engine)
    if engine == "scan" and dev.type == "cuda":
        raise ValueError("engine='scan' is the plain tile: it runs with device='cpu' only")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    group = axis_group(mesh, axis)
    links = _Links(group, dev)
    top, side = (torch.as_tensor(x, dtype=torch.int32) for x in (top, side))
    A, B = top.shape[0], side.shape[0]
    if B == 0:  # row 0 alone: no rank owns a row
        score = int(_wrap32(A * -int(d)))
        return score, np.full(A, OP_LEFT, np.int8), {}
    if chunk is None:
        chunk = tile_chunk(A, B, links.n)
    mode = ("masks" if engine != "pallasb" else "codes") if traceback else "scores"
    timings = {}
    t0 = time.perf_counter()
    fill = _TiledFill(top, side, m, k, d, chunk, mode, links, dev)
    fill.run(0, fill.nphases)
    _sync(dev)
    timings["fill"] = time.perf_counter() - t0
    timings["halo"], timings["halo_wait"] = links.seconds, links.wait_seconds
    owner = (B - 1) // fill.H
    score = _broadcast_score(fill.score, owner, group, links.n)
    ops = None
    if traceback:
        t1 = time.perf_counter()
        seg = _relay_walk(fill)
        timings["walk"] = time.perf_counter() - t1
        t2 = time.perf_counter()
        ops = _gather_segments(seg, group, links.n)
        timings["stitch"] = time.perf_counter() - t2
    links.flush()
    return score, ops, timings


def huge_pair_score_sharded(
    top, side, m: int, k: int, d: int, mesh, axis: str = "seq",
    chunk: Optional[int] = None, engine: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> int:
    """Score of ONE huge pair, rows sharded over ``axis`` (collective).

    ``top`` / ``side``: the whole pair's encoded strings (int32, numpy
    or torch) on every rank.  ``chunk``: columns a tile (default
    :func:`tile_chunk`).  ``engine``: ``None`` / ``"pallasb"`` /
    ``"pallas"`` run ``nw_fill_tile``'s scores mode on the card,
    ``"scan"`` the plain tile, with ``device="cpu"`` only; with
    ``device="cpu"`` every engine runs the plain tile.  Every rank
    returns the score, broadcast from the rank that owns the corner.
    """
    return _sharded(top, side, m, k, d, mesh, axis, chunk, engine, device, False)[0]


def huge_pair_align_sharded(
    top, side, m: int, k: int, d: int, mesh, axis: str = "seq",
    chunk: Optional[int] = None, engine: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> HugeShardedResult:
    """Exact first-emission alignment of ONE huge pair across the ranks
    (collective): byte-identical to ``nw_tpu``'s at every scoring where
    ``nw_tpu`` follows its own ``fill_scan``, and to ``fill_scan``'s
    walk at every other.

    The fill is the tiled wavefront; each rank keeps its rows' 2-bit
    codes (``engine`` ``None`` / ``"pallasb"``) or tie masks
    (``"pallas"``; ``"scan"``: the plain tile, ``device="cpu"`` only)
    on its device; the walk relays from rank to rank.  Returns op codes
    with :mod:`nw_tpu_torch.ops.traceback` semantics (``ops_to_strings``)
    on every rank; other arguments as :func:`huge_pair_score_sharded`.
    """
    score, ops, timings = _sharded(top, side, m, k, d, mesh, axis, chunk, engine, device, True)
    return HugeShardedResult(score=score, ops=ops, n=len(ops), timings=timings)
