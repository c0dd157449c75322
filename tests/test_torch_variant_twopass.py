"""nw_tpu_torch's variant two-pass tracebacks (plain PyTorch) vs nw_tpu on the CPU.

The plain span fills (``free_fill_rows_plain`` and
``affine_fill_rows_plain``, the row-exact cores of
``free_fill_span_banded_batch_plain`` / ``affine_fill_span_banded_batch_plain``)
against ``nw_tpu``'s K18 / K19 / K21 band calls in interpret mode, each
seeded from the boundary row the kernel leaves after the bands before
it; the spans chained over a table against the whole code fills; the
plain group walks chained over groups against the one-pass walks;
``sw_traceback_banded_batch``, ``overlap_traceback_banded_batch`` and
``affine_traceback_banded_batch`` on both routes against ``nw_tpu``'s
functions of the same name (interpret mode, its two-pass engine) and the
port's one-pass route; the model paths with the budget below one pair;
the sub-batch rule.  Inputs from numpy seeds; every output is an integer,
compared exactly (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nw_tpu.models import affine as j_affine
from nw_tpu.models import overlap as j_overlap
from nw_tpu.models import smith_waterman as j_sw
from nw_tpu.ops import variants_banded as jvb
from nw_tpu.ops.encode import encode_batch as jencode_batch
from nw_tpu.ops.fill_pallas_banded import LANES, _geometry, _prep_banded
from nw_tpu_torch.models import affine as af
from nw_tpu_torch.models import needleman_wunsch as nwm
from nw_tpu_torch.models import overlap as ov
from nw_tpu_torch.models import smith_waterman as sw
from nw_tpu_torch.ops import banded_traceback as bt
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import traceback
from nw_tpu_torch.ops import variants_banded as vb
from nw_tpu_torch.ops.fill_banded import SIDE_PAD
from nw_tpu_torch.ops.fill_scan import _free_fill_diag_batch

from torch_kernel_cases import (
    VARIANT_WALK_EDGE_SHAPES, starts_batch, variant_cursor, variant_edge_pairs, variant_groups_walk,
    variant_span_chain,
)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# the scorings where nw_tpu's banded SW kernels follow its scan (k, d >= 0),
# and the port's SW / overlap and Gotoh scorings (chip_smoke.py's), the
# queue-3 cases included
SW_SCAN = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, 2, 2)]
SW_SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2), (1, 1, 2**30), (1, 2**30, 1),
               (2**31 - 1, -(2**31), 2**30), (1, 1, -1)]
GOTOH_SCAN = [(2, 1, 3, 1), (1, 1, 1, 1), (0, 0, 0, 0), (3, -1, 2, 1), (2, 1, 1, 3), (3, 1, 4, 0)]
GOTOH_SCORINGS = GOTOH_SCAN + [(1, 1, -1, -1), (1, 1, 2**28, 2**28), (1, 1, 1, 2**29), (1, 2**30, 3, 1)]
EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG")]
# nw_tpu's variant tracebacks at a small geometry, interpret mode (its
# two-pass engine: the one-pass budget is 0 under interpret)
JKW = dict(interpret=True, band_rows=8, chunk=16, unroll=4, group_bands=2)
DEFAULT_GROUP = bt.GROUP_BANDS


def _pairs(seed, n, lo, hi, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    return [
        tuple(letters[rng.integers(0, len(letters), int(rng.integers(lo, hi + 1)))].tobytes() for _ in range(2))
        for _ in range(n)
    ]


def _edges(S):
    """Pairs whose sides end on a group edge of S bands (32 * S rows) and
    one row either side of it, and one of a single band's rows."""
    rng = np.random.default_rng(S + 100)
    return [(_pairs(int(rng.integers(1 << 20)), 1, 20, 90)[0][0], _pairs(S + e, 1, 32 * S + e, 32 * S + e)[0][1])
            for e in (-1, 0, 1)] + [_pairs(S + 40, 1, 1, 31)[0]]


def _upload(pairs, A=None, Bs=None):
    A = A or max(1, max(len(a) for a, _ in pairs))
    Bs = Bs or max(1, max(len(b) for _, b in pairs))
    return enc.upload(enc.encode_batch(pairs, A, Bs), "cpu")


def _same(got, want, msg=""):
    assert len(got) == len(want), msg
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=msg)


# ---------------- the span fills against K18 / K19 / K21 band calls ----------------


def _k_pairs(seed):
    return _pairs(seed, 6, 1, 48) + [(b"A" * 30, b"A" * 23), (b"ACGT", b"ACGTACGTACGTACGTACG"),
                                     (b"", b"ACG" * 5), (b"ACGTT" * 9, b"CGT")]


def _handoff(M, X, Y, open_, extend):
    """A Gotoh row as the port's pipeline hands it on ((best h, IY of the
    row below, state bits) int32[B, 3, A+1]) from its three states."""
    M, X, Y = (torch.from_numpy(a).to(torch.int64) for a in (M, X, Y))
    h = torch.maximum(torch.maximum(M, X), Y)
    mo, xe, ye = M - open_, X - extend, Y - extend
    st = torch.where(M >= h, 0, torch.where(X >= Y, 1, 2))
    bits = st | ((xe > mo).to(torch.int64) << 2) | ((ye > mo).to(torch.int64) << 3)
    return torch.stack([h, torch.maximum(mo, ye), bits], 1).to(torch.int32).contiguous()


def _k_band_calls(kind, pairs, sc, RB=8, first=2):
    """nw_tpu's band calls of ``kind`` over a 48 x 48 bucket, band by band
    as its two-pass traceback's pass 1 runs them (K18 / K19 with their
    argmax, merged by the scan's tie rule; K21's scores, its corner score
    and state): the boundary row after band first-1 (row RB*first - 1:
    the seed, the port's layout) with the best cell or corners so far,
    and after the last band (row RB*nbands - 1) with those of all bands."""
    A = Bs = 48
    tops, sides, l1, l2 = jencode_batch(pairs, A, Bs)
    B = len(pairs)
    gotoh = kind == "gotoh"
    RB, nbands, C, T_pad, lag0, off, U_pad = _geometry(A, Bs + 1, RB, 8, 8 if gotoh else 4)
    ts, ss, lens, nb_pad = _prep_banded(tops, sides, l1, l2, LANES, T_pad, nbands * RB)

    def row(bnd):  # the producer-step boundary (U_pad, nb_pad) -> rows [B, A+1]
        return np.ascontiguousarray(np.asarray(bnd)[np.arange(A + 1) + RB - 1, :B].T)

    out = dict(row0=RB * first - 1, rows=RB * (nbands - first))
    neg = jnp.full((U_pad, nb_pad), jvb.NEG, jnp.int32)
    if gotoh:
        call = jvb.build_affine_full_call(RB, C, lag0, off, 8, T_pad, U_pad, nb_pad, LANES, True, with_words=False)
        streams = (neg, neg, neg)  # M, IY, IX
        score = np.full(nb_pad, jvb.NEG, np.int64)
        state = np.zeros(nb_pad, np.int64)
        for r in range(nbands):
            if r == first:
                out.update(seed=_handoff(row(streams[0]), row(streams[2]), row(streams[1]), *sc[2:]))
                score = np.full(nb_pad, jvb.NEG, np.int64)
            mb, yb, xb = streams
            ps, pst, *streams = call(jvb._variant_scalars(*sc, r, RB, lens, B), ts, ss, lens, mb, mb, yb, yb, xb, xb)
            ps, pst = np.asarray(ps)[0], np.asarray(pst)[0]
            state = np.where(ps > score, pst, state)
            score = np.maximum(score, ps)
        out.update(last=_handoff(row(streams[0]), row(streams[2]), row(streams[1]), *sc[2:]),
                   scores=score[:B], states=state[:B])
        return out
    build = jvb.build_sw_call if kind == "sw" else jvb.build_overlap_call
    call = build(RB, C, off, lag0, 4, T_pad, U_pad, nb_pad, LANES, True, with_argmax=True)
    bnd = neg
    best = np.zeros(nb_pad, np.int64)
    kst = np.full(nb_pad, 0 if kind == "sw" else jvb.BIG, np.int64)
    jst = kst.copy()
    for r in range(nbands):
        if r == first:
            pos = best > 0
            out.update(seed=torch.from_numpy(row(bnd)), key0=torch.from_numpy(
                np.stack([best, np.where(pos, kst, 0), np.where(pos, jst, 0)], 1)[:B].astype(np.int32)))
        pb, pk, pj, bnd = call(jvb._variant_scalars(*sc, 0, r, RB, lens, B), ts, ss, lens, bnd, bnd)
        pb, pk, pj = (np.asarray(x)[0] for x in (pb, pk, pj))
        upd = (pb > best) | ((pb == best) & ((pk < kst) | ((pk == kst) & (pj < jst))))
        best, kst, jst = np.maximum(best, pb), np.where(upd, pk, kst), np.where(upd, pj, jst)
    out.update(last=torch.from_numpy(row(bnd)), best=best[:B], kst=kst[:B], jst=jst[:B])
    return out


@pytest.mark.parametrize("mkd", SW_SCAN)
@pytest.mark.parametrize("kind", ["sw", "overlap"])
def test_free_span_plain_matches_k18_k19_band_calls(kind, mkd):
    """The plain free span from K18's / K19's boundary row after bands 0-1
    (row 15 of 8-row bands), its key the best cell of those bands, over
    the rows the kernel sweeps next: its last row (columns 0 .. A) and the
    merged best, and where the best is positive its anti-diagonal and
    row, equal the kernel's."""
    pairs = _k_pairs(sum(mkd) + (kind == "sw"))
    k = _k_band_calls(kind, pairs, mkd)
    T = _upload(pairs, 48, 48)
    bnd, key = k["seed"].clone(), k["key0"].clone()
    vb.free_fill_rows_plain(*T, *mkd, k["row0"], k["rows"], bnd, key, kind == "sw")
    torch.testing.assert_close(bnd, k["last"], rtol=0, atol=0)
    np.testing.assert_array_equal(key[:, 0].numpy(), k["best"])
    pos = k["best"] > 0
    assert pos.any() == (mkd[0] > 0)
    np.testing.assert_array_equal(key[pos, 1].numpy(), k["kst"][pos])
    np.testing.assert_array_equal(key[pos, 2].numpy(), k["jst"][pos])


@pytest.mark.parametrize("sc", GOTOH_SCAN)
def test_gotoh_span_plain_matches_k21_band_calls(sc):
    """The plain Gotoh span from K21's boundary streams after bands 0-1
    (row 15, turned into the port's hand-on row: best h, IY of the row
    below, state bits) over the rows K21 sweeps next: its last row (h and
    IY below on columns 0 .. len1; the state bits but the next cell's
    IX-extend bit, which no band below reads) and the scores and corner
    states of the pairs whose corner lies there, equal K21's."""
    pairs = _k_pairs(sum(sc) % 89)
    k = _k_band_calls("gotoh", pairs, sc)
    T = _upload(pairs, 48, 48)
    B = len(pairs)
    bnd = k["seed"].clone()
    scores, states = torch.full((B,), 7, dtype=torch.int32), torch.full((B,), 7, dtype=torch.int32)
    vb.affine_fill_rows_plain(*T, *sc, k["row0"], k["rows"], bnd, scores, states)
    inside = (T[3] > k["row0"]) & (T[3] <= k["row0"] + k["rows"])
    assert inside.any() and not inside.all()
    np.testing.assert_array_equal(scores[inside].numpy(), k["scores"][inside.numpy()])
    np.testing.assert_array_equal(states[inside].numpy(), k["states"][inside.numpy()])
    assert (scores[~inside] == 7).all() and (states[~inside] == 7).all()
    for b, l1 in enumerate(T[2].tolist()):
        want, got = k["last"][b, :, : l1 + 1], bnd[b, :, : l1 + 1]
        torch.testing.assert_close(got[:2], want[:2], rtol=0, atol=0)
        torch.testing.assert_close(got[2] & 11, want[2] & 11, rtol=0, atol=0)


# ---------------- the spans chained against the whole fills ----------------


def _chain_vs_whole(kind, T, sc, S):
    """The plain span fill of ``kind`` chained from row 0 in spans of S
    bands (with codes, and as pass 1 sweeps it, without) against the
    whole code fill: codes, best and cell (Gotoh: scores and states), and
    the last row against the one span of the whole table."""
    nbands = -(-T[1].shape[1] // 32)
    got = variant_span_chain(T, sc, kind, S, plain=True)
    (whole_span,) = variant_span_chain(T, sc, kind, nbands, plain=True)
    no_codes = variant_span_chain(T, sc, kind, S, plain=True, emit_codes=False)
    if kind == "gotoh":
        codes, scores, states = vb.affine_fill_codes_banded_batch_plain(*T, *sc)
        outs, picks = (scores, states), (1, 2)
    else:
        fill = vb.sw_fill_codes_banded_batch_plain if kind == "sw" else vb.overlap_fill_codes_banded_batch_plain
        codes, *outs = fill(*T, *sc)
        picks = (2, 3, 4)
    torch.testing.assert_close(torch.cat([x[-1] for x in got], 1), codes, rtol=0, atol=0)
    for p, o in zip(picks, outs):
        torch.testing.assert_close(got[-1][p], o, rtol=0, atol=0)
        torch.testing.assert_close(no_codes[-1][p], o, rtol=0, atol=0)
    for a, b in zip(got[-1][:-1], whole_span[:-1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(no_codes[-1][0], whole_span[0], rtol=0, atol=0)
    return got


@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("kind", ["sw", "overlap"])
def test_free_span_chain_matches_the_whole_fill(kind, S):
    """Spans of S bands of a 4-band table (equal bests in two bands, the
    later on an earlier anti-diagonal; pairs on span edges) give the whole
    fill's codes, best, j* and i* under every scoring, and the last row,
    row 128 over the pads past Bs, of the whole table's free sweep."""
    pairs = (_pairs(S, 5, 1, 100) + _edges(1) + _edges(2) + EDGE
             + [(b"A" * 40, b"A" * 70), (b"T" * 10 + b"C" * 30 + b"A" * 10 + b"C" * 10,
                                          b"A" * 10 + b"G" * 23 + b"T" * 10 + b"G" * 2)])
    T = _upload(pairs, 110, 110)
    for mkd in SW_SCORINGS:
        got = _chain_vs_whole(kind, T, mkd, S)
        side = torch.cat([T[1], torch.full((len(pairs), 18), SIDE_PAD, dtype=torch.int32)], 1)
        last = _free_fill_diag_batch(T[0], side, T[2], T[3], *mkd, False, kind == "sw",
                                     seed=torch.zeros(len(pairs), 111, dtype=torch.int32), with_last=True)["last"]
        torch.testing.assert_close(got[-1][0], last, rtol=0, atol=0)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_gotoh_span_chain_matches_the_whole_fill(S):
    """Spans of S bands of a 4-band table give the whole Gotoh fill's
    codes, scores and corner states under every scoring, near the
    sentinel too; the corner of each pair is written by its span alone."""
    pairs = _pairs(S + 7, 5, 1, 100) + _edges(1) + _edges(2) + EDGE + [(b"ACGT", b"T" * 100 + b"ACGT")]
    T = _upload(pairs, 110, 110)
    for sc in GOTOH_SCORINGS:
        _chain_vs_whole("gotoh", T, sc, S)
    B = len(pairs)
    bnd = torch.empty(B, 3, 111, dtype=torch.int32)
    for r0 in range(0, 4, S):
        scores, states = torch.full((B,), 7, dtype=torch.int32), torch.full((B,), 7, dtype=torch.int32)
        vb.affine_fill_span_banded_batch(*T, 2, 1, 3, 1, r0, S, bnd, scores, states)
        mine = ((T[3] > 32 * r0) & (T[3] <= 32 * (r0 + S))) | ((T[3] == 0) & (r0 == 0))
        assert (scores[~mine] == 7).all() and (states[~mine] == 7).all() and (states[mine] != 7).all()


def test_spans_past_the_table_and_their_checks():
    """A span from past the last band sweeps nothing (its codes have no
    band) and keeps the row and the key; a table of no row takes its
    result off row 0; the wrappers refuse bad buffers."""
    T = _upload([(b"ACGT", b"AC"), (b"", b"")], 4, 2)
    B = 2
    bufs = [torch.zeros(B, 5, dtype=torch.int32), torch.zeros(B, 3, dtype=torch.int32),
            *(torch.zeros(B, dtype=torch.int32) for _ in range(3))]
    vb.free_fill_span_banded_batch(*T, 2, 1, 1, 0, 1, *bufs, True)
    keep = [x.clone() for x in bufs]
    codes = vb.free_fill_span_banded_batch(*T, 2, 1, 1, 3, 2, *bufs, True, emit_codes=True)
    assert codes.shape[1] == 0 and all(torch.equal(a, b) for a, b in zip(bufs, keep))
    assert bufs[2].tolist() == [4, 0]  # AC on ACGT
    g = [torch.empty(B, 3, 5, dtype=torch.int32), torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)]
    assert vb.affine_fill_span_banded_batch(*T, 2, 1, 3, 1, 3, 1, *g, emit_codes=True).shape[1] == 0
    T0 = _upload([(b"ACGT", b""), (b"", b"")], 4, 1)
    vb.affine_fill_span_banded_batch(*T0, 2, 1, 3, 1, 0, 1, *g)
    assert g[1].tolist() == [-6, 0] and g[2].tolist() == [1, 0]
    with pytest.raises(ValueError, match="span"):
        vb.free_fill_span_banded_batch(*T, 2, 1, 1, 0, 0, *bufs, True)
    with pytest.raises(ValueError, match="key"):
        vb.free_fill_span_banded_batch(*T, 2, 1, 1, 0, 1, bufs[0], bufs[2], *bufs[2:], True)
    with pytest.raises(ValueError, match="bnd"):
        vb.affine_fill_span_banded_batch(*T, 2, 1, 3, 1, 0, 1, g[0][:, :2].contiguous(), *g[1:])


# ---------------- the group walks ----------------


@pytest.mark.parametrize("shape", VARIANT_WALK_EDGE_SHAPES)
@pytest.mark.parametrize("kind", ["sw", "overlap", "gotoh"])
def test_group_walk_chain_matches_the_one_pass_walk(kind, shape):
    """The plain local (SW and overlap codes) and Gotoh group walks chained
    over groups of 1, 2 and 3 bands, last group first, from each fill's
    start (the best cell; the corner in its state) and from every edge
    start of each table (Gotoh: in a state turning with the start), equal
    the one-pass walk's ops and n (and the cell where a local walk
    stopped) at the variant walk edge shapes."""
    T = _upload(variant_edge_pairs(shape))
    if kind == "gotoh":
        walk, S = traceback.walk_gotoh_codes_groups, T[0].shape[1] + T[1].shape[1]
        fill = vb.affine_fill_codes_banded_batch_plain(*T, 2, 1, 3, 1)
        codes, _, states = fill
        sub, js, is_ = starts_batch(codes, T[2], T[3], 8)
        st = torch.where(js == 0, 1, torch.where(is_ == 0, 2, torch.arange(len(js)) % 3)).int()
        cases = [(codes, variant_cursor("gotoh", fill, T), traceback.walk_gotoh_codes_batch_plain(
                     codes, T[2], T[3], states, S)),
                 (sub, torch.stack([is_, js, torch.zeros_like(js), st], 1).contiguous(),
                  traceback.walk_gotoh_codes_batch_plain(sub, is_, js, st, S))]
    else:
        walk = traceback.walk_sw_codes_groups
        fill = getattr(vb, f"{kind}_fill_codes_banded_batch_plain")(*T, 2, 1, 1)
        codes = fill[0]
        S = traceback._sw_max_steps(codes)
        sub, js, is_ = starts_batch(codes, T[2], T[3], 16)
        cases = [(codes, variant_cursor(kind, fill, T), traceback.walk_sw_codes_batch_plain(codes, fill[2], fill[3])),
                 (sub, torch.stack([is_, js, torch.zeros_like(js)], 1).contiguous(),
                  traceback.walk_sw_codes_batch_plain(sub, js, is_))]
    for c, start, want in cases:
        for G in (1, 2, 3):
            state, ops = variant_groups_walk(walk, c, start, G, S)
            torch.testing.assert_close(ops, want[0], rtol=0, atol=0)
            torch.testing.assert_close(state[:, 2], want[1], rtol=0, atol=0)
            if kind != "gotoh":
                torch.testing.assert_close(state[:, 0], want[2], rtol=0, atol=0)
                torch.testing.assert_close(state[:, 1], want[3], rtol=0, atol=0)


def test_group_walks_limits_and_starts_outside():
    """A start outside the group's rows or columns walks nowhere and
    keeps its cursor; a finished local walk (below the group) stays; a
    walk stops after stride - off ops, its ops at off; the cursor's
    shape is checked."""
    T = _upload([(b"GATTACAGATTACA", b"GCATGCATGCAT" * 4)], 16, 48)
    codes, _, js, is_ = vb.sw_fill_codes_banded_batch_plain(*T, 2, 1, 1)  # 2 bands
    TW = codes.shape[2]
    for start, j0 in (([5, 48, 0], 64), ([5, 10, 0], 32), ([16 * TW - 31, 40, 0], 32)):
        state = torch.tensor([start], dtype=torch.int32)
        ops = torch.full((1, 8), 3, dtype=torch.int8)
        traceback.walk_sw_codes_groups(codes[:, 1:].contiguous(), state, j0, ops)
        assert state.tolist() == [start] and (ops == 3).all()
    want = traceback.walk_sw_codes_batch_plain(codes, js, is_)
    state = torch.stack([is_, js, torch.zeros_like(js)], 1).contiguous()
    ops = torch.full((1, 10), 3, dtype=torch.int8)
    traceback.walk_sw_codes_groups(codes, state, 0, ops, torch.tensor([4], dtype=torch.int32))
    assert state[0, 2] == min(6, int(want[1][0])) and torch.equal(ops[0, 4 : 4 + int(state[0, 2])],
                                                                 want[0][0, : int(state[0, 2])])
    gcodes, _, states = vb.affine_fill_codes_banded_batch_plain(*T, 2, 1, 3, 1)
    for start, j0 in (([5, 48, 0, 0], 64), ([5, 10, 0, 2], 32), ([8 * gcodes.shape[2] - 31, 40, 0, 1], 32)):
        state = torch.tensor([start], dtype=torch.int32)
        ops = torch.full((1, 8), 3, dtype=torch.int8)
        traceback.walk_gotoh_codes_groups(gcodes[:, 1:].contiguous(), state, j0, ops)
        assert state.tolist() == [start] and (ops == 3).all()
    with pytest.raises(ValueError, match="state"):
        traceback.walk_gotoh_codes_groups(gcodes, torch.zeros(1, 3, dtype=torch.int32), 0, ops)
    with pytest.raises(ValueError, match="state"):
        traceback.walk_sw_codes_groups(codes, torch.zeros(1, 4, dtype=torch.int32), 0, ops)


# ---------------- the three functions on both routes ----------------


def _dispatch(kind, T, sc, **kw):
    """The dispatcher of ``kind`` on T, and whether it took the two-pass
    route (ran pass 1)."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vb, "_group_checkpoints", lambda *a: calls.append(1) or _group_checkpoints(*a))
        out = (vb.affine_traceback_dispatch(*T, *sc, **kw) if kind == "gotoh"
               else vb.free_traceback_dispatch(*T, *sc, kind == "sw", **kw))
    return out, bool(calls)


_group_checkpoints = vb._group_checkpoints


def _route(kind, pairs, sc, onepass):
    """The route ``onepass`` names, forced with NW_TPU_ONEPASS_HBM."""
    T = _upload(pairs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NW_TPU_ONEPASS_HBM", str(1 << 50) if onepass else "0")
        out, twopass = _dispatch(kind, T, sc)
    assert twopass != onepass
    if kind == "gotoh":
        return tuple(x.numpy() for x in (out.scores, out.ops, out.n))
    return tuple(x.numpy() for x in (out.scores, out.j_star, out.i_star, out.j_end, out.i_end, out.ops, out.n))


def _function(kind, pairs, sc):
    """The port's public function of ``kind`` on the route the budget picks."""
    T = _upload(pairs)
    name = "affine" if kind == "gotoh" else kind
    return getattr(vb, f"{name}_traceback_banded_batch")(*T, *sc)


def _nw_tpu(kind, pairs, sc):
    A = max(1, max(len(a) for a, _ in pairs))
    Bs = max(1, max(len(b) for _, b in pairs))
    name = "affine" if kind == "gotoh" else kind
    out = getattr(jvb, f"{name}_traceback_banded_batch")(*jencode_batch(pairs, A, Bs), *sc, **JKW)
    return tuple(np.asarray(x) for x in out)


def _mix(seed):
    return _pairs(seed, 6, 1, 60) + EDGE + _edges(1) + _edges(2)


@pytest.mark.parametrize("kind", ["sw", "overlap", "gotoh"])
def test_functions_on_both_routes_match_nw_tpu(monkeypatch, kind):
    """sw_ / overlap_ / affine_traceback_banded_batch with
    NW_TPU_ONEPASS_HBM at 0 (the two-pass route, groups of 1 and 2 bands
    and the default height) and large (the one-pass route) equal nw_tpu's
    function of the same name with the same setting (interpret mode,
    8-row bands, groups of 2), at the scorings where nw_tpu follows its
    scan: the pairs of test_banded.py:164's mix and pairs on the edges of
    1- and 2-band groups."""
    pairs = _mix(len(kind))
    for sc in (GOTOH_SCAN if kind == "gotoh" else SW_SCAN)[:3]:
        monkeypatch.setenv("NW_TPU_ONEPASS_HBM", "0")
        want = _nw_tpu(kind, pairs, sc)
        for S in (1, 2, DEFAULT_GROUP):
            monkeypatch.setattr(bt, "GROUP_BANDS", S)
            _same(_function(kind, pairs, sc), want, f"two-pass, {sc}, S = {S}")
        monkeypatch.setenv("NW_TPU_ONEPASS_HBM", str(1 << 40))
        _same(_function(kind, pairs, sc), want, f"one-pass, {sc}")
        _same(_nw_tpu(kind, pairs, sc), want, f"nw_tpu's one-pass engine, {sc}")


@pytest.mark.parametrize("kind", ["sw", "overlap", "gotoh"])
def test_two_pass_route_matches_the_one_pass_route(monkeypatch, kind):
    """The two-pass route (groups of 1, 2 and 3 bands) equals the one-pass
    route at every scoring of chip_smoke.py's SW_SCORINGS /
    GOTOH_ALIGN_SCORINGS and more, the queue-3 cases included (where the
    port follows the scan and nw_tpu does not); a batch of one pair, an
    odd batch, an empty batch."""
    pairs = _mix(len(kind) + 30) + _pairs(kind == "sw", 3, 90, 140, b"AC")
    for sc in GOTOH_SCORINGS if kind == "gotoh" else SW_SCORINGS:
        want = _route(kind, pairs, sc, True)
        for S in (1, 2, 3):
            monkeypatch.setattr(bt, "GROUP_BANDS", S)
            _same(_route(kind, pairs, sc, False), want, f"{sc}, S = {S}")
    monkeypatch.setattr(bt, "GROUP_BANDS", 1)
    for sub in (pairs[:1], pairs[:7]):
        _same(_route(kind, sub, (2, 1, 3, 1)[: 4 if kind == "gotoh" else 3], False),
              _route(kind, sub, (2, 1, 3, 1)[: 4 if kind == "gotoh" else 3], True))
    monkeypatch.setenv("NW_TPU_ONEPASS_HBM", "0")
    T = enc.upload(enc.encode_batch([], 8, 8), "cpu")
    out, _ = _dispatch(kind, T, (2, 1, 3, 1)[: 4 if kind == "gotoh" else 3])
    assert out.scores.shape == (0,) and out.ops.shape[0] == 0


def test_queue3_scorings_follow_the_scan(monkeypatch):
    """Where nw_tpu's kernels leave its scan (ROADMAP queue 3) the port
    follows the scan on both routes: SW at d < 0, where K18 leaves column
    0 free and nw_tpu's function reports another best; Gotoh near the
    sentinel (1 1 2^28 2^28, 1 1 1 2^29, 1 2^30 3 1), its scores nw_tpu's
    scan's (affine_score)."""
    monkeypatch.setenv("NW_TPU_ONEPASS_HBM", "0")
    monkeypatch.setattr(bt, "GROUP_BANDS", 1)
    pairs = [(b"ACGTAC", b"TTACG"), (b"GATTACA", b"GCAT"), (b"A" * 40, b"C" * 40 + b"A")]
    mkd = (1, 1, -1)
    want = [j_sw.sw_align(a, b, *mkd)[0] for a, b in pairs]
    for onepass in (True, False):
        np.testing.assert_array_equal(_route("sw", pairs, mkd, onepass)[0], want)
    assert not np.array_equal(_nw_tpu("sw", pairs, mkd)[0], want)
    pairs = [(b"ACGT", b"T" * 40 + b"ACGT"), (b"GATTACA", b"GCAT"), (b"T" * 70, b"A")]
    for sc in GOTOH_SCORINGS[-3:]:
        want = [int(j_affine.affine_score(enc.encode(a), enc.encode(b), *sc)) for a, b in pairs]
        for onepass in (True, False):
            np.testing.assert_array_equal(_route("gotoh", pairs, sc, onepass)[0], want)


# ---------------- the model paths and the sub-batch rule ----------------


@pytest.mark.parametrize("budget", ["0", "small"])
def test_model_paths_below_one_pair_match_the_scans(monkeypatch, budget):
    """sw_align_batch, overlap_align_batch and affine_align_batch with
    NW_TPU_ONEPASS_HBM below one pair's codes take the two-pass route (a
    span fill and a group walk a group) and equal the scan models
    (sw_align, overlap_align, affine_align), here and in nw_tpu."""
    pairs = _pairs(41, 5, 30, 110) + [(b"GATTACA", b"GCAT"), (b"ACGT", b"")]
    L1, L2 = (max(len(p[x]) for p in pairs) for x in (0, 1))
    one = vb.code_table_bytes(L1, L2)
    monkeypatch.setenv("NW_TPU_ONEPASS_HBM", "0" if budget == "0" else str(one - 1))
    monkeypatch.setattr(bt, "GROUP_BANDS", 1)
    calls = {"sw": 0, "gotoh": 0}
    free_walk, gotoh_walk = vb.walk_sw_codes_groups, vb.walk_gotoh_codes_groups

    def count(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    monkeypatch.setattr(vb, "walk_sw_codes_groups", count("sw", free_walk))
    monkeypatch.setattr(vb, "walk_gotoh_codes_groups", count("gotoh", gotoh_walk))
    got = sw.sw_align_batch(pairs, 2, 1, 1, device="cpu")
    assert got == [sw.sw_align(a, b, 2, 1, 1, device="cpu") for a, b in pairs]
    assert [g[0] for g in got] == [j_sw.sw_align(a, b, 2, 1, 1)[0] for a, b in pairs]
    got = ov.overlap_align_batch(pairs, 2, 3, 3, device="cpu")
    assert [g[:3] for g in got] == [ov.overlap_align(a, b, 2, 3, 3, device="cpu")[:3] for a, b in pairs]
    assert [g[:3] for g in got] == [tuple(j_overlap.overlap_align(a, b, 2, 3, 3))[:3] for a, b in pairs]
    got = af.affine_align_batch(pairs, 2, 1, 3, 1, device="cpu")
    assert got == [tuple(j_affine.affine_align(a, b, 2, 1, 3, 1)) for a, b in pairs]
    assert calls["sw"] >= 2 * -(-L2 // 32) and calls["gotoh"] >= -(-L2 // 32)


def test_inputs_that_fit_keep_the_one_pass_route(monkeypatch):
    """A batch whose codes fit the budget takes the one-pass route (one
    code fill, no span fill), under CODE_BUDGET_BYTES and under
    NW_TPU_ONEPASS_HBM; the model paths cut sub-batches as before."""
    monkeypatch.delenv("NW_TPU_ONEPASS_HBM", raising=False)
    pairs = _pairs(5, 4, 10, 60)
    T = _upload(pairs)
    assert not _dispatch("sw", T, (2, 1, 1))[1]
    assert not _dispatch("gotoh", T, (2, 1, 3, 1))[1]
    four = 4 * vb.code_table_bytes(T[0].shape[1], T[1].shape[1])
    four4 = 4 * vb.code_table_bytes(T[0].shape[1], T[1].shape[1], 4)
    assert not _dispatch("gotoh", T, (2, 1, 3, 1), budget=four4)[1]
    assert _dispatch("gotoh", T, (2, 1, 3, 1), budget=four4 - 1)[1]
    monkeypatch.setenv("NW_TPU_ONEPASS_HBM", str(four))
    assert not _dispatch("overlap", T, (2, 1, 1))[1]
    monkeypatch.setenv("NW_TPU_ONEPASS_HBM", str(four - 1))
    assert _dispatch("overlap", T, (2, 1, 1))[1]
    monkeypatch.delenv("NW_TPU_ONEPASS_HBM")
    L = 10240
    assert vb.variant_sub_batch(L, L, 2, nwm.CODE_BUDGET_BYTES) == 653
    assert vb.variant_sub_batch(L, L, 4, nwm.CODE_BUDGET_BYTES) == 326
    # a sub-batch the rule cuts takes the route its budget gives: one-pass
    # above, two-pass past the budget (one 270 kb SW pair, one 190 kb
    # Gotoh pair)
    for bits, chunk in ((2, 653), (4, 326)):
        assert vb._takes_onepass(chunk, L, L, bits, nwm.CODE_BUDGET_BYTES)
    for bits, L in ((2, 270_000), (4, 190_000)):
        assert vb.code_table_bytes(L, L, bits) > nwm.CODE_BUDGET_BYTES
        chunk = vb.variant_sub_batch(L, L, bits, nwm.CODE_BUDGET_BYTES)
        assert chunk >= 1 and not vb._takes_onepass(chunk, L, L, bits, nwm.CODE_BUDGET_BYTES)
        assert chunk * vb.twopass_pair_bytes(L, L, bits) <= nwm.CODE_BUDGET_BYTES
    assert vb.onepass_budget() == nwm.CODE_BUDGET_BYTES
    monkeypatch.setenv("NW_TPU_ONEPASS_HBM", "123")
    assert vb.onepass_budget() == 123
