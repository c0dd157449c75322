"""nw_tpu_torch's two-pass walk engines (plain PyTorch) vs nw_tpu on the CPU.

The plain band-span fill (``fill_span_banded_batch_plain`` and its
row-exact core ``fill_rows_plain``) against ``nw_tpu``'s K1 and K2 band
calls in interpret mode, each seeded from the boundary row K2 leaves
after the bands before it; the span chained over a table against the
whole fill; the plain group walk against the one-pass walk; the
``twopass`` and ``hoststitch`` engines against ``nw_tpu``'s engines of
the same name in interpret mode and the port's codes engine (the pair mix
of ``tests/test_banded.py:164``, pairs on group edges, one group);
``align_batch`` through ``NW_TPU_WALK_ENGINE``; the large scoring where
``nw_tpu``'s banded kernels leave fill_scan and the port does not; the
host stitch against ``nw_tpu``'s; the memory rule.  Every output is an
integer: comparisons are exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nw_tpu
from nw_tpu.ops.banded_traceback import _compact_group_ops as j_compact_group_ops
from nw_tpu.ops.banded_traceback import traceback_banded_batch as j_traceback_banded_batch
from nw_tpu.ops.encode import encode_batch as jencode_batch
from nw_tpu.ops.fill_pallas_banded import (
    LANES,
    NEG_INF,
    _band_scalars,
    _geometry,
    _prep_banded,
    build_arrows_call,
    build_scores_call,
)
from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
from nw_tpu_torch.models import needleman_wunsch as model
from nw_tpu_torch.ops import banded_traceback as bt
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded, traceback

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)]
LARGE = [(1, 1, 2**30), (1, 2**30, 1), (2**31 - 1, -(2**31), 2**30)]
BIG = (1, 1, 2**30)
EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG")]
# nw_tpu's two-pass engines at a small geometry (interpret mode)
JKW = dict(interpret=True, band_rows=8, chunk=16, unroll=4, group_bands=2)
DEFAULT_GROUP = bt.GROUP_BANDS  # the port's group height, before any test patches it


def _pairs(seed, n, lo, hi, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    return [
        tuple(letters[rng.integers(0, len(letters), int(rng.integers(lo, hi + 1)))].tobytes() for _ in range(2))
        for _ in range(n)
    ]


def _mix(seed):
    """tests/test_banded.py:164's pair mix: 6 random pairs of 1-60 bp and
    the three empty or one-sided pairs."""
    return _pairs(seed, 6, 1, 60) + EDGE


def _edges(S):
    """Pairs whose sides end on a group edge of S bands (32 * S rows) and
    one row either side of it, and one of a single group's rows."""
    rng = np.random.default_rng(S)
    one = _pairs(S + 40, 1, 1, 31)[0]
    return [(_pairs(int(rng.integers(1 << 20)), 1, 20, 90)[0][0], _pairs(S + e, 1, 32 * S + e, 32 * S + e)[0][1])
            for e in (-1, 0, 1)] + [one]


def _upload(pairs, A=None, Bs=None):
    A = A or max(1, max(len(a) for a, _ in pairs))
    Bs = Bs or max(1, max(len(b) for _, b in pairs))
    return enc.upload(enc.encode_batch(pairs, A, Bs), "cpu")


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _assert_same_ops(got, want):
    """Op arrays of two widths: equal where both are, OP_NONE beyond."""
    S = min(got.shape[1], want.shape[1])
    np.testing.assert_array_equal(got[:, :S], want[:, :S])
    assert (got[:, S:] == traceback.OP_NONE).all() and (want[:, S:] == traceback.OP_NONE).all()


# ---------------- the span fill against K1 / K2 band calls ----------------


def _k_band_calls(pairs, mkd, with_counts, RB=8, first=2):
    """nw_tpu's K2 band calls (scores + counts, with_words=False) over bands
    0 .. first-1 from NEG_INF, then K1's (scores) or K2's over the rest,
    band by band as the two-pass engine's group_fwd runs them: the
    boundary row K2 left after band first-1 (row RB*first - 1: the seed,
    int32[B, A+1], and its counts), and the rest's boundary row (row
    RB*nbands - 1), scores and counts of the corners in those bands."""
    A = Bs = 48
    tops, sides, l1, l2 = jencode_batch(pairs, A, Bs)
    B = len(pairs)
    RB, nbands, C, T_pad, lag0, off, U_pad = _geometry(A, Bs + 1, RB, 8, 4)
    ts, ss, lens, nb_pad = _prep_banded(tops, sides, l1, l2, LANES, T_pad, nbands * RB)
    k1 = build_scores_call(RB, C, off, lag0, 4, T_pad, U_pad, nb_pad, LANES, True)
    k2 = build_arrows_call(RB, C, off, lag0, 4, T_pad, U_pad, nb_pad, LANES, True,
                           with_counts=True, with_words=False)

    def row(bnd):  # the producer-step boundary (U_pad, nb_pad) -> rows [B, A+1]
        return torch.from_numpy(np.ascontiguousarray(np.asarray(bnd)[np.arange(A + 1) + RB - 1, :B].T))

    bnd = jnp.full((U_pad, nb_pad), NEG_INF, jnp.int32)
    cbnd = jnp.zeros((U_pad, nb_pad), jnp.int32)
    for r in range(first):
        _, bnd, _, cbnd = k2(_band_scalars(*mkd, r, RB, lens, B), ts, ss, lens, bnd, bnd, cbnd, cbnd)
    seed, cseed = row(bnd), row(cbnd)
    scores = jnp.full((1, nb_pad), NEG_INF, jnp.int32)
    counts = jnp.zeros((1, nb_pad), jnp.int32)
    for r in range(first, nbands):
        s = _band_scalars(*mkd, r, RB, lens, B)
        if with_counts:
            part, bnd, cpart, cbnd = k2(s, ts, ss, lens, bnd, bnd, cbnd, cbnd)
            counts = counts + cpart
        else:
            part, bnd = k1(s, ts, ss, lens, bnd, bnd)
        scores = jnp.maximum(scores, part)
    out = dict(seed=seed, cseed=cseed, last=row(bnd), scores=torch.from_numpy(np.array(scores)[0, :B]),
               row0=RB * first - 1, rows=RB * (nbands - first))
    if with_counts:
        out.update(clast=row(cbnd), counts=torch.from_numpy(np.array(counts)[0, :B]))
    return out


def _seeded_plain(pairs, mkd, k, with_counts):
    """fill_rows_plain from K2's seed row over the same rows: (its last
    row, its counts, scores, counts, the pairs whose corner it holds)."""
    T = _upload(pairs, 48, 48)
    B = len(pairs)
    bnd = k["seed"].clone()
    cbnd = k["cseed"].clone() if with_counts else None
    scores = torch.zeros(B, dtype=torch.int32)
    counts = torch.zeros(B, dtype=torch.int32) if with_counts else None
    fill_banded.fill_rows_plain(*T, *mkd, k["row0"], k["rows"], bnd, cbnd, scores, counts)
    inside = (T[3] > k["row0"]) & (T[3] <= k["row0"] + k["rows"])
    return bnd, cbnd, scores, counts, inside, T[2]


def _k_pairs(seed):
    return _pairs(seed, 6, 1, 48) + [(b"A" * 30, b"A" * 23), (b"ACGT", b"ACGTACGTACGTACGTACG"), (b"", b"ACG" * 5)]


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("mkd", SCORINGS + LARGE)
def test_span_plain_matches_k1_k2_band_calls(mkd, with_counts):
    """The plain span from K2's boundary row after bands 0-1 (row 15 of
    8-row bands) over the rows K1 / K2 sweep next: its last row (columns
    0 .. len1; K2's boundary past len1 is unspecified), and the scores and
    counts of the pairs whose corner lies there, equal K1's / K2's.  At the
    three large scorings nw_tpu's kernels leave fill_scan through their
    NEG_INF boundary decay (ROADMAP queue 3): there the port's span equals
    its own whole fill, which follows fill_scan (nw_tpu's scan on the
    CPU), and K2 differs from it."""
    pairs = _k_pairs(sum(mkd) % 89)
    k = _k_band_calls(pairs, mkd, with_counts)
    bnd, cbnd, scores, counts, inside, l1 = _seeded_plain(pairs, mkd, k, with_counts)
    assert inside.any() and not inside.all()
    ok = [
        torch.equal(scores[inside], k["scores"][inside]),
        all(torch.equal(bnd[b, : int(l1[b]) + 1], k["last"][b, : int(l1[b]) + 1]) for b in range(len(pairs))),
    ]
    if with_counts:
        ok += [torch.equal(counts[inside], k["counts"][inside]),
               all(torch.equal(cbnd[b, : int(l1[b]) + 1], k["clast"][b, : int(l1[b]) + 1])
                   for b in range(len(pairs)))]
    if mkd in SCORINGS:
        assert all(ok), ok
        return
    assert not all(ok)  # K2 leaves fill_scan here
    T = _upload(pairs, 48, 48)
    chain = fill_banded.fill_scores_counts_banded_batch_plain(*T, *mkd)
    want = nw_tpu.align_batch(pairs, *mkd, count=True)
    np.testing.assert_array_equal(chain[0].numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal((chain[1] & 0xFFFFFFFF).numpy().astype(np.uint32), np.asarray(want.counts))
    bnd0, cbnd0 = fill_banded.span_row0(len(pairs), 48, mkd[2], True, "cpu")
    sc = torch.zeros(len(pairs), dtype=torch.int32)
    ct = torch.zeros_like(sc)
    fill_banded.fill_span_banded_batch(*T, *mkd, 0, 1, bnd0, cbnd0, sc, ct)
    fill_banded.fill_span_banded_batch(*T, *mkd, 1, 1, bnd0, cbnd0, sc, ct)
    torch.testing.assert_close(sc, chain[0], rtol=0, atol=0)
    torch.testing.assert_close(ct.to(torch.int64) & 0xFFFFFFFF, chain[1], rtol=0, atol=0)


# ---------------- the span fill chained against the whole fill ----------------


@pytest.mark.parametrize("S", [1, 2, 3, 64])
@pytest.mark.parametrize("mkd", SCORINGS + LARGE)
def test_span_chain_matches_the_whole_fill(mkd, S):
    """Spans of S bands from row 0 to the table's last band, each from the
    row the one before it left: the scores, counts and codes of the
    whole fill (codes band by band), the pairs of each span written by it
    alone; the last row is row 32 * nbands over the pads past Bs."""
    pairs = _mix(S + sum(mkd) % 7) + _edges(2)
    T = _upload(pairs, 100, 100)
    B = len(pairs)
    codes, want_sc, want_ct = fill_banded.fill_greedy_counts_banded_batch_plain(*T, *mkd, with_counts=True)
    bnd, cbnd = fill_banded.span_row0(B, 100, mkd[2], True, "cpu")
    sc = torch.full((B,), 7, dtype=torch.int32)
    ct = torch.full((B,), 7, dtype=torch.int32)
    got_codes = []
    for r0 in range(0, 4, S):
        before = sc.clone()
        c_bnd = bnd.clone()
        fill_banded.fill_span_banded_batch(*T, *mkd, r0, S, bnd, cbnd, sc, ct)
        got_codes.append(fill_banded.fill_span_banded_batch(*T, *mkd, r0, S, c_bnd, None, None, None, emit_codes=True))
        torch.testing.assert_close(c_bnd, bnd, rtol=0, atol=0)  # the codes variant leaves the same row
        mine = ((T[3] > 32 * r0) & (T[3] <= 32 * (r0 + S))) | ((T[3] == 0) & (r0 == 0))
        assert torch.equal(sc[~mine], before[~mine])
    torch.testing.assert_close(sc, want_sc, rtol=0, atol=0)
    torch.testing.assert_close(ct.to(torch.int64) & 0xFFFFFFFF, want_ct, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(got_codes, 1), codes, rtol=0, atol=0)
    side = torch.cat([T[1], torch.full((B, 28), fill_banded.SIDE_PAD, dtype=torch.int32)], 1)
    from nw_tpu_torch.ops.fill_scan import fill_diag_batch

    last = fill_diag_batch(T[0], side, T[2], T[3], *mkd, with_arrows=False, with_last=True)["last"]
    torch.testing.assert_close(bnd, last, rtol=0, atol=0)


def test_span_past_the_table_and_its_checks():
    """A span from past the last band sweeps nothing (its codes have no
    band); the span from band 0 of a table of no row writes the row-0
    corners off its seed; the wrappers refuse bad state."""
    T = _upload([(b"ACGT", b""), (b"", b"")], 4, 1)
    B = 2
    bnd, cbnd = fill_banded.span_row0(B, 4, 3, True, "cpu")
    sc, ct = torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)
    keep = bnd.clone()
    codes = fill_banded.fill_span_banded_batch(*T, 2, 1, 3, 5, 2, bnd.clone(), None, None, None, emit_codes=True)
    assert codes.shape[1] == 0
    fill_banded.fill_span_banded_batch(*T, 2, 1, 3, 5, 2, bnd, cbnd, sc, ct)
    assert torch.equal(bnd, keep) and sc.tolist() == [0, 0]
    T0 = enc.upload(enc.encode_batch([(b"ACGT", b""), (b"", b"")], 4, 0), "cpu")
    fill_banded.fill_span_banded_batch(*T0, 2, 1, 3, 0, 1, bnd, cbnd, sc, ct)
    assert sc.tolist() == [-12, 0] and ct.tolist() == [1, 1]
    with pytest.raises(ValueError, match="span"):
        fill_banded.fill_span_banded_batch(*T, 2, 1, 3, 0, 0, bnd)
    with pytest.raises(ValueError, match="counts"):
        fill_banded.fill_span_banded_batch(*T, 2, 1, 3, 0, 1, bnd, cbnd, sc, None)
    with pytest.raises(ValueError, match="codes variant"):
        fill_banded.fill_span_banded_batch(*T, 2, 1, 3, 0, 1, bnd, cbnd, sc, ct, emit_codes=True)
    with pytest.raises(ValueError, match="bnd"):
        fill_banded.fill_span_banded_batch(*T, 2, 1, 3, 0, 1, bnd[:, :3].contiguous())


# ---------------- the group walk ----------------


@pytest.mark.parametrize("S", [1, 2, 3])
def test_group_walk_chain_matches_the_one_pass_walk(S):
    """The plain group walk chained over groups of S bands, last first,
    ops in place or as per-group prefixes stitched on the host, equals
    the one-pass walk over the whole table's codes."""
    pairs = _mix(S) + _edges(S) + _pairs(S + 9, 3, 60, 130, b"AC")
    T = _upload(pairs, 130, 130)
    codes = fill_banded.fill_greedy_counts_banded_batch_plain(*T, 2, 1, 1)[0]
    want_ops, want_n = traceback.walk_codes_batch_plain(codes, T[2], T[3], 260)
    B, nbands = codes.shape[:2]
    G = -(-nbands // S)
    for prefixes in (False, True):
        state = torch.stack([T[2], T[3], torch.zeros_like(T[2])], 1).contiguous()
        ops = torch.full((B, 260), traceback.OP_NONE, dtype=torch.int8)
        pre = torch.full((G, B, bt._group_cap(130, S)), traceback.OP_NONE, dtype=torch.int8)
        ng = []
        for idx, g in enumerate(range(G - 1, -1, -1)):
            part = codes[:, g * S : (g + 1) * S].contiguous()
            if prefixes:
                before = state[:, 2].clone()
                traceback.walk_codes_groups(part, state, 32 * g * S, pre[idx], torch.zeros(B, dtype=torch.int32))
                ng.append(state[:, 2] - before)
            else:
                traceback.walk_codes_groups(part, state, 32 * g * S, ops)
        if prefixes:
            ops, n = bt.compact_group_ops(bt.pack_ops4(pre).numpy(), torch.stack(ng).numpy(), 260)
            ops = torch.from_numpy(ops)
            np.testing.assert_array_equal(n, want_n.numpy())
        torch.testing.assert_close(ops, want_ops, rtol=0, atol=0)
        torch.testing.assert_close(state[:, 2], want_n, rtol=0, atol=0)
        assert (state[:, :2] == 0).all()


def test_group_walk_limits_and_starts_outside():
    """A start outside the group's rows or columns walks nowhere and
    keeps its state; a walk stops after stride - off ops, ops at off."""
    T = _upload([(b"GATTACAGATTACA", b"GCATGCATGCAT" * 4)], 16, 48)
    codes = fill_banded.fill_greedy_counts_banded_batch_plain(*T, 2, 1, 1)[0]  # 2 bands
    for start, j0 in (([5, 48, 0], 64), ([5, 10, 0], 32), ([16 * codes.shape[2] - 31, 40, 0], 32)):
        state = torch.tensor([start], dtype=torch.int32)
        ops = torch.full((1, 8), 3, dtype=torch.int8)
        traceback.walk_codes_groups(codes[:, 1:].contiguous(), state, j0, ops)
        assert state.tolist() == [start] and (ops == 3).all()
    want_ops, _ = traceback.walk_codes_batch_plain(codes, T[2], T[3], 64)
    state = torch.tensor([[14, 48, 0]], dtype=torch.int32)
    ops = torch.full((1, 10), 3, dtype=torch.int8)
    traceback.walk_codes_groups(codes, state, 0, ops, torch.tensor([4], dtype=torch.int32))
    assert state[0, 2] == 6 and torch.equal(ops[0, 4:], want_ops[0, :6])
    with pytest.raises(ValueError, match="state"):
        traceback.walk_codes_groups(codes, torch.zeros(3, dtype=torch.int32), 0, ops)
    with pytest.raises(ValueError, match="j0"):
        traceback.walk_codes_groups(codes, state, -1, ops)


def test_compact_group_ops_matches_nw_tpu():
    """The port's host stitch, [ngroups, B, cap], against nw_tpu's
    _compact_group_ops on the same prefixes laid out [ngroups, cap, B]."""
    rng = np.random.default_rng(3)
    G, B, cap = 4, 7, 24
    ops = rng.integers(0, 4, (G, B, cap)).astype(np.int8)
    ng = rng.integers(0, cap + 1, (G, B)).astype(np.int32)
    ng[1, 2] = 0
    got = bt.compact_group_ops(bt.pack_ops4(torch.from_numpy(ops)).numpy(), ng, 70)
    want = j_compact_group_ops(ops.transpose(0, 2, 1), ng, 70)
    _assert_same(got, want)


# ---------------- the engines ----------------


def _port(pairs, mkd, engine, with_counts=True):
    return bt.traceback_banded_batch(*_upload(pairs), *mkd, with_counts=with_counts, engine=engine)


def _nw_tpu(pairs, mkd, engine, with_counts=True):
    A = max(1, max(len(a) for a, _ in pairs))
    Bs = max(1, max(len(b) for _, b in pairs))
    tops, sides, l1, l2 = jencode_batch(pairs, A, Bs)
    return j_traceback_banded_batch(tops, sides, l1, l2, *mkd, with_counts=with_counts, engine=engine, **JKW)


@pytest.mark.parametrize("engine", ["twopass", "hoststitch"])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_engines_match_nw_tpu_and_the_codes_engine(monkeypatch, mkd, engine):
    """Scores, counts, ops and n of the port's engine (groups of 1 and 2
    bands, and the default: one group here) against nw_tpu's engine of
    the same name (interpret mode, 8-row bands, groups of 2) and the
    port's codes engine: test_banded.py:164's mix and pairs on the edges
    of 2-band groups."""
    pairs = _mix(sum(mkd) + 3) + _edges(2)
    want = _nw_tpu(pairs, mkd, engine)
    codes = _port(pairs, mkd, "auto")
    _assert_same(want[:2], codes[:2])
    _assert_same_ops(codes[2], np.asarray(want[2]))
    np.testing.assert_array_equal(codes[3], np.asarray(want[3]))
    for S in (1, 2, DEFAULT_GROUP):
        monkeypatch.setattr(bt, "GROUP_BANDS", S)
        got = _port(pairs, mkd, engine)
        assert got[1].dtype == np.uint32
        _assert_same(got, codes)


@pytest.mark.parametrize("engine", ["twopass", "hoststitch"])
def test_engines_without_counts_and_at_group_edges(monkeypatch, engine):
    """(scores, ops, n) without counts, at pairs on the edges of groups of
    1, 2 and 3 bands, each group height; a batch of one pair; an empty
    batch of no pair."""
    pairs = _edges(1) + _edges(3) + _mix(77)
    want = _port(pairs, (2, 1, 1), "auto", with_counts=False)
    for S in (1, 2, 3):
        monkeypatch.setattr(bt, "GROUP_BANDS", S)
        _assert_same(_port(pairs, (2, 1, 1), engine, with_counts=False), want)
    monkeypatch.setattr(bt, "GROUP_BANDS", 1)
    one = _port(pairs[:1], (2, 1, 1), engine, with_counts=False)
    _assert_same(one, _port(pairs[:1], (2, 1, 1), "auto", with_counts=False))
    T = enc.upload(enc.encode_batch([], 8, 8), "cpu")
    sc, ct, ops, n = bt.traceback_banded_batch(*T, 2, 1, 1, with_counts=True, engine=engine)
    assert sc.shape == (0,) and ct.shape == (0,) and ops.shape[0] == 0 and n.shape == (0,)


def test_twopass_follows_fill_scan_at_large_scorings(monkeypatch):
    """At 1 1 2^30 nw_tpu's two-pass engines leave its own fill_scan
    through K1's / K2's NEG_INF boundary decay, as its runs engine does
    (ROADMAP queue 3): on GATTACA / GCAT they report 2147483644 against
    fill_scan's 1073741822.  The port's two-pass engines write row 0 and
    column 0 and follow fill_scan: nw_tpu's scan route (align_batch on the
    CPU) on every pair, byte for byte."""
    pairs = _mix(11) + [(b"GATTACA", b"GCAT")]
    want = nw_tpu.align_batch(pairs, *BIG, traceback_strings=True, count=True)
    monkeypatch.setattr(bt, "GROUP_BANDS", 1)
    for engine in ("twopass", "hoststitch"):
        got = _port(pairs, BIG, engine)
        np.testing.assert_array_equal(got[0], np.asarray(want.scores))
        np.testing.assert_array_equal(got[1], np.asarray(want.counts))
        np.testing.assert_array_equal(got[3], np.asarray(want.ops_len))
        _assert_same_ops(got[2], np.asarray(want.ops))
        j = _nw_tpu(pairs, BIG, engine)
        assert int(j[0][-1]) == 2147483644 and int(got[0][-1]) == 1073741822
        assert not np.array_equal(np.asarray(j[0]), got[0])


@pytest.mark.parametrize("engine", ["twopass", "hoststitch"])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (3, -1, 2)])
def test_align_batch_on_the_engines_matches_nw_tpu(monkeypatch, mkd, engine):
    """align_batch under NW_TPU_WALK_ENGINE=twopass / hoststitch runs the
    two-pass steps (a span fill and a group walk a group) and gives
    nw_tpu's align_batch's scores, counts, ops and strings under the same
    engine."""
    pairs = _mix(sum(mkd) + 21) + _pairs(5, 4, 100, 140)
    monkeypatch.setenv("NW_TPU_WALK_ENGINE", engine)
    calls = []
    walk = bt.walk_codes_groups
    monkeypatch.setattr(bt, "walk_codes_groups", lambda *a, **kw: calls.append(1) or walk(*a, **kw))
    want = nw_tpu.align_batch(pairs, *mkd, traceback_strings=True, count=True)
    al = NWAligner(AlignConfig(scoring=ScoringParams(*mkd)), device="cpu")
    got = al.align_batch(pairs, traceback_strings=True, count=True, sub_batch=5)
    assert len(calls) == -(-len(pairs) // 5)  # one group a sub-batch here
    np.testing.assert_array_equal(got.scores, np.asarray(want.scores))
    assert got.counts.dtype == np.uint32
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    _assert_same_ops(got.ops, np.asarray(want.ops))
    np.testing.assert_array_equal(got.ops_len, np.asarray(want.ops_len))
    assert got.alignment_strings() == want.alignment_strings()


def test_engine_names_and_the_memory_rule(monkeypatch):
    """Every engine name of nw_tpu resolves; the two-pass engines keep
    the checkpoint rows and one group's codes: config 3 (256 x 10 240 bp)
    is one sub-batch, and a 10 kb pair holds ~1/5 of its codes."""
    for engine in bt.ENGINES:
        monkeypatch.setenv("NW_TPU_WALK_ENGINE", engine)
        assert bt.resolve_walk_engine() == engine
    with pytest.raises(ValueError, match="unknown walk engine"):
        bt.resolve_walk_engine("fast")
    L10 = 10240
    assert bt.group_bands(L10) == bt.GROUP_BANDS == 64 and bt.group_bands(100) == 4
    whole = model.code_bytes_per_pair(L10, L10)
    two = bt.engine_pair_bytes(L10, L10, "twopass")
    assert two == 5 * 4 * (L10 + 1) + 64 * 642 * 32 * 4
    assert whole // 6 < two < whole // 4
    assert bt.engine_pair_bytes(L10, L10, "hoststitch") == two + 5 * (32 * 64 + L10)
    assert model.strings_sub_batch(L10, L10, "twopass") >= 256
    assert model.strings_sub_batch(L10, L10, "hoststitch") >= 256
    assert model.strings_sub_batch(L10, L10, "auto") == 653
    # the group height is read at each call: the memory rule follows it
    monkeypatch.setattr(bt, "GROUP_BANDS", 2)
    assert bt.group_bands(100) == 2 and bt.group_bands(10) == 1
    assert bt.engine_pair_bytes(L10, L10, "twopass") == 160 * 4 * (L10 + 1) + 2 * 642 * 32 * 4
