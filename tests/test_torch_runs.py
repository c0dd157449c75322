"""nw_tpu_torch's runs walk engine (plain PyTorch) vs nw_tpu on the CPU.

The port's ``traceback_banded_batch(engine="runs")`` (run bytes from
``fill_runs_banded_batch``, the run-skip walk ``walk_runs_batch``)
against ``nw_tpu``'s ``runs`` and ``twopass`` engines in interpret mode;
the run bytes' code bits against K2's ``with_runs`` bytes, reached
through ``build_arrows_call(..., pack_bits=8, with_runs=True)`` band by
band as ``nw_tpu``'s ``band_refill`` does; the run bits against the
definition, written out cell by cell over ``nw_tpu``'s scan masks;
``align_batch`` under ``NW_TPU_WALK_ENGINE=runs`` against ``nw_tpu``'s;
the sub-batch rule.  Pairs of 0 to 300 bp:
random, tie-dense, pure-diagonal past the 63 cap and past 32-row bands,
gap-heavy, empty and one-sided.  Every output is an integer, so every
comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nw_tpu
from nw_tpu.ops.banded_traceback import traceback_banded_batch as jtraceback_banded_batch
from nw_tpu.ops.encode import encode as jencode
from nw_tpu.ops.encode import encode_batch as jencode_batch
from nw_tpu.ops.fill_pallas_banded import (
    LANES,
    NEG_INF,
    _band_scalars,
    _geometry,
    _prep_banded,
    build_arrows_call,
)
from nw_tpu.ops.fill_scan import fill_diag as jfill_diag
from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
from nw_tpu_torch.models import needleman_wunsch as model
from nw_tpu_torch.ops import banded_traceback as bt
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded, traceback

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)]
BIG = (1, 1, 2**30)  # nw_tpu's K2 leaves fill_scan here (NEG_INF decay)
L = 304  # the buckets of every batch here
# nw_tpu's banded engines at a small geometry (interpret mode)
JKW = dict(interpret=True, band_rows=32, chunk=32, unroll=8, group_bands=4)


def _pairs(seed, n, lo, hi, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    return [
        tuple(letters[rng.integers(0, len(letters), int(rng.integers(lo, hi + 1)))].tobytes() for _ in range(2))
        for _ in range(n)
    ]


def _cases(seed):
    base = _pairs(seed + 7, 1, 300, 300)[0][0]
    return (
        _pairs(seed, 6, 0, 300) + _pairs(seed + 1, 3, 50, 200, b"AC")
        + [
            (base, base),  # a 300-cell diagonal run: past the cap and 9 bands
            (base[:64], base[:64]), (base[:63], base[:63]),  # the cap + 1, the cap
            (base, base[:200]), (base[:150], base),  # a diagonal run, then lefts / ups
            (b"A" * 90, b"T"), (b"T", b"A" * 90), (b"A" * 50, b"AA"),  # mostly gaps
            (b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"GCATGCU", b"GATTACA"),
        ]
    )


def _port(pairs, mkd, engine="runs"):
    T = enc.upload(enc.encode_batch(pairs, L, L), "cpu")
    return bt.traceback_banded_batch(*T, *mkd, with_counts=True, engine=engine)


def _nw_tpu(pairs, mkd, engine):
    tops, sides, l1, l2 = jencode_batch(pairs, L, L)
    return jtraceback_banded_batch(tops, sides, l1, l2, *mkd, with_counts=True, engine=engine, **JKW)


def _assert_same_ops(got, want):
    """Op arrays of two bucket widths: equal where both are, OP_NONE beyond."""
    S = min(got.shape[1], want.shape[1])
    np.testing.assert_array_equal(got[:, :S], want[:, :S])
    assert (got[:, S:] == traceback.OP_NONE).all() and (want[:, S:] == traceback.OP_NONE).all()


def _assert_same(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("engine", ["runs", "twopass"])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_runs_engine_matches_nw_tpu_engines(mkd, engine):
    """Scores, counts and ops of the port's runs engine against nw_tpu's
    runs engine (K2's with_runs bytes, the run-skip walk) and its
    two-pass engine (checkpoints, 2-bit re-fills)."""
    pairs = _cases(sum(mkd))
    _assert_same(_port(pairs, mkd), _nw_tpu(pairs, mkd, engine))


@pytest.mark.parametrize("mkd", SCORINGS + [BIG])
def test_runs_engine_matches_codes_engine(mkd):
    pairs = _cases(sum(mkd) % 97 + 3)
    _assert_same(_port(pairs, mkd, "runs"), _port(pairs, mkd, "auto"))


def test_runs_engine_follows_fill_scan_at_large_scorings():
    """At 1 1 2^30 nw_tpu's banded engines (K2, runs or two-pass) leave
    its own fill_scan through the NEG_INF boundary decay, as K8 and K9
    do (ROADMAP queue 3): on GATTACA / GCAT they report 2147483644
    against fill_scan's 1073741822.  The port writes row 0 and column 0
    and follows fill_scan: nw_tpu's scan route (align_batch on the CPU)
    on every pair, byte for byte."""
    pairs = _cases(11) + [(b"GATTACA", b"GCAT")]
    got = _port(pairs, BIG)
    want = nw_tpu.align_batch(pairs, *BIG, traceback_strings=True, count=True)
    np.testing.assert_array_equal(got[0], np.asarray(want.scores))
    np.testing.assert_array_equal(got[1], np.asarray(want.counts))
    np.testing.assert_array_equal(got[3], np.asarray(want.ops_len))
    _assert_same_ops(got[2], np.asarray(want.ops))
    k2 = _nw_tpu(pairs, BIG, "runs")
    assert int(k2[0][-1]) == 2147483644 and int(got[0][-1]) == 1073741822
    assert not np.array_equal(np.asarray(k2[0]), got[0])


# ---------------- the run bytes ----------------


def _scan_masks(pair, mkd):
    """nw_tpu's fill_scan tie masks of one pair's true table, (len2+1, len1+1)."""
    s1, s2 = pair
    arrows = np.asarray(jfill_diag(jnp.asarray(jencode(s1)), jnp.asarray(jencode(s2)), *mkd)["arrows"])
    jj, ii = np.mgrid[0 : len(s2) + 1, 0 : len(s1) + 1]
    return arrows[ii + jj, jj]


def _definition(masks, restart):
    """Run bytes of one true table, cell by cell: the greedy code (the
    first set bit, diag > left > up) and the length of the same-code run
    ending at the cell, a diag run through (j-1, i-1) unless
    ``restart(j)``, a left run through (j, i-1), capped at 63; up cells
    and the origin 0 run."""
    N, M = masks.shape
    out = np.zeros((N, M), np.int64)
    for j in range(N):
        for i in range(M):
            if i == 0 and j == 0:
                continue
            a = int(masks[j, i])
            code = 0 if a & 1 else (1 if a & 2 else 2)
            run = 0
            if code == 0:
                p = 0 if restart(j) else int(out[j - 1, i - 1])
                run = min(p >> 2 if p & 3 == 0 else 0, 62) + 1
            elif code == 1:
                p = int(out[j, i - 1])
                run = min(p >> 2 if p & 3 == 1 else 0, 62) + 1
            out[j, i] = run << 2 | code
    return out


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("mkd", SCORINGS + [BIG, (1, 2**30, 1)])
def test_run_bytes_match_definition(mkd, with_counts):
    """The plain fill's run bytes against the definition over fill_scan's
    masks (bands restart diag runs at rows 1, 33, 65, ...), 0 outside
    each table; scores and counts as the masks fill's."""
    pairs = _cases(sum(mkd) % 89 + 5)
    T = enc.upload(enc.encode_batch(pairs, L, L), "cpu")
    runs, sc, ct = fill_banded.fill_runs_banded_batch(*T, *mkd, with_counts=with_counts)
    assert runs.dtype == torch.uint8 and runs.shape == (len(pairs), L + 1, L + 1)
    _, msc, mct = fill_banded.fill_masks_banded_batch(*T, *mkd, with_counts=with_counts)
    torch.testing.assert_close(sc, msc, rtol=0, atol=0)
    if with_counts:
        torch.testing.assert_close(ct, mct, rtol=0, atol=0)
    else:
        assert ct is None
    for b, (s1, s2) in enumerate(pairs):
        want = _definition(_scan_masks((s1, s2), mkd), lambda j: j % 32 == 1)
        got = runs[b].numpy()
        np.testing.assert_array_equal(got[: len(s2) + 1, : len(s1) + 1], want)
        assert int(got.astype(np.int64).sum()) == int(want.sum())  # nothing outside the table
        # row 0 and column 0 as the kernel writes them
        assert (got[0, 1 : len(s1) + 1] >> 2 == np.minimum(np.arange(1, len(s1) + 1), 63)).all()
        assert (got[1 : len(s2) + 1, 0] == 2).all()


def _k2_run_bytes(pairs, mkd, RB):
    """K2's with_runs bytes of each true table: the arrows call the runs
    engine builds, run band by band from NEG_INF as band_refill runs a
    group (the chunk and unroll of its refill)."""
    m, k, d = mkd
    A = Bs = max(max(len(a), len(b)) for a, b in pairs)
    tops, sides, l1, l2 = jencode_batch(pairs, A, Bs)
    RB, nbands, C, T_pad, lag0, off, U_pad = _geometry(A, Bs + 1, RB, 16, 16)
    tops_sh, sides_sh, lens, nb_pad = _prep_banded(tops, sides, l1, l2, LANES, T_pad, nbands * RB)
    call = build_arrows_call(
        RB, C, off, lag0, 16, T_pad, U_pad, nb_pad, LANES, True,
        with_counts=False, pack_bits=8, with_runs=True,
    )
    bnd = jnp.full((U_pad, nb_pad), NEG_INF, jnp.int32)
    planes = []
    for r in range(nbands):
        words, _, bnd = call(_band_scalars(m, k, d, r, RB, lens, len(pairs)), tops_sh, sides_sh, lens, bnd, bnd)
        planes.append(np.asarray(words[0]).view(np.uint32))  # (T_pad // 4, RB, nb_pad)
    out = []
    for b, (s1, s2) in enumerate(pairs):
        jj, ii = np.mgrid[0 : len(s2) + 1, 0 : len(s1) + 1]
        t = ii + jj % RB
        w = np.stack(planes)[jj // RB, t >> 2, jj % RB, b]
        out.append((w >> (8 * (t & 3))) & 0xFF)
    return out


@pytest.mark.parametrize("mkd", SCORINGS)
def test_run_bytes_match_k2_with_runs(mkd):
    """K2's with_runs bytes (interpret mode, 16-row bands) against the
    port's: the code bits on every cell of each true table but the
    origin, which K2 leaves unspecified; K2's run bits against the same
    definition with K2's band restart (rows 0, 16, 32, ...), so the two
    differ only where their bands split a diagonal run."""
    base = _pairs(5, 1, 120, 120)[0][0]
    pairs = (_pairs(sum(mkd) + 40, 5, 1, 120) + _pairs(2, 2, 30, 100, b"AC")
             + [(base, base), (base, base[:90]), (b"A" * 80, b"T"), (b"", b"ACG"), (b"ACG", b"")])
    k2 = _k2_run_bytes(pairs, mkd, RB=16)
    T = enc.upload(enc.encode_batch(pairs, L, L), "cpu")
    runs = fill_banded.fill_runs_banded_batch(*T, *mkd)[0].numpy()
    for b, (s1, s2) in enumerate(pairs):
        got = runs[b, : len(s2) + 1, : len(s1) + 1].astype(np.int64)
        np.testing.assert_array_equal((k2[b] & 3).ravel()[1:], (got & 3).ravel()[1:])
        want = _definition(_scan_masks((s1, s2), mkd), lambda j: j % 16 == 0)
        np.testing.assert_array_equal(k2[b].ravel()[1:], want.ravel()[1:])


# ---------------- the run-skip walk ----------------


@pytest.mark.parametrize("mkd", SCORINGS + [BIG])
def test_walk_runs_matches_walk_codes(mkd):
    """The run-skip walk over run bytes gives the step walk's ops over the
    same fill's codes, in fewer loads wherever runs are long."""
    pairs = _cases(sum(mkd) % 83 + 9)
    T = enc.upload(enc.encode_batch(pairs, L, L), "cpu")
    runs = fill_banded.fill_runs_banded_batch(*T, *mkd)[0]
    codes = fill_banded.fill_greedy_counts_banded_batch(*T, *mkd)[0]
    S = 2 * L
    ops, n = traceback.walk_runs_batch(runs, T[2], T[3], S)
    want_ops, want_n = traceback.walk_codes_batch(codes, T[2], T[3], S)
    torch.testing.assert_close(ops, want_ops, rtol=0, atol=0)
    torch.testing.assert_close(n, want_n, rtol=0, atol=0)
    ops2, n2, loads = traceback.walk_runs_loads(runs, T[2], T[3], S)
    torch.testing.assert_close(ops2, ops, rtol=0, atol=0)
    assert (loads <= n.to(torch.int64)).all()
    diag = pairs.index(next(p for p in pairs if p[0] == p[1] and len(p[0]) == 300))
    if mkd[0] > 0:  # a 300-cell diagonal: one load a band, ten in all
        assert int(loads[diag]) == 10 and int(n[diag]) == 300


def test_walk_runs_checks_its_inputs():
    runs = torch.zeros((2, 5, 7), dtype=torch.uint8)
    lens = torch.tensor([6, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="inside the mask tables"):
        traceback.walk_runs_batch(runs, lens, torch.tensor([5, 1], dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        traceback.walk_runs_batch(runs.to(torch.int32), lens, lens, 16)


# ---------------- the engine choice ----------------


@pytest.mark.parametrize("strings,count", [(True, True), (True, False)])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (3, -1, 2), BIG])
def test_align_batch_runs_engine_matches_nw_tpu(monkeypatch, mkd, strings, count):
    """align_batch under NW_TPU_WALK_ENGINE=runs takes the runs engine and
    gives nw_tpu's align_batch's scores, counts, ops and strings."""
    pairs = _cases(sum(mkd) % 71)
    monkeypatch.setenv("NW_TPU_WALK_ENGINE", "runs")
    calls = []
    fill = bt.fill_runs_banded_batch
    monkeypatch.setattr(bt, "fill_runs_banded_batch", lambda *a, **kw: calls.append(1) or fill(*a, **kw))
    want = nw_tpu.align_batch(pairs, *mkd, traceback_strings=strings, count=count)
    al = NWAligner(AlignConfig(scoring=ScoringParams(*mkd)), device="cpu")
    got = al.align_batch(pairs, traceback_strings=strings, count=count, sub_batch=7)
    assert len(calls) == -(-len(pairs) // 7)
    np.testing.assert_array_equal(got.scores, np.asarray(want.scores))
    if count:
        assert got.counts.dtype == np.uint32
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    _assert_same_ops(got.ops, np.asarray(want.ops))
    np.testing.assert_array_equal(got.ops_len, np.asarray(want.ops_len))
    assert got.alignment_strings() == want.alignment_strings()


def test_engine_names(monkeypatch):
    monkeypatch.delenv("NW_TPU_WALK_ENGINE", raising=False)
    assert bt.default_walk_engine() == "auto" and bt.resolve_walk_engine() == "auto"
    monkeypatch.setenv("NW_TPU_WALK_ENGINE", "runs")
    assert bt.resolve_walk_engine() == "runs" and bt.resolve_walk_engine("onepass") == "onepass"
    with pytest.raises(ValueError, match="unknown walk engine"):
        bt.resolve_walk_engine("fast")
    T = enc.upload(enc.encode_batch([(b"GATTACA", b"GCAT")], 8, 8), "cpu")
    assert bt.traceback_banded_dispatch(*T, 2, 1, 1).engine == "runs"
    assert bt.traceback_banded_dispatch(*T, 2, 1, 1, engine="auto").engine == "auto"


def test_sub_batch_rule_counts_the_engines_bytes():
    """A run byte a cell against 2 bits of code: config 3 (256 x 10 240 bp,
    26.8 GB of run bytes) takes two sub-batches under the 16 GiB budget,
    128 x 10 kb one; the codes engine takes config 3 whole."""
    L10 = 10240
    assert model.code_bytes_per_pair(L10, L10, bits=8) == 10241 * 10241
    assert model.strings_sub_batch(L10, L10, "runs") == 163
    assert model.strings_sub_batch(L10, L10, "auto") == model.strings_sub_batch(L10, L10, "onepass") == 653
    assert -(-256 // model.strings_sub_batch(L10, L10, "runs")) == 2
    assert model.strings_sub_batch(L10, L10, "runs") >= 128
    assert model.strings_sub_batch(3072, 3072, "runs") >= 256
    assert 256 * model.code_bytes_per_pair(L10, L10, bits=8) > 26.8e9
