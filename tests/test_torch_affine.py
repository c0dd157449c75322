"""Gotoh affine-gap scores and alignments of nw_tpu_torch against nw_tpu,
on the CPU.

The port's plain path (``affine_score``, ``affine_score_batch`` and
``affine_score_pairs(device="cpu")``, the plain version of
``gotoh_scores``) is held against ``nw_tpu``'s scan oracle
(``affine_score`` / ``affine_score_batch``) at every scoring, and against
its Pallas kernels K17 (``affine_scores_rowsweep_batch``), K20
(``affine_scores_banded_batch``) and K23 (``affine_scores_pallas_batch``),
run with ``interpret=True``, at the scorings where those follow the scan
(they leave it at gap costs near the sentinel: the ``large_gaps`` test
pins that).

The alignments: the plain state bits (``affine_fill_arrows``, the plain
version of ``gotoh_fill_codes``) against ``nw_tpu``'s
``affine_fill_arrows`` and against K25 (``affine_arrows_pallas_batch``,
interpret mode); ``affine_align`` / ``affine_align_batch(device="cpu")``
(the plain ``gotoh_walk``) against ``nw_tpu``'s ``affine_align`` and K21
(``affine_traceback_banded_batch``, interpret mode, both engines); near
the sentinel the port spells its inputs where ``nw_tpu`` does not.  The
host strings: the native builder against the numpy path.  Inputs are
made by numpy from a seed.  Every output is an integer or a byte string:
comparisons are exact (tolerance 0).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nw_tpu.models import affine as ref
from nw_tpu.ops import encode as jenc
from nw_tpu.ops.traceback import ops_to_strings as jax_ops_to_strings
from nw_tpu.ops.variants_banded import affine_scores_banded_batch as k20_scores
from nw_tpu.ops.variants_banded import affine_traceback_banded_batch as k21_align
from nw_tpu.ops.variants_pallas import affine_arrows_pallas_batch as k25_codes
from nw_tpu.ops.variants_pallas import affine_scores_pallas_batch as k23_scores
from nw_tpu.ops.variants_rowsweep import affine_scores_rowsweep_batch as k17_scores
from nw_tpu_torch import align_batch
from nw_tpu_torch.models import affine as af
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import traceback as tb
from nw_tpu_torch.ops import variants_banded as vb
from nw_tpu_torch.runtime import native

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# (m, k, open, extend)
SCORINGS = [(2, 1, 3, 1), (1, 1, 1, 1), (0, 0, 0, 0), (3, -1, 2, 1), (2, 1, 1, 3), (1, 1, -1, -1)]
HUGE_GAPS = (1, 1, 2**28, 2**28)  # boundary gaps near the sentinel NEG_INF // 2
# the alignments' seven scorings: SCORINGS and tests/test_variants_pallas.py:103
ALIGN_SCORINGS = SCORINGS + [(3, 1, 4, 0)]
LARGE_GAPS = [HUGE_GAPS, (1, 1, 1, 2**29)]
# small TPU geometry, so that interpret mode crosses bands and chunks
K20_GEOMETRY = dict(band_rows=8, chunk=8, unroll=4)


def _pairs(seed, n, lo, hi, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)

    def one():
        return letters[rng.integers(0, len(letters), int(rng.integers(lo, hi + 1)))].tobytes()

    return [(one(), one()) for _ in range(n)]


GROUPS = {
    "random": _pairs(51, 30, 0, 50),
    "tie_dense": _pairs(52, 8, 10, 50, b"AC"),
    "edge": [(b"", b""), (b"ACGT", b""), (b"", b"ACGT"), (b"AAAA", b"TTTT"), (b"A", b"AAA"),
             (b"GATTACA", b"GCAT"), (b"ACGTACGT", b"TTACG")],
    # sides over 64 bp: three or more 32-row bands
    "multiband": _pairs(53, 4, 65, 110) + _pairs(54, 2, 65, 110, b"AC"),
}
PAIRS = GROUPS["random"] + GROUPS["tie_dense"] + GROUPS["edge"]  # sides <= 50 for interpret mode


@functools.lru_cache(maxsize=None)
def _scan(a, s, sc):
    """nw_tpu's affine_score of one pair."""
    return int(ref.affine_score(jnp.asarray(jenc.encode(a)), jnp.asarray(jenc.encode(s)), *sc))


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("sc", SCORINGS + [HUGE_GAPS])
def test_affine_score_matches_nw_tpu(sc, group):
    for a, s in GROUPS[group]:
        got = af.affine_score(enc.encode(a), enc.encode(s), *sc)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == _scan(a, s, sc), (a, s)


@pytest.mark.parametrize("sc", SCORINGS + [HUGE_GAPS])
def test_affine_score_batch_matches_nw_tpu(sc):
    """Equal-length pairs, every pair at its full lengths."""
    for L1, L2 in [(17, 23), (40, 9), (0, 5), (70, 66)]:
        pairs = [(a[:L1].ljust(L1, b"A"), s[:L2].ljust(L2, b"C")) for a, s in _pairs(L1 + L2, 5, 60, 80)]
        tops = np.stack([jenc.encode(a) for a, _ in pairs])
        sides = np.stack([jenc.encode(s) for _, s in pairs])
        want = np.asarray(ref.affine_score_batch(jnp.asarray(tops), jnp.asarray(sides), *sc))
        got = af.affine_score_batch(tops, sides, *sc)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sc", SCORINGS + [HUGE_GAPS])
def test_affine_score_pairs_matches_scan(sc):
    """Ragged lengths, empty and one-sided pairs, several bands."""
    pairs = PAIRS + GROUPS["multiband"]
    got = af.affine_score_pairs(pairs, *sc, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(pairs),)
    assert got.tolist() == [_scan(a, s, sc) for a, s in pairs]


@pytest.mark.parametrize("kernel", ["K17", "K20", "K23"])
@pytest.mark.parametrize("sc", SCORINGS)
def test_affine_score_pairs_matches_pallas(sc, kernel):
    tops, sides, l1, l2 = jenc.encode_batch(PAIRS)
    if kernel == "K17":
        want = k17_scores(tops, sides, l1, l2, *sc, rows=4, interpret=True)
    elif kernel == "K20":
        want = k20_scores(tops, sides, l1, l2, *sc, interpret=True, **K20_GEOMETRY)
    else:
        want = k23_scores(tops, sides, l1, l2, *sc, interpret=True)
    np.testing.assert_array_equal(af.affine_score_pairs(PAIRS, *sc, device="cpu"), np.asarray(want))


def test_affine_follows_scan_at_large_gaps():
    """At open = extend = 2^28 the boundary gaps pass the sentinel
    NEG_INF // 2 = -2^29: the scan writes the sentinel into the states
    that do not exist and takes the max of the three on the boundary;
    the port follows it, nw_tpu's K17, K20 and K23 each leave it."""
    pair = (b"GATTACA", b"GCAT")
    assert _scan(*pair, HUGE_GAPS) == -536870916
    assert af.affine_score_pairs([pair], *HUGE_GAPS, device="cpu").tolist() == [-536870916]
    assert int(af.affine_score(enc.encode(pair[0]), enc.encode(pair[1]), *HUGE_GAPS)) == -536870916
    tops, sides, l1, l2 = jenc.encode_batch([pair])
    assert np.asarray(k17_scores(tops, sides, l1, l2, *HUGE_GAPS, rows=4, interpret=True)).tolist() == [-536870918]
    assert np.asarray(k20_scores(tops, sides, l1, l2, *HUGE_GAPS, interpret=True, **K20_GEOMETRY)).tolist() == [
        -536870912
    ]
    assert np.asarray(k23_scores(tops, sides, l1, l2, *HUGE_GAPS, interpret=True)).tolist() == [-536870912]


@pytest.mark.parametrize("m,k,d", [(2, 1, 1), (1, 1, 1), (3, 2, 2), (0, 0, 1), (2, 3, 2)])
def test_open_equal_extend_is_the_linear_score(m, k, d):
    """With open == extend == d and k < 2d no optimal linear path puts an
    up move beside a left move (one mismatch costs less than two gaps),
    so the Gotoh score is the port's Needleman-Wunsch score."""
    assert k < 2 * d
    pairs = PAIRS + GROUPS["multiband"]
    want = align_batch(pairs, m, k, d, device="cpu").scores
    np.testing.assert_array_equal(af.affine_score_pairs(pairs, m, k, d, d, device="cpu"), want)


def test_affine_empty_batch_and_no_card(monkeypatch):
    assert af.affine_score_pairs([], 2, 1, 3, 1, device="cpu").shape == (0,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        af.affine_score_pairs([(b"ACGT", b"ACGT")], 2, 1, 3, 1)


@functools.lru_cache(maxsize=None)
def _ref_arrows(a, s, sc):
    """nw_tpu's affine_fill_arrows of one pair: (rect[j, i] of its state
    bits, score, corner state)."""
    out = ref.affine_fill_arrows(jnp.asarray(jenc.encode(a)), jnp.asarray(jenc.encode(s)), *sc)
    arrows = np.asarray(out["arrows"])
    rect = np.zeros((len(s) + 1, len(a) + 1), np.uint8)
    if arrows.size:
        j, i = np.mgrid[: len(s) + 1, : len(a) + 1]
        rect = arrows[i + j, j]
    return rect, int(out["score"]), int(out["state"])


@functools.lru_cache(maxsize=None)
def _ref_align(a, s, sc):
    """nw_tpu's affine_align of one pair."""
    return ref.affine_align(a, s, *sc)


def _code_rect(codes, A, Bs):
    """4-bit band-major words int32[B, nbands, TW, 32] -> uint8[B, Bs+1,
    A+1], cell (j, i) at [b, j, i] (row 0: 0)."""
    w = codes.numpy().view(np.uint32)
    j, i = np.mgrid[1 : Bs + 1, : A + 1]
    r = j - 1
    t = i + (r & 31)
    rect = (w[:, r >> 5, t >> 3, r & 31] >> (4 * (t & 7))) & 15
    return np.concatenate([np.zeros((w.shape[0], 1, A + 1), np.uint32), rect], 1).astype(np.uint8)


def _spells(pair, X, Y):
    """X / Y are the pair's strings with gaps added, never two gaps in a
    column."""
    x, y = np.frombuffer(X, np.uint8), np.frombuffer(Y, np.uint8)
    gx, gy = x == ord("-"), y == ord("-")
    return (len(x) == len(y) and not (gx & gy).any()
            and x[~gx].tobytes() == pair[0] and y[~gy].tobytes() == pair[1])


@pytest.mark.parametrize("sc", ALIGN_SCORINGS + LARGE_GAPS)
def test_affine_fill_arrows_matches_nw_tpu(sc):
    """The plain state bits of every interior cell, the score and the
    corner state of each pair, at every scoring."""
    for a, s in PAIRS:
        out = af.affine_fill_arrows(enc.encode(a), enc.encode(s), *sc)
        want, score, state = _ref_arrows(a, s, sc)
        rect = np.zeros_like(want)
        if a or s:
            j, i = np.mgrid[: len(s) + 1, : len(a) + 1]
            rect = out["arrows"].numpy()[i + j, j]
        np.testing.assert_array_equal(rect[1:, 1:], want[1:, 1:], err_msg=str((a, s)))
        assert (int(out["score"]), int(out["state"])) == (score, state), (a, s)


@pytest.mark.parametrize("sc", ALIGN_SCORINGS + LARGE_GAPS)
def test_gotoh_codes_plain_decode_to_nw_tpu_bits(sc):
    """The plain version of ``gotoh_fill_codes`` over a padded batch (sides
    over 64 bp: three or more bands): its 4-bit words decode to nw_tpu's
    bits on each pair's interior cells, and its scores and states are
    nw_tpu's."""
    pairs = PAIRS + GROUPS["multiband"]
    tops, sides, l1, l2 = enc.upload(enc.encode_batch(pairs), "cpu")
    codes, scores, states = vb.affine_fill_codes_banded_batch(tops, sides, l1, l2, *sc)
    assert codes.shape == vb.code_shape(len(pairs), tops.shape[1], sides.shape[1], bits=4)
    rect = _code_rect(codes, tops.shape[1], sides.shape[1])
    for b, (a, s) in enumerate(pairs):
        want, score, state = _ref_arrows(a, s, sc)
        np.testing.assert_array_equal(rect[b, 1 : len(s) + 1, 1 : len(a) + 1], want[1:, 1:], err_msg=str((a, s)))
        assert (int(scores[b]), int(states[b])) == (score, state), (a, s)
    assert not rect[:, :, 0].any()  # column 0 carries no code


@pytest.mark.parametrize("sc", ALIGN_SCORINGS)
def test_gotoh_codes_match_k25(sc):
    """K25 in interpret mode: its 8-bit words decode to the port's codes
    on every interior cell, except the IX-extend bit of column 1 and the
    IY-extend bit of row 1, which compare states of column 0 / row 0 that
    K25 leaves to its chains (the walk leaves the rectangle's edge by the
    boundary rule there, whatever the bit); best and corner state equal."""
    tops, sides, l1, l2 = jenc.encode_batch(PAIRS)
    words, best, states = k25_codes(tops, sides, l1, l2, *sc, interpret=True)
    words = np.asarray(words).view(np.uint32)
    codes, scores, st = vb.affine_fill_codes_banded_batch(*enc.upload((tops, sides, l1, l2), "cpu"), *sc)
    rect = _code_rect(codes, tops.shape[1], sides.shape[1])
    for b, (a, s) in enumerate(PAIRS):
        j, i = np.mgrid[1 : len(s) + 1, 1 : len(a) + 1]
        kk = i + j
        k25 = (words[kk >> 2, j, b] >> ((kk & 3) * 8)) & 0xFF
        mask = np.where(i == 1, ~4, 0xFF) & np.where(j == 1, ~8, 0xFF)
        np.testing.assert_array_equal(k25 & mask, rect[b, 1 : len(s) + 1, 1 : len(a) + 1] & mask,
                                      err_msg=str((a, s)))
    np.testing.assert_array_equal(np.asarray(best), scores.numpy())
    np.testing.assert_array_equal(np.asarray(states), st.numpy())


@pytest.mark.parametrize("sc", ALIGN_SCORINGS)
def test_affine_align_matches_nw_tpu(sc):
    """``affine_align_batch`` and ``affine_align`` on the CPU (the plain
    ``gotoh_fill_codes`` and ``gotoh_walk``), and the host walk
    ``affine_traceback`` over ``affine_fill_arrows``, give nw_tpu's
    ``affine_align`` byte for byte."""
    pairs = PAIRS + GROUPS["multiband"]
    want = [_ref_align(a, s, sc) for a, s in pairs]
    assert af.affine_align_batch(pairs, *sc, device="cpu") == want
    for (a, s), w in zip(pairs, want):
        out = af.affine_fill_arrows(enc.encode(a), enc.encode(s), *sc)
        assert (int(out["score"]), *af.affine_traceback(out["arrows"], out["state"], a, s)) == w, (a, s)
    for a, s in GROUPS["edge"]:
        assert af.affine_align(a, s, *sc, device="cpu") == _ref_align(a, s, sc)


@pytest.mark.parametrize("sc", [(2, 1, 3, 1), (3, -1, 2, 1), (2, 1, 1, 3)])
@pytest.mark.parametrize("engine", ["onepass", "twopass"])
def test_affine_align_batch_matches_k21(engine, sc, monkeypatch):
    """K21 in interpret mode, at tests/test_banded.py:338-359's small
    geometry, on both of its engines."""
    if engine == "onepass":
        monkeypatch.setenv("NW_TPU_ONEPASS_HBM", str(8 << 30))
    else:
        monkeypatch.delenv("NW_TPU_ONEPASS_HBM", raising=False)
    tops, sides, l1, l2 = jenc.encode_batch(PAIRS)
    score, ops, n = k21_align(
        tops, sides, l1, l2, *sc, interpret=True, band_rows=8, chunk=8, unroll=4, group_bands=2
    )
    want = [(int(score[b]), *jax_ops_to_strings(ops[b], int(n[b]), a, s)) for b, (a, s) in enumerate(PAIRS)]
    assert af.affine_align_batch(PAIRS, *sc, device="cpu") == want


@pytest.mark.parametrize("sc", LARGE_GAPS)
def test_affine_align_spells_inputs_at_large_gaps(sc):
    """Near the sentinel the states of row 0 and column 0 send nw_tpu's
    walks off the rectangle; the port's walk steps LEFT on row 0 and UP on
    column 0, so every alignment spells both inputs, and its score is the
    scan's (``affine_fill_arrows``)."""
    pairs = PAIRS + GROUPS["multiband"]
    got = af.affine_align_batch(pairs, *sc, device="cpu")
    for (a, s), (score, X, Y) in zip(pairs, got):
        assert _spells((a, s), X, Y), (a, s, X, Y)
        assert score == _ref_arrows(a, s, sc)[1], (a, s)
        out = af.affine_fill_arrows(enc.encode(a), enc.encode(s), *sc)
        assert af.affine_traceback(out["arrows"], out["state"], a, s) == (X, Y)
    pair = (b"GATTACA", b"GCAT")
    got = af.affine_align(*pair, *sc, device="cpu")
    tops, sides, l1, l2 = jenc.encode_batch([pair])
    k21 = k21_align(tops, sides, l1, l2, *sc, interpret=True, band_rows=8, chunk=8, unroll=4, group_bands=2)
    k25 = ref.affine_align_batch([pair], *sc)[0]  # K25 in interpret mode on the CPU
    if sc == HUGE_GAPS:
        assert got[0] == -536870916
        # nw_tpu's scan walk reads side[j-1] at j = 0, and fails on an empty side
        assert ref.affine_align(*pair, *sc) == (-536870916, b"GATTACA", b"CATGCAT")
        with pytest.raises(IndexError):
            ref.affine_align(b"ACGT", b"", *sc)
        # K25 and K21 take K23's / K20's sentinel difference, and their
        # walks leave the rectangle as well
        assert k25[0] == -536870912 and not _spells(pair, *k25[1:])
        assert int(k21[0][0]) == -536870912
        assert jax_ops_to_strings(k21[1][0], int(k21[2][0]), *pair) == (b"TTACA", b"TGCAT")
    else:
        assert got[0] == 2147483645
        assert ref.affine_align(*pair, *sc) == (2147483645, b"GATTAC-A-", b"CAT--GCAT")
        assert k25 == (-3, b"GATTACA", b"G-C-A-T") and int(k21[0][0]) == -3
    assert _spells(pair, *got[1:])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ops_to_strings_native_matches_numpy(seed):
    """The native one-pass builder (taken whenever the runtime loads)
    against the numpy path, on random walks of random pairs, empty walks
    and empty pairs included."""
    assert native.load() is not None
    rng = np.random.default_rng(seed)
    pairs = _pairs(60 + seed, 20, 0, 40) + [(b"", b""), (b"ACGT", b""), (b"", b"AC")]
    S = max(len(a) + len(s) for a, s in pairs) + 3
    ops = np.full((len(pairs), S), tb.OP_NONE, np.int8)
    ns = np.zeros(len(pairs), np.int32)
    for b, (a, s) in enumerate(pairs):
        i, j = len(a), len(s)
        while i > 0 or j > 0:
            op = tb.OP_LEFT if j == 0 else tb.OP_UP if i == 0 else int(rng.integers(0, 3))
            ops[b, ns[b]] = op
            ns[b] += 1
            i -= op != tb.OP_UP
            j -= op != tb.OP_LEFT
    want = tb.ops_to_strings_batch_plain(ops, ns, pairs)
    assert tb.ops_to_strings_batch(ops, ns, pairs) == want
    assert all(_spells(p, X, Y) for p, (X, Y) in zip(pairs, want))
    assert tb.ops_to_strings_batch(ops[:0], ns[:0], []) == []


def test_affine_align_empty_batch_and_no_card(monkeypatch):
    assert af.affine_align_batch([], 2, 1, 3, 1, device="cpu") == []
    assert af.affine_align(b"", b"", 2, 1, 3, 1, device="cpu") == (0, b"", b"")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        af.affine_align_batch([(b"ACGT", b"ACGT")], 2, 1, 3, 1)
