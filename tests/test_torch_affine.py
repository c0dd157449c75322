"""Gotoh affine-gap scores of nw_tpu_torch against nw_tpu, on the CPU.

The port's plain path (``affine_score``, ``affine_score_batch`` and
``affine_score_pairs(device="cpu")``, the plain version of
``gotoh_scores``) is held against ``nw_tpu``'s scan oracle
(``affine_score`` / ``affine_score_batch``) at every scoring, and against
its Pallas kernels K17 (``affine_scores_rowsweep_batch``), K20
(``affine_scores_banded_batch``) and K23 (``affine_scores_pallas_batch``),
run with ``interpret=True``, at the scorings where those follow the scan
(they leave it at gap costs near the sentinel: the ``large_gaps`` test
pins that).  Inputs are made by numpy from a seed.  Every output is an
integer: comparisons are exact (tolerance 0).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nw_tpu.models import affine as ref
from nw_tpu.ops import encode as jenc
from nw_tpu.ops.variants_banded import affine_scores_banded_batch as k20_scores
from nw_tpu.ops.variants_pallas import affine_scores_pallas_batch as k23_scores
from nw_tpu.ops.variants_rowsweep import affine_scores_rowsweep_batch as k17_scores
from nw_tpu_torch import align_batch
from nw_tpu_torch.models import affine as af
from nw_tpu_torch.ops import encode as enc

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# (m, k, open, extend)
SCORINGS = [(2, 1, 3, 1), (1, 1, 1, 1), (0, 0, 0, 0), (3, -1, 2, 1), (2, 1, 1, 3), (1, 1, -1, -1)]
HUGE_GAPS = (1, 1, 2**28, 2**28)  # boundary gaps near the sentinel NEG_INF // 2
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
