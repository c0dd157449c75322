"""Smith-Waterman local alignment of nw_tpu_torch against nw_tpu, on the CPU.

The port's plain path (``device="cpu"``: the plain versions of
``sw_scores``, ``sw_fill_codes`` and ``sw_walk``) is held against
``nw_tpu``'s scan oracle (``sw_fill_diag``, ``sw_align``) at every scoring
and against its Pallas kernels K22, K18, K15 and K24 and its batched
walks, run with ``interpret=True``, at the scorings where those follow
its scan (K22, K18 and K24 leave it when k < 0 or d < 0: the two
``follows_scan`` tests pin that).  Inputs are made by
numpy from a seed.  Every output is an integer: comparisons are exact
(tolerance 0).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nw_tpu.models import smith_waterman as ref
from nw_tpu.ops import encode as jenc
from nw_tpu.ops.traceback import ops_to_strings as ref_ops_to_strings
from nw_tpu.ops.variants_banded import sw_scores_banded_batch as k18_scores
from nw_tpu.ops.variants_banded import sw_traceback_banded_batch as k18_traceback
from nw_tpu.ops.variants_pallas import sw_scores_pallas_batch as k22_scores
from nw_tpu.ops.variants_rowsweep import sw_scores_rowsweep_batch as k15_scores
from nw_tpu_torch.models import needleman_wunsch as nw
from nw_tpu_torch.models import smith_waterman as sw
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import traceback as tb
from nw_tpu_torch.ops import variants_banded as vb

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2), (1, 1, -1)]
# where nw_tpu's K22, K18 and K24 follow its scan: no mismatch bonus, no
# gap bonus (their column 0 is not pinned to 0)
NONNEG = [mkd for mkd in SCORINGS if min(mkd[1:]) >= 0]


def _pairs(seed, n, lo, hi, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)

    def one():
        return letters[rng.integers(0, len(letters), int(rng.integers(lo, hi + 1)))].tobytes()

    return [(one(), one()) for _ in range(n)]


GROUPS = {
    "random": _pairs(4, 40, 0, 60),
    "tie_dense": _pairs(5, 10, 10, 60, b"AC"),
    "edge": [(b"", b""), (b"ACGT", b""), (b"", b"ACGT"), (b"AAAA", b"TTTT")],
    # sides over 64 bp: three or more 32-row bands, the best reached in
    # more than one band
    "multiband": [
        # the best, 80 at m = 2, on row 40 and every row after it
        (b"A" * 40, b"A" * 70),
        # 20 in band 0 at (j, i) = (10, 50), diagonal 60, and in band 1 at
        # (43, 10), diagonal 53: the later band holds the earlier diagonal
        (b"T" * 10 + b"C" * 30 + b"A" * 10 + b"C" * 10, b"A" * 10 + b"G" * 23 + b"T" * 10 + b"G" * 2),
    ] + _pairs(6, 4, 65, 130) + _pairs(7, 3, 65, 130, b"AC"),
}
PAIRS = GROUPS["random"] + GROUPS["tie_dense"] + GROUPS["edge"]  # sides <= 60 for interpret mode


@functools.lru_cache(maxsize=None)
def _scan(a, s, mkd):
    """nw_tpu's sw_fill_diag: (score, argmax (j, i), arrows)."""
    out = ref.sw_fill_diag(jnp.asarray(jenc.encode(a)), jnp.asarray(jenc.encode(s)), *mkd)
    return int(out["score"]), tuple(int(x) for x in np.asarray(out["argmax"])), np.asarray(out["arrows"])


@functools.lru_cache(maxsize=None)
def _align(a, s, mkd):
    return ref.sw_align(a, s, *mkd)


def _upload(pairs):
    return enc.upload(enc.encode_batch(pairs), "cpu")


def _decode(codes, len1, len2):
    """One pair's band-major codes -> uint8[len2, len1 + 1] (rows 1..len2)."""
    words = codes.numpy().view(np.uint32)
    r = np.arange(len2)[:, None]
    t = np.arange(len1 + 1)[None, :] + (r & 31)
    return (words[r >> 5, t >> 4, r & 31] >> (2 * (t & 15)).astype(np.uint32)) & 3


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("mkd", SCORINGS)
def test_sw_fill_diag_matches_nw_tpu(mkd, group):
    for a, s in GROUPS[group]:
        score, argmax, arrows = _scan(a, s, mkd)
        got = sw.sw_fill_diag(enc.encode(a), enc.encode(s), *mkd)
        assert (int(got["score"]), tuple(got["argmax"].tolist())) == (score, argmax), (a, s)
        np.testing.assert_array_equal(got["arrows"].numpy(), arrows, err_msg=str((a, s)))
        got = sw.sw_fill_diag(enc.encode(a), enc.encode(s), *mkd, with_arrows=False)
        assert "arrows" not in got and int(got["score"]) == score


@pytest.mark.parametrize("mkd", SCORINGS)
def test_sw_score_batch_matches_scan(mkd):
    pairs = PAIRS + GROUPS["multiband"]
    got = sw.sw_score_batch(pairs, *mkd, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(pairs),)
    assert got.tolist() == [_scan(a, s, mkd)[0] for a, s in pairs]


@pytest.mark.parametrize(
    "mkd,kernel",
    [(mkd, kern) for mkd in NONNEG for kern in ("K22", "K18")] + [(mkd, "K15") for mkd in SCORINGS],
)
def test_sw_score_batch_matches_pallas(mkd, kernel):
    tops, sides, l1, l2 = jenc.encode_batch(PAIRS)
    if kernel == "K22":
        want = k22_scores(tops, sides, l1, l2, *mkd, interpret=True)
    elif kernel == "K18":
        want = k18_scores(tops, sides, l1, l2, *mkd, interpret=True)
    else:
        want = k15_scores(tops, sides, l1, l2, *mkd, rows=32, interpret=True)
    np.testing.assert_array_equal(sw.sw_score_batch(PAIRS, *mkd, device="cpu"), np.asarray(want))


@pytest.mark.parametrize("mkd", SCORINGS)
def test_sw_align_batch_matches_sw_align(mkd):
    want = [_align(a, s, mkd) for a, s in PAIRS]
    assert sw.sw_align_batch(PAIRS, *mkd, device="cpu") == want
    assert [sw.sw_align(a, s, *mkd, device="cpu") for a, s in PAIRS] == want


@pytest.mark.parametrize("engine", ["K24", "K18"])
@pytest.mark.parametrize("mkd", NONNEG)
def test_sw_align_batch_matches_nw_tpu_batch(mkd, engine):
    if engine == "K24":  # K24 + the vmapped _sw_walk_packed, interpreted off the TPU
        want = ref.sw_align_batch(PAIRS, *mkd)
    else:
        tops, sides, l1, l2 = jenc.encode_batch(PAIRS)
        best, jst, ist, j_end, i_end, ops, n = k18_traceback(tops, sides, l1, l2, *mkd, interpret=True)
        want = [
            (int(best[b]),
             *ref_ops_to_strings(ops[b], int(n[b]), a[: int(ist[b])], s[: int(jst[b])]),
             (int(j_end[b]), int(i_end[b])))
            for b, (a, s) in enumerate(PAIRS)
        ]
    assert sw.sw_align_batch(PAIRS, *mkd, device="cpu") == want


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("mkd", SCORINGS)
def test_plain_codes_and_walk_match_sw_traceback(mkd, group):
    pairs = GROUPS[group]
    codes, best, jst, ist = vb.sw_fill_codes_banded_batch(*_upload(pairs), *mkd)
    ops, n, i_end, j_end = tb.walk_sw_codes_batch(codes, jst, ist)
    for b, (a, s) in enumerate(pairs):
        score, (j, i), arrows = _scan(a, s, mkd)
        want = ref.sw_traceback(arrows, (j, i), a, s)
        assert sw.sw_traceback(arrows, (j, i), a, s) == want
        assert (int(best[b]), int(jst[b]), int(ist[b])) == (score, j, i), (a, s)
        assert tb.ops_to_strings(ops[b].numpy(), int(n[b]), a[:i], s[:j]) == want[:2], (a, s)
        assert (int(j_end[b]), int(i_end[b])) == want[2], (a, s)
        # every cell's code: the greedy choice of nw_tpu's masks, STOP
        # (3) where a cell has none (column 0, every cell of score 0)
        rect = arrows[np.arange(len(a) + 1)[None, :] + np.arange(1, len(s) + 1)[:, None],
                      np.arange(1, len(s) + 1)[:, None]]
        want_codes = np.select([rect & 1 != 0, rect & 2 != 0, rect & 4 != 0], [0, 1, 2], 3)
        np.testing.assert_array_equal(_decode(codes[b], len(a), len(s)), want_codes)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_multiband_matches_nw_tpu(mkd):
    pairs = GROUPS["multiband"]
    assert sw.sw_align_batch(pairs, *mkd, device="cpu") == [_align(a, s, mkd) for a, s in pairs]


def test_later_band_wins_on_an_earlier_diagonal():
    (a40, a70), (a, s) = GROUPS["multiband"][:2]
    assert _scan(a40, a70, (2, 1, 1))[:2] == (80, (40, 40))
    score, argmax, _ = _scan(a, s, (2, 1, 1))
    assert (score, argmax) == (20, (43, 10))  # diagonal 53 beats band 0's diagonal 60
    codes, best, jst, ist = vb.sw_fill_codes_banded_batch(*_upload([(a, s), (a40, a70)]), 2, 1, 1)
    assert list(zip(best.tolist(), jst.tolist(), ist.tolist())) == [(20, 43, 10), (80, 40, 40)]
    assert sw.sw_align(a, s, device="cpu") == (20, b"T" * 10, b"T" * 10, (33, 0))


def test_sw_follows_scan_at_negative_gap():
    pairs = [(b"GATTACA", b"GCAT"), (b"ACGTACGT", b"TTACG"), (b"AAAA", b"TTTT")]
    mkd = (1, 1, -1)
    want = [_scan(a, s, mkd)[0] for a, s in pairs]
    assert want == [10, 12, 7]
    assert sw.sw_score_batch(pairs, *mkd, device="cpu").tolist() == want
    assert sw.sw_align_batch(pairs, *mkd, device="cpu") == [_align(a, s, mkd) for a, s in pairs]
    assert sw.sw_align(*pairs[0], *mkd, device="cpu") == (10, b"G---ATTACA", b"GCAT------", (0, 0))
    # nw_tpu's K22 and K18 leave column 0 free there: one more each
    tops, sides, l1, l2 = jenc.encode_batch(pairs)
    assert np.asarray(k22_scores(tops, sides, l1, l2, *mkd, interpret=True)).tolist() == [11, 13, 8]
    assert np.asarray(k18_scores(tops, sides, l1, l2, *mkd, interpret=True)).tolist() == [11, 13, 8]


def test_sw_follows_scan_at_negative_mismatch():
    pair, mkd = (b"A", b"AAA"), (3, -1, 2)
    assert _scan(*pair, mkd)[0] == 3
    assert sw.sw_score_batch([pair], *mkd, device="cpu").tolist() == [3]
    assert sw.sw_align(*pair, *mkd, device="cpu") == _align(*pair, mkd) == (3, b"A", b"A", (0, 0))
    # nw_tpu's K22 and K18 score column 0's mismatch bonus; its
    # sw_align_batch returns a start outside the table
    tops, sides, l1, l2 = jenc.encode_batch([pair])
    assert np.asarray(k22_scores(tops, sides, l1, l2, *mkd, interpret=True)).tolist() == [4]
    assert np.asarray(k18_scores(tops, sides, l1, l2, *mkd, interpret=True)).tolist() == [4]
    assert ref.sw_align_batch([pair], *mkd)[0][3] == (1, -1)


def test_sw_align_batch_sub_batches(monkeypatch):
    pairs = GROUPS["random"][:11]
    want = sw.sw_align_batch(pairs, device="cpu")
    L1, L2 = (max(len(p[x]) for p in pairs) for x in (0, 1))
    monkeypatch.setattr(sw, "CODE_BUDGET_BYTES", 3 * nw.code_bytes_per_pair(L1, L2))
    assert sw.sw_align_batch(pairs, device="cpu") == want
    assert want == [_align(a, s, (2, 1, 1)) for a, s in pairs]


def test_sw_empty_batch_and_no_card(monkeypatch):
    assert sw.sw_score_batch([], device="cpu").shape == (0,)
    assert sw.sw_align_batch([], device="cpu") == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (sw.sw_score_batch, sw.sw_align_batch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn([(b"ACGT", b"ACGT")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sw.sw_align("ACGT", "ACGT")


def test_sw_walk_rejects_a_start_outside_the_codes():
    codes, _, jst, ist = vb.sw_fill_codes_banded_batch(*_upload(GROUPS["edge"]), 2, 1, 1)
    for bad_j, bad_i in ((33, 0), (0, 33), (-1, 0)):
        with pytest.raises(ValueError, match="inside the code table"):
            tb.walk_sw_codes_batch(codes, torch.full_like(jst, bad_j), torch.full_like(ist, bad_i))
