"""Overlap alignment of nw_tpu_torch against nw_tpu, on the CPU.

The port's plain path (``device="cpu"``: the plain versions of
``overlap_scores``, ``overlap_fill_codes`` and ``sw_walk``) is held
against ``nw_tpu``'s scan oracle (``overlap_fill_diag``,
``overlap_align``), its batched ``overlap_align_batch``, and its Pallas
kernels K16 (``overlap_scores_rowsweep_batch``) and K19 (scores, and the
full alignments of ``overlap_traceback_banded_batch``), run with
``interpret=True``.  Inputs are made by numpy from a seed.  Every output
is an integer: comparisons are exact (tolerance 0).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nw_tpu.models import overlap as ref
from nw_tpu.ops import encode as jenc
from nw_tpu.ops.traceback import ops_to_strings as ref_ops_to_strings
from nw_tpu.ops.variants_banded import overlap_scores_banded_batch as k19_scores
from nw_tpu.ops.variants_banded import overlap_traceback_banded_batch as k19_traceback
from nw_tpu.ops.variants_rowsweep import overlap_scores_rowsweep_batch as k16_scores
from nw_tpu_torch.models import needleman_wunsch as nw
from nw_tpu_torch.models import overlap as ov
from nw_tpu_torch.models import smith_waterman as sw
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import traceback as tb
from nw_tpu_torch.ops import variants_banded as vb
from nw_tpu_torch.ops.fill_scan import greedy_codes_from_arrows

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2), (1, 1, -1)]
# small TPU geometries, so that interpret mode crosses bands and chunks
K19_GEOMETRY = dict(band_rows=8, chunk=8, unroll=4)


def _pairs(seed, n, lo, hi, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)

    def one():
        return letters[rng.integers(0, len(letters), int(rng.integers(lo, hi + 1)))].tobytes()

    return [(one(), one()) for _ in range(n)]


# the best 40 at m = 2 on the last column in band 0, (j, i) = (20, 80),
# diagonal 100, and on the last row in band 2, (70, 20), diagonal 90: the
# later band holds the earlier diagonal and wins
TWO_BANDS = (b"C" * 20 + b"G" * 40 + b"A" * 20, b"A" * 20 + b"T" * 30 + b"C" * 20)
GROUPS = {
    "random": _pairs(41, 30, 0, 50),
    "tie_dense": _pairs(42, 8, 10, 50, b"AC"),
    "edge": [(b"", b""), (b"ACGT", b""), (b"", b"ACGT"), (b"AAAA", b"TTTT"), (b"A", b"AAA"),
             (b"GATTACA", b"GCAT"), (b"ACGTACGT", b"TTACG"), (b"AAAATTTT", b"TTTTCCCC")],
    # sides over 64 bp: three or more 32-row bands
    "multiband": [TWO_BANDS, (b"A" * 70, b"A" * 40)] + _pairs(43, 3, 65, 110)
    + _pairs(44, 2, 65, 110, b"AC"),
}
PAIRS = GROUPS["random"] + GROUPS["tie_dense"] + GROUPS["edge"]  # sides <= 50 for interpret mode


@functools.lru_cache(maxsize=None)
def _scan(a, s, mkd):
    """nw_tpu's overlap_fill_diag: (score, argmax (j, i), arrows)."""
    out = ref.overlap_fill_diag(jnp.asarray(jenc.encode(a)), jnp.asarray(jenc.encode(s)), *mkd)
    return int(out["score"]), tuple(int(x) for x in np.asarray(out["argmax"])), np.asarray(out["arrows"])


@functools.lru_cache(maxsize=None)
def _align(a, s, mkd):
    return ref.overlap_align(a, s, *mkd)


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
def test_overlap_fill_diag_matches_nw_tpu(mkd, group):
    for a, s in GROUPS[group]:
        score, argmax, arrows = _scan(a, s, mkd)
        got = ov.overlap_fill_diag(enc.encode(a), enc.encode(s), *mkd)
        assert (int(got["score"]), tuple(got["argmax"].tolist())) == (score, argmax), (a, s)
        np.testing.assert_array_equal(got["arrows"].numpy(), arrows, err_msg=str((a, s)))
        got = ov.overlap_fill_diag(enc.encode(a), enc.encode(s), *mkd, with_arrows=False)
        assert "arrows" not in got and int(got["score"]) == score


@pytest.mark.parametrize("mkd", SCORINGS)
def test_overlap_fill_diag_padded_matches_nw_tpu(mkd):
    """A pair padded to a bucket, its true lengths given: the same score
    and end cell as the pair alone."""
    for a, s in GROUPS["random"][:10] + GROUPS["edge"]:
        top, side = enc.encode_batch([(a, s)], 56, 56)[:2]
        want = ref.overlap_fill_diag(jnp.asarray(top[0]), jnp.asarray(side[0]), *mkd, len(a), len(s),
                                     with_arrows=False)
        got = ov.overlap_fill_diag(top[0], side[0], *mkd, len(a), len(s), with_arrows=False)
        assert (int(got["score"]), got["argmax"].tolist()) == (int(want["score"]), np.asarray(want["argmax"]).tolist())
        assert int(got["score"]) == _scan(a, s, mkd)[0]


@pytest.mark.parametrize("mkd", SCORINGS)
def test_overlap_score_batch_matches_scan(mkd):
    pairs = PAIRS + GROUPS["multiband"]
    got = ov.overlap_score_batch(pairs, *mkd, device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(pairs),)
    assert got.tolist() == [_scan(a, s, mkd)[0] for a, s in pairs]


@pytest.mark.parametrize("kernel", ["K16", "K19"])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_overlap_score_batch_matches_pallas(mkd, kernel):
    tops, sides, l1, l2 = jenc.encode_batch(PAIRS)
    if kernel == "K16":
        want = k16_scores(tops, sides, l1, l2, *mkd, rows=4, interpret=True)
    else:
        want = k19_scores(tops, sides, l1, l2, *mkd, interpret=True, **K19_GEOMETRY)
    np.testing.assert_array_equal(ov.overlap_score_batch(PAIRS, *mkd, device="cpu"), np.asarray(want))


@pytest.mark.parametrize("mkd", SCORINGS)
def test_overlap_align_batch_matches_overlap_align(mkd):
    want = [_align(a, s, mkd) for a, s in PAIRS]
    assert ov.overlap_align_batch(PAIRS, *mkd, device="cpu") == want
    assert [ov.overlap_align(a, s, *mkd, device="cpu") for a, s in PAIRS[::5]] == want[::5]


@pytest.mark.parametrize("engine", ["scan", "K19"])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_overlap_align_batch_matches_nw_tpu_batch(mkd, engine):
    if engine == "scan":  # the batched fill + vmapped _overlap_walk_diag, off the TPU
        want = ref.overlap_align_batch(PAIRS, *mkd)
    else:
        tops, sides, l1, l2 = jenc.encode_batch(PAIRS)
        best, jst, ist, j_st, i_st, ops, n = k19_traceback(
            tops, sides, l1, l2, *mkd, interpret=True, group_bands=2, **K19_GEOMETRY
        )
        want = [
            (int(best[b]),
             *ref_ops_to_strings(ops[b], int(n[b]), a[: int(ist[b])], s[: int(jst[b])]),
             (int(j_st[b]), int(i_st[b])), (int(jst[b]), int(ist[b])))
            for b, (a, s) in enumerate(PAIRS)
        ]
    assert ov.overlap_align_batch(PAIRS, *mkd, device="cpu") == want


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("mkd", SCORINGS)
def test_plain_codes_and_walk_match_overlap_traceback(mkd, group):
    pairs = GROUPS[group]
    codes, best, jst, ist = vb.overlap_fill_codes_banded_batch(*_upload(pairs), *mkd)
    ops, n, i_st, j_st = tb.walk_sw_codes_batch(codes, jst, ist)
    for b, (a, s) in enumerate(pairs):
        score, (j, i), arrows = _scan(a, s, mkd)
        want = ref.overlap_traceback(arrows, (j, i), a, s)
        assert ov.overlap_traceback(arrows, (j, i), a, s) == want
        assert (int(best[b]), int(jst[b]), int(ist[b])) == (score, j, i), (a, s)
        assert tb.ops_to_strings(ops[b].numpy(), int(n[b]), a[:i], s[:j]) == want[:2], (a, s)
        assert (int(j_st[b]), int(i_st[b])) == want[2], (a, s)
        # every cell's code: the greedy choice of nw_tpu's masks, STOP
        # (3) on column 0, the only cells with none
        rect = arrows[np.arange(len(a) + 1)[None, :] + np.arange(1, len(s) + 1)[:, None],
                      np.arange(1, len(s) + 1)[:, None]]
        want_codes = np.select([rect & 1 != 0, rect & 2 != 0, rect & 4 != 0], [0, 1, 2], 3)
        assert (want_codes[:, 1:] != 3).all() and (want_codes[:, 0] == 3).all()
        np.testing.assert_array_equal(_decode(codes[b], len(a), len(s)), want_codes)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_greedy_codes_of_nw_tpu_arrows_equal_plain_codes(mkd):
    """nw_tpu's overlap arrows through ``greedy_codes_from_arrows(...,
    local=True)`` are the plain codes of ``overlap_fill_codes``, word for
    word, one pair at a time (no padding)."""
    for a, s in GROUPS["edge"] + GROUPS["tie_dense"][:4] + GROUPS["multiband"][:2]:
        arrows = torch.from_numpy(_scan(a, s, mkd)[2].copy())
        codes = greedy_codes_from_arrows(arrows[None], local=True)
        want = vb.overlap_fill_codes_banded_batch_plain(*_upload([(a, s)]), *mkd)[0]
        torch.testing.assert_close(codes, want, rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_multiband_matches_nw_tpu(mkd):
    pairs = GROUPS["multiband"]
    assert ov.overlap_align_batch(pairs, *mkd, device="cpu") == [_align(a, s, mkd) for a, s in pairs]


def test_later_band_wins_on_an_earlier_diagonal():
    a, s = TWO_BANDS
    assert _scan(a, s, (2, 1, 1))[:2] == (40, (70, 20))  # diagonal 90 beats band 0's (20, 80)
    codes, best, jst, ist = vb.overlap_fill_codes_banded_batch(*_upload([TWO_BANDS]), 2, 1, 1)
    assert (int(best[0]), int(jst[0]), int(ist[0])) == (40, 70, 20)
    assert ov.overlap_align(a, s, device="cpu") == (40, b"C" * 20, b"C" * 20, (50, 0), (70, 20))
    # the last-column alignment alone, without the last row's
    assert ov.overlap_align(a, s[:50], device="cpu") == (40, b"A" * 20, b"A" * 20, (0, 60), (20, 80))


def test_seed_cell_when_no_end_cell_beats_zero():
    """Every end-boundary cell <= 0: the zero-cost corner (0, len1), or
    (len2, 0) when len1 is 0, and the empty overlap."""
    assert _scan(b"AAAA", b"TTTT", (2, 1, 1))[:2] == (0, (0, 4))
    pairs = [(b"AAAA", b"TTTT"), (b"", b"TTT"), (b"AAA", b""), (b"", b"")]
    want = [(0, b"", b"", (0, 4), (0, 4)), (0, b"", b"", (3, 0), (3, 0)),
            (0, b"", b"", (0, 3), (0, 3)), (0, b"", b"", (0, 0), (0, 0))]
    assert ov.overlap_align_batch(pairs, 2, 1, 1, device="cpu") == want
    assert [_align(a, s, (2, 1, 1)) for a, s in pairs] == want
    assert ov.overlap_score_batch(pairs, 2, 1, 1, device="cpu").tolist() == [0, 0, 0, 0]


def test_overlap_align_batch_sub_batches(monkeypatch):
    pairs = GROUPS["random"][:11]
    want = ov.overlap_align_batch(pairs, device="cpu")
    L1, L2 = (max(len(p[x]) for p in pairs) for x in (0, 1))
    monkeypatch.setattr(sw, "CODE_BUDGET_BYTES", 3 * nw.code_bytes_per_pair(L1, L2))
    assert ov.overlap_align_batch(pairs, device="cpu") == want
    assert want == [_align(a, s, (2, 1, 1)) for a, s in pairs]


def test_overlap_empty_batch_and_no_card(monkeypatch):
    assert ov.overlap_score_batch([], device="cpu").shape == (0,)
    assert ov.overlap_align_batch([], device="cpu") == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (ov.overlap_score_batch, ov.overlap_align_batch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn([(b"ACGT", b"ACGT")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ov.overlap_align("ACGT", "ACGT")
