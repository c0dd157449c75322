"""nw_tpu_torch.align_batch (device="cpu") vs nw_tpu.align_batch on the
CPU: scores, uint32 counts, op codes and alignment strings, bit for bit,
in all four modes; plus sub-batching, masking and the BASELINE anchors.
"""

import numpy as np
import pytest

import nw_tpu
from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams, align_batch

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"GCATGCU", b"GATTACA")]
MODES = [(False, False), (False, True), (True, False), (True, True)]


def _pairs(seed, n, lo, hi, alphabet="ACGT"):
    rng = np.random.default_rng(seed)
    return [
        (
            "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode(),
            "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode(),
        )
        for _ in range(n)
    ]


def _assert_same(got, want, strings, count):
    assert got.scores.dtype == np.int32
    np.testing.assert_array_equal(got.scores, np.asarray(want.scores))
    np.testing.assert_array_equal(got.status, np.asarray(want.status))
    if count:
        assert got.counts.dtype == np.uint32
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    else:
        assert got.counts is None
    if strings:
        np.testing.assert_array_equal(got.ops, np.asarray(want.ops))
        np.testing.assert_array_equal(got.ops_len, np.asarray(want.ops_len))
        assert got.alignment_strings() == want.alignment_strings()
    else:
        assert got.ops is None


@pytest.mark.parametrize("strings,count", MODES)
@pytest.mark.parametrize("mkd", [(2, 1, 1), (3, -1, 2)])
def test_align_batch_vs_nw_tpu(strings, count, mkd):
    ps = _pairs(sum(mkd) + 2 * strings + count, 7, 1, 70) + _pairs(4, 3, 20, 40, "AC") + EDGE
    want = nw_tpu.align_batch(ps, *mkd, traceback_strings=strings, count=count)
    got = align_batch(ps, *mkd, device="cpu", traceback_strings=strings, count=count)
    _assert_same(got, want, strings, count)


@pytest.mark.parametrize("strings,count", [(True, False), (True, True)])
def test_sub_batches_concatenate(strings, count):
    ps = _pairs(21, 8, 1, 60) + EDGE
    want = nw_tpu.align_batch(ps, 2, 1, 1, traceback_strings=strings, count=count)
    al = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)), device="cpu")
    got = al.align_batch(ps, traceback_strings=strings, count=count, sub_batch=3)
    _assert_same(got, want, strings, count)


@pytest.mark.parametrize("strings,count", MODES)
def test_on_error_mask(strings, count):
    ps = _pairs(31, 5, 1, 40) + [(b"A" * 50, b"C"), (b"G", b"T" * 45)]
    kw = dict(traceback_strings=strings, count=count, max_length=40)
    want = nw_tpu.align_batch(ps, 1, 1, 1, on_error="mask", **kw)
    got = align_batch(ps, 1, 1, 1, device="cpu", on_error="mask", **kw)
    _assert_same(got, want, strings, count)
    assert list(got.status) == [0] * 5 + [1, 1]
    with pytest.raises(ValueError, match="max_length"):
        align_batch(ps, 1, 1, 1, device="cpu", **kw)


def test_baseline_anchors():
    r = align_batch(
        [("GCATGCU", "GATTACA"), ("GT", "GT"), ("GAT", "GTA")],
        device="cpu", traceback_strings=True, count=True,
    )
    assert list(r.scores) == [0, 2, 0]
    assert list(r.counts) == [3, 1, 2]
    assert r.alignment_strings() == [
        (b"GCA-TGCU", b"G-ATTACA"), (b"GT", b"GT"), (b"G-AT", b"GTA-"),
    ]


def test_empty_batch():
    for strings, count in MODES:
        r = align_batch([], device="cpu", traceback_strings=strings, count=count)
        assert r.scores.shape == (0,)


def test_small_batch_of_huge_pairs_is_not_ported(monkeypatch):
    """A small batch of pairs over HUGE_PAIR_MIN_SIDE (shrunk to 32 in
    both packages) goes pair by pair through the huge-pair routes:
    strings through align_huge's routes, counts through summary_huge;
    everything equals nw_tpu's, which runs the same routes."""
    import nw_tpu.ops.fill_auto as jfa
    from nw_tpu_torch.models import needleman_wunsch as model

    ps = _pairs(44, 3, 33, 70) + [(b"ACGT", b"A" * 40), (b"", b"C" * 35)]
    monkeypatch.setattr(jfa, "HUGE_PAIR_MIN_SIDE", 32)
    monkeypatch.setattr(model, "HUGE_PAIR_MIN_SIDE", 32)
    for strings, count in [(True, False), (True, True)]:
        want = nw_tpu.align_batch(ps, 2, 1, 1, traceback_strings=strings, count=count)
        got = align_batch(ps, 2, 1, 1, device="cpu", traceback_strings=strings, count=count)
        np.testing.assert_array_equal(got.scores, np.asarray(want.scores))
        np.testing.assert_array_equal(got.ops_len, np.asarray(want.ops_len))
        assert got.alignment_strings() == want.alignment_strings()
    calls = []
    monkeypatch.setattr(
        NWAligner, "summary_huge", lambda self, a, b: calls.append((a, b)) or (-7, 2**32 - 1)
    )
    r = align_batch(ps, device="cpu", count=True)
    assert calls == ps
    assert r.scores.tolist() == [-7] * len(ps) and r.counts.tolist() == [2**32 - 1] * len(ps)
