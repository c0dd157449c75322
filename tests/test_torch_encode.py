"""nw_tpu_torch host layer vs nw_tpu: encoding, bucketing, config."""

import dataclasses

import numpy as np
import pytest

from nw_tpu import config as jcfg
from nw_tpu.ops import encode as jenc
from nw_tpu_torch import config as tcfg
from nw_tpu_torch.ops import encode as tenc

EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"A", b"A")]


def _pairs(seed, n, hi):
    rng = np.random.default_rng(seed)
    return [
        (
            rng.integers(0, 256, int(rng.integers(0, hi))).astype(np.uint8).tobytes(),
            rng.integers(0, 256, int(rng.integers(0, hi))).astype(np.uint8).tobytes(),
        )
        for _ in range(n)
    ] + EDGE


def test_pad_sentinels_match():
    assert (tenc.PAD_TOP, tenc.PAD_SIDE) == (jenc.PAD_TOP, jenc.PAD_SIDE) == (-1, -2)


@pytest.mark.parametrize("fn", ["encode_batch", "encode_batch_u8"])
@pytest.mark.parametrize("lens", [(None, None), (64, 96)])
def test_encode_batch_identical(fn, lens):
    ps = _pairs(1, 12, 60)
    want = getattr(jenc, fn)(ps, *lens)
    got = getattr(tenc, fn)(ps, *lens)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


def test_encode_single_and_str_input():
    np.testing.assert_array_equal(tenc.encode("GATTACA"), jenc.encode("GATTACA"))
    want = jenc.encode_batch([("GCATGCU", "GATTACA")], 8, 8)
    got = tenc.encode_batch([("GCATGCU", "GATTACA")], 8, 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_encode_rejects_overlong():
    with pytest.raises(ValueError):
        tenc.encode_batch([(b"ACGTA", b"A")], 4, 4)


def test_upload_keeps_values():
    arrays = tenc.encode_batch(_pairs(2, 4, 20), 32, 32)
    for a, t in zip(arrays, tenc.upload(arrays, "cpu")):
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("ladder", ["default", "none"])
def test_bucket_for_identical(ladder):
    kw = {} if ladder == "default" else {"bucket_sizes": None}
    jc, tc = jcfg.AlignConfig(**kw), tcfg.AlignConfig(**kw)
    for n in list(range(0, 2100)) + [8191, 8192, 8193, 10000, 10240, 10241, 32768, 100000]:
        assert tc.bucket_for(n) == jc.bucket_for(n), n
    if ladder == "default":
        assert tc.bucket_for(10000) == 10240


def test_config_from_dict_round_trip():
    jc = jcfg.AlignConfig(
        scoring=jcfg.ScoringParams(3, -1, 2), band=7, max_alignments=5,
        mesh_shape=(2, 4),
    )
    tc = tcfg.AlignConfig.from_dict(dataclasses.asdict(jc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.scoring.as_tuple() == (3, -1, 2)
    assert [f.name for f in dataclasses.fields(tc)] == [
        f.name for f in dataclasses.fields(jc)
    ]
    assert [f.name for f in dataclasses.fields(tc.scoring)] == [
        f.name for f in dataclasses.fields(jc.scoring)
    ]
    assert tcfg.AlignConfig.from_dict({}) == tcfg.AlignConfig()
