"""nw_tpu_torch's small public helpers vs nw_tpu's: ``decode``,
``pad_to`` and ``encode_pair`` (``ops/encode.py``), ``num_diagonals``
and ``fill_matrix`` (``ops/fill_scan.py``).  Inputs from numpy seeds;
every output is an integer, compared exactly."""

import numpy as np
import pytest
import torch

from nw_tpu.ops import encode as jenc
from nw_tpu.ops import fill_scan as jfs
from nw_tpu_torch.ops import encode as tenc
from nw_tpu_torch.ops import fill_scan as tfs

EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"A", b"A"), (b"GCATGCU", b"GATTACA")]
SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2), (1, 1, 2**30), (2**31 - 1, -(2**31), 2**30)]


def _pairs(seed, n, hi, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(alphabet, np.uint8)
    return [(letters[rng.integers(0, len(letters), int(rng.integers(0, hi)))].tobytes(),
             letters[rng.integers(0, len(letters), int(rng.integers(0, hi)))].tobytes()) for _ in range(n)] + EDGE


@pytest.mark.parametrize("seq", [b"", b"A", b"GATTACA", bytes(range(128)), "GCAT"])
def test_decode_inverts_encode(seq):
    codes = tenc.encode(seq)
    want = jenc.decode(jenc.encode(seq))
    assert tenc.decode(codes) == want
    assert tenc.decode(torch.from_numpy(codes)) == want
    # the pad sentinels are dropped
    padded = tenc.pad_to(codes, codes.shape[0] + 5, tenc.PAD_SIDE)
    assert tenc.decode(padded) == jenc.decode(padded) == want


@pytest.mark.parametrize("length", [7, 8, 20])
@pytest.mark.parametrize("fill", [tenc.PAD_TOP, tenc.PAD_SIDE, 0])
def test_pad_to_identical(length, fill):
    arr = tenc.encode(b"GATTACA")
    got, want = tenc.pad_to(arr, length, fill), jenc.pad_to(arr, length, fill)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_pad_to_refuses_a_longer_sequence():
    arr = tenc.encode(b"GATTACA")
    for mod in (tenc, jenc):
        with pytest.raises(ValueError, match="exceeds bucket"):
            mod.pad_to(arr, 6, -1)


@pytest.mark.parametrize("lens", [(None, None), (9, 12), (7, None)])
@pytest.mark.parametrize("seed", range(3))
def test_encode_pair_identical(seed, lens):
    for s1, s2 in _pairs(seed, 6, 8):
        got, want = tenc.encode_pair(s1, s2, *lens), jenc.encode_pair(s1, s2, *lens)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[2:] == want[2:] == (len(s1), len(s2))
    with pytest.raises(ValueError):
        tenc.encode_pair(b"GATTACA", b"GA", 3, None)


@pytest.mark.parametrize("len1, len2", [(0, 0), (5, 0), (0, 3), (7, 4), (100, 250)])
def test_num_diagonals(len1, len2):
    assert tfs.num_diagonals(len1, len2) == jfs.num_diagonals(len1, len2) == len1 + len2 + 1


@pytest.mark.parametrize("mkd", SCORINGS)
def test_fill_matrix_identical(mkd):
    for s1, s2 in _pairs(sum(mkd) % 61, 4, 40) + _pairs(7, 2, 30, b"AC"):
        top, side = jenc.encode(s1), jenc.encode(s2)
        w_scores, w_arrows = jfs.fill_matrix(top, side, *mkd)
        g_scores, g_arrows = tfs.fill_matrix(torch.from_numpy(top), torch.from_numpy(side), *mkd)
        assert isinstance(g_scores, torch.Tensor) and g_scores.shape == (len(s2) + 1, len(s1) + 1)
        np.testing.assert_array_equal(g_scores.numpy(), np.asarray(w_scores))
        np.testing.assert_array_equal(g_arrows.numpy().astype(np.int64), np.asarray(w_arrows).astype(np.int64))
    # numpy inputs too
    got = tfs.fill_matrix(tenc.encode(b"GCATGCU"), tenc.encode(b"GATTACA"), 1, 1, 1)
    want = jfs.fill_matrix(jenc.encode(b"GCATGCU"), jenc.encode(b"GATTACA"), 1, 1, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))
