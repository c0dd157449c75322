"""nw_tpu_torch fills (plain PyTorch) vs nw_tpu on the CPU.

Every output is an integer, so every comparison is exact (tolerance 0):
scores, 3-bit tie masks, decoded 2-bit greedy codes and uint32 counts.
The references are nw_tpu's lax.scan fill + count_paths, and nw_tpu's
K1 / K2 Pallas kernels in interpret mode at tiny geometry (as
tests/test_banded.py runs them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nw_tpu.ops import encode as jenc
from nw_tpu.ops import pathcount as jpath
from nw_tpu.ops.fill_scan import fill_diag_batch as j_fill_diag_batch
from nw_tpu_torch.ops import fill_banded
from nw_tpu_torch.ops.fill_scan import fill_diag_batch
from nw_tpu_torch.ops.pathcount import count_paths_batch

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)]
EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"A", b"A"), (b"GCATGCU", b"GATTACA")]


def _pairs(seed, n, lo, hi, alphabet="ACGTN"):
    rng = np.random.default_rng(seed)
    return [
        (
            "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode(),
            "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode(),
        )
        for _ in range(n)
    ]


def _batch(seed):
    # random pairs, tie-dense two-letter pairs, and the edge pairs
    return _pairs(seed, 5, 1, 45) + _pairs(seed + 1, 4, 15, 30, "AC") + EDGE


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _jax_ref(tops, sides, l1, l2, mkd):
    l1j, l2j = jnp.asarray(l1), jnp.asarray(l2)
    ref = j_fill_diag_batch(tops, sides, *mkd, l1j, l2j)
    counts = np.asarray(jax.vmap(jpath.count_paths)(ref["arrows"], l1j, l2j))
    return np.asarray(ref["score"]), np.asarray(ref["arrows"]), counts


def _greedy_rect(arrows_diag, A1, B2):
    """Greedy code (0 diag, 1 left, 2 up) of the true rectangle from
    diagonal-major tie masks of one pair."""
    jj, ii = np.mgrid[0 : B2 + 1, 0 : A1 + 1]
    a = arrows_diag[ii + jj, jj]
    return np.where(a & 1, 0, np.where(a & 2, 1, 2))


def _decode_codes(codes, A1, B2):
    """True rectangle of the port's band-major packed codes of one pair;
    row 0 is not stored (every step there is LEFT)."""
    jj, ii = np.mgrid[0 : B2 + 1, 0 : A1 + 1]
    jm = np.maximum(jj - 1, 0)
    t = ii + jm % 32
    w = codes[jm // 32, t >> 4, jm % 32].astype(np.int64) if codes.shape[0] else 0 * t
    out = (w >> (2 * (t & 15))) & 3
    out[0, 1:] = 1
    out[0, 0] = 2  # the origin: never read, as the tie-mask greedy rule gives it
    return out


@pytest.mark.parametrize("mkd", SCORINGS)
def test_plain_fill_vs_scan_oracle(mkd):
    ps = _batch(sum(mkd) + 10)
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    want_sc, want_ar, want_ct = _jax_ref(tops, sides, l1, l2, mkd)
    out = fill_diag_batch(*_torch(tops, sides, l1, l2), *mkd, with_counts=True)
    np.testing.assert_array_equal(out["score"].numpy(), want_sc)
    np.testing.assert_array_equal(out["arrows"].numpy(), want_ar)
    np.testing.assert_array_equal(out["count"].numpy(), want_ct.astype(np.int64))
    got_ct = count_paths_batch(out["arrows"], *_torch(l1, l2))
    np.testing.assert_array_equal(got_ct.numpy(), want_ct.astype(np.int64))


def test_counts_wrap_past_2_32():
    """(0,0,0) makes every path optimal: Delannoy-many paths, which pass
    2^32 at ~25 bp sides and must wrap exactly as uint32 does."""
    ps = [(b"A" * 25, b"C" * 25), (b"ACGT" * 7, b"TTGCA" * 5), (b"A" * 12, b"A" * 13)]
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    _, _, want_ct = _jax_ref(tops, sides, l1, l2, (0, 0, 0))
    _, got_ct = fill_banded.fill_scores_counts_banded_batch(
        *_torch(tops, sides, l1, l2), 0, 0, 0
    )
    np.testing.assert_array_equal(got_ct.numpy(), want_ct.astype(np.int64))
    # the central Delannoy number D(25, 25), in Python integers
    D = [[1] * 26 for _ in range(26)]
    for i in range(1, 26):
        for j in range(1, 26):
            D[i][j] = D[i - 1][j] + D[i][j - 1] + D[i - 1][j - 1]
    assert D[25][25] > 2**32
    assert int(got_ct[0]) == D[25][25] % 2**32


@pytest.mark.parametrize("mkd", SCORINGS)
def test_greedy_codes_vs_scan_oracle(mkd):
    ps = _batch(sum(mkd) + 20)
    tops, sides, l1, l2 = jenc.encode_batch(ps, 48, 44)
    want_sc, want_ar, want_ct = _jax_ref(tops, sides, l1, l2, mkd)
    codes, scores, counts = fill_banded.fill_greedy_counts_banded_batch(
        *_torch(tops, sides, l1, l2), *mkd, with_counts=True
    )
    assert tuple(codes.shape) == fill_banded.code_shape(len(ps), 48, 44) == (len(ps), 2, 6, 32)
    np.testing.assert_array_equal(scores.numpy(), want_sc)
    np.testing.assert_array_equal(counts.numpy(), want_ct.astype(np.int64))
    codes = codes.numpy()
    for b, (a, s) in enumerate(ps):
        got = _decode_codes(codes[b], len(a), len(s))
        want = _greedy_rect(want_ar[b], len(a), len(s))
        np.testing.assert_array_equal(got, want, err_msg=str(b))
    # fields of cells outside the bucket table are zero
    full = np.zeros((len(ps), 2, 6, 32, 16), np.int64)
    w = codes.astype(np.int64) & 0xFFFFFFFF
    for q in range(16):
        full[..., q] = (w >> (2 * q)) & 3
    by_step = full.transpose(0, 1, 3, 2, 4).reshape(len(ps), 64, 96)  # [b, row-1, t]
    rows = np.arange(64)[:, None]
    t = np.arange(96)[None, :]
    outside = (rows >= 44) | (t < rows % 32) | (t > 48 + rows % 32)
    assert not by_step[:, outside].any()
    codes2, _, none = fill_banded.fill_greedy_counts_banded_batch(
        *_torch(tops, sides, l1, l2), *mkd
    )
    assert none is None
    np.testing.assert_array_equal(codes2.numpy(), codes)


@pytest.mark.parametrize(
    "geometry,mkd",
    [((8, 8, 2), (2, 1, 1)), ((8, 8, 2), (0, 0, 0)), ((16, 8, 4), (3, -1, 2))],
)
def test_scores_vs_k1_interpret(geometry, mkd):
    from nw_tpu.ops.fill_pallas_banded import fill_scores_banded_batch as k1

    RB, C, U = geometry
    ps = _batch(RB + C + U)
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    want = np.asarray(
        k1(tops, sides, l1, l2, *mkd, interpret=True, band_rows=RB, chunk=C, unroll=U)
    )
    got = fill_banded.fill_scores_banded_batch(*_torch(tops, sides, l1, l2), *mkd)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 1, 1)])
def test_counts_vs_k2_interpret(mkd):
    from nw_tpu.ops.fill_pallas_banded import fill_scores_counts_banded_batch as k2

    ps = _batch(31 + sum(mkd))
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    want_sc, want_ct = k2(
        tops, sides, l1, l2, *mkd, interpret=True, band_rows=8, chunk=8, unroll=4
    )
    got_sc, got_ct = fill_banded.fill_scores_counts_banded_batch(
        *_torch(tops, sides, l1, l2), *mkd
    )
    np.testing.assert_array_equal(got_sc.numpy(), np.asarray(want_sc))
    np.testing.assert_array_equal(
        got_ct.numpy(), np.asarray(want_ct).astype(np.int64)
    )


def test_greedy_codes_vs_k2_interpret():
    """K2's pack_bits=2 band-major greedy words, decoded cell by cell."""
    from nw_tpu.ops.fill_pallas_banded import fill_arrows_banded_batch as k2

    RB = 8
    ps = _batch(41)
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    words, want_sc, want_ct = k2(
        tops, sides, l1, l2, 2, 1, 1, interpret=True, band_rows=RB, chunk=16,
        unroll=16, with_counts=True, pack_bits=2,
    )
    words = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    codes, scores, counts = fill_banded.fill_greedy_counts_banded_batch(
        *_torch(tops, sides, l1, l2), 2, 1, 1, with_counts=True
    )
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want_sc))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_ct).astype(np.int64))
    codes = codes.numpy()
    for b, (a, s) in enumerate(ps):
        got = _decode_codes(codes[b], len(a), len(s))
        jj, ii = np.mgrid[0 : len(s) + 1, 0 : len(a) + 1]
        t = ii + jj % RB
        want = (words[jj // RB, t >> 4, jj % RB, b] >> (2 * (t & 15))) & 3
        want[0, 0] = got[0, 0]  # the TPU kernel leaves cell (0,0) unspecified
        np.testing.assert_array_equal(got, want, err_msg=str(b))


def test_wrappers_validate_inputs():
    tops, sides, l1, l2 = _torch(*jenc.encode_batch([(b"ACGT", b"AC")], 4, 2))
    for fn in (
        fill_banded.fill_scores_banded_batch,
        fill_banded.fill_scores_counts_banded_batch,
        fill_banded.fill_greedy_counts_banded_batch,
    ):
        with pytest.raises(ValueError, match="bucket"):
            fn(tops, sides, l1 + 1, l2, 1, 1, 1)
        with pytest.raises(ValueError, match="bucket"):
            fn(tops, sides, l1, l2 - 3, 1, 1, 1)
        with pytest.raises(ValueError, match="int32"):
            fn(tops, sides, l1, l2, 2**31, 1, 1)
        with pytest.raises(ValueError, match="int32"):
            fn(tops.to(torch.int64), sides, l1, l2, 1, 1, 1)
