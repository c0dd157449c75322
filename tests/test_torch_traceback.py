"""nw_tpu_torch greedy walks (plain PyTorch) vs nw_tpu on the CPU.

The port's banded traceback (code fill + walk) against nw_tpu's banded
traceback run in interpret mode at tiny geometry, and the port's walkers
against nw_tpu's greedy walk over the scan oracle's tie masks.  All
comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nw_tpu.ops import encode as jenc
from nw_tpu.ops import traceback as jtb
from nw_tpu.ops.fill_scan import fill_diag_batch as j_fill_diag_batch
from nw_tpu_torch.ops import traceback as ttb
from nw_tpu_torch.ops.banded_traceback import traceback_banded_batch
from nw_tpu_torch.ops.fill_banded import fill_greedy_counts_banded_batch
from nw_tpu_torch.ops.fill_scan import fill_diag_batch

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"GCATGCU", b"GATTACA")]


def _pairs(seed, n, lo, hi, alphabet="ACGTN"):
    rng = np.random.default_rng(seed)
    return [
        (
            "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode(),
            "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode(),
        )
        for _ in range(n)
    ]


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (3, -1, 2)])
def test_banded_traceback_vs_nw_tpu_interpret(with_counts, mkd):
    from nw_tpu.ops.banded_traceback import traceback_banded_batch as j_tb

    ps = _pairs(5 + with_counts, 6, 1, 50) + _pairs(9, 3, 10, 30, "AC") + EDGE
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    want = j_tb(
        tops, sides, l1, l2, *mkd, interpret=True, band_rows=8, chunk=8,
        unroll=4, group_bands=2, with_counts=with_counts,
    )
    got = traceback_banded_batch(
        *_torch(tops, sides, l1, l2), *mkd, with_counts=with_counts
    )
    assert len(got) == len(want)
    if with_counts:
        assert got[1].dtype == np.uint32
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    w_sc, w_ops, w_n = np.asarray(want[0]), np.asarray(want[-2]), np.asarray(want[-1])
    g_sc, g_ops, g_n = got[0], got[-2], got[-1]
    np.testing.assert_array_equal(g_sc, w_sc)
    np.testing.assert_array_equal(g_n, w_n)
    assert g_ops.shape == w_ops.shape == (len(ps), tops.shape[1] + sides.shape[1])
    np.testing.assert_array_equal(g_ops, w_ops)


@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)])
def test_walkers_vs_nw_tpu_greedy(mkd):
    ps = _pairs(sum(mkd), 6, 1, 40) + _pairs(3, 3, 10, 25, "AC") + EDGE
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    S = tops.shape[1] + sides.shape[1]
    ref = j_fill_diag_batch(tops, sides, *mkd, jnp.asarray(l1), jnp.asarray(l2))
    want_ops, want_n = jtb.traceback_greedy_batch(
        ref["arrows"], jnp.asarray(l1), jnp.asarray(l2), max_steps=S
    )
    want_ops, want_n = np.asarray(want_ops), np.asarray(want_n)

    tt, ts, tl1, tl2 = _torch(tops, sides, l1, l2)
    arrows = fill_diag_batch(tt, ts, tl1, tl2, *mkd)["arrows"]
    ops, n = ttb.traceback_greedy_batch(arrows, tl1, tl2, S)
    np.testing.assert_array_equal(ops.numpy(), want_ops)
    np.testing.assert_array_equal(n.numpy(), want_n)

    codes, _, _ = fill_greedy_counts_banded_batch(tt, ts, tl1, tl2, *mkd)
    ops2, n2 = ttb.walk_codes_batch(codes, tl1, tl2, S)
    np.testing.assert_array_equal(ops2.numpy(), want_ops)
    np.testing.assert_array_equal(n2.numpy(), want_n)


def test_walk_rejects_bad_inputs():
    codes = torch.zeros((2, 1, 4, 32), dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        ttb.walk_codes_batch(codes.to(torch.int64), lens, lens, 4)
    with pytest.raises(ValueError):
        ttb.walk_codes_batch(codes[..., :16], lens, lens, 4)
    with pytest.raises(ValueError):
        ttb.walk_codes_batch(codes, lens[:1], lens, 4)
    # one band (32 rows) by 64 band steps: len1 <= 32, len2 <= 32
    ttb.walk_codes_batch(codes, lens + 32, lens + 32, 64)
    with pytest.raises(ValueError, match="code table"):
        ttb.walk_codes_batch(codes, lens + 33, lens, 64)
    with pytest.raises(ValueError, match="code table"):
        ttb.walk_codes_batch(codes, lens, lens + 33, 64)


def test_ops_to_strings_batch_vs_nw_tpu():
    ps = _pairs(12, 8, 0, 30) + EDGE
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    S = tops.shape[1] + sides.shape[1]
    ref = j_fill_diag_batch(tops, sides, 1, 1, 1, jnp.asarray(l1), jnp.asarray(l2))
    ops, n = jtb.traceback_greedy_batch(
        ref["arrows"], jnp.asarray(l1), jnp.asarray(l2), max_steps=S
    )
    ops, n = np.asarray(ops), np.asarray(n)
    want = [jtb.ops_to_strings(ops[b], n[b], a, s) for b, (a, s) in enumerate(ps)]
    assert ttb.ops_to_strings_batch(ops, n, ps) == want
    assert ttb.ops_to_strings_batch(ops[:0], n[:0], []) == []
