"""nw_tpu_torch's Hirschberg aligner and K9 port (plain PyTorch) vs
nw_tpu on the CPU.

``hirschberg_align(device="cpu")`` must give ``nw_tpu``'s bytes exactly
(or raise as it does), on pairs on both sides of ``_HOST_CELLS``; the
port's ``last_row`` must be ``nw_tpu``'s ``fill_last_row`` at every
scoring, and K9 (``last_row_pallas`` in interpret mode) where K9
follows it.  Tolerance 0 everywhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nw_tpu.ops import hirschberg as jh
from nw_tpu.ops.encode import encode as jencode
from nw_tpu.ops.fill_pallas_single import last_row_pallas
from nw_tpu.ops.fill_scan import fill_last_row as j_fill_last_row
from nw_tpu_torch.ops import fill_single
from nw_tpu_torch.ops import hirschberg

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2), (1, 1, 2**30), (1, 2**30, 1),
            (2**31 - 1, -(2**31), 2**30)]


def _seq(rng, n, alphabet=b"ACGT"):
    return rng.choice(list(alphabet), n).astype(np.uint8).tobytes()


def _outcome(fn, *args, **kw):
    """The bytes returned, or the exception raised, as comparable values."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # nw_tpu's int32 host rows raise at large scorings
        return type(e), str(e)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_hirschberg_matches_nw_tpu(mkd):
    rng = np.random.default_rng(sum(mkd) % 1000)
    pairs = [
        (_seq(rng, 100), _seq(rng, 120)),  # 12 000 cells: a host leaf
        (_seq(rng, 200), _seq(rng, 90)),  # past _HOST_CELLS: split rows
        (_seq(rng, 300, b"AC"), _seq(rng, 280, b"AC")),  # tie-dense, several levels
        (_seq(rng, 9000), _seq(rng, 3)),  # b > 2: one split of a wide pair
        (b"", b"ACG"), (b"ACG", b""), (b"A", b"A"), (b"GCATGCU", b"GATTACA"),
    ]
    for s1, s2 in pairs:
        want = _outcome(jh.hirschberg_align, s1, s2, *mkd)
        assert _outcome(hirschberg.hirschberg_align, s1, s2, *mkd, device="cpu") == want, (len(s1), len(s2))


def test_hirschberg_2kb_matches_nw_tpu():
    rng = np.random.default_rng(2)
    s1, s2 = _seq(rng, 2000), _seq(rng, 2100)
    X, Y = hirschberg.hirschberg_align(s1, s2, 2, 1, 1, device="cpu")
    assert (X, Y) == jh.hirschberg_align(s1, s2, 2, 1, 1)
    assert X.replace(b"-", b"") == s1 and Y.replace(b"-", b"") == s2


def test_hirschberg_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hirschberg.hirschberg_align(b"GATTACA", b"GCAT")
    assert hirschberg.hirschberg_align(b"GATTACA", b"GCAT", device="cpu") == jh.hirschberg_align(
        b"GATTACA", b"GCAT"
    )


@pytest.mark.parametrize("mkd", SCORINGS)
def test_last_row_matches_fill_last_row_and_k9(mkd):
    """Bucket-padded inputs with true lengths, as nw_tpu's Hirschberg
    passes them; K9 only at the scorings where it follows fill_last_row
    (it rests on the NEG_INF decay)."""
    rng = np.random.default_rng(3)
    for A, B, Ab, Bb in [(20, 10, 32, 16), (150, 150, 150, 150), (37, 260, 64, 512), (5, 0, 16, 16), (0, 7, 16, 16)]:
        t = np.full((Ab,), -1, np.int32)
        t[:A] = rng.integers(65, 69, A)
        s = np.full((Bb,), -2, np.int32)
        s[:B] = rng.integers(65, 69, B)
        want = np.asarray(j_fill_last_row(jnp.asarray(t), jnp.asarray(s), *mkd, A, B))[: A + 1]
        got = fill_single.last_row(torch.from_numpy(t), torch.from_numpy(s), *mkd, len1=A, len2=B)
        assert got.dtype == torch.int32 and got.shape == (A + 1,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(fill_single.last_row_plain(torch.from_numpy(t), torch.from_numpy(s), *mkd, A, B).numpy(), want)
        if max(abs(mkd[1]), abs(mkd[2])) < 2**30:
            k9 = last_row_pallas(jnp.asarray(t), jnp.asarray(s), *mkd, len2=B, interpret=True)
            np.testing.assert_array_equal(np.asarray(k9)[: A + 1], want)


def test_last_row_follows_fill_last_row_at_large_scorings():
    """At |k| or |d| >= 2^30 K9's NEG_INF decay leaves fill_last_row
    (as K8 does); the port writes row 0 and column 0 and stays on it."""
    top, side = jencode(b"GATTACA"), jencode(b"GCAT")
    mkd = (1, 1, 2**30)
    want = [0, 1073741823, 2147483646, 1073741826, 2, 1073741823, 2147483646, 1073741822]
    assert np.asarray(j_fill_last_row(jnp.asarray(top), jnp.asarray(side), *mkd, 7, 4)).tolist() == want
    got = fill_single.last_row(torch.from_numpy(top), torch.from_numpy(side), *mkd)
    assert got.tolist() == want
    k9 = last_row_pallas(jnp.asarray(top), jnp.asarray(side), *mkd, interpret=True)
    assert np.asarray(k9).tolist() == [0, 1073741822, -2, -1073741821, 0, 0, 1073741823, 2147483644]
