"""The Smith-Waterman and overlap score fills on the W-warp pipeline
(``sw_scores``, ``overlap_scores``) on the CPU: the rule for W and the
shared memory at their shapes, the checks of a forced W, and the plain
path against nw_tpu's K18 / K19 and its scans where the pipeline cuts.

The pipeline runs only on the card (``tests/test_torch_kernels.py``,
``-m cuda``, holds both fills at every forced W against the plain
versions); on CPU tensors the wrappers run those plain versions.  So
here the plain path is held against K18 / K19 in interpret mode (small
``band_rows``, as tests/test_torch_overlap.py runs K19) and against
nw_tpu's scan on batches whose sides end one row short of, on and one
row past a multiple of 32 W rows, with band counts that are not a
multiple of W (``CUTS`` of tests/test_torch_fill_pipe.py).  Each batch
holds mixed lengths, an empty side, an empty top, and pairs whose best
lies in a band on warp 1, in the last band (back on warp 0 after a
round of W warps where the side passes 32 W rows), in two warps' bands
at once (equal scores), and on the end window's last column and last
row.  Every output is an integer: comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nw_tpu.models import overlap as ref_ov
from nw_tpu.models import smith_waterman as ref_sw
from nw_tpu.ops import encode as jenc
from nw_tpu.ops.variants_banded import overlap_scores_banded_batch as k19_scores
from nw_tpu.ops.variants_banded import sw_scores_banded_batch as k18_scores
from nw_tpu_torch.ops import fill_banded
from nw_tpu_torch.ops import variants_banded as vb
from nw_tpu_torch.ops.fill_banded import SMEM_LIMIT, fill_smem, fill_warps, top_cols

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

H100_SMS = 132
# small TPU geometries, so that interpret mode crosses bands and chunks
GEOMETRY = dict(band_rows=8, chunk=8, unroll=4)
# (W, Bs): one short of, on and one past 32 W rows, and a band count
# (3 or 4 bands) that is not a multiple of W
CUTS = [(2, 63), (2, 64), (2, 65), (2, 96), (3, 95), (3, 96), (3, 97), (3, 128)]
A_BUCKET = 80  # room for OVERLAP_TWO_BANDS' top
MOTIF = b"ACGTTGCAACGT"
# overlap's best 40 (2 1 1) on the last column in band 0, (j, i) = (20, 80),
# and on the last row in band 2, (70, 20)
OVERLAP_TWO_BANDS = (b"C" * 20 + b"G" * 40 + b"A" * 20, b"A" * 20 + b"T" * 30 + b"C" * 20)


def _placed(Bs):
    """Pairs of a Bs-row bucket whose best (24 at 2 1 1: the motif over
    G / C filler) lies in band 1 (rows 33-64, warp 1), on the last row
    (in the last band), in bands 0 and 1 at once, and on the last column;
    and OVERLAP_TWO_BANDS (its 70-row side, where the bucket holds it, or
    the empty pair)."""
    return [
        (b"C" * 9 + MOTIF + b"C" * 20, b"G" * 40 + MOTIF + b"G" * (Bs - 52)),
        (MOTIF + b"C" * 30, b"G" * (Bs - len(MOTIF)) + MOTIF),
        (b"C" * 9 + MOTIF + b"C" * 20, b"G" * 8 + MOTIF + b"G" * 30 + MOTIF + b"G" * (Bs - 62)),
        (b"C" * 20 + MOTIF, MOTIF + b"G" * (Bs - len(MOTIF))),
        OVERLAP_TWO_BANDS if Bs >= len(OVERLAP_TWO_BANDS[1]) else (b"", b""),
    ]


def _pairs(Bs, seed):
    """Random pairs at a bucket of Bs side rows (one of exactly Bs rows,
    mixed shorter ones, empty sides and tops, a one-row pair) and the
    placed ones."""
    rng = np.random.default_rng(seed)

    def s(n, alphabet="ACGT"):
        return "".join(rng.choice(list(alphabet), n)).encode()

    pairs = [(s(37), s(Bs)), (s(29, "AC"), s(Bs - 1, "AC")), (s(60), s(int(rng.integers(1, Bs + 1))))]
    pairs += [(s(int(rng.integers(0, A_BUCKET + 1))), s(int(rng.integers(0, Bs + 1)))) for _ in range(2)]
    pairs += [(s(23), b""), (b"", s(Bs // 2)), (b"A", b"A")]
    return pairs + _placed(Bs)


def _batch(pairs, Bs):
    return jenc.encode_batch(pairs, A_BUCKET, Bs)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _scan_padded(kind, tops, sides, l1, l2, mkd):
    """nw_tpu's scan over each padded pair: overlap masks the padding by
    its lengths; SW's padding never matches and k, d >= 0 here, so no
    padded cell beats the true rectangle's best."""
    if kind == "overlap":
        def one(t, s, a, b):
            return ref_ov.overlap_fill_diag(t, s, *mkd, a, b, with_arrows=False)["score"]
    else:
        assert min(mkd[1:]) >= 0

        def one(t, s, a, b):
            return ref_sw.sw_fill_diag(t, s, *mkd, with_arrows=False)["score"]
    return np.asarray(jax.vmap(one)(*(jnp.asarray(x) for x in (tops, sides, l1, l2))))


@pytest.mark.parametrize("B,L,want", [(128, 10_240, 32), (10_240, 150, 1), (4_096, 150, 1), (1_024, 3_072, 4)])
def test_rule_at_the_variant_shapes(B, L, want):
    """fill_warps' W for the score fills (no counts): 32 warps a pair at
    128 x 10 240 bp (bench.py:583), one at 10 240 x 150 bp (bench.py:517)."""
    assert fill_warps(B, L, L, 4, H100_SMS) == want


@pytest.mark.parametrize("W,A,want", [(32, 10_240, 37_248), (1, 150, 1_092)])
def test_shared_memory_is_nw_scores(W, A, want):
    """The bests go through done[] after the sweep: a block's shared
    memory is nw_scores' (done[W], W rings of 4 x 32 int32 cells, warp
    0's 32 staged cells, the int16 top)."""
    assert fill_smem(W, A, 4) == 4 * W + 4 * (W * 128 + 32) + 2 * top_cols(A) == want
    assert want <= SMEM_LIMIT


@pytest.mark.parametrize("kind", ["sw", "overlap"])
def test_forced_warps_are_checked(kind):
    """A forced W outside [1, 32], or one whose rings leave no room for a
    112 000-column top in shared memory, raises before any launch; the
    rule's W fits."""
    wrapper = getattr(vb, f"{kind}_scores_banded_batch")

    def launch(A, warps):
        T = _torch(np.zeros((1, A), np.int32), np.zeros((1, 40), np.int32),
                   np.array([A], np.int32), np.array([40], np.int32))
        return fill_banded._fill_scores_kernel(wrapper, *T, 2, 1, 1, warps=warps, entry=f"{kind}_scores")

    launches = wrapper.launches
    for bad in (0, 33):
        with pytest.raises(ValueError, match="warps"):
            launch(100, bad)
    with pytest.raises(ValueError, match="shared memory"):
        launch(112_000, 32)
    assert fill_banded.top_in_smem(112_000, 4)
    assert 1 < fill_warps(1, 112_000, 112_000, 4, H100_SMS) < 32
    assert wrapper.launches == launches


@pytest.mark.parametrize("W,Bs", CUTS)
def test_sw_cuts_vs_k18_and_scan(W, Bs):
    pairs = _pairs(Bs, 100 * W + Bs)
    tops, sides, l1, l2 = _batch(pairs, Bs)
    for mkd in [(2, 1, 1), (1, 1, 1)]:  # K18 follows the scan at k, d >= 0
        got = vb.sw_scores_banded_batch(*_torch(tops, sides, l1, l2), *mkd).numpy()
        np.testing.assert_array_equal(got, np.asarray(k18_scores(tops, sides, l1, l2, *mkd, interpret=True,
                                                                 **GEOMETRY)))
        np.testing.assert_array_equal(got, _scan_padded("sw", tops, sides, l1, l2, mkd))
        if mkd == (2, 1, 1):  # the placed bests
            assert got[-5:-1].tolist() == [24, 24, 24, 24], got[-5:]


@pytest.mark.parametrize("W,Bs", CUTS)
def test_overlap_cuts_vs_k19_and_scan(W, Bs):
    pairs = _pairs(Bs, 200 * W + Bs)
    tops, sides, l1, l2 = _batch(pairs, Bs)
    for mkd in [(2, 1, 1), (3, -1, 2)]:  # K19 follows the scan at every scoring
        got = vb.overlap_scores_banded_batch(*_torch(tops, sides, l1, l2), *mkd).numpy()
        np.testing.assert_array_equal(got, np.asarray(k19_scores(tops, sides, l1, l2, *mkd, interpret=True,
                                                                  **GEOMETRY)))
        np.testing.assert_array_equal(got, _scan_padded("overlap", tops, sides, l1, l2, mkd))
        if mkd == (2, 1, 1):  # the last row, the last column, OVERLAP_TWO_BANDS
            assert got[-4] == got[-2] == 24 and got[-1] == (40 if Bs >= 70 else 0), got[-5:]


@pytest.mark.parametrize("mkd", [(1, 1, -1), (3, -1, 2)])
@pytest.mark.parametrize("kind", ["sw", "overlap"])
def test_cut_vs_scan_at_negative_costs(kind, mkd):
    """A gap bonus (d < 0) or a mismatch bonus (k < 0): the plain path
    against the scan only (K18 leaves the scan there, as
    test_torch_sw.py's follows_scan tests pin), on the cut at 97 rows and
    W = 3; SW's scan on each unpadded pair, as padding can gain there."""
    pairs = _pairs(97, 300 + sum(mkd))
    tops, sides, l1, l2 = _batch(pairs, 97)
    got = getattr(vb, f"{kind}_scores_banded_batch")(*_torch(tops, sides, l1, l2), *mkd).numpy()
    if kind == "overlap":
        want = _scan_padded("overlap", tops, sides, l1, l2, mkd)
    else:
        want = [int(ref_sw.sw_fill_diag(jnp.asarray(jenc.encode(a)), jnp.asarray(jenc.encode(s)), *mkd,
                                        with_arrows=False)["score"]) for a, s in pairs]
    np.testing.assert_array_equal(got, want)
