"""The Gotoh fills on the W-warp pipeline (``gotoh_scores``,
``gotoh_fill_codes``) on the CPU: the rule for W and the shared memory
at their shapes, the checks of a forced W, and the plain path against
nw_tpu's K20 / K21 and its scan where the pipeline cuts.

The pipeline runs only on the card (``tests/test_torch_kernels_variants.py``,
``-m cuda``, holds both fills at every forced W against the plain
versions); on CPU tensors the wrappers run those plain versions.  So
here the plain path is held against K20 (``affine_scores_banded_batch``)
and K21 (``affine_traceback_banded_batch``, alignments) in interpret mode
at a small geometry, and against nw_tpu's scan (``affine_score``, and
``affine_fill_arrows``' state bits decoded from the 4-bit codes), on
batches whose sides end one row short of, on and one row past a multiple
of 32 W rows, with band counts that are not a multiple of W (``CUTS`` of
tests/test_torch_fill_pipe.py).  Each batch holds mixed lengths, an
empty side, an empty top, the empty pair, a one-cell mismatch, and
corners on warp 1 (row 40) and in the last band (the bucket's last
row).  At the scorings near the sentinel (``SENTINEL``) the port follows
the scan, and the tests say what K20 and K21 give there.  Every output
is an integer: comparisons are exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nw_tpu.models import affine as ref
from nw_tpu.ops import encode as jenc
from nw_tpu.ops.traceback import ops_to_strings as jax_ops_to_strings
from nw_tpu.ops.variants_banded import affine_scores_banded_batch as k20_scores
from nw_tpu.ops.variants_banded import affine_traceback_banded_batch as k21_align
from nw_tpu_torch.ops import fill_banded
from nw_tpu_torch.ops import traceback as tb
from nw_tpu_torch.ops import variants_banded as vb
from nw_tpu_torch.ops.fill_banded import SMEM_LIMIT, fill_smem, top_cols

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

H100_SMS = 132
# small TPU geometries, so that interpret mode crosses bands and chunks
K20_GEOMETRY = dict(band_rows=8, chunk=8, unroll=4)
K21_GEOMETRY = dict(K20_GEOMETRY, group_bands=2)
# (W, Bs): one short of, on and one past 32 W rows, and a band count
# (3 or 4 bands) that is not a multiple of W
CUTS = [(2, 63), (2, 64), (2, 65), (2, 96), (3, 95), (3, 96), (3, 97), (3, 128)]
A_BUCKET = 80
# (m, k, open, extend) where K20 and K21 follow the scan
SCORINGS = [(2, 1, 3, 1), (3, -1, 2, 1)]
# near the sentinel NEG_INF // 2 = -2^29: boundary gaps past it, a
# mismatch penalty of 2^30, an extend of 2^29
SENTINEL = [(1, 1, 2**28, 2**28), (1, 2**30, 3, 1), (1, 1, 1, 2**29)]
NEG = -(2**29)


def _pairs(Bs, seed):
    """Pairs at a bucket of Bs side rows: a side of exactly Bs rows (the
    corner in the last band), mixed shorter ones, a side of 40 rows (the
    corner in band 1, on warp 1), an empty side, an empty top, the empty
    pair, one-cell match and mismatch pairs, and a top of A_BUCKET
    columns over the whole bucket."""
    rng = np.random.default_rng(seed)

    def s(n, alphabet="ACGT"):
        return "".join(rng.choice(list(alphabet), n)).encode()

    shared = s(40)
    return [
        (s(37), s(Bs)), (s(29, "AC"), s(Bs - 1, "AC")), (s(60), s(int(rng.integers(1, Bs + 1)))),
        (s(int(rng.integers(0, A_BUCKET + 1))), s(int(rng.integers(0, Bs + 1)))),
        (shared + s(13), shared), (s(A_BUCKET), s(Bs)), (s(23), b""), (b"", s(Bs // 2)), (b"", b""),
        (b"A", b"A"), (b"A", b"T"),
    ]


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@functools.lru_cache(maxsize=None)
def _scan_arrows(a, s, sc):
    """nw_tpu's affine_fill_arrows of one pair: (rect[j, i] of its state
    bits, score, corner state)."""
    out = ref.affine_fill_arrows(jnp.asarray(jenc.encode(a)), jnp.asarray(jenc.encode(s)), *sc)
    arrows = np.asarray(out["arrows"])
    rect = np.zeros((len(s) + 1, len(a) + 1), np.uint8)
    if arrows.size:
        j, i = np.mgrid[: len(s) + 1, : len(a) + 1]
        rect = arrows[i + j, j]
    return rect, int(out["score"]), int(out["state"])


def _code_rect(codes, A, Bs):
    """4-bit band-major words int32[B, nbands, TW, 32] -> uint8[B, Bs+1,
    A+1], cell (j, i) at [b, j, i] (row 0: 0)."""
    w = codes.numpy().view(np.uint32)
    j, i = np.mgrid[1 : Bs + 1, : A + 1]
    r = j - 1
    t = i + (r & 31)
    rect = (w[:, r >> 5, t >> 3, r & 31] >> (4 * (t & 7))) & 15
    return np.concatenate([np.zeros((w.shape[0], 1, A + 1), np.uint32), rect], 1).astype(np.uint8)


def _plain_vs_scan(pairs, Bs, sc):
    """The plain path's scores, codes and corner states on the batch,
    each held against the scan; returns the batch and the scores."""
    tops, sides, l1, l2 = jenc.encode_batch(pairs, A_BUCKET, Bs)
    T = _torch(tops, sides, l1, l2)
    scores = vb.affine_scores_banded_batch(*T, *sc).numpy()
    codes, scores2, states = vb.affine_fill_codes_banded_batch(*T, *sc)
    rect = _code_rect(codes, A_BUCKET, Bs)
    for b, (a, s) in enumerate(pairs):
        want, score, state = _scan_arrows(a, s, sc)
        np.testing.assert_array_equal(rect[b, 1 : len(s) + 1, 1 : len(a) + 1], want[1:, 1:], err_msg=str((a, s)))
        assert (int(scores[b]), int(scores2[b]), int(states[b])) == (score, score, state), (a, s, sc)
    assert not rect[:, :, 0].any() and not rect[:, :, A_BUCKET + 1 :].any()  # column 0 and padding
    return (tops, sides, l1, l2), T, scores, (codes, states)


def _plain_alignments(T, pairs, codes, states):
    """The plain walk over the plain codes, as (score-less) strings."""
    ops, n = tb.walk_gotoh_codes_batch(codes, T[2], T[3], states, T[0].shape[1] + T[1].shape[1])
    return tb.ops_to_strings_batch(ops.numpy(), n.numpy(), pairs)


@pytest.mark.parametrize("B,L,codes,want", [(128, 10_240, False, 32), (10_240, 150, False, 1),
                                             (128, 3_072, True, 32), (4_096, 150, True, 1)])
def test_rule_at_the_gotoh_shapes(B, L, codes, want):
    """gotoh_warps' W: 32 warps a pair at 128 x 10 240 bp scores
    (bench.py:583) and 128 x 3 072 bp codes (bench.py:414), one at
    10 240 x 150 bp scores (bench.py:517) and 4 096 x 150 bp codes
    (bench.py:291)."""
    assert vb.gotoh_warps(B, L, L, codes, H100_SMS) == want


@pytest.mark.parametrize("W,A,codes,want", [(32, 10_240, False, 53_760), (1, 150, False, 1_732),
                                             (32, 3_072, True, 72_448), (1, 150, True, 3_012)])
def test_shared_memory_of_a_gotoh_block(W, A, codes, want):
    """A Gotoh block's shared memory: done[W], W rings of 4 x 32 cells
    and warp 0's 32 staged cells (8 bytes a cell for the scores: h and IY
    of the row below; 16 with codes: also the state bits, and a word
    unused), the int16 top."""
    cell = vb.GOTOH_CELL[codes]
    assert cell == (16 if codes else 8)
    assert fill_smem(W, A, cell) == 4 * W + cell * (W * 128 + 32) + 2 * top_cols(A) == want
    assert want <= SMEM_LIMIT


@pytest.mark.parametrize("codes", [False, True])
def test_forced_warps_are_checked(codes):
    """A forced W outside [1, 32], or one whose rings leave no room for a
    112 000-column top in shared memory, raises before any launch; the
    rule's W fits.  A 117 000-column top goes to device memory."""
    wrapper = vb.affine_fill_codes_banded_batch if codes else vb.affine_scores_banded_batch
    cell = vb.GOTOH_CELL[codes]

    def launch(A, warps):
        T = _torch(np.zeros((1, A), np.int32), np.zeros((1, 40), np.int32),
                   np.array([A], np.int32), np.array([40], np.int32))
        return vb._gotoh_kernel(wrapper, *T, (2, 1, 3, 1), codes, warps)

    launches = wrapper.launches
    for bad in (0, 33):
        with pytest.raises(ValueError, match="warps"):
            launch(100, bad)
    with pytest.raises(ValueError, match="shared memory"):
        launch(112_000, 32)
    assert fill_banded.top_in_smem(112_000, cell)
    assert 1 < vb.gotoh_warps(1, 112_000, 112_000, codes, H100_SMS) < 32
    assert wrapper.launches == launches
    assert not fill_banded.top_in_smem(117_000, cell)
    assert fill_banded._top_scratch(2, 117_000, cell, "cpu").shape == (2, top_cols(117_000))
    assert fill_banded._top_scratch(2, 112_000, cell, "cpu") is None


@pytest.mark.parametrize("W,Bs", CUTS)
def test_cuts_vs_k20_k21_and_scan(W, Bs):
    """Scores, codes and corner states against the scan, scores against
    K20 and the plain walk's alignments against K21's, at each cut."""
    pairs = _pairs(Bs, 100 * W + Bs)
    for sc in SCORINGS:
        (tops, sides, l1, l2), T, scores, (codes, states) = _plain_vs_scan(pairs, Bs, sc)
        np.testing.assert_array_equal(scores, np.asarray(k20_scores(tops, sides, l1, l2, *sc, interpret=True,
                                                                    **K20_GEOMETRY)))
        k21, ops, n = k21_align(tops, sides, l1, l2, *sc, interpret=True, **K21_GEOMETRY)
        np.testing.assert_array_equal(scores, np.asarray(k21))
        want = [jax_ops_to_strings(ops[b], int(n[b]), a, s) for b, (a, s) in enumerate(pairs)]
        assert _plain_alignments(T, pairs, codes, states) == want, sc


@pytest.mark.parametrize("sc", SENTINEL)
def test_cut_at_the_sentinel(sc):
    """Near the sentinel the plain path follows the scan (scores, codes,
    states) on the cut at 97 rows and W = 3.  K20 and K21 give one score
    between them, and leave the scan on the pairs whose alignments need a
    gap (here: those whose sides differ in length): with boundary gaps
    past the sentinel (2^28) they give -2^29 on each of those, with an
    extend of 2^29 another score on each; with a mismatch of 2^30 they
    give -2^29 on the one-cell mismatch only (its scan score is
    -2^29 - 1: a gap each way)."""
    pairs = _pairs(97, 300 + sc[1] % 97)
    (tops, sides, l1, l2), _, scores, _ = _plain_vs_scan(pairs, 97, sc)
    k20 = np.asarray(k20_scores(tops, sides, l1, l2, *sc, interpret=True, **K20_GEOMETRY))
    k21 = np.asarray(k21_align(tops, sides, l1, l2, *sc, interpret=True, **K21_GEOMETRY)[0])
    np.testing.assert_array_equal(k20, k21)
    one_mismatch = len(pairs) - 1
    same_len = np.asarray(l1) == np.asarray(l2)  # the empty pair, the one-cell pairs
    if sc[2] == 2**28:
        np.testing.assert_array_equal(k20, np.where(same_len, scores, NEG))
    elif sc[3] == 2**29:
        np.testing.assert_array_equal(k20 == scores, same_len)
    else:
        assert scores[one_mismatch] == NEG - 1 and k20[one_mismatch] == NEG
        np.testing.assert_array_equal(np.delete(k20, one_mismatch), np.delete(scores, one_mismatch))
