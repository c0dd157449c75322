"""CUDA kernels of nw_tpu_torch vs their plain PyTorch versions:
the Smith-Waterman, overlap and Gotoh fills and walks, and their
batch paths.

These need an NVIDIA card (sm_90a) and nvcc; without one they skip.  On
the card: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_variants.py``.
Every output is an integer: comparisons are exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.models import affine as af
from nw_tpu_torch.models import overlap as ov
from nw_tpu_torch.models import smith_waterman as sw
from nw_tpu_torch.ops import fill_banded, traceback, variants_banded

from torch_kernel_cases import (  # noqa: F401 (cuda is a fixture)
    SCORINGS, EDGE, cuda, _pairs, _pipe_batches,
)

pytestmark = pytest.mark.cuda


SW_SCORINGS = SCORINGS + [(1, 1, -1)]


def _sw_inputs(seed, device):
    # the multi-band, tie-dense and edge pairs of _inputs, plus equal
    # bests in two bands (the later one on the earlier diagonal)
    ps = _pairs(seed, 12, 0, 140) + _pairs(seed + 1, 6, 20, 70, "AC") + EDGE + [
        (b"A" * 40, b"A" * 70),
        (b"T" * 10 + b"C" * 30 + b"A" * 10 + b"C" * 10, b"A" * 10 + b"G" * 23 + b"T" * 10 + b"G" * 2),
    ]
    arrays = enc.encode_batch(ps, 160, 144)
    return enc.upload(arrays, "cpu"), enc.upload(arrays, device)


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_sw_scores_kernel_vs_plain(cuda, mkd):
    cpu, dev = _sw_inputs(sum(mkd) + 11, cuda)
    got = variants_banded.sw_scores_banded_batch(*dev, *mkd)
    want = variants_banded.sw_scores_banded_batch_plain(*cpu, *mkd)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_sw_codes_and_walk_kernels_vs_plain(cuda, mkd):
    cpu, dev = _sw_inputs(sum(mkd) + 12, cuda)
    got = variants_banded.sw_fill_codes_banded_batch(*dev, *mkd)
    want = variants_banded.sw_fill_codes_banded_batch_plain(*cpu, *mkd)
    for g, w in zip(got, want):  # codes, best, j*, i*
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    g_walk = traceback.walk_sw_codes_batch(got[0], got[2], got[3])
    w_walk = traceback.walk_sw_codes_batch_plain(want[0], want[2], want[3])
    for g, w in zip(g_walk, w_walk):  # ops, n, i_end, j_end
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_sw_batch_cuda_vs_cpu(cuda, mkd):
    ps = _pairs(sum(mkd) + 13, 30, 0, 300) + EDGE
    assert sw.sw_align_batch(ps, *mkd, device="cuda") == sw.sw_align_batch(ps, *mkd, device="cpu")
    np.testing.assert_array_equal(
        sw.sw_score_batch(ps, *mkd, device="cuda"), sw.sw_score_batch(ps, *mkd, device="cpu")
    )


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_overlap_scores_kernel_vs_plain(cuda, mkd):
    cpu, dev = _sw_inputs(sum(mkd) + 14, cuda)
    got = variants_banded.overlap_scores_banded_batch(*dev, *mkd)
    want = variants_banded.overlap_scores_banded_batch_plain(*cpu, *mkd)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# the best on the last column in band 0 and on the last row in band 2
OVERLAP_TWO_BANDS = (b"C" * 20 + b"G" * 40 + b"A" * 20, b"A" * 20 + b"T" * 30 + b"C" * 20)
# sw_scores / overlap_scores on the pipeline at forced warps a pair
FREE_WARPS = [1, 2, 3, 4, 8, 16, 32]
MOTIF = b"ACGTTGCAACGT"


def _placed_pairs():
    """Pairs whose best (SW and overlap) ends in band W, on warp 0 again
    after a round of W warps (W = 2, 3, 4, 8, 16, 32), or in band 1, on
    warp 1: the side's last 12 rows match the top's first 12 columns over
    G / C filler, so the best (24 at 2 1 1) lies on the last row; and
    equal bests in bands 0 and 1."""
    out = [(MOTIF + b"C" * 30, b"G" * (32 * W + 20 - len(MOTIF)) + MOTIF) for W in (1, 2, 3, 4, 8, 16, 32)]
    out.append((b"C" * 9 + MOTIF + b"C" * 20, b"G" * 8 + MOTIF + b"G" * 30 + MOTIF + b"G" * 9))
    return out + [OVERLAP_TWO_BANDS]


def _free_batches(seed, device):
    """_pipe_batches' two buckets (5 and 35 bands), the second with the
    placed pairs."""
    out = _pipe_batches(seed, device)
    cpu, _ = out[1]
    extra = enc.upload(enc.encode_batch(_placed_pairs(), 1100, 1100), "cpu")
    cpu = [torch.cat([x, y]) for x, y in zip(cpu, extra)]
    return [out[0], (cpu, [x.to(device) for x in cpu])]


@pytest.mark.parametrize("kind", ["sw", "overlap"])
@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_free_scores_at_forced_warps_vs_plain(cuda, mkd, kind):
    """sw_scores / overlap_scores on the pipeline at W = 1, 2, 3, 4, 8,
    16, 32 and at the rule's W, bit for bit against the plain version and
    equal to the codes kernel's best (one warp a pair)."""
    wrapper = getattr(variants_banded, f"{kind}_scores_banded_batch")
    plain = getattr(variants_banded, f"{kind}_scores_banded_batch_plain")
    codes = getattr(variants_banded, f"{kind}_fill_codes_banded_batch")
    for cpu, dev in _free_batches(sum(mkd) % 89 + 21, cuda):
        want = plain(*cpu, *mkd)
        torch.testing.assert_close(codes(*dev, *mkd)[1].cpu(), want, rtol=0, atol=0)
        torch.testing.assert_close(wrapper(*dev, *mkd).cpu(), want, rtol=0, atol=0)
        for warps in FREE_WARPS:
            got = fill_banded._fill_scores_kernel(wrapper, *dev, *mkd, warps=warps, entry=f"{kind}_scores")
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0, msg=f"W = {warps}")


@pytest.mark.parametrize("kind", ["sw", "overlap"])
def test_free_scores_with_the_top_in_device_memory(cuda, kind):
    """sw_scores / overlap_scores with a top past a block's shared memory
    (117 000 columns; ~115 000 fit), staged in device memory: W = 1, 3, 32
    and the rule's W against the codes kernel's best (one warp a pair,
    the top read from device memory), under 2 1 1 and a wrapping scoring.
    The first pair's side holds 200 columns of its top from column
    116 000 (the local best past the columns that fit), the second's ends
    with its top's last 300 (the overlap best on the last row)."""
    rng = np.random.default_rng(37)
    A, Bs = 117_000, 1_600  # 50 bands
    letters = np.frombuffer(b"ACGT", np.uint8)
    tops = [letters[rng.integers(0, 4, a)].tobytes() for a in (A, A - 7, A - 30_000)]
    sides = [letters[rng.integers(0, 4, s)].tobytes() for s in (Bs, Bs - 340, 33)]
    sides[0] = sides[0][:700] + tops[0][116_000:116_200] + sides[0][900:]
    sides[1] += tops[1][-300:]
    dev = enc.upload(enc.encode_batch(list(zip(tops, sides)), A, Bs), cuda)
    assert not fill_banded.top_in_smem(A, 4)
    wrapper = getattr(variants_banded, f"{kind}_scores_banded_batch")
    codes = getattr(variants_banded, f"{kind}_fill_codes_banded_batch")
    for mkd in [(2, 1, 1), (1, 1, 2**30)]:
        want = codes(*dev, *mkd)[1].cpu().tolist()
        if mkd == (2, 1, 1):  # the planted best
            assert want[0 if kind == "sw" else 1] >= 400
        assert wrapper(*dev, *mkd).cpu().tolist() == want, mkd
        for warps in (1, 3, 32):
            got = fill_banded._fill_scores_kernel(wrapper, *dev, *mkd, warps=warps, entry=f"{kind}_scores")
            assert got.cpu().tolist() == want, (mkd, warps)


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_overlap_codes_and_walk_kernels_vs_plain(cuda, mkd):
    cpu, dev = _sw_inputs(sum(mkd) + 15, cuda)
    extra = enc.upload(enc.encode_batch([OVERLAP_TWO_BANDS, (b"AAAA", b"TTTT")], 160, 144), "cpu")
    cpu = [torch.cat([x, y]) for x, y in zip(cpu, extra)]
    dev = [x.to(cuda) for x in cpu]
    got = variants_banded.overlap_fill_codes_banded_batch(*dev, *mkd)
    want = variants_banded.overlap_fill_codes_banded_batch_plain(*cpu, *mkd)
    for g, w in zip(got, want):  # codes, best, j*, i*
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    g_walk = traceback.walk_sw_codes_batch(got[0], got[2], got[3])
    w_walk = traceback.walk_sw_codes_batch_plain(want[0], want[2], want[3])
    for g, w in zip(g_walk, w_walk):  # ops, n, i_end, j_end
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


GOTOH_SCORINGS = [(2, 1, 3, 1), (1, 1, 1, 1), (0, 0, 0, 0), (3, -1, 2, 1), (2, 1, 1, 3),
                  (1, 1, -1, -1), (1, 1, 2**28, 2**28)]


@pytest.mark.parametrize("sc", GOTOH_SCORINGS)
def test_gotoh_scores_kernel_vs_plain(cuda, sc):
    cpu, dev = _sw_inputs(sum(sc) % 97 + 16, cuda)
    got = variants_banded.affine_scores_banded_batch(*dev, *sc)
    want = variants_banded.affine_scores_banded_batch_plain(*cpu, *sc)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# the alignments' seven scorings (tests/test_torch_affine.py), near the sentinel too
GOTOH_ALIGN_SCORINGS = GOTOH_SCORINGS + [(3, 1, 4, 0), (1, 1, 1, 2**29)]


@pytest.mark.parametrize("sc", GOTOH_ALIGN_SCORINGS)
def test_gotoh_codes_and_walk_kernels_vs_plain(cuda, sc):
    cpu, dev = _sw_inputs(sum(sc) % 89 + 18, cuda)
    got = variants_banded.affine_fill_codes_banded_batch(*dev, *sc)
    want = variants_banded.affine_fill_codes_banded_batch_plain(*cpu, *sc)
    for g, w in zip(got, want):  # codes, scores, states
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    torch.testing.assert_close(got[1], variants_banded.affine_scores_banded_batch(*dev, *sc), rtol=0, atol=0)
    S = 160 + 144
    g_ops, g_n = traceback.walk_gotoh_codes_batch(got[0], dev[2], dev[3], got[2], S)
    w_ops, w_n = traceback.walk_gotoh_codes_batch_plain(want[0], cpu[2], cpu[3], want[2], S)
    torch.testing.assert_close(g_ops.cpu(), w_ops, rtol=0, atol=0)
    torch.testing.assert_close(g_n.cpu(), w_n, rtol=0, atol=0)


def _gotoh_at(T, sc, warps, S):
    """gotoh_scores and gotoh_fill_codes on T at ``warps`` warps a pair
    (None: the rule's), and gotoh_walk on the codes: (scores, codes,
    scores of the codes fill, states, walk ops, walk lengths)."""
    scores = variants_banded.affine_scores_banded_batch(*T, *sc, warps=warps)
    codes, sc2, states = variants_banded.affine_fill_codes_banded_batch(*T, *sc, warps=warps)
    ops, n = traceback.walk_gotoh_codes_batch(codes, T[2], T[3], states, S)
    return scores, codes, sc2, states, ops, n


@pytest.mark.parametrize("sc", GOTOH_ALIGN_SCORINGS)
def test_gotoh_at_forced_warps_vs_plain(cuda, sc):
    """gotoh_scores and gotoh_fill_codes on the pipeline at W = 1, 2, 3,
    4, 8, 16, 32 and at the rule's W: scores, codes, corner states and
    gotoh_walk's walk on the codes, bit for bit against the plain
    versions, on _free_batches' two buckets (5 and 35 bands; corners on
    warp 1, in the last band and back on warp 0 after a round)."""
    for cpu, dev in _free_batches(sum(sc) % 79 + 23, cuda):
        S = cpu[0].shape[1] + cpu[1].shape[1]
        w_codes, w_scores, w_states = variants_banded.affine_fill_codes_banded_batch_plain(*cpu, *sc)
        w_ops, w_n = traceback.walk_gotoh_codes_batch_plain(w_codes, cpu[2], cpu[3], w_states, S)
        want = (w_scores, w_codes, w_scores, w_states, w_ops, w_n)
        for warps in (*FREE_WARPS, None):
            got = _gotoh_at(dev, sc, warps, S)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0, msg=f"W = {warps or 'rule'}")


def test_gotoh_with_the_top_in_device_memory(cuda):
    """A bucket of 117 000 columns stages its tops in device memory
    (~114 000 fit shared memory beside a Gotoh ring): the same pairs (tops
    up to 100 000 bp, sides up to 1 600) in a 100 032-column bucket,
    whose tops lie in shared memory, give the same scores, corner states
    and walks at W = 1 there as at W = 1, 3, 32 and the rule's here,
    under 2 1 3 1 and a scoring near the sentinel.  The first pair's
    side holds 200 columns of its top from column 99 000, the second
    ends with its top's last 300, so their walks pass the far columns."""
    rng = np.random.default_rng(41)
    letters = np.frombuffer(b"ACGT", np.uint8)
    tops = [letters[rng.integers(0, 4, a)].tobytes() for a in (100_000, 99_993, 70_000)]
    sides = [letters[rng.integers(0, 4, s)].tobytes() for s in (1_600, 1_260, 33)]
    sides[0] = sides[0][:700] + tops[0][99_000:99_200] + sides[0][900:]
    sides[1] += tops[1][-300:]
    ps = list(zip(tops, sides))
    big = enc.upload(enc.encode_batch(ps, 117_000, 1_600), cuda)
    small = enc.upload(enc.encode_batch(ps, 100_032, 1_600), cuda)
    for codes in (False, True):
        cell = variants_banded.GOTOH_CELL[codes]
        assert not fill_banded.top_in_smem(117_000, cell) and fill_banded.top_in_smem(100_032, cell)
    S = 117_000 + 1_600
    for sc in [(2, 1, 3, 1), (1, 1, 1, 2**29)]:
        want = _gotoh_at(small, sc, 1, S)
        for warps in (1, 3, 32, None):
            got = _gotoh_at(big, sc, warps, S)
            for i in (0, 2, 3, 4, 5):  # scores, states and walks (the codes' widths differ)
                assert torch.equal(got[i], want[i]), (sc, warps, i)


@pytest.mark.parametrize("sc", GOTOH_ALIGN_SCORINGS)
def test_affine_align_batch_cuda_vs_cpu(cuda, sc):
    ps = _pairs(sum(sc) % 83 + 19, 30, 0, 300) + EDGE
    assert af.affine_align_batch(ps, *sc, device="cuda") == af.affine_align_batch(ps, *sc, device="cpu")


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_overlap_and_affine_batch_cuda_vs_cpu(cuda, mkd):
    ps = _pairs(sum(mkd) + 17, 30, 0, 300) + EDGE + [OVERLAP_TWO_BANDS]
    assert ov.overlap_align_batch(ps, *mkd, device="cuda") == ov.overlap_align_batch(ps, *mkd, device="cpu")
    np.testing.assert_array_equal(
        ov.overlap_score_batch(ps, *mkd, device="cuda"), ov.overlap_score_batch(ps, *mkd, device="cpu")
    )
    sc = (*mkd, mkd[2] + 1)  # open > extend
    np.testing.assert_array_equal(
        af.affine_score_pairs(ps, *sc, device="cuda"), af.affine_score_pairs(ps, *sc, device="cpu")
    )
