"""CUDA kernels of nw_tpu_torch vs their plain PyTorch versions:
the Smith-Waterman, overlap and Gotoh fills and walks (the walks also at
the shapes their shared-memory staging must get right), their batch
paths, and the variant tracebacks' two-pass route (the span fills, the
group walks, the three tracebacks on both routes).

These need an NVIDIA card (sm_90a) and nvcc; without one they skip.  On
the card: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_variants.py``.
Every output is an integer: comparisons are exact (tolerance 0).
"""

import functools

import numpy as np
import pytest
import torch

from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.models import affine as af
from nw_tpu_torch.models import overlap as ov
from nw_tpu_torch.models import smith_waterman as sw
from nw_tpu_torch.ops import fill_banded, traceback, variants_banded

from torch_kernel_cases import (  # noqa: F401 (cuda is a fixture)
    SCORINGS, EDGE, GROUP_SIZES, VARIANT_KINDS, VARIANT_SPAN_WARPS, VARIANT_WALK_EDGE_SHAPES, cuda, _pairs,
    _pipe_batches, random_code_words, starts_batch, variant_cursor, variant_edge_pairs, variant_groups_walk,
    variant_span_chain,
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
# the free fills on the pipeline at forced warps a pair
FREE_WARPS = [1, 2, 3, 4, 8, 16, 32]
MOTIF = b"ACGTTGCAACGT"
MOTIF2 = b"TTAGCCATGGAC"  # far from MOTIF: their cross alignments score well below 24


def _placed_pairs():
    """Pairs whose best (SW and overlap) ends in band W, on warp 0 again
    after a round of W warps (W = 2, 3, 4, 8, 16, 32), or in band 1, on
    warp 1: the side's last 12 rows match the top's first 12 columns over
    G / C filler, so the best (24 at 2 1 1) lies on the last row; equal
    bests in bands 0 and 1; and for each W equal bests in bands 0 and W
    on one lane of warp 0 (MOTIF2 at the top's end on row 20, diagonal
    100, and MOTIF at its start on row 20 + 32 W, diagonal 32 + 32 W)."""
    out = [(MOTIF + b"C" * 30, b"G" * (32 * W + 20 - len(MOTIF)) + MOTIF) for W in (1, 2, 3, 4, 8, 16, 32)]
    out.append((b"C" * 9 + MOTIF + b"C" * 20, b"G" * 8 + MOTIF + b"G" * 30 + MOTIF + b"G" * 9))
    out += [(MOTIF + b"C" * 56 + MOTIF2, b"G" * 8 + MOTIF2 + b"G" * (32 * W - len(MOTIF)) + MOTIF)
            for W in FREE_WARPS]
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
    16, 32 and at the rule's W, bit for bit against the plain version
    (the code fills, on the same pipeline, are held apart below)."""
    wrapper = getattr(variants_banded, f"{kind}_scores_banded_batch")
    plain = getattr(variants_banded, f"{kind}_scores_banded_batch_plain")
    for cpu, dev in _free_batches(sum(mkd) % 89 + 21, cuda):
        want = plain(*cpu, *mkd)
        torch.testing.assert_close(wrapper(*dev, *mkd).cpu(), want, rtol=0, atol=0)
        for warps in FREE_WARPS:
            got = fill_banded._fill_scores_kernel(wrapper, *dev, *mkd, warps=warps, entry=f"{kind}_scores")
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0, msg=f"W = {warps}")


@pytest.mark.parametrize("kind", ["sw", "overlap"])
@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_free_codes_at_forced_warps_vs_plain(cuda, mkd, kind):
    """sw_fill_codes / overlap_fill_codes on the pipeline at W = 1, 2, 3,
    4, 8, 16, 32 and at the rule's W: codes, best, j*, i* and sw_walk's
    walk on the codes bit for bit against the plain versions, on
    _free_batches' two buckets (5 and 35 bands; bests on warp 1, in the
    last band, back on warp 0 after a round, and equal in bands 0 and W
    on one lane)."""
    wrapper = getattr(variants_banded, f"{kind}_fill_codes_banded_batch")
    plain = getattr(variants_banded, f"{kind}_fill_codes_banded_batch_plain")
    for cpu, dev in _free_batches(sum(mkd) % 83 + 25, cuda):
        want = plain(*cpu, *mkd)
        w_walk = traceback.walk_sw_codes_batch_plain(want[0], want[2], want[3])
        for warps in (*FREE_WARPS, None):
            got = wrapper(*dev, *mkd, warps=warps)
            g_walk = traceback.walk_sw_codes_batch(got[0], got[2], got[3])
            names = ("codes", "best", "j*", "i*", "ops", "n", "i_end", "j_end")
            for name, g, w in zip(names, (*got, *g_walk), (*want, *w_walk)):
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0,
                                           msg=lambda m: f"{name} at W = {warps or 'rule'}: {m}")


def _far_pairs():
    """Three pairs in a bucket of 117 000 columns, past a block's shared
    memory (~115 000 fit), 50 bands: the first pair's side holds 200
    columns of its top from column 116 000 (the local best past the
    columns that fit), the second's ends with its top's last 300 (the
    overlap best on the last row)."""
    rng = np.random.default_rng(37)
    A, Bs = 117_000, 1_600
    letters = np.frombuffer(b"ACGT", np.uint8)
    tops = [letters[rng.integers(0, 4, a)].tobytes() for a in (A, A - 7, A - 30_000)]
    sides = [letters[rng.integers(0, 4, s)].tobytes() for s in (Bs, Bs - 340, 33)]
    sides[0] = sides[0][:700] + tops[0][116_000:116_200] + sides[0][900:]
    sides[1] += tops[1][-300:]
    assert not fill_banded.top_in_smem(A, 4)
    return list(zip(tops, sides)), A, Bs


def _best_cell_host(kind, top, side, m, k, d):
    """(best, j*, i*) of one pair by a row sweep on the host, a reference
    apart from the pipeline: int64 rows (the scorings here do not wrap
    int32), row 0 and column 0 at 0, the left chain of a row as a running
    max, LOCAL clamped at 0; the best cell over the window (LOCAL: the
    rectangle; OVERLAP: row len2 and column len1) by the scan's tie rule
    (higher score, then the smaller i + j, then the smaller j), from a
    best of 0 (else (0, 0), or the zero-cost corner for overlap)."""
    t = np.frombuffer(top, np.uint8)
    l1, l2 = len(top), len(side)
    cols = np.arange(l1 + 1, dtype=np.int64)
    h = np.zeros(l1 + 1, np.int64)
    best = (0, 0, 0)  # score, i + j, j
    for j in range(1, l2 + 1):
        e = np.zeros(l1 + 1, np.int64)
        e[1:] = np.maximum(h[:-1] + np.where(t == side[j - 1], m, -k), h[1:] - d)
        if kind == "sw":
            e = np.maximum(e, 0)
        h = np.maximum.accumulate(e + cols * d) - cols * d
        if kind == "sw" or j == l2:
            i = int(np.argmax(h[1:])) + 1 if l1 else 0
        else:
            i = l1
        if i and (h[i] > best[0] or (h[i] == best[0] and i + j < best[1])):
            best = (int(h[i]), i + j, j)
    if best[0] > 0:
        return best[0], best[2], best[1] - best[2]
    return (0, 0, 0) if kind == "sw" else (0, l2 if l1 == 0 else 0, l1)


@functools.lru_cache(maxsize=None)
def _far_want(kind, mkd):
    """_best_cell_host of each of _far_pairs under mkd."""
    return [_best_cell_host(kind, a, s, *mkd) for a, s in _far_pairs()[0]]


def _rescore(aligned, m, k, d):
    """The score of each aligned (X, Y) pair of byte strings."""
    out = []
    for X, Y in aligned:
        x, y = np.frombuffer(X, np.uint8), np.frombuffer(Y, np.uint8)
        gap = (x == ord("-")) | (y == ord("-"))
        out.append(int(np.where(gap, -d, np.where(x == y, m, -k)).sum()))
    return out


@pytest.mark.parametrize("kind", ["sw", "overlap"])
def test_free_scores_with_the_top_in_device_memory(cuda, kind):
    """sw_scores / overlap_scores with a top past a block's shared memory
    (_far_pairs), staged in device memory: W = 1, 3, 32 and the rule's W
    against the host's row sweep (_best_cell_host), under 2 1 1 and a
    wrapping scoring."""
    pairs, A, Bs = _far_pairs()
    dev = enc.upload(enc.encode_batch(pairs, A, Bs), cuda)
    wrapper = getattr(variants_banded, f"{kind}_scores_banded_batch")
    for mkd in [(2, 1, 1), (1, 1, 2**30)]:
        want = [w[0] for w in _far_want(kind, mkd)]
        if mkd == (2, 1, 1):  # the planted best
            assert want[0 if kind == "sw" else 1] >= 400
        assert wrapper(*dev, *mkd).cpu().tolist() == want, mkd
        for warps in (1, 3, 32):
            got = fill_banded._fill_scores_kernel(wrapper, *dev, *mkd, warps=warps, entry=f"{kind}_scores")
            assert got.cpu().tolist() == want, (mkd, warps)


@pytest.mark.parametrize("kind", ["sw", "overlap"])
def test_free_codes_with_the_top_in_device_memory(cuda, kind):
    """sw_fill_codes / overlap_fill_codes with the top in device memory
    (_far_pairs) at W = 1, 3, 32 and the rule's W, under 2 1 1 and a
    wrapping scoring: the best and its cell equal the host's row sweep,
    the codes are the same at every W, and sw_walk's alignment on them
    spells the pair's substrings and re-scores to the best."""
    pairs, A, Bs = _far_pairs()
    dev = enc.upload(enc.encode_batch(pairs, A, Bs), cuda)
    wrapper = getattr(variants_banded, f"{kind}_fill_codes_banded_batch")
    for mkd in [(2, 1, 1), (1, 1, 2**30)]:
        want = _far_want(kind, mkd)
        first = None
        for warps in (1, 3, 32, None):
            codes, best, js, is_ = wrapper(*dev, *mkd, warps=warps)
            got = list(zip(best.tolist(), js.tolist(), is_.tolist()))
            assert got == want, (mkd, warps)
            if first is None:
                first = codes
                ops, n, i_end, j_end = (t.cpu().numpy() for t in traceback.walk_sw_codes_batch(codes, js, is_))
                trunc = [(a[:i], s[:j]) for (a, s), (_, j, i) in zip(pairs, want)]
                aligned = traceback.ops_to_strings_batch(ops, n, trunc)
                for (a, s), (X, Y), ie, je, (_, j, i) in zip(pairs, aligned, i_end, j_end, want):
                    assert X.replace(b"-", b"") == a[ie:i] and Y.replace(b"-", b"") == s[je:j]
                assert _rescore(aligned, *mkd) == [w[0] for w in want], mkd
            else:
                assert torch.equal(codes, first), (mkd, warps)


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


def _variant_batch(ps, device):
    L1, L2 = max(len(a) for a, _ in ps), max(len(b) for _, b in ps)
    return enc.upload(enc.encode_batch(ps, max(L1, 1), max(L2, 1)), device)


def _same(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _sw_walks_equal(codes, js, is_):
    _same(traceback.walk_sw_codes_batch(codes, js, is_), traceback.walk_sw_codes_batch_plain(codes, js, is_))


def _gotoh_walks_equal(codes, l1, l2, states, S):
    _same(traceback.walk_gotoh_codes_batch(codes, l1, l2, states, S),
          traceback.walk_gotoh_codes_batch_plain(codes, l1, l2, states, S))


@pytest.mark.parametrize("shape", VARIANT_WALK_EDGE_SHAPES)
@pytest.mark.parametrize("kind", ["sw", "overlap"])
@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_sw_walk_kernel_vs_plain_at_edge_shapes(cuda, mkd, kind, shape):
    """sw_walk on the SW and overlap codes of the variant walk edge shapes
    against its plain version, from each fill's best, for the first pair
    alone and from every edge start of each pair's table (rows 0, 1, band
    and word-column edges, column 0): tolerance 0 on ops, n and the stop
    cell."""
    T = _variant_batch(variant_edge_pairs(shape), cuda)
    codes, _, js, is_ = getattr(variants_banded, f"{kind}_fill_codes_banded_batch")(*T, *mkd)
    _sw_walks_equal(codes, js, is_)
    _sw_walks_equal(codes[:1], js[:1], is_[:1])
    _sw_walks_equal(*starts_batch(codes, T[2], T[3], 16))


@pytest.mark.parametrize("kind", ["sw", "overlap"])
def test_sw_walk_kernel_odd_batch_and_many_short_pairs(cuda, kind):
    """An odd B and 5 000 short pairs (more walks than 132 SMs hold at
    once)."""
    fill = getattr(variants_banded, f"{kind}_fill_codes_banded_batch")
    for ps in (variant_edge_pairs()[:7], _pairs(5000, 5000, 0, 60)):
        T = _variant_batch(ps, cuda)
        for mkd in SW_SCORINGS:
            codes, _, js, is_ = fill(*T, *mkd)
            _sw_walks_equal(codes, js, is_)


@pytest.mark.parametrize("seed", range(3))
def test_sw_walk_kernel_over_random_code_words(cuda, seed):
    """Tables of random words (every 2-bit code, STOP included, and any
    code on column 0) from random starts and every edge start: the walk
    depends on nothing a fill writes."""
    rng = np.random.default_rng(210 + seed)
    for nbands, TW in ((1, 4), (3, 21), (6, 50)):
        codes = random_code_words(rng, 9, nbands, TW).to(cuda)
        js = torch.tensor(rng.integers(0, 32 * nbands + 1, 9), dtype=torch.int32, device=cuda)
        is_ = torch.tensor(rng.integers(0, 16 * TW - 31, 9), dtype=torch.int32, device=cuda)
        _sw_walks_equal(codes, js, is_)
        full = (torch.full((9,), 16 * TW - 32, dtype=torch.int32), torch.full((9,), 32 * nbands, dtype=torch.int32))
        _sw_walks_equal(*starts_batch(codes, *full, 16))


@pytest.mark.parametrize("shape", VARIANT_WALK_EDGE_SHAPES)
@pytest.mark.parametrize("sc", GOTOH_ALIGN_SCORINGS)
def test_gotoh_walk_kernel_vs_plain_at_edge_shapes(cuda, sc, shape):
    """gotoh_walk on the Gotoh codes of the variant walk edge shapes
    against its plain version, from each corner in its state, for the
    first pair alone, cut after 1 and 77 ops, and from every edge start of
    each pair's table (8-cell word columns) in each state (row 0 in IX,
    column 0 in IY, as a walk reaches them): tolerance 0 on ops and n."""
    T = _variant_batch(variant_edge_pairs(shape), cuda)
    S = T[0].shape[1] + T[1].shape[1]
    codes, _, states = variants_banded.affine_fill_codes_banded_batch(*T, *sc)
    for cut in (S, 1, 77):
        _gotoh_walks_equal(codes, T[2], T[3], states, cut)
    _gotoh_walks_equal(codes[:1], T[2][:1], T[3][:1], states[:1], S)
    sub, js, is_ = starts_batch(codes, T[2], T[3], 8)
    for st in range(3):
        _gotoh_walks_equal(sub, is_, js, torch.where(js == 0, 1, torch.where(is_ == 0, 2, st)).int(), S)


def test_gotoh_walk_kernel_odd_batch_and_many_short_pairs(cuda):
    """An odd B and 5 000 short pairs."""
    for ps in (variant_edge_pairs()[:7], _pairs(5001, 5000, 0, 60)):
        T = _variant_batch(ps, cuda)
        S = T[0].shape[1] + T[1].shape[1]
        for sc in GOTOH_ALIGN_SCORINGS:
            codes, _, states = variants_banded.affine_fill_codes_banded_batch(*T, *sc)
            _gotoh_walks_equal(codes, T[2], T[3], states, S)


@pytest.mark.parametrize("seed", range(3))
def test_gotoh_walk_kernel_over_random_code_words(cuda, seed):
    """Tables of random words (every 4-bit state pattern, any code on row 0
    and column 0) from random corners in every state, and cut short."""
    rng = np.random.default_rng(220 + seed)
    for nbands, TW in ((1, 8), (3, 41), (6, 100)):
        codes = random_code_words(rng, 9, nbands, TW).to(cuda)
        l1 = torch.tensor(rng.integers(0, 8 * TW - 31, 9), dtype=torch.int32, device=cuda)
        l2 = torch.tensor(rng.integers(0, 32 * nbands + 1, 9), dtype=torch.int32, device=cuda)
        for st in range(4):
            states = torch.full((9,), st, dtype=torch.int32, device=cuda)
            for S in (8 * TW + 32 * nbands, 50):
                _gotoh_walks_equal(codes, l1, l2, states, S)


def test_variant_walk_kernels_refuse_misaligned_codes(cuda):
    """The bulk copies need 16-byte aligned codes: a table starting 4 bytes
    in is refused, not read."""
    flat = torch.zeros(1 + 4 * 32, dtype=torch.int32, device=cuda)
    codes = flat[1:].view(1, 1, 4, 32)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        traceback.walk_sw_codes_batch(codes, zero, zero)
    with pytest.raises(ValueError, match="16-byte"):
        traceback.walk_gotoh_codes_batch(codes, zero, zero, zero, 4)


# ---------------- the variant two-pass route: span fills and group walks ----------------


def _whole_span(T, sc, kind):
    """The plain span fill over T's whole table in one span, with codes:
    (bnd, key, best, j*, i*, codes) or Gotoh's (bnd, scores, states,
    codes)."""
    (want,) = variant_span_chain(T, sc, kind, max(1, -(-T[1].shape[1] // 32)), plain=True)
    return want


def _chain_same(got, want, msg, codes=True):
    """A span chain's last outputs and (``codes``) its spans' codes side by
    side against one span of the whole table."""
    n = len(want) - 1
    for g, w in zip(got[-1][:n], want[:n]):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0, msg=msg)
    if codes:
        torch.testing.assert_close(torch.cat([x[n] for x in got], 1).cpu(), want[n], rtol=0, atol=0, msg=msg)


def _spans_vs_plain(cpu, dev, sc, kind):
    """The span fill of ``kind`` chained over the whole table in spans of 3
    bands (r0 = 0, 3, 6, ...: on and off a warp boundary at W = 2, 7, 16)
    at every W of VARIANT_SPAN_WARPS and the rule's, in spans of 1 band (S
    = 1) at W = 1, 7 and the rule's, and as pass 1 sweeps it (no codes) at
    the rule's W, against one plain span of the whole table."""
    want = _whole_span(cpu, sc, kind)
    for S, Ws in ((3, VARIANT_SPAN_WARPS), (1, (1, 7, None))):
        for W in Ws:
            _chain_same(variant_span_chain(dev, sc, kind, S, W), want, f"S = {S}, W = {W}")
    _chain_same(variant_span_chain(dev, sc, kind, 3, emit_codes=False), want, "no codes", codes=False)


@pytest.mark.parametrize("kind", ["sw", "overlap"])
@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_free_span_at_forced_warps_vs_plain(cuda, mkd, kind):
    """free_fill_span (LOCAL, OVERLAP) on _free_batches' two buckets (5 and
    35 bands; bests on warp 1, in the last band, back on warp 0 after a
    round, and equal in bands 0 and W on one lane, so the best's key is
    merged across spans): the last row, the key, best, j*, i* and the
    codes bit for bit against the plain span."""
    for cpu, dev in _free_batches(sum(mkd) % 71 + 31, cuda):
        _spans_vs_plain(cpu, dev, mkd, kind)


@pytest.mark.parametrize("sc", GOTOH_ALIGN_SCORINGS)
def test_gotoh_span_at_forced_warps_vs_plain(cuda, sc):
    """gotoh_fill_span on _free_batches' two buckets under the alignments'
    scorings (near the sentinel too): the last rows (h, IY, state bits),
    the scores and corner states, and the codes bit for bit against the
    plain span."""
    for cpu, dev in _free_batches(sum(sc) % 73 + 29, cuda):
        _spans_vs_plain(cpu, dev, sc, "gotoh")


@pytest.mark.parametrize("kind", VARIANT_KINDS)
def test_variant_span_with_the_top_in_device_memory(cuda, kind):
    """A 117 000-column top (past a block's shared memory) in device
    memory: spans of 1 and 3 bands at W = 1, 3 give the whole-table code
    fill's codes, best and cell (Gotoh: scores and corner states) at W =
    3 (held to a host row sweep by the free code fills' own test, and to
    the single-pair kernels for Gotoh) and one last row."""
    rng = np.random.default_rng(34)
    A, Bs = 117_000, 100  # 4 bands
    letters = np.frombuffer(b"ACGT", np.uint8)
    ps = [(letters[rng.integers(0, 4, a)].tobytes(), letters[rng.integers(0, 4, s)].tobytes())
          for a, s in ((A, Bs), (A - 9, 64), (A - 30_000, 33))]
    dev = enc.upload(enc.encode_batch(ps, A, Bs), cuda)
    cell = variants_banded.GOTOH_CELL[True] if kind == "gotoh" else 4
    assert not fill_banded.top_in_smem(A, cell)
    if kind == "gotoh":
        sc = (2, 1, 3, 1)
        codes, *outs = variants_banded.affine_fill_codes_banded_batch(*dev, *sc, warps=3)
        picks = (1, 2)  # scores, states
    else:
        sc = (2, 1, 1)
        codes, *outs = getattr(variants_banded, f"{kind}_fill_codes_banded_batch")(*dev, *sc, warps=3)
        picks = (2, 3, 4)  # best, j*, i*
    rows = []
    for S in (1, 3):
        for W in (1, 3):
            got = variant_span_chain(dev, sc, kind, S, W)
            assert torch.equal(torch.cat([x[-1] for x in got], 1), codes), f"S = {S}, W = {W}"
            assert all(torch.equal(got[-1][p], o) for p, o in zip(picks, outs)), f"S = {S}, W = {W}"
            rows.append(got[-1][0])
    assert all(torch.equal(r, rows[0]) for r in rows)


def _group_walks_vs_plain(kind, codes, start, width, want, cuda):
    """The group walk of ``kind`` chained over groups of GROUP_SIZES bands
    of ``codes`` from the cursors ``start`` on the card, against its plain
    version chained the same way and against the one-pass plain walk
    ``want`` (ops, n[, i_end, j_end])."""
    walk = traceback.walk_gotoh_codes_groups if kind == "gotoh" else traceback.walk_sw_codes_groups
    plain = traceback.walk_gotoh_codes_groups_plain if kind == "gotoh" else traceback.walk_sw_codes_groups_plain
    for G in GROUP_SIZES:
        p_state, p_ops = variant_groups_walk(plain, codes, start, G, width)
        g_state, g_ops = variant_groups_walk(walk, codes.to(cuda), start.to(cuda), G, width)
        torch.testing.assert_close(g_state.cpu(), p_state, rtol=0, atol=0, msg=f"G = {G}")
        torch.testing.assert_close(g_ops.cpu(), p_ops, rtol=0, atol=0, msg=f"G = {G}")
        torch.testing.assert_close(p_ops, want[0], rtol=0, atol=0, msg=f"G = {G}")
        torch.testing.assert_close(p_state[:, 2], want[1], rtol=0, atol=0, msg=f"G = {G}")
        if kind != "gotoh":  # where the walk stopped
            torch.testing.assert_close(p_state[:, 0], want[2], rtol=0, atol=0, msg=f"G = {G}")
            torch.testing.assert_close(p_state[:, 1], want[3], rtol=0, atol=0, msg=f"G = {G}")


@pytest.mark.parametrize("shape", VARIANT_WALK_EDGE_SHAPES)
@pytest.mark.parametrize("kind", VARIANT_KINDS)
def test_variant_walk_groups_vs_plain_at_edge_shapes(cuda, kind, shape):
    """sw_walk_groups (SW and overlap codes) and gotoh_walk_groups chained
    over groups of 1, 2 and 3 bands, last group first, of each variant walk
    edge shape's codes, from each fill's start (the best cell, or the
    corner in its state) for the shape's pairs, the first pair alone (B =
    1) and an odd B, and from every edge start of each pair's table (Gotoh:
    in a state turning with the start), against the plain group walk and
    the one-pass plain walk, under three scorings (wrapping ones too)."""
    ps = variant_edge_pairs(shape)
    T = _variant_batch(ps, "cpu")
    odd = len(ps) - 1 + len(ps) % 2
    if kind == "gotoh":
        width = T[0].shape[1] + T[1].shape[1]
        for q, sc in enumerate((GOTOH_ALIGN_SCORINGS[0], GOTOH_ALIGN_SCORINGS[5], GOTOH_ALIGN_SCORINGS[-1])):
            fill = variants_banded.affine_fill_codes_banded_batch_plain(*T, *sc)
            codes, _, states = fill
            start = variant_cursor("gotoh", fill, T)
            for B in sorted({len(ps), 1, odd}):
                want = traceback.walk_gotoh_codes_batch_plain(codes[:B], T[2][:B], T[3][:B], states[:B], width)
                _group_walks_vs_plain(kind, codes[:B], start[:B], width, want, cuda)
            sub, js, is_ = starts_batch(codes, T[2], T[3], 8)
            st = torch.where(js == 0, 1, torch.where(is_ == 0, 2, (torch.arange(len(js)) + q) % 3)).int()
            want = traceback.walk_gotoh_codes_batch_plain(sub, is_, js, st, width)
            _group_walks_vs_plain(kind, sub, torch.stack([is_, js, torch.zeros_like(js), st], 1).contiguous(),
                                  width, want, cuda)
        return
    for mkd in (SW_SCORINGS[0], SW_SCORINGS[4], SW_SCORINGS[-1]):
        fill = getattr(variants_banded, f"{kind}_fill_codes_banded_batch_plain")(*T, *mkd)
        codes = fill[0]
        start = variant_cursor(kind, fill, T)
        width = traceback._sw_max_steps(codes)
        for B in sorted({len(ps), 1, odd}):
            want = traceback.walk_sw_codes_batch_plain(codes[:B], fill[2][:B], fill[3][:B])
            _group_walks_vs_plain(kind, codes[:B], start[:B], width, want, cuda)
        sub, js, is_ = starts_batch(codes, T[2], T[3], 16)
        want = traceback.walk_sw_codes_batch_plain(sub, js, is_)
        _group_walks_vs_plain(kind, sub, torch.stack([is_, js, torch.zeros_like(js)], 1).contiguous(), width, want,
                              cuda)


@pytest.mark.parametrize("kind", VARIANT_KINDS)
def test_variant_tracebacks_on_both_routes_cuda_vs_cpu(cuda, kind, monkeypatch):
    """sw_ / overlap_ / affine_traceback_banded_batch on the card, with
    NW_TPU_ONEPASS_HBM at 0 (the two-pass route, groups of 4 bands and the
    default height) and unset (the one-pass route), equal the plain route
    on the CPU (long pairs: 35 bands)."""
    from nw_tpu_torch.ops import banded_traceback as bt

    ps = _pairs(17, 20, 0, 1100) + _pairs(18, 3, 900, 1100, "AC") + EDGE
    name = "affine" if kind == "gotoh" else kind
    fn = getattr(variants_banded, f"{name}_traceback_banded_batch")
    sc = (2, 1, 3, 1) if kind == "gotoh" else (2, 1, 1)
    monkeypatch.delenv("NW_TPU_ONEPASS_HBM", raising=False)
    want = fn(*_variant_batch(ps, "cpu"), *sc)
    got = fn(*_variant_batch(ps, cuda), *sc)
    _same([torch.from_numpy(g) for g in got], [torch.from_numpy(w) for w in want])
    monkeypatch.setenv("NW_TPU_ONEPASS_HBM", "0")
    for S in (4, bt.GROUP_BANDS):
        monkeypatch.setattr(bt, "GROUP_BANDS", S)
        got = fn(*_variant_batch(ps, cuda), *sc)
        _same([torch.from_numpy(g) for g in got], [torch.from_numpy(w) for w in want])
