"""The local and Gotoh walks' plain versions vs nw_tpu on the CPU, at the
shapes the walk kernels' staging must get right.

``sw_walk`` (over local and overlap codes) and ``gotoh_walk`` copy a
band's word columns into shared memory ahead of the walk and expand them
into a table of steps, so their edge cases are the geometry's
(``torch_kernel_cases.VARIANT_WALK_EDGE_SHAPES``, defined in
``chip_smoke.py`` beside the card checks of the same kernels): LEFT runs
longer than several segments (700 x 3; at a free gap, ``2 1 0``, local
ones too), UP runs across 22 bands (3 x 700), best cells and corners on
band edges and on the word-column edges of 2-bit (16 cells) and 4-bit (8
cells) codes, a local walk that stops mid-band, Gotoh's runs along column 0
and row 0, the empty and one-sided pairs; and local walks from every edge
start of a table (``variant_walk_starts``: rows 0 and 1, band edges,
column 0, word-column edges).  Here :func:`walk_sw_codes_batch_plain` and
:func:`walk_gotoh_codes_batch_plain` (the kernels' references on the card,
``tests/test_torch_kernels_variants.py``) are held against ``nw_tpu``:
``sw_align_batch`` (K24 in interpret mode and the vmapped
``_sw_walk_packed``), its scan at a gap bonus (``1 1 -1``, where K24 does
not follow it) and ``_sw_walk_packed`` from each edge start over K24's
words; ``overlap_align_batch`` and ``_overlap_walk_diag`` from each edge
start over its scan's arrows; ``affine_align_batch`` (K25 in interpret
mode and ``_affine_walk_packed``, whose ops are compared too).  All
comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nw_tpu.models import affine as ref_af
from nw_tpu.models import overlap as ref_ov
from nw_tpu.models import smith_waterman as ref_sw
from nw_tpu.ops import encode as jenc
from nw_tpu.ops.variants_pallas import affine_arrows_pallas_batch as k25_codes
from nw_tpu.ops.variants_pallas import sw_arrows_pallas_batch as k24_words
from nw_tpu_torch.models import affine as af
from nw_tpu_torch.models import overlap as ov
from nw_tpu_torch.models import smith_waterman as sw
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import traceback as tb
from nw_tpu_torch.ops import variants_banded as vb

from torch_kernel_cases import VARIANT_WALK_EDGE_SHAPES, starts_batch, variant_edge_pairs, variant_walk_starts

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# where K24 follows nw_tpu's scan (no gap or mismatch bonus), a free gap among them
K24_SCORINGS = [(2, 1, 1), (2, 1, 0)]
OVERLAP_SCORINGS = [(2, 1, 1), (2, 1, 0), (1, 1, -1)]
# Gotoh at a small extend cost too: long IX and IY runs
GOTOH_SCORINGS = [(2, 1, 3, 1), (3, 1, 4, 0)]


def _torch_batch(ps):
    return enc.upload(enc.encode_batch(ps), "cpu")


@pytest.mark.parametrize("mkd", K24_SCORINGS)
@pytest.mark.parametrize("shape", VARIANT_WALK_EDGE_SHAPES)
def test_sw_align_batch_plain_matches_k24_at_edge_shapes(shape, mkd):
    """The plain local fill and walk give nw_tpu's alignments (K24 and its
    vmapped walk): best, strings and stop cell."""
    ps = variant_edge_pairs(shape)
    assert sw.sw_align_batch(ps, *mkd, device="cpu") == ref_sw.sw_align_batch(ps, *mkd)


@pytest.mark.parametrize("shape", VARIANT_WALK_EDGE_SHAPES)
def test_sw_align_batch_plain_matches_the_scan_at_a_gap_bonus(shape):
    """At 1 1 -1 (every gap a bonus: walks of gaps) the plain path gives
    nw_tpu's scan alignment of each pair."""
    ps = variant_edge_pairs(shape)
    assert sw.sw_align_batch(ps, 1, 1, -1, device="cpu") == [ref_sw.sw_align(a, s, 1, 1, -1) for a, s in ps]


def _start_rows(T):
    """The pair of each edge start, in ``starts_batch``'s order."""
    counts = [len(variant_walk_starts(a, b, 16)) for a, b in zip(T[2].tolist(), T[3].tolist())]
    return jnp.asarray(np.repeat(np.arange(len(counts)), counts))


def _same_ops(ops, n, r_ops, r_n):
    """Each walk's n and its n ops equal nw_tpu's; the port pads with
    OP_NONE."""
    ops, n, r_ops, r_n = (np.asarray(x) for x in (ops, n, r_ops, r_n))
    np.testing.assert_array_equal(n, r_n)
    for q in range(len(n)):
        np.testing.assert_array_equal(ops[q, : n[q]], r_ops[q, : n[q]])
        assert (ops[q, n[q]:] == tb.OP_NONE).all()


def _walks_agree(got, want):
    """The port's (ops, n, i_end, j_end) against nw_tpu's walks from the
    same starts."""
    (ops, n, i_end, j_end), (r_ops, r_n, r_i, r_j) = got, want
    _same_ops(ops, n, r_ops, r_n)
    np.testing.assert_array_equal(i_end.numpy(), np.asarray(r_i))
    np.testing.assert_array_equal(j_end.numpy(), np.asarray(r_j))


@pytest.mark.parametrize("mkd", K24_SCORINGS)
@pytest.mark.parametrize("shape", VARIANT_WALK_EDGE_SHAPES)
def test_sw_walk_plain_from_edge_starts_matches_k24_walk(shape, mkd):
    """The plain local walk from every edge start of each pair's table (j*
    = 0 and i* = 0, band edges, 16-cell word-column edges) equals
    ``_sw_walk_packed`` from the same cell over K24's words: ops, n and
    the stop cell."""
    ps = variant_edge_pairs(shape)
    T = _torch_batch(ps)
    codes = vb.sw_fill_codes_banded_batch(*T, *mkd)[0]
    sub, js, is_ = starts_batch(codes, T[2], T[3], 16)
    got = tb.walk_sw_codes_batch_plain(sub, js, is_)
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    words = k24_words(tops, sides, l1, l2, *mkd, interpret=True)[0]
    S = tops.shape[1] + sides.shape[1]
    walk = jax.vmap(lambda b, j, i: ref_sw._sw_walk_packed(words[:, :, b], j, i, max_steps=S))
    _walks_agree(got, walk(_start_rows(T), jnp.asarray(js.numpy()), jnp.asarray(is_.numpy())))


@pytest.mark.parametrize("mkd", OVERLAP_SCORINGS)
@pytest.mark.parametrize("shape", VARIANT_WALK_EDGE_SHAPES)
def test_overlap_align_batch_plain_matches_nw_tpu_at_edge_shapes(shape, mkd):
    """The plain overlap fill and walk give nw_tpu's overlap alignments."""
    ps = variant_edge_pairs(shape)
    assert ov.overlap_align_batch(ps, *mkd, device="cpu") == ref_ov.overlap_align_batch(ps, *mkd)


@pytest.mark.parametrize("mkd", OVERLAP_SCORINGS)
@pytest.mark.parametrize("shape", VARIANT_WALK_EDGE_SHAPES)
def test_sw_walk_plain_on_overlap_codes_from_edge_starts(shape, mkd):
    """The plain walk over overlap codes from every edge start equals
    ``_overlap_walk_diag`` from the same cell over nw_tpu's overlap scan's
    arrows: ops, n and the cell where it reached row 0 or column 0."""
    ps = variant_edge_pairs(shape)
    T = _torch_batch(ps)
    codes = vb.overlap_fill_codes_banded_batch(*T, *mkd)[0]
    sub, js, is_ = starts_batch(codes, T[2], T[3], 16)
    got = tb.walk_sw_codes_batch_plain(sub, js, is_)
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    arrows = ref_ov._overlap_fill_batch(tops, sides, *mkd, jnp.asarray(l1), jnp.asarray(l2))["arrows"]
    S = tops.shape[1] + sides.shape[1]
    walk = jax.vmap(lambda b, j, i: ref_ov._overlap_walk_diag(arrows[b], j, i, max_steps=S))
    _walks_agree(got, walk(_start_rows(T), jnp.asarray(js.numpy()), jnp.asarray(is_.numpy())))


@pytest.mark.parametrize("sc", GOTOH_SCORINGS)
@pytest.mark.parametrize("shape", VARIANT_WALK_EDGE_SHAPES)
def test_gotoh_walk_plain_matches_k25_at_edge_shapes(shape, sc):
    """The plain Gotoh walk from each corner in its state (corners on band
    edges and 8-cell word-column edges, IX runs of 700 x 3, IY runs of 3 x
    700, runs along column 0 and row 0) equals ``_affine_walk_packed``
    over K25's words (ops and n), and ``affine_align_batch`` on the CPU
    gives nw_tpu's alignments."""
    ps = variant_edge_pairs(shape)
    T = _torch_batch(ps)
    S = T[0].shape[1] + T[1].shape[1]
    codes, _, states = vb.affine_fill_codes_banded_batch(*T, *sc)
    ops, n = tb.walk_gotoh_codes_batch_plain(codes, T[2], T[3], states, S)
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    words, _, k25_states = k25_codes(tops, sides, l1, l2, *sc, interpret=True)
    np.testing.assert_array_equal(np.asarray(k25_states), states.numpy())
    walk = ref_af._affine_walk_vmapped(tops.shape[1] + sides.shape[1])
    _same_ops(ops, n, *walk(words, k25_states, jnp.asarray(l1), jnp.asarray(l2)))
    assert af.affine_align_batch(ps, *sc, device="cpu") == ref_af.affine_align_batch(ps, *sc)


def test_variant_walks_plain_on_the_empty_batch():
    """An empty batch walks nothing: empty ops and counts, and no
    alignments from the models (nw_tpu's overlap_align_batch agrees)."""
    T = _torch_batch([("ACGT", "ACG")])
    codes = vb.sw_fill_codes_banded_batch(*T, 2, 1, 1)[0][:0]
    ops, n, i_end, j_end = tb.walk_sw_codes_batch_plain(codes, T[3][:0], T[2][:0])
    assert ops.shape == (0, tb._sw_max_steps(codes)) and n.shape == i_end.shape == j_end.shape == (0,)
    g_codes, _, states = vb.affine_fill_codes_banded_batch(*T, 2, 1, 3, 1)
    ops, n = tb.walk_gotoh_codes_batch_plain(g_codes[:0], T[2][:0], T[3][:0], states[:0], 7)
    assert ops.shape == (0, 7) and n.shape == (0,)
    assert sw.sw_align_batch([], device="cpu") == af.affine_align_batch([], 2, 1, 3, 1, device="cpu") == []
    assert ov.overlap_align_batch([], device="cpu") == ref_ov.overlap_align_batch([]) == []
