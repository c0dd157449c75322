"""The tie-mask walks' plain versions vs nw_tpu on the CPU, at the shapes
the masks walk kernels' staging must get right.

``nw_walk_masks`` and ``nw_walk_window``'s masks mode copy each band's row
pieces into shared memory one band ahead of the walk, widened to the
16-byte blocks that hold them and spread over the warp's lanes, so their
edge cases are the geometry's and the rows' offsets: LEFT runs longer
than several pieces (700 x 3), UP runs across bands (3 x 700), corners on
band edges (len2 = 32q - 1, 32q, 32q + 1), rows of A+1 bytes at every
residue mod 16, tie-dense pairs, the empty and one-sided pairs, and
windows chained over blocks of 32, 64 and 96 rows down to row 0.  Here
:func:`walk_masks_batch_plain` and :func:`walk_masks_window_plain` (the
kernels' references on the card,
``tests/test_torch_kernels_walks.py``) are held against ``nw_tpu``'s
greedy walk (``traceback_greedy``) over the scan oracle's tie masks, and
over tables of random bytes.

On a cell with none of bits 0-2 set (no fill writes one) ``nw_tpu``'s
``traceback_greedy`` records UP without moving; its relay walk over K28's
masks (``nw_tpu/parallel/huge_pair.py:894-903``) moves UP there, and the
port's walks follow that rule, so the random tables' reference gets bit 2
on those cells (bits 3-7 stay random: both read only bits 0-2).  All
comparisons are exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nw_tpu.ops import encode as jenc
from nw_tpu.ops import traceback as jtb
from nw_tpu.ops.fill_scan import fill_diag_batch as j_fill_diag_batch
from nw_tpu_torch.ops import traceback as ttb
from nw_tpu_torch.ops.fill_scan import diag_to_matrix_batch, matrix_to_diag_batch

from torch_kernel_cases import (
    MASK_STRIDES, MASK_WALK_EDGE_SHAPES, mask_edge_pairs, _mask_window_chain, random_masks, _walk_chain,
)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

MKDS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)]


@functools.lru_cache(maxsize=None)
def _nw_tpu_masks_walks(shape, mkd):
    """(masks uint8[B, Bs+1, A+1], lens1, lens2) of the scan oracle for the
    shape's pairs, and nw_tpu's greedy walks (ops int8[B, S], n int32[B])
    over them."""
    ps = mask_edge_pairs(shape)
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    S = tops.shape[1] + sides.shape[1]
    ref = j_fill_diag_batch(tops, sides, *mkd, jnp.asarray(l1), jnp.asarray(l2))
    ops, n = jtb.traceback_greedy_batch(ref["arrows"], jnp.asarray(l1), jnp.asarray(l2), max_steps=S)
    masks = diag_to_matrix_batch(torch.from_numpy(np.array(ref["arrows"])))
    lens = tuple(torch.from_numpy(np.asarray(x)).to(torch.int32) for x in (l1, l2))
    return masks, lens, np.asarray(ops), np.asarray(n)


def _widths(shape, masks):
    """The tables the batch walk is held on: the oracle's, and for
    "strides" the same cells in rows of A+1 = 129 .. 144 bytes."""
    if shape != "strides":
        return [masks]
    M = masks.shape[2]
    return [torch.nn.functional.pad(masks, (0, 129 + e - M)) for e in MASK_STRIDES]


def _greedy_of(masks, lens1, lens2, S):
    """nw_tpu's traceback_greedy over rectangular masks laid out
    diagonal-major (cell (j, i) at [i + j, j]), bit 2 set where none of
    bits 0-2 is (the module's note)."""
    m = masks.clone()
    m[(m & 7) == 0] |= 4
    ops, n = jtb.traceback_greedy_batch(
        jnp.asarray(matrix_to_diag_batch(m).numpy()), jnp.asarray(lens1.numpy()), jnp.asarray(lens2.numpy()),
        max_steps=S,
    )
    return np.asarray(ops), np.asarray(n)


@pytest.mark.parametrize("mkd", MKDS)
@pytest.mark.parametrize("shape", MASK_WALK_EDGE_SHAPES)
def test_walk_masks_batch_plain_at_edge_shapes(shape, mkd):
    """The batch walk over the oracle's tie masks equals nw_tpu's walk,
    whole and cut after fewer ops than the longest walk; for "strides" at
    every row width of 129 .. 144 bytes."""
    masks, (l1, l2), want_ops, want_n = _nw_tpu_masks_walks(shape, mkd)
    S = want_ops.shape[1]
    for table in _widths(shape, masks):
        ops, n = ttb.walk_masks_batch_plain(table, l1, l2, S)
        np.testing.assert_array_equal(ops.numpy(), want_ops)
        np.testing.assert_array_equal(n.numpy(), want_n)
    for cut in (1, max(int(want_n.max()) - 1, 1)):
        ops, n = ttb.walk_masks_batch_plain(masks, l1, l2, cut)
        np.testing.assert_array_equal(ops.numpy(), want_ops[:, :cut])
        np.testing.assert_array_equal(n.numpy(), np.minimum(want_n, cut))


@pytest.mark.parametrize("C", [32, 64, 96])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (3, -1, 2)])
@pytest.mark.parametrize("shape", MASK_WALK_EDGE_SHAPES)
def test_walk_masks_window_plain_chained_at_edge_shapes(shape, mkd, C):
    """The window walk chained over blocks of C rows of each pair's masks
    (rows of A+1 = len1 + 1 bytes), down to row 0 (j0 = 0), equals nw_tpu's
    walk of the whole pair and ends at the origin."""
    masks, (l1, l2), want_ops, want_n = _nw_tpu_masks_walks(shape, mkd)
    for b, (n1, n2) in enumerate(zip(l1.tolist(), l2.tolist())):
        if not n2:  # no row to walk: the batch walk's test holds it
            continue
        chain = _mask_window_chain(masks[b, : n2 + 1, : n1 + 1].contiguous(), C)
        state, ops = _walk_chain(ttb.walk_masks_window_plain, chain, n1, n2)
        assert state.tolist() == [0, 0, int(want_n[b])]
        np.testing.assert_array_equal(ops.numpy(), want_ops[b, : n1 + n2])


@pytest.mark.parametrize("shape", MASK_WALK_EDGE_SHAPES)
def test_walk_masks_window_plain_cut_and_outside_starts(shape):
    """A window walk cut after S ops keeps the ops it wrote and the cell it
    reached, and the next blocks' walks go on from there; a start outside
    a block's rows or columns (or with n < 0) leaves the state and ops as
    they were."""
    masks, (l1, l2), want_ops, want_n = _nw_tpu_masks_walks(shape, (2, 1, 1))
    for b, (n1, n2) in enumerate(zip(l1.tolist(), l2.tolist())):
        if not n2:
            continue
        chain = _mask_window_chain(masks[b, : n2 + 1, : n1 + 1].contiguous(), 32)
        r0, rows = chain[0]
        for start in ([n1, r0 + rows.shape[0] + 1, 0], [n1 + 1, r0 + 1, 0], [-1, r0 + 1, 0],
                      [0, r0 - 1, 0], [n1, n2, -1]):
            state, ops = torch.tensor(start, dtype=torch.int32), torch.full((4,), 3, dtype=torch.int8)
            ttb.walk_masks_window_plain(rows, state, r0, ops)
            assert state.tolist() == start and ops.tolist() == [3] * 4
        S = int(want_n[b])
        state = torch.tensor([n1, n2, 0], dtype=torch.int32)
        short = torch.full((max(S - 1, 0),), 3, dtype=torch.int8)
        full = torch.full((S,), 3, dtype=torch.int8)
        for r0, rows in chain:
            ttb.walk_masks_window_plain(rows, state, r0, short)
        assert int(state[2]) == max(S - 1, 0)
        full[: short.shape[0]] = short
        for r0, rows in chain:  # the blocks above the cut cell leave it as it is
            ttb.walk_masks_window_plain(rows, state, r0, full)
        assert state.tolist() == [0, 0, S]
        np.testing.assert_array_equal(full.numpy(), want_ops[b, :S])


@pytest.mark.parametrize("M", [113, 120, 128, 129])
def test_walk_masks_plain_over_random_bytes(M):
    """Tables of random bytes 0-255 in rows >= 1 and columns >= 1 (row 0
    LEFT, column 0 UP): the batch walk and the window walk chained over
    blocks of 32, 64 and 96 rows equal nw_tpu's greedy walk over the same
    bytes laid out diagonal-major, which pins the first set bit of bits
    0-2 in diag > left > up order, UP where none is set, and bits 3-7 not
    read."""
    N = 200
    masks = random_masks(np.random.default_rng(M), 3, N, M)
    l1 = torch.tensor([M - 1, M - 7, 40], dtype=torch.int32)
    l2 = torch.tensor([N - 1, 161, 96], dtype=torch.int32)
    S = N + M
    want_ops, want_n = _greedy_of(masks, l1, l2, S)
    assert (masks[:, 1:, 1:] & 7 == 0).any() and (masks[:, 1:, 1:] >> 3).unique().numel() == 32
    ops, n = ttb.walk_masks_batch_plain(masks, l1, l2, S)
    np.testing.assert_array_equal(ops.numpy(), want_ops)
    np.testing.assert_array_equal(n.numpy(), want_n)
    for b, (n1, n2) in enumerate(zip(l1.tolist(), l2.tolist())):
        for C in (32, 64, 96):
            chain = _mask_window_chain(masks[b, : n2 + 1], C)  # rows of all M bytes
            state, ops = _walk_chain(ttb.walk_masks_window_plain, chain, n1, n2)
            assert state.tolist() == [0, 0, int(want_n[b])]
            np.testing.assert_array_equal(ops.numpy(), want_ops[b, : n1 + n2])
