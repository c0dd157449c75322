"""The code walks' plain versions vs nw_tpu on the CPU, at the shapes the
walk kernels' staging must get right.

``nw_walk`` and ``nw_walk_window``'s codes mode copy a band's word columns
into shared memory a segment at a time, ahead of the walk, so their edge
cases are the geometry's: LEFT runs longer than several segments (700 x
3), UP runs across bands (3 x 700), corners on band edges (len2 = 32q - 1,
32q, 32q + 1) and on word-column edges (len1 = 16q - 31 +- 1), the empty
and one-sided pairs, and windows chained over blocks of 32, 64 and 96
rows down to row 0.  Here :func:`walk_codes_batch_plain` and
:func:`walk_codes_window_plain` (the kernels' references on the card,
``tests/test_torch_kernels_walks.py``) are held against ``nw_tpu``'s
greedy walk over the scan oracle's tie masks, as
``tests/test_torch_traceback.py`` does.  All comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nw_tpu.ops import encode as jenc
from nw_tpu.ops import traceback as jtb
from nw_tpu.ops.fill_scan import fill_diag_batch as j_fill_diag_batch
from nw_tpu_torch.ops import fill_banded, fill_single
from nw_tpu_torch.ops import traceback as ttb

from torch_kernel_cases import WALK_EDGE_SHAPES, _walk_chain, walk_edge_pairs, _window_chain

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

MKDS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)]


def _nw_tpu_walks(ps, mkd):
    """(tops, sides, lens1, lens2) as int32 tensors and nw_tpu's greedy
    walks (ops int8[B, S], n int32[B]) over its scan's tie masks."""
    tops, sides, l1, l2 = jenc.encode_batch(ps)
    S = tops.shape[1] + sides.shape[1]
    ref = j_fill_diag_batch(tops, sides, *mkd, jnp.asarray(l1), jnp.asarray(l2))
    ops, n = jtb.traceback_greedy_batch(ref["arrows"], jnp.asarray(l1), jnp.asarray(l2), max_steps=S)
    T = tuple(torch.from_numpy(np.asarray(a)) for a in (tops, sides, l1, l2))
    return T, np.asarray(ops), np.asarray(n)


@pytest.mark.parametrize("mkd", MKDS)
@pytest.mark.parametrize("shape", WALK_EDGE_SHAPES)
def test_walk_codes_batch_plain_at_edge_shapes(shape, mkd):
    """The batch walk over the port's codes equals nw_tpu's walk, whole and
    cut after fewer ops than the longest walk."""
    ps = walk_edge_pairs(shape)
    T, want_ops, want_n = _nw_tpu_walks(ps, mkd)
    S = want_ops.shape[1]
    codes, _, _ = fill_banded.fill_greedy_counts_banded_batch(*T, *mkd)
    ops, n = ttb.walk_codes_batch_plain(codes, T[2], T[3], S)
    np.testing.assert_array_equal(ops.numpy(), want_ops)
    np.testing.assert_array_equal(n.numpy(), want_n)
    for cut in (1, max(int(want_n.max()) - 1, 1)):
        ops, n = ttb.walk_codes_batch_plain(codes, T[2], T[3], cut)
        np.testing.assert_array_equal(ops.numpy(), want_ops[:, :cut])
        np.testing.assert_array_equal(n.numpy(), np.minimum(want_n, cut))


@pytest.mark.parametrize("C", [32, 64, 96])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (3, -1, 2)])
@pytest.mark.parametrize("shape", WALK_EDGE_SHAPES)
def test_walk_codes_window_plain_chained_at_edge_shapes(shape, mkd, C):
    """The window walk chained over blocks of C rows, each re-filled from
    its checkpoint row, down to row 0 (j0 = 0), equals nw_tpu's walk of
    the whole pair and ends at the origin."""
    ps = [p for p in walk_edge_pairs(shape) if p[1]]  # a pair with rows to walk
    _, want_ops, want_n = _nw_tpu_walks(ps, mkd)
    for b, (s1, s2) in enumerate(ps):
        chain = _window_chain(s1, s2, mkd, C, fill_single.fill_codes_single_plain, fill_single.score_fold_plain)
        state, ops = _walk_chain(ttb.walk_codes_window_plain, chain, len(s1), len(s2))
        assert state.tolist() == [0, 0, int(want_n[b])]
        np.testing.assert_array_equal(ops.numpy(), want_ops[b, : len(s1) + len(s2)])


@pytest.mark.parametrize("shape", WALK_EDGE_SHAPES)
def test_walk_codes_window_plain_cut_and_outside_starts(shape):
    """A window walk cut after S ops keeps the ops it wrote and the cell it
    reached, and the next block's walk goes on from there; a start outside
    a block's rows or columns leaves the state and ops as they were."""
    ps = [p for p in walk_edge_pairs(shape) if p[1]]
    _, want_ops, want_n = _nw_tpu_walks(ps, (2, 1, 1))
    for b, (s1, s2) in enumerate(ps):
        chain = _window_chain(s1, s2, (2, 1, 1), 32, fill_single.fill_codes_single_plain,
                              fill_single.score_fold_plain)
        r0, codes = chain[0]
        for start in ([len(s1), r0 + 32 * codes.shape[1] + 1, 0], [16 * codes.shape[2] - 31, r0 + 1, 0],
                      [0, r0 - 1, 0], [len(s1), len(s2), -1]):
            state, ops = torch.tensor(start, dtype=torch.int32), torch.full((4,), 3, dtype=torch.int8)
            ttb.walk_codes_window_plain(codes, state, r0, ops)
            assert state.tolist() == start and ops.tolist() == [3] * 4
        # an ops buffer of n_max - 1 cuts the last block's walk; a walk
        # into a bigger buffer from the cut state finishes the chain
        S = int(want_n[b])
        state = torch.tensor([len(s1), len(s2), 0], dtype=torch.int32)
        short = torch.full((max(S - 1, 0),), 3, dtype=torch.int8)
        full = torch.full((S,), 3, dtype=torch.int8)
        for r0, codes in chain:
            ttb.walk_codes_window_plain(codes, state, r0, short)
        assert int(state[2]) == max(S - 1, 0)
        full[: short.shape[0]] = short
        for r0, codes in chain:  # the blocks above the cut cell leave it as it is
            ttb.walk_codes_window_plain(codes, state, r0, full)
        assert state.tolist() == [0, 0, S]
        np.testing.assert_array_equal(full.numpy(), want_ops[b, :S])

