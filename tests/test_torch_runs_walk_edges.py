"""The run-skip walk's plain version vs nw_tpu on the CPU, at the shapes
the ``nw_walk_runs`` kernel's staging must get right.

``nw_walk_runs`` walks the run bytes ``min(run, 63) << 2 | code`` of
``nw_fill_runs_batch`` as the tie-mask walk walks its masks: each band's
row pieces copied into shared memory one band ahead, widened to the
16-byte blocks that hold them, and expanded into a table of the runs'
whole jumps.  Its edge cases are the runs' lengths against the table's
and the slot's columns and the bands' rows, and the rows' offsets: LEFT
runs past the 63 cap and past 64 and 128 columns, at the corner and
mid-path; UP runs across bands; pure diagonals across many 32-row bands;
alternating indels (a run a load); walks onto row 0 and column 0 and
starts there; the empty and one-sided pairs; rows of A+1 bytes around
multiples of 16 and of the 128-byte piece (``RUNS_WIDTHS``).  Here
:func:`walk_runs_batch_plain` (the kernel's reference on the card,
``tests/test_torch_kernels_walks.py``) over
:func:`fill_runs_banded_batch_plain`'s bytes is held against ``nw_tpu``'s
greedy walk (``traceback_greedy``) over the scan oracle's tie masks, the
walk whose ops the run-skip walk expands (the run bytes' code is the
greedy code, diag > left > up), whole and cut after fewer ops than the
longest walk.  All comparisons are exact (tolerance 0 on ops and n).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nw_tpu.ops import encode as jenc
from nw_tpu.ops import traceback as jtb
from nw_tpu.ops.fill_scan import fill_diag_batch as j_fill_diag_batch
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded
from nw_tpu_torch.ops import traceback as ttb

from torch_kernel_cases import RUNS_WALK_EDGE_SHAPES, RUNS_WIDTHS, SCORINGS, runs_edge_pairs

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@functools.lru_cache(maxsize=None)
def _nw_tpu_walks(pairs, mkd):
    """(batch tensors, S) of ``pairs`` at nw_tpu's buckets, and nw_tpu's
    greedy walks over the scan oracle's tie masks (ops int8[B, S], n
    int32[B])."""
    tops, sides, l1, l2 = jenc.encode_batch(list(pairs))
    S = tops.shape[1] + sides.shape[1]
    ref = j_fill_diag_batch(tops, sides, *mkd, jnp.asarray(l1), jnp.asarray(l2))
    ops, n = jtb.traceback_greedy_batch(ref["arrows"], jnp.asarray(l1), jnp.asarray(l2), max_steps=S)
    T = enc.upload(enc.encode_batch(list(pairs), tops.shape[1], sides.shape[1]), "cpu")
    return T, S, np.asarray(ops), np.asarray(n)


def _check(pairs, mkd):
    """The plain run walk over the plain runs fill's bytes equals nw_tpu's
    greedy walk, whole and cut after 1 op and one op short of the longest
    walk.  Returns the loads of the whole walks."""
    T, S, want_ops, want_n = _nw_tpu_walks(tuple(pairs), mkd)
    runs = fill_banded.fill_runs_banded_batch_plain(*T, *mkd)[0]
    ops, n, loads = ttb.walk_runs_loads(runs, *T[2:], S)
    np.testing.assert_array_equal(ops.numpy(), want_ops)
    np.testing.assert_array_equal(n.numpy(), want_n)
    for cut in (1, max(int(want_n.max()) - 1, 1)):
        ops, n = ttb.walk_runs_batch_plain(runs, *T[2:], cut)
        np.testing.assert_array_equal(ops.numpy(), want_ops[:, :cut])
        np.testing.assert_array_equal(n.numpy(), np.minimum(want_n, cut))
    return loads


@pytest.mark.parametrize("mkd", SCORINGS)
@pytest.mark.parametrize("shape", RUNS_WALK_EDGE_SHAPES)
def test_walk_runs_plain_at_edge_shapes(shape, mkd):
    """The shape's pairs in one batch; for "widths" each pair also alone in
    a bucket of its width A + 1."""
    pairs = runs_edge_pairs(shape)
    _check(pairs, mkd)
    if shape == "widths":
        for (s1, s2), w in zip(pairs, RUNS_WIDTHS):
            T = enc.upload(enc.encode_batch([(s1, s2)], w - 1, len(s2)), "cpu")
            assert T[0].shape[1] + 1 == w
            runs = fill_banded.fill_runs_banded_batch_plain(*T, *mkd)[0]
            _, S, want_ops, want_n = _nw_tpu_walks(((s1, s2),), mkd)
            ops, n = ttb.walk_runs_batch_plain(runs, *T[2:], S)
            np.testing.assert_array_equal(ops.numpy(), want_ops)
            np.testing.assert_array_equal(n.numpy(), want_n)


def test_edge_shapes_reach_what_they_name():
    """At 2 1 1 the shapes' walks take the runs they are there for: a
    pure diagonal of 700 cells is 22 loads (a run a band), alternating
    indels load about as often as they step, the boundary pairs walk onto
    row 0 and column 0 with no load there."""
    loads = _check(runs_edge_pairs("diagonals"), (2, 1, 1))
    assert int(loads[0]) == 22 and int(loads[-1]) == 16  # 700 and 500 cells, 32 rows a band
    T, S, _, want_n = _nw_tpu_walks(tuple(runs_edge_pairs("alternating")[:2]), (2, 1, 1))
    loads = _check(runs_edge_pairs("alternating")[:2], (2, 1, 1))
    assert (loads.numpy() * 3 >= 2 * want_n).all()
    loads = _check(runs_edge_pairs("boundary"), (2, 1, 1))
    assert loads[2:4].tolist() == [0, 0]  # a start on row 0, on column 0
