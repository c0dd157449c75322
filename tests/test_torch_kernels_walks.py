"""CUDA kernels of nw_tpu_torch vs their plain PyTorch versions:
the windowed walk over a checkpointed pair, and the runs engine's fill
and walk.

These need an NVIDIA card (sm_90a) and nvcc; without one they skip.  On
the card: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_walks.py``.
Every output is an integer: comparisons are exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from nw_tpu_torch import align_batch
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded, fill_single, traceback

from torch_kernel_cases import (  # noqa: F401 (cuda is a fixture)
    SCORINGS, EDGE, cuda, _pairs, _single_pairs, _pair_tensors, _lens,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("C", [32, 64, 96])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_window_walk_kernel_vs_plain(cuda, mkd, C):
    """The windowed walk, chained over the blocks of one pair, against
    its plain version; and the checkpointed traceback on the card against
    the CPU and against nw_walk over the whole pair's codes."""
    from nw_tpu_torch.ops import checkpoint_traceback as ckt

    for s1, s2 in _single_pairs(sum(mkd) + 8):
        top, side = _pair_tensors(s1, s2)
        S = len(s1) + len(s2)
        ops_k = torch.full((S,), traceback.OP_NONE, dtype=torch.int8, device=cuda)
        ops_p = torch.full((S,), traceback.OP_NONE, dtype=torch.int8)
        st_k = torch.tensor([len(s1), len(s2), 0], dtype=torch.int32, device=cuda)
        st_p = st_k.cpu()
        _, ckpt = fill_single.score_fold_plain(top, side, *mkd, checkpoint_every=C)
        for b in range(ckpt.shape[0] - 1, -1, -1):
            r0, r1 = b * C, min(len(s2), (b + 1) * C)
            codes, _ = fill_single.fill_codes_single_plain(
                top, side, *mkd, len2=r1, r0=r0, seed=ckpt[b] if r0 else None
            )
            traceback.walk_codes_window(codes.to(cuda), st_k, r0, ops_k)
            traceback.walk_codes_window_plain(codes, st_p, r0, ops_p)
            torch.testing.assert_close(st_k.cpu(), st_p, rtol=0, atol=0)
        torch.testing.assert_close(ops_k.cpu(), ops_p, rtol=0, atol=0)
        got = ckt.traceback_checkpointed(top.to(cuda), side.to(cuda), *mkd, block_diagonals=C)
        want = ckt.traceback_checkpointed(top, side, *mkd, block_diagonals=C)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
        assert int(got[1]) == int(want[1])
        codes, _ = fill_single.fill_codes_single(top.to(cuda), side.to(cuda), *mkd)
        ops, n = traceback.walk_codes_batch(codes, _lens(len(s1), cuda), _lens(len(s2), cuda), max(S, 1))
        assert int(n[0]) == int(want[1])
        torch.testing.assert_close(ops[0, :S].cpu(), want[0], rtol=0, atol=0)


def _run_inputs(seed, device):
    # _inputs' pairs plus pure-diagonal runs past the 63 cap and 32-row bands
    base = _pairs(seed + 50, 1, 150, 151)[0][0]
    ps = (_pairs(seed, 12, 0, 140) + _pairs(seed + 1, 6, 20, 70, "AC") + EDGE
          + [(base, base), (base[:64], base[:64]), (base, base[:100]), (base[:90], base)])
    arrays = enc.encode_batch(ps, 160, 160)
    return enc.upload(arrays, "cpu"), enc.upload(arrays, device)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_runs_fill_and_walk_kernels_vs_plain(cuda, mkd, with_counts):
    """nw_fill_runs_batch (K2's with_runs mode) and nw_walk_runs against
    their plain versions; the run walk's ops also against nw_walk's over
    the same pairs' codes."""
    cpu, dev = _run_inputs(sum(mkd) + 30, cuda)
    got = fill_banded.fill_runs_banded_batch(*dev, *mkd, with_counts=with_counts)
    want = fill_banded.fill_runs_banded_batch_plain(*cpu, *mkd, with_counts=with_counts)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    S = 320
    ops, n = traceback.walk_runs_batch(got[0], *dev[2:], S)
    for g, w in zip((ops, n), traceback.walk_runs_batch_plain(want[0], *cpu[2:], S)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    codes = fill_banded.fill_greedy_counts_banded_batch(*dev, *mkd)[0]
    for g, w in zip((ops, n), traceback.walk_codes_batch(codes, *dev[2:], S)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("strings,count", [(True, True), (True, False)])
def test_align_batch_runs_engine_cuda_vs_codes(cuda, monkeypatch, strings, count):
    """align_batch under NW_TPU_WALK_ENGINE=runs on the card: the runs
    kernels launch, and the outputs equal the codes engine's and the CPU's."""
    ps = _pairs(31, 30, 0, 300) + EDGE
    want = align_batch(ps, 2, 1, 1, device="cuda", traceback_strings=strings, count=count)
    monkeypatch.setenv("NW_TPU_WALK_ENGINE", "runs")
    fills, walks = fill_banded.fill_runs_banded_batch.launches, traceback.walk_runs_batch.launches
    got = align_batch(ps, 2, 1, 1, device="cuda", traceback_strings=strings, count=count)
    assert fill_banded.fill_runs_banded_batch.launches == fills + 1
    assert traceback.walk_runs_batch.launches == walks + 1
    cpu = align_batch(ps, 2, 1, 1, device="cpu", traceback_strings=strings, count=count)
    for r in (want, cpu):
        np.testing.assert_array_equal(got.scores, r.scores)
        np.testing.assert_array_equal(got.ops, r.ops)
        np.testing.assert_array_equal(got.ops_len, r.ops_len)
        if count:
            np.testing.assert_array_equal(got.counts, r.counts)
