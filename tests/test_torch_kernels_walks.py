"""CUDA kernels of nw_tpu_torch vs their plain PyTorch versions:
the code walks (``nw_walk``, the windowed walk over a checkpointed pair)
at the shapes their shared-memory staging must get right, and the runs
engine's fill and walk.

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
    SCORINGS, EDGE, WALK_EDGE_SHAPES, cuda, _pairs, _single_pairs, _pair_tensors, _lens,
    _walk_edge_pairs, _window_chain,
)

pytestmark = pytest.mark.cuda

def _batch(ps, device):
    L1, L2 = max(len(a) for a, _ in ps), max(len(b) for _, b in ps)
    arrays = enc.encode_batch(ps, max(L1, 1), max(L2, 1))
    return enc.upload(arrays, device), L1 + L2


@pytest.mark.parametrize("shape", WALK_EDGE_SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_walk_kernel_vs_plain_at_edge_shapes(cuda, mkd, shape):
    """nw_walk against its plain version, whole, at B = 1 and cut after 1
    and 77 ops: tolerance 0 on ops and n."""
    T, S = _batch(_walk_edge_pairs(shape), cuda)
    codes = fill_banded.fill_greedy_counts_banded_batch(*T, *mkd)[0]
    for TT, cut in ((T, S), (tuple(x[:1] for x in T), S), (T, 1), (T, 77)):
        want = traceback.walk_codes_batch_plain(codes[: TT[0].shape[0]], *TT[2:], max(cut, 1))
        got = traceback.walk_codes_batch(codes[: TT[0].shape[0]], *TT[2:], max(cut, 1))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_walk_kernel_many_short_pairs(cuda):
    """5 000 short pairs: more walks than 132 SMs hold at once."""
    T, S = _batch(_pairs(5000, 5000, 0, 60), cuda)
    for mkd in SCORINGS[:4]:
        codes = fill_banded.fill_greedy_counts_banded_batch(*T, *mkd)[0]
        want = traceback.walk_codes_batch_plain(codes, *T[2:], S)
        for g, w in zip(traceback.walk_codes_batch(codes, *T[2:], S), want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("C", [32, 64, 96])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_window_walk_kernel_vs_plain_at_edge_shapes(cuda, mkd, C):
    """nw_walk_window chained over blocks of C rows down to row 0 at the
    walk edge shapes against its plain version: tolerance 0 on ops and
    the state after every block."""
    for shape in WALK_EDGE_SHAPES:
        for s1, s2 in _walk_edge_pairs(shape):
            if not s2:
                continue
            chain = _window_chain(s1, s2, mkd, C, fill_single.fill_codes_single, fill_single.score_fold, cuda)
            st_k = torch.tensor([len(s1), len(s2), 0], dtype=torch.int32, device=cuda)
            st_p = st_k.clone()
            ops_k = torch.full((len(s1) + len(s2),), traceback.OP_NONE, dtype=torch.int8, device=cuda)
            ops_p = ops_k.clone()
            for r0, codes in chain:
                traceback.walk_codes_window(codes, st_k, r0, ops_k)
                traceback.walk_codes_window_plain(codes, st_p, r0, ops_p)
                torch.testing.assert_close(st_k, st_p, rtol=0, atol=0)
            torch.testing.assert_close(ops_k, ops_p, rtol=0, atol=0)
            assert st_k[:2].tolist() == [0, 0]


def test_window_walk_kernel_start_outside_block(cuda):
    """A start outside a block's rows or columns (or with n < 0) leaves the
    state and ops as they were, as the plain version does."""
    s1, s2 = _walk_edge_pairs("band_edges")[4]
    chain = _window_chain(s1, s2, (2, 1, 1), 64, fill_single.fill_codes_single, fill_single.score_fold, cuda)
    for r0, codes in chain:
        for start in ([len(s1), r0 + 32 * codes.shape[1] + 1, 0], [16 * codes.shape[2] - 31, r0 + 1, 0],
                      [0, r0 - 1, 0], [len(s1), r0 + 1, -1]):
            state = torch.tensor(start, dtype=torch.int32, device=cuda)
            ops = torch.full((8,), traceback.OP_NONE, dtype=torch.int8, device=cuda)
            traceback.walk_codes_window(codes, state, r0, ops)
            assert state.tolist() == start
            assert ops.tolist() == [traceback.OP_NONE] * 8


def test_walk_kernels_refuse_misaligned_codes(cuda):
    """The bulk copies need 16-byte aligned codes: a table starting 4 bytes
    in is refused, not read."""
    flat = torch.zeros(1 + 2 * 32, dtype=torch.int32, device=cuda)
    codes = flat[1:].view(1, 1, 2, 32)
    lens = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        traceback.walk_codes_batch(codes, lens, lens, 4)
    with pytest.raises(ValueError, match="16-byte"):
        traceback.walk_codes_window(codes, torch.zeros(3, dtype=torch.int32, device=cuda), 0,
                                    torch.zeros(4, dtype=torch.int8, device=cuda))


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
