"""CUDA kernels of nw_tpu_torch vs their plain PyTorch versions:
the code walks (``nw_walk``, the windowed walk over a checkpointed pair),
the tie-mask walks (``nw_walk_masks``, ``nw_walk_window``'s masks mode)
and the run-skip walk (``nw_walk_runs``) at the shapes their
shared-memory staging must get right, and the runs engine's fill and
walk.

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
    SCORINGS, EDGE, MASK_STRIDES, MASK_WALK_EDGE_SHAPES, RUNS_WALK_EDGE_SHAPES, RUNS_WIDTHS, WALK_EDGE_SHAPES,
    cuda, _pairs, _single_pairs, runs_edge_pairs,
    _pair_tensors, _lens, mask_edge_pairs, _mask_window_chain, random_masks, _walk_chain,
    walk_edge_pairs, _window_chain, BYTE_WARPS, _byte_batches, _byte_fill, _byte_plain,
    _bytes_with_the_top_in_device_memory, GROUP_SIZES, groups_walk,
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
    T, S = _batch(walk_edge_pairs(shape), cuda)
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
        for s1, s2 in walk_edge_pairs(shape):
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
    s1, s2 = walk_edge_pairs("band_edges")[4]
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


def _mask_batches(shape, device):
    """(tensors on ``device``, S) of the shape's pairs: one batch, or for
    "strides" one a bucket width A + 1 of 129 .. 144."""
    ps = mask_edge_pairs(shape)
    L1, L2 = max(len(a) for a, _ in ps), max(len(b) for _, b in ps)
    widths = [128 + e for e in MASK_STRIDES] if shape == "strides" else [max(L1, 1)]
    return [(enc.upload(enc.encode_batch(ps, A, max(L2, 1)), device), A + L2) for A in widths]


def _masks_vs_plain(masks, lens1, lens2, S):
    want = traceback.walk_masks_batch_plain(masks, lens1, lens2, S)
    for g, w in zip(traceback.walk_masks_batch(masks, lens1, lens2, S), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("shape", MASK_WALK_EDGE_SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_mask_walk_kernel_vs_plain_at_edge_shapes(cuda, mkd, shape):
    """nw_walk_masks against its plain version over the batched masks
    fill's tables, whole, at B = 1 and cut after 1 and 77 ops (for
    "strides" at every row width A + 1 of 129 .. 144): tolerance 0 on ops
    and n."""
    for T, S in _mask_batches(shape, cuda):
        masks = fill_banded.fill_masks_banded_batch(*T, *mkd)[0]
        for cut in (S, 1, 77):
            _masks_vs_plain(masks, *T[2:], cut)
        _masks_vs_plain(masks[:1], *(x[:1] for x in T[2:]), S)


def test_mask_walk_kernel_many_short_pairs_and_random_bytes(cuda):
    """5 000 short pairs (more walks than 132 SMs x the warps a block hold
    at once) under four scorings, and tables of random bytes (every bit
    pattern, row 0 LEFT, column 0 UP) at widths 113 .. 128."""
    T, S = _batch(_pairs(5001, 5000, 0, 60), cuda)
    for mkd in SCORINGS[:4]:
        _masks_vs_plain(fill_banded.fill_masks_banded_batch(*T, *mkd)[0], *T[2:], S)
    for M in range(113, 129):
        masks = random_masks(np.random.default_rng(M), 3, 200, M).to(cuda)
        l1 = torch.tensor([M - 1, M - 7, 40], dtype=torch.int32, device=cuda)
        l2 = torch.tensor([199, 161, 96], dtype=torch.int32, device=cuda)
        _masks_vs_plain(masks, l1, l2, 200 + M)


def _mask_chain_vs_plain(masks, len1, len2, C):
    """nw_walk_window's masks mode chained over blocks of C rows of one
    pair's masks (rows as views: any alignment) against its plain version:
    the state after every block and the ops, tolerance 0."""
    st_k = torch.tensor([len1, len2, 0], dtype=torch.int32, device=masks.device)
    st_p = st_k.cpu()
    ops_k = torch.full((len1 + len2,), traceback.OP_NONE, dtype=torch.int8, device=masks.device)
    ops_p = ops_k.cpu()
    for r0, rows in _mask_window_chain(masks, C):
        traceback.walk_masks_window(rows, st_k, r0, ops_k)
        traceback.walk_masks_window_plain(rows.cpu(), st_p, r0, ops_p)
        torch.testing.assert_close(st_k.cpu(), st_p, rtol=0, atol=0)
    torch.testing.assert_close(ops_k.cpu(), ops_p, rtol=0, atol=0)
    assert st_p[:2].tolist() == [0, 0]


@pytest.mark.parametrize("C", [32, 64, 96])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_mask_window_kernel_vs_plain_at_edge_shapes(cuda, mkd, C):
    """nw_walk_window's masks mode chained over blocks of C rows down to
    row 0 at the masks edge shapes (rows of len1 + 1 bytes: "strides"
    takes every offset mod 16) and over a table of random bytes."""
    for shape in MASK_WALK_EDGE_SHAPES:
        for s1, s2 in mask_edge_pairs(shape):
            if not s2:
                continue
            T = enc.upload(enc.encode_batch([(s1, s2)], max(len(s1), 1), len(s2)), cuda)
            masks = fill_banded.fill_masks_banded_batch(*T, *mkd)[0][0, :, : len(s1) + 1].contiguous()
            _mask_chain_vs_plain(masks, len(s1), len(s2), C)
    _mask_chain_vs_plain(random_masks(np.random.default_rng(C), 1, 301, 117)[0].to(cuda), 116, 300, C)


def test_mask_window_kernel_start_outside_block(cuda):
    """A start outside a block's rows or columns (or with n < 0) leaves the
    state and ops as they were, as the plain version does."""
    s1, s2 = mask_edge_pairs("band_edges")[4]
    T = enc.upload(enc.encode_batch([(s1, s2)], len(s1), len(s2)), cuda)
    masks = fill_banded.fill_masks_banded_batch(*T, 2, 1, 1)[0][0]
    for r0, rows in _mask_window_chain(masks, 64):
        for start in ([len(s1), r0 + rows.shape[0] + 1, 0], [len(s1) + 1, r0 + 1, 0], [-1, r0 + 1, 0],
                      [0, r0 - 1, 0], [len(s1), r0 + 1, -1]):
            for walk, where in ((traceback.walk_masks_window, cuda), (traceback.walk_masks_window_plain, "cpu")):
                state = torch.tensor(start, dtype=torch.int32, device=where)
                ops = torch.full((8,), traceback.OP_NONE, dtype=torch.int8, device=where)
                walk(rows.to(where), state, r0, ops)
                assert state.tolist() == start
                assert ops.tolist() == [traceback.OP_NONE] * 8


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


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_runs_pipeline_at_forced_warps_vs_plain(cuda, mkd, with_counts):
    """nw_fill_runs_batch (the pipeline's RUNS mode) at W = 1, 2, 3, 7,
    16, 31, 32 warps a pair and the rule's, bit for bit against the plain
    version (an odd B, B = 1, 5 and 35 bands, diagonals past the cap
    across bands); the rule's run bytes walked by nw_walk_runs as the
    plain walk does."""
    for cpu, dev in _byte_batches(sum(mkd) + 50, cuda):
        want = _byte_plain("runs", cpu, mkd, with_counts)
        for warps in BYTE_WARPS:
            got = _byte_fill("runs", dev, mkd, with_counts, warps)
            assert len(got) == len(want) == 2 + with_counts
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0, msg=f"W = {warps}")
        S = cpu[0].shape[1] + cpu[1].shape[1]
        for g, w in zip(traceback.walk_runs_batch(got[0], *dev[2:], S),
                        traceback.walk_runs_batch_plain(want[0], *cpu[2:], S)):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


def test_runs_pipeline_with_the_top_in_device_memory(cuda):
    _bytes_with_the_top_in_device_memory("runs", cuda)


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


def _runs_vs_plain(table, lens1, lens2, S):
    """nw_walk_runs over a run table on the card against its plain version
    on the CPU: tolerance 0 on ops and n."""
    want = traceback.walk_runs_batch_plain(table.cpu(), lens1.cpu(), lens2.cpu(), S)
    for g, w in zip(traceback.walk_runs_batch(table, lens1, lens2, S), want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    return want


@pytest.mark.parametrize("shape", RUNS_WALK_EDGE_SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_runs_walk_kernel_vs_plain_at_edge_shapes(cuda, mkd, shape):
    """nw_walk_runs (walk_masks_staged's runs mode) against its plain
    version over the runs fill's tables at the run walk's edge shapes: the
    shape's batch whole, cut after 1 and 77 ops and one op short of its
    longest walk, at B = 1 and at an odd B; for "widths" each pair also
    alone in a bucket of its width A + 1 (``RUNS_WIDTHS``)."""
    ps = runs_edge_pairs(shape)
    T, S = _batch(ps, cuda)
    table = fill_banded.fill_runs_banded_batch(*T, *mkd)[0]
    longest = int(_runs_vs_plain(table, *T[2:], S)[1].max())
    for cut in (1, 77, max(longest - 1, 1)):
        _runs_vs_plain(table, *T[2:], cut)
    for B in (1, len(ps) - 1 + len(ps) % 2):
        _runs_vs_plain(table[:B], *(x[:B] for x in T[2:]), S)
    if shape == "widths":
        for (s1, s2), w in zip(ps, RUNS_WIDTHS):
            assert len(s1) + 1 == w
            T1, S1 = _batch([(s1, s2)], cuda)
            _runs_vs_plain(fill_banded.fill_runs_banded_batch(*T1, *mkd)[0], *T1[2:], S1)


def test_runs_walk_kernel_many_short_pairs(cuda):
    """5 000 short pairs (more walks than 132 SMs x the walks a block hold
    at once) under every scoring, whole and cut after 40 ops."""
    T, S = _batch(_pairs(5002, 5000, 0, 60), cuda)
    for mkd in SCORINGS:
        table = fill_banded.fill_runs_banded_batch(*T, *mkd)[0]
        for cut in (S, 40):
            _runs_vs_plain(table, *T[2:], cut)


# ---------------- nw_walk_groups: the two-pass engines' group walk ----------------


@pytest.mark.parametrize("shape", WALK_EDGE_SHAPES)
def test_walk_groups_vs_plain_at_edge_shapes(cuda, shape):
    """nw_walk_groups chained over groups of 1, 2 and 3 bands of each walk
    edge shape's codes, last group first (the shape's pairs, an odd B, and
    its first pair alone, B = 1), ops in place and as per-group prefixes
    stitched on the host, against its plain version and nw_walk's plain
    walk, under 2 1 1 and two wrapping scorings."""
    ps = walk_edge_pairs(shape)
    assert len(ps) % 2 == 1
    T, S = _batch(ps, "cpu")
    for mkd in (SCORINGS[0], SCORINGS[4], SCORINGS[6]):
        codes = fill_banded.fill_greedy_counts_banded_batch(*T, *mkd)[0]
        for B in (len(ps), 1):
            c, l1, l2 = codes[:B], T[2][:B], T[3][:B]
            want = traceback.walk_codes_batch_plain(c, l1, l2, S)
            dc, d1, d2 = c.to(cuda), l1.to(cuda), l2.to(cuda)
            for G in GROUP_SIZES:
                p_state, p_ops = groups_walk(traceback.walk_codes_groups_plain, c, l1, l2, G, S)
                g_state, g_ops = groups_walk(traceback.walk_codes_groups, dc, d1, d2, G, S)
                torch.testing.assert_close(g_state.cpu(), p_state, rtol=0, atol=0)
                torch.testing.assert_close(g_ops.cpu(), p_ops, rtol=0, atol=0)
                torch.testing.assert_close(g_ops.cpu(), want[0], rtol=0, atol=0)
                torch.testing.assert_close(g_state[:, 2].cpu(), want[1], rtol=0, atol=0)
                _, h_ops = groups_walk(traceback.walk_codes_groups, dc, d1, d2, G, S, prefixes=True)
                torch.testing.assert_close(h_ops, want[0], rtol=0, atol=0)


def test_walk_groups_starts_outside_and_limits(cuda):
    """Starts outside a group's rows (above its top row, below its bottom)
    or columns leave the state and ops as they were; a walk stops after
    stride - off ops, its ops at off; equal to the plain version."""
    s1, s2 = walk_edge_pairs("band_edges")[4]  # 100 x 64: a corner on a band edge
    T, S = _batch([(s1, s2)] * 3, "cpu")
    codes = fill_banded.fill_greedy_counts_banded_batch(*T, 2, 1, 1)[0]  # 2 bands
    part = codes[:, 1:].contiguous()
    TW = codes.shape[2]
    starts = torch.tensor([[5, 70, 0], [5, 31, 0], [16 * TW - 31, 40, 0]], dtype=torch.int32)
    for off in (None, torch.tensor([0, 3, 7], dtype=torch.int32)):
        st_p, st_k = starts.clone(), starts.clone().to(cuda)
        ops_p = torch.full((3, 12), 3, dtype=torch.int8)
        ops_k = ops_p.to(cuda)
        traceback.walk_codes_groups_plain(part, st_p, 32, ops_p, off)
        traceback.walk_codes_groups(part.to(cuda), st_k, 32, ops_k, None if off is None else off.to(cuda))
        assert torch.equal(st_p, starts) and (ops_p == 3).all()
        assert torch.equal(st_k.cpu(), st_p) and torch.equal(ops_k.cpu(), ops_p)
    # from the corner with 12-wide rows: cut after 12 - off ops
    full = torch.stack([T[2], T[3], torch.zeros_like(T[2])], 1).contiguous()
    off = torch.tensor([0, 5, 12], dtype=torch.int32)
    st_p, ops_p = full.clone(), torch.full((3, 12), 3, dtype=torch.int8)
    st_k, ops_k = full.clone().to(cuda), ops_p.to(cuda)
    traceback.walk_codes_groups_plain(codes, st_p, 0, ops_p, off)
    traceback.walk_codes_groups(codes.to(cuda), st_k, 0, ops_k, off.to(cuda))
    assert st_p[:, 2].tolist() == [12, 7, 0]
    assert torch.equal(st_k.cpu(), st_p) and torch.equal(ops_k.cpu(), ops_p)
