"""CUDA kernels of nw_tpu_torch vs their plain PyTorch versions:
the single-pair fills (``single_pipe_kernel``'s K8, K14, K11, K12, K9,
K2-one-pair and K10 modes; the grouped re-fill ``nw_refill_blocks``) and
the paths that run them (``align_huge``, small huge batches, Hirschberg).

These need an NVIDIA card (sm_90a) and nvcc; without one they skip.  On
the card: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_single.py``.
Every output is an integer: comparisons are exact (tolerance 0).
"""

import functools

import numpy as np
import pytest
import torch

from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded, fill_single, traceback

from torch_kernel_cases import (  # noqa: F401 (cuda is a fixture)
    SCORINGS, EDGE, cuda, _pairs, _inputs, _single_pairs, _pair_tensors, SHAPES,
    SINGLE_PIPE_SHAPES, PAIR_700, _lens,
)

pytestmark = pytest.mark.cuda


@functools.lru_cache(maxsize=None)
def _plain(name, s1, s2, mkd, *args, **kw):
    """The plain version ``name`` (of fill_single or fill_banded) on the
    pair (s1, s2), once per input: every launch shape of a case is held
    to the same result.  ``seed_every`` = C, with ``r0``, seeds it from
    the pair's plain checkpoint row r0 / C (rows every C)."""
    every = kw.pop("seed_every", None)
    if every is not None:
        kw["seed"] = _plain("score_fold_plain", s1, s2, mkd, checkpoint_every=every)[1][kw["r0"] // every]
    mod = fill_single if hasattr(fill_single, name) else fill_banded
    return getattr(mod, name)(*_pair_tensors(s1, s2), *mkd, *args, **kw)


@pytest.mark.parametrize("blocks,warps", SINGLE_PIPE_SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_score_count_kernel_vs_plain(cuda, mkd, blocks, warps):
    for s1, s2 in _single_pairs(sum(mkd) + 3) + PAIR_700:
        top, side = _pair_tensors(s1, s2)
        got = fill_single.score_count_fold(
            top.to(cuda), side.to(cuda), *mkd, warps=warps, blocks=blocks
        )
        assert got == _plain("score_count_fold_plain", s1, s2, mkd), (s1, s2)


@pytest.mark.parametrize("with_scores", [False, True])
@pytest.mark.parametrize("blocks,warps", SINGLE_PIPE_SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_fill_masks_kernel_vs_plain(cuda, mkd, blocks, warps, with_scores):
    """nw_fill_masks (the single-pair pipeline's masks mode) at every
    shape of the pipeline's tests, the 700 bp pair's 22 bands included."""
    for s1, s2 in _single_pairs(sum(mkd) + 4) + PAIR_700:
        top, side = _pair_tensors(s1, s2)
        got = fill_banded.fill_arrows_banded_single(
            top.to(cuda), side.to(cuda), *mkd, with_scores=with_scores,
            warps=warps, blocks=blocks,
        )
        want = _plain("fill_arrows_banded_single_plain", s1, s2, mkd, with_scores=with_scores)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
        if with_scores:
            torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
        assert got[2:] == want[2:], (s1, s2)


@pytest.mark.parametrize("blocks,warps", [(None, 8), (7, 3), (1, 32), (50, 1), (None, None), (None, 32), (3, 4)])
def test_single_pair_kernels_across_blocks_at_10kb(cuda, blocks, warps):
    """Many blocks, several bands a warp (P = blocks x warps under the
    pair's 94 bands wraps around), against the batch fill (nw_fill_codes
    counts-only) on a 4 000 x 3 000 pair; nw_fill_masks at the same
    shape, and
    nw_fill_codes_single's codes and corner against nw_fill_codes at
    B = 1."""
    s1, s2 = _pairs(99, 1, 4000, 4001)[0][0], _pairs(98, 1, 3000, 3001)[0][0]
    top, side = (t.to(cuda) for t in _pair_tensors(s1, s2))
    lens = (_lens(4000, cuda), _lens(3000, cuda))
    want_sc, want_ct = fill_banded.fill_scores_counts_banded_batch(top[None], side[None], *lens, 2, 1, 1)
    want = (int(want_sc[0]), int(want_ct[0]))
    assert fill_single.score_count_fold(top, side, 2, 1, 1, warps=warps, blocks=blocks) == want
    assert fill_banded.fill_arrows_banded_single(top, side, 2, 1, 1, warps=warps, blocks=blocks)[2:] == want
    codes, score = fill_single.fill_codes_single(top, side, 2, 1, 1, warps=warps, blocks=blocks)
    batch = fill_banded.fill_greedy_counts_banded_batch(top[None], side[None], *lens, 2, 1, 1)
    assert torch.equal(codes, batch[0]) and int(score) == int(batch[1][0]) == want[0]


@pytest.mark.parametrize("blocks,warps", SINGLE_PIPE_SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_codes_single_kernel_vs_plain_and_nw_fill_codes(cuda, mkd, blocks, warps):
    """K14 port: bit-equal to its plain version and to nw_fill_codes at
    B = 1, lengths not multiples of 16 or 32 included; its seeded mode
    (rows r0+1 .. r1 from row r0, r0 > 0) on the 700 bp pair."""
    for s1, s2 in _single_pairs(sum(mkd) + 5) + [(b"ACGTACGTACGTACG", b"A" * 33)] + PAIR_700:
        top, side = _pair_tensors(s1, s2)
        got = fill_single.fill_codes_single(
            top.to(cuda), side.to(cuda), *mkd, warps=warps, blocks=blocks
        )
        want = _plain("fill_codes_single_plain", s1, s2, mkd)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
        assert int(got[1]) == int(want[1]), (s1, s2)
        batch = fill_banded.fill_greedy_counts_banded_batch(
            top.to(cuda)[None], side.to(cuda)[None], _lens(len(s1), cuda),
            _lens(len(s2), cuda), *mkd,
        )
        torch.testing.assert_close(got[0], batch[0], rtol=0, atol=0)
        assert int(got[1]) == int(batch[1][0])
    top, side = _pair_tensors(*PAIR_700[0])
    ck = _plain("score_fold_plain", *PAIR_700[0], mkd, checkpoint_every=224)[1]
    for r in range(1, ck.shape[0]):
        kw = {"len2": min(side.shape[0], 224 * r + 224), "r0": 224 * r}
        got = fill_single.fill_codes_single(
            top.to(cuda), side.to(cuda), *mkd, seed=ck[r].to(cuda), warps=warps, blocks=blocks, **kw
        )
        want = _plain("fill_codes_single_plain", *PAIR_700[0], mkd, seed_every=224, **kw)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
        assert int(got[1]) == int(want[1]), kw


@pytest.mark.parametrize("blocks,warps", SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_seeded_codes_and_checkpoint_kernels_vs_plain(cuda, mkd, blocks, warps):
    """K12 port (checkpoint rows) and K13 port (codes of the rows below a
    seed row) against their plain versions."""
    for s1, s2 in _single_pairs(sum(mkd) + 6):
        top, side = _pair_tensors(s1, s2)
        for every in (32, 64):
            got = fill_single.score_fold(
                top.to(cuda), side.to(cuda), *mkd, checkpoint_every=every,
                warps=warps, blocks=blocks,
            )
            want = _plain("score_fold_plain", s1, s2, mkd, checkpoint_every=every)
            torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
            assert int(got[0]) == int(want[0]), (s1, s2)
            for r in range(1, want[1].shape[0]):
                r0, r1 = r * every, min(len(s2), (r + 1) * every)
                seed = want[1][r]
                g = fill_single.fill_codes_single(
                    top.to(cuda), side.to(cuda), *mkd, len2=r1, r0=r0,
                    seed=seed.to(cuda), warps=warps, blocks=blocks,
                )
                w = _plain("fill_codes_single_plain", s1, s2, mkd, len2=r1, r0=r0, seed_every=every)
                torch.testing.assert_close(g[0].cpu(), w[0], rtol=0, atol=0)
                assert int(g[1]) == int(w[1])


@functools.lru_cache(maxsize=None)
def _refill_plain(s1, s2, mkd, C, lo):
    """fill_codes_blocks_plain of the pair's blocks of C rows from block
    ``lo`` on, from its plain checkpoints, once per input."""
    ck = _plain("score_fold_plain", s1, s2, mkd, checkpoint_every=C)[1]
    return fill_single.fill_codes_blocks_plain(*_pair_tensors(s1, s2), *mkd, len(s1), len(s2), lo * C, C, ck[lo:])


# (blocks, warps) of the grouped re-fill: fewer warps than the group's
# bands (P = 1, 3, 4, 3), blocks of 4 bands sharing 3 ring slots at P = 3;
# the default, a warp a band
REFILL_SHAPES = [(1, 1), (1, 3), (2, 2), (3, 1), (None, 8)]


@pytest.mark.parametrize("blocks,warps", REFILL_SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_grouped_refill_kernel_vs_plain(cuda, mkd, blocks, warps):
    """K13's grouped port (nw_refill_blocks): groups of blocks from the
    first block and from the second on, short last blocks included,
    against the plain version and, block by block, against the one-block
    launches of nw_fill_codes_single."""
    for s1, s2 in _single_pairs(sum(mkd) + 10) + [(b"ACGTT" * 60, b"GATTACA" * 50)]:
        if not s2:
            continue
        top, side = _pair_tensors(s1, s2)
        tc, sc = top.to(cuda), side.to(cuda)
        la, lb = len(s1), len(s2)
        for C in (32, 64, 128):
            _, ck = _plain("score_fold_plain", s1, s2, mkd, checkpoint_every=C)
            for lo in range(min(2, ck.shape[0])):
                got = fill_single.fill_codes_blocks(
                    tc, sc, *mkd, la, lb, lo * C, C, ck[lo:].to(cuda), warps=warps, blocks=blocks
                )
                want = _refill_plain(s1, s2, mkd, C, lo)
                torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
                torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
                for g in range(ck.shape[0] - lo):
                    r0 = (lo + g) * C
                    one, corner = fill_single.fill_codes_single(
                        tc, sc, *mkd, len2=min(lb, r0 + C), r0=r0,
                        seed=ck[lo + g].to(cuda) if r0 else None,
                    )
                    first = g * C // 32
                    torch.testing.assert_close(got[0][:, first : first + one.shape[1]], one, rtol=0, atol=0)
                    assert int(got[1][g]) == int(corner)


@pytest.mark.parametrize("blocks,warps", SINGLE_PIPE_SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_score_single_kernel_vs_plain(cuda, mkd, blocks, warps):
    """K11 port: the score alone, at every shape of the pipeline's tests."""
    for s1, s2 in _single_pairs(sum(mkd) + 7) + PAIR_700:
        top, side = _pair_tensors(s1, s2)
        got = fill_single.score_fold(top.to(cuda), side.to(cuda), *mkd, warps=warps, blocks=blocks)
        assert got[1] is None
        assert int(got[0]) == int(_plain("score_fold_plain", s1, s2, mkd)[0]), (s1, s2)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_align_huge_and_small_huge_batches_cuda_vs_cpu(cuda, monkeypatch, mkd):
    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.models import needleman_wunsch as model
    from nw_tpu_torch.ops import fill_auto

    cfg = AlignConfig(scoring=ScoringParams(*mkd))
    on_card, on_cpu = NWAligner(cfg, device="cuda"), NWAligner(cfg, device="cpu")
    pairs = _pairs(sum(mkd) + 9, 3, 0, 300) + EDGE
    for s1, s2 in pairs:
        strings = on_cpu.align_huge(s1, s2)
        for bd in (None, 32, 96):
            want = on_cpu.align_huge(s1, s2, block_diagonals=bd)
            assert on_card.align_huge(s1, s2, block_diagonals=bd) == want, (s1, s2, bd)
            # the routes share the alignment; where int32 wraps their scores
            # differ (the checkpointed route re-scores in Python ints)
            assert (want.X, want.Y) == (strings.X, strings.Y), (s1, s2, bd)
    monkeypatch.setattr(model, "HUGE_PAIR_MIN_SIDE", 64)
    monkeypatch.setattr(fill_auto, "SINGLE_PAIR_MIN_SIDE", 64)
    monkeypatch.setattr(fill_auto, "SINGLE_PAIR_SIDE_PER_PAIR", 1)
    for strings, count in [(False, False), (True, False), (True, True), (False, True)]:
        got = on_card.align_batch(pairs, traceback_strings=strings, count=count)
        want = on_cpu.align_batch(pairs, traceback_strings=strings, count=count)
        np.testing.assert_array_equal(got.scores, want.scores)
        if count:
            np.testing.assert_array_equal(got.counts, want.counts)
        if strings:
            assert got.alignment_strings() == want.alignment_strings()


def test_single_pair_code_kernels_across_blocks_at_4kb(cuda):
    """Many blocks, several bands a warp: the K14 port against
    nw_fill_codes, K11 / K12 against nw_score_count and each other, and
    both routes of the traceback against each other, on a 4 000 x 3 000
    pair."""
    from nw_tpu_torch.ops import checkpoint_traceback as ckt

    s1, s2 = _pairs(97, 1, 4000, 4001)[0][0], _pairs(96, 1, 3000, 3001)[0][0]
    top, side = (t.to(cuda) for t in _pair_tensors(s1, s2))
    want = fill_banded.fill_greedy_counts_banded_batch(
        top[None], side[None], _lens(4000, cuda), _lens(3000, cuda), 2, 1, 1
    )
    sc, _ = fill_single.score_count_fold(top, side, 2, 1, 1)
    ops_w, n_w = traceback.walk_codes_batch(want[0], _lens(4000, cuda), _lens(3000, cuda), 7000)
    for blocks, warps in [(None, 8), (7, 3), (1, 32), (50, 1)]:
        codes, score = fill_single.fill_codes_single(top, side, 2, 1, 1, warps=warps, blocks=blocks)
        torch.testing.assert_close(codes, want[0], rtol=0, atol=0)
        assert int(score) == int(want[1][0]) == sc
        s, ck = fill_single.score_fold(top, side, 2, 1, 1, checkpoint_every=320, warps=warps, blocks=blocks)
        assert int(s) == sc and int(fill_single.score_fold(top, side, 2, 1, 1)[0]) == sc
        ops, n = ckt.traceback_checkpointed(top, side, 2, 1, 1, block_diagonals=320)
        assert int(n) == int(n_w[0])
        torch.testing.assert_close(ops, ops_w[0], rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_fold_masks_kernel_vs_plain(cuda, mkd):
    """K10's port (nw_fill_masks a pair at a time into the batch's
    table) against its plain version and the batched masks."""
    cpu, dev = _inputs(sum(mkd) + 21, cuda)
    want = fill_single.fill_arrows_fold_batch_plain(*cpu, *mkd)
    batched = fill_banded.fill_masks_banded_batch(*dev, *mkd, with_counts=True)
    for blocks, warps in [(1, 1), (3, 1), (None, 8), (None, None), (2, 3), (None, 32)]:
        got = fill_single.fill_arrows_fold_batch(*dev, *mkd, warps=warps, blocks=blocks)
        for g, w, b in zip(got, want, batched):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
            torch.testing.assert_close(g, b, rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_last_row_kernel_vs_plain(cuda, mkd):
    """nw_last_row (K9's port) at rows 0, len2 / 3 and len2 against
    the plain fill's rows, at several shapes, the rule's and wrapping
    blocks included."""
    from nw_tpu_torch.ops.fill_scan import diag_to_matrix, fill_diag

    for s1, s2 in _single_pairs(sum(mkd) + 22):
        top, side = _pair_tensors(s1, s2)
        H = diag_to_matrix(fill_diag(top, side, *mkd, with_arrows=False, with_scores=True)["scores"],
                           len(s1), len(s2))
        for len2 in sorted({0, len(s2) // 3, len(s2)}):
            for blocks, warps in [(1, 1), (2, 2), (None, 8), (None, None), (2, 3), (None, 32)]:
                got = fill_single.last_row(top.to(cuda), side.to(cuda), *mkd, len2=len2,
                                           warps=warps, blocks=blocks)
                torch.testing.assert_close(got.cpu(), H[len2], rtol=0, atol=0)


def _rows_and_masks_vs_table(cuda, pairs, shapes, mkd, cuts=(32, 224)):
    """K11, K12 (every C of ``cuts``), K9 (rows 0, len2 / 3, len2),
    nw_fill_masks (with and without scores) and K10 (into a bucket wider
    than the pairs: rows of ldm > A+1 bytes) on ``pairs`` at every
    (blocks, warps) of ``shapes``, against the plain versions' body (the
    anti-diagonal fill with scores and counts of every pair at once, on
    the CPU)."""
    from nw_tpu_torch.ops.fill_scan import diag_to_matrix, fill_diag_batch

    A, B = max(len(a) for a, _ in pairs) + 7, max(len(b) for _, b in pairs)
    arrays = enc.encode_batch(pairs, A, B)
    cpu, dev = enc.upload(arrays, "cpu"), enc.upload(arrays, cuda)
    ref = fill_diag_batch(*cpu, *mkd, with_counts=True, with_scores=True)
    for b, (s1, s2) in enumerate(pairs):
        la, lb = len(s1), len(s2)
        t, s = dev[0][b, :la], dev[1][b, :lb]
        masks = diag_to_matrix(ref["arrows"][b], la, lb)
        hs = diag_to_matrix(ref["scores"][b], la, lb)
        want = (int(ref["score"][b]), int(ref["count"][b]))
        for blocks, warps in shapes:
            kw = {"warps": warps, "blocks": blocks}
            msg = f"{la} x {lb}, blocks {blocks}, warps {warps}"
            assert int(fill_single.score_fold(t, s, *mkd, **kw)[0]) == want[0], msg
            for C in cuts:
                sc, ck = fill_single.score_fold(t, s, *mkd, checkpoint_every=C, **kw)
                assert int(sc) == want[0], msg
                torch.testing.assert_close(ck.cpu(), hs[0:lb:C], rtol=0, atol=0, msg=f"{msg}, C {C}")
            for j in sorted({0, lb // 3, lb}):
                row = fill_single.last_row(t, s, *mkd, len2=j, **kw)
                torch.testing.assert_close(row.cpu(), hs[j], rtol=0, atol=0, msg=f"{msg}, row {j}")
            for with_scores in (False, True):
                got = fill_banded.fill_arrows_banded_single(t, s, *mkd, with_scores=with_scores, **kw)
                torch.testing.assert_close(got[0].cpu(), masks, rtol=0, atol=0, msg=msg)
                if with_scores:
                    torch.testing.assert_close(got[1].cpu(), hs, rtol=0, atol=0, msg=msg)
                assert got[2:] == want, msg
    want = fill_single.fill_arrows_fold_batch_plain(*cpu, *mkd)
    for blocks, warps in shapes:
        for g, w in zip(fill_single.fill_arrows_fold_batch(*dev, *mkd, warps=warps, blocks=blocks), want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0, msg=f"K10, blocks {blocks}, warps {warps}")


@pytest.mark.parametrize("mkd", SCORINGS)
def test_rows_and_masks_modes_at_every_warp(cuda, mkd):
    """The single-pair pipeline's rows (K11, K12, K9) and masks (K2 for
    one pair, K10) modes at every W of 1 .. 32 with blocks by the rule,
    at the rule's shape and at 2 blocks of 3 warps (the 700 bp pair's 22
    bands wrap around to block 0), on the 700 bp pair, a tie-dense pair,
    all-'A' 24 x 16 (the count wraps) and the edge pairs; the plain
    wrappers themselves on the 700 bp pair at the rule's shape."""
    pairs = PAIR_700 + _pairs(sum(mkd) + 33, 1, 300, 400, "AC") + [(b"A" * 24, b"A" * 16)] + EDGE
    shapes = [(None, w) for w in range(1, 33)] + [(None, None), (2, 3)]
    _rows_and_masks_vs_table(cuda, pairs, shapes, mkd)
    top, side = _pair_tensors(*PAIR_700[0])
    tc, sc = top.to(cuda), side.to(cuda)
    for C in (None, 224):
        got, want = fill_single.score_fold(tc, sc, *mkd, checkpoint_every=C), fill_single.score_fold_plain(
            top, side, *mkd, checkpoint_every=C)
        assert int(got[0]) == int(want[0]) and (C is None or torch.equal(got[1].cpu(), want[1]))
    torch.testing.assert_close(fill_single.last_row(tc, sc, *mkd).cpu(), fill_single.last_row_plain(top, side, *mkd),
                               rtol=0, atol=0)
    got = fill_banded.fill_arrows_banded_single(tc, sc, *mkd, with_scores=True)
    want = fill_banded.fill_arrows_banded_single_plain(top, side, *mkd, with_scores=True)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    assert got[2:] == want[2:]


# sides one short of, on and one past 32 W (W = 2, 3), 32 G W (G = 2, W =
# 3) and r C rows (C = 32, 224, 1 280; r = 1, 2) under a 75 bp top
CUT_SIDES = sorted({63, 64, 65, 95, 96, 97, 191, 192, 193}
                   | {r * C + e for C in (32, 224, 1280) for r in (1, 2) for e in (-1, 0, 1)})
CUT_SHAPES = [(None, None), (None, 1), (None, 2), (None, 3), (2, 3), (None, 32)]


@pytest.mark.parametrize("mkd", SCORINGS)
def test_rows_and_masks_modes_at_the_cuts(cuda, mkd):
    """The rows and masks modes on sides at the pipeline's cuts (the band
    that wraps to block 0, the last band's row Bs) and K12's (a
    checkpoint row one short of, on and one past the last row), with
    checkpoints every 32, 224 and 1 280 rows."""
    rng = np.random.default_rng(sum(mkd) + 34)
    letters = np.frombuffer(b"ACGT", np.uint8)
    top = letters[rng.integers(0, 4, 75)].tobytes()
    pairs = [(top, letters[rng.integers(0, 4, n)].tobytes()) for n in CUT_SIDES]
    _rows_and_masks_vs_table(cuda, pairs, CUT_SHAPES, mkd, cuts=(32, 224, 1280))


def test_rows_and_masks_modes_with_the_top_in_device_memory(cuda):
    """A top past shared memory (117 000 columns): nw_fill_masks against
    nw_fill_masks_batch at B = 1 (masks, score, count), K12's rows and
    K9's rows against nw_fill_masks's scores table, K11 against nw_scores,
    at W = 1, 3, 32 and the rule's, under 2 1 1 and a wrapping scoring."""
    rng = np.random.default_rng(35)
    letters = np.frombuffer(b"ACGT", np.uint8)
    A, Bs = 117_000, 200
    pair = (letters[rng.integers(0, 4, A)].tobytes(), letters[rng.integers(0, 4, Bs)].tobytes())
    T = enc.upload(enc.encode_batch([pair], A, Bs), cuda)
    t, s = T[0][0], T[1][0]
    assert not fill_banded.top_in_smem(A, 4) and not fill_banded.top_in_smem(A, 8)
    for mkd in [(2, 1, 1), (1, 1, 2**30)]:
        masks, score, count = fill_banded.fill_masks_banded_batch(*T, *mkd, with_counts=True)
        assert int(fill_banded.fill_scores_banded_batch(*T, *mkd)[0]) == int(score[0])
        for warps in (1, 3, 32, None):
            got = fill_banded.fill_arrows_banded_single(t, s, *mkd, with_scores=True, warps=warps)
            assert torch.equal(got[0], masks[0]) and got[2:] == (int(score[0]), int(count[0])), warps
            hs = got[1]
            sc, ck = fill_single.score_fold(t, s, *mkd, checkpoint_every=32, warps=warps)
            assert int(sc) == int(score[0]) and torch.equal(ck, hs[0:Bs:32]), warps
            assert int(fill_single.score_fold(t, s, *mkd, warps=warps)[0]) == int(score[0])
            for j in (0, 64, 131, Bs):
                assert torch.equal(fill_single.last_row(t, s, *mkd, len2=j, warps=warps), hs[j]), (warps, j)


@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 1, 2**30)])
def test_hirschberg_cuda_vs_cpu(cuda, mkd):
    from nw_tpu_torch.ops.hirschberg import hirschberg_align

    for s1, s2 in _pairs(sum(mkd) + 23, 2, 300, 900) + _pairs(24, 1, 200, 400, "AC"):
        try:
            want = hirschberg_align(s1, s2, *mkd, device="cpu")
        except OverflowError:  # nw_tpu's int32 host rows at large scorings
            with pytest.raises(OverflowError):
                hirschberg_align(s1, s2, *mkd, device="cuda")
            continue
        assert hirschberg_align(s1, s2, *mkd, device="cuda") == want
