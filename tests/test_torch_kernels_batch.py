"""CUDA kernels of nw_tpu_torch vs their plain PyTorch versions:
the batched Needleman-Wunsch fills (the W-warp pipeline, the tie-mask
batch kernel, the count, the flat API) and their routes
through ``align_batch`` and the CLI.

These need an NVIDIA card (sm_90a) and nvcc; without one they skip.  On
the card: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_batch.py``.
Every output is an integer: comparisons are exact (tolerance 0).
"""

import io

import numpy as np
import pytest
import torch

from nw_tpu_torch import align_batch, cli
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded, fill_single, traceback

from torch_kernel_cases import (  # noqa: F401 (cuda is a fixture)
    SCORINGS, EDGE, cuda, _pairs, _inputs, PIPE_WARPS, _pipe_batches, _pipe_fill, _pipe_plain,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("mkd", SCORINGS)
def test_scores_kernel_vs_plain(cuda, mkd):
    cpu, dev = _inputs(sum(mkd), cuda)
    got = fill_banded.fill_scores_banded_batch(*dev, *mkd)
    want = fill_banded.fill_scores_banded_batch_plain(*cpu, *mkd)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_counts_kernel_vs_plain(cuda, mkd):
    cpu, dev = _inputs(sum(mkd) + 1, cuda)
    got = fill_banded.fill_scores_counts_banded_batch(*dev, *mkd)
    want = fill_banded.fill_scores_counts_banded_batch_plain(*cpu, *mkd)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_codes_and_walk_kernels_vs_plain(cuda, mkd, with_counts):
    cpu, dev = _inputs(sum(mkd) + 2, cuda)
    got = fill_banded.fill_greedy_counts_banded_batch(*dev, *mkd, with_counts=with_counts)
    want = fill_banded.fill_greedy_counts_banded_batch_plain(
        *cpu, *mkd, with_counts=with_counts
    )
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    S = 160 + 144
    g_ops, g_n = traceback.walk_codes_batch(got[0], dev[2], dev[3], S)
    w_ops, w_n = traceback.walk_codes_batch_plain(want[0], cpu[2], cpu[3], S)
    torch.testing.assert_close(g_ops.cpu(), w_ops, rtol=0, atol=0)
    torch.testing.assert_close(g_n.cpu(), w_n, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["scores", "counts", "codes", "codes+counts"])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_pipeline_at_forced_warps_vs_plain(cuda, mkd, mode):
    """nw_scores and nw_fill_codes in its three modes, W = 1, 2, 3, 8, 32
    warps a pair, bit for bit against the plain versions."""
    for cpu, dev in _pipe_batches(sum(mkd) + 5, cuda):
        want = _pipe_plain(mode, cpu, mkd)
        for warps in PIPE_WARPS:
            got = _pipe_fill(mode, dev, mkd, warps)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0, msg=f"W = {warps}")


def test_pipeline_with_the_top_in_device_memory(cuda):
    """A top past a block's shared memory (117 000 columns; ~115 000 fit)
    is staged in device memory: scores, counts and codes at W = 1, 3, 32
    against the single-pair kernels, whose codes share nw_fill_codes's
    layout (the first pair fills both buckets), under 2 1 1 and a
    wrapping scoring; the single-pair kernels, which stage it in device
    memory too, at the same W against their rule's shape and, on the
    short-sided pair, against their plain versions."""
    rng = np.random.default_rng(31)
    A, Bs = 117_000, 1_600  # 50 bands
    letters = np.frombuffer(b"ACGT", np.uint8)
    ps = [(letters[rng.integers(0, 4, a)].tobytes(), letters[rng.integers(0, 4, s)].tobytes())
          for a, s in ((A, Bs), (A - 7, Bs - 40), (A - 30_000, 33))]
    dev = enc.upload(enc.encode_batch(ps, A, Bs), cuda)
    assert not fill_banded.top_in_smem(A, 4) and not fill_banded.top_in_smem(A, 8)
    pairs = [tuple(torch.from_numpy(enc.encode(x)).to(cuda) for x in p) for p in ps]
    for mkd in [(2, 1, 1), (1, 1, 2**30)]:
        want = [fill_single.score_count_fold(t, s, *mkd) for t, s in pairs]
        want_codes = fill_single.fill_codes_single(*pairs[0], *mkd)[0]
        # the single-pair pipeline stages this top in device memory too:
        # on the short-sided pair against its plain versions
        cpu = [torch.from_numpy(enc.encode(x)) for x in ps[2]]
        assert want[2] == fill_single.score_count_fold_plain(*cpu, *mkd)
        plain_codes, plain_score = fill_single.fill_codes_single_plain(*cpu, *mkd)
        for warps in (1, 3, 32):
            scores = _pipe_fill("scores", dev, mkd, warps)[0].cpu().tolist()
            sc, ct = (x.cpu().tolist() for x in _pipe_fill("counts", dev, mkd, warps))
            codes, sc2, ct2 = _pipe_fill("codes+counts", dev, mkd, warps)
            assert scores == sc == sc2.cpu().tolist() == [w[0] for w in want], (mkd, warps)
            assert ct == ct2.cpu().tolist() == [w[1] for w in want], (mkd, warps)
            assert torch.equal(codes[0], want_codes[0]), (mkd, warps)
            # the single-pair kernels at this W, blocks by the rule
            assert [fill_single.score_count_fold(t, s, *mkd, warps=warps) for t, s in pairs] == want
            got_codes, got_score = fill_single.fill_codes_single(*pairs[2], *mkd, warps=warps)
            assert torch.equal(got_codes.cpu(), plain_codes) and int(got_score) == int(plain_score)


def test_align_batch_long_pairs_at_the_rules_warps(cuda):
    """A few long pairs take many warps a pair (the rule gives 32 here):
    scores, counts and alignments on the card equal device='cpu'."""
    ps = _pairs(11, 3, 900, 1100) + _pairs(12, 1, 1000, 1001, "AC") + EDGE
    nbands = -(-max(len(b) for _, b in ps) // 32)
    assert fill_banded.fill_warps(len(ps), 1100, 1100, 8,
                                  torch.cuda.get_device_properties(cuda).multi_processor_count) == min(32, nbands)
    got = align_batch(ps, 2, 1, 1, device="cuda", traceback_strings=True, count=True)
    want = align_batch(ps, 2, 1, 1, device="cpu", traceback_strings=True, count=True)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.ops, want.ops)
    np.testing.assert_array_equal(got.ops_len, want.ops_len)


@pytest.mark.parametrize("strings,count", [(False, False), (False, True), (True, False), (True, True)])
def test_align_batch_cuda_vs_cpu(cuda, strings, count):
    ps = _pairs(7, 30, 0, 300) + EDGE
    got = align_batch(ps, 2, 1, 1, device="cuda", traceback_strings=strings, count=count)
    want = align_batch(ps, 2, 1, 1, device="cpu", traceback_strings=strings, count=count)
    np.testing.assert_array_equal(got.scores, want.scores)
    if count:
        np.testing.assert_array_equal(got.counts, want.counts)
    if strings:
        np.testing.assert_array_equal(got.ops, want.ops)
        np.testing.assert_array_equal(got.ops_len, want.ops_len)


@pytest.mark.parametrize(
    "args,stdin,huge",
    [
        (["-s", "1", "1", "1"], b"GCATGCU GATTACA", None),
        (["-q", "-t", "-s", "2", "1", "1"], b"ACCATG CATTG", None),
        (["-l", "-s", "0", "0", "0"], b"AAAA AAA", None),
        (["-q", "-s", "--", "3", "-1", "2"], b"GATTACAGATTACA CATGATTACA", "1"),
    ],
)
def test_cli_cuda_vs_cpu(cuda, monkeypatch, args, stdin, huge):
    if huge:
        monkeypatch.setenv("NW_TPU_HUGE_CELLS", huge)
    outs = []
    for platform in ("cuda", "cpu"):
        monkeypatch.setenv("NW_TPU_PLATFORM", platform)
        out, err = io.BytesIO(), io.BytesIO()
        rc = cli.main(["needleman-wunsch", *args], io.BytesIO(stdin), out, err)
        outs.append((rc, out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize(
    "args,launches",
    [
        (["-q", "-s", "1", "1", "1"], (1, 0)),  # score and count only
        (["-q", "1", "1", "1"], (1, 0)),
        (["-q", "-t", "-s", "1", "1", "1"], (0, 1)),  # -t reads the masks
        (["-s", "1", "1", "1"], (0, 1)),  # printing reads the masks
    ],
)
def test_cli_route_on_card(cuda, monkeypatch, args, launches):
    """Whatever the table's size, the card fills masks only when they
    are read."""
    monkeypatch.setenv("NW_TPU_PLATFORM", "cuda")
    monkeypatch.delenv("NW_TPU_HUGE_CELLS", raising=False)
    monkeypatch.delenv("NW_TPU_DEBUG", raising=False)
    fill_single.score_count_fold.launches = 0
    fill_banded.fill_arrows_banded_single.launches = 0
    rc = cli.main(
        ["needleman-wunsch", *args], io.BytesIO(b"GCATGCU GATTACA"), io.BytesIO(), io.BytesIO()
    )
    assert rc == 0
    assert (
        fill_single.score_count_fold.launches, fill_banded.fill_arrows_banded_single.launches
    ) == launches


def _count_inputs(seed, device):
    # _inputs' pairs (5 bands) and long pairs (up to 35 bands: W = 32
    # wraps around), both shorter than their buckets, so that the corners
    # lie inside the tables
    long = _pairs(seed + 2, 3, 900, 1100) + _pairs(seed + 3, 1, 1000, 1100, "AC")
    arrays = enc.encode_batch(long, 1100, 1120)
    return [_inputs(seed, device), (enc.upload(arrays, "cpu"), enc.upload(arrays, device))]


@pytest.mark.parametrize("warps", [1, 2, 3, 4, 8, 16, 32, None])
def test_count_masks_at_forced_warps_vs_plain(cuda, warps):
    """K6's port (nw_count_masks) at W warps a pair (None: the rule's)
    against its plain version under every scoring, over the batched
    masks kernel's tables."""
    from nw_tpu_torch.ops import pathcount

    for cpu, dev in _count_inputs(60, cuda):
        for mkd in SCORINGS:
            masks = fill_banded.fill_masks_banded_batch(*dev, *mkd)[0]
            got = pathcount.count_masks_batch(masks, *dev[2:], warps=warps)
            want = pathcount.count_masks_batch_plain(masks.cpu(), *cpu[2:])
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_batched_masks_count_and_walk_kernels_vs_plain(cuda, mkd, with_counts):
    """nw_fill_masks_batch (K2's batched pack_bits=8 mode), nw_count_masks
    (K6) and nw_walk_masks against their plain versions."""
    from nw_tpu_torch.ops import pathcount

    cpu, dev = _inputs(sum(mkd) + 20, cuda)
    got = fill_banded.fill_masks_banded_batch(*dev, *mkd, with_counts=with_counts)
    want = fill_banded.fill_masks_banded_batch_plain(*cpu, *mkd, with_counts=with_counts)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    torch.testing.assert_close(
        pathcount.count_masks_batch(got[0], *dev[2:]).cpu(),
        pathcount.count_masks_batch_plain(want[0], *cpu[2:]), rtol=0, atol=0,
    )
    S = cpu[0].shape[1] + cpu[1].shape[1]
    for g, w in zip(traceback.walk_masks_batch(got[0], *dev[2:], S),
                    traceback.walk_masks_batch_plain(want[0], *cpu[2:], S)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("strings,count", [(False, True), (True, True)])
def test_align_batch_mask_route_cuda_vs_cpu(cuda, monkeypatch, strings, count):
    """Six pairs padded to one 2 560 bp bucket (long enough for six
    pairs at 420 bp a pair: the mask route's rule takes them): the mask
    route on the card against the CPU."""
    from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
    from nw_tpu_torch.ops import fill_auto

    monkeypatch.setattr(fill_auto, "MASK_SIDE_PER_PAIR", 420)

    ps = _pairs(25, 3, 0, 600) + _pairs(26, 1, 100, 300, "AC") + EDGE[1:3]
    cfg = AlignConfig(scoring=ScoringParams(2, 1, 1), bucket_sizes=(2560,))
    launches = fill_single.fill_arrows_fold_batch.launches
    got = NWAligner(cfg, device="cuda").align_batch(ps, traceback_strings=strings, count=count)
    assert fill_single.fill_arrows_fold_batch.launches == launches + len(ps)
    want = NWAligner(cfg, device="cpu").align_batch(ps, traceback_strings=strings, count=count)
    np.testing.assert_array_equal(got.scores, want.scores)
    if count:
        np.testing.assert_array_equal(got.counts, want.counts)
    if strings:
        np.testing.assert_array_equal(got.ops, want.ops)
        np.testing.assert_array_equal(got.ops_len, want.ops_len)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_flat_api_kernels_vs_plain(cuda, mkd):
    """ops/fill_flat.py on the card (K7, K26, K27 and K6's functions on
    nw_scores, nw_fill_codes, nw_fill_masks_batch and nw_count_masks)
    against its plain versions."""
    from nw_tpu_torch.ops import fill_flat as ff

    cpu, dev = _inputs(sum(mkd) + 32, cuda)
    torch.testing.assert_close(ff.fill_scores_flat_batch(*dev, *mkd).cpu(),
                               ff.fill_scores_flat_batch_plain(*cpu, *mkd), rtol=0, atol=0)
    for g, w in zip(ff.fill_scores_counts_flat_batch(*dev, *mkd), ff.fill_scores_counts_flat_batch_plain(*cpu, *mkd)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    for wc in (False, True):
        got = ff.fill_arrows_flat_batch(*dev, *mkd, with_counts=wc)
        want = ff.fill_arrows_flat_batch_plain(*cpu, *mkd, with_counts=wc)
        assert len(got) == len(want) == 2 + wc
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    torch.testing.assert_close(ff.count_flat_batch(got[0], *dev[2:]).cpu(),
                               ff.count_flat_batch_plain(want[0], *cpu[2:]), rtol=0, atol=0)
