"""CUDA kernels of nw_tpu_torch vs their plain PyTorch versions.

These need an NVIDIA card (sm_90a) and nvcc; without one they skip.  On
the card: ``python -m pytest -m cuda tests/test_torch_kernels.py``.
Every output is an integer: comparisons are exact (tolerance 0).
"""

import io

import numpy as np
import pytest
import torch

from nw_tpu_torch import align_batch, cli
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded, fill_single, traceback

pytestmark = pytest.mark.cuda

SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)]
EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"A", b"A"), (b"GCATGCU", b"GATTACA")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def _pairs(seed, n, lo, hi, alphabet="ACGT"):
    rng = np.random.default_rng(seed)
    return [
        (
            "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode(),
            "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode(),
        )
        for _ in range(n)
    ]


def _inputs(seed, device):
    # multi-band sides (bands are 32 rows), tie-dense pairs, edge pairs
    ps = _pairs(seed, 12, 0, 140) + _pairs(seed + 1, 6, 20, 70, "AC") + EDGE
    arrays = enc.encode_batch(ps, 160, 144)
    return enc.upload(arrays, "cpu"), enc.upload(arrays, device)


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


def _single_pairs(seed):
    # several bands (32 rows each) and chunks, ties, edges, a wrapping count
    return (
        _pairs(seed, 6, 0, 200) + _pairs(seed + 1, 3, 20, 90, "AC") + EDGE
        + [(b"A" * 24, b"A" * 16)]
    )


def _pair_tensors(s1, s2):
    return torch.from_numpy(enc.encode(s1)), torch.from_numpy(enc.encode(s2))


# (blocks, warps): one warp; one block; several blocks whose warps take
# more than one band each (up to 7 bands a pair); the default
SHAPES = [(1, 1), (1, 32), (2, 2), (3, 1), (None, 8)]


@pytest.mark.parametrize("blocks,warps", SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_score_count_kernel_vs_plain(cuda, mkd, blocks, warps):
    for s1, s2 in _single_pairs(sum(mkd) + 3):
        top, side = _pair_tensors(s1, s2)
        got = fill_single.score_count_fold(
            top.to(cuda), side.to(cuda), *mkd, warps=warps, blocks=blocks
        )
        assert got == fill_single.score_count_fold_plain(top, side, *mkd), (s1, s2)


@pytest.mark.parametrize("with_scores", [False, True])
@pytest.mark.parametrize("blocks,warps", SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_fill_masks_kernel_vs_plain(cuda, mkd, blocks, warps, with_scores):
    for s1, s2 in _single_pairs(sum(mkd) + 4):
        top, side = _pair_tensors(s1, s2)
        got = fill_banded.fill_arrows_banded_single(
            top.to(cuda), side.to(cuda), *mkd, with_scores=with_scores,
            warps=warps, blocks=blocks,
        )
        want = fill_banded.fill_arrows_banded_single_plain(
            top, side, *mkd, with_scores=with_scores
        )
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
        if with_scores:
            torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
        assert got[2:] == want[2:], (s1, s2)


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


def test_single_pair_kernels_across_blocks_at_10kb(cuda):
    """Many blocks, several bands a warp, against the one-warp batch fill
    (nw_fill_codes counts-only) on a 4 000 x 3 000 pair."""
    s1, s2 = _pairs(99, 1, 4000, 4001)[0][0], _pairs(98, 1, 3000, 3001)[0][0]
    top, side = (t.to(cuda) for t in _pair_tensors(s1, s2))
    want_sc, want_ct = fill_banded.fill_scores_counts_banded_batch(
        top[None], side[None], torch.tensor([4000], dtype=torch.int32, device=cuda),
        torch.tensor([3000], dtype=torch.int32, device=cuda), 2, 1, 1,
    )
    want = (int(want_sc[0]), int(want_ct[0]))
    for blocks, warps in [(None, 8), (7, 3), (1, 32), (50, 1)]:
        assert fill_single.score_count_fold(top, side, 2, 1, 1, warps=warps, blocks=blocks) == want
        assert fill_banded.fill_arrows_banded_single(
            top, side, 2, 1, 1, warps=warps, blocks=blocks
        )[2:] == want
