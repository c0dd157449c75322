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
from nw_tpu_torch.models import affine as af
from nw_tpu_torch.models import overlap as ov
from nw_tpu_torch.models import smith_waterman as sw
from nw_tpu_torch.ops import fill_banded, fill_single, traceback, variants_banded

pytestmark = pytest.mark.cuda

# ordinary scorings, and scorings whose arithmetic wraps int32
SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2), (1, 1, 2**30), (1, 2**30, 1),
            (2**31 - 1, -(2**31), 2**30)]
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


# the W-warp pipeline (nw_scores, nw_fill_codes) at forced warps a pair,
# on buckets of 5 and 35 bands: no multiple of 2, 3, 8 or 32, and 35
# bands take two rounds of 32 warps
PIPE_WARPS = [1, 2, 3, 8, 32]


def _pipe_batches(seed, device):
    long = _pairs(seed + 2, 6, 0, 300) + _pairs(seed + 3, 3, 900, 1100, "AC") + EDGE
    out = []
    for ps, A, Bs in ((_pairs(seed, 12, 0, 140) + _pairs(seed + 1, 6, 20, 70, "AC") + EDGE, 160, 144),
                      (long, 1100, 1100)):
        arrays = enc.encode_batch(ps, A, Bs)
        out.append((enc.upload(arrays, "cpu"), enc.upload(arrays, device)))
    return out


def _pipe_fill(mode, T, mkd, warps):
    if mode == "scores":
        return (fill_banded._fill_scores_kernel(fill_banded.fill_scores_banded_batch, *T, *mkd, warps=warps),)
    wrapper = (fill_banded.fill_scores_counts_banded_batch if mode == "counts"
               else fill_banded.fill_greedy_counts_banded_batch)
    out = fill_banded._fill_codes_kernel(wrapper, *T, *mkd, emit_codes=mode != "counts",
                                         with_counts=mode != "codes", warps=warps)
    return tuple(x for x in out if x is not None)


def _pipe_plain(mode, T, mkd):
    if mode == "scores":
        return (fill_banded.fill_scores_banded_batch_plain(*T, *mkd),)
    if mode == "counts":
        return fill_banded.fill_scores_counts_banded_batch_plain(*T, *mkd)
    out = fill_banded.fill_greedy_counts_banded_batch_plain(*T, *mkd, with_counts=mode == "codes+counts")
    return tuple(x for x in out if x is not None)


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
    wrapping scoring."""
    rng = np.random.default_rng(31)
    A, Bs = 117_000, 1_600  # 50 bands
    letters = np.frombuffer(b"ACGT", np.uint8)
    ps = [(letters[rng.integers(0, 4, a)].tobytes(), letters[rng.integers(0, 4, s)].tobytes())
          for a, s in ((A, Bs), (A - 7, Bs - 40), (A - 30_000, 33))]
    dev = enc.upload(enc.encode_batch(ps, A, Bs), cuda)
    assert not fill_banded.top_in_smem(A, False) and not fill_banded.top_in_smem(A, True)
    pairs = [tuple(torch.from_numpy(enc.encode(x)).to(cuda) for x in p) for p in ps]
    for mkd in [(2, 1, 1), (1, 1, 2**30)]:
        want = [fill_single.score_count_fold(t, s, *mkd) for t, s in pairs]
        want_codes = fill_single.fill_codes_single(*pairs[0], *mkd)[0]
        for warps in (1, 3, 32):
            scores = _pipe_fill("scores", dev, mkd, warps)[0].cpu().tolist()
            sc, ct = (x.cpu().tolist() for x in _pipe_fill("counts", dev, mkd, warps))
            codes, sc2, ct2 = _pipe_fill("codes+counts", dev, mkd, warps)
            assert scores == sc == sc2.cpu().tolist() == [w[0] for w in want], (mkd, warps)
            assert ct == ct2.cpu().tolist() == [w[1] for w in want], (mkd, warps)
            assert torch.equal(codes[0], want_codes[0]), (mkd, warps)


def test_align_batch_long_pairs_at_the_rules_warps(cuda):
    """A few long pairs take many warps a pair (the rule gives 32 here):
    scores, counts and alignments on the card equal device='cpu'."""
    ps = _pairs(11, 3, 900, 1100) + _pairs(12, 1, 1000, 1001, "AC") + EDGE
    nbands = -(-max(len(b) for _, b in ps) // 32)
    assert fill_banded.fill_warps(len(ps), 1100, 1100, True,
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


def _one(s, cuda=None):
    t = torch.from_numpy(enc.encode(s))
    return t if cuda is None else t.to(cuda)


def _lens(x, cuda):
    return torch.tensor([x], dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("blocks,warps", SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_codes_single_kernel_vs_plain_and_nw_fill_codes(cuda, mkd, blocks, warps):
    """K14 port: bit-equal to its plain version and to nw_fill_codes at
    B = 1, lengths not multiples of 16 or 32 included."""
    for s1, s2 in _single_pairs(sum(mkd) + 5) + [(b"ACGTACGTACGTACG", b"A" * 33)]:
        top, side = _pair_tensors(s1, s2)
        got = fill_single.fill_codes_single(
            top.to(cuda), side.to(cuda), *mkd, warps=warps, blocks=blocks
        )
        want = fill_single.fill_codes_single_plain(top, side, *mkd)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
        assert int(got[1]) == int(want[1]), (s1, s2)
        batch = fill_banded.fill_greedy_counts_banded_batch(
            top.to(cuda)[None], side.to(cuda)[None], _lens(len(s1), cuda),
            _lens(len(s2), cuda), *mkd,
        )
        torch.testing.assert_close(got[0], batch[0], rtol=0, atol=0)
        assert int(got[1]) == int(batch[1][0])


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
            want = fill_single.score_fold_plain(top, side, *mkd, checkpoint_every=every)
            torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
            assert int(got[0]) == int(want[0]), (s1, s2)
            for r in range(1, want[1].shape[0]):
                r0, r1 = r * every, min(len(s2), (r + 1) * every)
                seed = want[1][r]
                g = fill_single.fill_codes_single(
                    top.to(cuda), side.to(cuda), *mkd, len2=r1, r0=r0,
                    seed=seed.to(cuda), warps=warps, blocks=blocks,
                )
                w = fill_single.fill_codes_single_plain(top, side, *mkd, len2=r1, r0=r0, seed=seed)
                torch.testing.assert_close(g[0].cpu(), w[0], rtol=0, atol=0)
                assert int(g[1]) == int(w[1])


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
            _, ck = fill_single.score_fold_plain(top, side, *mkd, checkpoint_every=C)
            for lo in range(min(2, ck.shape[0])):
                got = fill_single.fill_codes_blocks(
                    tc, sc, *mkd, la, lb, lo * C, C, ck[lo:].to(cuda), warps=warps, blocks=blocks
                )
                want = fill_single.fill_codes_blocks_plain(top, side, *mkd, la, lb, lo * C, C, ck[lo:])
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


@pytest.mark.parametrize("blocks,warps", SHAPES)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_score_single_kernel_vs_plain(cuda, mkd, blocks, warps):
    """K11 port: the score alone."""
    for s1, s2 in _single_pairs(sum(mkd) + 7):
        top, side = _pair_tensors(s1, s2)
        got = fill_single.score_fold(top.to(cuda), side.to(cuda), *mkd, warps=warps, blocks=blocks)
        assert got[1] is None
        assert int(got[0]) == int(fill_single.score_fold_plain(top, side, *mkd)[0]), (s1, s2)


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


SW_SCORINGS = SCORINGS + [(1, 1, -1)]


def _sw_inputs(seed, device):
    # the multi-band, tie-dense and edge pairs of _inputs, plus equal
    # bests in two bands (the later one on the earlier diagonal)
    ps = _pairs(seed, 12, 0, 140) + _pairs(seed + 1, 6, 20, 70, "AC") + EDGE + [
        (b"A" * 40, b"A" * 70),
        (b"T" * 10 + b"C" * 30 + b"A" * 10 + b"C" * 10, b"A" * 10 + b"G" * 23 + b"T" * 10 + b"G" * 2),
    ]
    arrays = enc.encode_batch(ps, 160, 144)
    return enc.upload(arrays, "cpu"), enc.upload(arrays, device)


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_sw_scores_kernel_vs_plain(cuda, mkd):
    cpu, dev = _sw_inputs(sum(mkd) + 11, cuda)
    got = variants_banded.sw_scores_banded_batch(*dev, *mkd)
    want = variants_banded.sw_scores_banded_batch_plain(*cpu, *mkd)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_sw_codes_and_walk_kernels_vs_plain(cuda, mkd):
    cpu, dev = _sw_inputs(sum(mkd) + 12, cuda)
    got = variants_banded.sw_fill_codes_banded_batch(*dev, *mkd)
    want = variants_banded.sw_fill_codes_banded_batch_plain(*cpu, *mkd)
    for g, w in zip(got, want):  # codes, best, j*, i*
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    g_walk = traceback.walk_sw_codes_batch(got[0], got[2], got[3])
    w_walk = traceback.walk_sw_codes_batch_plain(want[0], want[2], want[3])
    for g, w in zip(g_walk, w_walk):  # ops, n, i_end, j_end
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_sw_batch_cuda_vs_cpu(cuda, mkd):
    ps = _pairs(sum(mkd) + 13, 30, 0, 300) + EDGE
    assert sw.sw_align_batch(ps, *mkd, device="cuda") == sw.sw_align_batch(ps, *mkd, device="cpu")
    np.testing.assert_array_equal(
        sw.sw_score_batch(ps, *mkd, device="cuda"), sw.sw_score_batch(ps, *mkd, device="cpu")
    )


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_overlap_scores_kernel_vs_plain(cuda, mkd):
    cpu, dev = _sw_inputs(sum(mkd) + 14, cuda)
    got = variants_banded.overlap_scores_banded_batch(*dev, *mkd)
    want = variants_banded.overlap_scores_banded_batch_plain(*cpu, *mkd)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# the best on the last column in band 0 and on the last row in band 2
OVERLAP_TWO_BANDS = (b"C" * 20 + b"G" * 40 + b"A" * 20, b"A" * 20 + b"T" * 30 + b"C" * 20)


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_overlap_codes_and_walk_kernels_vs_plain(cuda, mkd):
    cpu, dev = _sw_inputs(sum(mkd) + 15, cuda)
    extra = enc.upload(enc.encode_batch([OVERLAP_TWO_BANDS, (b"AAAA", b"TTTT")], 160, 144), "cpu")
    cpu = [torch.cat([x, y]) for x, y in zip(cpu, extra)]
    dev = [x.to(cuda) for x in cpu]
    got = variants_banded.overlap_fill_codes_banded_batch(*dev, *mkd)
    want = variants_banded.overlap_fill_codes_banded_batch_plain(*cpu, *mkd)
    for g, w in zip(got, want):  # codes, best, j*, i*
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    g_walk = traceback.walk_sw_codes_batch(got[0], got[2], got[3])
    w_walk = traceback.walk_sw_codes_batch_plain(want[0], want[2], want[3])
    for g, w in zip(g_walk, w_walk):  # ops, n, i_end, j_end
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


GOTOH_SCORINGS = [(2, 1, 3, 1), (1, 1, 1, 1), (0, 0, 0, 0), (3, -1, 2, 1), (2, 1, 1, 3),
                  (1, 1, -1, -1), (1, 1, 2**28, 2**28)]


@pytest.mark.parametrize("sc", GOTOH_SCORINGS)
def test_gotoh_scores_kernel_vs_plain(cuda, sc):
    cpu, dev = _sw_inputs(sum(sc) % 97 + 16, cuda)
    got = variants_banded.affine_scores_banded_batch(*dev, *sc)
    want = variants_banded.affine_scores_banded_batch_plain(*cpu, *sc)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# the alignments' seven scorings (tests/test_torch_affine.py), near the sentinel too
GOTOH_ALIGN_SCORINGS = GOTOH_SCORINGS + [(3, 1, 4, 0), (1, 1, 1, 2**29)]


@pytest.mark.parametrize("sc", GOTOH_ALIGN_SCORINGS)
def test_gotoh_codes_and_walk_kernels_vs_plain(cuda, sc):
    cpu, dev = _sw_inputs(sum(sc) % 89 + 18, cuda)
    got = variants_banded.affine_fill_codes_banded_batch(*dev, *sc)
    want = variants_banded.affine_fill_codes_banded_batch_plain(*cpu, *sc)
    for g, w in zip(got, want):  # codes, scores, states
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    torch.testing.assert_close(got[1], variants_banded.affine_scores_banded_batch(*dev, *sc), rtol=0, atol=0)
    S = 160 + 144
    g_ops, g_n = traceback.walk_gotoh_codes_batch(got[0], dev[2], dev[3], got[2], S)
    w_ops, w_n = traceback.walk_gotoh_codes_batch_plain(want[0], cpu[2], cpu[3], want[2], S)
    torch.testing.assert_close(g_ops.cpu(), w_ops, rtol=0, atol=0)
    torch.testing.assert_close(g_n.cpu(), w_n, rtol=0, atol=0)


@pytest.mark.parametrize("sc", GOTOH_ALIGN_SCORINGS)
def test_affine_align_batch_cuda_vs_cpu(cuda, sc):
    ps = _pairs(sum(sc) % 83 + 19, 30, 0, 300) + EDGE
    assert af.affine_align_batch(ps, *sc, device="cuda") == af.affine_align_batch(ps, *sc, device="cpu")


@pytest.mark.parametrize("mkd", SW_SCORINGS)
def test_overlap_and_affine_batch_cuda_vs_cpu(cuda, mkd):
    ps = _pairs(sum(mkd) + 17, 30, 0, 300) + EDGE + [OVERLAP_TWO_BANDS]
    assert ov.overlap_align_batch(ps, *mkd, device="cuda") == ov.overlap_align_batch(ps, *mkd, device="cpu")
    np.testing.assert_array_equal(
        ov.overlap_score_batch(ps, *mkd, device="cuda"), ov.overlap_score_batch(ps, *mkd, device="cpu")
    )
    sc = (*mkd, mkd[2] + 1)  # open > extend
    np.testing.assert_array_equal(
        af.affine_score_pairs(ps, *sc, device="cuda"), af.affine_score_pairs(ps, *sc, device="cpu")
    )


# (rows a block, columns a chunk) of the chained tiles: chunks that cut
# code words (not multiples of 16 or 32), bands split across blocks
TILE_GRIDS = [(40, 13), (33, 16), (64, 50), (7, 200)]


def _decode_codes(codes, A, rows):
    """Band-major 2-bit codes -> their cells, int64[rows, A+1]."""
    r = torch.arange(rows, device=codes.device)[:, None]
    t = torch.arange(A + 1, device=codes.device)[None, :] + (r & 31)
    w = codes[0][r >> 5, t >> 4, r & 31].to(torch.int64) & 0xFFFFFFFF
    return (w >> (2 * (t & 15))) & 3


@pytest.mark.parametrize("mkd", SCORINGS)
def test_tile_kernel_vs_plain(cuda, mkd):
    """nw_fill_tile (K14's mesh half, K28) in all three modes, chained
    over grids of row blocks and column chunks at several launch shapes:
    the stitched codes equal nw_fill_codes_single's, the stitched masks
    nw_fill_masks's, the last row and corner the plain fill's; on one
    grid, every table and edge equals the plain tile's."""
    from nw_tpu_torch.ops.fill_scan import fill_last_row
    from nw_tpu_torch.parallel.huge_pair import chain_tiles

    for n_pair, (s1, s2) in enumerate(_single_pairs(sum(mkd) + 9)):
        top, side = _pair_tensors(s1, s2)
        A, B = len(s1), len(s2)
        if not B:
            continue
        tc, sc = top.to(cuda), side.to(cuda)
        whole, score = fill_single.fill_codes_single(tc, sc, *mkd)
        masks = fill_banded.fill_arrows_banded_single(tc, sc, *mkd)[0]
        last = fill_last_row(top, side, *mkd)
        for H, C in TILE_GRIDS:
            for blocks, warps in [(1, 1), (2, 2), (None, 8)]:
                for mode in ("scores", "codes", "masks"):
                    got = chain_tiles(tc, sc, *mkd, H, C, mode, warps=warps, blocks=blocks)
                    assert got[2] == int(score), (s1, s2, H, C, mode)
                    torch.testing.assert_close(got[1].cpu(), last, rtol=0, atol=0)
                    if mode == "codes":
                        cells = torch.cat([_decode_codes(t, A, min(H, B - b * H))
                                           for b, t in enumerate(got[0])])
                        torch.testing.assert_close(cells, _decode_codes(whole, A, B), rtol=0, atol=0)
                    if mode == "masks":
                        torch.testing.assert_close(torch.cat(got[0]), masks[1:], rtol=0, atol=0)
            if (H, C) == TILE_GRIDS[0] and n_pair < 6:
                for mode in ("scores", "codes", "masks"):
                    got = chain_tiles(tc, sc, *mkd, H, C, mode)
                    want = chain_tiles(top, side, *mkd, H, C, mode)
                    for g, w in zip(got[0], want[0]):
                        if w is not None:
                            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_mask_walk_kernel_vs_plain(cuda, mkd):
    """nw_walk_window's masks mode, relayed over the row blocks of one
    pair's K28 tiles, against its plain version and nw_walk."""
    from nw_tpu_torch.parallel.huge_pair import chain_tiles

    for s1, s2 in _single_pairs(sum(mkd) + 10):
        top, side = _pair_tensors(s1, s2)
        if not len(s2):
            continue
        S = len(s1) + len(s2)
        tc, sc = top.to(cuda), side.to(cuda)
        codes, _ = fill_single.fill_codes_single(tc, sc, *mkd)
        ops, n = traceback.walk_codes_batch(codes, _lens(len(s1), cuda), _lens(len(s2), cuda), max(S, 1))
        for H in (1, 17, 64):
            masks, _, _ = chain_tiles(tc, sc, *mkd, H, 29, "masks")
            ops_k = torch.full((S,), traceback.OP_NONE, dtype=torch.int8, device=cuda)
            ops_p = torch.full((S,), traceback.OP_NONE, dtype=torch.int8)
            st_k = torch.tensor([len(s1), len(s2), 0], dtype=torch.int32, device=cuda)
            st_p = st_k.cpu().clone()
            for b in range(len(masks) - 1, -1, -1):
                traceback.walk_masks_window(masks[b], st_k, b * H, ops_k)
                traceback.walk_masks_window_plain(masks[b].cpu(), st_p, b * H, ops_p)
                torch.testing.assert_close(st_k.cpu(), st_p, rtol=0, atol=0)
            assert st_p.tolist() == [0, 0, int(n[0])]
            torch.testing.assert_close(ops_k.cpu(), ops_p, rtol=0, atol=0)
            torch.testing.assert_close(ops_k.cpu(), ops[0, :S].cpu(), rtol=0, atol=0)


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


@pytest.mark.parametrize("mkd", SCORINGS)
def test_fold_masks_kernel_vs_plain(cuda, mkd):
    """K10's port (nw_fill_masks a pair at a time into the batch's
    table) against its plain version and the batched masks."""
    cpu, dev = _inputs(sum(mkd) + 21, cuda)
    want = fill_single.fill_arrows_fold_batch_plain(*cpu, *mkd)
    batched = fill_banded.fill_masks_banded_batch(*dev, *mkd, with_counts=True)
    for blocks, warps in [(1, 1), (3, 1), (None, 8)]:
        got = fill_single.fill_arrows_fold_batch(*dev, *mkd, warps=warps, blocks=blocks)
        for g, w, b in zip(got, want, batched):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
            torch.testing.assert_close(g, b, rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_last_row_kernel_vs_plain(cuda, mkd):
    """nw_last_row (K9's port) at every row count, multiples of 32 or
    not, 0 included, against the plain fill's rows."""
    from nw_tpu_torch.ops.fill_scan import diag_to_matrix, fill_diag

    for s1, s2 in _single_pairs(sum(mkd) + 22):
        top, side = _pair_tensors(s1, s2)
        H = diag_to_matrix(fill_diag(top, side, *mkd, with_arrows=False, with_scores=True)["scores"],
                           len(s1), len(s2))
        for len2 in sorted({0, len(s2) // 3, len(s2)}):
            for blocks, warps in [(1, 1), (2, 2), (None, 8)]:
                got = fill_single.last_row(top.to(cuda), side.to(cuda), *mkd, len2=len2,
                                           warps=warps, blocks=blocks)
                torch.testing.assert_close(got.cpu(), H[len2], rtol=0, atol=0)


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
