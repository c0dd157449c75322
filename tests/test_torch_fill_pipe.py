"""The W-warp pipeline of ``nw_scores`` / ``nw_fill_codes`` on the CPU:
its rule for W, its shared memory, and the plain path against nw_tpu's
K1 / K2 at the side lengths where a pipeline of W warps cuts.

The pipeline runs only on the card (``tests/test_torch_kernels.py``,
``-m cuda``, holds it at forced W against the plain versions); on CPU
tensors its wrappers run those plain versions.  So here the plain path
is held against K1 and K2 in interpret mode (as tests/test_banded.py
runs them) on batches whose sides end one row short of, on, and one row
past a multiple of 32 W rows, and on band counts that are not a
multiple of W, with mixed lengths, an empty side and a one-row pair in
each batch.  Every output is an integer: comparisons are exact.
"""

import numpy as np
import pytest
import torch

from nw_tpu.ops import encode as jenc
from nw_tpu_torch.ops import fill_banded
from nw_tpu_torch.ops.fill_banded import MAX_WARPS, SMEM_LIMIT, fill_smem, fill_warps

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

H100_SMS = 132
BATCHES = [1, 2, 4, 23, 24, 128, 132, 133, 256, 1024, 2112, 4096, 10240]
SIDES = [0, 1, 31, 32, 33, 150, 160, 1000, 2048, 10240, 100_000]


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("shape", [(10240, 160), (10240, 150), (4096, 160)])
def test_rule_keeps_one_warp_where_the_batch_fills_the_card(shape, with_counts):
    """Config 2 (10 240 x 150 bp, 5 bands) and K5's 4 096 pairs keep one
    warp a pair."""
    B, L = shape
    assert fill_warps(B, L, L, 8 if with_counts else 4, H100_SMS) == 1


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("A", [150, 10_240, 100_000])
def test_rule_stays_inside_the_block_and_the_bands(A, with_counts):
    """1 <= W <= min(32, bands), a block of at most 1 024 threads, and
    the shared memory the wrapper computes within a block's 232 448
    bytes, at every batch size."""
    cell = 8 if with_counts else 4
    for B in BATCHES:
        for Bs in SIDES:
            W = fill_warps(B, A, Bs, cell, H100_SMS)
            nbands = -(-Bs // 32)
            assert 1 <= W <= max(1, min(MAX_WARPS, nbands)), (B, Bs, W)
            assert 32 * W <= 1024
            assert fill_smem(W, A, cell) <= SMEM_LIMIT == 232_448, (B, Bs, W)


@pytest.mark.parametrize("B,Bs,want", [(256, 10240, 16), (128, 10240, 32), (4, 10240, 32),
                                       (1, 20_000, 32), (1024, 256, 4), (2112, 10240, 2), (4224, 10240, 1)])
def test_rule_fills_small_batches_of_long_pairs(B, Bs, want):
    """About WARPS_PER_SM warps an SM: config 3 (256 pairs, two an SM)
    takes 16 warps a pair, 128 pairs 32."""
    assert fill_warps(B, Bs, Bs, 8, H100_SMS) == want


def test_rule_fits_a_100_kb_pair_with_counts():
    """The counts-only reference of a 100 000 bp pair (B = 1): 32 warps'
    rings and the 200 KB top pass the limit, so W drops to 31."""
    assert fill_smem(32, 100_000, 8) > SMEM_LIMIT
    assert fill_warps(1, 100_000, 100_000, 8, H100_SMS) == 31
    assert fill_warps(1, 100_000, 100_000, 4, H100_SMS) == 32


def test_shared_memory_layout():
    """fill_smem mirrors the kernel's pipe_smem: done[W] and W rings of 4
    x 32 cells, warp 0's 32 staged cells (a cell 4 bytes, 8 with counts),
    and the int16 top of 32 * ceil((A+32)/32) + 32 columns."""
    nchunks = -(-(10240 + 32) // 32)
    assert fill_smem(16, 10240, 8) == 4 * 16 + 8 * (16 * 128 + 32) + 2 * (32 * nchunks + 32) == 37312
    assert fill_smem(1, 150, 4) == 4 + 4 * (128 + 32) + 2 * (32 * 6 + 32)


def test_forced_warps_are_checked():
    """A forced W outside [1, 32], or one whose rings leave no room for
    the top in a block's shared memory, raises before any launch."""
    for bad in (0, 33):
        with pytest.raises(ValueError, match="warps"):
            fill_banded._pipe_warps(4, 100, 100, 8, torch.device("cpu"), bad)
    with pytest.raises(ValueError, match="shared memory"):
        fill_banded._pipe_warps(1, 100_000, 100_000, 8, torch.device("cpu"), 32)
    assert fill_banded._pipe_warps(4, 100, 100, 8, torch.device("cpu"), 3) == 3
    assert fill_banded._pipe_warps(1, 100_000, 100_000, 4, torch.device("cpu"), 32) == 32


@pytest.mark.parametrize("with_counts", [False, True])
def test_a_top_past_shared_memory_is_staged_in_device_memory(with_counts):
    """Past ~115 000 columns the top goes to an int16 row in device
    memory: the block's shared memory is then the rings alone, and the
    rule gives W as for any long pair."""
    cell = 8 if with_counts else 4
    assert fill_banded.top_in_smem(100_000, cell)
    A = 115_489 if with_counts else 116_500
    assert not fill_banded.top_in_smem(A, cell)
    assert fill_warps(1, A, A, cell, H100_SMS) == 32
    assert fill_banded._pipe_warps(1, A, A, cell, torch.device("cpu"), 32) == 32
    assert fill_smem(32, A, cell, staged=False) == 4 * 32 + 4 * (32 * 128 + 32) * (1 + with_counts)
    assert fill_banded._top_scratch(2, A, cell, "cpu").shape == (2, fill_banded.top_cols(A))
    assert fill_banded._top_scratch(2, 100_000, cell, "cpu") is None


def _cut_batch(W, Bs, seed):
    """Pairs at a bucket of Bs side rows: one side of exactly Bs rows,
    mixed shorter ones, an empty side, a one-row pair, an empty top."""
    rng = np.random.default_rng(seed)

    def s(n, alphabet="ACGT"):
        return "".join(rng.choice(list(alphabet), n)).encode()

    pairs = [(s(37), s(Bs)), (s(29, "AC"), s(Bs - 1, "AC")), (s(40), s(int(rng.integers(1, Bs + 1))))]
    pairs += [(s(int(rng.integers(0, 41))), s(int(rng.integers(0, Bs + 1)))) for _ in range(3)]
    pairs += [(s(23), b""), (s(17), s(1)), (b"", s(Bs // 2)), (b"A", b"A")]
    return jenc.encode_batch(pairs, 40, Bs)


# (W, Bs): one short of, on and one past 32 W rows, and a band count
# (3 or 4 bands) that is not a multiple of W
CUTS = [(2, 63), (2, 64), (2, 65), (2, 96), (3, 95), (3, 96), (3, 97), (3, 128)]


@pytest.mark.parametrize("W,Bs", CUTS)
def test_pipeline_cuts_scores_vs_k1_interpret(W, Bs):
    from nw_tpu.ops.fill_pallas_banded import fill_scores_banded_batch as k1

    tops, sides, l1, l2 = _cut_batch(W, Bs, 100 * W + Bs)
    for mkd in [(2, 1, 1), (3, -1, 2)]:  # K1 rests on a NEG_INF decay: no wrapping scoring
        want = np.asarray(
            k1(tops, sides, l1, l2, *mkd, interpret=True, band_rows=8, chunk=8, unroll=4)
        )
        got = fill_banded.fill_scores_banded_batch(*_torch(tops, sides, l1, l2), *mkd)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("W,Bs", CUTS)
def test_pipeline_cuts_counts_vs_k2_interpret(W, Bs):
    from nw_tpu.ops.fill_pallas_banded import fill_scores_counts_banded_batch as k2

    tops, sides, l1, l2 = _cut_batch(W, Bs, 200 * W + Bs)
    want_sc, want_ct = k2(
        tops, sides, l1, l2, 1, 1, 1, interpret=True, band_rows=8, chunk=8, unroll=4
    )
    got_sc, got_ct = fill_banded.fill_scores_counts_banded_batch(
        *_torch(tops, sides, l1, l2), 1, 1, 1
    )
    np.testing.assert_array_equal(got_sc.numpy(), np.asarray(want_sc))
    np.testing.assert_array_equal(got_ct.numpy(), np.asarray(want_ct).astype(np.int64))


@pytest.mark.parametrize("W,Bs", CUTS)
def test_pipeline_cuts_codes_vs_k2_interpret(W, Bs):
    """K2's pack_bits=2 band-major greedy words, decoded cell by cell,
    against the port's codes with and without counts."""
    from nw_tpu.ops.fill_pallas_banded import fill_arrows_banded_batch as k2

    RB = 8
    tops, sides, l1, l2 = _cut_batch(W, Bs, 300 * W + Bs)
    words, want_sc, want_ct = k2(
        tops, sides, l1, l2, 2, 1, 1, interpret=True, band_rows=RB, chunk=16,
        unroll=16, with_counts=True, pack_bits=2,
    )
    words = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    T = _torch(tops, sides, l1, l2)
    codes, scores, counts = fill_banded.fill_greedy_counts_banded_batch(*T, 2, 1, 1, with_counts=True)
    codes0, scores0, none = fill_banded.fill_greedy_counts_banded_batch(*T, 2, 1, 1)
    assert none is None
    np.testing.assert_array_equal(codes0.numpy(), codes.numpy())
    np.testing.assert_array_equal(scores0.numpy(), scores.numpy())
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want_sc))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_ct).astype(np.int64))
    codes = codes.numpy().astype(np.int64) & 0xFFFFFFFF
    for b in range(len(l1)):
        A1, B2 = int(l1[b]), int(l2[b])
        jj, ii = np.mgrid[0 : B2 + 1, 0 : A1 + 1]
        jm = np.maximum(jj - 1, 0)
        t = ii + jm % 32
        got = (codes[b][jm // 32, t >> 4, jm % 32] >> (2 * (t & 15))) & 3 if codes.shape[1] else 0 * t
        tk = ii + jj % RB
        want = (words[jj // RB, tk >> 4, jj % RB, b] >> (2 * (tk & 15))) & 3
        # row 0 is not stored by the port, and K2 leaves cell (0, 0) unspecified
        np.testing.assert_array_equal(got[1:], want[1:], err_msg=str(b))
