"""The byte modes of the W-warp pipeline (``nw_fill_masks_batch``,
``nw_fill_runs_batch``) on the CPU: the rule for W with each warp's byte
ring counted, the shared memory and where the top goes, the checks of a
forced W, and the plain path against nw_tpu's K2 where the pipeline
cuts.

The pipeline runs only on the card (``tests/test_torch_kernels_batch.py``
and ``tests/test_torch_kernels_walks.py``, ``-m cuda``, hold both modes at
every forced W against the plain versions); on CPU tensors the wrappers
run those plain versions.  So here the plain tie masks are held against
K2's single-band ``pack_bits=8`` words in interpret mode (as
tests/test_torch_masks.py runs it) and the plain run bytes against K2's
``with_runs`` bytes, reached through ``build_arrows_call`` band by band
(as tests/test_torch_runs.py does): their code bits, and their run bits
against the definition over K2's masks with each side's band restart.
The batches' sides end one row short of, on, and one row past a
multiple of 32 W rows, their band counts are no multiple of W, and they
hold mixed lengths, empty sides and tops, a diagonal longer than the
63 cap across every band's first row and a left run past the cap.
Every output is an integer: comparisons are exact.
"""

import numpy as np
import pytest
import torch

from nw_tpu.ops.encode import encode_batch as jencode_batch
from nw_tpu.ops.fill_pallas_banded import fill_arrows_banded_single as k2_single_band
from nw_tpu_torch.ops import fill_banded
from nw_tpu_torch.ops.arrows import ARROW_LEFT, ARROW_UP
from nw_tpu_torch.ops.fill_banded import BYTE_RING, MAX_WARPS, SMEM_LIMIT, fill_smem, fill_warps, top_cols

from test_torch_runs import _definition, _k2_run_bytes

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

H100_SMS = 132
BATCHES = [1, 2, 4, 23, 128, 132, 133, 256, 1024, 2112, 10240]
SIDES = [0, 1, 31, 32, 33, 150, 256, 2048, 10240, 100_000]
TOPS = [150, 2048, 10_240, 60_000, 100_000, 117_000]
# (W, Bs): one short of, on and one past 32 W rows, and a band count
# (3 or 4 bands) that is not a multiple of W
CUTS = [(2, 63), (2, 64), (2, 65), (2, 96), (3, 95), (3, 96), (3, 97), (3, 128)]
A_BUCKET = 72  # room for a left run past the 63 cap
SCORINGS = [(2, 1, 1), (1, 1, 1), (3, -1, 2)]  # K2 rests on a NEG_INF decay: no wrapping scoring


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _cell(with_counts):
    return 8 if with_counts else 4  # a score, and a count


# ---------------- the rule, the shared memory, the forced W ----------------


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("B,L,want", [(128, 2048, 32), (128, 10_240, 32), (10_240, 150, 1), (1024, 256, 4),
                                      (256, 10_240, 16), (4, 10_240, 32)])
def test_rule_at_the_byte_fill_shapes(B, L, want, with_counts):
    """fill_warps' W with the byte rings counted: 32 at 128 x 2 048 bp
    (fill_arrows_auto's batched route) and at 128 x 10 240 bp (a runs
    sub-batch of config 3), one at 10 240 x 150 bp, 4 at 1 024 x 256 bp
    (K27's flat shape), 16 at config 3's 256 pairs."""
    cell = _cell(with_counts)
    W = fill_warps(B, L, L, cell, H100_SMS, ring=BYTE_RING)
    assert W == want
    assert fill_smem(W, L, cell, ring=BYTE_RING) <= SMEM_LIMIT
    assert fill_banded._top_scratch(B, L, cell, "cpu", W, ring=BYTE_RING) is None


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("A", TOPS)
def test_rule_stays_inside_the_block_and_the_bands(A, with_counts):
    """1 <= W <= min(32, bands), and the shared memory the kernel takes
    (the rings, the byte rings and, where it fits beside them, the top)
    within a block's 232 448 bytes, at every batch size; the top is
    staged in device memory exactly where it does not fit."""
    cell = _cell(with_counts)
    for B in BATCHES:
        for Bs in SIDES:
            W = fill_warps(B, A, Bs, cell, H100_SMS, ring=BYTE_RING)
            assert 1 <= W <= max(1, min(MAX_WARPS, -(-Bs // 32))), (B, Bs, W)
            staged = fill_banded._top_scratch(B, A, cell, "cpu", W, ring=BYTE_RING) is None
            assert staged == (fill_smem(W, A, cell, ring=BYTE_RING) <= SMEM_LIMIT)
            assert fill_smem(W, A, cell, staged, ring=BYTE_RING) <= SMEM_LIMIT == 232_448, (B, Bs, W)
            # the rule keeps the top in shared memory where it fits beside one warp
            assert staged == fill_banded.top_in_smem(A, cell, ring=BYTE_RING), (B, Bs, W)


def test_shared_memory_layout():
    """The kernel's launch: pipe_smem (done[W], W rings of 4 x 32 cells,
    warp 0's 32 staged cells, the int16 top) plus a byte ring a warp of
    32 rows of 64 slots, a row every 68 bytes."""
    assert BYTE_RING == 32 * 68
    for W, A, cell in [(32, 2048, 4), (32, 10_240, 8), (1, 150, 4), (4, 256, 8)]:
        want = 4 * W + cell * (W * 128 + 32) + 2 * top_cols(A) + 2176 * W
        assert fill_smem(W, A, cell, ring=BYTE_RING) == want
        assert fill_smem(W, A, cell, staged=False, ring=BYTE_RING) == want - 2 * top_cols(A)
        assert fill_smem(W, A, cell, ring=BYTE_RING) - fill_smem(W, A, cell) == BYTE_RING * W
    assert fill_smem(32, 2048, 4, ring=BYTE_RING) == 128 + 4 * 4128 + 2 * (32 * 65 + 32) + 69_632 == 90_496
    # W = 32 with counts: 102 784 bytes of rings, room for a top of ~64 800 columns
    assert fill_smem(32, 0, 8, staged=False, ring=BYTE_RING) == 102_784


@pytest.mark.parametrize("with_counts", [False, True])
def test_a_top_that_does_not_fit_beside_the_rings_goes_to_device_memory(with_counts):
    """An 80 000-column top fits beside one warp's rings but not beside 32
    warps': the rule keeps it in shared memory at fewer warps, a forced W
    of 32 stages it in device memory; a 117 000-column top fits beside
    none, so the rule keeps 32 warps and stages it."""
    cell = _cell(with_counts)
    A = 80_000
    assert fill_banded.top_in_smem(A, cell, ring=BYTE_RING)
    assert fill_smem(32, A, cell, ring=BYTE_RING) > SMEM_LIMIT
    W = fill_warps(1, A, A, cell, H100_SMS, ring=BYTE_RING)
    assert 1 < W < 32 and fill_smem(W, A, cell, ring=BYTE_RING) <= SMEM_LIMIT
    assert fill_banded._top_scratch(1, A, cell, "cpu", W, ring=BYTE_RING) is None
    assert fill_banded._pipe_warps(1, A, A, cell, torch.device("cpu"), 32, ring=BYTE_RING) == 32
    assert fill_banded._top_scratch(2, A, cell, "cpu", 32, ring=BYTE_RING).shape == (2, top_cols(A))
    A = 117_000
    assert not fill_banded.top_in_smem(A, cell, ring=BYTE_RING)
    assert fill_warps(1, A, A, cell, H100_SMS, ring=BYTE_RING) == 32
    assert fill_banded._top_scratch(1, A, cell, "cpu", 32, ring=BYTE_RING).shape == (1, top_cols(A))


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("kind", ["masks", "runs"])
def test_forced_warps_are_checked(monkeypatch, kind, with_counts):
    """A forced W outside [1, 32], or one whose rings leave no room in a
    block's shared memory, raises ValueError before any launch, and the
    wrapper's count does not move."""
    wrapper = getattr(fill_banded, f"fill_{kind}_banded_batch")
    launched = []
    monkeypatch.setattr(fill_banded.kernels, "launch", lambda *a: launched.append(a))
    T = _torch(np.zeros((2, 100), np.int32), np.zeros((2, 100), np.int32),
               np.array([100, 50], np.int32), np.array([100, 3], np.int32))

    def launch(warps):
        return fill_banded._fill_bytes_kernel(wrapper, f"nw_fill_{kind}_batch", *T, 2, 1, 1,
                                              with_counts, warps)

    launches = wrapper.launches
    for bad in (0, 33):
        with pytest.raises(ValueError, match="warps"):
            launch(bad)
    # W = 32's rings (int and byte) take 86 272 / 102 784 bytes: neither fits 64 KB
    monkeypatch.setattr(fill_banded, "SMEM_LIMIT", 65_536)
    with pytest.raises(ValueError, match="shared memory"):
        launch(32)
    assert fill_banded._pipe_warps(2, 100, 100, _cell(with_counts), torch.device("cpu"), 16, ring=BYTE_RING) == 16
    assert wrapper.launches == launches and not launched


# ---------------- the plain path where the pipeline cuts ----------------


def _cut_pairs(W, Bs, seed):
    """Pairs at a bucket of Bs side rows: one side of exactly Bs rows,
    mixed shorter ones, an empty side, an empty top, a one-row pair, a
    diagonal of Bs cells (past the 63 cap from Bs = 64, across every
    band's first row) and a left run of 70 cells."""
    rng = np.random.default_rng(seed)

    def s(n, alphabet="ACGT"):
        return "".join(rng.choice(list(alphabet), n)).encode()

    diag = s(Bs)
    pairs = [(s(37), s(Bs)), (s(29, "AC"), s(Bs - 1, "AC")), (s(A_BUCKET), s(int(rng.integers(1, Bs + 1))))]
    pairs += [(s(int(rng.integers(0, A_BUCKET + 1))), s(int(rng.integers(0, Bs + 1)))) for _ in range(2)]
    pairs += [(s(23), b""), (b"", s(Bs // 2)), (b"A", b"A"), (diag[:A_BUCKET], diag), (b"T" + b"A" * 70, b"T")]
    return pairs


def _plain(kind, pairs, Bs, mkd, with_counts):
    tops, sides, l1, l2 = jencode_batch(pairs, A_BUCKET, Bs)
    fill = getattr(fill_banded, f"fill_{kind}_banded_batch")
    table, sc, ct = fill(*_torch(tops, sides, l1, l2), *mkd, with_counts=with_counts)
    assert table.dtype == torch.uint8 and table.shape == (len(pairs), Bs + 1, A_BUCKET + 1)
    return table.numpy(), sc.numpy(), ct


def _k2_masks(pairs, Bs, mkd, with_counts):
    """K2's single-band pack_bits=8 masks of each true table (cell (j,
    i): byte (i+j) % 4 of words[(i+j) // 4, j, b]; the origin, which K2
    leaves unspecified, set to 0), its scores and counts."""
    tops, sides, l1, l2 = jencode_batch(pairs, A_BUCKET, Bs)
    out = k2_single_band(tops, sides, l1, l2, *mkd, interpret=True, with_counts=with_counts)
    words = np.asarray(out[0])
    masks = []
    for b, (s1, s2) in enumerate(pairs):
        jj, ii = np.mgrid[0 : len(s2) + 1, 0 : len(s1) + 1]
        kk = ii + jj
        t = ((words[kk // 4, jj, b] >> (8 * (kk % 4))) & 0xFF).astype(np.int64)
        t[0, 0] = 0
        masks.append(t)
    return masks, np.asarray(out[1]), (np.asarray(out[2]).astype(np.int64) if with_counts else None)


def _check_table(table, b, pair, want):
    """The true table is ``want``; nothing is stored outside it."""
    s1, s2 = pair
    got = table[b, : len(s2) + 1, : len(s1) + 1].astype(np.int64)
    np.testing.assert_array_equal(got, want, err_msg=f"pair {b}")
    assert int(table[b].astype(np.int64).sum()) == int(want.sum()), f"pair {b}"


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("W,Bs", CUTS)
def test_masks_cuts_vs_k2_interpret(W, Bs, with_counts):
    """The plain tie masks, scores and counts against K2's single band:
    row 0 LEFT, column 0 UP, the origin 0, 0 outside each table."""
    pairs = _cut_pairs(W, Bs, 500 * W + Bs)
    for mkd in SCORINGS[:2] if with_counts else SCORINGS:
        masks, sc, ct = _plain("masks", pairs, Bs, mkd, with_counts)
        want, want_sc, want_ct = _k2_masks(pairs, Bs, mkd, with_counts)
        for b, pair in enumerate(pairs):
            _check_table(masks, b, pair, want[b])
            t = masks[b, : len(pair[1]) + 1, : len(pair[0]) + 1]
            assert (t[0, 1:] == ARROW_LEFT).all() and (t[1:, 0] == ARROW_UP).all() and t[0, 0] == 0
        np.testing.assert_array_equal(sc, want_sc, err_msg=str(mkd))
        if with_counts:
            np.testing.assert_array_equal(ct.numpy(), want_ct, err_msg=str(mkd))
        else:
            assert ct is None


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("W,Bs", CUTS)
def test_run_bytes_cuts_vs_k2_with_runs(W, Bs, with_counts):
    """The plain run bytes against K2's with_runs bytes in 32-row bands:
    the code bits on every cell of each true table but the origin (K2
    leaves it unspecified); the whole bytes against the definition over
    K2's masks with the port's band restart (rows 1, 33, 65, ...), and
    K2's against it with K2's (rows 0, 32, 64, ...); scores and counts as
    K2's single band's."""
    pairs = _cut_pairs(W, Bs, 600 * W + Bs)
    mkd = SCORINGS[(W + Bs) % len(SCORINGS)]
    runs, sc, ct = _plain("runs", pairs, Bs, mkd, with_counts)
    masks, want_sc, want_ct = _k2_masks(pairs, Bs, mkd, with_counts)
    k2 = _k2_run_bytes(pairs, mkd, RB=32)
    for b, pair in enumerate(pairs):
        want = _definition(masks[b], lambda j: j % 32 == 1)
        _check_table(runs, b, pair, want)
        got = runs[b, : len(pair[1]) + 1, : len(pair[0]) + 1].astype(np.int64)
        np.testing.assert_array_equal((k2[b] & 3).ravel()[1:], (got & 3).ravel()[1:], err_msg=f"pair {b}")
        np.testing.assert_array_equal(k2[b].ravel()[1:], _definition(masks[b], lambda j: j % 32 == 0).ravel()[1:],
                                      err_msg=f"pair {b}")
    # the diagonal crosses every band's first row: its runs restart there;
    # row 1's left run and row 0's pass the cap
    j = np.arange(1, min(Bs, A_BUCKET) + 1)
    np.testing.assert_array_equal(runs[-2][j, j], ((j - 1) % 32 + 1) << 2)
    assert runs[-1][1, 71] == 63 << 2 | 1 and runs[-1][0, 71] == 63 << 2 | 1
    np.testing.assert_array_equal(sc, want_sc)
    if with_counts:
        np.testing.assert_array_equal(ct.numpy(), want_ct)
    else:
        assert ct is None
