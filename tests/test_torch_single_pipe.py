"""The single-pair pipeline (``nw_score_count``, K8; ``nw_fill_codes_single``,
K14) on the CPU: its launch rule, the top's placement, its scratch, the
checks of a forced shape, and the plain path against nw_tpu at the side
lengths where the pipeline cuts.

The pipeline runs only on the card (``tests/test_torch_kernels.py``,
``-m cuda``, holds both kernels at every forced W, at blocks that wrap
around and at the rule's shape against the plain versions); on CPU
tensors the wrappers run those plain versions.  So here the plain path
is held against nw_tpu's K8 in interpret mode (as tests/test_pallas.py
runs it) and against the greedy codes of nw_tpu's ``fill_diag``, on
sides that end one row short of, on and one row past a multiple of 32 W
rows and of 32 G W rows (where the bands wrap around to block 0), with
an empty side and an empty top.  Every output is an integer:
comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nw_tpu.ops.encode import encode as jencode
from nw_tpu.ops.encode import pad_to
from nw_tpu.ops.fill_pallas_single import score_count_fold as j_score_count_fold
from nw_tpu.ops.fill_scan import diag_to_matrix as j_diag_to_matrix
from nw_tpu.ops.fill_scan import fill_diag as j_fill_diag
from nw_tpu_torch.ops import fill_banded, fill_single
from nw_tpu_torch.ops.encode import encode
from nw_tpu_torch.ops.fill_banded import SMEM_LIMIT, fill_smem, single_blocks, single_warps

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

H100_SMS = 132
CPU = torch.device("cpu")


# ---------------- the launch rule ----------------


@pytest.mark.parametrize(
    "L,warps,blocks",
    [
        (150, 5, 1),  # 5 bands: one block, no handoff between blocks
        (10_240, 8, 40),
        (20_000, 8, 79),
        (50_000, 8, 132),
        (100_000, 12, 132),  # 3 125 bands on 1 584 warps: two rounds
        (150_000, 16, 132),
        (200_000, 16, 132),
    ],
)
def test_rule_spreads_the_wavefront_over_the_sms(L, warps, blocks):
    """W is the bands in flight at once (a band two chunks behind the one
    above it: about nchunks / 2) spread over the SMs, within
    SINGLE_WARPS_MIN .. SINGLE_WARPS_MAX; G as many blocks as the bands
    fill, one an SM at most."""
    assert single_warps(L, L, H100_SMS) == warps
    assert single_blocks(L, warps, H100_SMS) == blocks


def test_rule_keeps_every_band_in_flight_at_100_kb():
    """At 100 kb the wavefront holds ~1 563 bands: 132 blocks of 12 warps
    hold them all (a warp is free again when the band P below its last
    one starts), 12 an SM."""
    W = single_warps(100_000, 100_000, H100_SMS)
    P = W * single_blocks(100_000, W, H100_SMS)
    wave = -(-((100_000 + 63) // 32) // 2)
    assert P >= wave and W == -(-wave // H100_SMS)


@pytest.mark.parametrize("A,Bs,warps", [(100_000, 1_600, 8), (1_000, 100_000, 8), (0, 40, 2), (77, 0, 1)])
def test_rule_on_unequal_sides(A, Bs, warps):
    """Few bands (a short side): no more warps than bands; a short top:
    a narrow wavefront, the minimum W."""
    assert single_warps(A, Bs, H100_SMS) == warps


# ---------------- the top's placement and the scratch ----------------


@pytest.mark.parametrize("cell", [4, 8])
def test_top_is_staged_in_shared_memory_at_100_kb(cell):
    """At 100 kb the int16 top (200 KB) fits beside the rule's 12 warps'
    rings, with counts (8-byte cells) and without."""
    W = single_warps(100_000, 100_000, H100_SMS)
    assert fill_smem(W, 100_000, cell) <= SMEM_LIMIT
    top16, _, _ = fill_single.pipe_scratch(100_000, 132, W, cell, CPU)
    assert top16 is None


@pytest.mark.parametrize("A,warps,cell,staged", [
    (100_000, 32, 8, False),  # 32 warps' 8-byte rings and the top pass the limit
    (100_000, 32, 4, True),
    (100_000, 31, 8, True),
    (117_000, 1, 4, False),  # past ~115 000 columns at any W
    (117_000, 8, 8, False),
])
def test_the_top_goes_to_a_row_a_block_where_it_does_not_fit(A, warps, cell, staged):
    """The top is staged in shared memory where it fits beside the W
    warps' rings, else in each block's own int16 row of a device
    scratch, at the same W."""
    top16, _, _ = fill_single.pipe_scratch(A, 5, warps, cell, CPU)
    assert (top16 is None) == staged == (fill_smem(warps, A, cell) <= SMEM_LIMIT)
    if not staged:
        assert top16.shape == (5, fill_banded.top_cols(A)) and top16.dtype == torch.int16


@pytest.mark.parametrize("cell", [4, 8])
def test_boundary_rows_are_a_row_a_block(cell):
    """A boundary row a block of A+1 cells (4 bytes without counts, 8
    with): 105.6 MB (K8) and 52.8 MB (K14) at the rule's shape at 100 kb;
    the blocks' counters start at 0."""
    _, bnd, flags = fill_single.pipe_scratch(100_000, 132, 12, cell, CPU)
    assert bnd.numel() * bnd.element_size() == 132 * 100_001 * cell
    assert bnd.shape == (132, 100_001, cell // 4)
    assert flags.shape == (132,) and not flags.any()


def test_forced_shapes_pass_as_given():
    """Forced W and G pass as given, at any length (the top goes to
    device memory where it does not fit beside the rings)."""
    assert fill_single.pipe_shape(700, 700, CPU, warps=3, blocks=2) == (2, 3)
    assert fill_single.pipe_shape(100_000, 100_000, CPU, warps=32, blocks=132) == (132, 32)


@pytest.mark.parametrize("warps,blocks", [(0, None), (33, None), (None, 0)])
def test_wrappers_check_a_forced_shape_before_running(warps, blocks):
    """A forced W outside [1, 32] or G below 1 raises before any launch."""
    top = torch.from_numpy(encode(b"GATTACA"))
    for fn in (fill_single.score_count_fold, fill_single.fill_codes_single):
        with pytest.raises(ValueError, match="warps" if blocks is None else "blocks"):
            fn(top, top, 1, 1, 1, warps=warps, blocks=blocks)


# ---------------- the plain path at the pipeline's cuts ----------------

# side lengths: one short of, on and one past 32 W rows (W = 2, 3) and 32
# G W rows (G = 2, W = 3: the seventh band wraps around to block 0)
CUTS = [63, 64, 65, 95, 96, 97, 191, 192, 193, 0]
A_CUT = 75
PAD = 224  # nw_tpu's K8 compiles once for every pair


def _pair(Bs, seed):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    return letters[rng.integers(0, 4, A_CUT)].tobytes(), letters[rng.integers(0, 4, Bs)].tobytes()


@pytest.mark.parametrize("Bs", CUTS)
@pytest.mark.parametrize("mkd", [(2, 1, 1), (3, -1, 2)])
def test_score_count_plain_vs_k8_interpret_at_the_cuts(mkd, Bs):
    s1, s2 = _pair(Bs, Bs + sum(mkd))
    top = jnp.asarray(pad_to(jencode(s1), PAD, -1))
    side = jnp.asarray(pad_to(jencode(s2), PAD, -2))
    sc, cnt = j_score_count_fold(top, side, *mkd, len1=len(s1), len2=len(s2), interpret=True)
    t, s = torch.from_numpy(encode(s1)), torch.from_numpy(encode(s2))
    assert fill_single.score_count_fold(t, s, *mkd, warps=3, blocks=2) == (int(sc), int(cnt))
    assert fill_single.score_count_fold(t[:0], s, *mkd) == (-Bs * mkd[2], 1)  # an empty top


@pytest.mark.parametrize("Bs", CUTS)
def test_codes_plain_vs_nw_tpu_at_the_cuts(Bs):
    """The codes and the corner of the whole pair, and of its rows below
    row 64 from that row (the seeded mode), against the greedy codes of
    nw_tpu's fill_diag: code rows j-1 hold bits 0 diag, 1 left, 2 up by
    diag > left > up, cell (j, i) at band (j-1) // 32, word (i + jj) // 16,
    lane jj = (j-1) % 32."""
    mkd = (2, 1, 1)
    s1, s2 = _pair(Bs, Bs + 7)
    t, s = torch.from_numpy(encode(s1)), torch.from_numpy(encode(s2))
    if Bs == 0:  # no band: no codes, the corner on row 0
        codes, corner = fill_single.fill_codes_single(t, s, *mkd)
        assert codes.shape == (1, 0, 2 * ((A_CUT + 63) // 32), 32) and int(corner) == -A_CUT
        return
    out = j_fill_diag(jencode(s1), jencode(s2), *mkd)
    masks = j_diag_to_matrix(np.asarray(out["arrows"]), A_CUT, Bs)
    score = int(out["score"])
    codes, corner = fill_single.fill_codes_single(t, s, *mkd)
    assert int(corner) == score
    assert codes.shape == (1, -(-Bs // 32), 2 * ((A_CUT + 63) // 32), 32)
    words = codes[0].numpy().view(np.uint32)
    for j in range(1, Bs + 1):
        band, jj = (j - 1) // 32, (j - 1) % 32
        for i in range(A_CUT + 1):
            a = int(masks[j, i])
            want = 2 if i == 0 else (0 if a & 1 else (1 if a & 2 else 2))
            got = (int(words[band, (i + jj) // 16, jj]) >> (2 * ((i + jj) % 16))) & 3
            assert got == want, (j, i)
    if Bs > 64:
        seed = fill_single.score_fold_plain(t, s, *mkd, checkpoint_every=64)[1][1]
        part, corner = fill_single.fill_codes_single(t, s, *mkd, r0=64, seed=seed)
        np.testing.assert_array_equal(part[0].numpy(), codes[0, 2:].numpy())
        assert int(corner) == score
