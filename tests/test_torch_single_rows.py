"""The single-pair pipeline's rows and masks modes (``nw_score_single``,
K11 / K12; ``nw_last_row``, K9; ``nw_fill_masks``, K2 for one pair and
K10 a pair at a time) on the CPU: their launch shape, where the top goes
once the masks' rings are counted, their scratch, the checks of a forced
shape, and the plain paths against nw_tpu at the side lengths where the
pipeline cuts.

The kernels run only on the card (``tests/test_torch_kernels.py``, ``-m
cuda``, holds them at every forced W, at blocks that wrap around and at
the rule's shape against the plain versions); on CPU tensors the
wrappers run those plain versions.  So here the plain paths are held
against nw_tpu as nw_tpu's own tests run it on the CPU: K9
(``last_row_pallas``, interpret mode) at the scorings where its NEG_INF
decay holds and ``fill_last_row`` at every scoring; the rows and tie
masks of nw_tpu's ``fill_diag`` (what ``fill_matrix`` returns) for K12's
checkpoint rows, K11's score and K2's masks; K10
(``fill_arrows_fold_batch``, interpret mode) for the pair-at-a-time
masks.  Sides end one row short of, on and one row past 32 W and 32 G W
rows (where the bands wrap around to block 0) and r C checkpoint rows
(C = 32, 224: r = 1, 2; C = 1 280: r = 1).  Every output is an integer:
comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nw_tpu.ops.encode import encode_batch as jencode_batch
from nw_tpu.ops.fill_pallas_single import fill_arrows_fold_batch as k10_fold
from nw_tpu.ops.fill_pallas_single import last_row_pallas
from nw_tpu.ops.fill_scan import diag_to_matrix as j_diag_to_matrix
from nw_tpu.ops.fill_scan import fill_diag as j_fill_diag
from nw_tpu.ops.fill_scan import fill_last_row as j_fill_last_row
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded, fill_single
from nw_tpu_torch.ops.fill_banded import MASK_RING, SMEM_LIMIT, fill_smem, single_blocks, single_warps

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

H100_SMS = 132
CPU = torch.device("cpu")
SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2), (1, 1, 2**30), (1, 2**30, 1),
            (2**31 - 1, -(2**31), 2**30)]


# ---------------- the launch shape ----------------


@pytest.mark.parametrize(
    "A,Bs,warps,blocks",
    [
        (256, 128, 4, 1),  # Hirschberg's small splits: as few warps as bands, one block
        (640, 320, 8, 2),
        (2_560, 1_280, 8, 5),
        (10_240, 5_120, 8, 20),  # the 10 kb pair's top-level split
        (20_000, 10_000, 8, 40),
        (10_240, 10_240, 8, 40),  # nw_fill_masks at 10 kb: K10's pairs
        (100_000, 100_000, 12, 132),  # K11, K12 at 100 kb
    ],
)
def test_rows_and_masks_modes_take_the_pipelines_rule(A, Bs, warps, blocks):
    """K9's splits, K10's pairs and K11 / K12's 100 kb pair take the
    single-pair pipeline's W and G (single_warps / single_blocks)."""
    assert single_warps(A, Bs, H100_SMS) == warps
    assert single_blocks(Bs, warps, H100_SMS) == blocks


# ---------------- where the top goes, and the scratch ----------------


@pytest.mark.parametrize("A,warps,masks,staged", [
    (10_240, 8, True, True),
    (100_000, 8, True, True),  # 224 992 bytes with the 8 warps' rings of masks
    (100_000, 12, True, False),  # 237 296: the rings push the top out
    (100_000, 12, False, True),  # the same block without masks (K8's): 212 720
    (100_000, 32, True, False),
    (103_500, 8, True, True),  # 232 032 of the 232 448
    (104_000, 8, True, False),
])
def test_the_masks_rings_count_where_the_top_goes(A, warps, masks, staged):
    """nw_fill_masks adds each warp's ring of tie masks (32 rows of 64
    bytes) to the block's shared memory; the top is staged there only
    where it fits beside them, else in each block's int16 row of a device
    scratch."""
    assert fill_smem(warps, A, 8, masks=masks) - fill_smem(warps, A, 8) == (MASK_RING * warps if masks else 0)
    assert MASK_RING == 32 * 64
    top16, _, _ = fill_single.pipe_scratch(A, 3, warps, 8, CPU, masks=masks)
    assert (top16 is None) == staged == (fill_smem(warps, A, 8, masks=masks) <= SMEM_LIMIT)
    if not staged:
        assert top16.shape == (3, fill_banded.top_cols(A)) and top16.dtype == torch.int16


@pytest.mark.parametrize("cell,masks", [(4, False), (8, True)])
def test_scratch_of_the_rows_and_masks_modes(cell, masks):
    """The rows mode hands a score a column between blocks (K11, K12, K9:
    int32[G, A+1, 1]), the masks mode a score and a count (int32[G, A+1,
    2]); the blocks' counters start at 0; no ring of L2 boundary rows a
    warp is left."""
    top16, bnd, flags = fill_single.pipe_scratch(10_240, 20, 8, cell, CPU, masks=masks)
    assert top16 is None
    assert bnd.shape == (20, 10_241, cell // 4) and bnd.dtype == torch.int32
    assert flags.shape == (20,) and not flags.any()


def _pair(s1, s2):
    return torch.from_numpy(enc.encode(s1)), torch.from_numpy(enc.encode(s2))


@pytest.mark.parametrize("warps,blocks", [(0, None), (33, None), (None, 0)])
def test_wrappers_check_a_forced_shape_before_running(warps, blocks):
    """A forced W outside [1, 32] or G below 1 raises before any launch,
    in every wrapper of the rows and masks modes."""
    top, side = _pair(b"GATTACA", b"GCATGCU")
    T = enc.upload(enc.encode_batch([(b"GATTACA", b"GCAT")], 7, 4), "cpu")
    calls = [
        lambda: fill_single.score_fold(top, side, 1, 1, 1, warps=warps, blocks=blocks),
        lambda: fill_single.score_fold(top, side, 1, 1, 1, checkpoint_every=32, warps=warps, blocks=blocks),
        lambda: fill_single.last_row(top, side, 1, 1, 1, warps=warps, blocks=blocks),
        lambda: fill_banded.fill_arrows_banded_single(top, side, 1, 1, 1, warps=warps, blocks=blocks),
        lambda: fill_single.fill_arrows_fold_batch(*T, 1, 1, 1, warps=warps, blocks=blocks),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="warps" if blocks is None else "blocks"):
            call()


# ---------------- the plain paths at the pipeline's cuts ----------------

# sides one short of, on and one past 32 W (W = 2, 3) and 32 G W (G = 2,
# W = 3) rows, and an empty side; and r C rows (C = 32, 224: r = 1, 2; C
# = 1 280: r = 1), K12's cuts
W_CUTS = [0, 63, 64, 65, 95, 96, 97, 191, 192, 193]
C_CUTS = {C: [r * C + e for r in range(1, 2 + (C < 1280)) for e in (-1, 0, 1)] for C in (32, 224, 1280)}
CUTS = sorted(set(W_CUTS).union(*C_CUTS.values()))
A_CUT = 75


def _long_pair(seed):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    return letters[rng.integers(0, 4, A_CUT)].tobytes(), letters[rng.integers(0, 4, max(CUTS))].tobytes()


def _j_table(s1, s2, mkd):
    """nw_tpu's fill_diag of the pair, as (scores, masks) rectangles: row
    j does not depend on the rows below it, so the table of the longest
    side holds every cut's rows."""
    out = j_fill_diag(jnp.asarray(enc.encode(s1)), jnp.asarray(enc.encode(s2)), *mkd, with_scores=True)
    return (j_diag_to_matrix(np.asarray(out["scores"]), len(s1), len(s2)),
            j_diag_to_matrix(np.asarray(out["arrows"]), len(s1), len(s2)))


@pytest.mark.parametrize("mkd", SCORINGS)
def test_score_and_checkpoint_rows_plain_vs_nw_tpu_at_the_cuts(mkd):
    """K11 and K12: the score of the plain path against nw_tpu's
    fill_diag at the W cuts, and its score and rows 0, C, 2C, ... below
    row Bs at C = 32, 224, 1 280, Bs one short of, on and one past C (and
    2C), against nw_tpu's fill_diag rows and its fill_last_row."""
    s1, s2 = _long_pair(sum(mkd) % 1000)
    H, _ = _j_table(s1, s2, mkd)
    top, side = _pair(s1, s2)
    for Bs in W_CUTS:
        score, ck = fill_single.score_fold(top, side[:Bs], *mkd)
        assert ck is None and int(score) == int(H[Bs, A_CUT]), Bs
    for C, cuts in C_CUTS.items():
        for Bs in cuts:
            score, ck = fill_single.score_fold(top, side[:Bs], *mkd, checkpoint_every=C)
            assert int(score) == int(H[Bs, A_CUT]), (Bs, C)
            np.testing.assert_array_equal(ck.numpy(), H[0:Bs:C], err_msg=f"Bs {Bs} C {C}")
    jt, js = jnp.asarray(enc.encode(s1)), jnp.asarray(enc.encode(s2))
    for r0 in (224, 448, 1280):
        np.testing.assert_array_equal(np.asarray(j_fill_last_row(jt, js, *mkd, A_CUT, r0)), H[r0])


@pytest.mark.parametrize("mkd", SCORINGS)
def test_last_row_plain_vs_k9_and_fill_last_row_at_the_cuts(mkd):
    """K9: row Bs of the plain path against nw_tpu's fill_last_row at
    the W cuts and at C and 2C rows of K12's smaller cuts and, where K9's
    NEG_INF decay holds (|k|, |d| < 2^30), against K9 in interpret mode
    (one compiled shape, the true side length passed)."""
    s1, s2 = _long_pair(sum(mkd) % 1000 + 1)
    top, side = _pair(s1, s2)
    jt, js = jnp.asarray(enc.encode(s1)), jnp.asarray(enc.encode(s2))
    for Bs in W_CUTS + C_CUTS[32] + C_CUTS[224]:
        got = fill_single.last_row(top, side, *mkd, len2=Bs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_fill_last_row(jt, js, *mkd, A_CUT, Bs)), err_msg=str(Bs))
        if max(abs(mkd[1]), abs(mkd[2])) < 2**30:
            k9 = last_row_pallas(jt, js, *mkd, len2=Bs, interpret=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(k9)[: A_CUT + 1], err_msg=str(Bs))


@pytest.mark.parametrize("mkd", SCORINGS)
def test_masks_plain_vs_nw_tpu_at_the_cuts(mkd):
    """K2 for one pair: the plain path's masks (and -t scores), score and
    count against nw_tpu's fill_diag on every cut's rows."""
    s1, s2 = _long_pair(sum(mkd) % 1000 + 2)
    H, arrows = _j_table(s1, s2, mkd)
    top, side = _pair(s1, s2)
    for Bs in W_CUTS[::2] + [223, 449]:
        masks, scores, score, count = fill_banded.fill_arrows_banded_single(top, side[:Bs], *mkd, with_scores=True)
        np.testing.assert_array_equal(masks.numpy(), arrows[: Bs + 1], err_msg=str(Bs))
        np.testing.assert_array_equal(scores.numpy(), H[: Bs + 1], err_msg=str(Bs))
        assert score == int(H[Bs, A_CUT]) and 0 <= count < 2**32


@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)])
def test_fold_masks_plain_vs_k10_at_the_cuts(mkd):
    """K10: the plain path's masks, a pair at a time into a batch's
    table whose rows are wider than the pairs (ldm > A+1 on the card),
    against K10's packed words in interpret mode (cell (j, i): byte
    (i+j) & 3 of words[b, (i+j) >> 2, j]), and the scores."""
    rng = np.random.default_rng(sum(mkd) + 40)
    letters = np.frombuffer(b"ACGT", np.uint8)
    pairs = [(letters[rng.integers(0, 4, a)].tobytes(), letters[rng.integers(0, 4, b)].tobytes())
             for a, b in ((A_CUT, 63), (A_CUT - 9, 65), (40, 97), (A_CUT, 96), (0, 33), (17, 0))]
    tops, sides, l1, l2 = jencode_batch(pairs, A_CUT + 5, 97)
    words, sc = k10_fold(tops, sides, l1, l2, *mkd, interpret=True, packed=True)
    words = np.asarray(words)
    T = enc.upload(enc.encode_batch(pairs, A_CUT + 5, 97), "cpu")
    masks, scores, counts = fill_single.fill_arrows_fold_batch(*T, *mkd)
    assert masks.shape == (len(pairs), 98, A_CUT + 6)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(sc))
    for b, (s1, s2) in enumerate(pairs):
        jj, ii = np.mgrid[0 : len(s2) + 1, 0 : len(s1) + 1]
        kk = ii + jj
        want = (words[b, kk >> 2, jj] >> (8 * (kk & 3))) & 0xFF
        got = masks[b, : len(s2) + 1, : len(s1) + 1].numpy()
        # the origin's byte is K10's unspecified field; the port writes 0
        np.testing.assert_array_equal(got.ravel()[1:], want.ravel()[1:])
        assert got[0, 0] == 0 and not masks[b, len(s2) + 1 :].any() and not masks[b, :, len(s1) + 1 :].any()
