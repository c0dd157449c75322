"""The Smith-Waterman and overlap code fills on the W-warp pipeline
(``sw_fill_codes``, ``overlap_fill_codes``) on the CPU: the rule for W at
their shapes, the checks of a forced W, and the plain path against
nw_tpu's K18 / K19 full alignments where the pipeline cuts.

The pipeline runs only on the card (``tests/test_torch_kernels_variants.py``,
``-m cuda``, holds both fills at every forced W against the plain
versions); on CPU tensors the wrappers run those plain versions.  So
here the plain path (codes, best and its cell, and ``sw_walk``'s plain
version on the codes) is held against nw_tpu's
``sw_traceback_banded_batch`` / ``overlap_traceback_banded_batch`` in
interpret mode (small ``band_rows``, as tests/test_torch_free_pipe.py
runs K18 / K19) on the batches of tests/test_torch_free_pipe.py: sides
one row short of, on and one row past a multiple of 32 W rows, band
counts that are not a multiple of W, mixed lengths, empty sides and
tops, and the placed bests (in a band on warp 1, on the last row, in
two warps' bands at once, on the end window's last column and row),
plus a pair whose two equal bests lie in bands b and b + W, on one lane
of one warp.  Every output is an integer: comparisons are exact.
"""

import numpy as np
import pytest

from nw_tpu.ops.variants_banded import overlap_traceback_banded_batch as k19_traceback
from nw_tpu.ops.variants_banded import sw_traceback_banded_batch as k18_traceback
from nw_tpu_torch.ops import fill_banded
from nw_tpu_torch.ops import traceback as tb
from nw_tpu_torch.ops import variants_banded as vb
from nw_tpu_torch.ops.fill_banded import fill_warps

from test_torch_free_pipe import A_BUCKET, CUTS, GEOMETRY, H100_SMS, MOTIF, _batch, _pairs, _torch

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# a second motif, far from MOTIF: their cross alignments score well below 24
MOTIF2 = b"TTAGCCATGGAC"


def _same_lane(Bs, W):
    """A pair whose best (24 at 2 1 1) lies twice: MOTIF2 at the top's
    end on row 20 (band 0, lane 19) and MOTIF at the top's start on row
    20 + 32 w (band w, lane 19), with w = W where the bucket holds it:
    one lane of warp 0 holds both.  Their diagonals are 100 and 32 + 32 w,
    so the later band wins at w <= 2 and the earlier at w >= 3."""
    w = max(1, min(W, (Bs - 20) // 32))
    top = MOTIF + b"C" * (A_BUCKET - 2 * len(MOTIF)) + MOTIF2
    side = b"G" * 8 + MOTIF2 + b"G" * (32 * w - len(MOTIF)) + MOTIF
    return top, side + b"G" * (Bs - len(side))


@pytest.mark.parametrize("B,L,want", [(128, 3_072, 32), (4_096, 150, 1), (4, 3_072, 32), (30, 300, 10)])
def test_rule_at_the_code_fill_shapes(B, L, want):
    """fill_warps' W for the code fills (4-byte ring cells, as the score
    fills'): 32 warps a pair at 128 x 3 072 bp (bench.py:414) and at 4
    pairs of it, one at 4 096 x 150 bp (bench.py:291), a warp a band at
    30 x 300 bp (10 bands)."""
    assert fill_warps(B, L, L, 4, H100_SMS) == want


@pytest.mark.parametrize("kind", ["sw", "overlap"])
def test_forced_warps_are_checked(kind):
    """A forced W outside [1, 32], or one whose rings leave no room for a
    112 000-column top in shared memory, raises before any launch."""
    wrapper = getattr(vb, f"{kind}_fill_codes_banded_batch")

    def launch(A, warps):
        T = _torch(np.zeros((1, A), np.int32), np.zeros((1, 40), np.int32),
                   np.array([A], np.int32), np.array([40], np.int32))
        return vb._launch_codes(wrapper, f"{kind}_fill_codes", *T, 2, 1, 1, warps=warps)

    launches = wrapper.launches
    for bad in (0, 33):
        with pytest.raises(ValueError, match="warps"):
            launch(100, bad)
    with pytest.raises(ValueError, match="shared memory"):
        launch(112_000, 32)
    assert fill_banded.top_in_smem(112_000, 4)
    assert wrapper.launches == launches


def _vs_traceback(kind, W, Bs, scorings):
    pairs = _pairs(Bs, 400 * W + Bs + (kind == "overlap")) + [_same_lane(Bs, W)]
    tops, sides, l1, l2 = _batch(pairs, Bs)
    ref = k18_traceback if kind == "sw" else k19_traceback
    plain = getattr(vb, f"{kind}_fill_codes_banded_batch_plain")
    for mkd in scorings:
        codes, best, jst, ist = plain(*_torch(tops, sides, l1, l2), *mkd)
        ops, n, i_end, j_end = (t.numpy() for t in tb.walk_sw_codes_batch_plain(codes, jst, ist))
        w_best, w_jst, w_ist, w_jend, w_iend, w_ops, w_n = ref(tops, sides, l1, l2, *mkd, interpret=True,
                                                               **GEOMETRY)
        np.testing.assert_array_equal(best.numpy(), w_best, err_msg=str(mkd))
        np.testing.assert_array_equal(jst.numpy(), w_jst, err_msg=str(mkd))
        np.testing.assert_array_equal(ist.numpy(), w_ist, err_msg=str(mkd))
        np.testing.assert_array_equal(n, w_n, err_msg=str(mkd))
        np.testing.assert_array_equal(j_end, w_jend, err_msg=str(mkd))
        np.testing.assert_array_equal(i_end, w_iend, err_msg=str(mkd))
        for b in range(len(pairs)):
            np.testing.assert_array_equal(ops[b, : n[b]], w_ops[b, : n[b]], err_msg=f"{mkd} pair {b}")
    return best.numpy(), jst.numpy(), ist.numpy()


@pytest.mark.parametrize("W,Bs", CUTS)
def test_sw_codes_cuts_vs_k18_traceback(W, Bs):
    """The plain codes path at the pipeline's cuts against K18's full
    alignments (it follows the scan at k, d >= 0)."""
    best, jst, ist = _vs_traceback("sw", W, Bs, [(1, 1, 1), (2, 1, 1)])
    # the placed bests (2 1 1), and the same-lane pair's winner
    assert best[-6:-2].tolist() == [24, 24, 24, 24], best[-6:]
    w = max(1, min(W, (Bs - 20) // 32))
    assert (best[-1], jst[-1], ist[-1]) == ((24, 20 + 32 * w, 12) if 32 + 32 * w < 100 else (24, 20, 80))


@pytest.mark.parametrize("W,Bs", CUTS)
def test_overlap_codes_cuts_vs_k19_traceback(W, Bs):
    """The plain codes path at the pipeline's cuts against K19's full
    alignments (it follows the scan at every scoring)."""
    best, jst, ist = _vs_traceback("overlap", W, Bs, [(3, -1, 2), (2, 1, 1)])
    # OVERLAP_TWO_BANDS (2 1 1): the last row's cell in band 2 beats band
    # 0's last column on its earlier diagonal (or the empty pair)
    assert (best[-2], jst[-2], ist[-2]) == ((40, 70, 20) if Bs >= 70 else (0, 0, 0))
