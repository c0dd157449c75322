"""nw_tpu_torch.ops.fill_flat (plain PyTorch) vs nw_tpu's flat fills on the CPU.

The port's flat-fill API against ``nw_tpu/ops/fill_pallas.py`` in
interpret mode (as tests/test_pallas.py runs it): scores against K7
(``fill_scores_pallas_batch``), scores and counts against K26
(``fill_scores_counts_pallas_batch``), tie masks, scores and counts
against K27 (``fill_arrows_pallas_batch(packed=True)``, its
diagonal-major words decoded cell by cell and compared on each true
table), and counts over the masks against K6 (``count_packed_pallas_batch``
over K27's words).  Every output is an integer, so every comparison is
exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from nw_tpu.ops.encode import encode_batch as jencode_batch
from nw_tpu.ops.fill_pallas import (
    count_packed_pallas_batch,
    fill_arrows_pallas_batch,
    fill_scores_counts_pallas_batch,
    fill_scores_pallas_batch,
)
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded, fill_flat, pathcount

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)]
A, BS = 72, 40  # the buckets: a multi-band side and a longer top


def _pairs(seed):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)

    def rand(n, lo, hi, alphabet=letters):
        return [
            (alphabet[rng.integers(0, len(alphabet), int(rng.integers(lo, A + 1)))].tobytes(),
             alphabet[rng.integers(0, len(alphabet), int(rng.integers(lo, hi + 1)))].tobytes())
            for _ in range(n)
        ]

    # random, tie-dense two-letter, all-'A' (the count wraps), edge pairs
    return (rand(8, 0, BS) + rand(3, 10, BS, letters[:2]) + [(b"A" * 40, b"A" * 36)]
            + [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"A", b"A"), (b"GCATGCU", b"GATTACA")])


def _inputs(mkd):
    pairs = _pairs(sum(mkd) + 60)
    return pairs, jencode_batch(pairs, A, BS), enc.upload(enc.encode_batch(pairs, A, BS), "cpu")


@pytest.mark.parametrize("mkd", SCORINGS)
def test_scores_match_k7(mkd):
    _, J, T = _inputs(mkd)
    want = fill_scores_pallas_batch(*J, *mkd, interpret=True)
    got = fill_flat.fill_scores_flat_batch(*T, *mkd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    torch.testing.assert_close(got, fill_flat.fill_scores_flat_batch_plain(*T, *mkd), rtol=0, atol=0)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_scores_counts_match_k26(mkd):
    _, J, T = _inputs(mkd)
    want_sc, want_ct = fill_scores_counts_pallas_batch(*J, *mkd, interpret=True)
    sc, ct = fill_flat.fill_scores_counts_flat_batch(*T, *mkd)
    assert sc.dtype == torch.int32 and ct.dtype == torch.int64
    np.testing.assert_array_equal(sc.numpy(), np.asarray(want_sc))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(want_ct).astype(np.int64))
    for g, w in zip((sc, ct), fill_flat.fill_scores_counts_flat_batch_plain(*T, *mkd)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("mkd", SCORINGS)
def test_arrows_match_k27(mkd, with_counts):
    """K27's packed words (cell (j, i): byte (i+j) & 3 of
    words[(i+j) >> 2, j, b]) against the port's masks on every cell of
    each true table, its scores and fused counts; and K6 over K27's
    words against the port's count over its masks."""
    pairs, J, T = _inputs(mkd)
    out = fill_arrows_pallas_batch(*J, *mkd, interpret=True, packed=True, with_counts=with_counts)
    words = np.asarray(out[0]).view(np.uint32)
    got = fill_flat.fill_arrows_flat_batch(*T, *mkd, with_counts=with_counts)
    assert len(got) == len(out) == (3 if with_counts else 2)
    masks = got[0]
    assert masks.dtype == torch.uint8 and masks.shape == (len(pairs), BS + 1, A + 1)
    for b, (s1, s2) in enumerate(pairs):
        jj, ii = np.mgrid[0 : len(s2) + 1, 0 : len(s1) + 1]
        kk = ii + jj
        want = (words[kk >> 2, jj, b] >> (8 * (kk & 3))) & 0xFF
        np.testing.assert_array_equal(masks[b, : len(s2) + 1, : len(s1) + 1].numpy(), want)
    assert int(masks.sum()) == sum(int(masks[b, : len(s2) + 1, : len(s1) + 1].sum()) for b, (s1, s2) in enumerate(pairs))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(out[1]))
    k6 = np.asarray(count_packed_pallas_batch(out[0], J[2], J[3], interpret=True)).astype(np.int64)
    counts = fill_flat.count_flat_batch(masks, T[2], T[3])
    np.testing.assert_array_equal(counts.numpy(), k6)
    if with_counts:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(out[2]).astype(np.int64))
        np.testing.assert_array_equal(got[2].numpy(), k6)
    for g, w in zip(got, fill_flat.fill_arrows_flat_batch_plain(*T, *mkd, with_counts=with_counts)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(counts, fill_flat.count_flat_batch_plain(masks, T[2], T[3]), rtol=0, atol=0)


def test_flat_api_is_served_by_the_batched_fills():
    """The flat functions give the batched wrappers' outputs on the same
    inputs (the kernels that serve them on the card)."""
    _, _, T = _inputs((2, 1, 1))
    serving = (fill_banded.fill_scores_banded_batch, fill_banded.fill_scores_counts_banded_batch,
               fill_banded.fill_masks_banded_batch, pathcount.count_masks_batch)
    before = [w.launches for w in serving]
    torch.testing.assert_close(fill_flat.fill_scores_flat_batch(*T, 2, 1, 1),
                               fill_banded.fill_scores_banded_batch(*T, 2, 1, 1), rtol=0, atol=0)
    for g, w in zip(fill_flat.fill_scores_counts_flat_batch(*T, 2, 1, 1),
                    fill_banded.fill_scores_counts_banded_batch(*T, 2, 1, 1)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    masks, sc, ct = fill_flat.fill_arrows_flat_batch(*T, 2, 1, 1, with_counts=True)
    for g, w in zip((masks, sc, ct), fill_banded.fill_masks_banded_batch(*T, 2, 1, 1, with_counts=True)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(fill_flat.count_flat_batch(masks, T[2], T[3]),
                               pathcount.count_masks_batch(masks, T[2], T[3]), rtol=0, atol=0)
    # CPU tensors run the plain versions: no kernel launches
    assert [w.launches for w in serving] == before
