"""CUDA kernels of nw_tpu_torch vs their plain PyTorch versions.

These need an NVIDIA card (sm_90a) and nvcc; without one they skip.  On
the card: ``python -m pytest -m cuda tests/test_torch_kernels.py``.
Every output is an integer: comparisons are exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from nw_tpu_torch import align_batch
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded, traceback

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
