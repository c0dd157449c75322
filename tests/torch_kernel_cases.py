"""The inputs, launch shapes and fixture shared by the CUDA kernel tests
(``tests/test_torch_kernels_*.py``): the scorings, the random, tie-dense
and edge pairs made from seeds with numpy, and the batched pipeline's
launches at a forced W."""

import numpy as np
import pytest
import torch

from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded

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
# the single-pair pipeline (nw_score_count, nw_fill_codes_single,
# nw_score_single, nw_fill_masks): SHAPES, every W of a block with blocks
# by the rule, the rule's shape, and 2 blocks of 3 warps, which wrap
# around over the 700 bp pair's 22 bands
SINGLE_PIPE_SHAPES = SHAPES + [(None, w) for w in (1, 2, 3, 4, 16, 32)] + [(None, None), (2, 3)]
PAIR_700 = [(b"ACGTTGCA" * 80 + b"ACG", b"GATTACCA" * 87 + b"GCTA")]  # 643 x 700


def _one(s, cuda=None):
    t = torch.from_numpy(enc.encode(s))
    return t if cuda is None else t.to(cuda)


def _lens(x, cuda):
    return torch.tensor([x], dtype=torch.int32, device=cuda)
