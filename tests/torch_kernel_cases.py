"""The inputs, launch shapes and fixture shared by the CUDA kernel tests
(``tests/test_torch_kernels_*.py``): the scorings, the random, tie-dense
and edge pairs made from seeds with numpy, and the batched pipeline's
launches at a forced W."""

import importlib.util
from pathlib import Path

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


# the pipeline's byte modes (nw_fill_masks_batch, nw_fill_runs_batch) at
# forced warps a pair and at the rule's (None)
BYTE_WARPS = [1, 2, 3, 7, 16, 31, 32, None]


def _byte_batches(seed, device):
    """The byte fills' batches: _pipe_batches' two (23 pairs, an odd B,
    at 5 bands; 35 bands, two rounds of 32 warps), a lone pair (B = 1) of
    97 rows, and diagonals past the 63 cap across 32-row bands beside a
    left run past it."""
    base = _pairs(seed + 50, 1, 700, 701)[0][0]
    lone = [(_pairs(seed + 4, 1, 60, 300)[0][0], _pairs(seed + 5, 1, 97, 98)[0][1])]
    runs = [(base, base), (base[:64], base[:64]), (base, base[:300]), (base[:400], base),
            (b"T" + b"A" * 200, b"T")]
    out = _pipe_batches(seed, device)
    for ps, A, Bs in ((lone, 300, 97), (runs, 704, 700)):
        arrays = enc.encode_batch(ps, A, Bs)
        out.append((enc.upload(arrays, "cpu"), enc.upload(arrays, device)))
    return out


def _byte_fill(kind, T, mkd, with_counts, warps):
    """``nw_fill_{kind}_batch`` (kind ``masks`` or ``runs``) at ``warps``
    warps a pair (None: the rule's): the table, scores and, with counts,
    counts."""
    wrapper = getattr(fill_banded, f"fill_{kind}_banded_batch")
    out = fill_banded._fill_bytes_kernel(wrapper, f"nw_fill_{kind}_batch", *T, *mkd, with_counts, warps)
    return tuple(x for x in out if x is not None)


def _byte_plain(kind, T, mkd, with_counts):
    out = getattr(fill_banded, f"fill_{kind}_banded_batch_plain")(*T, *mkd, with_counts=with_counts)
    return tuple(x for x in out if x is not None)


def _bytes_with_the_top_in_device_memory(kind, device):
    """An 80 000-column top fits beside 3 warps' rings but not beside
    32's, so W = 32 stages it in device memory and W = 1, 3 in shared
    memory: every W against the plain version under 2 1 1 (with counts),
    and against W = 3 under a wrapping scoring (without)."""
    rng = np.random.default_rng(41)
    letters = np.frombuffer(b"ACGT", np.uint8)
    ps = [(letters[rng.integers(0, 4, a)].tobytes(), letters[rng.integers(0, 4, s)].tobytes())
          for a, s in ((80_000, 40), (79_990, 33), (50_000, 7))]
    arrays = enc.encode_batch(ps, 80_000, 40)
    cpu, dev = enc.upload(arrays, "cpu"), enc.upload(arrays, device)
    assert fill_banded._top_scratch(3, 80_000, 8, device, 32, ring=fill_banded.BYTE_RING) is not None
    assert fill_banded._top_scratch(3, 80_000, 8, device, 3, ring=fill_banded.BYTE_RING) is None
    want = _byte_plain(kind, cpu, (2, 1, 1), True)
    for warps in (1, 3, 32):
        got = _byte_fill(kind, dev, (2, 1, 1), True, warps)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0, msg=f"W = {warps}")
    mkd = (1, 1, 2**30)
    ref = _byte_fill(kind, dev, mkd, False, 3)
    got = _byte_fill(kind, dev, mkd, False, 32)
    for g, w in zip(got, ref):
        assert torch.equal(g, w)


def _single_pairs(seed):
    # several bands (32 rows each) and chunks, ties, edges, a wrapping count
    return (
        _pairs(seed, 6, 0, 200) + _pairs(seed + 1, 3, 20, 90, "AC") + EDGE
        + [(b"A" * 24, b"A" * 16)]
    )


# the walks' edge shapes (the code, masks, variant and run walks'), their
# starts and the random tie-mask and code tables, one definition with
# chip_smoke.py's card checks of the same kernels
_spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
WALK_EDGE_SHAPES, MASK_WALK_EDGE_SHAPES = chip_smoke.WALK_EDGE_SHAPES, chip_smoke.MASK_WALK_EDGE_SHAPES
MASK_STRIDES = chip_smoke.MASK_STRIDES
walk_edge_pairs, mask_edge_pairs, random_masks = (chip_smoke.walk_edge_pairs, chip_smoke.mask_edge_pairs,
                                                  chip_smoke.random_masks)
VARIANT_WALK_EDGE_SHAPES = chip_smoke.VARIANT_WALK_EDGE_SHAPES
RUNS_WALK_EDGE_SHAPES, RUNS_WIDTHS, runs_edge_pairs = (chip_smoke.RUNS_WALK_EDGE_SHAPES, chip_smoke.RUNS_WIDTHS,
                                                       chip_smoke.runs_edge_pairs)
variant_edge_pairs, variant_walk_starts, starts_batch, random_code_words = (
    chip_smoke.variant_edge_pairs, chip_smoke.variant_walk_starts, chip_smoke.starts_batch,
    chip_smoke.random_code_words)
# the two-pass kernels' chains: nw_fill_span over a table in spans, nw_walk_groups over its groups
span_chain, groups_walk = chip_smoke.span_chain, chip_smoke.groups_walk
SPAN_VARIANTS, GROUP_SIZES = chip_smoke.SPAN_VARIANTS, chip_smoke.GROUP_SIZES
# nw_fill_span at forced warps a pair, every W of 1-32 kinds, and the rule's (None)
SPAN_WARPS = [*chip_smoke.SPAN_WARPS, None]
# the variant two-pass route's chains: free_fill_span / gotoh_fill_span over a
# table in spans, sw_walk_groups / gotoh_walk_groups over its groups
variant_span_chain, variant_groups_walk, variant_cursor = (chip_smoke.variant_span_chain,
                                                           chip_smoke.variant_groups_walk, chip_smoke.variant_cursor)
VARIANT_KINDS = chip_smoke.VARIANT_KINDS
# the variant span fills at forced warps a pair (and the rule's, None)
VARIANT_SPAN_WARPS = [*chip_smoke.VARIANT_SPAN_WARPS, None]


def _mask_window_chain(masks, C):
    """(r0, rows) of every block of C rows of one pair's rectangular masks
    uint8[len2+1, A+1], the last block first: rows r0+1 .. r0+C, each a
    view into ``masks`` (so at any alignment)."""
    len2 = masks.shape[0] - 1
    return [(r0, masks[r0 + 1 : min(r0 + C, len2) + 1]) for r0 in range(-(-len2 // C) * C - C, -1, -C)]


def _window_chain(s1, s2, mkd, C, fill_codes, score_fold, device=None):
    """(r0, codes) of every block of C rows of one pair, the last block
    first, each re-filled from its checkpoint row, as
    traceback_checkpointed walks them (none when len2 is 0)."""
    top, side = _pair_tensors(s1, s2)
    if device is not None:
        top, side = top.to(device), side.to(device)
    _, ckpt = score_fold(top, side, *mkd, checkpoint_every=C)
    chain = []
    for b in range(ckpt.shape[0] - 1, -1, -1):
        r0, r1 = b * C, min(len(s2), (b + 1) * C)
        codes, _ = fill_codes(top, side, *mkd, len2=r1, r0=r0, seed=ckpt[b] if r0 else None)
        chain.append((r0, codes))
    return chain


def _walk_chain(walk, chain, len1, len2, device=None):
    """(state, ops) of ``walk`` chained over ``chain`` from the corner."""
    state = torch.tensor([len1, len2, 0], dtype=torch.int32, device=device)
    ops = torch.full((len1 + len2,), 3, dtype=torch.int8, device=device)
    for r0, codes in chain:
        walk(codes, state, r0, ops)
    return state, ops


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
