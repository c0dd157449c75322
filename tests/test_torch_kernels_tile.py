"""CUDA kernels of nw_tpu_torch vs their plain PyTorch versions: the
tiles of a pair whose rows are sharded (``nw_fill_tile``, K14's mesh half
and K28, the single-pair pipeline's tile modes) and the mask walk relayed
over them.

The tile kernel runs a tile of C columns from column c0 as a pair of
c0 % 16 + C columns whose first c0 % 16 are idle, so that its code words
line up with the rank's table: the cases here hold every geometry it
treats apart (c0 % 16 of 0, 1 and 15, c0 % 32 of 16; C of 0, 1, 29, 31,
32 and 33; H of 1, 31, 32 and 33; a last tile; two tiles that share code
words) at forced W of 1-32 and blocks that wrap, bit for bit against
``fill_tile_plain``, and the tiles chained over a pair against the whole
pair's ``nw_fill_codes_single`` codes and ``nw_fill_masks`` masks.

These need an NVIDIA card (sm_90a) and nvcc; without one they skip.  On
the card: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_tile.py``.
Every output is an integer: comparisons are exact (tolerance 0).
"""

import functools

import numpy as np
import pytest
import torch

from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded, fill_single, traceback
from nw_tpu_torch.ops.fill_scan import diag_to_matrix, fill_diag
from nw_tpu_torch.parallel.huge_pair import _new_table, chain_tiles

from torch_kernel_cases import (  # noqa: F401 (cuda is a fixture)
    SCORINGS, cuda, _single_pairs, _pair_tensors, _lens,
)

pytestmark = pytest.mark.cuda


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


# ---------------- one tile at the geometries the kernel treats apart ----------------

MODES = ("scores", "codes", "masks")
TILE_A, TILE_R0 = 200, 37  # the pair's width; the tiles' first row (r0 > 0: the halo is no row 0)
# (c0, C, H): c0 % 16 of 0, 1 and 15 and c0 % 32 of 16; C of 0, 1, 29, 31,
# 32 and 33; H of 1, 31, 32 and 33; last tiles (c0 + C == TILE_A), one of
# them C = 0
TILE_GEOMS = [(0, 29, 33), (1, 31, 32), (15, 32, 31), (16, 33, 1), (17, 0, 33), (31, 1, 32),
              (32, 45, 64), (47, 153, 70), (185, 15, 31), (199, 1, 1), (200, 0, 5), (160, 40, 100)]
TILE_SHAPES = [(1, 1), (2, 2), (None, 8), (None, None)]


@functools.lru_cache(maxsize=None)
def _tile_pair(mkd):
    """(top, side, scores): a TILE_A x (TILE_R0 + 700) pair and its whole
    table's scores on the CPU, once a scoring (the tiles' edges are its
    rows and columns)."""
    rng = np.random.default_rng(sum(mkd) % 1000 + 40)
    letters = np.frombuffer(b"ACGT", np.uint8)
    top, side = (torch.from_numpy(enc.encode(letters[rng.integers(0, 4, n)].tobytes()))
                 for n in (TILE_A, TILE_R0 + 700))
    out = fill_diag(top, side, *mkd, with_arrows=False, with_scores=True)
    return top, side, diag_to_matrix(out["scores"], TILE_A, side.shape[0])


def _tables(mode, codes, masks):
    return (codes, None) if mode == "codes" else (None, masks)


def _tile_vs_plain(cuda, mkd, c0, C, H, shapes, modes=MODES):
    """Each mode of the tile of rows TILE_R0+1 .. TILE_R0+H, columns c0+1
    .. c0+C, with the whole table's edges, at each (blocks, warps) of
    ``shapes`` against fill_tile_plain: edges, corner and table."""
    top, side, rect = _tile_pair(mkd)
    rows = side[TILE_R0 : TILE_R0 + H]
    halo, left = rect[TILE_R0, c0 : c0 + C + 1].clone(), rect[TILE_R0 + 1 : TILE_R0 + H + 1, c0].clone()
    args = [t.to(cuda) for t in (top, rows, halo, left)]
    for mode in modes:
        table = _new_table(mode, TILE_A, H, "cpu")
        want = fill_single.fill_tile_plain(top, rows, *mkd, c0, C, halo, left, *_tables(mode, table, table))
        assert int(want[2]) == int(rect[TILE_R0 + H, c0 + C])
        for blocks, warps in shapes:
            msg = f"{mode}, c0 {c0}, C {C}, H {H}, blocks {blocks}, warps {warps}"
            got_table = _new_table(mode, TILE_A, H, cuda)
            got = fill_single.fill_tile(args[0], args[1], *mkd, c0, C, args[2], args[3],
                                        *_tables(mode, got_table, got_table), warps=warps, blocks=blocks)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0, msg=msg)
            if table is not None:
                torch.testing.assert_close(got_table.cpu(), table, rtol=0, atol=0, msg=msg)


@pytest.mark.parametrize("c0,C,H", TILE_GEOMS)
@pytest.mark.parametrize("mkd", SCORINGS)
def test_tile_geometries_vs_plain(cuda, mkd, c0, C, H):
    """One tile in each mode at one of the geometries the kernel treats
    apart, at one and two warps, 8 warps and the rule's shape."""
    _tile_vs_plain(cuda, mkd, c0, C, H, TILE_SHAPES)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_tile_at_every_warp_vs_plain(cuda, mkd):
    """A 700-row tile (22 bands) from c0 = 15 at every W of 1-32 with
    blocks by the rule, and at 2 x 3 and 3 x 1 warps, which wrap."""
    shapes = [(None, w) for w in range(1, 33)] + [(2, 3), (3, 1)]
    _tile_vs_plain(cuda, mkd, 15, 150, 700, shapes)


@pytest.mark.parametrize("cut", [1, 15, 16, 17, 21, 31, 32, 33, 47])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 2**30, 1)])
def test_neighbouring_tiles_share_code_words(cuda, mkd, cut):
    """Two tiles cut at column ``cut`` (the words of a band row that hold
    columns of both) into one zeroed table, at one warp and the rule's
    shape: the table after each tile equals the plain tiles', and after
    both the whole rows' codes (nw_fill_codes_single from their seed
    row)."""
    top, side, rect = _tile_pair(mkd)
    H = 100
    rows = side[TILE_R0 : TILE_R0 + H]
    want_whole, _ = fill_single.fill_codes_single_plain(top, side, *mkd, len2=TILE_R0 + H, r0=TILE_R0,
                                                        seed=rect[TILE_R0])
    for blocks, warps in [(1, 1), (None, None)]:
        got_t = _new_table("codes", TILE_A, H, cuda)
        want_t = _new_table("codes", TILE_A, H, "cpu")
        for c0, C in ((0, cut), (cut, TILE_A - cut)):
            halo = rect[TILE_R0, c0 : c0 + C + 1].clone()
            left = rect[TILE_R0 + 1 : TILE_R0 + H + 1, c0].clone()
            fill_single.fill_tile_plain(top, rows, *mkd, c0, C, halo, left, want_t)
            fill_single.fill_tile(top.to(cuda), rows.to(cuda), *mkd, c0, C, halo.to(cuda), left.to(cuda),
                                  got_t, warps=warps, blocks=blocks)
            torch.testing.assert_close(got_t.cpu(), want_t, rtol=0, atol=0, msg=f"after the tile at {c0}")
        torch.testing.assert_close(got_t.cpu(), want_whole, rtol=0, atol=0)
