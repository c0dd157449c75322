"""nw_tpu_torch.parallel against nw_tpu.parallel on the CPU.

The port's ranks are gloo worker processes that import only
``nw_tpu_torch`` (:class:`nw_tpu_torch.parallel.workers.RankGroup`), one
group per world size for the whole module; ``nw_tpu``'s side runs in
this process on conftest's 8-device CPU mesh.  Inputs are made from
fixed seeds with numpy.  Tolerance: exact (equal int32 scores, equal
uint32 counts and statistics, byte-equal ops).
"""

import inspect
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nw_tpu.ops import encode as jenc
from nw_tpu.ops import traceback as jtb
from nw_tpu.ops.fill_scan import fill_diag as jfill_diag
from nw_tpu.parallel import data_parallel as jdp
from nw_tpu.parallel import huge_pair as jhp
from nw_tpu_torch import NWAligner
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded as tfb
from nw_tpu_torch.ops import fill_single as tfs
from nw_tpu_torch.ops import traceback as ttb
from nw_tpu_torch.ops.fill_scan import diag_to_matrix, fill_diag
from nw_tpu_torch.ops.fill_single import fill_codes_single_plain
from nw_tpu_torch.parallel import data_parallel as tdp
from nw_tpu_torch.parallel import distributed as tdist
from nw_tpu_torch.parallel import huge_pair as thp
from nw_tpu_torch.parallel.workers import MESH, PerRank, RankGroup

WORLDS = (1, 2, 4)
ORDINARY = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)]
LARGE = [(1, 1, 2**30), (1, 2**30, 1), (2**31 - 1, -(2**31), 2**30)]
CHUNKS = (8, 13, 16, 64)
EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"ACGTACGTAC", b"AC"), (b"A", b"A")]


def _rand(rng, lo, hi, alphabet="ACGT") -> bytes:
    return "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode()


def _pairs(seed, n, lo=0, hi=60):
    rng = np.random.default_rng(seed)
    return [(_rand(rng, lo, hi), _rand(rng, lo, hi)) for _ in range(n)] + [
        (_rand(rng, lo, hi, "AC"), _rand(rng, lo, hi, "AC"))
    ]


@pytest.fixture(scope="module")
def ranks():
    """One gloo group of CPU ranks per world size, started together."""
    with ThreadPoolExecutor(len(WORLDS)) as ex:
        groups = dict(zip(WORLDS, ex.map(lambda w: RankGroup(w, "gloo", "cpu", axis="seq"), WORLDS)))
    yield groups
    for g in groups.values():
        g.close()


def _mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} (virtual) devices")
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


def _nw_tpu_align(a, b, mkd, n, engine="scan", chunk=8, **kw):
    top = jnp.asarray(jenc.encode(a), dtype=jnp.int32)
    side = jnp.asarray(jenc.encode(b), dtype=jnp.int32)
    r = jhp.huge_pair_align_sharded(top, side, *mkd, _mesh(n), chunk=chunk, engine=engine, **kw)
    return r.score, np.asarray(r.ops)


def _fill_scan_walk(a, b, mkd):
    """fill_scan's answer: nw_tpu's fill_diag + traceback_greedy."""
    ref = jfill_diag(jnp.asarray(jenc.encode(a)), jnp.asarray(jenc.encode(b)), *mkd)
    ops, n = jtb.traceback_greedy(ref["arrows"], len(a), len(b), max_steps=max(len(a) + len(b), 1))
    return int(ref["score"]), np.asarray(ops)[: int(n)]


def _port(group, a, b, mkd, chunk, engine=None):
    """(align results, scores) of every rank."""
    args = (enc.encode(a), enc.encode(b), *mkd, MESH)
    kw = dict(axis="seq", chunk=chunk, engine=engine, device="cpu")
    return group.run(thp.huge_pair_align_sharded, *args, **kw), group.run(
        thp.huge_pair_score_sharded, *args, **kw)


def _assert_port(group, a, b, mkd, chunk, score, ops, engine=None):
    res, scores = _port(group, a, b, mkd, chunk, engine)
    for r, sc in zip(res, scores):
        assert (r.score, sc, r.n) == (score, score, len(ops)), (a, b, mkd, chunk)
        np.testing.assert_array_equal(r.ops, ops)


# ---------------- the tile, plain ----------------

# (rows H a block, columns C a chunk) of the chained tiles, a pair each
PLAIN_GRIDS = [(2, 9), (7, 8), (13, 13), (16, 16), (33, 64), (20, 1)]
# the geometries the tile kernel treats apart, each over every pair: tiles
# from c0 % 16 of 15, 1, 14, 2, ... (chunks of 15, 17, 31, 33 and 45
# columns), row blocks one short of and one past a band (31, 33)
CUT_GRIDS = [(31, 15), (33, 17), (31, 31), (33, 33), (31, 45), (33, 45)]


@pytest.mark.parametrize("grid", [None] + CUT_GRIDS)
@pytest.mark.parametrize("mkd", ORDINARY + LARGE)
def test_plain_tiles_stitch_to_the_whole_pair(mkd, grid):
    """The plain tile chained over a grid of row blocks and column chunks
    gives the whole pair's codes, tie masks, last row and corner (grid
    None: PLAIN_GRIDS, a grid a pair)."""
    grids = PLAIN_GRIDS if grid is None else [grid]
    for n, (a, b) in enumerate(_pairs(sum(mkd) % 1000, 2) + EDGE):
        if not b:
            continue
        top, side = torch.from_numpy(enc.encode(a)), torch.from_numpy(enc.encode(b))
        ref = fill_diag(top, side, *mkd, with_scores=True)
        rect = diag_to_matrix(ref["scores"], len(a), len(b))
        masks = diag_to_matrix(ref["arrows"], len(a), len(b))[1:]
        codes, score = fill_codes_single_plain(top, side, *mkd)
        H, C = grids[n % len(grids)]
        for mode in ("scores", "codes", "masks"):
            tables, last, corner = thp.chain_tiles(top, side, *mkd, H, C, mode)
            assert corner == int(score) == int(ref["score"])
            torch.testing.assert_close(last, rect[len(b)], rtol=0, atol=0)
            if mode == "masks":
                torch.testing.assert_close(torch.cat(tables), masks, rtol=0, atol=0)
            if mode == "codes":  # each block's codes, as if its rows stood alone
                for p, t in enumerate(tables):
                    r0, r1 = p * H, min(len(b), (p + 1) * H)
                    want, _ = fill_codes_single_plain(top, side, *mkd, len2=r1, r0=r0,
                                                      seed=rect[r0]) if r0 else \
                        fill_codes_single_plain(top, side, *mkd, len2=r1)
                    torch.testing.assert_close(t, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "C,H,blocks,warps",
    [
        (100_000, 50_000, 131, 12),  # rank 0's tile at 2 ranks of the 100 kb pair
        (100_000, 100_000, 132, 12),  # the 1-rank tile: the whole pair
        (10_016, 5_000, 20, 8),  # K28's tile at 4 ranks of the 20 kb pair
        (150, 700, 3, 8),
        (45, 40, 1, 2),  # as few warps as bands
        (0, 33, 1, 2),
    ],
)
def test_tile_takes_the_pipelines_rule(monkeypatch, C, H, blocks, warps):
    """fill_tile's launch shape defaults to the single-pair pipeline's
    rule at (C, H) (pipe_shape: single_warps / single_blocks on the
    H100's 132 SMs), and a forced one passes as given."""
    params = inspect.signature(tfs.fill_tile).parameters
    assert params["warps"].default is None and params["blocks"].default is None
    monkeypatch.setattr(tfb, "_sms", lambda device: 132)
    assert tfs.pipe_shape(C, H, torch.device("cpu")) == (blocks, warps)
    assert tfs.pipe_shape(C, H, torch.device("cpu"), warps=3, blocks=2) == (2, 3)


@pytest.mark.parametrize("warps,blocks", [(0, None), (33, None), (None, 0), (-1, 2)])
def test_tile_refuses_a_bad_forced_shape(warps, blocks):
    """A forced W outside [1, 32] or G below 1 raises before any launch,
    in every mode of fill_tile."""
    top, side = torch.from_numpy(enc.encode(b"GATTACA")), torch.from_numpy(enc.encode(b"GCAT"))
    halo, left = thp._gaps(0, 8, 1, "cpu"), thp._gaps(1, 5, 1, "cpu")
    for mode in ("scores", "codes", "masks"):
        table = thp._new_table(mode, 7, 4, "cpu")
        codes, masks = (table, None) if mode == "codes" else (None, table)
        with pytest.raises(ValueError, match="warps" if blocks is None else "blocks|warps"):
            tfs.fill_tile(top, side, 2, 1, 1, 0, 7, halo, left, codes, masks, warps=warps, blocks=blocks)


@pytest.mark.parametrize("window", [16, 48])
def test_plain_tile_packs_codes_a_window_at_a_time(monkeypatch, window):
    """fill_tile_plain packs its codes CODE_WINDOW columns at a time:
    windows that cut the tiles (16 and 48 columns) give the codes of one
    window a tile, which the test above holds to the whole pair's."""
    for a, b in _pairs(window, 2, 100, 300):
        top, side = torch.from_numpy(enc.encode(a)), torch.from_numpy(enc.encode(b))
        for H, C in ((64, 300), (37, 70)):
            want = thp.chain_tiles(top, side, 2, 1, 1, H, C, "codes")[0]
            with monkeypatch.context() as mp:
                mp.setattr(tfs, "CODE_WINDOW", window)
                got = thp.chain_tiles(top, side, 2, 1, 1, H, C, "codes")[0]
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------- the huge pair against nw_tpu ----------------


@pytest.mark.parametrize("mkd", ORDINARY)
@pytest.mark.parametrize("nseq", WORLDS)
def test_huge_pair_matches_nw_tpu_scan(ranks, nseq, mkd):
    """huge_pair_align_sharded / huge_pair_score_sharded at 1, 2 and 4
    ranks and chunks of 8, 13, 16 and 64 columns against nw_tpu's scan
    engine on a mesh of the same size; the edge pairs and B < ranks."""
    rng = np.random.default_rng(nseq * 100 + sum(mkd))
    la, lb = (int(x) for x in rng.integers(1, 60, 2))  # one shape: one nw_tpu compile
    cases = [(_rand(rng, la, la + 1), _rand(rng, lb, lb + 1)),
             (_rand(rng, la, la + 1, "AC"), _rand(rng, lb, lb + 1, "AC"))]
    cases += EDGE if mkd == (2, 1, 1) else []
    for a, b in cases:
        score, ops = _nw_tpu_align(a, b, mkd, nseq)
        for chunk in CHUNKS:
            _assert_port(ranks[nseq], a, b, mkd, chunk, score, ops)


@pytest.mark.parametrize(
    "la,lb,C,mkd",
    [(33, 41, 8, (2, 1, 1)), (5, 80, 8, (2, 1, 1)), (64, 64, 8, (0, 0, 0)),
     (300, 280, 32, (3, -1, 2))],
)
def test_masks_engine_matches_nw_tpu_pallas(ranks, la, lb, C, mkd):
    """engine="pallas" (nw_fill_tile's masks mode, K28) against nw_tpu's
    engine="pallas" in interpret mode, at tests/test_huge_pair.py's sizes,
    4 ranks against a 4-device mesh."""
    rng = np.random.default_rng(la * 7 + lb)
    a, b = _rand(rng, la, la + 1), _rand(rng, lb, lb + 1)
    score, ops = _nw_tpu_align(a, b, mkd, 4, engine="pallas", chunk=C, interpret=True)
    _assert_port(ranks[4], a, b, mkd, C, score, ops, engine="pallas")


@pytest.mark.parametrize("lb,C", [(124, 15), (132, 17), (124, 33), (132, 45)])
def test_masks_engine_at_unaligned_chunks_matches_nw_tpu_pallas(ranks, lb, C):
    """engine="pallas" on 4 ranks of 31 and 33 rows with chunks of 15, 17,
    33 and 45 columns (tiles from c0 % 16 of 15, 14, 1, 2, 13, ...)
    against nw_tpu's engine="pallas" in interpret mode (its chunk 8: a
    multiple of 4), on a 100 bp top."""
    rng = np.random.default_rng(lb * 7 + C)
    a, b = _rand(rng, 100, 101), _rand(rng, lb, lb + 1)
    score, ops = _nw_tpu_align(a, b, (2, 1, 1), 4, engine="pallas", chunk=8, interpret=True)
    _assert_port(ranks[4], a, b, (2, 1, 1), C, score, ops, engine="pallas")


@pytest.mark.parametrize("mkd", LARGE)
def test_huge_pair_follows_fill_scan_at_large_scorings(ranks, mkd):
    """At scorings that wrap int32 the port gives fill_scan's answer on
    every world size and engine, and its alignments spell both inputs."""
    for a, b in [(b"GATTACA", b"GCAT")] + _pairs(sum(mkd) % 997, 1, 1, 40):
        score, ops = _fill_scan_walk(a, b, mkd)
        X, Y = ttb.ops_to_strings(ops, len(ops), a, b)
        assert X.replace(b"-", b"") == a and Y.replace(b"-", b"") == b
        for nseq in WORLDS:
            for engine in (None, "pallas", "scan"):
                _assert_port(ranks[nseq], a, b, mkd, 13, score, ops, engine)


def test_nw_tpu_sharded_huge_pair_leaves_fill_scan_at_large_scorings():
    """Pins nw_tpu's divergence: its sharded huge pair (scan engine,
    chunk 8) on GATTACA/GCAT at 1 1 2^30 and 1 2^30 1, where fill_scan
    gives 1073741822 and -2 (the port's answers above), and its refusal
    of 2^31-1 -2^31 2^30."""
    a, b = b"GATTACA", b"GCAT"
    assert _fill_scan_walk(a, b, (1, 1, 2**30))[0] == 1073741822
    assert _fill_scan_walk(a, b, (1, 2**30, 1))[0] == -2
    for n in WORLDS:
        score, ops = _nw_tpu_align(a, b, (1, 1, 2**30), n)
        assert score == 2147483644
        assert jtb.ops_to_strings(ops, len(ops), a, b) == (b"T-ACA", b"TGCAT")
        score, ops = _nw_tpu_align(a, b, (1, 2**30, 1), n)
        assert score == 2147483642
        if n == 1:
            with pytest.raises(IndexError):
                jtb.ops_to_strings(ops, len(ops), a, b)
        else:
            assert jtb.ops_to_strings(ops, len(ops), a, b) == (b"--CAGATTACA", b"GC-A---T---")
        with pytest.raises(OverflowError):  # -k = 2^31 does not fit its int32 scan
            _nw_tpu_align(a, b, (2**31 - 1, -(2**31), 2**30), n)


@pytest.mark.parametrize("mkd", [(2, 1, 1), (3, -1, 2), (1, 1, 2**30)])
def test_align_huge_sharded_equals_align_huge(ranks, mkd):
    """NWAligner.align_huge_sharded on 2 ranks equals the port's own
    align_huge (codes route) on the same pair."""
    m, k, d = mkd
    aligner = NWAligner(device="cpu", match=m, mismatch=k, indel=d)
    for a, b in _pairs(sum(mkd) % 991 + 3, 2, 1, 50):
        want = aligner.align_huge(a, b)
        for got in ranks[2].run(aligner.align_huge_sharded, a, b, MESH, chunk=16):
            assert got == want


# ---------------- data parallel ----------------


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return Mesh(np.array(jax.devices()[:8]), ("data",))


def _batch(seed, n=32):
    rng = np.random.default_rng(seed)
    pairs = [(_rand(rng, 0, 40), _rand(rng, 0, 40)) for _ in range(n - 2)] + [(b"", b""), (b"ACG", b"")]
    return enc.encode_batch(pairs, 40, 40)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("nseq", WORLDS)
def test_align_batch_sharded_matches_nw_tpu(ranks, mesh8, nseq, with_counts):
    """align_batch_sharded at 1, 2 and 4 ranks against nw_tpu's on the
    8-device mesh: scores, pairs, score_min, score_max and solutions
    equal; cells and score_sum equal the exact numpy int64 sums."""
    tops, sides, l1, l2 = _batch(nseq * 10 + with_counts)
    t, s, a, b = jdp.shard_batch(mesh8, "data", tops, sides, l1, l2)
    jscores, jstats = jdp.align_batch_sharded(t, s, a, b, m=2, k=1, d=1, mesh=mesh8,
                                              with_counts=with_counts)
    shards = [PerRank(np.split(x, nseq)) for x in (tops, sides, l1, l2)]
    for scores, stats in ranks[nseq].run(tdp.align_batch_sharded, *shards, m=2, k=1, d=1,
                                         mesh=MESH, axis="seq", with_counts=with_counts,
                                         device="cpu"):
        np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
        keys = ["pairs", "score_min", "score_max"] + (["solutions"] if with_counts else [])
        for key in keys:
            assert int(stats[key]) == int(jstats[key]), key
        assert stats["score_min"].dtype == stats["score_max"].dtype == torch.int32
        real = (l1 > 0) | (l2 > 0)
        assert int(stats["cells"]) == int((l1.astype(np.int64) * l2).sum())
        assert int(stats["score_sum"]) == int(np.asarray(jscores, np.int64)[real].sum())


def test_batch_stats_are_exact_past_2_31(mesh8):
    """nw_tpu's cells and score_sum are int32 (its int64 casts need
    jax_enable_x64); the port's merge sums in int64.  On lengths whose
    products pass 2^31 the port gives the exact sum, and nw_tpu's rule
    (that sum mod 2^32, read as int32) another number."""
    tops, sides, l1, l2 = _batch(7, 8)
    t, s, a, b = jdp.shard_batch(mesh8, "data", tops, sides, l1, l2)
    with warnings.catch_warnings():  # the int64 casts warn that they are int32
        warnings.simplefilter("ignore")
        _, jstats = jdp.align_batch_sharded(t, s, a, b, m=2, k=1, d=1, mesh=mesh8)
    assert jstats["cells"].dtype == jstats["score_sum"].dtype == np.int32

    lens = torch.full((300,), 100_000, dtype=torch.int32)
    scores = torch.full((300,), 2**31 - 1, dtype=torch.int32)
    stats = tdp.batch_stats(scores, lens, lens)
    cells, ssum = 300 * 100_000**2, 300 * (2**31 - 1)
    assert (int(stats["cells"]), int(stats["score_sum"])) == (cells, ssum)
    assert stats["cells"].dtype == torch.int64
    as_int32 = lambda x: (x + 2**31) % 2**32 - 2**31  # noqa: E731
    assert as_int32(cells) != cells and as_int32(ssum) != ssum


def test_shards_must_agree_and_divide(ranks):
    tops = np.zeros((8, 4), np.int32)
    got = ranks[2].run(tdp.shard_batch, MESH, "seq", tops)
    assert [g[0].shape for g in got] == [(4, 4), (4, 4)]
    assert ranks[4].run(tdist.global_batch_from_local, MESH, "seq", tops[:2])[0][0].shape == (2, 4)
    with pytest.raises(RuntimeError, match="differ in shape"):
        ranks[2].run(tdist.global_batch_from_local, MESH, "seq", PerRank([tops[:2], tops[:3]]))


# ---------------- geometry, set-up, refusals ----------------


@pytest.mark.parametrize("engine", ["pallas", "pallasb", "scan"])
def test_auto_chunk_and_pipeline_efficiency_match_nw_tpu(engine):
    shapes = [(100_000, 100_000), (1, 100_000), (100_000, 1), (33, 41), (300, 280)]
    for nseq in range(1, 9):
        for A, B in shapes:
            for tb in (False, True):
                C = thp.auto_chunk(A, B, nseq, engine, traceback=tb)
                assert C == jhp.auto_chunk(A, B, nseq, engine, traceback=tb)
                assert thp.pipeline_efficiency(A, B, nseq, C, engine) == \
                    jhp.pipeline_efficiency(A, B, nseq, C, engine)


def test_tile_chunk_keeps_its_efficiency():
    """tile_chunk takes the width (a multiple of 32 columns) whose phase
    loop runs the fewest band steps, nphases x (2H + C): no cut into 1-64
    chunks, nor the 87.5%-of-phases rule of nw_tpu's auto_chunk, runs
    fewer.  One tile of the whole width on 1 and 2 ranks of a square
    pair; the 20 kb pair in 2 chunks on 4."""
    def width(A, n):
        return max(32, (-(-A // n) + 31) // 32 * 32)

    for nseq in range(1, 9):
        for A, B in ((1, 100_000), (100, 100_000), (100_000, 100_000), (20_000, 20_000), (100_000, 7)):
            C = thp.tile_chunk(A, B, nseq)
            H, nch, _ = thp.tile_geometry(A, B, nseq, C)

            def steps(c):
                return thp.tile_geometry(A, B, nseq, c)[2] * (2 * H + c)

            assert C % 32 == 0 and (nch - 1) * C < A
            rivals = [width(A, n) for n in range(1, 65)] + [width(A, max(1, 7 * (nseq - 1)))]
            assert all(steps(C) <= steps(c) for c in rivals)
            assert nch == 1 or nseq > 1
    assert thp.tile_chunk(100_000, 100_000, 2) == 100_000
    assert thp.tile_chunk(20_000, 20_000, 4) == 10_016


def test_init_distributed_and_refusals(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.init_distributed("gloo", device="cpu") is False
    with pytest.raises(ValueError, match="gloo"):
        tdist.init_distributed("nccl", "127.0.0.1:1", 2, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="a card for each rank"):
        tdist.init_distributed("nccl", "127.0.0.1:1", 2, 1, local_rank=1)
    with pytest.raises(ValueError, match="device='cpu' only"):
        thp.huge_pair_align_sharded(enc.encode(b"AC"), enc.encode(b"A"), 2, 1, 1, None,
                                    engine="scan", device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thp.huge_pair_score_sharded(enc.encode(b"AC"), enc.encode(b"A"), 2, 1, 1, None)
