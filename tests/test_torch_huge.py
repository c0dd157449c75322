"""nw_tpu_torch's huge-pair path (plain PyTorch) vs nw_tpu on the CPU.

``align_huge`` on both routes, the small-batch huge-pair routes of
``align_batch``, and the plain versions behind the single-pair kernels
K14 (whole-pair 2-bit codes), K12 (checkpoint rows), K13 (codes re-filled
from a checkpoint row) and K11 (score only), each against its ``nw_tpu``
counterpart: the ``pallasb`` engine on a one-device CPU mesh, the
checkpointed traceback, ``fill_last_row`` and ``strips_score``, the
Pallas kernels in interpret mode as ``nw_tpu``'s own tests run them.
Every output is an integer or a byte string: tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import nw_tpu
import nw_tpu.ops.fill_auto as j_fill_auto
import nw_tpu.parallel.huge_pair as j_huge_pair
from nw_tpu.config import AlignConfig as JAlignConfig
from nw_tpu.config import ScoringParams as JScoringParams
from nw_tpu.models.needleman_wunsch import NWAligner as JNWAligner
from nw_tpu.ops import traceback as j_traceback
from nw_tpu.ops.checkpoint_traceback import traceback_checkpointed as j_traceback_checkpointed
from nw_tpu.ops.encode import encode as jencode
from nw_tpu.ops.encode import pad_to
from nw_tpu.ops.fill_scan import diag_to_matrix as j_diag_to_matrix
from nw_tpu.ops.fill_scan import fill_diag as j_fill_diag
from nw_tpu.ops.fill_scan import fill_last_row as j_fill_last_row
from nw_tpu.ops.fill_strips import strips_score
from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
from nw_tpu_torch.models import needleman_wunsch as model
from nw_tpu_torch.ops import checkpoint_traceback as ckt
from nw_tpu_torch.ops import fill_auto, fill_scan, fill_single, traceback
from nw_tpu_torch.ops.encode import encode

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

EDGE = [(b"ACGT", b""), (b"", b"ACG"), (b"A", b"A"), (b"GCATGCU", b"GATTACA")]


def _rand(rng, n, alphabet="ACGT") -> bytes:
    return "".join(rng.choice(list(alphabet), n)).encode()


def _pairs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [(_rand(rng, int(rng.integers(lo, hi))), _rand(rng, int(rng.integers(lo, hi)))) for _ in range(n)]


def _t(s: bytes) -> torch.Tensor:
    return torch.from_numpy(encode(s))


def _lens(*xs):
    return [torch.tensor([x], dtype=torch.int32) for x in xs]


def _greedy_words(s1: bytes, s2: bytes, mkd) -> np.ndarray:
    """uint32[ceil(len2/32), TW, 32]: nw_tpu's fill_diag tie masks turned
    into greedy codes (diag > left > up) and packed into the band-major
    layout here, independently of the port: cell (j >= 1, i) at band
    (j-1)//32, lane jj = (j-1)%32, step t = i + jj, bits 2*(t%16) of word
    [band, t//16, jj]; every other field 0."""
    la, lb = len(s1), len(s2)
    out = j_fill_diag(jencode(s1), jencode(s2), *mkd)
    rect = np.asarray(j_diag_to_matrix(np.asarray(out["arrows"]), la, lb))[1:]
    code = np.where(rect & 1, 0, np.where(rect & 2, 1, 2)).astype(np.uint32)
    nbands, TW = -(-lb // 32), 2 * -(-(la + 32) // 32)
    words = np.zeros((nbands, TW, 32), np.uint32)
    jm, ii = np.mgrid[0:lb, 0 : la + 1]
    t = ii + jm % 32
    np.bitwise_or.at(words, (jm // 32, t // 16, jm % 32), code << (2 * (t % 16)).astype(np.uint32))
    return words


def _words(codes: torch.Tensor) -> np.ndarray:
    return codes[0].numpy().view(np.uint32)


# ---------------- K14: whole-pair codes + one walk ----------------


@pytest.mark.parametrize(
    "la,lb,C,mkd,fb",
    [
        (33, 41, 16, (2, 1, 1), None),
        (5, 80, 16, (2, 1, 1), None),
        (64, 64, 16, (0, 0, 0), None),  # max tie density
        (300, 280, 32, (3, -1, 2), None),
        (120, 999, 16, (3, -1, 2), 1),  # multi-block grid on the TPU side
    ],
)
def test_codes_route_vs_pallasb_engine(monkeypatch, la, lb, C, mkd, fb):
    """The K14 port's route (codes of the whole pair, its corner score,
    one walk) against nw_tpu's config-5 pallasb engine on a one-device
    mesh (tests/test_huge_pair.py:265-277), and the codes themselves
    against greedy codes of nw_tpu's fill_diag."""
    if fb is not None:
        monkeypatch.setattr(j_huge_pair, "_pick_fb", lambda B, n: fb)
    rng = np.random.default_rng(la * 11 + lb + 1)
    s1, s2 = _rand(rng, la), _rand(rng, lb)
    mesh = Mesh(np.array(jax.devices()[:1]), ("seq",))
    want = j_huge_pair.huge_pair_align_sharded(
        jnp.asarray(jencode(s1)), jnp.asarray(jencode(s2)), *mkd, mesh,
        chunk=C, engine="pallasb", interpret=True,
    )
    codes, score = fill_single.fill_codes_single(_t(s1), _t(s2), *mkd)
    ops, n = traceback.walk_codes_batch(codes, *_lens(la, lb), la + lb)
    assert int(score) == want.score
    assert int(n[0]) == want.n
    np.testing.assert_array_equal(ops[0, : want.n].numpy(), np.asarray(want.ops))
    np.testing.assert_array_equal(_words(codes), _greedy_words(s1, s2, mkd))


# ---------------- K12 / K13: checkpoint rows, re-filled blocks ----------------


@pytest.mark.parametrize("every", [32, 64, 96])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (0, 0, 0), (3, -1, 2)])
def test_checkpoint_rows_and_refilled_blocks_vs_nw_tpu(mkd, every):
    """K12's plain version: checkpoint row r is nw_tpu's fill_last_row of
    the prefix side[:r*C].  K13's: each block re-filled from its row has
    the full fill's greedy codes for rows r0+1 .. r1, and its corner is
    row r1's last cell."""
    rng = np.random.default_rng(every + sum(mkd))
    s1, s2 = _rand(rng, 70), _rand(rng, 230)
    score, ckpt = fill_single.score_fold(_t(s1), _t(s2), *mkd, checkpoint_every=every)
    assert ckpt.shape == (-(-230 // every), 71)
    rows = fill_scan.fill_last_row(_t(s1), _t(s2), *mkd, every=every)
    assert rows.shape == (ckpt.shape[0] + 1, 71)
    top, side = jnp.asarray(jencode(s1)), jnp.asarray(jencode(s2))
    for r in range(ckpt.shape[0]):
        want = np.asarray(j_fill_last_row(top, side, *mkd, 70, r * every))
        np.testing.assert_array_equal(ckpt[r].numpy(), want)
        np.testing.assert_array_equal(rows[r].numpy(), want)
        np.testing.assert_array_equal(
            fill_scan.fill_last_row(_t(s1), _t(s2), *mkd, len2=r * every).numpy(), want
        )
    np.testing.assert_array_equal(rows[-1].numpy(), np.asarray(j_fill_last_row(top, side, *mkd, 70, 230)))
    assert int(score) == int(j_fill_diag(jencode(s1), jencode(s2), *mkd, with_arrows=False)["score"])
    full = _greedy_words(s1, s2, mkd)
    for r in range(ckpt.shape[0]):
        r0, r1 = r * every, min(230, (r + 1) * every)
        codes, corner = fill_single.fill_codes_single(
            _t(s1), _t(s2), *mkd, len2=r1, r0=r0, seed=ckpt[r] if r0 else None
        )
        np.testing.assert_array_equal(_words(codes), full[r0 // 32 : -(-r1 // 32)])
        row = np.asarray(j_fill_last_row(top, side, *mkd, 70, r1))
        assert int(corner) == int(row[70])


@functools.lru_cache(maxsize=None)
def _j_checkpointed(s1, s2, mkd, C):
    """nw_tpu's checkpointed traceback (interpret mode) of one pair padded
    to 96 x 96, true lengths passed, so that JAX compiles once per block
    size: (ops, n) as numpy."""
    top = jnp.asarray(pad_to(jencode(s1), 96, -1))
    side = jnp.asarray(pad_to(jencode(s2), 96, -2))
    ops, n = j_traceback_checkpointed(
        top, side, *mkd, len(s1), len(s2), block_diagonals=C, interpret=True
    )
    return np.asarray(ops), int(n)


@pytest.mark.parametrize("group", [1, 2, 3, None])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 1, 1), (0, 0, 0), (-1, 2, -2), (3, -1, 2)])
def test_traceback_checkpointed_vs_nw_tpu(monkeypatch, mkd, group):
    """The port's checkpointed traceback against nw_tpu's (interpret
    mode), block sizes 32 to 128 rows (diagonals in nw_tpu;
    tests/test_checkpoint_traceback.py's cases), the blocks re-filled
    ``group`` at a time (NW_TPU_HUGE_WALK_HBM holding that many blocks'
    codes and rings; None: the default budget, every block at once)."""
    pairs = _pairs(17 + sum(mkd), 4, 1, 90)
    for b, (s1, s2) in enumerate(pairs):
        for C in (32, 64, 96, 128)[b % 2 :: 2]:
            if group is not None:
                monkeypatch.setenv("NW_TPU_HUGE_WALK_HBM", str(group * ckt.refill_bytes(len(s1), C)))
            blocks = -(-len(s2) // C)
            assert ckt.refill_group(len(s1), len(s2), C, "cpu") == min(group or blocks, blocks)
            want_ops, want_n = _j_checkpointed(s1, s2, mkd, C)
            ops, n = ckt.traceback_checkpointed(_t(s1), _t(s2), *mkd, block_diagonals=C)
            assert int(n) == want_n, (s1, s2, C)
            np.testing.assert_array_equal(ops[: int(n)].numpy(), want_ops[: int(n)])


@pytest.mark.parametrize("s1,s2", [(b"A", b"A"), (b"ACGT", b""), (b"", b"ACGT")])
def test_traceback_checkpointed_degenerate_vs_nw_tpu(s1, s2):
    want_ops, want_n = j_traceback_checkpointed(
        jnp.asarray(jencode(s1)), jnp.asarray(jencode(s2)), 1, 1, 1,
        block_diagonals=32, interpret=True,
    )
    ops, n = ckt.traceback_checkpointed(_t(s1), _t(s2), 1, 1, 1, block_diagonals=32)
    assert int(n) == int(want_n)
    np.testing.assert_array_equal(ops.numpy(), np.asarray(want_ops))


@pytest.mark.parametrize("fault", ["no_walk", "narrow_codes"])
def test_traceback_checkpointed_raises_off_the_origin(monkeypatch, fault):
    """A chain of block walks that does not end at (0, 0) raises instead
    of returning a short alignment: a window that walks nowhere, and
    blocks re-filled narrower than the pair (the walk's start lies
    outside their codes, so the window leaves the state as it was)."""
    s1, s2 = _pairs(23, 1, 90, 91)[0]
    if fault == "no_walk":
        monkeypatch.setattr(ckt, "walk_codes_window", lambda *a: None)
    else:
        real = ckt.fill_codes_blocks
        monkeypatch.setattr(
            ckt, "fill_codes_blocks",
            lambda top, side, m, k, d, len1, *a, **kw: real(top, side, m, k, d, len1 - 40, *a, **kw),
        )
    with pytest.raises(RuntimeError, match="origin"):
        ckt.traceback_checkpointed(_t(s1), _t(s2), 2, 1, 1, block_diagonals=32)


@pytest.mark.parametrize("C", [32, 64, 96])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (0, 0, 0), (3, -1, 2)])
def test_refilled_groups_vs_single_blocks_and_nw_tpu(mkd, C):
    """K13's grouped plain version: a group of blocks re-filled from their
    checkpoint rows (the whole pair, and groups from a later block on)
    holds, band for band, each block's one-block re-fill and the full
    fill's greedy codes from nw_tpu's fill_diag; its corners are the
    blocks' last cells.  230 rows: the last block is short."""
    rng = np.random.default_rng(C + sum(mkd) + 3)
    s1, s2 = _rand(rng, 70), _rand(rng, 230)
    _, ckpt = fill_single.score_fold(_t(s1), _t(s2), *mkd, checkpoint_every=C)
    full = _greedy_words(s1, s2, mkd)
    top, side = jnp.asarray(jencode(s1)), jnp.asarray(jencode(s2))
    nblk = ckpt.shape[0]
    for lo in (0, 1, nblk - 1):
        codes, corners = fill_single.fill_codes_blocks(
            _t(s1), _t(s2), *mkd, 70, 230, lo * C, C, ckpt[lo:]
        )
        assert corners.shape == (nblk - lo,)
        np.testing.assert_array_equal(_words(codes), full[lo * C // 32 :])
        for g in range(nblk - lo):
            r0, r1 = (lo + g) * C, min(230, (lo + g + 1) * C)
            one, corner = fill_single.fill_codes_single_plain(
                _t(s1), _t(s2), *mkd, 70, r1, r0, ckpt[lo + g] if r0 else None
            )
            first = g * C // 32
            assert torch.equal(codes[:, first : first + one.shape[1]], one)
            assert int(corners[g]) == int(corner) == int(np.asarray(j_fill_last_row(top, side, *mkd, 70, r1))[70])


def test_refill_group_limits(monkeypatch):
    """G: as many blocks as the budget holds (codes and a ring row a
    band), at least one, at most all; on a card no more than the bands
    one cooperative launch holds.  At 100 kb with 1 280-row blocks all 79
    fit one launch on 132 SMs; at 200 kb (the default route's
    ~4 sqrt(B) = 1 792-row blocks) the 8 GiB budget cuts 112 blocks into
    two groups."""
    per = ckt.refill_bytes(1000, 64)
    assert per == 2 * (66 * 32 * 4 + 4 * 1001)  # 2 bands of 66 words a lane, 2 ring rows
    for budget, want in ((0, 1), (per - 1, 1), (per, 1), (3 * per, 3), (100 * per, 16)):
        monkeypatch.setenv("NW_TPU_HUGE_WALK_HBM", str(budget))
        assert ckt.refill_group(1000, 1000, 64, "cpu") == want
    monkeypatch.delenv("NW_TPU_HUGE_WALK_HBM")
    monkeypatch.setattr(ckt, "resident_warps", lambda device: 132 * 32)
    assert ckt.refill_group(100_000, 100_000, 1280, "cpu") == 79
    assert ckt.refill_group(100_000, 100_000, 1280, "cuda") == 79
    C200 = ckt.auto_block_diagonals(200_000, 200_000)
    assert C200 == 1792 and model.code_bytes_per_pair(200_000, 200_000) > ckt.HUGE_WALK_BUDGET_BYTES
    G = ckt.refill_group(200_000, 200_000, C200, "cuda")
    assert G == (8 << 30) // ckt.refill_bytes(200_000, C200) == 63 and -(-112 // G) == 2
    assert ckt.refill_group(1000, 10**6, 1024 * 32, "cpu") == 31  # every block
    assert ckt.refill_group(1000, 10**6, 1024 * 32, "cuda") == 4  # 1 024 bands a block
    assert ckt.refill_group(1000, 10**6, 5000 * 32, "cuda") == 1  # more bands than warps


def test_traceback_checkpointed_empty_pair_and_blocks():
    ops, n = ckt.traceback_checkpointed(_t(b""), _t(b""), 1, 1, 1)
    assert ops.shape == (0,) and int(n) == 0
    assert ckt.auto_block_diagonals(100_000, 100_000) == 1280  # ~4 sqrt(B), whole bands
    assert ckt.auto_block_diagonals(1, 1) == 32


# ---------------- K11: the score alone ----------------


@pytest.mark.parametrize(
    "la,lb,R,K,mkd",
    [
        (2, 2, 2, 2, (2, 1, 1)),
        (3, 3, 2, 1, (1, 1, 1)),
        (9, 5, 2, 3, (2, 1, 1)),
        (17, 1024, 4, 1, (1, 1, 1)),
        (33, 2100, 4, 2, (3, 2, 2)),
        (40, 1025, 4, 1, (2, 1, 1)),
        (8, 999, 4, 4, (2, 1, 1)),
        (1, 50, 4, 1, (2, 1, 1)),
        (25, 3000, 4, 1, (0, 0, 0)),
    ],
)
def test_score_fold_vs_strips_score(la, lb, R, K, mkd):
    """K11's plain version against nw_tpu's K11 (interpret mode) at the
    shapes of tests/test_strips.py."""
    rng = np.random.default_rng(la * 31 + lb)
    a = rng.integers(65, 69, la).astype(np.uint8).tobytes()
    b = rng.integers(65, 69, lb).astype(np.uint8).tobytes()
    want = int(strips_score(jnp.asarray(jencode(a)), jnp.asarray(jencode(b)), *mkd,
                            rows=R, chunks=K, interpret=True))
    score, ckpt = fill_single.score_fold(_t(a), _t(b), *mkd)
    assert ckpt is None
    assert int(score) == want


# ---------------- the slice: align_huge, small batches of huge pairs ----------------


def _aligners(mkd):
    return (
        NWAligner(AlignConfig(scoring=ScoringParams(*mkd)), device="cpu"),
        JNWAligner(JAlignConfig(scoring=JScoringParams(*mkd))),
    )


def _slice_pairs(seed):
    return _pairs(seed, 2, 30, 300) + EDGE


@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)])
def test_align_huge_vs_nw_tpu(monkeypatch, mkd):
    """Default route (the codes route here; nw_tpu takes its checkpointed
    route off the TPU), both packages forced to the checkpointed route by
    NW_TPU_HUGE_WALK_HBM=0, and block_diagonals=64."""
    ours, ref = _aligners(mkd)
    calls = []
    real = model.traceback_checkpointed
    monkeypatch.setattr(model, "traceback_checkpointed", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    for s1, s2 in _slice_pairs(sum(mkd)):
        want = ref.align_huge(s1, s2)
        got = ours.align_huge(s1, s2)
        assert (got.X, got.Y, got.score) == (want.X, want.Y, want.score), (s1, s2)
        assert (got.s1, got.s2) == (s1, s2)
        assert ours.align_huge(s1, s2, block_diagonals=64) == got
        monkeypatch.setenv("NW_TPU_HUGE_WALK_HBM", "0")
        assert ours.align_huge(s1, s2) == got
        assert ref.align_huge(s1, s2) == want
        monkeypatch.delenv("NW_TPU_HUGE_WALK_HBM")
    # a pair with no rows has no codes: they fit even a budget of 0
    assert calls == [
        c for a, b in _slice_pairs(sum(mkd))
        for c in [{"block_diagonals": 64}] + [{"block_diagonals": None}] * (len(b) > 0)
    ]


def test_align_huge_block_sizes_and_budget(monkeypatch):
    """block_diagonals never changes the output; the budget alone picks
    the route (the codes route while the codes fit, at the byte)."""
    ours, ref = _aligners((2, 1, 1))
    s1, s2 = _pairs(5, 1, 200, 201)[0]
    want = ref.align_huge(s1, s2, block_diagonals=64)
    want = model.HugeAlignmentResult(want.s1, want.s2, want.score, want.X, want.Y)
    for bd in (1, 32, 33, 100, 1000):
        assert ours.align_huge(s1, s2, block_diagonals=bd) == want
    need = model.code_bytes_per_pair(len(s1), len(s2))
    routes = []
    monkeypatch.setattr(model, "traceback_checkpointed", lambda *a, **kw: routes.append("ckpt") or ckt.traceback_checkpointed(*a, **kw))
    for budget in (need, need - 1):
        monkeypatch.setenv("NW_TPU_HUGE_WALK_HBM", str(budget))
        assert ours.align_huge(s1, s2) == want
    assert routes == ["ckpt"]
    assert ours.align_huge(b"", b"") == model.HugeAlignmentResult(b"", b"", 0, b"", b"")


def test_align_huge_follows_fill_scan_at_large_scorings(monkeypatch):
    """At 1 1 2^30 the int32 DP wraps: both routes give the alignment of
    nw_tpu's fill_diag + traceback_greedy; the codes route reports the
    int32 corner, the checkpointed route the alignment's score in Python
    ints (no wrap)."""
    mkd = (1, 1, 1 << 30)
    s1, s2 = b"GATTACA", b"GCAT"
    out = j_fill_diag(jencode(s1), jencode(s2), *mkd)
    ops, n = j_traceback.traceback_greedy(out["arrows"], 7, 4, max_steps=11)
    X, Y = j_traceback.ops_to_strings(ops, n, s1, s2)
    ours, _ = _aligners(mkd)
    got = ours.align_huge(s1, s2)
    assert (got.X, got.Y, got.score) == (X, Y, int(out["score"]))
    got = ours.align_huge(s1, s2, block_diagonals=32)
    assert (got.X, got.Y, got.score) == (X, Y, model._rescore(X, Y, *mkd))
    assert got.score < -(2**31)


@pytest.mark.parametrize("budget", [None, "0"])
def test_small_batch_of_huge_pairs_checks_the_walk_against_the_summary(monkeypatch, budget):
    """With strings and counts each huge pair's walk gives a score (the
    corner on the codes route, the re-scored alignment on the
    checkpointed one) and the summary another: a mismatch raises."""
    if budget is not None:
        monkeypatch.setenv("NW_TPU_HUGE_WALK_HBM", budget)
    monkeypatch.setattr(model, "HUGE_PAIR_MIN_SIDE", 32)
    pairs = _slice_pairs(4)[:2]
    ours, _ = _aligners((2, 1, 1))
    got = ours.align_batch(pairs, traceback_strings=True, count=True)
    np.testing.assert_array_equal(got.scores, [ours.align_huge(*p).score for p in pairs])
    real = NWAligner.summary_huge
    monkeypatch.setattr(
        NWAligner, "summary_huge", lambda self, a, b: (lambda s, c: (s + 1, c))(*real(self, a, b))
    )
    with pytest.raises(RuntimeError, match="summary"):
        ours.align_batch(pairs, traceback_strings=True, count=True)


@pytest.mark.parametrize("strings,count", [(True, True), (True, False), (False, False)])
def test_small_batch_of_huge_pairs_vs_nw_tpu(monkeypatch, strings, count):
    """align_batch with HUGE_PAIR_MIN_SIDE cut to 32 in both packages
    (and the port's K11 threshold too): pair by pair through the huge-pair
    routes, equal to nw_tpu's and to the port's normal batch route."""
    pairs = _slice_pairs(3)[:2] + [(b"ACGT", b"A" * 40), (b"", b"C" * 35)]
    ours, ref = _aligners((2, 1, 1))
    normal = ours.align_batch(pairs, traceback_strings=strings, count=count)
    monkeypatch.setattr(j_fill_auto, "HUGE_PAIR_MIN_SIDE", 32)
    monkeypatch.setattr(model, "HUGE_PAIR_MIN_SIDE", 32)
    monkeypatch.setattr(fill_auto, "SINGLE_PAIR_MIN_SIDE", 32)
    monkeypatch.setattr(fill_auto, "SINGLE_PAIR_SIDE_PER_PAIR", 1)
    routes = []
    real = NWAligner._huge_ops
    monkeypatch.setattr(NWAligner, "_huge_ops", lambda self, *a: routes.append(1) or real(self, *a))
    got = ours.align_batch(pairs, traceback_strings=strings, count=count)
    want = ref.align_batch(pairs, traceback_strings=strings, count=count)
    assert len(routes) == (len(pairs) if strings else 0)
    for other in (want, normal):
        np.testing.assert_array_equal(got.scores, np.asarray(other.scores))
        if count:
            np.testing.assert_array_equal(got.counts, np.asarray(other.counts))
        if strings:
            np.testing.assert_array_equal(got.ops_len, np.asarray(other.ops_len))
            assert got.alignment_strings() == other.alignment_strings()
    assert got.scores.dtype == np.int32


def test_scores_of_a_small_batch_of_long_pairs_take_k11(monkeypatch):
    """Scores only: fewer than BANDED_MIN_BATCH pairs with buckets of at
    least SINGLE_PAIR_MIN_SIDE go pair by pair through score_fold; the
    scores equal nw_tpu's and the K1 route's."""
    pairs = _pairs(8, 3, 100, 300) + [(b"", b"")]
    want = nw_tpu.align_batch(pairs, 2, 1, 1).scores
    k1 = model.align_batch(pairs, 2, 1, 1, device="cpu").scores
    calls = []
    real = fill_single.score_fold
    monkeypatch.setattr(fill_auto, "score_fold", lambda *a, **kw: calls.append(a[5:]) or real(*a, **kw))
    monkeypatch.setattr(fill_auto, "SINGLE_PAIR_MIN_SIDE", 128)
    monkeypatch.setattr(fill_auto, "SINGLE_PAIR_SIDE_PER_PAIR", 1)
    got = model.align_batch(pairs, 2, 1, 1, device="cpu").scores
    assert calls == [(len(a), len(b)) for a, b in pairs]
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, k1)
    many = pairs * 6  # BANDED_MIN_BATCH pairs: the K1 route
    calls.clear()
    np.testing.assert_array_equal(model.align_batch(many, 2, 1, 1, device="cpu").scores, np.tile(k1, 6))
    assert calls == []


@pytest.mark.parametrize(
    "nb,L1,L2,single",
    [
        (1, 2000, 2000, True),  # one pair needs 2 000 bp
        (1, 1999, 100_000, False),  # the shorter bucket decides
        (5, 10240, 10240, True),  # K11 was faster on the card at 4 pairs
        (6, 10240, 10240, False),  # and K1 at 6
        (2, 4096, 4096, True),  # K11 at 2 pairs of 4 kb
        (3, 4096, 4096, False),  # K1 by 3 (at 4 on the card)
        (23, 4096, 4096, False),
        (23, 100_000, 100_000, True),  # 23 pairs of 100 kb: 2 000 bp a pair
        (24, 100_000, 100_000, False),  # BANDED_MIN_BATCH pairs: K1
        (0, 4096, 4096, False),
    ],
)
def test_single_pair_route_rule(nb, L1, L2, single):
    """The K11 route takes a small batch once the shorter bucket reaches
    SINGLE_PAIR_SIDE_PER_PAIR bp a pair, and at least SINGLE_PAIR_MIN_SIDE."""
    assert fill_auto.takes_single_pair_route(nb, L1, L2) is single
