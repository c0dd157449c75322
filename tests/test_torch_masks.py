"""nw_tpu_torch's tie-mask routes (plain PyTorch) vs nw_tpu on the CPU.

The port's ``fill_arrows_auto`` (batched masks up to 2 048 bp sides, a
pair at a time beyond), ``count_masks_batch`` and ``walk_masks_batch``
against ``nw_tpu``'s ``fill_arrows_auto`` + ``pathcount.count_paths`` +
``traceback.traceback_greedy_batch``; the port's rectangular masks
against K2's single-band words, K10's packed words and K6's counts in
interpret mode (as tests/test_pallas.py runs them), decoded from their
layouts and compared on each true table; and ``align_batch``'s mask
route for a small batch of long pairs against ``nw_tpu``'s
``align_batch``.  Every output is an integer, so every comparison is
exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nw_tpu.config import AlignConfig as JAlignConfig
from nw_tpu.config import ScoringParams as JScoringParams
from nw_tpu.models.needleman_wunsch import NWAligner as JNWAligner
from nw_tpu.ops import fill_auto as jfill_auto
from nw_tpu.ops import pathcount as jpath
from nw_tpu.ops import traceback as jtb
from nw_tpu.ops.encode import encode_batch as jencode_batch
from nw_tpu.ops.fill_pallas import count_packed_pallas_batch, fill_arrows_pallas_batch
from nw_tpu.ops.fill_pallas_banded import fill_arrows_banded_single as k2_single_band
from nw_tpu.ops.fill_pallas_single import fill_arrows_fold_batch as k10_fold
from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
from nw_tpu_torch.models import needleman_wunsch as model
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_auto, fill_banded, fill_single, pathcount, traceback
from nw_tpu_torch.ops.arrows import ARROW_LEFT, ARROW_UP

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# ordinary scorings, and scorings whose arithmetic wraps int32
SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2), (1, 1, 2**30), (1, 2**30, 1),
            (2**31 - 1, -(2**31), 2**30)]
EDGE = [(b"", b""), (b"ACGT", b""), (b"", b"ACG"), (b"A", b"A"), (b"GCATGCU", b"GATTACA")]


def _pairs(seed, n, lo, hi, alphabet="ACGT"):
    rng = np.random.default_rng(seed)
    return [
        (
            "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode(),
            "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi)))).encode(),
        )
        for _ in range(n)
    ]


def _cases(seed):
    # random, tie-dense two-letter, all-'A' (the count wraps) and edge pairs
    return _pairs(seed, 6, 0, 40) + _pairs(seed + 1, 3, 10, 40, "AC") + [(b"A" * 24, b"A" * 16)] + EDGE


def _true_table(table, b, pair):
    return table[b, : len(pair[1]) + 1, : len(pair[0]) + 1]


def _check_layout(masks, pairs):
    """Row 0 LEFT, column 0 UP, the origin 0, nothing outside the table."""
    for b, pair in enumerate(pairs):
        t = _true_table(masks, b, pair)
        assert t[0, 0] == 0 and (t[0, 1:] == ARROW_LEFT).all() and (t[1:, 0] == ARROW_UP).all()
        assert int(masks[b].sum()) == int(t.sum())


# long side buckets take the pair-at-a-time route (true lengths stay short)
@pytest.mark.parametrize(
    "mkd,L2", [(mkd, 48) for mkd in SCORINGS] + [((2, 1, 1), 2056), ((1, 1, 2**30), 2056)]
)
def test_fill_arrows_auto_count_walk_match_nw_tpu(mkd, L2):
    pairs = _cases(sum(mkd) % 1000 + L2)
    tops, sides, l1, l2 = jencode_batch(pairs, 48, L2)
    arr, axis, sc = jfill_auto.fill_arrows_auto(tops, sides, l1, l2, *mkd, platform="cpu")
    l1j, l2j = jnp.asarray(l1), jnp.asarray(l2)
    cnt = jax.vmap(jpath.count_paths, in_axes=(axis, 0, 0))(arr, l1j, l2j)
    ops, n = jtb.traceback_greedy_batch(arr, l1j, l2j, max_steps=48 + L2)
    arr = np.asarray(arr)

    T = enc.upload(enc.encode_batch(pairs, 48, L2), "cpu")
    masks, axis2, sc2 = fill_auto.fill_arrows_auto(*T, *mkd)
    assert axis2 == 0 and masks.shape == (len(pairs), L2 + 1, 49) and masks.dtype == torch.uint8
    for b, pair in enumerate(pairs):
        jj, ii = np.mgrid[0 : len(pair[1]) + 1, 0 : len(pair[0]) + 1]
        np.testing.assert_array_equal(_true_table(masks, b, pair).numpy(), arr[b][ii + jj, jj])
    _check_layout(masks, pairs)
    np.testing.assert_array_equal(sc2.numpy(), np.asarray(sc))
    got_cnt = pathcount.count_masks_batch(masks, T[2], T[3])
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(cnt).astype(np.int64))
    got_ops, got_n = traceback.walk_masks_batch(masks, T[2], T[3], 48 + L2)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(n))
    np.testing.assert_array_equal(got_ops.numpy(), np.asarray(ops))


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 1, 1), (0, 0, 0)])
def test_batched_masks_match_k2_single_band(mkd, with_counts):
    """K2's pack_bits=8 words (cell (j, i): byte (i+j) % 4 of
    words[(i+j) // 4, j, b]) against the port's batched masks on every
    cell of each true table but the origin, which K2 leaves unspecified."""
    pairs = _pairs(3, 9, 1, 23) + [(b"A", b"A"), (b"", b"ACG"), (b"ACG", b"")]
    tops, sides, l1, l2 = jencode_batch(pairs, 23, 23)
    out = k2_single_band(tops, sides, l1, l2, *mkd, interpret=True, with_counts=with_counts)
    words = np.asarray(out[0])
    T = enc.upload(enc.encode_batch(pairs, 23, 23), "cpu")
    masks, sc, ct = fill_banded.fill_masks_banded_batch(*T, *mkd, with_counts=with_counts)
    for b, pair in enumerate(pairs):
        jj, ii = np.mgrid[0 : len(pair[1]) + 1, 0 : len(pair[0]) + 1]
        kk = ii + jj
        got = (words[kk // 4, jj, b] >> (8 * (kk % 4))) & 0xFF
        want = _true_table(masks, b, pair).numpy()
        np.testing.assert_array_equal(got.ravel()[1:], want.ravel()[1:])
    np.testing.assert_array_equal(sc.numpy(), np.asarray(out[1]))
    if with_counts:
        np.testing.assert_array_equal(ct.numpy(), np.asarray(out[2]).astype(np.int64))
    else:
        assert ct is None


@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 1, 1), (0, 0, 0)])
def test_fold_masks_match_k10(mkd):
    """K10's packed words (cell (j, i): byte (i+j) & 3 of
    words[b, (i+j) >> 2, j]) against the port's pair-at-a-time masks."""
    pairs = _pairs(4, 5, 1, 24)
    tops, sides, l1, l2 = jencode_batch(pairs, 24, 24)
    words, sc = k10_fold(tops, sides, l1, l2, *mkd, interpret=True, packed=True)
    words = np.asarray(words)
    T = enc.upload(enc.encode_batch(pairs, 24, 24), "cpu")
    masks, sc2, ct = fill_single.fill_arrows_fold_batch(*T, *mkd)
    for b, pair in enumerate(pairs):
        jj, ii = np.mgrid[0 : len(pair[1]) + 1, 0 : len(pair[0]) + 1]
        kk = ii + jj
        got = (words[b, kk >> 2, jj] >> (8 * (kk & 3))) & 0xFF
        np.testing.assert_array_equal(got, _true_table(masks, b, pair).numpy())
    _check_layout(masks, pairs)
    np.testing.assert_array_equal(sc2.numpy(), np.asarray(sc))
    # the fused count is K10's masks counted by nw_tpu's count_paths
    want = jax.vmap(jpath.count_paths)(jnp.asarray(words), jnp.asarray(l1), jnp.asarray(l2))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("mkd", [(2, 1, 1), (0, 0, 0)])
def test_count_masks_match_k6(mkd):
    """K6 over the flat kernel's packed words against the port's count
    over its batched masks."""
    pairs = _pairs(15, 10, 1, 35) + [(b"A", b"A"), (b"", b"ACG"), (b"ACG", b"")]
    tops, sides, l1, l2 = jencode_batch(pairs, 35, 35)
    words, _ = fill_arrows_pallas_batch(tops, sides, l1, l2, *mkd, interpret=True, packed=True)
    want = count_packed_pallas_batch(words, l1, l2, interpret=True)
    T = enc.upload(enc.encode_batch(pairs, 35, 35), "cpu")
    masks, _, fused = fill_banded.fill_masks_banded_batch(*T, *mkd, with_counts=True)
    got = pathcount.count_masks_batch(masks, T[2], T[3])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(fused.numpy(), got.numpy())


@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 1, 1), (0, 0, 0)])
def test_count_masks_match_k6_across_bands(mkd):
    """K6 (interpret mode) against the port's count over masks of four
    32-row bands, the shapes the W-warp count hands rows between warps
    at: pairs shorter than the bucket (their corners inside the table),
    tie-dense pairs and one filling it."""
    pairs = _pairs(16, 5, 1, 100) + _pairs(17, 2, 60, 100, "AC")
    pairs = [(a[:70], b) for a, b in pairs] + [(b"AC" * 35, b"CA" * 50)]
    tops, sides, l1, l2 = jencode_batch(pairs, 70, 100)
    words, _ = fill_arrows_pallas_batch(tops, sides, l1, l2, *mkd, interpret=True, packed=True)
    want = count_packed_pallas_batch(words, l1, l2, interpret=True)
    T = enc.upload(enc.encode_batch(pairs, 70, 100), "cpu")
    masks, _, fused = fill_banded.fill_masks_banded_batch(*T, *mkd, with_counts=True)
    assert masks.shape == (len(pairs), 101, 71)
    got = pathcount.count_masks_batch(masks, T[2], T[3])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(fused.numpy(), got.numpy())


@pytest.mark.parametrize(
    "B,Bs,want",
    [
        (4, 10240, 32),  # a few long pairs: 32 warps each
        (128, 2048, 32),  # a pair an SM
        (264, 2048, 16),  # two pairs an SM
        (1024, 256, 4),  # K27's flat shape: 8 pairs an SM, 8 bands each
        (10240, 150, 1),  # config 2's shape: one warp a pair
        (4, 40, 2),  # no more warps than bands
        (3, 0, 1),  # no rows below row 0
    ],
)
def test_count_warps_rule(B, Bs, want):
    """The count's W on 132 SMs: ~32 warps an SM from the whole batch,
    never more than a pair's bands."""
    assert pathcount.count_warps(B, Bs, 132) == want


def test_count_warps_limits(monkeypatch):
    """W stops where shared memory does (32 warps take 82 176 bytes, so
    on an H100 it never binds); a forced W outside 1..32 raises."""
    assert pathcount.count_smem(32) == 32 * 2048 + 4 * (32 * 128 + 32 + 32) == 82176
    monkeypatch.setattr(pathcount, "SMEM_LIMIT", pathcount.count_smem(5))
    assert pathcount.count_warps(4, 10240, 132) == 5
    masks = torch.zeros((1, 2, 2), dtype=torch.uint8)
    lens = torch.ones(1, dtype=torch.int32)
    for warps in (0, 33):
        with pytest.raises(ValueError, match="warps"):
            pathcount.count_masks_batch(masks, lens, lens, warps=warps)


def test_mask_route_is_taken_for_small_batches_of_long_pairs():
    take = fill_auto.takes_mask_route
    assert take(5, 10240, 10240) and take(6, 10240, 10240) and take(2, 4096, 4096)
    assert take(8, 32768, 32768)
    assert take(1, 32768, 32768) and take(1, 4096, 4000) and take(2, 10240, 8000)
    assert not take(7, 10240, 10240)  # too many pairs for their length: the codes route
    assert not take(3, 4096, 4096) and not take(16, 4096, 4096)
    assert not take(24, 10240, 10240)  # a batch that fills the card: the codes route
    assert not take(1, 2048, 2048)  # short sides: the codes route, a quarter of the bytes
    assert not take(2, 2176, 128) and not take(4, 40960, 2048) and not take(0, 4096, 4096)


@pytest.mark.parametrize("strings,count,mkd", [(True, True, (1, 1, 2**30)), (False, True, (3, -1, 2))])
def test_align_batch_mask_route_matches_nw_tpu(monkeypatch, strings, count, mkd):
    """Random, tie-dense and empty pairs padded to one 2 176 bp bucket,
    through the mask route (its rule at 420 bp a pair, so that five pairs
    take it); the plain fills run on the true lengths."""
    pairs = _pairs(8, 3, 0, 60) + _pairs(9, 1, 20, 40, "AC") + [(b"", b"ACG")]
    monkeypatch.setattr(fill_auto, "MASK_SIDE_PER_PAIR", 420)
    calls = []
    fold = model.fill_arrows_fold_batch
    monkeypatch.setattr(model, "fill_arrows_fold_batch", lambda *a, **kw: calls.append(1) or fold(*a, **kw))
    jcfg = JAlignConfig(scoring=JScoringParams(*mkd), bucket_sizes=(2176,))
    want = JNWAligner(jcfg).align_batch(pairs, traceback_strings=strings, count=count)
    cfg = AlignConfig(scoring=ScoringParams(*mkd), bucket_sizes=(2176,))
    got = NWAligner(cfg, device="cpu").align_batch(pairs, traceback_strings=strings, count=count)
    assert len(calls) == 1
    np.testing.assert_array_equal(got.scores, np.asarray(want.scores))
    if count:
        assert got.counts.dtype == np.uint32
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    if strings:
        np.testing.assert_array_equal(got.ops_len, np.asarray(want.ops_len))
        np.testing.assert_array_equal(got.ops, np.asarray(want.ops))
        assert got.alignment_strings() == want.alignment_strings()
