"""nw_tpu_torch's single-pair path (plain PyTorch) vs nw_tpu on the CPU.

Every output is an integer or a byte string, so every comparison is
exact (tolerance 0): scores, uint32 counts, tie masks, per-cell scores,
optimal-cell marks, branch counts, enumerated alignments and rendered
tables.  The references are nw_tpu's lax.scan fill and path DPs, and
its K8 kernel in interpret mode (as tests/test_pallas.py runs it).
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nw_tpu.config import AlignConfig as JAlignConfig
from nw_tpu.config import ScoringParams as JScoringParams
from nw_tpu.models.needleman_wunsch import NWAligner as JNWAligner
from nw_tpu.ops import enumerate_walk as jwalk
from nw_tpu.ops import pathcount as jpath
from nw_tpu.ops.encode import encode as jencode
from nw_tpu.ops.encode import pad_to
from nw_tpu.ops.fill_pallas_single import score_count_fold as j_score_count_fold
from nw_tpu.ops.fill_scan import diag_to_matrix as j_diag_to_matrix
from nw_tpu.ops.fill_scan import fill_diag as j_fill_diag
from nw_tpu.utils import render as jrender
from nw_tpu.utils import textio as jtextio
from nw_tpu_torch import AlignConfig, NWAligner, ScoringParams
from nw_tpu_torch.models import needleman_wunsch as model
from nw_tpu_torch.ops import enumerate_walk, pathcount
from nw_tpu_torch.ops.encode import encode
from nw_tpu_torch.ops.fill_banded import (
    fill_arrows_banded_single,
    fill_arrows_banded_single_plain,
)
from nw_tpu_torch.ops.fill_single import score_count_fold, score_count_fold_plain
from nw_tpu_torch.runtime import native
from nw_tpu_torch.utils import render, textio

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SCORINGS = [(2, 1, 1), (1, 1, 1), (0, 0, 0), (3, -1, 2)]
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
    # random, tie-dense two-letter, all-'A' (counts wrap) and edge pairs
    return (
        _pairs(seed, 3, 1, 40) + _pairs(seed + 1, 2, 10, 40, "AC")
        + [(b"A" * 24, b"A" * 16)] + EDGE
    )


def _t(s: bytes) -> torch.Tensor:
    return torch.from_numpy(encode(s))


def _jax_tables(s1, s2, mkd):
    """nw_tpu's rectangles of one pair: masks, scores, score, count.
    Padded to 64 x 64 (true lengths passed) so that JAX compiles once."""
    top, side = pad_to(jencode(s1), 64, -1), pad_to(jencode(s2), 64, -2)
    out = j_fill_diag(top, side, *mkd, len(s1), len(s2), with_scores=True)
    arrows = np.asarray(out["arrows"])
    masks = j_diag_to_matrix(arrows, len(s1), len(s2))
    scores = j_diag_to_matrix(np.asarray(out["scores"]), len(s1), len(s2))
    count = int(jpath.count_paths(out["arrows"], len(s1), len(s2)))
    return arrows, masks, scores, int(out["score"]), count


@pytest.mark.parametrize("mkd", SCORINGS)
def test_score_count_fold_plain_vs_k8_interpret(mkd):
    """One compile: every pair padded to 64 x 64, true lengths passed."""
    for s1, s2 in _cases(sum(mkd)):
        top = jnp.asarray(pad_to(jencode(s1), 64, -1))
        side = jnp.asarray(pad_to(jencode(s2), 64, -2))
        sc, cnt = j_score_count_fold(top, side, *mkd, len1=len(s1), len2=len(s2), interpret=True)
        want = (int(sc), int(cnt))
        padded = (
            torch.from_numpy(np.array(top)), torch.from_numpy(np.array(side))
        )
        assert score_count_fold_plain(_t(s1), _t(s2), *mkd) == want, (s1, s2)
        assert score_count_fold(*padded, *mkd, len(s1), len(s2)) == want, (s1, s2)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_fill_masks_plain_vs_fill_diag(mkd):
    for s1, s2 in _cases(sum(mkd) + 20):
        _, masks, scores, score, count = _jax_tables(s1, s2, mkd)
        for with_scores in (False, True):
            got = fill_arrows_banded_single(_t(s1), _t(s2), *mkd, with_scores=with_scores)
            np.testing.assert_array_equal(got[0].numpy(), masks)
            if with_scores:
                np.testing.assert_array_equal(got[1].numpy(), scores)
            else:
                assert got[1] is None
            assert got[2:] == (score, count), (s1, s2)
        plain = fill_arrows_banded_single_plain(_t(s1), _t(s2), *mkd, with_scores=True)
        np.testing.assert_array_equal(plain[1].numpy(), scores)


@pytest.mark.parametrize("mkd", SCORINGS)
def test_marks_branches_counts_vs_pathcount(mkd):
    for s1, s2 in _cases(sum(mkd) + 40):
        arrows, masks, _, _, count = _jax_tables(s1, s2, mkd)
        l1, l2 = len(s1), len(s2)
        t_masks = torch.from_numpy(np.ascontiguousarray(masks))
        want_marks = j_diag_to_matrix(np.asarray(jpath.mark_optimal_cells(arrows, l1, l2)), l1, l2)
        np.testing.assert_array_equal(pathcount.mark_optimal_cells(t_masks).numpy(), want_marks)
        assert pathcount.count_branches(t_masks) == int(jpath.count_branches(arrows, l1, l2))
        assert pathcount.count_paths(t_masks) == count


@pytest.mark.parametrize("use_native", [True, False])
def test_enumerate_walk_vs_nw_tpu(use_native):
    for s1, s2 in _cases(3) + _pairs(4, 3, 1, 9, "AC"):
        _, masks, _, _, _ = _jax_tables(s1, s2, (1, 1, 1))
        got, want = [], []
        n_got = enumerate_walk.enumerate_alignments(
            masks, s1, s2, lambda x, y: got.append((x, y)), max_alignments=500,
            use_native=use_native,
        )
        n_want = jwalk.enumerate_alignments(
            masks, s1, s2, lambda x, y: want.append((x, y)), max_alignments=500,
            use_native=use_native,
        )
        assert (n_got, got) == (n_want, want)


@pytest.mark.parametrize("unicode,color", [(False, False), (True, True)])
def test_render_table_vs_nw_tpu(unicode, color):
    assert native.load() is not None  # g++ builds nw_tpu/runtime/cc here
    for s1, s2 in [(b"GCATGCU", b"GATTACA"), (b"ACCA", b"CA"), (b"", b"G")]:
        _, masks, scores, _, _ = _jax_tables(s1, s2, (2, 1, 1))
        marks = pathcount.mark_optimal_cells(torch.from_numpy(np.ascontiguousarray(masks))).numpy()
        want = jrender.render_table_py(scores, masks, marks, s1, s2, unicode, color)
        assert render.render_table(scores, masks, marks, s1, s2, unicode, color) == want
        assert render.render_table_py(scores, masks, marks, s1, s2, unicode, color) == want


def test_read_two_sequences_vs_nw_tpu(tmp_path):
    inputs = [b"GT GA", b" \n GT\tGA\n", b"A\x00C G", b"GT", b"GT ", b"X" * 70000 + b" Y"]
    for data in inputs:
        results = []
        for mod in (textio, jtextio):
            try:
                results.append(mod.read_two_sequences(io.BytesIO(data)))
            except mod.EarlyEOFError:
                results.append("eof")
            f = tmp_path / "in.txt"
            f.write_bytes(data)
            with open(f, "rb") as fh:  # a real fd: the native reader
                try:
                    results.append(mod.read_two_sequences(fh))
                except mod.EarlyEOFError:
                    results.append("eof")
        assert results[0] == results[2] and results[1] == results[3], data
        assert results[0] == results[1], data
    assert textio.c_atoi(" -12x") == jtextio.c_atoi(" -12x") == -12


@pytest.mark.parametrize("mkd", SCORINGS)
def test_align_and_summary_huge_vs_nw_tpu(mkd):
    ours = NWAligner(AlignConfig(scoring=ScoringParams(*mkd)), device="cpu")
    ref = JNWAligner(JAlignConfig(scoring=JScoringParams(*mkd)))
    for s1, s2 in [(b"GCATGCU", b"GATTACA"), (b"AACA", b"ACA"), (b"", b""), (b"AC", b"")]:
        got, want = ours.align(s1, s2), ref.align(s1, s2)
        assert (got.score, got.solution_count) == (want.score, want.solution_count)
        np.testing.assert_array_equal(got.arrows, want.arrows)
        np.testing.assert_array_equal(got.score_matrix, want.score_matrix)
        assert list(got.alignments()) == list(want.alignments())
        assert got.best_alignment() == want.best_alignment()
        assert ours.summary_huge(s1, s2) == ref.summary_huge(s1, s2)


def test_small_batch_of_huge_pairs_counts_via_summary(monkeypatch):
    """Counts of a small batch of long-side pairs go pair by pair through
    summary_huge; their strings through align_huge's routes, equal to the
    normal batch route's."""
    pairs = _pairs(9, 3, 20, 40) + [(b"", b"ACGT" * 5)]
    aligner = NWAligner(device="cpu")
    want = aligner.align_batch(pairs, count=True)
    want_strings = aligner.align_batch(pairs, traceback_strings=True).alignment_strings()
    monkeypatch.setattr(model, "HUGE_PAIR_MIN_SIDE", 16)
    calls = []
    real = NWAligner.summary_huge
    monkeypatch.setattr(
        NWAligner, "summary_huge", lambda self, a, b: calls.append(a) or real(self, a, b)
    )
    got = aligner.align_batch(pairs, count=True)
    assert len(calls) == len(pairs)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.dtype == np.uint32
    assert aligner.align_batch(pairs, traceback_strings=True).alignment_strings() == want_strings
