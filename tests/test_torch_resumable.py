"""nw_tpu_torch's resumable runners (plain PyTorch) vs nw_tpu on the CPU.

Mirrors of ``tests/test_aux.py:273-420``: ``ResumableBandedFill`` and
``ResumableBandedTraceback`` killed after spans 1, 2 and 4 (and every
other span), resumed in a fresh runner, give the bits of an
uninterrupted run and of ``nw_tpu``'s runner in interpret mode, and
refuse a directory written by another run.  Each span writes only its
own rows.  ``CheckpointedRunner.run``'s ``progress`` calls match
``nw_tpu``'s.  Every output is an integer: comparisons are exact
(tolerance 0).
"""

import functools
import os
import tempfile

import numpy as np
import pytest

import nw_tpu.runtime.checkpoint as jck
from nw_tpu.ops.encode import encode_batch as jencode_batch
from nw_tpu_torch.ops import banded_traceback as bt
from nw_tpu_torch.ops import encode as enc
from nw_tpu_torch.ops import fill_banded
from nw_tpu_torch.runtime.checkpoint import (
    CheckpointedRunner,
    ResumableBandedFill,
    ResumableBandedTraceback,
)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

MKD = (2, 1, 1)


def _pairs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    return [tuple(letters[rng.integers(0, 4, int(rng.integers(lo, hi + 1)))].tobytes() for _ in range(2))
            for _ in range(n)]


# 5 pairs of 30-150 bp (5 bands of 32 rows: 5 spans of one band, 3 groups
# of 2 bands), a pair on a group edge, the empty and one-sided pairs
PAIRS = _pairs(12, 5, 30, 150) + [(b"GATTACA" * 9, b"ACGT" * 16), (b"", b""), (b"ACGT", b""), (b"", b"ACG")]
L = 160


def _batch(pairs=PAIRS):
    return enc.upload(enc.encode_batch(pairs, L, L), "cpu")


@functools.lru_cache(maxsize=None)
def _nw_tpu_fill(with_counts):
    """nw_tpu's ResumableBandedFill, uninterrupted, in interpret mode."""
    tops, sides, l1, l2 = jencode_batch(PAIRS, L, L)
    with tempfile.TemporaryDirectory() as d:
        out = jck.ResumableBandedFill(d, save_every=2).run(
            tops, sides, l1, l2, *MKD, with_counts=with_counts, interpret=True, band_rows=32, chunk=32, unroll=8)
    return out if with_counts else (out,)


@functools.lru_cache(maxsize=None)
def _nw_tpu_walk(with_counts):
    """nw_tpu's ResumableBandedTraceback, uninterrupted, in interpret mode."""
    tops, sides, l1, l2 = jencode_batch(PAIRS, L, L)
    with tempfile.TemporaryDirectory() as d:
        return jck.ResumableBandedTraceback(d, save_every=2).run(
            tops, sides, l1, l2, *MKD, with_counts=with_counts, interpret=True, band_rows=32, chunk=32,
            unroll=8, group_bands=2)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("kill", [1, 2, 4])
@pytest.mark.parametrize("with_counts", [False, True])
def test_resumable_fill_kill_and_resume(tmp_path, with_counts, kill):
    """A fill of one band a span killed after span ``kill`` resumes in a
    fresh runner to the bits of an uninterrupted run, of nw_tpu's
    ResumableBandedFill and of the whole fill; the state file holds a row
    a pair, whatever the span."""
    T = _batch()
    want = _nw_tpu_fill(with_counts)
    full = ResumableBandedFill(str(tmp_path / "full"), save_every=1).run(*T, *MKD, with_counts=with_counts)
    _same(full, want)
    sc, ct = fill_banded.fill_scores_counts_banded_batch_plain(*T, *MKD)
    np.testing.assert_array_equal(np.asarray(want[0]), sc.numpy())
    d = tmp_path / "killed"
    with pytest.raises(KeyboardInterrupt):
        ResumableBandedFill(str(d), save_every=1).run(*T, *MKD, with_counts=with_counts, _abort_after_spans=kill)
    with np.load(d / "fill_state.npz") as saved:
        assert int(saved["r_next"]) == kill and saved["bnd"].shape == (len(PAIRS), L + 1)
    _same(ResumableBandedFill(str(d), save_every=1).run(*T, *MKD, with_counts=with_counts), want)
    if with_counts:
        np.testing.assert_array_equal(want[1], (ct & 0xFFFFFFFF).numpy().astype(np.uint32))


def test_resumable_fill_refuses_another_run(tmp_path):
    """A directory written by another scoring, shape or span is refused
    with ValueError; the last span is never aborted."""
    T = _batch()
    d = str(tmp_path / "f")
    with pytest.raises(KeyboardInterrupt):
        ResumableBandedFill(d, save_every=2).run(*T, *MKD, _abort_after_spans=1)
    for kw, mkd in (({}, (3, 1, 1)), ({"with_counts": True}, MKD)):
        with pytest.raises(ValueError, match="different run"):
            ResumableBandedFill(d, save_every=2).run(*T, *mkd, **kw)
    with pytest.raises(ValueError):
        ResumableBandedFill(d, save_every=3).run(*T, *MKD)
    with pytest.raises(ValueError):
        ResumableBandedFill(d, save_every=2).run(*_batch(PAIRS[:4]), *MKD)
    out = ResumableBandedFill(str(tmp_path / "g"), save_every=5).run(*T, *MKD, _abort_after_spans=1)
    _same(out, _nw_tpu_fill(False))


@pytest.mark.parametrize("kill", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("with_counts", [False, True])
def test_resumable_traceback_kill_and_resume(monkeypatch, tmp_path, with_counts, kill):
    """Groups of 2 bands, a save a group: 3 spans of pass 1 (the third
    ends between the passes) and 2 of pass 2 can be killed.  Killed after
    span ``kill`` and resumed in a fresh runner, the run gives the bits
    of an uninterrupted run, of the twopass engine and of nw_tpu's
    ResumableBandedTraceback."""
    T = _batch()
    want = _nw_tpu_walk(with_counts)
    monkeypatch.setattr(bt, "GROUP_BANDS", 2)
    full = ResumableBandedTraceback(str(tmp_path / "full"), save_every=1).run(*T, *MKD, with_counts=with_counts)
    _same(full, want)
    _same(bt.traceback_banded_batch(*T, *MKD, with_counts=with_counts, engine="twopass"), want)
    d = tmp_path / "killed"
    with pytest.raises(KeyboardInterrupt):
        ResumableBandedTraceback(str(d), save_every=1).run(
            *T, *MKD, with_counts=with_counts, _abort_after_spans=kill)
    files = sorted(os.listdir(d))
    assert [f for f in files if f.startswith("cp_")] == [f"cp_{g:05d}.npy" for g in range(min(kill, 3))]
    assert [f for f in files if f.startswith("ops_")] == [f"ops_{g:05d}.npz" for g in range(max(kill - 3, 0))]
    got = ResumableBandedTraceback(str(d), save_every=1).run(*T, *MKD, with_counts=with_counts)
    _same(got, want)


def test_resumable_traceback_spans_and_layout(monkeypatch, tmp_path):
    """Spans of 2 groups (a span of pass 1 writes its 2 checkpoint rows,
    one file a group, each int32[B, A+1]; pass 2 a file of packed prefixes
    a span), the default group height (one group here), and a wrong key
    refused: another scoring, no counts, or another group height."""
    T = _batch()
    want = _nw_tpu_walk(True)
    _same(ResumableBandedTraceback(str(tmp_path / "one"), save_every=1).run(*T, *MKD, with_counts=True), want)
    monkeypatch.setattr(bt, "GROUP_BANDS", 2)
    d = tmp_path / "w"
    with pytest.raises(KeyboardInterrupt):
        ResumableBandedTraceback(str(d), save_every=2).run(*T, *MKD, with_counts=True, _abort_after_spans=1)
    assert sorted(f for f in os.listdir(d) if f.startswith("cp_")) == ["cp_00000.npy", "cp_00001.npy"]
    assert np.load(d / "cp_00001.npy").shape == (len(PAIRS), L + 1)
    _same(ResumableBandedTraceback(str(d), save_every=2).run(*T, *MKD, with_counts=True), want)
    with np.load(d / "ops_00000.npz") as saved:
        assert saved["ops4"].shape == (2, len(PAIRS), bt._group_cap(L, 2) // 4) and saved["ng"].shape == (2, len(PAIRS))
    for mkd, kw in (((2, 1, 2), {}), (MKD, {"with_counts": False})):
        with pytest.raises(ValueError, match="different run"):
            ResumableBandedTraceback(str(d), save_every=2).run(*T, *mkd, **{"with_counts": True, **kw})
    monkeypatch.setattr(bt, "GROUP_BANDS", 1)
    with pytest.raises(ValueError, match="different run"):
        ResumableBandedTraceback(str(d), save_every=2).run(*T, *MKD, with_counts=True)


def test_checkpointed_runner_progress_matches_nw_tpu(tmp_path):
    """CheckpointedRunner.run(pairs, align_chunk, progress, retries): the
    same (chunk, chunks) calls as nw_tpu's runner, fresh and on a resume
    that loads the chunks already written."""
    pairs = [(b"A" * i, b"C") for i in range(11)]

    def align_chunk(chunk):
        return {"n": np.array([len(a) for a, _ in chunk], np.int32)}

    calls = {}
    for name, runner in (("port", CheckpointedRunner), ("nw_tpu", jck.CheckpointedRunner)):
        seen = calls[name] = []
        out = runner(str(tmp_path / name), chunk_size=4).run(pairs, align_chunk, lambda c, n: seen.append((c, n)))
        np.testing.assert_array_equal(out["n"], np.arange(11))
        os.remove(tmp_path / name / "chunk_00001.npz")
        runner(str(tmp_path / name), chunk_size=4).run(pairs, align_chunk, progress=lambda c, n: seen.append((c, n)),
                                                       retries=1)
    assert calls["port"] == calls["nw_tpu"] == [(0, 3), (1, 3), (2, 3)] * 2
