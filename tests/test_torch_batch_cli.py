"""The batch CLI of nw_tpu_torch (``nw-tpu-torch-batch``) against
``nw_tpu.batch_cli.main``, on the CPU (``NW_TPU_PLATFORM=cpu``: the
kernels' plain versions).

The TSV bytes equal ``nw_tpu``'s in all four modes, with and without
``--alignments`` / ``--counts``, ``--chunk`` and ``--sort-by-length``; a
run resumed through ``--checkpoint-dir`` prints identical bytes,
``--retries`` re-attempts a failing chunk, and a checkpoint written under
another key is rejected (the flags of tests/test_aux.py:154-247).  Inputs
are made by numpy from a seed; comparisons are byte for byte.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nw_tpu import batch_cli as ref_cli
from nw_tpu_torch import batch_cli
from nw_tpu_torch.models import affine

REPO = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _pairs(seed, n, lo, hi, alphabet="ACGT"):
    rng = np.random.default_rng(seed)
    return [
        ("".join(rng.choice(list(alphabet), int(rng.integers(lo, hi + 1)))),
         "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi + 1)))))
        for _ in range(n)
    ]


@pytest.fixture
def pairs_file(tmp_path):
    pairs = _pairs(27, 9, 1, 30) + _pairs(28, 3, 5, 25, "AC") + [("GATTACA", "GCAT"), ("A", "AAA")]
    src = tmp_path / "pairs.txt"
    src.write_text("".join(f"{a} {b}\n" for a, b in pairs))
    return src


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("NW_TPU_PLATFORM", "cpu")


def _run(main, src, out, args):
    assert main(["--pairs", str(src), "--out", str(out), *args]) == 0
    return out.read_bytes()


CASES = {
    "nw-counts-alignments": ["--counts", "--alignments", "-m", "2", "-k", "1", "-d", "1", "--chunk", "4"],
    "nw-scores-sorted": ["-m", "1", "-k", "1", "-d", "1", "--sort-by-length"],
    "sw-alignments": ["--mode", "sw", "--alignments", "-m", "2", "-k", "1", "-d", "1", "--chunk", "5"],
    "sw-scores": ["--mode", "sw", "-m", "3", "-k", "2", "-d", "2"],
    "overlap-alignments": ["--mode", "overlap", "--alignments", "-m", "2", "-k", "1", "-d", "1",
                           "--sort-by-length"],
    "overlap-scores": ["--mode", "overlap", "-m", "2", "-k", "3", "-d", "2", "--chunk", "4"],
    "affine-alignments": ["--mode", "affine", "--alignments", "-m", "2", "-k", "1", "--open", "3",
                          "--extend", "1", "--chunk", "4", "--sort-by-length"],
    "affine-alignments-open-lt-extend": ["--mode", "affine", "--alignments", "-m", "2", "-k", "1",
                                         "--open", "1", "--extend", "3"],
    "affine-scores": ["--mode", "affine", "-m", "2", "-k", "1", "--open", "3", "--extend", "1"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_cli_matches_nw_tpu(case, pairs_file, tmp_path, on_cpu):
    args = CASES[case]
    want = _run(ref_cli.main, pairs_file, tmp_path / "ref.tsv", args)
    got = _run(batch_cli.main, pairs_file, tmp_path / "port.tsv", args)
    assert got == want
    assert len(got.splitlines()) == 14


@pytest.mark.parametrize("mode", ["nw", "affine"])
def test_batch_cli_resume_and_retries(mode, pairs_file, tmp_path, on_cpu, monkeypatch):
    """A run through --checkpoint-dir, then a rerun over the chunks on
    disk, print nw_tpu's bytes; a chunk that fails once is re-attempted
    under --retries; another key on the same directory is rejected."""
    extra = ["--counts"] if mode == "nw" else ["--open", "3", "--extend", "1"]
    args = ["--mode", mode, "--alignments", *extra, "-m", "2", "-k", "1", "-d", "1", "--chunk", "4",
            "--sort-by-length"]
    want = _run(ref_cli.main, pairs_file, tmp_path / "ref.tsv", args)
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    fails = []
    real = affine.affine_align_batch

    def flaky(*a, **kw):  # the second chunk fails once
        if len(fails) == 1:
            fails.append(1)
            raise RuntimeError("transient")
        fails.append(0)
        return real(*a, **kw)

    if mode == "affine":
        monkeypatch.setattr(affine, "affine_align_batch", flaky)
    first = _run(batch_cli.main, pairs_file, tmp_path / "a.tsv", [*args, *ck, "--retries", "1"])
    assert first == want
    assert len(os.listdir(tmp_path / "ck")) == 1 + 4  # the manifest and 4 chunks of 4
    if mode == "affine":
        assert fails == [0, 1, 0, 0, 0]  # 4 chunks, one failure re-attempted
        fails.clear()
    again = _run(batch_cli.main, pairs_file, tmp_path / "b.tsv", [*args, *ck])
    assert again == want
    if mode == "affine":
        assert fails == []  # every chunk came from disk
    with pytest.raises(ValueError, match="different run"):
        batch_cli.main(["--pairs", str(pairs_file), "--out", str(tmp_path / "c.tsv"),
                        *[x if x != "2" else "3" for x in args], *ck])


def test_batch_cli_retries_exhausted(pairs_file, tmp_path, on_cpu, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("persistent")

    monkeypatch.setattr(affine, "affine_score_pairs", broken)
    with pytest.raises(RuntimeError, match="persistent"):
        batch_cli.main(["--pairs", str(pairs_file), "--mode", "affine", "--retries", "2",
                        "--checkpoint-dir", str(tmp_path / "ck")])


def test_batch_cli_counts_need_nw_and_card(pairs_file, monkeypatch):
    with pytest.raises(SystemExit, match="--counts is only defined for --mode nw"):
        batch_cli.main(["--pairs", str(pairs_file), "--mode", "sw", "--counts"])
    monkeypatch.delenv("NW_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert batch_cli.main(["--pairs", str(pairs_file)]) == 1


def test_batch_cli_module_entry(pairs_file, tmp_path):
    """``python -m nw_tpu_torch.batch_cli`` from stdin to stdout."""
    args = ["--mode", "affine", "--alignments", "-m", "2", "-k", "1", "--open", "3", "--extend", "1"]
    want = _run(ref_cli.main, pairs_file, tmp_path / "ref.tsv", args)
    res = subprocess.run(
        [sys.executable, "-m", "nw_tpu_torch.batch_cli", *args], input=pairs_file.read_bytes(),
        capture_output=True, cwd=REPO, env={**os.environ, "NW_TPU_PLATFORM": "cpu"}, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout == want
