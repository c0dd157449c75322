"""Import hygiene of nw_tpu_torch: no JAX, no nw_tpu, no silent CPU path."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+nw_tpu(\.|\s|$)|from\s+nw_tpu(\.|\s))",
    re.M,
)


NEW_MODULES = {
    "nw_tpu_torch.cli", "nw_tpu_torch.__main__", "nw_tpu_torch.runtime.native",
    "nw_tpu_torch.ops.fill_single", "nw_tpu_torch.ops.enumerate_walk",
    "nw_tpu_torch.utils.cformat", "nw_tpu_torch.utils.textio",
    "nw_tpu_torch.utils.alignout", "nw_tpu_torch.utils.render",
}


def test_import_does_not_load_jax():
    code = (
        "import pkgutil, sys, importlib, nw_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(nw_tpu_torch.__path__, 'nw_tpu_torch.')]\n"
        f"assert set(names) >= set({sorted(NEW_MODULES)}), names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'nw_tpu' or n.startswith('nw_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_never_import_jax_or_nw_tpu():
    files = sorted((REPO / "nw_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not FORBIDDEN.search(f.read_text()), f


def test_default_device_without_card_raises(monkeypatch):
    from nw_tpu_torch import NWAligner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NWAligner()
    assert NWAligner(device="cpu").device.type == "cpu"


def test_wrappers_do_not_fall_back_off_cpu():
    """A tensor on neither the CPU nor a card is refused, not computed."""
    from nw_tpu_torch.ops import fill_banded, traceback

    t = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    for fn in (
        fill_banded.fill_scores_banded_batch,
        fill_banded.fill_scores_counts_banded_batch,
        fill_banded.fill_greedy_counts_banded_batch,
    ):
        with pytest.raises(ValueError):
            fn(t, t, lens, lens, 1, 1, 1)
    with pytest.raises(ValueError):
        traceback.walk_codes_batch(
            torch.zeros((2, 1, 6, 32), dtype=torch.int32, device="meta"), lens, lens, 16
        )
    from nw_tpu_torch.ops import fill_single

    one = torch.zeros(8, dtype=torch.int32, device="meta")
    for fn in (fill_single.score_count_fold, fill_banded.fill_arrows_banded_single):
        with pytest.raises(ValueError):
            fn(one, one, 1, 1, 1)


def test_kernel_build_is_keyed_by_sources():
    from nw_tpu_torch.runtime import kernels

    path = kernels.library_path()
    assert path.parent == REPO / "nw_tpu_torch" / "_build"
    assert {s.name for s in kernels._sources()} >= {
        "nw_fill.cu", "nw_walk.cu", "nw_single.cu", "nw_common.cuh"
    }
    assert os.path.basename(path).startswith("libnw_tpu_torch-")


def test_native_runtime_builds_from_nw_tpu_sources():
    """The port's native C++ runtime is nw_tpu/runtime/cc, compiled by
    path into nw_tpu_torch/_build (g++ is on both hosts)."""
    from nw_tpu_torch.runtime import native

    assert {os.path.basename(s) for s in native._sources()} == {
        "nwread.cc", "nwrender.cc", "nwstrings.cc", "nwwalk.cc"
    }
    assert native.load() is not None
    assert any(p.name.startswith("libnwnative-") for p in (REPO / "nw_tpu_torch" / "_build").iterdir())
