"""Import hygiene of nw_tpu_torch: no JAX, no nw_tpu, no silent CPU path."""

import ast
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
    "nw_tpu_torch.ops.checkpoint_traceback", "nw_tpu_torch.ops.fill_auto",
    "nw_tpu_torch.ops.traceback", "nw_tpu_torch.models.smith_waterman",
    "nw_tpu_torch.ops.variants_banded", "nw_tpu_torch.models.overlap",
    "nw_tpu_torch.models.affine", "nw_tpu_torch.batch_cli", "nw_tpu_torch.runtime.checkpoint",
    "nw_tpu_torch.parallel", "nw_tpu_torch.parallel.mesh", "nw_tpu_torch.parallel.distributed",
    "nw_tpu_torch.parallel.data_parallel", "nw_tpu_torch.parallel.huge_pair",
    "nw_tpu_torch.parallel.workers", "nw_tpu_torch.ops.arrows", "nw_tpu_torch.ops.hirschberg",
    "nw_tpu_torch.ops.fill_flat",
}


def test_parallel_imports_with_jax_and_nw_tpu_blocked():
    """nw_tpu_torch.parallel and its submodules import, and a gloo rank
    group of two runs a sharded huge pair, while any import of jax or
    nw_tpu raises."""
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'nw_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import nw_tpu_torch.parallel as par\n"
        "from nw_tpu_torch.parallel import mesh, distributed, data_parallel, huge_pair, workers\n"
        "from nw_tpu_torch.ops.encode import encode\n"
        "with workers.RankGroup(2, 'gloo', 'cpu') as g:\n"
        "    r = g.run(par.huge_pair_align_sharded, encode(b'GATTACA'), encode(b'GCAT'), 2, 1, 1,\n"
        "              workers.MESH, device='cpu')\n"
        "assert [x.score for x in r] == [1, 1], r\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


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
    from nw_tpu_torch.ops import fill_banded, fill_flat, fill_single, pathcount, traceback, variants_banded

    t = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    for fn in (
        fill_banded.fill_scores_banded_batch,
        fill_banded.fill_scores_counts_banded_batch,
        fill_banded.fill_greedy_counts_banded_batch,
        variants_banded.sw_scores_banded_batch,
        variants_banded.sw_fill_codes_banded_batch,
        variants_banded.overlap_scores_banded_batch,
        variants_banded.overlap_fill_codes_banded_batch,
        fill_banded.fill_masks_banded_batch,
        fill_single.fill_arrows_fold_batch,
        fill_banded.fill_runs_banded_batch,
        fill_flat.fill_scores_flat_batch,
        fill_flat.fill_scores_counts_flat_batch,
        fill_flat.fill_arrows_flat_batch,
    ):
        with pytest.raises(ValueError):
            fn(t, t, lens, lens, 1, 1, 1)
    for fn in (variants_banded.affine_scores_banded_batch, variants_banded.affine_fill_codes_banded_batch):
        with pytest.raises(ValueError):
            fn(t, t, lens, lens, 1, 1, 1, 1)
    meta_codes = torch.zeros((2, 1, 6, 32), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        traceback.walk_codes_batch(meta_codes, lens, lens, 16)
    with pytest.raises(ValueError):
        traceback.walk_sw_codes_batch(meta_codes, lens, lens)
    with pytest.raises(ValueError):
        traceback.walk_gotoh_codes_batch(meta_codes, lens, lens, lens, 16)
    meta_masks = torch.zeros((2, 3, 9), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        traceback.walk_masks_batch(meta_masks, lens, lens, 16)
    with pytest.raises(ValueError):
        pathcount.count_masks_batch(meta_masks, lens, lens)
    with pytest.raises(ValueError):
        traceback.walk_runs_batch(meta_masks, lens, lens, 16)
    with pytest.raises(ValueError):
        fill_flat.count_flat_batch(meta_masks, lens, lens)

    one = torch.zeros(8, dtype=torch.int32, device="meta")
    for fn in (
        fill_single.score_count_fold, fill_banded.fill_arrows_banded_single,
        fill_single.score_fold, fill_single.fill_codes_single, fill_single.last_row,
    ):
        with pytest.raises(ValueError):
            fn(one, one, 1, 1, 1)
    with pytest.raises(ValueError):
        traceback.walk_codes_window(
            torch.zeros((1, 1, 6, 32), dtype=torch.int32, device="meta"),
            torch.zeros(3, dtype=torch.int32, device="meta"), 0,
            torch.zeros(8, dtype=torch.int8, device="meta"),
        )
    with pytest.raises(ValueError):
        traceback.walk_masks_window(
            torch.zeros((1, 6), dtype=torch.uint8, device="meta"),
            torch.zeros(3, dtype=torch.int32, device="meta"), 0,
            torch.zeros(8, dtype=torch.int8, device="meta"),
        )
    with pytest.raises(ValueError):
        fill_single.fill_tile(one, one, 1, 1, 1, 0, 4, one[:5], one)


def test_kernel_build_is_keyed_by_sources():
    from nw_tpu_torch.runtime import kernels

    path = kernels.library_path()
    assert path.parent == REPO / "nw_tpu_torch" / "_build"
    assert {s.name for s in kernels._sources()} >= {
        "nw_fill.cu", "nw_walk.cu", "nw_single.cu", "nw_affine.cu", "nw_count.cu", "nw_common.cuh"
    }
    assert os.path.basename(path).startswith("libnw_tpu_torch-")


def test_native_runtime_builds_from_nw_tpu_sources():
    """The port's native C++ runtime is its own byte-for-byte copy of
    nw_tpu's sources, nw_tpu_torch/runtime/cc, compiled into
    nw_tpu_torch/_build (g++ is on both hosts); nothing is built from
    nw_tpu/."""
    from nw_tpu_torch.runtime import native

    srcs = [Path(s).resolve() for s in native._sources()]
    assert {s.parent for s in srcs} == {REPO / "nw_tpu_torch" / "runtime" / "cc"}
    assert {s.name for s in srcs} == {"nwread.cc", "nwrender.cc", "nwstrings.cc", "nwwalk.cc"}
    for s in srcs:
        assert s.read_bytes() == (REPO / "nw_tpu" / "runtime" / "cc" / s.name).read_bytes(), s
    assert native.load() is not None
    assert any(p.name.startswith("libnwnative-") for p in (REPO / "nw_tpu_torch" / "_build").iterdir())


def _code_strings(tree):
    """String constants of a module that are not docstrings."""
    docs = {
        id(node.body[0].value)
        for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
        and node.body and isinstance(node.body[0], ast.Expr)
        and isinstance(node.body[0].value, ast.Constant)
    }
    return [
        node.value for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs
    ]


def test_port_names_no_path_inside_nw_tpu():
    """No code of the port reaches into nw_tpu/ by path: no string it
    builds a path from names nw_tpu/ (docstrings and comments cite the
    TPU kernels they replace by file:line, which is not a path the code
    opens), and no C/C++/CUDA source includes a header from there."""
    inside = re.compile(r"(^|[^\w])nw_tpu([/\\]|$)")
    py = sorted((REPO / "nw_tpu_torch").rglob("*.py"))
    native = sorted(
        f for ext in ("*.cu", "*.cuh", "*.cc", "*.h") for f in (REPO / "nw_tpu_torch").rglob(ext)
    )
    assert len(py) > 10 and len(native) >= 8
    for f in py:
        for s in _code_strings(ast.parse(f.read_text())):
            assert not inside.search(s), (f, s)
    for f in native:
        assert not re.search(r'#\s*include\s*[<"][^>"]*nw_tpu[/\\]', f.read_text()), f
    assert inside.search("nw_tpu/runtime/cc") and not inside.search("nw_tpu_torch/runtime/cc")
    assert inside.search("nw_tpu") and not inside.search("libnw_tpu_torch-")
