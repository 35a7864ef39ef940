"""The port's package rules: hypad_tpu_torch imports no JAX and nothing of
hypad_tpu, keeps pandas, yaml and triton off module tops, and defaults every
entry point to CUDA without falling back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "hypad_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree, top_only):
    nodes = tree.body if top_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _root(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_package_anywhere(path):
    tree = ast.parse(path.read_text())
    bad = [m for m in _imports(tree, top_only=False)
           if _root(m) in ("jax", "jaxlib", "hypad_tpu", "flax", "optax")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_optional_imports_at_module_top(path):
    tree = ast.parse(path.read_text())
    bad = [m for m in _imports(tree, top_only=True)
           if _root(m) in ("pandas", "yaml", "triton", "scipy")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module top"


def test_package_imports_with_jax_blocked():
    """Every port module imports in a fresh interpreter in which importing
    jax, hypad_tpu, pandas or yaml fails."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'hypad_tpu', 'pandas', 'yaml', "
        "'triton'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_detect_scores_defaults_to_cuda():
    from hypad_tpu_torch.detect.scorer import detect_scores
    from hypad_tpu_torch.models.tadgan import build_tadgan

    if torch.cuda.is_available():
        pytest.skip("CUDA is available, so the default device is usable")
    model = build_tadgan(8, hyperbolic=True, device="cpu")
    X = np.zeros((4, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_scores(model, X, True, "mult")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_tadgan(8, hyperbolic=True)


def test_kernel_sources_are_present_and_name_their_tpu_kernel():
    for name, replaces in (("mobius_linear",
                            ["hypad_tpu/manifold/kernels.py:35"]),
                           ("kde_argmax", ["hypad_tpu/ops/kde_pallas.py:42",
                                           "hypad_tpu/ops/kde_pallas.py:91"]),
                           ("critic_step",
                            ["hypad_tpu/train/critic_kernel.py:156",
                             "hypad_tpu/train/critic_kernel.py:350"])):
        src = (PORT / "csrc" / f"{name}.cu").read_text()
        assert all(r in src for r in replaces)
        assert 'extern "C"' in src and "cudaGetLastError" in src


def test_build_compiles_every_kernel_source():
    """Every csrc/*.cu is one of _build.KERNEL_SOURCES, built for sm_90a."""
    from hypad_tpu_torch import _build

    sources = sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert sorted(_build.KERNEL_SOURCES) == sources
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_compiles_extra_jobs_in_the_same_round(tmp_path, monkeypatch):
    """``_build.build(extra_jobs=...)`` hands the stale kernel sources and
    the extra jobs to one ``compile_sources`` round."""
    from hypad_tpu_torch import _build

    rounds = []
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "compile_sources",
                        lambda jobs: rounds.append(dict(jobs)) or {})
    extra = {"empty": (tmp_path / "empty.cu", tmp_path / "libempty.so")}
    _build.build(extra_jobs=extra)
    assert len(rounds) == 1
    assert sorted(rounds[0]) == sorted([*_build.KERNEL_SOURCES, "empty"])
    assert rounds[0]["empty"] == extra["empty"]
    assert rounds[0]["kde_argmax"] == (_build.CSRC / "kde_argmax.cu",
                                       _build.library_path("kde_argmax"))
