"""The port's package rules: hypad_tpu_torch imports no JAX and nothing of
hypad_tpu, keeps pandas, yaml, triton, scipy and matplotlib off module
tops, and defaults every entry point to CUDA without falling back to the
CPU."""

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


def _code_strings(tree):
    """The string constants of ``tree`` that are not docstrings."""
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_code_reads_the_jax_package_or_its_native_directory(path):
    """No string the port's code uses names a path of the JAX package or
    of its ``native/`` directory: the port builds its host engine from its
    own ``csrc/host/`` copy and reads no file of ``hypad_tpu/``. (Comments
    and docstrings may cite the JAX source they port.)"""
    import re

    tree = ast.parse(path.read_text())
    # a "file.py:line" citation (a kernel's ``replaces``) reads nothing
    bad = [s for s in _code_strings(tree)
           if ("hypad_tpu/" in s.replace("hypad_tpu_torch/", "")
               and not re.fullmatch(r"hypad_tpu/[\w/]+\.py:\d+", s))
           or "native/" in s or "libhypad_native" in s]
    # nor is a "native" directory joined into a path
    bad += [ast.unparse(node) for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and ast.unparse(node.func).endswith(("path.join", "Path"))
            and any(isinstance(a, ast.Constant) and a.value == "native"
                    for a in node.args)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_host_engine_sources_include_only_system_headers():
    """csrc/host/*.cpp, the port's copy of the native engine, includes
    nothing but the C++ library: no file outside the port."""
    for src in sorted((PORT / "csrc" / "host").glob("*.cpp")):
        includes = [line for line in src.read_text().splitlines()
                    if line.startswith("#include")]
        assert includes and all("<" in line for line in includes), src


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_optional_imports_at_module_top(path):
    tree = ast.parse(path.read_text())
    bad = [m for m in _imports(tree, top_only=True)
           if _root(m) in ("pandas", "yaml", "triton", "scipy",
                           "matplotlib")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module top"


def test_package_imports_with_jax_blocked():
    """Every port module imports in a fresh interpreter in which importing
    jax, hypad_tpu, pandas, yaml, triton, scipy or matplotlib fails."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'hypad_tpu', 'pandas', 'yaml', "
        "'triton', 'scipy', 'matplotlib'):\n"
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


def test_cli_runs_with_pandas_yaml_orbax_and_jax_blocked(tmp_path):
    """``python -m hypad_tpu_torch.cli train`` then ``detect`` on the CPU,
    in interpreters in which importing pandas, yaml, orbax, jax or
    hypad_tpu fails: the card's machine has no pandas, PyYAML or orbax."""
    n = 160
    rng = np.random.default_rng(0)
    values = np.sin(np.arange(n) / 4.0) + 0.1 * rng.standard_normal(n)
    values[100:106] += 4.0
    stamps = 1_400_000_000 + 21600 * np.arange(n)
    (tmp_path / "sig.csv").write_text("timestamp,value\n" + "".join(
        f"{s},{float(v)!r}\n" for s, v in zip(stamps, np.round(values, 6))))
    (tmp_path / "anomalies.csv").write_text(
        f'signal,events\nsig,"[[{stamps[100]}, {stamps[105]}]]"\n')
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        "dataset: 'NAB'\nsignal: 'sig'  # a comment\nepochs: 1\n"
        "hyperbolic: True\nsignal_shape: 100\nlr: 0.0005\nbatch_size: 16\n"
        "save_result: True\nfilename: 'r.csv'\nrec_error: 'point'\n"
        "combination: 'mult'\ninterval: 21600\nunique_dataset: True\n"
        f"devices: 1\ndata_root: '{tmp_path}'\noutput_root: '{tmp_path}'\n")
    blocked = ("jax", "jaxlib", "hypad_tpu", "pandas", "yaml", "orbax",
               "tensorstore", "triton")
    # one thread a process: the suite runs in several worker processes
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for argv in (["train"], ["detect"],
                 ["detect", "--rec-errors", "point", "--combinations",
                  "mult,rec"]):
        code = (
            "import runpy, sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = ['cli', *{argv!r}, '--config', {str(cfg)!r}, "
            "'--device', 'cpu']\n"
            "runpy.run_module('hypad_tpu_torch.cli', run_name='__main__')\n"
            f"assert not any(sys.modules.get(m) for m in {blocked!r})\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "wall-clock" in out.stdout
    run = tmp_path / "trained_models" / "models_hyper_NAB_1_0.0005" / "NAB"
    names = sorted(os.listdir(run / "sig"))
    assert names == ["anomalies.csv", "config.yaml", "grid_results.csv",
                     "inference.npz", "state_final.pt", "train_log.jsonl"]
    assert (tmp_path / "results" / "r.csv").is_file()


def test_cli_defaults_to_cuda(tmp_path):
    from hypad_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("CUDA is available, so the default device is usable")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"output_root: '{tmp_path}'\n")
    for command in ("train", "detect"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([command, "--config", str(cfg)])
