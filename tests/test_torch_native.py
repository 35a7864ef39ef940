"""Port parity: the native C++ host engine (hypad_tpu_torch.data.native,
built from the port's own csrc/host/ sources into hypad_tpu_torch/_build/)
against the port's numpy paths and the JAX package's engine, bitwise, on
the CPU: JAX's tests/test_native.py cases (random signals with NaNs, a
signal too short) without the reference CSV, the loader's ``engine``
values, and the dynamic thresholds of 108-cell-style stacks (the NAB
grid's 9 signals x 12 cells) through ``_find_thresholds_batch``. The
build is held safe under six processes building at once."""

import os
import subprocess
import sys

import numpy as np
import pytest

from hypad_tpu.data import native as jnative
from hypad_tpu.data import pipeline as jdp
from hypad_tpu.detect import intervals as jiv
from hypad_tpu_torch import _build
from hypad_tpu_torch.data import native
from hypad_tpu_torch.data import pipeline as tdp
from hypad_tpu_torch.detect import intervals as tiv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    """The port's engine; this box has g++, so it must build."""
    assert native.available(), native.build_error
    return native.get_lib()


def _signal(seed, n=5000):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, 1e6, n))
    vs = rng.standard_normal(n)
    vs[rng.random(n) < 0.02] = np.nan
    return ts, vs


def test_engine_builds_from_the_ports_sources(lib):
    """The library is the host job's, under hypad_tpu_torch/_build/, and
    its digest covers the port's csrc/host/ sources, not native/'s."""
    path = _build.host_library_path()
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.parent.parent.name == "hypad_tpu_torch"
    assert lib._name == str(path)
    assert {"pipeline.cpp", "thresholds.cpp"} == set(_build.HOST_SOURCES)
    assert all((_build.CSRC / "host" / f).exists() for f in _build.HOST_SOURCES)
    assert "-ffp-contract=off" in _build.HOST_FLAGS


@pytest.mark.parametrize("seed,interval,width", [(0, 300.0, 50),
                                                 (1, 1000.0, 100),
                                                 (2, 60.0, 7)])
def test_prepare_univariate_is_numpy_and_jax_bitwise(lib, seed, interval,
                                                     width):
    """JAX's random-signal case (NaNs in 2% of the values): the port's
    engine against the port's numpy pipeline and JAX's engine."""
    ts, vs = _signal(seed)
    before = native.runs["prepare_univariate"]
    got = native.prepare_univariate(ts, vs, interval, window_size=width)
    assert native.runs["prepare_univariate"] == before + 1
    want = tdp._windows(vs, ts, interval, width)
    for g, w in zip(got, (want[0], want[1], want[2], want[3], want[4])):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    jres = jnative.prepare_univariate(ts, vs, interval, window_size=width)
    if jres is not None:   # JAX's engine where native/ builds
        for g, w in zip(got, jres):
            np.testing.assert_array_equal(g, w)
    agg, idx = jdp.time_segments_aggregate(vs, ts, interval)
    wX, *_ = jdp.rolling_windows(jdp.minmax_scale(jdp.impute_mean(agg)),
                                 idx, window_size=width)
    np.testing.assert_array_equal(got[0], wX.astype(np.float32))


def test_too_short_and_the_loader_engines(lib, tmp_path):
    """A signal shorter than a window gives None, and
    ``load_signal_dataset(engine="native")`` raises on it as JAX's does;
    "auto" and "native" equal "numpy" bit for bit on a written CSV, each
    counted under the engine that ran."""
    assert native.prepare_univariate(np.arange(10.0), np.ones(10), 1.0,
                                     window_size=100) is None
    tiny = tmp_path / "tiny.csv"
    tiny.write_text("timestamp,value\n" + "".join(
        f"{i},1.0\n" for i in range(10)))
    with pytest.raises(RuntimeError, match="too short"):
        tdp.load_signal_dataset(str(tiny), interval=1, engine="native")
    if jnative.available():
        with pytest.raises(RuntimeError):
            jdp.load_signal_dataset(str(tiny), interval=1, engine="native")
    ts, vs = _signal(3, 3000)
    csv = tmp_path / "sig.csv"
    csv.write_text("timestamp,value\n" + "".join(
        f"{int(t)},{'' if np.isnan(v) else repr(float(v))}\n"
        for t, v in zip(ts, vs)))
    counts = dict(tdp.load_signal_dataset.engines)
    want = tdp.load_signal_dataset(str(csv), interval=600, engine="numpy")
    for engine in ("auto", "native"):
        got = tdp.load_signal_dataset(str(csv), interval=600, engine=engine)
        for f in ("X", "y", "X_index", "y_index", "index"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert tdp.load_signal_dataset.engines["native"] == counts["native"] + 2
    assert tdp.load_signal_dataset.engines["numpy"] == counts["numpy"] + 1
    jwant = jdp.load_signal_dataset(str(csv), interval=600, engine="numpy")
    np.testing.assert_array_equal(got.X, jwant.X)
    with pytest.raises(ValueError, match="unknown engine"):
        tdp.load_signal_dataset(str(csv), engine="fast")


def _grid_stacks(seed):
    """The threshold windows of 9 signals x 12 cells of dynamic intervals
    (the NAB grid's 108 cells), stacked as ``find_anomalies_batch`` stacks
    them: scores of 1,500 steps, windows a third long, a tenth apart."""
    rng = np.random.default_rng(seed)
    C, T = 108, 1500
    E = 1.0 + 0.15 * rng.standard_normal((C, T))
    for c in range(C):
        for _ in range(rng.integers(0, 4)):
            s = rng.integers(0, T - 30)
            E[c, s:s + rng.integers(1, 25)] += rng.uniform(1, 6)
    E[7] = 1.0                     # a constant cell: every cost inf
    E[8, 200:400] = 0.0            # an exact-zero run
    L, step = int(T * 0.33), int(T * 0.1)
    return np.concatenate([E[:, s:s + L] for s in range(0, T - L, step)])


@pytest.mark.parametrize("seed", [0, 1])
def test_find_thresholds_batch_native_is_numpy_and_jax_bitwise(lib, seed):
    """``_find_thresholds_batch`` on the engine equals the numpy replica
    and JAX's batch (JAX on its engine where native/ builds) bit for bit,
    on 108-cell stacks; "native" raises where the engine is missing."""
    W = _grid_stacks(seed)
    counts = dict(tiv._find_thresholds_batch.engines)
    got = tiv._find_thresholds_batch(W, engine="native")
    want = tiv._find_thresholds_batch(W, engine="numpy")
    assert tiv._find_thresholds_batch.engines == {
        "native": counts["native"] + 1, "numpy": counts["numpy"] + 1}
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jiv._find_thresholds_batch(W))
    direct = native.find_thresholds(W, W.mean(axis=1), W.std(axis=1), 0, 10)
    np.testing.assert_array_equal(direct, got)


def test_find_thresholds_batch_without_the_engine(monkeypatch):
    """Where the engine cannot build, "auto" runs the numpy replica (the
    same bits) and "native" raises naming why."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "build_error", "g++ not found")
    W = _grid_stacks(2)[:40]
    np.testing.assert_array_equal(tiv._find_thresholds_batch(W),
                                  jiv._find_thresholds_batch(W))
    with pytest.raises(RuntimeError, match="g.. not found"):
        tiv._find_thresholds_batch(W, engine="native")


_BUILD_ONE = """
import sys
from pathlib import Path
import numpy as np
from hypad_tpu_torch import _build
_build.BUILD_DIR = Path(sys.argv[1])
from hypad_tpu_torch.data import native
lib = native.get_lib()
assert lib is not None, native.build_error
W = np.random.default_rng(0).standard_normal((5, 60)) + 1.0
print(native.find_thresholds(W, W.mean(1), W.std(1)).tobytes().hex())
"""


def test_six_processes_building_at_once_load_one_whole_library(tmp_path):
    """Six processes start on an empty build directory together, as the
    test workers may: each builds under the lock or waits for the build,
    none loads a half-written library, and all compute the same bits; one
    library is left, no temporary file."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len({o for o, _ in outs}) == 1
    left = sorted(f.name for f in tmp_path.iterdir())
    assert [f for f in left if f.endswith(".so")] == [
        _build.host_library_path().name]
    assert not [f for f in left if f.endswith(".tmp")]
