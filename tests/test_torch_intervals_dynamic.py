"""Port parity: the dynamic thresholds of hypad_tpu_torch.detect.intervals
(``fixed_threshold`` None or False, JAX's default) against the JAX package,
bitwise, on the CPU.

The serial ``find_threshold`` runs scipy's ``fmin`` in both packages. The
batched path is the native C++ engine (``data/native.py``) or, where it is
not built, the numpy replica of that Nelder-Mead, in both packages; each
batch case runs the port on both engines (``ENGINES``) and holds each
against JAX, itself on its engine and on its replica. The fixtures are
JAX's own (tests/test_intervals_batch.py)."""

import functools

import numpy as np
import pytest
import torch

from hypad_tpu.data import native as jnative
from hypad_tpu.detect import intervals as jiv
from hypad_tpu_torch.detect import intervals as tiv

DYNAMIC_KW = dict(window_size_portion=0.33, window_step_size_portion=0.1,
                  fixed_threshold=False)
ENGINES = ("native", "numpy")
_BATCH = tiv._find_thresholds_batch


def _on_engine(monkeypatch, engine):
    """Make the port's batched thresholds run on ``engine``."""
    monkeypatch.setattr(tiv, "_find_thresholds_batch",
                        functools.partial(_BATCH, engine=engine))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _score_matrix(rng, C, T, n_spikes=4):
    """tests/test_intervals_batch.py's score fixture."""
    E = 1.0 + 0.15 * rng.standard_normal((C, T))
    for c in range(C):
        for _ in range(rng.integers(0, n_spikes)):
            s = rng.integers(0, T - 30)
            E[c, s:s + rng.integers(1, 25)] += rng.uniform(1, 6)
    return E


def _same(got, want, what=""):
    assert len(got) == len(want), what
    for c, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), f"{what} cell {c}: {g} != {w}"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_find_threshold_and_z_cost_are_bitwise_jax(seed):
    """The serial threshold over many windows (scipy's fmin from each
    integer start in both packages), and the z-cost it minimizes,
    including starts where no run lies above and the cost is inf."""
    rng = np.random.default_rng(seed)
    W = _score_matrix(rng, 8, 463)
    for c, window in enumerate(W):
        got = tiv.find_threshold(window)
        assert got == jiv.find_threshold(window), f"window {c}"
        mean, std = window.mean(), window.std()
        for z in (0.0, 0.5, 2.5, 7.0, 40.0):
            assert (tiv.z_cost(z, window, mean, std)
                    == jiv.z_cost(z, window, mean, std))
    assert tiv.find_threshold(W[0], (2, 5)) == jiv.find_threshold(W[0],
                                                                  (2, 5))
    pruned = [(3, 9, 4.5), (40, 41, 2.0)]
    assert (tiv.compute_scores(pruned, W[1], 1.7, 100)
            == jiv.compute_scores(pruned, W[1], 1.7, 100))


@pytest.mark.parametrize("jax_engine", ["native", "numpy"])
def test_find_thresholds_batch_is_bitwise_jax(jax_engine, monkeypatch):
    """The batched Nelder-Mead against JAX's, with JAX on its native engine
    and on its numpy replica, the port on each of ``ENGINES``; and within
    1e-9 of the serial thresholds, as JAX's own test holds its batch."""
    if jax_engine == "numpy":
        monkeypatch.setattr(jnative, "find_thresholds",
                            lambda *a, **k: None)
    rng = np.random.default_rng(123)
    W = _score_matrix(rng, 37, 463)
    W[5] = 1.0                      # constant: std 0, every cost inf
    W[6, ::2] = np.nan
    want = jiv._find_thresholds_batch(W)
    for engine in ENGINES:
        got = tiv._find_thresholds_batch(W, engine=engine)
        np.testing.assert_array_equal(got, want, err_msg=engine)
    for c in (0, 1, 17, 36):
        np.testing.assert_allclose(got[c], tiv.find_threshold(W[c]),
                                   rtol=1e-9)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dynamic_find_anomalies_batch_matches_jax(seed, monkeypatch):
    """JAX's dynamic parity fixture: 11 cells, ragged tail windows,
    ``lower_threshold`` on seed 2. The batch, on each of ``ENGINES``, is
    bitwise JAX's batch on every cell; on two cells the serial
    ``find_anomalies`` is bitwise JAX's serial one and equal to the
    batch."""
    rng = np.random.default_rng(seed)
    C, T = 11, 1400 + 37 * seed
    E = _score_matrix(rng, C, T)
    idx = np.arange(T) * 21600
    kw = dict(DYNAMIC_KW, lower_threshold=(seed == 2))
    want = jiv.find_anomalies_batch(E, idx, **kw)
    assert sum(len(w) for w in want) > 0, "degenerate fixture"
    for engine in ENGINES:
        _on_engine(monkeypatch, engine)
        got = tiv.find_anomalies_batch(E, idx, **kw)
        _same(got, want, f"batch ({engine})")
    for c in (0, 10):
        serial = tiv.find_anomalies(E[c], idx, **kw)
        assert np.array_equal(serial, jiv.find_anomalies(E[c], idx, **kw))
        assert np.array_equal(serial, got[c]), f"cell {c}"


def test_dynamic_batch_takes_per_cell_indexes_as_jax():
    """JAX's per-cell index fixture under dynamic thresholds: batch and
    serial against JAX's, and the batch equal to the serial path cell by
    cell."""
    rng = np.random.default_rng(0)
    E = _score_matrix(rng, 3, 800)
    idxs = [np.arange(800) * (k + 1) for k in range(3)]
    kw = dict(window_size_portion=0.33, window_step_size_portion=0.1)
    for fixed in (False, None):
        got = tiv.find_anomalies_batch(E, idxs, fixed_threshold=fixed, **kw)
        _same(got, jiv.find_anomalies_batch(E, idxs, fixed_threshold=fixed,
                                            **kw), f"batch {fixed}")
    per = [tiv.find_anomalies(E[c], idxs[c], **kw) for c in range(3)]
    _same(per, [jiv.find_anomalies(E[c], idxs[c], **kw) for c in range(3)],
          "serial")
    _same(got, per, "batch against serial")


@pytest.mark.parametrize("seed", [4, 5])
def test_dynamic_batch_equals_serial_cell_by_cell(seed, monkeypatch):
    """Every cell of a small grid, with exact-zero runs, a constant cell and
    a run in the truncated tail window, ``lower_threshold`` on one seed
    (threshold windows a third of the series, a quarter of one apart): the
    batch equals the serial chain cell by cell."""
    rng = np.random.default_rng(seed)
    C, T = 5, 517
    E = _score_matrix(rng, C, T)
    E[1, 100:160] = 0.0
    E[2] = 1.0
    E[3, 505:] += 5.0
    index = 1e9 + 60.0 * np.arange(T + 99)
    kw = dict(DYNAMIC_KW, window_step_size_portion=0.25,
              lower_threshold=(seed == 5))
    serial = [tiv.find_anomalies(E[c], index, **kw) for c in range(C)]
    want = jiv.find_anomalies_batch(E, index, **kw)
    for engine in ENGINES:
        _on_engine(monkeypatch, engine)
        got = tiv.find_anomalies_batch(E, index, **kw)
        _same(got, serial, f"against serial ({engine})")
        _same(got, want, f"against JAX ({engine})")
