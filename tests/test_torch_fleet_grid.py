"""Port parity: the fleet grid (``detect_scores_fleet_grid``) and the
``sweep --rec-errors/--combinations`` command on the CPU.

The family is ragged (210 / 150 / 90 windows, as
tests/test_torch_fleet_detect.py has it), so each signal has its own
smoothing window and every masked reduction runs off the unpadded path.
Weights are JAX ``init_tadgan``'s, carried over by the stacked-parameter
bridge.

The fleet grid is held three ways:

* each cell bitwise the port's own fleet detection of that one cell
  (``detect_scores_fleet``, which is the grid's one-cell case), and each
  signal against the port's single-signal ``detect_scores_grid`` at
  tests/test_fleet_detect.py's fleet bound with the exact-zero and NaN
  positions equal: the fleet's masked reductions (ragged rolling sums,
  masked quantiles and z-scores) sum in another order than the unpadded
  ones, so the two are not bitwise (up to 1.5e-5 on this family);
* against JAX's ``detect_scores_fleet_grid``, with JAX's KDE argmax fed
  in as tests/test_torch_fleet_detect.py feeds it (the port's own pick
  held at tie level), ``sum`` held as sum + 1. Hyperbolic and
  multivariate cells: critic combinations at rtol 1e-4 and the others at
  1e-5 (tests/test_torch_multivariate.py's tolerances). Euclidean cells at
  the fleet bound, as tests/test_torch_fleet_detect.py holds the
  Euclidean fleet against JAX's: their reconstruction errors pass through
  the ragged rolling trapezoid and mean, whose cumulative sums run in
  another order than XLA's (up to 1.2e-4 relative on this family's
  ``rec`` cells);
* chunked: ``FLEET_MAX_BYTES`` forced low changes no value."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hypad_tpu.detect import scorer as jsc
from hypad_tpu.models.tadgan import init_tadgan
from hypad_tpu.ops import kde as jkde
from hypad_tpu_torch import bridge
from hypad_tpu_torch import cli as tcli
from hypad_tpu_torch.detect import detector as tdet
from hypad_tpu_torch.detect import scorer as tsc
from hypad_tpu_torch.train import fleet as tfl
from hypad_tpu_torch.utils import checkpoint as tck
from hypad_tpu_torch.utils import config as tcfg

W = 100
F = 12
LENS = (210, 150, 90)
FLEET_TOL = dict(rtol=3e-4, atol=1e-5)   # tests/test_fleet_detect.py
REC_TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_torch_multivariate.py
CRITIC_TOL = dict(rtol=1e-4, atol=1e-6)
T0 = 1_400_000_000


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch ops on one thread: the suite runs in several
    worker processes, whose default thread pools would oversubscribe the
    cores and slow these small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_windows(n, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 20 * np.pi, n + W)
    s = np.sin(t) + 0.05 * rng.standard_normal(n + W)
    X = np.stack([s[i:i + W] for i in range(n)]).astype(np.float32)
    return np.clip(X, -1, 1)


def _toy_rows(n, seed):
    """(n, F) multivariate rows: random walks with a level shift."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(rng.standard_normal((n, F)), axis=0) * 0.05
    X[n // 2:n // 2 + 10] += 1.0
    return np.clip(X, -1, 1).astype(np.float32)


def _family(kind):
    """(stacked JAX weights, X_list, hyperbolic, multivariate) of a ragged
    family: "hyperbolic", "euclidean" or "multivariate" (hyperbolic
    rows of F features)."""
    hyperbolic = kind != "euclidean"
    mv = kind == "multivariate"
    width = F if mv else W
    params = [init_tadgan(jax.random.PRNGKey(7 + i), signal_shape=width,
                          hyperbolic=hyperbolic) for i in range(len(LENS))]
    X_list = [(_toy_rows if mv else _toy_windows)(n, i)
              for i, n in enumerate(LENS)]
    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), *params)
    return stacked, X_list, hyperbolic, mv


def _cells(kind):
    """(combinations, rec_errors) of the whole grid of ``kind``."""
    if kind == "euclidean":
        return list(tsc.EUCL_COMBOS), list(tsc.REC_ERRORS)
    return list(tsc.COMBINATIONS), ["point"]


def _assert_scores(got, want, what, comb, tol):
    """``tol``, and the exact-zero and NaN positions equal. "sum" is
    (c - 1) / 2 + (r - 1) / 2 of scores c, r >= 1, held as sum + 1 as
    tests/test_torch_eucl.py holds it."""
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=f"{what}: NaN positions")
    np.testing.assert_array_equal(got == 0, want == 0,
                                  err_msg=f"{what}: zero positions")
    shift = 1.0 if comb == "sum" else 0.0
    np.testing.assert_allclose(got + shift, want + shift, err_msg=what,
                               **tol)


@pytest.mark.parametrize("kind", ["hyperbolic", "euclidean",
                                  "multivariate"])
def test_fleet_grid_matches_single_cells_and_single_signal_grids(kind):
    """Every cell of every signal: bitwise the port's fleet detection of
    that cell alone, and within the fleet bound of the port's
    ``detect_scores_grid`` of that signal alone (zeros and NaNs equal);
    the cells in JAX's order, keyed by combination alone for hyperbolic
    and multivariate families, each signal sliced to its true length."""
    stacked, X_list, hyperbolic, mv = _family(kind)
    P = bridge.from_jax_stacked_params(stacked, device="cpu")
    combos, recs = _cells(kind)
    grid = tsc.detect_scores_fleet_grid(P, X_list, hyperbolic, combos, recs,
                                        canonical=False, device="cpu",
                                        multivariate=mv)
    assert len(grid) == len(LENS)
    for cell in grid[0]:
        re_, cb = cell
        one = tsc.detect_scores_fleet(P, X_list, hyperbolic, cb,
                                      rec_error=re_ or "point",
                                      canonical=False, device="cpu",
                                      multivariate=mv)
        for i in range(len(LENS)):
            np.testing.assert_array_equal(grid[i][cell], one[i],
                                          err_msg=f"{cell} signal {i}")
    for i, X in enumerate(X_list):
        want = tsc.detect_scores_grid(tfl.unstack_model(P, i), X, hyperbolic,
                                      combos, recs, device="cpu",
                                      multivariate=mv)
        assert list(grid[i]) == list(want)
        length = LENS[i] + (0 if hyperbolic or mv else W - 1)
        for cell, w in want.items():
            assert grid[i][cell].shape == (length,)
            _assert_scores(grid[i][cell], w, f"{cell} signal {i}", cell[1],
                           FLEET_TOL)


@pytest.mark.parametrize("kind,canonical", [("hyperbolic", False),
                                            ("euclidean", False),
                                            ("euclidean", True),
                                            ("multivariate", False)])
def test_fleet_grid_matches_jax_fleet_grid(monkeypatch, kind, canonical):
    """Against JAX's ``detect_scores_fleet_grid`` on the same stacked
    weights, with and without the canonical path (whose one observable
    effect, the 256-ulp snap, the port keeps): JAX's KDE argmax fed in
    (the port's own pick differs from it on at most 3 rows, each a sample
    of its own row), then every cell at its tolerance with zeros and NaNs
    where JAX has them; one KDE call for the whole grid."""
    stacked, X_list, hyperbolic, mv = _family(kind)
    combos, recs = _cells(kind)
    want = jsc.detect_scores_fleet_grid(stacked, X_list, hyperbolic, combos,
                                        rec_errors=recs, canonical=canonical,
                                        multivariate=mv)
    port_kde = tsc.kde_argmax_rows_fused
    calls, flips = [], []

    def jax_kde(vals, mask, version):
        ours = port_kde(vals, mask, version).numpy()
        theirs = np.asarray(jkde.kde_argmax_rows(jnp.asarray(vals.numpy()),
                                                 jnp.asarray(mask.numpy())))
        v, m = vals.numpy(), mask.numpy()
        for i in np.nonzero(ours != theirs)[0]:
            assert ours[i] in v[i][m[i]]
            flips.append(i)
        calls.append(len(ours))
        return torch.from_numpy(theirs)

    monkeypatch.setattr(tsc, "kde_argmax_rows_fused", jax_kde)
    got = tsc.detect_scores_fleet_grid(
        bridge.from_jax_stacked_params(stacked, device="cpu"), X_list,
        hyperbolic, combos, recs, canonical=canonical, device="cpu",
        multivariate=mv)
    width = F if mv else W
    assert calls == [sum(n + width - 1 for n in LENS)]
    assert len(flips) <= 3
    assert len(got) == len(want) == len(LENS)
    for i, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w)
        for cell, scores in w.items():
            tol = (FLEET_TOL if kind == "euclidean" else CRITIC_TOL
                   if cell[1] in tsc.CRITIC_COMBOS else REC_TOL)
            _assert_scores(g[cell], np.asarray(scores), f"{cell} signal {i}",
                           cell[1], tol)


def test_fleet_grid_chunks_change_no_value(monkeypatch):
    """A budget forced down to two signals a chunk (the tail chunk slid
    back over the first) gives the one-call grid bit for bit, and so does
    the staged stack; ``mesh`` raises naming ROADMAP A13."""
    stacked, X_list, hyperbolic, mv = _family("euclidean")
    P = bridge.from_jax_stacked_params(stacked, device="cpu")
    args = (P, X_list, hyperbolic, ["mult", "rec"], ["point", "area"])
    full = tsc.detect_scores_fleet_grid(*args, device="cpu")
    Xs, n_real = tfl.pad_and_stack(X_list)
    staged = tsc.detect_scores_fleet_grid(
        *args, staged=(torch.from_numpy(Xs), n_real), device="cpu")
    monkeypatch.setattr(tsc, "FLEET_MAX_BYTES",
                        2 * max(LENS) * tsc.FLEET_BYTES_PER_WINDOW)
    assert tsc.fleet_chunk_plan(3, max(LENS)) == ([(0, 2), (2, 2)], 2)
    chunked = tsc.detect_scores_fleet_grid(*args, device="cpu")
    for a, b, c in zip(full, staged, chunked):
        assert list(a) == list(b) == list(c)
        for cell in a:
            np.testing.assert_array_equal(a[cell], b[cell])
            np.testing.assert_array_equal(a[cell], c[cell])
    with pytest.raises(NotImplementedError, match="A13"):
        tsc.detect_scores_fleet_grid(*args, mesh=object(), device="cpu")


def test_grid_ranking_orders_cells_as_the_sweep_prints_them():
    """Mean over each cell's non-NaN f1 with n counting them; best first;
    equal means in first-seen order; a cell of NaN f1 only last, n = 0."""
    rows = [{"rec_error": "", "combination": c, "f1": f} for c, f in (
        ("a", 0.5), ("b", 0.75), ("c", math.nan), ("d", 0.25),
        ("a", 1.0), ("b", math.nan), ("c", math.nan), ("d", 1.0))]
    got = tcli.grid_ranking(rows)
    assert [r[1] for r in got] == ["a", "b", "d", "c"]
    assert [r[3] for r in got] == [2, 1, 2, 0]
    assert got[0][2] == got[1][2] == 0.75 and got[2][2] == 0.625
    assert math.isnan(got[3][2])


# ---------------------------------------------------------------------------
# the command: sweep --detect-only --rec-errors ... --combinations ...
# ---------------------------------------------------------------------------

SWEEP_LENGTHS = {"sig_a": 360, "sig_b": 300, "sig_c": 330}


def _write_signals(root):
    """NAB-style CSVs, each a flat series with a little noise and one level
    shift of +5 over 10 samples (which an untrained model's
    reconstruction error finds); sig_c's anomalies.csv entry lists no
    event, so its metrics are undefined (f1 NaN in the sweep table)."""
    os.makedirs(root, exist_ok=True)
    rows = []
    for k, (name, n) in enumerate(SWEEP_LENGTHS.items()):
        rng = np.random.default_rng(k)
        t = np.arange(n)
        values = 0.05 * rng.standard_normal(n)
        a = int(0.6 * n)
        values[a:a + 10] += 5
        stamps = T0 + 21600 * t
        with open(os.path.join(root, f"{name}.csv"), "w") as f:
            f.write("timestamp,value\n")
            for s, v in zip(stamps, np.round(values, 6)):
                f.write(f"{s},{float(v)!r}\n")
        events = [] if name == "sig_c" else [[int(stamps[a]),
                                              int(stamps[a + 9])]]
        rows.append(f'{name},"{json.dumps(events)}"')
    with open(os.path.join(root, "anomalies.csv"), "w") as f:
        f.write("signal,events\n" + "\n".join(rows) + "\n")


def _read_csv(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0].split(","), [line.split(",") for line in lines[1:]]


def test_sweep_grid_writes_each_runs_grid_and_the_family_table(tmp_path,
                                                               capsys):
    """``sweep --detect-only --rec-errors point,dtw --combinations all`` on
    a trained 3-signal Euclidean family: one fleet-grid call (JAX's
    wall-clock line); each run's grid_results.csv the rows of that run's
    own ``detect_grid`` (confusion and metrics); ``sweep_grid.csv``
    beside ``sweep_log.jsonl`` with the columns signal, seed, rec_error,
    combination, f1, the runs in order and each run's cells in grid
    order, sig_c's f1 empty (no ground truth); and the ranking of the
    cells by mean f1 over the non-NaN runs."""
    _write_signals(tmp_path / "data")
    cfg = dict(dataset="NAB", signal="sig_a", signals=list(SWEEP_LENGTHS),
               epochs=1, hyperbolic=False, signal_shape=100, lr=0.0005,
               batch_size=32, rec_error="point", combination="mult",
               interval=21600, unique_dataset=True,
               data_root=str(tmp_path / "data"), devices=1,
               save_result=False, fused_critics="full",
               output_root=str(tmp_path / "out"))
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml.safe_dump(cfg))
    tcli.main(["sweep", "--config", str(path), "--device", "cpu"])
    capsys.readouterr()
    results = tcli.main(["sweep", "--config", str(path), "--device", "cpu",
                         "--detect-only", "--rec-errors", "point,dtw",
                         "--combinations", "all"])
    out = capsys.readouterr().out
    assert "fleet grid detection wall-clock:" in out
    assert "for 3 signals x 8 cells in one program" in out
    cells = [(re_, cb) for re_ in ("dtw", "point")
             for cb in sorted(tsc.EUCL_COMBOS)]
    assert [(s, sd) for s, sd, _ in results] == [
        (s, 0) for s in SWEEP_LENGTHS]
    params = tcfg.load_config(str(path))
    table = []
    for signal, seed, res in results:
        assert list(res) == cells
        params.signal = signal
        run = tcfg.run_dir(params)
        header, swept = _read_csv(os.path.join(run, "grid_results.csv"))
        model = tck.restore_state(run, "final", "cpu").model
        _, test_data, _ = tcli._build(params)
        own = tdet.detect_grid(params, model, test_data, str(tmp_path / signal),
                               rec_errors=["point", "dtw"],
                               combinations=list(tsc.EUCL_COMBOS),
                               device="cpu")
        assert list(own) == cells
        own_header, own_rows = _read_csv(str(tmp_path / signal /
                                             "grid_results.csv"))
        assert header == own_header and swept == own_rows
        for cell in cells:
            m = res[cell]["metrics"] or {}
            table.append([signal, str(seed), cell[0], cell[1],
                          repr(float(m["f1"])) if "f1" in m else ""])
    params.signal = "sig_a"
    first = tcfg.run_dir(params)
    assert os.path.exists(os.path.join(first, "sweep_log.jsonl"))
    header, rows = _read_csv(os.path.join(first, "sweep_grid.csv"))
    assert header == ["signal", "seed", "rec_error", "combination", "f1"]
    assert rows == table
    assert all(r[4] == "" for r in rows if r[0] == "sig_c")
    lines = out.splitlines()
    start = lines.index("sweep grid mean f1 over 3 runs, best cell first:")
    printed = lines[start + 1:start + 1 + len(cells)]
    ranked = tcli.grid_ranking([
        {"rec_error": r[2], "combination": r[3],
         "f1": float(r[4]) if r[4] else math.nan} for r in rows])
    assert printed == [f"  {re_}/{cb}: {mean:.4f} (n={n})"
                       for re_, cb, mean, n in ranked]
    # sig_c adds no f1 to any cell's mean
    assert max(n for *_, n in ranked) == 2
