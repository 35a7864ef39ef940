"""Port parity: multivariate HypAD against the JAX package, on the CPU.

The SWaT / WADI / CASAS loaders (CSVs and ``.pt`` tensors written to a
tmpdir in the JAX tests' formats), ``casas_anomalies``, the multivariate
scorers (one call, staged, grid, fleet) and detection, and the kernels'
plain versions at a multivariate width (150) against the JAX Pallas kernels
in interpret mode. Weights are JAX ``init_tadgan``'s, carried over by
``bridge.from_jax_params``.

Score tolerances. Scores that do not read the critic (``rec``,
``rec_uncertainty``) are held at rtol 1e-5 / atol 1e-6. The critic
pipeline's reductions (IQR mean, std, centred rolling mean) sum in another
order than XLA's and its z-score divides by the KDE values' std, so
combinations that read it agree to about 3e-5 relative even on the same
inference; they are held at tests/test_torch_detect.py's score tolerance,
rtol 1e-4 / atol 1e-6. As there, the KDE argmax itself is held at tie
level on its own, and the stages after it take JAX's KDE values, since a
flipped tie moves a score past any fixed bound. Exact-zero and NaN
positions and the intervals are equal everywhere."""

import functools
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from hypad_tpu.data import fetch as jfetch
from hypad_tpu.data import registry as jreg
from hypad_tpu.detect import scorer as jsc
from hypad_tpu.models.tadgan import init_tadgan
from hypad_tpu.ops import kde as jkde
from hypad_tpu_torch import bridge
from hypad_tpu_torch.data import multivariate as tmv
from hypad_tpu_torch.data import registry as treg
from hypad_tpu_torch.detect import detector as tdet
from hypad_tpu_torch.detect import intervals as tiv
from hypad_tpu_torch.detect import scorer as tsc
from hypad_tpu_torch.ops.kde import (
    kde_argmax_rows,
    kde_argmax_rows_and_use,
    kde_argmax_rows_v2_and_use,
)
from hypad_tpu_torch.ops.unroll import antidiagonal_gather

REC_TOL = dict(rtol=1e-5, atol=1e-6)
CRITIC_TOL = dict(rtol=1e-4, atol=1e-6)
N_ROWS = 300
FLEET_LENS = (210, 150, 90)
WIDE = 150


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch ops on one thread: the suite runs in several
    worker processes, whose default thread pools would oversubscribe the
    cores and slow these small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def csv_root(tmp_path_factory):
    """SWaT and WADI CSVs in the JAX tests' formats
    (tests/test_multivariate_e2e.py), with NaNs to impute and an integer
    column."""
    root = tmp_path_factory.mktemp("mvcsv")
    os.makedirs(root / "SWAT")
    os.makedirs(root / "WADI_downsampled")
    rng = np.random.default_rng(0)
    n, f = 400, 12
    base = rng.standard_normal((n, f)).cumsum(axis=0) * 0.01
    base[[3, 50, 51], 2] = np.nan
    cols = [f"s{i}" for i in range(f)]
    for name, shift in (("SWaT_train_mine.csv", 0.0),
                        ("SWaT_test_mine.csv", 3.0)):
        vals = base.copy()
        vals[200:230] += shift
        df = pd.DataFrame(vals, columns=cols)
        df.insert(0, "Timestamp", np.arange(n))
        df["Normal/Attack"] = "Normal"
        df["count"] = rng.integers(0, 5, n)
        if shift:
            df["label"] = (np.arange(n) >= 200) & (np.arange(n) < 230)
        df.to_csv(root / "SWAT" / name)
    wcols = [f"w{i}" for i in range(9)]
    wbase = rng.standard_normal((300, 9)).cumsum(axis=0) * 0.01
    wbase[7, 4] = np.nan
    pd.DataFrame(wbase, columns=wcols).to_csv(
        root / "WADI_downsampled" / "WADI_train.csv", index=False)
    test = pd.DataFrame(wbase - 0.1, columns=wcols)
    test.insert(0, "Time", np.arange(300))
    test["label"] = np.arange(300) % 7 == 0
    test.to_csv(root / "WADI_downsampled" / "WADI_test_mine.csv",
                index=False)
    return str(root)


@pytest.fixture(scope="module")
def casas_root(tmp_path_factory):
    """Every CASAS-family layout (tests/test_casas_family.py's fixture),
    with a NaN in eHealth's test tensor."""
    root = tmp_path_factory.mktemp("mvcasas")
    rng = np.random.default_rng(7)

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32))

    n_train, n_test = 64, 60
    for ds in ("CASAS", "ELINUS", "eHealth"):
        base = root / "DATASETS" / ds
        os.makedirs(base / "POINTS" / "kitchen")
        os.makedirs(base / "POINTS_NEWFEATURES")
        train = rng.standard_normal((n_train // 4, 4, 150))
        torch.save(t(train), base / "normal_sequences.pt")
        torch.save(t(train + 0.1), base / "normal_sequences_newfeatures.pt")
        test = rng.standard_normal((n_test, 150))
        test[20:30] += 4.0
        if ds == "eHealth":
            test[5, 9] = np.nan
        gt = np.zeros(n_test)
        gt[20:30] = 1
        points = base / "POINTS" / "kitchen"
        torch.save(t(test), points / "kitchen_sequences_id1.pt")
        torch.save(t(gt), points / "kitchen_groundtruth_id1.pt")
        newf = base / "POINTS_NEWFEATURES"
        torch.save(t(test - 0.1), newf / "kitchen_sequences_newfeatures.pt")
        torch.save(t(gt), newf / "kitchen_groundtruth_newfeatures.pt")
    nc = root / "CASAS" / "new_dataset" / "milan"
    os.makedirs(nc)
    torch.save(t(rng.standard_normal((n_train, 150))), nc / "x_train")
    torch.save(t(np.zeros(n_train)), nc / "y_train")
    xt = rng.standard_normal((n_test, 150))
    yt = np.zeros(n_test)
    yt[10:15] = 1
    torch.save(t(xt), nc / "x_test")
    torch.save(t(yt), nc / "y_test")
    ca = root / "CASAS_"
    os.makedirs(ca)
    y = np.zeros((50, 120))
    y.reshape(-1)[5700:5750] = 1
    torch.save(t(rng.standard_normal((50, 120, 150))),
               ca / "sequences_2week_aruba.pt")
    torch.save(t(y), ca / "ground_truth_2week_aruba.pt")
    return str(root)


def _params(**kw):
    base = dict(signal="multivariate", id=1, split=1, new_features=False,
                unique_dataset=False, interval=1)
    base.update(kw)
    return SimpleNamespace(**base)


def _same_data(got, want):
    np.testing.assert_array_equal(got.X, want.X)
    assert got.X.dtype == np.float32
    np.testing.assert_array_equal(got.index, want.index)
    if want.y is None:
        assert got.y is None
    else:
        np.testing.assert_array_equal(np.asarray(got.y), np.asarray(want.y))


@pytest.mark.parametrize("dataset", ["SWAT", "WADI"])
def test_csv_loaders_are_bitwise_jax(csv_root, dataset):
    """SWaT (index column, meta columns dropped) and WADI through the
    registry: the imputed, scaled float32 rows bit for bit."""
    p = _params(dataset=dataset, data_root=csv_root)
    want = jreg.dataset_selection(p)
    got = treg.dataset_selection(p)
    assert got[2] == want[2] == ""
    for g, w in zip(got[:2], want[:2]):
        _same_data(g, w)
    assert np.isfinite(got[0].X).all()


@pytest.mark.parametrize("dataset,signal,new_features", [
    ("CASAS", "kitchen", False), ("CASAS", "kitchen", True),
    ("ELINUS", "kitchen", False), ("ELINUS", "kitchen", True),
    ("eHealth", "kitchen", False), ("eHealth", "kitchen", True),
    ("new_CASAS", "milan", False), ("CASAS_", "aruba", False)])
def test_casas_loaders_are_bitwise_jax(casas_root, dataset, signal,
                                       new_features):
    """Every CASAS-family branch: the rows and the ground truth of both
    splits bit for bit (a NaN in eHealth's test tensor where JAX has it;
    the CASAS_ carve-out unscaled)."""
    p = _params(dataset=dataset, signal=signal, new_features=new_features,
                data_root=casas_root)
    want = jreg.dataset_selection(p)
    got = treg.dataset_selection(p)
    for g, w in zip(got[:2], want[:2]):
        _same_data(g, w)
    if dataset == "CASAS_":
        assert (len(got[0]), len(got[1])) == (200, 1300)
    if dataset == "eHealth":
        assert np.isnan(got[1].X).any()


def test_missing_tensor_names_the_file(tmp_path):
    p = _params(dataset="CASAS", signal="kitchen", data_root=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="normal_sequences.pt"):
        treg.dataset_selection(p)


@pytest.mark.parametrize("y", [
    [0, 1, 1, 0, 0, 1, 0, 1, 1],      # a trailing run is dropped
    [1, 0, 0, 1, 1, 1, 0],            # a run of one at 0 ends at x_index[-1]
    [0, 0, 0], [1, 1, 1],
    [0.0, 1.0, 1.0, 1.0, 0.0, 2.0, 1.0, 0.0]])
def test_casas_anomalies_matches_jax(y):
    x_index = np.arange(len(y)) * 10 + 3
    want = jfetch.casas_anomalies(np.asarray(y), x_index)
    got = tmv.casas_anomalies(np.asarray(y), x_index)
    assert got.shape == (len(want), 2)
    np.testing.assert_array_equal(got, want[["start", "end"]].to_numpy()
                                  .reshape(-1, 2).astype(got.dtype))


# ---------------------------------------------------------------------------
# scorers
# ---------------------------------------------------------------------------

def _rows(n, F, seed):
    """Seeded (n, F) rows in [-1, 1] with a shifted block of 20 rows."""
    X = np.random.default_rng(seed).uniform(-1, 1, (n, F)).astype(np.float32)
    X[n // 2:n // 2 + 20] = np.clip(X[n // 2:n // 2 + 20] + 0.8, -1, 1)
    return X


@functools.cache
def _jax_params(F, hyperbolic, seed=0):
    return jax.tree_util.tree_map(np.asarray, init_tadgan(
        jax.random.PRNGKey(F + hyperbolic + 10 * seed), signal_shape=F,
        hyperbolic=hyperbolic))


@functools.cache
def _jax_grid(F, hyperbolic):
    """JAX's multivariate grid, every combination: each cell equals JAX's
    single-cell ``detect_scores`` (tests/test_multivariate_glue.py)."""
    out = jsc.detect_scores_grid(_jax_params(F, hyperbolic),
                                 _rows(N_ROWS, F, F), hyperbolic,
                                 tsc.COMBINATIONS, multivariate=True)
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_own_kde(critic, width):
    """JAX's KDE argmax of the anti-diagonal rows of JAX's own critic values
    (the port's ``antidiagonal_gather`` is bitwise JAX's)."""
    y = np.ascontiguousarray(np.broadcast_to(
        np.asarray(critic, np.float32)[:, None], (len(critic), width)))
    vals, mask = antidiagonal_gather(torch.from_numpy(y))
    return np.asarray(jkde.kde_argmax_rows(jnp.asarray(vals.numpy()),
                                           jnp.asarray(mask.numpy())))


def _jax_critic(params, X, hyperbolic):
    return np.asarray(jsc.run_inference(params, X, hyperbolic).critic_score)


@pytest.fixture
def jax_kde(monkeypatch):
    """The port's scorers take JAX's KDE values of JAX's own critic values
    (set with the returned function, one critic per signal, in the order
    the KDE call takes their rows), so that every stage after the argmax
    sees JAX's inputs. The port's own KDE pick is held at tie level: a row
    whose value is not JAX's (up to the forwards' last bits) is a sample of
    its own row, and such rows are at most 1% of the rows, plus one."""
    port_kde = tsc.kde_argmax_rows_fused
    state = {"want": None, "flips": 0, "rows": 0}

    def kde(vals, mask, version="v1"):
        theirs = state["want"]
        assert theirs is not None and len(theirs) == vals.shape[0]
        ours = port_kde(vals, mask, version).numpy()
        v, m = vals.numpy(), mask.numpy()
        flips = np.nonzero(~np.isclose(ours, theirs, rtol=1e-5, atol=1e-6,
                                       equal_nan=True))[0]
        assert all(ours[i] in v[i][m[i]] for i in flips)
        state["flips"] += len(flips)
        state["rows"] += len(ours)
        return torch.from_numpy(theirs.copy())

    def use(critics, width):
        state["want"] = np.concatenate([_jax_own_kde(c, width)
                                        for c in critics])

    monkeypatch.setattr(tsc, "kde_argmax_rows_fused", kde)
    yield use
    assert state["flips"] <= 1 + 0.01 * state["rows"]


def _assert_scores(got, want, comb, what=""):
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=f"{what}: NaN positions")
    np.testing.assert_array_equal(got == 0, want == 0,
                                  err_msg=f"{what}: zero positions")
    tol = CRITIC_TOL if comb in tsc.CRITIC_COMBOS else REC_TOL
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _starts_ends(intervals):
    """The (start, end) columns of intervals (none comes back as (0,))."""
    return np.asarray(intervals).reshape(-1, 3)[:, :2]


def _model(F, hyperbolic, seed=0):
    return bridge.from_jax_params(_jax_params(F, hyperbolic, seed),
                                  device="cpu")


@pytest.mark.parametrize("comb", tsc.COMBINATIONS)
@pytest.mark.parametrize("F,hyperbolic", [(12, True), (12, False),
                                          (WIDE, True), (WIDE, False)])
def test_mv_detect_scores_matches_jax(jax_kde, F, hyperbolic, comb):
    """``detect_scores(multivariate=True)``, the one call, for every
    combination in both geometries at F = 12 and 150, and its intervals
    (the multivariate threshold windows) equal to those of JAX's scores."""
    want = _jax_grid(F, hyperbolic)[(None, comb)]
    jax_kde([_jax_critic(_jax_params(F, hyperbolic), _rows(N_ROWS, F, F),
                         hyperbolic)], F)
    got, inference = tsc.detect_scores(_model(F, hyperbolic),
                                       _rows(N_ROWS, F, F), hyperbolic,
                                       comb, multivariate=True,
                                       device="cpu")
    _assert_scores(got, want, comb)
    assert inference.true_signal.shape == (N_ROWS, F)
    iv_got, iv_want = (tiv.find_anomalies(s, np.arange(N_ROWS),
                                          **tdet._MV_FA_KW)
                       for s in (got, want))
    np.testing.assert_array_equal(_starts_ends(iv_got), _starts_ends(iv_want))


@pytest.mark.parametrize("F,hyperbolic", [(12, True), (12, False),
                                          (WIDE, True), (WIDE, False)])
def test_mv_staged_path_matches_jax(jax_kde, monkeypatch, F, hyperbolic):
    """Above ``ONE_CALL_MAX_WINDOWS`` (patched down) the chunked forward
    and ``score_anomalies_multivariate``, for detect_scores and the grid."""
    monkeypatch.setattr(tsc, "ONE_CALL_MAX_WINDOWS", 100)
    model, X = _model(F, hyperbolic), _rows(N_ROWS, F, F)
    jax_kde([_jax_critic(_jax_params(F, hyperbolic), X, hyperbolic)], F)
    want = _jax_grid(F, hyperbolic)
    for comb in ("mult", "rec_uncertainty"):
        got, _ = tsc.detect_scores(model, X, hyperbolic, comb,
                                   multivariate=True, device="cpu")
        _assert_scores(got, want[(None, comb)], comb, comb)
    grid = tsc.detect_scores_grid(model, X, hyperbolic, ("sum", "rec"),
                                  multivariate=True, device="cpu")
    assert list(grid) == [(None, "sum"), (None, "rec")]
    for (_, comb), got in grid.items():
        _assert_scores(got, want[(None, comb)], comb, comb)


@pytest.mark.parametrize("F,hyperbolic", [(12, True), (12, False),
                                          (WIDE, True), (WIDE, False)])
def test_mv_grid_matches_jax(jax_kde, F, hyperbolic):
    """``detect_scores_grid(multivariate=True)``: JAX's cells in JAX's
    order, each as JAX computes it."""
    want = _jax_grid(F, hyperbolic)
    jax_kde([_jax_critic(_jax_params(F, hyperbolic), _rows(N_ROWS, F, F),
                         hyperbolic)], F)
    with pytest.warns(UserWarning, match="multivariate" if not hyperbolic
                      else "hyperbolic"):
        got = tsc.detect_scores_grid(_model(F, hyperbolic),
                                     _rows(N_ROWS, F, F), hyperbolic,
                                     tsc.COMBINATIONS, ("point", "dtw"),
                                     multivariate=True, device="cpu")
    assert list(got) == list(want)
    for (_, comb), scores in got.items():
        _assert_scores(scores, want[(None, comb)], comb, comb)


@pytest.mark.parametrize("hyperbolic", [True, False])
def test_score_anomalies_multivariate_matches_jax(jax_kde, hyperbolic):
    """The staged scorer on JAX's own inference outputs."""
    inference = jsc.run_inference(_jax_params(12, hyperbolic),
                                  _rows(N_ROWS, 12, 12), hyperbolic)
    inference = jsc.InferenceOutput(*(None if a is None else np.asarray(a)
                                      for a in inference))
    jax_kde([inference.critic_score], 12)
    for comb in ("mult", "rec"):
        want = np.asarray(jsc.score_anomalies_multivariate(inference, comb,
                                                           hyperbolic))
        got = tsc.score_anomalies_multivariate(inference, comb, hyperbolic,
                                               device="cpu")
        _assert_scores(got, want, comb, comb)


def test_mv_rejects_an_unknown_combination():
    with pytest.raises(ValueError, match="unknown combination"):
        tsc.detect_scores(_model(12, False), _rows(50, 12, 1), False,
                          "bogus", multivariate=True, device="cpu")
    with pytest.raises(ValueError, match="unknown combination"):
        tsc.detect_scores_grid(_model(12, False), _rows(50, 12, 1), False,
                               ("mult", "bogus"), multivariate=True,
                               device="cpu")


@pytest.mark.parametrize("F,hyperbolic,comb", [
    (12, True, "mult"), (12, False, "uncertainty"), (WIDE, True, "mult"),
    (WIDE, False, "sum_uncertainty"), (WIDE, True, "rec")])
def test_mv_fleet_matches_jax(jax_kde, F, hyperbolic, comb):
    """``detect_scores_fleet(multivariate=True)`` on a ragged family
    (210 / 150 / 90 rows), each signal's rec scores z-scored over its own
    rows and one KDE call over every signal's real anti-diagonal rows,
    sliced to N_i: each signal against JAX's ``detect_scores`` of that
    signal alone, which is what the fleet is to compute. (JAX's vmapped
    fleet is not the reference here: its forward's last bits flip a KDE
    tie against its own single-signal call, 9.3e-4 on signal 0 of the
    (150, Euclidean) family.)"""
    params = [_jax_params(F, hyperbolic, seed) for seed in range(3)]
    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), *params)
    X_list = [_rows(n, F, 100 + i) for i, n in enumerate(FLEET_LENS)]
    jax_kde([_jax_critic(p, x, hyperbolic) for p, x in zip(params, X_list)],
            F)
    got = tsc.detect_scores_fleet(
        bridge.from_jax_stacked_params(stacked, device="cpu"), X_list,
        hyperbolic, comb, canonical=False, device="cpu", multivariate=True)
    assert [len(g) for g in got] == list(FLEET_LENS)
    for i, (g, p, x) in enumerate(zip(got, params, X_list)):
        want, _ = jsc.detect_scores(p, x, hyperbolic, comb,
                                    fetch_inference=False, multivariate=True)
        _assert_scores(g, np.asarray(want), comb, f"signal {i}")


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def test_mv_detect_writes_intervals_and_metrics(jax_kde, tmp_path, capsys):
    """``detect`` on a labelled multivariate stream: intervals from JAX's
    multivariate threshold windows on JAX's scores, the ground truth from
    ``casas_anomalies``, the plot that JAX draws by default for a
    multivariate run (``anomalies.png``, matplotlib imports here), and
    under ``load: true`` the cached ``scores_mv_{comb}``."""
    from hypad_tpu.detect import detector as jdet

    X = _rows(N_ROWS, 12, 12)
    jax_kde([_jax_critic(_jax_params(12, True), X, True)], 12)
    y = np.zeros(N_ROWS)
    y[150:170] = 1
    test_data = tmv.MultivariateData(X, y=y)
    params = SimpleNamespace(dataset="CASAS", signal="kitchen",
                             hyperbolic=True, combination="mult",
                             rec_error="dtw", load=False, save_result=False,
                             save_artifacts=True, output_root=str(tmp_path))
    res = tdet.detect(params, _model(12, True), test_data, str(tmp_path),
                      device="cpu")
    assert tdet._PLOT_SKIPPED not in capsys.readouterr().out
    with open(tmp_path / "anomalies.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    want_scores = _jax_grid(12, True)[(None, "mult")]
    _assert_scores(res["scores"], want_scores, "mult")
    want_iv = jdet.iv.find_anomalies(want_scores, np.arange(N_ROWS),
                                     **jdet._MV_FA_KW)
    np.testing.assert_array_equal(_starts_ends(res["intervals"]),
                                  _starts_ends(want_iv))
    known = jdet._multivariate_ground_truth(SimpleNamespace(X=X, y=y))
    np.testing.assert_array_equal(tdet._multivariate_ground_truth(test_data),
                                  known.to_numpy())
    assert os.path.exists(tmp_path / "anomalies.csv")
    assert os.path.exists(tmp_path / "inference.npz")
    params.load = True
    again = tdet.detect(params, _model(12, True), test_data, str(tmp_path),
                        device="cpu")
    np.testing.assert_array_equal(again["scores"], res["scores"])
    np.testing.assert_array_equal(np.load(tmp_path / "scores_mv_mult.npy"),
                                  res["scores"])


@pytest.mark.parametrize("matplotlib_imports", [True, False])
def test_mv_save_plots_true_plots_or_prints_jax_skip_line(
        tmp_path, capsys, monkeypatch, matplotlib_imports):
    """``save_plots=True`` on an unlabelled stream draws ``anomalies.png``
    (the predicted intervals only); with matplotlib's import blocked, JAX's
    skip line is printed, no file is written and detection completes."""
    if not matplotlib_imports:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    params = SimpleNamespace(dataset="SWAT", signal="multivariate",
                             hyperbolic=True, combination="mult",
                             rec_error="dtw", load=False, save_result=False)
    res = tdet.detect(params, _model(12, True),
                      tmv.MultivariateData(_rows(50, 12, 0)), str(tmp_path),
                      save_plots=True, device="cpu")
    out = capsys.readouterr().out
    assert res["scores"].shape == (50,)
    assert os.path.exists(tmp_path / "anomalies.csv")
    assert os.path.exists(tmp_path / "anomalies.png") == matplotlib_imports
    assert (tdet._PLOT_SKIPPED in out) != matplotlib_imports
    assert tdet._PLOT_SKIPPED == (
        "save_plots requested but matplotlib is not installed "
        "(pip install 'hypad-tpu[plots]'); skipping plot")


def test_mv_detect_grid_cells_match_single_detection(tmp_path):
    """The multivariate ``detect_grid``: every cell's intervals and
    confusion those of a single-cell ``detect`` with the same scores."""
    X = _rows(N_ROWS, 12, 12)
    y = np.zeros(N_ROWS)
    y[150:170] = 1
    params = SimpleNamespace(dataset="CASAS", signal="kitchen",
                             hyperbolic=False, combination="mult",
                             rec_error="dtw", load=False, save_result=False,
                             save_artifacts=False, output_root=str(tmp_path))
    model = _model(12, False)
    cells = tdet.detect_grid(params, model, tmv.MultivariateData(X, y=y),
                             str(tmp_path), combinations=list(
                                 tsc.COMBINATIONS), device="cpu")
    assert len(cells) == 8
    table = pd.read_csv(tmp_path / "grid_results.csv")
    assert list(table["combination"]) == [cb for _, cb in cells]
    for (_, comb), cell in cells.items():
        params.combination = comb
        one = tdet.detect(params, model, tmv.MultivariateData(X, y=y),
                          str(tmp_path / comb), save_plots=False,
                          device="cpu")
        np.testing.assert_array_equal(np.asarray(cell["intervals"]),
                                      np.asarray(one["intervals"]))
        assert tuple(cell["confusion"]) == tuple(one["confusion"])


# ---------------------------------------------------------------------------
# the kernels' plain versions at a multivariate width
# ---------------------------------------------------------------------------

def test_wide_mobius_linear_plain_matches_pallas_interpret():
    """K1's plain version at 150 x 150 against JAX's fused MobiusLinear in
    interpret mode (its widths padded to 256 lanes)."""
    from hypad_tpu.manifold.kernels import mobius_linear_fused as jax_fused
    from hypad_tpu.models.tadgan import init_mobius_linear
    from hypad_tpu_torch.manifold.kernels import (
        mobius_linear,
        mobius_linear_kernel,
    )

    p = init_mobius_linear(jax.random.PRNGKey(3), WIDE, WIDE)
    x = np.random.default_rng(3).uniform(-1, 1, (64, WIDE)).astype(np.float32)
    want = np.asarray(jax_fused({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), interpret=True))
    tw, tb = torch.from_numpy(np.array(p["w"])), torch.from_numpy(
        np.array(p["b"]))
    got = mobius_linear(torch.from_numpy(x), tw, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        mobius_linear_kernel(torch.from_numpy(x), tw, tb).numpy(), got)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_wide_kde_plain_matches_pallas_interpret(version):
    """K2's and K3's plain versions on rows 150 wide against JAX's Pallas
    kernels in interpret mode: the use flags and the fallback rows
    bitwise, the rest at tie level."""
    from hypad_tpu.ops.kde_pallas import (
        _pallas_kde,
        _pallas_kde_v2,
        kde_argmax_rows_pallas,
    )
    critic = np.random.default_rng(5).standard_normal(60).astype(np.float32)
    critic[10:40] = 0.5  # zero-variance rows: the median fallback
    y = np.ascontiguousarray(np.broadcast_to(critic[:, None], (60, WIDE)))
    vals, mask = antidiagonal_gather(torch.from_numpy(y))
    plain = (kde_argmax_rows_and_use if version == "v1"
             else kde_argmax_rows_v2_and_use)
    got, use = (t.numpy() for t in plain(vals, mask))
    jv, jm = jnp.asarray(vals.numpy()), jnp.asarray(mask.numpy())
    want = np.asarray(kde_argmax_rows_pallas(jv, jm, interpret=True,
                                             version=version))
    pallas = _pallas_kde if version == "v1" else _pallas_kde_v2
    np.testing.assert_array_equal(use, np.asarray(pallas(jv, jm,
                                                         interpret=True)[1]))
    assert (~use).any()
    np.testing.assert_array_equal(got[~use], want[~use])
    diff = np.nonzero(got != want)[0]
    v, m = vals.numpy(), mask.numpy()
    assert all(got[i] in v[i][m[i]] for i in diff)
    assert len(diff) <= max(1, int(0.01 * len(want)))
    if version == "v1":
        np.testing.assert_array_equal(kde_argmax_rows(vals, mask).numpy()[use],
                                      got[use])


def _critic_case(hyperbolic, B, seed, width=WIDE):
    params = _jax_params(width, hyperbolic, seed)
    rng = np.random.default_rng(seed)
    d = {"z_x": rng.standard_normal((B, 20)).astype(np.float32),
         "a_x": rng.uniform(0, 1, (B, width)).astype(np.float32),
         "z_z": rng.standard_normal((B, 20)).astype(np.float32),
         "a_z": rng.uniform(0, 1, (B, 20)).astype(np.float32),
         "m_cx": rng.uniform(size=(4, 3 * B, 20)) < 0.75,
         "m_cz": rng.uniform(size=(2, 3 * B, 20)) < 0.8,
         "m_dec": rng.uniform(size=(B, 128)) < 0.8}
    x = rng.uniform(-1, 1, (B, width)).astype(np.float32)
    return params, x, d


def _check_critic(got, want, loss_tol, grad_tol):
    lx, lz, gx, gz = got
    jlx, jlz, jgx, jgz = want
    np.testing.assert_allclose(lx.item(), float(jlx), **loss_tol)
    np.testing.assert_allclose(lz.item(), float(jlz), **loss_tol)
    for name, grads, jgrads in (("critic_x", gx, jgx), ("critic_z", gz, jgz)):
        flat = {f"{name}.{k.replace('/', '.')}": v for k, v in
                bridge.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                           jgrads)).items()}
        assert sorted(grads) == sorted(flat)
        for key, value in flat.items():
            np.testing.assert_allclose(grads[key].numpy(), value,
                                       err_msg=key, **grad_tol)


@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_wide_critic_step_plain_matches_pallas_interpret(kernel):
    """K4's and K5's plain versions at a 150-wide signal, B = 8, against
    JAX's Pallas kernels in interpret mode, within the JAX tests'
    tolerances (tests/test_critic_kernel.py:83-93, :113-122)."""
    from hypad_tpu.train import critic_kernel as jck
    from hypad_tpu_torch.train import critic_kernel as tck

    params, x, d = _critic_case(True, 8, 11)
    model = bridge.from_jax_params(params, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    if kernel == "k4":
        rng = np.random.default_rng(12)
        bigx = rng.uniform(-1, 1, (24, WIDE)).astype(np.float32)
        bigz = rng.standard_normal((24, 20)).astype(np.float32)
        want = jck.critics_fused_grads(params["critic_x"], params["critic_z"],
                                       bigx, bigz, d["m_cx"], d["m_cz"],
                                       interpret=True)
        got = tck.critics_fused_grads(
            model["critic_x"], model["critic_z"], torch.from_numpy(bigx),
            torch.from_numpy(bigz), t["m_cx"], t["m_cz"])
        _check_critic(got, want, dict(rtol=2e-5, atol=1e-6),
                      dict(rtol=5e-5, atol=5e-7))
    else:
        want = jck.critic_step_fused_full(
            params, x, dict(d, m_dec=d["m_dec"][None, None]), True,
            interpret=True)
        got = tck.critic_step_fused_full(model, torch.from_numpy(x), t, True)
        _check_critic(got, want, dict(rtol=5e-5, atol=2e-6),
                      dict(rtol=1e-4, atol=1e-6))


@pytest.mark.parametrize("kernel,width", [("k4", 257), ("k4", 300),
                                          ("k5", 257), ("k5", 300)])
def test_critic_step_plain_matches_pallas_interpret_above_256(kernel, width):
    """K4's and K5's wrappers at signal widths above 256, which the card
    runs in the any-width instance (the former refusal above 256 is gone):
    on the CPU the plain versions at B = 4 against JAX's Pallas kernels in
    interpret mode, within the tolerances of the 150-wide case above, and
    no launch counted."""
    from hypad_tpu.train import critic_kernel as jck
    from hypad_tpu_torch.train import critic_kernel as tck

    B = 4
    params, x, d = _critic_case(True, B, width, width)
    model = bridge.from_jax_params(params, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    counters = (tck.critics_fused_grads, tck.critic_step_fused_full)
    before = [(f.launches, f.xwide_launches) for f in counters]
    if kernel == "k4":
        rng = np.random.default_rng(width)
        bigx = rng.uniform(-1, 1, (3 * B, width)).astype(np.float32)
        bigz = rng.standard_normal((3 * B, 20)).astype(np.float32)
        want = jck.critics_fused_grads(params["critic_x"], params["critic_z"],
                                       bigx, bigz, d["m_cx"], d["m_cz"],
                                       interpret=True)
        got = tck.critics_fused_grads(
            model["critic_x"], model["critic_z"], torch.from_numpy(bigx),
            torch.from_numpy(bigz), t["m_cx"], t["m_cz"])
        _check_critic(got, want, dict(rtol=2e-5, atol=1e-6),
                      dict(rtol=5e-5, atol=5e-7))
    else:
        want = jck.critic_step_fused_full(
            params, x, dict(d, m_dec=d["m_dec"][None, None]), True,
            interpret=True)
        got = tck.critic_step_fused_full(model, torch.from_numpy(x), t, True)
        _check_critic(got, want, dict(rtol=5e-5, atol=2e-6),
                      dict(rtol=1e-4, atol=1e-6))
    assert [(f.launches, f.xwide_launches) for f in counters] == before
