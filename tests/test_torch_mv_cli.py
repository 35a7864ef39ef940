"""Port parity: the command line on multivariate configs, against the JAX
package's CLI on the same data and weights, on the CPU.

A SWaT-format corpus (CSVs, 12 features) and a CASAS-format family (``.pt``
tensors, 150 features, three residents) are written to a tmpdir. JAX
``train`` / ``sweep`` (1 epoch) write checkpoints that
``train_state_from_jax`` carries over; the port's ``detect`` / ``sweep
--detect-only`` on them must give JAX's intervals, confusion and F1. The
port's own ``train`` and ``sweep`` (its own weights) run end to end and
re-enter their run directories."""

import importlib.util
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from hypad_tpu import cli as jcli
from hypad_tpu.detect import scorer as jsc
from hypad_tpu.utils import checkpoint as jck
from hypad_tpu.utils import config as jcfg
from hypad_tpu_torch import bridge
from hypad_tpu_torch import cli as tcli
from hypad_tpu_torch.data import registry as treg
from hypad_tpu_torch.detect import scorer as tsc
from hypad_tpu_torch.train.state_bridge import train_state_from_jax
from hypad_tpu_torch.utils import checkpoint as tck
from hypad_tpu_torch.utils import config as tcfg

INTERVAL_SCORE_TOL = dict(rtol=1e-3)  # tests/test_torch_cli.py's
RESIDENTS = ("kitchen", "bedroom", "bathroom")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch ops on one thread, as tests/test_torch_cli.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_swat(root):
    """tests/test_multivariate_e2e.py's SWaT corpus: 400 rows of 12
    features, an injected shift at rows 200-229 in the test split."""
    os.makedirs(root / "SWAT", exist_ok=True)
    rng = np.random.default_rng(0)
    n, f = 400, 12
    base = rng.standard_normal((n, f)).cumsum(axis=0) * 0.01
    for name, shift in (("SWaT_train_mine.csv", 0.0),
                        ("SWaT_test_mine.csv", 3.0)):
        vals = base.copy()
        vals[200:230] += shift
        df = pd.DataFrame(vals, columns=[f"s{i}" for i in range(f)])
        df.insert(0, "Timestamp", np.arange(n))
        df["Normal/Attack"] = "Normal"
        if shift:
            df["label"] = (np.arange(n) >= 200) & (np.arange(n) < 230)
        df.to_csv(root / "SWAT" / name)


def _write_casas(root):
    """A CASAS family: normal_sequences.pt (256 rows of 150) and, per
    resident, 300 test rows with a shifted run and its ground truth."""
    base = root / "DATASETS" / "CASAS"
    rng = np.random.default_rng(3)

    def save(a, path):
        os.makedirs(path.parent, exist_ok=True)
        torch.save(torch.tensor(np.asarray(a, np.float32)), path)

    save(rng.standard_normal((64, 4, 150)), base / "normal_sequences.pt")
    for i, sig in enumerate(RESIDENTS):
        test = rng.standard_normal((300, 150))
        a = 120 + 40 * i
        test[a:a + 30] += 3.0
        gt = np.zeros(300)
        gt[a:a + 30] = 1
        save(test, base / "POINTS" / sig / f"{sig}_sequences_id1.pt")
        save(gt, base / "POINTS" / sig / f"{sig}_groundtruth_id1.pt")


def _config(tmp_path, name, **kw):
    cfg = dict(epochs=1, lr=0.0005, batch_size=32, rec_error="dtw",
               combination="mult", data_root=str(tmp_path / "data"),
               devices=1, save_result=True, filename="results.csv",
               save_plots=False, output_root=str(tmp_path / name))
    cfg.update(kw)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


SWAT = dict(dataset="SWAT", signal="multivariate", signal_shape=12)
CASAS = dict(dataset="CASAS", signal="kitchen", id=1, signal_shape=150)


def _chip_smoke():
    """chip_smoke.py as a module, for its interval-score limit."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _score_atol(got, want):
    """What the two runs' measured relative score difference can make of
    an interval score near 0 (chip_smoke.py's ``interval_score_atol`` over
    the multivariate threshold windows), for the interval scores' check."""
    got, want = np.asarray(got), np.asarray(want)
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6)))
    return _chip_smoke().interval_score_atol(want, rel, multivariate=True)


def _same_intervals(got, want, atol=0.0):
    """Equal starts and ends; scores within 1e-3 relative, or within what
    the measured score difference can make of them (``atol``)."""
    got = np.asarray(got).reshape(-1, 3)
    want = np.asarray(want).reshape(-1, 3)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=atol,
                               **INTERVAL_SCORE_TOL)


def _same_detection(got, want):
    _same_intervals(got["intervals"], want["intervals"],
                    _score_atol(got["scores"], want["scores"]))
    assert tuple(got["confusion"]) == tuple(want["confusion"])
    if want["metrics"] is None:
        assert got["metrics"] is None
    else:
        assert got["metrics"]["f1"] == want["metrics"]["f1"]


def _carry(jax_cfg, port_cfg, signal=None):
    """JAX's state_final in the run directory of ``signal`` (the config's
    by default) -> the port's state_final.pt in the port's."""
    jp, tp = jcfg.load_config(jax_cfg), tcfg.load_config(port_cfg)
    if signal is not None:
        jp.signal = tp.signal = signal
    state = train_state_from_jax(jck.restore_state(jcfg.run_dir(jp),
                                                   "final"), device="cpu")
    tck.save_state(tcfg.run_dir(tp), state, "final")


@pytest.mark.parametrize("corpus,hyperbolic", [("swat", True),
                                               ("casas", False)])
def test_mv_detect_on_a_carried_jax_checkpoint_matches_the_jax_cli(
        tmp_path, capsys, corpus, hyperbolic):
    """JAX ``train`` (1 epoch) on a SWaT-format corpus (hyperbolic) and a
    CASAS-format one (Euclidean, 150 features); the port's ``detect
    --device cpu`` on the carried checkpoint gives JAX ``detect``'s
    intervals, confusion and F1 and its results CSV, and the port's
    ``--combinations all`` grid gives each cell's confusion as JAX's grid
    does."""
    root = tmp_path / "data"
    (_write_swat if corpus == "swat" else _write_casas)(root)
    kw = dict(SWAT if corpus == "swat" else CASAS, hyperbolic=hyperbolic)
    jax_cfg, port_cfg = (_config(tmp_path, n, **kw) for n in ("jax", "port"))
    jcli.main(["train", "--config", jax_cfg])
    want = jcli.cmd_detect(jcfg.load_config(jax_cfg), jax_cfg)
    _carry(jax_cfg, port_cfg)
    got = tcli.main(["detect", "--config", port_cfg, "--device", "cpu"])
    _same_detection(got, want)
    assert len(got["scores"]) == (400 if corpus == "swat" else 300)
    pd.testing.assert_frame_equal(
        pd.read_csv(tmp_path / "port" / "results" / "results.csv"),
        pd.read_csv(tmp_path / "jax" / "results" / "results.csv"))

    want_grid = jcli.cmd_detect(jcfg.load_config(jax_cfg), jax_cfg,
                                combinations=jcli.expand_combinations(
                                    jcfg.load_config(jax_cfg), ["all"]))
    got_grid = tcli.main(["detect", "--config", port_cfg, "--device", "cpu",
                          "--combinations", "all"])
    assert list(got_grid) == list(want_grid) and len(got_grid) == 8
    for cell, res in got_grid.items():
        _same_detection(res, want_grid[cell])
    out = capsys.readouterr().out
    assert "grid detection wall-clock" in out


def test_port_mv_train_writes_the_run_directory_and_detect_reenters(
        tmp_path, capsys):
    """The port's own ``train`` (its weights, 1 epoch) on the SWaT-format
    corpus: the run directory, a multivariate model at signal_shape 12,
    detection per timestep; ``detect`` re-enters it and gives the same
    scores; the default plot setting prints that the plot is skipped."""
    _write_swat(tmp_path / "data")
    cfg = _config(tmp_path, "port", hyperbolic=True, save_plots=None,
                  **SWAT)
    state, path, result = tcli.main(["train", "--config", cfg, "--device",
                                     "cpu"])
    assert state.model["decoder"].hyperbolic_linear.w.shape == (12, 12)
    for name in ("config.yaml", "train_log.jsonl", "state_final.pt",
                 "anomalies.csv", "inference.npz"):
        assert os.path.exists(os.path.join(path, name)), name
    assert path.endswith(os.path.join("models_hyper_SWAT_1_0.0005",
                                      "SWAT"))
    again = tcli.main(["detect", "--config", cfg, "--device", "cpu"])
    np.testing.assert_array_equal(again["scores"], result["scores"])
    out = capsys.readouterr().out
    assert "training wall-clock" in out and "detection wall-clock" in out
    assert out.count("plots are not ported (ROADMAP A12)") == 2


def test_mv_sweep_detect_only_on_carried_jax_checkpoints_matches_jax(
        tmp_path):
    """JAX ``sweep`` of three CASAS residents (1 epoch, Euclidean); the
    port's ``sweep --detect-only --device cpu`` on the carried checkpoints
    scores the family in one fleet call, per timestep, and gives each
    resident JAX's intervals (anomalies.csv), confusion and F1."""
    _write_casas(tmp_path / "data")
    kw = dict(CASAS, hyperbolic=False, signals=list(RESIDENTS))
    jax_cfg, port_cfg = (_config(tmp_path, n, **kw) for n in ("jax", "port"))
    want = jcli.cmd_sweep(jcfg.load_config(jax_cfg), jax_cfg)
    for sig in RESIDENTS:
        _carry(jax_cfg, port_cfg, sig)
    got = tcli.main(["sweep", "--config", port_cfg, "--device", "cpu",
                     "--detect-only"])
    assert [(s, f) for s, _, f in got] == [(s, f) for s, _, f in want]
    # the two fleets' scores, for the interval scores' bound
    jparams, X_list, dirs = [], [], []
    for sig in RESIDENTS:
        jp, tp = jcfg.load_config(jax_cfg), tcfg.load_config(port_cfg)
        jp.signal = tp.signal = sig
        jparams.append(jck.restore_state(jcfg.run_dir(jp), "final").params)
        X_list.append(treg.dataset_selection(tp)[1].X)
        dirs.append((jcfg.run_dir(jp), tcfg.run_dir(tp)))
    jstack = jax.tree_util.tree_map(lambda *x: np.stack(x), *jparams)
    jscores = jsc.detect_scores_fleet(jstack, X_list, False, "mult",
                                      multivariate=True)
    tscores = tsc.detect_scores_fleet(
        bridge.from_jax_stacked_params(jstack, device="cpu"), X_list, False,
        "mult", device="cpu", multivariate=True)
    for (jdir, tdir), js, ts in zip(dirs, jscores, tscores):
        janom = pd.read_csv(os.path.join(jdir, "anomalies.csv"))
        tanom = pd.read_csv(os.path.join(tdir, "anomalies.csv"))
        _same_intervals(tanom[["start", "end", "score"]].to_numpy(),
                        janom[["start", "end", "score"]].to_numpy(),
                        _score_atol(ts, np.asarray(js)))
    pd.testing.assert_frame_equal(
        pd.read_csv(tmp_path / "port" / "results" / "results.csv"),
        pd.read_csv(tmp_path / "jax" / "results" / "results.csv"))


def test_port_mv_sweep_trains_and_detects_the_family(tmp_path, capsys):
    """The port's own ``sweep`` of the CASAS family (hyperbolic, 150
    features, "full": the critic step's plain version on the CPU): one
    fleet, each resident's run directory and checkpoint; ``sweep
    --detect-only`` re-scores it to the same F1, and each resident's
    ``detect`` from its checkpoint to the same intervals."""
    _write_casas(tmp_path / "data")
    cfg = _config(tmp_path, "port", hyperbolic=True, fused_critics="full",
                  signals=list(RESIDENTS), **CASAS)
    first = tcli.main(["sweep", "--config", cfg, "--device", "cpu"])
    assert [s for s, _, _ in first] == list(RESIDENTS)
    again = tcli.main(["sweep", "--config", cfg, "--device", "cpu",
                       "--detect-only"])
    assert again == first
    p = tcfg.load_config(cfg)
    for sig in RESIDENTS:
        p.signal = sig
        assert os.path.exists(os.path.join(tcfg.run_dir(p),
                                           "state_final.pt"))
    one = tcli.main(["detect", "--config", cfg, "--device", "cpu"])
    kitchen = pd.read_csv(os.path.join(
        tcfg.run_dir(tcfg.load_config(cfg)), "anomalies.csv"))
    _same_intervals(one["intervals"],
                    kitchen[["start", "end", "score"]].to_numpy())
    assert "fleet detection wall-clock" in capsys.readouterr().out
