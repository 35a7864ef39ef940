"""Port parity: the ``train`` / ``detect`` command line of hypad_tpu_torch,
its artifacts and grid detection, against the JAX package's CLI on the same
weights, on a tiny NAB-style CSV written to a tmpdir, on the CPU.

The port's ``train`` draws its own weights from a torch generator, so the
CLIs are held together through a JAX checkpoint: JAX ``train`` writes it,
``hypad_tpu.utils.checkpoint.restore_state`` reads it,
``train_state_from_jax`` carries it over and the port's ``save_state``
writes it where the port's ``detect`` finds it."""

import json
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from hypad_tpu import cli as jcli
from hypad_tpu.detect import intervals as jiv
from hypad_tpu.detect import scorer as jsc
from hypad_tpu.models.tadgan import init_tadgan as jax_init_tadgan
from hypad_tpu.utils import checkpoint as jck
from hypad_tpu.utils import config as jcfg
from hypad_tpu_torch import cli as tcli
from hypad_tpu_torch.bridge import from_jax_params
from hypad_tpu_torch.data import pipeline as tpipe
from hypad_tpu_torch.detect import intervals as tiv
from hypad_tpu_torch.detect import scorer as tsc
from hypad_tpu_torch.detect.detector import detect_univariate
from hypad_tpu_torch.parallel.mesh import make_mesh
from hypad_tpu_torch.train.state_bridge import train_state_from_jax
from hypad_tpu_torch.utils import artifacts
from hypad_tpu_torch.utils import checkpoint as tck
from hypad_tpu_torch.utils import config as tcfg

# tests/test_torch_detect.py's score tolerance: the two frameworks' scores
# from the same weights and windows
SCORE_TOL = dict(rtol=1e-4, atol=1e-6)
# an interval's score, (max - threshold) / (mean + std) of the scores: the
# detect tests' tolerance (tests/test_torch_detect.py, test_torch_eucl.py)
INTERVAL_SCORE_TOL = dict(rtol=1e-3)
T0 = 1_400_000_000
N_SAMPLES = 400      # 300 windows of 100


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch ops on one thread: the suite runs in several
    worker processes, whose default thread pools would oversubscribe the
    cores and slow these small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_signal(root):
    """A sine with two level shifts of +5 over 10 samples, 21,600 s apart,
    and its anomalies.csv; one epoch from JAX's weights finds intervals in
    both geometries."""
    rng = np.random.default_rng(1)
    t = np.arange(N_SAMPLES)
    values = np.sin(2 * np.pi * t / 25) + 0.05 * rng.standard_normal(
        N_SAMPLES)
    flags = np.zeros(N_SAMPLES, int)
    for a in (int(0.45 * N_SAMPLES), int(0.75 * N_SAMPLES)):
        values[a:a + 10] += 5
        flags[a:a + 10] = 1
    stamps = T0 + 21600 * t
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "sig.csv"), "w") as f:
        f.write("timestamp,value\n")
        for s, v in zip(stamps, np.round(values, 6)):
            f.write(f"{s},{float(v)!r}\n")
    change = np.diff(np.r_[0, flags, 0])
    events = [[int(stamps[a]), int(stamps[b])] for a, b in
              zip(np.flatnonzero(change == 1),
                  np.flatnonzero(change == -1) - 1)]
    with open(os.path.join(root, "anomalies.csv"), "w") as f:
        f.write(f'signal,events\nsig,"{json.dumps(events)}"\n')


def _config(tmp_path, name, **kw):
    cfg = dict(dataset="NAB", signal="sig", epochs=1, hyperbolic=True,
               signal_shape=100, lr=0.0005, batch_size=32, rec_error="point",
               combination="mult", interval=21600, unique_dataset=True,
               data_root=str(tmp_path / "data"), devices=1,
               save_result=True, filename="results.csv",
               output_root=str(tmp_path / name))
    cfg.update(kw)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _same_intervals(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if got.size:
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got[:, 2], want[:, 2],
                                   **INTERVAL_SCORE_TOL)


def _same_detection(got, want):
    _same_intervals(got["intervals"], want["intervals"])
    assert tuple(got["confusion"]) == tuple(want["confusion"])
    if want["metrics"] is None:
        assert got["metrics"] is None
    else:
        assert got["metrics"]["f1"] == want["metrics"]["f1"]


def _carry_jax_checkpoint(jax_cfg, port_cfg):
    """JAX's state_final -> the port's state_final.pt in the port's run
    directory; returns the port's TrainState."""
    state = train_state_from_jax(
        jck.restore_state(jcfg.run_dir(jcfg.load_config(jax_cfg)), "final"),
        device="cpu")
    tck.save_state(tcfg.run_dir(tcfg.load_config(port_cfg)), state, "final")
    return state


@pytest.mark.parametrize("hyperbolic", [True, False],
                         ids=["hyperbolic", "euclidean"])
def test_detect_on_a_carried_jax_checkpoint_matches_the_jax_cli(
        tmp_path, capsys, hyperbolic):
    """JAX ``train`` (1 epoch), then the port's ``detect`` on its
    checkpoint gives JAX ``detect``'s intervals, confusion, F1,
    anomalies.csv and results CSV; under ``load: true`` the port reads
    JAX's inference.npz and gives JAX's cached scores (SCORE_TOL)."""
    _write_signal(tmp_path / "data")
    jax_cfg = _config(tmp_path, "jax", hyperbolic=hyperbolic)
    port_cfg = _config(tmp_path, "port", hyperbolic=hyperbolic)
    jcli.main(["train", "--config", jax_cfg])
    jparams = jcfg.load_config(jax_cfg)
    want = jcli.cmd_detect(jparams, jax_cfg)
    assert len(want["intervals"]), "the JAX run found no interval"
    _carry_jax_checkpoint(jax_cfg, port_cfg)
    got = tcli.main(["detect", "--config", port_cfg, "--device", "cpu"])
    _same_detection(got, want)

    jdir = jcfg.run_dir(jparams)
    tdir = tcfg.run_dir(tcfg.load_config(port_cfg))
    assert tdir.replace(str(tmp_path / "port"), "") == jdir.replace(
        str(tmp_path / "jax"), "")
    janom = pd.read_csv(os.path.join(jdir, "anomalies.csv"))
    tanom = pd.read_csv(os.path.join(tdir, "anomalies.csv"))
    assert list(tanom.columns) == list(janom.columns)
    _same_intervals(tanom[["start", "end", "score"]].to_numpy(),
                    janom[["start", "end", "score"]].to_numpy())
    pd.testing.assert_frame_equal(
        pd.read_csv(tmp_path / "port" / "results" / "results.csv"),
        pd.read_csv(tmp_path / "jax" / "results" / "results.csv"))
    with np.load(os.path.join(jdir, "inference.npz")) as j, \
            np.load(os.path.join(tdir, "inference.npz")) as t:
        assert sorted(t.files) == sorted(j.files)
        np.testing.assert_array_equal(t["true_index"], j["true_index"])

    # load: true: JAX caches its scores from its own inference.npz; the
    # port, given only that file, scores it the same
    jload = _config(tmp_path, "jax", hyperbolic=hyperbolic, load=True)
    jcli.cmd_detect(jcfg.load_config(jload), jload)
    key = "scores_hyper_mult" if hyperbolic else "scores_eucl_point_mult"
    jscores = np.load(os.path.join(jdir, f"{key}.npy"))
    tload = _config(tmp_path, "port_load", hyperbolic=hyperbolic, load=True)
    ldir = tcfg.run_dir(tcfg.load_config(tload))
    os.makedirs(ldir)
    shutil.copy(os.path.join(jdir, "inference.npz"), ldir)
    _carry_jax_checkpoint(jax_cfg, tload)
    cached = tcli.main(["detect", "--config", tload, "--device", "cpu"])
    np.testing.assert_allclose(cached["scores"], jscores, **SCORE_TOL)
    np.testing.assert_allclose(np.load(os.path.join(ldir, f"{key}.npy")),
                               jscores, **SCORE_TOL)
    _, true_index = artifacts.load_inference(ldir)
    np.testing.assert_array_equal(true_index,
                                  np.load(os.path.join(jdir,
                                                       "inference.npz"))
                                  ["true_index"])
    assert "detection wall-clock" in capsys.readouterr().out


def _state_tensors(state):
    out = dict(state.model.state_dict())
    for name in ("opt_cx", "opt_cz", "opt_gen"):
        opt = getattr(state, name)
        for m in ("mu", "nu"):
            moments = getattr(opt, m)
            items = moments.items() if isinstance(moments, dict) else [
                ("", moments)]
            out.update({f"{name}.{m}.{k}": v for k, v in items})
    return out


def test_port_train_writes_the_run_directory_and_resumes_bitwise(
        tmp_path, capsys, monkeypatch):
    """``train`` for 2 epochs writes JAX's run-directory layout and detects
    on the very windows tensor it trained on; ``detect`` re-enters from
    state_final.pt and gives train's detection; ``resume: true`` from
    state_1.pt ends bitwise on the straight run's state."""
    from hypad_tpu_torch.train import trainer

    _write_signal(tmp_path / "data")
    cfg = _config(tmp_path, "port", epochs=2)
    seen = {}
    train_tadgan, detect_scores = trainer.train_tadgan, tsc.detect_scores

    def spy_train(model, X, **kw):
        seen["train"] = X
        return train_tadgan(model, X, **kw)

    def spy_detect(model, X, *args, **kw):
        seen["detect"] = X
        return detect_scores(model, X, *args, **kw)

    monkeypatch.setattr(trainer, "train_tadgan", spy_train)
    monkeypatch.setattr(tsc, "detect_scores", spy_detect)
    state, path, trained = tcli.main(["train", "--config", cfg, "--device",
                                      "cpu", "--profile"])
    assert torch.is_tensor(seen["train"]) and seen["detect"] is seen["train"]
    out = capsys.readouterr().out
    assert "training wall-clock" in out and "detection wall-clock" in out
    assert "stage" in out and "train " in out
    assert path == tcfg.run_dir(tcfg.load_config(cfg))
    assert sorted(os.listdir(path)) == [
        "anomalies.csv", "config.yaml", "inference.npz", "state_1.pt",
        "state_final.pt", "train_log.jsonl"]
    rows = [json.loads(line) for line in open(os.path.join(path,
                                                           "train_log.jsonl"))]
    assert [r["epoch"] for r in rows] == [1, 2]
    assert set(rows[0]) == {"epoch", "critic_x_loss", "critic_z_loss",
                            "decoder_loss", "rec_loss"}
    results = pd.read_csv(tmp_path / "port" / "results" / "results.csv")
    assert list(results.columns) == ["signal", "tn", "fp", "fn", "tp"]
    assert list(results["signal"]) == ["sig"]

    again = tcli.main(["detect", "--config", cfg, "--device", "cpu"])
    np.testing.assert_array_equal(again["scores"], trained["scores"])
    np.testing.assert_array_equal(again["intervals"], trained["intervals"])
    assert tuple(again["confusion"]) == tuple(trained["confusion"])

    straight = {k: v.clone() for k, v in _state_tensors(state).items()}
    resumed_cfg = _config(tmp_path, "port", epochs=2, resume=True)
    resumed, _, _ = tcli.main(["train", "--config", resumed_cfg, "--device",
                               "cpu"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert resumed.epoch == 2
    got = _state_tensors(resumed)
    assert list(got) == list(straight)
    for key, value in straight.items():
        assert torch.equal(got[key], value), key
    assert resumed.opt_gen.step == state.opt_gen.step


def _jax_weights(hyperbolic, seed):
    return jax.tree_util.tree_map(
        np.asarray, jax_init_tadgan(jax.random.PRNGKey(seed), 100,
                                    hyperbolic=hyperbolic))


def _windows():
    X, index, known = tpipe.synthetic_detect_input(300, 100, anomaly_len=12,
                                                   seed=3)
    return X, index, known


@pytest.mark.parametrize("hyperbolic", [True, False],
                         ids=["hyperbolic", "euclidean"])
def test_detect_scores_grid_matches_jax_and_the_single_cell(hyperbolic):
    X, _, _ = _windows()
    weights = _jax_weights(hyperbolic, 11)
    model = from_jax_params(weights, device="cpu")
    combos = list(tsc.COMBINATIONS if hyperbolic else tsc.EUCL_COMBOS)
    recs = ["point"] if hyperbolic else ["point", "area", "dtw"]
    got = tsc.detect_scores_grid(model, X, hyperbolic, combos, recs,
                                 device="cpu")
    want = jsc.detect_scores_grid(weights, X, hyperbolic, combos,
                                  rec_errors=recs)
    assert list(got) == list(want)
    for cell, scores in want.items():
        # tests/test_torch_eucl.py's hold of "sum" near 0: as sum + 1
        shift = 1.0 if cell[1] == "sum" else 0.0
        np.testing.assert_allclose(got[cell] + shift, scores + shift,
                                   **SCORE_TOL)
        np.testing.assert_array_equal(got[cell] == 0, scores == 0)
        re_, cb = cell
        single, _ = tsc.detect_scores(model, X, hyperbolic, cb,
                                      rec_error=re_ or "point",
                                      fetch_inference=False, device="cpu")
        np.testing.assert_array_equal(got[cell], single)


def test_grid_chunked_fallback_matches_the_one_call(monkeypatch):
    X, _, _ = _windows()
    model = from_jax_params(_jax_weights(False, 12), device="cpu")
    full = tsc.detect_scores_grid(model, X, False, ["mult", "rec"],
                                  ["point", "dtw"], device="cpu")
    monkeypatch.setattr(tsc, "ONE_CALL_MAX_WINDOWS", 100)
    chunked = tsc.detect_scores_grid(model, X, False, ["mult", "rec"],
                                     ["point", "dtw"], device="cpu")
    assert sorted(chunked) == sorted(full)
    for cell in full:
        np.testing.assert_allclose(chunked[cell], full[cell], **SCORE_TOL)


def test_grid_validates_cells():
    X, _, _ = _windows()
    model = from_jax_params(_jax_weights(False, 13), device="cpu")
    with pytest.raises(ValueError, match="unknown combination"):
        tsc.detect_scores_grid(model, X, False, ["uncertainty"],
                               device="cpu")
    with pytest.raises(ValueError, match="unknown rec_error"):
        tsc.detect_scores_grid(model, X, False, ["mult"], ["l2"],
                               device="cpu")
    with pytest.raises(ValueError, match="MobiusLinear"):
        tsc.detect_scores_grid(model, X, True, ["mult"], device="cpu")
    hyper = from_jax_params(_jax_weights(True, 13), device="cpu")
    with pytest.warns(UserWarning, match="collapses"):
        out = tsc.detect_scores_grid(hyper, X, True, ["mult", "mult"],
                                     ["point", "dtw"], device="cpu")
    assert list(out) == [(None, "mult")]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_anomalies_batch_is_bitwise_jax_and_the_serial_chain(seed):
    rng = np.random.default_rng(seed)
    C, T = 7, 1317
    E = np.abs(rng.standard_normal((C, T)))
    E[1, 400:430] += 9.0
    E[2, :] = 1.0                      # constant: no run anywhere
    E[3, 50:60] += 6.0
    E[3, 900:960] += 4.0
    E[4, 1290:] += 8.0                 # a run in the truncated tail window
    E[5] = np.round(E[5], 1)           # ties
    index = 1e9 + 60.0 * np.arange(T + 99)
    kw = dict(window_size_portion=0.33, window_step_size_portion=0.1,
              fixed_threshold=True)
    got = tiv.find_anomalies_batch(E, index, **kw)
    want = jiv.find_anomalies_batch(E, index, **kw)
    assert len(got) == C
    for c in range(C):
        np.testing.assert_array_equal(got[c], want[c])
        np.testing.assert_array_equal(got[c],
                                      tiv.find_anomalies(E[c], index, **kw))
    # JAX's default, fixed_threshold None: the dynamic thresholds
    for g, w in zip(tiv.find_anomalies_batch(E, index),
                    jiv.find_anomalies_batch(E, index)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rel", [1e-6, 1e-4, 1e-3])
def test_chip_smoke_interval_score_limit_bounds_the_gap(rel):
    """chip_smoke.py's card-against-CPU limit on interval scores holds the
    gap that scores perturbed by at most ``rel`` relative make, wherever
    every threshold window's runs stay the same. (A run that one window
    gains or prunes changes a merged interval's average by a step that no
    first-order limit holds, even where the intervals stay the same.)"""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    rng = np.random.default_rng(7)
    index = np.arange(1400.0)
    kw = dict(window_size_portion=0.33, window_step_size_portion=0.1,
              fixed_threshold=True)
    size, step = tiv._window_geometry(1320, None, 0.33, None, 0.1)

    def window_runs(x):
        windows = [(start, x[start:start + size])
                   for start in range(0, 1320 - size + step, step)]
        return [tuple(r[:2]) for start, w in windows
                for r in tiv._window_sequences(
                    w, tiv.fixed_threshold(w), 50, 0.1, start)]

    compared = 0
    for _ in range(60):
        s = (np.abs(rng.standard_normal(1320)) * rng.uniform(0.1, 3)
             + rng.uniform(0, 2))
        start = rng.integers(0, 1200)
        s[start:start + rng.integers(5, 60)] += rng.uniform(1, 8)
        s2 = s * (1 + rel * rng.uniform(-1, 1, s.shape))
        a, b = (tiv.find_anomalies(x, index, **kw) for x in (s, s2))
        if a.size == 0 or window_runs(s) != window_runs(s2):
            continue
        np.testing.assert_array_equal(a[:, :2], b[:, :2])
        measured = float(np.max(np.abs(s2 - s) / np.abs(s)))
        limit = chip_smoke.interval_score_atol(s, measured)
        assert np.max(np.abs(a[:, 2] - b[:, 2])) <= limit
        compared += 1
    assert compared >= 30


@pytest.mark.parametrize("hyperbolic", [True, False],
                         ids=["hyperbolic", "euclidean"])
def test_grid_cli_matches_jax_grid_results_csv(tmp_path, hyperbolic):
    """``detect --rec-errors ... --combinations all`` on a carried JAX
    checkpoint writes JAX's grid_results.csv rows, and each cell equals a
    single-cell ``detect``."""
    _write_signal(tmp_path / "data")
    jax_cfg = _config(tmp_path, "jax", hyperbolic=hyperbolic,
                      save_result=False)
    port_cfg = _config(tmp_path, "port", hyperbolic=hyperbolic,
                       save_result=False)
    # the JAX weights of init_tadgan(seed 0), as JAX's train would start
    jparams = jcfg.load_config(jax_cfg)
    jdir = jcfg.run_dir(jparams)
    from hypad_tpu.train.trainer import init_train_state

    jck.save_state(jdir, init_train_state(
        jax_init_tadgan(jax.random.PRNGKey(5), 100, hyperbolic=hyperbolic),
        lr=5e-4, hyperbolic=hyperbolic), "final")
    _carry_jax_checkpoint(jax_cfg, port_cfg)
    recs = "point" if hyperbolic else "point,area,dtw"
    flags = ["--rec-errors", recs, "--combinations", "all"]
    want = jcli.cmd_detect(jparams, jax_cfg, rec_errors=recs.split(","),
                           combinations=jcli.expand_combinations(jparams,
                                                                 ["all"]))
    got = tcli.main(["detect", "--config", port_cfg, "--device", "cpu",
                     *flags])
    assert list(got) == list(want)
    tdir = tcfg.run_dir(tcfg.load_config(port_cfg))
    jtab = pd.read_csv(os.path.join(jdir, "grid_results.csv"))
    ttab = pd.read_csv(os.path.join(tdir, "grid_results.csv"))
    assert len(ttab) == (8 if hyperbolic else 12)
    assert list(ttab.columns) == list(jtab.columns)
    exact = ["rec_error", "combination", "tn", "fp", "fn", "tp"]
    pd.testing.assert_frame_equal(ttab[exact], jtab[exact])
    metric_cols = [c for c in ("precision", "recall", "f1", "gmean")
                   if c in jtab]
    pd.testing.assert_frame_equal(ttab[metric_cols], jtab[metric_cols])
    for (re_, cb), cell in got.items():
        _same_detection(cell, want[(re_, cb)])
        single_cfg = _config(tmp_path, "port", hyperbolic=hyperbolic,
                             save_result=False, combination=cb,
                             rec_error=re_ or "point")
        single = tcli.main(["detect", "--config", single_cfg, "--device",
                            "cpu"])
        np.testing.assert_array_equal(single["scores"], cell["scores"])
        assert tuple(single["confusion"]) == tuple(cell["confusion"])


def test_detect_univariate_is_the_cli_detection_on_arrays(tmp_path):
    X, index, known = _windows()
    model = from_jax_params(_jax_weights(True, 14), device="cpu")
    got = detect_univariate(model, X, index, known, "mult", device="cpu")
    scores, _ = tsc.detect_scores(model, X, True, "mult",
                                  fetch_inference=False, device="cpu")
    np.testing.assert_array_equal(got["scores"], scores)


def _write_swat(root):
    """A SWaT corpus (tests/test_torch_mv_cli.py's): 400 rows of 12
    features, a shift at rows 200-229 of the test split."""
    os.makedirs(root / "SWAT", exist_ok=True)
    rng = np.random.default_rng(0)
    base = rng.standard_normal((400, 12)).cumsum(axis=0) * 0.01
    for name, shift in (("SWaT_train_mine.csv", 0.0),
                        ("SWaT_test_mine.csv", 3.0)):
        vals = base.copy()
        vals[200:230] += shift
        df = pd.DataFrame(vals, columns=[f"s{i}" for i in range(12)])
        df.insert(0, "Timestamp", np.arange(400))
        df["Normal/Attack"] = "Normal"
        if shift:
            df["label"] = (np.arange(400) >= 200) & (np.arange(400) < 230)
        df.to_csv(root / "SWAT" / name)


def _cpu_mesh(monkeypatch):
    """``make_mesh`` of the CLI patched to ``devices`` CPU shards."""
    monkeypatch.setattr(
        tcli, "make_mesh", lambda devices, **kw: (
            make_mesh([torch.device("cpu")] * devices)
            if isinstance(devices, int) else None))


def _run_intervals(out_root):
    """{run directory: anomalies.csv rows} under ``out_root``."""
    return {os.path.relpath(d, out_root): pd.read_csv(
                os.path.join(d, "anomalies.csv")).to_numpy()
            for d, _, files in os.walk(out_root) if "anomalies.csv" in files}


@pytest.mark.parametrize("argv,override,item", [
    (["sweep", "--canonical"], {}, "A10"),
    (["sweep", "--canonical", "--rec-errors", "point,dtw"], {}, "A10"),
    (["sweep", "--canonical", "--combinations", "all"], {}, "A10"),
    (["sweep", "--canonical", "--combinations", "all"],
     {"dataset": "SWAT", "signal": "multivariate"}, "A10"),
    (["sweep"], {"devices": 2}, "A13"),
])
def test_unported_cli_options_raise_naming_their_roadmap_item(
        tmp_path, monkeypatch, argv, override, item):
    """What of ``sweep`` was unported until ROADMAP A10 and A13 landed now
    runs. ``--canonical`` (A10), alone and with the fleet grid's flags,
    univariate or multivariate, trains the family at JAX's canonical
    shapes and detects it: every run directory gets its final checkpoint
    and its results, on a patched 2-shard CPU mesh too (alone: the same
    intervals). ``devices: 2`` (A13) on a patched 2-shard CPU mesh gives
    every run directory the intervals of ``devices: 1``."""
    if override.get("dataset") == "SWAT":
        _write_swat(tmp_path / "data")
        extra = dict(signals=["multivariate"], signal_shape=12,
                     save_plots=False)
    else:
        _write_signal(tmp_path / "data")
        extra = dict(signals=["sig"])
    if item == "A13":
        _cpu_mesh(monkeypatch)
        one = _config(tmp_path, "one", **extra)
        tcli.main(["sweep", "--config", one, "--device", "cpu"])
    cfg = _config(tmp_path, "port", **{**override, **extra})
    results = tcli.main([*argv, "--config", cfg, "--device", "cpu"])
    assert len(results) == 1
    run = tcfg.run_dir(tcfg.load_config(cfg))
    assert os.path.exists(os.path.join(run, "state_final.pt"))
    if item == "A13":
        got = _run_intervals(tmp_path / "port")
        want = _run_intervals(tmp_path / "one")
        assert list(got) == list(want) and got
        for k in want:
            np.testing.assert_array_equal(got[k][:, :2], want[k][:, :2])
            np.testing.assert_allclose(got[k][:, 2], want[k][:, 2],
                                       **INTERVAL_SCORE_TOL)
    elif len(argv) > 2:
        assert os.path.exists(os.path.join(run, "grid_results.csv"))
    else:
        # and on a patched 2-shard CPU mesh, the same intervals
        assert os.path.exists(os.path.join(run, "anomalies.csv"))
        _cpu_mesh(monkeypatch)
        tcli.main([*argv, "--config", _config(
            tmp_path, "mesh", devices=2, **{**override, **extra}),
            "--device", "cpu"])
        got = _run_intervals(tmp_path / "mesh")
        want = _run_intervals(tmp_path / "port")
        assert list(got) == list(want) and got
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("override,item", [
    ({"devices": 2}, "A13"), ({"save_plots": True}, None),
])
def test_unported_config_keys_raise_naming_their_roadmap_item(
        tmp_path, monkeypatch, override, item):
    """``devices: 2`` (A13, ported) trains and detects on a patched 2-shard
    CPU mesh, each step's rows split over it: the same intervals and
    confusion as ``devices: 1``; ``save_plots: true``, ported, makes a
    univariate ``train`` draw ``anomalies.png`` into its run directory, as
    JAX's does."""
    _write_signal(tmp_path / "data")
    cfg = _config(tmp_path, "port", **override)
    if item is None:
        _, path, result = tcli.main(["train", "--config", cfg, "--device",
                                     "cpu"])
        assert os.path.getsize(os.path.join(path, "anomalies.png")) > 0
        assert result["scores"].ndim == 1
        return
    _cpu_mesh(monkeypatch)
    _, _, want = tcli.main(["train", "--config", _config(tmp_path, "one"),
                            "--device", "cpu"])
    _, _, got = tcli.main(["train", "--config", cfg, "--device", "cpu"])
    _same_detection(got, want)
    again = tcli.main(["detect", "--config", cfg, "--device", "cpu"])
    _same_detection(again, got)


def test_artifact_options_and_staging(tmp_path):
    """float16 halves the (N, W) arrays and keeps the critic in float32;
    minimal drops eucl_recons and gt_signal; the one call and the chunked
    fallback apply them alike; stage_inference leaves a staged field where
    it is."""
    X, _, _ = _windows()
    model = from_jax_params(_jax_weights(True, 15), device="cpu")
    full_scores, full = tsc.detect_scores(model, X, True, "mult",
                                          device="cpu")
    scores, half = tsc.detect_scores(model, X, True, "mult", device="cpu",
                                     artifact_dtype="float16",
                                     artifact_set="minimal")
    np.testing.assert_array_equal(scores, full_scores)
    assert half.eucl_recons is None and half.gt_signal is None
    assert half.recons_signal.dtype == np.float16
    assert half.critic_score.dtype == np.float32
    np.testing.assert_array_equal(half.recons_signal,
                                  full.recons_signal.astype(np.float16))
    want = jsc._apply_artifact_opts(
        jsc.InferenceOutput(*full), "float16", "minimal", True)
    for g, w in zip(half, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    staged = tsc.stage_inference(full, device="cpu")
    assert all(torch.is_tensor(t) for t in staged)
    assert tsc.stage_inference(staged, device="cpu").recons_signal is \
        staged.recons_signal
    np.testing.assert_array_equal(
        tsc.score_anomalies_hyperbolic(staged, "mult", device="cpu"),
        tsc.score_anomalies_hyperbolic(full, "mult", device="cpu"))
    artifacts.save_inference(str(tmp_path), half, np.arange(3.0))
    back, idx = artifacts.load_inference(str(tmp_path))
    assert back.eucl_recons is None
    np.testing.assert_array_equal(back.recons_signal, half.recons_signal)
    np.testing.assert_array_equal(idx, np.arange(3.0))
    assert not os.path.exists(tmp_path / "inference.npz.tmp")
