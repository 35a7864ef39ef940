"""The port's ``sweep`` command on the CPU: a signal family, a seed band and
their cross product trained as one fleet and detected in one call, each run
in JAX's run-directory layout; ``--detect-only`` and ``detect`` re-entering
a sweep's run directories. (The options that stay unported raise in
tests/test_torch_cli.py.)

On the CPU a fleet signal's training is bitwise its single-model run
(tests/test_torch_fleet.py), so a sweep's checkpoints are held bitwise to
the port's own ``train`` of each signal."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from hypad_tpu_torch import cli as tcli
from hypad_tpu_torch.utils import checkpoint as tck
from hypad_tpu_torch.utils import config as tcfg

T0 = 1_400_000_000
LENGTHS = {"sig_a": 400, "sig_b": 330}   # 300 and 230 windows of 100


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch ops on one thread: the suite runs in several
    worker processes, whose default thread pools would oversubscribe the
    cores and slow these small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_signals(root):
    """NAB-style CSVs of different lengths, each a sine with one level
    shift of +5 over 10 samples, and their anomalies.csv."""
    os.makedirs(root, exist_ok=True)
    rows = []
    for k, (name, n) in enumerate(LENGTHS.items()):
        rng = np.random.default_rng(k)
        t = np.arange(n)
        values = np.sin(2 * np.pi * t / 25) + 0.05 * rng.standard_normal(n)
        a = int(0.6 * n)
        values[a:a + 10] += 5
        stamps = T0 + 21600 * t
        with open(os.path.join(root, f"{name}.csv"), "w") as f:
            f.write("timestamp,value\n")
            for s, v in zip(stamps, np.round(values, 6)):
                f.write(f"{s},{float(v)!r}\n")
        events = [[int(stamps[a]), int(stamps[a + 9])]]
        rows.append(f'{name},"{json.dumps(events)}"')
    with open(os.path.join(root, "anomalies.csv"), "w") as f:
        f.write("signal,events\n" + "\n".join(rows) + "\n")


def _config(tmp_path, name, **kw):
    cfg = dict(dataset="NAB", signal="sig_a", signals=list(LENGTHS),
               epochs=2, hyperbolic=True, signal_shape=100, lr=0.0005,
               batch_size=32, rec_error="point", combination="mult",
               interval=21600, unique_dataset=True,
               data_root=str(tmp_path / "data"), devices=1,
               save_result=True, filename="results.csv",
               fused_critics="full", output_root=str(tmp_path / name))
    cfg.update(kw)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run_dir(cfg, **override):
    params = tcfg.load_config(cfg)
    for k, v in override.items():
        setattr(params, k, v)
    return tcfg.run_dir(params)


def _intervals(path):
    """(start, end, score) rows of a run's anomalies.csv."""
    with open(os.path.join(path, "anomalies.csv")) as f:
        return np.array([[float(v) for v in line.split(",")[1:]]
                         for line in f.read().splitlines()[1:]])


def _same_intervals(got, want):
    """Equal bounds; each interval's score, (max - threshold) / (mean +
    std) of the scores, at the detect tests' rtol 1e-3
    (tests/test_torch_cli.py): the fleet's masked reductions sum in
    another order than the single-signal call's."""
    assert got.shape == want.shape
    if got.size:
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-3)


def _same_state(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert (a.opt_gen.step, a.epoch) == (b.opt_gen.step, b.epoch)


def test_sweep_writes_each_runs_directory_and_detect_re_enters_it(
        tmp_path, capsys):
    """A 2-signal ragged family, 2 epochs: in each signal's run directory
    the effective config.yaml, state_1.pt (epoch n - 1), state_final.pt
    (bitwise the port's own ``train`` of that signal) and anomalies.csv;
    sweep_log.jsonl with (S,) metrics in the first; one results CSV row a
    signal; JAX's wall-clock lines. ``detect --config <run>/config.yaml``
    gives each signal the sweep's intervals, confusion and F1."""
    _write_signals(tmp_path / "data")
    cfg = _config(tmp_path, "fleet")
    results = tcli.main(["sweep", "--config", cfg, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sweep training wall-clock:" in out
    assert "fleet detection wall-clock:" in out
    assert [(s, sd) for s, sd, _ in results] == [("sig_a", 0), ("sig_b", 0)]
    first = _run_dir(cfg, signal="sig_a")
    log = [json.loads(line) for line in open(os.path.join(
        first, "sweep_log.jsonl"))]
    assert [row["epoch"] for row in log] == [1, 2]
    assert all(len(row["rec_loss"]) == 2 for row in log)
    for signal, _, f1 in results:
        path = _run_dir(cfg, signal=signal)
        for name in ("config.yaml", "state_1.pt", "state_final.pt",
                     "anomalies.csv"):
            assert os.path.exists(os.path.join(path, name)), (signal, name)
        run_cfg = os.path.join(path, "config.yaml")
        assert tcfg.load_config(run_cfg).signal == signal
        single = tcli.main(["train", "--config", _config(
            tmp_path, f"single_{signal}", signal=signal), "--device",
            "cpu"])[0]
        _same_state(tck.restore_state(path, "final", "cpu"), single)
        swept = _intervals(path)
        re_entered = tcli.main(["detect", "--config", run_cfg, "--device",
                                "cpu"])
        _same_intervals(_intervals(path), swept)
        m = re_entered["metrics"]
        assert (m["f1"] if m else None) == f1
    with open(tmp_path / "fleet" / "results" / "results.csv") as f:
        rows = f.read().splitlines()
    assert rows[0] == "signal,tn,fp,fn,tp"
    assert [row.split(",")[0] for row in rows[1:]] == ["sig_a", "sig_b"]


def test_sweep_seed_band_cross_product_and_detect_only(tmp_path, capsys):
    """``--signals sig_a,sig_b --seeds 0,1``: four runs under seed_0/ and
    seed_1/, each seed's effective config.yaml; the band's runs are
    bitwise ``train`` at that seed. ``--detect-only`` re-scores the family
    from the checkpoints with the same F1s; without checkpoints it stops
    with JAX's message."""
    _write_signals(tmp_path / "data")
    cfg = _config(tmp_path, "band", epochs=1)
    argv = ["sweep", "--config", cfg, "--device", "cpu", "--signals",
            "sig_a,sig_b", "--seeds", "0,1"]
    with pytest.raises(SystemExit, match="no 'state_final' checkpoint in "
                                         "4/4 run dir"):
        tcli.main(argv + ["--detect-only"])
    trained = tcli.main(argv)
    assert [(s, sd) for s, sd, _ in trained] == [
        ("sig_a", 0), ("sig_a", 1), ("sig_b", 0), ("sig_b", 1)]
    root = str(tmp_path / "band")
    for signal, seed, _ in trained:
        path = _run_dir(cfg, signal=signal,
                        output_root=os.path.join(root, f"seed_{seed}"))
        run_cfg = tcfg.load_config(os.path.join(path, "config.yaml"))
        assert (run_cfg.seed, run_cfg.signal) == (seed, signal)
        assert run_cfg.output_root == os.path.join(root, f"seed_{seed}")
    path = _run_dir(cfg, signal="sig_b",
                    output_root=os.path.join(root, "seed_1"))
    single = tcli.main(["train", "--config", _config(
        tmp_path, "single", signal="sig_b", seed=1, epochs=1), "--device",
        "cpu"])[0]
    _same_state(tck.restore_state(path, "final", "cpu"), single)
    capsys.readouterr()
    again = tcli.main(argv + ["--detect-only"])
    assert "sweep training wall-clock" not in capsys.readouterr().out
    assert again == trained

