"""Port parity: the signal loaders, the dataset registry, the known-anomaly
files and the checkpoints of hypad_tpu_torch against the JAX package, on
tiny CSVs written to a tmpdir, on the CPU."""

import os
import shutil
import stat
from argparse import Namespace

import numpy as np
import pandas as pd
import pytest
import torch

from hypad_tpu.data import pipeline as jpipe
from hypad_tpu.data import registry as jreg
from hypad_tpu_torch.data import pipeline as tpipe
from hypad_tpu_torch.data import registry as treg
from hypad_tpu_torch.models.tadgan import init_tadgan
from hypad_tpu_torch.train import trainer as tr
from hypad_tpu_torch.utils import checkpoint as tck

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


def _signal(n, seed, nan_at=()):
    rng = np.random.default_rng(seed)
    values = np.round(np.sin(np.arange(n) / 7.0)
                      + 0.1 * rng.standard_normal(n), 6)
    fields = [repr(float(v)) for v in values]
    for i in nan_at:
        fields[i] = ""
    return fields


def _write(path, header, columns):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in zip(*columns):
            f.write(",".join(str(v) for v in row) + "\n")


def _params(**kw):
    base = dict(dataset="MSL", signal="S-1", interval=21600,
                unique_dataset=False)
    base.update(kw)
    return Namespace(**base)


def _assert_same_data(got, want):
    for name in ("X", "y", "X_index", "y_index", "index"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _known(df_or_array):
    if isinstance(df_or_array, pd.DataFrame):
        return df_or_array[["start", "end"]].to_numpy()
    return np.asarray(df_or_array)


def test_numeric_column_follows_pandas(tmp_path):
    path = tmp_path / "c.csv"
    path.write_text("a,b,c,d\n1,1.5,,7\n-2,2,NaN,8\n3,1e3,NA,9\n")
    cols = tpipe.read_csv_columns(path)
    df = pd.read_csv(path)
    for name in "abcd":
        got = tpipe.numeric_column(cols[name])
        want = df[name].to_numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)


def test_nasa_train_test_pair_matches_jax(tmp_path):
    root = tmp_path / "data"
    for split, n, seed, step in (("train", 180, 0, 21600),
                                 ("test", 300, 1, 10800)):
        stamps = T0 + step * np.arange(n)
        _write(str(root / f"S-1-{split}.csv"), ["timestamp", "value"],
               [stamps, _signal(n, seed)])
    params = _params(data_root=str(root))
    jtr, jte, jpath = jreg.dataset_selection(params)
    ttr, tte, tpath = treg.dataset_selection(params)
    assert tpath == jpath
    _assert_same_data(ttr, jtr)
    _assert_same_data(tte, jte)


def test_nab_unique_dataset_with_nans_and_anomalies_csv(tmp_path):
    root = tmp_path / "data"
    n = 900
    stamps = T0 + 3600 * np.arange(n)   # 6 samples an interval, averaged
    _write(str(root / "Twitter_volume_X.csv"), ["timestamp", "value"],
           [stamps, _signal(n, 2, nan_at=(5, 6, 7, 8, 9, 10, 100))])
    with open(root / "anomalies.csv", "w") as f:
        f.write('signal,events\nother,"[[1, 2]]"\n'
                f'Twitter_volume_X,"[[{stamps[300]}, {stamps[360]}], '
                f'[{stamps[650]}, {stamps[670]}]]"\n')
    params = _params(dataset="NAB", signal="Twitter_volume_X",
                     unique_dataset=True, data_root=str(root))
    jtr, jte, jpath = jreg.dataset_selection(params)
    ttr, tte, tpath = treg.dataset_selection(params)
    assert tpath == jpath and tte is ttr
    _assert_same_data(ttr, jtr)
    assert np.isfinite(ttr.X).all()
    got = tpipe.load_anomalies("Twitter_volume_X", str(root))
    want = _known(jpipe.load_anomalies("Twitter_volume_X", str(root)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    with pytest.raises(KeyError):
        tpipe.load_anomalies("absent", str(root))


def _yahoo_roots(tmp_path, dataset, signal, header, columns):
    """The same Yahoo CSV under two data roots, one for each package (each
    writes its *_known_anomalies.csv beside the source)."""
    roots = []
    for who in ("jax", "port"):
        root = tmp_path / who
        _write(str(root / "YAHOO" / f"{dataset}Benchmark" / f"{signal}.csv"),
               header, columns)
        roots.append(root)
    return roots


def _flags(n, runs):
    flags = np.zeros(n, dtype=int)
    for a, b in runs:
        flags[a:b] = 1
    return flags


@pytest.mark.parametrize("read_only", [False, True])
def test_yahoo_a1_matches_jax_and_writes_its_known_anomalies(tmp_path,
                                                             read_only):
    n = 260
    flags = _flags(n, [(40, 52), (200, 230), (255, 260)])
    jroot, troot = _yahoo_roots(
        tmp_path, "A1", "real_1", ["timestamp", "value", "is_anomaly"],
        [np.arange(1, n + 1), _signal(n, 3), flags])
    out = {}
    for who, root, reg in (("jax", jroot, jreg), ("port", troot, treg)):
        src_dir = root / "YAHOO" / "A1Benchmark"
        if read_only:
            os.chmod(src_dir, stat.S_IRUSR | stat.S_IXUSR)
        cache = tmp_path / f"cache_{who}"
        try:
            out[who] = reg.dataset_selection(
                _params(dataset="A1", signal="real_1", interval=21600,
                        data_root=str(root)), cache_dir=str(cache))
        finally:
            os.chmod(src_dir, stat.S_IRWXU)
        written = ((cache if read_only else src_dir)
                   / "real_1_known_anomalies.csv")
        assert written.is_file(), who
        assert not (src_dir / "real_1_known_anomalies.csv.tmp").exists()
        if read_only:
            assert not (src_dir / "real_1_known_anomalies.csv").exists()
        out[who + "_file"] = pd.read_csv(written)
    (jtr, jte, _), (ttr, tte, _) = out["jax"], out["port"]
    _assert_same_data(ttr, jtr)
    np.testing.assert_array_equal(ttr.known_anomalies,
                                  _known(jtr.known_anomalies))
    assert ttr.known_anomalies.shape == (3, 2)
    pd.testing.assert_frame_equal(out["port_file"], out["jax_file"])


def test_yahoo_a3_columns_match_jax(tmp_path):
    n = 220
    flags = _flags(n, [(100, 103)])
    jroot, troot = _yahoo_roots(
        tmp_path, "A3", "A3Benchmark-TS1",
        ["timestamps", "value", "anomaly", "changepoint", "trend"],
        [T0 + np.arange(n), _signal(n, 4), flags, np.zeros(n, int),
         np.arange(n)])
    params = dict(dataset="A3", signal="A3Benchmark-TS1")
    jtr, _, jpath = jreg.dataset_selection(_params(data_root=str(jroot),
                                                   **params))
    ttr, _, tpath = treg.dataset_selection(_params(data_root=str(troot),
                                                   **params))
    assert os.path.basename(tpath) == os.path.basename(jpath)
    _assert_same_data(ttr, jtr)
    np.testing.assert_array_equal(ttr.known_anomalies,
                                  _known(jtr.known_anomalies))
    pd.testing.assert_frame_equal(
        pd.read_csv(tpath[:-4] + "_known_anomalies.csv"),
        pd.read_csv(jpath[:-4] + "_known_anomalies.csv"))


def test_yahoo_without_anomalies_writes_an_empty_table(tmp_path):
    n = 150
    jroot, troot = _yahoo_roots(
        tmp_path, "A2", "synthetic_1", ["timestamp", "value", "is_anomaly"],
        [np.arange(n), _signal(n, 5), np.zeros(n, int)])
    params = dict(dataset="A2", signal="synthetic_1")
    jtr, _, jpath = jreg.dataset_selection(_params(data_root=str(jroot),
                                                   **params))
    ttr, _, tpath = treg.dataset_selection(_params(data_root=str(troot),
                                                   **params))
    assert ttr.known_anomalies.shape == (0, 2)
    assert len(pd.read_csv(tpath[:-4] + "_known_anomalies.csv")) == 0
    assert (list(pd.read_csv(tpath[:-4] + "_known_anomalies.csv").columns)
            == list(pd.read_csv(jpath[:-4] + "_known_anomalies.csv")
                    .columns))


def test_multivariate_dataset_raises_naming_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="A11"):
        treg.dataset_selection(_params(dataset="SWAT",
                                       signal="multivariate"))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trained_state(hyperbolic):
    """A TrainState two epochs in, so every optimizer moment is set."""
    X, _, _ = tpipe.synthetic_detect_input(40, 16, anomaly_len=5)
    model = init_tadgan(torch.Generator().manual_seed(0), 16,
                        hyperbolic=hyperbolic, device="cpu")
    return tr.train_tadgan(model, X, lr=5e-4, hyperbolic=hyperbolic,
                           batch_size=16, n_epochs=2, fused_critics=False,
                           device="cpu")


def _flat_state(state):
    out = {f"params/{k}": v for k, v in state.model.state_dict().items()}
    for name in ("opt_cx", "opt_cz", "opt_gen"):
        opt = getattr(state, name)
        out[f"{name}/step"] = opt.step
        for m in ("mu", "nu"):
            moments = getattr(opt, m)
            if isinstance(moments, dict):
                out.update({f"{name}/{m}/{k}": v for k, v in moments.items()})
            else:
                out[f"{name}/{m}"] = moments
    out["epoch"] = state.epoch
    return out


@pytest.mark.parametrize("hyperbolic", [True, False])
def test_checkpoint_round_trips_bitwise(tmp_path, hyperbolic):
    state = _trained_state(hyperbolic)
    path = tck.save_state(str(tmp_path), state, 2)
    assert os.path.basename(path) == "state_2.pt"
    back = tck.restore_state(str(tmp_path), 2, device="cpu")
    want, got = _flat_state(state), _flat_state(back)
    assert list(got) == list(want)
    for key, value in want.items():
        if torch.is_tensor(value):
            assert torch.equal(got[key], value), key
        else:
            assert got[key] == value, key
    assert back.epoch == 2 and type(back.opt_gen) is type(state.opt_gen)
    assert back.model["decoder"].hyperbolic == hyperbolic


def test_restore_state_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available, so the default device is usable")
    tck.save_state(str(tmp_path), _trained_state(False), "final")
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.restore_state(str(tmp_path), "final")


def test_latest_epoch_tag_reads_only_the_ports_epoch_files(tmp_path):
    assert tck.latest_epoch_tag(str(tmp_path / "absent")) is None
    assert tck.latest_epoch_tag(str(tmp_path)) is None
    for name in ("state_final.pt", "state_7.pt.tmp", "state_x.pt"):
        (tmp_path / name).write_bytes(b"")
    for name in ("state_30", "state_final"):   # JAX orbax directories
        (tmp_path / name).mkdir()
    assert tck.latest_epoch_tag(str(tmp_path)) is None
    for name in ("state_9.pt", "state_10.pt"):
        (tmp_path / name).write_bytes(b"")
    assert tck.latest_epoch_tag(str(tmp_path)) == 10


def test_snapshot_config_copies_the_file(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("epochs: 2\n")
    tck.snapshot_config(str(tmp_path / "run"), str(cfg))
    assert (tmp_path / "run" / "config.yaml").read_text() == "epochs: 2\n"
    shutil.rmtree(tmp_path / "run")
    tck.snapshot_config(str(tmp_path / "run"), None)
    assert os.listdir(tmp_path / "run") == []
