"""Port parity: hypad_tpu_torch.data.fetch against the JAX package's fetch
surface (tests/test_fetch.py's cases), on CSVs written to a tmpdir. The
port returns ``{column: array}`` tables where JAX returns DataFrames; each
column must equal the DataFrame's, values and dtype.

No test touches the network: every cache miss fetches from ``S3_URL``
pointed at a ``file://`` directory in the tmpdir (``pandas.read_csv``
reads ``file://`` too, so JAX's ``download`` runs on the same file)."""

import numpy as np
import pandas as pd
import pytest
import torch

from hypad_tpu.data import fetch as jfetch
from hypad_tpu_torch.data import fetch as tfetch
from hypad_tpu_torch.data.multivariate import casas_anomalies


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def remote(tmp_path, monkeypatch):
    """A ``file://`` bucket root for both packages' ``S3_URL``: a miss of
    signal ``s`` reads ``remote/d3-ai-orion/s.csv``."""
    root = tmp_path / "remote"
    (root / tfetch.BUCKET).mkdir(parents=True)
    url = "file://" + str(root) + "/{}/{}"
    monkeypatch.setattr(tfetch, "S3_URL", url)
    monkeypatch.setattr(jfetch, "S3_URL", url)
    return root / tfetch.BUCKET


def _same_table(got, frame):
    assert list(got) == list(frame.columns)
    for name in frame.columns:
        want = frame[name].to_numpy()
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want)


def test_download_uses_cache(tmp_path):
    df = pd.DataFrame({"timestamp": [1, 2, 3], "value": [0.1, 0.2, 0.3]})
    df.to_csv(tmp_path / "sig.csv", index=False)
    _same_table(tfetch.download("sig", str(tmp_path)),
                jfetch.download("sig", str(tmp_path)))
    # an s3:// name resolves to the file name in the cache
    got = tfetch.download("s3://bucket/dir/sig.csv", str(tmp_path))
    _same_table(got, jfetch.download("s3://bucket/dir/sig.csv",
                                     str(tmp_path)))


def test_download_miss_raises_naming_the_cache_path(tmp_path, remote):
    """A miss whose fetch fails (the file is not in the bucket) raises
    JAX's ``FileNotFoundError`` text, naming the cache path and the URL,
    and creates no cache directory."""
    cache = tmp_path / "cache"
    with pytest.raises(FileNotFoundError, match="not cached") as err:
        tfetch.download("never-existing-signal-xyz", str(cache))
    assert str(cache / "never-existing-signal-xyz.csv") in str(err.value)
    assert "remote fetch from file://" in str(err.value)
    with pytest.raises(FileNotFoundError) as jerr:
        jfetch.download("never-existing-signal-xyz", str(cache))
    assert str(err.value).split(" failed (")[0] == \
        str(jerr.value).split(" failed (")[0]
    assert not cache.exists()
    with pytest.raises(FileNotFoundError, match="not cached"):
        tfetch.download_demo(str(cache), n=2)


@pytest.mark.parametrize("name", ["sig", "s3://d3-ai-orion/sub/sig.csv"])
def test_download_miss_fetches_and_caches_as_jax(tmp_path, remote, name):
    """A miss reads the remote CSV and writes the cache in pandas'
    ``to_csv(index=False)`` layout: the port's cache file is byte for byte
    JAX's, its table JAX's DataFrame, and the next call reads the cache
    (the remote file gone)."""
    n = 57
    rng = np.random.default_rng(3)
    # six significant digits, which pandas' fast float parser reads
    # correctly rounded, as the port's reader always does
    values = np.array([float(f"{v:.6g}") for v in
                       rng.standard_normal(n) * 10.0 ** rng.integers(-7, 9,
                                                                      n)])
    values[[4, 11]] = np.nan
    values[5] = 2.0
    frame = pd.DataFrame({"timestamp": 1_222_819_200 + 21600 * np.arange(n),
                          "value": values,
                          "tag": [f"t{i % 3}" for i in range(n)]})
    if name.startswith("s3://"):
        (remote / "sub").mkdir()
        frame.to_csv(remote / "sub" / "sig.csv", index=False)
    else:
        frame.to_csv(remote / "sig.csv", index=False)
    got = tfetch.download(name, str(tmp_path / "port"))
    want = jfetch.download(name, str(tmp_path / "jax"))
    _same_table(got, want)
    assert ((tmp_path / "port" / "sig.csv").read_bytes()
            == (tmp_path / "jax" / "sig.csv").read_bytes())
    for path in remote.rglob("sig.csv"):
        path.unlink()
    _same_table(tfetch.download(name, str(tmp_path / "port")), want)


@pytest.mark.parametrize("n,test_size", [(10, 0.3), (7, 0.5), (3, 0.1)])
def test_download_tail_split(tmp_path, n, test_size):
    """The tail split as pandas' iloc slices it, a split of 0 rows (the
    whole table in the tail) included."""
    df = pd.DataFrame({"timestamp": range(n), "value": np.arange(n) * 0.5})
    df.to_csv(tmp_path / "s.csv", index=False)
    got = tfetch.download("s", str(tmp_path), test_size=test_size)
    want = jfetch.download("s", str(tmp_path), test_size=test_size)
    for g, w in zip(got, want):
        _same_table(g, w)


def test_load_csv_positional_columns(tmp_path):
    p = tmp_path / "raw.csv"
    pd.DataFrame([[5, 1.0, 100], [6, 2.0, 200]]).to_csv(p, index=False,
                                                        header=False)
    got = tfetch.load_csv(str(p), timestamp_column=0, value_column=2)
    _same_table(got, jfetch.load_csv(str(p), timestamp_column=0,
                                     value_column=2))
    assert got["value"].tolist() == [100, 200]
    for kw in (dict(timestamp_column=1, value_column=1),
               dict(value_column=1), dict(timestamp_column=1)):
        with pytest.raises(ValueError):
            tfetch.load_csv(str(p), **kw)
    q = tmp_path / "head.csv"
    pd.DataFrame({"t": [1, 2], "v": [0.5, None], "s": ["a", "b"]}).to_csv(
        q, index=False)
    got = tfetch.load_csv(str(q))
    want = jfetch.load_csv(str(q))
    assert list(got) == list(want.columns)
    np.testing.assert_array_equal(got["v"], want["v"].to_numpy())
    assert got["s"].tolist() == want["s"].tolist()


@pytest.mark.parametrize("test_size", [None, 0.25])
def test_load_signal_types(tmp_path, test_size):
    p = tmp_path / "sig.csv"
    pd.DataFrame({"timestamp": ["1", "2", "3", "4"],
                  "value": ["3.5", "4.5", "5", "6"]}).to_csv(p, index=False)
    got = tfetch.load_signal(str(p), test_size=test_size)
    want = jfetch.load_signal(str(p), test_size=test_size)
    if test_size is None:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _same_table(g, w)
        assert g["timestamp"].dtype.kind == "i"
        assert g["value"].dtype.kind == "f"
    # a cached name, positional columns
    pd.DataFrame([[10, 0.25], [20, 0.75]]).to_csv(tmp_path / "raw.csv",
                                                  index=False, header=False)
    _same_table(tfetch.load_signal("sig", data_path=str(tmp_path)),
                jfetch.load_signal("sig", data_path=str(tmp_path)))
    _same_table(tfetch.load_signal(str(tmp_path / "raw.csv"),
                                   timestamp_column=0, value_column=1),
                jfetch.load_signal(str(tmp_path / "raw.csv"),
                                   timestamp_column=0, value_column=1))


def test_nasa_registry_and_constants():
    assert tfetch.NASA_SIGNALS == jfetch.NASA_SIGNALS
    assert "C-2" in tfetch.NASA_SIGNALS and len(tfetch.NASA_SIGNALS) == 80
    assert (tfetch.BUCKET, tfetch.S3_URL) == (jfetch.BUCKET, jfetch.S3_URL)
    assert tfetch.casas_anomalies is casas_anomalies


def test_download_demo_reads_the_cache(tmp_path, remote):
    for sig in jfetch.NASA_SIGNALS[:2]:
        for part in ("-train", "-test"):
            pd.DataFrame({"timestamp": [1, 2], "value": [0.0, 1.0]}).to_csv(
                tmp_path / f"{sig}{part}.csv", index=False)
    assert tfetch.download_demo(str(tmp_path), split=True, n=2) is None
    with pytest.raises(FileNotFoundError, match="-train.csv"):
        tfetch.download_demo(str(tmp_path), split=True, n=3)
