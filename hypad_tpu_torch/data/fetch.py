"""Signal acquisition: the local cache and the remote fetch, a port of
``hypad_tpu.data.fetch``.

Behaviour spec: reference ``utils/data.py``, as the JAX package carries
it: ``download`` (:114-163) resolves a signal name (or an s3:// URL) to a
CSV in the cache directory, ``download_demo`` (:166-176) caches the first
NASA demo signals, ``load_csv`` (:179-205) maps positional columns to
``timestamp`` / ``value``, ``load_signal`` (:208-224) loads with the int /
float casts and an optional tail split, and ``NASA_SIGNALS`` (:30-111) is
the SMAP / MSL registry.

On a cache miss ``download`` reads the CSV from ``S3_URL`` (the
d3-ai-orion bucket by default) with ``urllib.request``, writes it into the
cache in pandas' ``to_csv(index=False)`` layout, as JAX's does, and raises
JAX's ``FileNotFoundError`` text only if that fails. The card's machine
has no pandas, so a table is the port's own: a
``{column name: numpy array}`` dict, each column numeric as
``pandas.read_csv`` reads it (int64, else float64 with NaN for the NA
strings), a column that is not numeric kept as strings. A tail split
returns two such tables. ``casas_anomalies`` is the multivariate loaders'
(``data/multivariate.py``).
"""

from __future__ import annotations

import csv
import os

import numpy as np

from hypad_tpu_torch.data.multivariate import casas_anomalies
from hypad_tpu_torch.data.pipeline import numeric_column, read_csv_columns

__all__ = ["BUCKET", "S3_URL", "NASA_SIGNALS", "download", "download_demo",
           "load_csv", "load_signal", "casas_anomalies"]

BUCKET = "d3-ai-orion"
S3_URL = "https://{}.s3.amazonaws.com/{}"

NASA_SIGNALS = (
    "P-1", "S-1", "E-1", "E-2", "E-3", "E-4", "E-5", "E-6", "E-7", "E-8",
    "E-9", "E-10", "E-11", "E-12", "E-13", "A-1", "D-1", "P-3", "D-2", "D-3",
    "D-4", "A-2", "A-3", "A-4", "G-1", "G-2", "D-5", "D-6", "D-7", "F-1",
    "P-4", "G-3", "T-1", "T-2", "D-8", "D-9", "F-2", "G-4", "T-3", "D-11",
    "D-12", "B-1", "G-6", "G-7", "P-7", "R-1", "A-5", "A-6", "A-7", "D-13",
    "A-8", "A-9", "F-3", "M-6", "M-1", "M-2", "S-2", "P-10", "T-4", "T-5",
    "F-7", "M-3", "M-4", "M-5", "P-15", "C-1", "C-2", "T-12", "T-13", "F-4",
    "F-5", "D-14", "T-9", "P-14", "T-8", "P-11", "D-15", "D-16", "M-7",
    "F-8",
)


def _column(fields):
    try:
        return numeric_column(fields)
    except ValueError:
        return np.array(fields, dtype=object)


def _read_table(path, header=True):
    """{column: array} of a CSV; without ``header`` the columns are named
    0, 1, ... by position."""
    if header:
        cols = read_csv_columns(path)
    else:
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        width = max((len(r) for r in rows), default=0)
        cols = {i: [r[i] if i < len(r) else "" for r in rows]
                for i in range(width)}
    return {name: _column(fields) for name, fields in cols.items()}


def _split(table, test_size):
    """(head, tail) of a table, the tail round(n * test_size) rows, sliced
    as pandas' ``iloc[:-n]`` / ``iloc[-n:]`` slice."""
    n = len(next(iter(table.values()), ()))
    test_length = round(n * test_size)
    return ({k: v[:-test_length] for k, v in table.items()},
            {k: v[-test_length:] for k, v in table.items()})


def _cell(v):
    """One field as pandas' ``to_csv`` writes it: NaN empty, a float by
    its shortest round-trip repr, anything else by ``str``."""
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    return str(v)


def _write_table(path, table):
    """``table`` as ``DataFrame(table).to_csv(path, index=False)`` writes
    it."""
    cols = list(table)
    n = len(next(iter(table.values()), ()))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for i in range(n):
            w.writerow([_cell(table[c][i]) for c in cols])


def _fetch(url, data_path, filename):
    """The table of the CSV at ``url``, cached at ``filename``."""
    import urllib.request

    with urllib.request.urlopen(url) as response:
        raw = response.read()
    os.makedirs(data_path, exist_ok=True)
    part = f"{filename}.{os.getpid()}.part"
    try:
        with open(part, "wb") as f:
            f.write(raw)
        data = _read_table(part)
    finally:
        if os.path.exists(part):
            os.unlink(part)
    _write_table(filename, data)
    return data


def download(name, data_path, test_size=None):
    """The table of ``name`` (a signal name or s3://bucket/path.csv) from
    the cache ``data_path``, fetched from ``S3_URL`` and cached there on a
    miss; with ``test_size`` its (head, tail) split. A miss whose fetch
    fails raises ``FileNotFoundError``."""
    url = None
    if name.startswith("s3://"):
        bucket, _, path = name[5:].partition("/")
        url = S3_URL.format(bucket, path)
        filename = os.path.join(data_path, path.split("/")[-1])
    else:
        filename = os.path.join(data_path, name + ".csv")
    if os.path.exists(filename):
        data = _read_table(filename)
    else:
        url = url or S3_URL.format(BUCKET, f"{name}.csv")
        try:
            data = _fetch(url, data_path, filename)
        except Exception as exc:
            raise FileNotFoundError(
                f"signal {name!r} not cached at {filename} and remote fetch "
                f"from {url} failed ({exc}); place the CSV in the data root"
            ) from exc
    if test_size:
        return _split(data, test_size)
    return data


def download_demo(data_path, split=False, n=3):
    """Cache the first ``n`` NASA demo signals (their ``-train`` /
    ``-test`` halves with ``split``)."""
    for signal in NASA_SIGNALS[:n]:
        if split:
            download(signal + "-train", data_path)
            download(signal + "-test", data_path)
        else:
            download(signal, data_path)


def load_csv(path, timestamp_column=None, value_column=None):
    """A CSV as a table: every column under its header, or, with the two
    positional columns given (the file then has no header),
    ``{"timestamp", "value"}``."""
    if timestamp_column is None:
        if value_column is not None:
            raise ValueError(
                "If value_column is provided, timestamp_column must be as well")
        return _read_table(path)
    if value_column is None:
        raise ValueError(
            "If timestamp_column is provided, value_column must be as well")
    if timestamp_column == value_column:
        raise ValueError("timestamp_column cannot be the same as value_column")
    data = _read_table(path, header=False)
    columns = list(data)
    return {"timestamp": data[columns[timestamp_column]],
            "value": data[columns[value_column]]}


def load_signal(signal, data_path=None, test_size=None, timestamp_column=None,
                value_column=None):
    """``{"timestamp" int64, "value" float64}`` of a CSV path or a cached
    signal name (other columns kept as read), with the (head, tail) split
    when ``test_size`` is given."""
    if os.path.isfile(signal):
        data = load_csv(signal, timestamp_column, value_column)
    else:
        data = download(signal, data_path or ".")
    data["timestamp"] = np.asarray(data["timestamp"]).astype(int)
    data["value"] = np.asarray(data["value"]).astype(float)
    if test_size is None:
        return data
    return _split(data, test_size)
