"""Signal loading and preprocessing, numpy and the standard library only.

Port of ``hypad_tpu.data.pipeline`` (the port imports nothing of the JAX
package, and the card's machine has no pandas): signal CSVs are read with
``csv`` and numpy, keeping ``pandas.read_csv``'s semantics where the
pipeline reads them (an empty or NA field is NaN; a column of integers
stays int64, one with a NaN or a fraction is float64). Stages: Yahoo's
linear detrend, synthetic timestamps and known-anomaly runs, per-interval
mean aggregation, mean imputation, (-1, 1) min-max scaling and rolling
windows. Known anomalies are ``(k, 2)`` start/end arrays; the
``*_known_anomalies.csv`` file is written in pandas' ``to_csv`` layout (an
index column, then ``start,end``). ``load_signal_dataset`` runs the
aggregation-to-windows pass on the native C++ engine (``data/native.py``)
where it builds, with the numpy stages' bits.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
import re
import stat
from datetime import datetime
from typing import Any, Optional

import numpy as np

# The A1-sized training input of chip_smoke.py and profile_train.py:
# ``synthetic_detect_input(A1_WINDOWS, 100, anomaly_len=50)`` is a signal as
# long as Yahoo A1 real_1 (1,420 samples), trained in batches of
# configs/univariate.yaml's 64.
A1_WINDOWS = 1320
A1_BATCH_SIZE = 64

# the strings pandas.read_csv reads as NaN by default
_NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_INT_TEXT = re.compile(r"^[+-]?[0-9]+$")


def read_csv_columns(path):
    """{column name: list of field strings} of a CSV with a header row."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    header, body = rows[0], rows[1:]
    return {name: [row[i] if i < len(row) else "" for row in body]
            for i, name in enumerate(header)}


def numeric_column(fields):
    """A numeric CSV column as pandas reads it: int64 when every field is
    an integer, else float64 with NaN for the NA strings. Text that is not
    a number raises ValueError."""
    if fields and all(_INT_TEXT.match(f) for f in fields):
        return np.array([int(f) for f in fields], dtype=np.int64)
    out = np.empty(len(fields), dtype=np.float64)
    for i, f in enumerate(fields):
        f = f.strip()
        if f in _NA_VALUES:
            out[i] = math.nan
        elif "_" in f:
            raise ValueError(f"not a number: {f!r}")
        else:
            out[i] = float(f)
    return out


def detrend(values):
    """Linear least-squares detrend (scipy.signal.detrend(type="linear"))."""
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    t = np.arange(n, dtype=np.float64)
    t_mean = t.mean()
    v_mean = values.mean()
    slope = ((t - t_mean) * (values - v_mean)).sum() / ((t - t_mean) ** 2).sum()
    return values - (v_mean + slope * (t - t_mean))


def synthetic_timestamps(n: int) -> np.ndarray:
    """Per-second epoch timestamps starting 2012-11-24 local time."""
    start = datetime(2012, 11, 24).timestamp()
    return start + np.arange(n, dtype=np.float64)


def extract_known_anomalies(is_anomaly, timestamps):
    """Contiguous runs of is_anomaly == 1 -> (starts, ends) timestamp
    arrays of the runs' first and last samples."""
    flags = np.concatenate([[0], np.asarray(is_anomaly).astype(int) == 1,
                            [0]]).astype(np.int8)
    change = np.diff(flags)
    timestamps = np.asarray(timestamps)
    starts = timestamps[np.flatnonzero(change == 1)]
    ends = timestamps[np.flatnonzero(change == -1) - 1]
    return starts, ends


def time_segments_aggregate(values, timestamps, interval):
    """Per-interval mean aggregation. Returns (aggregated values
    (n_buckets, n_cols), bucket-start index (n_buckets,)); empty buckets
    aggregate to NaN (imputed later)."""
    order = np.argsort(timestamps, kind="stable")
    ts = np.asarray(timestamps, dtype=np.float64)[order]
    vals = np.asarray(values, dtype=np.float64)[order]
    if vals.ndim == 1:
        vals = vals[:, None]

    t0, t_max = ts[0], ts[-1]
    n_buckets = int(np.floor((t_max - t0) / interval)) + 1
    bucket = np.floor((ts - t0) / interval).astype(np.int64)
    bucket = np.clip(bucket, 0, n_buckets - 1)

    out = np.empty((n_buckets, vals.shape[1]), dtype=np.float64)
    valid = ~np.isnan(vals)
    for c in range(vals.shape[1]):
        sums = np.bincount(bucket, weights=np.where(valid[:, c], vals[:, c],
                                                    0.0),
                           minlength=n_buckets)
        counts = np.bincount(bucket, weights=valid[:, c].astype(np.float64),
                             minlength=n_buckets)
        with np.errstate(invalid="ignore"):
            out[:, c] = sums / counts  # 0/0 -> NaN for empty buckets
    index = t0 + interval * np.arange(n_buckets, dtype=np.float64)
    return out, index


def impute_mean(X):
    """Column-mean imputation of NaNs."""
    X = np.array(X, dtype=np.float64, copy=True)
    col_mean = np.nanmean(X, axis=0)
    nan_pos = np.isnan(X)
    X[nan_pos] = np.take(col_mean, np.nonzero(nan_pos)[1])
    return X


def minmax_scale(X, feature_range=(-1.0, 1.0)):
    """Per-column min-max scaling."""
    lo, hi = feature_range
    mn = X.min(axis=0)
    mx = X.max(axis=0)
    scale = np.where(mx > mn, (hi - lo) / np.where(mx > mn, mx - mn, 1.0),
                     0.0)
    return (X - mn) * scale + lo


def rolling_windows(X, index, window_size=100, target_size=1, step_size=1,
                    target_column=0):
    """Stride-tricks rolling windows. Returns (windows (M, window[, n_cols]),
    targets (M, target_size), X_index (M,), y_index (M,)),
    M = len(X) - window - target + 1 stepped."""
    X = np.ascontiguousarray(X)
    target = X[:, target_column]
    n = len(X)
    max_start = n - window_size - target_size + 1
    starts = np.arange(0, max(max_start, 0), step_size)
    if len(starts) == 0:
        raise ValueError(
            f"signal of length {n} too short for window {window_size}")
    win = np.lib.stride_tricks.sliding_window_view(X, window_size, axis=0)
    out_X = win.transpose(0, 2, 1)[starts]
    tgt = np.lib.stride_tricks.sliding_window_view(target, target_size)
    out_y = tgt[starts + window_size]
    X_index = np.asarray(index)[starts]
    y_index = np.asarray(index)[starts + window_size]
    if out_X.shape[-1] == 1:
        out_X = out_X[..., 0]
    return out_X, out_y, X_index, y_index


def _windows(values, timestamps, interval, window_size):
    """Aggregate, impute, scale to (-1, 1), window: (X (M, window_size)
    float32, y (M, 1) float32, X_index, y_index, index)."""
    agg, index = time_segments_aggregate(values, timestamps, interval)
    X = minmax_scale(impute_mean(agg))
    out_X, out_y, X_index, y_index = rolling_windows(
        X, index, window_size=window_size)
    return (out_X.astype(np.float32), out_y.astype(np.float32), X_index,
            y_index, index)


def prepare_univariate(values, timestamps, interval, window_size=100):
    """The preprocessing of ``load_signal_dataset`` on arrays: aggregate,
    impute, scale to (-1, 1), window. Returns (windows (M, window_size)
    float32, aggregated timeline (n_buckets,))."""
    X, _, _, _, index = _windows(values, timestamps, interval, window_size)
    return X, index


@dataclasses.dataclass
class SignalData:
    """A preprocessed univariate signal. ``X_device`` is a copy of ``X``
    on the card, set by whoever uploads it once (the CLI's ``train``) so
    that detection reuses it."""
    X: np.ndarray            # (M, window) float32 windows
    y: np.ndarray            # (M, 1) targets
    X_index: np.ndarray      # (M,) window-start timestamps
    y_index: np.ndarray      # (M,) target timestamps
    index: np.ndarray        # (n_buckets,) aggregated timeline
    known_anomalies: Optional[np.ndarray] = None   # (k, 2) start, end
    X_device: Any = None

    def __len__(self):
        return len(self.X)


def write_intervals_csv(path, intervals, columns):
    """``intervals`` (k, len(columns)) in pandas' ``DataFrame.to_csv``
    layout: a header with an empty index name, then ``i,v0,v1,...`` rows,
    floats in their shortest round-trip form."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["", *columns])
        for i, row in enumerate(np.asarray(intervals).reshape(
                -1, len(columns)).tolist()):
            w.writerow([i, *(repr(v) for v in row)])


def _save_known_anomalies(path, known, cache_dir):
    """Write ``known`` beside the source CSV as ``*_known_anomalies.csv``,
    through a temporary file and ``os.replace`` so a failed write never
    leaves a truncated file; when the source directory's mode bits mark it
    read-only (checked on the bits, since root passes any access check),
    write it into ``cache_dir`` instead."""
    src_dir = os.path.dirname(os.path.abspath(path))
    writable = bool(os.stat(src_dir).st_mode & stat.S_IWUSR)
    try:
        if writable:
            dst = path[:-4] + "_known_anomalies.csv"
            tmp = dst + ".tmp"
            try:
                write_intervals_csv(tmp, known, ("start", "end"))
                os.replace(tmp, dst)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    except OSError:
        writable = False
    if not writable and cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        base = os.path.basename(path)[:-4] + "_known_anomalies.csv"
        write_intervals_csv(os.path.join(cache_dir, base), known,
                            ("start", "end"))


def load_signal_dataset(path, interval=21600, window_size=100, yahoo=False,
                        cache_dir=None, engine="auto") -> SignalData:
    """A signal CSV (``timestamp,value``) -> :class:`SignalData`.

    ``yahoo``: the Yahoo layout (``value`` and ``is_anomaly``, or A3/A4's
    ``timestamps``/``value``/``anomaly``): the values are detrended, given
    synthetic per-second timestamps (in place of any timestamp column), and
    the runs of the anomaly flag become the known anomalies, which are also
    written to ``*_known_anomalies.csv`` (see ``_save_known_anomalies``).
    The caller passes ``interval=1`` for Yahoo.

    ``engine`` (JAX's): "auto" runs the native C++ pass
    (``data/native.py``) and falls back to numpy, with the same bits,
    where the engine is not built or the signal is too short; "native"
    raises there; "numpy" runs numpy. ``load_signal_dataset.engines``
    counts which one ran."""
    if engine not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown engine {engine!r}")
    cols = read_csv_columns(path)
    known = None
    if yahoo:
        values = detrend(numeric_column(cols["value"]))
        timestamps = synthetic_timestamps(len(values))
        flag_col = ("anomaly" if "is_anomaly" not in cols and "anomaly" in cols
                    else "is_anomaly")
        known = np.stack(extract_known_anomalies(
            numeric_column(cols[flag_col]), timestamps), axis=1)
        _save_known_anomalies(path, known, cache_dir)
    else:
        timestamps = numeric_column(cols["timestamp"])
        values = numeric_column(cols["value"])
    res = None
    if engine != "numpy":
        from hypad_tpu_torch.data import native

        res = native.prepare_univariate(timestamps, values, interval,
                                        window_size=window_size)
        if res is None and engine == "native":
            raise RuntimeError("native pipeline unavailable or signal too "
                               "short; use engine='numpy'"
                               + (f" ({native.build_error})"
                                  if native.build_error else ""))
    load_signal_dataset.engines["numpy" if res is None else "native"] += 1
    if res is None:
        res = _windows(values, timestamps, interval, window_size)
    X, y, X_index, y_index, index = res
    return SignalData(X=X, y=y, X_index=X_index, y_index=y_index,
                      index=index, known_anomalies=known)


load_signal_dataset.engines = {"native": 0, "numpy": 0}


def load_anomalies(signal, data_root):
    """Ground-truth (k, 2) start/end intervals of ``signal`` from
    ``data_root/anomalies.csv`` (columns ``signal`` and ``events``, a JSON
    list of [start, end] pairs); a signal not listed raises KeyError."""
    cols = read_csv_columns(os.path.join(data_root, "anomalies.csv"))
    # pandas' set_index("signal").loc[signal].values[0]: the first column
    # after ``signal``, on the signal's row
    other = next(name for name in cols if name != "signal")
    for name, events in zip(cols["signal"], cols[other]):
        if name == signal:
            return np.asarray(json.loads(events)).reshape(-1, 2)
    raise KeyError(signal)


def synthetic_signal(n, n_anomalies=3, anomaly_len=50, seed=0):
    """A seeded univariate test signal: two sines plus noise, with
    ``n_anomalies`` level shifts of ``anomaly_len`` samples spread over the
    middle of the signal. Returns (timestamps (n,), values (n,),
    is_anomaly (n,) int)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    values = (np.sin(2 * np.pi * t / 100) + 0.5 * np.sin(2 * np.pi * t / 37)
              + 0.1 * rng.standard_normal(n))
    is_anomaly = np.zeros(n, dtype=int)
    starts = np.linspace(0.2 * n, 0.8 * n, n_anomalies).astype(int)
    for k, start in enumerate(starts):
        values[start:start + anomaly_len] += 3.0 if k % 2 == 0 else -3.0
        is_anomaly[start:start + anomaly_len] = 1
    return synthetic_timestamps(n), values, is_anomaly


def synthetic_detect_input(n_windows, window_size=100, anomaly_len=200,
                           seed=0):
    """A seeded signal with 3 injected anomalies, windowed to exactly
    ``n_windows`` windows. Returns (windows (n_windows, window_size)
    float32, timeline, known anomalies (3, 2) start/end timestamps)."""
    stamps, values, flags = synthetic_signal(n_windows + window_size,
                                             anomaly_len=anomaly_len,
                                             seed=seed)
    X, index = prepare_univariate(values, stamps, 1, window_size=window_size)
    known = np.stack(extract_known_anomalies(flags, stamps), axis=1)
    return X, index, known
