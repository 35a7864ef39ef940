"""Signal preprocessing for the detector, numpy only.

A copy of the stages of ``hypad_tpu.data.pipeline`` that the detector's
input needs (the port imports nothing of the JAX package): synthetic
timestamps, per-interval mean aggregation, mean imputation, (-1, 1) min-max
scaling and rolling windows; plus ``extract_known_anomalies``, which returns
start/end arrays instead of a DataFrame so no pandas is needed.
"""

from __future__ import annotations

from datetime import datetime

import numpy as np

# The A1-sized training input of chip_smoke.py and profile_train.py:
# ``synthetic_detect_input(A1_WINDOWS, 100, anomaly_len=50)`` is a signal as
# long as Yahoo A1 real_1 (1,420 samples), trained in batches of
# configs/univariate.yaml's 64.
A1_WINDOWS = 1320
A1_BATCH_SIZE = 64


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


def prepare_univariate(values, timestamps, interval, window_size=100):
    """The preprocessing of ``load_signal_dataset`` on arrays: aggregate,
    impute, scale to (-1, 1), window. Returns (windows (M, window_size)
    float32, aggregated timeline (n_buckets,))."""
    agg, index = time_segments_aggregate(values, timestamps, interval)
    X = minmax_scale(impute_mean(agg))
    windows, _, _, _ = rolling_windows(X, index, window_size=window_size)
    return windows.astype(np.float32), index


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
