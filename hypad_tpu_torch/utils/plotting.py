"""Anomaly plots: a port of ``hypad_tpu.utils.plotting``.

The same figures as the JAX package's functions, drawn with matplotlib on
its Agg backend, imported inside each function (the GPU machine need not
have it). The card has no pandas, so the tables are the port's own:

* interval tables are arrays of shape (K, >= 2), start and end first, as
  the detector holds its ``intervals`` and ``known_anomalies`` (or lists
  of (start, end) pairs where JAX takes lists);
* a signal table is a ``{"timestamp", "value"}`` mapping of arrays where
  JAX takes a DataFrame.

A DataFrame is accepted as well wherever pandas happens to be present.

Like JAX's, :func:`plot_anomaly_intervals` draws every set of intervals:
the reference's plot_anomalies draws only the last set (its inner loop
sits outside the outer one), a bug documented there and not reproduced.
"""

from __future__ import annotations

import os

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _spans(table):
    """(start, end) pairs of an interval table: a DataFrame's ``start`` and
    ``end`` columns, or an array's first two columns (an empty array, as
    ``find_anomalies`` gives for no interval, has none)."""
    if hasattr(table, "columns"):
        return list(table[["start", "end"]].itertuples(index=False))
    a = np.asarray(table)
    if a.size == 0:
        return []
    return [(row[0], row[1]) for row in a.reshape(len(a), -1)]


def plot_anomaly_intervals(anomaly_frames, x_index, series, out_dir,
                           filename="anomalies.png"):
    """The series against ``x_index`` with each interval table's spans
    shaded: the first red (predicted), the rest green (ground truth).
    Writes ``out_dir/filename`` and returns its path."""
    plt = _pyplot()
    colors = ["red"] + ["green"] * (len(anomaly_frames) - 1)
    fig, ax = plt.subplots(figsize=(25, 5))
    ax.plot(np.asarray(x_index)[: len(series)], np.asarray(series), lw=0.8)
    for frame, color in zip(anomaly_frames, colors):
        for start, end in _spans(frame):
            ax.axvspan(start, end, color=color, alpha=0.2)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, filename)
    fig.savefig(out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out


def unroll_ts(y_hat, device="cuda"):
    """Per-timestep median unroll of (N, W) window predictions for
    display, without the first W - 1 positions (reference
    utils/utils.py:87-102); computed on ``device``, returned as numpy."""
    import torch

    from hypad_tpu_torch._device import resolve_device
    from hypad_tpu_torch.ops.unroll import unroll_median

    y = torch.as_tensor(np.asarray(y_hat, np.float32),
                        device=resolve_device(device))
    return unroll_median(y).cpu().numpy()[y.shape[1] - 1:]


def plot_ts(series_list, labels=None, title="signal", out_path=None):
    """Multi-series line plot (reference plot_ts, utils/utils.py:115-136)."""
    plt = _pyplot()
    if not isinstance(series_list, list):
        series_list = [series_list]
    fig, ax = plt.subplots(figsize=(30, 6))
    for x in series_list:
        ax.plot(range(len(x)), x)
    ax.set_title(title, size=34)
    ax.set_xlabel("Time", size=30)
    ax.set_xlim([0, max(len(x) for x in series_list) - 1])
    if labels:
        ax.legend(labels=labels, loc=1, prop={"size": 26})
    if out_path:
        fig.savefig(out_path)
    plt.close(fig)
    return fig


def plot_signal_with_anomalies(df, anomalies=(), signal="signal", path=""):
    """A timestamped signal with shaded anomaly spans, the first interval
    table red (predicted), the rest green (ground truth) (reference plot,
    utils/utils.py:166-223). ``df``: a ``{"timestamp", "value"}`` table or
    a list or tuple of them; ``anomalies``: an interval table, a list of
    (start, end) pairs in a list, or a list of either. Writes
    ``anomalies.jpg`` into ``path`` (the working directory when empty) and
    returns its path."""
    from datetime import datetime

    import matplotlib.dates as mdates

    plt = _pyplot()
    dfs = list(df) if isinstance(df, (list, tuple)) else [df]
    anomalies = list(anomalies) if isinstance(anomalies, (list, tuple)) \
        else [anomalies]
    time = [datetime.fromtimestamp(t) for t in dfs[0]["timestamp"]]

    fig, ax = plt.subplots(figsize=(30, 6))
    for frame in dfs:
        ax.plot(time, frame["value"])
    colors = ["red"] + ["green"] * (len(anomalies) - 1)
    for color, anomaly in zip(colors, anomalies):
        if not isinstance(anomaly, list):
            anomaly = _spans(anomaly)
        for anom in anomaly:
            ax.axvspan(datetime.fromtimestamp(anom[0]),
                       datetime.fromtimestamp(anom[1]), color=color,
                       alpha=0.2)
    ax.set_title(signal, size=34)
    ax.set_xlabel("Time", size=30)
    ax.set_xlim([time[0], time[-1]])
    ax.xaxis.set_major_locator(mdates.MonthLocator())
    ax.xaxis.set_major_formatter(mdates.DateFormatter("%b"))
    out = os.path.join(path, "anomalies.jpg") if path else "anomalies.jpg"
    fig.savefig(out)
    plt.close(fig)
    return out


def plot_error(series_groups, out_path=None):
    """Stacked error panels (reference plot_error, utils/utils.py:139-163):
    each entry is either a pair of series (drawn together on a double-height
    panel) or a single series (drawn red)."""
    import matplotlib.gridspec as gridspec

    plt = _pyplot()
    fig = plt.figure(figsize=(30, 6))
    gs = gridspec.GridSpec(3, 1)
    gs.update(wspace=0.025, hspace=0.05)
    i = 0
    for group in series_groups:
        if isinstance(group, (list, tuple)) and len(group) == 2:
            ax = plt.subplot(gs[i:i + 2])
            for line in group:
                ax.plot(range(len(line)), line)
            i += 1
        else:
            ax = plt.subplot(gs[i])
            ax.plot(range(len(group)), group, color="tab:red")
        i += 1
        ax.set_xticklabels([])
    if out_path:
        fig.savefig(out_path)
    plt.close(fig)
    return fig


def plot_rolling_windows(X, window=100, k=5, out_path=None):
    """Grid of sample rolling windows (reference plot_rws,
    utils/utils.py:226-262, without its duplicated-first-panel quirks)."""
    plt = _pyplot()
    X = np.asarray(X)
    shift = 75
    rows = int(np.ceil(k / 5)) + 1
    fig = plt.figure(figsize=(15, rows * 2))
    for i in range(k):
        j = i * shift if i >= 2 else i
        if j >= len(X):
            break
        ax = fig.add_subplot(rows, 5, i + 1)
        ax.plot(range(j, j + X.shape[1]), X[j], lw=2)
        ax.set_title(f"window {j}", size=16)
        ax.set_ylim([-1, 1])
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path)
    plt.close(fig)
    return fig
