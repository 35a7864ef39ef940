"""Anomalous-interval extraction: the host epilogue of the detector.

A copy of the serial, fixed-threshold ``find_anomalies`` chain of
``hypad_tpu.detect.intervals`` (the port imports nothing of the JAX
package): sliding threshold windows over the score series; per window the
fixed threshold mean + 4 sigma; above-threshold run extraction with
padding; max-error ranking; percent-separation pruning; scoring
(max - thr) / (mean + std); weighted merging; finally positions are mapped
to timestamps through the index. numpy only. ``find_anomalies_batch`` runs
the same chain for the cells of a detection grid at once, bitwise equal per
cell, with one shared timestamp index or one index per cell. Both take
JAX's parameters in JAX's order, ``lower_threshold`` included (each window
also scans its mirror about its mean). The dynamic (Nelder-Mead) threshold
is not ported yet (ROADMAP A12): a falsy ``fixed_threshold`` raises.
"""

from __future__ import annotations

import numpy as np


def fixed_threshold(errors, k=4):
    return errors.mean() + k * errors.std()


# ---------------------------------------------------------------------------
# sequences
# ---------------------------------------------------------------------------

def find_sequences(errors, epsilon, anomaly_padding):
    above = errors > epsilon
    idx = np.flatnonzero(above)
    # pad each above-threshold point by +-anomaly_padding: union of ranges
    # via a difference array + running sum — O(n + k) instead of the
    # reference's O(k * padding) per-point slice assigns (:1117-1166)
    n = len(above)
    delta = np.zeros(n + 1, dtype=np.int64)
    np.add.at(delta, np.maximum(idx - anomaly_padding, 0), 1)
    np.add.at(delta, np.minimum(idx + anomaly_padding + 1, n), -1)
    padded = np.cumsum(delta[:-1]) > 0
    if padded.all():
        max_below = 0.0
    else:
        max_below = float(errors[~padded].max())
    change = np.diff(np.concatenate([[False], padded]).astype(int))
    starts = np.flatnonzero(change == 1)
    ends = np.flatnonzero(change == -1) - 1
    if len(ends) == len(starts) - 1:
        ends = np.append(ends, len(padded) - 1)
    return np.array([starts, ends]).T, max_below


def get_max_errors(errors, sequences, max_below):
    rows = [(-1, -1, float(max_below))]
    for start, stop in sequences:
        rows.append((int(start), int(stop),
                     float(errors[start: stop + 1].max())))
    rows.sort(key=lambda r: -r[2])
    return rows  # list of (start, stop, max_error), descending by max_error


def prune_anomalies(max_errors, min_percent):
    """max_errors: descending (start, stop, max_error) incl. the sentinel
    non-anomalous row. Reference _prune_anomalies (:1203-1237).

    Pure-Python over the handful of runs a threshold window yields. The
    reference's NaN/zero-div semantics are preserved exactly: 0/0 -> nan ->
    ``nan < min_percent`` is False (run kept as boundary), x/0 -> signed
    inf."""
    n = len(max_errors)
    if n < 2:
        return []
    last_index = -1
    for i in range(n - 2, -1, -1):
        me = max_errors[i][2]
        diff = me - max_errors[i + 1][2]
        if me == 0.0:
            # numpy scalar division reproduces the reference's inf/nan
            # (incl. the -0.0 sign convention) in this rare branch
            with np.errstate(invalid="ignore", divide="ignore"):
                increase = np.float64(diff) / np.float64(me)
        else:
            increase = diff / me
        if not increase < min_percent:
            last_index = i
            break
    return max_errors[: last_index + 1]


def _weighted_average(score, weights):
    """np.average(score, weights=weights). Two elements reduce without any
    associativity choice, so the plain Python form is bitwise-identical
    there (the most common merge chain); longer chains go through numpy,
    whose SIMD/pairwise reduction order already diverges from a sequential
    sum at n=3."""
    if len(score) == 2:
        return ((score[0] * weights[0] + score[1] * weights[1])
                / float(weights[0] + weights[1]))
    return np.average(score, weights=weights)


def merge_sequences(sequences):
    # Intermediate chain averages are overwritten by the next overlapping
    # extension and never escape, so each chain's weighted average is
    # computed ONCE when the chain closes — same outputs as the reference's
    # per-step recomputation (:1272-1313) at O(k) instead of O(k^2).
    if len(sequences) == 0:
        return np.array([])
    s = sorted(sequences, key=lambda e: e[0])
    merged = [s[0]]
    score = [s[0][2]]
    weights = [s[0][1] - s[0][0]]

    def close_chain():
        if len(score) > 1:
            prev = merged[-1]
            merged[-1] = (prev[0], prev[1],
                          _weighted_average(score, weights))

    for seq in s[1:]:
        prev = merged[-1]
        if seq[0] <= prev[1] + 1:
            score.append(seq[2])
            weights.append(seq[1] - seq[0])
            merged[-1] = (prev[0], max(prev[1], seq[1]), None)
        else:
            close_chain()
            score = [seq[2]]
            weights = [seq[1] - seq[0]]
            merged.append(seq)
    close_chain()
    return np.array(merged)


def _run_tail(window, seqs, max_below, threshold, denominator, min_percent,
              window_start):
    """Run-level tail (rank -> prune -> score) of one threshold window.
    ``denominator`` = window.mean() + window.std().

    A window with no above-threshold runs yields only the sentinel row,
    which prune_anomalies always drops (len < 2) — returning [] straight
    away is bitwise-identical and skips the tail for the common case."""
    if len(seqs) == 0:
        return []
    max_errors = get_max_errors(window, seqs, max_below)
    pruned = prune_anomalies(max_errors, min_percent)
    return [[start + window_start, stop + window_start,
             (max_error - threshold) / denominator]
            for start, stop, max_error in pruned]


def _find_window_sequences(window, anomaly_padding, min_percent,
                           window_start):
    threshold = fixed_threshold(window)
    seqs, max_below = find_sequences(window, threshold, anomaly_padding)
    return _run_tail(window, seqs, max_below, threshold,
                     window.mean() + window.std(), min_percent, window_start)


def _window_geometry(n, window_size, window_size_portion, window_step_size,
                     window_step_size_portion):
    """Resolved (window_size, window_step_size) — the exact reference
    resolution order (:1444-1452)."""
    window_size = window_size or n
    if window_size_portion:
        window_size = int(np.ceil(n * window_size_portion))
    window_step_size = window_step_size or window_size
    if window_step_size_portion:
        window_step_size = int(np.ceil(window_size * window_step_size_portion))
    return window_size, window_step_size


_DYNAMIC = ("only the fixed threshold is ported; the dynamic threshold is "
            "ROADMAP A12")


def find_anomalies(errors, index, z_range=(0, 10), window_size=None,
                   window_size_portion=None, window_step_size=None,
                   window_step_size_portion=None, min_percent=0.1,
                   anomaly_padding=50, lower_threshold=False,
                   fixed_threshold=None):
    """Reference find_anomalies (:1363-1472) with ``fixed_threshold=True``:
    sliding threshold windows, sequence merge, position -> timestamp
    mapping. The parameters are ``hypad_tpu.detect.intervals``'s, in its
    order; ``z_range`` bounds the dynamic threshold's search, so it is not
    read here. ``lower_threshold``: each window also scans its mirror
    ``mean - (window - mean)`` under the same fixed threshold."""
    if not fixed_threshold:
        raise NotImplementedError(_DYNAMIC)
    errors = np.asarray(errors, dtype=np.float64)
    window_size, window_step_size = _window_geometry(
        len(errors), window_size, window_size_portion, window_step_size,
        window_step_size_portion)

    window_start = 0
    window_end = 0
    sequences = []
    while window_end < len(errors):
        window_end = window_start + window_size
        window = errors[window_start:window_end]
        sequences.extend(_find_window_sequences(
            window, anomaly_padding, min_percent, window_start))
        if lower_threshold:
            mean = window.mean()
            sequences.extend(_find_window_sequences(
                mean - (window - mean), anomaly_padding, min_percent,
                window_start))
        window_start += window_step_size

    merged = merge_sequences(sequences)
    anomalies = [[index[int(start)], index[int(stop)], score]
                 for start, stop, score in merged]
    return np.asarray(anomalies)


def find_anomalies_batch(errors, index_list, window_size=None,
                         window_size_portion=None, window_step_size=None,
                         window_step_size_portion=None, min_percent=0.1,
                         anomaly_padding=50, lower_threshold=False,
                         fixed_threshold=None):
    """:func:`find_anomalies` over each row of ``errors`` (C, T), the cells
    of one grid sharing the score length; JAX's signature. ``index_list``
    is one timestamp index shared by every cell, or a length-C list or
    tuple of per-cell indexes (array-likes); a plain list of scalar
    timestamps is one shared index, as JAX tells them apart. Returns a
    list of C interval arrays."""
    if not fixed_threshold:
        raise NotImplementedError(_DYNAMIC)
    E = np.asarray(errors, dtype=np.float64)
    if E.ndim != 2:
        raise ValueError(f"errors must be (C, T), got shape {E.shape}")
    shared = not (isinstance(index_list, (list, tuple))
                  and len(index_list) == len(E)
                  and all(np.ndim(e) >= 1 for e in index_list))
    return [find_anomalies(
                row, index_list if shared else index_list[c],
                window_size=window_size,
                window_size_portion=window_size_portion,
                window_step_size=window_step_size,
                window_step_size_portion=window_step_size_portion,
                min_percent=min_percent, anomaly_padding=anomaly_padding,
                lower_threshold=lower_threshold, fixed_threshold=True)
            for c, row in enumerate(E)]
