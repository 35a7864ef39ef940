"""Auxiliary detector utilities: a port of ``hypad_tpu.detect.extra``.

The reference detector module's alternative (TadGAN-paper) path, for users
migrating code that calls it; host numpy, as in JAX:

* ``ewma``: pandas' ``Series.ewm(span=span).mean()`` as two single-pole
  filters (``scipy.signal.lfilter``, imported where it is called);
* ``regression_errors`` (reference utils/anomaly_detection_utils.py:730-
  758): |y - y_hat| of the first column with EWMA smoothing;
* ``detect_anomaly`` (:710-727): the 3-sigma sliding-window flagger, with
  the reference's std of a scalar kept (every point off the window mean is
  flagged);
* ``prune_false_positive`` (:657-707): drop anomalous runs whose max score
  is not far enough above the next one's, with the reference's run
  bookkeeping kept.
"""

from __future__ import annotations

import numpy as np


def ewma(x, span):
    """pandas Series.ewm(span=span, adjust=True).mean():
    y_t = sum_i (1-a)^i x_{t-i} / sum_i (1-a)^i with a = 2/(span+1).

    Computed as two single-pole IIR filters (scipy.signal.lfilter runs the
    recurrence acc <- acc*decay + x in C): numerically stable like the scan
    form (no 0^n underflow of the closed form) but O(n) vectorized — the
    50k-row multivariate aux path stays in the milliseconds."""
    from scipy.signal import lfilter

    x = np.asarray(x, dtype=np.float64)
    alpha = 2.0 / (span + 1.0)
    decay = 1.0 - alpha
    num = lfilter([1.0], [1.0, -decay], x)
    den = lfilter([1.0], [1.0, -decay], np.ones(len(x)))
    return num / den


def regression_errors(y, y_hat, smoothing_window=0.01, smooth=True):
    """Reference regression_errors (:730-758). y/y_hat: (N, >=1) arrays;
    errors from column 0, EWMA span = smoothing_window * len(y)."""
    y = np.asarray(y)
    y_hat = np.asarray(y_hat)
    errors = np.abs(y - y_hat)
    if errors.ndim > 1:
        errors = errors[:, 0]
    if not smooth:
        return errors
    span = int(smoothing_window * len(y))
    return ewma(errors, span)


def detect_anomaly(anomaly_score):
    """Reference detect_anomaly (:710-727) including its quirk:
    window_std = std(window_MEAN) == 0, so every point != window mean is
    flagged; faithfully reproduced."""
    anomaly_score = np.asarray(anomaly_score, dtype=np.float64)
    window_size = len(anomaly_score) // 3
    step_size = len(anomaly_score) // 30
    is_anomaly = np.zeros(len(anomaly_score))
    for i in range(0, len(anomaly_score) - window_size, step_size):
        window = anomaly_score[i:i + window_size]
        mean = window.mean()
        std = np.std(mean)  # reference: std of a scalar == 0 (quirk)
        inside = (mean - 3 * std < window) & (window < mean + 3 * std)
        is_anomaly[i:i + window_size] = np.where(inside, 0.0, 1.0)
    return is_anomaly


def prune_false_positive(is_anomaly, anomaly_score, change_threshold):
    """Reference prune_false_positive (:657-707): identify anomalous runs,
    rank their max scores descending and delete runs whose relative score
    drop vs the previous kept one is below change_threshold."""
    is_anomaly = np.asarray(is_anomaly).astype(int).copy()
    anomaly_score = np.asarray(anomaly_score, dtype=np.float64)

    seq_details = []
    start_position = 0
    max_seq_element = anomaly_score[0]
    for i in range(1, len(is_anomaly)):
        if i + 1 == len(is_anomaly):
            seq_details.append([start_position, i, max_seq_element, 0])
        elif is_anomaly[i] == 1 and is_anomaly[i + 1] == 0:
            seq_details.append([start_position, i, max_seq_element, 0])
        elif is_anomaly[i] == 1 and is_anomaly[i - 1] == 0:
            start_position = i
            max_seq_element = anomaly_score[i]
        if (is_anomaly[i] == 1 and is_anomaly[i - 1] == 1
                and anomaly_score[i] > max_seq_element):
            max_seq_element = anomaly_score[i]

    max_elements = sorted((s[2] for s in seq_details), reverse=True)
    max_elements = np.array(max_elements)
    if len(max_elements) > 1:
        change_percent = (np.abs(max_elements[1:] - max_elements[:-1])
                          / max_elements[1:])
        delete_seq = np.append([0], change_percent < change_threshold)
    else:
        delete_seq = np.zeros(len(max_elements))

    for i, max_elt in enumerate(max_elements):
        for seq in seq_details:
            if seq[2] == max_elt:
                seq[3] = delete_seq[i]

    for seq in seq_details:
        if seq[3] == 1:
            is_anomaly[seq[0]: seq[1] + 1] = 0
    return is_anomaly
