"""Evaluation: contextual (interval-overlap) confusion matrix and metrics.

A numpy-only copy of ``hypad_tpu.detect.metrics`` (the port imports
nothing of the JAX package): each ground-truth interval is a TP if any
predicted interval overlaps it (strict product test), else an FN;
predictions that overlap no ground truth are FPs; intervals are end-padded
by +1; TN is undefined (None).
"""

from __future__ import annotations

import numpy as np


def _pad(intervals):
    return [(part[0], part[1] + 1) for part in intervals]


def _overlap_segment(expected, observed):
    """(None, fp, fn, tp) from one pairwise overlap matrix; the overlap test
    is ``(e_start - o_end) * (e_end - o_start) < 0``."""
    if not expected or not observed:
        return None, len(observed), len(expected), 0
    exp = np.asarray(expected, dtype=np.float64)
    obs = np.asarray(observed, dtype=np.float64)
    ov = ((exp[:, 0, None] - obs[None, :, 1])
          * (exp[:, 1, None] - obs[None, :, 0]) < 0)
    tp = int(ov.any(axis=1).sum())
    fn = len(exp) - tp
    fp = int((~ov.any(axis=0)).sum())
    return None, fp, fn, tp


def _interval_rows(intervals):
    """A list of (start, end) pairs from a list of pairs or a (k, >=2)
    array (find_anomalies output; extra columns such as the score are
    ignored)."""
    if isinstance(intervals, list):
        return intervals
    intervals = np.asarray(intervals)
    return ([] if intervals.size == 0
            else [(row[0], row[1]) for row in intervals])


def contextual_confusion_matrix(expected, observed):
    """Returns (tn, fp, fn, tp); tn is always None for the overlap method
    (the unweighted segment evaluation)."""
    return _overlap_segment(_pad(_interval_rows(expected)),
                            _pad(_interval_rows(observed)))


def metrics_from_confusion(confusion, verbose=True):
    """Precision/recall/F1/gmean from an overlap confusion matrix. Raises
    ZeroDivisionError when there are no predictions or no ground truth."""
    tn, fp, fn, tp = confusion
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    f1 = 2 * (precision * recall) / (precision + recall)
    gmean = float(np.sqrt(precision * recall))
    if verbose:
        print(f"precision: {precision}, recall: {recall}")
        print(f"f1_score: {f1}, gmean: {gmean}")
    return {"tn": tn, "fp": fp, "fn": fn, "tp": tp,
            "precision": precision, "recall": recall, "f1": f1,
            "gmean": gmean}


def compute_metrics(known_anomalies, pred_anomalies, verbose=True):
    """Precision/recall/F1/gmean of predicted against known intervals."""
    return metrics_from_confusion(
        contextual_confusion_matrix(known_anomalies, pred_anomalies),
        verbose=verbose)
