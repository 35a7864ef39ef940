"""Univariate detection: scores -> intervals -> metrics.

Port of the univariate path of ``hypad_tpu.detect.detector.detect``: the
scorer (hyperbolic or Euclidean), fixed-threshold interval extraction with
the reference's univariate parameters over the signal's whole timeline, and
the contextual confusion matrix and F1. Artifact persistence, results CSVs,
plots and ``load: true`` re-scoring are not ported.
"""

from __future__ import annotations

import numpy as np

from hypad_tpu_torch.detect import intervals as iv
from hypad_tpu_torch.detect import metrics as mt
from hypad_tpu_torch.detect.scorer import detect_scores

# univariate interval extraction: 0.33/0.1 threshold windows, fixed threshold
_UNIVARIATE_FA_KW = dict(window_size_portion=0.33,
                         window_step_size_portion=0.1, fixed_threshold=True)


def _confusion_and_metrics(known_anomalies, pred, verbose=True):
    """Confusion matrix and metrics; no predictions or no ground truth
    leaves the metrics undefined (None), as in the reference detector."""
    confusion = mt.contextual_confusion_matrix(known_anomalies, pred)
    try:
        return confusion, mt.metrics_from_confusion(confusion,
                                                    verbose=verbose)
    except ZeroDivisionError:
        return (0, 0, 0, 0), None


def detect_univariate(model, X, index, known_anomalies, combination="mult",
                      hyperbolic=True, rec_error="point", kde_version="v1",
                      device="cuda", verbose=False):
    """Detect anomalies in the (N, W) windows ``X`` of one univariate
    signal with ``model`` (on ``device``), hyperbolic or Euclidean.

    ``index``: the aggregated timeline (N + W entries from the pipeline)
    that maps score positions to timestamps: the hyperbolic scores cover
    its first N, the Euclidean scores N + W - 1. ``known_anomalies``:
    ground-truth (start, end) pairs, a list or a (k, 2) array.
    ``rec_error`` (point, area, dtw) applies to the Euclidean scores;
    ``kde_version`` picks the KDE kernel, "v1" (K2) or "v2" (K3). Returns a
    dict with the scores, the intervals ((k, 3) start, end, score), the
    confusion matrix (tn, fp, fn, tp) and the metrics (None when
    undefined)."""
    scores, _ = detect_scores(model, X, hyperbolic, combination,
                              rec_error=rec_error, fetch_inference=False,
                              kde_version=kde_version, device=device)
    intervals = iv.find_anomalies(scores.reshape(-1), np.asarray(index),
                                  **_UNIVARIATE_FA_KW)
    confusion, metrics = _confusion_and_metrics(known_anomalies, intervals,
                                                verbose=verbose)
    return {"scores": scores, "intervals": intervals, "confusion": confusion,
            "metrics": metrics}
