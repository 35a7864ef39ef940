"""Univariate hyperbolic detection: scores -> intervals -> metrics.

Port of the univariate path of ``hypad_tpu.detect.detector.detect``: the
one-call scorer, fixed-threshold interval extraction with the reference's
univariate parameters, and the contextual confusion matrix and F1. Artifact
persistence, results CSVs, plots and ``load: true`` re-scoring are not
ported.
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
                      device="cuda", verbose=False):
    """Detect anomalies in the (N, W) windows ``X`` of one univariate
    signal with the hyperbolic model ``model`` (on ``device``).

    ``index``: the aggregated timeline (at least N entries) that maps score
    positions to timestamps; ``known_anomalies``: ground-truth (start, end)
    pairs, a list or a (k, 2) array. Returns a dict with the scores (N,),
    the intervals ((k, 3) start, end, score), the confusion matrix
    (tn, fp, fn, tp) and the metrics (None when undefined)."""
    scores, _ = detect_scores(model, X, True, combination,
                              fetch_inference=False, device=device)
    intervals = iv.find_anomalies(scores.reshape(-1), np.asarray(index),
                                  **_UNIVARIATE_FA_KW)
    confusion, metrics = _confusion_and_metrics(known_anomalies, intervals,
                                                verbose=verbose)
    return {"scores": scores, "intervals": intervals, "confusion": confusion,
            "metrics": metrics}
