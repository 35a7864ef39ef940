"""Detection: scores -> intervals -> metrics -> files.

Port of ``hypad_tpu.detect.detector``:

* :func:`detect`, the CLI's detection: ground truth (a Yahoo signal's own
  runs, a multivariate stream's label runs (``casas_anomalies``), else
  ``anomalies.csv``), the one-call scorer with the inference
  artifacts saved (or, under ``load: true``, the cached artifacts staged
  on the device once and the scores cached per variant), fixed-threshold
  intervals over the signal's whole timeline (0.33 / 0.1 threshold
  windows), or for a multivariate config over the N timesteps (0.2 / 0.1
  windows, anomaly padding 200), ``anomalies.csv``, the contextual
  confusion matrix and F1, and the cumulative results CSV under
  ``output_root/results/``;
* :func:`detect_grid`: every (rec_error x combination) cell from one
  forward pass, intervals for all cells at once, ``grid_results.csv``;
* :func:`detect_univariate`: the same scores -> intervals -> metrics on
  arrays, without files.

Both take JAX's ``mesh`` (``parallel/mesh.py``): the forward and the
scoring stages run sharded over its ``dp`` devices (``detect/scorer.py``),
and ``model`` lies on its lead device.

A config is multivariate as JAX's detector decides it (``signal:
multivariate``, or a dataset of the multivariate family). The CSV files
keep pandas' ``to_csv`` layouts, written with ``csv``. ``save_plots`` is
JAX's: None plots a multivariate run and not a univariate one, True and
False override that; the plot is ``anomalies.png`` in the run directory
(``utils.plotting.plot_anomaly_intervals``: the scores over the timeline,
the predicted intervals red, the ground truth green), and where matplotlib
cannot be imported JAX's skip line is printed instead.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.data.multivariate import casas_anomalies
from hypad_tpu_torch.data.pipeline import load_anomalies, write_intervals_csv
from hypad_tpu_torch.data.registry import YAHOO_DATASETS, is_multivariate
from hypad_tpu_torch.detect import intervals as iv
from hypad_tpu_torch.detect import metrics as mt
from hypad_tpu_torch.detect import scorer as sc
from hypad_tpu_torch.utils import artifacts

# interval extraction, fixed threshold: univariate 0.33/0.1 threshold
# windows; multivariate 0.2/0.1 windows with anomaly padding 200
_UNIVARIATE_FA_KW = dict(window_size_portion=0.33,
                         window_step_size_portion=0.1, fixed_threshold=True)
_MV_FA_KW = dict(window_size_portion=0.2, window_step_size_portion=0.1,
                 fixed_threshold=True, anomaly_padding=200)
_PLOT_SKIPPED = ("save_plots requested but matplotlib is not installed "
                 "(pip install 'hypad-tpu[plots]'); skipping plot")


def _confusion_and_metrics(known_anomalies, pred, verbose=True):
    """Confusion matrix and metrics; no predictions or no ground truth
    leaves the metrics undefined (None) and the confusion (0, 0, 0, 0), as
    in the reference detector."""
    try:
        confusion = mt.contextual_confusion_matrix(known_anomalies, pred)
        return confusion, mt.metrics_from_confusion(confusion,
                                                    verbose=verbose)
    except ZeroDivisionError:
        return (0, 0, 0, 0), None


def _intervals(scores, true_index, multivariate):
    """Intervals of one signal's scores: per timestep (positions 0..N-1)
    multivariate, over ``true_index`` univariate."""
    scores = np.asarray(scores).reshape(-1)
    if multivariate:
        return iv.find_anomalies(scores, np.arange(len(scores)), **_MV_FA_KW)
    return iv.find_anomalies(scores, true_index, **_UNIVARIATE_FA_KW)


def _multivariate_ground_truth(test_data):
    """The label runs of a multivariate test stream (``casas_anomalies``,
    its off-by-one end and dropped trailing run kept); none for a stream
    without labels (SWaT, WADI)."""
    y = getattr(test_data, "y", None)
    if y is None:
        return np.zeros((0, 2), np.int64)
    y = np.asarray(y).reshape(-1)[: len(test_data.X)]
    return casas_anomalies(y, np.arange(len(y)))


def _ground_truth(params, test_data, known_anomalies):
    if known_anomalies is not None:
        return known_anomalies
    if is_multivariate(params):
        return _multivariate_ground_truth(test_data)
    if params.dataset in YAHOO_DATASETS:
        return test_data.known_anomalies
    return load_anomalies(params.signal, params.data_root)


def _windows_on_device(test_data, device):
    """The test windows on ``device``, uploaded once and kept on the
    dataset (the CLI's ``train`` has already put them there when one CSV
    trains and tests); None above the one-call limit, where the scorer
    runs chunks from the host array."""
    X_dev = test_data.X_device
    if X_dev is not None and X_dev.device == device:
        return X_dev
    if len(test_data.X) > sc.ONE_CALL_MAX_WINDOWS:
        return None
    X_dev = torch.as_tensor(np.asarray(test_data.X, np.float32),
                            device=device)
    test_data.X_device = X_dev
    return X_dev


def detect(params, model, test_data, run_path, known_anomalies=None,
           save_plots=None, mesh=None, precomputed_scores=None,
           device="cuda"):
    """Detection of the config ``params`` with ``model`` (on ``device``) on
    ``test_data`` (a ``SignalData``, or a ``MultivariateData`` for a
    multivariate config), writing into ``run_path``. Returns
    {"scores", "intervals", "confusion", "metrics"} (metrics None when
    undefined). The KDE kernel follows ``HYPAD_KDE_PALLAS``. ``save_plots``:
    None plots a multivariate run only, True or False decide.

    ``precomputed_scores``: the signal's final scores computed elsewhere
    (``detect_scores_fleet`` of a sweep): no device work runs, only the
    epilogue (intervals, anomalies.csv, metrics, the results CSV); no
    inference artifact is written."""
    mv = is_multivariate(params)
    device = resolve_device(device, mesh)
    kde_version = sc.kde_version_from_env()
    os.makedirs(run_path, exist_ok=True)
    known_anomalies = _ground_truth(params, test_data, known_anomalies)
    if precomputed_scores is not None:
        final_scores = np.asarray(precomputed_scores)
        true_index = np.asarray(test_data.index)
        return _epilogue(params, final_scores,
                         _intervals(final_scores, true_index, mv),
                         known_anomalies, run_path, save_plots, mv,
                         true_index)

    one_call_scores = None
    save_artifacts = getattr(params, "save_artifacts", True) or params.load
    cached = artifacts.load_inference(run_path) if params.load else None
    if cached is not None:
        inference, true_index = cached
        inference = sc.stage_inference(inference, device, mesh=mesh)
    else:
        X_dev = _windows_on_device(test_data, device)
        one_call_scores, inference = sc.detect_scores(
            model, test_data.X if X_dev is None else X_dev,
            params.hyperbolic, params.combination, rec_error=params.rec_error,
            mesh=mesh, fetch_inference=save_artifacts, kde_version=kde_version,
            device=device,
            artifact_dtype=getattr(params, "artifact_dtype", "float32"),
            artifact_set=getattr(params, "artifact_set", "full"),
            multivariate=mv)
        # the whole aggregated timeline (N + W entries) maps the T = N + W
        # - 1 unrolled score positions to timestamps
        true_index = np.asarray(test_data.index)
        if save_artifacts:
            artifacts.save_inference(run_path, inference, true_index)

    # the scores are cached per variant under load: true, JAX's file names
    def compute():
        if one_call_scores is not None:
            return one_call_scores
        if mv:
            return sc.score_anomalies_multivariate(
                inference, params.combination, params.hyperbolic, mesh,
                kde_version, device)
        if params.hyperbolic:
            return sc.score_anomalies_hyperbolic(
                inference, params.combination, mesh, kde_version, device)
        return sc.score_anomalies_euclidean(
            inference.true_signal, inference.recons_signal,
            inference.critic_score, params.rec_error, params.combination,
            mesh=mesh, kde_version=kde_version, device=device)

    cache_key = (f"scores_mv_{params.combination}" if mv else
                 f"scores_hyper_{params.combination}" if params.hyperbolic
                 else f"scores_eucl_{params.rec_error}_{params.combination}")
    final_scores = artifacts.cache_scores(run_path, cache_key, compute,
                                          enabled=params.load)
    intervals = _intervals(final_scores, true_index, mv)
    return _epilogue(params, final_scores, intervals, known_anomalies,
                     run_path, save_plots, mv, true_index)


def _epilogue(params, final_scores, intervals, known_anomalies, run_path,
              save_plots, mv, true_index):
    """anomalies.csv, the confusion and metrics, the results CSV row and,
    where ``save_plots`` asks (None: a multivariate run), the plot."""
    write_intervals_csv(os.path.join(run_path, "anomalies.csv"), intervals,
                        ("start", "end", "score"))
    confusion, metrics = _confusion_and_metrics(known_anomalies, intervals)
    if params.save_result:
        _append_results_csv(params, confusion)
    if mv if save_plots is None else save_plots:
        _plot(final_scores, intervals, known_anomalies, run_path,
              np.arange(len(final_scores)) if mv else true_index)
    return {"scores": np.asarray(final_scores), "intervals": intervals,
            "confusion": confusion, "metrics": metrics}


def _plot(final_scores, intervals, known_anomalies, run_path, x_index):
    """``anomalies.png`` in ``run_path``, as JAX's detector draws it; JAX's
    skip line where matplotlib cannot be imported."""
    from hypad_tpu_torch.utils.plotting import plot_anomaly_intervals

    known = ([known_anomalies] if known_anomalies is not None
             and len(known_anomalies) else [])
    try:
        plot_anomaly_intervals([intervals] + known, x_index,
                               np.asarray(final_scores), run_path)
    except ImportError:  # matplotlib is the optional 'plots' extra
        print(_PLOT_SKIPPED)


def _write_rows(path, rows):
    """``rows`` (dicts) as ``DataFrame(rows).to_csv(path, index=False)``
    writes them: the columns in order of first appearance, None and
    missing keys as empty fields."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for row in rows:
            w.writerow(["" if row.get(k) is None else row[k]
                        for k in columns])


def detect_grid(params, model, test_data, run_path, rec_errors=None,
                combinations=None, known_anomalies=None, mesh=None,
                precomputed_grid=None, device="cuda"):
    """Every (rec_error x combination) cell of the config's signal from one
    forward pass (:func:`scorer.detect_scores_grid`), the intervals of all
    cells in one batch, each cell's confusion and metrics, and
    ``grid_results.csv`` in ``run_path``. Returns {(rec_error or None,
    combination): result dict as :func:`detect` gives}; a multivariate
    config's cells are scored and thresholded per timestep.

    ``precomputed_grid``: the signal's ``{(rec_error or None, combination):
    scores}`` computed elsewhere (its slice of
    ``scorer.detect_scores_fleet_grid``, as ``sweep`` with the grid flags
    passes it): no device work runs, only the rest."""
    mv = is_multivariate(params)
    device = resolve_device(device, mesh)
    os.makedirs(run_path, exist_ok=True)
    known_anomalies = _ground_truth(params, test_data, known_anomalies)
    combinations = combinations or [params.combination]
    rec_errors = rec_errors or [params.rec_error]

    if precomputed_grid is not None:
        grid = precomputed_grid
    else:
        X_dev = _windows_on_device(test_data, device)
        grid = sc.detect_scores_grid(
            model, test_data.X if X_dev is None else X_dev,
            params.hyperbolic, combinations, rec_errors=rec_errors,
            mesh=mesh, kde_version=sc.kde_version_from_env(), device=device,
            multivariate=mv)
    cells = list(grid)
    score_matrix = np.stack([np.asarray(grid[c]).reshape(-1)
                             for c in cells])
    if mv:
        all_intervals = iv.find_anomalies_batch(
            score_matrix, np.arange(score_matrix.shape[1]), **_MV_FA_KW)
    else:
        all_intervals = iv.find_anomalies_batch(
            score_matrix, np.asarray(test_data.index), **_UNIVARIATE_FA_KW)

    rows, results = [], {}
    for (re_, cb), scores, intervals in zip(cells, score_matrix,
                                            all_intervals):
        confusion, metrics = _confusion_and_metrics(
            known_anomalies, intervals, verbose=False)
        results[(re_, cb)] = {"scores": scores, "intervals": intervals,
                              "confusion": confusion, "metrics": metrics}
        m = metrics or {}
        rows.append({"rec_error": re_ or "", "combination": cb,
                     "tn": confusion[0], "fp": confusion[1],
                     "fn": confusion[2], "tp": confusion[3],
                     **{k: round(float(m[k]), 6) for k in
                        ("precision", "recall", "f1", "gmean") if k in m}})
        cell = cb if re_ is None else f"{re_}/{cb}"
        f1 = f"f1={m['f1']:.4f}" if "f1" in m else "no metrics"
        print(f"[grid] {cell}: {f1} "
              f"(tp={confusion[3]} fp={confusion[1]} fn={confusion[2]})")
    _write_rows(os.path.join(run_path, "grid_results.csv"), rows)
    return results


def _append_results_csv(params, confusion):
    """Add ``signal,tn,fp,fn,tp`` to ``output_root/results/{filename or
    results.csv}`` unless the signal already has a row."""
    results_dir = os.path.join(params.output_root, "results")
    os.makedirs(results_dir, exist_ok=True)
    file_place = os.path.join(results_dir, params.filename or "results.csv")
    header, rows = ["signal", "tn", "fp", "fn", "tp"], []
    if os.path.isfile(file_place):
        with open(file_place, newline="") as f:
            header, *rows = list(csv.reader(f))
    if params.signal in [row[header.index("signal")] for row in rows]:
        return
    rows.append([params.signal, *("" if v is None else v
                                  for v in confusion)])
    with open(file_place, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


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
    scores, _ = sc.detect_scores(model, X, hyperbolic, combination,
                                 rec_error=rec_error, fetch_inference=False,
                                 kde_version=kde_version, device=device)
    intervals = _intervals(scores, np.asarray(index), False)
    confusion, metrics = _confusion_and_metrics(known_anomalies, intervals,
                                                verbose=verbose)
    return {"scores": scores, "intervals": intervals, "confusion": confusion,
            "metrics": metrics}
