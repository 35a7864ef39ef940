"""Multivariate dataset loaders (SWaT, WADI and the CASAS family).

Port of ``hypad_tpu.data.multivariate``. Each example is ONE timestep's
feature vector (no windowing), so a multivariate model's ``signal_shape``
is the feature count (SWaT 51, WADI 123, CASAS 150). SWaT and WADI come as
CSVs, read as ``pandas.read_csv`` reads them (``data/pipeline.py``'s
``read_csv_columns`` / ``numeric_column``: the card's machine has no
pandas) with their meta columns dropped, then mean-imputed and min-max
scaled to (-1, 1) per column in float64. The CASAS family comes as torch
``.pt`` tensors reshaped to (-1, 150) and scaled without imputation.

Reference quirks kept: the CASAS branches load the ground truth for both
splits (only the test copy is read); the ``CASAS_`` branch drops the first
4,500 timesteps, carves the test span as [first anomaly - 1,000, last
anomaly + 1,000) and scales nothing; ``new_CASAS`` scales each split on its
own. The CASAS corpora are not distributed with the reference; a missing
file raises ``FileNotFoundError`` naming it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hypad_tpu_torch.data.pipeline import (
    impute_mean,
    minmax_scale,
    numeric_column,
    read_csv_columns,
)

CASAS_FEATURES = 150


class MultivariateData:
    """A preprocessed multivariate stream: X (N, F) float32 and the ground
    truth y (per timestep, or None). ``X_device`` is a copy of ``X`` on
    the card, set by whoever uploads it once (the CLI's ``train``)."""

    def __init__(self, X, y=None):
        self.X = np.asarray(X, dtype=np.float32)
        self.y = y
        self.X_index = np.arange(len(self.X))
        self.index = np.arange(len(self.X))
        self.known_anomalies = None
        self.X_device = None

    def __len__(self):
        return len(self.X)


def read_feature_csv(path, drop=(), index_col=False):
    """The numeric columns of a CSV as one (rows, columns) float64 array,
    as ``pd.read_csv(path, index_col=0 if index_col else None)
    .drop(list(drop), axis=1).values`` gives them: the first column is the
    index under ``index_col``; a dropped column that is not there raises
    KeyError, as pandas' ``drop`` does."""
    cols = read_csv_columns(path)
    names = list(cols)[1:] if index_col else list(cols)
    missing = [name for name in drop if name not in names]
    if missing:
        raise KeyError(f"{missing} not found in the columns of {path}")
    keep = [name for name in names if name not in drop]
    return np.column_stack([numeric_column(cols[name]) for name in keep]
                           ).astype(np.float64)


def _load_pt(path):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"multivariate tensor {path} not found — the CASAS-family "
            "corpora are not shipped with the reference; point data_root "
            "at a copy")
    return np.asarray(torch.load(path, weights_only=False))


def _scale(X):
    """Mean imputation, then (-1, 1) min-max scaling, in float64 (the
    SWaT / WADI preprocessing)."""
    return minmax_scale(impute_mean(np.asarray(X, dtype=np.float64)))


def _scale_only(X):
    """(-1, 1) min-max scaling without imputation (the CASAS-family .pt
    branches): a NaN stays NaN and makes its column's scale NaN, as
    sklearn's scaler does."""
    return minmax_scale(np.asarray(X, dtype=np.float64))


def load_swat(data_root, test):
    """``SWAT/SWaT_{train,test}_mine.csv``: the first column is the index;
    ``Timestamp``, ``Normal/Attack`` and the test's ``label`` are
    dropped."""
    name, drop = (("SWaT_test_mine.csv", ("Timestamp", "Normal/Attack",
                                          "label")) if test else
                  ("SWaT_train_mine.csv", ("Timestamp", "Normal/Attack")))
    return MultivariateData(_scale(read_feature_csv(
        os.path.join(data_root, "SWAT", name), drop, index_col=True)))


def load_wadi(data_root, test):
    """``WADI_downsampled/WADI_train.csv`` (every column a feature) and
    ``WADI_test_mine.csv`` (``Time`` and ``label`` dropped)."""
    base = os.path.join(data_root, "WADI_downsampled")
    if test:
        X = read_feature_csv(os.path.join(base, "WADI_test_mine.csv"),
                             ("Time", "label"))
    else:
        X = read_feature_csv(os.path.join(base, "WADI_train.csv"))
    return MultivariateData(_scale(X))


def load_casas_family(params, data_root, test):
    """CASAS / ELINUS / eHealth ``.pt`` tensors: the normal sequences
    (train) or one point's sequences (test), reshaped to (-1, 150) and
    scaled; the point's ground truth for both splits."""
    ds, sig = params.dataset, params.signal
    base = os.path.join(data_root, "DATASETS", ds)
    if not getattr(params, "new_features", False):
        seq = os.path.join(base, "normal_sequences.pt")
        points = os.path.join(base, "POINTS", sig)
        seq_test = os.path.join(points, f"{sig}_sequences_id{params.id}.pt")
        gt = os.path.join(points, f"{sig}_groundtruth_id{params.id}.pt")
    else:
        seq = os.path.join(base, "normal_sequences_newfeatures.pt")
        points = os.path.join(base, "POINTS_NEWFEATURES")
        seq_test = os.path.join(points, f"{sig}_sequences_newfeatures.pt")
        gt = os.path.join(points, f"{sig}_groundtruth_newfeatures.pt")
    X = _load_pt(seq_test if test else seq).reshape(-1, CASAS_FEATURES)
    return MultivariateData(_scale_only(X), y=_load_pt(gt))


def _load_casas_carved(params, data_root):
    """The ``CASAS_`` branch: the two-week tensors (or ``seq_path`` /
    ``gt_path``), the first 4,500 timesteps dropped, the test span
    [first anomaly - 1,000, last anomaly + 1,000), train everything before
    it; no scaling."""
    base = os.path.join(data_root, "CASAS_")
    seq = _load_pt(getattr(params, "seq_path", None) or os.path.join(
        base, f"sequences_2week_{params.signal}.pt"))
    gt = _load_pt(getattr(params, "gt_path", None) or os.path.join(
        base, f"ground_truth_2week_{params.signal}.pt"))
    X = seq.reshape(seq.shape[0] * seq.shape[1], -1)[4500:]
    y = gt.reshape(gt.shape[0] * gt.shape[1], -1)[4500:]
    anom = np.where(y == 1)[0]
    init, end = anom[0] - 1000, anom[-1] + 1000
    return (MultivariateData(X[:init].reshape(-1, CASAS_FEATURES),
                             y=y[:init]),
            MultivariateData(X[init:end].reshape(-1, CASAS_FEATURES),
                             y=y[init:end]))


def _load_new_casas(params, data_root):
    """The ``new_CASAS`` branch: ``CASAS/new_dataset/{signal}/x_train``,
    ``y_train``, ``x_test``, ``y_test`` (saved without an extension), each
    split scaled on its own."""
    base = os.path.join(data_root, "CASAS", "new_dataset", params.signal)

    def split(x, y):
        return MultivariateData(
            _scale_only(_load_pt(os.path.join(base, x))
                        .reshape(-1, CASAS_FEATURES)),
            y=_load_pt(os.path.join(base, y)))

    return split("x_train", "y_train"), split("x_test", "y_test")


def load_multivariate(params, data_root):
    """(train, test, read_path) of the multivariate dataset
    ``params.dataset``, as the registry returns them; read_path is
    empty."""
    ds = params.dataset
    if ds == "SWAT":
        return load_swat(data_root, False), load_swat(data_root, True), ""
    if ds == "WADI":
        return load_wadi(data_root, False), load_wadi(data_root, True), ""
    if ds in ("CASAS", "ELINUS", "eHealth"):
        return (load_casas_family(params, data_root, False),
                load_casas_family(params, data_root, True), "")
    if ds == "CASAS_":
        return (*_load_casas_carved(params, data_root), "")
    if ds == "new_CASAS":
        return (*_load_new_casas(params, data_root), "")
    raise ValueError(f"unsupported multivariate dataset {ds!r}")


def casas_anomalies(y, x_index):
    """Ground-truth runs of a per-timestep label ``y`` -> (k, 2) start, end
    array. A run ends at ``x_index`` of its last index minus one (the
    reference's off-by-one, which wraps to the last entry for a run of one
    at index 0), and a run reaching the last sample is dropped: the
    reference closes a run only on a following zero."""
    y = np.asarray(y).reshape(-1)[: len(x_index)]
    records = []
    start = last = None
    for i, v in enumerate(y):
        if v == 1:
            if start is None:
                start = x_index[i]
            last = i
        elif start is not None:
            records.append((start, x_index[last - 1]))
            start = last = None
    return np.asarray(records, dtype=np.asarray(x_index).dtype).reshape(-1, 2)
