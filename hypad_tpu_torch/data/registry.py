"""Dataset registry: a config -> (train, test, read path).

Port of ``hypad_tpu.data.registry`` ``dataset_selection``, over the
config's ``data_root``:

* a multivariate config (``signal: multivariate``, or a dataset of the
  SWaT / WADI / CASAS family): ``data/multivariate.py``'s loaders;
* ``unique_dataset: true``: ``{signal}.csv`` trains and tests (NAB style);
* dataset A1..A4: ``YAHOO/{dataset}Benchmark/{signal}.csv``, Yahoo
  preprocessing, interval 1;
* otherwise: ``{signal}-train.csv`` and ``{signal}-test.csv``.
"""

from __future__ import annotations

import os

from hypad_tpu_torch.data.multivariate import load_multivariate
from hypad_tpu_torch.data.pipeline import load_signal_dataset

YAHOO_DATASETS = ("A1", "A2", "A3", "A4")
MULTIVARIATE_DATASETS = ("CASAS_", "new_CASAS", "SWAT", "WADI", "CASAS",
                         "ELINUS", "eHealth")


def is_multivariate(params):
    """Whether ``params`` detects per timestep: JAX's detector dispatch
    (``signal: multivariate``, or a dataset of the multivariate family)."""
    return (params.signal == "multivariate"
            or params.dataset in MULTIVARIATE_DATASETS)


def dataset_selection(params, cache_dir=None):
    """(train_data, test_data, read_path) of the config ``params``; the
    test data is the train data's object where one CSV serves both."""
    data_root = getattr(params, "data_root", "./data")

    if params.dataset in MULTIVARIATE_DATASETS:
        return load_multivariate(params, data_root)

    if getattr(params, "unique_dataset", False):
        path = os.path.join(data_root, f"{params.signal}.csv")
        train = load_signal_dataset(path, interval=params.interval,
                                    cache_dir=cache_dir)
        return train, train, path

    if params.dataset in YAHOO_DATASETS:
        path = os.path.join(data_root, "YAHOO", f"{params.dataset}Benchmark",
                            f"{params.signal}.csv")
        train = load_signal_dataset(path, interval=1, yahoo=True,
                                    cache_dir=cache_dir)
        return train, train, path

    train_path = os.path.join(data_root, f"{params.signal}-train.csv")
    test_path = os.path.join(data_root, f"{params.signal}-test.csv")
    train = load_signal_dataset(train_path, interval=params.interval,
                                cache_dir=cache_dir)
    test = load_signal_dataset(test_path, interval=params.interval,
                               cache_dir=cache_dir)
    return train, test, test_path
