"""The detection artifact cache: inference tensors and per-variant scores.

Port of ``hypad_tpu.utils.artifacts``. ``inference.npz`` holds the
inference tensors (``InferenceOutput``'s fields that are set, and
``true_index``) as an uncompressed zip of ``.npy`` members, the layout of
``np.savez``; scores are ``{name}.npy`` files beside it. With ``load:
true`` either package reads the other's files. Files are written through a
temporary file and ``os.replace``.
"""

from __future__ import annotations

import os

import numpy as np

from hypad_tpu_torch.detect.scorer import InferenceOutput

_FILE = "inference.npz"


def save_inference(path, out: InferenceOutput, true_index=None):
    """Write ``out``'s set fields (numpy arrays) and ``true_index`` to
    ``path/inference.npz``."""
    os.makedirs(path, exist_ok=True)
    members = {k: np.asarray(v) for k, v in out._asdict().items()
               if v is not None}
    if true_index is not None:
        members["true_index"] = np.asarray(true_index)
    final = os.path.join(path, _FILE)
    tmp = final + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **members)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_inference(path):
    """(InferenceOutput of numpy arrays, true_index or None), or None when
    ``path`` holds no ``inference.npz``."""
    f = os.path.join(path, _FILE)
    if not os.path.exists(f):
        return None
    with np.load(f) as data:
        fields = {k: data[k] for k in data.files if k != "true_index"}
        true_index = data["true_index"] if "true_index" in data.files else None
    return InferenceOutput(**fields), true_index


def cache_scores(path, name, compute_fn, enabled=True):
    """``path/{name}.npy`` if ``enabled`` and present; else
    ``compute_fn()``, saved there when ``enabled``. Returns numpy."""
    f = os.path.join(path, f"{name}.npy")
    if enabled and os.path.exists(f):
        return np.load(f)
    scores = np.asarray(compute_fn())
    if enabled:
        os.makedirs(path, exist_ok=True)
        np.save(f, scores)
    return scores
