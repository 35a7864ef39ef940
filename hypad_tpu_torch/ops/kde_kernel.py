"""KDE argmax through the hand-written CUDA kernels ``csrc/kde_argmax.cu``
(K2) and ``csrc/kde_argmax_v2.cu`` (K3).

Counterpart of ``hypad_tpu.ops.kde_pallas.kde_argmax_rows_pallas``: each
kernel emits each row's density-argmax sample and its use flag; the
masked-median fallback, which needs a sort, stays outside the kernels. K2
replaces the Pallas v1 kernel (``hypad_tpu/ops/kde_pallas.py:42``), which
sums the full (W, W) pair tensor; K3 replaces v2 (``:91``), which computes
each symmetric pair's exp once. On a CUDA tensor a wrapper launches its
kernel (or raises); on a CPU tensor it runs the plain version,
``hypad_tpu_torch.ops.kde.kde_argmax_rows_parts`` or
``kde_argmax_rows_v2_parts``.

A kernel's densities agree with its plain version's to within ulps, so
where densities tie to the last bits the argmax may pick another sample of
the same row: the two agree at tie level, as K2 and K3 do with each other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hypad_tpu_torch.ops.kde import (
    kde_argmax_rows_parts,
    kde_argmax_rows_v2_parts,
)
from hypad_tpu_torch.ops.unroll import masked_median

MAX_WIDTH = 128  # widest row either kernel takes (csrc/kde_row.cuh)
KDE_VERSIONS = ("v1", "v2")


def _check(vals, mask, name):
    if vals.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"{name}: expected float32 vals and bool mask, got "
                        f"{vals.dtype} and {mask.dtype}")
    if vals.dim() != 2 or mask.shape != vals.shape:
        raise ValueError(f"{name}: expected vals and mask of one (T, W) "
                         f"shape, got {tuple(vals.shape)} and "
                         f"{tuple(mask.shape)}")
    if mask.device != vals.device:
        raise ValueError(f"{name}: mask on {mask.device}, vals on "
                         f"{vals.device}")
    if not (vals.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{name}: vals and mask must be contiguous")
    if not 1 <= vals.shape[1] <= MAX_WIDTH:
        raise ValueError(f"{name}: row width must be in [1, {MAX_WIDTH}], "
                         f"got {vals.shape[1]}")


@functools.cache
def _lib(source, symbol):
    from hypad_tpu_torch import _build

    fn = getattr(_build.load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(source, symbol, vals, mask):
    """Launch ``symbol`` of ``csrc/<source>.cu`` on CUDA tensors; returns
    (kde_val, use). Raises on an unsupported device or a CUDA error."""
    if vals.device.type != "cuda":
        raise ValueError(f"{symbol}: unsupported device {vals.device}")
    T, W = vals.shape
    kde_val = torch.empty(T, dtype=torch.float32, device=vals.device)
    use = torch.empty(T, dtype=torch.bool, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib(source, symbol)(vals.data_ptr(), mask.data_ptr(),
                                   kde_val.data_ptr(), use.data_ptr(), T, W,
                                   stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return kde_val, use


def kde_argmax_kernel(vals, mask):
    """(kde_val (T,) float32, use_kde (T,) bool) of each row: through
    ``csrc/kde_argmax.cu`` (K2) for CUDA tensors, through the plain
    :func:`kde_argmax_rows_parts` for CPU tensors."""
    _check(vals, mask, "kde_argmax_kernel")
    if vals.device.type == "cpu":
        return kde_argmax_rows_parts(vals, mask)
    out = _launch("kde_argmax", "kde_argmax_forward", vals, mask)
    kde_argmax_kernel.launches += 1
    return out


kde_argmax_kernel.launches = 0


def kde_argmax_v2_kernel(vals, mask):
    """(kde_val (T,) float32, use_kde (T,) bool) of each row, one exp per
    symmetric pair: through ``csrc/kde_argmax_v2.cu`` (K3) for CUDA tensors,
    through the plain :func:`kde_argmax_rows_v2_parts` for CPU tensors."""
    _check(vals, mask, "kde_argmax_v2_kernel")
    if vals.device.type == "cpu":
        return kde_argmax_rows_v2_parts(vals, mask)
    out = _launch("kde_argmax_v2", "kde_argmax_v2_forward", vals, mask)
    kde_argmax_v2_kernel.launches += 1
    return out


kde_argmax_v2_kernel.launches = 0


def kde_argmax_rows_fused(vals, mask, version="v1"):
    """Per-row KDE-argmax sample with the masked-median fallback outside the
    kernel. ``version`` picks the kernel as JAX's
    ``kde_argmax_rows_pallas(version=...)`` does: "v1" K2, "v2" K3. vals
    (T, W) float32, mask (T, W) bool -> (T,)."""
    if version == "v1":
        kde_val, use_kde = kde_argmax_kernel(vals, mask)
    elif version == "v2":
        kde_val, use_kde = kde_argmax_v2_kernel(vals, mask)
    else:
        raise ValueError(f"unknown kde_version {version!r}; expected one of "
                         f"{KDE_VERSIONS}")
    return torch.where(use_kde, kde_val, masked_median(vals, mask))
