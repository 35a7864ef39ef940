"""KDE argmax through the hand-written CUDA kernel ``csrc/kde_argmax.cu``.

Counterpart of ``hypad_tpu.ops.kde_pallas.kde_argmax_rows_pallas``: the
kernel (replacing the Pallas v1 kernel ``hypad_tpu/ops/kde_pallas.py:42``)
emits each row's density-argmax sample and its use flag; the masked-median
fallback, which needs a sort, stays outside the kernel. On a CUDA tensor the
wrapper launches the kernel (or raises); on a CPU tensor it runs the plain
version, ``hypad_tpu_torch.ops.kde.kde_argmax_rows_parts``.

The kernel's densities agree with the plain version's to within ulps (the
two sum in different orders), so where densities tie to the last bits the
argmax may pick another sample of the same row: the two agree at tie level.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hypad_tpu_torch.ops.kde import kde_argmax_rows_parts
from hypad_tpu_torch.ops.unroll import masked_median

MAX_WIDTH = 128  # widest row the kernel takes (csrc/kde_argmax.cu)


def _check(vals, mask):
    if vals.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("kde_argmax_kernel: expected float32 vals and bool "
                        f"mask, got {vals.dtype} and {mask.dtype}")
    if vals.dim() != 2 or mask.shape != vals.shape:
        raise ValueError("kde_argmax_kernel: expected vals and mask of one "
                         f"(T, W) shape, got {tuple(vals.shape)} and "
                         f"{tuple(mask.shape)}")
    if mask.device != vals.device:
        raise ValueError(f"kde_argmax_kernel: mask on {mask.device}, vals on "
                         f"{vals.device}")
    if not (vals.is_contiguous() and mask.is_contiguous()):
        raise ValueError("kde_argmax_kernel: vals and mask must be "
                         "contiguous")
    if not 1 <= vals.shape[1] <= MAX_WIDTH:
        raise ValueError(f"kde_argmax_kernel: row width must be in "
                         f"[1, {MAX_WIDTH}], got {vals.shape[1]}")


@functools.cache
def _lib():
    from hypad_tpu_torch import _build

    fn = _build.load("kde_argmax").kde_argmax_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kde_argmax_kernel(vals, mask):
    """(kde_val (T,) float32, use_kde (T,) bool) of each row: through
    ``csrc/kde_argmax.cu`` for CUDA tensors, through the plain
    :func:`kde_argmax_rows_parts` for CPU tensors."""
    _check(vals, mask)
    if vals.device.type == "cpu":
        return kde_argmax_rows_parts(vals, mask)
    if vals.device.type != "cuda":
        raise ValueError(f"kde_argmax_kernel: unsupported device "
                         f"{vals.device}")
    T, W = vals.shape
    kde_val = torch.empty(T, dtype=torch.float32, device=vals.device)
    use = torch.empty(T, dtype=torch.bool, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(vals.data_ptr(), mask.data_ptr(), kde_val.data_ptr(),
                     use.data_ptr(), T, W, stream)
    if err != 0:
        raise RuntimeError(f"kde_argmax_forward failed: CUDA error {err}")
    kde_argmax_kernel.launches += 1
    return kde_val, use


kde_argmax_kernel.launches = 0


def kde_argmax_rows_fused(vals, mask):
    """Per-row KDE-argmax sample with the masked-median fallback outside the
    kernel; on CPU tensors the same as :func:`kde_argmax_rows`. vals (T, W)
    float32, mask (T, W) bool -> (T,)."""
    kde_val, use_kde = kde_argmax_kernel(vals, mask)
    return torch.where(use_kde, kde_val, masked_median(vals, mask))
