"""KDE argmax through the hand-written CUDA kernels of ``csrc/kde_argmax.cu``:
K2 (densities summed by sample) and K3 (summed by offset).

Counterpart of ``hypad_tpu.ops.kde_pallas.kde_argmax_rows_pallas``. K2
replaces the Pallas v1 kernel (``hypad_tpu/ops/kde_pallas.py:42``), K3 the
v2 kernel (``:91``), which computes each symmetric pair's exp once and sums
each density by offset. Each also replaces the masked-median fallback that
JAX takes outside the kernel (``:230-235``): it emits each row's final value
(the density-argmax sample, or the masked median where the KDE does not
apply) and its use flag, in one launch and with no sort. On a CUDA tensor a
wrapper launches its kernel (or raises); on a CPU tensor it runs the plain
version, ``hypad_tpu_torch.ops.kde.kde_argmax_rows_and_use`` or
``kde_argmax_rows_v2_and_use``.

Rows up to 128 wide go to each kernel's narrow instance, rows of 129 to 256
(multivariate feature counts) to its wide instance, wider rows to its
any-width instance (``.wide_launches`` and ``.xwide_launches`` count those
two); the wide and any-width instances of K2 and K3 are their group kernels
up to 4,096 columns (``kK3TriMaxW``) and their one-block-a-row kernels past
them. No width takes the plain version on the card.

A kernel's densities agree with its plain version's to within ulps (K2's
group kernels take each pair's term from the SFU's ``ex2``, within about
2^-22 of it), so where densities tie to the last bits the argmax may pick
another sample of the same row: the two agree at tie level, as K2 and K3
do with each other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hypad_tpu_torch import _build
from hypad_tpu_torch.ops.kde import (
    kde_argmax_rows_and_use,
    kde_argmax_rows_v2_and_use,
)

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
    if vals.shape[1] < 1:
        raise ValueError(f"{name}: row width must be at least 1, got "
                         f"{vals.shape[1]}")


def bind(lib, symbol):
    """The entry ``symbol`` of a library built from a KDE kernel source,
    with its argument types set."""
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib(source, symbol):
    return bind(_build.load(source), symbol)


def launch_with(fn, vals, mask):
    """Launch the bound entry ``fn`` on checked CUDA tensors; returns
    (kde_val, use). Raises on an unsupported device or a CUDA error."""
    if vals.device.type != "cuda":
        raise ValueError(f"{fn.__name__}: unsupported device {vals.device}")
    T, W = vals.shape
    kde_val = torch.empty(T, dtype=torch.float32, device=vals.device)
    use = torch.empty(T, dtype=torch.bool, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(vals.data_ptr(), mask.data_ptr(), kde_val.data_ptr(),
                 use.data_ptr(), T, W, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    return kde_val, use


def kde_argmax_kernel(vals, mask):
    """(value (T,) float32, use_kde (T,) bool) of each row, the value the
    density-argmax sample where use_kde holds and the masked median where it
    does not: through ``csrc/kde_argmax.cu`` (K2) for CUDA tensors, through
    the plain :func:`kde_argmax_rows_and_use` for CPU tensors."""
    _check(vals, mask, "kde_argmax_kernel")
    if vals.device.type == "cpu":
        return kde_argmax_rows_and_use(vals, mask)
    out = launch_with(_lib("kde_argmax", "kde_argmax_forward"), vals, mask)
    _build.count_launch(kde_argmax_kernel, _build.instance(vals.shape[1]))
    return out


# every launch, and those of the wide and the any-width instance among them
kde_argmax_kernel.launches = 0
kde_argmax_kernel.wide_launches = 0
kde_argmax_kernel.xwide_launches = 0


def kde_argmax_v2_kernel(vals, mask):
    """(value (T,) float32, use_kde (T,) bool) of each row, as
    :func:`kde_argmax_kernel` gives them, with the densities summed by
    offset, one exp per symmetric pair: through ``csrc/kde_argmax.cu``'s K3
    for CUDA tensors, through the plain :func:`kde_argmax_rows_v2_and_use`
    for CPU tensors."""
    _check(vals, mask, "kde_argmax_v2_kernel")
    if vals.device.type == "cpu":
        return kde_argmax_rows_v2_and_use(vals, mask)
    out = launch_with(_lib("kde_argmax", "kde_argmax_v2_forward"), vals, mask)
    _build.count_launch(kde_argmax_v2_kernel,
                        _build.instance(vals.shape[1]))
    return out


kde_argmax_v2_kernel.launches = 0
kde_argmax_v2_kernel.wide_launches = 0
kde_argmax_v2_kernel.xwide_launches = 0


def kde_argmax_rows_fused(vals, mask, version="v1"):
    """Per-row KDE-argmax sample with the masked-median fallback, one
    launch and no sort. ``version`` picks the kernel as JAX's
    ``kde_argmax_rows_pallas(version=...)`` does: "v1" K2, "v2" K3. vals
    (T, W) float32, mask (T, W) bool -> (T,)."""
    if version not in KDE_VERSIONS:
        raise ValueError(f"unknown kde_version {version!r}; expected one of "
                         f"{KDE_VERSIONS}")
    kernel = kde_argmax_kernel if version == "v1" else kde_argmax_v2_kernel
    return kernel(vals, mask)[0]


def kde_argmax_rows_sharded(vals, mask, mesh, version="v1"):
    """:func:`kde_argmax_rows_fused` over a device mesh, the counterpart of
    ``kde_argmax_rows_pallas_sharded`` (``hypad_tpu/ops/kde_pallas.py:251``):
    the (T, W) rows split into the mesh's ``dp`` slabs, one K2 or K3 launch
    per slab on its device, the values gathered to the lead device. Rows are
    independent, so the result is the unsharded launch's row for row, ties
    included; no slab needs the pad rows JAX's ``shard_map`` needs for even
    shards."""
    from hypad_tpu_torch.parallel.mesh import map_rows

    return map_rows(mesh, lambda _, v, m: kde_argmax_rows_fused(
        v.contiguous(), m.contiguous(), version), vals, mask)
