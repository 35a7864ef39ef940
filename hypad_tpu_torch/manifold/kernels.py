"""Fused MobiusLinear forward: the CUDA kernel, its plain version, autograd.

``mobius_linear`` is the plain PyTorch composition (matvec -> expmap0 ->
mobius_add(bias) -> project), the counterpart of
``hypad_tpu.models.tadgan.mobius_linear``. ``mobius_linear_kernel`` is the
wrapper of the hand-written kernel ``csrc/mobius_linear.cu``, which replaces
the Pallas kernel ``hypad_tpu/manifold/kernels.py:35``: on a CUDA tensor it
launches the kernel (or raises), on a CPU tensor it runs the plain version.
``mobius_linear_fused`` puts the wrapper under a ``torch.autograd.Function``
whose backward is autograd of the plain composition, as the JAX
``custom_vjp`` does (there is no backward kernel).

Widths up to 128 run the narrow kernel, 129 to 256 (multivariate feature
counts) the wide one of the same source, and any wider width the any-width
kernel there (``mobius_linear_xwide_kernel``); no width takes the plain
path on the card.

All three take a leading signal axis too (the fleet's counterpart of
``jax.vmap``): x (S, N, in), w (S, out, in), b (S, out) is one launch, in
which each signal gets the bits of its own single-signal launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hypad_tpu_torch import _build
from hypad_tpu_torch.manifold import stereographic as st

def instance(din, dout):
    """The kernel a (din -> dout) launch takes, as csrc/mobius_linear.cu's
    dispatch decides: "narrow" up to 128, "wide" up to 256, else "xwide"
    (the any-width kernel)."""
    return _build.instance(max(din, dout))


def mobius_linear(x, w, b, k=-1.0):
    """x (..., in), w (out, in), b (out,) on the ball -> (..., out) on the
    ball; or with a signal axis, x (S, N, in), w (S, out, in), b (S, out)
    -> (S, N, out)."""
    out = x @ w.mT
    out = st.expmap0(out, k)
    out = st.mobius_add(out, b[..., None, :].expand_as(out), k)
    return st.project(out, k)


def _check(x, w, b):
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"mobius_linear_kernel: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"mobius_linear_kernel: {name} is on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"mobius_linear_kernel: {name} must be "
                             "contiguous")
    lead = x.dim() - 2
    if (lead not in (0, 1) or w.dim() != 2 + lead or b.dim() != 1 + lead
            or x.shape[:lead] != w.shape[:lead]
            or b.shape[:lead] != w.shape[:lead]):
        raise ValueError("mobius_linear_kernel: expected x (B, in), "
                         "w (out, in), b (out,), or x (S, B, in), "
                         "w (S, out, in), b (S, out); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if w.shape[-1] != x.shape[-1] or b.shape[-1] != w.shape[-2]:
        raise ValueError("mobius_linear_kernel: shape mismatch "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if x.shape[-1] < 1 or w.shape[-2] < 1:
        raise ValueError(f"mobius_linear_kernel: in/out widths must be at "
                         f"least 1, got {x.shape[-1]}, {w.shape[-2]}")


def bind(lib):
    """``mobius_linear_forward`` of a library built from
    ``csrc/mobius_linear.cu`` (or a source of the same interface), with its
    argument types set."""
    fn = lib.mobius_linear_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bind_signals(lib):
    """``mobius_linear_forward_signals`` (the signal-axis entry) of a
    library built from ``csrc/mobius_linear.cu``, its argument types set."""
    fn = lib.mobius_linear_forward_signals
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib():
    return bind(_build.load("mobius_linear"))


@functools.cache
def _lib_signals():
    return bind_signals(_build.load("mobius_linear"))


def launch_with(fn, x, w, b):
    """Launch the bound entry ``fn`` on checked CUDA tensors; returns the
    output. Raises on a CUDA error. ``fn`` is a :func:`bind` entry for 2-D
    ``x`` and a :func:`bind_signals` entry for a signal axis."""
    out = torch.empty((*x.shape[:-1], w.shape[-2]), dtype=torch.float32,
                      device=x.device)
    shape = (x.shape[-2], x.shape[-1], w.shape[-2])
    if x.dim() == 3:
        shape = (x.shape[0],) + shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 *shape, stream)
    if err != 0:
        raise RuntimeError(f"mobius_linear_forward failed: CUDA error {err}")
    return out


def mobius_linear_kernel(x, w, b):
    """Forward of MobiusLinear through ``csrc/mobius_linear.cu`` for a CUDA
    ``x``, through :func:`mobius_linear` for a CPU ``x``. x (B, in),
    w (out, in), b (out,), or with a signal axis x (S, B, in),
    w (S, out, in), b (S, out) in one launch; all float32 and contiguous."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return mobius_linear(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"mobius_linear_kernel: unsupported device "
                         f"{x.device}")
    out = launch_with(_lib() if x.dim() == 2 else _lib_signals(), x, w, b)
    _build.count_launch(mobius_linear_kernel,
                        instance(x.shape[-1], w.shape[-2]))
    return out


# every launch, and those of the wide and the any-width kernel among them
mobius_linear_kernel.launches = 0
mobius_linear_kernel.wide_launches = 0
mobius_linear_kernel.xwide_launches = 0


class _MobiusLinearFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return mobius_linear_kernel(x, w, b)

    @staticmethod
    def backward(ctx, grad):
        x, w, b = ctx.saved_tensors
        with torch.enable_grad():
            xs, ws, bs = (t.detach().requires_grad_(True) for t in (x, w, b))
            out = mobius_linear(xs, ws, bs)
        return torch.autograd.grad(out, (xs, ws, bs), grad)


def mobius_linear_fused(x, w, b):
    """Differentiable MobiusLinear whose forward is the kernel wrapper and
    whose backward is autograd of the plain composition."""
    return _MobiusLinearFn.apply(x, w, b)
