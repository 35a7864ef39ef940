"""kappa-stereographic (Poincare ball, k<0) gyrovector math in PyTorch.

Port of the subset of ``hypad_tpu.manifold.stereographic`` that the
hyperbolic detector and trainer run: the clamp constants, ``tanh``/``artanh``,
``project``, ``lambda_x``, ``mobius_add``, ``gyration``, ``expmap0``,
``logmap0``, ``retr``, ``parallel_transport``, ``egrad2rgrad`` and the two
acosh Poincare distances (detector score and training loss). Every
stability clamp is kept as it is there, so boundary numerics agree with the
JAX package. All ops reduce over the last axis and compute in the input
dtype.
"""

from __future__ import annotations

import math

import torch

# -- stability constants (same table as hypad_tpu.manifold.stereographic) ----
TANH_CLAMP = 15.0
ARTANH_EPS = 1e-7
NORM_FLOOR = 1e-15
PROJECT_EPS_F32 = 4e-3
PROJECT_EPS_F64 = 1e-5
ACOSH_EPS = 1e-7


def _last_norm(x, keepdim=True):
    """L2 norm over the last axis, floored at NORM_FLOOR."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim)).clamp_min(
        NORM_FLOOR)


def tanh(x):
    """tanh with a +-15 pre-clamp."""
    return torch.tanh(x.clamp(-TANH_CLAMP, TANH_CLAMP))


def artanh(x):
    """artanh with the input clamped to (-1+1e-7, 1-1e-7)."""
    x = x.clamp(-1.0 + ARTANH_EPS, 1.0 - ARTANH_EPS)
    return 0.5 * (torch.log1p(x) - torch.log1p(-x))


def tan_k(x, k=-1.0):
    """tan_kappa, k<0 branch."""
    sqrt_abs_k = math.sqrt(abs(k))
    return tanh(x * sqrt_abs_k) / sqrt_abs_k


def artan_k(x, k=-1.0):
    """artan_kappa, k<0 branch."""
    sqrt_abs_k = math.sqrt(abs(k))
    return artanh(x * sqrt_abs_k) / sqrt_abs_k


def project(x, k=-1.0, eps=None):
    """Clip points to the open ball of radius (1-eps)/sqrt(|k|)."""
    if eps is None:
        eps = PROJECT_EPS_F32 if x.dtype == torch.float32 else PROJECT_EPS_F64
    maxnorm = (1.0 - eps) / math.sqrt(abs(k))
    norm = _last_norm(x)
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def lambda_x(x, k=-1.0, keepdim=False):
    """Conformal factor 2 / (1 + k ||x||^2), floored."""
    sq = torch.sum(x * x, dim=-1, keepdim=keepdim)
    return 2.0 / (1.0 + k * sq).clamp_min(NORM_FLOOR)


def mobius_add(x, y, k=-1.0):
    """Mobius gyrovector addition x (+)_k y."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = torch.sum(x * y, dim=-1, keepdim=True)
    num = (1.0 - 2.0 * k * xy - k * y2) * x + (1.0 + k * x2) * y
    denom = 1.0 - 2.0 * k * xy + (k * k) * x2 * y2
    return num / denom.clamp_min(NORM_FLOOR)


def gyration(u, v, w, k=-1.0):
    """gyr[u, v] w, simplified closed form."""
    u2 = torch.sum(u * u, dim=-1, keepdim=True)
    v2 = torch.sum(v * v, dim=-1, keepdim=True)
    uv = torch.sum(u * v, dim=-1, keepdim=True)
    uw = torch.sum(u * w, dim=-1, keepdim=True)
    vw = torch.sum(v * w, dim=-1, keepdim=True)
    k2 = k * k
    a = -k2 * uw * v2 - k * vw + 2.0 * k2 * uv * vw
    b = -k2 * vw * u2 + k * uw
    d = 1.0 - 2.0 * k * uv + k2 * u2 * v2
    return w + 2.0 * (a * u + b * v) / d.clamp_min(NORM_FLOOR)


def retr(x, u, k=-1.0):
    """First-order retraction: project(x + u)."""
    return project(x + u, k)


def parallel_transport(x, y, v, k=-1.0):
    """P_{x->y}(v) = gyr[y, -x] v * lambda_x / lambda_y."""
    return (gyration(y, -x, v, k) * lambda_x(x, k, keepdim=True)
            / lambda_x(y, k, keepdim=True))


def egrad2rgrad(x, grad, k=-1.0):
    """Euclidean to Riemannian gradient: grad / lambda_x^2."""
    lam = lambda_x(x, k, keepdim=True)
    return grad / (lam * lam)


def expmap0(u, k=-1.0):
    """Exponential map at the origin."""
    u_norm = _last_norm(u)
    return tan_k(u_norm, k) * (u / u_norm)


def logmap0(y, k=-1.0):
    """Logarithmic map at the origin."""
    y_norm = _last_norm(y)
    return (y / y_norm) * artan_k(y_norm, k)


def acosh_poincare_distance(u, v, eps=ACOSH_EPS):
    """acosh(1 + 2 d2 / ((1-||u||^2)(1-||v||^2)) + 1e-7), over the last axis.

    Deliberately not the geodesic ``dist``: the detector's per-window score
    keeps the additive 1e-7 and the *unclamped* (1 - ||.||^2) denominators.
    Returns shape ``u.shape[:-1]``.

    The argument's excess over 1 is kept apart from the 1: with
    y = x_temp - 1, acosh(1 + y) = log1p(y + sqrt(y (y + 2))). Rounding
    1 + y to the working precision first would quantize y to steps of one
    ulp of 1 (1.2e-7 in f32) and move small distances by up to 1e-2
    relative. The 1 + 1e-7 constant itself is rounded as the working dtype
    rounds it (to 1 + 2^-23 in f32), which is what the JAX program, whose
    compiler folds the constants and cancels the 1, computes as well."""
    sqdist = torch.sum((u - v) ** 2, dim=-1)
    squnorm = torch.sum(u * u, dim=-1)
    sqvnorm = torch.sum(v * v, dim=-1)
    offset = float(torch.tensor(1.0 + eps, dtype=u.dtype) - 1.0)
    y = 2.0 * sqdist / ((1.0 - squnorm) * (1.0 - sqvnorm)) + offset
    return torch.log1p(y + torch.sqrt(y * (y + 2.0)))


def acosh_poincare_distance_loss(u, v, eps=ACOSH_EPS):
    """The same distance as the generator's reconstruction loss computes it:
    ``acosh(1 + 2 d2 / ((1-||u||^2)(1-||v||^2)) + 1e-7)`` with the argument
    rounded to the working dtype before the acosh. Its gradient is then
    ``1 / sqrt(x^2 - 1)`` at the rounded argument, the form the JAX
    trainer differentiates, where :func:`acosh_poincare_distance` keeps the
    excess over 1 apart for the detector's forward accuracy."""
    sqdist = torch.sum((u - v) ** 2, dim=-1)
    squnorm = torch.sum(u * u, dim=-1)
    sqvnorm = torch.sum(v * v, dim=-1)
    x_temp = 1.0 + 2.0 * sqdist / ((1.0 - squnorm) * (1.0 - sqvnorm)) + eps
    return torch.acosh(x_temp)
