"""kappa-stereographic (Poincare ball, k<0) gyrovector math in PyTorch.

Port of ``hypad_tpu.manifold.stereographic``: the clamp constants,
``tanh``/``artanh``, ``project``, ``lambda_x``, ``mobius_add``,
``gyration``, ``expmap0``, ``logmap0``, ``retr``, ``parallel_transport``,
``egrad2rgrad`` and the two acosh Poincare distances (detector score and
training loss), which the detector and trainer run; and the rest of the
public API, with JAX's names and arguments (curvature ``k`` a Python
float, k < 0): ``expmap``, ``logmap``, ``mobius_matvec``,
``mobius_pointwise_mul``, ``mobius_scalar_mul``, ``mobius_fn_apply`` and
``mobius_fn_apply_chain``, ``mobius_sub``, ``mobius_coadd``,
``mobius_cosub``, ``dist``, ``dist0``, ``dist_matmul``, ``dist2plane``,
``dist2plane_matmul``, ``arsin_k``, ``antipode``, ``weighted_midpoint``,
``inner``, ``norm``, ``geodesic`` and ``geodesic_unit``. Every stability
clamp is kept as it is there, and each function is the JAX function's
formula, so autograd differentiates what JAX differentiates and boundary
numerics agree with the JAX package. All ops reduce over the last axis and
compute in the input dtype.
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


def expmap(x, u, k=-1.0):
    """Exponential map at x."""
    u_norm = _last_norm(u)
    lam = lambda_x(x, k, keepdim=True)
    second = tan_k(lam / 2.0 * u_norm, k) * (u / u_norm)
    return mobius_add(x, second, k)


def mobius_matvec(m, x, k=-1.0):
    """Mobius matrix-vector multiply with the exact zero-vector guard.
    ``m``: (out, in); ``x``: (..., in)."""
    x_norm = _last_norm(x)
    mx = x @ m.T
    mx_norm = _last_norm(mx)
    res = tan_k(mx_norm / x_norm * artan_k(x_norm, k), k) * (mx / mx_norm)
    all_zero = torch.all(mx == 0, dim=-1, keepdim=True)
    return torch.where(all_zero, torch.zeros((), dtype=res.dtype,
                                             device=res.device), res)


def mobius_pointwise_mul(w, x, k=-1.0):
    """Mobius pointwise (diagonal-matrix) multiply; rows whose product is
    all within ``isclose`` of 0 give 0."""
    x_norm = _last_norm(x)
    wx = w * x
    wx_norm = _last_norm(wx)
    res = tan_k(wx_norm / x_norm * artan_k(x_norm, k), k) * (wx / wx_norm)
    all_zero = torch.all(torch.isclose(wx, torch.zeros_like(wx)), dim=-1,
                         keepdim=True)
    return torch.where(all_zero, torch.zeros((), dtype=res.dtype,
                                             device=res.device), res)


def mobius_fn_apply(fn, x, k=-1.0):
    """Apply a Euclidean fn in the tangent space at 0 (logmap0 -> fn ->
    expmap0), projected back to the ball."""
    return project(expmap0(fn(logmap0(x, k)), k), k)


def dist(x, y, k=-1.0, keepdims=False):
    """Geodesic distance 2 artan_k(||(-x) (+) y||)."""
    return 2.0 * artan_k(_last_norm(mobius_add(-x, y, k), keepdim=keepdims),
                         k)


def dist0(x, k=-1.0, keepdims=False):
    """Distance to the origin."""
    return 2.0 * artan_k(_last_norm(x, keepdim=keepdims), k)


def dist2plane(x, p, a, k=-1.0, signed=False):
    """Distance from x to the hyperplane through p with normal a (the k<0
    arsin_k branch)."""
    diff = mobius_add(-p, x, k)
    diff_norm2 = torch.sum(diff * diff, dim=-1).clamp_min(NORM_FLOOR)
    sc_diff_a = torch.sum(diff * a, dim=-1)
    if not signed:
        sc_diff_a = torch.abs(sc_diff_a)
    a_norm = torch.sqrt(torch.sum(a * a, dim=-1))
    num = 2.0 * sc_diff_a
    denom = (1.0 + k * diff_norm2) * a_norm
    denom = torch.sign(denom) * torch.abs(denom).clamp_min(NORM_FLOOR)
    sqrt_abs_k = math.sqrt(abs(k))
    return torch.asinh(num / denom * sqrt_abs_k) / sqrt_abs_k


def _sign(x):
    """geoopt.utils.sign: never returns 0 (sign(0) = +1)."""
    return torch.sign(torch.sign(x) + 0.5)


def _clamp_abs(x, eps=NORM_FLOOR):
    """geoopt.utils.clamp_abs: floor |x| at eps, preserving (nonzero)
    sign."""
    return _sign(x) * torch.abs(x).clamp_min(eps)


def antipode(x, k=-1.0):
    """Antipodal point; for k <= 0 simply -x."""
    return -x


def mobius_scalar_mul(r, x, k=-1.0):
    """Mobius scalar multiplication r (x) x:
    tan_k(r * artan_k(||x||)) * x/||x||."""
    x_norm = _last_norm(x)
    return tan_k(r * artan_k(x_norm, k), k) * (x / x_norm)


def weighted_midpoint(xs, weights=None, k=-1.0, reducedim=None,
                      keepdim=False, lincomb=False, posweight=False,
                      coadd=False):
    """Einstein midpoint in Poincare coordinates,

        mid = 1/2 (x) ( sum_i a_i lam(x_i) x_i / sum_j |a_j| (lam(x_j) - 1) )

    reduced over ``reducedim`` (default: every axis but the last, the
    manifold dimension); only the k <= 0 branches."""
    xs = torch.as_tensor(xs)
    if reducedim is None:
        reducedim = tuple(range(xs.ndim - 1))
    elif isinstance(reducedim, int):
        reducedim = (reducedim,)
    else:
        reducedim = tuple(reducedim)
    gamma = lambda_x(xs, k, keepdim=True)
    if weights is None:
        weights = torch.ones((), dtype=xs.dtype, device=xs.device)
        scalar_weights = True
    else:
        weights = torch.as_tensor(weights, dtype=xs.dtype,
                                  device=xs.device)[..., None]
        scalar_weights = False
    if posweight and not scalar_weights:
        xs = torch.where(weights < 0, antipode(xs, k), xs)
        weights = torch.abs(weights)
    denominator = torch.sum((gamma - 1.0) * torch.abs(weights),
                            dim=reducedim, keepdim=True)
    nominator = torch.sum(gamma * weights * xs, dim=reducedim, keepdim=True)
    two_mean = nominator / _clamp_abs(denominator, 1e-10)
    if lincomb or coadd:
        a_mean = two_mean
    else:
        a_mean = two_mean / (1.0 + torch.sqrt(
            1.0 + k * torch.sum(two_mean ** 2, dim=-1, keepdim=True)))
    if lincomb:
        if scalar_weights:
            alpha = weights
            for d in reducedim:
                alpha = alpha * xs.shape[d]
        else:
            alpha = torch.sum(torch.broadcast_to(weights, gamma.shape),
                              dim=reducedim, keepdim=True)
        a_mean = mobius_scalar_mul(alpha / 2.0, a_mean, k)
    if not keepdim:
        a_mean = a_mean.reshape([s for i, s in enumerate(a_mean.shape)
                                 if i not in reducedim])
    return a_mean


def arsin_k(x, k=-1.0):
    """arsin_kappa, k<0 branch: arsinh(x sqrt|k|)/sqrt|k|."""
    sqrt_abs_k = math.sqrt(abs(k))
    return torch.asinh(x * sqrt_abs_k) / sqrt_abs_k


def dist2plane_matmul(x, p, z, k=-1.0):
    """Distances to P hyperplanes in matmul form: ``x`` (..., D) ball
    points, ``p`` (D, P) hyperplane points, ``z`` (D, P) hyperplane
    tangents (reduced over dim -2). Returns (..., P) signed distances
    scaled by the tangent norms."""
    z_norm = torch.sqrt(torch.sum(z * z, dim=-2, keepdim=True)).clamp_min(
        NORM_FLOOR)
    z_unit = z / z_norm
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    p2 = torch.sum(p * p, dim=-2, keepdim=True)
    pz = torch.sum(p * z_unit, dim=-2, keepdim=True)
    inner_ = (x @ z_unit
              - (1.0 + 2.0 * k * (x @ p) - k * x2)
              / (1.0 + k * x2).clamp_min(NORM_FLOOR) * pz)
    distance = arsin_k(
        2.0 / (1.0 + k * p2).clamp_min(NORM_FLOOR) * inner_, k)
    return 2.0 * distance * z_norm


def inner(x, u, v, k=-1.0, keepdims=False):
    """Riemannian inner product of tangent vectors u, v at x:
    lambda_x^2 <u, v>."""
    lam = lambda_x(x, k, keepdim=True)
    return lam * lam * torch.sum(u * v, dim=-1, keepdim=keepdims)


def norm(x, u, k=-1.0, keepdims=False):
    """Riemannian norm of tangent vector u at x: lambda_x ||u||_2 (the
    reference applies ``keepdim`` to both factors, as JAX does)."""
    return lambda_x(x, k, keepdim=keepdims) * torch.sqrt(
        torch.sum(u * u, dim=-1, keepdim=keepdims))


def mobius_sub(x, y, k=-1.0):
    """Mobius gyrovector subtraction x (-)_k y = x (+)_k (-y)."""
    return mobius_add(x, -y, k)


def mobius_coadd(x, y, k=-1.0):
    """Mobius cogyrovector addition:
    ((1 + k||y||^2) x + (1 + k||x||^2) y) / (1 - k^2 ||x||^2 ||y||^2)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    num = (1.0 + k * y2) * x + (1.0 + k * x2) * y
    denom = 1.0 - (k * k) * x2 * y2
    return num / denom.clamp_min(NORM_FLOOR)


def mobius_cosub(x, y, k=-1.0):
    """Mobius cogyrovector subtraction: x coadd (-y)."""
    return mobius_coadd(x, -y, k)


def logmap(x, y, k=-1.0):
    """Logarithmic map of y at x, the inverse of :func:`expmap` at x:
    2 artan_k(||(-x)(+)y||) * ((-x)(+)y) / (lambda_x ||(-x)(+)y||)."""
    sub = mobius_add(-x, y, k)
    sub_norm = _last_norm(sub)
    lam = lambda_x(x, k, keepdim=True)
    return 2.0 * artan_k(sub_norm, k) * (sub / (lam * sub_norm))


def dist_matmul(x, y, k=-1.0):
    """Pairwise geodesic distances in matmul form: ``x`` (..., N, D),
    ``y`` (D, M) -> (..., N, M), the squared mobius_add norm expanded so
    the grid takes one matrix product."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-2, keepdim=True)
    xy = x @ y
    num = x2 - 2.0 * xy + y2
    denom = (1.0 + 2.0 * k * xy + (k * k) * x2 * y2).clamp_min(NORM_FLOOR)
    return 2.0 * artan_k(torch.sqrt((num / denom).clamp_min(NORM_FLOOR)), k)


def geodesic(t, x, y, k=-1.0):
    """Point at parameter t along the geodesic from x to y:
    x (+) t (x) ((-x) (+) y)."""
    v = mobius_add(-x, y, k)
    return mobius_add(x, mobius_scalar_mul(t, v, k), k)


def geodesic_unit(t, x, u, k=-1.0):
    """Unit-speed geodesic from x with direction u at arclength t:
    x (+) tan_k(t/2) u/||u||."""
    u_norm = _last_norm(u)
    t = torch.as_tensor(t, dtype=u.dtype, device=u.device)
    return mobius_add(x, tan_k(t / 2.0, k) * (u / u_norm), k)


def mobius_fn_apply_chain(x, *fns, k=-1.0):
    """Sequential gyrovector function application: one logmap0 / expmap0
    round trip around the whole chain; like the reference, not projected
    back to the ball (unlike :func:`mobius_fn_apply`)."""
    if not fns:
        return x
    ex = logmap0(x, k)
    for fn in fns:
        ex = fn(ex)
    return expmap0(ex, k)


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
