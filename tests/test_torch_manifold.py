"""Port parity: Poincare-ball ops and MobiusLinear (hypad_tpu_torch.manifold)
against the JAX package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.manifold import stereographic as jst
from hypad_tpu.manifold.kernels import mobius_linear_fused as jax_fused
from hypad_tpu.models.tadgan import init_mobius_linear
from hypad_tpu.models.tadgan import mobius_linear as jax_mobius_linear
from hypad_tpu_torch.manifold import stereographic as tst
from hypad_tpu_torch.manifold.kernels import (
    mobius_linear,
    mobius_linear_fused,
    mobius_linear_kernel,
)

TOL = {np.float32: dict(rtol=1e-6, atol=1e-7),
       np.float64: dict(rtol=1e-10, atol=1e-13)}


def _ball_points(rng, n, d, dtype, edge=(0.995, 0.9959, 0.99999, 0.0)):
    """Points with norms spread from the origin to just inside the edge."""
    x = rng.standard_normal((n, d))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    radius = np.concatenate([rng.uniform(0, 0.9, n - len(edge)), edge])
    return (x * radius[:, None]).astype(dtype)


def _jax(fn, *args, dtype):
    with jax.enable_x64(dtype == np.float64):
        return np.asarray(fn(*(jnp.asarray(a) for a in args)))


def _torch(fn, *args):
    return fn(*(torch.from_numpy(a) for a in args)).numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["project", "lambda_x", "mobius_add",
                                  "expmap0", "logmap0", "tanh", "artanh"])
def test_stereographic_ops_match_jax(name, dtype):
    rng = np.random.default_rng(0)
    x = _ball_points(rng, 64, 100, dtype)
    y = _ball_points(rng, 64, 100, dtype)
    if name == "mobius_add":
        args = (x, y)
    elif name == "project":
        args = (x * dtype(1.5),)  # half of them outside the f32 ball
    elif name == "expmap0":
        args = (rng.standard_normal((64, 100)).astype(dtype) * 3,)
    elif name in ("tanh", "artanh"):
        args = (np.concatenate([x[:, 0], [20.0, -20.0, 1.0, -1.0]]
                               ).astype(dtype),)
    else:
        args = (x,)
    want = _jax(getattr(jst, name), *args, dtype=dtype)
    got = _torch(getattr(tst, name), *args)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_acosh_poincare_distance_matches_jax(dtype):
    """Against the jitted JAX function (the form detect_scores runs) and an
    exact float64 evaluation, including near-identical points (distances
    near the 1e-7 floor) and points at the ball's edge (in f32 the edge
    that ``project`` leaves, 1 - 4e-3, beyond which the unclamped
    denominators lose every digit)."""
    rng = np.random.default_rng(1)
    edge = ((0.995, 0.996, 0.996, 0.0) if dtype == np.float32
            else (0.995, 0.9959, 0.99999, 0.0))
    u = _ball_points(rng, 64, 100, dtype, edge)
    v = _ball_points(rng, 64, 100, dtype, edge)
    v[:16] = u[:16] + dtype(1e-5) * rng.standard_normal((16, 100))
    v[16] = u[16]
    got = _torch(tst.acosh_poincare_distance, u, v)
    want = _jax(jax.jit(jst.acosh_poincare_distance), u, v, dtype=dtype)
    rtol = 2e-5 if dtype == np.float32 else 1e-9
    np.testing.assert_allclose(got, want, rtol=rtol)
    # exact value of the same expression, its 1 + 1e-7 rounded as the
    # working dtype rounds it
    u64, v64 = u.astype(np.float64), v.astype(np.float64)
    offset = float(dtype(1.0 + 1e-7)) - 1.0
    y = (2 * np.sum((u64 - v64) ** 2, -1)
         / ((1 - np.sum(u64 ** 2, -1)) * (1 - np.sum(v64 ** 2, -1)))
         + offset)
    # acosh(1 + y) = 2 asinh(sqrt(y / 2)), exact for small y
    np.testing.assert_allclose(got, 2 * np.arcsinh(np.sqrt(y / 2)),
                               rtol=1e-5 if dtype == np.float32 else 1e-12)


def _mobius_case(B, D, boundary=False):
    p = init_mobius_linear(jax.random.PRNGKey(0), D, D)
    if boundary:
        p = dict(p, w=p["w"] * 1e6)  # force outputs at the ball boundary
    x = np.random.default_rng(B * 1000 + D).uniform(
        -1.0, 1.0, (B, D)).astype(np.float32)
    return np.array(p["w"]), np.array(p["b"]), x


@pytest.mark.parametrize("B,D,boundary", [(64, 100, False), (5, 100, False),
                                          (130, 64, False), (8, 100, True)])
def test_mobius_linear_matches_jax(B, D, boundary):
    w, b, x = _mobius_case(B, D, boundary)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    want = np.asarray(jax_mobius_linear(jp, jnp.asarray(x)))
    want_fused = np.asarray(jax_fused(jp, jnp.asarray(x), interpret=True))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    got = mobius_linear(tx, tw, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, want_fused, rtol=1e-6, atol=1e-7)
    # on CPU tensors the kernel wrapper is the plain version and launches
    # nothing
    before = mobius_linear_kernel.launches
    np.testing.assert_array_equal(mobius_linear_kernel(tx, tw, tb).numpy(),
                                  got)
    assert mobius_linear_kernel.launches == before
    if boundary:
        assert np.all(np.linalg.norm(got, axis=-1) <= 1 - 4e-3 + 1e-6)


def test_mobius_linear_fused_gradient_matches_jax():
    w, b, x = _mobius_case(16, 100)
    target = np.random.default_rng(2).uniform(
        -0.05, 0.05, (16, 100)).astype(np.float32)

    def loss(p, x_):
        return jnp.sum((jax_mobius_linear(p, x_) - target) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out = mobius_linear_fused(tx, tw, tb)
    torch.sum((out - torch.from_numpy(target)) ** 2).backward()
    for got, want in ((tx.grad, gx), (tw.grad, gp["w"]), (tb.grad, gp["b"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,din,dout", [(8, 257, 257), (6, 300, 300),
                                         (5, 384, 100), (4, 100, 384)])
def test_mobius_linear_kernel_matches_jax_above_256(B, din, dout):
    """Widths above 256, which the card runs in the any-width kernel: on
    the CPU the wrapper runs the plain version, which must match JAX's
    Pallas kernel in interpret mode and its plain composition (the former
    refusal above 256 is gone)."""
    p = init_mobius_linear(jax.random.PRNGKey(din + dout), dout, din)
    w, b = np.array(p["w"]), np.array(p["b"])
    x = np.random.default_rng(B + din).uniform(
        -1.0, 1.0, (B, din)).astype(np.float32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    want = np.asarray(jax_mobius_linear(jp, jnp.asarray(x)))
    want_fused = np.asarray(jax_fused(jp, jnp.asarray(x), interpret=True))
    before = (mobius_linear_kernel.launches,
              mobius_linear_kernel.xwide_launches)
    got = mobius_linear_kernel(*map(torch.from_numpy, (x, w, b))).numpy()
    assert got.shape == (B, dout)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, want_fused, rtol=1e-6, atol=1e-7)
    assert (mobius_linear_kernel.launches,
            mobius_linear_kernel.xwide_launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_mobius_linear_kernel_rejects_what_it_does_not_take(bad):
    w, b, x = map(torch.from_numpy, _mobius_case(4, 64)[:3])
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        b = b[:10]
    else:
        x = torch.zeros(64, 4).T
    with pytest.raises((TypeError, ValueError)):
        mobius_linear_kernel(x, w, b)
