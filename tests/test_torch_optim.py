"""Port parity: the optimizers (hypad_tpu_torch.optim.radam) and the
stereographic ops they use against the JAX package, on the CPU. Both sides
are fed the same parameters and the same gradient sequence."""

import jax
import numpy as np
import pytest
import torch

from hypad_tpu.manifold import stereographic as jst
from hypad_tpu.models import tadgan as jt
from hypad_tpu.optim import radam as jrad
from hypad_tpu_torch import bridge
from hypad_tpu_torch.manifold import stereographic as tst
from hypad_tpu_torch.optim import radam as trad

STEPS = 20


def _ball(rng, shape, radius):
    v = rng.standard_normal(shape)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    r = radius * rng.uniform(0.1, 1.0, shape[:-1] + (1,))
    return (v * r).astype(np.float32)


@pytest.mark.parametrize("radius", [0.3, 0.99])
def test_new_stereographic_ops_match_jax(radius):
    """gyration, retr, parallel_transport, egrad2rgrad: within 1e-5
    relative / 1e-6 absolute, inside the ball and near its edge."""
    rng = np.random.default_rng(int(radius * 100))
    x, y, z = (_ball(rng, (64, 100), radius) for _ in range(3))
    v = rng.standard_normal((64, 100)).astype(np.float32)
    tx, ty, tz, tv = (torch.from_numpy(a) for a in (x, y, z, v))
    tol = dict(rtol=1e-5, atol=1e-6)
    pairs = [
        (tst.gyration(tx, ty, tz), jst.gyration(x, y, z)),
        (tst.retr(tx, tv), jst.retr(x, v)),
        (tst.parallel_transport(tx, ty, tv), jst.parallel_transport(x, y, v)),
        (tst.egrad2rgrad(tx, tv), jst.egrad2rgrad(x, v)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # retr projects back inside the f32 ball
    assert (tst.retr(tx, 10 * tv).norm(dim=-1) <= 1 - 4e-3 + 1e-6).all()


def _params(hyperbolic):
    return jax.tree_util.tree_map(
        np.asarray, jt.init_tadgan(jax.random.PRNGKey(4), 100,
                                   hyperbolic=hyperbolic))


def _grad_sequence(tree, seed, scale=1.0):
    """STEPS gradient pytrees (numpy) shaped like ``tree``."""
    rng = np.random.default_rng(seed)
    flat = bridge.flatten_tree(tree)
    out = []
    for _ in range(STEPS):
        out.append(bridge.unflatten_tree({
            k: (scale * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in flat.items()}))
    return out


def _port(tree, prefix):
    return {f"{prefix}.{k.replace('/', '.')}" if prefix else
            k.replace("/", "."): torch.from_numpy(np.array(v))
            for k, v in bridge.flatten_tree(tree).items()}


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("which", ["critic_x", "generator"])
def test_adam_tracks_jax_over_20_steps(which):
    """Packed Adam: parameters within 1e-6 relative / 1e-8 absolute, the
    flat moments within 1e-6 / 1e-12 (so their leaf order is JAX's), equal
    step counters."""
    params = _params(hyperbolic=False)
    tree = (params["critic_x"] if which == "critic_x" else
            {"encoder": params["encoder"], "decoder": params["decoder"]})
    prefix = "critic_x" if which == "critic_x" else ""
    grads = _grad_sequence(tree, seed=1)

    jopt = jrad.adam(5e-4)
    jstate, jp = jopt.init(tree), tree
    topt = trad.adam(5e-4)
    tp = _port(tree, prefix)
    tstate = topt.init(tp)
    for g in grads:
        jp, jstate = jopt.update(g, jstate, jp)
        tstate = topt.update(_port(g, prefix), tstate, tp)
    assert tstate.step == int(jstate.step) == STEPS
    _close(tstate.mu, jstate.mu, "mu", 1e-6, 1e-12)
    _close(tstate.nu, jstate.nu, "nu", 1e-6, 1e-12)
    want = _port(jp, prefix)
    for k in want:
        _close(tp[k], want[k], k, 1e-6, 1e-8)


@pytest.mark.parametrize("lr,scale,ball_rtol", [(5e-4, 1.0, 1e-5),
                                                (0.3, 30.0, 2e-3)])
def test_riemannian_adam_tracks_jax_over_20_steps(lr, scale, ball_rtol):
    """Riemannian Adam (wd 1e-5 on every leaf, stabilize 10, the ball bias
    retracted, its momentum transported): parameters and per-leaf moments
    within 1e-5 relative / 1e-6 absolute (a few ulps of the weights) after
    20 steps, also at a step size that drives the ball bias onto the
    projection boundary. There the ball bias's moments get 2e-3 relative:
    near ||b|| = 0.996 the conformal factor 2 / (1 - ||b||^2) is 250, and it
    scales the ulp-level difference of the two frameworks' sum of b^2 in
    the Riemannian gradient and the transport by ~1 / (1 - ||b||^2)."""
    params = _params(hyperbolic=True)
    tree = {"encoder": params["encoder"], "decoder": params["decoder"]}
    grads = _grad_sequence(tree, seed=2, scale=scale)
    push = -np.sign(np.random.default_rng(3).standard_normal(100))
    for i, g in enumerate(grads):  # a steady pull on the ball bias
        g["decoder"]["hyperbolic_linear"]["b"] = (
            scale * (push + 0.1 * i)).astype(np.float32)

    jopt = jrad.riemannian_adam(lr, weight_decay=1e-5, stabilize=10)
    jstate, jp = jopt.init(tree), tree
    topt = trad.riemannian_adam(lr, weight_decay=1e-5, stabilize=10)
    tp = _port(tree, "")
    tstate = topt.init(tp)
    for g in grads:
        jp, jstate = jopt.update(g, jstate, jp)
        tstate = topt.update(_port(g, ""), tstate, tp)
    assert tstate.step == int(jstate.step) == STEPS
    tol = dict(rtol=1e-5, atol=1e-6)
    for name, got, want in (("param", tp, _port(jp, "")),
                            ("mu", tstate.mu, _port(jstate.mu, "")),
                            ("nu", tstate.nu, _port(jstate.nu, ""))):
        assert sorted(got) == sorted(want)
        for k in want:
            rtol = (ball_rtol if name != "param" and "hyperbolic_linear.b"
                    in k else tol["rtol"])
            _close(got[k], want[k], f"{name} {k}", rtol, tol["atol"])
    b = tp["decoder.hyperbolic_linear.b"]
    assert b.norm() <= 1 - 4e-3 + 1e-6
    if scale > 1:
        assert b.norm() > 0.98  # the bias ends near the edge of the ball


def test_leaf_order_and_manifold_mask():
    names = ["encoder.lstm.0.w_ih", "decoder.lstm.1.b_hh",
             "decoder.lstm.0.w_ih_rev", "decoder.dense1.w",
             "decoder.hyperbolic_linear.b", "decoder.hyperbolic_linear.w"]
    tree = bridge.unflatten_tree({n.replace(".", "/"): 0 for n in names})
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(tree)]
    got = trad.jax_leaf_order(names)
    assert [n.split(".") for n in got] == [
        [str(getattr(k, "key", getattr(k, "idx", None))) for k in p]
        for p, _ in jax.tree_util.tree_leaves_with_path(tree)], want
    mask = trad.manifold_mask(names)
    assert [n for n in names if mask[n]] == ["decoder.hyperbolic_linear.b"]
    jmask = jrad.manifold_mask(tree)
    assert sum(bool(v) for v in jax.tree_util.tree_leaves(jmask)) == 1
