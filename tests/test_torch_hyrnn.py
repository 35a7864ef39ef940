"""Port parity: the rest of the stereographic API and the Mobius GRU
(hypad_tpu_torch.manifold.stereographic, hypad_tpu_torch.models.hyrnn)
against the JAX package, forward and gradient, in float32 and float64, on
the CPU. JAX's ``init_mobius_gru`` / ``init_dist2hyperplane`` weights are
carried across by ``hypad_tpu_torch.bridge``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.manifold import stereographic as jst
from hypad_tpu.models import hyrnn as jhy
from hypad_tpu_torch import bridge
from hypad_tpu_torch.manifold import stereographic as tst
from hypad_tpu_torch.models import hyrnn as thy

# tests/test_torch_manifold.py's forward tolerances
TOL = {np.float32: dict(rtol=1e-6, atol=1e-7),
       np.float64: dict(rtol=1e-10, atol=1e-13)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ball(rng, shape, dtype, max_radius=0.9):
    x = rng.standard_normal(shape)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    radius = rng.uniform(0.05, max_radius, shape[:-1] + (1,))
    return (x * radius).astype(dtype)


def _vec(rng, shape, dtype, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(dtype)


def _cases(rng, dtype):
    """{name: (jax fn, torch fn, float args)}: each function of the API on
    ball points, tangent vectors and matrices at small widths."""
    B, D, P = 12, 16, 5
    x, y = _ball(rng, (B, D), dtype), _ball(rng, (B, D), dtype)
    u, v = _vec(rng, (B, D), dtype), _vec(rng, (B, D), dtype)
    m = _vec(rng, (P, D), dtype, 0.3)
    w = rng.uniform(0.2, 1.5, D).astype(dtype)
    p_cols, z_cols = _ball(rng, (P, D), dtype).T.copy(), _vec(rng, (D, P),
                                                             dtype)
    t = rng.uniform(-1, 1, (B, 1)).astype(dtype)
    r = rng.uniform(0.3, 2.0, (B, 1)).astype(dtype)
    xs = _ball(rng, (4, 6, D), dtype)
    wts = rng.uniform(-1, 1, (4, 6)).astype(dtype)

    def both(name, **kw):
        return (lambda *a: getattr(jst, name)(*a, **kw),
                lambda *a: getattr(tst, name)(*a, **kw))

    def fn_apply(mod, chain=False):
        def f(a):
            return jnp.tanh(a) * 0.5 if mod is jst else torch.tanh(a) * 0.5

        def g(a):
            return a * 1.3

        if chain:
            return lambda x_: mod.mobius_fn_apply_chain(x_, f, g, k=-1.0)
        return lambda x_: mod.mobius_fn_apply(f, x_)

    return {
        "expmap": (*both("expmap"), (x, u)),
        "logmap": (*both("logmap"), (x, y)),
        "mobius_matvec": (*both("mobius_matvec"), (m, x)),
        "mobius_pointwise_mul": (*both("mobius_pointwise_mul"), (w, x)),
        "mobius_fn_apply": (fn_apply(jst), fn_apply(tst), (x,)),
        "mobius_fn_apply_chain": (fn_apply(jst, True), fn_apply(tst, True),
                                  (x,)),
        "dist": (*both("dist"), (x, y)),
        "dist_keepdims": (*both("dist", keepdims=True), (x, y)),
        "dist0": (*both("dist0"), (x,)),
        "dist2plane": (*both("dist2plane"), (x, y, u)),
        "dist2plane_signed": (*both("dist2plane", signed=True), (x, y, u)),
        "antipode": (*both("antipode"), (x,)),
        "mobius_scalar_mul": (*both("mobius_scalar_mul"), (r, x)),
        "weighted_midpoint": (*both("weighted_midpoint"), (xs, wts)),
        "weighted_midpoint_reduce1": (
            *both("weighted_midpoint", reducedim=1, keepdim=True), (xs, wts)),
        "weighted_midpoint_lincomb": (
            *both("weighted_midpoint", lincomb=True, posweight=True),
            (xs, wts)),
        "weighted_midpoint_unweighted": (
            lambda a: jst.weighted_midpoint(a, lincomb=True),
            lambda a: tst.weighted_midpoint(a, lincomb=True), (xs,)),
        "arsin_k": (*both("arsin_k"), (u,)),
        "dist2plane_matmul": (*both("dist2plane_matmul"),
                              (x, p_cols, z_cols)),
        "inner": (*both("inner"), (x, u, v)),
        "norm": (*both("norm"), (x, u)),
        "norm_keepdims": (*both("norm", keepdims=True), (x, u)),
        "mobius_sub": (*both("mobius_sub"), (x, y)),
        "mobius_coadd": (*both("mobius_coadd"), (x, y)),
        "mobius_cosub": (*both("mobius_cosub"), (x, y)),
        "dist_matmul": (*both("dist_matmul"), (x, y.T.copy())),
        "geodesic": (*both("geodesic"), (t, x, y)),
        "geodesic_unit": (*both("geodesic_unit"), (t, x, u)),
        "geodesic_unit_float_t": (lambda a, b: jst.geodesic_unit(0.7, a, b),
                                  lambda a, b: tst.geodesic_unit(0.7, a, b),
                                  (x, u)),
        "_sign": (*both("_sign"), (np.array([-2.0, 0.0, 3.0, -0.0],
                                            dtype),)),
        "_clamp_abs": (*both("_clamp_abs"),
                       (np.array([-2.0, 0.0, 1e-20, -1e-20, 0.5], dtype),)),
    }


NAMES = sorted(_cases(np.random.default_rng(0), np.float32))
# The two frameworks sum the last axis in their own orders, and the f32
# last-bit differences that leaves grow where a formula cancels (an
# element far smaller than its row after a Mobius addition): measured at
# up to 5.3e-7 of the output's largest element (geodesic) and 3.7e-6
# relative on single elements (dist2plane_matmul), where float64 agrees to
# 1e-12. So the absolute part of the tolerance scales with the tensor's
# largest element: forward rtol 1e-6 (tests/test_torch_manifold.py's),
# atol 1e-6 of the largest element; gradients rtol 1e-5 (that file's
# gradient tolerance), atol 1e-6 of the largest (measured 2.3e-7).
SCALED_TOL = {np.float32: (dict(rtol=1e-6, atol=1e-6),
                           dict(rtol=1e-5, atol=1e-6)),
              np.float64: (dict(rtol=1e-10, atol=1e-13),
                           dict(rtol=1e-10, atol=1e-13))}


def _scaled_close(got, want, tol, err_msg=""):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want), initial=0.0))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=err_msg)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", NAMES)
def test_stereographic_function_and_gradient_match_jax(name, dtype):
    rng = np.random.default_rng(NAMES.index(name))
    jfn, tfn, args = _cases(rng, dtype)[name]
    with jax.enable_x64(dtype == np.float64):
        jargs = [jnp.asarray(a) for a in args]
        want = np.asarray(jfn(*jargs))
        cot = np.random.default_rng(1).standard_normal(want.shape).astype(
            dtype)
        grads = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot),
                         argnums=tuple(range(len(args))))(*jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    out = tfn(*targs)
    assert out.dtype == torch.from_numpy(want).dtype
    fwd_tol, grad_tol = SCALED_TOL[dtype]
    _scaled_close(out.detach().numpy(), want, fwd_tol)
    if name in ("_sign", "antipode"):
        return
    torch.sum(out * torch.from_numpy(cot)).backward()
    for i, (ta, g) in enumerate(zip(targs, grads)):
        _scaled_close(ta.grad.numpy(), g, grad_tol,
                      err_msg=f"{name} argument {i}")


def test_zero_vector_guards_match_jax():
    """``mobius_matvec``'s exact zero guard and ``mobius_pointwise_mul``'s
    isclose guard give 0 where JAX's give it."""
    rng = np.random.default_rng(3)
    x = _ball(rng, (6, 8), np.float32)
    x[1] = 0.0
    m = _vec(rng, (4, 8), np.float32)
    w = rng.uniform(0.5, 1.0, 8).astype(np.float32)
    w[:] = np.where(np.arange(8) < 4, 0.0, w)
    x[2, 4:] = 1e-12
    for name, args in (("mobius_matvec", (m, x)),
                       ("mobius_pointwise_mul", (w, x))):
        want = np.asarray(getattr(jst, name)(*map(jnp.asarray, args)))
        got = getattr(tst, name)(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, **TOL[np.float32])
        assert np.array_equal(got == 0, want == 0)


def _gru_inputs(dtype, T=12, B=5, in_size=6, hidden=16, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, B, in_size)) * 0.2).astype(dtype)
    h0 = (rng.standard_normal((B, hidden)) * 0.1).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        p = jhy.init_mobius_gru(jax.random.PRNGKey(seed), in_size, hidden,
                                dtype=jnp.dtype(dtype))
        p = {k_: np.array(v) for k_, v in p.items()}
    return x, h0, p


# the GRU chains 3 matvecs, 4 Mobius additions and 2 sigmoids a step; the
# two frameworks' f32 reductions differ in the last bits, measured at up to
# 6.9e-8 absolute over 20 steps (on states near 0 that is up to 8e-4
# relative), so f32 is held at rtol 1e-5 / atol 1e-6, f64 at 1e-9 / 1e-12
GRU_TOL = {np.float32: dict(rtol=1e-5, atol=1e-6),
           np.float64: dict(rtol=1e-9, atol=1e-12)}


# JAX's masked scan (``lengths``) carries an int32 step counter that x64
# promotes, so its float64 run fails in JAX itself: that case is f32 only
@pytest.mark.parametrize("dtype,T,hidden,lengths,flags", [
    (dt, *case) for case in [(10, 16, None, (False, False)),
                             (20, 32, None, (True, False))]
    for dt in (np.float32, np.float64)] + [
    (np.float32, 12, 16, [12, 7, 7, 3, 1], (False, True))])
def test_mobius_gru_loop_matches_jax(dtype, T, hidden, lengths, flags):
    """The dense loop (with ``lengths`` masking and the hyperbolic input /
    state flags) against JAX's ``lax.scan``, outputs and h_last, through
    the bridged module and the function."""
    x, h0, p = _gru_inputs(dtype, T=T, hidden=hidden)
    hyper_in, hyper_h0 = flags
    kw = dict(hyperbolic_input=hyper_in, hyperbolic_hidden_state0=hyper_h0)
    with jax.enable_x64(dtype == np.float64):
        if hyper_in:
            x = np.array(jst.expmap0(jnp.asarray(x)))
        if hyper_h0:
            h0 = np.array(jst.expmap0(jnp.asarray(h0)))
        want_outs, want_h = jhy.mobius_gru_loop(
            jnp.asarray(x), jnp.asarray(h0), *(jnp.asarray(p[n]) for n in
                                               ("weight_ih", "weight_hh",
                                                "bias")),
            lengths=lengths, **kw)
    gru = bridge.mobius_gru_from_jax(p, device="cpu", **kw)
    assert gru.weight_ih.dtype == torch.from_numpy(x).dtype
    outs, h_last = gru(torch.from_numpy(x), torch.from_numpy(h0),
                       lengths=lengths)
    np.testing.assert_allclose(outs.detach().numpy(), np.asarray(want_outs),
                               **GRU_TOL[dtype])
    np.testing.assert_allclose(h_last.detach().numpy(), np.asarray(want_h),
                               **GRU_TOL[dtype])
    assert float(torch.linalg.norm(outs, dim=-1).max()) < 1.0
    if lengths is not None:
        for b, L in enumerate(lengths):
            assert torch.equal(outs[L - 1:, b],
                               outs[L - 1, b].expand(T - L + 1, -1))


def test_masked_gru_loop_gradients_match_jax_nan_included():
    """Ragged ``lengths`` mask finished rows' inputs to the origin, where
    ``mobius_matvec``'s floored norm has a 0 * inf derivative: JAX's
    ``weight_ih`` gradient is NaN there, and the port's is NaN at the same
    entries; the other gradients are finite and agree."""
    x, h0, p = _gru_inputs(np.float32, T=6, B=4, in_size=3, hidden=8,
                           seed=7)
    lengths = np.array([6, 4, 4, 2])

    def jloss(pw):
        _, h = jhy.mobius_gru_loop(jnp.asarray(x), jnp.asarray(h0),
                                   pw["weight_ih"], pw["weight_hh"],
                                   pw["bias"], lengths=lengths)
        return jnp.sum(jst.dist0(h))

    want = jax.grad(jloss)({k_: jnp.asarray(v) for k_, v in p.items()})
    gru = bridge.mobius_gru_from_jax(p, device="cpu")
    _, h = gru(torch.from_numpy(x), torch.from_numpy(h0), lengths=lengths)
    torch.sum(tst.dist0(h)).backward()
    assert np.isnan(np.asarray(want["weight_ih"])).any()
    for name, param in gru.named_parameters():
        got, w = param.grad.numpy(), np.asarray(want[name])
        assert np.array_equal(np.isnan(got), np.isnan(w)), name
        ok = ~np.isnan(w)
        np.testing.assert_allclose(got[ok], w[ok], err_msg=name,
                                   **GRU_TOL[np.float32])


@pytest.mark.parametrize("hyper_in", [False, True])
def test_mobius_gru_loop_packed_matches_jax(hyper_in):
    """The PackedSequence layout (ragged lengths with ties and a length-1
    straggler), packed outputs and h_last."""
    rng = np.random.default_rng(4)
    in_size, hidden = 5, 16
    lengths = [15, 11, 11, 4, 1]
    batch_sizes = np.array([sum(1 for L in lengths if L > t)
                            for t in range(max(lengths))])
    data = (rng.standard_normal((int(batch_sizes.sum()), in_size))
            * 0.2).astype(np.float32)
    h0 = (rng.standard_normal((len(lengths), hidden)) * 0.1).astype(
        np.float32)
    p = {k_: np.asarray(v) for k_, v in jhy.init_mobius_gru(
        jax.random.PRNGKey(1), in_size, hidden).items()}
    want_outs, want_h = jhy.mobius_gru_loop_packed(
        jnp.asarray(data), batch_sizes, jnp.asarray(h0),
        *(jnp.asarray(p[n]) for n in ("weight_ih", "weight_hh", "bias")),
        hyperbolic_input=hyper_in)
    gru = bridge.mobius_gru_from_jax(p, device="cpu",
                                     hyperbolic_input=hyper_in)
    outs, h_last = gru(torch.from_numpy(data), torch.from_numpy(h0),
                       batch_sizes=batch_sizes)
    assert outs.shape == (batch_sizes.sum(), hidden)
    np.testing.assert_allclose(outs.detach().numpy(), np.asarray(want_outs),
                               **GRU_TOL[np.float32])
    np.testing.assert_allclose(h_last.detach().numpy(), np.asarray(want_h),
                               **GRU_TOL[np.float32])
    np.testing.assert_array_equal(thy.batch_sizes_to_lengths(batch_sizes),
                                  jhy.batch_sizes_to_lengths(batch_sizes))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mobius_gru_cell_gradients_match_jax(dtype):
    """The cell's gradients for every weight, the input and the state,
    through a dist0 loss, against jax.grad."""
    _, _, p = _gru_inputs(dtype, hidden=16, in_size=6, seed=5)
    rng = np.random.default_rng(5)
    x = _ball(rng, (4, 6), dtype, 0.5)
    h = _ball(rng, (4, 16), dtype, 0.5)

    def jloss(pw, x_, h_):
        out = jhy.mobius_gru_cell(x_, h_, pw["weight_ih"], pw["weight_hh"],
                                  pw["bias"], nonlin=jnp.tanh)
        return jnp.sum(jst.dist0(out))

    with jax.enable_x64(dtype == np.float64):
        gp, gx, gh = jax.grad(jloss, argnums=(0, 1, 2))(
            {k_: jnp.asarray(v) for k_, v in p.items()}, jnp.asarray(x),
            jnp.asarray(h))
    tp = {k_: torch.tensor(v, requires_grad=True) for k_, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(h, requires_grad=True)
    out = thy.mobius_gru_cell(tx, th, tp["weight_ih"], tp["weight_hh"],
                              tp["bias"], nonlin=torch.tanh)
    torch.sum(tst.dist0(out)).backward()
    for got, want, what in [(tp[k_].grad, gp[k_], k_) for k_ in tp] + [
            (tx.grad, gx, "x"), (th.grad, gh, "h")]:
        assert np.all(np.isfinite(got.numpy())), what
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=what, **GRU_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dist2hyperplane_and_pairwise_distance_match_jax(dtype):
    rng = np.random.default_rng(6)
    with jax.enable_x64(dtype == np.float64):
        p = {k_: np.array(v) for k_, v in jhy.init_dist2hyperplane(
            jax.random.PRNGKey(2), 16, 7, dtype=jnp.dtype(dtype)).items()}
        p["scale"] = rng.uniform(-0.5, 0.5, 7).astype(dtype)
        x = np.array(jst.expmap0(jnp.asarray(
            rng.standard_normal((30, 16)).astype(dtype) * 0.3)))
        want_d = np.asarray(jhy.dist2hyperplane_apply(
            {k_: jnp.asarray(v) for k_, v in p.items()}, jnp.asarray(x)))
        want_pair = np.asarray(jhy.pairwise_poincare_distance(
            jnp.asarray(x), jnp.asarray(x[:11])))
    layer = bridge.dist2hyperplane_from_jax(p, device="cpu")
    got_d = layer(torch.from_numpy(x)).detach().numpy()
    assert got_d.shape == (30, 7)
    # the denominator's 1 + k ||(-p) (+) x||^2 cancels for points near the
    # ball's edge and scales up the f32 last-bit differences of the norm:
    # measured 5.6e-6 relative, held at 1e-5 in f32
    np.testing.assert_allclose(got_d, want_d,
                               **(dict(rtol=1e-5, atol=1e-6)
                                  if dtype == np.float32 else TOL[dtype]))
    got_pair = thy.pairwise_poincare_distance(torch.from_numpy(x),
                                              torch.from_numpy(x[:11]))
    # a point against itself: the expanded |x|^2 - 2 x.y + |y|^2 cancels
    # to rounding noise (then clamped at 1e-7), which acosh near 1 turns
    # into distances of 1e-3 that differ between the frameworks in f32; as
    # in JAX's own test, those are held below 1e-2, the rest at TOL
    got_pair = got_pair.numpy()
    self_pairs = np.eye(30, 11, dtype=bool)
    assert np.all(got_pair[self_pairs] < 1e-2)
    np.testing.assert_allclose(got_pair[~self_pairs], want_pair[~self_pairs],
                               **TOL[dtype])


def test_port_init_draws_from_its_generator():
    """The port's own init: the same seed gives the same weights, the bias
    and hyperplane points lie in the ball, the tangents are unit; and the
    modules run on the CPU when asked and refuse a missing card."""
    a = thy.init_mobius_gru(torch.Generator().manual_seed(3), 4, 8,
                            device="cpu")
    b = thy.init_mobius_gru(torch.Generator().manual_seed(3), 4, 8,
                            device="cpu")
    assert all(torch.equal(a[k_], b[k_]) for k_ in a)
    assert a["weight_ih"].shape == (24, 4) and a["bias"].shape == (3, 8)
    assert float(a["weight_hh"].abs().max()) <= 1 / np.sqrt(8)
    d = thy.init_dist2hyperplane(torch.Generator().manual_seed(3), 4, 5,
                                 device="cpu")
    assert float(torch.linalg.norm(d["point"], dim=-1).max()) < 1.0
    torch.testing.assert_close(torch.linalg.norm(d["tangent"], dim=-1),
                               torch.ones(5))
    gru = thy.MobiusGRU(4, 8, device="cpu")
    outs, h = gru(torch.zeros(3, 2, 4))
    assert outs.shape == (3, 2, 8) and h.shape == (2, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            thy.MobiusGRU(4, 8)
