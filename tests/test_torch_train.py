"""Port parity: the training forwards, losses, one epoch and the train-state
bridge (hypad_tpu_torch.train) against the JAX package, on the CPU.

Weights come from the JAX ``init_tadgan`` through the bridge; every draw is
made once (numpy, or the JAX trainer's own keys for the epoch) and handed
to both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.models import tadgan as jt
from hypad_tpu.optim.radam import PackedAdamState, RAdamState
from hypad_tpu.train import trainer as jtr
from hypad_tpu_torch import bridge
from hypad_tpu_torch.train import state_bridge
from hypad_tpu_torch.train import trainer as ttr

B, W, LATENT, H = 16, 100, 20, 20
N_EPOCH, LR = 96, 0.005


def _jax_params(hyperbolic, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jt.init_tadgan(jax.random.PRNGKey(seed), W,
                                   hyperbolic=hyperbolic))


def _draws(seed):
    """One step's draws (numpy), shaped as the port takes them."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.uniform(-1, 1, (B, W)).astype(np.float32),
        "z_x": rng.standard_normal((B, LATENT)).astype(np.float32),
        "a_x": rng.uniform(0, 1, (B, W)).astype(np.float32),
        "z_z": rng.standard_normal((B, LATENT)).astype(np.float32),
        "a_z": rng.uniform(0, 1, (B, LATENT)).astype(np.float32),
        "m_cx": rng.uniform(size=(4, 3 * B, H)) < 0.75,
        "m_cz": rng.uniform(size=(2, 3 * B, H)) < 0.8,
        "m_dec": rng.uniform(size=(B, 128)) < 0.8,
        "gen_m_cx": rng.uniform(size=(4, B, H)) < 0.75,
        "gen_m_cz": rng.uniform(size=(2, B, H)) < 0.8,
        "gen_m_dec": rng.uniform(size=(2 * B, 128)) < 0.8,
    }


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _assert_tree_close(got, want, rtol, atol, what):
    want = bridge.flatten_tree(want)
    got = {k.replace(".", "/"): v for k, v in got.items()}
    assert sorted(got) == sorted(want), what
    for key in want:
        np.testing.assert_allclose(
            np.asarray(got[key]), np.asarray(want[key]), rtol=rtol,
            atol=atol, err_msg=f"{what} {key}")


@pytest.mark.parametrize("hyperbolic", [True, False])
def test_training_forwards_match_jax(hyperbolic):
    """CriticX (4 masks), CriticZ (2 masks) and the decoder (inter-layer
    LSTM mask) in training mode, same masks: within 1e-5 relative."""
    params = _jax_params(hyperbolic, seed=1)
    model = bridge.from_jax_params(params, device="cpu")
    d = _draws(1)
    t = _t(d)
    big = np.concatenate([d["x"]] * 3)
    tol = dict(rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        cx = model["critic_x"](torch.from_numpy(big), t["m_cx"]).numpy()
        cz = model["critic_z"](t["z_z"], t["m_cz"][:, :B]).numpy()
        dec = model["decoder"](t["z_x"], t["m_dec"][None, None])
    np.testing.assert_allclose(cx, np.asarray(jt.critic_x_apply(
        params["critic_x"], big, training=True, drop_masks=d["m_cx"])), **tol)
    np.testing.assert_allclose(cz, np.asarray(jt.critic_z_apply(
        params["critic_z"], d["z_z"], training=True,
        drop_masks=d["m_cz"][:, :B])), **tol)
    jdec = jt.decoder_apply(params["decoder"], d["z_x"],
                            hyperbolic=hyperbolic, training=True,
                            lstm_drop_masks=d["m_dec"][None, None])
    for got, want in zip(dec if hyperbolic else (dec,),
                         jdec if hyperbolic else (jdec,)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("hyperbolic", [True, False])
def test_critic_losses_and_gradients_match_jax(hyperbolic):
    """critic_x_loss and critic_z_loss (stacked 3B forward, GP through
    create_graph autograd, one whole-batch norm): values within 2e-5
    relative, every parameter gradient within 5e-5 relative / 5e-7
    absolute, the bounds tests/test_critic_kernel.py holds K4 to."""
    params = _jax_params(hyperbolic, seed=2)
    model = bridge.from_jax_params(params, device="cpu")
    d = _draws(2)
    t = _t(d)
    gen = {"encoder": params["encoder"], "decoder": params["decoder"]}
    key = jax.random.PRNGKey(0)

    jlx, jgx = jax.value_and_grad(jtr.critic_x_loss)(
        params["critic_x"], gen, d["x"], key, hyperbolic, z=d["z_x"],
        alpha=d["a_x"], drop_masks=d["m_cx"],
        dec_drop_masks=d["m_dec"][None, None])
    jlz, jgz = jax.value_and_grad(jtr.critic_z_loss)(
        params["critic_z"], gen, d["x"], key, hyperbolic, z=d["z_z"],
        alpha=d["a_z"], drop_masks=d["m_cz"])

    lx = ttr.critic_x_loss(model, t["x"], hyperbolic, t["z_x"], t["a_x"],
                           t["m_cx"], t["m_dec"])
    lz = ttr.critic_z_loss(model, t["x"], t["z_z"], t["a_z"], t["m_cz"])
    for loss, jloss, jgrads, name in ((lx, jlx, jgx, "critic_x"),
                                      (lz, jlz, jgz, "critic_z")):
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5,
                                   atol=1e-6)
        names = [n for n, _ in model[name].named_parameters()]
        grads = torch.autograd.grad(loss, list(model[name].parameters()))
        _assert_tree_close({n: g for n, g in zip(names, grads)}, jgrads,
                           5e-5, 5e-7, name)


@pytest.mark.parametrize("hyperbolic", [True, False])
def test_generator_loss_and_gradients_match_jax(hyperbolic):
    """generator_loss (stacked 2B decoder, 10 x sum acosh / B or MSE, both
    critics' adversarial terms): loss and rec within 1e-5 relative, every
    generator gradient within 1e-4 relative / 1e-6 absolute."""
    params = _jax_params(hyperbolic, seed=3)
    model = bridge.from_jax_params(params, device="cpu")
    d = _draws(3)
    t = _t(d)
    gen = {"encoder": params["encoder"], "decoder": params["decoder"]}
    z = d["z_x"]
    masks = {"m_cx": d["gen_m_cx"], "m_cz": d["gen_m_cz"],
             "m_dec": d["gen_m_dec"][None, None]}
    (jloss, jrec), jgrads = jax.value_and_grad(jtr.generator_loss,
                                               has_aux=True)(
        gen, params["critic_x"], params["critic_z"], d["x"],
        jax.random.PRNGKey(0), hyperbolic, z=z, masks=masks)

    loss, rec = ttr.generator_loss(
        model, t["x"], hyperbolic, t["z_x"],
        {"m_cx": t["gen_m_cx"], "m_cz": t["gen_m_cz"],
         "m_dec": t["gen_m_dec"]})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(rec.item(), float(jrec), rtol=1e-5)
    p_gen = ttr.gen_params(model)
    grads = torch.autograd.grad(loss, list(p_gen.values()))
    _assert_tree_close(dict(zip(p_gen, grads)), jgrads, 1e-4, 1e-6,
                       "generator")


def _jax_epoch_draws(key, n, bs):
    """The JAX trainer's per-epoch indices and draws, rebuilt from its key
    as hypad_tpu/train/trainer.py:464-537 derives them, shaped as the
    port's ``run_epoch`` takes them. One jitted call: the same bits as
    eager ops, without a compile for each of them."""
    draws = jax.jit(_jax_epoch_draw_arrays, static_argnums=(1, 2))(key, n, bs)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _jax_epoch_draw_arrays(key, n, bs):
    nb = n // bs
    keys = jax.random.split(key, 2 * jtr.N_CRITICS + 2)
    critic_idx = jnp.concatenate([
        jtr._shuffled_index(keys[i], n, nb, bs)
        for i in range(jtr.N_CRITICS)])
    S = critic_idx.shape[0]
    kk = jax.random.split(keys[jtr.N_CRITICS], 8)
    gk = jax.random.split(keys[-1], 6)
    draws = {
        "critic_idx": critic_idx,
        "z_x": jax.random.normal(kk[0], (S, bs, LATENT)),
        "a_x": jax.random.uniform(kk[1], (S, bs, W)),
        "z_z": jax.random.normal(kk[2], (S, bs, LATENT)),
        "a_z": jax.random.uniform(kk[3], (S, bs, LATENT)),
        "m_cx": jax.random.bernoulli(kk[4], 0.75, (S, 4, 3 * bs, H)),
        "m_cz": jax.random.bernoulli(kk[5], 0.8, (S, 2, 3 * bs, H)),
        "m_dec": jax.random.bernoulli(kk[6], 0.8,
                                      (S, 1, 1, bs, 128)).reshape(S, bs, 128),
        "gen_idx": jtr._shuffled_index(keys[jtr.N_CRITICS + 1], n, nb, bs),
        "gen_z": jax.random.normal(gk[1], (nb, bs, LATENT)),
        "gen_m_cx": jax.random.bernoulli(gk[2], 0.75, (nb, 4, bs, H)),
        "gen_m_cz": jax.random.bernoulli(gk[3], 0.8, (nb, 2, bs, H)),
        "gen_m_dec": jax.random.bernoulli(
            gk[4], 0.8, (nb, 1, 1, 2 * bs, 128)).reshape(nb, 2 * bs, 128),
    }
    return draws


@functools.cache
def _jax_epoch_fn(hyperbolic):
    """The JAX trainer's jitted epoch, compiled once per geometry."""
    return jtr.build_epoch_fn(LR, hyperbolic, B)


@functools.cache
def _jax_epoch(hyperbolic):
    """(initial params, X, key, JAX state after one epoch, metrics)."""
    kp, kx, ke = jax.random.split(jax.random.PRNGKey(3), 3)
    params = jt.init_tadgan(kp, W, hyperbolic=hyperbolic)
    X = np.asarray(jax.random.uniform(kx, (N_EPOCH, W), minval=-1.0,
                                      maxval=1.0), np.float32)
    state0 = jtr.init_train_state(params, lr=LR, hyperbolic=hyperbolic)
    state1, metrics = _jax_epoch_fn(hyperbolic)(
        jax.tree_util.tree_map(jnp.copy, state0), X, ke)
    return (jax.tree_util.tree_map(np.asarray, params), X, ke,
            jax.tree_util.tree_map(np.asarray, state1),
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("hyperbolic,fused", [(True, "full"), (True, False),
                                              (False, "full"),
                                              (False, True)])
def test_epoch_tracks_jax_with_injected_draws(hyperbolic, fused):
    """One epoch (n = 96, bs = 16: 30 critic steps, 6 generator steps) from
    the same weights with the JAX trainer's draws injected: losses within
    1e-3 relative / 1e-4 absolute and parameters within 5e-3 / 2e-4, the
    bounds tests/test_critic_kernel.py:227-236 holds the fused JAX epoch
    to; optimizer step counters equal."""
    params, X, key, want, jmetrics = _jax_epoch(hyperbolic)
    model = bridge.from_jax_params(params, device="cpu")
    state = ttr.init_train_state(model, LR, hyperbolic)
    state, metrics = ttr.run_epoch(
        state, torch.from_numpy(X), _jax_epoch_draws(key, N_EPOCH, B),
        lr=LR, hyperbolic=hyperbolic, fused_critics=fused)
    for name, value in jmetrics.items():
        np.testing.assert_allclose(metrics[name], value, rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    _assert_tree_close(
        {k: v.detach() for k, v in model.state_dict().items()},
        want.params, 5e-3, 2e-4, "params")
    assert state.epoch == 1
    assert (state.opt_cx.step, state.opt_cz.step, state.opt_gen.step) == (
        int(want.opt_cx.step), int(want.opt_cz.step),
        int(want.opt_gen.step))


def test_epoch_draws_shapes_and_seeding():
    model = bridge.from_jax_params(_jax_params(True), device="cpu")
    a = ttr.epoch_draws(ttr.epoch_generator(0, 0), 100, 16, model)
    b = ttr.epoch_draws(ttr.epoch_generator(0, 0), 100, 16, model)
    c = ttr.epoch_draws(ttr.epoch_generator(0, 1), 100, 16, model)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["z_x"], c["z_x"])
    assert a["critic_idx"].shape == (30, 16)
    assert a["m_cx"].shape == (30, 4, 48, 20) and a["m_cx"].dtype == torch.bool
    assert a["m_dec"].shape == (30, 16, 128)
    assert a["gen_m_dec"].shape == (6, 32, 128)
    for k in range(5):  # each pass is a permutation cut to drop_last
        idx = a["critic_idx"][6 * k:6 * (k + 1)].flatten()
        assert len(set(idx.tolist())) == 96
    assert abs(a["m_cx"].float().mean().item() - 0.75) < 0.02


def test_train_state_bridge_round_trip_and_resume():
    """A JAX state after one epoch carries to the port and back bitwise
    (parameters, packed Adam moments in leaf order, Riemannian Adam
    per-leaf moments, step counters, epoch); the port resumes it for a
    second epoch, and the result carries back and runs in JAX."""
    _, X, _, jstate, _ = _jax_epoch(True)
    state = state_bridge.train_state_from_jax(jstate, device="cpu")
    back = state_bridge.train_state_to_jax(state)
    for field in ("params", "opt_cx", "opt_cz", "opt_gen"):
        want = bridge.flatten_tree(jax.tree_util.tree_map(
            np.asarray, getattr(jstate, field)._asdict()
            if field != "params" else jstate.params))
        got = bridge.flatten_tree(back[field])
        assert sorted(got) == sorted(want), field
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{field} {k}")
    assert int(back["epoch"]) == int(jstate.epoch) == state.epoch == 1

    state = ttr.train_tadgan(state, X, lr=LR, hyperbolic=True,
                             batch_size=B, n_epochs=2, device="cpu")
    assert state.epoch == 2 and state.opt_cx.step == 60
    back = state_bridge.train_state_to_jax(state)
    jstate2 = jtr.TrainState(
        params=back["params"],
        opt_cx=PackedAdamState(**back["opt_cx"]),
        opt_cz=PackedAdamState(**back["opt_cz"]),
        opt_gen=RAdamState(**back["opt_gen"]),
        epoch=jnp.int32(back["epoch"]))
    jstate3, metrics = _jax_epoch_fn(True)(
        jstate2, X, jax.random.PRNGKey(9))
    assert int(jstate3.epoch) == 3 and int(jstate3.opt_gen.step) == 18
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_train_tadgan_needs_cuda_unless_cpu():
    model = bridge.from_jax_params(_jax_params(True), device="cpu")
    X = np.zeros((32, W), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttr.train_tadgan(model, X, lr=LR, hyperbolic=True, batch_size=B,
                             n_epochs=1)
    with pytest.raises(ValueError, match="fused_critics"):
        ttr.train_tadgan(model, X, lr=LR, hyperbolic=True, batch_size=B,
                         n_epochs=1, device="cpu", fused_critics="sideways")
    seen, saved = [], []
    state = ttr.train_tadgan(
        model, X, lr=LR, hyperbolic=True, batch_size=B, n_epochs=3,
        device="cpu", log_cb=lambda e, m: seen.append((e, sorted(m))),
        checkpoint_cb=lambda e, s: saved.append(e))
    assert [e for e, _ in seen] == [1, 2, 3] and state.epoch == 3
    assert seen[0][1] == ["critic_x_loss", "critic_z_loss", "decoder_loss",
                          "rec_loss"]
    assert saved == [2]  # every 10th epoch and epoch n_epochs - 1


def test_reconstruction_loss_gradient_matches_jax_near_the_target():
    """The generator's acosh distance has its own function: its gradient is
    JAX's 1 / sqrt(x^2 - 1) at the rounded argument, within 1e-5 relative
    even where a reconstruction is 1e-3 from its target. The detector's
    log1p form, exact in its forward, differs there by ~4e-2 relative in
    f32 (ROADMAP C), so the loss does not use it."""
    from hypad_tpu.manifold import stereographic as jst
    from hypad_tpu_torch.manifold import stereographic as tst

    rng = np.random.default_rng(0)
    v = (rng.uniform(-1, 1, (16, W)) * 0.05).astype(np.float32)
    u = (v + 1e-3 * 0.05 * rng.standard_normal((16, W))).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda a: jnp.sum(jst.acosh_poincare_distance(a, v)))(u))

    def grad(fn):
        t = torch.from_numpy(u).requires_grad_(True)
        (g,) = torch.autograd.grad(fn(t, torch.from_numpy(v)).sum(), t)
        return g.numpy()

    np.testing.assert_allclose(grad(tst.acosh_poincare_distance_loss), want,
                               rtol=1e-5)
    rel = np.abs(grad(tst.acosh_poincare_distance) - want) / np.abs(want)
    assert rel.max() > 1e-2


def test_fused_critics_defaults_are_jax():
    """C3: every port default of ``fused_critics`` is JAX's (False, the
    autograd step): ``train_tadgan`` and ``train_fleet`` against JAX's
    signatures, and the port's own ``run_epoch``, ``run_fleet_epoch`` and
    ``critic_pass`` with them, so a caller who passes nothing trains as
    JAX's does."""
    import inspect

    from hypad_tpu.train import fleet as jfl
    from hypad_tpu_torch.train import fleet as tfl

    def default(fn):
        return inspect.signature(fn).parameters["fused_critics"].default

    want = default(jtr.train_tadgan)
    assert want is False and default(jfl.train_fleet) is False
    for fn in (ttr.train_tadgan, tfl.train_fleet, ttr.run_epoch,
               ttr.run_fleet_epoch, ttr.critic_pass):
        assert default(fn) is want, fn.__name__
