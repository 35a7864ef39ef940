"""Port parity: the fleet trainer (hypad_tpu_torch.train.fleet), its
signal-axis forwards, losses, critic-step kernels' plain versions and
optimizers, against S single-model runs of the port and against the JAX
fleet epoch, on the CPU.

A fleet is held bitwise to S single-model runs on the same draws: on the
CPU every batched op of a fleet step does each signal's single-model
arithmetic (``models/fleet.py`` ``dense`` runs the one-output layer signal
by signal there). Against JAX the draws are JAX's own (its ragged masked
shuffles), injected, and the bounds are those of
``test_torch_train.py::test_epoch_tracks_jax_with_injected_draws``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.models import tadgan as jt
from hypad_tpu.train import fleet as jfl
from hypad_tpu.train import trainer as jtr
from hypad_tpu_torch import bridge
from hypad_tpu_torch.manifold import kernels as mk
from hypad_tpu_torch.models import fleet as mf
from hypad_tpu_torch.models.tadgan import init_tadgan
from hypad_tpu_torch.optim import radam
from hypad_tpu_torch.parallel.mesh import make_mesh
from hypad_tpu_torch.train import critic_kernel as ck
from hypad_tpu_torch.train import fleet as fl
from hypad_tpu_torch.train import state_bridge
from hypad_tpu_torch.train import trainer as tr

W, B, LATENT, H = 100, 16, 20, 20
LR = 0.005
JAX_LR = 5e-4   # the configs' learning rate


def _windows(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, W)).astype(np.float32)


def _model(i, hyperbolic):
    return init_tadgan(torch.Generator().manual_seed(40 + i), W,
                       hyperbolic=hyperbolic, device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch ops on one thread: the suite runs in several
    worker processes, whose default thread pools would oversubscribe the
    cores and slow these small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_model(got, want, what):
    a, b = got.state_dict(), want.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


@pytest.mark.parametrize("hyperbolic,fused", [(True, "full"), (True, False),
                                              (True, True), (False, "full")])
def test_fleet_epoch_is_bitwise_single_model_epochs(hyperbolic, fused):
    """A ragged 3-signal fleet (96, 70 and 0 windows; seeds 3, 4, 5), one
    epoch: each signal's parameters, moments and step counters are bitwise
    what ``train_tadgan(seed=seed_i)`` gives it alone; the ``n_real = 0``
    dummy comes back bit-unchanged with zero metrics."""
    ns, seeds = [96, 70, 0], [3, 4, 5]
    Xl = [_windows(n, 10 + i) for i, n in enumerate(ns)]
    state = fl.init_fleet_state([_model(i, hyperbolic) for i in range(3)],
                                LR, hyperbolic)
    logs = []
    state = fl.train_fleet(state, Xl, lr=LR, hyperbolic=hyperbolic,
                           batch_size=B, n_epochs=1, seeds=seeds,
                           device="cpu", fused_critics=fused,
                           log_cb=lambda e, m: logs.append((e, m)))
    for i in range(2):
        single = tr.train_tadgan(_model(i, hyperbolic), Xl[i], lr=LR,
                                 hyperbolic=hyperbolic, batch_size=B,
                                 n_epochs=1, seed=seeds[i], device="cpu",
                                 fused_critics=fused,
                                 log_cb=lambda e, m: logs.append((i, m)))
        got = fl.unstack_state(state, i)
        _assert_same_model(got.model, single.model, f"signal {i}")
        for name in ("opt_cx", "opt_cz", "opt_gen"):
            g, w = getattr(got, name), getattr(single, name)
            assert g.step == w.step, name
            if isinstance(g.mu, dict):
                assert all(torch.equal(g.mu[k], w.mu[k]) for k in g.mu)
            else:
                assert torch.equal(g.mu, w.mu) and torch.equal(g.nu, w.nu)
        # the fleet's metric is a masked sum over the step axis, the single
        # model's a mean: the same terms, summed in another order
        for key, value in logs[1 + i][1].items():
            np.testing.assert_allclose(logs[0][1][key][i], value, rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    _assert_same_model(fl.unstack_state(state, 2).model, _model(2, hyperbolic),
                       "dummy")
    assert all(v[2] == 0.0 for v in logs[0][1].values())
    assert fl.unstack_state(state, 2).opt_gen.step == 0


def test_nan_pad_rows_change_nothing():
    """Pad rows filled with NaN train bit for bit as zero padding: no
    valid step reads a pad row, and a masked step's NaNs are discarded."""
    Xl = [_windows(96, 0), _windows(48, 1)]
    draws = tr.fleet_epoch_draws([0, 1], 0, [96, 48], B,
                                 fl.stack_models([_model(0, True)] * 2))
    outs = []
    for pad in (0.0, np.nan):
        Xs, n_real = fl.pad_and_stack(Xl, pad_value=pad)
        state = fl.init_fleet_state([_model(i, True) for i in range(2)], LR,
                                    True)
        state, metrics = tr.run_fleet_epoch(state, torch.from_numpy(Xs),
                                            n_real, draws, lr=LR,
                                            hyperbolic=True)
        outs.append((state, metrics))
    for k, v in outs[0][0].params.items():
        assert torch.equal(v, outs[1][0].params[k]), k
    for v in outs[1][1].values():
        assert np.isfinite(v).all()


def _jax_fleet_draw_arrays(key, n, n_real, bs):
    """One signal's draws inside JAX's ragged fleet body
    (hypad_tpu/train/trainer.py:464-537 with ``ragged=True``): the masked
    shuffles over the padded n rows, shaped as ``fleet_epoch_draws`` lays
    them out for one signal."""
    nb = n // bs
    keys = jax.random.split(key, 2 * jtr.N_CRITICS + 2)
    critic_idx = jnp.concatenate([
        jtr._masked_shuffled_index(keys[i], n, n_real, nb, bs)
        for i in range(jtr.N_CRITICS)])
    S = critic_idx.shape[0]
    kk = jax.random.split(keys[jtr.N_CRITICS], 8)
    gk = jax.random.split(keys[-1], 6)
    return {
        "critic_idx": critic_idx,
        "z_x": jax.random.normal(kk[0], (S, bs, LATENT)),
        "a_x": jax.random.uniform(kk[1], (S, bs, W)),
        "z_z": jax.random.normal(kk[2], (S, bs, LATENT)),
        "a_z": jax.random.uniform(kk[3], (S, bs, LATENT)),
        "m_cx": jax.random.bernoulli(kk[4], 0.75, (S, 4, 3 * bs, H)),
        "m_cz": jax.random.bernoulli(kk[5], 0.8, (S, 2, 3 * bs, H)),
        "m_dec": jax.random.bernoulli(kk[6], 0.8,
                                      (S, 1, 1, bs, 128)).reshape(S, bs, 128),
        "gen_idx": jtr._masked_shuffled_index(keys[jtr.N_CRITICS + 1], n,
                                              n_real, nb, bs),
        "gen_z": jax.random.normal(gk[1], (nb, bs, LATENT)),
        "gen_m_cx": jax.random.bernoulli(gk[2], 0.75, (nb, 4, bs, H)),
        "gen_m_cz": jax.random.bernoulli(gk[3], 0.8, (nb, 2, bs, H)),
        "gen_m_dec": jax.random.bernoulli(
            gk[4], 0.8, (nb, 1, 1, 2 * bs, 128)).reshape(nb, 2 * bs, 128),
    }


@functools.cache
def _jax_fleet_epoch(hyperbolic, lens):
    """(X list, initial stacked JAX state, keys, JAX fleet state after one
    ragged epoch, its (S,) metrics)."""
    Xl = [_windows(n, 20 + i) for i, n in enumerate(lens)]
    params = [jt.init_tadgan(jax.random.PRNGKey(30 + i), W,
                             hyperbolic=hyperbolic) for i in range(len(lens))]
    state0 = jfl.init_fleet_state(params, JAX_LR, hyperbolic)
    Xs, n_real = jfl.pad_and_stack(Xl)
    keys = jnp.stack([jax.random.PRNGKey(50 + i) for i in range(len(lens))])
    fn = jfl.build_fleet_epoch_fn(JAX_LR, hyperbolic, B, ragged=True)
    state1, metrics = fn(jax.tree_util.tree_map(jnp.copy, state0),
                         jnp.asarray(Xs), keys, jnp.asarray(n_real))
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (Xl, host(state0), keys, host(state1),
            {k: np.asarray(v) for k, v in metrics.items()})


@pytest.mark.parametrize("hyperbolic,lens", [(False, (64, 64)),
                                             (True, (80, 48))])
def test_fleet_epoch_tracks_jax_fleet_with_injected_draws(hyperbolic, lens):
    """One fleet epoch, equal lengths (Euclidean) and ragged (hyperbolic),
    from JAX's stacked initial state carried over by the state bridge, with
    JAX's ragged-body draws injected: (S,) metrics within 1e-3 / 1e-4,
    parameters within 5e-3 / 2e-4, per-signal step counters equal."""
    Xl, state0, keys, want, jmetrics = _jax_fleet_epoch(hyperbolic, lens)
    Xs, n_real = fl.pad_and_stack(Xl)
    draw_fn = jax.jit(jax.vmap(_jax_fleet_draw_arrays,
                               in_axes=(0, None, 0, None)),
                      static_argnums=(1, 3))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draw_fn(
        keys, Xs.shape[1], jnp.asarray(n_real), B).items()}
    state = state_bridge.fleet_state_from_jax(state0, device="cpu")
    state, metrics = tr.run_fleet_epoch(state, torch.from_numpy(Xs), n_real,
                                        draws, lr=JAX_LR,
                                        hyperbolic=hyperbolic)
    for name, value in jmetrics.items():
        np.testing.assert_allclose(metrics[name], value, rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    got = bridge.flatten_tree(bridge.to_jax_stacked_params(state.params))
    for key, value in bridge.flatten_tree(want.params).items():
        np.testing.assert_allclose(got[key], value, rtol=5e-3, atol=2e-4,
                                   err_msg=key)
    for name in ("opt_cx", "opt_cz", "opt_gen"):
        np.testing.assert_array_equal(getattr(state, name).step,
                                      getattr(want, name).step)


def test_fleet_state_bridge_round_trip_and_unstack():
    """JAX's stacked state carries to the port and back bitwise; signal i
    of the port's fleet is signal i of JAX's (``unstack_state``), and
    ``unstack_model(stack_models(ms), i)`` is ``ms[i]`` bitwise."""
    _, state0, _, jstate, _ = _jax_fleet_epoch(True, (80, 48))
    for js in (state0, jstate):
        fleet = state_bridge.fleet_state_from_jax(js, device="cpu")
        back = state_bridge.fleet_state_to_jax(fleet)
        for field in ("params", "opt_cx", "opt_cz", "opt_gen"):
            want = bridge.flatten_tree(
                js.params if field == "params"
                else getattr(js, field)._asdict())
            got = bridge.flatten_tree(back[field])
            assert sorted(got) == sorted(want), field
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{field} {k}")
    one = state_bridge.train_state_from_jax(jfl.unstack_state(jstate, 1),
                                            device="cpu")
    got = fl.unstack_state(state_bridge.fleet_state_from_jax(jstate, "cpu"),
                           1)
    _assert_same_model(got.model, one.model, "unstack_state")
    assert got.opt_gen.step == one.opt_gen.step
    models = [_model(i, True) for i in range(3)]
    stacked = fl.stack_models(models)
    for i, m in enumerate(models):
        _assert_same_model(fl.unstack_model(stacked, i), m, "unstack_model")


def test_fleet_forwards_and_kernel_plain_versions_per_signal():
    """The signal-axis forwards, K1's plain version with a signal axis and
    K4 / K5's fleet plain versions give each signal its single-model
    values bit for bit on the CPU, and launch no kernel there."""
    models = [_model(i, True) for i in range(3)]
    P = fl.stack_models(models)
    x = torch.from_numpy(np.stack([_windows(B, 60 + i) for i in range(3)]))
    d = [tr.epoch_draws(torch.Generator().manual_seed(70 + i), 64, B,
                        models[0]) for i in range(3)]
    draws = {k: torch.stack([di[k][0] for di in d]) for k in tr.CRITIC_DRAWS}
    before = (mk.mobius_linear_kernel.launches,
              ck.critic_step_fused_full.launches,
              ck.critics_fused_grads.launches)
    hyper, eucl, hyper_x, critic = mf.forward_eval(P, x, True)
    k1 = mk.mobius_linear_kernel(x.contiguous(),
                                 P["decoder.hyperbolic_linear.w"],
                                 P["decoder.hyperbolic_linear.b"])
    k5 = ck.critic_step_fused_full_fleet(P, x, draws, True)
    bigx, bigz = ck.critic_step_inputs_fleet(P, x, draws, True)
    k4 = ck.critics_fused_grads_fleet(P, bigx, bigz, draws["m_cx"],
                                      draws["m_cz"])
    for i, m in enumerate(models):
        z = m["encoder"](x[i])
        h1, e1 = m["decoder"](z)
        assert torch.equal(hyper[i], h1) and torch.equal(eucl[i], e1)
        assert torch.equal(hyper_x[i], m["decoder"].hyperbolic_linear(x[i]))
        assert torch.equal(k1[i], hyper_x[i])
        assert torch.equal(critic[i], m["critic_x"](x[i])[:, 0])
        one = ck.critic_step_plain(m, x[i], {k: v[i] for k, v in
                                             draws.items()}, True)
        for out in (k5, k4):
            assert torch.equal(out[0][i], one[0])
            assert torch.equal(out[1][i], one[1])
            for g_fleet, g_one in ((out[2], one[2]), (out[3], one[3])):
                for k in g_one:
                    assert torch.equal(g_fleet[k][i], g_one[k]), k
    assert (mk.mobius_linear_kernel.launches,
            ck.critic_step_fused_full.launches,
            ck.critics_fused_grads.launches) == before


@pytest.mark.parametrize("kernel", ["K5", "K4"])
def test_fleet_kernel_wrappers_refuse_leaves_of_another_shape(kernel):
    """K5's and K4's signal-axis wrappers check every stacked leaf they
    would hand the kernel: stacked parameters of fewer signals than the
    inputs, or a leaf whose per-signal shape is not the one the dims name,
    raise a ValueError before any launch (on the card the kernel would
    read and write past those buffers)."""
    models = [_model(i, True) for i in range(3)]
    x = torch.from_numpy(np.stack([_windows(B, 60 + i) for i in range(3)]))
    d = [tr.epoch_draws(torch.Generator().manual_seed(70 + i), 64, B,
                        models[0]) for i in range(3)]
    draws = {k: torch.stack([di[k][0] for di in d]) for k in tr.CRITIC_DRAWS}
    P = fl.stack_models(models)
    bigx, bigz = ck.critic_step_inputs_fleet(P, x, draws, True)

    def call(params):
        if kernel == "K5":
            return ck.critic_step_fused_full_fleet(params, x, draws, True)
        return ck.critics_fused_grads_fleet(params, bigx, bigz,
                                            draws["m_cx"], draws["m_cz"])

    call(P)
    two = fl.stack_models(models[:2])
    with pytest.raises(ValueError, match="expected \\(3, "):
        call(two)
    for key in ("critic_x.dense3.w", "critic_z.dense3.b") + (
            ("encoder.lstm.0.w_ih_rev", "decoder.hyperbolic_linear.b")
            if kernel == "K5" else ()):
        bad = dict(P)
        bad[key] = torch.cat([P[key], P[key][:, :1]], dim=1).contiguous()
        with pytest.raises(ValueError, match=key.replace(".", "\\.")):
            call(bad)


def test_fleet_optimizers_keep_skipped_steps_and_count_per_signal():
    """Masked fleet updates: a signal that skips a step keeps its
    parameters, moments and step counter bitwise, and every taken step is
    its single-model optimizer's update (Adam and Riemannian Adam with
    stabilize 3, so the per-signal project select is crossed)."""
    models = [_model(i, True) for i in range(2)]
    P = fl.stack_models(models)
    valid = np.array([[1, 1], [1, 0], [0, 1], [1, 1]], bool)
    torch.manual_seed(0)
    for fleet_opt, single_opt in (
            (radam.adam_fleet(LR), radam.adam(LR)),
            (radam.riemannian_adam_fleet(LR, weight_decay=1e-5,
                                         stabilize=3),
             radam.riemannian_adam(LR, weight_decay=1e-5, stabilize=3))):
        p = {k: v.clone() for k, v in P.items() if k.startswith("decoder")}
        ps = [{k: v[i].clone() for k, v in p.items()} for i in range(2)]
        state = fleet_opt.init(p)
        singles = [single_opt.init(q) for q in ps]
        sched = fleet_opt.schedule(state, valid)
        for j in range(len(valid)):
            g = {k: torch.randn_like(v) for k, v in p.items()}
            state = fleet_opt.update(g, state, p, sched, j)
            for i in range(2):
                if valid[j, i]:
                    singles[i] = single_opt.update(
                        {k: v[i] for k, v in g.items()}, singles[i], ps[i])
        for i in range(2):
            assert state.step[i] == singles[i].step == valid[:, i].sum()
            for k in p:
                assert torch.equal(p[k][i], ps[i][k]), k


def test_train_fleet_cadence_staging_and_refusals():
    """log_cb after every epoch with (S,) finite metrics; checkpoint_cb
    where JAX's chunks end (hypad_tpu/train/fleet.py:355-366): epochs 10
    and 11 of 12, epoch 2 of 3 resumed from 1; the staged stack is the
    padded windows; mixed lengths with ``ragged=False`` raise, and so does
    ``canonical`` with it; ``mesh`` (a 2-shard CPU mesh) and ``canonical``
    (2 signals padded to JAX's rungs: 4 signals of 128 windows) run, the
    real signals' staged windows kept, each state with its pad signals."""
    Xl = [_windows(48, 0), _windows(32, 1)]
    logs, ckpts = [], []
    state = fl.init_fleet_state([_model(i, False) for i in range(2)], LR,
                                False)
    state, (Xs, n_real) = fl.train_fleet(
        state, Xl, lr=LR, hyperbolic=False, batch_size=B, n_epochs=12,
        device="cpu", return_staged=True,
        log_cb=lambda e, m: logs.append((e, m)),
        checkpoint_cb=lambda e, s: ckpts.append(e))
    assert [e for e, _ in logs] == list(range(1, 13)) and ckpts == [10, 11]
    assert state.epoch == 12
    for _, m in logs:
        for v in m.values():
            assert v.shape == (2,) and np.isfinite(v).all()
    np.testing.assert_array_equal(Xs[1, :32].numpy(), Xl[1])
    assert list(n_real) == [48, 32]
    ckpts.clear()
    fl.train_fleet(state, Xl, lr=LR, hyperbolic=False, batch_size=B,
                   n_epochs=3, start_epoch=1, device="cpu",
                   checkpoint_cb=lambda e, s: ckpts.append(e))
    assert ckpts == [2] and state.epoch == 3
    for kw in ({"ragged": False}, {"ragged": False, "canonical": True}):
        with pytest.raises(ValueError):
            fl.train_fleet(state, Xl, lr=LR, hyperbolic=False, batch_size=B,
                           n_epochs=4, device="cpu", **kw)
    mesh = make_mesh([torch.device("cpu")] * 2)
    for kw, shape in (({"mesh": mesh}, (2, 48, W)),
                      ({"canonical": True}, (4, 128, W)),
                      ({"mesh": mesh, "canonical": True}, (4, 128, W))):
        out, (Xs, n_real) = fl.train_fleet(
            fl.init_fleet_state([_model(i, False) for i in range(2)], LR,
                                False), Xl, lr=LR, hyperbolic=False,
            batch_size=B, n_epochs=1, device="cpu", return_staged=True, **kw)
        assert tuple(Xs.shape) == shape and list(n_real) == [48, 32], kw
        assert out.n_signals == shape[0] and out.epoch == 1, kw
        np.testing.assert_array_equal(Xs[1, :32].numpy(), Xl[1])
