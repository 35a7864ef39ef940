"""Port parity: the fleet's compiled epoch (hypad_tpu_torch.train.graphed
``FleetProgram``) and ``train_fleet``'s chunks (``epochs_per_call``,
``start_epoch``), on the CPU.

The card captures ``FleetProgram``'s two fleet step bodies as CUDA graphs;
on the CPU the same bodies run eagerly, so these tests hold the code the
card replays:

* (a) two epochs of the bodies are bitwise ``trainer.fleet_epoch_device``'s
  on the same draws (parameters, moments, per-signal step counters,
  metrics) for every ``fused_critics`` path in the hyperbolic geometry and
  ``"full"`` in the Euclidean one, on an equal-length fleet, a ragged one
  with an ``n_real = 0`` signal (which comes back bit-unchanged) and a
  canonical one (masked shuffles over padded rows);
* (b) with JAX's ragged-body draws injected, an epoch of the bodies tracks
  JAX's vmapped fleet epoch within the bounds of test_torch_fleet.py's
  ``test_fleet_epoch_tracks_jax_fleet_with_injected_draws``;
* (c) ``train_fleet``'s ``checkpoint_cb`` and ``log_cb`` epochs are JAX's
  ``train_fleet``'s: JAX's own on a tiny fleet for n_epochs 3, and its
  chunk rule (hypad_tpu/train/fleet.py:356-413) for a table of
  ``(n_epochs, start_epoch, epochs_per_call)``;
* (d) ``epochs_per_call`` 1, 2 and 10 give the same bits, and a second
  call on the same ``FleetState`` reuses the program kept there.

Weights come from the port's ``init_tadgan`` seeds (JAX's through the
state bridge for (b)); inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.models import tadgan as jt
from hypad_tpu.train import fleet as jfl
from hypad_tpu_torch import bridge
from hypad_tpu_torch.models.tadgan import init_tadgan
from hypad_tpu_torch.optim.radam import AdamState, RAdamState
from hypad_tpu_torch.train import fleet as fl
from hypad_tpu_torch.train import graphed
from hypad_tpu_torch.train import state_bridge
from hypad_tpu_torch.train import trainer as tr
from test_torch_fleet import (
    B as JAX_B,
    JAX_LR,
    _jax_fleet_draw_arrays,
    _jax_fleet_epoch,
)

W, B, LR = 8, 8, 5e-3
SEEDS = (3, 4, 5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch ops on one thread: the suite runs in several
    worker processes, whose default thread pools would oversubscribe the
    cores and slow these small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, W)).astype(
        np.float32)


def _models(S, hyperbolic):
    return [init_tadgan(torch.Generator().manual_seed(40 + i), W,
                        hyperbolic=hyperbolic, device="cpu")
            for i in range(S)]


# (lengths, padded row count of a canonical fleet): 40 windows of batch 8
# are 5 generator steps an epoch, so two epochs cross the Riemannian Adam's
# stabilize step 10
FLEETS = {"equal": ((40, 40, 40), None),
          "ragged": ((40, 24, 0), None),
          "canonical": ((40, 24, 0), 48)}


def _fleet(kind):
    lens, n_pad = FLEETS[kind]
    Xs, n_real = fl.pad_and_stack(
        [_windows(n, 10 + i) if n else np.zeros((1, W), np.float32)
         for i, n in enumerate(lens)], target_len=n_pad)
    n_real[:] = lens
    return torch.from_numpy(Xs), n_real, n_pad


def _opt_tensors(opt):
    out = {}
    for part in ("mu", "nu"):
        v = getattr(opt, part)
        items = v.items() if isinstance(v, dict) else [("", v)]
        out.update({f"{part}.{k}": t for k, t in items})
    return out


def _assert_fleets_equal(got, want):
    assert list(got.params) == list(want.params)
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), f"parameter {k}"
    for name in ("opt_cx", "opt_cz", "opt_gen"):
        g, w = getattr(got, name), getattr(want, name)
        assert type(g) is type(w), name
        np.testing.assert_array_equal(g.step, w.step, err_msg=name)
        tg, tw = _opt_tensors(g), _opt_tensors(w)
        assert sorted(tg) == sorted(tw), name
        for k in tw:
            assert torch.equal(tg[k], tw[k]), f"{name} {k}"
    assert got.epoch == want.epoch


def _assert_metrics_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kind", list(FLEETS))
@pytest.mark.parametrize("hyperbolic,fused", [(True, "full"), (True, True),
                                              (True, False),
                                              (False, "full")])
def test_fleet_bodies_are_fleet_epoch_device_bitwise(kind, hyperbolic,
                                                     fused):
    """(a): two epochs of the fleet bodies equal two
    ``fleet_epoch_device`` epochs on the same draws bit for bit:
    parameters, every moment, the per-signal step counters, the epoch and
    the (S,) metrics; an ``n_real = 0`` signal keeps its initial bits and
    step 0."""
    Xs, n_real, n_pad = _fleet(kind)
    states = [fl.init_fleet_state(_models(3, hyperbolic), LR, hyperbolic)
              for _ in range(2)]
    draws = [tr.fleet_epoch_draws(SEEDS, e, n_real, B, states[0].params,
                                  n_pad=n_pad) for e in range(2)]
    want = []
    for d in draws:
        _, means = tr.fleet_epoch_device(states[0], Xs, n_real, d, lr=LR,
                                         hyperbolic=hyperbolic,
                                         fused_critics=fused)
        want.append(tr.fleet_metrics(means.numpy()))
    program = graphed.fleet_program_for(
        states[1], Xs, n_real, lr=LR, hyperbolic=hyperbolic, batch_size=B,
        fused_critics=fused)
    assert not program.capture and states[1].program is None
    got = program.run(states[1], draws)
    _assert_metrics_equal(got, want)
    _assert_fleets_equal(states[1], states[0])
    nb = (n_pad or max(n_real)) // B
    assert program.nb == nb and states[1].epoch == 2
    steps = 2 * (np.asarray(n_real) // B)
    np.testing.assert_array_equal(states[1].opt_gen.step, steps)
    np.testing.assert_array_equal(states[1].opt_cx.step, 5 * steps)
    assert isinstance(states[1].opt_gen,
                      RAdamState if hyperbolic else AdamState)
    if 0 in n_real:
        i = list(n_real).index(0)
        init = fl.stack_models(_models(3, hyperbolic))
        for k, v in states[1].params.items():
            assert torch.equal(v[i], init[k][i]), k
        assert all(m[k][i] == 0.0 for m in got for k in m)


def test_fleet_bodies_track_jax_fleet_epoch_with_injected_draws():
    """(b): one ragged hyperbolic fleet epoch (80 and 48 windows of 100,
    batch 16) of the bodies from JAX's stacked initial state carried over
    by the state bridge, with JAX's ragged-body draws injected, against
    JAX's ``build_fleet_epoch_fn``: (S,) metrics within 1e-3 / 1e-4,
    parameters within 5e-3 / 2e-4, per-signal step counters equal (the
    bounds of test_torch_fleet.py, whose cached JAX epoch this reuses)."""
    Xl, state0, keys, want, jmetrics = _jax_fleet_epoch(True, (80, 48))
    Xs, n_real = fl.pad_and_stack(Xl)
    draw_fn = jax.jit(jax.vmap(_jax_fleet_draw_arrays,
                               in_axes=(0, None, 0, None)),
                      static_argnums=(1, 3))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draw_fn(
        keys, Xs.shape[1], jnp.asarray(n_real), JAX_B).items()}
    state = state_bridge.fleet_state_from_jax(state0, device="cpu")
    program = graphed.FleetProgram(state.params, torch.from_numpy(Xs),
                                   n_real, lr=JAX_LR, hyperbolic=True,
                                   batch_size=JAX_B, fused_critics=False)
    (metrics,) = program.run(state, [draws])
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


def _train(n_epochs, states=None, S=2, hyperbolic=False, lens=(16, 16),
           **kw):
    """The port's ``train_fleet`` on the CPU: (states, checkpoint epochs,
    log epochs, metrics)."""
    saved, logged = [], []
    states = states or fl.init_fleet_state(_models(S, hyperbolic), LR,
                                           hyperbolic)
    states = fl.train_fleet(
        states, [_windows(n, 20 + i) for i, n in enumerate(lens)], lr=LR,
        hyperbolic=hyperbolic, batch_size=B, n_epochs=n_epochs,
        seeds=SEEDS[:S], device="cpu", checkpoint_cb=lambda e, s: saved.append(e),
        log_cb=lambda e, m: logged.append((e, m)), **kw)
    return states, saved, [e for e, _ in logged], [m for _, m in logged]


def test_cadence_matches_jax_train_fleet():
    """(c), the case run on both sides: 3 epochs of JAX's ``train_fleet``
    and the port's on the same two signals (16 windows of 8, batch 8,
    Euclidean) fire ``checkpoint_cb`` and ``log_cb`` at the same epochs
    with (S,) finite metrics. JAX runs one epoch a call (one program to
    compile; its cadence does not depend on it), the port its default
    10."""
    X = [_windows(16, 20 + i) for i in range(2)]
    jsaved, jlogged = [], []
    params = [jt.init_tadgan(jax.random.PRNGKey(i), signal_shape=W,
                             hyperbolic=False) for i in range(2)]
    jfl.train_fleet(jfl.init_fleet_state(params, lr=LR, hyperbolic=False),
                    X, lr=LR, hyperbolic=False, batch_size=B, n_epochs=3,
                    epochs_per_call=1,
                    checkpoint_cb=lambda e, s: jsaved.append(e),
                    log_cb=lambda e, m: jlogged.append(e))
    states, saved, logged, metrics = _train(3)
    assert (saved, logged) == (jsaved, jlogged) == ([2], [1, 2, 3])
    assert states.epoch == 3
    for m in metrics:
        for v in m.values():
            assert v.shape == (2,) and np.isfinite(v).all()


def _jax_cadence(n_epochs, start_epoch, epochs_per_call):
    """The checkpoint epochs of JAX's ``train_fleet`` chunk loop
    (hypad_tpu/train/fleet.py:356-366, :408-412), written out."""
    saved, e = [], start_epoch
    while e < n_epochs:
        nxt = min(((e // 10) + 1) * 10, n_epochs)
        if e < n_epochs - 1 < nxt:
            nxt = n_epochs - 1
        e = min(nxt, e + max(epochs_per_call, 1))
        if e % 10 == 0 or e == n_epochs - 1:
            saved.append(e)
    return saved


@pytest.mark.parametrize("n_epochs,start_epoch,epochs_per_call,saved", [
    (1, None, 10, []),
    (3, None, 10, [2]),
    (12, None, 10, [10, 11]),
    (25, None, 10, [10, 20, 24]),
    (25, None, 1, [10, 20, 24]),
    (14, 3, 4, [10, 13]),
    (40, 20, 10, [30, 39, 40]),
    (21, 0, 7, [10, 20]),
])
def test_cadence_is_jax_cadence(n_epochs, start_epoch, epochs_per_call,
                                saved):
    """(c): for each case the port's checkpoint epochs are JAX's (its
    chunk loop written out, and the list), ``log_cb`` fires once for each
    epoch from the start, and the fleet's epoch ends at ``n_epochs``."""
    assert saved == _jax_cadence(n_epochs, start_epoch or 0,
                                 epochs_per_call)
    states, got_saved, logged, _ = _train(
        n_epochs, lens=(8, 8), start_epoch=start_epoch,
        epochs_per_call=epochs_per_call)
    first = start_epoch or 0
    assert got_saved == saved
    assert logged == list(range(first + 1, n_epochs + 1))
    assert states.epoch == n_epochs
    np.testing.assert_array_equal(states.opt_gen.step,
                                  [n_epochs - first] * 2)


def test_chunk_size_changes_no_bit_and_the_program_is_reused(monkeypatch):
    """(d): 5 hyperbolic epochs of a ragged fleet (24 and 16 windows of 8,
    batch 8: 15 and 10 generator steps, so the stabilize step falls
    inside) through ``train_fleet(device="cpu")`` give the same
    parameters, moments, counters, metrics and checkpoint epochs for
    ``epochs_per_call`` 1, 2 and 10. Resumed from the 2-epoch state, with
    the program of the first call kept in the state (as the card keeps
    it), the second call reuses that program and ends on the straight
    run's bits; a fleet of other lengths gets a new program."""
    kw = dict(hyperbolic=True, lens=(24, 16))
    runs = [_train(5, epochs_per_call=k, **kw) for k in (1, 2, 10)]
    for states, saved, logged, metrics in runs[1:]:
        _assert_fleets_equal(states, runs[0][0])
        assert (saved, logged) == runs[0][1:3] == ([4], [1, 2, 3, 4, 5])
        _assert_metrics_equal(metrics, runs[0][3])
    np.testing.assert_array_equal(runs[0][0].opt_gen.step, [15, 10])

    half, _, _, first = _train(2, **kw)
    Xs, n_real = fl.pad_and_stack([_windows(n, 20 + i)
                                   for i, n in enumerate(kw["lens"])])
    program = graphed.fleet_program_for(
        half, torch.from_numpy(Xs), n_real, lr=LR, hyperbolic=True,
        batch_size=B, fused_critics=False)
    half.program = program
    made = []
    real_init = graphed.FleetProgram.__init__

    def recording(self, *args, **kwargs):
        made.append(self)
        real_init(self, *args, **kwargs)

    monkeypatch.setattr(graphed.FleetProgram, "__init__", recording)
    resumed, _, logged, rest = _train(5, half, **kw)
    assert made == [] and resumed.program is program
    graphed.fleet_program_for(
        half, torch.from_numpy(Xs[:, :16]), [16, 16], lr=LR,
        hyperbolic=True, batch_size=B, fused_critics=False)
    assert len(made) == 1 and made[0] is not program
    _assert_fleets_equal(resumed, runs[0][0])
    assert logged == [3, 4, 5]
    _assert_metrics_equal(first + rest, runs[0][3])


@pytest.mark.parametrize("n_pad", [None, 48])
def test_fleet_draws_do_not_depend_on_the_thread_pool(monkeypatch, n_pad):
    """``fleet_epoch_draws`` on a pool of ``DRAW_THREADS`` threads gives
    the bits of the same draws made one signal after another, ragged (40,
    24 and 0 windows) and canonical (48 padded rows)."""
    params = fl.stack_models(_models(1, True))
    n_real = [40, 24, 0]
    got = tr.fleet_epoch_draws(SEEDS, 2, n_real, B, params, n_pad=n_pad)
    monkeypatch.setattr(tr, "DRAW_THREADS", 1)
    want = tr.fleet_epoch_draws(SEEDS, 2, n_real, B, params, n_pad=n_pad)
    assert list(got) == list(want)
    for k, v in want.items():
        assert v.dtype == got[k].dtype and torch.equal(got[k], v), k
