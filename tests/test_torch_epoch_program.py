"""Port parity: the compiled epoch (hypad_tpu_torch.train.graphed) and
``train_tadgan``'s chunks (``epochs_per_call``, ``start_epoch``), on the CPU.

The card captures ``graphed.EpochProgram``'s two step bodies as CUDA graphs;
on the CPU the same bodies run eagerly, so these tests hold the code the
card replays:

* (a) ``train_tadgan``'s checkpoint and log cadence is JAX's: JAX's own
  ``train_tadgan`` on the same tiny input for n_epochs 3, and the lists of
  tests/test_epoch_chunking.py:25-47 for the other cases;
* (b) two epochs of the step bodies are bitwise ``run_epoch``'s on the same
  draws (parameters, moments, step counters, metrics) for every
  ``fused_critics`` path in both geometries;
* (c) with the JAX trainer's draws injected, an epoch of the bodies tracks
  JAX's ``build_epoch_fn`` within the bounds of
  ``test_torch_train.py::test_epoch_tracks_jax_with_injected_draws``;
* (d) the chunk size changes no bit of a run.

Weights come from the JAX ``init_tadgan`` through ``bridge.from_jax_params``;
inputs from numpy seeds."""

import functools

import jax
import numpy as np
import pytest
import torch

from hypad_tpu.models import tadgan as jt
from hypad_tpu.train import trainer as jtr
from hypad_tpu_torch import bridge
from hypad_tpu_torch.optim.radam import AdamState
from hypad_tpu_torch.train import graphed
from hypad_tpu_torch.train import trainer as ttr
from test_torch_train import (
    B as JAX_B,
    LR as JAX_LR,
    N_EPOCH,
    _assert_tree_close,
    _jax_epoch,
    _jax_epoch_draws,
)

CADENCE_W, CADENCE_N, CADENCE_B = 8, 32, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch ops on one thread: the suite runs in several
    worker processes, whose default thread pools would oversubscribe the
    cores and slow these small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _jax_params(width, hyperbolic):
    """JAX's ``init_tadgan`` weights (numpy), made once a worker."""
    return jax.tree_util.tree_map(np.asarray, jt.init_tadgan(
        jax.random.PRNGKey(0), width, hyperbolic=hyperbolic))


def _model(width, hyperbolic):
    return bridge.from_jax_params(_jax_params(width, hyperbolic),
                                  device="cpu")


def _windows(n, width, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, width)).astype(
        np.float32)


def _train(model, X, n_epochs, batch_size, hyperbolic=False, **kw):
    """The port's ``train_tadgan`` on the CPU: (state, checkpoint epochs,
    log epochs, metrics)."""
    saved, logged = [], []
    state = ttr.train_tadgan(
        model, X, lr=5e-4, hyperbolic=hyperbolic, batch_size=batch_size,
        n_epochs=n_epochs, device="cpu",
        checkpoint_cb=lambda e, s: saved.append(e),
        log_cb=lambda e, m: logged.append((e, m)), **kw)
    return state, saved, [e for e, _ in logged], [m for _, m in logged]


def _moments(state):
    out = {}
    for name in ("opt_cx", "opt_cz", "opt_gen"):
        opt = getattr(state, name)
        for part in ("mu", "nu"):
            v = getattr(opt, part)
            items = v.items() if isinstance(v, dict) else [("", v)]
            out.update({f"{name}.{part}.{k}": t for k, t in items})
    return out


def _assert_states_equal(got, want):
    for (k, a), (k2, b) in zip(got.model.state_dict().items(),
                               want.model.state_dict().items()):
        assert k == k2
        assert torch.equal(a, b), f"parameter {k}"
    mg, mw = _moments(got), _moments(want)
    assert sorted(mg) == sorted(mw)
    for k in mw:
        assert torch.equal(mg[k], mw[k]), f"moment {k}"
    for name in ("opt_cx", "opt_cz", "opt_gen"):
        assert getattr(got, name).step == getattr(want, name).step, name
    assert got.epoch == want.epoch


def test_step_bodies_track_jax_epoch_with_injected_draws():
    """(c): one hyperbolic epoch of the bodies under the configs' default
    critic step (``fused_critics`` False) from JAX's weights, with the JAX
    trainer's own draws injected (96 windows, batch 16), against JAX's
    ``build_epoch_fn``: losses within 1e-3 relative / 1e-4 absolute,
    parameters within 5e-3 / 2e-4 (the bounds of
    test_torch_train.py::test_epoch_tracks_jax_with_injected_draws, whose
    cached JAX epoch this reuses), step counters equal. The other paths
    and the Euclidean model are (b)'s, bitwise ``run_epoch``, which that
    test holds against JAX."""
    hyperbolic, fused = True, False
    params, X, key, want, jmetrics = _jax_epoch(hyperbolic)
    model = bridge.from_jax_params(params, device="cpu")
    state = ttr.init_train_state(model, JAX_LR, hyperbolic)
    program = graphed.EpochProgram(
        model, torch.from_numpy(np.array(X)), lr=JAX_LR, hyperbolic=hyperbolic,
        batch_size=JAX_B, fused_critics=fused)
    (metrics,) = program.run(state, [_jax_epoch_draws(key, N_EPOCH, JAX_B)])
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


def test_chunk_sizes_are_jax_chunks():
    """``chunk_sizes`` cuts as JAX's ``train_tadgan`` does
    (hypad_tpu/train/trainer.py:611-621)."""
    assert graphed.chunk_sizes(0, 40, 10) == [10, 10, 10, 9, 1]
    assert graphed.chunk_sizes(0, 25, 10) == [10, 10, 4, 1]
    assert graphed.chunk_sizes(0, 3, 10) == [2, 1]
    assert graphed.chunk_sizes(0, 1, 10) == [1]
    assert graphed.chunk_sizes(20, 40, 10) == [10, 9, 1]
    assert graphed.chunk_sizes(0, 25, 1) == [1] * 25
    assert graphed.chunk_sizes(3, 14, 4) == [4, 3, 3, 1]
    assert graphed.chunk_sizes(5, 5, 10) == []


def test_cadence_matches_jax_train_tadgan():
    """(a), the case run on both sides: 3 epochs of JAX's ``train_tadgan``
    and the port's on the same windows (64 of 100, batch 32, Euclidean,
    the same weights) fire ``checkpoint_cb`` and ``log_cb`` at the same
    epochs and end at the same ``epoch``. JAX runs one epoch a call (one
    program to compile; its cadence does not depend on it,
    tests/test_epoch_chunking.py:43-45), the port its default 10."""
    X = _windows(64, 100)
    jparams = _jax_params(100, False)
    jsaved, jlogged = [], []
    jstate = jtr.train_tadgan(
        jtr.init_train_state(jparams, lr=5e-4, hyperbolic=False), X,
        lr=5e-4, hyperbolic=False, batch_size=32, n_epochs=3,
        epochs_per_call=1,
        checkpoint_cb=lambda e, s: jsaved.append(e),
        log_cb=lambda e, m: jlogged.append(e))
    model = bridge.from_jax_params(jparams, device="cpu")
    state, saved, logged, metrics = _train(model, X, 3, 32)
    assert (saved, logged) == (jsaved, jlogged) == ([2], [1, 2, 3])
    assert state.epoch == int(jstate.epoch) == 3
    assert all(np.isfinite(v) for m in metrics for v in m.values())


@pytest.mark.parametrize("n_epochs,start_epoch,epochs_per_call,saved,epoch", [
    # tests/test_epoch_chunking.py:25-34 (JAX's checkpoint_cadence cases)
    (1, None, 10, [], 1),
    (3, None, 10, [2], 3),
    (25, None, 10, [10, 20, 24], 25),
    (40, None, 10, [10, 20, 30, 39, 40], 40),
    # :37-40, resuming: the counter starts at 20, the state counts the
    # epochs run in it
    (40, 20, 10, [30, 39, 40], 20),
    # :43-45, one epoch a call
    (25, None, 1, [10, 20, 24], 25),
])
def test_cadence_is_jax_cadence(n_epochs, start_epoch, epochs_per_call,
                                saved, epoch):
    """(a): the port's checkpoint epochs are JAX's lists for every case of
    tests/test_epoch_chunking.py, its ``log_cb`` fires once for each epoch
    from the start, and ``state.epoch`` is JAX's."""
    model = _model(CADENCE_W, False)
    state, got_saved, logged, _ = _train(
        model, _windows(CADENCE_N, CADENCE_W), n_epochs, CADENCE_B,
        start_epoch=start_epoch, epochs_per_call=epochs_per_call)
    first = start_epoch or 0
    assert got_saved == saved
    assert logged == list(range(first + 1, n_epochs + 1))
    assert state.epoch == epoch
    steps = (epoch * (CADENCE_N // CADENCE_B))
    assert (state.opt_cx.step, state.opt_gen.step) == (5 * steps, steps)


def test_chunk_size_changes_no_bit():
    """(d): ``train_tadgan(device="cpu")`` for 5 hyperbolic epochs (16
    windows of 8, batch 8: 10 generator steps, so the stabilize step falls
    inside) gives the same parameters, moments, counters and metrics for
    ``epochs_per_call`` 1, 3 and 10 (chunks of 1 x 5, 3 + 1 + 1 and
    4 + 1), and resumed from the 2-epoch state it ends on the straight
    run's bits."""
    X = _windows(16, CADENCE_W, seed=3)

    def run(n_epochs, model=None, **kw):
        return _train(model or _model(CADENCE_W, True), X, n_epochs,
                      8, hyperbolic=True, **kw)

    runs = [run(5, epochs_per_call=k) for k in (1, 3, 10)]
    for state, saved, logged, metrics in runs[1:]:
        _assert_states_equal(state, runs[0][0])
        assert (saved, logged, metrics) == runs[0][1:]
    assert runs[0][0].opt_gen.step == 10
    half, _, _, first = run(2)
    resumed, _, logged, rest = run(5, half)
    _assert_states_equal(resumed, runs[0][0])
    assert logged == [3, 4, 5] and first + rest == runs[0][3]


@pytest.mark.parametrize("hyperbolic", [True, False])
@pytest.mark.parametrize("fused", ["full", True, False])
def test_step_bodies_are_run_epoch_bitwise(hyperbolic, fused):
    """(b): two epochs of the bodies the card captures (40 windows of 8,
    batch 8: 25 critic and 5 generator steps an epoch, so the Riemannian
    Adam's stabilize step 10 falls inside) equal two ``run_epoch`` calls
    on the same draws bit for bit: parameters, every moment, the step
    counters, the epoch and the metrics."""
    n, batch, lr = 40, 8, 5e-3
    X = torch.from_numpy(_windows(n, CADENCE_W, seed=1))
    models = [_model(CADENCE_W, hyperbolic) for _ in range(2)]
    states = [ttr.init_train_state(m, lr, hyperbolic) for m in models]
    draws = [ttr.epoch_draws(ttr.epoch_generator(7, e), n, batch, models[0])
             for e in range(2)]
    want = [ttr.run_epoch(states[0], X, d, lr=lr, hyperbolic=hyperbolic,
                          fused_critics=fused)[1] for d in draws]
    program = graphed.EpochProgram(models[1], X, lr=lr,
                                   hyperbolic=hyperbolic, batch_size=batch,
                                   fused_critics=fused)
    assert not program.capture
    got = program.run(states[1], draws)
    assert got == want
    _assert_states_equal(states[1], states[0])
    assert states[1].opt_gen.step == 10 and states[1].epoch == 2
    assert isinstance(states[1].opt_cx, AdamState)
