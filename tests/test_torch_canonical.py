"""Port parity: the fleet on a device mesh and canonical fleet training
(hypad_tpu_torch.train.fleet ``mesh`` / ``canonical``,
hypad_tpu_torch.detect.scorer ``canonical_fleet_shape``) against the JAX
package, on the CPU.

The shape ladder is JAX's, table for table. The mesh cases are JAX's
tests/test_fleet.py ones (a seed band padded with replicas, a fleet padded
with dummies, a sharded signal axis) on the port's ``[cpu] * 8`` mesh,
each held bitwise to the port unsharded (on the CPU a fleet signal is its
single-model run bit for bit). One canonical fleet epoch from JAX's
stacked state, with the draws of JAX's canonical ``train_fleet`` injected
(its masked shuffles over the padded rows), is held against JAX's at the
fleet tests' tolerance (metrics 1e-3 / 1e-4, parameters 5e-3 / 2e-4), and
the port's ``train_fleet(canonical=True)`` stages JAX's padded stack."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.detect import scorer as jsc
from hypad_tpu.models import tadgan as jt
from hypad_tpu.train import fleet as jfl
from hypad_tpu_torch import bridge
from hypad_tpu_torch.detect import scorer as tsc
from hypad_tpu_torch.models.tadgan import init_tadgan
from hypad_tpu_torch.parallel.mesh import make_mesh
from hypad_tpu_torch.train import fleet as tfl
from hypad_tpu_torch.train import state_bridge
from hypad_tpu_torch.train import trainer as ttr

W, B, LR = 100, 16, 5e-4
MESH8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, W)).astype(
        np.float32)


def _models(S, hyperbolic=False):
    return [init_tadgan(torch.Generator().manual_seed(60 + i), W,
                        hyperbolic=hyperbolic, device="cpu")
            for i in range(S)]


def _same_state(a, b, what):
    for k in a.model.state_dict():
        assert torch.equal(a.model.state_dict()[k],
                           b.model.state_dict()[k]), f"{what}: {k}"
    assert (a.opt_cx.step, a.opt_gen.step) == (b.opt_cx.step,
                                               b.opt_gen.step), what


def test_canonical_shapes_and_rungs_are_jax():
    """The rung ladders, the pair budget and ``canonical_fleet_shape`` over
    a table of (S, N, W, ndev), chunk-capped cases included."""
    assert tsc.FLEET_N_RUNGS == jsc.FLEET_N_RUNGS
    assert tsc.FLEET_S_RUNGS == jsc.FLEET_S_RUNGS
    assert tsc.FLEET_MAX_PAIR_ELEMS == jsc.FLEET_MAX_PAIR_ELEMS
    for n in (1, 127, 128, 129, 1320, 22_000, 131_072, 200_000):
        assert tsc._next_rung(n) == jsc._next_rung(n), n
    for s in (1, 3, 4, 5, 9, 81, 1024, 1500):
        assert tsc._next_s_rung(s) == jsc._next_s_rung(s), s
    for S in (1, 2, 3, 9, 13, 81, 300):
        for N in (64, 400, 1320, 5000):
            for width in (100, 123, 150):
                for ndev in (1, 2, 4, 8):
                    assert (tsc.canonical_fleet_shape(S, N, width, ndev)
                            == jsc.canonical_fleet_shape(S, N, width, ndev)
                            ), (S, N, width, ndev)


def test_seed_band_on_a_mesh_pads_with_replicas():
    """tests/test_fleet.py:84's case: a seed band of S = 2 on an 8-device
    mesh is padded to 8 with replicas of the last signal (JAX's
    non-ragged stream); each real signal is its ``train_tadgan(seed=s)``
    bitwise, each replica the last signal's."""
    X = _windows(96, 4)
    band = [0, 5]
    state = tfl.init_fleet_state(_models(2), LR, False)
    state = tfl.train_fleet(state, [X, X], lr=LR, hyperbolic=False,
                            batch_size=32, n_epochs=2, seeds=band,
                            mesh=make_mesh(MESH8), device="cpu")
    assert state.n_signals == 8
    for i, s in enumerate(band):
        single = ttr.train_tadgan(_models(2)[i], X, lr=LR, hyperbolic=False,
                                  batch_size=32, n_epochs=2, seed=s,
                                  device="cpu")
        _same_state(tfl.unstack_state(state, i), single, f"seed {s}")
    for i in range(2, 8):
        _same_state(tfl.unstack_state(state, i), tfl.unstack_state(state, 1),
                    f"replica {i}")


def test_fleet_on_a_mesh_pads_with_dummies_and_equals_unsharded():
    """tests/test_fleet.py:185 and :202's cases: S = 3 on an 8-device mesh
    gets 5 ``n_real = 0`` dummies that come back unchanged, the 3 real
    signals bitwise the unsharded fleet; 8 signals sharded one a device
    equal the unsharded fleet bitwise; a 2-D mesh shards over ``dp``."""
    Xs = [_windows(64, s) for s in range(8)]
    for S, mesh in ((3, make_mesh(MESH8)), (8, make_mesh(MESH8)),
                    (3, make_mesh(MESH8, shape=(4, 2)))):
        one = tfl.train_fleet(tfl.init_fleet_state(_models(S), LR, False),
                              Xs[:S], lr=LR, hyperbolic=False,
                              batch_size=32, n_epochs=1, device="cpu")
        init = tfl.init_fleet_state(_models(S), LR, False)
        sharded = tfl.train_fleet(init, Xs[:S], lr=LR, hyperbolic=False,
                                  batch_size=32, n_epochs=1, device="cpu",
                                  mesh=mesh)
        ndev = mesh.size
        assert sharded.n_signals == S + (-S) % ndev
        for i in range(S):
            _same_state(tfl.unstack_state(sharded, i),
                        tfl.unstack_state(one, i), f"S={S} signal {i}")
        last = tfl.unstack_state(tfl.init_fleet_state(_models(S), LR, False),
                                 S - 1)
        for i in range(S, sharded.n_signals):
            d = tfl.unstack_state(sharded, i)
            for k, v in last.model.state_dict().items():
                assert torch.equal(d.model.state_dict()[k], v), k
            assert d.opt_gen.step == 0


LENS = (48, 32, 40)


@functools.cache
def _jax_canonical():
    """JAX's ``train_fleet(canonical=True)``: one epoch of 3 hyperbolic
    signals, its initial state, staged stack and final state."""
    Xl = [_windows(n, 70 + i) for i, n in enumerate(LENS)]
    params = [jt.init_tadgan(jax.random.PRNGKey(80 + i), W, hyperbolic=True)
              for i in range(len(LENS))]
    state0 = jfl.init_fleet_state(params, LR, True)
    host0 = jax.tree_util.tree_map(np.asarray, state0)
    state1, (Xs, lens) = jfl.train_fleet(
        jax.tree_util.tree_map(jnp.copy, state0), Xl, lr=LR,
        hyperbolic=True, batch_size=B, n_epochs=1, seed=0, canonical=True,
        return_staged=True)
    return (Xl, host0, np.asarray(Xs), np.asarray(lens),
            jax.tree_util.tree_map(np.asarray, state1))


def test_canonical_epoch_tracks_jax_with_injected_draws():
    """The port's canonical padding is JAX's (the staged stack bit for
    bit: 3 signals of up to 48 windows -> 4 x 128, a dummy with no real
    row), and one canonical epoch from JAX's padded initial state with
    JAX's draws injected (masked shuffles over the 128 padded rows, 8
    steps a pass) tracks JAX's canonical epoch; the dummy is unchanged."""
    from tests.test_torch_fleet import _jax_fleet_draw_arrays

    Xl, state0, jXs, jlens, want = _jax_canonical()
    S_t, N_c = jXs.shape[:2]
    assert (S_t, N_c) == (4, 128) and list(jlens) == list(LENS)
    _, (Xs, lens) = tfl.train_fleet(
        tfl.init_fleet_state(_models(3, True), LR, True), Xl, lr=LR,
        hyperbolic=True, batch_size=B, n_epochs=1, canonical=True,
        return_staged=True, device="cpu")
    np.testing.assert_array_equal(Xs.numpy(), jXs)
    assert list(lens) == list(jlens)

    # JAX's padded initial state (the last signal replicated, as it pads)
    padded0 = jax.tree_util.tree_map(
        lambda x: np.concatenate([x, x[-1:]]), state0)
    n_real = np.asarray(list(LENS) + [0], np.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    draw_fn = jax.jit(jax.vmap(_jax_fleet_draw_arrays,
                               in_axes=(0, None, 0, None)),
                      static_argnums=(1, 3))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draw_fn(
        jnp.broadcast_to(key, (S_t,) + key.shape), N_c, jnp.asarray(n_real),
        B).items()}
    assert draws["gen_idx"].shape[1] == N_c // B
    state = state_bridge.fleet_state_from_jax(padded0, device="cpu")
    state, metrics = ttr.run_fleet_epoch(state, torch.from_numpy(jXs),
                                         n_real, draws, lr=LR,
                                         hyperbolic=True)
    got = bridge.flatten_tree(bridge.to_jax_stacked_params(state.params))
    for k, v in bridge.flatten_tree(want.params).items():
        np.testing.assert_allclose(got[k], v, rtol=5e-3, atol=2e-4,
                                   err_msg=k)
    for name in ("opt_cx", "opt_cz", "opt_gen"):
        np.testing.assert_array_equal(getattr(state, name).step,
                                      getattr(want, name).step)
    assert list(state.opt_gen.step) == [n // B for n in LENS] + [0]
    first = bridge.flatten_tree(bridge.to_jax_stacked_params(
        state_bridge.fleet_state_from_jax(padded0, device="cpu").params))
    for k, v in got.items():
        np.testing.assert_array_equal(v[3], first[k][3], err_msg=k)


def test_canonical_draws_mask_the_pad_rows():
    """The port's own canonical draws: each signal's shuffles cover only
    its real rows in its real steps, every draw is shaped by the padded
    count (nb = 128 // 16 steps a pass), and they are not the unpadded
    run's draws (JAX's documented semantics)."""
    params = tfl.init_fleet_state(_models(1), LR, False).params
    n_real = [48, 0]
    d = ttr.fleet_epoch_draws([0, 0], 0, n_real, B, params, n_pad=128)
    assert d["critic_idx"].shape == (2, 5 * 8, B)
    assert d["gen_idx"].shape == (2, 8, B)
    valid_c, valid_g = ttr.fleet_valid(n_real, B, 8)
    assert bool((d["critic_idx"][0][torch.as_tensor(valid_c[0])] < 48).all())
    assert bool((d["gen_idx"][0][torch.as_tensor(valid_g[0])] < 48).all())
    plain = ttr.fleet_epoch_draws([0], 0, [48], B, params)
    assert not torch.equal(plain["z_x"][0], d["z_x"][0][:plain["z_x"].shape[1]])
