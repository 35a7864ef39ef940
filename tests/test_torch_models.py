"""Port parity: the weight bridge and the TadGAN forwards
(hypad_tpu_torch.bridge, hypad_tpu_torch.models) against the JAX package,
on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.models import tadgan as jt
from hypad_tpu_torch import bridge
from hypad_tpu_torch.models import tadgan as tt


def _jax_params(signal_shape, hyperbolic=True, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jt.init_tadgan(jax.random.PRNGKey(seed), signal_shape,
                                   hyperbolic=hyperbolic))


def _leaves(tree):
    return bridge.flatten_tree(tree)


@pytest.mark.parametrize("hyperbolic", [True, False])
def test_bridge_round_trip_is_bitwise(hyperbolic):
    params = _jax_params(32, hyperbolic)
    back = bridge.to_jax_params(bridge.from_jax_params(params, device="cpu"))
    want, got = _leaves(params), _leaves(back)
    assert sorted(want) == sorted(got)
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])
    # the JAX functions accept the round-tripped tree as it is
    x = np.zeros((2, 32), np.float32)
    np.testing.assert_array_equal(
        np.asarray(jt.critic_x_apply(back["critic_x"], x)),
        np.asarray(jt.critic_x_apply(params["critic_x"], x)))


def test_save_and_load_params_npz_round_trip(tmp_path):
    model = bridge.from_jax_params(_jax_params(32), device="cpu")
    path = tmp_path / "weights.npz"
    bridge.save_params_npz(model, path)
    loaded = bridge.load_params_npz(path, device="cpu")
    want, got = model.state_dict(), loaded.state_dict()
    assert list(want) == list(got)
    for key in want:
        assert torch.equal(want[key], got[key])
    assert loaded["decoder"].hyperbolic


@pytest.mark.parametrize("signal_shape,B", [(32, 64), (100, 17)])
def test_forwards_match_jax(signal_shape, B):
    params = _jax_params(signal_shape, seed=signal_shape)
    model = bridge.from_jax_params(params, device="cpu")
    x = np.random.default_rng(B).uniform(
        -1, 1, (B, signal_shape)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    tol = dict(rtol=1e-5, atol=1e-6)
    with torch.inference_mode():
        z = model["encoder"](tx)
        hyper, eucl = model["decoder"](z)
        critic = model["critic_x"](tx)
        critic_z = model["critic_z"](z)
    jz = jt.encoder_apply(params["encoder"], jx)
    jhyper, jeucl = jt.decoder_apply(params["decoder"], jz, hyperbolic=True)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **tol)
    np.testing.assert_allclose(hyper.numpy(), np.asarray(jhyper), **tol)
    np.testing.assert_allclose(eucl.numpy(), np.asarray(jeucl), **tol)
    np.testing.assert_allclose(
        critic.numpy(), np.asarray(jt.critic_x_apply(params["critic_x"], jx)),
        **tol)
    np.testing.assert_allclose(
        critic_z.numpy(),
        np.asarray(jt.critic_z_apply(params["critic_z"], jz)), **tol)


def test_euclidean_decoder_matches_jax():
    params = _jax_params(32, hyperbolic=False)
    model = bridge.from_jax_params(params, device="cpu")
    z = np.random.default_rng(3).standard_normal((8, 20)).astype(np.float32)
    with torch.inference_mode():
        got = model["decoder"](torch.from_numpy(z)).numpy()
    want = np.asarray(jt.decoder_apply(params["decoder"], jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_init_tadgan_distributions_and_determinism():
    def make(seed):
        return tt.init_tadgan(torch.Generator().manual_seed(seed), 100,
                              hyperbolic=True, device="cpu")

    a, b, c = make(0), make(0), make(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.dense.w"], sc["encoder.dense.w"])
    # same keys and shapes as the JAX pytree
    jax_shapes = {k.replace("/", "."): np.shape(v)
                  for k, v in _leaves(_jax_params(100)).items()}
    assert {k: tuple(v.shape) for k, v in sa.items()} == jax_shapes
    # dense: U(-1/sqrt(fan_in), 1/sqrt(fan_in)); LSTM: U(-1/sqrt(H), ..)
    assert sa["critic_x.dense1.w"].abs().max() <= 1 / np.sqrt(100)
    assert sa["decoder.lstm.1.w_ih_rev"].abs().max() <= 1 / np.sqrt(64)
    assert sa["decoder.lstm.1.w_ih_rev"].abs().max() > 0.9 / np.sqrt(64)
    # MobiusLinear: N(0, (1/(100 sqrt(2 out in)))^2) weight, ball bias
    w = sa["decoder.hyperbolic_linear.w"]
    std = 1 / np.sqrt(2 * 100 * 100) / 100
    assert abs(w.std().item() / std - 1) < 0.05
    assert sa["decoder.hyperbolic_linear.b"].norm() < 1 - 4e-3
    assert not a.training


def test_entry_points_default_to_cuda():
    """Without CUDA the default device raises instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available, so the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_tadgan(torch.Generator().manual_seed(0), 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.from_jax_params(_jax_params(32))
