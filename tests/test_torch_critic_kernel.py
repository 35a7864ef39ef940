"""Port parity: the critic-step kernel wrappers (K4 ``critics_fused_grads``,
K5 ``critic_step_fused_full``) on CPU tensors, where they run their plain
autograd versions, against the JAX package's Pallas kernels run in
interpret mode, as tests/test_critic_kernel.py runs them. The CUDA kernels
themselves are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import numpy as np
import pytest
import torch

from hypad_tpu.models import tadgan as jt
from hypad_tpu.train import critic_kernel as jck
from hypad_tpu_torch import bridge
from hypad_tpu_torch.train import critic_kernel as tck

W, LATENT, H = 100, 20, 20


def _case(hyperbolic, B, seed):
    params = jax.tree_util.tree_map(
        np.asarray, jt.init_tadgan(jax.random.PRNGKey(seed), W,
                                   hyperbolic=hyperbolic))
    rng = np.random.default_rng(seed)
    d = {
        "z_x": rng.standard_normal((B, LATENT)).astype(np.float32),
        "a_x": rng.uniform(0, 1, (B, W)).astype(np.float32),
        "z_z": rng.standard_normal((B, LATENT)).astype(np.float32),
        "a_z": rng.uniform(0, 1, (B, LATENT)).astype(np.float32),
        "m_cx": rng.uniform(size=(4, 3 * B, H)) < 0.75,
        "m_cz": rng.uniform(size=(2, 3 * B, H)) < 0.8,
        "m_dec": rng.uniform(size=(B, 128)) < 0.8,
    }
    x = rng.uniform(-1, 1, (B, W)).astype(np.float32)
    return params, x, d


def _check(got, want, loss_tol, grad_tol):
    lx, lz, gx, gz = got
    jlx, jlz, jgx, jgz = want
    np.testing.assert_allclose(lx.item(), float(jlx), **loss_tol)
    np.testing.assert_allclose(lz.item(), float(jlz), **loss_tol)
    for name, grads, jgrads in (("critic_x", gx, jgx), ("critic_z", gz, jgz)):
        flat = {f"{name}.{k.replace('/', '.')}": v for k, v in
                bridge.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                           jgrads)).items()}
        assert sorted(grads) == sorted(flat)
        for key, value in flat.items():
            np.testing.assert_allclose(grads[key].numpy(), value,
                                       err_msg=key, **grad_tol)


@pytest.mark.parametrize("hyperbolic,B", [(True, 16), (False, 16),
                                          (True, 13)])
def test_k4_wrapper_matches_jax_kernel(hyperbolic, B):
    """K4 on the same stacked rows and masks: losses within 2e-5 relative /
    1e-6 absolute, gradients within 5e-5 / 5e-7
    (tests/test_critic_kernel.py:83-93). No kernel launch on the CPU."""
    params, x, d = _case(hyperbolic, B, seed=B + hyperbolic)
    rng = np.random.default_rng(7)
    bigx = rng.uniform(-1, 1, (3 * B, W)).astype(np.float32)
    bigz = rng.standard_normal((3 * B, LATENT)).astype(np.float32)
    want = jck.critics_fused_grads(params["critic_x"], params["critic_z"],
                                   bigx, bigz, d["m_cx"], d["m_cz"],
                                   interpret=True)
    model = bridge.from_jax_params(params, device="cpu")
    before = tck.critics_fused_grads.launches
    got = tck.critics_fused_grads(
        model["critic_x"], model["critic_z"], torch.from_numpy(bigx),
        torch.from_numpy(bigz), torch.from_numpy(d["m_cx"]),
        torch.from_numpy(d["m_cz"]))
    assert tck.critics_fused_grads.launches == before
    _check(got, want, dict(rtol=2e-5, atol=1e-6), dict(rtol=5e-5, atol=5e-7))


@pytest.mark.parametrize("hyperbolic,B", [(True, 16), (False, 16),
                                          (True, 13), (True, 3)])
def test_k5_wrapper_matches_jax_kernel(hyperbolic, B):
    """K5 (generator forwards, then both critics) from the same weights and
    draws: losses within 5e-5 relative / 2e-6 absolute, gradients within
    1e-4 / 1e-6 (tests/test_critic_kernel.py:113-122)."""
    params, x, d = _case(hyperbolic, B, seed=20 + B + hyperbolic)
    jd = dict(d, m_dec=d["m_dec"][None, None])
    want = jck.critic_step_fused_full(params, x, jd, hyperbolic,
                                      interpret=True)
    model = bridge.from_jax_params(params, device="cpu")
    before = tck.critic_step_fused_full.launches
    got = tck.critic_step_fused_full(
        model, torch.from_numpy(x), {k: torch.from_numpy(v)
                                     for k, v in d.items()}, hyperbolic)
    assert tck.critic_step_fused_full.launches == before
    _check(got, want, dict(rtol=5e-5, atol=2e-6), dict(rtol=1e-4, atol=1e-6))


def test_wrappers_check_their_inputs():
    params, x, d = _case(True, 8, seed=0)
    model = bridge.from_jax_params(params, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    tx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="m_cx"):
        tck.critic_step_fused_full(model, tx, dict(t, m_cx=t["m_cx"][:, :8]),
                                   True)
    with pytest.raises(TypeError, match="m_dec"):
        tck.critic_step_fused_full(model, tx, dict(t, m_dec=t["m_dec"].float()),
                                   True)
    with pytest.raises(ValueError, match="hyperbolic"):
        tck.critic_step_fused_full(model, tx, t, False)
    bigx = torch.zeros(24, W)
    with pytest.raises(ValueError, match="bigz"):
        tck.critics_fused_grads(model["critic_x"], model["critic_z"], bigx,
                                torch.zeros(24, 7), t["m_cx"], t["m_cz"])
    with pytest.raises(ValueError, match="contiguous"):
        tck.critics_fused_grads(model["critic_x"], model["critic_z"],
                                torch.zeros(W, 24).T, torch.zeros(24, LATENT),
                                t["m_cx"], t["m_cz"])


def test_profile_tool_rewrites_only_the_cluster_size(tmp_path):
    """profile_critic_step builds csrc/critic_step.cu at other cluster
    sizes by replacing its constant; only a size above the portable 8 also
    allows non-portable clusters, and a baseline source comes first."""
    from hypad_tpu_torch import profile_critic_step as pcs

    base = tmp_path / "old.cu"
    base.write_text("// another kernel\n")
    src = pcs.variant_sources(base, [1, 8, 16])
    assert list(src) == ["baseline", "cluster1", "cluster8", "cluster16"]
    assert src["baseline"] == "// another kernel\n"
    shipped = (pcs._build.CSRC / "critic_step.cu").read_text()
    assert src["cluster8"] == shipped
    for n in (1, 16):
        assert f"constexpr int kClusterBlocks = {n};" in src[f"cluster{n}"]
        assert pcs.SHIPPED not in src[f"cluster{n}"]
    assert pcs.NON_PORTABLE not in src["cluster1"]
    assert src["cluster16"].count(pcs.NON_PORTABLE) == 1
