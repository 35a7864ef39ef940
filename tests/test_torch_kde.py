"""Port parity: anti-diagonal unroll and KDE argmax (hypad_tpu_torch.ops)
against the JAX package and its Pallas kernels in interpret mode, on the
CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.ops.kde import kde_argmax_rows as jax_kde
from hypad_tpu.ops.kde_pallas import kde_argmax_rows_pallas
from hypad_tpu.ops.unroll import antidiagonal_gather as jax_antidiag
from hypad_tpu.ops.unroll import masked_median as jax_median
from hypad_tpu_torch.ops.kde import (
    kde_argmax_rows,
    kde_argmax_rows_parts,
    kde_argmax_rows_v2_parts,
)
from hypad_tpu_torch.ops.kde_kernel import (
    kde_argmax_kernel,
    kde_argmax_rows_fused,
    kde_argmax_v2_kernel,
)
from hypad_tpu_torch.ops.unroll import antidiagonal_gather, masked_median


def _critic(N, seed=0, constant_runs=False):
    critic = np.random.default_rng(seed).standard_normal(N).astype(np.float32)
    if constant_runs:
        critic[10:40] = 0.5  # zero-variance rows -> median fallback
    return critic


def _antidiag(N, W, seed=0, constant_runs=False):
    c = _critic(N, seed, constant_runs)
    y = np.ascontiguousarray(np.broadcast_to(c[:, None], (N, W)))
    vals, mask = antidiagonal_gather(torch.from_numpy(y))
    return vals, mask


def assert_tie_level_equal(got, want, vals, mask, max_frac=0.01):
    """Any differing value is a sample of its own row, and differing rows
    are rare (the rule of tests/test_pallas.py)."""
    diff = np.nonzero(got != want)[0]
    v, m = np.asarray(vals), np.asarray(mask)
    assert all(got[i] in v[i][m[i]] for i in diff), diff
    assert len(diff) <= max(1, int(max_frac * len(want)))


@pytest.mark.parametrize("N,W", [(300, 100), (50, 100), (700, 64), (1, 8)])
def test_antidiagonal_gather_and_masked_median_bitwise(N, W):
    y = np.random.default_rng(N).standard_normal((N, W)).astype(np.float32)
    vals, mask = antidiagonal_gather(torch.from_numpy(y))
    jvals, jmask = jax_antidiag(jnp.asarray(y))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(masked_median(vals, mask).numpy(),
                                  np.asarray(jax_median(jvals, jmask)))


@pytest.mark.parametrize("N,W,const", [(300, 100, False), (50, 100, False),
                                       (300, 100, True), (700, 64, False)])
def test_kde_argmax_matches_jax_and_pallas(N, W, const):
    vals, mask = _antidiag(N, W, constant_runs=const)
    got = kde_argmax_rows(vals, mask).numpy()
    jv, jm = jnp.asarray(vals.numpy()), jnp.asarray(mask.numpy())
    for want in (jax_kde(jv, jm),
                 kde_argmax_rows_pallas(jv, jm, interpret=True,
                                        version="v1"),
                 kde_argmax_rows_pallas(jv, jm, interpret=True,
                                        version="v2")):
        assert_tie_level_equal(got, np.asarray(want), vals, mask)


def test_kde_argmax_blocks_do_not_change_the_result():
    vals, mask = _antidiag(300, 100)
    np.testing.assert_array_equal(kde_argmax_rows(vals, mask, block=64),
                                  kde_argmax_rows(vals, mask))


def test_kde_wrapper_on_cpu_is_the_plain_version():
    vals, mask = _antidiag(300, 100, constant_runs=True)
    before = kde_argmax_kernel.launches
    np.testing.assert_array_equal(kde_argmax_rows_fused(vals, mask).numpy(),
                                  kde_argmax_rows(vals, mask).numpy())
    assert kde_argmax_kernel.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mask", "width", "contiguous"])
def test_kde_wrapper_rejects_what_the_kernel_does_not_take(bad):
    vals, mask = _antidiag(50, 64)
    if bad == "dtype":
        vals = vals.double()
    elif bad == "mask":
        mask = mask.float()
    elif bad == "width":
        vals, mask = torch.zeros(4, 200), torch.ones(4, 200, dtype=torch.bool)
    else:
        vals, mask = vals.T, mask.T
    with pytest.raises((TypeError, ValueError)):
        kde_argmax_rows_fused(vals, mask)


# --- K3: the symmetric-pair (offset) form of the KDE argmax ---------------

@pytest.mark.parametrize("N,W,const", [(300, 100, False), (50, 100, False),
                                       (300, 100, True), (700, 64, False),
                                       (300, 32, False)])
def test_kde_v2_plain_matches_jax_pallas_v2_and_jnp(N, W, const):
    """The plain K3 against JAX's _kernel_v2 in interpret mode and against
    the jnp KDE, at tie level; the use flags against the first form's
    bitwise (they come from the same statistics)."""
    vals, mask = _antidiag(N, W, constant_runs=const)
    val, use = kde_argmax_rows_v2_parts(vals, mask)
    np.testing.assert_array_equal(use.numpy(),
                                  kde_argmax_rows_parts(vals, mask)[1].numpy())
    got = torch.where(use, val, masked_median(vals, mask)).numpy()
    jv, jm = jnp.asarray(vals.numpy()), jnp.asarray(mask.numpy())
    for want in (kde_argmax_rows_pallas(jv, jm, interpret=True,
                                        version="v2"),
                 jax_kde(jv, jm)):
        assert_tie_level_equal(got, np.asarray(want), vals, mask)
    np.testing.assert_array_equal(
        kde_argmax_rows_fused(vals, mask, version="v2").numpy(), got)


def test_kde_v2_wrapper_on_cpu_is_the_plain_version():
    vals, mask = _antidiag(300, 100, constant_runs=True)
    before = (kde_argmax_kernel.launches, kde_argmax_v2_kernel.launches)
    got_val, got_use = kde_argmax_v2_kernel(vals, mask)
    want_val, want_use = kde_argmax_rows_v2_parts(vals, mask)
    np.testing.assert_array_equal(got_val.numpy(), want_val.numpy())
    np.testing.assert_array_equal(got_use.numpy(), want_use.numpy())
    assert (kde_argmax_kernel.launches,
            kde_argmax_v2_kernel.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "mask", "width", "contiguous"])
def test_kde_v2_wrapper_rejects_what_the_kernel_does_not_take(bad):
    vals, mask = _antidiag(50, 64)
    if bad == "dtype":
        vals = vals.double()
    elif bad == "mask":
        mask = mask.float()
    elif bad == "width":
        vals, mask = torch.zeros(4, 200), torch.ones(4, 200, dtype=torch.bool)
    else:
        vals, mask = vals.T, mask.T
    with pytest.raises((TypeError, ValueError)):
        kde_argmax_v2_kernel(vals, mask)


def test_kde_fused_rejects_an_unknown_version():
    vals, mask = _antidiag(50, 64)
    with pytest.raises(ValueError, match="kde_version"):
        kde_argmax_rows_fused(vals, mask, version="v3")
