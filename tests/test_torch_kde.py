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
    kde_argmax_rows_and_use,
    kde_argmax_rows_parts,
    kde_argmax_rows_v2_and_use,
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


@pytest.mark.parametrize("N,W,const", [(300, 100, True), (50, 100, False),
                                       (700, 64, False), (1, 8, False)])
def test_kde_value_and_use_match_pallas_v1(N, W, const):
    """The plain version of K2's one-launch output (value with the median
    fallback folded in, and the use flag) against JAX's v1 Pallas kernel in
    interpret mode: the use flags bitwise, the fallback rows bitwise, the
    rest at tie level."""
    from hypad_tpu.ops.kde_pallas import _pallas_kde

    vals, mask = _antidiag(N, W, constant_runs=const)
    got, use = kde_argmax_rows_and_use(vals, mask)
    jv, jm = jnp.asarray(vals.numpy()), jnp.asarray(mask.numpy())
    want = np.asarray(kde_argmax_rows_pallas(jv, jm, interpret=True,
                                             version="v1"))
    want_use = np.asarray(_pallas_kde(jv, jm, interpret=True)[1])
    got, use = got.numpy(), use.numpy()
    np.testing.assert_array_equal(use, want_use)
    assert (~use).any()  # the edge rows hold one sample each
    np.testing.assert_array_equal(got[~use], want[~use])
    assert_tie_level_equal(got, want, vals, mask)
    before = kde_argmax_kernel.launches
    for a, b in zip(kde_argmax_kernel(vals, mask), (got, use)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert kde_argmax_kernel.launches == before


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


@pytest.mark.parametrize("version,N,W", [("v1", 40, 257), ("v1", 30, 300),
                                         ("v2", 40, 257), ("v2", 24, 384)])
def test_kde_wrappers_match_jax_pallas_above_256(version, N, W):
    """Rows wider than 256, which the card runs in the any-width instances:
    on the CPU each wrapper's plain version against JAX's (the former
    refusal above 256 is gone): the use flags bitwise those of the v1
    Pallas kernel in interpret mode (both versions take them from the same
    statistics), the fallback rows bitwise, the rest at tie level; a row
    with NaNs takes the fallback. The values are held against the Pallas
    kernel of the same version in interpret mode for v1, and for v2
    against JAX's plain KDE, since the v2 kernel's interpret mode takes
    minutes at these widths."""
    from hypad_tpu.ops.kde_pallas import _pallas_kde

    c = _critic(N, seed=W)
    c[3] = np.nan
    y = np.ascontiguousarray(np.broadcast_to(c[:, None], (N, W)))
    vals, mask = antidiagonal_gather(torch.from_numpy(y))
    kernel = kde_argmax_kernel if version == "v1" else kde_argmax_v2_kernel
    before = (kernel.launches, kernel.xwide_launches)
    got, use = (t.numpy() for t in kernel(vals, mask))
    assert (kernel.launches, kernel.xwide_launches) == before
    np.testing.assert_array_equal(
        kde_argmax_rows_fused(vals, mask, version).numpy(), got)
    jv, jm = jnp.asarray(vals.numpy()), jnp.asarray(mask.numpy())
    want = np.asarray(kde_argmax_rows_pallas(jv, jm, interpret=True,
                                             version="v1")
                      if version == "v1" else jax_kde(jv, jm))
    np.testing.assert_array_equal(use, np.asarray(_pallas_kde(
        jv, jm, interpret=True)[1]))
    assert (~use).any() and use.any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fallback = ~use & ~np.isnan(want)
    np.testing.assert_array_equal(got[fallback], want[fallback])
    assert_tie_level_equal(got[use], want[use], vals.numpy()[use],
                           mask.numpy()[use])


@pytest.mark.parametrize("bad", ["dtype", "mask", "contiguous"])
def test_kde_wrapper_rejects_what_the_kernel_does_not_take(bad):
    vals, mask = _antidiag(50, 64)
    if bad == "dtype":
        vals = vals.double()
    elif bad == "mask":
        mask = mask.float()
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
    """On a CPU tensor K3's wrapper runs the folded plain version and
    launches nothing; ``kde_argmax_rows_fused("v2")`` returns its value."""
    vals, mask = _antidiag(300, 100, constant_runs=True)
    before = (kde_argmax_kernel.launches, kde_argmax_v2_kernel.launches)
    got_val, got_use = kde_argmax_v2_kernel(vals, mask)
    want_val, want_use = kde_argmax_rows_v2_and_use(vals, mask)
    np.testing.assert_array_equal(got_val.numpy(), want_val.numpy())
    np.testing.assert_array_equal(got_use.numpy(), want_use.numpy())
    np.testing.assert_array_equal(
        kde_argmax_rows_fused(vals, mask, "v2").numpy(), want_val.numpy())
    assert (kde_argmax_kernel.launches,
            kde_argmax_v2_kernel.launches) == before


def _nan_antidiag(N, W):
    c = _critic(N)
    c[:2] = c[100:200] = np.nan
    y = np.ascontiguousarray(np.broadcast_to(c[:, None], (N, W)))
    return antidiagonal_gather(torch.from_numpy(y))


@pytest.mark.parametrize("N,W,case", [(300, 100, ""), (50, 100, ""),
                                      (300, 100, "const"),
                                      (300, 100, "nans"), (300, 1, ""),
                                      (300, 4, ""), (300, 5, "")])
def test_kde_v2_value_and_use_match_pallas_v2(N, W, case):
    """The plain version of K3's one-launch output (value with the median
    fallback folded in, and the use flag) against JAX's v2 Pallas kernel in
    interpret mode, then its fallback: the use flags bitwise, the fallback
    rows bitwise (NaN where JAX's is NaN), the rest at tie level."""
    from hypad_tpu.ops.kde_pallas import _pallas_kde_v2

    if case == "nans":
        vals, mask = _nan_antidiag(N, W)
    else:
        vals, mask = _antidiag(N, W, constant_runs=case == "const")
    got, use = kde_argmax_rows_v2_and_use(vals, mask)
    jv, jm = jnp.asarray(vals.numpy()), jnp.asarray(mask.numpy())
    want = np.asarray(kde_argmax_rows_pallas(jv, jm, interpret=True,
                                             version="v2"))
    want_use = np.asarray(_pallas_kde_v2(jv, jm, interpret=True)[1])
    got, use = got.numpy(), use.numpy()
    np.testing.assert_array_equal(use, want_use)
    assert (~use).any()  # the edge rows hold one sample each
    np.testing.assert_array_equal(got[~use], want[~use])
    assert_tie_level_equal(got[use], want[use], vals.numpy()[use],
                           mask.numpy()[use])
    if case == "nans":
        assert np.isnan(got[~use]).any()


@pytest.mark.parametrize("bad", ["dtype", "mask", "contiguous"])
def test_kde_v2_wrapper_rejects_what_the_kernel_does_not_take(bad):
    vals, mask = _antidiag(50, 64)
    if bad == "dtype":
        vals = vals.double()
    elif bad == "mask":
        mask = mask.float()
    else:
        vals, mask = vals.T, mask.T
    with pytest.raises((TypeError, ValueError)):
        kde_argmax_v2_kernel(vals, mask)


def test_kde_fused_rejects_an_unknown_version():
    vals, mask = _antidiag(50, 64)
    with pytest.raises(ValueError, match="kde_version"):
        kde_argmax_rows_fused(vals, mask, version="v3")


def test_masked_median_with_nans_matches_jax():
    """The fallback K2 computes in the kernel, on rows holding NaNs: masked
    entries filled with the f32 maximum and NaNs sorted last, as JAX's
    masked_median sorts them (NaN where it is NaN)."""
    c = _critic(300)
    c[:2] = c[100:200] = np.nan
    y = np.ascontiguousarray(np.broadcast_to(c[:, None], (300, 100)))
    vals, mask = antidiagonal_gather(torch.from_numpy(y))
    got = masked_median(vals, mask).numpy()
    want = np.asarray(jax_median(jnp.asarray(vals.numpy()),
                                 jnp.asarray(mask.numpy())))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any() and np.isinf(got).any()


@pytest.mark.parametrize("W,nans", [(100, True), (1, False), (4, False),
                                    (5, False)])
def test_k2_check_holds_fallback_rows_bitwise(W, nans):
    """``profile_kernels.check_k2``, which holds K2 on the card: the plain
    output passes, a fallback row off by one ulp fails."""
    from hypad_tpu_torch.profile_kernels import check_k2, k2_case

    vals, mask = k2_case(300, W, device="cpu", nans=nans)
    value, use = kde_argmax_kernel(vals, mask)
    rec = check_k2(value, use, vals, mask, (value, use), case="cpu")
    assert rec["fallback_rows"] == int((~use).sum()) > 0
    assert rec["flips_vs_plain"] == rec["flips_vs_baseline"] == 0
    i = int(torch.nonzero(~use & torch.isfinite(value))[0, 0])
    value[i] = torch.nextafter(value[i], torch.tensor(np.inf))
    with pytest.raises(SystemExit, match="fallback rows differ"):
        check_k2(value, use, vals, mask, case="cpu")


@pytest.mark.parametrize("W,nans", [(100, True), (1, False), (4, False),
                                    (5, False)])
def test_k3_check_holds_fallback_rows_bitwise(W, nans):
    """``profile_kernels.check_k3``, which holds K3 on the card: the plain
    output passes, a fallback row off by one ulp fails."""
    from hypad_tpu_torch.profile_kernels import check_k3, k2_case

    vals, mask = k2_case(300, W, device="cpu", nans=nans)
    value, use = kde_argmax_v2_kernel(vals, mask)
    rec = check_k3(value, use, vals, mask, (value, use), case="cpu")
    assert rec["fallback_rows"] == int((~use).sum()) > 0
    assert rec["flips_vs_plain"] == rec["flips_vs_baseline"] == 0
    i = int(torch.nonzero(~use & torch.isfinite(value))[0, 0])
    value[i] = torch.nextafter(value[i], torch.tensor(np.inf))
    with pytest.raises(SystemExit, match="K3 fallback rows differ"):
        check_k3(value, use, vals, mask, case="cpu")


@pytest.mark.parametrize("spec,want", [
    ("kK3Rows=16", {"kK3Rows": "16"}),
    ("kK3Rows=8,kByOffsetBlocksPerSM=4",
     {"kK3Rows": "8", "kByOffsetBlocksPerSM": "4"})])
def test_k3_variant_source_sets_only_the_named_constants(spec, want):
    """``profile_kernels.k3_variant_source`` rewrites K3's launch constants
    in csrc/kde_argmax.cu and leaves every other line as it is."""
    import re

    from hypad_tpu_torch import _build
    from hypad_tpu_torch.profile_kernels import k3_variant_source

    text = (_build.CSRC / "kde_argmax.cu").read_text()
    out = k3_variant_source(text, spec)
    changed = [(a, b) for a, b in zip(text.splitlines(), out.splitlines())
               if a != b]
    assert len(changed) == len(want)
    for _, line in changed:
        name, value = re.match(r"constexpr int (\w+) = (\d+);", line).groups()
        assert want[name] == value
    with pytest.raises(ValueError):
        k3_variant_source(text, "kK2Rows=8")


def _k3_schedule_densities(vs_row, scale, width):
    """The densities of one row summed as csrc/kde_argmax.cu's K3 sums them:
    thread I owns samples 4I..4I+3; round 0 adds the in-block pairs, round
    D the forward terms f (pairs with block I - D) and back terms g (pairs
    with block I + D) of offsets 4D-3..4D+1, carrying the 1-3 terms a side
    that belong to round D + 1; a side without a partner adds nothing. The
    pair terms come from one torch.exp, as the plain version's do."""
    nb = max((width + 3) // 4, 1)
    v = np.full(4 * nb, np.float32(1e18), np.float32)
    v[:width] = vs_row
    d = torch.from_numpy(v)[:, None] - torch.from_numpy(v)[None, :]
    term = torch.exp(torch.tensor(scale) * (d * d)).numpy()
    inside = lambda i: i < width  # noqa: E731
    out = np.zeros(4 * nb, np.float32)
    for I in range(nb):
        e = {(a, b): term[4 * I + a, 4 * I + b] if inside(4 * I + a)
             else np.float32(0) for a in range(4) for b in range(a)}
        p = [np.float32(1), (np.float32(1) + e[1, 0]) + e[2, 1],
             (np.float32(1) + e[2, 1]) + e[3, 2], np.float32(1)]
        cb0, cb1, cf2 = [e[1, 0], e[2, 0], e[3, 0]], e[3, 1], e[2, 0]
        cf3 = [e[3, 2], e[3, 1], e[3, 0]]
        for D in range(1, max(I, nb - 1 - I) + 2):
            left, right = D <= I, I + D < nb
            f = [[term[4 * I + a, 4 * (I - D) + b] if left and inside(4 * I + a)
                  else None for b in range(4)] for a in range(4)]
            g = [[term[4 * (I + D) + b, 4 * I + a]
                  if right and inside(4 * (I + D) + b) else
                  (np.float32(0) if right else None) for b in range(4)]
                 for a in range(4)]
            if left:
                f = [[x if x is not None else np.float32(0) for x in row]
                     for row in f]
            seqs = ([f[0][3], cb0[0], f[0][2], cb0[1], f[0][1], cb0[2],
                     f[0][0], g[0][0]],
                    [f[1][3], cb1, f[1][2], g[1][0], f[1][1], g[1][1],
                     f[1][0], g[1][2]],
                    [cf2, g[2][0], f[2][3], g[2][1], f[2][2], g[2][2],
                     f[2][1], g[2][3]],
                    [cf3[0], g[3][0], cf3[1], g[3][1], cf3[2], g[3][2],
                     f[3][3], g[3][3]])
            for a, seq in enumerate(seqs):
                for x in seq:
                    if x is not None:  # a missing side's terms are skipped
                        p[a] = np.float32(p[a] + x)
            zero = np.float32(0)
            cb0 = [g[0][k] if right else zero for k in (1, 2, 3)]
            cb1 = g[1][3] if right else zero
            cf2 = f[2][0] if left else zero
            cf3 = [f[3][k] if left else zero for k in (2, 1, 0)]
        out[4 * I:4 * I + 4] = p
    return out[:width]


@pytest.mark.parametrize("N,W", [(40, 100), (60, 13), (60, 5), (60, 6)])
def test_k3_round_schedule_keeps_v2_order(N, W):
    """K3's round schedule, emulated on the CPU, sums every masked-in
    sample's density bit for bit as the plain v2 form does (the same
    terms, in ascending offset, the forward term before the back term)."""
    from hypad_tpu_torch.ops.kde import SENTINEL, kde_stats

    vals, mask = _antidiag(N, W, constant_runs=N >= 40)
    cnt, var, scale = kde_stats(vals, mask)
    vs = torch.where(mask, vals, SENTINEL)
    col = torch.arange(W)
    dens = torch.ones_like(vals)
    for r in range(1, W):
        dd = vs - torch.roll(vs, r, dims=1)
        e = torch.where(col >= r, torch.exp(scale[:, None] * (dd * dd)), 0.0)
        dens = dens + e + torch.roll(e, W - r, dims=1)
    use = ((cnt > 1) & (var > 0)).numpy()
    for t in np.nonzero(use)[0]:
        got = _k3_schedule_densities(vs[t].numpy(),
                                     np.float32(scale[t].item()), W)
        m = mask[t].numpy()
        np.testing.assert_array_equal(got[m], dens[t].numpy()[m])
