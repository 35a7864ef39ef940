"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where no CUDA device is present. Run on a
GPU machine with ``python -m pytest tests/test_torch_cuda.py -q``."""

import pytest
import torch

from hypad_tpu_torch.manifold.kernels import mobius_linear, mobius_linear_kernel
from hypad_tpu_torch.models.tadgan import init_tadgan
from hypad_tpu_torch.ops.kde import (
    kde_argmax_rows,
    kde_argmax_rows_and_use,
    kde_argmax_rows_v2_and_use,
)
from hypad_tpu_torch.ops.kde_kernel import (
    kde_argmax_kernel,
    kde_argmax_rows_fused,
    kde_argmax_v2_kernel,
)
from hypad_tpu_torch.ops.unroll import antidiagonal_gather, masked_median

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,D,scale", [(20000, 100, 1.0), (130, 64, 1.0),
                                       (8, 100, 1e6), (1, 128, 1.0),
                                       (128, 100, 1.0), (64, 100, 1.0),
                                       (50000, 100, 1.0)])
def test_mobius_linear_kernel_matches_plain(cuda, B, D, scale):
    g = torch.Generator().manual_seed(B)
    model = init_tadgan(g, D, hyperbolic=True, device=cuda)
    head = model["decoder"].hyperbolic_linear
    w = (head.w.detach() * scale).contiguous()
    x = (torch.rand(B, D, generator=g) * 2 - 1).to(cuda)
    before = mobius_linear_kernel.launches
    got = mobius_linear_kernel(x, w, head.b.detach())
    torch.cuda.synchronize()
    assert mobius_linear_kernel.launches == before + 1
    want = mobius_linear(x, w, head.b.detach())
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("N,W,const,nans", [
    (20000, 100, False, False), (700, 64, False, False),
    (300, 100, True, False), (50, 100, False, False),
    (300, 100, False, True), (300, 1, False, False), (300, 4, False, False),
    (300, 5, False, False)])
def test_kde_argmax_kernel_matches_plain_at_tie_level(cuda, N, W, const,
                                                      nans):
    """K2 on the card: use flags bitwise, fallback rows bitwise
    masked_median (NaN where it is NaN: with NaNs in the critic, middle
    ranks fall on the masked entries' fill and on the NaNs), the other
    rows at tie level; row widths down to 1, where a block is under a
    warp of row blocks."""
    critic = torch.randn(N, generator=torch.Generator().manual_seed(N))
    if const:
        critic[10:40] = 0.5
    if nans:
        critic[:2] = critic[100:200] = float("nan")
    vals, mask = antidiagonal_gather(critic.to(cuda)[:, None].expand(N, W))
    before = kde_argmax_kernel.launches
    got = kde_argmax_rows_fused(vals, mask)
    torch.cuda.synchronize()
    assert kde_argmax_kernel.launches == before + 1
    want = kde_argmax_rows(vals, mask)
    _, use = kde_argmax_kernel(vals, mask)
    _, want_use = kde_argmax_rows_and_use(vals, mask)
    assert torch.equal(use, want_use)
    torch.testing.assert_close(got[~use], masked_median(vals, mask)[~use],
                               rtol=0, atol=0, equal_nan=True)
    if nans:
        assert torch.isnan(got[~use]).any() and torch.isinf(got[~use]).any()
    got, want = got[use], want[use]
    diff = torch.nonzero(got != want)[:, 0].cpu().numpy()
    v, m, g = (vals[use].cpu().numpy(), mask[use].cpu().numpy(),
               got.cpu().numpy())
    assert all(g[i] in v[i][m[i]] for i in diff)
    assert len(diff) <= max(1, int(0.01 * len(g)))


@pytest.mark.parametrize("N,W,const,nans", [
    (20000, 100, False, False), (700, 64, False, False),
    (300, 100, True, False), (50, 100, False, False),
    (300, 100, False, True), (300, 1, False, False), (300, 4, False, False),
    (300, 5, False, False)])
def test_kde_argmax_v2_kernel_matches_plain_at_tie_level(cuda, N, W, const,
                                                         nans):
    """K3 on the card, one launch with the median fallback inside: use
    flags bitwise, fallback rows bitwise masked_median (NaN where it is
    NaN), the other rows at tie level against its plain version and
    against K2."""
    critic = torch.randn(N, generator=torch.Generator().manual_seed(N))
    if const:
        critic[10:40] = 0.5
    if nans:
        critic[:2] = critic[100:200] = float("nan")
    vals, mask = antidiagonal_gather(critic.to(cuda)[:, None].expand(N, W))
    before = kde_argmax_v2_kernel.launches
    got = kde_argmax_rows_fused(vals, mask, "v2")
    torch.cuda.synchronize()
    assert kde_argmax_v2_kernel.launches == before + 1
    _, use = kde_argmax_v2_kernel(vals, mask)
    want, want_use = kde_argmax_rows_v2_and_use(vals, mask)
    assert torch.equal(use, want_use)
    torch.testing.assert_close(got[~use], masked_median(vals, mask)[~use],
                               rtol=0, atol=0, equal_nan=True)
    k2 = kde_argmax_rows_fused(vals, mask, "v1")
    v, m = vals[use].cpu().numpy(), mask[use].cpu().numpy()
    for other in (want, k2):
        g = got[use].cpu().numpy()
        diff = torch.nonzero(got[use] != other[use])[:, 0].cpu().numpy()
        assert all(g[i] in v[i][m[i]] for i in diff)
        assert len(diff) <= max(1, int(0.01 * len(g)))


def _critic_case(device, hyperbolic, B, seed=0):
    g = torch.Generator().manual_seed(100 + B + hyperbolic + 1000 * seed)
    model = init_tadgan(g, 100, hyperbolic=hyperbolic, device=device)
    draws = {"z_x": torch.randn(B, 20, generator=g),
             "a_x": torch.rand(B, 100, generator=g),
             "z_z": torch.randn(B, 20, generator=g),
             "a_z": torch.rand(B, 20, generator=g),
             "m_cx": torch.rand(4, 3 * B, 20, generator=g) < 0.75,
             "m_cz": torch.rand(2, 3 * B, 20, generator=g) < 0.8,
             "m_dec": torch.rand(B, 128, generator=g) < 0.8}
    x = torch.rand(B, 100, generator=g) * 2 - 1
    return model, x.to(device), {k: v.to(device) for k, v in draws.items()}


def _assert_critic_close(got, want, loss_tol, grad_tol):
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, **loss_tol)
    for gd, wd in zip(got[2:], want[2:]):
        assert sorted(gd) == sorted(wd)
        for key in wd:
            torch.testing.assert_close(gd[key], wd[key], msg=key, **grad_tol)


def _assert_bitwise(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a[:2], b[:2]))
    assert all(torch.equal(a[i][k], b[i][k]) for i in (2, 3) for k in a[i])


@pytest.mark.parametrize("hyperbolic,B", [(True, 64), (False, 64),
                                          (True, 13), (True, 3),
                                          (True, 100)])
def test_critic_step_kernels_match_autograd(cuda, hyperbolic, B):
    """K5 and K4 against their plain autograd versions on the card, within
    the JAX tests' tolerances (tests/test_critic_kernel.py:83-93, :113-122),
    two launches bitwise equal, one count per launch. B = 3 leaves most of
    a cluster's blocks without rows; B = 100 splits the rows unevenly."""
    from hypad_tpu_torch.train import critic_kernel as ck

    model, x, d = _critic_case(cuda, hyperbolic, B)
    want = ck.critic_step_plain(model, x, d, hyperbolic)
    before = ck.critic_step_fused_full.launches
    got = ck.critic_step_fused_full(model, x, d, hyperbolic)
    again = ck.critic_step_fused_full(model, x, d, hyperbolic)
    torch.cuda.synchronize()
    assert ck.critic_step_fused_full.launches == before + 2
    assert ck.launch_shape() == (2, 8, 512)  # 2 clusters of 8 blocks
    _assert_critic_close(got, want, dict(rtol=5e-5, atol=2e-6),
                         dict(rtol=1e-4, atol=1e-6))
    _assert_bitwise(got, again)

    bigx, bigz = ck.critic_step_inputs(model, x, d, hyperbolic)
    before = ck.critics_fused_grads.launches
    args = (model["critic_x"], model["critic_z"], bigx, bigz, d["m_cx"],
            d["m_cz"])
    got = ck.critics_fused_grads(*args)
    again = ck.critics_fused_grads(*args)
    torch.cuda.synchronize()
    assert ck.critics_fused_grads.launches == before + 2
    _assert_critic_close(got, ck.critics_fused_grads_plain(*args),
                         dict(rtol=2e-5, atol=1e-6),
                         dict(rtol=5e-5, atol=5e-7))
    _assert_bitwise(got, again)


# ---------------------------------------------------------------------------
# the signal axis: one launch for a fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,B", [(1, 64), (3, 128), (9, 20000)])
def test_mobius_linear_kernel_signal_axis_is_each_signals_launch(cuda, S, B):
    """K1 with a signal axis: one launch, each signal bitwise its own
    single-signal launch and within 1e-6 of the plain version."""
    g = torch.Generator().manual_seed(S)
    heads = [init_tadgan(g, 100, hyperbolic=True, device=cuda)["decoder"]
             .hyperbolic_linear for _ in range(S)]
    w = torch.stack([h.w.detach() for h in heads])
    b = torch.stack([h.b.detach() for h in heads])
    x = (torch.rand(S, B, 100, generator=g) * 2 - 1).to(cuda)
    before = mobius_linear_kernel.launches
    got = mobius_linear_kernel(x, w, b)
    torch.cuda.synchronize()
    assert mobius_linear_kernel.launches == before + 1
    for i in range(S):
        assert torch.equal(got[i], mobius_linear_kernel(x[i].contiguous(),
                                                        w[i], b[i]))
    assert (got - mobius_linear(x, w, b)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("S,hyperbolic", [(1, True), (3, True), (9, True),
                                          (3, False)])
def test_critic_step_kernels_signal_axis_are_each_signals_launch(
        cuda, S, hyperbolic):
    """K5 and K4 with a signal axis at B = 64: one launch each for all S
    signals, each signal's losses and gradients bitwise its single-signal
    launch, and within the JAX tests' tolerances of the fleet's plain
    autograd version."""
    from hypad_tpu_torch.train import critic_kernel as ck
    from hypad_tpu_torch.train import fleet as fl

    cases = [_critic_case(cuda, hyperbolic, 64, seed=i) for i in range(S)]
    models = [c[0] for c in cases]
    P = fl.stack_models(models)
    x = torch.stack([c[1] for c in cases])
    d = {k: torch.stack([c[2][k] for c in cases]) for k in cases[0][2]}
    before = ck.critic_step_fused_full.launches
    got = ck.critic_step_fused_full_fleet(P, x, d, hyperbolic)
    torch.cuda.synchronize()
    assert ck.critic_step_fused_full.launches == before + 1
    bigx, bigz = ck.critic_step_inputs_fleet(P, x, d, hyperbolic)
    before = ck.critics_fused_grads.launches
    got4 = ck.critics_fused_grads_fleet(P, bigx, bigz, d["m_cx"], d["m_cz"])
    torch.cuda.synchronize()
    assert ck.critics_fused_grads.launches == before + 1
    for i, m in enumerate(models):
        di = {k: v[i] for k, v in d.items()}
        one = ck.critic_step_fused_full(m, x[i], di, hyperbolic)
        one4 = ck.critics_fused_grads(m["critic_x"], m["critic_z"], bigx[i],
                                      bigz[i], di["m_cx"], di["m_cz"])
        for fleet_out, single in ((got, one), (got4, one4)):
            assert torch.equal(fleet_out[0][i], single[0])
            assert torch.equal(fleet_out[1][i], single[1])
            for j in (2, 3):
                for k in single[j]:
                    assert torch.equal(fleet_out[j][k][i], single[j][k]), k
    plain = ck.critic_step_fleet_plain(P, x, d, hyperbolic)
    _assert_critic_close(got, plain, dict(rtol=5e-5, atol=2e-6),
                         dict(rtol=1e-4, atol=1e-6))


def test_fleet_epoch_on_the_card_tracks_the_cpu(cuda):
    """One ragged hyperbolic fleet epoch (K5 with a signal axis) from the
    same weights and draws on the card and on the CPU: parameters within
    5e-3 / 2e-4 (tests/test_critic_kernel.py:227-236), step counters
    equal, one K5 launch a fleet critic step."""
    import numpy as np

    from hypad_tpu_torch.train import critic_kernel as ck
    from hypad_tpu_torch.train import fleet as fl
    from hypad_tpu_torch.train import trainer as tr

    rng = np.random.default_rng(0)
    Xl = [rng.uniform(-1, 1, (n, 100)).astype(np.float32)
          for n in (640, 448, 0)]
    Xs, n_real = fl.pad_and_stack(Xl)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        models = [init_tadgan(torch.Generator().manual_seed(3 + i), 100,
                              hyperbolic=True, device=dev) for i in range(3)]
        state = fl.init_fleet_state(models, 5e-4, True)
        draws = tr.fleet_epoch_draws([0, 1, 2], 0, n_real, 64, state.params)
        before = ck.critic_step_fused_full.launches
        state, _ = tr.run_fleet_epoch(state, torch.as_tensor(Xs, device=dev),
                                      n_real, draws, lr=5e-4,
                                      hyperbolic=True)
        if dev.type == "cuda":
            assert ck.critic_step_fused_full.launches == before + 50
        out[dev.type] = state
    for k, v in out["cpu"].params.items():
        torch.testing.assert_close(out["cuda"].params[k].cpu(), v,
                                   rtol=5e-3, atol=2e-4, msg=k)
    assert list(out["cuda"].opt_gen.step) == [10, 7, 0]


# ---------------------------------------------------------------------------
# the wide instances: multivariate feature counts of 129 to 256
# ---------------------------------------------------------------------------

def _traced(fn, kernel, tries=3):
    """(fn()'s result, the names of the device kernels it launched, and the
    launches ``kernel`` counted in that call). A trace with no device event
    at all (the profiler missed the launch) is taken again, up to
    ``tries`` times, as chip_smoke.py's ``kernels_launched`` does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # the profiler can miss a first launch
    torch.cuda.synchronize()
    for _ in range(tries):
        before = kernel.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return out, names, kernel.launches - before


@pytest.mark.parametrize("B,D", [(64, 150), (128, 150), (50000, 150),
                                 (64, 256), (128, 256), (50000, 256),
                                 (300, 129), (5000, 200)])
def test_mobius_linear_wide_kernel_matches_plain(cuda, B, D):
    """K1's wide kernel (W staged whole at 150, in k-chunks at 256) against
    the plain version within 1e-6, one launch each, and by the profiler
    the wide kernel alone."""
    g = torch.Generator().manual_seed(B + D)
    head = init_tadgan(g, D, hyperbolic=True,
                       device=cuda)["decoder"].hyperbolic_linear
    w, b = head.w.detach(), head.b.detach()
    x = (torch.rand(B, D, generator=g) * 2 - 1).to(cuda)
    got, names, launched = _traced(lambda: mobius_linear_kernel(x, w, b),
                                   mobius_linear_kernel)
    assert launched == 1
    assert len(names) == 1 and "mobius_linear_wide_kernel" in names[0]
    assert (got - mobius_linear(x, w, b)).abs().max().item() <= 1e-6


def test_mobius_linear_wide_kernel_signal_axis_is_each_signals_launch(cuda):
    g = torch.Generator().manual_seed(7)
    heads = [init_tadgan(g, 150, hyperbolic=True, device=cuda)["decoder"]
             .hyperbolic_linear for _ in range(3)]
    w = torch.stack([h.w.detach() for h in heads])
    b = torch.stack([h.b.detach() for h in heads])
    x = (torch.rand(3, 2000, 150, generator=g) * 2 - 1).to(cuda)
    got = mobius_linear_kernel(x, w, b)
    for i in range(3):
        assert torch.equal(got[i], mobius_linear_kernel(x[i].contiguous(),
                                                        w[i], b[i]))
    assert (got - mobius_linear(x, w, b)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("N,W,const,nans", [
    (50000, 150, False, False), (300, 150, True, False),
    (300, 150, False, True), (50000, 256, False, False),
    (300, 256, True, False), (300, 129, False, False)])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_kde_argmax_wide_kernels_match_plain_at_tie_level(cuda, N, W, const,
                                                          nans, version):
    """K2's and K3's wide instances on rows of 129 to 256: use flags
    bitwise, fallback rows bitwise masked_median, the other rows at tie
    level against the plain version (``near_tie_flips``: each differing row
    a sample of its own row whose float64 density is within n 2^-22 of the
    plain pick's); one launch, of the wide kernel."""
    from hypad_tpu_torch.profile_kernels import near_tie_flips

    critic = torch.randn(N, generator=torch.Generator().manual_seed(N + W))
    if const:
        critic[10:400] = 0.5
    if nans:
        critic[:2] = critic[100:200] = float("nan")
    vals, mask = antidiagonal_gather(critic.to(cuda)[:, None].expand(N, W))
    kernel, plain = ((kde_argmax_kernel, kde_argmax_rows_and_use)
                     if version == "v1" else
                     (kde_argmax_v2_kernel, kde_argmax_rows_v2_and_use))
    (got, use), names, launched = _traced(lambda: kernel(vals, mask), kernel)
    assert launched == 1
    assert len(names) == 1 and "_wide_kernel" in names[0]
    want, want_use = plain(vals, mask)
    assert torch.equal(use, want_use)
    torch.testing.assert_close(got[~use], masked_median(vals, mask)[~use],
                               rtol=0, atol=0, equal_nan=True)
    # every differing row a sample of its own row at a float64 density tie
    near_tie_flips(got[use], want[use], vals[use], mask[use])


@pytest.mark.parametrize("hyperbolic,B,width", [(True, 64, 150),
                                                (False, 64, 150),
                                                (True, 64, 256),
                                                (True, 13, 200)])
def test_critic_step_wide_kernels_match_autograd(cuda, hyperbolic, B, width):
    """K5 and K4 at multivariate widths (the wide instance) against their
    plain autograd versions, within the narrow checks' tolerances, two
    launches bitwise equal."""
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.train import critic_kernel as ck

    model, x, d = critic_case(cuda, hyperbolic, B, width)
    want = ck.critic_step_plain(model, x, d, hyperbolic)
    got = ck.critic_step_fused_full(model, x, d, hyperbolic)
    again = ck.critic_step_fused_full(model, x, d, hyperbolic)
    torch.cuda.synchronize()
    _assert_critic_close(got, want, dict(rtol=5e-5, atol=2e-6),
                         dict(rtol=1e-4, atol=1e-6))
    _assert_bitwise(got, again)
    bigx, bigz = ck.critic_step_inputs(model, x, d, hyperbolic)
    args = (model["critic_x"], model["critic_z"], bigx, bigz, d["m_cx"],
            d["m_cz"])
    got = ck.critics_fused_grads(*args)
    _assert_critic_close(got, ck.critics_fused_grads_plain(*args),
                         dict(rtol=2e-5, atol=1e-6),
                         dict(rtol=5e-5, atol=5e-7))
    _assert_bitwise(got, ck.critics_fused_grads(*args))


def test_critic_step_wide_signal_axis_is_each_signals_launch(cuda):
    """K5 and K4's wide instance with a signal axis (S = 3, width 150):
    each signal bitwise its single-signal launch."""
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.train import critic_kernel as ck
    from hypad_tpu_torch.train import fleet as fl

    cases = [critic_case(cuda, True, 64, 150, seed=i) for i in range(3)]
    models = [c[0] for c in cases]
    P = fl.stack_models(models)
    x = torch.stack([c[1] for c in cases])
    d = {k: torch.stack([c[2][k] for c in cases]) for k in cases[0][2]}
    got = ck.critic_step_fused_full_fleet(P, x, d, True)
    for i, m in enumerate(models):
        one = ck.critic_step_fused_full(m, x[i], {k: v[i] for k, v in
                                                   d.items()}, True)
        assert torch.equal(got[0][i], one[0])
        for j in (2, 3):
            for k in one[j]:
                assert torch.equal(got[j][k][i], one[j][k]), k


@pytest.mark.parametrize("n", [50_000, 262_144])
def test_rolling_sums_are_the_same_bits_on_every_call(cuda, n):
    """The detectors' rolling mean and trapezoid over one long row give the
    same bits call after call (a one-row CUDA cumsum through CUB's scan
    does not), and agree with the CPU's."""
    from hypad_tpu_torch.ops import rolling

    x = torch.randn(n, generator=torch.Generator().manual_seed(n))
    xd = x.to(cuda)
    for fn in (rolling.rolling_mean_centered, rolling.rolling_trapz_centered):
        first = fn(xd, 500)
        for _ in range(30):
            # exactly, the edges' NaNs where they were
            torch.testing.assert_close(fn(xd, 500), first, rtol=0, atol=0,
                                       equal_nan=True)
        # window sums are differences of running sums of up to n entries
        torch.testing.assert_close(first.cpu(), fn(x, 500), rtol=1e-4,
                                   atol=1e-3, equal_nan=True)


# ---------------------------------------------------------------------------
# the any-width instances: widths above 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,din,dout", [(64, 300, 300), (128, 512, 512),
                                        (4096, 1024, 1024), (50000, 300, 300),
                                        (300, 257, 100), (100, 64, 700)])
def test_mobius_linear_xwide_kernel_matches_plain(cuda, B, din, dout):
    """K1's any-width kernel (columns in chunks of 256, k in chunks of 64,
    the row's products held in the output until the epilogue) against the
    plain version within 1e-6, one launch each, and by the profiler the
    any-width kernel alone."""
    g = torch.Generator().manual_seed(B + din + dout)
    w = (torch.randn(dout, din, generator=g) / (din * dout) ** 0.5).to(cuda)
    b = (torch.randn(dout, generator=g) / 400).to(cuda)
    b = b / (1 + b.norm())
    x = (torch.rand(B, din, generator=g) * 2 - 1).to(cuda)
    before = mobius_linear_kernel.xwide_launches
    got, names, launched = _traced(lambda: mobius_linear_kernel(x, w, b),
                                   mobius_linear_kernel)
    assert launched == 1 and mobius_linear_kernel.xwide_launches > before
    assert len(names) == 1 and "mobius_linear_xwide_kernel" in names[0]
    assert (got - mobius_linear(x, w, b)).abs().max().item() <= 1e-6


def test_mobius_linear_xwide_kernel_signal_axis_is_each_signals_launch(cuda):
    g = torch.Generator().manual_seed(8)
    heads = [init_tadgan(g, 300, hyperbolic=True, device=cuda)["decoder"]
             .hyperbolic_linear for _ in range(3)]
    w = torch.stack([h.w.detach() for h in heads])
    b = torch.stack([h.b.detach() for h in heads])
    x = (torch.rand(3, 2000, 300, generator=g) * 2 - 1).to(cuda)
    got = mobius_linear_kernel(x, w, b)
    for i in range(3):
        assert torch.equal(got[i], mobius_linear_kernel(x[i].contiguous(),
                                                        w[i], b[i]))
    assert (got - mobius_linear(x, w, b)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("N,W,const,nans", [
    (2000, 300, False, False), (1000, 300, True, False),
    (1000, 300, False, True), (1000, 512, False, False),
    (500, 1024, False, False), (700, 257, False, False)])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_kde_argmax_xwide_kernels_match_plain_at_tie_level(cuda, N, W, const,
                                                           nans, version):
    """K2's and K3's any-width instances on rows wider than 256: use flags
    bitwise, fallback rows bitwise masked_median, the other rows at a
    float64 density tie (``near_tie_flips``); one launch, of the any-width
    kernel."""
    from hypad_tpu_torch.profile_kernels import near_tie_flips

    critic = torch.randn(N, generator=torch.Generator().manual_seed(N + W))
    if const:
        critic[10:700] = 0.5
    if nans:
        critic[:2] = critic[100:200] = float("nan")
    vals, mask = antidiagonal_gather(critic.to(cuda)[:, None].expand(N, W))
    kernel, plain = ((kde_argmax_kernel, kde_argmax_rows_and_use)
                     if version == "v1" else
                     (kde_argmax_v2_kernel, kde_argmax_rows_v2_and_use))
    (got, use), names, launched = _traced(lambda: kernel(vals, mask), kernel)
    assert launched == 1
    assert len(names) == 1 and "_xwide_kernel" in names[0]
    want, want_use = (plain(vals, mask, block=128) if version == "v1"
                      else plain(vals, mask))
    assert torch.equal(use, want_use)
    torch.testing.assert_close(got[~use], masked_median(vals, mask)[~use],
                               rtol=0, atol=0, equal_nan=True)
    near_tie_flips(got[use], want[use], vals[use], mask[use])


@pytest.mark.parametrize("hyperbolic,B,width", [(True, 64, 300),
                                                (False, 64, 300),
                                                (True, 64, 512),
                                                (True, 13, 400)])
def test_critic_step_xwide_kernels_match_autograd(cuda, hyperbolic, B,
                                                  width):
    """K5 and K4 above 256 (the any-width instance, whose row tile is
    dynamic shared memory) against their plain autograd versions, within
    the narrow checks' tolerances, two launches bitwise equal."""
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.train import critic_kernel as ck

    model, x, d = critic_case(cuda, hyperbolic, B, width)
    before = ck.critic_step_fused_full.xwide_launches
    want = ck.critic_step_plain(model, x, d, hyperbolic)
    got = ck.critic_step_fused_full(model, x, d, hyperbolic)
    again = ck.critic_step_fused_full(model, x, d, hyperbolic)
    torch.cuda.synchronize()
    assert ck.critic_step_fused_full.xwide_launches == before + 2
    _assert_critic_close(got, want, dict(rtol=5e-5, atol=2e-6),
                         dict(rtol=1e-4, atol=1e-6))
    _assert_bitwise(got, again)
    bigx, bigz = ck.critic_step_inputs(model, x, d, hyperbolic)
    args = (model["critic_x"], model["critic_z"], bigx, bigz, d["m_cx"],
            d["m_cz"])
    got = ck.critics_fused_grads(*args)
    _assert_critic_close(got, ck.critics_fused_grads_plain(*args),
                         dict(rtol=2e-5, atol=1e-6),
                         dict(rtol=5e-5, atol=5e-7))
    _assert_bitwise(got, ck.critics_fused_grads(*args))


def test_critic_step_xwide_signal_axis_is_each_signals_launch(cuda):
    """K5's any-width instance with a signal axis (S = 3, width 300): each
    signal bitwise its single-signal launch."""
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.train import critic_kernel as ck
    from hypad_tpu_torch.train import fleet as fl

    cases = [critic_case(cuda, True, 64, 300, seed=i) for i in range(3)]
    models = [c[0] for c in cases]
    P = fl.stack_models(models)
    x = torch.stack([c[1] for c in cases])
    d = {k: torch.stack([c[2][k] for c in cases]) for k in cases[0][2]}
    got = ck.critic_step_fused_full_fleet(P, x, d, True)
    for i, m in enumerate(models):
        one = ck.critic_step_fused_full(m, x[i], {k: v[i] for k, v in
                                                   d.items()}, True)
        assert torch.equal(got[0][i], one[0])
        for j in (2, 3):
            for k in one[j]:
                assert torch.equal(got[j][k][i], one[j][k]), k
