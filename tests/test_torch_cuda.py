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
                                      hyperbolic=True, fused_critics="full")
        if dev.type == "cuda":
            assert ck.critic_step_fused_full.launches == before + 50
        out[dev.type] = state
    for k, v in out["cpu"].params.items():
        torch.testing.assert_close(out["cuda"].params[k].cpu(), v,
                                   rtol=5e-3, atol=2e-4, msg=k)
    assert list(out["cuda"].opt_gen.step) == [10, 7, 0]


def test_graphed_fleet_epoch_is_the_eager_one_bitwise(cuda):
    """One fleet epoch of ``train_fleet`` on the card (S = 3 hyperbolic
    signals of 640 windows, seeds 0-2, ``"full"``), each fleet step a
    replayed CUDA graph, against one eager ``fleet_epoch_device`` epoch
    from the same weights and draws: parameters, moments, per-signal step
    counters, the (S,) metrics and the kernels' launch counts (K5 50, K1
    20) bit for bit; the captured program is kept in the ``FleetState``."""
    import numpy as np

    from hypad_tpu_torch.train import critic_kernel as ck
    from hypad_tpu_torch.train import fleet as fl
    from hypad_tpu_torch.train import graphed
    from hypad_tpu_torch.train import trainer as tr

    X = np.random.default_rng(0).uniform(-1, 1, (640, 100)).astype(
        np.float32)

    def init():
        return fl.init_fleet_state(
            [init_tadgan(torch.Generator().manual_seed(3 + i), 100,
                         hyperbolic=True, device=cuda) for i in range(3)],
            5e-4, True)

    def counts():
        return (ck.critic_step_fused_full.launches,
                mobius_linear_kernel.launches)

    eager, n_real = init(), [640] * 3
    before = counts()
    eager, means = tr.fleet_epoch_device(
        eager, torch.as_tensor(np.stack([X] * 3), device=cuda), n_real,
        tr.fleet_epoch_draws([0, 1, 2], 0, n_real, 64, eager.params),
        lr=5e-4, hyperbolic=True, fused_critics="full")
    want = tr.fleet_metrics(means.cpu().numpy())
    eager_counts = tuple(a - b for a, b in zip(counts(), before))
    logs = []
    before = counts()
    got = fl.train_fleet(init(), [X] * 3, lr=5e-4, hyperbolic=True,
                         batch_size=64, n_epochs=1, seeds=[0, 1, 2],
                         device=cuda, fused_critics="full",
                         log_cb=lambda e, m: logs.append(m))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == eager_counts \
        == (50, 20)
    assert isinstance(got.program, graphed.FleetProgram)
    assert got.program.critic.graph is not None
    for k, v in eager.params.items():
        assert torch.equal(got.params[k], v), k
    for name in ("opt_cx", "opt_cz", "opt_gen"):
        g, w = getattr(got, name), getattr(eager, name)
        np.testing.assert_array_equal(g.step, w.step)
        for part in ("mu", "nu"):
            a, b = getattr(g, part), getattr(w, part)
            for key in (a if isinstance(a, dict) else [None]):
                x, y = (a, b) if key is None else (a[key], b[key])
                assert torch.equal(x, y), (name, part, key)
    assert len(logs) == 1
    for k, v in want.items():
        np.testing.assert_array_equal(logs[0][k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the wide instances: multivariate feature counts of 129 to 256
# ---------------------------------------------------------------------------

def _traced(fn, kernel, tries=8):
    """(fn()'s result, the names of the device kernels it launched, and the
    launches ``kernel`` counted in that call). A trace with no device event
    at all (the profiler missed the launch) is taken again after a short
    pause, up to ``tries`` times, as chip_smoke.py's ``kernels_launched``
    does."""
    import time

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
        time.sleep(0.5)
    return out, names, kernel.launches - before


@pytest.mark.parametrize("B,D", [(64, 150), (128, 150), (50000, 150),
                                 (64, 256), (128, 256), (50000, 256),
                                 (300, 129), (5000, 200)])
def test_mobius_linear_wide_kernel_matches_plain(cuda, B, D):
    """K1's wide kernel (W staged whole at 150, in k-chunks at 256) against
    the plain version within 1e-6, one launch each, and by the profiler
    the wide kernel alone: its ring where many rows meet a W too wide for
    a block beside their tiles ((50,000, 256), (5,000, 200) on 132 SMs)."""
    g = torch.Generator().manual_seed(B + D)
    head = init_tadgan(g, D, hyperbolic=True,
                       device=cuda)["decoder"].hyperbolic_linear
    w, b = head.w.detach(), head.b.detach()
    x = (torch.rand(B, D, generator=g) * 2 - 1).to(cuda)
    got, names, launched = _traced(lambda: mobius_linear_kernel(x, w, b),
                                   mobius_linear_kernel)
    assert launched == 1
    assert len(names) == 1 and "mobius_linear_wide_kernel" in names[0]
    ring = (B, D) in ((50000, 256), (5000, 200))
    assert ("mobius_linear_wide_kernel_ring" in names[0]) is ring, names
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


@pytest.mark.parametrize("B,D", [(64, 150), (5000, 150), (20000, 150),
                                 (64, 256), (5000, 256), (64, 300),
                                 (2000, 300), (50000, 300), (4096, 512)])
def test_mobius_linear_wide_instances_repeat_their_bits_on_each_signal(
        cuda, B, D):
    """K1's instances above 128 columns, few rows and many (the wide
    kernel and its ring, the any-width split and ring kernels): three
    signals in one launch, each bitwise its own single-signal launch, two
    launches the same bits, within 1e-6 of the plain version."""
    from hypad_tpu_torch.profile_k1 import k1_case

    x, w, b = k1_case(B, D, 3, device=cuda)
    got = mobius_linear_kernel(x, w, b)
    assert torch.equal(got, mobius_linear_kernel(x, w, b))
    for i in range(3):
        assert torch.equal(got[i], mobius_linear_kernel(x[i].contiguous(),
                                                        w[i], b[i]))
    assert (got - mobius_linear(x, w, b)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("B,D", [(64, 51), (128, 51), (64, 123),
                                 (128, 123)])
def test_mobius_linear_kernel_at_the_multivariate_training_shapes(cuda, B,
                                                                  D):
    """K1 at the generator step's 64 and 128 rows at SWaT's and WADI's
    feature counts (the few-rows path, W staged by cp.async): within 1e-6
    of the plain version, one launch, and by the profiler the narrow
    kernel alone."""
    g = torch.Generator().manual_seed(B + D)
    head = init_tadgan(g, D, hyperbolic=True,
                       device=cuda)["decoder"].hyperbolic_linear
    w, b = head.w.detach(), head.b.detach()
    x = (torch.rand(B, D, generator=g) * 2 - 1).to(cuda)
    got, names, launched = _traced(lambda: mobius_linear_kernel(x, w, b),
                                   mobius_linear_kernel)
    assert launched == 1
    assert len(names) == 1 and "mobius_linear_kernel" in names[0]
    assert (got - mobius_linear(x, w, b)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("D", [123, 150])
def test_mobius_linear_kernel_signal_axis_at_the_training_shapes(cuda, D):
    """Three signals of 64 rows at WADI's and CASAS's widths in one launch
    (narrow and wide few-rows paths): each signal bitwise its own launch,
    within 1e-6 of the plain version."""
    g = torch.Generator().manual_seed(D)
    heads = [init_tadgan(g, D, hyperbolic=True, device=cuda)["decoder"]
             .hyperbolic_linear for _ in range(3)]
    w = torch.stack([h.w.detach() for h in heads])
    b = torch.stack([h.b.detach() for h in heads])
    x = (torch.rand(3, 64, D, generator=g) * 2 - 1).to(cuda)
    before = mobius_linear_kernel.launches
    got = mobius_linear_kernel(x, w, b)
    assert mobius_linear_kernel.launches == before + 1
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
                                        (300, 257, 100), (100, 64, 700),
                                        (64, 300, 12000)])
def test_mobius_linear_xwide_kernel_matches_plain(cuda, B, din, dout):
    """K1's any-width kernels against the plain version within 1e-6, one
    launch each, and by the profiler the one that takes the shape alone:
    the split kernel where a cluster holds W (dout up to 512) and walks at
    most 2 tiles, else the ring (at 12,000 columns with each row's products
    in the output, as no warp's rows of them fit in shared memory)."""
    g = torch.Generator().manual_seed(B + din + dout)
    w = (torch.randn(dout, din, generator=g) / (din * dout) ** 0.5).to(cuda)
    b = (torch.randn(dout, generator=g) / 400).to(cuda)
    b = b / (1 + b.norm())
    x = (torch.rand(B, din, generator=g) * 2 - 1).to(cuda)
    before = mobius_linear_kernel.xwide_launches
    got, names, launched = _traced(lambda: mobius_linear_kernel(x, w, b),
                                   mobius_linear_kernel)
    assert launched == 1 and mobius_linear_kernel.xwide_launches > before
    split = (B, din, dout) in ((64, 300, 300), (128, 512, 512),
                               (300, 257, 100))
    want = ("mobius_linear_xwide_kernel_split" if split
            else "mobius_linear_xwide_kernel_ring")
    assert len(names) == 1 and want in names[0], names
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


# ---------------------------------------------------------------------------
# K5 with its critic resident in shared memory: the staging's edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hyperbolic,B,width", [(True, 64, 123),
                                                (False, 64, 123),
                                                (True, 64, 51),
                                                (True, 64, 256),
                                                (True, 100, 100),
                                                (True, 100, 150)])
def test_critic_step_kernels_at_the_staging_edges(cuda, hyperbolic, B,
                                                  width):
    """K5 and K4 where the weights are awkward: rows of 123 and 51 floats
    (492 and 204 bytes, off the 16-byte boundary a copy needs, and no
    float4 loads), the Mobius head at 256, and B = 100 (13 rows a rank, one
    rank 9): against autograd within the other checks' tolerances, two
    launches bitwise equal."""
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.train import critic_kernel as ck

    model, x, d = critic_case(cuda, hyperbolic, B, width)
    got = ck.critic_step_fused_full(model, x, d, hyperbolic)
    again = ck.critic_step_fused_full(model, x, d, hyperbolic)
    torch.cuda.synchronize()
    _assert_critic_close(got, ck.critic_step_plain(model, x, d, hyperbolic),
                         dict(rtol=5e-5, atol=2e-6),
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


def test_critic_step_signal_axis_with_unaligned_slices(cuda):
    """K5 with a signal axis at width 123: each signal's slice of a
    stacked weight starts off the 16-byte boundary (a (123,) bias is 492
    bytes), so its critic lands elsewhere in its resident place; each
    signal bitwise its own single-signal launch."""
    from hypad_tpu_torch.profile_critic_step import case_inputs
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.train import critic_kernel as ck

    P, x, d = case_inputs(cuda, True, 64, 123, 3)
    assert P["decoder.dense2.b"][1].data_ptr() % 16 != 0
    got = ck.critic_step_fused_full_fleet(P, x, d, True)
    for i in range(3):
        model, xi, di = critic_case(cuda, True, 64, 123, seed=i)
        one = ck.critic_step_fused_full(model, xi, di, True)
        assert torch.equal(got[0][i], one[0])
        assert torch.equal(got[1][i], one[1])
        for j in (2, 3):
            for k in one[j]:
                assert torch.equal(got[j][k][i], one[j][k]), k


def test_critic_step_reads_in_place_what_it_cannot_stage(cuda):
    """Past the widths whose critic and generator rows fit in shared
    memory, K5 reads a side's weights where they lie (at 4,000 side x,
    whose critic_x is 320 KB; side z still stages), with the same
    tolerances and two launches the same bits; past one tile row of the
    widest input (about 58,000 floats) the launch is refused, the wrapper
    raises its CUDA error and no launch is counted."""
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.train import critic_kernel as ck

    smem = ck.smem_bytes((8, 4000, 20, 20, 20, 50, 50, 64), True, False)
    assert (smem["direct_x"], smem["direct_z"]) == (1, 0)
    model, x, d = critic_case(cuda, False, 8, 4000)
    got = ck.critic_step_fused_full(model, x, d, False)
    _assert_critic_close(got, ck.critic_step_plain(model, x, d, False),
                         dict(rtol=5e-5, atol=2e-6),
                         dict(rtol=1e-4, atol=1e-6))
    _assert_bitwise(got, ck.critic_step_fused_full(model, x, d, False))
    model, x, d = critic_case(cuda, False, 8, 60000)
    before = ck.critic_step_fused_full.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        ck.critic_step_fused_full(model, x, d, False)
    assert ck.critic_step_fused_full.launches == before
    assert ck.smem_bytes((8, 60000, 20, 20, 20, 50, 50, 64), True,
                         False) is None


# ---------------------------------------------------------------------------
# the side modules on the card: the Mobius GRU and the device trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
def test_mobius_gru_loop_on_the_card_matches_the_cpu(cuda, packed):
    """The GRU loop (batch 64, 40 steps, input 1, hidden 100), dense or
    packed with ragged lengths, on the card against the CPU from the same
    weights, within chip_smoke.py's GRU_TOL; inside the ball; the dense
    loop's gradients finite (a packed loop's masked rows give weight_ih a
    NaN gradient, as JAX's do: tests/test_torch_hyrnn.py)."""
    import numpy as np

    from hypad_tpu_torch.manifold import stereographic as st
    from hypad_tpu_torch.models import hyrnn

    rng = np.random.default_rng(0)
    T, B = 40, 64
    x = torch.as_tensor(rng.standard_normal((T, B, 1)) * 0.5,
                        dtype=torch.float32)
    h0 = torch.as_tensor(rng.standard_normal((B, 100)) * 0.05,
                         dtype=torch.float32)
    lengths = np.sort(rng.integers(1, T + 1, B))[::-1].copy()
    lengths[0] = T
    batch_sizes = (lengths[None, :] > np.arange(T)[:, None]).sum(1)
    data = torch.cat([x[t, :n] for t, n in enumerate(batch_sizes)])
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        gru = hyrnn.MobiusGRU(1, 100, generator=torch.Generator().manual_seed(
            1), device=dev)
        if packed:
            out, h = gru(data.to(dev), h0.to(dev), batch_sizes=batch_sizes)
        else:
            out, h = gru(x.to(dev), h0.to(dev))
            torch.sum(st.dist0(h)).backward()
            assert all(bool(torch.isfinite(p.grad).all())
                       for p in gru.parameters())
        outs[dev.type] = (out.detach().cpu(), h.detach().cpu())
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        assert float(torch.linalg.norm(got, dim=-1).max()) < 1.0


def test_trace_names_k1_and_k2_on_the_card(cuda, tmp_path):
    """A hyperbolic detect inside ``trace`` with ``annotate``: the Chrome
    trace holds the annotation and kernel events of K1
    (``mobius_linear_kernel``) and K2 (``kde_argmax_kernel``)."""
    import json
    import re

    from hypad_tpu_torch.data.pipeline import synthetic_detect_input
    from hypad_tpu_torch.detect.detector import detect_univariate
    from hypad_tpu_torch.utils.profiling import annotate, trace

    X, index, known = synthetic_detect_input(2000, 100, seed=0)
    model = init_tadgan(torch.Generator().manual_seed(0), 100,
                        hyperbolic=True, device=cuda)
    detect_univariate(model, X, index, known, device=cuda)   # warm
    for attempt in range(3):
        logdir = tmp_path / str(attempt)
        with trace(str(logdir)):
            with annotate("detect"):
                detect_univariate(model, X, index, known, device=cuda)
                torch.cuda.synchronize()
        (path,) = logdir.glob("*.json")
        events = json.loads(path.read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        if kernels:   # the profiler now and then records no device event
            break
    assert "detect" in {e.get("name") for e in events}
    for name in ("mobius_linear_kernel", "kde_argmax_kernel"):
        assert any(re.search(rf"\b{name}\b", k) for k in kernels), kernels


# ---------------------------------------------------------------------------
# a mesh of two shards on one card (cuda:0 twice), or of two cards
# ---------------------------------------------------------------------------

def _two_shard_mesh():
    from hypad_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    return make_mesh([torch.device("cuda", 0),
                      torch.device("cuda", 1 if n >= 2 else 0)])


@pytest.mark.parametrize("hyperbolic", [True, False])
def test_sharded_detect_launches_per_shard_and_equals_unsharded(cuda,
                                                                hyperbolic):
    """The sharded detect on the card: K1 and K2 (hyperbolic) or K3
    (Euclidean dtw, v2) once per shard where the unsharded call launches
    them once; scores within JAX's sharded tolerance (3e-4 / 3e-5)."""
    import numpy as np

    from hypad_tpu_torch.detect.scorer import detect_scores

    mesh = _two_shard_mesh()
    model = init_tadgan(torch.Generator().manual_seed(3), 100,
                        hyperbolic=hyperbolic, device="cuda:0")
    X = np.random.default_rng(3).uniform(-1, 1, (2003, 100)).astype(
        np.float32)
    kw = dict(rec_error="dtw", kde_version="v1" if hyperbolic else "v2",
              fetch_inference=False, device="cuda:0")
    counters = [mobius_linear_kernel, kde_argmax_kernel, kde_argmax_v2_kernel]
    before = [k.launches for k in counters]
    want, _ = detect_scores(model, X, hyperbolic, "mult", **kw)
    mid = [k.launches for k in counters]
    got, _ = detect_scores(model, X, hyperbolic, "mult", mesh=mesh, **kw)
    after = [k.launches for k in counters]
    one = [m - b for m, b in zip(mid, before)]
    assert [a - m for a, m in zip(after, mid)] == [2 * n for n in one]
    assert one == ([2, 1, 0] if hyperbolic else [0, 0, 1])
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_sharded_epoch_matches_unsharded(cuda):
    """One ``fused_critics`` False epoch on the 2-shard mesh against the
    unsharded epoch, same weights and draws: losses within 1e-4 / 1e-5,
    parameters within 5e-3 / 5e-4 (tests/test_trainer.py's dp bounds),
    K1 twice the unsharded epoch's launches."""
    import numpy as np

    from hypad_tpu_torch.train import trainer as tr

    X = torch.as_tensor(np.random.default_rng(4).uniform(
        -1, 1, (256, 100)).astype(np.float32), device="cuda:0")
    out = []
    for mesh in (None, _two_shard_mesh()):
        model = init_tadgan(torch.Generator().manual_seed(4), 100,
                            hyperbolic=True, device="cuda:0")
        draws = tr.epoch_draws(tr.epoch_generator(0, 0), 256, 32, model)
        state = tr.init_train_state(model, 5e-4, True)
        before = mobius_linear_kernel.launches
        _, metrics = tr.run_epoch(state, X, draws, lr=5e-4, hyperbolic=True,
                                  mesh=mesh)
        out.append((model.state_dict(), metrics,
                    mobius_linear_kernel.launches - before))
    (p1, m1, k1), (p2, m2, k2) = out
    assert k2 == 2 * k1 == 2 * 7 * (256 // 32)
    for name in m1:
        np.testing.assert_allclose(m2[name], m1[name], rtol=1e-4, atol=1e-5)
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("N,W,const,nans", [
    (2000, 129, False, False), (5000, 150, False, False),
    (300, 150, True, False), (300, 150, False, True),
    (3000, 256, False, False), (1000, 257, False, False),
    (2000, 300, False, False), (1000, 300, True, False),
    (1000, 300, False, True), (1000, 512, False, False),
    (500, 1024, False, False), (64, 4096, False, False),
    (300, 4096, True, False), (64, 4097, False, False)])
def test_kde_argmax_v2_group_kernels(cuda, N, W, const, nans):
    """K3 above 128 columns: the group kernels up to kK3TriMaxW (4,096)
    columns, the one-block-a-row kde_argmax_v2_xwide_kernel past it, named
    by the profiler; two launches give the same bits; use flags bitwise and
    fallback rows bitwise masked_median; the other rows at a float64
    density tie of the plain v2 form's and of K2's."""
    from hypad_tpu_torch.profile_kernels import (
        k3_constants,
        near_tie_flips,
        same_values,
    )

    assert k3_constants()["kK3TriMaxW"] == 4096
    critic = torch.randn(N, generator=torch.Generator().manual_seed(N + W))
    if const:
        critic[10:N] = 0.5
    if nans:
        critic[:2] = critic[100:200] = float("nan")
    vals, mask = antidiagonal_gather(critic.to(cuda)[:, None].expand(N, W))
    (got, use), names, launched = _traced(
        lambda: kde_argmax_v2_kernel(vals, mask), kde_argmax_v2_kernel)
    assert launched == 1 and len(names) == 1
    want_name = ("kde_argmax_v2_xwide_kernel" if W > 4096 else
                 "kde_argmax_v2_group_xwide_kernel" if W > 256 else
                 "kde_argmax_v2_group_wide_kernel")
    assert want_name in names[0]
    again, again_use = kde_argmax_v2_kernel(vals, mask)
    assert same_values(again, got) and torch.equal(again_use, use)
    want, want_use = kde_argmax_rows_v2_and_use(vals, mask)
    assert torch.equal(use, want_use)
    assert same_values(got[~use], masked_median(vals, mask)[~use])
    if const:
        assert (~use).sum() > 0
    near_tie_flips(got[use], want[use], vals[use], mask[use])
    k2, k2_use = kde_argmax_kernel(vals, mask)
    assert torch.equal(k2_use, use)
    near_tie_flips(got[use], k2[use], vals[use], mask[use])


@pytest.mark.parametrize("N,W,const,nans", [
    (2000, 129, False, False), (5000, 150, False, False),
    (300, 150, True, False), (300, 150, False, True),
    (3000, 256, False, False), (300, 256, True, False),
    (1000, 257, False, False), (2000, 300, False, False),
    (1000, 300, True, False), (1000, 300, False, True),
    (1000, 512, False, False), (500, 1024, False, False),
    (64, 4096, False, False), (300, 4096, True, False),
    (64, 4097, False, False), (300, 4097, False, True)])
def test_kde_argmax_group_kernels(cuda, N, W, const, nans):
    """K2 above 128 columns: the group kernels up to kK3TriMaxW (4,096)
    columns, the one-block-a-row kde_argmax_xwide_kernel past it, named by
    the profiler; two launches give the same bits; use flags bitwise and
    fallback rows bitwise masked_median; the other rows at a float64
    density tie of the plain version's."""
    from hypad_tpu_torch.profile_kernels import (
        k3_constants,
        near_tie_flips,
        plain_k2,
        same_values,
    )

    assert k3_constants()["kK3TriMaxW"] == 4096
    critic = torch.randn(N, generator=torch.Generator().manual_seed(N + W))
    if const:
        critic[10:N] = 0.5
    if nans:
        critic[:2] = critic[100:200] = float("nan")
    vals, mask = antidiagonal_gather(critic.to(cuda)[:, None].expand(N, W))
    (got, use), names, launched = _traced(
        lambda: kde_argmax_kernel(vals, mask), kde_argmax_kernel)
    assert launched == 1 and len(names) == 1
    want_name = ("kde_argmax_xwide_kernel" if W > 4096 else
                 "kde_argmax_group_xwide_kernel" if W > 256 else
                 "kde_argmax_group_wide_kernel")
    assert want_name in names[0] and "_v2_" not in names[0]
    again, again_use = kde_argmax_kernel(vals, mask)
    assert same_values(again, got) and torch.equal(again_use, use)
    want, want_use = plain_k2(W)(vals, mask)
    assert torch.equal(use, want_use)
    assert same_values(got[~use], masked_median(vals, mask)[~use])
    if const or nans:
        assert (~use).sum() > 0
    near_tie_flips(got[use], want[use], vals[use], mask[use])


@pytest.mark.parametrize("W", [150, 300, 1024])
def test_kde_argmax_group_kernels_rows_bitwise_their_own_launch(cuda, W):
    """A fleet detection launches K2 once on every signal's rows: in the
    group kernels a row's bits do not depend on where it lies in the
    launch, so each signal's rows equal its own launch's bit for bit."""
    from hypad_tpu_torch.profile_kernels import same_values

    parts = []
    for i, n in enumerate((700, 1_300, 301)):
        critic = torch.randn(n, generator=torch.Generator().manual_seed(i))
        parts.append(antidiagonal_gather(
            critic.to(cuda)[:, None].expand(n, W)))
    vals = torch.cat([v for v, _ in parts])
    mask = torch.cat([m for _, m in parts])
    got, use = kde_argmax_kernel(vals, mask)
    start = 0
    for v, m in parts:
        own, own_use = kde_argmax_kernel(v, m)
        rows = slice(start, start + v.shape[0])
        assert same_values(got[rows], own) and torch.equal(use[rows], own_use)
        start += v.shape[0]


def split_launches():
    """The launches of K1's few-rows split instance so far, as the
    extension counts them (``mobius_linear_split_launches``)."""
    import ctypes

    from hypad_tpu_torch import _build

    fn = _build.load("mobius_linear").mobius_linear_split_launches
    fn.restype = ctypes.c_longlong
    return fn()


@pytest.fixture(scope="module")
def few_rows_kernels():
    """{"few_rows": K1 launcher of the tree built without the few-rows split
    instance (kFewSplitRanks = 0: the few-rows kernels it replaces, the
    parent's code), "parent": the parent's K1 where a parent commit is
    unpacked under _checkout/parent (else absent)}: nvcc on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import ctypes
    from pathlib import Path

    from hypad_tpu_torch import _build
    from hypad_tpu_torch.profile_critic_step import OUT, variant_jobs
    from hypad_tpu_torch.profile_k1 import launcher, variant_source

    text = (_build.CSRC / "mobius_linear.cu").read_text()
    jobs = variant_jobs({"k1_few_rows": variant_source(
        text, "kFewSplitRanks=0")})
    parent = (Path(__file__).resolve().parents[1] / "_checkout" / "parent"
              / "hypad_tpu_torch" / "csrc" / "mobius_linear.cu")
    if parent.is_file():
        jobs["k1_parent"] = (parent, OUT / "libk1_parent_cuda_test.so")
    _build.compile_sources(jobs)
    return {name[3:]: launcher(ctypes.CDLL(str(lib)))
            for name, (_, lib) in jobs.items()}


@pytest.mark.parametrize("B,D,signals,scale,split", [
    (64, 100, None, 1.0, True), (128, 100, None, 1.0, True),
    (64, 100, 3, 1.0, True), (64, 51, 3, 1.0, True),
    (64, 123, None, 1.0, True), (64, 150, None, 1.0, True),
    (128, 256, None, 1.0, True), (130, 64, None, 1.0, True),
    (8, 100, None, 1e6, True), (9, 300, None, 1.0, False),
    (2280, 100, 3, 1.0, False)])
def test_mobius_linear_few_rows_split_bitwise_the_few_rows_kernels(
        cuda, few_rows_kernels, B, D, signals, scale, split):
    """The few-rows split instance (``mobius_linear_kernel_split`` up to 128
    columns, ``mobius_linear_wide_kernel_split`` above) at the generator
    step's shapes, an odd width, a huge weight (the clamps) and 9 rows:
    it takes the launch (the extension's count of its launches,
    ``mobius_linear_split_launches``, and its plan,
    ``mobius_linear_split_plan``, agree), one launch, bitwise the few-rows
    kernels it replaces and the parent's K1 where built, each signal its
    own launch, within 1e-6 of plain; at 300 columns and at 2,280 rows a
    signal (more tiles than clusters fit the card) it has no plan and the
    kernels of before take the launch, the same bits."""
    from hypad_tpu_torch import _build
    from hypad_tpu_torch.profile_k1 import k1_case, split_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = split_plan(_build.load("mobius_linear"), signals or 1, B, D, D,
                      sms)
    assert (plan is not None) is split, plan
    x, w, b = k1_case(B, D, signals, device=cuda)
    w = (w * scale).contiguous()
    before = mobius_linear_kernel.launches
    split_before = split_launches()
    got = mobius_linear_kernel(x, w, b)
    torch.cuda.synchronize()
    assert mobius_linear_kernel.launches == before + 1
    assert split_launches() == split_before + split
    for fn in few_rows_kernels.values():
        assert torch.equal(got, fn(x, w, b))
    if signals:
        for i in range(signals):
            assert torch.equal(got[i], mobius_linear_kernel(
                x[i].contiguous(), w[i].contiguous(), b[i]))
    assert (got - mobius_linear(x, w, b)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("moved", ["x", "w"])
def test_mobius_linear_few_rows_split_unaligned_after_aligned(
        cuda, few_rows_kernels, moved):
    """(64, 100), the main path's width, on 16-byte-aligned x and W (each
    rank's W rows and the tile copied into place), then at the same shape
    on an x (or W) one float past a 16-byte boundary (a plan of its own:
    copies from the boundary below into raw regions, repacked): the split
    instance takes both launches, each bitwise the aligned launch, the
    few-rows kernels it replaces and the parent's K1 where built."""
    from hypad_tpu_torch.profile_k1 import k1_case

    x, w, b = k1_case(64, 100, None, device=cuda)
    before = split_launches()
    got = mobius_linear_kernel(x, w, b)
    t = x if moved == "x" else w
    off = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
    assert off.data_ptr() % 16 == 4
    off.copy_(t)
    args = (off, w, b) if moved == "x" else (x, off, b)
    again = mobius_linear_kernel(*args)
    torch.cuda.synchronize()
    assert split_launches() == before + 2
    assert torch.equal(got, again)
    for fn in few_rows_kernels.values():
        assert torch.equal(got, fn(*args))


DIV_RN_CHECK = r"""
__global__ void div_rn_check_kernel(const float* a, const float* b,
                                    float* q, float* ref, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a1[1] = {a[i]}, q1[1];
  div_rn(q1, a1, b[i]);
  q[5 * i] = q1[0];
  ref[5 * i] = a[i] / b[i];
  float a4[4], q4[4];
  for (int j = 0; j < 4; ++j) a4[j] = a[(i ^ j) < n ? (i ^ j) : i];
  div_rn(q4, a4, b[i]);
  for (int j = 0; j < 4; ++j) {
    q[5 * i + 1 + j] = q4[j];
    ref[5 * i + 1 + j] = a4[j] / b[i];
  }
}

extern "C" int mobius_linear_div_rn_check(const float* a, const float* b,
                                          float* q, float* ref, int n) {
  div_rn_check_kernel<<<(n + 255) / 256, 256>>>(a, b, q, ref, n);
  cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : cudaDeviceSynchronize();
}
"""


def div_rn_operands():
    """(a, b) float32 pairs for div_rn: b of 64 random mantissas at every
    exponent within 4 of -60, 0 and 60 and both signs, and at 2^-61, 2^-60,
    2^60, 2^61 and their neighbours; each against a of +0, -0, subnormals,
    2^-126, the range's edges and their neighbours, 1, random values over
    the whole normal range and both signs."""
    import numpy as np

    rng = np.random.default_rng(19)
    f32 = np.float32
    mant = 1.0 + rng.random(64)
    bs = [s * m * 2.0 ** e for e in (*range(-64, -55), *range(-4, 5),
                                     *range(56, 65))
          for m in mant[:8] for s in (1, -1)]
    edges = [f32(2.0 ** e) for e in (-61, -60, 60, 61)]
    edges += [np.nextafter(e, f32(d)) for e in edges for d in (0, np.inf)]
    bs = np.array(bs + edges + [-e for e in edges], dtype=f32)
    a_fixed = [0.0, -0.0, 1e-45, -1e-45, 1e-40, 2.0 ** -126, 1.0, -1.0,
               *edges, *[-e for e in edges], f32(3.4e38), f32(-3.4e38)]
    a_rand = (rng.choice([-1.0, 1.0], 256) * (1.0 + rng.random(256))
              * 2.0 ** rng.integers(-126, 127, 256))
    a = np.array(a_fixed + list(a_rand), dtype=f32)
    aa, bb = np.meshgrid(a, bs, indexing="ij")
    return aa.ravel().astype(f32), bb.ravel().astype(f32)


def test_div_rn_bitwise_the_division(cuda):
    """K1's ``div_rn`` (the few-rows split instance's branch-free division)
    against ``/`` on the card, bitwise (signs of zeros and NaNs' positions
    included), one quotient and four sharing a divisor, over operands at
    and around the edges of its fast path's range [2^-60, 2^60], inside it
    and past it on either side, zeros and subnormals; and, where every
    operand and the quotient are normal, against numpy's correctly rounded
    f32 quotient."""
    import ctypes

    import numpy as np

    from hypad_tpu_torch import _build
    from hypad_tpu_torch.profile_critic_step import variant_jobs

    text = (_build.CSRC / "mobius_linear.cu").read_text() + DIV_RN_CHECK
    jobs = variant_jobs({"k1_div_rn": text})
    _build.compile_sources(jobs)
    fn = ctypes.CDLL(str(jobs["k1_div_rn"][1])).mobius_linear_div_rn_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    fn.restype = ctypes.c_int
    a_np, b_np = div_rn_operands()
    a = torch.from_numpy(a_np).to(cuda)
    b = torch.from_numpy(b_np).to(cuda)
    n = a.numel()
    q = torch.empty(5 * n, device=cuda)
    ref = torch.empty(5 * n, device=cuda)
    assert fn(a.data_ptr(), b.data_ptr(), q.data_ptr(), ref.data_ptr(),
              n) == 0
    qi = q.cpu().view(torch.int32)
    ri = ref.cpu().view(torch.int32)
    bad = (qi != ri).nonzero().flatten()
    assert bad.numel() == 0, [
        (float(a_np[k // 5]), float(b_np[k // 5]), k % 5)
        for k in bad[:10].tolist()]
    with np.errstate(all="ignore"):
        want = a_np / b_np
    tiny = np.finfo(np.float32).tiny
    normal = ((np.abs(a_np) >= tiny) & (np.abs(want) >= tiny)
              & np.isfinite(want))
    got = q.cpu().numpy()[0::5]
    assert np.array_equal(got[normal].view(np.int32),
                          want[normal].view(np.int32))


@pytest.fixture(scope="module")
def kde_expf():
    """K2 and K3 launchers of the tree built with K2's term as expf
    (kK2Ex2 = 0: the narrow K2 of before the SFU's ex2): nvcc on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import ctypes

    from hypad_tpu_torch import _build
    from hypad_tpu_torch.ops import kde_kernel as kk
    from hypad_tpu_torch.profile_critic_step import variant_jobs
    from hypad_tpu_torch.profile_kernels import K2_CONSTANTS, k3_variant_source

    text = (_build.CSRC / "kde_argmax.cu").read_text()
    jobs = variant_jobs({"kde_expf": k3_variant_source(text, "kK2Ex2=0",
                                                       K2_CONSTANTS)})
    _build.compile_sources(jobs)
    lib = ctypes.CDLL(str(jobs["kde_expf"][1]))
    return {v: (lambda vals, mask, fn=kk.bind(lib, entry):
                kk.launch_with(fn, vals, mask))
            for v, entry in (("v1", "kde_argmax_forward"),
                             ("v2", "kde_argmax_v2_forward"))}


@pytest.mark.parametrize("N,W,const,nans", [
    (20000, 100, False, False), (700, 64, False, False),
    (300, 100, True, False), (300, 100, False, True), (300, 5, False, False),
    (2000, 128, False, False)])
def test_kde_argmax_narrow_kernel_ex2_at_density_tie(cuda, kde_expf, N, W,
                                                     const, nans):
    """The narrow K2 (up to 128 columns) on the SFU's ex2, one launch: use
    flags bitwise and fallback rows bitwise
    masked_median; each other differing row a float64 density tie of the
    plain version's, and of its expf build (the narrow K2 of before), with
    whose use flags and fallback rows it agrees bitwise; the narrow K3 the
    same bits in both builds."""
    from hypad_tpu_torch.profile_kernels import near_tie_flips, same_values

    critic = torch.randn(N, generator=torch.Generator().manual_seed(N + W))
    if const:
        critic[10:40] = 0.5
    if nans:
        critic[:2] = critic[100:200] = float("nan")
    vals, mask = antidiagonal_gather(critic.to(cuda)[:, None].expand(N, W))
    before = kde_argmax_kernel.launches
    got, use = kde_argmax_kernel(vals, mask)
    torch.cuda.synchronize()
    assert kde_argmax_kernel.launches == before + 1
    want, want_use = kde_argmax_rows_and_use(vals, mask)
    assert torch.equal(use, want_use)
    assert same_values(got[~use], masked_median(vals, mask)[~use])
    near_tie_flips(got[use], want[use], vals[use], mask[use])
    old, old_use = kde_expf["v1"](vals, mask)
    assert torch.equal(old_use, use)
    assert same_values(old[~use], got[~use])
    near_tie_flips(got[use], old[use], vals[use], mask[use])
    k3, k3_use = kde_argmax_v2_kernel(vals, mask)
    old3, old3_use = kde_expf["v2"](vals, mask)
    assert same_values(k3, old3) and torch.equal(k3_use, old3_use)


def test_graphed_detect_call_is_the_eager_one_bitwise(cuda):
    """``detect_scores`` on the card (hyperbolic, 2,000 windows of 100,
    "mult", K2) through its program: the eager first call, the capture and
    a replay, then a replay of other windows. The scores and the inference
    tensors bit for bit the eager calls' (the programs withheld), the
    launch counts equal (K1 2, K2 1 a call)."""
    import numpy as np

    from hypad_tpu_torch.detect import graphed, scorer

    model = init_tadgan(torch.Generator().manual_seed(0), 100,
                        hyperbolic=True, device=cuda)
    rng = np.random.default_rng(0)
    X1, X2 = (rng.uniform(-1, 1, (2000, 100)).astype(np.float32)
              for _ in range(2))

    def call(X):
        before = (mobius_linear_kernel.launches, kde_argmax_kernel.launches)
        scores, inference = scorer.detect_scores(model, X, True, "mult",
                                                 device=cuda)
        counts = (mobius_linear_kernel.launches - before[0],
                  kde_argmax_kernel.launches - before[1])
        return [scores, *(t for t in inference if t is not None)], counts

    with graphed.eager():
        want = [call(X1), call(X2)]
    got = [call(X1), call(X1), call(X2)]
    progs = graphed.programs(model)
    assert len(progs) == 1 and progs[0].graph is not None
    for (arrays, counts), (want_arrays, want_counts) in zip(
            got, [want[0], want[0], want[1]]):
        assert counts == want_counts == (2, 1)
        assert len(arrays) == len(want_arrays) == 6
        for a, b in zip(arrays, want_arrays):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    graphed.release_programs(model)
