"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where no CUDA device is present. Run on a
GPU machine with ``python -m pytest tests/test_torch_cuda.py -q``."""

import pytest
import torch

from hypad_tpu_torch.manifold.kernels import mobius_linear, mobius_linear_kernel
from hypad_tpu_torch.models.tadgan import init_tadgan
from hypad_tpu_torch.ops.kde import kde_argmax_rows
from hypad_tpu_torch.ops.kde_kernel import (
    kde_argmax_kernel,
    kde_argmax_rows_fused,
)
from hypad_tpu_torch.ops.unroll import antidiagonal_gather

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,D,scale", [(20000, 100, 1.0), (130, 64, 1.0),
                                       (8, 100, 1e6), (1, 128, 1.0)])
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


@pytest.mark.parametrize("N,W,const", [(20000, 100, False), (700, 64, False),
                                       (300, 100, True), (50, 100, False)])
def test_kde_argmax_kernel_matches_plain_at_tie_level(cuda, N, W, const):
    critic = torch.randn(N, generator=torch.Generator().manual_seed(N))
    if const:
        critic[10:40] = 0.5
    vals, mask = antidiagonal_gather(critic.to(cuda)[:, None].expand(N, W))
    before = kde_argmax_kernel.launches
    got = kde_argmax_rows_fused(vals, mask)
    torch.cuda.synchronize()
    assert kde_argmax_kernel.launches == before + 1
    want = kde_argmax_rows(vals, mask)
    diff = torch.nonzero(got != want)[:, 0].cpu().numpy()
    v, m, g = vals.cpu().numpy(), mask.cpu().numpy(), got.cpu().numpy()
    assert all(g[i] in v[i][m[i]] for i in diff)
    assert len(diff) <= max(1, int(0.01 * len(g)))
