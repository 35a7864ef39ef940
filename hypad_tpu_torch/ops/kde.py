"""Batched Gaussian-KDE argmax over anti-diagonal rows, plain PyTorch.

Port of ``hypad_tpu.ops.kde.kde_argmax_rows``: per row, a Scott-bandwidth
Gaussian KDE over the masked samples (unbiased variance, h^2 = var *
n^-0.4) evaluated at those same samples; the sample where the density peaks
(first-max-wins), or the masked median when the row has one sample or zero
variance. The scale-multiply form (``scale = -0.5 / h2``, then
``scale * diff^2``) and the 1e18 masked-entry sentinel are kept as they are
there. ``kde_argmax_rows_and_use`` is the plain version of the K2 kernel
in ``ops/kde_kernel.py``: the value with the fallback folded in, and the
use flag.

``kde_argmax_rows_v2_parts`` sums the same densities by offset, one exp
per symmetric pair, as ``hypad_tpu.ops.kde_pallas._kernel_v2`` sums them;
``kde_argmax_rows_v2_and_use``, the plain version of the K3 kernel there,
folds the median fallback into it. Its additions run in another order, so
it agrees with the first form at tie level only.
"""

from __future__ import annotations

import torch

from hypad_tpu_torch.ops.unroll import masked_median

SENTINEL = 1e18


def kde_stats(vals, mask):
    """Per-row (cnt, var, scale) of the masked samples."""
    cnt = torch.sum(mask, dim=-1)
    cnt_f = cnt.clamp_min(1).to(vals.dtype)
    mean = torch.sum(torch.where(mask, vals, 0.0), -1) / cnt_f
    centered = torch.where(mask, vals - mean[:, None], 0.0)
    var = torch.sum(centered * centered, -1) / (cnt_f - 1.0).clamp_min(1.0)
    h2 = var * cnt_f ** (-0.4)
    h2_safe = torch.where(h2 > 0, h2, 1.0)
    return cnt, var, -0.5 / h2_safe


def kde_argmax_rows_parts(vals, mask, block=1024):
    """(kde_val, use_kde) per row: the density-argmax sample and whether the
    KDE applies (cnt > 1 and var > 0). Rows go in blocks to bound the
    (block, W, W) intermediate."""
    kde_vals, uses = [], []
    for start in range(0, vals.shape[0], block):
        vb, mb = vals[start:start + block], mask[start:start + block]
        cnt, var, scale = kde_stats(vb, mb)
        vs = torch.where(mb, vb, SENTINEL)
        diff = vs[:, :, None] - vs[:, None, :]                  # (t, W, W)
        dens = torch.sum(torch.exp(scale[:, None, None] * (diff * diff)), -1)
        dens = torch.where(mb, dens, -torch.inf)
        arg = torch.argmax(dens, dim=-1)
        kde_vals.append(torch.gather(vb, -1, arg[:, None])[:, 0])
        uses.append((cnt > 1) & (var > 0))
    return torch.cat(kde_vals), torch.cat(uses)


def kde_argmax_rows_v2_parts(vals, mask):
    """(kde_val, use_kde) per row, the densities summed by offset: dens
    starts at 1 (the self pair), then for r = 1..W-1 the exp of each pair
    (i, i-r) is added to lane i and, rolled back by r, to lane i-r, in that
    order. ``torch.roll`` moves like ``jnp.roll``, so ``vr[i] = vs[i - r]``;
    the lanes that wrap are exactly those with col < r, zeroed, so no (W, W)
    tensor and no padding to 128 lanes is needed."""
    cnt, var, scale = kde_stats(vals, mask)
    vs = torch.where(mask, vals, SENTINEL)
    width = vals.shape[1]
    col = torch.arange(width, device=vals.device)
    scale = scale[:, None]
    dens = torch.ones_like(vals)
    for r in range(1, width):
        d = vs - torch.roll(vs, r, dims=1)
        e = torch.where(col >= r, torch.exp(scale * (d * d)), 0.0)
        dens = dens + e + torch.roll(e, width - r, dims=1)
    dens = torch.where(mask, dens, -torch.inf)
    arg = torch.argmax(dens, dim=-1)
    return torch.gather(vals, -1, arg[:, None])[:, 0], (cnt > 1) & (var > 0)


def kde_argmax_rows_and_use(vals, mask, block=1024):
    """(value, use_kde) per row: the density-argmax sample where the KDE
    applies, else the masked median; and where it applies. The plain
    version of the K2 kernel's output (``ops/kde_kernel.py``)."""
    kde_val, use_kde = kde_argmax_rows_parts(vals, mask, block)
    return torch.where(use_kde, kde_val, masked_median(vals, mask)), use_kde


def kde_argmax_rows_v2_and_use(vals, mask):
    """(value, use_kde) per row with the densities summed by offset: the
    plain version of the K3 kernel's output (``ops/kde_kernel.py``), the
    v2 counterpart of :func:`kde_argmax_rows_and_use`."""
    kde_val, use_kde = kde_argmax_rows_v2_parts(vals, mask)
    return torch.where(use_kde, kde_val, masked_median(vals, mask)), use_kde


def kde_argmax_rows(vals, mask, block=1024):
    """Per-row KDE-argmax sample. vals (T, W) float, mask (T, W) bool ->
    (T,). Rows where the KDE does not apply take the masked median."""
    return kde_argmax_rows_and_use(vals, mask, block)[0]
