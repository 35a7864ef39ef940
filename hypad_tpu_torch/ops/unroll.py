"""Anti-diagonal unrolling of window-stacked values.

Port of ``hypad_tpu.ops.unroll``: ``antidiagonal_gather`` (the gather-free
pad-reshape skew), ``masked_median``, and the two series the Euclidean
reconstruction errors compare, ``unroll_median`` and ``true_series``.

The ragged forms serve the fleet detector: (S, N, W) windows padded from
each signal's ``n_real`` real ones; entries drawn from pad windows are
masked out, so every masked consumer sees each signal's own length-n_real
structure (JAX's ``n_real`` forms and ``true_series_ragged``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def antidiagonal_gather(y_hat):
    """(N, W) window-stacked values -> (T, W) anti-diagonal matrix + mask.

    Row i holds ``y_hat[i - j, j]`` for the valid j's in ascending-j order;
    invalid entries are 0 with mask False. T = N + W - 1. Padding each row
    of y_hat.T by W zeros and re-viewing the flat buffer at width T shifts
    row j right by exactly j, so no gather is needed."""
    N, W = y_hat.shape
    T = N + W - 1
    P = F.pad(y_hat.T, (0, W))                       # (W, N + W)
    vals = P.reshape(-1)[:-W].reshape(W, T).T.contiguous()
    i = torch.arange(T, device=y_hat.device)[:, None]
    j = torch.arange(W, device=y_hat.device)[None, :]
    n = i - j
    mask = (n >= 0) & (n < N)
    return vals, mask


def masked_median(vals, mask):
    """Per-row median over the masked entries (np.median semantics: mean of
    the two middle order statistics for even counts). An all-masked row
    wraps its index like the JAX version and is never used by callers."""
    big = torch.finfo(vals.dtype).max
    filled = torch.where(mask, vals, torch.full_like(vals, big))
    s = torch.sort(filled, dim=-1).values
    cnt = torch.sum(mask, dim=-1)
    width = vals.shape[-1]
    lo = torch.gather(s, -1, torch.remainder((cnt - 1) // 2, width)[:, None])
    hi = torch.gather(s, -1, torch.remainder(cnt // 2, width)[:, None])
    return 0.5 * (lo[:, 0] + hi[:, 0])


def unroll_median(y_hat):
    """Per-timestep median of every window's prediction for it: (N, W) ->
    (T,), T = N + W - 1."""
    return masked_median(*antidiagonal_gather(y_hat))


def true_series(y):
    """The signal the windows were cut from: the first sample of every
    window, then the rest of the last window. (N, W) -> (T,)."""
    return torch.cat([y[:, 0], y[-1, 1:]])


def antidiagonal_gather_ragged(y_hat, n_real):
    """(S, N, W) padded window stacks -> (S, T, W) anti-diagonal values and
    mask, T = N + W - 1, each signal's entries from its first
    ``n_real[s]`` windows only (``n_real`` an (S,) tensor)."""
    S, N, W = y_hat.shape
    T = N + W - 1
    P = F.pad(y_hat.transpose(1, 2), (0, W))             # (S, W, N + W)
    vals = P.reshape(S, -1)[:, :-W].reshape(S, W, T).transpose(1, 2)
    i = torch.arange(T, device=y_hat.device)[:, None]
    j = torch.arange(W, device=y_hat.device)[None, :]
    n = (i - j)[None]
    mask = (n >= 0) & (n < n_real.reshape(-1, 1, 1))
    return vals.contiguous(), mask


def unroll_median_ragged(y_hat, n_real):
    """Per-timestep median of each signal's real windows: (S, N, W) ->
    (S, T)."""
    vals, mask = antidiagonal_gather_ragged(y_hat, n_real)
    S, T, W = vals.shape
    return masked_median(vals.reshape(S * T, W),
                         mask.reshape(S * T, W)).reshape(S, T)


def true_series_ragged(y, n_real):
    """``true_series`` of each signal's first ``n_real[s]`` windows of the
    padded (S, N, W) ``y`` -> (S, T): positions [0, n) take the window
    starts, [n, n + W - 1) the tail of window n - 1; later entries are
    unspecified."""
    S, N, W = y.shape
    first = F.pad(y[:, :, 0], (0, W - 1))                # (S, T)
    last = y[torch.arange(S, device=y.device),
             (n_real - 1).clamp_min(0)]                  # (S, W)
    pos = n_real.reshape(-1, 1) + torch.arange(W - 1, device=y.device)
    return first.scatter(1, pos, last[:, 1:])
