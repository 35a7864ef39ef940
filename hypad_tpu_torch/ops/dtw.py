"""Batched classic DTW over short sliding windows, as an anti-diagonal
wavefront.

Port of ``hypad_tpu.ops.dtw``: the DTW distance (squared point cost, sqrt
of the accumulated terminal cost) between each 11-sample window of the true
and predicted series, sliding by 1 after zero-padding 5 on each side. The
(L, L) accumulated-cost table is swept along its 2L - 1 anti-diagonals:
every cell of a diagonal depends only on the two before it, so each step is
a few (L, N) elementwise operations over the whole batch. Every operation
(subtract, multiply, add, min, sqrt) is correctly rounded IEEE f32 in the
JAX package's order, so the results equal its bit for bit. JAX computes this
outside any Pallas kernel, so it stays plain PyTorch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _dtw_batch_diag(tw, pw):
    """Terminal DTW distances of a batch of window pairs. tw, pw: (N, L)
    true and predicted windows -> (N,). The state arrays are (L, N): row k
    of diagonal d is the cell (k, d - k)."""
    n, length = tw.shape
    big = torch.finfo(tw.dtype).max / 4
    x = tw.T                          # x[k] = tw[:, k]
    y_rev = pw.flip(1).T              # y_rev[k] = pw[:, L-1-k]
    big_row = tw.new_full((1, n), big)
    prevprev = tw.new_full((length, n), big)
    prev = prevprev
    k = torch.arange(length, device=tw.device)[:, None]
    for d in range(2 * length - 1):
        # pw[:, d-k] is a roll of the reversed windows; the lanes that wrap
        # are exactly the cells off the table, masked below
        diff = x - torch.roll(y_rev, d - (length - 1), dims=0)
        cost = diff * diff
        valid = (k <= d) & (k >= d - (length - 1))
        if d == 0:
            cur = torch.where(valid, cost, big)
        else:
            up = torch.cat([big_row, prev[:-1]])          # (k-1, j)
            diag = torch.cat([big_row, prevprev[:-1]])    # (k-1, j-1)
            best = torch.minimum(torch.minimum(prev, up), diag)
            cur = torch.where(valid, cost + best, big)
        prevprev, prev = prev, cur
    # torch's vectorised f32 sqrt on the CPU is not always correctly
    # rounded; the f64 root rounded once to f32 is, on every device
    return torch.sqrt(prev[length - 1].double()).to(tw.dtype)


def dtw_pair(x, y):
    """Classic DTW distance of two equal-length 1-D series."""
    return _dtw_batch_diag(x[None, :], y[None, :])[0]


def dtw_errors(true, pred, score_window=10):
    """The DTW reconstruction error of two (T,) series -> (T,): half a
    window of zeros, the T - L window distances, then zeros to the end
    (L = score_window // 2 * 2 + 1). Leading axes (a fleet's (S, T)) are
    batched: every window of every series in one wavefront."""
    length = (score_window // 2) * 2 + 1
    half = length // 2
    T = true.shape[-1]
    n_windows = T - length
    lead = true.shape[:-1]
    tw = F.pad(true, (half, half)).unfold(-1, length, 1)[..., :n_windows, :]
    pw = F.pad(pred, (half, half)).unfold(-1, length, 1)[..., :n_windows, :]
    out = true.new_zeros(true.shape)
    out[..., half:half + n_windows] = _dtw_batch_diag(
        tw.reshape(-1, length), pw.reshape(-1, length)).reshape(*lead, -1)
    return out
