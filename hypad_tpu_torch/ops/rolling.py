"""Rolling-window statistics with pandas semantics, as cumulative sums.

Port of ``hypad_tpu.ops.rolling``: ``rolling_mean_centered`` (pandas'
``rolling(window, center=True, min_periods)``, whose centered window for
label i covers ``[i - w//2, i - w//2 + w - 1]`` clipped to the array) as
cumulative-sum differences, ``rolling_trapz_centered`` (the same windows'
unit-spacing trapezoid) and ``zscore`` (ddof=0). The ragged (padded fleet)
variants are not ported yet.
"""

from __future__ import annotations

import torch


def _window_bounds(n, window, device):
    """[start, end) of each label's centered window, clipped to [0, n]."""
    i = torch.arange(n, device=device)
    start = (i - window // 2).clamp(0, n)
    end = (i - window // 2 + window).clamp(0, n)
    return start, end


def _cumsum0(x):
    """Cumulative sum with a leading 0: window sums are differences."""
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def rolling_mean_centered(x, window, min_periods=None):
    """pd.Series(x).rolling(window, center=True, min_periods).mean(). NaN
    inputs are skipped like pandas; NaN out where fewer than
    ``min_periods`` finite samples fall in the window. The arithmetic of the
    JAX package's cumsum form: window sums are differences of cumulative
    sums."""
    if min_periods is None:
        min_periods = window
    finite = torch.isfinite(x)
    csum = _cumsum0(torch.where(finite, x, 0.0))
    ccnt = _cumsum0(finite.to(x.dtype))
    start, end = _window_bounds(x.shape[0], window, x.device)
    sums = csum[end] - csum[start]
    cnt = ccnt[end] - ccnt[start]
    mean = sums / cnt.clamp_min(1.0)
    return torch.where(cnt >= min_periods, mean, torch.nan)


def rolling_trapz_centered(x, window, min_periods=None):
    """pd rolling(window, center=True, min_periods).apply(trapz): the
    unit-spacing trapezoid of each (possibly clipped) window, its sum less
    half its first and last samples. NaN out where the window holds fewer
    than ``min_periods`` samples."""
    if min_periods is None:
        min_periods = window
    n = x.shape[0]
    csum = _cumsum0(x)
    start, end = _window_bounds(n, window, x.device)
    sums = csum[end] - csum[start]
    first = x[start.clamp(0, n - 1)]
    last = x[(end - 1).clamp(0, n - 1)]
    trapz = sums - 0.5 * (first + last)
    return torch.where((end - start) >= min_periods, trapz, torch.nan)


def zscore(x):
    """scipy.stats.zscore (ddof=0). NaN-free input expected."""
    return (x - x.mean()) / x.std(correction=0)
