"""Rolling-window statistics with pandas semantics, as cumulative sums.

Port of ``hypad_tpu.ops.rolling``: ``rolling_mean_centered`` (pandas'
``rolling(window, center=True, min_periods)``, whose centered window for
label i covers ``[i - w//2, i - w//2 + w - 1]`` clipped to the array) as
cumulative-sum differences, and ``zscore`` (ddof=0). The ragged (padded
fleet) variants are not ported yet.
"""

from __future__ import annotations

import torch


def rolling_mean_centered(x, window, min_periods=None):
    """pd.Series(x).rolling(window, center=True, min_periods).mean(). NaN
    inputs are skipped like pandas; NaN out where fewer than
    ``min_periods`` finite samples fall in the window. The arithmetic of the
    JAX package's cumsum form: window sums are differences of cumulative
    sums."""
    if min_periods is None:
        min_periods = window
    n = x.shape[0]
    finite = torch.isfinite(x)
    zero = x.new_zeros(1)
    csum = torch.cat([zero, torch.cumsum(torch.where(finite, x, 0.0), 0)])
    ccnt = torch.cat([zero, torch.cumsum(finite.to(x.dtype), 0)])
    i = torch.arange(n, device=x.device)
    start = (i - window // 2).clamp(0, n)
    end = (i - window // 2 + window).clamp(0, n)
    sums = csum[end] - csum[start]
    cnt = ccnt[end] - ccnt[start]
    mean = sums / cnt.clamp_min(1.0)
    return torch.where(cnt >= min_periods, mean, torch.nan)


def zscore(x):
    """scipy.stats.zscore (ddof=0). NaN-free input expected."""
    return (x - x.mean()) / x.std(correction=0)
