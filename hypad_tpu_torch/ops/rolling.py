"""Rolling-window statistics with pandas semantics, as cumulative sums.

Port of ``hypad_tpu.ops.rolling``: ``rolling_mean_centered`` (pandas'
``rolling(window, center=True, min_periods)``, whose centered window for
label i covers ``[i - w//2, i - w//2 + w - 1]`` clipped to the array) as
cumulative-sum differences, ``rolling_trapz_centered`` (the same windows'
unit-spacing trapezoid) and ``zscore`` (ddof=0).

The ragged forms serve the fleet detector: S signals padded to one (S, T)
stack, each with its own valid length ``n`` and window, given as (S,)
tensors. Each row computes over its length-n prefix what the function
above computes on that prefix alone (JAX's ``*_ragged``, ``zscore_masked``
and ``masked_quantile``, which JAX vmaps; here the signal axis is an axis
of every op). Entries at or past n are unspecified.
"""

from __future__ import annotations

import torch


def _window_bounds(n, window, device):
    """[start, end) of each label's centered window, clipped to [0, n]."""
    i = torch.arange(n, device=device)
    start = (i - window // 2).clamp(0, n)
    end = (i - window // 2 + window).clamp(0, n)
    return start, end


def _cumsum_rows(x):
    """``torch.cumsum(x, 1)`` of an (S, T) ``x``, the same bits on every
    call. On the card torch scans a tensor that is one row with CUB, whose
    decoupled look-back adds a tile's predecessors in the order they
    finish, so two calls may differ in the last bits (and a detection's
    scores and intervals with them); two or more rows it scans each in a
    fixed order. So a single row on the card is scanned beside a row of
    zeros."""
    if x.shape[0] == 1 and x.is_cuda:
        return torch.cumsum(torch.cat([x, torch.zeros_like(x)]), 1)[:1]
    return torch.cumsum(x, 1)


def _cumsum0(x):
    """Cumulative sum with a leading 0: window sums are differences."""
    return torch.cat([x.new_zeros(1), _cumsum_rows(x[None])[0]])


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


# ---------------------------------------------------------------------------
# ragged forms: (S, T) rows with per-row valid lengths
# ---------------------------------------------------------------------------

def _col(v, like):
    """``v`` (an int, or an (S,) tensor or array) as an (S, 1) tensor on
    ``like``'s device."""
    v = torch.as_tensor(v, device=like.device)
    return v.reshape(-1, 1) if v.dim() else v.reshape(1, 1)


def _window_bounds_ragged(size, window, n, device):
    """[start, end) of each label's centered window, clipped to [0, n]:
    (S, size) each, from (S, 1) ``window`` and ``n``."""
    i = torch.arange(size, device=device)[None, :]
    start = torch.minimum((i - window // 2).clamp_min(0), n)
    end = torch.minimum((i - window // 2 + window).clamp_min(0), n)
    return start, end


def _cumsum0_rows(x):
    return torch.cat([x.new_zeros((x.shape[0], 1)), _cumsum_rows(x)], 1)


def rolling_mean_centered_ragged(x, window, n, min_periods):
    """``rolling_mean_centered`` over each row's length-n prefix of the
    padded (S, T) ``x``; ``window``, ``n``, ``min_periods`` per row."""
    window, n, min_periods = (_col(v, x) for v in (window, n, min_periods))
    size = x.shape[1]
    valid = torch.arange(size, device=x.device)[None, :] < n
    finite = torch.isfinite(x) & valid
    csum = _cumsum0_rows(torch.where(finite, x, 0.0))
    ccnt = _cumsum0_rows(finite.to(x.dtype))
    start, end = _window_bounds_ragged(size, window, n, x.device)
    sums = csum.gather(1, end) - csum.gather(1, start)
    cnt = ccnt.gather(1, end) - ccnt.gather(1, start)
    mean = sums / cnt.clamp_min(1.0)
    return torch.where(cnt >= min_periods, mean, torch.nan)


def rolling_trapz_centered_ragged(x, window, n, min_periods):
    """``rolling_trapz_centered`` over each row's length-n prefix."""
    window, n, min_periods = (_col(v, x) for v in (window, n, min_periods))
    size = x.shape[1]
    valid = torch.arange(size, device=x.device)[None, :] < n
    xz = torch.where(valid, x, 0.0)
    csum = _cumsum0_rows(xz)
    start, end = _window_bounds_ragged(size, window, n, x.device)
    sums = csum.gather(1, end) - csum.gather(1, start)
    first = xz.gather(1, start.clamp(0, size - 1))
    last = xz.gather(1, (end - 1).clamp(0, size - 1))
    trapz = sums - 0.5 * (first + last)
    return torch.where((end - start) >= min_periods, trapz, torch.nan)


def zscore_masked(x, mask):
    """Row-wise ``zscore`` over the masked entries (ddof=0); unmasked
    positions get (x - mean) / std of their row's masked population."""
    cnt = mask.sum(dim=1, keepdim=True).clamp_min(1).to(x.dtype)
    mean = torch.where(mask, x, 0.0).sum(dim=1, keepdim=True) / cnt
    var = torch.where(mask, (x - mean) ** 2, 0.0).sum(dim=1,
                                                      keepdim=True) / cnt
    return (x - mean) / torch.sqrt(var)


def masked_quantile(x, mask, q):
    """Row-wise quantile ``q`` (linear interpolation) over the masked
    entries of (S, T) ``x``: JAX's ``masked_quantile`` (a sort with the
    f32 maximum in the unmasked places, ``pos = q * max(m - 1, 0)`` in f32,
    ``s[lo] (1 - frac) + s[hi] frac``). The last step is taken as the fma
    that XLA's CPU code contracts it into, as ``detect.scorer.quartiles``
    does. -> (S,)."""
    big = torch.finfo(x.dtype).max
    s = torch.sort(torch.where(mask, x, big), dim=1).values
    m = mask.sum(dim=1, keepdim=True)
    pos = torch.tensor(q, dtype=x.dtype, device=x.device) * (
        (m - 1).clamp_min(0).to(x.dtype))
    lo, hi = torch.floor(pos), torch.ceil(pos)
    frac = pos - lo
    low = s.gather(1, lo.long()) * (1.0 - frac)
    out = s.gather(1, hi.long()).double() * frac.double() + low.double()
    return out.to(x.dtype)[:, 0]
