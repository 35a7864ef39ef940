"""Anomalous-interval extraction: the host epilogue of the detector.

A copy of ``hypad_tpu.detect.intervals`` (the port imports nothing of the
JAX package): sliding threshold windows over the score series; per window
the fixed threshold mean + 4 sigma or, with ``fixed_threshold`` None or
False (JAX's default), the dynamic threshold, which minimizes the
reference's z-cost by Nelder-Mead from every integer z start; above-
threshold run extraction with padding; max-error ranking; percent-
separation pruning; scoring (max - thr) / (mean + std); weighted merging;
finally positions are mapped to timestamps through the index. Host numpy,
as in JAX: the serial dynamic threshold calls scipy's ``fmin`` (imported
where it is called), so it is bitwise JAX's. ``find_anomalies_batch`` runs
the chain for the cells of a detection grid at once, bitwise equal per cell
to JAX's batch, with one shared timestamp index or one index per cell; its
dynamic thresholds come from one batched numpy replica of that Nelder-Mead
per window length (JAX's ``_find_thresholds_batch``), answered first by
the native C++ engine (``data/native.py``), bitwise the replica, as JAX's
is. Both take JAX's
parameters in JAX's order, ``lower_threshold`` included (each window also
scans its mirror about its mean).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# thresholds
# ---------------------------------------------------------------------------

def fixed_threshold(errors, k=4):
    return errors.mean() + k * errors.std()


def _deltas(errors, epsilon, mean, std):
    below = errors[errors <= epsilon]
    if not len(below):
        return 0, 0
    return mean - below.mean(), std - below.std()


def _count_above(errors, epsilon):
    above = errors > epsilon
    total_above = int(above.sum())
    # runs: positions where above turns on
    change = np.diff(np.concatenate([[False], above]).astype(int)) == 1
    return total_above, int(change.sum())


def z_cost(z, errors, mean, std):
    epsilon = mean + z * std
    delta_mean, delta_std = _deltas(errors, epsilon, mean, std)
    above, consecutive = _count_above(errors, epsilon)
    numerator = -(delta_mean / mean + delta_std / std)
    denominator = above + consecutive**2
    if denominator == 0:
        return np.inf
    return numerator / denominator


def find_threshold(errors, z_range=(0, 10)):
    """The dynamic threshold mean + z std of one window: scipy's ``fmin``
    of :func:`z_cost` from every integer z start in ``z_range``."""
    from scipy.optimize import fmin

    mean = errors.mean()
    std = errors.std()
    min_z, max_z = z_range
    best_z = min_z
    best_cost = np.inf
    for z in range(min_z, max_z):
        best = fmin(z_cost, z, args=(errors, mean, std), full_output=True,
                    disp=False)
        z_opt, cost = best[0:2]
        if cost < best_cost:
            best_z = z_opt[0]
            # NOTE: the reference never updates best_cost (bug preserved:
            # utils/anomaly_detection_utils.py:1089-1093 keeps the LAST z
            # whose cost beats inf, i.e. effectively the last finite one).
    return mean + best_z * std


def compute_scores(pruned, errors, threshold, window_start):
    denominator = errors.mean() + errors.std()
    out = []
    for start, stop, max_error in pruned:
        score = (max_error - threshold) / denominator
        out.append([start + window_start, stop + window_start, score])
    return out


# ---------------------------------------------------------------------------
# sequences
# ---------------------------------------------------------------------------

def find_sequences(errors, epsilon, anomaly_padding):
    above = errors > epsilon
    idx = np.flatnonzero(above)
    # pad each above-threshold point by +-anomaly_padding: union of ranges
    # via a difference array + running sum — O(n + k) instead of the
    # reference's O(k * padding) per-point slice assigns (:1117-1166)
    n = len(above)
    delta = np.zeros(n + 1, dtype=np.int64)
    np.add.at(delta, np.maximum(idx - anomaly_padding, 0), 1)
    np.add.at(delta, np.minimum(idx + anomaly_padding + 1, n), -1)
    padded = np.cumsum(delta[:-1]) > 0
    if padded.all():
        max_below = 0.0
    else:
        max_below = float(errors[~padded].max())
    change = np.diff(np.concatenate([[False], padded]).astype(int))
    starts = np.flatnonzero(change == 1)
    ends = np.flatnonzero(change == -1) - 1
    if len(ends) == len(starts) - 1:
        ends = np.append(ends, len(padded) - 1)
    return np.array([starts, ends]).T, max_below


def get_max_errors(errors, sequences, max_below):
    rows = [(-1, -1, float(max_below))]
    for start, stop in sequences:
        rows.append((int(start), int(stop),
                     float(errors[start: stop + 1].max())))
    rows.sort(key=lambda r: -r[2])
    return rows  # list of (start, stop, max_error), descending by max_error


def prune_anomalies(max_errors, min_percent):
    """max_errors: descending (start, stop, max_error) incl. the sentinel
    non-anomalous row. Reference _prune_anomalies (:1203-1237).

    Pure-Python over the handful of runs a threshold window yields. The
    reference's NaN/zero-div semantics are preserved exactly: 0/0 -> nan ->
    ``nan < min_percent`` is False (run kept as boundary), x/0 -> signed
    inf."""
    n = len(max_errors)
    if n < 2:
        return []
    last_index = -1
    for i in range(n - 2, -1, -1):
        me = max_errors[i][2]
        diff = me - max_errors[i + 1][2]
        if me == 0.0:
            # numpy scalar division reproduces the reference's inf/nan
            # (incl. the -0.0 sign convention) in this rare branch
            with np.errstate(invalid="ignore", divide="ignore"):
                increase = np.float64(diff) / np.float64(me)
        else:
            increase = diff / me
        if not increase < min_percent:
            last_index = i
            break
    return max_errors[: last_index + 1]


def _weighted_average(score, weights):
    """np.average(score, weights=weights). Two elements reduce without any
    associativity choice, so the plain Python form is bitwise-identical
    there (the most common merge chain); longer chains go through numpy,
    whose SIMD/pairwise reduction order already diverges from a sequential
    sum at n=3."""
    if len(score) == 2:
        return ((score[0] * weights[0] + score[1] * weights[1])
                / float(weights[0] + weights[1]))
    return np.average(score, weights=weights)


def merge_sequences(sequences):
    # Intermediate chain averages are overwritten by the next overlapping
    # extension and never escape, so each chain's weighted average is
    # computed ONCE when the chain closes — same outputs as the reference's
    # per-step recomputation (:1272-1313) at O(k) instead of O(k^2).
    if len(sequences) == 0:
        return np.array([])
    s = sorted(sequences, key=lambda e: e[0])
    merged = [s[0]]
    score = [s[0][2]]
    weights = [s[0][1] - s[0][0]]

    def close_chain():
        if len(score) > 1:
            prev = merged[-1]
            merged[-1] = (prev[0], prev[1],
                          _weighted_average(score, weights))

    for seq in s[1:]:
        prev = merged[-1]
        if seq[0] <= prev[1] + 1:
            score.append(seq[2])
            weights.append(seq[1] - seq[0])
            merged[-1] = (prev[0], max(prev[1], seq[1]), None)
        else:
            close_chain()
            score = [seq[2]]
            weights = [seq[1] - seq[0]]
            merged.append(seq)
    close_chain()
    return np.array(merged)


def _run_tail(window, seqs, max_below, threshold, denominator, min_percent,
              window_start):
    """Run-level tail (rank -> prune -> score) of one threshold window.
    ``denominator`` = window.mean() + window.std().

    A window with no above-threshold runs yields only the sentinel row,
    which prune_anomalies always drops (len < 2) — returning [] straight
    away is bitwise-identical and skips the tail for the common case."""
    if len(seqs) == 0:
        return []
    max_errors = get_max_errors(window, seqs, max_below)
    pruned = prune_anomalies(max_errors, min_percent)
    return [[start + window_start, stop + window_start,
             (max_error - threshold) / denominator]
            for start, stop, max_error in pruned]


def _threshold(window, z_range, use_fixed_threshold):
    return (fixed_threshold(window) if use_fixed_threshold
            else find_threshold(window, z_range))


def _window_sequences(window, threshold, anomaly_padding, min_percent,
                      window_start):
    seqs, max_below = find_sequences(window, threshold, anomaly_padding)
    return _run_tail(window, seqs, max_below, threshold,
                     window.mean() + window.std(), min_percent, window_start)


def _window_geometry(n, window_size, window_size_portion, window_step_size,
                     window_step_size_portion):
    """Resolved (window_size, window_step_size) — the exact reference
    resolution order (:1444-1452)."""
    window_size = window_size or n
    if window_size_portion:
        window_size = int(np.ceil(n * window_size_portion))
    window_step_size = window_step_size or window_size
    if window_step_size_portion:
        window_step_size = int(np.ceil(window_size * window_step_size_portion))
    return window_size, window_step_size


def _window_starts(n, window_size, window_step_size):
    """The serial schedule's window starts; the last window may run past
    the series and is then truncated."""
    starts, start, end = [], 0, 0
    while end < n:
        end = start + window_size
        starts.append(start)
        start += window_step_size
    return starts


def _intervals(errors, index, starts, window_size, min_percent,
               anomaly_padding, lower_threshold, threshold):
    """The windows' runs, merged and mapped to timestamps.
    ``threshold(start, window, mirrored)`` gives each window's threshold;
    under ``lower_threshold`` each window's mirror ``mean - (window -
    mean)`` is scanned after it."""
    sequences = []
    for start in starts:
        window = errors[start:start + window_size]
        scans = [(window, False)]
        if lower_threshold:
            mean = window.mean()
            scans.append((mean - (window - mean), True))
        for w, mirrored in scans:
            sequences.extend(_window_sequences(
                w, threshold(start, w, mirrored), anomaly_padding,
                min_percent, start))
    merged = merge_sequences(sequences)
    anomalies = [[index[int(start)], index[int(stop)], score]
                 for start, stop, score in merged]
    return np.asarray(anomalies)


def find_anomalies(errors, index, z_range=(0, 10), window_size=None,
                   window_size_portion=None, window_step_size=None,
                   window_step_size_portion=None, min_percent=0.1,
                   anomaly_padding=50, lower_threshold=False,
                   fixed_threshold=None):
    """Reference find_anomalies (:1363-1472): sliding threshold windows,
    sequence merge, position -> timestamp mapping. The parameters are
    ``hypad_tpu.detect.intervals``'s, in its order: a true
    ``fixed_threshold`` takes mean + 4 sigma, None or False the dynamic
    threshold searched over ``z_range``. ``lower_threshold``: each window
    also scans its mirror ``mean - (window - mean)`` under its own
    threshold."""
    errors = np.asarray(errors, dtype=np.float64)
    window_size, window_step_size = _window_geometry(
        len(errors), window_size, window_size_portion, window_step_size,
        window_step_size_portion)
    return _intervals(
        errors, index, _window_starts(len(errors), window_size,
                                      window_step_size),
        window_size, min_percent, anomaly_padding, lower_threshold,
        lambda start, window, mirrored: _threshold(window, z_range,
                                                   fixed_threshold))


# ---------------------------------------------------------------------------
# batched dynamic thresholds: all (window, z-start) fmin problems at once —
# a vectorized replica of scipy.optimize.fmin's Nelder-Mead for the 1-D
# z_cost minimization (reference :1023-1095), with O(log L) cost
# evaluations from per-window sorted prefix tables
# ---------------------------------------------------------------------------

class _WindowTables:
    """Per-window preprocessing that turns every z_cost evaluation into a
    few binary searches instead of an O(L) pass:

      * ``sorted_e`` + prefix sums of values/squares -> below-threshold
        count/mean/std at searchsorted position;
      * interval-stabbing pair arrays: a run STARTS at i iff
        e_{i-1} <= eps < e_i (boundary: e_0 > eps), so the run count is
        #(a_sorted <= eps) - #(b_sorted <= eps) over kept pairs a < b —
        each a plain searchsorted.

    Numerical note: below-subset mean/std come from prefix sums over the
    SORTED window rather than numpy's pairwise reduction over the original
    subset — values agree to ~1e-16 relative, NOT bitwise; the serial
    ``find_threshold`` stays the bitwise oracle."""

    def __init__(self, W):
        W = np.ascontiguousarray(W, np.float64)
        self.mean = W.mean(axis=1)
        self.std = W.std(axis=1)
        self.first = W[:, 0]
        s = np.sort(W, axis=1)                      # NaN sort to the end
        self.n_valid = (~np.isnan(W)).sum(axis=1)
        clean = np.where(np.isnan(s), 0.0, s)
        Wn, L = W.shape
        self.pre_sum = np.zeros((Wn, L + 1))
        np.cumsum(clean, axis=1, out=self.pre_sum[:, 1:])
        self.pre_sumsq = np.zeros((Wn, L + 1))
        np.cumsum(clean * clean, axis=1, out=self.pre_sumsq[:, 1:])
        a, b = W[:, :-1], W[:, 1:]
        keep = a < b                                 # NaN pairs drop out
        pad = np.full((Wn, 1), np.inf)
        # the three searched tables stacked into ONE row-sorted matrix so a
        # z_cost evaluation is a single 3P-problem binary search
        self.tables = np.concatenate([
            s,
            np.concatenate([np.sort(np.where(keep, a, np.inf), axis=1),
                            pad], axis=1),
            np.concatenate([np.sort(np.where(keep, b, np.inf), axis=1),
                            pad], axis=1),
        ])
        self.Wn = Wn

    def z_cost(self, z, rows):
        """Vectorized reference z_cost (:1023-1062) for P problems: ``z``
        (P,) candidate z values, ``rows`` (P,) table-row indices."""
        mean, std = self.mean[rows], self.std[rows]
        P, Wn = len(rows), self.Wn
        with np.errstate(invalid="ignore", divide="ignore",
                         over="ignore"):
            eps = mean + z * std
            rows3 = np.concatenate([rows, rows + Wn, rows + 2 * Wn])
            pos3 = _vsearch_right(self.tables, rows3, np.tile(eps, 3))
            pos, ra, rb = pos3[:P], pos3[P:2 * P], pos3[2 * P:]
            cnt = pos.astype(np.float64)
            mean_b = self.pre_sum[rows, pos] / cnt
            var_b = self.pre_sumsq[rows, pos] / cnt - mean_b * mean_b
            std_b = np.sqrt(np.maximum(var_b, 0.0))
            has_below = pos > 0
            delta_mean = np.where(has_below, mean - mean_b, 0.0)
            delta_std = np.where(has_below, std - std_b, 0.0)
            above = self.n_valid[rows] - pos
            runs = ra - rb + (self.first[rows] > eps)
            numerator = -(delta_mean / mean + delta_std / std)
            denominator = above + runs * runs
            return np.where(denominator == 0, np.inf,
                            numerator / denominator)


def _vsearch_right(mat, rows, vals):
    """Per-row ``searchsorted(mat[rows[p]], vals[p], side='right')`` —
    a fixed-depth vectorized binary search (rows index a (Wn, L) matrix of
    row-sorted values; NaN/inf tails compare correctly)."""
    L = mat.shape[1]
    n = len(rows)
    lo = np.zeros(n, np.int64)
    hi = np.full(n, L, np.int64)
    flat = mat.ravel()
    base = rows * L
    for _ in range(int(np.ceil(np.log2(max(L, 2)))) + 1):
        open_ = lo < hi
        mid = (lo + hi) >> 1
        le = flat[base + np.minimum(mid, L - 1)] <= vals
        go = open_ & le
        lo = np.where(go, mid + 1, lo)
        hi = np.where(open_ & ~le, mid, hi)
    return lo


_NM_XATOL = 1e-4
_NM_FATOL = 1e-4
_NM_MAXITER = 200    # scipy fmin defaults for N=1: N * 200
_NM_MAXFUN = 200


def _fmin_z_batch(x0, tab, rows):
    """P simultaneous 1-D Nelder-Mead minimizations of z_cost — the exact
    scipy ``fmin`` algorithm (rho=1 chi=2 psi=0.5 sigma=0.5, 5% initial
    step / 0.00025 at zero, xatol=fatol=1e-4, maxiter=maxfun=200) run in
    lockstep across problems with masked branch updates. For N=1 scipy's
    ``fxr < fsim[-2]`` reflection-accept branch is unreachable
    (fsim[-2] IS fsim[0]), leaving expand/contract/shrink.

    Returns (x, fval) per problem — scipy's ``sim[0]`` and ``min(fsim)``.
    """
    sim0 = np.asarray(x0, np.float64).copy()
    sim1 = np.where(sim0 != 0.0, 1.05 * sim0, 0.00025)
    f0 = tab.z_cost(sim0, rows)
    f1 = tab.z_cost(sim1, rows)
    fcalls = np.full(len(sim0), 2, np.int64)

    def sort2():
        nonlocal sim0, sim1, f0, f1
        # np.argsort on 2 elements: swap iff f1 < f0, or f0 is NaN while
        # f1 is not (NaN sorts last)
        swap = (f1 < f0) | (np.isnan(f0) & ~np.isnan(f1))
        sim0, sim1 = (np.where(swap, sim1, sim0),
                      np.where(swap, sim0, sim1))
        f0, f1 = np.where(swap, f1, f0), np.where(swap, f0, f1)

    sort2()
    active = np.ones(len(sim0), bool)
    for _ in range(1, _NM_MAXITER):          # iterations start at 1
        with np.errstate(invalid="ignore"):
            conv = (np.abs(sim1 - sim0) <= _NM_XATOL) \
                & (np.abs(f0 - f1) <= _NM_FATOL)
        active &= ~conv & (fcalls < _NM_MAXFUN)
        act = np.flatnonzero(active)
        if not len(act):
            break
        s0, s1, g0, g1 = sim0[act], sim1[act], f0[act], f1[act]
        r = rows[act]
        xr = 2.0 * s0 - s1
        fxr = tab.z_cost(xr, r)
        calls = np.full(len(act), 2, np.int64)   # xr + exactly one more
        ns1, nf1 = s1.copy(), g1.copy()
        with np.errstate(invalid="ignore"):
            case1 = fxr < g0
        i1 = np.flatnonzero(case1)
        if len(i1):
            xe = 3.0 * s0[i1] - 2.0 * s1[i1]
            fxe = tab.z_cost(xe, r[i1])
            use_e = fxe < fxr[i1]
            ns1[i1] = np.where(use_e, xe, xr[i1])
            nf1[i1] = np.where(use_e, fxe, fxr[i1])
        rest = ~case1
        with np.errstate(invalid="ignore"):
            outside = rest & (fxr < g1)
        i3 = np.flatnonzero(outside)
        shrink = np.zeros(len(act), bool)
        if len(i3):
            xc = 1.5 * s0[i3] - 0.5 * s1[i3]
            fxc = tab.z_cost(xc, r[i3])
            ok = fxc <= fxr[i3]
            ns1[i3] = np.where(ok, xc, ns1[i3])
            nf1[i3] = np.where(ok, fxc, nf1[i3])
            shrink[i3] = ~ok
        i4 = np.flatnonzero(rest & ~outside)
        if len(i4):
            xcc = 0.5 * s0[i4] + 0.5 * s1[i4]
            fxcc = tab.z_cost(xcc, r[i4])
            ok = fxcc < g1[i4]
            ns1[i4] = np.where(ok, xcc, ns1[i4])
            nf1[i4] = np.where(ok, fxcc, nf1[i4])
            shrink[i4] = ~ok
        ish = np.flatnonzero(shrink)
        if len(ish):
            xs = s0[ish] + 0.5 * (ns1[ish] - s0[ish])
            ns1[ish] = xs
            nf1[ish] = tab.z_cost(xs, r[ish])
            calls[ish] += 1
        sim1[act], f1[act] = ns1, nf1
        fcalls[act] += calls
        sort2()
    with np.errstate(invalid="ignore"):
        fval = np.where(np.isnan(f0) | np.isnan(f1), np.nan,
                        np.minimum(f0, f1))
    return sim0, fval


def _find_thresholds_batch(windows, z_range=(0, 10), engine="auto"):
    """Dynamic thresholds for a stack of equal-length windows (Wn, L):
    the reference ``find_threshold`` semantics — fmin from every integer
    z start, keeping the LAST start whose minimized cost is finite (the
    preserved best_cost bug, see find_threshold above; falls back to
    ``mean + min_z * std`` when no start is finite) — for all windows and
    starts in one batched Nelder-Mead.

    ``engine``: "auto" (JAX's behaviour) asks the native engine first
    (``data/native.py``, given numpy's window means and stds) and runs the
    numpy replica where it is not built; "native" raises where it is not;
    "numpy" runs the replica. Both give the same bits.
    ``_find_thresholds_batch.engines`` counts which one answered."""
    if engine not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine != "numpy":
        from hypad_tpu_torch.data import native

        W = np.ascontiguousarray(windows, np.float64)
        out = native.find_thresholds(W, W.mean(axis=1), W.std(axis=1),
                                     z_range[0], z_range[1])
        if out is not None:
            _THRESHOLD_ENGINES["native"] += 1
            return out
        if engine == "native":
            raise RuntimeError("native threshold engine unavailable: "
                               f"{native.build_error}")
    _THRESHOLD_ENGINES["numpy"] += 1
    tab = _WindowTables(windows)
    Wn = windows.shape[0]
    min_z, max_z = z_range
    starts = np.arange(min_z, max_z)
    S = len(starts)
    rows = np.repeat(np.arange(Wn), S)
    x0 = np.tile(starts.astype(np.float64), Wn)
    xs, costs = _fmin_z_batch(x0, tab, rows)
    xs = xs.reshape(Wn, S)
    finite = (costs < np.inf).reshape(Wn, S)
    any_f = finite.any(axis=1)
    last = S - 1 - np.argmax(finite[:, ::-1], axis=1)
    best_z = np.where(any_f, xs[np.arange(Wn), last], float(min_z))
    return tab.mean + best_z * tab.std


_THRESHOLD_ENGINES = {"native": 0, "numpy": 0}
_find_thresholds_batch.engines = _THRESHOLD_ENGINES


def _batch_thresholds(E, starts, window_size, lower_threshold):
    """{(window start, mirrored): (C,) dynamic thresholds} of the (C, T)
    score matrix, as JAX's batch computes them: one batched Nelder-Mead
    per distinct window length (the full windows and at most one truncated
    tail), over the windows stacked position-major."""
    C, T = E.shape
    by_len = {}
    for s in starts:
        by_len.setdefault(min(s + window_size, T) - s, []).append(s)
    out = {}
    for L, group in by_len.items():
        stack = np.concatenate([E[:, s:s + L] for s in group])
        stacks = [(stack, False)]
        if lower_threshold:
            mu = stack.mean(axis=1, keepdims=True)
            stacks.append((mu - (stack - mu), True))
        for st, mirrored in stacks:
            thr = _find_thresholds_batch(st).reshape(len(group), C)
            out.update(((s, mirrored), thr[g]) for g, s in enumerate(group))
    return out


def find_anomalies_batch(errors, index_list, window_size=None,
                         window_size_portion=None, window_step_size=None,
                         window_step_size_portion=None, min_percent=0.1,
                         anomaly_padding=50, lower_threshold=False,
                         fixed_threshold=None):
    """:func:`find_anomalies` over each row of ``errors`` (C, T), the cells
    of one grid sharing the score length; JAX's signature and default
    (``fixed_threshold`` None: dynamic thresholds). ``index_list`` is one
    timestamp index shared by every cell, or a length-C list or tuple of
    per-cell indexes (array-likes); a plain list of scalar timestamps is
    one shared index, as JAX tells them apart. The dynamic thresholds of
    every (cell, window) come from the batched Nelder-Mead
    (:func:`_find_thresholds_batch`), the rest of the chain runs cell by
    cell. Returns a list of C interval arrays."""
    E = np.ascontiguousarray(np.asarray(errors, dtype=np.float64))
    if E.ndim != 2:
        raise ValueError(f"errors must be (C, T), got shape {E.shape}")
    C, T = E.shape
    shared = not (isinstance(index_list, (list, tuple))
                  and len(index_list) == C
                  and all(np.ndim(e) >= 1 for e in index_list))
    window_size, window_step_size = _window_geometry(
        T, window_size, window_size_portion, window_step_size,
        window_step_size_portion)
    starts = _window_starts(T, window_size, window_step_size)
    dynamic = None if fixed_threshold else _batch_thresholds(
        E, starts, window_size, lower_threshold)

    def threshold_of(c):
        if dynamic is None:
            return lambda start, window, mirrored: _threshold(window, None,
                                                              True)
        return lambda start, window, mirrored: dynamic[start, mirrored][c]

    return [_intervals(row, index_list if shared else index_list[c], starts,
                       window_size, min_percent, anomaly_padding,
                       lower_threshold, threshold_of(c))
            for c, row in enumerate(E)]
