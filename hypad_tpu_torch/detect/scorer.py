"""Univariate detector: forward pass and scoring, hyperbolic and Euclidean.

Port of the univariate subset of ``hypad_tpu.detect.scorer``.
``detect_scores`` runs the encoder, critic_x and decoder forwards and the
whole scoring pipeline on one device:

* the critic pipeline, shared by both geometries: anti-diagonal skew, KDE
  argmax (K2, or K3 with ``kde_version="v2"``), IQR mean, population std,
  centred rolling mean;
* hyperbolic: the MobiusLinear embedding of the input windows and the
  per-window acosh Poincare distance, combined in any of 8 ways;
* Euclidean (TadGAN): the reconstruction error of the unrolled series,
  ``point``, ``area`` or ``dtw``, smoothed and z-scored, combined by
  ``mult``, ``sum``, ``rec`` or ``critic``.

On the card the MobiusLinear applications and the KDE argmax go through the
hand-written kernels (``manifold/kernels.py``, ``ops/kde_kernel.py``); on
the CPU through their plain versions. Above ``ONE_CALL_MAX_WINDOWS`` the
forward runs in chunks (``run_inference``) and the staged
``score_anomalies_*`` score its host arrays.

Not ported yet: grid, fleet and multivariate detection, and the artifact
options of the JAX ``detect_scores``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.manifold import stereographic as st
from hypad_tpu_torch.ops.dtw import dtw_errors
from hypad_tpu_torch.ops.kde_kernel import kde_argmax_rows_fused
from hypad_tpu_torch.ops.rolling import (
    rolling_mean_centered,
    rolling_trapz_centered,
    zscore,
)
from hypad_tpu_torch.ops.unroll import (
    antidiagonal_gather,
    true_series,
    unroll_median,
)

CRITIC_COMBOS = ("mult", "uncertainty", "sum", "sum_uncertainty", "critic",
                 "critic_uncertainty")
COMBINATIONS = CRITIC_COMBOS + ("rec", "rec_uncertainty")
EUCL_COMBOS = ("mult", "sum", "rec", "critic")
REC_ERRORS = ("point", "area", "dtw")

# above this many windows detect_scores runs the chunked forward and the
# staged scorers instead of one batch (hypad_tpu/detect/scorer.py:640)
ONE_CALL_MAX_WINDOWS = 262144


class InferenceOutput(NamedTuple):
    recons_signal: np.ndarray   # (N, W) reconstruction (ball coords if hyper)
    true_signal: np.ndarray     # (N, W) input windows, or hyper_real if hyper
    critic_score: np.ndarray    # (N,) critic values
    eucl_recons: Optional[np.ndarray] = None  # (N, W) tanh output (hyper only)
    gt_signal: Optional[np.ndarray] = None    # raw input windows (hyper only)


def _as_device(x, device):
    """A float32 tensor of ``x`` (numpy or tensor) on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# ---------------------------------------------------------------------------
# model forward over the full test set
# ---------------------------------------------------------------------------

def _forward_chunk(model, x, hyperbolic):
    """Eval forward of the (B, W) windows ``x``: (hyper, eucl, hyper_x,
    critic) hyperbolic, (recon, critic) Euclidean."""
    if hyperbolic and not model["decoder"].hyperbolic:
        raise ValueError("hyperbolic scoring needs a model with the "
                         "MobiusLinear head (init_tadgan(hyperbolic=True))")
    z = model["encoder"](x)
    critic = model["critic_x"](x)[:, 0]
    decoded = model["decoder"](z)
    if hyperbolic:
        hyper, eucl = decoded
        return hyper, eucl, model["decoder"].hyperbolic_linear(x), critic
    # a model with the ball head decodes to (hyper, tanh output); JAX's
    # Euclidean forward takes the tanh output
    recon = decoded[1] if isinstance(decoded, tuple) else decoded
    return recon, critic


def run_inference(params, X, hyperbolic, batch_size=1024,
                  device="cuda") -> InferenceOutput:
    """Forward every window of ``X`` (N, W) in batches of ``batch_size``,
    each copied to the host as it finishes. Returns numpy arrays:
    hyperbolic (ball reconstruction, embedded input, critic, tanh output,
    raw input), Euclidean (reconstruction, raw input, critic)."""
    device = resolve_device(device)
    _check_params_device(params, device)
    X_host = (X.detach().cpu().float().numpy() if torch.is_tensor(X)
              else np.asarray(X, np.float32))
    outs = []
    with torch.inference_mode():
        for i in range(0, len(X_host), batch_size):
            chunk = torch.as_tensor(X_host[i:i + batch_size], device=device)
            outs.append([t.cpu().numpy() for t in
                         _forward_chunk(params, chunk, hyperbolic)])
    cols = [np.concatenate(col) for col in zip(*outs)]
    if hyperbolic:
        hyper, eucl, hyper_x, critic = cols
        return InferenceOutput(recons_signal=hyper, true_signal=hyper_x,
                               critic_score=critic, eucl_recons=eucl,
                               gt_signal=X_host)
    recon, critic = cols
    return InferenceOutput(recons_signal=recon, true_signal=X_host,
                           critic_score=critic)


# ---------------------------------------------------------------------------
# critic-score pipeline
# ---------------------------------------------------------------------------

def _critic_antidiag(critic, n_windows, width):
    """(N,) critic values -> (T, width) anti-diagonal matrix + mask, entry
    (i, j) = critic[i - j]: each window's critic value repeated across the
    window, then skewed."""
    return antidiagonal_gather(critic[:, None].expand(n_windows, width))


def quartiles(x):
    """(0.25, 0.75) quantiles of the 1-D ``x`` from one sort, interpolated
    linearly as ``jnp.quantile`` does: n taken in f32, pos = q * (n - 1)
    (within [0, n - 1], so no clamp is needed), floor and ceil, lo * (1 -
    frac) + hi * frac; NaN if any entry is NaN. Unlike ``torch.quantile``
    it takes more than 2^24 elements. The positions depend on n alone, so
    they are computed on the host in f32 and no copy to the device stalls
    the stream.

    XLA's CPU code contracts the last step into fma(hi, frac, lo * (1 -
    frac)). The f64 sum below computes that fma for f32 inputs (the f32
    product is exact in f64; the sum is rounded to f64, then to f32), and
    gave jnp.quantile's bits at every length from 1 to 2,999 tried."""
    s = torch.sort(x).values
    n = np.float32(x.shape[0])
    out = []
    for q in (np.float32(0.25), np.float32(0.75)):
        pos = q * (n - np.float32(1))
        lo, hi = np.floor(pos), np.ceil(pos)
        frac = pos - lo
        low = s[int(lo)] * float(np.float32(1) - frac)
        out.append((s[int(hi)].double() * float(frac) + low.double())
                   .to(x.dtype))
    # NaNs sort last, so the largest entry is NaN when any is
    return torch.where(torch.isnan(s[-1]), s[-1], torch.stack(out))


def _critic_scores_from_kde(kde_max, smooth_window):
    """IQR mean, population std, |z| + 1, centred rolling mean."""
    lq, uq = quartiles(kde_max)
    in_range = (kde_max >= lq) & (kde_max <= uq)
    mean = torch.sum(torch.where(in_range, kde_max, 0.0)) / torch.sum(in_range)
    std = kde_max.std(correction=0)
    z = torch.abs((kde_max - mean) / std) + 1.0
    return rolling_mean_centered(z, smooth_window, max(smooth_window // 2, 1))


def _critic_scores_core(critic, width, smooth_window, kde_version="v1"):
    """(N,) critic values -> (T,) smoothed critic scores, T = N + width - 1.
    ``kde_version`` picks the KDE kernel: "v1" K2, "v2" K3."""
    vals, mask = _critic_antidiag(critic, critic.shape[0], width)
    return _critic_scores_from_kde(
        kde_argmax_rows_fused(vals, mask, kde_version), smooth_window)


def final_critic_scores(critic_score, true_signal, kde_version="v1",
                        device="cuda"):
    """(T,) smoothed critic scores of the (N,) critic values of the (N, W)
    windows, T = N + W - 1, as numpy. The smoothing window is
    ``max(trunc(N * 0.01), 1)``."""
    n, w = np.shape(true_signal)
    device = resolve_device(device)
    with torch.inference_mode():
        out = _critic_scores_core(_as_device(critic_score, device), w,
                                  max(math.trunc(n * 0.01), 1), kde_version)
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# reconstruction errors (Euclidean path)
# ---------------------------------------------------------------------------

def _rec_errors_core(y, y_hat, rec_error_type, smoothing_window,
                     score_window=10, smooth=True):
    """(errors (T,), unrolled prediction (T,)) of the (N, W) windows ``y``
    and their reconstructions ``y_hat``: the pointwise, area (rolling
    trapezoid) or DTW difference of the two unrolled series, then a
    centred rolling mean."""
    true = true_series(y)
    pred = unroll_median(y_hat)
    if rec_error_type == "point":
        errors = torch.abs(true - pred)
    elif rec_error_type == "area":
        half = score_window // 2
        errors = torch.abs(rolling_trapz_centered(true, score_window, half)
                           - rolling_trapz_centered(pred, score_window, half))
    elif rec_error_type == "dtw":
        errors = dtw_errors(true, pred, score_window)
    else:
        raise ValueError(f"unknown rec_error_type {rec_error_type!r}")
    if smooth:
        errors = rolling_mean_centered(errors, smoothing_window,
                                       max(smoothing_window // 2, 1))
    return errors, pred


def reconstruction_errors(y, y_hat, rec_error_type="point", score_window=10,
                          smoothing_window=0.01, smooth=True, device="cuda"):
    """(errors (T,), predictions (T,)) as numpy, for (N, W) arrays y and
    y_hat. A float ``smoothing_window`` is a share of N, capped at 200
    windows; an int is taken as it is. A window of 0 is floored at 1."""
    if isinstance(smoothing_window, float):
        smoothing_window = min(math.trunc(len(y) * smoothing_window), 200)
    device = resolve_device(device)
    with torch.inference_mode():
        errors, pred = _rec_errors_core(
            _as_device(y, device), _as_device(y_hat, device), rec_error_type,
            max(smoothing_window, 1) if smooth else 1, score_window, smooth)
    return errors.cpu().numpy(), pred.cpu().numpy()


# ---------------------------------------------------------------------------
# combination
# ---------------------------------------------------------------------------

def _combine_device(combination, critic_scores, rec_scores, recons):
    """combine_scores, all 8 modes."""
    if combination == "sum":
        return 0.2 * critic_scores + 0.8 * rec_scores
    if combination == "mult":
        return critic_scores * rec_scores
    if combination == "uncertainty":
        unc = torch.linalg.norm(recons, dim=1)
        return critic_scores * rec_scores * unc
    if combination == "critic":
        return critic_scores
    if combination == "critic_uncertainty":
        return critic_scores * torch.linalg.norm(recons, dim=1)
    if combination == "sum_uncertainty":
        unc = torch.linalg.norm(recons, dim=1)
        n = rec_scores.shape[0]
        return 0.5 * critic_scores * unc[:n] + 0.5 * rec_scores * unc[:n]
    if combination == "rec":
        return rec_scores
    if combination == "rec_uncertainty":
        return rec_scores * torch.linalg.norm(recons, dim=1)
    raise ValueError(f"unknown combination {combination!r}")


def _check_combination(hyperbolic, combination):
    if hyperbolic and combination not in COMBINATIONS:
        raise ValueError(f"unknown combination {combination!r}")
    if not hyperbolic and combination not in EUCL_COMBOS:
        raise ValueError(f'Unknown combination specified {combination}, use '
                         f'"mult", "sum", or "rec"')


# ---------------------------------------------------------------------------
# the two scoring tails
# ---------------------------------------------------------------------------

def _eucl_scores_core(y, y_hat, critic, rec_error_type, comb, width,
                      smooth_window, lambda_rec=0.5, kde_version="v1"):
    """The Euclidean scores (T,): the critic pipeline and the smoothed
    reconstruction errors (z-scored, clipped at 0, plus 1), combined. The
    critic pipeline is skipped for ``rec``, which does not read it."""
    _check_combination(False, comb)
    errors, _ = _rec_errors_core(y, y_hat, rec_error_type, smooth_window)
    rec_scores = zscore(errors).clamp_min(0.0) + 1.0
    if comb == "rec":
        return rec_scores
    critic_scores = _critic_scores_core(critic, width, smooth_window,
                                        kde_version)
    if comb == "critic":
        return critic_scores
    if comb == "mult":
        return critic_scores * rec_scores
    return ((1 - lambda_rec) * (critic_scores - 1)
            + lambda_rec * (rec_scores - 1))


def _hyper_scores_core(recons, true, critic, combination, width,
                       smooth_window, kde_version="v1"):
    """Per-window acosh distances, critic smoothing (truncated to N
    windows), combination."""
    rec_scores = st.acosh_poincare_distance(recons, true)
    critic_scores = None
    if combination in CRITIC_COMBOS:
        critic_scores = _critic_scores_core(critic, width, smooth_window,
                                            kde_version)
        critic_scores = critic_scores[: rec_scores.shape[0]]
    return _combine_device(combination, critic_scores, rec_scores, recons)


def score_anomalies_euclidean(y, y_hat, critic, rec_error_type="point",
                              comb="mult", lambda_rec=0.5, kde_version="v1",
                              device="cuda"):
    """The Euclidean scores (T,) as numpy, from the (N, W) windows, their
    reconstructions and the (N,) critic values (host or device arrays).
    The smoothing window of both the errors and the critic is
    ``max(trunc(N * 0.01), 1)``, an int, so the 200 cap of
    ``reconstruction_errors`` does not apply."""
    n, w = np.shape(y)
    device = resolve_device(device)
    with torch.inference_mode():
        out = _eucl_scores_core(
            _as_device(y, device), _as_device(y_hat, device),
            _as_device(critic, device), rec_error_type, comb, w,
            max(math.trunc(n * 0.01), 1), lambda_rec, kde_version)
    return out.cpu().numpy()


def score_anomalies_hyperbolic(inference: InferenceOutput, combination,
                               kde_version="v1", device="cuda"):
    """The hyperbolic scores (N,) as numpy, from ``run_inference``'s
    output: per-window acosh distances and the critic scores truncated to N
    windows, combined."""
    _check_combination(True, combination)
    n, w = np.shape(inference.true_signal)
    device = resolve_device(device)
    with torch.inference_mode():
        out = _hyper_scores_core(
            _as_device(inference.recons_signal, device),
            _as_device(inference.true_signal, device),
            _as_device(inference.critic_score, device), combination, w,
            max(math.trunc(n * 0.01), 1), kde_version)
    return out.cpu().numpy()


def hyperbolic_window_scores(recons_signal, true_signal, device="cuda"):
    """Per-window acosh Poincare distance. (N, W) arrays -> (N,) numpy."""
    device = resolve_device(device)
    with torch.inference_mode():
        d = st.acosh_poincare_distance(_as_device(recons_signal, device),
                                       _as_device(true_signal, device))
    return d.cpu().numpy()


# ---------------------------------------------------------------------------
# one-call detection
# ---------------------------------------------------------------------------

def _detect_core(model, X, hyperbolic, combination, rec_error, width,
                 smooth_window, kde_version="v1"):
    """Forward pass and scoring of the (N, W) windows X."""
    outs = _forward_chunk(model, X, hyperbolic)
    if hyperbolic:
        hyper, _, hyper_x, critic = outs
        scores = _hyper_scores_core(hyper, hyper_x, critic, combination,
                                    width, smooth_window, kde_version)
        return scores, outs
    recon, critic = outs
    scores = _eucl_scores_core(X, recon, critic, rec_error, combination,
                               width, smooth_window, kde_version=kde_version)
    return scores, outs


def _check_params_device(params, device):
    params_device = next(params.parameters()).device
    if params_device != device:
        raise ValueError(f"params lie on {params_device}, not on {device}")


def detect_scores(params, X, hyperbolic, combination, rec_error="point",
                  fetch_inference=True, kde_version="v1", device="cuda"):
    """The whole detection compute on ``device``: returns (final scores as
    numpy, InferenceOutput of numpy arrays or None). The scores are (N,)
    hyperbolic and (N + W - 1,) Euclidean.

    ``params`` is the port's module dict (``models.tadgan.init_tadgan`` or
    ``bridge.from_jax_params``) and must already lie on ``device``. ``X``:
    (N, W) windows, numpy or a tensor. The smoothing window is
    ``max(trunc(N * 0.01), 1)``. ``rec_error`` (point, area, dtw) applies to
    the Euclidean scores only. ``kde_version`` picks the KDE kernel, "v1"
    (K2) or "v2" (K3). ``fetch_inference=False`` returns (scores, None) and
    copies only the scores to the host.

    Above ``ONE_CALL_MAX_WINDOWS`` windows the forward runs in chunks
    (:func:`run_inference`) and :func:`score_anomalies_hyperbolic` or
    :func:`score_anomalies_euclidean` scores its output."""
    _check_combination(hyperbolic, combination)
    if not hyperbolic and rec_error not in REC_ERRORS:
        raise ValueError(f"unknown rec_error_type {rec_error!r}")
    device = resolve_device(device)
    _check_params_device(params, device)
    if len(X) > ONE_CALL_MAX_WINDOWS:
        inference = run_inference(params, X, hyperbolic, device=device)
        if hyperbolic:
            scores = score_anomalies_hyperbolic(inference, combination,
                                                kde_version, device)
        else:
            scores = score_anomalies_euclidean(
                inference.true_signal, inference.recons_signal,
                inference.critic_score, rec_error, combination,
                kde_version=kde_version, device=device)
        return scores, (inference if fetch_inference else None)
    X_host = None if torch.is_tensor(X) else np.asarray(X, np.float32)
    Xt = _as_device(X if X_host is None else X_host, device)
    n, w = Xt.shape
    with torch.inference_mode():
        scores, outs = _detect_core(params, Xt, hyperbolic, combination,
                                    rec_error, w, max(math.trunc(n * 0.01),
                                                      1), kde_version)
        scores = scores.cpu().numpy()
        if not fetch_inference:
            return scores, None
        outs = [t.cpu().numpy() for t in outs]
    if X_host is None:
        X_host = Xt.cpu().numpy()
    if hyperbolic:
        hyper, eucl, hyper_x, critic = outs
        return scores, InferenceOutput(recons_signal=hyper,
                                       true_signal=hyper_x,
                                       critic_score=critic, eucl_recons=eucl,
                                       gt_signal=X_host)
    recon, critic = outs
    return scores, InferenceOutput(recons_signal=recon, true_signal=X_host,
                                   critic_score=critic)
