"""The detector's forward pass and scoring: univariate (hyperbolic and
Euclidean) and multivariate.

Port of ``hypad_tpu.detect.scorer``.
``detect_scores`` runs the encoder, critic_x and decoder forwards and the
whole scoring pipeline on one device:

* the critic pipeline, shared by both geometries: anti-diagonal skew, KDE
  argmax (K2, or K3 with ``kde_version="v2"``), IQR mean, population std,
  centred rolling mean;
* hyperbolic: the MobiusLinear embedding of the input windows and the
  per-window acosh Poincare distance, combined in any of 8 ways;
* Euclidean (TadGAN): the reconstruction error of the unrolled series,
  ``point``, ``area`` or ``dtw``, smoothed and z-scored, combined by
  ``mult``, ``sum``, ``rec`` or ``critic``;
* multivariate (``multivariate=True``, rows are timesteps' feature vectors
  (N, F)): each row's acosh distance (hyperbolic) or L2 error (Euclidean),
  z-scored, clipped at 0, plus 1, then the critic scores truncated to N
  rows and any of the 8 combinations, in either geometry.

On the card the MobiusLinear applications and the KDE argmax go through the
hand-written kernels (``manifold/kernels.py``, ``ops/kde_kernel.py``); on
the CPU through their plain versions. Above ``ONE_CALL_MAX_WINDOWS`` the
forward runs in chunks (``run_inference``) and the staged
``score_anomalies_*`` (``score_anomalies_multivariate`` for multivariate
rows) score its host arrays.

``detect_scores_grid`` scores every (rec_error x combination) cell from one
forward pass and one critic KDE launch. ``stage_inference`` puts a cached
artifact set on the device once, for the staged scorers to take as it is.

``detect_scores_fleet`` detects a whole signal family at once (the
counterpart of JAX's vmapped fleet program): one batched forward of the
padded (S, N, W) stack, each signal's real anti-diagonal rows through ONE
KDE launch, and the scoring tails with every reduction over each signal's
real prefix (the ragged ops of ``ops/rolling.py`` and ``ops/unroll.py``);
with ``multivariate=True`` a family of (N_i, F) streams, each row scored
per timestep. ``detect_scores_fleet_grid`` is the two at once: every
(rec_error x combination) cell of every signal from that one forward and
one KDE launch.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.manifold import stereographic as st
from hypad_tpu_torch.ops.dtw import dtw_errors
from hypad_tpu_torch.ops.kde_kernel import kde_argmax_rows_fused
from hypad_tpu_torch.models import fleet as mf
from hypad_tpu_torch.ops.rolling import (
    masked_quantile,
    rolling_mean_centered,
    rolling_mean_centered_ragged,
    rolling_trapz_centered,
    rolling_trapz_centered_ragged,
    zscore,
    zscore_masked,
)
from hypad_tpu_torch.ops.unroll import (
    antidiagonal_gather,
    antidiagonal_gather_ragged,
    true_series,
    true_series_ragged,
    unroll_median,
    unroll_median_ragged,
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
    """A float32 tensor of ``x`` (numpy or tensor) on ``device``; a float32
    contiguous tensor already there is returned as it is."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def kde_version_from_env():
    """The KDE kernel the JAX package's switch selects: ``HYPAD_KDE_PALLAS=1``
    (its hand-tiled v2 kernel) gives "v2" (K3), anything else "v1" (K2)."""
    return "v2" if os.environ.get("HYPAD_KDE_PALLAS") == "1" else "v1"


def stage_inference(inference: "InferenceOutput", device="cuda"):
    """``inference`` (a cached artifact set) with every field as a float32
    tensor on ``device``, copied there once: the staged
    ``score_anomalies_*`` then take its fields without another copy."""
    device = resolve_device(device)
    return InferenceOutput(*(None if t is None else _as_device(t, device)
                             for t in inference))


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
    """combine_scores, all 8 modes; a leading signal axis rides along."""
    if combination == "sum":
        return 0.2 * critic_scores + 0.8 * rec_scores
    if combination == "mult":
        return critic_scores * rec_scores
    if combination == "uncertainty":
        unc = torch.linalg.norm(recons, dim=-1)
        return critic_scores * rec_scores * unc
    if combination == "critic":
        return critic_scores
    if combination == "critic_uncertainty":
        return critic_scores * torch.linalg.norm(recons, dim=-1)
    if combination == "sum_uncertainty":
        unc = torch.linalg.norm(recons, dim=-1)
        n = rec_scores.shape[-1]
        return (0.5 * critic_scores * unc[..., :n]
                + 0.5 * rec_scores * unc[..., :n])
    if combination == "rec":
        return rec_scores
    if combination == "rec_uncertainty":
        return rec_scores * torch.linalg.norm(recons, dim=-1)
    raise ValueError(f"unknown combination {combination!r}")


def _check_combination(hyperbolic, combination):
    """``hyperbolic``: the path takes all 8 combinations (a hyperbolic or a
    multivariate one), else the Euclidean 4."""
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
    rec_scores = _eucl_rec_scores(y, y_hat, rec_error_type, smooth_window)
    critic_scores = None
    if comb != "rec":
        critic_scores = _critic_scores_core(critic, width, smooth_window,
                                            kde_version)
    return _eucl_combine(comb, critic_scores, rec_scores, lambda_rec)


def _eucl_rec_scores(y, y_hat, rec_error_type, smooth_window):
    """The smoothed reconstruction errors, z-scored, clipped at 0, plus 1."""
    errors, _ = _rec_errors_core(y, y_hat, rec_error_type, smooth_window)
    return zscore(errors).clamp_min(0.0) + 1.0


def _eucl_combine(comb, critic_scores, rec_scores, lambda_rec=0.5):
    """The Euclidean combination of the critic and rec scores (T,)."""
    if comb == "rec":
        return rec_scores
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


def _mv_rec_scores(recons, true, hyperbolic, n_real=None):
    """Per-row rec scores of multivariate rows (..., N, F): the acosh
    Poincare distance (hyperbolic) or the L2 norm of the error
    (Euclidean), z-scored (over each signal's first ``n_real`` rows when
    given), clipped at 0, plus 1."""
    if hyperbolic:
        raw = st.acosh_poincare_distance(recons, true)
    else:
        raw = torch.linalg.norm(true - recons, dim=-1)
    if n_real is None:
        z = zscore(raw)
    else:
        z = zscore_masked(raw, torch.arange(raw.shape[-1], device=raw.device)
                          [None, :] < n_real[:, None])
    return z.clamp_min(0.0) + 1.0


def _mv_scores_core(recons, true, critic, combination, hyperbolic, width,
                    smooth_window, kde_version="v1"):
    """The multivariate scores (N,) of (N, F) rows: per-row rec scores, the
    critic scores truncated to N rows (only for a combination that reads
    them), combined (hypad_tpu/detect/scorer.py:552-579)."""
    rec_scores = _mv_rec_scores(recons, true, hyperbolic)
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


def score_anomalies_multivariate(inference: InferenceOutput, combination,
                                 hyperbolic, kde_version="v1",
                                 device="cuda"):
    """The multivariate scores (N,) as numpy, from ``run_inference``'s
    output of (N, F) rows (host or device arrays)."""
    _check_combination(True, combination)
    n, w = np.shape(inference.true_signal)
    device = resolve_device(device)
    with torch.inference_mode():
        out = _mv_scores_core(
            _as_device(inference.recons_signal, device),
            _as_device(inference.true_signal, device),
            _as_device(inference.critic_score, device), combination,
            hyperbolic, w, max(math.trunc(n * 0.01), 1), kde_version)
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
                 smooth_window, kde_version="v1", multivariate=False):
    """Forward pass and scoring of the (N, W) windows, or (N, F) rows
    under ``multivariate``, X."""
    outs = _forward_chunk(model, X, hyperbolic)
    if hyperbolic:
        hyper, _, hyper_x, critic = outs
        if multivariate:
            scores = _mv_scores_core(hyper, hyper_x, critic, combination,
                                     True, width, smooth_window, kde_version)
        else:
            scores = _hyper_scores_core(hyper, hyper_x, critic, combination,
                                        width, smooth_window, kde_version)
        return scores, outs
    recon, critic = outs
    if multivariate:
        scores = _mv_scores_core(recon, X, critic, combination, False, width,
                                 smooth_window, kde_version)
    else:
        scores = _eucl_scores_core(X, recon, critic, rec_error, combination,
                                   width, smooth_window,
                                   kde_version=kde_version)
    return scores, outs


def _check_params_device(params, device):
    params_device = next(params.parameters()).device
    if params_device != device:
        raise ValueError(f"params lie on {params_device}, not on {device}")


def _apply_artifact_opts(inference, artifact_dtype, artifact_set,
                         hyperbolic):
    """The artifact options on a host ``InferenceOutput``: drop
    eucl_recons and gt_signal of a hyperbolic run under "minimal", cast the
    (N, W) arrays to float16 under "float16" (the critic stays float32)."""
    if hyperbolic and artifact_set == "minimal":
        inference = inference._replace(eucl_recons=None, gt_signal=None)
    if artifact_dtype == "float16":
        inference = InferenceOutput(*(
            t.astype(np.float16) if t is not None and np.ndim(t) > 1 else t
            for t in inference))
    return inference


def detect_scores(params, X, hyperbolic, combination, rec_error="point",
                  fetch_inference=True, kde_version="v1", device="cuda",
                  artifact_dtype="float32", artifact_set="full",
                  multivariate=False):
    """The whole detection compute on ``device``: returns (final scores as
    numpy, InferenceOutput of numpy arrays or None). The scores are (N,)
    hyperbolic and (N + W - 1,) Euclidean.

    ``params`` is the port's module dict (``models.tadgan.init_tadgan`` or
    ``bridge.from_jax_params``) and must already lie on ``device``. ``X``:
    (N, W) windows, numpy or a tensor. The smoothing window is
    ``max(trunc(N * 0.01), 1)``. ``rec_error`` (point, area, dtw) applies to
    the Euclidean scores only. ``kde_version`` picks the KDE kernel, "v1"
    (K2) or "v2" (K3). ``fetch_inference=False`` returns (scores, None) and
    copies only the scores to the host. ``artifact_dtype`` and
    ``artifact_set`` shape the returned inference as
    :func:`_apply_artifact_opts` says; the scores are computed in float32
    either way.

    Above ``ONE_CALL_MAX_WINDOWS`` windows the forward runs in chunks
    (:func:`run_inference`) and :func:`score_anomalies_hyperbolic` or
    :func:`score_anomalies_euclidean` scores its output.

    ``multivariate=True``: X holds (N, F) timestep rows and the scores are
    the per-row multivariate scores (N,) (:func:`_mv_scores_core`), in
    either geometry and for any of the 8 combinations; ``rec_error`` is
    not read. Above the one-call limit :func:`score_anomalies_multivariate`
    scores the chunked forward."""
    _check_combination(hyperbolic or multivariate, combination)
    if not (hyperbolic or multivariate) and rec_error not in REC_ERRORS:
        raise ValueError(f"unknown rec_error_type {rec_error!r}")
    device = resolve_device(device)
    _check_params_device(params, device)
    if len(X) > ONE_CALL_MAX_WINDOWS:
        inference = run_inference(params, X, hyperbolic, device=device)
        if multivariate:
            scores = score_anomalies_multivariate(inference, combination,
                                                  hyperbolic, kde_version,
                                                  device)
        elif hyperbolic:
            scores = score_anomalies_hyperbolic(inference, combination,
                                                kde_version, device)
        else:
            scores = score_anomalies_euclidean(
                inference.true_signal, inference.recons_signal,
                inference.critic_score, rec_error, combination,
                kde_version=kde_version, device=device)
        if not fetch_inference:
            return scores, None
        return scores, _apply_artifact_opts(inference, artifact_dtype,
                                            artifact_set, hyperbolic)
    X_host = None if torch.is_tensor(X) else np.asarray(X, np.float32)
    Xt = _as_device(X if X_host is None else X_host, device)
    n, w = Xt.shape
    with torch.inference_mode():
        scores, outs = _detect_core(params, Xt, hyperbolic, combination,
                                    rec_error, w, max(math.trunc(n * 0.01),
                                                      1), kde_version,
                                    multivariate)
        scores = scores.cpu().numpy()
        if not fetch_inference:
            return scores, None
        outs = [t.cpu().numpy() for t in outs]
    if X_host is None:
        X_host = Xt.cpu().numpy()
    if hyperbolic:
        hyper, eucl, hyper_x, critic = outs
        inference = InferenceOutput(recons_signal=hyper, true_signal=hyper_x,
                                    critic_score=critic, eucl_recons=eucl,
                                    gt_signal=X_host)
    else:
        recon, critic = outs
        inference = InferenceOutput(recons_signal=recon, true_signal=X_host,
                                    critic_score=critic)
    return scores, _apply_artifact_opts(inference, artifact_dtype,
                                        artifact_set, hyperbolic)


# ---------------------------------------------------------------------------
# grid detection: every (rec_error x combination) cell from one forward pass
# ---------------------------------------------------------------------------

def _validate_grid(hyperbolic, combinations, rec_errors, multivariate=False):
    """The cells deduplicated in order; an unknown combination for the
    path or an unknown rec_error raises."""
    combinations = tuple(dict.fromkeys(combinations))
    valid = COMBINATIONS if (hyperbolic or multivariate) else EUCL_COMBOS
    bad = [cb for cb in combinations if cb not in valid]
    if bad:
        raise ValueError(f"unknown combination(s) {bad} for this path; "
                         f"valid: {sorted(valid)}")
    rec_errors = tuple(dict.fromkeys(rec_errors))
    for re_ in rec_errors:
        if re_ not in REC_ERRORS:
            raise ValueError(f"unknown rec_error {re_!r}")
    return combinations, rec_errors


def _grid_core(model, X, hyperbolic, combinations, rec_errors, width,
               smooth_window, kde_version="v1", lambda_rec=0.5,
               multivariate=False):
    """One forward pass, one critic pipeline (one KDE launch, only if a
    combination reads it), one reconstruction error per rec_error, then
    every combination's tail, each the same operations as the single-cell
    scorer's. Returns {(rec_error or None, combination): (T,) tensor}."""
    outs = _forward_chunk(model, X, hyperbolic)
    critic_scores = None
    if any(cb in CRITIC_COMBOS for cb in combinations):
        critic_scores = _critic_scores_core(outs[-1], width, smooth_window,
                                            kde_version)
    if hyperbolic or multivariate:
        recons, other = (outs[0], outs[2]) if hyperbolic else (outs[0], X)
        rec_scores = (_mv_rec_scores(recons, other, hyperbolic)
                      if multivariate else
                      st.acosh_poincare_distance(recons, other))
        if critic_scores is not None:
            critic_scores = critic_scores[: rec_scores.shape[0]]
        return {(None, cb): _combine_device(cb, critic_scores, rec_scores,
                                            recons)
                for cb in combinations}
    out = {}
    for rec_error in rec_errors:
        rec_scores = _eucl_rec_scores(X, outs[0], rec_error, smooth_window)
        for cb in combinations:
            out[(rec_error, cb)] = _eucl_combine(cb, critic_scores,
                                                 rec_scores, lambda_rec)
    return out


def detect_scores_grid(params, X, hyperbolic, combinations,
                       rec_errors=("point",), kde_version="v1",
                       device="cuda", multivariate=False):
    """Every (rec_error x combination) detection cell of the (N, W) windows
    ``X`` (numpy or a tensor on ``device``) from one forward pass and one
    critic KDE launch: each rec_error's unroll and error are computed once,
    and only the combination tails fan out. Each cell equals
    :func:`detect_scores` for that cell.

    Returns ``{(rec_error or None, combination): numpy scores}``: the
    rec_error slot is None for hyperbolic and multivariate cells, whose rec
    scores take no rec_error. ``multivariate=True`` scores (N, F) timestep
    rows as :func:`detect_scores` does. Above ``ONE_CALL_MAX_WINDOWS`` the
    forward runs in chunks (:func:`run_inference`) and each cell is scored
    from its output."""
    combinations, rec_errors = _validate_grid(hyperbolic, combinations,
                                              rec_errors, multivariate)
    if (hyperbolic or multivariate) and len(rec_errors) > 1:
        warnings.warn(
            "rec_errors apply only to the euclidean univariate path; the "
            f"{'hyperbolic' if hyperbolic else 'multivariate'} grid keys "
            "cells by combination alone and the requested rec_error sweep "
            "collapses to one row per combination", stacklevel=2)
    device = resolve_device(device)
    _check_params_device(params, device)
    if len(X) > ONE_CALL_MAX_WINDOWS:
        inference = run_inference(params, X, hyperbolic, device=device)
        if multivariate:
            return {(None, cb): score_anomalies_multivariate(
                        inference, cb, hyperbolic, kde_version, device)
                    for cb in combinations}
        if hyperbolic:
            return {(None, cb): score_anomalies_hyperbolic(
                        inference, cb, kde_version, device)
                    for cb in combinations}
        return {(re_, cb): score_anomalies_euclidean(
                    inference.true_signal, inference.recons_signal,
                    inference.critic_score, re_, cb,
                    kde_version=kde_version, device=device)
                for cb in combinations for re_ in rec_errors}
    Xt = _as_device(X, device)
    n, w = Xt.shape
    with torch.inference_mode():
        out = _grid_core(params, Xt, hyperbolic, combinations, rec_errors, w,
                         max(math.trunc(n * 0.01), 1), kde_version,
                         multivariate=multivariate)
        return {cell: out[cell].cpu().numpy() for cell in _cell_order(out)}


def _cell_order(cells):
    """The cells in JAX's order: its grid programs return a dict keyed
    "comb" or "rec_error/comb", which the device fetch sorts."""
    return sorted(cells, key=lambda c: c[1] if c[0] is None
                  else f"{c[0]}/{c[1]}")


# ---------------------------------------------------------------------------
# fleet detection: a whole signal family at once
# ---------------------------------------------------------------------------

# The fleet's chunk plan. JAX bounds its fleet program by the (S, T, W, W)
# KDE pair tensor (FLEET_MAX_PAIR_ELEMS, sized for a v5e's 16 GB); the port's
# K2 / K3 never build it, and the plain KDE builds it 1,024 rows at a time,
# so the peak here is the forward's activations and the scoring's (T, W)
# stacks. Per window at the published widths (W = 100, latent 20, encoder
# LSTM 50, decoder LSTMs 64, critic 20), in f32 words: the encoder's gates
# and output 2 * 200 + 100 + 20, the decoder's 50 + 2 * 256 + 128 + 2 * 256
# + 128 + 100 + 100 + 100 (the ball head), the critic's 4 * 20 + 1, the
# embedded input 100, and the anti-diagonal values, mask and median sort
# 100 + 25 + 2 * 100: about 2,660 words, 10.6 KB; FLEET_BYTES_PER_WINDOW
# rounds it up to 16 KB for the temporaries between them. FLEET_MAX_BYTES
# keeps a call's peak at 16 GB, a fifth of an H100's 80 GB: about a
# million windows (9 NAB signals of up to 22,000 windows are 200,000), so
# a family is one call unless it is very large.
FLEET_BYTES_PER_WINDOW = 16 * 1024
FLEET_MAX_BYTES = 16 * 1024 ** 3

_SNAP_ULPS = 256.0


def fleet_chunk_plan(S, n_pad):
    """(chunks, S_c): ``chunks`` None for one call of all S signals, else
    the (start, size) slices of one fixed size S_c that cover S, the last
    slid back to end at S (its leading overlap dropped on reassembly)."""
    per_signal = max(n_pad, 1) * FLEET_BYTES_PER_WINDOW
    S_c = max(1, FLEET_MAX_BYTES // per_signal)
    if S_c >= S:
        return None, S
    return [(start, S_c) for start in range(0, S, S_c)], S_c


def _snap_scores(s, n_valid):
    """Zero the |scores| at or below 256 ulp of each row's largest |score|
    over its first ``n_valid`` entries (JAX's ``_snap_scores_device``, the
    canonical fleet's noise floor). s (S, L); n_valid (S,)."""
    a = torch.abs(s)
    valid = torch.arange(s.shape[1], device=s.device)[None, :] < \
        n_valid.reshape(-1, 1)
    m = torch.where(valid, a, 0.0).amax(dim=1, keepdim=True)
    floor = _SNAP_ULPS * torch.finfo(torch.float32).eps * m
    return torch.where(a <= floor, torch.zeros_like(s), s)


def _critic_scores_fleet(critic, n_real, n_host, width, smooth, kde_version):
    """(S, N) critic values -> (S, T) smoothed critic scores, each signal
    over its real prefix (scorer.py:145-227 of the JAX package with
    ``n_real``). Every signal's real anti-diagonal rows go to one KDE
    launch; the pad rows take no part."""
    S, N = critic.shape
    T = N + width - 1
    vals, mask = antidiagonal_gather_ragged(
        critic[:, :, None].expand(S, N, width), n_real)
    t_real = n_real + width - 1
    rows = torch.as_tensor(np.concatenate(
        [i * T + np.arange(int(n) + width - 1) for i, n in enumerate(n_host)
         if n > 0] or [np.zeros(0, np.int64)]), device=critic.device)
    kde = torch.zeros(S * T, dtype=critic.dtype, device=critic.device)
    if rows.numel():
        kde[rows] = kde_argmax_rows_fused(
            vals.reshape(S * T, width)[rows].contiguous(),
            mask.reshape(S * T, width)[rows].contiguous(), kde_version)
    kde = kde.reshape(S, T)
    rv = torch.arange(T, device=critic.device)[None, :] < t_real[:, None]
    lq = masked_quantile(kde, rv, 0.25)[:, None]
    uq = masked_quantile(kde, rv, 0.75)[:, None]
    in_range = rv & (kde >= lq) & (kde <= uq)
    mean = (torch.where(in_range, kde, 0.0).sum(dim=1, keepdim=True)
            / in_range.sum(dim=1, keepdim=True))
    cnt = rv.sum(dim=1, keepdim=True).to(kde.dtype)
    m_all = torch.where(rv, kde, 0.0).sum(dim=1, keepdim=True) / cnt
    std = torch.sqrt(torch.where(rv, (kde - m_all) ** 2, 0.0).sum(
        dim=1, keepdim=True) / cnt)
    z = torch.abs((kde - mean) / std) + 1.0
    return rolling_mean_centered_ragged(z, smooth, t_real,
                                        (smooth // 2).clamp_min(1))


def _rec_errors_fleet(y, y_hat, n_real, rec_error_type, smooth,
                      score_window=10):
    """(S, T) smoothed reconstruction errors of each signal's real windows
    (scorer.py:254-316 of the JAX package with ``n_real``), DTW's window
    boundary at each signal's real end."""
    width = y.shape[2]
    true = true_series_ragged(y, n_real)
    pred = unroll_median_ragged(y_hat, n_real)
    t_real = (n_real + width - 1)[:, None]
    t = torch.arange(true.shape[1], device=y.device)[None, :]
    half = score_window // 2
    if rec_error_type == "point":
        errors = torch.abs(true - pred)
    elif rec_error_type == "area":
        errors = torch.abs(
            rolling_trapz_centered_ragged(true, score_window, t_real, half)
            - rolling_trapz_centered_ragged(pred, score_window, t_real,
                                            half))
    elif rec_error_type == "dtw":
        # zero past the real end, so a boundary window sees the zero padding
        # the single-signal call sees, then zero what that call leaves zero
        rv = t < t_real
        errors = dtw_errors(torch.where(rv, true, 0.0),
                            torch.where(rv, pred, 0.0), score_window)
        length = 2 * half + 1
        live = (t >= half) & (t < t_real - length + half)
        errors = torch.where(live, errors, 0.0)
    else:
        raise ValueError(f"unknown rec_error_type {rec_error_type!r}")
    return rolling_mean_centered_ragged(errors, smooth, t_real[:, 0],
                                        (smooth // 2).clamp_min(1))


def _grid_core_fleet(P, Xs, n_real, n_host, hyperbolic, combinations,
                     rec_errors, width, smooth, kde_version,
                     multivariate=False):
    """The fleet's forward and every cell's scoring, as :func:`_grid_core`
    for one signal: one batched forward, one critic pipeline (one KDE
    launch over every signal's real rows, only if a combination reads it),
    one reconstruction error per rec_error, then the combination tails.
    Returns {(rec_error or None, combination): (S, N) hyperbolic or
    multivariate, (S, T) Euclidean scores}, pad positions unspecified. The
    outputs of pad windows are zeroed first, so no pad value (a NaN of a
    poisoned pad row, say) reaches a masked reduction."""
    S, N, _ = Xs.shape
    live = (torch.arange(N, device=Xs.device)[None, :]
            < n_real[:, None])[..., None]
    outs = [torch.where(live if t.dim() == 3 else live[..., 0], t, 0.0)
            for t in mf.forward_eval(P, Xs, hyperbolic)]
    critic_scores = None
    if any(cb in CRITIC_COMBOS for cb in combinations):
        critic_scores = _critic_scores_fleet(outs[-1], n_real, n_host, width,
                                             smooth, kde_version)
    if hyperbolic or multivariate:
        recons, other = ((outs[0], outs[2]) if hyperbolic
                         else (outs[0], torch.where(live, Xs, 0.0)))
        rec_scores = (_mv_rec_scores(recons, other, hyperbolic, n_real)
                      if multivariate else
                      st.acosh_poincare_distance(recons, other))
        if critic_scores is not None:
            critic_scores = critic_scores[:, :N]
        return {(None, cb): _combine_device(cb, critic_scores, rec_scores,
                                            recons)
                for cb in combinations}
    X = torch.where(live, Xs, 0.0)
    T = N + width - 1
    rv = torch.arange(T, device=Xs.device)[None, :] < (n_real + width - 1)[
        :, None]
    out = {}
    for rec_error in rec_errors:
        errors = _rec_errors_fleet(X, outs[0], n_real, rec_error, smooth)
        rec_scores = zscore_masked(errors, rv).clamp_min(0.0) + 1.0
        for cb in combinations:
            out[(rec_error, cb)] = _eucl_combine(cb, critic_scores,
                                                 rec_scores)
    return out


def _fleet_stage(X_list, staged, device):
    """The (S, N, W) float32 stack on ``device`` and the (S,) window
    counts: the staged stack of ``train_fleet(return_staged=True)`` cut to
    the S signals (checked against ``X_list``), or ``X_list`` padded and
    stacked on the host and copied over once."""
    from hypad_tpu_torch.train.fleet import pad_and_stack

    widths = {int(np.shape(x)[1]) for x in X_list}
    if len(widths) > 1:
        raise ValueError("fleet signals must share a window width; got "
                         f"{sorted(widths)}")
    n_real = np.asarray([len(x) for x in X_list], np.int64)
    if staged is not None:
        Xs, n_staged = staged
        S = len(X_list)
        if Xs.shape[0] < S or Xs.shape[1] < n_real.max():
            raise ValueError("staged stack does not cover the requested "
                             f"family: {tuple(Xs.shape)} vs {S} signals of "
                             f"up to {int(n_real.max())} windows")
        if not (np.asarray(n_staged)[:S] == n_real).all():
            raise ValueError("staged window counts disagree with X_list — "
                             "stale stack?")
        return _as_device(Xs[:S], device), n_real
    Xs, _ = pad_and_stack([x.detach().cpu().numpy() if torch.is_tensor(x)
                           else np.asarray(x, np.float32) for x in X_list])
    return torch.as_tensor(Xs, device=device), n_real


def detect_scores_fleet(stacked, X_list, hyperbolic, combination,
                        rec_error="point", staged=None, canonical=True,
                        kde_version=None, device="cuda", multivariate=False):
    """The scores of a whole signal family, each signal's as
    :func:`detect_scores` computes them alone: a list of S numpy vectors
    sliced to their true lengths (N_i hyperbolic or multivariate,
    N_i + W - 1 Euclidean).

    ``stacked``: the fleet's stacked parameters (``train.fleet``
    ``stack_models`` or a ``FleetState``'s ``params``) on ``device``.
    ``X_list``: S (N_i, W) window arrays. The family is padded to one
    (S, N, W) stack and scored at once: one batched forward (K1 with a
    signal axis for the ball head), ONE KDE launch over every signal's real
    anti-diagonal rows (``kde_version`` "v1" K2, "v2" K3; None follows
    ``HYPAD_KDE_PALLAS``), and each reduction over each signal's real
    prefix. ``staged``: ``train_fleet(return_staged=True)``'s device stack
    of the same windows, used instead of padding and copying again.
    ``canonical`` keeps JAX's one observable effect of its canonical
    shapes: scores within 256 ulp of zero (of each signal's largest) snap
    to exact zero. The port pads to no shape ladder, so the rest of JAX's
    canonical path has no counterpart.

    A family whose peak buffer passes ``FLEET_MAX_BYTES`` is scored in
    chunks of one fixed signal count (``fleet_chunk_plan``), each one KDE
    launch; the signals are independent, so chunks change no value.

    ``multivariate=True``: X_list holds S (N_i, F) timestep streams of one
    feature count F (a CASAS family, say), each scored per row with its
    rec scores z-scored over its own N_i rows; ``rec_error`` is not
    read.

    It is the one-cell case of :func:`detect_scores_fleet_grid`."""
    _check_combination(hyperbolic or multivariate, combination)
    eucl = not (hyperbolic or multivariate)
    if eucl and rec_error not in REC_ERRORS:
        raise ValueError(f"unknown rec_error_type {rec_error!r}")
    cells = _fleet_cells(stacked, X_list, hyperbolic, (combination,),
                         (rec_error,) if eucl else REC_ERRORS[:1], staged,
                         canonical, kde_version, device, multivariate)
    return [next(iter(c.values())) for c in cells]


def detect_scores_fleet_grid(stacked, X_list, hyperbolic, combinations,
                             rec_errors=("point",), staged=None,
                             canonical=True, multivariate=False, mesh=None,
                             kde_version=None, device="cuda"):
    """A whole signal family times the whole (rec_error x combination)
    grid at once: the composition of :func:`detect_scores_fleet` (the
    padded stack, one batched forward, the ragged reductions) and
    :func:`detect_scores_grid` (the shared stages computed once, only the
    combination tails fanning out). The critic pipeline does not depend on
    the cell, so every signal's real rows go to ONE KDE launch for every
    cell; each rec_error's unroll and error are computed once.

    Returns a list of S dicts ``{(rec_error or None, combination):
    scores}``, each signal's sliced to its true length (N_i hyperbolic or
    multivariate, N_i + W - 1 Euclidean), the cells in JAX's order;
    hyperbolic and multivariate cells are keyed by combination alone.
    ``staged``, ``canonical`` (the 256-ulp snap of each signal's scores),
    the ``FLEET_MAX_BYTES`` chunks, ``multivariate`` and ``kde_version``
    as :func:`detect_scores_fleet` takes them. ``mesh`` (a family over
    several cards) is not ported (ROADMAP A13)."""
    if mesh is not None:
        raise NotImplementedError("fleet detection over several cards (mesh)"
                                  " is not ported yet (ROADMAP A13)")
    combinations, rec_errors = _validate_grid(hyperbolic, combinations,
                                              rec_errors, multivariate)
    return _fleet_cells(stacked, X_list, hyperbolic, combinations,
                        rec_errors, staged, canonical, kde_version, device,
                        multivariate)


def _fleet_cells(stacked, X_list, hyperbolic, combinations, rec_errors,
                 staged, canonical, kde_version, device, multivariate):
    """The body of :func:`detect_scores_fleet_grid` on checked cells."""
    device = resolve_device(device)
    P = getattr(stacked, "params", stacked)
    ref = next(iter(P.values()))
    if ref.device != device:
        raise ValueError(f"params lie on {ref.device}, not on {device}")
    kde_version = kde_version or kde_version_from_env()
    Xs, n_host = _fleet_stage(X_list, staged, device)
    S, _, width = Xs.shape
    if ref.shape[0] < S:
        raise ValueError(f"{ref.shape[0]} stacked models for {S} signals")
    smooth_host = np.maximum(np.trunc(n_host * 0.01).astype(np.int64), 1)
    lens = n_host if (hyperbolic or multivariate) else n_host + width - 1

    def run(lo, size):
        sl = slice(lo, lo + size)
        n_real = torch.as_tensor(n_host[sl], device=device)
        with torch.inference_mode():
            out = _grid_core_fleet(
                {k: v[sl] for k, v in P.items()}, Xs[sl], n_real,
                n_host[sl], hyperbolic, combinations, rec_errors, width,
                torch.as_tensor(smooth_host[sl], device=device), kde_version,
                multivariate)
            if canonical:
                n_valid = torch.as_tensor(lens[sl], device=device)
                out = {c: _snap_scores(v, n_valid) for c, v in out.items()}
            return {c: v.cpu().numpy() for c, v in out.items()}

    chunks, _ = fleet_chunk_plan(S, Xs.shape[1])
    if chunks is None:
        out = run(0, S)
    else:
        out = {}
        for start, size in chunks:
            start_c = min(start, S - size)
            for c, sub in run(start_c, size).items():
                if c not in out:
                    out[c] = np.zeros((S,) + sub.shape[1:], sub.dtype)
                out[c][start:start_c + size] = sub[start - start_c:]
    order = _cell_order(out)
    return [{c: out[c][i, :int(L)] for c in order}
            for i, L in enumerate(lens)]
