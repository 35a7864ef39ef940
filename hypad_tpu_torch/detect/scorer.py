"""One-call hyperbolic univariate detector: forward pass and scoring.

Port of the hyperbolic univariate subset of ``hypad_tpu.detect.scorer``:
``detect_scores`` runs the encoder, critic_x and decoder forwards, the
MobiusLinear embedding of the input windows, the per-window acosh Poincare
distance, the critic pipeline (anti-diagonal skew, KDE argmax, IQR mean,
population std, centred rolling mean) and the score combination, all on
one device. On the card the two MobiusLinear applications and the KDE argmax
go through the hand-written kernels (``manifold/kernels.py``,
``ops/kde_kernel.py``); on the CPU through their plain versions.

Not ported yet: the Euclidean path (rec errors, DTW), the chunked fallback
above the one-call window limit, grid, fleet and multivariate detection.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.manifold import stereographic as st
from hypad_tpu_torch.ops.kde_kernel import kde_argmax_rows_fused
from hypad_tpu_torch.ops.rolling import rolling_mean_centered
from hypad_tpu_torch.ops.unroll import antidiagonal_gather

CRITIC_COMBOS = ("mult", "uncertainty", "sum", "sum_uncertainty", "critic",
                 "critic_uncertainty")
COMBINATIONS = CRITIC_COMBOS + ("rec", "rec_uncertainty")


class InferenceOutput(NamedTuple):
    recons_signal: np.ndarray   # (N, W) reconstruction (ball coords if hyper)
    true_signal: np.ndarray     # (N, W) input windows, or hyper_real if hyper
    critic_score: np.ndarray    # (N,) critic values
    eucl_recons: Optional[np.ndarray] = None  # (N, W) tanh output (hyper only)
    gt_signal: Optional[np.ndarray] = None    # raw input windows (hyper only)


# ---------------------------------------------------------------------------
# critic-score pipeline
# ---------------------------------------------------------------------------

def _critic_antidiag(critic, n_windows, width):
    """(N,) critic values -> (T, width) anti-diagonal matrix + mask, entry
    (i, j) = critic[i - j]: each window's critic value repeated across the
    window, then skewed."""
    return antidiagonal_gather(critic[:, None].expand(n_windows, width))


def _critic_scores_from_kde(kde_max, smooth_window):
    """IQR mean, population std, |z| + 1, centred rolling mean."""
    lq = torch.quantile(kde_max, 0.25)
    uq = torch.quantile(kde_max, 0.75)
    in_range = (kde_max >= lq) & (kde_max <= uq)
    mean = torch.sum(torch.where(in_range, kde_max, 0.0)) / torch.sum(in_range)
    std = kde_max.std(correction=0)
    z = torch.abs((kde_max - mean) / std) + 1.0
    return rolling_mean_centered(z, smooth_window, max(smooth_window // 2, 1))


def _critic_scores_core(critic, width, smooth_window):
    """(N,) critic values -> (T,) smoothed critic scores, T = N + width - 1."""
    vals, mask = _critic_antidiag(critic, critic.shape[0], width)
    return _critic_scores_from_kde(kde_argmax_rows_fused(vals, mask),
                                   smooth_window)


# ---------------------------------------------------------------------------
# combination and the hyperbolic scoring tail
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


def _hyper_scores_core(recons, true, critic, combination, width,
                       smooth_window):
    """Per-window acosh distances, critic smoothing (truncated to N
    windows), combination."""
    rec_scores = st.acosh_poincare_distance(recons, true)
    critic_scores = None
    if combination in CRITIC_COMBOS:
        critic_scores = _critic_scores_core(critic, width, smooth_window)
        critic_scores = critic_scores[: rec_scores.shape[0]]
    return _combine_device(combination, critic_scores, rec_scores, recons)


def hyperbolic_window_scores(recons_signal, true_signal, device="cuda"):
    """Per-window acosh Poincare distance. (N, W) arrays -> (N,) numpy."""
    device = resolve_device(device)
    with torch.inference_mode():
        d = st.acosh_poincare_distance(
            torch.as_tensor(np.asarray(recons_signal, np.float32),
                            device=device),
            torch.as_tensor(np.asarray(true_signal, np.float32),
                            device=device))
    return d.cpu().numpy()


# ---------------------------------------------------------------------------
# one-call detection
# ---------------------------------------------------------------------------

def _detect_core(model, X, combination, width, smooth_window):
    """Forward pass and hyperbolic scoring of the (N, W) windows X."""
    z = model["encoder"](X)
    critic = model["critic_x"](X)[:, 0]
    hyper, eucl = model["decoder"](z)
    hyper_x = model["decoder"].hyperbolic_linear(X)
    scores = _hyper_scores_core(hyper, hyper_x, critic, combination, width,
                                smooth_window)
    return scores, (hyper, hyper_x, critic, eucl)


def detect_scores(params, X, hyperbolic, combination, fetch_inference=True,
                  device="cuda"):
    """The whole detection compute on ``device``: returns (final scores
    (N,) numpy, InferenceOutput of numpy arrays or None).

    ``params`` is the port's module dict (``models.tadgan.init_tadgan`` or
    ``bridge.from_jax_params``) and must already lie on ``device``. ``X``:
    (N, W) windows, numpy or a tensor. The critic smoothing window is
    ``max(trunc(N * 0.01), 1)``. ``fetch_inference=False`` returns
    (scores, None) and copies only the scores to the host."""
    if not hyperbolic:
        raise NotImplementedError(
            "the Euclidean detector (rec errors, DTW) is not ported yet")
    if combination not in COMBINATIONS:
        raise ValueError(f"unknown combination {combination!r}")
    device = resolve_device(device)
    params_device = next(params.parameters()).device
    if params_device != device:
        raise ValueError(f"params lie on {params_device}, not on {device}")
    X_host = None if torch.is_tensor(X) else np.asarray(X, np.float32)
    Xt = (X.to(device=device, dtype=torch.float32) if torch.is_tensor(X)
          else torch.as_tensor(X_host, device=device))
    Xt = Xt.contiguous()
    n, w = Xt.shape
    smooth_window = max(math.trunc(n * 0.01), 1)
    with torch.inference_mode():
        scores, outs = _detect_core(params, Xt, combination, w,
                                    smooth_window)
        scores = scores.cpu().numpy()
        if not fetch_inference:
            return scores, None
        hyper, hyper_x, critic, eucl = (t.cpu().numpy() for t in outs)
    if X_host is None:
        X_host = Xt.cpu().numpy()
    return scores, InferenceOutput(recons_signal=hyper, true_signal=hyper_x,
                                   critic_score=critic, eucl_recons=eucl,
                                   gt_signal=X_host)
