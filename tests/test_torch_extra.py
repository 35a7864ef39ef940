"""Port parity: hypad_tpu_torch.detect.extra against the JAX package's
auxiliary detector utilities, on JAX's fixtures (tests/test_hyrnn_extra.py),
bitwise; ``ewma`` also against pandas' ``ewm`` as JAX's test holds it."""

import numpy as np
import pandas as pd
import pytest
import torch

from hypad_tpu.detect import extra as jex
from hypad_tpu_torch.detect import extra as tex


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("span", [1, 5, 20, 63])
def test_ewma_matches_jax_and_pandas(span):
    x = np.random.default_rng(0).standard_normal(200)
    got = tex.ewma(x, span)
    np.testing.assert_array_equal(got, jex.ewma(x, span))
    np.testing.assert_allclose(got, pd.Series(x).ewm(span=span).mean().values,
                               rtol=1e-10)


@pytest.mark.parametrize("smooth,window", [(True, 0.01), (True, 0.1),
                                           (False, 0.01)])
def test_regression_errors_matches_jax(smooth, window):
    rng = np.random.default_rng(1)
    y = rng.standard_normal((300, 1))
    y_hat = y + 0.1 * rng.standard_normal((300, 1))
    got = tex.regression_errors(y, y_hat, smoothing_window=window,
                                smooth=smooth)
    np.testing.assert_array_equal(
        got, jex.regression_errors(y, y_hat, smoothing_window=window,
                                   smooth=smooth))
    flat = tex.regression_errors(y[:, 0], y_hat[:, 0], smooth=smooth)
    np.testing.assert_array_equal(
        flat, jex.regression_errors(y[:, 0], y_hat[:, 0], smooth=smooth))


@pytest.mark.parametrize("n,seed", [(150, 3), (90, 4), (31, 5)])
def test_detect_anomaly_matches_jax(n, seed):
    """The std-of-a-scalar quirk kept: every point off its window's mean
    is flagged, the last windows' flags overwrite the earlier ones'."""
    scores = np.abs(np.random.default_rng(seed).standard_normal(n))
    scores[10:20] = 0.7
    got = tex.detect_anomaly(scores.copy())
    np.testing.assert_array_equal(got, jex.detect_anomaly(scores.copy()))


@pytest.mark.parametrize("n,seed,threshold", [(120, 2, 0.2), (200, 6, 0.05),
                                              (60, 7, 0.5)])
def test_prune_false_positive_matches_jax(n, seed, threshold):
    """Random flags with runs touching the last sample, ties between run
    maxima (the reference's bookkeeping marks every run of a tied max),
    and a single run."""
    rng = np.random.default_rng(seed)
    scores = np.abs(rng.standard_normal(n))
    is_anom = (rng.random(n) < 0.3).astype(int)
    is_anom[0] = 0
    is_anom[-3:] = 1
    scores[5] = scores[n // 2] = scores.max() + 1.0
    is_anom[5] = is_anom[n // 2] = 1
    got = tex.prune_false_positive(is_anom.copy(), scores.copy(), threshold)
    want = jex.prune_false_positive(is_anom.copy(), scores.copy(), threshold)
    np.testing.assert_array_equal(got, want)
    one = np.zeros(n, int)
    one[10:15] = 1
    np.testing.assert_array_equal(
        tex.prune_false_positive(one, scores, threshold),
        jex.prune_false_positive(one, scores, threshold))
