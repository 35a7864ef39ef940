"""Port parity: the hyperbolic one-call detector (hypad_tpu_torch.detect,
hypad_tpu_torch.ops.rolling, hypad_tpu_torch.data.pipeline) against the JAX
package, on the CPU."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.data import pipeline as jpipe
from hypad_tpu.detect import intervals as jiv
from hypad_tpu.detect import metrics as jmt
from hypad_tpu.detect import scorer as js
from hypad_tpu.detect.detector import _UNIVARIATE_FA_KW
from hypad_tpu.models.tadgan import init_tadgan as jax_init_tadgan
from hypad_tpu.ops.kde import kde_argmax_rows as jax_kde
from hypad_tpu.ops.rolling import rolling_mean_centered as jax_rolling
from hypad_tpu_torch.bridge import from_jax_params
from hypad_tpu_torch.data import pipeline as tpipe
from hypad_tpu_torch.detect import scorer as ts
from hypad_tpu_torch.detect.detector import detect_univariate
from hypad_tpu_torch.ops.kde_kernel import kde_argmax_rows_fused
from hypad_tpu_torch.ops.rolling import rolling_mean_centered, zscore

SCORE_TOL = dict(rtol=1e-4, atol=1e-6)


def _params(signal_shape, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_init_tadgan(jax.random.PRNGKey(seed), signal_shape,
                                    hyperbolic=True))


@pytest.mark.parametrize("n,window", [(300, 3), (300, 4), (80, 1),
                                      (2131, 21)])
def test_rolling_mean_centered_matches_jax(n, window):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    x[5] = np.nan
    mp = max(window // 2, 1)
    got = rolling_mean_centered(torch.from_numpy(x), window, mp).numpy()
    want = np.asarray(jax_rolling(jnp.asarray(x), window, mp))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_zscore_is_population():
    x = np.random.default_rng(0).standard_normal(50)
    got = zscore(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, (x - x.mean()) / x.std(), rtol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1000, 20099, 2**24 + 1])
def test_quartiles_match_jnp_quantile(n):
    """The IQR's quartiles from one sort, bitwise jnp.quantile's, also above
    2^24 elements where torch.quantile raises (there n rounds to 2^24 in
    f32, as in jnp.quantile). The large vector comes sorted, which both
    sorts take faster; the small ones do not."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    if n > 2**24:
        x = np.sort(x)
    got = ts.quartiles(torch.from_numpy(x)).numpy()
    want = jnp.quantile(jnp.asarray(x),
                        jnp.asarray([0.25, 0.75], jnp.float32))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_quartiles_are_nan_with_a_nan():
    x = np.random.default_rng(0).standard_normal(11).astype(np.float32)
    x[4] = np.nan
    assert np.isnan(ts.quartiles(torch.from_numpy(x)).numpy()).all()
    assert np.isnan(np.asarray(jnp.quantile(jnp.asarray(x), 0.25)))


@pytest.mark.parametrize("N,W", [(300, 32), (90, 100)])
def test_critic_scores_core_matches_jax(N, W):
    critic = np.random.default_rng(N).standard_normal(N).astype(np.float32)
    smooth = max(math.trunc(N * 0.01), 1)
    got = ts._critic_scores_core(torch.from_numpy(critic), W, smooth)
    want = js._critic_scores_core(jnp.asarray(critic), W, smooth, False,
                                  None)
    # cumulative sums in another order: the scores' tolerance
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


@pytest.fixture(scope="module")
def detect_case():
    """N = 300 windows of width 32 through both packages, one weight set."""
    params = _params(32)
    model = from_jax_params(params, device="cpu")
    X = np.random.default_rng(7).uniform(-1, 1, (300, 32)).astype(np.float32)
    _, jinf = js.detect_scores(params, X, True, "mult")
    _, tinf = ts.detect_scores(model, X, True, "mult", device="cpu")
    return params, model, X, jinf, tinf


def test_detect_inference_outputs_match_jax(detect_case):
    _, _, X, jinf, tinf = detect_case
    for name in ("recons_signal", "true_signal", "critic_score",
                 "eucl_recons"):
        np.testing.assert_allclose(getattr(tinf, name),
                                   np.asarray(getattr(jinf, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tinf.gt_signal, X)


def test_hyperbolic_window_scores_matches_jax(detect_case):
    _, _, _, jinf, _ = detect_case
    recons, true = (np.asarray(jinf.recons_signal),
                    np.asarray(jinf.true_signal))
    got = ts.hyperbolic_window_scores(recons, true, device="cpu")
    want = js.hyperbolic_window_scores(recons, true)
    assert got.shape == (300,)
    # the acosh test's f32 tolerance (tests/test_torch_manifold.py)
    np.testing.assert_allclose(got, want, rtol=2e-5)


@functools.partial(jax.jit, static_argnums=0)
def _jax_after_kde(combination, recons, true, critic):
    """JAX's scoring tail as one program, as detect_scores compiles it (the
    compiler's constant folding makes the jitted acosh more accurate than
    the op-by-op one)."""
    critic_scores = js._critic_scores_core(critic, 32, 3, False, None)
    return js._combine_device(combination, critic_scores[:300],
                              js.st.acosh_poincare_distance(recons, true),
                              recons)


@pytest.mark.parametrize("combination", ts.COMBINATIONS)
def test_detect_scores_matches_jax(detect_case, combination):
    params, model, X, jinf, tinf = detect_case
    want, _ = js.detect_scores(params, X, True, combination,
                               fetch_inference=False)
    got, none = ts.detect_scores(model, X, True, combination,
                                 fetch_inference=False, device="cpu")
    assert none is None and got.shape == want.shape == (300,)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))

    # the KDE stage alone, at tie level
    critic = np.asarray(jinf.critic_score)
    vals, mask = ts._critic_antidiag(torch.from_numpy(critic), 300, 32)
    jax_kde_max = np.asarray(jax_kde(jnp.asarray(vals.numpy()),
                                     jnp.asarray(mask.numpy())))
    port_kde_max = kde_argmax_rows_fused(vals, mask).numpy()
    flips = np.nonzero(port_kde_max != jax_kde_max)[0]
    v, m = vals.numpy(), mask.numpy()
    assert all(port_kde_max[i] in v[i][m[i]] for i in flips)
    assert len(flips) <= 3

    # the stages after the KDE, fed JAX's kde_max, hold in every case
    tensors = [torch.from_numpy(np.asarray(t)) for t in
               (jinf.recons_signal, jinf.true_signal)]
    rec = ts.st.acosh_poincare_distance(*tensors)
    critic_scores = ts._critic_scores_from_kde(
        torch.from_numpy(jax_kde_max), 3)[:300]
    after_kde = ts._combine_device(combination, critic_scores, rec,
                                   tensors[0]).numpy()
    want_after = _jax_after_kde(combination, jinf.recons_signal,
                                jinf.true_signal, critic)
    np.testing.assert_allclose(after_kde, np.asarray(want_after),
                               **SCORE_TOL)
    if len(flips) == 0 or combination not in ts.CRITIC_COMBOS:
        np.testing.assert_allclose(got, want, **SCORE_TOL)


def test_pipeline_copy_matches_jax():
    ts_, values, flags = tpipe.synthetic_signal(1200, seed=3)
    starts, ends = tpipe.extract_known_anomalies(flags, ts_)
    want = jpipe.extract_known_anomalies(flags, ts_)
    np.testing.assert_array_equal(starts, want["start"].values)
    np.testing.assert_array_equal(ends, want["end"].values)
    assert len(starts) == 3
    values = values.copy()
    values[100:103] = np.nan
    X, index = tpipe.prepare_univariate(values, ts_, 1, window_size=50)
    agg, jindex = jpipe.time_segments_aggregate(values, ts_, 1)
    jX, _, _, _ = jpipe.rolling_windows(
        jpipe.minmax_scale(jpipe.impute_mean(agg)), jindex, window_size=50)
    np.testing.assert_array_equal(X, jX.astype(np.float32))
    np.testing.assert_array_equal(index, jindex)


def test_detect_univariate_matches_jax_end_to_end():
    """Synthetic signal with injected anomalies: the port's detector gives
    the intervals and F1 of JAX detect_scores -> find_anomalies ->
    metrics."""
    stamps, values, flags = tpipe.synthetic_signal(1500, anomaly_len=40,
                                                   seed=11)
    X, index = tpipe.prepare_univariate(values, stamps, 1, window_size=32)
    known = np.stack(tpipe.extract_known_anomalies(flags, stamps), axis=1)
    params = _params(32, seed=5)
    model = from_jax_params(params, device="cpu")

    scores, _ = js.detect_scores(params, X, True, "mult",
                                 fetch_inference=False)
    want_iv = jiv.find_anomalies(scores.reshape(-1), index,
                                 **_UNIVARIATE_FA_KW)
    want_conf = jmt.contextual_confusion_matrix(known, want_iv)
    got = detect_univariate(model, X, index, known, "mult", device="cpu")

    assert len(want_iv) > 0
    np.testing.assert_array_equal(got["intervals"][:, :2], want_iv[:, :2])
    np.testing.assert_allclose(got["intervals"][:, 2], want_iv[:, 2],
                               rtol=1e-3)
    assert tuple(got["confusion"]) == tuple(want_conf)
    want_f1 = jmt.metrics_from_confusion(want_conf, verbose=False)["f1"]
    assert got["metrics"]["f1"] == want_f1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_anomalies_matches_jax(seed):
    """The intervals copy against JAX's serial find_anomalies, on score
    series with injected bumps and exact-zero runs."""
    from hypad_tpu_torch.detect import intervals as tiv

    rng = np.random.default_rng(seed)
    errors = np.abs(rng.standard_normal(3000))
    for start in rng.choice(2800, 4, replace=False):
        errors[start:start + 30] += 6.0
    errors[100:400] = 0.0
    index = 1000.0 + 60.0 * np.arange(3000)
    want = jiv.find_anomalies(errors, index, **_UNIVARIATE_FA_KW)
    got = tiv.find_anomalies(errors, index, **_UNIVARIATE_FA_KW)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    # fixed_threshold left at None: the dynamic threshold, bitwise JAX's
    np.testing.assert_array_equal(
        tiv.find_anomalies(errors, index, window_size_portion=0.33),
        jiv.find_anomalies(errors, index, window_size_portion=0.33))


def _interval_series(seed, n=3000, dips=False):
    """Scores with injected bumps (and, with ``dips``, injected dips, which
    only the lower threshold's mirrored windows see) and an exact-zero
    run."""
    rng = np.random.default_rng(seed)
    errors = np.abs(rng.standard_normal(n)) + 10.0
    for start in rng.choice(n - 200, 3, replace=False):
        errors[start:start + 30] += 6.0
    if dips:
        for start in rng.choice(n - 200, 3, replace=False):
            errors[start:start + 20] -= 9.0
    errors[100:160] = 0.0
    return errors


def _same_intervals(got, want):
    """Equal start, stop and score, as float64 arrays of one shape."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.size:
        assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lower", [False, True])
def test_find_anomalies_takes_jax_positional_call(lower):
    """JAX's parameter order: ``find_anomalies(e, idx, (0, 10), None, 0.33,
    None, 0.1, fixed_threshold=True)`` puts (0, 10) in z_range and 0.33 in
    window_size_portion, in the port as in JAX; the same with
    ``lower_threshold`` as the tenth positional argument."""
    from hypad_tpu_torch.detect import intervals as tiv

    errors = _interval_series(4, dips=True)
    index = 1000.0 + 60.0 * np.arange(len(errors))
    args = (errors, index, (0, 10), None, 0.33, None, 0.1, 0.1, 50, lower)
    want = jiv.find_anomalies(*args, fixed_threshold=True)
    got = tiv.find_anomalies(*args, fixed_threshold=True)
    assert len(want) > 0
    _same_intervals(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_find_anomalies_lower_threshold_matches_jax(seed):
    """``lower_threshold=True`` scans each window's mirror about its mean as
    well: the dips become intervals, equal to JAX's, serial and batch."""
    from hypad_tpu_torch.detect import intervals as tiv

    errors = _interval_series(seed, dips=True)
    index = 1000.0 + 60.0 * np.arange(len(errors))
    kw = dict(_UNIVARIATE_FA_KW, lower_threshold=True)
    want = jiv.find_anomalies(errors, index, **kw)
    got = tiv.find_anomalies(errors, index, **kw)
    assert len(want) > len(jiv.find_anomalies(errors, index,
                                              **_UNIVARIATE_FA_KW))
    _same_intervals(got, want)
    E = np.stack([errors, _interval_series(seed + 10, dips=True)])
    for g, w in zip(tiv.find_anomalies_batch(E, index, **kw),
                    jiv.find_anomalies_batch(E, index, **kw)):
        _same_intervals(g, w)


def test_find_anomalies_batch_takes_per_cell_indexes():
    """A (2, 600) error matrix with one index per cell (a length-C list of
    arrays): each cell's intervals on its own timestamps, equal to JAX's
    and to the serial call with that cell's index."""
    from hypad_tpu_torch.detect import intervals as tiv

    E = np.stack([_interval_series(5, 600), _interval_series(6, 600)])
    indexes = [1e9 + 60.0 * np.arange(699), 5e8 + 300.0 * np.arange(699)]
    got = tiv.find_anomalies_batch(E, indexes, **_UNIVARIATE_FA_KW)
    want = jiv.find_anomalies_batch(E, indexes, **_UNIVARIATE_FA_KW)
    assert len(got) == 2 and all(len(w) for w in want)
    for c in range(2):
        _same_intervals(got[c], want[c])
        _same_intervals(got[c], tiv.find_anomalies(E[c], indexes[c],
                                                   **_UNIVARIATE_FA_KW))
    assert got[0][0, 0] != got[1][0, 0] or got[0][0, 0] >= 1e9


def test_find_anomalies_batch_scalar_list_is_one_shared_index():
    """A plain list of scalar timestamps is one index shared by every cell,
    as JAX reads it; a falsy ``fixed_threshold`` takes the dynamic
    threshold, serial and batch, bitwise JAX's."""
    from hypad_tpu_torch.detect import intervals as tiv

    E = np.stack([_interval_series(7, 600), _interval_series(8, 600)])
    index = [float(t) for t in 100.0 + 7.0 * np.arange(699)]
    got = tiv.find_anomalies_batch(E, index, **_UNIVARIATE_FA_KW)
    want = jiv.find_anomalies_batch(E, index, **_UNIVARIATE_FA_KW)
    assert any(len(w) for w in want)
    for g, w in zip(got, want):
        _same_intervals(g, w)
    got = tiv.find_anomalies_batch(E, index, fixed_threshold=None)
    want = jiv.find_anomalies_batch(E, index, fixed_threshold=None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tiv.find_anomalies(E[0], index, (0, 10), fixed_threshold=False),
        jiv.find_anomalies(E[0], index, (0, 10), fixed_threshold=False))


@pytest.mark.parametrize("observed", [
    [(5, 20), (40, 41), (90, 120)],
    [(0, 3)],
    [],
    np.array([[10.0, 12.0, 0.5], [60.0, 75.0, 1.5]]),
])
def test_confusion_and_metrics_match_jax(observed):
    from hypad_tpu_torch.detect import metrics as tmt

    expected = [(8, 15), (50, 70), (100, 101)]
    got = tmt.contextual_confusion_matrix(expected, observed)
    want = jmt.contextual_confusion_matrix(expected, observed)
    assert tuple(got) == tuple(want)
    def metrics(module):
        try:
            return module.compute_metrics(expected, observed, verbose=False)
        except ZeroDivisionError:  # no true positive: F1 is undefined
            return "undefined"

    assert metrics(tmt) == metrics(jmt)
