"""Port parity: the Euclidean (TadGAN) detector of hypad_tpu_torch against
the JAX package, on the CPU. DTW, the unrolled series and the rolling
trapezoid; reconstruction errors; the Euclidean scores for every rec_error
x combination under both KDE versions; the staged fallback above the
one-call limit, for both geometries; ``detect_univariate`` end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.detect import intervals as jiv
from hypad_tpu.detect import metrics as jmt
from hypad_tpu.detect import scorer as js
from hypad_tpu.detect.detector import _UNIVARIATE_FA_KW
from hypad_tpu.models.tadgan import init_tadgan as jax_init_tadgan
from hypad_tpu.ops import dtw as jdtw
from hypad_tpu.ops import rolling as jrolling
from hypad_tpu.ops import unroll as junroll
from hypad_tpu.ops.kde import kde_argmax_rows as jax_kde
from hypad_tpu.ops.kde_pallas import kde_argmax_rows_pallas
from hypad_tpu_torch.bridge import from_jax_params
from hypad_tpu_torch.data import pipeline as tpipe
from hypad_tpu_torch.detect import scorer as ts
from hypad_tpu_torch.detect.detector import detect_univariate
from hypad_tpu_torch.ops.dtw import dtw_errors, dtw_pair
from hypad_tpu_torch.ops.kde_kernel import kde_argmax_rows_fused
from hypad_tpu_torch.ops.rolling import rolling_trapz_centered
from hypad_tpu_torch.ops.unroll import true_series, unroll_median

# the scores' tolerance of tests/test_torch_detect.py: reductions and
# cumulative sums add in another order in the two packages
SCORE_TOL = dict(rtol=1e-4, atol=1e-6)
# the forward passes: the same products, summed in another order
FORWARD_TOL = dict(rtol=1e-5, atol=1e-6)
N, W = 300, 32


def _params(seed=0, hyperbolic=False, width=W):
    return jax.tree_util.tree_map(
        np.asarray, jax_init_tadgan(jax.random.PRNGKey(seed), width,
                                    hyperbolic=hyperbolic))


def _windows(seed=7):
    return np.random.default_rng(seed).uniform(-1, 1, (N, W)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,score_window", [(331, 10), (2000, 10),
                                            (200, 6)])
def test_dtw_errors_bitwise(T, score_window):
    """Subtract, square, add, min and sqrt, each correctly rounded in the
    same order: no ulp of difference (XLA contracts no multiply-add
    here)."""
    rng = np.random.default_rng(T)
    a, b = rng.standard_normal((2, T)).astype(np.float32)
    got = dtw_errors(torch.from_numpy(a), torch.from_numpy(b), score_window)
    want = jdtw.dtw_errors(jnp.asarray(a), jnp.asarray(b), score_window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length", [11, 17])
def test_dtw_pair_bitwise(length):
    rng = np.random.default_rng(length)
    x, y = rng.standard_normal((2, length)).astype(np.float32)
    got = dtw_pair(torch.from_numpy(x), torch.from_numpy(y))
    want = jdtw.dtw_pair(jnp.asarray(x), jnp.asarray(y))
    assert got.item() == float(want)


@pytest.mark.parametrize("n,w", [(N, W), (50, 100), (1, 8)])
def test_unroll_median_and_true_series_bitwise(n, w):
    y = np.random.default_rng(n).standard_normal((n, w)).astype(np.float32)
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    np.testing.assert_array_equal(unroll_median(yt).numpy(),
                                  np.asarray(junroll.unroll_median(yj)))
    np.testing.assert_array_equal(true_series(yt).numpy(),
                                  np.asarray(junroll.true_series(yj)))


@pytest.mark.parametrize("n,window,min_periods", [(331, 10, 5),
                                                  (100, 7, 3), (20, 10, None)])
def test_rolling_trapz_centered_matches_jax(n, window, min_periods):
    """Window sums are differences of cumulative sums, which the two
    packages add in different orders: each sum is off by up to a few ulps
    of the largest |cumsum| (about 20 here), hence atol 2e-5."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = rolling_trapz_centered(torch.from_numpy(x), window,
                                 min_periods).numpy()
    want = np.asarray(jrolling.rolling_trapz_centered(jnp.asarray(x), window,
                                                      min_periods))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the Euclidean scorer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eucl_case():
    """N = 300 windows of width 32 through both packages, one Euclidean
    weight set."""
    params = _params()
    model = from_jax_params(params, device="cpu")
    X = _windows()
    _, jinf = js.detect_scores(params, X, False, "mult")
    _, tinf = ts.detect_scores(model, X, False, "mult", device="cpu")
    return params, model, X, jinf, tinf


def test_eucl_inference_outputs_match_jax(eucl_case):
    _, _, X, jinf, tinf = eucl_case
    for name in ("recons_signal", "critic_score"):
        np.testing.assert_allclose(getattr(tinf, name),
                                   np.asarray(getattr(jinf, name)),
                                   **FORWARD_TOL, err_msg=name)
    np.testing.assert_array_equal(tinf.true_signal, X)
    assert tinf.eucl_recons is None and tinf.gt_signal is None


def _assert_scores_close(got, want, comb):
    """SCORE_TOL, relative to the scores' own scale. "sum" is (c - 1) / 2 +
    (r - 1) / 2 of critic and rec scores c, r >= 1: the exact - 1 leaves
    their error, relative to c and r, on a result near 0, so it is held
    as sum + 1 = (c + r) / 2."""
    shift = 1.0 if comb == "sum" else 0.0
    np.testing.assert_allclose(got + shift, want + shift, **SCORE_TOL)


def _jax_kde_max(critic, kde_version):
    vals, mask = ts._critic_antidiag(torch.from_numpy(critic), N, W)
    jv, jm = jnp.asarray(vals.numpy()), jnp.asarray(mask.numpy())
    want = (jax_kde(jv, jm) if kde_version == "v1" else
            kde_argmax_rows_pallas(jv, jm, interpret=True, version="v2"))
    return vals, mask, np.asarray(want)


@pytest.mark.parametrize("kde_version", ["v1", "v2"])
@pytest.mark.parametrize("rec_error", ts.REC_ERRORS)
@pytest.mark.parametrize("comb", ts.EUCL_COMBOS)
def test_eucl_detect_scores_matches_jax(eucl_case, monkeypatch, comb,
                                        rec_error, kde_version):
    """detect_scores(hyperbolic=False) against JAX's. For "v2" JAX runs
    its Pallas v2 kernel (in interpret mode off the TPU) under
    HYPAD_KDE_PALLAS=1, the counterpart of the port's K3."""
    params, model, X, jinf, _ = eucl_case
    if kde_version == "v2":
        monkeypatch.setenv("HYPAD_KDE_PALLAS", "1")
    want, _ = js.detect_scores(params, X, False, comb, rec_error=rec_error,
                               fetch_inference=False)
    got, none = ts.detect_scores(model, X, False, comb, rec_error=rec_error,
                                 fetch_inference=False,
                                 kde_version=kde_version, device="cpu")
    assert none is None and got.shape == want.shape == (N + W - 1,)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))

    # the KDE stage alone, at tie level
    critic = np.array(jinf.critic_score)
    vals, mask, jax_kde_max = _jax_kde_max(critic, kde_version)
    port_kde_max = kde_argmax_rows_fused(vals, mask, kde_version).numpy()
    flips = np.nonzero(port_kde_max != jax_kde_max)[0]
    v, m = vals.numpy(), mask.numpy()
    assert all(port_kde_max[i] in v[i][m[i]] for i in flips)
    assert len(flips) <= 3

    # the stages after the KDE, fed JAX's kde_max, hold in every case
    monkeypatch.setattr(ts, "kde_argmax_rows_fused",
                        lambda *_: torch.from_numpy(jax_kde_max))
    after_kde = ts.score_anomalies_euclidean(
        jinf.true_signal, jinf.recons_signal, critic, rec_error, comb,
        kde_version=kde_version, device="cpu")
    want_after = js.score_anomalies_euclidean(
        jinf.true_signal, jinf.recons_signal, critic,
        rec_error_type=rec_error, comb=comb)
    _assert_scores_close(after_kde, want_after, comb)
    if len(flips) == 0 or comb == "rec":
        _assert_scores_close(got, want, comb)


@pytest.mark.parametrize("comb", ["uncertainty", "rec_uncertainty", "max"])
def test_eucl_unsupported_combination_raises_as_in_jax(eucl_case, comb):
    params, model, X, jinf, _ = eucl_case
    with pytest.raises(ValueError) as want:
        js.detect_scores(params, X, False, comb, fetch_inference=False)
    with pytest.raises(ValueError) as got:
        ts.detect_scores(model, X, False, comb, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        ts.score_anomalies_euclidean(X, jinf.recons_signal, jinf.critic_score,
                                     comb=comb, device="cpu")


def test_eucl_unknown_rec_error_raises(eucl_case):
    _, model, X, _, _ = eucl_case
    with pytest.raises(ValueError, match="rec_error"):
        ts.detect_scores(model, X, False, "mult", rec_error="l2",
                         device="cpu")


@pytest.mark.parametrize("rec_error", ts.REC_ERRORS)
@pytest.mark.parametrize("window", [0.01, 2.0, 7])
def test_reconstruction_errors_match_jax(eucl_case, rec_error, window):
    """A float window is a share of N capped at 200 (2.0 -> 200), an int
    passes as it is; the unrolled prediction is bitwise JAX's."""
    _, _, X, jinf, _ = eucl_case
    y_hat = np.asarray(jinf.recons_signal)
    got_e, got_p = ts.reconstruction_errors(X, y_hat, rec_error,
                                            smoothing_window=window,
                                            device="cpu")
    want_e, want_p = js.reconstruction_errors(X, y_hat, rec_error,
                                              smoothing_window=window)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(np.isnan(got_e), np.isnan(want_e))
    np.testing.assert_allclose(got_e, want_e, **SCORE_TOL)


@pytest.mark.parametrize("kde_version", ["v1", "v2"])
def test_final_critic_scores_matches_jax(eucl_case, monkeypatch,
                                         kde_version):
    _, _, X, jinf, _ = eucl_case
    if kde_version == "v2":
        monkeypatch.setenv("HYPAD_KDE_PALLAS", "1")
    critic = np.asarray(jinf.critic_score)
    got = ts.final_critic_scores(critic, X, kde_version, device="cpu")
    want = js.final_critic_scores(critic, X)
    np.testing.assert_allclose(got, want, **SCORE_TOL)


# ---------------------------------------------------------------------------
# the staged fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hyperbolic", [True, False])
def test_run_inference_in_chunks_matches_jax(hyperbolic):
    params = _params(seed=2, hyperbolic=hyperbolic)
    model = from_jax_params(params, device="cpu")
    X = _windows(seed=2)
    got = ts.run_inference(model, X, hyperbolic, batch_size=128,
                           device="cpu")
    want = js.run_inference(params, X, hyperbolic, batch_size=128)
    for name, a in got._asdict().items():
        b = getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a, np.asarray(b), **FORWARD_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("hyperbolic", [True, False])
def test_staged_fallback_matches_one_call_and_jax(monkeypatch, hyperbolic):
    """Above ONE_CALL_MAX_WINDOWS (patched down to 200) detect_scores runs
    run_inference and score_anomalies_*: the one-call scores bit for bit
    (one chunk, the same operations), and JAX's staged scores."""
    params = _params(seed=3, hyperbolic=hyperbolic)
    model = from_jax_params(params, device="cpu")
    X = _windows(seed=3)
    comb, rec_error = "mult", "dtw"
    one_call, one_inf = ts.detect_scores(model, X, hyperbolic, comb,
                                         rec_error=rec_error, device="cpu")
    calls = []
    run_inference = ts.run_inference
    monkeypatch.setattr(ts, "run_inference",
                        lambda *a, **k: calls.append(1) or run_inference(
                            *a, **k))
    monkeypatch.setattr(ts, "ONE_CALL_MAX_WINDOWS", 200)
    staged, inf = ts.detect_scores(model, X, hyperbolic, comb,
                                   rec_error=rec_error, device="cpu")
    assert calls == [1]
    np.testing.assert_array_equal(staged, one_call)
    for a, b in zip(inf, one_inf):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)

    jinf = js.run_inference(params, X, hyperbolic)
    if hyperbolic:
        want = js.score_anomalies_hyperbolic(jinf, comb)
        assert staged.shape == (N,)
    else:
        want = js.score_anomalies_euclidean(
            jinf.true_signal, jinf.recons_signal, jinf.critic_score,
            rec_error_type=rec_error, comb=comb)
        assert staged.shape == (N + W - 1,)
    np.testing.assert_array_equal(staged == 0, want == 0)
    np.testing.assert_array_equal(np.isnan(staged), np.isnan(want))
    np.testing.assert_allclose(staged, want, **SCORE_TOL)


def test_euclidean_scoring_of_a_ball_head_model_matches_jax():
    """A hyperbolic model scored with hyperbolic=False reconstructs with
    its decoder's tanh output, as JAX's Euclidean forward does."""
    params = _params(seed=4, hyperbolic=True)
    model = from_jax_params(params, device="cpu")
    X = _windows(seed=4)
    want, jinf = js.detect_scores(params, X, False, "rec", rec_error="point")
    got, tinf = ts.detect_scores(model, X, False, "rec", rec_error="point",
                                 device="cpu")
    np.testing.assert_allclose(tinf.recons_signal,
                               np.asarray(jinf.recons_signal), **FORWARD_TOL)
    np.testing.assert_allclose(got, want, **SCORE_TOL)


def test_hyperbolic_scoring_needs_the_ball_head(eucl_case):
    _, model, X, _, _ = eucl_case
    with pytest.raises(ValueError, match="MobiusLinear"):
        ts.detect_scores(model, X, True, "mult", device="cpu")


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rec_error,kde_version", [("point", "v1"),
                                                   ("dtw", "v2")])
def test_detect_univariate_euclidean_matches_jax_end_to_end(
        monkeypatch, rec_error, kde_version):
    """Synthetic signal with injected anomalies: the Euclidean detector
    gives the intervals and F1 of JAX detect_scores -> find_anomalies ->
    metrics, over the whole N + W timeline."""
    if kde_version == "v2":
        monkeypatch.setenv("HYPAD_KDE_PALLAS", "1")
    stamps, values, flags = tpipe.synthetic_signal(1500, anomaly_len=40,
                                                   seed=11)
    X, index = tpipe.prepare_univariate(values, stamps, 1, window_size=W)
    known = np.stack(tpipe.extract_known_anomalies(flags, stamps), axis=1)
    params = _params(seed=5)
    model = from_jax_params(params, device="cpu")

    scores, _ = js.detect_scores(params, X, False, "mult",
                                 rec_error=rec_error, fetch_inference=False)
    assert len(index) == len(X) + W and len(scores) == len(X) + W - 1
    want_iv = jiv.find_anomalies(scores.reshape(-1), index,
                                 **_UNIVARIATE_FA_KW)
    want_conf = jmt.contextual_confusion_matrix(known, want_iv)
    got = detect_univariate(model, X, index, known, "mult", hyperbolic=False,
                            rec_error=rec_error, kde_version=kde_version,
                            device="cpu")

    assert len(want_iv) > 0
    np.testing.assert_array_equal(got["intervals"][:, :2], want_iv[:, :2])
    np.testing.assert_allclose(got["intervals"][:, 2], want_iv[:, 2],
                               rtol=1e-3)
    assert tuple(got["confusion"]) == tuple(want_conf)
    want_f1 = jmt.metrics_from_confusion(want_conf, verbose=False)["f1"]
    assert got["metrics"]["f1"] == want_f1
