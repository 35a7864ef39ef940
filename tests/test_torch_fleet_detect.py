"""Port parity: fleet detection (``detect_scores_fleet``) and the ragged
ops under it, against the JAX package's fleet detector and ragged ops, on
the CPU.

The family is ragged (210 / 150 / 90 windows, as tests/test_fleet_detect.py
has it), so the per-signal smoothing windows differ and every masked
reduction runs off the unpadded path. Weights are JAX ``init_tadgan``'s,
carried over by the stacked-parameter bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypad_tpu.detect import scorer as jsc
from hypad_tpu.models.tadgan import init_tadgan
from hypad_tpu.ops import kde as jkde
from hypad_tpu.ops import rolling as jrol
from hypad_tpu.ops import unroll as jun
from hypad_tpu.train import fleet as jfl
from hypad_tpu_torch import bridge
from hypad_tpu_torch.detect import scorer as tsc
from hypad_tpu_torch.ops import rolling as trol
from hypad_tpu_torch.ops import unroll as tun
from hypad_tpu_torch.train import fleet as tfl

W = 100
LENS = (210, 150, 90)
# tests/test_fleet_detect.py's bound for the fleet against per-signal scores
FLEET_TOL = dict(rtol=3e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch ops on one thread: the suite runs in several
    worker processes, whose default thread pools would oversubscribe the
    cores and slow these small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_windows(n, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 20 * np.pi, n + W)
    s = np.sin(t) + 0.05 * rng.standard_normal(n + W)
    X = np.stack([s[i:i + W] for i in range(n)]).astype(np.float32)
    return np.clip(X, -1, 1)


def _family(hyperbolic):
    params = [init_tadgan(jax.random.PRNGKey(7 + i), signal_shape=W,
                          hyperbolic=hyperbolic) for i in range(len(LENS))]
    X_list = [_toy_windows(n, seed=i) for i, n in enumerate(LENS)]
    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), *params)
    return stacked, X_list


def _assert_scores(got, want, what, comb="mult"):
    """FLEET_TOL, and the exact-zero and NaN positions equal. "sum" is
    (c - 1) / 2 + (r - 1) / 2 of critic and rec scores c, r >= 1, held as
    sum + 1 as tests/test_torch_eucl.py holds it: the exact - 1 leaves
    their error, relative to c and r, on a result near 0."""
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=f"{what}: NaN positions")
    np.testing.assert_array_equal(got == 0, want == 0,
                                  err_msg=f"{what}: zero positions")
    shift = 1.0 if comb == "sum" else 0.0
    np.testing.assert_allclose(got + shift, want + shift, err_msg=what,
                               **FLEET_TOL)


@pytest.mark.parametrize("hyperbolic,combination,rec_error,canonical", [
    (False, "mult", "point", False),
    (False, "mult", "dtw", True),
    (False, "sum", "area", True),
    (True, "mult", "point", True),
    (True, "uncertainty", "point", False),
])
def test_fleet_detect_matches_jax_fleet(monkeypatch, hyperbolic, combination,
                                        rec_error, canonical):
    """``detect_scores_fleet`` against JAX's, with and without the
    canonical path (whose one observable effect, the 256-ulp snap, the
    port keeps): FLEET_TOL, zeros and NaNs where JAX has them.

    As in tests/test_torch_eucl.py, the KDE argmax is held at tie level on
    its own (a row's argmax may take another sample of equal density, at
    most 3 rows of the family), and the stages after it are held end to end
    with JAX's KDE values fed in, since one flipped tie moves a
    cancelling ``sum`` score past any fixed bound."""
    stacked, X_list = _family(hyperbolic)
    want = jsc.detect_scores_fleet(stacked, X_list, hyperbolic, combination,
                                   rec_error=rec_error, canonical=canonical)
    port_kde = tsc.kde_argmax_rows_fused
    flips = []

    def jax_kde(vals, mask, version):
        ours = port_kde(vals, mask, version).numpy()
        theirs = np.asarray(jkde.kde_argmax_rows(jnp.asarray(vals.numpy()),
                                                 jnp.asarray(mask.numpy())))
        v, m = vals.numpy(), mask.numpy()
        for i in np.nonzero(ours != theirs)[0]:
            assert ours[i] in v[i][m[i]]
            flips.append(i)
        return torch.from_numpy(theirs)

    monkeypatch.setattr(tsc, "kde_argmax_rows_fused", jax_kde)
    got = tsc.detect_scores_fleet(
        bridge.from_jax_stacked_params(stacked, device="cpu"), X_list,
        hyperbolic, combination, rec_error=rec_error, canonical=canonical,
        device="cpu")
    assert len(got) == len(want) == len(LENS)
    assert len(flips) <= 3
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_scores(g, np.asarray(w), f"signal {i}", combination)


@pytest.mark.parametrize("hyperbolic,rec_error", [(False, "dtw"),
                                                  (True, "point")])
def test_fleet_detect_matches_port_single_signal_detection(hyperbolic,
                                                           rec_error):
    """Each signal's fleet scores against the port's own one-call
    ``detect_scores`` of that signal alone (the fleet's ragged
    reductions against the unpadded ones), at FLEET_TOL with the zero and
    NaN positions equal; a NaN-poisoned pad changes nothing."""
    stacked, X_list = _family(hyperbolic)
    P = bridge.from_jax_stacked_params(stacked, device="cpu")
    got = tsc.detect_scores_fleet(P, X_list, hyperbolic, "mult",
                                  rec_error=rec_error, canonical=False,
                                  device="cpu")
    for i, X in enumerate(X_list):
        model = tfl.unstack_model(P, i)
        want, _ = tsc.detect_scores(model, X, hyperbolic, "mult",
                                    rec_error=rec_error,
                                    fetch_inference=False, device="cpu")
        _assert_scores(got[i], want, f"signal {i}")
    Xs, n_real = tfl.pad_and_stack(X_list, pad_value=np.nan)
    poisoned = tsc.detect_scores_fleet(
        P, X_list, hyperbolic, "mult", rec_error=rec_error, canonical=False,
        staged=(torch.from_numpy(Xs), n_real), device="cpu")
    for g, p in zip(got, poisoned):
        np.testing.assert_array_equal(g, p)


def test_fleet_detect_chunks_and_staging(monkeypatch):
    """A budget forced down to two signals a chunk (the tail chunk slid
    back over the first) gives the one-call scores bit for bit; so does
    the staged stack of ``train_fleet(return_staged=True)``; a stale stack
    raises."""
    stacked, X_list = _family(False)
    P = bridge.from_jax_stacked_params(stacked, device="cpu")
    full = tsc.detect_scores_fleet(P, X_list, False, "mult", device="cpu")
    Xs, n_real = tfl.pad_and_stack(X_list)
    staged = tsc.detect_scores_fleet(P, X_list, False, "mult",
                                     staged=(torch.from_numpy(Xs), n_real),
                                     device="cpu")
    monkeypatch.setattr(tsc, "FLEET_MAX_BYTES",
                        2 * max(LENS) * tsc.FLEET_BYTES_PER_WINDOW)
    assert tsc.fleet_chunk_plan(3, max(LENS)) == ([(0, 2), (2, 2)], 2)
    chunked = tsc.detect_scores_fleet(P, X_list, False, "mult",
                                      device="cpu")
    for a, b, c in zip(full, staged, chunked):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError, match="stale"):
        tsc.detect_scores_fleet(P, X_list, False, "mult",
                                staged=(torch.from_numpy(Xs),
                                        n_real[::-1].copy()), device="cpu")


def test_ragged_ops_match_jax():
    """The ragged rolling mean and trapezoid, masked z-score and quantile,
    anti-diagonal gather, median unroll and true series, row by row,
    against JAX's vmapped over the same rows: bitwise, or within 1e-6
    where the op reduces in another order (the cumulative sums and the
    masked sums of the z-score)."""
    rng = np.random.default_rng(3)
    S, N = 3, 60
    n = np.array([60, 41, 17], np.int32)
    x = rng.standard_normal((S, N + W - 1)).astype(np.float32)
    x[1, 5] = np.nan
    y = rng.uniform(-1, 1, (S, N, W)).astype(np.float32)
    t_real = n + W - 1
    win = np.array([3, 2, 1], np.int32)
    tx, tn, tw = (torch.from_numpy(a) for a in (x, t_real, win))
    jx = jnp.asarray(x)
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        trol.rolling_mean_centered_ragged(tx, tw, tn, tw // 2 + 1).numpy(),
        jax.vmap(jrol.rolling_mean_centered_ragged)(
            jx, win, t_real, win // 2 + 1), **close)
    np.testing.assert_allclose(
        trol.rolling_trapz_centered_ragged(tx, 10, tn, 5).numpy(),
        jax.vmap(lambda a, m: jrol.rolling_trapz_centered_ragged(
            a, 10, m, 5))(jx, t_real), **close)
    xf = np.nan_to_num(x)
    mask = np.arange(x.shape[1])[None, :] < t_real[:, None]
    np.testing.assert_allclose(
        trol.zscore_masked(torch.from_numpy(xf),
                           torch.from_numpy(mask)).numpy(),
        jax.vmap(jrol.zscore_masked)(jnp.asarray(xf), mask), **close)
    for q in (0.25, 0.75):
        np.testing.assert_array_equal(
            trol.masked_quantile(torch.from_numpy(xf), torch.from_numpy(mask),
                                 q).numpy(),
            jax.jit(jax.vmap(lambda a, m: jrol.masked_quantile(a, m, q)))(
                jnp.asarray(xf), mask))
    ty, tnr = torch.from_numpy(y), torch.from_numpy(n)
    vals, m = tun.antidiagonal_gather_ragged(ty, tnr)
    jvals, jm = jax.vmap(lambda a, k: jun.antidiagonal_gather(a, n_real=k))(
        jnp.asarray(y), n)
    np.testing.assert_array_equal(vals.numpy(), jvals)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(
        tun.unroll_median_ragged(ty, tnr).numpy(),
        jax.vmap(lambda a, k: jun.unroll_median(a, n_real=k))(
            jnp.asarray(y), n))
    got = tun.true_series_ragged(ty, tnr).numpy()
    want = np.asarray(jax.vmap(jun.true_series_ragged)(jnp.asarray(y), n))
    for i, k in enumerate(n):   # past n + W - 1 the entries are unspecified
        np.testing.assert_array_equal(got[i, :k + W - 1],
                                      want[i, :k + W - 1])


def test_stacked_params_bridge_round_trip():
    """JAX's stacked parameters carry to the port and back bitwise, and
    signal i of the port's stack is ``from_jax_params`` of JAX's signal
    i."""
    stacked, _ = _family(True)
    P = bridge.from_jax_stacked_params(stacked, device="cpu")
    back = bridge.flatten_tree(bridge.to_jax_stacked_params(P))
    want = bridge.flatten_tree(stacked)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    one = bridge.from_jax_params(jfl.unstack_state(stacked, 1),
                                 device="cpu").state_dict()
    for k, v in tfl.unstack_model(P, 1).state_dict().items():
        assert torch.equal(v, one[k]), k
