"""Port parity: the compiled detect call and grid
(hypad_tpu_torch.detect.graphed), on the CPU.

On the card ``detect_scores`` and ``detect_scores_grid`` run their bodies
through a ``graphed.DetectProgram``: the first call of a configuration
eagerly, the second captured into a CUDA graph and replayed, every later
one replayed. Here a stand-in for the graph (:class:`StandInGraph`, set
through ``graphed._graph_factory``) runs the program's host side on the
CPU: its capture records the body, and its replay runs the body again on
the program's static buffers and writes the results into the tensors the
capture returned, as a replay rewrites a graph's outputs. So these tests
hold:

* (a) every path, two different ``X`` of one shape, the first through the
  eager first call and the second through the stand-in's capture and
  replay (then the first again through a replay): each call bitwise the
  eager call of the CPU path, and JAX's ``detect_scores`` /
  ``detect_scores_grid`` on the same numpy inputs and weights (carried
  over by ``bridge.from_jax_params``) within the tolerances of
  tests/test_torch_detect.py, test_torch_eucl.py and
  test_torch_multivariate.py, zeros exact and intervals equal (a critic
  combination outside its tolerance must be a KDE tie, as those files
  allow: at most three picks differ, each a sample of its own row, and the
  port's scores fed JAX's picks then hold at the tolerance and on the
  intervals); "v2"
  runs JAX's Pallas v2 kernel in interpret mode (``HYPAD_KDE_PALLAS=1``),
  as tests/test_torch_eucl.py does;
* (b) the programs' keys, their least-recently-used bound, the paths that
  make none (a mesh, the staged path, the CPU), the launch counters per
  replay and a failing capture.
"""

import weakref

import jax
import numpy as np
import pytest
import torch

from hypad_tpu.detect import scorer as js
from hypad_tpu.models.tadgan import init_tadgan as jax_init_tadgan
from hypad_tpu_torch.bridge import from_jax_params
from hypad_tpu_torch.data.pipeline import synthetic_detect_input
from hypad_tpu_torch.detect import detector as tdet
from hypad_tpu_torch.detect import graphed
from hypad_tpu_torch.detect import scorer as ts
from hypad_tpu_torch.manifold.kernels import mobius_linear_kernel
from hypad_tpu_torch.ops.kde_kernel import (
    kde_argmax_kernel,
    kde_argmax_rows_fused,
)
from hypad_tpu_torch.parallel.mesh import make_mesh

# tests/test_torch_detect.py and test_torch_eucl.py: the critic
# combinations, every Euclidean score (its cumulative sums add in another
# order) and the forwards; tests/test_torch_multivariate.py: the other rec
# combinations
CRITIC_TOL = dict(rtol=1e-4, atol=1e-6)
REC_TOL = dict(rtol=1e-5, atol=1e-6)
FORWARD_TOL = dict(rtol=1e-5, atol=1e-6)
N, W, F = 300, 100, 123
REAL_GRAPH_FACTORY = graphed._graph_factory


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch ops on one thread: the suite runs in several
    worker processes, whose default thread pools would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandInGraph:
    """``torch.cuda.CUDAGraph``'s stand-in on the CPU. ``capture`` records
    the body and runs it once for the tensors it returns; ``replay`` runs
    the recorded body again (on the program's static buffers) and copies
    its results into those tensors. ``log`` counts both."""

    log = None

    def __init__(self, device):
        self.body = self.out = None

    def capture(self, body):
        self.log["captures"] += 1
        self.body = body
        self.out = body()
        return self.out

    def replay(self):
        self.log["replays"] += 1
        for dst, src in zip(self.out, self.body()):
            dst.copy_(src)

    def reset(self):
        self.log["resets"] += 1
        self.body = self.out = None


@pytest.fixture
def stand_in(monkeypatch):
    """Programs on the CPU through :class:`StandInGraph`, kept in a table
    of this test's own; returns the graphs' log."""
    log = {"captures": 0, "replays": 0, "resets": 0}
    monkeypatch.setattr(StandInGraph, "log", log)
    monkeypatch.setattr(graphed, "_PROGRAMS", weakref.WeakKeyDictionary())
    monkeypatch.setattr(graphed, "_graph_factory",
                        lambda device: StandInGraph)
    return log


def _jax_params(width, hyperbolic, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_init_tadgan(
        jax.random.PRNGKey(seed), width, hyperbolic=hyperbolic))


def _windows(seed, n=N):
    """Seeded synthetic windows of width W with 3 level shifts, and their
    timeline."""
    X, index, _ = synthetic_detect_input(n, W, anomaly_len=20, seed=seed)
    return X, np.asarray(index)


def _rows(seed):
    """Seeded (N, F) rows in [-1, 1] with a shifted block of 20 rows
    (tests/test_torch_multivariate.py's ``_rows``)."""
    X = np.random.default_rng(seed).uniform(-1, 1, (N, F)).astype(np.float32)
    X[N // 2:N // 2 + 20] = np.clip(X[N // 2:N // 2 + 20] + 0.8, -1, 1)
    return X


def _assert_same(got, want, what):
    """Bit for bit, NaNs in the same places."""
    np.testing.assert_array_equal(got, want, err_msg=what)


def _hold_against_jax(got, want, comb, index, multivariate, euclidean,
                      kde_tie):
    """``got`` (the port's scores) against JAX's ``want``: zeros and NaNs
    in the same places, the tolerance of the combination, the same
    intervals. A critic combination that misses its tolerance must be a
    KDE tie: ``kde_tie()`` (:func:`_kde_tie`) checks that the picks that
    differ are samples of their own rows, at most three, and returns the
    port's scores with JAX's picks in place of its own, which are then held
    at the tolerance and on the intervals in ``got``'s place (the stages
    after the KDE fed JAX's picks, as tests/test_torch_detect.py holds
    them). The Euclidean "sum", (c - 1) / 2 + (r - 1) / 2 of scores c, r >=
    1, is held as sum + 1, as tests/test_torch_eucl.py holds it."""
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    shift = 1.0 if comb == "sum" and euclidean else 0.0
    critic = comb in ts.CRITIC_COMBOS
    tol = CRITIC_TOL if critic or euclidean else REC_TOL
    try:
        np.testing.assert_allclose(got + shift, want + shift, **tol)
    except AssertionError:
        if not critic:
            raise
        got = kde_tie()
        np.testing.assert_allclose(got + shift, want + shift, **tol)
    iv_got, iv_want = (tdet._intervals(s, index, multivariate)
                       for s in (got, want))
    np.testing.assert_array_equal(np.asarray(iv_got).reshape(-1, 3)[:, :2],
                                  np.asarray(iv_want).reshape(-1, 3)[:, :2])


def _kde_tie(model, X, hyperbolic, jax_critic, width, version, scores):
    """The check :func:`_hold_against_jax` runs on a miss: the port's KDE
    picks on its critic of ``X`` (outside any program) against JAX's on
    JAX's ``jax_critic`` (JAX's plain KDE for "v1", its Pallas v2 kernel in
    interpret mode for "v2"), at most three differing, each a sample of its
    own row. Returns ``scores()`` (the port's eager scores of the cell held)
    with JAX's picks in place of the port's KDE."""
    def check():
        import jax.numpy as jnp

        from hypad_tpu.ops.kde import kde_argmax_rows as jax_kde
        from hypad_tpu.ops.kde_pallas import kde_argmax_rows_pallas

        with torch.inference_mode():
            port_critic = ts._forward_chunk(model, torch.from_numpy(X),
                                            hyperbolic)[-1]
        n = len(port_critic)
        vals, mask = ts._critic_antidiag(port_critic, n, width)
        jv, jm = ts._critic_antidiag(torch.tensor(np.asarray(jax_critic)), n,
                                     width)
        jv, jm = jnp.asarray(jv.numpy()), jnp.asarray(jm.numpy())
        theirs = np.array(jax_kde(jv, jm) if version == "v1" else
                            kde_argmax_rows_pallas(jv, jm, interpret=True,
                                                   version="v2"), np.float32)
        ours = kde_argmax_rows_fused(vals, mask, version).numpy()
        flips = np.nonzero(~np.isclose(ours, theirs, rtol=1e-5,
                                       atol=1e-6))[0]
        v, m = vals.numpy(), mask.numpy()
        assert 0 < len(flips) <= 3, f"{len(flips)} KDE picks differ"
        assert all(ours[i] in v[i][m[i]] for i in flips)
        picks = torch.from_numpy(theirs)
        with pytest.MonkeyPatch.context() as patch, graphed.eager():
            patch.setattr(ts, "kde_argmax_rows_fused",
                          lambda vals, mask, version="v1": picks)
            return scores()
    return check


def _through_program(monkeypatch, stand_in, call, X1, X2):
    """``call(X)`` on the CPU path (eager, no program) for X1 and X2, then
    through a program and the stand-in: X1 (the eager first call), X2 (the
    capture and a replay), X1 (a replay). Each program call bitwise the
    eager call; returns the three program calls' results."""
    with monkeypatch.context() as m:
        m.setattr(graphed, "_graph_factory", REAL_GRAPH_FACTORY)
        eager = [call(X1), call(X2)]
    assert stand_in["captures"] == 0
    got = [call(X1), call(X2), call(X1)]
    assert stand_in == {"captures": 1, "replays": 2, "resets": 0}
    for i, (g, e) in enumerate(zip(got, [eager[0], eager[1], eager[0]])):
        for k in e:
            _assert_same(g[k], e[k], f"call {i}, {k}")
    # a second X that changed no output would mean a frozen input
    for k in got[0]:
        assert not np.array_equal(got[0][k], got[1][k]), k
    return got


SINGLE = {
    "hyperbolic_v1_mult": (True, "mult", "point", "v1"),
    "hyperbolic_v1_uncertainty": (True, "uncertainty", "point", "v1"),
    "hyperbolic_v2_mult": (True, "mult", "point", "v2"),
    "hyperbolic_v2_uncertainty": (True, "uncertainty", "point", "v2"),
    "euclidean_dtw_v2": (False, "mult", "dtw", "v2"),
    "euclidean_area_v2": (False, "mult", "area", "v2"),
}


@pytest.mark.parametrize("path", list(SINGLE))
def test_detect_program_matches_jax(monkeypatch, stand_in, path):
    """``detect_scores`` through a program: each call bitwise its eager
    call, scores (and, on the hyperbolic v1 path, the inference tensors)
    at JAX's numbers for both X."""
    hyperbolic, comb, rec_error, version = SINGLE[path]
    if version == "v2":
        monkeypatch.setenv("HYPAD_KDE_PALLAS", "1")
    params = _jax_params(W, hyperbolic)
    model = from_jax_params(params, device="cpu")
    fetch = path == "hyperbolic_v1_mult"
    (X1, index), (X2, _) = _windows(1), _windows(2)

    def call(X):
        scores, inf = ts.detect_scores(model, X, hyperbolic, comb,
                                       rec_error=rec_error,
                                       fetch_inference=fetch,
                                       kde_version=version, device="cpu")
        out = {"scores": scores}
        if fetch:
            out.update({k: v for k, v in inf._asdict().items()
                        if v is not None})
        return out

    got = _through_program(monkeypatch, stand_in, call, X1, X2)
    assert len(graphed.programs(model)) == 1
    for X, g in ((X1, got[0]), (X2, got[1])):
        want, jinf = js.detect_scores(params, X, hyperbolic, comb,
                                      rec_error=rec_error)
        _hold_against_jax(g["scores"], np.asarray(want), comb, index, False,
                          not hyperbolic,
                          _kde_tie(model, X, hyperbolic, jinf.critic_score,
                                   W, version,
                                   lambda X=X: call(X)["scores"]))
        if fetch:
            for k in ("recons_signal", "true_signal", "critic_score",
                      "eucl_recons"):
                np.testing.assert_allclose(g[k], np.asarray(getattr(jinf, k)),
                                           err_msg=k, **FORWARD_TOL)
            _assert_same(g["gt_signal"], X, "gt_signal")


def test_multivariate_program_matches_jax(monkeypatch, stand_in):
    """``detect_scores(multivariate=True)`` through a program, hyperbolic,
    at F = 123 (WADI's width), each call bitwise its eager call and at
    JAX's numbers."""
    params = _jax_params(F, True)
    model = from_jax_params(params, device="cpu")
    X1, X2 = _rows(1), _rows(2)

    def call(X):
        return {"scores": ts.detect_scores(
            model, X, True, "mult", fetch_inference=False, device="cpu",
            multivariate=True)[0]}

    got = _through_program(monkeypatch, stand_in, call, X1, X2)
    for X, g in ((X1, got[0]), (X2, got[1])):
        want, jinf = js.detect_scores(params, X, True, "mult",
                                      multivariate=True)
        _hold_against_jax(g["scores"], np.asarray(want), "mult", None, True,
                          False,
                          _kde_tie(model, X, True, jinf.critic_score, F,
                                   "v1", lambda X=X: call(X)["scores"]))


GRIDS = {
    "hyperbolic": (True, ts.COMBINATIONS, ("point",)),
    "euclidean": (False, ts.EUCL_COMBOS, ts.REC_ERRORS),
}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_program_matches_jax(monkeypatch, stand_in, grid):
    """``detect_scores_grid`` through a program (the hyperbolic grid of all
    8 combinations, the Euclidean 3 x 4): every cell of every call bitwise
    its eager call, in JAX's order and at JAX's numbers."""
    hyperbolic, combs, rec_errors = GRIDS[grid]
    params = _jax_params(W, hyperbolic)
    model = from_jax_params(params, device="cpu")
    (X1, index), (X2, _) = _windows(1), _windows(2)

    def call(X):
        return ts.detect_scores_grid(model, X, hyperbolic, combs,
                                     rec_errors, device="cpu")

    got = _through_program(monkeypatch, stand_in, call, X1, X2)
    for X, g in ((X1, got[0]), (X2, got[1])):
        want = js.detect_scores_grid(params, X, hyperbolic, combs,
                                     rec_errors)
        assert list(g) == list(want)

        def tie(cell, X=X):
            jinf = js.run_inference(params, X, hyperbolic)
            return _kde_tie(model, X, hyperbolic, jinf.critic_score, W, "v1",
                            lambda: call(X)[cell])()

        for cell, scores in g.items():
            _hold_against_jax(scores, np.asarray(want[cell]), cell[1], index,
                              False, not hyperbolic,
                              lambda cell=cell: tie(cell))


# ---------------------------------------------------------------------------
# the programs' host side
# ---------------------------------------------------------------------------

def _small_model(hyperbolic=True, width=16):
    return from_jax_params(_jax_params(width, hyperbolic, seed=3),
                           device="cpu")


def _small_windows(n, width=16, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, width)).astype(
        np.float32)


def _detect(model, X, comb="mult", **kw):
    return ts.detect_scores(model, X, True, comb, fetch_inference=False,
                            device="cpu", **kw)[0]


def test_a_new_key_makes_a_new_program(stand_in):
    """A new shape, combination, KDE version, entry or parameter tensor
    makes a new program; a parameter updated in place keeps it."""
    model = _small_model()
    X, Y = _small_windows(40), _small_windows(50)
    first = _detect(model, X)
    # a one-off call holds no buffer and no graph
    (prog,) = graphed.programs(model)
    assert prog.calls == 1 and prog.X is None and prog.graph is None
    for _ in range(2):
        _assert_same(_detect(model, X), first, "the capture and a replay")
    # windows given as a tensor take the same program, copied into its
    # buffer; the returned windows are a copy of that buffer
    scores, inf = ts.detect_scores(model, torch.from_numpy(X.copy()), True,
                                   "mult", device="cpu")
    _assert_same(scores, first, "tensor windows")
    _assert_same(inf.gt_signal, X, "gt_signal")
    assert not np.shares_memory(inf.gt_signal,
                                graphed.programs(model)[0].X.numpy())
    assert len(graphed.programs(model)) == 1 and stand_in["captures"] == 1
    _detect(model, Y)
    _detect(model, X, "sum")
    _detect(model, X, kde_version="v2")
    ts.detect_scores_grid(model, X, True, ("mult",), device="cpu")
    assert len(graphed.programs(model)) == 5
    w = model["critic_x"].dense1.w
    with torch.no_grad():
        w.add_(0.0)
    _detect(model, X)
    assert len(graphed.programs(model)) == 5 and stand_in["captures"] == 1
    w.data = w.data.clone()
    before = _detect(model, X)
    assert len(graphed.programs(model)) == 6 and stand_in["captures"] == 1
    _assert_same(_detect(model, X), before, "the new program's replay")
    assert stand_in["captures"] == 2
    other = _small_model()
    _detect(other, X)
    assert len(graphed.programs(other)) == 1
    assert len(graphed.programs(model)) == 6


def test_the_cache_evicts_its_least_recently_used_program(monkeypatch,
                                                          stand_in):
    """Past ``MAX_PROGRAMS`` the program used longest ago goes, its graph
    reset; a later call of its key starts a new program eagerly."""
    monkeypatch.setattr(graphed, "MAX_PROGRAMS", 2)
    model = _small_model()
    X = _small_windows(40)
    for comb in ("mult", "mult", "sum", "sum"):
        _detect(model, X, comb)
    first = {id(p) for p in graphed.programs(model)}
    _detect(model, X, "mult")            # "mult" now the most recent
    _detect(model, X, "critic")          # evicts "sum"
    kept = graphed.programs(model)
    assert len(kept) == 2 and stand_in["resets"] == 1
    assert [p.calls for p in kept] == [3, 1]
    assert id(kept[0]) in first
    _detect(model, X, "sum")             # new: eager, no capture
    assert stand_in == {"captures": 2, "replays": 3, "resets": 2}


def test_mesh_staged_and_cpu_make_no_program(monkeypatch, stand_in):
    """A mesh and the staged path (above ``ONE_CALL_MAX_WINDOWS``) stay
    eager; so does the CPU without a graph type."""
    model = _small_model()
    X = _small_windows(40)
    mesh = make_mesh([torch.device("cpu")] * 2)
    ts.detect_scores(model, X, True, "mult", mesh=mesh, device="cpu")
    ts.detect_scores_grid(model, X, True, ("mult",), mesh=mesh,
                          device="cpu")
    with monkeypatch.context() as m:
        m.setattr(ts, "ONE_CALL_MAX_WINDOWS", 20)
        _detect(model, X)
        ts.detect_scores_grid(model, X, True, ("mult",), device="cpu")
    assert graphed.programs(model) == []
    monkeypatch.setattr(graphed, "_graph_factory", REAL_GRAPH_FACTORY)
    _detect(model, X)
    _detect(model, X)
    assert graphed.programs(model) == [] and stand_in["captures"] == 0
    assert graphed.program_for(model, ("detect",), X.shape,
                               torch.device("cpu")) is None


def test_launch_counters_advance_by_the_captured_launches(monkeypatch,
                                                          stand_in):
    """The capture's own counts are put back and each replay adds them:
    a graph that held K1 twice and K2 once counts 2 and 1 a call."""

    class Counting(StandInGraph):
        def capture(self, body):
            mobius_linear_kernel.launches += 2
            kde_argmax_kernel.launches += 1
            kde_argmax_kernel.wide_launches += 1
            return super().capture(body)

    monkeypatch.setattr(graphed, "_graph_factory", lambda device: Counting)
    for fn in (mobius_linear_kernel, kde_argmax_kernel):
        for c in ("launches", "wide_launches", "xwide_launches"):
            monkeypatch.setattr(fn, c, 0)
    model = _small_model()
    X = _small_windows(40)
    counts = []
    for _ in range(4):
        _detect(model, X)
        counts.append((mobius_linear_kernel.launches,
                       kde_argmax_kernel.launches,
                       kde_argmax_kernel.wide_launches,
                       kde_argmax_kernel.xwide_launches))
    # the CPU's eager first call launches nothing
    assert counts == [(0, 0, 0, 0), (2, 1, 1, 0), (4, 2, 2, 0), (6, 3, 3, 0)]
    assert graphed.programs(model)[0].launches == {
        (mobius_linear_kernel, "launches"): 2,
        (kde_argmax_kernel, "launches"): 1,
        (kde_argmax_kernel, "wide_launches"): 1}


def test_a_failing_capture_raises(monkeypatch, stand_in):
    """No fallback: the call that captures raises, the counters as they
    were."""

    class Failing(StandInGraph):
        def capture(self, body):
            mobius_linear_kernel.launches += 2
            raise RuntimeError("capture failed")

    monkeypatch.setattr(graphed, "_graph_factory", lambda device: Failing)
    monkeypatch.setattr(mobius_linear_kernel, "launches", 0)
    model = _small_model()
    X = _small_windows(40)
    _detect(model, X)
    with pytest.raises(RuntimeError, match="capture failed"):
        _detect(model, X)
    assert mobius_linear_kernel.launches == 0
    assert graphed.programs(model)[0].graph is None


def test_eager_withholds_the_programs(stand_in):
    """``graphed.eager`` (the measurements' eager side) makes and uses no
    program inside and leaves the programs as they were after."""
    model = _small_model()
    X = _small_windows(40)
    with graphed.eager():
        first = _detect(model, X)
        _detect(model, X)
    assert graphed.programs(model) == []
    for _ in range(2):
        _assert_same(_detect(model, X), first, "through the program")
    with graphed.eager():
        _assert_same(_detect(model, X), first, "eager again")
    assert stand_in["captures"] == 1 and graphed.programs(model)[0].calls == 2
