"""Port parity: data parallelism over a device mesh
(hypad_tpu_torch.parallel.mesh, the sharded scoring of detect/scorer.py and
detect/detector.py, the sharded KDE and data-parallel training) against
the JAX package on its 8 virtual CPU devices (the root conftest.py) and
against the port unsharded, on the CPU.

The port's mesh is ``[cpu] * 8``, 1-D and shaped (4, 2) with a ``dp``
axis: the same device repeated, each entry a shard of its own (the port's
counterpart of JAX's virtual devices). The cases are JAX's
tests/test_sharded_scoring.py at its sizes (403 windows, uneven shards),
held at its tolerance (rtol 3e-4, atol 3e-5, the sharded reductions'
reassociation); one data-parallel epoch is held at
tests/test_trainer.py's (losses 1e-4 / 1e-5, parameters 5e-3 / 5e-4)."""

import functools
import inspect
from types import SimpleNamespace

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from hypad_tpu.data.pipeline import SignalData as JSignalData
from hypad_tpu.detect import detector as jdet
from hypad_tpu.detect import scorer as jsc
from hypad_tpu.models import tadgan as jt
from hypad_tpu.parallel import mesh as jmesh
from hypad_tpu.train import trainer as jtr
from hypad_tpu_torch import bridge
from hypad_tpu_torch.data.pipeline import SignalData
from hypad_tpu_torch.detect import detector as tdet
from hypad_tpu_torch.detect import scorer as tsc
from hypad_tpu_torch.ops import kde_kernel as kk
from hypad_tpu_torch.parallel import mesh as tmesh
from hypad_tpu_torch.train import trainer as ttr

SHARD_TOL = dict(rtol=3e-4, atol=3e-5)   # tests/test_sharded_scoring.py
CPU = torch.device("cpu")
MESHES = ["1d", "2d"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(kind):
    if kind == "1d":
        return tmesh.make_mesh([CPU] * 8)
    return tmesh.make_mesh([CPU] * 8, shape=(4, 2), axis_names=("dp", "mp"))


@functools.cache
def _jmesh():
    m = jmesh.make_mesh("all")
    assert m is not None and m.devices.size == 8
    return m


@functools.cache
def _data():
    rng = np.random.default_rng(0)
    n, w = 403, 100   # not a multiple of 8: uneven shards
    X = rng.uniform(-1, 1, (n, w)).astype(np.float32)
    critic = rng.standard_normal(n).astype(np.float32)
    y_hat = X + 0.1 * np.random.default_rng(1).standard_normal(
        X.shape).astype(np.float32)
    return X, critic, y_hat


@functools.cache
def _params(hyperbolic):
    return jax.tree_util.tree_map(np.asarray, jt.init_tadgan(
        jax.random.PRNGKey(0), signal_shape=100, hyperbolic=hyperbolic))


def _model(hyperbolic):
    return bridge.from_jax_params(_params(hyperbolic), device="cpu")


def test_make_mesh_and_batch_multiple_match_jax():
    """JAX's semantics: None for one device, "all" and an int count the
    platform's devices (truncating), an explicit list is the mesh (here
    the CPU repeated, as JAX's 8 virtual devices), ``shape`` names the
    axes dp, mp and raises when too few devices; ``batch_multiple`` rounds
    down to a multiple of the device count, at least that count."""
    jd = jax.devices()
    assert jmesh.make_mesh(jd[:1]) is None
    assert tmesh.make_mesh([CPU]) is None
    assert tmesh.make_mesh("all", platform="cpu") is None
    assert tmesh.make_mesh(4, platform="cpu") is None
    for n in (2, 3, 8):
        j, t = jmesh.make_mesh(jd[:n]), tmesh.make_mesh([CPU] * n)
        assert dict(j.shape) == t.shape and j.axis_names == t.axis_names
        assert j.devices.size == t.size == n
        for bs in (1, 5, 16, 30, 64, 100):
            assert (jmesh.batch_multiple(bs, j)
                    == tmesh.batch_multiple(bs, t)), (n, bs)
    assert jmesh.batch_multiple(30, None) == tmesh.batch_multiple(30, None)
    j2 = jmesh.make_mesh(jd, shape=(4, 2))
    t2 = tmesh.make_mesh([CPU] * 8, shape=(4, 2))
    assert dict(j2.shape) == t2.shape == {"dp": 4, "mp": 2}
    assert len(tmesh.dp_devices(t2)) == 4
    for make, devs in ((jmesh.make_mesh, jd), (tmesh.make_mesh, [CPU] * 8)):
        with pytest.raises(ValueError, match="needs 16 devices"):
            make(devs, shape=(4, 4))
    assert tmesh.row_slices(403, 8)[-1][1] == slice(357, 403)
    assert [i for i, _ in tmesh.row_slices(3, 8)] == [0, 1, 2]


def test_shard_leading_splits_every_leaf_over_dp():
    """``shard_leading`` (JAX's signal-axis constraint, here the split
    itself): every leaf's leading axis in the mesh's contiguous ``dp``
    slabs, on each slab's device, the slabs concatenating to the tree;
    without a mesh, the whole tree in one shard."""
    tree = {"a": torch.arange(10.0), "b": (torch.ones(10, 3),
                                           torch.zeros(10, 2, 2))}
    for kind in MESHES:
        mesh = _mesh(kind)
        shards = tmesh.shard_leading(mesh)(tree)
        assert [sl for _, sl, _ in shards] == [
            sl for _, sl in tmesh.row_slices(10, len(tmesh.dp_devices(mesh)))]
        assert torch.equal(torch.cat([t["a"] for _, _, t in shards]),
                           tree["a"])
        for dev, sl, t in shards:
            assert dev == CPU and torch.equal(t["b"][1],
                                              tree["b"][1][sl])
    ((dev, sl, t),) = tmesh.shard_leading(None)(tree)
    assert dev is None and sl == slice(0, 10) and t is tree


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("kind", MESHES)
def test_sharded_kde_is_the_unsharded_kde_bitwise(kind, version):
    """``kde_argmax_rows_sharded`` (one launch a slab) equals the unsharded
    call row for row, ties included: JAX's sharded-KDE case (T = 101 rows
    of 40, uneven) and the 403-window detect shape."""
    rng = np.random.default_rng(7)
    T, W = 101, 40
    vals = torch.as_tensor(rng.standard_normal((T, W)), dtype=torch.float32)
    i, j = torch.arange(T)[:, None], torch.arange(W)[None, :]
    mask = (j <= (i % W)) | (j < 3)
    X, critic, _ = _data()
    from hypad_tpu_torch.ops.unroll import antidiagonal_gather

    v2, m2 = antidiagonal_gather(
        torch.as_tensor(critic)[:, None].expand(len(critic), 100))
    for v, m in ((vals, mask), (v2, m2)):
        want = kk.kde_argmax_rows_fused(v, m, version)
        got = kk.kde_argmax_rows_sharded(v, m, _mesh(kind), version)
        assert torch.equal(got, want)


@functools.cache
def _jax_sharded(hyperbolic):
    """JAX's mesh results on the shared inputs, computed once."""
    X, critic, y_hat = _data()
    mesh = _jmesh()
    params = jt.init_tadgan(jax.random.PRNGKey(0), signal_shape=100,
                            hyperbolic=hyperbolic)
    out = {"inference": jsc.run_inference(params, X, hyperbolic, mesh=mesh)}
    if hyperbolic:
        out["critic"] = jsc.final_critic_scores(critic, X, mesh=mesh)
        out["hyper"] = jsc.score_anomalies_hyperbolic(
            out["inference"], "uncertainty", mesh=mesh)
    else:
        out["eucl"] = jsc.score_anomalies_euclidean(
            X, y_hat, critic, "point", "mult", mesh=mesh)
        for re_ in ("point", "area", "dtw"):
            out[re_] = jsc.reconstruction_errors(X, y_hat, re_, mesh=mesh)
    return out


@pytest.mark.parametrize("hyperbolic", [True, False])
def test_sharded_inference_matches_single_and_jax(hyperbolic):
    """Both port meshes against the port unsharded and JAX's mesh (one JAX
    program a geometry, shared by the cases of a worker)."""
    X, _, _ = _data()
    model = _model(hyperbolic)
    single = tsc.run_inference(model, X, hyperbolic, device="cpu")
    jax_mesh = _jax_sharded(hyperbolic)["inference"]
    for kind in MESHES:
        sharded = tsc.run_inference(model, X, hyperbolic, mesh=_mesh(kind))
        for a, b, c in zip(single, sharded, jax_mesh):
            assert (a is None) == (b is None) == (c is None)
            if a is not None:
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(b, c, rtol=1e-5, atol=1e-6)


def test_sharded_critic_scores_match():
    X, critic, _ = _data()
    single = tsc.final_critic_scores(critic, X, device="cpu")
    for kind in MESHES:
        sharded = tsc.final_critic_scores(critic, X, mesh=_mesh(kind))
        np.testing.assert_allclose(sharded, single, **SHARD_TOL)
        np.testing.assert_allclose(sharded, _jax_sharded(True)["critic"],
                                   **SHARD_TOL)


@pytest.mark.parametrize("rec_error", ["point", "area", "dtw"])
def test_sharded_reconstruction_errors_match(rec_error):
    X, _, y_hat = _data()
    e1, p1 = tsc.reconstruction_errors(X, y_hat, rec_error, device="cpu")
    e2, p2 = tsc.reconstruction_errors(X, y_hat, rec_error,
                                       mesh=_mesh("1d"))
    je, jp = _jax_sharded(False)[rec_error]
    np.testing.assert_allclose(p2, p1, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(e2, e1, **SHARD_TOL)
    np.testing.assert_allclose(p2, jp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(e2, je, **SHARD_TOL)


def test_sharded_euclidean_scoring_matches():
    X, critic, y_hat = _data()
    s1 = tsc.score_anomalies_euclidean(X, y_hat, critic, "point", "mult",
                                       device="cpu")
    for kind in MESHES:
        s2 = tsc.score_anomalies_euclidean(X, y_hat, critic, "point", "mult",
                                           mesh=_mesh(kind))
        np.testing.assert_allclose(s2, s1, **SHARD_TOL)
        np.testing.assert_allclose(s2, _jax_sharded(False)["eucl"],
                                   **SHARD_TOL)


def test_sharded_hyperbolic_scoring_matches():
    inf = _jax_sharded(True)["inference"]
    s1 = tsc.score_anomalies_hyperbolic(inf, "uncertainty", device="cpu")
    w1 = tsc.hyperbolic_window_scores(inf.recons_signal, inf.true_signal,
                                      device="cpu")
    for kind in MESHES:
        s2 = tsc.score_anomalies_hyperbolic(inf, "uncertainty",
                                            mesh=_mesh(kind))
        np.testing.assert_allclose(s2, s1, **SHARD_TOL)
        np.testing.assert_allclose(s2, _jax_sharded(True)["hyper"],
                                   **SHARD_TOL)
        w2 = tsc.hyperbolic_window_scores(inf.recons_signal,
                                          inf.true_signal, mesh=_mesh(kind))
        np.testing.assert_array_equal(w2, w1)


@pytest.mark.parametrize("multivariate", [False, True])
def test_sharded_detect_scores_and_grid_match_single(multivariate):
    """``detect_scores`` (hyperbolic; Euclidean dtw under K3's plain
    version) and ``detect_scores_grid`` on a mesh against the unsharded
    calls; the staged path (above a lowered one-call limit) too."""
    X, _, _ = _data()
    mesh = _mesh("1d")
    for hyperbolic in (True, False):
        model = _model(hyperbolic)
        kw = dict(rec_error="dtw", kde_version="v2",
                  multivariate=multivariate, fetch_inference=False)
        s1, _ = tsc.detect_scores(model, X, hyperbolic, "mult",
                                  device="cpu", **kw)
        s2, _ = tsc.detect_scores(model, X, hyperbolic, "mult", mesh=mesh,
                                  **kw)
        np.testing.assert_allclose(s2, s1, **SHARD_TOL)
        combos = ["mult", "rec"]
        g1 = tsc.detect_scores_grid(model, X, hyperbolic, combos,
                                    ["point", "dtw"], device="cpu",
                                    multivariate=multivariate)
        g2 = tsc.detect_scores_grid(model, X, hyperbolic, combos,
                                    ["point", "dtw"], mesh=mesh,
                                    multivariate=multivariate)
        assert list(g1) == list(g2)
        for cell in g1:
            np.testing.assert_allclose(g2[cell], g1[cell], **SHARD_TOL)


def test_sharded_staged_path_matches_one_call(monkeypatch):
    X, _, _ = _data()
    model = _model(True)
    mesh = _mesh("1d")
    one, _ = tsc.detect_scores(model, X, True, "mult", mesh=mesh,
                               fetch_inference=False)
    monkeypatch.setattr(tsc, "ONE_CALL_MAX_WINDOWS", 100)
    staged, inf = tsc.detect_scores(model, X, True, "mult", mesh=mesh)
    np.testing.assert_allclose(staged, one, **SHARD_TOL)
    inf = tsc.stage_inference(inf, mesh=mesh)
    np.testing.assert_array_equal(
        tsc.score_anomalies_hyperbolic(inf, "mult", mesh=mesh), staged)


def test_sharded_detect_end_to_end_matches(tmp_path):
    """The detector on a mesh against the port unsharded and JAX's on its
    mesh (tests/test_sharded_scoring.py's case): same intervals and
    confusion; ``detect_grid`` on the mesh too."""
    X, _, _ = _data()
    n, w = X.shape
    arrays = dict(X=X, y=np.zeros((n, 1), np.float32),
                  X_index=np.arange(n, dtype=np.float64),
                  y_index=np.arange(n, dtype=np.float64) + w,
                  index=np.arange(n + w, dtype=np.float64))
    params = SimpleNamespace(signal="sig", dataset="NAB", hyperbolic=True,
                             combination="uncertainty", rec_error="point",
                             load=False, save_result=False)
    known = np.array([[50.0, 80.0]])
    model = _model(True)
    r1 = tdet.detect(params, model, SignalData(**arrays),
                     str(tmp_path / "single"), known_anomalies=known,
                     device="cpu")
    r2 = tdet.detect(params, model, SignalData(**arrays),
                     str(tmp_path / "sharded"), known_anomalies=known,
                     mesh=_mesh("1d"))
    rj = jdet.detect(params, jt.init_tadgan(jax.random.PRNGKey(0),
                                            signal_shape=w, hyperbolic=True),
                     JSignalData(**arrays), str(tmp_path / "jax"),
                     known_anomalies=pd.DataFrame({"start": [50.0],
                                                   "end": [80.0]}),
                     mesh=_jmesh())
    for other in (r1, rj):
        np.testing.assert_allclose(r2["scores"], other["scores"],
                                   **SHARD_TOL)
        assert [tuple(i[:2]) for i in r2["intervals"]] == \
            [tuple(i[:2]) for i in other["intervals"]]
        assert list(r2["confusion"]) == list(other["confusion"])
    g = tdet.detect_grid(params, model, SignalData(**arrays),
                         str(tmp_path / "grid"), combinations=["mult"],
                         known_anomalies=known, mesh=_mesh("2d"))
    g1 = tdet.detect_grid(params, model, SignalData(**arrays),
                          str(tmp_path / "grid1"), combinations=["mult"],
                          known_anomalies=known, device="cpu")
    assert [tuple(i[:2]) for i in g[(None, "mult")]["intervals"]] == \
        [tuple(i[:2]) for i in g1[(None, "mult")]["intervals"]]


N_DP, B_DP, LR_DP = 128, 32, 5e-4


@functools.cache
def _jax_dp_epoch():
    """(initial params, X, key, JAX state after one epoch on its 8-device
    mesh, its metrics): tests/test_trainer.py's dp epoch at 128 windows,
    batch 32."""
    kp, kx, ke = jax.random.split(jax.random.PRNGKey(5), 3)
    params = jt.init_tadgan(kp, 100, hyperbolic=True)
    X = np.asarray(jax.random.uniform(kx, (N_DP, 100), minval=-1.0,
                                      maxval=1.0), np.float32)
    state0 = jtr.init_train_state(params, lr=LR_DP, hyperbolic=True)
    fn = jtr.build_epoch_fn(LR_DP, True, B_DP, mesh=_jmesh())
    state1, metrics = fn(jax.tree_util.tree_map(jax.numpy.copy, state0),
                         X, ke)
    return (jax.tree_util.tree_map(np.asarray, params), X, ke,
            jax.tree_util.tree_map(np.asarray, state1),
            {k: float(v) for k, v in metrics.items()})


def test_dp_epoch_matches_unsharded_and_jax_mesh():
    """One data-parallel epoch (JAX's draws injected) on each port mesh
    against the port unsharded and against JAX's epoch on its 8-device
    mesh (one JAX program), at tests/test_trainer.py's tolerances; the
    step counters equal."""
    from tests.test_torch_train import _jax_epoch_draws

    params, X, key, want, jmetrics = _jax_dp_epoch()
    draws = _jax_epoch_draws(key, N_DP, B_DP)
    out = {}
    for label, mesh in (("single", None), ("1d", _mesh("1d")),
                        ("2d", _mesh("2d"))):
        model = bridge.from_jax_params(params, device="cpu")
        state = ttr.init_train_state(model, LR_DP, True)
        state, metrics = ttr.run_epoch(state, torch.from_numpy(X.copy()),
                                       draws, lr=LR_DP, hyperbolic=True,
                                       mesh=mesh)
        out[label] = (model.state_dict(), metrics, state)
    p1, m1, _ = out["single"]
    for kind in MESHES:
        p2, m2, state = out[kind]
        for name in m1:
            np.testing.assert_allclose(m2[name], m1[name], rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(m2[name], jmetrics[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
        for k in p1:
            torch.testing.assert_close(p2[k], p1[k], rtol=5e-3, atol=5e-4)
        got = {k.replace(".", "/"): v.detach().numpy()
               for k, v in p2.items()}
        for k, v in bridge.flatten_tree(want.params).items():
            np.testing.assert_allclose(got[k], v, rtol=5e-3, atol=5e-4,
                                       err_msg=k)
        assert (state.opt_cx.step, state.opt_gen.step) == (
            int(want.opt_cx.step), int(want.opt_gen.step))


@pytest.mark.parametrize("fused", ["full", True])
def test_fused_critics_on_a_mesh_raise_as_jax(fused):
    """A truthy ``fused_critics`` on a mesh of more than one device raises
    JAX's ValueError before anything runs (train_tadgan, run_epoch,
    train_fleet); a one-device mesh is None and trains."""
    mesh = _mesh("1d")
    with pytest.raises(ValueError) as jerr:
        jtr.build_epoch_fn(LR_DP, True, B_DP, mesh=_jmesh(),
                           fused_critics=fused)
    model = _model(True)
    X = np.zeros((64, 100), np.float32)
    with pytest.raises(ValueError) as err:
        ttr.train_tadgan(model, X, lr=LR_DP, hyperbolic=True, batch_size=32,
                         n_epochs=1, mesh=mesh, fused_critics=fused)
    assert str(err.value) == str(jerr.value)
    from hypad_tpu_torch.train import fleet as tfl

    with pytest.raises(ValueError, match="single-device path"):
        tfl.train_fleet(None, [X], lr=LR_DP, hyperbolic=True, batch_size=32,
                        n_epochs=1, mesh=mesh, fused_critics=fused)
    assert tmesh.make_mesh([CPU]) is None


def test_every_jax_mesh_canonical_and_engine_parameter_is_ported():
    """Every public JAX function of the ported modules that takes
    ``mesh``, ``canonical`` or ``engine`` has it in the port, with JAX's
    default."""
    import importlib

    pairs = [("detect.scorer", ("run_inference", "final_critic_scores",
                                "reconstruction_errors", "stage_inference",
                                "score_anomalies_euclidean",
                                "hyperbolic_window_scores",
                                "score_anomalies_hyperbolic",
                                "score_anomalies_multivariate",
                                "detect_scores", "detect_scores_grid",
                                "detect_scores_fleet",
                                "detect_scores_fleet_grid")),
             ("detect.detector", ("detect", "detect_grid")),
             ("train.trainer", ("train_tadgan",)),
             ("train.fleet", ("train_fleet",)),
             ("data.pipeline", ("load_signal_dataset",)),
             ("parallel.mesh", ("make_mesh", "shard_leading",
                                "batch_multiple"))]
    for mod, names in pairs:
        jm = importlib.import_module(f"hypad_tpu.{mod}")
        tm = importlib.import_module(f"hypad_tpu_torch.{mod}")
        for name in names:
            jp = inspect.signature(getattr(jm, name)).parameters
            tp = inspect.signature(getattr(tm, name)).parameters
            for key in ("mesh", "canonical", "engine"):
                if key in jp:
                    assert key in tp, f"{mod}.{name} lacks {key}"
                    assert tp[key].default == jp[key].default, (name, key)
