"""Port parity: hypad_tpu_torch.utils.plotting against the JAX package's
plots, on the CPU with matplotlib's Agg backend.

The files each package writes from the same inputs decode
(``matplotlib.image.imread``) to the same pixels; JAX gets DataFrames made
from the arrays the port takes. The figures returned without a file carry
the same line data and span extents."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from hypad_tpu.utils import plotting as jpl  # noqa: E402
from hypad_tpu_torch.utils import plotting as tpl  # noqa: E402

T0 = 1_400_000_000
DAY = 86_400


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signal(n=240, seed=0):
    rng = np.random.default_rng(seed)
    index = T0 + DAY * np.arange(n)
    series = np.sin(np.arange(n) / 7.0) + 0.1 * rng.standard_normal(n)
    pred = np.array([[index[20], index[35], 1.3], [index[150], index[160],
                                                    0.7]])
    known = np.array([[index[30], index[40]], [index[200], index[210]]])
    return index, series, pred, known


def _frame(intervals, columns=("start", "end", "score")):
    return pd.DataFrame(np.asarray(intervals),
                        columns=list(columns)[:np.shape(intervals)[1]])


def _same_pixels(a, b):
    pa, pb = mpimg.imread(a), mpimg.imread(b)
    assert pa.shape == pb.shape
    np.testing.assert_array_equal(pa, pb)


def _figure_data(fig):
    """Each axes' title, x limits, lines' data and spans' extents."""
    out = []
    for ax in fig.axes:
        spans = [p.get_extents().bounds for p in ax.patches]
        out.append((ax.get_title(), ax.get_xlim(), ax.get_ylim(),
                    [line.get_xydata().tolist() for line in ax.get_lines()],
                    [line.get_color() for line in ax.get_lines()], spans))
    return out


@pytest.mark.parametrize("known_as", ["array", "frame", "none"])
def test_plot_anomaly_intervals_pixels_equal_jax(tmp_path, known_as):
    """Interval arrays (the detector's) against JAX's DataFrames: the same
    PNG. The port takes DataFrames too; an empty interval array (no
    prediction) draws no span."""
    index, series, pred, known = _signal()
    frames = [pred] + {"array": [known], "frame": [_frame(known,
                                                          ("start", "end"))],
                       "none": []}[known_as]
    got = tpl.plot_anomaly_intervals(frames, index, series,
                                     str(tmp_path / "port"))
    want = jpl.plot_anomaly_intervals(
        [_frame(pred)] + ([_frame(known, ("start", "end"))]
                          if known_as != "none" else []),
        index, series, str(tmp_path / "jax"))
    assert got.endswith("anomalies.png")
    _same_pixels(got, want)
    empty = tpl.plot_anomaly_intervals([np.array([])], index, series,
                                       str(tmp_path / "empty"))
    _same_pixels(empty, jpl.plot_anomaly_intervals(
        [pd.DataFrame(columns=["start", "end"])], index, series,
        str(tmp_path / "jax_empty")))


def test_plot_signal_with_anomalies_pixels_equal_jax(tmp_path):
    """A {"timestamp", "value"} table and interval arrays against JAX's
    DataFrames (several signals, predicted and known spans; and a list of
    (start, end) pairs, as JAX takes lists): the same JPEG."""
    index, series, pred, known = _signal()
    table = {"timestamp": index, "value": series}
    twice = {"timestamp": index, "value": 0.5 * series}
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = tpl.plot_signal_with_anomalies([table, twice], [pred, known],
                                         signal="s", path=str(tmp_path /
                                                              "port"))
    want = jpl.plot_signal_with_anomalies(
        [pd.DataFrame(table), pd.DataFrame(twice)],
        [_frame(pred), _frame(known, ("start", "end"))], signal="s",
        path=str(tmp_path / "jax"))
    assert got.endswith("anomalies.jpg")
    _same_pixels(got, want)
    pairs = [[(int(a), int(b)) for a, b in known]]
    got = tpl.plot_signal_with_anomalies(table, pairs,
                                         path=str(tmp_path / "port"))
    want = jpl.plot_signal_with_anomalies(pd.DataFrame(table), pairs,
                                          path=str(tmp_path / "jax"))
    _same_pixels(got, want)


def test_plot_ts_error_and_rolling_windows_figures_equal_jax(tmp_path):
    _, series, _, _ = _signal()
    X = np.stack([np.tanh(series[i:i + 50]) for i in range(180)])
    cases = [
        ("plot_ts", ([series, series * 0.5],), dict(labels=["a", "b"])),
        ("plot_ts", (series,), dict(title="one")),
        ("plot_error", ([(series, series * 0.9), np.abs(series) * 0.1],),
         {}),
        ("plot_rolling_windows", (X,), dict(window=50, k=7)),
    ]
    for name, args, kw in cases:
        got = getattr(tpl, name)(*args, **kw,
                                 out_path=str(tmp_path / f"p_{name}.png"))
        want = getattr(jpl, name)(*args, **kw,
                                  out_path=str(tmp_path / f"j_{name}.png"))
        assert _figure_data(got) == _figure_data(want), name
        _same_pixels(tmp_path / f"p_{name}.png", tmp_path / f"j_{name}.png")


@pytest.mark.parametrize("N,W", [(40, 10), (300, 100), (7, 1)])
def test_unroll_ts_matches_jax_exactly(N, W):
    rng = np.random.default_rng(N)
    y_hat = rng.standard_normal((N, W))
    got = tpl.unroll_ts(y_hat, device="cpu")
    want = jpl.unroll_ts(y_hat)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
