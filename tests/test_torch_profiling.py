"""hypad_tpu_torch.utils.profiling's ``trace`` and ``annotate`` on the CPU:
the trace file is written into the directory and names the annotated
region and the ops inside it. (On the card the same trace also holds the
kernels: tests/test_torch_cuda.py.)"""

import json
import os

import pytest
import torch

from hypad_tpu_torch.utils.profiling import annotate, trace


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs in several worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trace_writes_a_chrome_trace_naming_the_annotation(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with trace(logdir) as d:
        assert d == logdir
        with annotate("hypad_region"):
            y = x @ x
    assert y.shape == (64, 64)
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "hypad_region" in names
    assert any(n and "mm" in n for n in names), sorted(filter(None, names))
    # a second trace into the same directory keeps the first
    with trace(logdir):
        torch.ones(3).sum()
    assert len([f for f in os.listdir(logdir) if f.endswith(".json")]) == 2
