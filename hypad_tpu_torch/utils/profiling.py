"""Wall-clock stages, device traces and the per-epoch metric log.

Port of ``hypad_tpu.utils.profiling`` ``stage``, ``stage_stats``,
``reset_stages``, ``report``, ``trace``, ``annotate`` and
``MetricsLogger``, with the same stdout lines and JSONL rows. ``stage``
reads the host clock: a stage around device work is only as long as that
work when the code inside it waits for the device (the CLI's train and
detect stages do, by reading their results). ``trace`` records the block
with ``torch.profiler`` (host and, where a card is present, its kernels)
and writes a Chrome trace JSON; ``annotate`` labels a region on it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

# the process-wide registry, as in the JAX package: the CLI's stages and
# ``report()`` share it
_STAGES = defaultdict(lambda: {"count": 0, "total": 0.0})


@contextlib.contextmanager
def stage(name):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s = _STAGES[name]
        s["count"] += 1
        s["total"] += time.perf_counter() - t0


def stage_stats():
    return {k: dict(v, mean=v["total"] / max(v["count"], 1))
            for k, v in _STAGES.items()}


def reset_stages():
    _STAGES.clear()


def report():
    lines = ["stage                          count    total(s)    mean(s)"]
    for name, s in sorted(stage_stats().items(),
                          key=lambda kv: -kv[1]["total"]):
        lines.append(f"{name:<30} {s['count']:>5} {s['total']:>11.3f} "
                     f"{s['mean']:>10.4f}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir):
    """Record the block with ``torch.profiler``: CPU activity, and CUDA
    activity (every kernel on the card) when a card is present. On exit
    the Chrome trace JSON (``chrome://tracing``, Perfetto) is written into
    ``logdir`` as ``trace_{pid}_{ns}.json``; yields ``logdir``, as JAX's
    ``trace`` does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name):
    """Label a region on the trace's timeline (a context manager)."""
    import torch

    return torch.profiler.record_function(name)


class MetricsLogger:
    """Per-epoch metric sink: keeps the history, appends one JSON row per
    epoch to ``path`` if given, and prints the reference's epoch lines when
    ``echo``."""

    def __init__(self, path=None, echo=True, hyperbolic=False):
        self.history = []
        self.path = path
        self.echo = echo
        self.hyperbolic = hyperbolic
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def __call__(self, epoch, metrics):
        row = {"epoch": int(epoch),
               **{k: float(v) for k, v in metrics.items()}}
        self.history.append(row)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        if self.echo:
            rec = ("Hyperbolic loss" if self.hyperbolic else "Eucl mse loss")
            print(f"Encoder decoder training done in epoch {epoch - 1}")
            print(f"{rec} {row['rec_loss']:.6f}")
            print(f"critic x loss {row['critic_x_loss']:.3f} "
                  f"critic z loss {row['critic_z_loss']:.3f} \n"
                  f"decoder loss {row['decoder_loss']:.3f}\n")
