"""Where the time of one warm hyperbolic detect call goes, on a GPU.

    python3 -m hypad_tpu_torch.profile_detect [--windows 20000]

Two views of ``detect_scores(..., "mult", fetch_inference=False)`` at full
model width on a seeded synthetic signal:

* stages: each step of the call (upload, forwards, the two kernels, the
  critic pipeline, combination, download) run on its own and timed with
  CUDA events;
* trace: ``torch.profiler`` over warm calls, the kernels summed by device
  time, and the device's busy share of the wall time (the union of kernel
  and copy intervals over the span of the calls).

Prints one line per stage and per top kernel, then one JSON line; writes
the profiler's table and Chrome trace under ``chiprun_out/``. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from pathlib import Path

import torch

OUT_DIR = Path("chiprun_out")


def cuda_ms(fn, reps):
    """Device time of one ``fn()`` in ms: CUDA events around ``reps`` calls,
    enqueued behind a sleep kernel so that the host's launch cost leaves no
    gaps between them on the device (a call that synchronises the host
    keeps its own gaps)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device time to enqueue under
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stage_times(model, X, device, reps=20):
    """{stage: device ms} for the steps of one detect call, in order."""
    from hypad_tpu_torch.detect import scorer
    from hypad_tpu_torch.manifold import stereographic as st
    from hypad_tpu_torch.ops.kde_kernel import kde_argmax_kernel
    from hypad_tpu_torch.ops.unroll import masked_median

    n, width = X.shape
    smooth = max(math.trunc(n * 0.01), 1)
    with torch.inference_mode():
        Xt = torch.as_tensor(X, device=device)
        z = model["encoder"](Xt)
        critic = model["critic_x"](Xt)[:, 0]
        hyper, _ = model["decoder"](z)
        hyper_x = model["decoder"].hyperbolic_linear(Xt)
        rec = st.acosh_poincare_distance(hyper, hyper_x)
        vals, mask = scorer._critic_antidiag(critic, n, width)
        kde_val, use = kde_argmax_kernel(vals, mask)
        kde_max = torch.where(use, kde_val, masked_median(vals, mask))
        critic_scores = scorer._critic_scores_from_kde(kde_max, smooth)[:n]
        scores = scorer._combine_device("mult", critic_scores, rec, hyper)
        stages = {
            "upload windows (pageable H2D)":
                lambda: torch.as_tensor(X, device=device),
            "encoder (bi-LSTM, dense)": lambda: model["encoder"](Xt),
            "critic_x (5 dense)": lambda: model["critic_x"](Xt),
            "decoder (dense, 2 bi-LSTM, dense, K1 head)":
                lambda: model["decoder"](z),
            "hyper_x (K1)": lambda: model["decoder"].hyperbolic_linear(Xt),
            "acosh distance": lambda: st.acosh_poincare_distance(hyper,
                                                                 hyper_x),
            "anti-diagonal skew": lambda: scorer._critic_antidiag(critic, n,
                                                                  width),
            "KDE argmax (K2)": lambda: kde_argmax_kernel(vals, mask),
            "masked median (sort)": lambda: masked_median(vals, mask),
            "IQR mean, std, rolling mean":
                lambda: scorer._critic_scores_from_kde(kde_max, smooth),
            "combine (mult)": lambda: scorer._combine_device(
                "mult", critic_scores, rec, hyper),
            "download scores (D2H)": lambda: scores.cpu(),
        }
        return {name: cuda_ms(fn, reps) for name, fn in stages.items()}


def _busy_us(events):
    """Length of the union of [start, end] intervals, in us."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(events):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile_calls(call, calls, tag, chrome_trace=True):
    """Profile ``calls`` warm calls of ``call()``: (top kernels [(name,
    device ms per call, launches per call)], device busy share, wall ms per
    call). Writes ``chiprun_out/<tag>_profile.txt`` and, with
    ``chrome_trace``, ``<tag>_trace.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    OUT_DIR.mkdir(exist_ok=True)
    if chrome_trace:
        prof.export_chrome_trace(str(OUT_DIR / f"{tag}_trace.json"))
    (OUT_DIR / f"{tag}_profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    events = prof.events()
    device_events = [e for e in events if e.device_type == DeviceType.CUDA]
    cpu_events = [e for e in events if e.device_type == DeviceType.CPU]
    intervals = [(e.time_range.start, e.time_range.end)
                 for e in device_events]
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in cpu_events))
    busy_share = _busy_us(intervals) / span if span > 0 else float("nan")
    per_kernel = {}
    for e in device_events:
        ms, count = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    top = sorted(((name, ms / calls, count / calls)
                  for name, (ms, count) in per_kernel.items()),
                 key=lambda t: -t[1])
    return top, busy_share, wall_ms


def trace(model, X, device, calls=5):
    """:func:`profile_calls` over warm detect calls."""
    from hypad_tpu_torch.detect.scorer import detect_scores

    def call():
        return detect_scores(model, X, True, "mult", fetch_inference=False,
                             device=device)

    return profile_calls(call, calls, "detect")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--windows", type=int, default=20_000)
    args = parser.parse_args(argv)

    from hypad_tpu_torch._device import resolve_device
    from hypad_tpu_torch.data.pipeline import synthetic_detect_input
    from hypad_tpu_torch.detect.scorer import detect_scores
    from hypad_tpu_torch.models.tadgan import init_tadgan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device("cuda")
    X, _, _ = synthetic_detect_input(args.windows)
    model = init_tadgan(torch.Generator().manual_seed(0), X.shape[1],
                        hyperbolic=True, device=device)
    stages = stage_times(model, X, device)
    for name, ms in stages.items():
        print(f"[stage] {name}: {ms:.5f} ms")
    print(f"[stage] sum of stages: {sum(stages.values()):.5f} ms")
    top, busy_share, wall_ms = trace(model, X, device)
    for name, ms, count in top[:15]:
        print(f"[kernel] {ms:.5f} ms/call, {count:g} launches/call: "
              f"{name[:110]}")
    device_ms = sum(ms for _, ms, _ in top)
    print(f"[trace] wall {wall_ms:.5f} ms/call under the profiler, device "
          f"busy {busy_share:.4f} of it, device work {device_ms:.5f} "
          f"ms/call in {sum(c for _, _, c in top):g} launches")
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        detect_scores(model, X, True, "mult", fetch_inference=False,
                      device=device)
        walls.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "windows": args.windows,
        "wall_ms_median": statistics.median(walls), "wall_ms": walls,
        "stages_ms": stages, "busy_share_under_profiler": busy_share,
        "device_ms_per_call": device_ms,
        "top_kernels": [{"name": n, "ms": ms, "launches": c}
                        for n, ms, c in top[:15]]}))


if __name__ == "__main__":
    main()
