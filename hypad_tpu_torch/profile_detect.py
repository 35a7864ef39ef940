"""Where the time of one warm detect call goes, on a GPU.

    python3 -m hypad_tpu_torch.profile_detect [--windows 20000]
        [--rec-error point|area|dtw] [--kde-version v1|v2]

Two views of ``detect_scores(..., "mult", fetch_inference=False)`` at full
model width on a seeded synthetic signal, hyperbolic by default or, with
``--rec-error``, Euclidean with that reconstruction error:

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


def stage_times(model, X, device, reps=20, kde_version="v1"):
    """{stage: device ms} for the steps of one hyperbolic detect call, in
    order."""
    from hypad_tpu_torch.detect import scorer
    from hypad_tpu_torch.manifold import stereographic as st

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
        kde_max, kde_stages = _kde_stages(kde_version, vals, mask)
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
            **kde_stages,
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


def _kde_stages(kde_version, vals, mask):
    """(kde_max, {stage: fn}) of the KDE step: K2 ("v1") or K3 ("v2"), each
    of which takes the median fallback inside."""
    from hypad_tpu_torch.ops import kde_kernel

    kernel = (kde_kernel.kde_argmax_kernel if kde_version == "v1"
              else kde_kernel.kde_argmax_v2_kernel)
    name = "K2" if kde_version == "v1" else "K3"
    return kernel(vals, mask)[0], {
        f"KDE argmax and median fallback ({name}, one launch)":
            lambda: kernel(vals, mask)}


def eucl_stage_times(model, X, device, rec_error, kde_version="v2",
                     reps=20):
    """{stage: device ms} for the steps of one Euclidean detect call, in
    order."""
    from hypad_tpu_torch.detect import scorer
    from hypad_tpu_torch.ops.dtw import dtw_errors
    from hypad_tpu_torch.ops.rolling import (
        rolling_mean_centered,
        rolling_trapz_centered,
        zscore,
    )
    from hypad_tpu_torch.ops.unroll import true_series, unroll_median

    n, width = X.shape
    smooth = max(math.trunc(n * 0.01), 1)
    raw_error = {
        "point": lambda t, p: (t - p).abs(),
        "area": lambda t, p: (rolling_trapz_centered(t, 10, 5)
                              - rolling_trapz_centered(p, 10, 5)).abs(),
        "dtw": lambda t, p: dtw_errors(t, p, 10)}[rec_error]
    with torch.inference_mode():
        Xt = torch.as_tensor(X, device=device)
        z = model["encoder"](Xt)
        critic = model["critic_x"](Xt)[:, 0]
        recon = model["decoder"](z)
        true, pred = true_series(Xt), unroll_median(recon)
        errors = raw_error(true, pred)
        smoothed = rolling_mean_centered(errors, smooth, max(smooth // 2, 1))
        rec = zscore(smoothed).clamp_min(0.0) + 1.0
        vals, mask = scorer._critic_antidiag(critic, n, width)
        kde_max, kde_stages = _kde_stages(kde_version, vals, mask)
        critic_scores = scorer._critic_scores_from_kde(kde_max, smooth)
        scores = critic_scores * rec
        stages = {
            "upload windows (pageable H2D)":
                lambda: torch.as_tensor(X, device=device),
            "encoder (bi-LSTM, dense)": lambda: model["encoder"](Xt),
            "critic_x (5 dense)": lambda: model["critic_x"](Xt),
            "decoder (dense, 2 bi-LSTM, dense)": lambda: model["decoder"](z),
            "true series, median unroll (sort)":
                lambda: (true_series(Xt), unroll_median(recon)),
            f"{rec_error} error": lambda: raw_error(true, pred),
            "error rolling mean, z-score":
                lambda: zscore(rolling_mean_centered(
                    errors, smooth, max(smooth // 2, 1))).clamp_min(0.0),
            "anti-diagonal skew": lambda: scorer._critic_antidiag(critic, n,
                                                                  width),
            **kde_stages,
            "IQR mean, std, rolling mean":
                lambda: scorer._critic_scores_from_kde(kde_max, smooth),
            "combine (mult)": lambda: critic_scores * rec,
            "download scores (D2H)": lambda: scores.cpu(),
        }
        return {name: cuda_ms(fn, reps) for name, fn in stages.items()}


def trace(model, X, device, calls=5, hyperbolic=True, rec_error="point",
          kde_version="v1"):
    """:func:`profile_calls` over warm detect calls."""
    from hypad_tpu_torch.detect.scorer import detect_scores

    def call():
        return detect_scores(model, X, hyperbolic, "mult",
                             rec_error=rec_error, fetch_inference=False,
                             kde_version=kde_version, device=device)

    tag = "detect" if hyperbolic else f"detect_euclidean_{rec_error}"
    return profile_calls(call, calls, tag)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--windows", type=int, default=20_000)
    parser.add_argument("--rec-error", choices=("point", "area", "dtw"),
                        help="profile the Euclidean detector with this "
                             "reconstruction error (default: hyperbolic)")
    parser.add_argument("--kde-version", choices=("v1", "v2"),
                        help="KDE kernel: v1 (K2, the hyperbolic default) "
                             "or v2 (K3, the Euclidean default here)")
    args = parser.parse_args(argv)
    hyperbolic = args.rec_error is None
    kde_version = args.kde_version or ("v1" if hyperbolic else "v2")

    from hypad_tpu_torch._device import resolve_device
    from hypad_tpu_torch.data.pipeline import synthetic_detect_input
    from hypad_tpu_torch.detect.scorer import detect_scores
    from hypad_tpu_torch.models.tadgan import init_tadgan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device("cuda")
    X, _, _ = synthetic_detect_input(args.windows)
    model = init_tadgan(torch.Generator().manual_seed(0), X.shape[1],
                        hyperbolic=hyperbolic, device=device)
    if hyperbolic:
        stages = stage_times(model, X, device, kde_version=kde_version)
    else:
        stages = eucl_stage_times(model, X, device, args.rec_error,
                                  kde_version)
    for name, ms in stages.items():
        print(f"[stage] {name}: {ms:.5f} ms")
    print(f"[stage] sum of stages: {sum(stages.values()):.5f} ms")
    top, busy_share, wall_ms = trace(model, X, device, hyperbolic=hyperbolic,
                                     rec_error=args.rec_error or "point",
                                     kde_version=kde_version)
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
        detect_scores(model, X, hyperbolic, "mult",
                      rec_error=args.rec_error or "point",
                      fetch_inference=False, kde_version=kde_version,
                      device=device)
        walls.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "windows": args.windows,
        "hyperbolic": hyperbolic, "rec_error": args.rec_error,
        "kde_version": kde_version,
        "wall_ms_median": statistics.median(walls), "wall_ms": walls,
        "stages_ms": stages, "busy_share_under_profiler": busy_share,
        "device_ms_per_call": device_ms,
        "launches_per_call": sum(c for _, _, c in top),
        "top_kernels": [{"name": n, "ms": ms, "launches": c}
                        for n, ms, c in top[:15]]}))


if __name__ == "__main__":
    main()
