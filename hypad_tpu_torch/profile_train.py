"""Where the time of one warm training epoch goes, on a GPU.

    python3 -m hypad_tpu_torch.profile_train [--fused-critics full|true|false]

The A1-sized input of ``chip_smoke.py`` (a 1,420-sample synthetic signal,
1,320 windows of 100, batch 64: 100 critic steps and 20 generator steps an
epoch) through the hyperbolic trainer at the published widths, weights from
seed 0. Two views of a warm epoch:

* phases: the epoch's draws (made on the CPU and copied to the card), the
  critic passes and the generator pass, each timed on the host clock up to
  a synchronise;
* trace: ``torch.profiler`` over warm epochs, the kernels summed by device
  time, and the device's busy share of the wall time.

Prints one line per phase and per top kernel, then one JSON line; writes
the profiler's table under ``chiprun_out/``. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from hypad_tpu_torch.profile_detect import profile_calls

MODES = {"full": "full", "true": True, "false": False}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--fused-critics", choices=sorted(MODES),
                        default="full")
    args = parser.parse_args(argv)
    fused = MODES[args.fused_critics]

    from hypad_tpu_torch._device import resolve_device
    from hypad_tpu_torch.data.pipeline import (
        A1_BATCH_SIZE,
        A1_WINDOWS,
        synthetic_detect_input,
    )
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.train import trainer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device("cuda")
    X = torch.as_tensor(synthetic_detect_input(A1_WINDOWS, 100,
                                               anomaly_len=50)[0],
                        device=device)
    model = init_tadgan(torch.Generator().manual_seed(0), X.shape[1],
                        hyperbolic=True, device=device)
    state = tr.init_train_state(model, 5e-4, True)
    kw = dict(lr=5e-4, hyperbolic=True)
    epoch = iter(range(1_000_000))

    def draws():
        return {k: v.to(device) for k, v in tr.epoch_draws(
            tr.epoch_generator(0, next(epoch)), X.shape[0], A1_BATCH_SIZE,
            model).items()}

    def one_epoch():
        d = draws()
        tr.critic_pass(state, X, d, fused_critics=fused, **kw)
        tr.generator_pass(state, X, d, **kw)

    one_epoch()
    torch.cuda.synchronize()
    phases = {"draws": [], "critic passes": [], "generator pass": []}
    for _ in range(3):
        stamps = [time.perf_counter()]
        d = draws()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        tr.critic_pass(state, X, d, fused_critics=fused, **kw)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        tr.generator_pass(state, X, d, **kw)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        for name, t0, t1 in zip(phases, stamps, stamps[1:]):
            phases[name].append((t1 - t0) * 1e3)
    medians = {k: statistics.median(v) for k, v in phases.items()}
    for name, ms in medians.items():
        print(f"[phase] {name}: {ms:.3f} ms (median of 3, runs {phases[name]})")
    print(f"[phase] epoch: {sum(medians.values()):.3f} ms")

    # an epoch is ~20,000 launches: no Chrome trace, which would be tens of MB
    top, busy_share, wall_ms = profile_calls(
        one_epoch, 2, f"train_{args.fused_critics}", chrome_trace=False)
    for name, ms, count in top[:15]:
        print(f"[kernel] {ms:.4f} ms/epoch, {count:g} launches/epoch: "
              f"{name[:110]}")
    device_ms = sum(ms for _, ms, _ in top)
    launches = sum(c for _, _, c in top)
    print(f"[trace] wall {wall_ms:.3f} ms/epoch under the profiler, device "
          f"busy {busy_share:.4f} of it, device work {device_ms:.3f} "
          f"ms/epoch in {launches:g} launches")
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "fused_critics": args.fused_critics, "windows": X.shape[0],
        "batch_size": A1_BATCH_SIZE, "phases_ms": medians,
        "phase_runs_ms": phases, "wall_ms_under_profiler": wall_ms,
        "busy_share_under_profiler": busy_share,
        "device_ms_per_epoch": device_ms, "launches_per_epoch": launches,
        "top_kernels": [{"name": n, "ms": ms, "launches": c}
                        for n, ms, c in top[:15]]}))


if __name__ == "__main__":
    main()
