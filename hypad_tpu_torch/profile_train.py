"""Where the time of one warm training epoch goes, on a GPU.

    python3 -m hypad_tpu_torch.profile_train [--fused-critics full|true|false]
        [--width F --windows N] [--k1-baseline DIR]

The A1-sized input of ``chip_smoke.py`` (a 1,420-sample synthetic signal,
1,320 windows of 100, batch 64: 100 critic steps and 20 generator steps an
epoch) through the hyperbolic trainer at the published widths, weights from
seed 0. ``--width`` and ``--windows`` set another input shape: ``--width
123 --windows 8000 --fused-critics false`` is the WADI-width epoch of
``chip_smoke.py``'s [mv] (configs/multivariate.yaml's widths; the rows are
windows of a synthetic signal, so only the shapes are WADI's). Two views of
a warm epoch:

* phases: the epoch's draws (made on the CPU and copied to the card), the
  critic passes and the generator pass, each timed on the host clock up to
  a synchronise;
* trace: ``torch.profiler`` over warm epochs, the kernels summed by device
  time (K1's instances also together), and the device's busy share of the
  wall time.

With ``--k1-baseline DIR`` (a directory holding another
``mobius_linear.cu`` of the same C interface, for example a parent commit's
``hypad_tpu_torch/csrc`` unpacked with ``git archive`` into the gitignored
``_checkout/``), also warm epochs' wall time with K1 launched through that
source's library and through the tree's, in turns (baseline, tree, tree,
baseline, three times; medians): what K1's host side costs an epoch.

Prints one line per phase and per top kernel, then one JSON line; writes
the profiler's table under ``chiprun_out/``. Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time
from pathlib import Path

import torch

from hypad_tpu_torch.profile_detect import profile_calls

MODES = {"full": "full", "true": True, "false": False}


def k1_in_turns(one_epoch, baseline_dir, rounds=3):
    """{"baseline": ms, "tree": ms}: the median wall time of a warm epoch
    (host clock, up to a synchronise) with K1 launched through the library
    of ``baseline_dir``'s ``mobius_linear.cu`` and through the tree's, in
    turns (baseline, tree, tree, baseline, ``rounds`` times)."""
    from hypad_tpu_torch import _build
    from hypad_tpu_torch.manifold import kernels as mk
    from hypad_tpu_torch.profile_critic_step import OUT

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libk1_train_baseline.so"
    _build.compile_sources(
        {"k1_baseline": (Path(baseline_dir) / "mobius_linear.cu", lib)})
    base = ctypes.CDLL(str(lib))
    entries = {"baseline": (mk.bind(base), mk.bind_signals(base)),
               "tree": (mk._lib(), mk._lib_signals())}
    saved = mk._lib, mk._lib_signals
    walls = {name: [] for name in entries}
    try:
        for _ in range(rounds):
            for name in ("baseline", "tree", "tree", "baseline"):
                one, signals = entries[name]
                mk._lib = lambda one=one: one
                mk._lib_signals = lambda signals=signals: signals
                one_epoch()  # each library's first launches at each shape
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one_epoch()
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        mk._lib, mk._lib_signals = saved
    for name, runs in walls.items():
        print(f"[k1 host] warm epoch with the {name}'s K1: "
              f"{statistics.median(runs):.3f} ms (median of {len(runs)}, "
              f"runs {runs})")
    return {name: statistics.median(runs) for name, runs in walls.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--fused-critics", choices=sorted(MODES),
                        default="full")
    parser.add_argument("--width", type=int, default=100,
                        help="window width (a multivariate feature count)")
    parser.add_argument("--windows", type=int, default=None,
                        help="windows an epoch (default: A1's 1,320)")
    parser.add_argument("--k1-baseline", metavar="DIR",
                        help="directory of another mobius_linear.cu: also "
                        "time warm epochs with its K1 and the tree's")
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
    X = torch.as_tensor(synthetic_detect_input(args.windows or A1_WINDOWS,
                                               args.width,
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
    k1_epochs = (k1_in_turns(one_epoch, args.k1_baseline)
                 if args.k1_baseline else None)

    # an epoch is ~20,000 launches: no Chrome trace, which would be tens of MB
    top, busy_share, wall_ms = profile_calls(
        one_epoch, 2, f"train_{args.fused_critics}", chrome_trace=False)
    for name, ms, count in top[:15]:
        print(f"[kernel] {ms:.4f} ms/epoch, {count:g} launches/epoch: "
              f"{name[:110]}")
    device_ms = sum(ms for _, ms, _ in top)
    launches = sum(c for _, _, c in top)
    k1_ms = sum(ms for name, ms, _ in top if "mobius_linear" in name)
    k1_launches = sum(c for name, _, c in top if "mobius_linear" in name)
    print(f"[kernel] K1 (every mobius_linear instance): {k1_ms:.4f} "
          f"ms/epoch in {k1_launches:g} launches")
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
        "width": X.shape[1], "k1_ms_per_epoch": k1_ms,
        "k1_launches_per_epoch": k1_launches,
        "epoch_ms_by_k1": k1_epochs,
        "top_kernels": [{"name": n, "ms": ms, "launches": c}
                        for n, ms, c in top[:15]]}))


if __name__ == "__main__":
    main()
