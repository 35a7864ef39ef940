"""Where a graphed fleet epoch's host time goes within a chunk, on a GPU.

    python3 -m hypad_tpu_torch.profile_fleet [--signals S ...] [--epochs N]

S hyperbolic models at the published widths (``init_tadgan`` seeds 0 to
S - 1) on ``chip_smoke.py``'s A1-sized windows (1,320 of 100, batch 64),
signal i drawing seed i's draws, are trained through ``train_fleet`` for
one epoch under ``fused_critics="full"`` (the captures). Then the program it keeps in the ``FleetState``
(``train/graphed.py`` ``FleetProgram``) runs ``--epochs`` epochs a call,
twice in turns with each of two ways of making the draws:

* "after", as ``train_fleet`` makes them: each epoch's draws made once the
  previous epoch's replays are enqueued;
* "prefetch": each epoch's draws started on a background thread before
  the previous epoch's load.

Each call's host phases are timed on the host clock: the draws (where they
are made), ``_load_epoch`` (the draws' copy in and the coefficient tables),
``_run_pass`` (the replays' enqueue) and ``_epoch_means`` (the metrics'
reductions), beside the call's wall time an epoch up to a synchronise; then
the device work an epoch of one more call under ``torch.profiler`` (device
activity only). Prints one line per signal count and way, then one JSON
line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import torch

WAYS = ("after", "prefetch")


def draws_after(make, first, n):
    """Epochs ``first`` .. ``first + n - 1``'s draws, each made when the
    program asks for it."""
    return (make(first + j) for j in range(n))


def draws_prefetched(make, first, n, pool):
    """The same draws, each next epoch's started on ``pool`` as the
    current one is handed over (so before its load)."""
    nxt = pool.submit(make, first) if n else None
    for j in range(n):
        draws = nxt.result()
        if j + 1 < n:
            nxt = pool.submit(make, first + j + 1)
        yield draws


def timed_run(program, state, draws, sync):
    """Run ``program`` on ``state`` over the draws iterator ``draws``
    with its host phases timed: (metrics, wall s, {phase: [s, ...]}).
    ``sync``: what waits for the device (nothing on the CPU)."""
    phases = {"load_epoch": [], "run_pass": [], "epoch_means": []}

    def timer(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            phases[name].append(time.perf_counter() - t0)
            return out
        return run

    for name in phases:
        setattr(program, f"_{name}", timer(name, getattr(program,
                                                          f"_{name}")))
    try:
        sync()
        t0 = time.perf_counter()
        metrics = program.run(state, draws)
        sync()
        wall = time.perf_counter() - t0
    finally:
        for name in phases:
            delattr(program, f"_{name}")
    return metrics, wall, phases


def device_ms(fn):
    """Device ms of one ``fn()`` under torch.profiler (the card's activity
    only), or None where it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    return sum(e.time_range.elapsed_us() for e in events) / 1e3


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--signals", type=int, nargs="+", default=[3, 9])
    parser.add_argument("--epochs", type=int, default=4,
                        help="epochs a call")
    args = parser.parse_args(argv)

    from hypad_tpu_torch._device import resolve_device
    from hypad_tpu_torch.data.pipeline import (
        A1_BATCH_SIZE,
        A1_WINDOWS,
        synthetic_detect_input,
    )
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.train import fleet as fl
    from hypad_tpu_torch.train import trainer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device("cuda")
    X = synthetic_detect_input(A1_WINDOWS, 100, anomaly_len=50)[0]
    pool = ThreadPoolExecutor(1, thread_name_prefix="prefetch")
    out = {"card": torch.cuda.get_device_name(0),
           "epochs_a_call": args.epochs, "draw_threads": tr.DRAW_THREADS}
    for S in args.signals:
        seeds, n_real = list(range(S)), [X.shape[0]] * S
        state = fl.init_fleet_state(
            [init_tadgan(torch.Generator().manual_seed(i), X.shape[1],
                         hyperbolic=True, device=device) for i in range(S)],
            5e-4, True)
        fl.train_fleet(state, [X] * S, lr=5e-4, hyperbolic=True,
                       batch_size=A1_BATCH_SIZE, n_epochs=1, seeds=seeds,
                       device=device, fused_critics="full")
        program = state.program
        if program is None:
            raise SystemExit("train_fleet kept no captured program")
        made = []

        def make(e):
            t0 = time.perf_counter()
            d = tr.fleet_epoch_draws(seeds, e, n_real, A1_BATCH_SIZE,
                                     state.params)
            made.append(time.perf_counter() - t0)
            return d

        ways = {"after": lambda: draws_after(make, state.epoch, args.epochs),
                "prefetch": lambda: draws_prefetched(make, state.epoch,
                                                     args.epochs, pool)}
        rec = {}
        for way in WAYS + WAYS[::-1]:
            made.clear()
            _, wall, phases = timed_run(program, state, ways[way](),
                                        torch.cuda.synchronize)
            phases["draws"] = list(made)
            run = {"epoch_s": wall / args.epochs,
                   **{k: statistics.median(v) for k, v in phases.items()},
                   "runs": phases}
            rec.setdefault(way, []).append(run)
            print(f"[fleet] S={S} draws {way}: {run['epoch_s']:.4f} s an "
                  f"epoch; medians: draws {run['draws']:.4f} s, load "
                  f"{run['load_epoch']:.4f}, replays' enqueue "
                  f"{run['run_pass']:.4f} a pass, means "
                  f"{run['epoch_means']:.4f}")
        ms = device_ms(lambda: program.run(
            state, draws_after(make, state.epoch, args.epochs)))
        rec["device_ms_an_epoch"] = None if ms is None else ms / args.epochs
        print(f"[fleet] S={S}: device work {rec['device_ms_an_epoch']} ms an "
              f"epoch (profiler, {args.epochs} epochs) "
              f"({torch.cuda.get_device_name(0)})")
        out[S] = rec
    pool.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
