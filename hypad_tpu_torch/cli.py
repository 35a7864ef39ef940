"""Command line of the port: ``python -m hypad_tpu_torch.cli``.

Port of ``hypad_tpu.cli``'s ``train`` and ``detect``:

* ``train --config cfg.yaml``: load the config's signal, snapshot the
  config into the run directory, train (resuming from the newest
  ``state_{epoch}.pt`` under ``resume: true``), log each epoch to
  ``train_log.jsonl``, checkpoint every 10th epoch and the last one, save
  ``state_final.pt``, then detect with the windows already on the card;
* ``detect --config cfg.yaml``: detect from ``state_final.pt``, or from
  ``state_{resume_epoch}.pt`` under ``resume: true``; with
  ``--rec-errors``/``--combinations`` every cell of the grid from one
  forward pass, into ``grid_results.csv``;
* no subcommand means ``train``.

The run directory is the JAX package's
(``trained_models/models_{hyper|eucl}_{dataset}_{epochs}_{lr}/...``).
``--device`` defaults to ``cuda`` and raises without CUDA; ``--device cpu``
runs the kernels' plain versions. ``fused_critics`` picks the critic step
(false: autograd; true: K4; "full": K5); ``HYPAD_KDE_PALLAS=1`` picks the
KDE kernel K3, else K2. The weights come from ``init_tadgan`` on a torch
generator seeded with ``seed``, so a port run does not train the JAX
run's weights; a JAX checkpoint carried over with
``train.state_bridge.train_state_from_jax`` and saved with
``utils.checkpoint.save_state`` detects as the JAX CLI does. Not ported:
``sweep`` and its flags (ROADMAP A10), more than one device (A13).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device

_FLEET = "the fleet `sweep` and its flags are not ported yet (ROADMAP A10)"


def _build(params):
    from hypad_tpu_torch.data.registry import dataset_selection
    from hypad_tpu_torch.utils.config import run_dir

    path = run_dir(params)
    train_data, test_data, _ = dataset_selection(params, cache_dir=path)
    return train_data, test_data, path


def _init_models(params, device):
    from hypad_tpu_torch.models.tadgan import init_tadgan

    return init_tadgan(torch.Generator().manual_seed(params.seed),
                       signal_shape=params.signal_shape,
                       hyperbolic=params.hyperbolic, device=device)


def _check_supported(params, device):
    """Raise on the config keys whose JAX meaning is not ported: more than
    one device (``devices`` above 1, or "all" on a host with more than one
    visible card) and ``save_plots: true``."""
    n = params.devices
    if n == "all":
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if not isinstance(n, int) or n > 1:
        raise NotImplementedError(
            f"devices: {params.devices!r} asks for {n} devices; data "
            "parallelism over several cards is not ported yet (ROADMAP A13)"
            "; set devices: 1")
    if getattr(params, "save_plots", None):
        raise NotImplementedError("save_plots: plots are not ported yet "
                                  "(ROADMAP A12)")


def cmd_train(params, config_path, device="cuda"):
    from hypad_tpu_torch.train import trainer as tr
    from hypad_tpu_torch.utils import checkpoint as ck
    from hypad_tpu_torch.utils.profiling import MetricsLogger, stage

    device = resolve_device(device)
    train_data, test_data, path = _build(params)
    ck.snapshot_config(path, config_path)

    state = tr.init_train_state(_init_models(params, device), lr=params.lr,
                                hyperbolic=params.hyperbolic)
    start_epoch = 0
    if params.resume:
        tag = ck.latest_epoch_tag(path)
        if tag is not None:
            state = ck.restore_state(path, tag, device)
            start_epoch = tag
            print(f"resumed from epoch {tag}")

    log_cb = MetricsLogger(path=os.path.join(path, "train_log.jsonl"),
                           hyperbolic=params.hyperbolic)
    # the windows go to the card once; detection reuses them where one CSV
    # trains and tests
    X_dev = torch.as_tensor(np.asarray(train_data.X, np.float32),
                            device=device)
    train_data.X_device = X_dev
    if test_data is train_data:
        test_data.X_device = X_dev

    t0 = time.time()
    with stage("train"):
        state = tr.train_tadgan(
            state, X_dev, lr=params.lr, hyperbolic=params.hyperbolic,
            batch_size=params.batch_size, n_epochs=params.epochs,
            seed=params.seed, device=device,
            fused_critics=params.fused_critics, log_cb=log_cb,
            checkpoint_cb=lambda e, s: ck.save_state(path, s, e))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    wall = time.time() - t0
    trained = max(params.epochs - start_epoch, 1)
    print(f"training wall-clock: {wall:.2f}s "
          f"({wall / trained:.3f}s/epoch)")
    ck.save_state(path, state, "final")

    result = _run_detection(params, state.model, test_data, path, device)
    return state, path, result


def _run_detection(params, model, test_data, path, device):
    from hypad_tpu_torch.detect.detector import detect
    from hypad_tpu_torch.utils.profiling import stage

    t0 = time.time()
    with stage("detect"):
        result = detect(params, model, test_data, path,
                        save_plots=getattr(params, "save_plots", None),
                        device=device)
    wall = time.time() - t0
    print(f"detection wall-clock: {wall:.2f}s "
          f"({len(test_data.X) / wall:.1f} windows/sec)")
    if result["metrics"] is None:
        print("no anomalous intervals predicted (or no ground truth)")
    return result


def expand_combinations(params, combos):
    """``["all"]`` -> every combination valid for the config's geometry
    (hyperbolic: all 8; Euclidean: mult, sum, rec, critic); any other list
    passes through for the grid to check."""
    if combos != ["all"]:
        return combos
    from hypad_tpu_torch.detect.scorer import COMBINATIONS, EUCL_COMBOS

    return list(COMBINATIONS if params.hyperbolic else EUCL_COMBOS)


def cmd_detect(params, config_path, rec_errors=None, combinations=None,
               device="cuda"):
    from hypad_tpu_torch.utils import checkpoint as ck
    from hypad_tpu_torch.utils.profiling import stage

    device = resolve_device(device)
    train_data, test_data, path = _build(params)
    tag = params.resume_epoch if params.resume else "final"
    if params.resume:
        print(f"resuming epoch: {params.resume_epoch}")
    model = ck.restore_state(path, tag, device).model
    if rec_errors or combinations:
        from hypad_tpu_torch.detect.detector import detect_grid

        t0 = time.time()
        with stage("detect_grid"):
            results = detect_grid(params, model, test_data, path,
                                  rec_errors=rec_errors,
                                  combinations=combinations, device=device)
        wall = time.time() - t0
        print(f"grid detection wall-clock: {wall:.2f}s for "
              f"{len(results)} cells in one program "
              f"(results -> {os.path.join(path, 'grid_results.csv')})")
        return results
    return _run_detection(params, model, test_data, path, device)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    command = "train"
    if argv and argv[0] in ("train", "detect", "sweep"):
        command = argv.pop(0)

    parser = argparse.ArgumentParser(description="HypAD on PyTorch/CUDA")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--profile", action="store_true",
                        help="print per-stage wall-clock report at exit")
    parser.add_argument("--rec-errors", type=str, default=None,
                        help="comma-separated rec_error list for `detect`: "
                             "score every (rec_error x combination) cell "
                             "from one forward pass")
    parser.add_argument("--combinations", type=str, default=None,
                        help="comma-separated combination list for `detect` "
                             "grid detection ('all' = every mode valid for "
                             "the config's geometry)")
    for flag in ("--signals", "--seeds"):
        parser.add_argument(flag, type=str, default=None, help=_FLEET)
    for flag in ("--detect-only", "--canonical"):
        parser.add_argument(flag, action="store_true", help=_FLEET)
    args = parser.parse_args(argv)
    if (command == "sweep" or args.signals or args.seeds or args.detect_only
            or args.canonical):
        raise NotImplementedError(_FLEET)
    device = resolve_device(args.device)

    from hypad_tpu_torch.utils.config import load_config

    params = load_config(args.config)
    _check_supported(params, device)
    print(f"dataset: {params.dataset}, signal: {params.signal}")
    print(params)

    combos = expand_combinations(
        params, args.combinations.split(",") if args.combinations else None)
    recs = args.rec_errors.split(",") if args.rec_errors else None
    if command == "train":
        out = cmd_train(params, args.config, device)
    else:
        out = cmd_detect(params, args.config, rec_errors=recs,
                         combinations=combos, device=device)

    if args.profile:
        from hypad_tpu_torch.utils.profiling import report

        print(report())
    return out


if __name__ == "__main__":
    main()
