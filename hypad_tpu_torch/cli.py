"""Command line of the port: ``python -m hypad_tpu_torch.cli``.

Port of ``hypad_tpu.cli``'s ``train``, ``detect`` and ``sweep``, univariate
and multivariate:

* ``train --config cfg.yaml``: load the config's signal, snapshot the
  config into the run directory, train (resuming from the newest
  ``state_{epoch}.pt`` under ``resume: true``), log each epoch to
  ``train_log.jsonl``, checkpoint every 10th epoch and the last one, save
  ``state_final.pt``, then detect with the windows already on the card;
* ``detect --config cfg.yaml``: detect from ``state_final.pt``, or from
  ``state_{resume_epoch}.pt`` under ``resume: true``; with
  ``--rec-errors``/``--combinations`` every cell of the grid from one
  forward pass, into ``grid_results.csv``;
* ``sweep --config cfg.yaml [--signals a,b] [--seeds 0,1] [--detect-only]``:
  train a signal family (a ``signals:`` list or ``--signals``), a seed
  band of the config's signal (``--seeds``) or their cross product as ONE
  fleet (``train/fleet.py``: one batched step per fleet step for all of
  them), then detect the whole family in one call
  (``detect_scores_fleet``); each signal's checkpoints, effective
  ``config.yaml``, anomalies and results CSV row land in its own run
  directory (under ``seed_{k}/`` for a band), where ``detect`` re-enters
  it; ``sweep_log.jsonl`` in the first. ``--detect-only`` re-scores a
  trained family from its checkpoints. With ``--rec-errors``/
  ``--combinations`` (the fleet grid) every (rec_error x combination) cell
  of every run is scored in one call (``detect_scores_fleet_grid``), each
  run's ``grid_results.csv`` written from its slice, the family table
  ``sweep_grid.csv`` beside ``sweep_log.jsonl``, and the cells ranked by
  their mean F1;
* no subcommand means ``train``.

A multivariate config (``signal: multivariate`` with SWaT or WADI, or a
CASAS-family dataset with ``signal`` the resident or point) trains on the
(N, F) timestep rows with the model built at ``signal_shape`` = F (WADI
123, SWaT 51, CASAS 150) and detects per timestep; its sweep trains and
scores a family of such streams as one fleet.

The run directory is the JAX package's
(``trained_models/models_{hyper|eucl}_{dataset}_{epochs}_{lr}/...``).
``--device`` defaults to ``cuda`` and raises without CUDA; ``--device cpu``
runs the kernels' plain versions. ``fused_critics`` picks the critic step
(false: autograd; true: K4; "full": K5); ``HYPAD_KDE_PALLAS=1`` picks the
KDE kernel K3, else K2. The weights come from ``init_tadgan`` on a torch
generator seeded with ``seed``, so a port run does not train the JAX
run's weights; a JAX checkpoint carried over with
``train.state_bridge.train_state_from_jax`` and saved with
``utils.checkpoint.save_state`` detects as the JAX CLI does. ``all``
stands for every valid cell in ``--combinations`` and, unlike JAX's CLI,
in ``--rec-errors`` too. ``save_plots`` draws ``anomalies.png`` as JAX's
detector does (by default for a multivariate run). ``sweep --canonical``
trains the family at JAX's canonical shapes (``train_fleet(canonical=
True)``).

``devices`` is JAX's: every command builds ``make_mesh(devices)`` over
the cards of ``--device``'s platform ("all" by default; an int takes the
first that many). With two or more, one process drives them all: the
state lies on the first card, ``train`` rounds the batch down to a
multiple of the card count (``batch_multiple``) and shards each step's
rows, detection shards its windows, and ``sweep`` shards the fleet's
signals (``parallel/mesh.py``). ``fused_critics`` true or "full" raises
on such a mesh, as in JAX.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.parallel.mesh import batch_multiple, make_mesh


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


def _mesh(params, device):
    """(mesh, device): JAX's ``make_mesh(params.devices)`` over the devices
    of ``device``'s platform (None for one), and the device the state lies
    on, the mesh's lead device when there is one."""
    device = resolve_device(device)
    mesh = make_mesh(params.devices, platform=device.type)
    if mesh is not None:
        print(f"mesh: {mesh}")
    return mesh, resolve_device(device, mesh)


def cmd_train(params, config_path, device="cuda"):
    from hypad_tpu_torch.train import trainer as tr
    from hypad_tpu_torch.utils import checkpoint as ck
    from hypad_tpu_torch.utils.profiling import MetricsLogger, stage

    mesh, device = _mesh(params, device)
    # the fused critic steps refuse a mesh before any file is written
    tr.check_mesh_fused(params.fused_critics, mesh)
    train_data, test_data, path = _build(params)
    ck.snapshot_config(path, config_path)
    # rounded down to a multiple of the mesh's devices, as JAX's cmd_train
    batch_size = batch_multiple(params.batch_size, mesh)

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
            batch_size=batch_size, n_epochs=params.epochs,
            seed=params.seed, device=device, mesh=mesh,
            start_epoch=start_epoch, fused_critics=params.fused_critics,
            log_cb=log_cb,
            checkpoint_cb=lambda e, s: ck.save_state(path, s, e))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    wall = time.time() - t0
    trained = max(params.epochs - start_epoch, 1)
    print(f"training wall-clock: {wall:.2f}s "
          f"({wall / trained:.3f}s/epoch)")
    ck.save_state(path, state, "final")

    result = _run_detection(params, state.model, test_data, path, device,
                            mesh=mesh)
    return state, path, result


def _run_detection(params, model, test_data, path, device,
                   precomputed_scores=None, mesh=None):
    from hypad_tpu_torch.detect.detector import detect
    from hypad_tpu_torch.utils.profiling import stage

    t0 = time.time()
    with stage("detect"):
        result = detect(params, model, test_data, path,
                        save_plots=getattr(params, "save_plots", None),
                        mesh=mesh, precomputed_scores=precomputed_scores,
                        device=device)
    wall = time.time() - t0
    print(f"detection wall-clock: {wall:.2f}s "
          f"({len(test_data.X) / wall:.1f} windows/sec)")
    if result["metrics"] is None:
        print("no anomalous intervals predicted (or no ground truth)")
    return result


def _sweep_pairs(params, signals, seeds):
    """The (signal, seed or None) runs of a sweep, as JAX's ``cmd_sweep``
    pairs them: signals x seeds, a seed band of the config's signal, or
    the signals alone."""
    seeds = seeds if seeds is not None else getattr(params, "seeds", None)
    if seeds is not None and signals:
        return [(sig, int(sd)) for sig in signals for sd in seeds]
    if seeds is not None:
        return [(params.signal, int(sd)) for sd in seeds]
    signals = signals or getattr(params, "signals", None)
    if not signals:
        raise SystemExit("sweep needs a `signals:` list in the config, "
                         "--signals a,b,c, or --seeds 0,1,2")
    return [(sig, None) for sig in signals]


def cmd_sweep(params, config_path, signals=None, seeds=None,
              detect_only=False, rec_errors=None, combinations=None,
              canonical=False, device="cuda"):
    """Train a signal family, a seed band or their cross product as one
    fleet, then detect it in one call (JAX's ``cmd_sweep``; ``canonical``
    trains at JAX's canonical shapes); a multivariate family (CASAS
    residents, say) is scored per timestep. Returns one ``(signal, seed,
    f1)`` per run, in run order. With a mesh the fleet's signals shard
    over its cards.

    ``rec_errors`` / ``combinations`` (JAX's keywords) make it the fleet
    grid: every cell of every run from one ``detect_scores_fleet_grid``
    call, each run's ``grid_results.csv`` through ``detect_grid`` on its
    slice, ``sweep_grid.csv`` (columns signal, seed, rec_error,
    combination, f1; runs in order, then cells in grid order) beside
    ``sweep_log.jsonl``, and the cells ranked by mean F1
    (:func:`grid_ranking`). It then returns one ``(signal, seed,
    {cell: result})`` per run."""
    import argparse as ap
    import copy
    import json

    from hypad_tpu_torch.data.registry import is_multivariate
    from hypad_tpu_torch.detect.detector import detect_grid
    from hypad_tpu_torch.detect.scorer import (
        detect_scores_fleet,
        detect_scores_fleet_grid,
    )
    from hypad_tpu_torch.train import fleet as fl
    from hypad_tpu_torch.utils import checkpoint as ck
    from hypad_tpu_torch.utils.config import run_dir
    from hypad_tpu_torch.utils.profiling import stage

    from hypad_tpu_torch.train.trainer import check_mesh_fused

    mesh, device = _mesh(params, device)
    if not detect_only:
        check_mesh_fused(params.fused_critics, mesh)
    grid_mode = bool(rec_errors or combinations)
    grid_combos = combinations or [params.combination]
    grid_recs = rec_errors or [params.rec_error]
    pairs = _sweep_pairs(params, signals, seeds)
    band = seeds is not None or getattr(params, "seeds", None) is not None
    if getattr(params, "save_artifacts", True) and not params.load:
        print("sweep detection is scores-only: inference artifacts are NOT "
              "persisted (save_artifacts ignored; use per-signal `detect` "
              "for artifact caching)")

    per, data_cache = [], {}
    for sig, sd in pairs:
        p = ap.Namespace(**copy.deepcopy(vars(params)))
        p.signal = sig
        if sd is not None:
            p.seed = sd
            p.output_root = os.path.join(params.output_root, f"seed_{sd}")
        if sig in data_cache:
            train_data, test_data = data_cache[sig]
            path = run_dir(p)
        else:
            train_data, test_data, path = _build(p)
            data_cache[sig] = (train_data, test_data)
        if not detect_only:
            ck.snapshot_effective(path, p)
        per.append((p, train_data, test_data, path))

    tag = params.resume_epoch if params.resume else "final"
    staged = fstate = stacked = None
    if detect_only:
        # the grid always scores from the checkpoints; a single cell under
        # `load: true` takes each run's cached artifacts instead
        if grid_mode or not params.load:
            missing = [path for (*_, path) in per if not os.path.exists(
                ck.checkpoint_path(path, tag))]
            if missing:
                raise SystemExit(
                    f"sweep --detect-only: no 'state_{tag}' checkpoint in "
                    f"{len(missing)}/{len(per)} run dir(s) — train the "
                    "family first (same config, without --detect-only). "
                    f"First missing: {missing[0]}")
            stacked = fl.stack_models([ck.restore_state(path, tag,
                                                        device).model
                                       for (*_, path) in per])
    else:
        fstate = fl.init_fleet_state(
            [_init_models(p, device) for (p, *_) in per], lr=params.lr,
            hyperbolic=params.hyperbolic)
        log_path = os.path.join(per[0][3], "sweep_log.jsonl")

        def log_cb(epoch, metrics):
            row = {"epoch": int(epoch),
                   **{k: [float(x) for x in v] for k, v in metrics.items()}}
            with open(log_path, "a") as f:
                f.write(json.dumps(row) + "\n")
            mean = {k: float(np.mean(v)) for k, v in metrics.items()}
            print(f"[sweep] epoch {epoch}: "
                  f"critic x {mean['critic_x_loss']:.3f} "
                  f"critic z {mean['critic_z_loss']:.3f} "
                  f"decoder {mean['decoder_loss']:.3f} "
                  f"rec {mean['rec_loss']:.6f} (mean of {len(per)})")

        def ckpt_cb(epoch, states):
            for i, (*_, path) in enumerate(per):
                ck.save_state(path, fl.unstack_state(states, i), epoch)

        t0 = time.time()
        with stage("sweep_train"):
            fstate, staged = fl.train_fleet(
                fstate, [td.X for (_, td, _, _) in per], lr=params.lr,
                hyperbolic=params.hyperbolic, batch_size=params.batch_size,
                n_epochs=params.epochs, seed=params.seed,
                seeds=[sd for (_, sd) in pairs] if band else None,
                log_cb=log_cb, checkpoint_cb=ckpt_cb, return_staged=True,
                fused_critics=params.fused_critics, mesh=mesh,
                canonical=canonical, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        wall = time.time() - t0
        print(f"sweep training wall-clock: {wall:.2f}s for {len(per)} "
              f"models x {params.epochs} epochs "
              f"({wall / max(params.epochs, 1):.3f}s/fleet-epoch, "
              f"{wall / max(params.epochs * len(per), 1):.4f}"
              f"s/signal-epoch)")
        stacked = fstate.params

    fleet_scores = [None] * len(per)
    # a family that tests on its training windows reuses the stack already
    # on the card
    reuse = staged if all(td is trd for (_, trd, td, _) in per) else None
    X_test = [td.X for (_, _, td, _) in per]
    mv = is_multivariate(params)
    if grid_mode:
        t0 = time.time()
        with stage("sweep_detect_grid"):
            fleet_grid = detect_scores_fleet_grid(
                stacked, X_test, params.hyperbolic, grid_combos,
                rec_errors=grid_recs, mesh=mesh, staged=reuse, device=device,
                multivariate=mv)
        dwall = time.time() - t0
        print(f"fleet grid detection wall-clock: {dwall:.2f}s for "
              f"{len(per)} signals x {len(fleet_grid[0])} cells in one "
              "program")
    elif not params.load:
        t0 = time.time()
        with stage("sweep_detect"):
            fleet_scores = detect_scores_fleet(
                stacked, X_test, params.hyperbolic, params.combination,
                rec_error=params.rec_error, mesh=mesh, staged=reuse,
                device=device, multivariate=mv)
        dwall = time.time() - t0
        n_win = sum(len(x) for x in X_test)
        print(f"fleet detection wall-clock: {dwall:.2f}s for {len(per)} "
              f"signals / {n_win} windows in one program "
              f"({n_win / dwall:.1f} windows/sec)")

    results, grid_rows = [], []
    for i, (p, _, test_data, path) in enumerate(per):
        if fstate is not None:
            ck.save_state(path, fl.unstack_state(fstate, i), "final")
        print(f"--- {p.signal}{f' (seed {p.seed})' if band else ''} ---")
        if grid_mode:
            res = detect_grid(p, None, test_data, path, rec_errors=grid_recs,
                              combinations=grid_combos, device=device,
                              precomputed_grid=fleet_grid[i])
            for (re_, cb), r in res.items():
                m = r["metrics"] or {}
                grid_rows.append({"signal": p.signal, "seed": p.seed,
                                  "rec_error": re_ or "", "combination": cb,
                                  "f1": float(m.get("f1", np.nan))})
            results.append((p.signal, p.seed, res))
            continue
        model = (fl.unstack_model(stacked, i) if stacked is not None
                 else ck.restore_state(path, tag, device).model)
        res = _run_detection(p, model, test_data, path, device,
                             precomputed_scores=fleet_scores[i], mesh=mesh)
        m = res["metrics"]
        results.append((p.signal, p.seed, m["f1"] if m else None))
    if grid_mode:
        write_sweep_grid(os.path.join(per[0][3], "sweep_grid.csv"),
                         grid_rows)
        print(f"sweep grid mean f1 over {len(per)} runs, best cell first:")
        for re_, cb, mean, n in grid_ranking(grid_rows):
            print(f"  {cb if not re_ else f'{re_}/{cb}'}: {mean:.4f} "
                  f"(n={n})")
        return results
    scored = [f for _, _, f in results if f is not None]
    if scored:
        print(f"sweep mean f1 over {len(scored)}/{len(results)} signals: "
              f"{float(np.mean(scored)):.4f}")
    return results


def write_sweep_grid(path, rows):
    """The family table ``sweep_grid.csv`` as JAX writes it with pandas'
    ``to_csv(index=False)``: columns signal, seed, rec_error, combination,
    f1, the rows as given, a NaN f1 as an empty field."""
    from hypad_tpu_torch.detect.detector import _write_rows

    _write_rows(path, [{**r, "f1": None if math.isnan(r["f1"]) else r["f1"]}
                       for r in rows])


def grid_ranking(rows):
    """[(rec_error, combination, mean f1, n)] of the sweep grid's rows,
    best cell first: the mean over each cell's non-NaN f1 and ``n`` their
    count, as pandas' ``mean`` / ``count`` take them (a cell with none has
    NaN and n = 0, and goes last). Equal means keep the cells' first-seen
    order, a stable sort; JAX's ``sort_values`` (quicksort, after a
    ``groupby`` that sorts the cells by name) may order such ties
    differently."""
    f1s = {}
    for r in rows:
        f1s.setdefault((r["rec_error"], r["combination"]), []).extend(
            [] if math.isnan(r["f1"]) else [r["f1"]])
    table = [(re_, cb, float(np.mean(v)) if v else math.nan, len(v))
             for (re_, cb), v in f1s.items()]
    return sorted(table, key=lambda t: (math.isnan(t[2]),
                                        0.0 if math.isnan(t[2]) else -t[2]))


def expand_rec_errors(recs):
    """``["all"]`` -> every rec_error (point, area, dtw); any other list
    passes through for the grid to check."""
    if recs != ["all"]:
        return recs
    from hypad_tpu_torch.detect.scorer import REC_ERRORS

    return list(REC_ERRORS)


def expand_combinations(params, combos):
    """``["all"]`` -> every combination valid for the config's path
    (hyperbolic or multivariate: all 8; Euclidean univariate: mult, sum,
    rec, critic); any other list passes through for the grid to check."""
    if combos != ["all"]:
        return combos
    from hypad_tpu_torch.data.registry import is_multivariate
    from hypad_tpu_torch.detect.scorer import COMBINATIONS, EUCL_COMBOS

    return list(COMBINATIONS if params.hyperbolic or is_multivariate(params)
                else EUCL_COMBOS)


def cmd_detect(params, config_path, rec_errors=None, combinations=None,
               device="cuda"):
    from hypad_tpu_torch.utils import checkpoint as ck
    from hypad_tpu_torch.utils.profiling import stage

    mesh, device = _mesh(params, device)
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
                                  combinations=combinations, mesh=mesh,
                                  device=device)
        wall = time.time() - t0
        print(f"grid detection wall-clock: {wall:.2f}s for "
              f"{len(results)} cells in one program "
              f"(results -> {os.path.join(path, 'grid_results.csv')})")
        return results
    return _run_detection(params, model, test_data, path, device, mesh=mesh)


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
                        help="comma-separated rec_error list for `detect` / "
                             "`sweep` ('all' = point,area,dtw): score every "
                             "(rec_error x combination) cell from one "
                             "forward pass (on `sweep`, every run's cells in "
                             "one call)")
    parser.add_argument("--combinations", type=str, default=None,
                        help="comma-separated combination list for `detect` "
                             "/ `sweep` grid detection ('all' = every mode "
                             "valid for the config's geometry)")
    parser.add_argument("--signals", type=str, default=None,
                        help="comma-separated signal list for `sweep` "
                             "(overrides the config's `signals:`)")
    parser.add_argument("--seeds", type=str, default=None,
                        help="comma-separated seed list for `sweep`: train "
                             "the config's signal as a seed band in one "
                             "fleet")
    parser.add_argument("--detect-only", action="store_true",
                        help="`sweep`: skip training; restore each run's "
                             "checkpoint and detect the family in one call")
    parser.add_argument("--canonical", action="store_true",
                        help="`sweep`: train at JAX's canonical bucket shapes "
                             "(window and signal rungs); its draws differ "
                             "from an unpadded run's")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from hypad_tpu_torch.utils.config import load_config

    params = load_config(args.config)
    print(f"dataset: {params.dataset}, signal: {params.signal}")
    print(params)

    combos = expand_combinations(
        params, args.combinations.split(",") if args.combinations else None)
    recs = expand_rec_errors(args.rec_errors.split(",")
                             if args.rec_errors else None)
    if command == "train":
        out = cmd_train(params, args.config, device)
    elif command == "sweep":
        out = cmd_sweep(params, args.config,
                        signals=(args.signals.split(",") if args.signals
                                 else None),
                        seeds=(args.seeds.split(",") if args.seeds
                               else None),
                        detect_only=args.detect_only, rec_errors=recs,
                        combinations=combos, canonical=args.canonical,
                        device=device)
    else:
        out = cmd_detect(params, args.config, rec_errors=recs,
                         combinations=combos, device=device)

    if args.profile:
        from hypad_tpu_torch.utils.profiling import report

        print(report())
    return out


if __name__ == "__main__":
    main()
