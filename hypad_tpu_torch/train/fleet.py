"""The fleet trainer: a whole family of signals, one batched step per step.

Port of ``hypad_tpu.train.fleet``. JAX trains a signal family (the 9 NAB
signals of ``configs/nab_sweep.yaml``, a seed band) as one vmapped program;
here the counterpart of ``jax.vmap`` is a leading signal axis S on the
parameters, the optimizer states, the draws and every op of a step
(``models/fleet.py``, ``train/losses.py``, ``optim/radam.py``), so a fleet
critic step is ONE launch of K5 (or K4) for all S signals and a fleet
generator step issues about the launches of one signal's.

* :func:`stack_models` / :func:`unstack_model` and :func:`stack_states` /
  :func:`unstack_state` move between S single models (or ``TrainState``s)
  and one :class:`FleetState`, whose parameter leaves keep the model's
  ``state_dict`` names with a leading S; unstacking gives each model back
  bit for bit.
* Signal i draws exactly what a single-model ``train_tadgan(seed=seed_i)``
  draws (``trainer.fleet_epoch_draws``). Ragged families (different
  lengths) are zero-padded to one (S, N, W) stack and each signal's steps
  past its own schedule are no-ops, so every signal trains its own
  single-model schedule; a signal with ``n_real = 0`` comes back
  unchanged.
* :func:`train_fleet` keeps JAX's chunks and cadence (``epochs_per_call``
  epochs a chunk, each chunk ending at every 10th epoch and at epoch
  ``n_epochs - 1``, where the checkpoints fall; the metrics read once a
  chunk) and its ``log_cb`` / ``checkpoint_cb`` / ``return_staged``
  contract. With no mesh, or a mesh of one device, a chunk's epochs run
  the fleet's two step bodies of ``train/graphed.py``
  (:class:`~hypad_tpu_torch.train.graphed.FleetProgram`): on the card each
  captured once as a CUDA graph, K5, K4 and K1 inside with their signal
  axis, and replayed every step; on the CPU eagerly. The card's program is
  kept in the :class:`FleetState`, so a later call on the same fleet
  replays the same graphs.

* On a mesh (``parallel/mesh.py``) the SIGNAL axis is sharded over its
  ``dp`` devices with zero collectives: each device trains its slab of
  signals, one ``run_fleet_epoch`` body a slab, every slab enqueued before
  any metric is read. As in JAX the fleet is padded to a device multiple:
  an equal-length seed band with replicas of its last signal, any other
  fleet with ``n_real = 0`` dummies that take no step. The returned state
  keeps the pad signals, the caller's to ignore.
* ``canonical`` pads the window axis to JAX's rung ladder and the signal
  axis up its signal rungs (``detect/scorer.py`` ``canonical_fleet_shape``)
  with dummies, and draws each signal's masked shuffles over the padded
  row count, as JAX does: a canonical run is not the unpadded run.

Not ported, on purpose: JAX's ``SINGLE_EPOCH_MAX_S`` slicing
(``_single_epoch_sliced``) works round a v5e code-generation fault that no
CUDA launch has.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.bridge import model_from_state_dict
from hypad_tpu_torch.optim.radam import AdamState, RAdamState
from hypad_tpu_torch.parallel.mesh import dp_devices, row_slices
from hypad_tpu_torch.train import graphed
from hypad_tpu_torch.train.trainer import (
    TrainState,
    check_mesh_fused,
    fleet_epoch_device,
    fleet_epoch_draws,
    fleet_metrics,
    init_train_state,
)


@dataclass
class FleetState:
    """S models' parameters and optimizer states, stacked.

    ``params``: {state_dict name: (S, ...) tensor}; the optimizer states
    are ``AdamState`` / ``RAdamState`` with (S, ...) moments and (S,) int64
    numpy step counters; ``epoch`` is the fleet's. ``program``: on the
    card, the captured fleet epoch (``train/graphed.py``) of the last
    :func:`train_fleet` call, which the next call on the same fleet
    replays."""
    params: dict
    opt_cx: AdamState
    opt_cz: AdamState
    opt_gen: object
    epoch: int
    program: Any = field(default=None, repr=False, compare=False)

    @property
    def n_signals(self):
        return next(iter(self.params.values())).shape[0]


def stack_models(models):
    """{name: (S, ...)} of S models (``init_tadgan`` ModuleDicts) with one
    architecture, on their device."""
    sds = [m.state_dict() for m in models]
    return {k: torch.stack([sd[k].detach() for sd in sds]) for k in sds[0]}


def unstack_model(fleet, i):
    """Signal ``i``'s model (an ``init_tadgan`` ModuleDict on the stack's
    device) from stacked parameters or a :class:`FleetState`."""
    params = fleet.params if isinstance(fleet, FleetState) else fleet
    sd = {k: v[i].clone() for k, v in params.items()}
    return model_from_state_dict(sd, device=next(iter(sd.values())).device)


def _stack_opt(opts):
    step = np.asarray([o.step for o in opts], np.int64)
    if isinstance(opts[0], RAdamState):
        return RAdamState(step=step,
                          mu={k: torch.stack([o.mu[k] for o in opts])
                              for k in opts[0].mu},
                          nu={k: torch.stack([o.nu[k] for o in opts])
                              for k in opts[0].nu})
    return AdamState(step=step, mu=torch.stack([o.mu for o in opts]),
                     nu=torch.stack([o.nu for o in opts]))


def _unstack_opt(opt, i):
    if isinstance(opt, RAdamState):
        return RAdamState(step=int(opt.step[i]),
                          mu={k: v[i].clone() for k, v in opt.mu.items()},
                          nu={k: v[i].clone() for k, v in opt.nu.items()})
    return AdamState(step=int(opt.step[i]), mu=opt.mu[i].clone(),
                     nu=opt.nu[i].clone())


def stack_states(states):
    """One :class:`FleetState` of S single-model ``TrainState``s (the
    counterpart of JAX's ``stack_states``). The fleet's epoch is the
    first state's."""
    return FleetState(params=stack_models([s.model for s in states]),
                      opt_cx=_stack_opt([s.opt_cx for s in states]),
                      opt_cz=_stack_opt([s.opt_cz for s in states]),
                      opt_gen=_stack_opt([s.opt_gen for s in states]),
                      epoch=states[0].epoch)


def unstack_state(fleet, i):
    """Signal ``i``'s ``TrainState`` of a :class:`FleetState`, its tensors
    copied out of the stack."""
    return TrainState(model=unstack_model(fleet, i),
                      opt_cx=_unstack_opt(fleet.opt_cx, i),
                      opt_cz=_unstack_opt(fleet.opt_cz, i),
                      opt_gen=_unstack_opt(fleet.opt_gen, i),
                      epoch=fleet.epoch)


def init_fleet_state(models, lr, hyperbolic):
    """Per-signal ``init_train_state``, then :func:`stack_states`."""
    return stack_states([init_train_state(m, lr, hyperbolic)
                         for m in models])


def _slice_opt(opt, sl, device):
    if isinstance(opt, RAdamState):
        return RAdamState(step=opt.step[sl].copy(),
                          mu={k: v[sl].to(device, copy=True)
                              for k, v in opt.mu.items()},
                          nu={k: v[sl].to(device, copy=True)
                              for k, v in opt.nu.items()})
    return AdamState(step=opt.step[sl].copy(),
                     mu=opt.mu[sl].to(device, copy=True),
                     nu=opt.nu[sl].to(device, copy=True))


def _cat_opt(opts, device):
    step = np.concatenate([o.step for o in opts])
    if isinstance(opts[0], RAdamState):
        return RAdamState(step=step,
                          mu={k: torch.cat([o.mu[k].to(device) for o in opts])
                              for k in opts[0].mu},
                          nu={k: torch.cat([o.nu[k].to(device) for o in opts])
                              for k in opts[0].nu})
    return AdamState(step=step,
                     mu=torch.cat([o.mu.to(device) for o in opts]),
                     nu=torch.cat([o.nu.to(device) for o in opts]))


def slice_state(states, sl, device):
    """Signals ``sl`` (a slice) of a :class:`FleetState`, copied to
    ``device``: one mesh device's slab."""
    return FleetState(
        params={k: v[sl].to(device, copy=True)
                for k, v in states.params.items()},
        opt_cx=_slice_opt(states.opt_cx, sl, device),
        opt_cz=_slice_opt(states.opt_cz, sl, device),
        opt_gen=_slice_opt(states.opt_gen, sl, device), epoch=states.epoch)


def concat_states(parts, device):
    """One :class:`FleetState` on ``device`` of the slabs ``parts``, in
    order."""
    return FleetState(
        params={k: torch.cat([p.params[k].to(device) for p in parts])
                for k in parts[0].params},
        opt_cx=_cat_opt([p.opt_cx for p in parts], device),
        opt_cz=_cat_opt([p.opt_cz for p in parts], device),
        opt_gen=_cat_opt([p.opt_gen for p in parts], device),
        epoch=parts[0].epoch)


def pad_and_stack(X_list, pad_value=0.0, target_len=None):
    """Pad (N_i, W) window arrays to the longest N (or ``target_len``, the
    canonical path's) and stack: ((S, N, W) float32 numpy, n_real (S,)
    int32). No valid step reads a pad row."""
    n_max = max(x.shape[0] for x in X_list)
    if target_len is not None:
        if target_len < n_max:
            raise ValueError(f"target_len {target_len} < longest signal "
                             f"{n_max}")
        n_max = target_len
    out = np.full((len(X_list), n_max, X_list[0].shape[1]), pad_value,
                  np.float32)
    n_real = np.zeros((len(X_list),), np.int32)
    for i, x in enumerate(X_list):
        out[i, : x.shape[0]] = x
        n_real[i] = x.shape[0]
    return out, n_real


def train_fleet(states, X_list, *, lr, hyperbolic, batch_size, n_epochs,
                seed=0, seeds=None, log_cb=None, checkpoint_cb=None,
                start_epoch=None, epochs_per_call=10, ragged=None,
                return_staged=False, fused_critics=False, mesh=None,
                canonical=False, device="cuda"):
    """Train S models jointly, one batched step per fleet step.

    ``states``: a :class:`FleetState` on ``device`` (:func:`stack_states`,
    :func:`init_fleet_state`). ``X_list``: S (N_i, W) window arrays (numpy
    or tensors). ``seeds``: one seed per signal (a seed band), each signal
    drawing what ``train_tadgan(seed=seeds[i])`` draws; without it every
    signal draws from ``seed``.

    JAX's chunks and cadence (hypad_tpu/train/fleet.py:356-413): the
    epochs run in chunks of at most ``epochs_per_call``, each ending at
    every multiple of 10 and at epoch ``n_epochs - 1``. After a chunk its
    metrics come off the device in one copy, ``log_cb(epoch, metrics)``
    fires for each of its epochs with (S,) numpy metrics, and
    ``checkpoint_cb(epoch, states)`` fires where the chunk ends at a
    multiple of 10 or at ``n_epochs - 1``. ``start_epoch`` defaults to the
    state's epoch; given, it sets the state's epoch. Epoch e's draws are
    ``fleet_epoch_draws(seeds, e, ...)``, so no number of the run depends
    on ``epochs_per_call``. With no mesh, or a mesh of one device, the
    epochs run the fleet's step bodies (``train/graphed.py``
    ``FleetProgram``; on the card replayed CUDA graphs, on the CPU
    eagerly); on a mesh of more than one device each epoch runs
    ``fleet_epoch_device`` slab by slab, eagerly.

    ``ragged`` selects nothing here and exists only to keep JAX's
    signature: the port always runs the ragged body, whose draws are each
    signal's single-model draws, and an equal-length fleet simply has no
    step to mask. As in JAX, False on mixed lengths, on a fleet a mesh
    pads with dummies, or with ``canonical`` raises.

    ``return_staged``: also return the padded stack on the device,
    ``(states, (Xs, n_real))``, which ``detect_scores_fleet(staged=)``
    reuses when the family tests on its training windows; ``n_real``
    covers the real signals only, ``Xs`` may carry pad signals and (under
    ``canonical``) pad windows past them.

    ``fused_critics``: False (autograd, the default), "full" (K5 with a
    signal axis) or True (the fleet's generator forwards, then K4 with a
    signal axis); a truthy value on a mesh of more than one device raises
    JAX's ``ValueError`` before anything else.

    ``mesh`` and ``canonical``: the module docstring. With a mesh the
    states lie on its lead device, the ``device``; with ``canonical`` the
    metrics and states carry the pad signals too."""
    check_mesh_fused(fused_critics, mesh)
    device = resolve_device(device, mesh)
    S = len(X_list)
    if states.n_signals != S:
        raise ValueError(f"train_fleet: {states.n_signals} states for "
                         f"{S} signals")
    ref = next(iter(states.params.values()))
    if ref.device != device:
        raise ValueError(f"train_fleet: the states are on {ref.device}, "
                         f"not on {device}")
    X_list = [x.detach().cpu().numpy() if torch.is_tensor(x)
              else np.asarray(x, np.float32) for x in X_list]
    lens = {x.shape[0] for x in X_list}
    if seeds is not None and len(seeds) != S:
        raise ValueError(f"train_fleet: {len(seeds)} seeds for {S} signals")
    real_lens = np.asarray([x.shape[0] for x in X_list], np.int32)
    ndev = mesh.size if mesh is not None else 1
    n_pad, target_len = (-S) % ndev, None
    if canonical:
        from hypad_tpu_torch.detect.scorer import canonical_fleet_shape

        if ragged is False:
            raise ValueError("canonical shapes require the ragged stream")
        ragged = True
        S_c, target_len = canonical_fleet_shape(
            S, max(lens), X_list[0].shape[1], ndev)
        target_S = max(S_c, S)
        target_S += (-target_S) % ndev
        n_pad = target_S - S
    if seeds is not None and len(lens) == 1 and n_pad and ragged is not True:
        # an equal-length seed band on a mesh: replicas of the last signal
        # keep JAX's non-ragged stream (the caller ignores them)
        X_list = X_list + [X_list[-1]] * n_pad
        seeds = list(seeds) + [seeds[-1]] * n_pad
        states = _padded(states, S, n_pad)
        S, n_pad = len(X_list), 0
    if ragged is False and (len(lens) > 1 or n_pad):
        raise ValueError("mixed-length or mesh-padded fleets require "
                         "ragged mode")
    seeds = ([int(sd) for sd in seeds] if seeds is not None else [seed] * S)
    # mesh- and canonical-pad dummies: no real row, so no step; the last seed
    seeds += seeds[-1:] * n_pad
    Xs_host, n_real = pad_and_stack(
        X_list + [np.zeros((1, X_list[0].shape[1]), np.float32)] * n_pad,
        target_len=target_len)
    n_real[S:] = 0
    if n_pad:
        states = _padded(states, S, n_pad)
    Xs = torch.as_tensor(Xs_host, device=device)
    if start_epoch is not None:
        states.epoch = start_epoch
    sharded = mesh is not None and mesh.size > 1
    devs = dp_devices(mesh) if sharded else [device]
    slabs = row_slices(len(n_real), len(devs))
    parts = ([slice_state(states, sl, devs[i]) for i, sl in slabs]
             if sharded else [states])
    Xparts = [Xs[sl].to(devs[i]) for i, sl in slabs] if sharded else [Xs]

    def merged():
        return concat_states(parts, device) if sharded else parts[0]

    def draws(e):
        return fleet_epoch_draws(seeds, e, n_real, batch_size, states.params,
                                 n_pad=target_len)

    def eager_epoch(e):
        d, means = draws(e), []
        for k, (_, sl) in enumerate(slabs):
            parts[k], m = fleet_epoch_device(
                parts[k], Xparts[k], n_real[sl],
                {name: v[sl] for name, v in d.items()}, lr=lr,
                hyperbolic=hyperbolic, fused_critics=fused_critics)
            means.append(m.to(device))
        return fleet_metrics(torch.cat(means, dim=1).cpu().numpy())

    epoch = parts[0].epoch
    chunks = graphed.chunk_sizes(epoch, n_epochs, epochs_per_call)
    program = None if sharded or not chunks else graphed.fleet_program_for(
        states, Xs, n_real, lr=lr, hyperbolic=hyperbolic,
        batch_size=batch_size, fused_critics=fused_critics)
    for chunk in chunks:
        if sharded:
            metrics = [eager_epoch(epoch + j) for j in range(chunk)]
        else:
            metrics = program.run(states, (draws(epoch + j)
                                           for j in range(chunk)))
        if log_cb is not None:
            for j, m in enumerate(metrics):
                log_cb(epoch + j + 1, m)
        epoch += chunk
        if checkpoint_cb is not None and (epoch % 10 == 0
                                          or epoch == n_epochs - 1):
            checkpoint_cb(epoch, merged())
    states = merged()
    if return_staged:
        return states, (Xs, real_lens)
    return states


def _padded(states, S, n_pad):
    """``states`` with ``n_pad`` copies of its last signal appended."""
    return stack_states([unstack_state(states, i) for i in range(S)]
                        + [unstack_state(states, S - 1)] * n_pad)
