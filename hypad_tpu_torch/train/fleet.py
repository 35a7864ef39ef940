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
* :func:`train_fleet` keeps JAX's checkpoint cadence (every 10th epoch and
  epoch ``n_epochs - 1``, where its chunks end) and its ``log_cb`` /
  ``checkpoint_cb`` / ``return_staged`` contract.

Not ported, on purpose: JAX's ``SINGLE_EPOCH_MAX_S`` slicing
(``_single_epoch_sliced``) works round a v5e code-generation fault that no
CUDA launch has, and ``epochs_per_call`` fuses epochs into one XLA program,
which changes no number; the port runs epoch by epoch. ``mesh`` (a fleet
over several cards) is ROADMAP A13 and ``canonical`` (the JAX compile
cache's padded shapes) the rest of A10; both raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.bridge import model_from_state_dict
from hypad_tpu_torch.optim.radam import AdamState, RAdamState
from hypad_tpu_torch.train.trainer import (
    TrainState,
    fleet_epoch_draws,
    init_train_state,
    run_fleet_epoch,
)


@dataclass
class FleetState:
    """S models' parameters and optimizer states, stacked.

    ``params``: {state_dict name: (S, ...) tensor}; the optimizer states
    are ``AdamState`` / ``RAdamState`` with (S, ...) moments and (S,) int64
    numpy step counters; ``epoch`` is the fleet's."""
    params: dict
    opt_cx: AdamState
    opt_cz: AdamState
    opt_gen: object
    epoch: int

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


def pad_and_stack(X_list, pad_value=0.0):
    """Pad (N_i, W) window arrays to the longest N and stack: ((S, N, W)
    float32 numpy, n_real (S,) int32). No valid step reads a pad row."""
    n_max = max(x.shape[0] for x in X_list)
    out = np.full((len(X_list), n_max, X_list[0].shape[1]), pad_value,
                  np.float32)
    n_real = np.zeros((len(X_list),), np.int32)
    for i, x in enumerate(X_list):
        out[i, : x.shape[0]] = x
        n_real[i] = x.shape[0]
    return out, n_real


def train_fleet(states, X_list, *, lr, hyperbolic, batch_size, n_epochs,
                seed=0, seeds=None, log_cb=None, checkpoint_cb=None,
                start_epoch=None, ragged=None, return_staged=False,
                fused_critics="full", mesh=None, canonical=False,
                device="cuda"):
    """Train S models jointly, one batched step per fleet step.

    ``states``: a :class:`FleetState` on ``device`` (:func:`stack_states`,
    :func:`init_fleet_state`). ``X_list``: S (N_i, W) window arrays (numpy
    or tensors). ``seeds``: one seed per signal (a seed band), each signal
    drawing what ``train_tadgan(seed=seeds[i])`` draws; without it every
    signal draws from ``seed``. ``log_cb(epoch, metrics)`` gets (S,)
    metrics after every epoch; ``checkpoint_cb(epoch, states)`` fires at
    every 10th epoch and at epoch ``n_epochs - 1`` (JAX's chunk ends).
    ``start_epoch`` defaults to the state's epoch.

    ``ragged`` selects nothing here and exists only to keep JAX's
    signature: the port always runs the ragged body, whose draws are each
    signal's single-model draws, and an equal-length fleet simply has no
    step to mask. As in JAX, False on mixed lengths raises.

    ``return_staged``: also return the padded stack on the device,
    ``(states, (Xs, n_real))``, which ``detect_scores_fleet(staged=)``
    reuses when the family tests on its training windows.

    ``fused_critics``: "full" (K5 with a signal axis), True (the fleet's
    generator forwards, then K4 with a signal axis) or False (autograd)."""
    if mesh is not None:
        raise NotImplementedError("train_fleet over several cards (mesh) is "
                                  "not ported yet (ROADMAP A13)")
    if canonical:
        raise NotImplementedError("canonical fleet shapes are not ported "
                                  "(ROADMAP A10): the port compiles no "
                                  "shape-keyed programs")
    device = resolve_device(device)
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
    if ragged is False and len(lens) > 1:
        raise ValueError("mixed-length fleets require ragged mode")
    if seeds is not None and len(seeds) != S:
        raise ValueError(f"train_fleet: {len(seeds)} seeds for {S} signals")
    seeds = [int(sd) for sd in seeds] if seeds is not None else [seed] * S
    Xs_host, n_real = pad_and_stack(X_list)
    Xs = torch.as_tensor(Xs_host, device=device)
    if start_epoch is not None:
        states.epoch = start_epoch
    while states.epoch < n_epochs:
        draws = fleet_epoch_draws(seeds, states.epoch, n_real, batch_size,
                                  states.params)
        states, metrics = run_fleet_epoch(states, Xs, n_real, draws, lr=lr,
                                          hyperbolic=hyperbolic,
                                          fused_critics=fused_critics)
        if log_cb is not None:
            log_cb(states.epoch, metrics)
        # JAX's chunks end at every 10th epoch and at epoch n - 1, where
        # its checkpoints fall (hypad_tpu/train/fleet.py:355-366)
        if checkpoint_cb is not None and (states.epoch % 10 == 0
                                          or states.epoch == n_epochs - 1):
            checkpoint_cb(states.epoch, states)
    if return_staged:
        return states, (Xs, n_real)
    return states
