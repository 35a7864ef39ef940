"""Checkpoints of the whole training state, and the config snapshot.

Port of ``hypad_tpu.utils.checkpoint``, in the port's own format: a
checkpoint is one ``state_{tag}.pt`` file (``tag`` an epoch or ``final``)
holding the :class:`~hypad_tpu_torch.train.trainer.TrainState` as a dict
of CPU tensors and ints: the parameters (``state_dict`` keys), both
critics' packed Adam moments, the generator's Riemannian Adam per-leaf
moments (packed Adam when Euclidean), the step counters and the epoch. It
is written with ``torch.save`` through a temporary file and
``os.replace``, and read with ``weights_only=True``, so loading runs no
pickled code.

The JAX package's orbax checkpoints (``state_{tag}`` directories) are not
read here: restore one with ``hypad_tpu.utils.checkpoint.restore_state`` and
carry it over with ``train.state_bridge.train_state_from_jax``.
"""

from __future__ import annotations

import os
import re
import shutil

import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.bridge import model_from_state_dict
from hypad_tpu_torch.optim.radam import AdamState, RAdamState
from hypad_tpu_torch.train.trainer import TrainState

_EPOCH_FILE = re.compile(r"^state_([0-9]+)\.pt$")


def checkpoint_path(run_dir, tag):
    return os.path.abspath(os.path.join(run_dir, f"state_{tag}.pt"))


def _cpu(t):
    return t.detach().to("cpu", copy=True)


def _opt_to_dict(opt):
    if isinstance(opt, RAdamState):
        return {"step": int(opt.step),
                "mu": {k: _cpu(v) for k, v in opt.mu.items()},
                "nu": {k: _cpu(v) for k, v in opt.nu.items()}}
    return {"step": int(opt.step), "mu": _cpu(opt.mu), "nu": _cpu(opt.nu)}


def _opt_from_dict(d, device):
    if isinstance(d["mu"], dict):
        return RAdamState(step=int(d["step"]),
                          mu={k: v.to(device) for k, v in d["mu"].items()},
                          nu={k: v.to(device) for k, v in d["nu"].items()})
    return AdamState(step=int(d["step"]), mu=d["mu"].to(device),
                     nu=d["nu"].to(device))


def save_state(run_dir, state: TrainState, tag):
    """Write ``state`` to ``run_dir/state_{tag}.pt``; returns the path."""
    os.makedirs(run_dir, exist_ok=True)
    path = checkpoint_path(run_dir, tag)
    blob = {"params": {k: _cpu(v) for k, v in
                       state.model.state_dict().items()},
            "opt_cx": _opt_to_dict(state.opt_cx),
            "opt_cz": _opt_to_dict(state.opt_cz),
            "opt_gen": _opt_to_dict(state.opt_gen),
            "epoch": int(state.epoch)}
    tmp = path + ".tmp"
    try:
        torch.save(blob, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def restore_state(run_dir, tag, device="cuda") -> TrainState:
    """The :class:`TrainState` of ``run_dir/state_{tag}.pt`` on
    ``device``."""
    device = resolve_device(device)
    blob = torch.load(checkpoint_path(run_dir, tag), map_location="cpu",
                      weights_only=True)
    return TrainState(model=model_from_state_dict(blob["params"], device),
                      opt_cx=_opt_from_dict(blob["opt_cx"], device),
                      opt_cz=_opt_from_dict(blob["opt_cz"], device),
                      opt_gen=_opt_from_dict(blob["opt_gen"], device),
                      epoch=int(blob["epoch"]))


def latest_epoch_tag(run_dir):
    """The highest epoch of a ``state_{epoch}.pt`` in ``run_dir``, or None.
    ``state_final.pt`` and the JAX package's orbax directories are not
    counted."""
    if not os.path.isdir(run_dir):
        return None
    tags = [int(m.group(1)) for m in map(_EPOCH_FILE.match,
                                         os.listdir(run_dir)) if m]
    return max(tags) if tags else None


def snapshot_config(run_dir, config_path):
    """Copy the config file into the run directory as ``config.yaml``."""
    os.makedirs(run_dir, exist_ok=True)
    if config_path and os.path.isfile(config_path):
        shutil.copy(config_path, os.path.join(run_dir, "config.yaml"))
