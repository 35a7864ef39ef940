"""A whole training state between the JAX package and the port.

``train_state_to_jax`` / ``train_state_from_jax`` carry the parameters, the
critics' packed Adam moments (flat, in the JAX leaf order, which the port
keeps too), the generator's Riemannian Adam per-leaf moments (or packed Adam
moments when Euclidean), the optimizer step counters and the epoch. The JAX
side is the ``TrainState`` NamedTuple of ``PackedAdamState`` /
``RAdamState`` tuples, read by field name; the port side is
:class:`hypad_tpu_torch.train.trainer.TrainState`. The parameters go
through the weight bridge (``hypad_tpu_torch.bridge``).

``fleet_state_to_jax`` / ``fleet_state_from_jax`` do the same for a fleet:
JAX's stacked ``TrainState`` (``init_fleet_state`` or ``train_fleet``'s
result, every leaf with a leading signal axis S, step counters (S,)) and
the port's :class:`hypad_tpu_torch.train.fleet.FleetState`.
"""

from __future__ import annotations

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.bridge import (
    flatten_tree,
    from_jax_params,
    to_jax_params,
    unflatten_tree,
)
from hypad_tpu_torch.optim.radam import AdamState, RAdamState
from hypad_tpu_torch.train.trainer import TrainState


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _opt_to_jax(opt):
    if isinstance(opt, RAdamState):
        def tree(moments):
            return unflatten_tree({k.replace(".", "/"): v.detach().cpu()
                                   .numpy() for k, v in moments.items()})
        mu, nu = tree(opt.mu), tree(opt.nu)
    else:
        mu, nu = (opt.mu.detach().cpu().numpy(),
                  opt.nu.detach().cpu().numpy())
    return {"step": np.asarray(opt.step, np.int32), "mu": mu, "nu": nu}


def _opt_from_jax(opt, device, stacked=False):
    step = np.asarray(_field(opt, "step"))
    step = step.astype(np.int64) if stacked else int(step)
    mu, nu = _field(opt, "mu"), _field(opt, "nu")

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    if isinstance(mu, dict):
        def moments(tree):
            return {k.replace("/", "."): tensor(v)
                    for k, v in flatten_tree(tree).items()}
        return RAdamState(step=step, mu=moments(mu), nu=moments(nu))
    return AdamState(step=step, mu=tensor(mu), nu=tensor(nu))


def train_state_to_jax(state):
    """{"params", "opt_cx", "opt_cz", "opt_gen", "epoch"} as numpy: each
    optimizer a {"step", "mu", "nu"} dict with the JAX state's fields."""
    return {"params": to_jax_params(state.model),
            "opt_cx": _opt_to_jax(state.opt_cx),
            "opt_cz": _opt_to_jax(state.opt_cz),
            "opt_gen": _opt_to_jax(state.opt_gen),
            "epoch": np.int32(state.epoch)}


def train_state_from_jax(jax_state, device="cuda"):
    """The port's ``TrainState`` from a JAX ``TrainState`` (or the dict
    :func:`train_state_to_jax` gives), on ``device``."""
    device = resolve_device(device)
    params = _field(jax_state, "params")
    return TrainState(
        model=from_jax_params(params, device=device),
        opt_cx=_opt_from_jax(_field(jax_state, "opt_cx"), device),
        opt_cz=_opt_from_jax(_field(jax_state, "opt_cz"), device),
        opt_gen=_opt_from_jax(_field(jax_state, "opt_gen"), device),
        epoch=int(np.asarray(_field(jax_state, "epoch"))))


def fleet_state_to_jax(fleet):
    """{"params", "opt_cx", "opt_cz", "opt_gen", "epoch"} as numpy with a
    leading signal axis; step counters (S,) int32, as JAX's stacked
    ``TrainState`` holds them (its ``epoch`` is (S,) as well)."""
    from hypad_tpu_torch.bridge import to_jax_stacked_params

    S = fleet.n_signals
    return {"params": to_jax_stacked_params(fleet.params),
            "opt_cx": _opt_to_jax(fleet.opt_cx),
            "opt_cz": _opt_to_jax(fleet.opt_cz),
            "opt_gen": _opt_to_jax(fleet.opt_gen),
            "epoch": np.full((S,), fleet.epoch, np.int32)}


def fleet_state_from_jax(jax_state, device="cuda"):
    """The port's ``FleetState`` from JAX's stacked ``TrainState`` (or the
    dict :func:`fleet_state_to_jax` gives), on ``device``. The fleet's
    epoch is the first signal's."""
    from hypad_tpu_torch.bridge import from_jax_stacked_params
    from hypad_tpu_torch.train.fleet import FleetState

    device = resolve_device(device)
    epoch = np.asarray(_field(jax_state, "epoch")).reshape(-1)
    return FleetState(
        params=from_jax_stacked_params(_field(jax_state, "params"), device),
        opt_cx=_opt_from_jax(_field(jax_state, "opt_cx"), device, True),
        opt_cz=_opt_from_jax(_field(jax_state, "opt_cz"), device, True),
        opt_gen=_opt_from_jax(_field(jax_state, "opt_gen"), device, True),
        epoch=int(epoch[0]))
