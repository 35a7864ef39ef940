"""Adam and Riemannian Adam for the Poincare ball, in PyTorch.

Port of ``hypad_tpu.optim.radam``. Parameters are a dict of tensors keyed
like the port's ``state_dict`` (``"decoder.hyperbolic_linear.b"``), and
``update`` writes the new values into those tensors in place, which keeps
the module's parameters where they are. Both optimizers follow the JAX
arithmetic order step by step, so they are not ``torch.optim.Adam``:

* ``adam``: the moments are two flat vectors, the leaves concatenated in
  the JAX pytree's leaf order (:func:`jax_leaf_order`), so a JAX
  ``PackedAdamState`` carries across unchanged. Per element:
  ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + ((1-b2) g) g``,
  ``p -= (lr (mu/bc1)) / (sqrt(nu/bc2) + eps)``.
* ``riemannian_adam``: per-leaf moments; per step and leaf
  1. ``g += weight_decay * p`` (every leaf, LSTM ``w_hh`` included);
  2. ``rg = egrad2rgrad(p, g)`` on the ball leaf, ``g`` elsewhere;
  3. ``mu = b1 mu + (1-b1) rg``;
  4. ``nu = b2 nu + (1-b2) inner``, with ``inner = lambda_p^2 ||rg||^2``
     broadcast on the ball leaf and ``rg rg`` elsewhere (so here the
     square comes first, unlike Adam's ``((1-b2) g) g``);
  5. ``denom = sqrt(nu/bc2) + eps``;
  6. ``dir = (mu/bc1) / denom``;
  7. ``p_new = retr(p, -lr dir)`` on the ball (``p + (-lr dir)`` elsewhere);
  8. ``mu = parallel_transport(p, p_new, mu)`` on the ball;
  9. every ``stabilize`` steps, ``p_new = project(p_new)`` on the ball.

The only ball leaf of the model is ``decoder.hyperbolic_linear.b``
(:func:`manifold_mask`). The Euclidean leaves are updated packed into one
flat tensor, one launch per op for all leaves. The step counter is a Python
int and the bias corrections ``1 - b ** step`` are computed in float32 on
the host, as the JAX optimizers compute them, so an update needs no device
sync.

Each update is written once, for a fleet's stacked leaves (a leading
signal axis S, ``adam_fleet`` / ``riemannian_adam_fleet``), whose
arithmetic takes any leading axes; a single model's optimizer is that
update on its own leaves with every step taken (:func:`_single`), its
coefficients Python floats.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from hypad_tpu_torch.manifold import stereographic as st


def jax_leaf_order(names):
    """``names`` ("decoder.lstm.0.w_ih", ...) in the order
    ``jax.tree_util`` flattens the same pytree: dict keys sorted, list
    entries by index."""
    def key(name):
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                     for p in name.split("."))
    return sorted(names, key=key)


def manifold_mask(names):
    """{name: True} for leaves on the Poincare ball: the MobiusLinear bias."""
    return {n: n.split(".")[-2:] == ["hyperbolic_linear", "b"]
            for n in names}


def _bias_correction(b, step):
    """1 - b**step in float32, as a Python float (exactly the f32 value)."""
    one = torch.tensor(1.0, dtype=torch.float32)
    bt = torch.tensor(b, dtype=torch.float32) ** torch.tensor(
        float(step), dtype=torch.float32)
    return float(one - bt)


@dataclass
class AdamState:
    """Packed Adam state: ``mu``/``nu`` flat, leaves in JAX leaf order."""
    step: int
    mu: torch.Tensor
    nu: torch.Tensor


@dataclass
class RAdamState:
    """Riemannian Adam state: per-leaf moments keyed by parameter name."""
    step: int
    mu: dict
    nu: dict


class Optimizer:
    """An ``init(params) -> state`` / ``update(grads, state, params) ->
    state`` pair; ``update`` writes the new parameters in place."""

    def __init__(self, init, update):
        self.init = init
        self.update = update


# ---------------------------------------------------------------------------
# fleets: stacked leaves with a leading signal axis S
# ---------------------------------------------------------------------------
#
# A fleet trains S models in one batched step (train/fleet.py). Each leaf is
# (S, ...) and the moments are stacked alike: Adam's (S, P), Riemannian
# Adam's per-leaf (S, ...). In a ragged fleet a signal skips the steps past
# its own schedule, so the step counters are per signal, (S,) on the host,
# and so are the bias corrections and the stabilize select. They are made
# for a whole pass at once (:func:`fleet_schedule`), so no update copies
# anything to the device. A skipped step keeps that signal's parameters,
# moments and counter exactly; every other value is each signal's
# single-model update: a single model's optimizer is this update on leaves
# without the signal axis (:func:`_single`), with Python float coefficients
# (:class:`_OneStep`).
# Where it divides by such a float, PyTorch's CUDA division multiplies by
# the float's f32 reciprocal instead (a CPU scalar divisor); the fleet does
# the same on the card with the reciprocals' tables (``_div_bc``), so that a
# signal's update gives its single-model bits on either device.


@functools.lru_cache(maxsize=4096)
def _bias_correction_cached(b, step):
    return _bias_correction(b, step)


@dataclass
class FleetSchedule:
    """Per-step, per-signal coefficients of one pass of ``n`` steps:
    ``valid`` (n, S) bool on the host and the device, ``bc1``/``bc2``
    (n, S) f32 (``_bias_correction``'s values at each signal's own step),
    ``stab`` (n, S) bool (that step is a multiple of ``stabilize``);
    ``inv1``/``inv2`` the f32 reciprocals of ``bc1``/``bc2``."""
    valid_host: np.ndarray
    all_valid: np.ndarray    # (n,) every signal takes step j
    valid: torch.Tensor
    bc1: torch.Tensor
    bc2: torch.Tensor
    stab: torch.Tensor
    inv1: torch.Tensor
    inv2: torch.Tensor

    @property
    def lead(self):
        """The leaves' leading axes: (S,)."""
        return self.valid_host.shape[1:]

    def at(self, j):
        """Step ``j``'s (bc1, inv1, bc2, inv2, stab), each (S,)."""
        return (self.bc1[j], self.inv1[j], self.bc2[j], self.inv2[j],
                self.stab[j])


class _OneStep:
    """The schedule of one single-model step: leaves with no signal axis,
    the step taken, and its coefficients Python floats (the exact f32
    values), so the update copies nothing to the device."""
    valid_host = np.ones((1,), bool)
    all_valid = (True,)
    lead = ()

    def __init__(self, step, b1, b2, stabilize):
        self.coefficients = (
            _bias_correction_cached(b1, step), None,
            _bias_correction_cached(b2, step), None,
            bool(stabilize) and step % stabilize == 0)

    def at(self, j):
        return self.coefficients


def fleet_schedule(step0, valid, device, b1=0.9, b2=0.999, stabilize=None):
    """The :class:`FleetSchedule` of a pass whose signals stand at steps
    ``step0`` (S,) and take the steps where ``valid`` (n, S) is True."""
    valid = np.asarray(valid, bool)
    steps = np.asarray(step0, np.int64)[None, :] + np.cumsum(valid, axis=0)
    # a skipped step's coefficients are never used; give it the next step's
    steps = np.where(valid, steps, steps + 1)
    bc1 = [[_bias_correction_cached(b1, int(s)) for s in row] for row in steps]
    bc2 = [[_bias_correction_cached(b2, int(s)) for s in row] for row in steps]
    stab = (steps % stabilize == 0) if stabilize else np.zeros_like(valid)
    bc1, bc2 = np.asarray(bc1, np.float32), np.asarray(bc2, np.float32)
    one = np.float32(1)
    to = functools.partial(torch.as_tensor, device=device)
    return FleetSchedule(
        valid_host=valid, all_valid=valid.all(axis=1),
        valid=to(valid), bc1=to(bc1), bc2=to(bc2), stab=to(stab),
        inv1=to(one / bc1), inv2=to(one / bc2))


def _signal_shaped(v, t):
    """(S,) ``v`` viewed to broadcast against a leaf ``t`` (S, ...)."""
    return v.view((-1,) + (1,) * (t.dim() - 1))


def _div_bc(x, bc, inv):
    """``x / bc`` as a single model's ``x / float`` computes it: true
    division on the CPU; on the card PyTorch multiplies by the float's f32
    reciprocal, which a fleet does with the reciprocals ``inv``."""
    if isinstance(bc, float):
        return x / bc
    if x.device.type == "cuda":
        return x * _signal_shaped(inv, x)
    return x / _signal_shaped(bc, x)


def _project_where(stab, p, k):
    """``p`` projected onto the ball where ``stab`` (a bool, or (S,))."""
    if isinstance(stab, bool):
        return st.project(p, k) if stab else p
    return torch.where(_signal_shaped(stab, p), st.project(p, k), p)


def _masked(sched, j, new, old):
    """``new`` where signal takes step ``j``, else ``old``."""
    if sched.all_valid[j]:
        return new
    return torch.where(_signal_shaped(sched.valid[j], new), new, old)


def _pack(tensors, names, lead):
    """The leaves ``names`` flattened behind their leading axes ``lead``
    ((S,) or none) and concatenated: (*lead, P)."""
    return torch.cat([tensors[n].reshape(*lead, -1) for n in names], dim=-1)


def _sizes(tensors, names, lead):
    n_lead = int(np.prod(lead))
    return [tensors[n].numel() // n_lead for n in names]


def _unpack_into(dst, names, packed, lead):
    """Write the (*lead, P) ``packed`` back into the leaves ``dst[n]``."""
    torch._foreach_copy_([dst[n] for n in names],
                         [v.view_as(dst[n]) for v, n in zip(
                             packed.split(_sizes(dst, names, lead), dim=-1),
                             names)])


def _unpack(like, names, packed, lead):
    return {n: v.reshape(like[n].shape) for v, n in zip(
        packed.split(_sizes(like, names, lead), dim=-1), names)}


class FleetOptimizer:
    """``init(params) -> state``, ``schedule(state, valid) ->``
    :class:`FleetSchedule`, ``update(grads, state, params, sched, j) ->
    state``: step ``j`` of a pass, writing the parameters in place."""

    def __init__(self, init, schedule, update):
        self.init = init
        self.schedule = schedule
        self.update = update


def adam_fleet(lr, b1=0.9, b2=0.999, eps=1e-8):
    """Plain Adam for stacked leaves: packed moments (S, P), counters (S,)
    (the critics' optimizer, and the generator's when Euclidean)."""

    def init(params):
        order = jax_leaf_order(params)
        ref = params[order[0]]
        S = ref.shape[0]
        size = sum(params[n][0].numel() for n in order)
        zeros = functools.partial(torch.zeros, (S, size), dtype=ref.dtype,
                                  device=ref.device)
        return AdamState(step=np.zeros(S, np.int64), mu=zeros(), nu=zeros())

    def schedule(state, valid):
        return fleet_schedule(state.step, valid, state.mu.device, b1, b2)

    @torch.no_grad()
    def update(grads, state, params, sched, j):
        order = jax_leaf_order(params)
        lead = sched.lead
        bc1, inv1, bc2, inv2, _ = sched.at(j)
        g = _pack(grads, order, lead)
        mu = b1 * state.mu + (1.0 - b1) * g
        nu = b2 * state.nu + (1.0 - b2) * g * g
        denom = torch.sqrt(_div_bc(nu, bc2, inv2)) + eps
        p_vec = _pack(params, order, lead)
        p_new = p_vec - lr * _div_bc(mu, bc1, inv1) / denom
        _unpack_into(params, order, _masked(sched, j, p_new, p_vec), lead)
        return AdamState(step=state.step + sched.valid_host[j],
                         mu=_masked(sched, j, mu, state.mu),
                         nu=_masked(sched, j, nu, state.nu))

    return FleetOptimizer(init, schedule, update)


def riemannian_adam_fleet(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                          stabilize=None, k=-1.0):
    """Riemannian Adam for stacked leaves (the hyperbolic generator's
    optimizer: wd 1e-5, ``stabilize`` 10): per-leaf moments (S, ...),
    counters (S,). The Euclidean leaves are updated packed into one (S, P)
    tensor."""

    def init(params):
        S = next(iter(params.values())).shape[0]
        return RAdamState(
            step=np.zeros(S, np.int64),
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()})

    def schedule(state, valid):
        ref = next(iter(state.mu.values()))
        return fleet_schedule(state.step, valid, ref.device, b1, b2,
                              stabilize)

    @torch.no_grad()
    def update(grads, state, params, sched, j):
        mask = manifold_mask(params)
        mu, nu = dict(state.mu), dict(state.nu)
        bc1, inv1, bc2, inv2, stab = sched.at(j)

        eucl = [n for n in params if not mask[n]]
        if eucl:
            lead = sched.lead
            p = _pack(params, eucl, lead)
            mu0, nu0 = (_pack(state.mu, eucl, lead),
                        _pack(state.nu, eucl, lead))
            g = _pack(grads, eucl, lead) + p * weight_decay
            m = mu0 * b1 + g * (1.0 - b1)
            gg = g * g
            gg *= 1.0 - b2
            v = nu0 * b2 + gg
            denom = _div_bc(v, bc2, inv2)
            denom.sqrt_()
            denom += eps
            direction = _div_bc(m, bc1, inv1)
            direction /= denom
            p_new = p + direction * -lr
            _unpack_into(params, eucl, _masked(sched, j, p_new, p), lead)
            mu.update(_unpack(params, eucl, _masked(sched, j, m, mu0), lead))
            nu.update(_unpack(params, eucl, _masked(sched, j, v, nu0), lead))

        for n in (n for n in params if mask[n]):
            p = params[n]
            g = grads[n] + weight_decay * p
            rg = st.egrad2rgrad(p, g, k)
            inner = st.lambda_x(p, k, keepdim=True) ** 2 * torch.sum(
                rg * rg, dim=-1, keepdim=True)
            m = b1 * mu[n] + (1.0 - b1) * rg
            v = b2 * nu[n] + (1.0 - b2) * inner.expand_as(rg)
            denom = torch.sqrt(_div_bc(v, bc2, inv2)) + eps
            direction = _div_bc(m, bc1, inv1) / denom
            p_new = st.retr(p, -lr * direction, k)
            m_new = st.parallel_transport(p, p_new, m, k)
            if stabilize is not None:
                p_new = _project_where(stab, p_new, k)
            mu[n] = _masked(sched, j, m_new, mu[n])
            nu[n] = _masked(sched, j, v, nu[n])
            p.copy_(_masked(sched, j, p_new, p))
        return RAdamState(step=state.step + sched.valid_host[j], mu=mu, nu=nu)

    return FleetOptimizer(init, schedule, update)


def _lift(x):
    """A leaf dict or packed vector with a leading signal axis of 1 (the
    fleet's ``init`` takes a signal axis)."""
    if isinstance(x, dict):
        return {n: v[None] for n, v in x.items()}
    return x[None]


def _drop(x):
    if isinstance(x, dict):
        return {n: v[0] for n, v in x.items()}
    return x[0]


def _single(fleet, b1, b2, stabilize=None):
    """The single-model :class:`Optimizer` of the fleet optimizer
    ``fleet``: its update on leaves without a signal axis, every step
    taken."""

    def init(params):
        state = fleet.init(_lift(params))
        return type(state)(step=0, mu=_drop(state.mu), nu=_drop(state.nu))

    def update(grads, state, params):
        step = state.step + 1
        new = fleet.update(grads, state, params,
                           _OneStep(step, b1, b2, stabilize), 0)
        return type(state)(step=step, mu=new.mu, nu=new.nu)

    return Optimizer(init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8):
    """:func:`adam_fleet` for one model: moments packed in JAX leaf order,
    a Python int step."""
    return _single(adam_fleet(lr, b1, b2, eps), b1, b2)


def riemannian_adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                    stabilize=None, k=-1.0):
    """:func:`riemannian_adam_fleet` for one model: per-leaf moments, a
    Python int step."""
    return _single(riemannian_adam_fleet(lr, b1, b2, eps, weight_decay,
                                         stabilize, k), b1, b2, stabilize)
