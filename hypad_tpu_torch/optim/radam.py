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
(:func:`manifold_mask`). The Euclidean leaves go through ``torch._foreach_*``
ops, one launch per op for all leaves. The step counter is a Python int and
the bias corrections ``1 - b ** step`` are computed in float32 on the host,
as the JAX optimizers compute them, so an update needs no device sync.
"""

from __future__ import annotations

from dataclasses import dataclass

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


def adam(lr, b1=0.9, b2=0.999, eps=1e-8):
    """Plain Adam with packed moments (the critics' optimizer, and the
    generator's when Euclidean)."""

    def init(params):
        order = jax_leaf_order(params)
        size = sum(params[n].numel() for n in order)
        ref = params[order[0]]
        return AdamState(step=0,
                         mu=torch.zeros(size, dtype=ref.dtype,
                                        device=ref.device),
                         nu=torch.zeros(size, dtype=ref.dtype,
                                        device=ref.device))

    @torch.no_grad()
    def update(grads, state, params):
        order = jax_leaf_order(params)
        step = state.step + 1
        bc1 = _bias_correction(b1, step)
        bc2 = _bias_correction(b2, step)
        g = torch.cat([grads[n].reshape(-1) for n in order])
        mu = b1 * state.mu + (1.0 - b1) * g
        nu = b2 * state.nu + (1.0 - b2) * g * g
        denom = torch.sqrt(nu / bc2) + eps
        p_vec = torch.cat([params[n].reshape(-1) for n in order])
        p_new = p_vec - lr * (mu / bc1) / denom
        torch._foreach_copy_(
            [params[n] for n in order],
            [v.view_as(params[n]) for v, n in zip(
                p_new.split([params[n].numel() for n in order]), order)])
        return AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def riemannian_adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                    stabilize=None, k=-1.0):
    """Riemannian Adam (the hyperbolic generator's optimizer: wd 1e-5,
    ``stabilize`` 10)."""

    def init(params):
        return RAdamState(
            step=0,
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        bc1 = _bias_correction(b1, step)
        bc2 = _bias_correction(b2, step)
        mask = manifold_mask(params)
        mu, nu = dict(state.mu), dict(state.nu)

        eucl = [n for n in params if not mask[n]]
        if eucl:
            p = [params[n] for n in eucl]
            g = torch._foreach_add([grads[n] for n in eucl],
                                   torch._foreach_mul(p, weight_decay))
            m = torch._foreach_add(torch._foreach_mul([mu[n] for n in eucl],
                                                      b1),
                                   torch._foreach_mul(g, 1.0 - b1))
            gg = torch._foreach_mul(g, g)
            torch._foreach_mul_(gg, 1.0 - b2)
            v = torch._foreach_add(torch._foreach_mul([nu[n] for n in eucl],
                                                      b2), gg)
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            direction = torch._foreach_div(m, bc1)
            torch._foreach_div_(direction, denom)
            torch._foreach_add_(p, torch._foreach_mul(direction, -lr))
            mu.update(zip(eucl, m))
            nu.update(zip(eucl, v))

        for n in (n for n in params if mask[n]):
            p = params[n]
            g = grads[n] + weight_decay * p
            rg = st.egrad2rgrad(p, g, k)
            inner = st.lambda_x(p, k, keepdim=True) ** 2 * torch.sum(
                rg * rg, dim=-1, keepdim=True)
            m = b1 * mu[n] + (1.0 - b1) * rg
            v = b2 * nu[n] + (1.0 - b2) * inner.expand_as(rg)
            denom = torch.sqrt(v / bc2) + eps
            direction = (m / bc1) / denom
            p_new = st.retr(p, -lr * direction, k)
            mu[n] = st.parallel_transport(p, p_new, m, k)
            nu[n] = v
            if stabilize is not None and step % stabilize == 0:
                p_new = st.project(p_new, k)
            p.copy_(p_new)
        return RAdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)
