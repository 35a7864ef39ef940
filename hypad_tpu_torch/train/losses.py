"""The WGAN-GP losses of one training step, with pregenerated draws.

Port of ``hypad_tpu.train.trainer`` ``critic_x_loss``, ``critic_z_loss``
and ``generator_loss``. Every random draw (latent ``z``, the GP's
elementwise ``alpha``, the dropout keep-masks) is an argument, so the same
numpy draws give the same losses here and in JAX. As there:

* each critic runs once on stacked (3B, .) rows: the B "valid" rows, the B
  "fake" rows and the B gradient-penalty interpolates;
* the gradient penalty is ``10 (||g|| - 1)^2`` with ONE L2 norm over the
  whole flattened (B, .) input gradient ``g`` of ``sum(C(interp))``, plus
  1e-12 under the root; ``g`` comes from ``torch.autograd.grad(...,
  create_graph=True)`` so the loss's parameter gradient has its second-order
  part;
* critic_x's Wasserstein term is ``mean(fake) - mean(valid)``; critic_z's is
  flipped: its first B rows are E(x), its second B rows the prior draws;
* when hyperbolic, critic_x sees Poincare-ball coordinates as fake while the
  valid rows stay the raw (-1, 1) signal;
* the generator loss runs the decoder once on stacked (2B) rows (prior z
  and E(x)) and adds 10x the reconstruction: ``sum(acosh distance) / B``
  to MobiusLinear(x) when hyperbolic, the MSE otherwise.

The generator is frozen in a critic step, so its forwards there run without
a graph.

Each loss is written once for any leading axes: rows lie on axis -2, and
the means and the gradient penalty's norm reduce the last two axes. A
single model's tensors have none; a fleet's (``train/fleet.py``) carry a
leading signal axis S, and its losses come back (S,), one GP norm a
signal. :class:`Forwards` names the forwards a loss runs: the model's
modules (:func:`model_forwards`), the same split over a device mesh's
``dp`` slabs (:func:`mesh_forwards`), or the batched forwards of
``models/fleet.py`` over stacked parameters (:func:`fleet_forwards`).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from hypad_tpu_torch.manifold import stereographic as st

N_CRITICS = 5          # full critic passes per epoch
GP_WEIGHT = 10.0
REC_WEIGHT = 10.0
GP_NORM_EPS = 1e-12
_ROWS = (-2, -1)       # a loss's reductions: rows and features


class Forwards(NamedTuple):
    """The forwards a loss runs. ``decoder(z, m_dec)`` takes the
    inter-layer keep-mask as the batch's rows carry it ((..., N, 128));
    ``head`` is the MobiusLinear head (None when Euclidean)."""
    encoder: Callable
    decoder: Callable
    critic_x: Callable
    critic_z: Callable
    head: Callable | None


def model_forwards(model):
    """One model's modules as :class:`Forwards`."""
    dec = model["decoder"]
    return Forwards(model["encoder"], lambda z, m: dec(z, m[None, None]),
                    model["critic_x"], model["critic_z"],
                    getattr(dec, "hyperbolic_linear", None))


def mesh_forwards(model, mesh):
    """One model's modules as :class:`Forwards` over ``mesh``
    (``parallel/mesh.py``): each forward's rows (axis -2 of every tensor
    argument, the keep-masks' too) split into the mesh's ``dp`` slabs, each
    slab run on its device with differentiable copies of the parameters,
    the outputs gathered to the lead device, where the losses reduce the
    whole batch. A gradient through them sums every copy's into the
    model's parameters."""
    from hypad_tpu_torch.parallel.mesh import map_rows, on_device

    def sharded(fn):
        return lambda *args: map_rows(
            mesh, lambda dev, *a: on_device(model, dev, fn, *a), *args,
            axis=-2)

    head = getattr(model["decoder"], "hyperbolic_linear", None)
    return Forwards(
        sharded(lambda m, x: m["encoder"](x)),
        sharded(lambda m, z, mk: m["decoder"](z, mk[None, None])),
        sharded(lambda m, x, mk: m["critic_x"](x, mk)),
        sharded(lambda m, z, mk: m["critic_z"](z, mk)),
        None if head is None else sharded(
            lambda m, x: m["decoder"].hyperbolic_linear(x)))


def _forwards(model, mesh):
    return model_forwards(model) if mesh is None else mesh_forwards(model,
                                                                    mesh)


def fleet_forwards(P):
    """The batched forwards of ``models/fleet.py`` over the stacked
    parameters ``P`` as :class:`Forwards`."""
    from hypad_tpu_torch.models import fleet as mf

    return Forwards(*(functools.partial(f, P) for f in (
        mf.encoder, mf.decoder, mf.critic_x, mf.critic_z, mf.mobius_head)))


def critic_loss_stacked(critic, big, masks, sign):
    """One critic's WGAN-GP loss on ``big`` = [first B, second B, interp]
    rows (..., 3B, d) with keep-masks ``masks``; ``critic(rows, masks)``.
    ``sign`` +1 gives ``mean(second) - mean(first)`` (critic_x), -1 the
    flipped critic_z term. Each leading index takes ONE norm over its own
    (B, d) input gradient."""
    B = big.shape[-2] // 3
    interp = big[..., 2 * B:, :].detach().requires_grad_(True)
    out = critic(torch.cat([big[..., :2 * B, :], interp], dim=-2), masks)
    # leading indices share no parameter, so the sum's input gradient is
    # each one's own
    (g,) = torch.autograd.grad(out[..., 2 * B:, :].sum(), interp,
                               create_graph=True)
    first = out[..., :B, :].mean(dim=_ROWS)
    second = out[..., B:2 * B, :].mean(dim=_ROWS)
    wl = second - first if sign > 0 else first - second
    gn = torch.sqrt(torch.sum(g * g, dim=_ROWS) + GP_NORM_EPS)
    return wl + GP_WEIGHT * (gn - 1.0) ** 2


@torch.no_grad()
def _stack_x(f, x, z, alpha, dec_drop_masks, hyperbolic):
    """critic_x's rows [x, x_fake, interp_x]: the decoder runs on ``z``
    without a graph."""
    dec_out = f.decoder(z, dec_drop_masks)
    x_fake = dec_out[0] if hyperbolic else dec_out
    return torch.cat([x, x_fake, alpha * x + (1.0 - alpha) * x_fake], dim=-2)


@torch.no_grad()
def _stack_z(f, x, z, alpha):
    """critic_z's rows [z_enc, z, interp_z], the encoder run without a
    graph."""
    z_enc = f.encoder(x)
    return torch.cat([z_enc, z, alpha * z + (1.0 - alpha) * z_enc], dim=-2)


def _critic_rows(f, x, draws, hyperbolic):
    return (_stack_x(f, x, draws["z_x"], draws["a_x"], draws["m_dec"],
                     hyperbolic),
            _stack_z(f, x, draws["z_z"], draws["a_z"]))


def critic_step_inputs(model, x, draws, hyperbolic, mesh=None):
    """(bigx, bigz) of one critic step from its draws."""
    return _critic_rows(_forwards(model, mesh), x, draws, hyperbolic)


def critic_step_inputs_fleet(P, x, draws, hyperbolic):
    """(bigx, bigz) (S, 3B, .) of one fleet critic step: ``draws`` hold one
    step's z_x, a_x, z_z, a_z and m_dec with a leading S."""
    return _critic_rows(fleet_forwards(P), x, draws, hyperbolic)


def critic_x_loss(model, x, hyperbolic, z, alpha, drop_masks,
                  dec_drop_masks):
    """critic_x's loss. x (B, W); z (B, latent); alpha (B, W); drop_masks
    (4, 3B, latent); dec_drop_masks (B, 128)."""
    bigx = _stack_x(model_forwards(model), x, z, alpha, dec_drop_masks,
                    hyperbolic)
    return critic_loss_stacked(model["critic_x"], bigx, drop_masks, +1)


def critic_z_loss(model, x, z, alpha, drop_masks):
    """critic_z's loss. x (B, W); z, alpha (B, latent); drop_masks
    (2, 3B, latent)."""
    bigz = _stack_z(model_forwards(model), x, z, alpha)
    return critic_loss_stacked(model["critic_z"], bigz, drop_masks, -1)


def _generator_loss(f, x, hyperbolic, z, masks):
    B = x.shape[-2]
    z_enc = f.encoder(x)
    fake_gen_z = f.critic_z(z_enc, masks["m_cz"])
    dec_out = f.decoder(torch.cat([z, z_enc], dim=-2), masks["m_dec"])
    out = dec_out[0] if hyperbolic else dec_out
    x_gen, x_gen_rec = out[..., :B, :], out[..., B:, :]
    fake_gen_x = f.critic_x(x_gen, masks["m_cx"])
    adv = -fake_gen_x.mean(dim=_ROWS) - fake_gen_z.mean(dim=_ROWS)
    if hyperbolic:
        rec = torch.sum(st.acosh_poincare_distance_loss(x_gen_rec, f.head(x)),
                        dim=-1) / B
    else:
        rec = torch.mean((x - x_gen_rec) ** 2, dim=_ROWS)
    return REC_WEIGHT * rec + adv, rec


def generator_loss(model, x, hyperbolic, z, masks, mesh=None):
    """(loss, rec) of the generator step. x (B, W); z (B, latent);
    ``masks``: {"m_cx": (4, B, latent), "m_cz": (2, B, latent),
    "m_dec": (2B, 128)}. ``mesh``: the forwards split over it
    (:func:`mesh_forwards`)."""
    return _generator_loss(_forwards(model, mesh), x, hyperbolic, z, masks)


def generator_loss_fleet(P, x, hyperbolic, z, masks):
    """(loss, rec), each (S,), of :func:`generator_loss` for every signal:
    x (S, B, W); z (S, B, latent); ``masks`` {"m_cx": (S, 4, B, Hx),
    "m_cz": (S, 2, B, Hz), "m_dec": (S, 2B, 128)}."""
    return _generator_loss(fleet_forwards(P), x, hyperbolic, z, masks)
