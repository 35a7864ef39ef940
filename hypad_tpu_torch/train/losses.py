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
"""

from __future__ import annotations

import torch

from hypad_tpu_torch.manifold import stereographic as st

N_CRITICS = 5          # full critic passes per epoch
GP_WEIGHT = 10.0
REC_WEIGHT = 10.0
GP_NORM_EPS = 1e-12


def critic_loss_stacked(critic, big, masks, sign):
    """One critic's WGAN-GP loss on ``big`` = [first B, second B, interp]
    rows with keep-masks ``masks``. ``sign`` +1 gives ``mean(second) -
    mean(first)`` (critic_x), -1 the flipped critic_z term."""
    B = big.shape[0] // 3
    interp = big[2 * B:].detach().requires_grad_(True)
    out = critic(torch.cat([big[:2 * B], interp]), masks)
    (g,) = torch.autograd.grad(out[2 * B:].sum(), interp, create_graph=True)
    first, second = out[:B].mean(), out[B:2 * B].mean()
    wl = second - first if sign > 0 else first - second
    gn = torch.sqrt(torch.sum(g * g) + GP_NORM_EPS)
    return wl + GP_WEIGHT * (gn - 1.0) ** 2


@torch.no_grad()
def stack_x(model, x, z, alpha, dec_drop_masks, hyperbolic):
    """critic_x's rows [x, x_fake, interp_x]: the decoder runs on ``z``
    without a graph, with inter-layer keep-mask ``dec_drop_masks``
    (B, 128)."""
    dec_out = model["decoder"](z, dec_drop_masks[None, None])
    x_fake = dec_out[0] if hyperbolic else dec_out
    return torch.cat([x, x_fake, alpha * x + (1.0 - alpha) * x_fake])


@torch.no_grad()
def stack_z(model, x, z, alpha):
    """critic_z's rows [z_enc, z, interp_z], the encoder run without a
    graph."""
    z_enc = model["encoder"](x)
    return torch.cat([z_enc, z, alpha * z + (1.0 - alpha) * z_enc])


def critic_step_inputs(model, x, draws, hyperbolic):
    """(bigx, bigz) of one critic step from its draws."""
    return (stack_x(model, x, draws["z_x"], draws["a_x"], draws["m_dec"],
                    hyperbolic),
            stack_z(model, x, draws["z_z"], draws["a_z"]))


def critic_x_loss(model, x, hyperbolic, z, alpha, drop_masks,
                  dec_drop_masks):
    """critic_x's loss. x (B, W); z (B, latent); alpha (B, W); drop_masks
    (4, 3B, latent); dec_drop_masks (B, 128)."""
    bigx = stack_x(model, x, z, alpha, dec_drop_masks, hyperbolic)
    return critic_loss_stacked(model["critic_x"], bigx, drop_masks, +1)


def critic_z_loss(model, x, z, alpha, drop_masks):
    """critic_z's loss. x (B, W); z, alpha (B, latent); drop_masks
    (2, 3B, latent)."""
    bigz = stack_z(model, x, z, alpha)
    return critic_loss_stacked(model["critic_z"], bigz, drop_masks, -1)


def generator_loss(model, x, hyperbolic, z, masks):
    """(loss, rec) of the generator step. x (B, W); z (B, latent);
    ``masks``: {"m_cx": (4, B, latent), "m_cz": (2, B, latent),
    "m_dec": (2B, 128)}."""
    B = x.shape[0]
    z_enc = model["encoder"](x)
    fake_gen_z = model["critic_z"](z_enc, masks["m_cz"])
    dec_out = model["decoder"](torch.cat([z, z_enc]),
                               masks["m_dec"][None, None])
    out = dec_out[0] if hyperbolic else dec_out
    x_gen, x_gen_rec = out[:B], out[B:]
    fake_gen_x = model["critic_x"](x_gen, masks["m_cx"])
    adv = -fake_gen_x.mean() - fake_gen_z.mean()
    if hyperbolic:
        hyper_x = model["decoder"].hyperbolic_linear(x)
        rec = torch.sum(st.acosh_poincare_distance_loss(x_gen_rec,
                                                        hyper_x)) / B
    else:
        rec = torch.mean((x - x_gen_rec) ** 2)
    return REC_WEIGHT * rec + adv, rec
