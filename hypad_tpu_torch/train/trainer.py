"""WGAN-GP training of the TadGAN / HypAD model, one epoch at a time.

Port of ``hypad_tpu.train.trainer``. An epoch is 5 full critic passes over
the shuffled windows (drop_last, a fresh shuffle each), then one generator
pass, with per-epoch mean losses. Each critic step runs one of three paths,
chosen by ``fused_critics`` as the JAX config names them:

* ``"full"`` (default): K5, the whole step body below the batch gather and
  above the Adam updates, in one kernel (``critic_step_fused_full``);
* ``True``: the generator forwards in torch, then K4 (``critics_fused_grads``);
* ``False``: the autograd composition of ``train/losses.py``.

On a CPU tensor the two kernel paths run their plain versions. The chosen
path is never swapped for another. A generator step is autograd of
``generator_loss``, whose MobiusLinear forwards (the decoder head on 2B rows
and the target embedding on B rows) are K1 on the card. The critics train
with Adam and the generator with Riemannian Adam (wd 1e-5, stabilize 10)
when hyperbolic, Adam otherwise.

Every random draw of an epoch (the 5 critic shuffles, ``z_x a_x z_z a_z
m_cx m_cz m_dec`` for every critic step, the generator pass's shuffle,
``z`` and keep-masks) is made up front from an explicit CPU
``torch.Generator`` and copied to the device, so one seed gives the same
draws on the CPU and on the card; :func:`run_epoch` also takes injected
draws, such as the JAX trainer's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.models.tadgan import (
    CX_DROPOUT,
    CZ_DROPOUT,
    DEC_LSTM_DROPOUT,
)
from hypad_tpu_torch.optim.radam import adam, riemannian_adam
from hypad_tpu_torch.train.critic_kernel import (
    critic_params,
    critic_step_fused_full,
    critic_step_plain,
    critics_fused_grads,
)
from hypad_tpu_torch.train.losses import (  # noqa: F401  (re-exported)
    N_CRITICS,
    critic_step_inputs,
    critic_x_loss,
    critic_z_loss,
    generator_loss,
)

CRITIC_DRAWS = ("z_x", "a_x", "z_z", "a_z", "m_cx", "m_cz", "m_dec")


@dataclass
class TrainState:
    """The model (updated in place) and the three optimizer states."""
    model: Any       # nn.ModuleDict: encoder, decoder, critic_x, critic_z
    opt_cx: Any
    opt_cz: Any
    opt_gen: Any
    epoch: int


def gen_params(model):
    """{"encoder.lstm.0.w_ih": tensor, ...}: the generator's parameters."""
    return {**dict(model["encoder"].named_parameters(prefix="encoder")),
            **dict(model["decoder"].named_parameters(prefix="decoder"))}


def make_optimizers(lr, hyperbolic):
    opt_gen = (riemannian_adam(lr, weight_decay=1e-5, stabilize=10)
               if hyperbolic else adam(lr))
    return adam(lr), adam(lr), opt_gen


def init_train_state(model, lr, hyperbolic):
    opt_cx, opt_cz, opt_gen = make_optimizers(lr, hyperbolic)
    return TrainState(
        model=model,
        opt_cx=opt_cx.init(critic_params(model["critic_x"], "critic_x")),
        opt_cz=opt_cz.init(critic_params(model["critic_z"], "critic_z")),
        opt_gen=opt_gen.init(gen_params(model)),
        epoch=0)


def _widths(model):
    """(signal width, latent, critic_x hidden, critic_z hidden, decoder
    LSTM output width)."""
    lstm0 = model["decoder"].lstm[0]
    return (model["critic_x"].dense1.w.shape[1],
            model["decoder"].dense1.w.shape[1],
            model["critic_x"].dense1.w.shape[0],
            model["critic_z"].dense1.w.shape[0],
            lstm0["w_hh"].shape[1] * (2 if "w_ih_rev" in lstm0 else 1))


def epoch_draws(generator, n, batch_size, model):
    """Every random draw of one epoch, on the CPU, from ``generator``.

    Critic steps (S = 5 * (n // batch_size)): ``critic_idx`` (S, B),
    ``z_x``/``z_z`` (S, B, latent) normal, ``a_x`` (S, B, W) and ``a_z``
    (S, B, latent) uniform, keep-masks ``m_cx`` (S, 4, 3B, Hx), ``m_cz``
    (S, 2, 3B, Hz), ``m_dec`` (S, B, 128). Generator steps: ``gen_idx``,
    ``gen_z``, ``gen_m_cx`` (nb, 4, B, Hx), ``gen_m_cz`` (nb, 2, B, Hz),
    ``gen_m_dec`` (nb, 2B, 128)."""
    W, latent, hx, hz, dec_width = _widths(model)
    nb, B = n // batch_size, batch_size
    g = generator

    def perm():
        return torch.randperm(n, generator=g)[:nb * B].view(nb, B)

    def keep(rate, *shape):
        return torch.rand(shape, generator=g) < 1.0 - rate

    critic_idx = torch.cat([perm() for _ in range(N_CRITICS)])
    S = critic_idx.shape[0]
    return {
        "critic_idx": critic_idx,
        "z_x": torch.randn(S, B, latent, generator=g),
        "a_x": torch.rand(S, B, W, generator=g),
        "z_z": torch.randn(S, B, latent, generator=g),
        "a_z": torch.rand(S, B, latent, generator=g),
        "m_cx": keep(CX_DROPOUT, S, 4, 3 * B, hx),
        "m_cz": keep(CZ_DROPOUT, S, 2, 3 * B, hz),
        "m_dec": keep(DEC_LSTM_DROPOUT, S, B, dec_width),
        "gen_idx": perm(),
        "gen_z": torch.randn(nb, B, latent, generator=g),
        "gen_m_cx": keep(CX_DROPOUT, nb, 4, B, hx),
        "gen_m_cz": keep(CZ_DROPOUT, nb, 2, B, hz),
        "gen_m_dec": keep(DEC_LSTM_DROPOUT, nb, 2 * B, dec_width),
    }


def _critic_step(model, x, d, hyperbolic, fused_critics):
    if fused_critics == "full":
        return critic_step_fused_full(model, x, d, hyperbolic)
    if fused_critics is True:
        bigx, bigz = critic_step_inputs(model, x, d, hyperbolic)
        return critics_fused_grads(model["critic_x"], model["critic_z"],
                                   bigx, bigz, d["m_cx"], d["m_cz"])
    return critic_step_plain(model, x, d, hyperbolic)


def critic_pass(state, X, d, *, lr, hyperbolic, fused_critics="full"):
    """The epoch's 5 critic passes: one critic step per row of
    ``d["critic_idx"]``, each followed by the two critics' Adam updates.
    ``d`` holds the epoch's draws on X's device. Returns the per-step
    (lx, lz) as two lists of 0-d tensors."""
    if not (fused_critics == "full" or fused_critics is True
            or fused_critics is False):
        raise ValueError('fused_critics must be "full", True or False, '
                         f"got {fused_critics!r}")
    model = state.model
    opt_cx, opt_cz, _ = make_optimizers(lr, hyperbolic)
    p_cx = critic_params(model["critic_x"], "critic_x")
    p_cz = critic_params(model["critic_z"], "critic_z")
    lxs, lzs = [], []
    for s in range(d["critic_idx"].shape[0]):
        x = X[d["critic_idx"][s]]
        lx, lz, gx, gz = _critic_step(model, x, {k: d[k][s]
                                                 for k in CRITIC_DRAWS},
                                      hyperbolic, fused_critics)
        state.opt_cx = opt_cx.update(gx, state.opt_cx, p_cx)
        state.opt_cz = opt_cz.update(gz, state.opt_cz, p_cz)
        lxs.append(lx)
        lzs.append(lz)
    return lxs, lzs


def generator_pass(state, X, d, *, lr, hyperbolic):
    """The epoch's generator pass: autograd of ``generator_loss`` on each
    row of ``d["gen_idx"]``, then the generator's optimizer update.
    Returns the per-step (loss, rec) as two lists of 0-d tensors."""
    model = state.model
    _, _, opt_gen = make_optimizers(lr, hyperbolic)
    p_gen = gen_params(model)
    lgs, recs = [], []
    for s in range(d["gen_idx"].shape[0]):
        x = X[d["gen_idx"][s]]
        masks = {"m_cx": d["gen_m_cx"][s], "m_cz": d["gen_m_cz"][s],
                 "m_dec": d["gen_m_dec"][s]}
        with torch.enable_grad():
            loss, rec = generator_loss(model, x, hyperbolic, d["gen_z"][s],
                                       masks)
            grads = torch.autograd.grad(loss, list(p_gen.values()))
        state.opt_gen = opt_gen.update(dict(zip(p_gen, grads)),
                                       state.opt_gen, p_gen)
        lgs.append(loss.detach())
        recs.append(rec.detach())
    return lgs, recs


def run_epoch(state, X, draws, *, lr, hyperbolic, fused_critics="full"):
    """One epoch on ``X`` (N, W) float32 on the model's device, from
    ``draws`` as :func:`epoch_draws` makes them (on any device): the critic
    passes, then the generator pass. Updates ``state`` in place and returns
    ``(state, metrics)``: the mean critic_x, critic_z, decoder and
    reconstruction losses as Python floats (reading them synchronises)."""
    d = {k: v.to(X.device) for k, v in draws.items()}
    lxs, lzs = critic_pass(state, X, d, lr=lr, hyperbolic=hyperbolic,
                           fused_critics=fused_critics)
    lgs, recs = generator_pass(state, X, d, lr=lr, hyperbolic=hyperbolic)
    means = torch.stack([torch.stack(v).mean()
                         for v in (lxs, lzs, lgs, recs)]).tolist()
    state.epoch += 1
    return state, dict(zip(("critic_x_loss", "critic_z_loss",
                            "decoder_loss", "rec_loss"), means))


def epoch_generator(seed, epoch):
    """The CPU generator of epoch ``epoch``'s draws under ``seed``."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def train_tadgan(model, X, *, lr, hyperbolic, batch_size, n_epochs, seed=0,
                 device="cuda", fused_critics="full", log_cb=None,
                 checkpoint_cb=None):
    """Train ``model`` (an ``init_tadgan`` ModuleDict, or a
    :class:`TrainState` to resume) on windows ``X`` (N, W) for the epochs
    from its ``epoch`` up to ``n_epochs``. ``log_cb(epoch, metrics)`` fires
    after every epoch; ``checkpoint_cb(epoch, state)`` after every 10th and
    after epoch ``n_epochs - 1``. Returns the final :class:`TrainState`.
    The model must lie on ``device``; a CUDA device without CUDA raises.
    ``X`` may be numpy or a tensor; a float32 tensor on ``device`` is used
    as it is, without a copy."""
    device = resolve_device(device)
    state = (model if isinstance(model, TrainState)
             else init_train_state(model, lr, hyperbolic))
    params = list(state.model.parameters())
    if any(p.device != device for p in params):
        raise ValueError(f"train_tadgan: the model is on {params[0].device}, "
                         f"not on {device}")
    X = (X.to(device, torch.float32) if torch.is_tensor(X)
         else torch.as_tensor(np.asarray(X, np.float32), device=device))
    while state.epoch < n_epochs:
        draws = epoch_draws(epoch_generator(seed, state.epoch), X.shape[0],
                            batch_size, state.model)
        state, metrics = run_epoch(state, X, draws, lr=lr,
                                   hyperbolic=hyperbolic,
                                   fused_critics=fused_critics)
        if log_cb is not None:
            log_cb(state.epoch, metrics)
        if checkpoint_cb is not None and (state.epoch % 10 == 0
                                          or state.epoch == n_epochs - 1):
            checkpoint_cb(state.epoch, state)
    return state
