"""The TadGAN / HypAD forwards of a whole fleet at once: a signal axis S.

The fleet's counterpart of ``jax.vmap`` over ``hypad_tpu.models.tadgan``.
A fleet's parameters are one dict keyed like the per-signal model's
``state_dict`` (``"decoder.lstm.0.w_ih"``) whose every leaf carries a
leading axis S (``train/fleet.py`` ``stack_models``). Each forward below
takes activations (S, N, .) and runs every layer as one batched op for all
S signals: ``torch.baddbmm`` for a dense layer (the per-signal
``F.linear``'s arithmetic, bias first), ``x @ w.mT`` for an LSTM's
products, and the MobiusLinear head through the signal-axis K1
(``manifold/kernels.py``). So a fleet forward issues about the launches of
one signal's forward, whatever S is.

The LSTMs run at sequence length 1 from zero state, as the detector and
trainer always run them; the ``h @ w_hh`` term is kept, so ``w_hh`` gets its
(zero) gradient as in the per-signal model. Training mode takes explicit
keep-masks with a leading S, as ``models/tadgan.py`` takes them without it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hypad_tpu_torch.manifold.kernels import mobius_linear_fused
from hypad_tpu_torch.models.tadgan import (
    CX_DROPOUT,
    CZ_DROPOUT,
    DEC_LSTM_DROPOUT,
    _leaky_relu,
    dropout,
)

CX_LAYERS = ("dense1", "dense2", "dense3", "dense4", "dense5")
CZ_LAYERS = ("dense1", "dense2", "dense3")


def dense(P, name, x):
    """x (S, N, in) @ w.mT + b for every signal: (S, N, out).

    On the CPU a one-output layer (the critics' last) runs signal by
    signal: there the BLAS's batched product rounds a one-column result
    otherwise than its single product does, and the critics' WGAN bias
    gradient is pure rounding residue, which Adam scales to whole steps,
    so one ulp there moves a signal's training far from its single-model
    run: with one batched op here, ``tests/test_torch_fleet.py``'s
    ``test_fleet_epoch_is_bitwise_single_model_epochs`` fails after one
    epoch (signal 0's ``encoder.lstm.0.b_hh`` first). Every other shape,
    and every shape on the card, is one batched op; on the card the fleet
    is held to its single-model runs at a tolerance (``chip_smoke.py``)."""
    w, b = P[f"{name}.w"], P[f"{name}.b"]
    if x.device.type == "cpu" and w.shape[1] == 1:
        return torch.stack([F.linear(x[s], w[s], b[s])
                            for s in range(x.shape[0])])
    return torch.baddbmm(b[:, None, :], x, w.mT)


def _lstm_cell(x, P, prefix, suffix):
    """One direction of an LSTM layer at T = 1 from zero state."""
    w_ih, w_hh = P[f"{prefix}.w_ih{suffix}"], P[f"{prefix}.w_hh{suffix}"]
    h = x.new_zeros((*x.shape[:-1], w_hh.shape[-1]))
    gates = (x @ w_ih.mT + h @ w_hh.mT + P[f"{prefix}.b_ih{suffix}"][:, None]
             + P[f"{prefix}.b_hh{suffix}"][:, None])
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = (torch.sigmoid(f) * torch.zeros_like(h)
         + torch.sigmoid(i) * torch.tanh(g))
    return torch.sigmoid(o) * torch.tanh(c)


def bilstm(P, prefix, x, n_layers, drop_mask=None):
    """A bidirectional ``n_layers`` LSTM at T = 1: x (S, N, in) ->
    (S, N, 2H). ``drop_mask``: the inter-layer keep-mask (S, N, 2H) of a
    2-layer LSTM in training mode, or None."""
    out = x
    for layer in range(n_layers):
        pre = f"{prefix}.{layer}"
        out = torch.cat([_lstm_cell(out, P, pre, ""),
                         _lstm_cell(out, P, pre, "_rev")], dim=-1)
        if drop_mask is not None and layer < n_layers - 1:
            out = dropout(out, DEC_LSTM_DROPOUT, drop_mask)
    return out


def n_lstm_layers(P, prefix):
    return sum(1 for k in P if k.startswith(f"{prefix}.") and
               k.endswith(".w_ih"))


def encoder(P, x):
    """x (S, N, W) -> z (S, N, latent)."""
    h = bilstm(P, "encoder.lstm", x, n_lstm_layers(P, "encoder.lstm"))
    return dense(P, "encoder.dense", h)


def is_hyperbolic(P):
    return "decoder.hyperbolic_linear.w" in P


def mobius_head(P, x):
    """The decoder's MobiusLinear on x (S, N, W): one K1 launch on the
    card for every signal."""
    return mobius_linear_fused(x.contiguous(),
                               P["decoder.hyperbolic_linear.w"],
                               P["decoder.hyperbolic_linear.b"])


def decoder(P, z, drop_mask=None):
    """z (S, N, latent) -> (S, N, W) tanh output; with the hyperbolic
    head, (hyper, eucl). ``drop_mask``: the inter-layer keep-mask
    (S, N, 128) in training mode."""
    h = dense(P, "decoder.dense1", z)
    h = bilstm(P, "decoder.lstm", h, n_lstm_layers(P, "decoder.lstm"),
               drop_mask)
    x = torch.tanh(dense(P, "decoder.dense2", h))
    if is_hyperbolic(P):
        return mobius_head(P, x), x
    return x


def _critic(P, prefix, layers, rate, x, drop_masks):
    h = x
    for i, layer in enumerate(layers[:-1]):
        h = _leaky_relu(dense(P, f"{prefix}.{layer}", h))
        if drop_masks is not None:
            h = dropout(h, rate, drop_masks[:, i])
    return dense(P, f"{prefix}.{layers[-1]}", h)


def critic_x(P, x, drop_masks=None):
    """x (S, N, W) -> (S, N, 1). ``drop_masks``: (S, 4, N, Hx) or None."""
    return _critic(P, "critic_x", CX_LAYERS, CX_DROPOUT, x, drop_masks)


def critic_z(P, z, drop_masks=None):
    """z (S, N, latent) -> (S, N, 1). ``drop_masks``: (S, 2, N, Hz) or
    None."""
    return _critic(P, "critic_z", CZ_LAYERS, CZ_DROPOUT, z, drop_masks)


def forward_eval(P, X, hyperbolic):
    """The detector's eval forward of X (S, N, W): (hyper, eucl, hyper_x,
    critic) hyperbolic, (recon, critic) Euclidean; critic is (S, N)."""
    if hyperbolic and not is_hyperbolic(P):
        raise ValueError("hyperbolic scoring needs a model with the "
                         "MobiusLinear head (init_tadgan(hyperbolic=True))")
    z = encoder(P, X)
    critic = critic_x(P, X)[..., 0]
    decoded = decoder(P, z)
    if hyperbolic:
        hyper, eucl = decoded
        return hyper, eucl, mobius_head(P, X), critic
    recon = decoded[1] if isinstance(decoded, tuple) else decoded
    return recon, critic
