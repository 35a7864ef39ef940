"""TadGAN / HypAD modules in PyTorch (eval and training forwards).

Port of ``hypad_tpu.models.tadgan``: Encoder, Decoder (with the hyperbolic
MobiusLinear head), CriticX and CriticZ as ``nn.Module``s. Parameter names
follow the JAX pytree (``dense.w``, ``lstm.0.w_ih``,
``hyperbolic_linear.b``), so ``state_dict`` keys are the pytree paths
joined by dots and ``hypad_tpu_torch.bridge`` carries weights across
unchanged.

Initialization (``init_tadgan``) draws from an explicit CPU
``torch.Generator`` with the torch distributions the JAX package documents:
  * dense layers: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias;
  * LSTMs: U(-1/sqrt(hidden), 1/sqrt(hidden));
  * MobiusLinear weight: N(0, (1/(100*sqrt(2*out*in)))^2);
  * MobiusLinear bias: expmap0(N(0,1)/400), a point on the Poincare ball.
The window enters the LSTMs as one timestep of a ``signal_shape``-wide
feature vector (sequence length 1), as in the reference model.

Training mode is a forward given explicit dropout keep-masks, as the JAX
trainer pregenerates them: CriticX takes 4 masks (rate 0.25), CriticZ 2
(rate 0.2), the Decoder one inter-layer LSTM mask (rate 0.2). A kept value
is divided by ``1 - rate``, as in the JAX package. Without masks every
forward is the eval forward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.manifold import stereographic as st
from hypad_tpu_torch.manifold.kernels import mobius_linear_fused
from hypad_tpu_torch.ops.lstm import LSTM, _uniform_

LATENT_DIM = 20
CX_DROPOUT = 0.25       # CriticX, after each hidden layer
CZ_DROPOUT = 0.2        # CriticZ
DEC_LSTM_DROPOUT = 0.2  # decoder inter-layer LSTM dropout


class Dense(nn.Module):
    """x @ w.T + b with torch.nn.Linear's layout: w (out, in), b (out,)."""

    def __init__(self, in_features, out_features, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(out_features, in_features,
                                          device=device))
        self.b = nn.Parameter(torch.empty(out_features, device=device))

    def reset_parameters(self, generator):
        bound = 1.0 / math.sqrt(self.w.shape[1])
        _uniform_(self.w, bound, generator)
        _uniform_(self.b, bound, generator)

    def forward(self, x):
        return F.linear(x, self.w, self.b)


class MobiusLinear(nn.Module):
    """Euclidean input -> Poincare ball: matvec, expmap0, mobius_add of the
    ball bias ``b``, project. The forward is the fused kernel on CUDA."""

    def __init__(self, in_features, out_features, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(out_features, in_features,
                                          device=device))
        self.b = nn.Parameter(torch.empty(out_features, device=device))

    def reset_parameters(self, generator):
        out_f, in_f = self.w.shape
        std = 1.0 / math.sqrt(2.0 * out_f * in_f) / 100.0
        with torch.no_grad():
            w = torch.empty(self.w.shape).normal_(0.0, 1.0,
                                                  generator=generator) * std
            tangent = torch.empty(self.b.shape).normal_(
                0.0, 1.0, generator=generator) / 400.0
            self.w.copy_(w)
            self.b.copy_(st.expmap0(tangent, k=-1.0))

    def forward(self, x):
        return mobius_linear_fused(x.contiguous(), self.w, self.b)


def _leaky_relu(x, slope=0.2):
    return torch.where(x >= 0, x, slope * x)


def dropout(x, rate, keep):
    """Inverted dropout with a pregenerated keep-mask (bool or 0/1)."""
    return torch.where(keep.to(torch.bool), x / (1.0 - rate), 0.0)


class Encoder(nn.Module):
    """x (B, signal_shape) -> z (B, latent_dim)."""

    def __init__(self, signal_shape=100, latent_dim=LATENT_DIM, device=None):
        super().__init__()
        self.lstm = LSTM(signal_shape, 50, num_layers=1, bidirectional=True,
                         device=device)
        self.dense = Dense(100, latent_dim, device=device)

    def forward(self, x):
        h = self.lstm(x[None])            # (1, B, 100)
        return self.dense(h)[0]


class Decoder(nn.Module):
    """z (B, latent_dim) -> (B, signal_shape) tanh output; with the
    hyperbolic head, (hyper, eucl) where ``hyper`` lies on the ball."""

    def __init__(self, signal_shape=100, latent_dim=LATENT_DIM,
                 hyperbolic=False, device=None):
        super().__init__()
        self.dense1 = Dense(latent_dim, 50, device=device)
        self.lstm = LSTM(50, 64, num_layers=2, bidirectional=True,
                         device=device)
        self.dense2 = Dense(128, signal_shape, device=device)
        self.hyperbolic = hyperbolic
        if hyperbolic:
            self.hyperbolic_linear = MobiusLinear(signal_shape, signal_shape,
                                                  device=device)

    def forward(self, z, lstm_drop_masks=None):
        """``lstm_drop_masks``: training-mode inter-layer keep-masks,
        (1, 1, B, 128) as the JAX trainer draws them (or (1, B, 128)
        each in a sequence); None for eval."""
        h = self.dense1(z)[None]          # (1, B, 50)
        h = self.lstm(h, lstm_drop_masks, DEC_LSTM_DROPOUT)
        x = torch.tanh(self.dense2(h))[0]
        if self.hyperbolic:
            return self.hyperbolic_linear(x), x
        return x


class CriticX(nn.Module):
    """x (B, signal_shape) -> (B, 1)."""

    def __init__(self, signal_shape=100, latent_dim=LATENT_DIM, device=None):
        super().__init__()
        self.dense1 = Dense(signal_shape, latent_dim, device=device)
        self.dense2 = Dense(latent_dim, latent_dim, device=device)
        self.dense3 = Dense(latent_dim, latent_dim, device=device)
        self.dense4 = Dense(latent_dim, latent_dim, device=device)
        self.dense5 = Dense(latent_dim, 1, device=device)

    def forward(self, x, drop_masks=None):
        """``drop_masks``: training-mode keep-masks (4, B, latent); None
        for eval."""
        h = x
        for i, layer in enumerate((self.dense1, self.dense2, self.dense3,
                                   self.dense4)):
            h = _leaky_relu(layer(h))
            if drop_masks is not None:
                h = dropout(h, CX_DROPOUT, drop_masks[i])
        return self.dense5(h)


class CriticZ(nn.Module):
    """z (B, latent_dim) -> (B, 1)."""

    def __init__(self, latent_dim=LATENT_DIM, device=None):
        super().__init__()
        self.dense1 = Dense(latent_dim, latent_dim, device=device)
        self.dense2 = Dense(latent_dim, latent_dim, device=device)
        self.dense3 = Dense(latent_dim, 1, device=device)

    def forward(self, z, drop_masks=None):
        """``drop_masks``: training-mode keep-masks (2, B, latent); None
        for eval."""
        h = z
        for i, layer in enumerate((self.dense1, self.dense2)):
            h = _leaky_relu(layer(h))
            if drop_masks is not None:
                h = dropout(h, CZ_DROPOUT, drop_masks[i])
        return self.dense3(h)


def build_tadgan(signal_shape=100, latent_dim=LATENT_DIM, hyperbolic=False,
                 device="cuda"):
    """The four modules with uninitialized parameters, in eval mode, as an
    ``nn.ModuleDict`` keyed like the JAX pytree."""
    device = resolve_device(device)
    return nn.ModuleDict({
        "encoder": Encoder(signal_shape, latent_dim, device=device),
        "decoder": Decoder(signal_shape, latent_dim, hyperbolic,
                           device=device),
        "critic_x": CriticX(signal_shape, latent_dim, device=device),
        "critic_z": CriticZ(latent_dim, device=device),
    }).eval()


def init_tadgan(generator, signal_shape=100, hyperbolic=False,
                latent_dim=LATENT_DIM, device="cuda"):
    """Build and initialize all four modules from ``generator`` (a CPU
    ``torch.Generator``). Draws are taken on the CPU and copied to
    ``device``, so one seed gives the same weights on every device."""
    model = build_tadgan(signal_shape, latent_dim, hyperbolic, device)
    for module in model.modules():
        if module is not model and hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model
