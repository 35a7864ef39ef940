"""Multi-layer bidirectional LSTM with torch.nn.LSTM semantics.

Port of ``hypad_tpu.ops.lstm``: gate order i, f, g, o in the stacked
weights; both biases added; zero initial state; bidirectional outputs
concatenated on the feature axis. The parameters keep the JAX package's
names and layout (per layer ``w_ih`` (4H, in), ``w_hh`` (4H, H), ``b_ih``,
``b_hh``, and ``*_rev`` for the reverse direction), so weights carry across
unchanged. The detector and trainer always run it at sequence length 1;
the ``h @ w_hh`` term is kept so the recurrence stays general. Training-mode
inter-layer dropout takes explicit keep-masks, one per inter-layer gap, as
the JAX trainer pregenerates them: ``where(keep, out / (1 - p), 0)``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class LSTM(nn.ModuleList):
    """One ``nn.ParameterDict`` per layer, keyed like the JAX parameters."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=True, device=None):
        super().__init__()
        num_dir = 2 if bidirectional else 1
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * num_dir
            params = {}
            for suffix in ("", "_rev")[:num_dir]:
                for name, shape in (("w_ih", (4 * hidden_size, in_size)),
                                    ("w_hh", (4 * hidden_size, hidden_size)),
                                    ("b_ih", (4 * hidden_size,)),
                                    ("b_hh", (4 * hidden_size,))):
                    params[name + suffix] = nn.Parameter(
                        torch.empty(shape, device=device))
            self.append(nn.ParameterDict(params))

    def reset_parameters(self, generator):
        """U(-1/sqrt(H), 1/sqrt(H)) for every weight and bias, like torch."""
        for layer in self:
            bound = 1.0 / math.sqrt(layer["w_hh"].shape[1])
            for p in layer.values():
                _uniform_(p, bound, generator)

    def forward(self, x, drop_masks=None, dropout=0.0):
        """x: (T, B, in) time-major -> (T, B, H * num_directions).

        ``drop_masks``: training-mode keep-masks (bool or 0/1), entry ``i``
        shaped like layer ``i``'s output, for every layer but the last;
        None runs in eval mode."""
        out = x
        for idx, layer in enumerate(self):
            outs = [_run_direction(out, layer["w_ih"], layer["w_hh"],
                                   layer["b_ih"], layer["b_hh"],
                                   reverse=False)]
            if "w_ih_rev" in layer:
                outs.append(_run_direction(out, layer["w_ih_rev"],
                                           layer["w_hh_rev"],
                                           layer["b_ih_rev"],
                                           layer["b_hh_rev"], reverse=True))
            out = torch.cat(outs, dim=-1)
            if drop_masks is not None and idx < len(self) - 1:
                keep = drop_masks[idx].to(torch.bool)
                out = torch.where(keep, out / (1.0 - dropout), 0.0)
        return out


def _uniform_(p, bound, generator):
    """Draw ``p`` from U(-bound, bound) on the CPU generator, then copy it to
    ``p``'s device, so weights from one seed match across devices."""
    with torch.no_grad():
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                              generator=generator))


def lstm_cell(h, c, x_t, w_ih, w_hh, b_ih, b_hh):
    """One torch-semantics LSTM step. x_t: (B, in); h, c: (B, H)."""
    gates = x_t @ w_ih.T + h @ w_hh.T + b_ih + b_hh
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _run_direction(x, w_ih, w_hh, b_ih, b_hh, reverse):
    """x: (T, B, in) -> (T, B, H), scanning backwards when ``reverse``."""
    T, B, _ = x.shape
    H = w_hh.shape[1]
    h = x.new_zeros((B, H))
    c = x.new_zeros((B, H))
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = lstm_cell(h, c, x[t], w_ih, w_hh, b_ih, b_hh)
        outs[t] = h
    return torch.stack(outs)
