"""Hyperbolic recurrent layers: a port of ``hypad_tpu.models.hyrnn``.

Behaviour spec: reference ``hyperspace/hyrnn_nets.py``, as the JAX package
carries it:

* ``one_rnn_transform`` (:61-65) and ``mobius_gru_cell`` (:68-91): gates
  through logmap0(..).sigmoid(), the candidate state through Mobius ops,
  the update by Mobius addition of the z-scaled delta;
* ``mobius_gru_loop`` (:94-151): the cell over time, dense, with optional
  per-sequence ``lengths`` (a finished row keeps its state), and
  ``mobius_gru_loop_packed``, the reference's PackedSequence layout;
* ``dist2hyperplane_apply`` (``MobiusDist2Hyperplane``, :210-245): signed
  distances to learned hyperplanes scaled by exp(scale), and
  ``pairwise_poincare_distance`` (hyperspace/poincare_distance.py).

JAX scans the cell with ``lax.scan``, one device loop; here the time loop
is a Python loop over the steps, each step's ops launched on the inputs'
device. ``MobiusGRU`` and ``MobiusDist2Hyperplane`` are thin modules that
hold the parameters, named as JAX's ``init_mobius_gru`` and
``init_dist2hyperplane`` dicts name them (``hypad_tpu_torch.bridge`` carries
those across); the port's own init draws from an explicit CPU
``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.manifold import stereographic as st


def one_rnn_transform(W, h, U, x, b, k=-1.0):
    """W (x) h  (+)  U (x) x  (+)  b."""
    W_otimes_h = st.mobius_matvec(W, h, k)
    U_otimes_x = st.mobius_matvec(U, x, k)
    Wh_plus_Ux = st.mobius_add(W_otimes_h, U_otimes_x, k)
    return st.mobius_add(Wh_plus_Ux, b, k)


def mobius_gru_cell(x, h, weight_ih, weight_hh, bias, k=-1.0, nonlin=None):
    """One hyperbolic GRU step. ``weight_ih`` / ``weight_hh``: (3H, in) /
    (3H, H) stacked [r, h, z]; ``bias``: (3, H) rows [b_r, b_h, b_z];
    ``x``: (..., in) and ``h``: (..., H) ball points."""
    W_ir, W_ih, W_iz = weight_ih.chunk(3, dim=0)
    W_hr, W_hh, W_hz = weight_hh.chunk(3, dim=0)
    b_r, b_h, b_z = bias[0], bias[1], bias[2]

    z_t = torch.sigmoid(st.logmap0(
        one_rnn_transform(W_hz, h, W_iz, x, b_z, k), k))
    r_t = torch.sigmoid(st.logmap0(
        one_rnn_transform(W_hr, h, W_ir, x, b_r, k), k))

    rh_t = st.mobius_pointwise_mul(r_t, h, k)
    h_tilde = one_rnn_transform(W_hh, rh_t, W_ih, x, b_h, k)
    if nonlin is not None:
        h_tilde = st.mobius_fn_apply(nonlin, h_tilde, k)
    delta_h = st.mobius_add(-h, h_tilde, k)
    return st.mobius_add(h, st.mobius_pointwise_mul(z_t, delta_h, k), k)


def mobius_gru_loop(inputs, h0, weight_ih, weight_hh, bias, k=-1.0,
                    hyperbolic_input=False, hyperbolic_hidden_state0=False,
                    nonlin=None, lengths=None):
    """The hyperbolic GRU over time: ``inputs`` (T, B, in), ``h0`` (B, H)
    -> (outs (T, B, H), h_last (B, H)).

    ``lengths``: optional (B,) per-sequence lengths. A row whose sequence
    has ended keeps its state (its input masked to the origin), so
    ``h_last[b]`` is the state after step ``lengths[b]`` and ``outs[t, b]``
    for t >= lengths[b] repeats it, as JAX's masked scan gives it. As in
    JAX, the masked rows' zero inputs give ``weight_ih`` a NaN gradient
    (``mobius_matvec``'s floored norm of a zero vector: 0 * inf)."""
    h = h0 if hyperbolic_hidden_state0 else st.expmap0(h0, k)
    x = inputs if hyperbolic_input else st.expmap0(inputs, k)
    if lengths is not None:
        lengths = torch.as_tensor(np.asarray(lengths), device=x.device)
    outs = []
    for t in range(x.shape[0]):
        if lengths is None:
            h = mobius_gru_cell(x[t], h, weight_ih, weight_hh, bias, k,
                                nonlin)
        else:
            active = (t < lengths)[:, None]
            h_new = mobius_gru_cell(torch.where(active, x[t], 0.0), h,
                                    weight_ih, weight_hh, bias, k, nonlin)
            h = torch.where(active, h_new, h)
        outs.append(h)
    if not outs:
        return h.new_zeros((0,) + tuple(h.shape)), h
    return torch.stack(outs), h


def batch_sizes_to_lengths(batch_sizes):
    """PackedSequence ``batch_sizes`` (T,) -> per-sequence lengths (B0,)
    (sequences sorted by decreasing length: lengths[b] = #{t :
    batch_sizes[t] > b})."""
    batch_sizes = np.asarray(batch_sizes)
    return (batch_sizes[:, None] > np.arange(batch_sizes[0])).sum(0)


def mobius_gru_loop_packed(data, batch_sizes, h0, weight_ih, weight_hh, bias,
                           k=-1.0, hyperbolic_input=False,
                           hyperbolic_hidden_state0=False, nonlin=None):
    """The reference's packed-sequence layout: ``data`` is the
    PackedSequence data (sum(batch_sizes), in), step t's rows the first
    batch_sizes[t] sequences (sorted by decreasing length). Returns (packed
    outs (sum(batch_sizes), H), h_last (B0, H)), h_last in the packed
    (sorted) order. The stream is scattered once into a dense (T, B0, in)
    tensor, run through :func:`mobius_gru_loop` with ``lengths`` and
    gathered back."""
    batch_sizes = np.asarray(batch_sizes)
    T, B0 = len(batch_sizes), int(batch_sizes[0])
    lengths = batch_sizes_to_lengths(batch_sizes)
    t_idx = torch.as_tensor(np.repeat(np.arange(T), batch_sizes),
                            device=data.device)
    b_idx = torch.as_tensor(np.concatenate([np.arange(n) for n in
                                            batch_sizes]),
                            device=data.device)
    dense = data.new_zeros((T, B0) + tuple(data.shape[1:]))
    dense = dense.index_put((t_idx, b_idx), data)
    outs_dense, h_last = mobius_gru_loop(
        dense, h0, weight_ih, weight_hh, bias, k,
        hyperbolic_input=hyperbolic_input,
        hyperbolic_hidden_state0=hyperbolic_hidden_state0,
        nonlin=nonlin, lengths=lengths)
    return outs_dense[t_idx, b_idx], h_last


def dist2hyperplane_apply(params, x, k=-1.0):
    """``x`` (..., in) ball points -> (..., out) signed distances to the
    hyperplanes of ``params`` ({"point", "tangent"} (out, in), "scale"
    (out,)), each scaled by exp(scale)."""
    d = st.dist2plane(x[..., None, :], params["point"], params["tangent"],
                      k, signed=True)
    return d * torch.exp(params["scale"])


def pairwise_poincare_distance(x, y):
    """All-pairs Poincare distance: squared norms floored at 1e-5,
    pairwise squared distances clamped to [1e-7, inf), then
    acosh(1 + 2 d2 / ((1-|x|^2)(1-|y|^2))). ``x`` (N, D), ``y`` (M, D) ->
    (N, M)."""
    x2 = torch.sum(x * x, -1).clamp_min(1e-5)
    y2 = torch.sum(y * y, -1).clamp_min(1e-5)
    sq = (torch.sum(x * x, -1)[:, None] - 2.0 * x @ y.T
          + torch.sum(y * y, -1)[None, :])
    sq = sq.clamp_min(1e-7)
    arg = 1.0 + 2.0 * sq / ((1.0 - x2)[:, None] * (1.0 - y2)[None, :])
    return torch.acosh(arg)


def init_mobius_gru(generator, input_size, hidden_size,
                    dtype=torch.float32, device="cuda"):
    """{"weight_ih", "weight_hh", "bias"} drawn from ``generator`` (a CPU
    ``torch.Generator``) as JAX's ``init_mobius_gru`` draws them: the
    weights U(-1/sqrt(H), 1/sqrt(H)), the bias points expmap0(N(0,1)/400)
    on the ball; then moved to ``device``."""
    device = resolve_device(device)
    bound = 1.0 / math.sqrt(hidden_size)

    def uniform(*shape):
        return (torch.rand(shape, generator=generator, dtype=dtype) * 2
                - 1) * bound

    params = {
        "weight_ih": uniform(3 * hidden_size, input_size),
        "weight_hh": uniform(3 * hidden_size, hidden_size),
        "bias": st.expmap0(torch.randn((3, hidden_size), generator=generator,
                                       dtype=dtype) / 400.0),
    }
    return {name: p.to(device) for name, p in params.items()}


def init_dist2hyperplane(generator, in_features, out_features,
                         dtype=torch.float32, device="cuda"):
    """{"point", "tangent", "scale"} as the reference initializes
    ``MobiusDist2Hyperplane`` (:210-225): points expmap0(N(0,1)/4) on the
    ball, unit tangents, zero log-scales; drawn from ``generator`` on the
    CPU, then moved to ``device``."""
    device = resolve_device(device)
    point = st.expmap0(torch.randn((out_features, in_features),
                                   generator=generator, dtype=dtype) / 4.0)
    tangent = torch.randn((out_features, in_features), generator=generator,
                          dtype=dtype)
    tangent = tangent / torch.linalg.norm(tangent, dim=-1, keepdim=True)
    params = {"point": point, "tangent": tangent,
              "scale": torch.zeros((out_features,), dtype=dtype)}
    return {name: p.to(device) for name, p in params.items()}


class MobiusGRU(nn.Module):
    """The hyperbolic GRU's parameters (``weight_ih`` (3H, in),
    ``weight_hh`` (3H, H), ``bias`` (3, H)) and its loop: ``forward(inputs
    (T, B, in), h0=None (zeros), lengths=None)`` is :func:`mobius_gru_loop`,
    and with ``batch_sizes`` ``inputs`` is PackedSequence data and the loop
    :func:`mobius_gru_loop_packed`. Weights from ``generator`` (seed 0
    when None) by :func:`init_mobius_gru`."""

    def __init__(self, input_size, hidden_size, k=-1.0, nonlin=None,
                 hyperbolic_input=False, hyperbolic_hidden_state0=False,
                 generator=None, dtype=torch.float32, device="cuda"):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        params = init_mobius_gru(generator, input_size, hidden_size, dtype,
                                 device)
        self.weight_ih = nn.Parameter(params["weight_ih"])
        self.weight_hh = nn.Parameter(params["weight_hh"])
        self.bias = nn.Parameter(params["bias"])
        self.hidden_size = hidden_size
        self.k = k
        self.nonlin = nonlin
        self.hyperbolic_input = hyperbolic_input
        self.hyperbolic_hidden_state0 = hyperbolic_hidden_state0

    def forward(self, inputs, h0=None, lengths=None, batch_sizes=None):
        batch = inputs.shape[1] if batch_sizes is None else int(
            np.asarray(batch_sizes)[0])
        if h0 is None:
            h0 = inputs.new_zeros((batch, self.hidden_size))
        kw = dict(k=self.k, hyperbolic_input=self.hyperbolic_input,
                  hyperbolic_hidden_state0=self.hyperbolic_hidden_state0,
                  nonlin=self.nonlin)
        if batch_sizes is not None:
            return mobius_gru_loop_packed(inputs, batch_sizes, h0,
                                          self.weight_ih, self.weight_hh,
                                          self.bias, **kw)
        return mobius_gru_loop(inputs, h0, self.weight_ih, self.weight_hh,
                               self.bias, lengths=lengths, **kw)


class MobiusDist2Hyperplane(nn.Module):
    """Learned hyperplanes (``point`` and ``tangent`` (out, in), ``scale``
    (out,)); ``forward(x)`` is :func:`dist2hyperplane_apply`. Weights from
    ``generator`` (seed 0 when None) by :func:`init_dist2hyperplane`."""

    def __init__(self, in_features, out_features, k=-1.0, generator=None,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        params = init_dist2hyperplane(generator, in_features, out_features,
                                      dtype, device)
        self.point = nn.Parameter(params["point"])
        self.tangent = nn.Parameter(params["tangent"])
        self.scale = nn.Parameter(params["scale"])
        self.k = k

    def forward(self, x):
        return dist2hyperplane_apply({"point": self.point,
                                      "tangent": self.tangent,
                                      "scale": self.scale}, x, self.k)
