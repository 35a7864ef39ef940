"""The critic step as one kernel: K4 and K5, their wrappers and plain versions.

``critics_fused_grads`` (K4) and ``critic_step_fused_full`` (K5) wrap the
hand-written kernels of ``csrc/critic_step.cu``, which replace the Pallas
kernels ``hypad_tpu/train/critic_kernel.py:156`` ``_kernel`` and ``:350``
``_kernel_full``. K4 takes the two critics' stacked rows and keep-masks and
returns both WGAN-GP losses with every critic parameter's gradient; K5 also
runs the step's gradient-free generator forwards first. On a CUDA tensor a
wrapper launches its kernel (or raises); on a CPU tensor it runs the plain
version beside it, which is the autograd composition of the training losses
(``train/losses.py``), not the kernel's hand-derived closed form, so on the
card the kernel is held against autodiff. Each wrapper counts its kernel
launches in ``.launches``, those of the wide instance (widths of 129 to
256, multivariate feature counts) in ``.wide_launches`` too, and those of
the any-width instance (above 256) in ``.xwide_launches``. The any-width
instance stages its input rows in dynamic shared memory, at least one row
of the widest input at a time, so a launch takes widths up to about 58,000
floats (227 KB); a wider launch is refused by the card and the wrapper
raises its CUDA error.

Both return ``(lx, lz, grads_cx, grads_cz)``: 0-d loss tensors and dicts of
gradients keyed like the port's ``state_dict`` (``"critic_x.dense1.w"``).

``critics_fused_grads_fleet`` and ``critic_step_fused_full_fleet`` are the
same two kernels with a signal axis (the fleet's counterpart of
``jax.vmap``): the stacked parameters of ``train/fleet.py`` and inputs with a
leading S go to ONE launch of grid (16, S), each signal's two clusters on
its own slices, which gives each signal the bits of its own single-signal
launch. They return (S,) losses and gradients with a leading S, count in the
same ``.launches`` as the single-signal wrappers, and on CPU tensors run the
batched autograd composition of ``train/losses.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hypad_tpu_torch import _build
from hypad_tpu_torch.models import fleet as mf
from hypad_tpu_torch.train.losses import (
    critic_loss_stacked,
    critic_step_inputs,
    critic_step_inputs_fleet,
    fleet_forwards,
)

CX_LAYERS = ("dense1", "dense2", "dense3", "dense4", "dense5")
CZ_LAYERS = ("dense1", "dense2", "dense3")
LSTM_KEYS = ("w_ih", "b_ih", "b_hh", "w_ih_rev", "b_ih_rev", "b_hh_rev")
N_SLOTS = 70          # csrc/critic_step.cu `Slot`
SLOT_X, SLOT_ZX, SLOT_AX, SLOT_ZZ, SLOT_AZ = 0, 1, 2, 3, 4
SLOT_MDEC, SLOT_MCX, SLOT_MCZ, SLOT_BIGX, SLOT_BIGZ = 5, 6, 7, 8, 9
SLOT_ENC, SLOT_DEC, SLOT_CX, SLOT_CZ = 10, 18, 36, 46
SLOT_LOSS, SLOT_GCX, SLOT_GCZ, SLOT_WS = 52, 53, 63, 69


def critic_params(critic, prefix):
    """{"critic_x.dense1.w": tensor, ...} of one critic."""
    return dict(critic.named_parameters(prefix=prefix))


def _grads(lx, lz, critic_x, critic_z):
    px = critic_params(critic_x, "critic_x")
    pz = critic_params(critic_z, "critic_z")
    grads = torch.autograd.grad(lx + lz, [*px.values(), *pz.values()])
    return (dict(zip(px, grads[:len(px)])), dict(zip(pz, grads[len(px):])))


def critics_fused_grads_plain(critic_x, critic_z, bigx, bigz, mx, mz):
    """K4's plain version: autograd of both critics' WGAN-GP losses."""
    with torch.enable_grad():
        lx = critic_loss_stacked(critic_x, bigx, mx, +1)
        lz = critic_loss_stacked(critic_z, bigz, mz, -1)
        gx, gz = _grads(lx, lz, critic_x, critic_z)
    return lx.detach(), lz.detach(), gx, gz


def critic_step_plain(model, x, draws, hyperbolic):
    """K5's plain version: the generator forwards, then K4's plain
    version. ``draws``: one step's z_x, a_x, z_z, a_z, m_cx (4, 3B, Hx),
    m_cz (2, 3B, Hz), m_dec (B, 128)."""
    bigx, bigz = critic_step_inputs(model, x, draws, hyperbolic)
    return critics_fused_grads_plain(model["critic_x"], model["critic_z"],
                                     bigx, bigz, draws["m_cx"],
                                     draws["m_cz"])


@functools.cache
def _lib():
    return bind(_build.load("critic_step"))


def bind(lib):
    """Set the argument and result types of a library built from
    ``csrc/critic_step.cu``; returns it."""
    lib.critic_step_workspace_floats.argtypes = [ctypes.c_void_p]
    lib.critic_step_workspace_floats.restype = ctypes.c_longlong
    lib.critics_fused_grads_forward.argtypes = [ctypes.c_void_p] * 3
    lib.critics_fused_grads_forward.restype = ctypes.c_int
    lib.critic_step_full_forward.argtypes = ([ctypes.c_void_p] * 2
                                             + [ctypes.c_int, ctypes.c_void_p])
    lib.critic_step_full_forward.restype = ctypes.c_int
    # a baseline source (profile_critic_step.py) may predate the signal axis
    if hasattr(lib, "critic_step_full_signals_forward"):
        lib.critics_fused_grads_signals_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
        lib.critics_fused_grads_signals_forward.restype = ctypes.c_int
        lib.critic_step_full_signals_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.critic_step_full_signals_forward.restype = ctypes.c_int
    return lib


def launch_shape():
    """(clusters, blocks a cluster, threads a block) of a K4 or K5 launch,
    as ``csrc/critic_step.cu`` sets them; builds the library if needed."""
    shape = (ctypes.c_int * 3)()
    _lib().critic_step_launch_shape(shape)
    return tuple(shape)


def _check(name, device, **tensors):
    """Each tensor on ``device`` and contiguous; keep-masks (keys starting
    with "m") bool, the rest float32."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        want = torch.bool if key.startswith("m") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _shape(name, key, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _instance(widths):
    """The instance a launch on these widths takes, as
    csrc/critic_step.cu's launch decides by the widest: "narrow", "wide"
    or "xwide"."""
    return _build.instance(max(widths))


def _dims(B, W, L, Hx, Hz, He=1, D1=1, Hd=1):
    return (ctypes.c_int * 8)(B, W, L, Hx, Hz, He, D1, Hd)


def _critic_slots(ptrs, critic_x, critic_z, device):
    """Fill the critic parameter and gradient slots; returns the gradient
    dicts and the (2,) loss buffer."""
    gx, gz = {}, {}
    for slot, gslot, critic, prefix, layers, grads in (
            (SLOT_CX, SLOT_GCX, critic_x, "critic_x", CX_LAYERS, gx),
            (SLOT_CZ, SLOT_GCZ, critic_z, "critic_z", CZ_LAYERS, gz)):
        for i, layer in enumerate(layers):
            for j, leaf in enumerate(("w", "b")):
                p = getattr(getattr(critic, layer), leaf)
                _check("critic step", device, **{f"{prefix}.{layer}.{leaf}": p})
                g = torch.empty_like(p)
                ptrs[slot + 2 * i + j] = p.data_ptr()
                ptrs[gslot + 2 * i + j] = g.data_ptr()
                grads[f"{prefix}.{layer}.{leaf}"] = g
    loss = torch.empty(2, dtype=torch.float32, device=device)
    ptrs[SLOT_LOSS] = loss.data_ptr()
    return gx, gz, loss


def _run(fn_name, ptrs, dims, device, *extra):
    lib = _lib()
    ws = torch.empty(int(lib.critic_step_workspace_floats(dims)),
                     dtype=torch.float32, device=device)
    ptrs[SLOT_WS] = ws.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(ptrs, dims, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")


def _critic_dims(critic_x, critic_z, bigx, bigz, mx, mz, name):
    R, W = bigx.shape
    if bigx.dim() != 2 or R % 3 or R == 0:
        raise ValueError(f"{name}: bigx must be (3B, W), got "
                         f"{tuple(bigx.shape)}")
    Hx = critic_x.dense1.w.shape[0]
    Hz = critic_z.dense1.w.shape[0]
    L = critic_z.dense1.w.shape[1]
    _shape(name, "bigx", bigx, (R, critic_x.dense1.w.shape[1]))
    _shape(name, "bigz", bigz, (R, L))
    _shape(name, "mx", mx, (4, R, Hx))
    _shape(name, "mz", mz, (2, R, Hz))
    return R // 3, W, L, Hx, Hz


def k4_launch_args(critic_x, critic_z, bigx, bigz, mx, mz):
    """K4's pointer slots, dims and the outputs (lx, lz, grads_cx,
    grads_cz) it fills, for inputs the wrapper has checked."""
    ptrs = (ctypes.c_void_p * N_SLOTS)()
    for slot, t in ((SLOT_BIGX, bigx), (SLOT_BIGZ, bigz), (SLOT_MCX, mx),
                    (SLOT_MCZ, mz)):
        ptrs[slot] = t.data_ptr()
    gx, gz, loss = _critic_slots(ptrs, critic_x, critic_z, bigx.device)
    dims = _dims(*_critic_dims(critic_x, critic_z, bigx, bigz, mx, mz,
                               "critics_fused_grads"))
    return ptrs, dims, (loss[0], loss[1], gx, gz)


def k5_launch_args(model, x, d, hyperbolic):
    """K5's pointer slots, dims and outputs, as :func:`k4_launch_args`,
    and last the stacked rows (bigx, bigz) the kernel writes, which the
    caller holds until the launch is enqueued; ``d`` holds one step's
    draws."""
    device = x.device
    enc, dec = model["encoder"], model["decoder"]
    B, W = x.shape
    L = model["critic_z"].dense1.w.shape[1]
    ptrs = (ctypes.c_void_p * N_SLOTS)()
    for slot, key in ((SLOT_ZX, "z_x"), (SLOT_AX, "a_x"), (SLOT_ZZ, "z_z"),
                      (SLOT_AZ, "a_z"), (SLOT_MDEC, "m_dec"),
                      (SLOT_MCX, "m_cx"), (SLOT_MCZ, "m_cz")):
        ptrs[slot] = d[key].data_ptr()
    ptrs[SLOT_X] = x.data_ptr()
    bigx = torch.empty((3 * B, W), dtype=torch.float32, device=device)
    bigz = torch.empty((3 * B, L), dtype=torch.float32, device=device)
    ptrs[SLOT_BIGX], ptrs[SLOT_BIGZ] = bigx.data_ptr(), bigz.data_ptr()
    gen = ([enc.lstm[0][k] for k in LSTM_KEYS] + [enc.dense.w, enc.dense.b]
           + [dec.dense1.w, dec.dense1.b]
           + [dec.lstm[0][k] for k in LSTM_KEYS]
           + [dec.lstm[1][k] for k in LSTM_KEYS]
           + [dec.dense2.w, dec.dense2.b])
    if hyperbolic:
        gen += [dec.hyperbolic_linear.w, dec.hyperbolic_linear.b]
    for i, p in enumerate(gen):
        _check("critic_step_fused_full", device, generator_weight=p)
        ptrs[SLOT_ENC + i] = p.data_ptr()
    gx, gz, loss = _critic_slots(ptrs, model["critic_x"], model["critic_z"],
                                 device)
    dims = _dims(B, W, L, model["critic_x"].dense1.w.shape[0],
                 model["critic_z"].dense1.w.shape[0],
                 enc.lstm[0]["w_hh"].shape[1], dec.dense1.w.shape[0],
                 dec.lstm[0]["w_hh"].shape[1])
    return ptrs, dims, (loss[0], loss[1], gx, gz), (bigx, bigz)


def critics_fused_grads(critic_x, critic_z, bigx, bigz, mx, mz):
    """(lx, lz, grads_cx, grads_cz) of one critic step: ``csrc``'s K4 for
    CUDA tensors, :func:`critics_fused_grads_plain` for CPU tensors.
    ``bigx`` (3B, W) = [x, x_fake, interp_x], ``bigz`` (3B, L) =
    [z_enc, z, interp_z], ``mx`` (4, 3B, Hx) and ``mz`` (2, 3B, Hz) bool
    keep-masks."""
    name = "critics_fused_grads"
    kind = _instance(_critic_dims(critic_x, critic_z, bigx, bigz, mx, mz,
                                  name)[1:])
    device = bigx.device
    _check(name, device, bigx=bigx, bigz=bigz, mx=mx, mz=mz)
    if device.type == "cpu":
        return critics_fused_grads_plain(critic_x, critic_z, bigx, bigz, mx,
                                         mz)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    ptrs, dims, out = k4_launch_args(critic_x, critic_z, bigx, bigz, mx, mz)
    _run("critics_fused_grads_forward", ptrs, dims, device)
    _build.count_launch(critics_fused_grads, kind)
    return out


# every launch, and those of the wide and the any-width instance among them
critics_fused_grads.launches = 0
critics_fused_grads.wide_launches = 0
critics_fused_grads.xwide_launches = 0


def critic_step_fused_full(model, x, draws, hyperbolic):
    """(lx, lz, grads_cx, grads_cz) of one whole critic step, generator
    forwards included: ``csrc``'s K5 for a CUDA ``x``,
    :func:`critic_step_plain` for a CPU ``x``. ``draws`` as
    :func:`critic_step_plain` takes them."""
    name = "critic_step_fused_full"
    device = x.device
    d = {k: draws[k] for k in ("z_x", "a_x", "z_z", "a_z", "m_cx", "m_cz",
                               "m_dec")}
    _check(name, device, x=x, **d)
    enc, dec = model["encoder"], model["decoder"]
    if hyperbolic != dec.hyperbolic:
        raise ValueError(f"{name}: hyperbolic={hyperbolic} but the decoder "
                         f"has hyperbolic={dec.hyperbolic}")
    B, W = x.shape
    L = model["critic_z"].dense1.w.shape[1]
    Hx = model["critic_x"].dense1.w.shape[0]
    Hz = model["critic_z"].dense1.w.shape[0]
    Hd = dec.lstm[0]["w_hh"].shape[1]
    for key, shape in (("z_x", (B, L)), ("a_x", (B, W)), ("z_z", (B, L)),
                       ("a_z", (B, L)), ("m_cx", (4, 3 * B, Hx)),
                       ("m_cz", (2, 3 * B, Hz)), ("m_dec", (B, 2 * Hd))):
        _shape(name, key, d[key], shape)
    if len(dec.lstm) != 2 or len(enc.lstm) != 1:
        raise ValueError(f"{name}: expected a 1-layer encoder and a 2-layer "
                         "decoder LSTM")
    kind = _instance((W, L, Hx, Hz, dec.dense1.w.shape[0], 2 * Hd,
                      2 * enc.lstm[0]["w_hh"].shape[1]))
    if device.type == "cpu":
        return critic_step_plain(model, x, d, hyperbolic)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")

    ptrs, dims, out, _rows = k5_launch_args(model, x, d, hyperbolic)
    _run("critic_step_full_forward", ptrs, dims, device,
         int(bool(hyperbolic)))
    _build.count_launch(critic_step_fused_full, kind)
    return out


critic_step_fused_full.launches = 0
critic_step_fused_full.wide_launches = 0
critic_step_fused_full.xwide_launches = 0


# ---------------------------------------------------------------------------
# the signal axis: one launch for a whole fleet
# ---------------------------------------------------------------------------

CX_KEYS = tuple(f"critic_x.{layer}.{leaf}" for layer in CX_LAYERS
                for leaf in ("w", "b"))
CZ_KEYS = tuple(f"critic_z.{layer}.{leaf}" for layer in CZ_LAYERS
                for leaf in ("w", "b"))
ENC_KEYS = (tuple(f"encoder.lstm.0.{k}" for k in LSTM_KEYS)
            + ("encoder.dense.w", "encoder.dense.b"))
DEC_KEYS = (("decoder.dense1.w", "decoder.dense1.b")
            + tuple(f"decoder.lstm.{i}.{k}" for i in (0, 1)
                    for k in LSTM_KEYS)
            + ("decoder.dense2.w", "decoder.dense2.b"))
HEAD_KEYS = ("decoder.hyperbolic_linear.w", "decoder.hyperbolic_linear.b")


def _critic_grads_fleet(lx, lz, P):
    """The stacked critic gradients of (S,) losses ``lx + lz``; ``P``'s
    critic leaves require grad."""
    keys = CX_KEYS + CZ_KEYS
    grads = torch.autograd.grad((lx + lz).sum(), [P[k] for k in keys])
    g = dict(zip(keys, grads))
    return ({k: g[k] for k in CX_KEYS}, {k: g[k] for k in CZ_KEYS})


def _with_critic_grad(P):
    return {**P, **{k: P[k].detach().requires_grad_(True)
                    for k in CX_KEYS + CZ_KEYS}}


def critics_fused_grads_fleet_plain(P, bigx, bigz, mx, mz):
    """K4's plain version with a signal axis: autograd of both critics'
    (S,) WGAN-GP losses (``losses.critic_loss_stacked``)."""
    with torch.enable_grad():
        Pg = _with_critic_grad(P)
        f = fleet_forwards(Pg)
        lx = critic_loss_stacked(f.critic_x, bigx, mx, +1)
        lz = critic_loss_stacked(f.critic_z, bigz, mz, -1)
        gx, gz = _critic_grads_fleet(lx, lz, Pg)
    return lx.detach(), lz.detach(), gx, gz


def critic_step_fleet_plain(P, x, draws, hyperbolic):
    """K5's plain version with a signal axis: the fleet's generator
    forwards, then :func:`critics_fused_grads_fleet_plain`."""
    bigx, bigz = critic_step_inputs_fleet(P, x, draws, hyperbolic)
    return critics_fused_grads_fleet_plain(P, bigx, bigz, draws["m_cx"],
                                           draws["m_cz"])


def _fleet_leaf_shapes(W, L, Hx, Hz, He=None, D1=None, Hd=None):
    """{key: per-signal shape} of every stacked leaf a signal-axis launch
    reads: the critics', and with ``He`` the generator's, from the dims
    the launch is given."""
    shapes = {}

    def dense(key, d_out, d_in):
        shapes[f"{key}.w"], shapes[f"{key}.b"] = (d_out, d_in), (d_out,)

    def lstm(prefix, H, d_in):
        for s in ("", "_rev"):
            shapes[f"{prefix}.w_ih{s}"] = (4 * H, d_in)
            for b in ("b_ih", "b_hh"):
                shapes[f"{prefix}.{b}{s}"] = (4 * H,)

    for prefix, layers, d_in, H in (("critic_x", CX_LAYERS, W, Hx),
                                    ("critic_z", CZ_LAYERS, L, Hz)):
        for i, layer in enumerate(layers):
            dense(f"{prefix}.{layer}", 1 if i == len(layers) - 1 else H,
                  d_in if i == 0 else H)
    if He is not None:
        lstm("encoder.lstm.0", He, W)
        dense("encoder.dense", L, 2 * He)
        dense("decoder.dense1", D1, L)
        lstm("decoder.lstm.0", Hd, D1)
        lstm("decoder.lstm.1", Hd, 2 * Hd)
        dense("decoder.dense2", W, 2 * Hd)
        dense("decoder.hyperbolic_linear", W, W)
    return shapes


def _check_fleet_leaves(name, P, S, keys, shapes):
    """Each of ``P``'s leaves ``keys`` is (S, *its per-signal shape)."""
    for key in keys:
        _shape(name, key, P[key], (S, *shapes[key]))


class _FleetSlots:
    """The pointer and byte-stride tables of a signal-axis launch over S
    signals."""

    def __init__(self, device, S):
        self.ptrs = (ctypes.c_void_p * N_SLOTS)()
        self.strides = (ctypes.c_longlong * N_SLOTS)()
        self.device = device
        self.S = S

    def put(self, slot, t, key, name="fleet critic step"):
        """Slot ``slot`` <- ``t``, checked as ``_check`` checks ``key``
        (a name starting with "m" is a bool keep-mask); its leading axis
        must be the signal axis, or the launch would read or write past
        it."""
        _check(name, self.device, **{key: t})
        if t.dim() == 0 or t.shape[0] != self.S:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected a leading signal axis of {self.S}")
        self.ptrs[slot] = t.data_ptr()
        self.strides[slot] = t.stride(0) * t.element_size()


def _fleet_critic_slots(slots, P, S, name):
    """The stacked critic parameters and fresh gradients; returns the
    gradient dicts and the (S, 2) losses."""
    gx, gz = {}, {}
    for base, gbase, keys, grads in ((SLOT_CX, SLOT_GCX, CX_KEYS, gx),
                                     (SLOT_CZ, SLOT_GCZ, CZ_KEYS, gz)):
        for i, key in enumerate(keys):
            g = torch.empty_like(P[key])
            slots.put(base + i, P[key], key, name)
            slots.put(gbase + i, g, f"grad {key}", name)
            grads[key] = g
    loss = torch.empty((S, 2), dtype=torch.float32, device=slots.device)
    slots.put(SLOT_LOSS, loss, "loss", name)
    return gx, gz, loss


def _run_fleet(fn_name, slots, dims, S, *extra):
    lib = _lib()
    ws = torch.empty((S, int(lib.critic_step_workspace_floats(dims))),
                     dtype=torch.float32, device=slots.device)
    slots.put(SLOT_WS, ws, "workspace", fn_name)
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(slots.ptrs, slots.strides, dims, S,
                                    *extra, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")


def _fleet_widths(P):
    """(W, L, Hx, Hz) of stacked parameters."""
    return (P["critic_x.dense1.w"].shape[2], P["critic_z.dense1.w"].shape[2],
            P["critic_x.dense1.w"].shape[1], P["critic_z.dense1.w"].shape[1])


def critics_fused_grads_fleet(P, bigx, bigz, mx, mz):
    """(lx (S,), lz (S,), grads_cx, grads_cz) of one fleet critic step:
    ``csrc``'s K4 with a signal axis, one launch, for CUDA tensors;
    :func:`critics_fused_grads_fleet_plain` for CPU tensors. ``P``: the
    stacked parameters; ``bigx`` (S, 3B, W), ``bigz`` (S, 3B, L), ``mx``
    (S, 4, 3B, Hx), ``mz`` (S, 2, 3B, Hz)."""
    name = "critics_fused_grads_fleet"
    S, R = bigx.shape[:2]
    W, L, Hx, Hz = _fleet_widths(P)
    for key, t, shape in (("bigx", bigx, (S, R, W)), ("bigz", bigz, (S, R, L)),
                          ("mx", mx, (S, 4, R, Hx)), ("mz", mz, (S, 2, R, Hz))):
        _shape(name, key, t, shape)
    if R % 3 or R == 0:
        raise ValueError(f"{name}: bigx must be (S, 3B, W), got "
                         f"{tuple(bigx.shape)}")
    kind = _instance((W, L, Hx, Hz))
    _check_fleet_leaves(name, P, S, CX_KEYS + CZ_KEYS,
                        _fleet_leaf_shapes(W, L, Hx, Hz))
    device = bigx.device
    _check(name, device, bigx=bigx, bigz=bigz, mx=mx, mz=mz)
    if device.type == "cpu":
        return critics_fused_grads_fleet_plain(P, bigx, bigz, mx, mz)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    slots = _FleetSlots(device, S)
    for slot, key, t in ((SLOT_BIGX, "bigx", bigx), (SLOT_BIGZ, "bigz", bigz),
                         (SLOT_MCX, "mx", mx), (SLOT_MCZ, "mz", mz)):
        slots.put(slot, t, key, name)
    gx, gz, loss = _fleet_critic_slots(slots, P, S, name)
    _run_fleet("critics_fused_grads_signals_forward", slots,
               _dims(R // 3, W, L, Hx, Hz), S)
    _build.count_launch(critics_fused_grads, kind)
    return loss[:, 0], loss[:, 1], gx, gz


def critic_step_fused_full_fleet(P, x, draws, hyperbolic):
    """(lx (S,), lz (S,), grads_cx, grads_cz) of one whole fleet critic
    step, generator forwards included: ``csrc``'s K5 with a signal axis,
    one launch, for a CUDA ``x``; :func:`critic_step_fleet_plain` for a CPU
    ``x``. x (S, B, W); ``draws`` one step's z_x, a_x, z_z, a_z, m_cx
    (S, 4, 3B, Hx), m_cz (S, 2, 3B, Hz), m_dec (S, B, 128)."""
    name = "critic_step_fused_full_fleet"
    device = x.device
    d = {k: draws[k] for k in ("z_x", "a_x", "z_z", "a_z", "m_cx", "m_cz",
                               "m_dec")}
    _check(name, device, x=x, **d)
    if hyperbolic != mf.is_hyperbolic(P):
        raise ValueError(f"{name}: hyperbolic={hyperbolic} but the "
                         f"parameters have hyperbolic={mf.is_hyperbolic(P)}")
    S, B, W = x.shape
    _, L, Hx, Hz = _fleet_widths(P)
    He = P["encoder.lstm.0.w_hh"].shape[2]
    Hd = P["decoder.lstm.0.w_hh"].shape[2]
    D1 = P["decoder.dense1.w"].shape[1]
    for key, shape in (("z_x", (S, B, L)), ("a_x", (S, B, W)),
                       ("z_z", (S, B, L)), ("a_z", (S, B, L)),
                       ("m_cx", (S, 4, 3 * B, Hx)),
                       ("m_cz", (S, 2, 3 * B, Hz)),
                       ("m_dec", (S, B, 2 * Hd))):
        _shape(name, key, d[key], shape)
    if mf.n_lstm_layers(P, "decoder.lstm") != 2 or mf.n_lstm_layers(
            P, "encoder.lstm") != 1:
        raise ValueError(f"{name}: expected a 1-layer encoder and a 2-layer "
                         "decoder LSTM")
    kind = _instance((W, L, Hx, Hz, D1, 2 * Hd, 2 * He))
    gen = ENC_KEYS + DEC_KEYS + (HEAD_KEYS if hyperbolic else ())
    _check_fleet_leaves(name, P, S, gen + CX_KEYS + CZ_KEYS,
                        _fleet_leaf_shapes(W, L, Hx, Hz, He, D1, Hd))
    if device.type == "cpu":
        return critic_step_fleet_plain(P, x, d, hyperbolic)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    slots = _FleetSlots(device, S)
    for slot, key in ((SLOT_ZX, "z_x"), (SLOT_AX, "a_x"), (SLOT_ZZ, "z_z"),
                      (SLOT_AZ, "a_z"), (SLOT_MDEC, "m_dec"),
                      (SLOT_MCX, "m_cx"), (SLOT_MCZ, "m_cz")):
        slots.put(slot, d[key], key, name)
    slots.put(SLOT_X, x, "x", name)
    bigx = torch.empty((S, 3 * B, W), dtype=torch.float32, device=device)
    bigz = torch.empty((S, 3 * B, L), dtype=torch.float32, device=device)
    slots.put(SLOT_BIGX, bigx, "bigx", name)
    slots.put(SLOT_BIGZ, bigz, "bigz", name)
    for i, key in enumerate(gen):
        slots.put(SLOT_ENC + i, P[key], key, name)
    gx, gz, loss = _fleet_critic_slots(slots, P, S, name)
    _run_fleet("critic_step_full_signals_forward", slots,
               _dims(B, W, L, Hx, Hz, He, D1, Hd), S, int(bool(hyperbolic)))
    _build.count_launch(critic_step_fused_full, kind)
    return loss[:, 0], loss[:, 1], gx, gz
