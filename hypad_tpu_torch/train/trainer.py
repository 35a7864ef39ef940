"""WGAN-GP training of the TadGAN / HypAD model, one epoch at a time.

Port of ``hypad_tpu.train.trainer``. An epoch is 5 full critic passes over
the shuffled windows (drop_last, a fresh shuffle each), then one generator
pass, with per-epoch mean losses. Each critic step runs one of three paths,
chosen by ``fused_critics`` as the JAX config names them:

* ``"full"``: K5, the whole step body below the batch gather and above the
  Adam updates, in one kernel (``critic_step_fused_full``);
* ``True``: the generator forwards in torch, then K4 (``critics_fused_grads``);
* ``False`` (default, as in JAX's ``train_tadgan`` and ``train_fleet``): the
  autograd composition of ``train/losses.py``, the only path that runs on a
  mesh of several devices.

With ``mesh`` (``parallel/mesh.py``) each step's rows are split over the
mesh's ``dp`` devices (:func:`mesh_forwards`): every forward runs slab by
slab, each slab on its device with differentiable copies of the
parameters, and its outputs are gathered to the lead device, where the
losses reduce the whole batch as unsharded (one GP norm over the whole
flattened batch, the generator loss Σ / B). Backward sums every copy's
gradient into the lead parameters, which the optimizers update.

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

A fleet epoch (:func:`run_fleet_epoch`, the counterpart of JAX's vmapped
``_make_epoch_body``) trains S models at once, each fleet step one batched
step for all S: the critic step is K5 (or K4) with a signal axis, one launch
whatever S is. Signal i's draws are its own single-model draws
(:func:`fleet_epoch_draws`) in JAX's ragged layout; a step past a signal's
own ``5 * (n_i // B)`` critic / ``n_i // B`` generator schedule is a no-op
for it (its parameters, moments and step counters are kept), so every
signal trains exactly its single-model schedule.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from hypad_tpu_torch._device import resolve_device
from hypad_tpu_torch.models.tadgan import (
    CX_DROPOUT,
    CZ_DROPOUT,
    DEC_LSTM_DROPOUT,
)
from hypad_tpu_torch.optim.radam import (
    adam,
    adam_fleet,
    riemannian_adam,
    riemannian_adam_fleet,
)
from hypad_tpu_torch.train.critic_kernel import (
    critic_params,
    critic_step_fleet_plain,
    critic_step_fused_full,
    critic_step_fused_full_fleet,
    critic_step_plain,
    critics_fused_grads,
    critics_fused_grads_fleet,
)
from hypad_tpu_torch.train.losses import (  # noqa: F401  (re-exported)
    N_CRITICS,
    critic_step_inputs,
    critic_step_inputs_fleet,
    critic_x_loss,
    critic_z_loss,
    generator_loss,
    generator_loss_fleet,
)

CRITIC_DRAWS = ("z_x", "a_x", "z_z", "a_z", "m_cx", "m_cz", "m_dec")
GEN_DRAWS = ("gen_idx", "gen_z", "gen_m_cx", "gen_m_cz", "gen_m_dec")


@dataclass
class TrainState:
    """The model (updated in place) and the three optimizer states.
    ``program``: on the card, the captured epoch (``train/graphed.py``)
    of the last :func:`train_tadgan` call, which the next call on the same
    model and windows replays."""
    model: Any       # nn.ModuleDict: encoder, decoder, critic_x, critic_z
    opt_cx: Any
    opt_cz: Any
    opt_gen: Any
    epoch: int
    program: Any = field(default=None, repr=False, compare=False)


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
    LSTM output width) of a model, or of a fleet's stacked parameters (a
    dict keyed like the model's ``state_dict``)."""
    if isinstance(model, dict):
        def shape(key):
            return model[key].shape[-2:]
        dec_dirs = 2 if "decoder.lstm.0.w_ih_rev" in model else 1
        return (shape("critic_x.dense1.w")[1], shape("decoder.dense1.w")[1],
                shape("critic_x.dense1.w")[0], shape("critic_z.dense1.w")[0],
                shape("decoder.lstm.0.w_hh")[1] * dec_dirs)
    lstm0 = model["decoder"].lstm[0]
    return (model["critic_x"].dense1.w.shape[1],
            model["decoder"].dense1.w.shape[1],
            model["critic_x"].dense1.w.shape[0],
            model["critic_z"].dense1.w.shape[0],
            lstm0["w_hh"].shape[1] * (2 if "w_ih_rev" in lstm0 else 1))


def epoch_draws(generator, n, batch_size, model, n_real=None):
    """Every random draw of one epoch, on the CPU, from ``generator``.

    Critic steps (S = 5 * (n // batch_size)): ``critic_idx`` (S, B),
    ``z_x``/``z_z`` (S, B, latent) normal, ``a_x`` (S, B, W) and ``a_z``
    (S, B, latent) uniform, keep-masks ``m_cx`` (S, 4, 3B, Hx), ``m_cz``
    (S, 2, 3B, Hz), ``m_dec`` (S, B, 128). Generator steps: ``gen_idx``,
    ``gen_z``, ``gen_m_cx`` (nb, 4, B, Hx), ``gen_m_cz`` (nb, 2, B, Hz),
    ``gen_m_dec`` (nb, 2B, 128). ``model``: the model, or stacked
    parameters (only the widths are read).

    ``n_real``: ``n`` counts padded rows of which the first ``n_real`` are
    real (a canonical fleet's signal): each shuffle is then JAX's masked
    one (``_masked_shuffled_index``), the argsort of uniform keys with the
    pad rows' keys set to 2, so the first ``n_real // B`` batches hold
    only real rows, and every draw is shaped by the padded count."""
    W, latent, hx, hz, dec_width = _widths(model)
    nb, B = n // batch_size, batch_size
    g = generator

    def perm():
        if n_real is None:
            return torch.randperm(n, generator=g)[:nb * B].view(nb, B)
        u = torch.rand(n, generator=g)
        u[int(n_real):] = 2.0
        return torch.argsort(u, stable=True)[:nb * B].view(nb, B)

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


_MESH_FUSED = ("fused_critics is a single-device path (the megakernel is not "
               "shard_map'd over the dp mesh); use the default critic step "
               "when training over multiple devices")


def check_fused_critics(fused_critics):
    """``fused_critics`` is one of the three paths, or ValueError."""
    if not (fused_critics == "full" or fused_critics is True
            or fused_critics is False):
        raise ValueError('fused_critics must be "full", True or False, '
                         f"got {fused_critics!r}")


def check_mesh_fused(fused_critics, mesh):
    """JAX's guard: a truthy ``fused_critics`` on a mesh of more than one
    device raises (hypad_tpu/train/trainer.py:296-300)."""
    if fused_critics and mesh is not None and mesh.size > 1:
        raise ValueError(_MESH_FUSED)


def _critic_step(model, x, d, hyperbolic, fused_critics, mesh=None):
    if fused_critics is False:
        return critic_step_plain(model, x, d, hyperbolic, mesh)
    if fused_critics == "full":
        return critic_step_fused_full(model, x, d, hyperbolic)
    bigx, bigz = critic_step_inputs(model, x, d, hyperbolic)
    return critics_fused_grads(model["critic_x"], model["critic_z"],
                               bigx, bigz, d["m_cx"], d["m_cz"])


def critic_pass(state, X, d, *, lr, hyperbolic, fused_critics=False,
                mesh=None):
    """The epoch's 5 critic passes: one critic step per row of
    ``d["critic_idx"]``, each followed by the two critics' Adam updates.
    ``d`` holds the epoch's draws on X's device. Returns the per-step
    (lx, lz) as two lists of 0-d tensors."""
    check_fused_critics(fused_critics)
    check_mesh_fused(fused_critics, mesh)
    model = state.model
    opt_cx, opt_cz, _ = make_optimizers(lr, hyperbolic)
    p_cx = critic_params(model["critic_x"], "critic_x")
    p_cz = critic_params(model["critic_z"], "critic_z")
    lxs, lzs = [], []
    for s in range(d["critic_idx"].shape[0]):
        x = X[d["critic_idx"][s]]
        lx, lz, gx, gz = _critic_step(model, x, {k: d[k][s]
                                                 for k in CRITIC_DRAWS},
                                      hyperbolic, fused_critics, mesh)
        state.opt_cx = opt_cx.update(gx, state.opt_cx, p_cx)
        state.opt_cz = opt_cz.update(gz, state.opt_cz, p_cz)
        lxs.append(lx)
        lzs.append(lz)
    return lxs, lzs


def generator_pass(state, X, d, *, lr, hyperbolic, mesh=None):
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
                                       masks, mesh)
            grads = torch.autograd.grad(loss, list(p_gen.values()))
        state.opt_gen = opt_gen.update(dict(zip(p_gen, grads)),
                                       state.opt_gen, p_gen)
        lgs.append(loss.detach())
        recs.append(rec.detach())
    return lgs, recs


def run_epoch(state, X, draws, *, lr, hyperbolic, fused_critics=False,
              mesh=None):
    """One epoch on ``X`` (N, W) float32 on the model's device, from
    ``draws`` as :func:`epoch_draws` makes them (on any device): the critic
    passes, then the generator pass. Updates ``state`` in place and returns
    ``(state, metrics)``: the mean critic_x, critic_z, decoder and
    reconstruction losses as Python floats (reading them synchronises).
    ``mesh``: every step's rows split over its ``dp`` devices; the model
    and ``X`` lie on its lead device."""
    d = {k: v.to(X.device) for k, v in draws.items()}
    lxs, lzs = critic_pass(state, X, d, lr=lr, hyperbolic=hyperbolic,
                           fused_critics=fused_critics, mesh=mesh)
    lgs, recs = generator_pass(state, X, d, lr=lr, hyperbolic=hyperbolic,
                               mesh=mesh)
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
                 device="cuda", fused_critics=False, log_cb=None,
                 checkpoint_cb=None, mesh=None, start_epoch=None,
                 epochs_per_call=10):
    """Train ``model`` (an ``init_tadgan`` ModuleDict, or a
    :class:`TrainState` to resume) on windows ``X`` (N, W) for the epochs
    from ``start_epoch`` up to ``n_epochs``. Returns the final
    :class:`TrainState`. The model must lie on ``device``; a CUDA device
    without CUDA raises. ``X`` may be numpy or a tensor; a float32 tensor
    on ``device`` is used as it is, without a copy.

    JAX's chunks and cadence (hypad_tpu/train/trainer.py:595-652): the
    epochs run in chunks of at most ``epochs_per_call``, each ending at
    every multiple of 10 and at epoch ``n_epochs - 1``. After a chunk its
    metrics come off the device in one copy, ``log_cb(epoch, metrics)``
    fires for each of its epochs, and ``checkpoint_cb(epoch, state)`` fires
    where the chunk ends at a multiple of 10 or at ``n_epochs - 1``.
    ``start_epoch`` starts that epoch counter, as in JAX; it defaults to
    the state's ``epoch``. ``state.epoch`` counts the epochs run in the
    state. Epoch e's draws come from ``epoch_generator(seed, e)`` of this
    counter, so, unlike JAX's keys (made a chunk), they and every number of
    the run do not depend on ``epochs_per_call``; the port's draws were
    never JAX's bits (the tests inject JAX's where they compare numbers).

    With no mesh, or a mesh of one device, a chunk's epochs run the two
    step bodies of ``train/graphed.py``: on the card each captured once as
    a CUDA graph and replayed every step, on the CPU eagerly. On a mesh of
    more than one device each epoch is :func:`run_epoch`, eager, its rows
    split over the mesh's ``dp`` devices (the module docstring); ``device``
    is then its lead device, and the draws are the unsharded run's, split
    by rows. A truthy ``fused_critics`` on a mesh of more than one device
    raises JAX's ``ValueError`` before anything else."""
    from hypad_tpu_torch.train import graphed

    check_mesh_fused(fused_critics, mesh)
    device = resolve_device(device, mesh)
    state = (model if isinstance(model, TrainState)
             else init_train_state(model, lr, hyperbolic))
    params = list(state.model.parameters())
    if any(p.device != device for p in params):
        raise ValueError(f"train_tadgan: the model is on {params[0].device}, "
                         f"not on {device}")
    X = (X.to(device, torch.float32) if torch.is_tensor(X)
         else torch.as_tensor(np.asarray(X, np.float32), device=device))
    epoch = state.epoch if start_epoch is None else start_epoch
    chunks = graphed.chunk_sizes(epoch, n_epochs, epochs_per_call)
    sharded = mesh is not None and mesh.size > 1
    program = None if sharded or not chunks else graphed.program_for(
        state, X, lr=lr, hyperbolic=hyperbolic, batch_size=batch_size,
        fused_critics=fused_critics)

    def draws(e):
        return epoch_draws(epoch_generator(seed, e), X.shape[0], batch_size,
                           state.model)

    for chunk in chunks:
        if sharded:
            metrics = [run_epoch(state, X, draws(epoch + j), lr=lr,
                                 hyperbolic=hyperbolic,
                                 fused_critics=fused_critics, mesh=mesh)[1]
                       for j in range(chunk)]
        else:
            metrics = program.run(state, (draws(epoch + j)
                                          for j in range(chunk)))
        if log_cb is not None:
            for j, m in enumerate(metrics):
                log_cb(epoch + j + 1, m)
        epoch += chunk
        if checkpoint_cb is not None and (epoch % 10 == 0
                                          or epoch == n_epochs - 1):
            checkpoint_cb(epoch, state)
    return state


# ---------------------------------------------------------------------------
# the fleet epoch: S models, one batched step per fleet step
# ---------------------------------------------------------------------------

def make_fleet_optimizers(lr, hyperbolic):
    opt_gen = (riemannian_adam_fleet(lr, weight_decay=1e-5, stabilize=10)
               if hyperbolic else adam_fleet(lr))
    return adam_fleet(lr), adam_fleet(lr), opt_gen


def fleet_valid(n_real, batch_size, n_steps=None):
    """The step-validity masks of a fleet epoch, as JAX's ragged body makes
    them (hypad_tpu/train/trainer.py:468-476, :512-513): critic (S, 5 nb)
    = ``tile(j < n_i // B, 5)`` and generator (S, nb), nb = ``n_steps``
    (the padded row count // B), by default max n_i // B."""
    nb = np.asarray(n_real, np.int64) // batch_size
    if n_steps is None:
        n_steps = int(nb.max(initial=0))
    gen = np.arange(n_steps)[None, :] < nb[:, None]
    return np.tile(gen, (1, N_CRITICS)), gen


# the host threads that make a fleet epoch's per-signal draws (while the
# card runs the epoch before, under train_fleet)
DRAW_THREADS = 8


@functools.lru_cache(maxsize=None)
def _draw_pool(threads):
    return ThreadPoolExecutor(threads, thread_name_prefix="fleet-draws")


def fleet_epoch_draws(seeds, epoch, n_real, batch_size, params, n_pad=None):
    """Every draw of one fleet epoch, on the CPU, signal-major (S, steps,
    ...): signal i's are ``epoch_draws(epoch_generator(seeds[i], epoch),
    n_real[i], batch_size, params)``, the draws a single-model
    ``train_tadgan(seed=seeds[i])`` makes, laid out as JAX's ragged epoch
    lays its steps: critic pass p's step j at ``p * nb + j``, nb = max
    n_i // B. Steps past a signal's schedule hold zeros (never used).

    ``n_pad``: the padded row count of a canonical fleet. Signal i's draws
    are then ``epoch_draws(..., n_pad, batch_size, params,
    n_real=n_real[i])``, masked shuffles over the padded rows as JAX's
    canonical fleet draws them, nb = n_pad // B: not the draws of an
    unpadded run.

    The signals' draws are made on a pool of up to ``DRAW_THREADS``
    threads, each signal's from its own generator, so their bits do not
    depend on the pool."""
    B = batch_size

    def one(signal):
        sd, n = signal
        if n_pad is not None:
            return epoch_draws(epoch_generator(int(sd), epoch), int(n_pad),
                               B, params, n_real=int(n))
        return epoch_draws(epoch_generator(int(sd), epoch), int(n), B,
                           params)

    signals = list(zip(seeds, n_real))
    per = (list(_draw_pool(DRAW_THREADS).map(one, signals))
           if DRAW_THREADS > 1 and len(signals) > 1
           else [one(signal) for signal in signals])
    if n_pad is not None:
        return {k: torch.stack([d[k] for d in per]) for k in per[0]}
    nb = [int(n) // B for n in n_real]
    nb_max = max(nb, default=0)
    out = {}
    for key, ref in per[0].items():
        steps = N_CRITICS * nb_max if key in CRITIC_DRAWS + (
            "critic_idx",) else nb_max
        out[key] = torch.zeros((len(per), steps) + tuple(ref.shape[1:]),
                               dtype=ref.dtype)
    for i, d in enumerate(per):
        for key, v in d.items():
            if key in GEN_DRAWS:
                out[key][i, :nb[i]] = v
            else:
                for p in range(N_CRITICS):
                    out[key][i, p * nb_max:p * nb_max + nb[i]] = \
                        v[p * nb[i]:(p + 1) * nb[i]]
    return out


def _gather_rows(Xs, idx):
    """Xs (S, N, W), idx (S, B) -> (S, B, W): each signal's batch rows."""
    return torch.take_along_dim(Xs, idx[..., None].long(), dim=1)


def _fleet_critic_step(P, x, d, hyperbolic, fused_critics):
    if fused_critics == "full":
        return critic_step_fused_full_fleet(P, x, d, hyperbolic)
    if fused_critics is True:
        bigx, bigz = critic_step_inputs_fleet(P, x, d, hyperbolic)
        return critics_fused_grads_fleet(P, bigx, bigz, d["m_cx"],
                                         d["m_cz"])
    return critic_step_fleet_plain(P, x, d, hyperbolic)


def _prefixed(P, *prefixes):
    return {k: v for k, v in P.items() if k.split(".")[0] in prefixes}


def _masked_sum(values, valid):
    """Sum over steps of the (steps, S) ``values`` where ``valid``."""
    v = torch.stack(values)
    return torch.where(valid, v, 0.0).sum(dim=0)


def run_fleet_epoch(state, Xs, n_real, draws, *, lr, hyperbolic,
                    fused_critics=False):
    """One epoch of S models on the padded windows ``Xs`` (S, N, W) float32
    on the models' device, signal i's real rows ``[0, n_real[i])``, from
    ``draws`` as :func:`fleet_epoch_draws` lays them out (on any device;
    their generator step count is the epoch's nb). ``state`` is a
    ``train.fleet.FleetState``, updated in place. Returns ``(state,
    metrics)``, each metric (S,) numpy: the means over each signal's real
    steps (sum / (5 nb_i) and sum / nb_i, as
    hypad_tpu/train/trainer.py:537-545)."""
    state, means = fleet_epoch_device(state, Xs, n_real, draws, lr=lr,
                                      hyperbolic=hyperbolic,
                                      fused_critics=fused_critics)
    return state, fleet_metrics(means.cpu().numpy())


def fleet_metrics(means):
    """The metrics dict of :func:`fleet_epoch_device`'s (4, S) means."""
    return dict(zip(("critic_x_loss", "critic_z_loss", "decoder_loss",
                     "rec_loss"), means))


def fleet_epoch_device(state, Xs, n_real, draws, *, lr, hyperbolic,
                       fused_critics=False):
    """:func:`run_fleet_epoch` without reading its result: returns
    ``(state, means)``, the (4, S) means still on the device, so a caller
    can enqueue several devices' epochs before it waits for any."""
    check_fused_critics(fused_critics)
    B = draws["critic_idx"].shape[-1]
    valid_c, valid_g = fleet_valid(n_real, B, draws["gen_idx"].shape[1])
    # step-major on the device, so each step's slice is contiguous
    d = {k: v.to(Xs.device).transpose(0, 1).contiguous()
         for k, v in draws.items()}
    P = state.params
    p_cx, p_cz = _prefixed(P, "critic_x"), _prefixed(P, "critic_z")
    p_gen = _prefixed(P, "encoder", "decoder")
    opt_cx, opt_cz, opt_gen = make_fleet_optimizers(lr, hyperbolic)
    s_cx = opt_cx.schedule(state.opt_cx, valid_c.T)
    s_cz = opt_cz.schedule(state.opt_cz, valid_c.T)
    lxs, lzs = [], []
    for s in range(valid_c.shape[1]):
        x = _gather_rows(Xs, d["critic_idx"][s])
        lx, lz, gx, gz = _fleet_critic_step(
            P, x, {k: d[k][s] for k in CRITIC_DRAWS}, hyperbolic,
            fused_critics)
        state.opt_cx = opt_cx.update(gx, state.opt_cx, p_cx, s_cx, s)
        state.opt_cz = opt_cz.update(gz, state.opt_cz, p_cz, s_cz, s)
        lxs.append(lx)
        lzs.append(lz)

    s_gen = opt_gen.schedule(state.opt_gen, valid_g.T)
    gen_keys = list(p_gen)
    lgs, recs = [], []
    for s in range(valid_g.shape[1]):
        x = _gather_rows(Xs, d["gen_idx"][s])
        masks = {"m_cx": d["gen_m_cx"][s], "m_cz": d["gen_m_cz"][s],
                 "m_dec": d["gen_m_dec"][s]}
        with torch.enable_grad():
            Pg = {**P, **{k: P[k].detach().requires_grad_(True)
                          for k in gen_keys}}
            loss, rec = generator_loss_fleet(Pg, x, hyperbolic,
                                             d["gen_z"][s], masks)
            grads = torch.autograd.grad(loss.sum(),
                                        [Pg[k] for k in gen_keys])
        state.opt_gen = opt_gen.update(dict(zip(gen_keys, grads)),
                                       state.opt_gen, p_gen, s_gen, s)
        lgs.append(loss.detach())
        recs.append(rec.detach())

    nb = np.asarray(n_real, np.int64) // B
    denom_c = torch.as_tensor(np.maximum(N_CRITICS * nb, 1), device=Xs.device,
                              dtype=torch.float32)
    denom_g = torch.as_tensor(np.maximum(nb, 1), device=Xs.device,
                              dtype=torch.float32)
    sums = []
    if valid_c.shape[1]:
        vc = s_cx.valid
        sums += [_masked_sum(lxs, vc) / denom_c,
                 _masked_sum(lzs, vc) / denom_c]
        vg = s_gen.valid
        sums += [_masked_sum(lgs, vg) / denom_g,
                 _masked_sum(recs, vg) / denom_g]
    else:
        sums = [torch.zeros_like(denom_c)] * 4
    state.epoch += 1
    return state, torch.stack(sums)
