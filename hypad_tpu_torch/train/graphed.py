"""The training epoch as two captured step graphs, replayed on the card.

Port of JAX's compiled epoch: ``hypad_tpu.train.trainer`` ``build_epoch_fn``
jits one epoch into one device program and ``build_multi_epoch_fn`` fuses
``epochs_per_call`` of them with ``lax.scan``, so the host reads the metrics
once a chunk; ``hypad_tpu.train.fleet`` does the same for a vmapped fleet
(``build_fleet_multi_epoch_fn``). Here an epoch is two step bodies, each
written once:

* the critic step (``critic_step``): the batch and the step's draws
  gathered through a device step counter, the step of the chosen
  ``fused_critics`` path (K5, the generator forwards then K4, or the
  autograd step), then both critics' Adam updates; ``5 * nb`` of them an
  epoch;
* the generator step (``generator_step``): autograd of ``generator_loss``
  (K1 twice when hyperbolic), then Riemannian Adam (or Adam); ``nb`` of
  them an epoch.

:class:`EpochProgram` holds the bodies of one model, :class:`FleetProgram`
those of a fleet (``train/fleet.py``): every tensor with a leading signal
axis S, K5, K4 and K1 with their signal axis, and each update masked per
signal with the pass's device ``valid`` row (``optim.radam``
``DeviceFleetStep``), so a ragged signal's skipped steps keep its
parameters and moments, as ``trainer.fleet_epoch_device`` keeps them.

On a CUDA device each body is captured once into a ``torch.cuda.CUDAGraph``
and replayed every step. Every value a body reads or writes lies in static
storage the program owns: one epoch's draws (copied in before the epoch's
replays), the two step counters, the optimizers' coefficient tables (one
row a step, as ``optim.radam.fleet_schedule`` makes them, read through
``DeviceStep``), the moments (written back in place after each update) and
the per-step loss rows, from which the epoch's metrics are reduced on the
device, as ``trainer.run_epoch`` and ``trainer.fleet_epoch_device`` reduce
them. The parameters are updated in place. The first steps of the first
epoch a program runs are warm-up steps, run eagerly on a side stream: they
are real steps, counted in the step counter and the schedule, and the
capture that follows runs nothing. A capture or a replay that fails
raises; nothing goes back to the eager epoch.

On the CPU the same bodies run eagerly, with no capture, so the CPU tests
hold the very code the card captures against ``trainer.run_epoch`` and
``trainer.fleet_epoch_device``, which stay as they were (the mesh path
uses them).

A replay runs no Python, so the kernel wrappers' launch counters
(``.launches``, ``.wide_launches``, ``.xwide_launches``) are advanced after
each pass by what each graph captured, times its replays: the counts are
those of the eager epoch (``utils/capture.py``, which the detector's
programs share).

Each graph holds the addresses of the parameters: a program is made for
one model (or one fleet's stacked parameters), one window shape and one
configuration. ``trainer.train_tadgan`` keeps the card's program in the
``TrainState`` (:func:`program_for`) and ``fleet.train_fleet`` in the
``FleetState`` (:func:`fleet_program_for`), so a later call with that
state replays the same graphs. An :class:`EpochProgram` reads the caller's
``X`` where it lies; a :class:`FleetProgram` owns its (S, N, W) stack and
copies each call's into it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hypad_tpu_torch.optim.radam import DeviceFleetStep, DeviceStep
from hypad_tpu_torch.train.losses import (
    N_CRITICS,
    generator_loss,
    generator_loss_fleet,
)
from hypad_tpu_torch.train.trainer import (
    CRITIC_DRAWS,
    _critic_step,
    _fleet_critic_step,
    _gather_rows,
    _prefixed,
    check_fused_critics,
    critic_params,
    fleet_metrics,
    fleet_valid,
    gen_params,
    make_fleet_optimizers,
)
from hypad_tpu_torch.utils.capture import advance_counters, counted_capture

WARMUP_STEPS = 3       # eager steps on a side stream before each capture
METRICS = ("critic_x_loss", "critic_z_loss", "decoder_loss", "rec_loss")
_TABLES = ("bc1", "inv1", "bc2", "inv2", "stab")


def chunk_sizes(start_epoch, n_epochs, epochs_per_call):
    """The epochs of each chunk from ``start_epoch`` to ``n_epochs``, as
    JAX's ``train_tadgan`` cuts them (hypad_tpu/train/trainer.py:611-621):
    a chunk ends at every multiple of 10 and at ``n_epochs - 1``, where the
    checkpoints fall, and holds at most ``epochs_per_call`` epochs."""
    sizes, e = [], start_epoch
    while e < n_epochs:
        nxt = min((e // 10 + 1) * 10, n_epochs)
        if e < n_epochs - 1 < nxt:
            nxt = n_epochs - 1
        nxt = min(nxt, e + max(epochs_per_call, 1))
        sizes.append(nxt - e)
        e = nxt
    return sizes


def _store_moments(dst, new):
    """Write an update's new moments into the static ones ``dst``."""
    if isinstance(dst.mu, dict):
        names = list(dst.mu)
        torch._foreach_copy_([dst.mu[n] for n in names],
                             [new.mu[n] for n in names])
        torch._foreach_copy_([dst.nu[n] for n in names],
                             [new.nu[n] for n in names])
    else:
        dst.mu.copy_(new.mu)
        dst.nu.copy_(new.nu)


def _clone_moments(moments):
    if isinstance(moments, dict):
        return {n: v.clone() for n, v in moments.items()}
    return moments.clone()


class _Pass:
    """One step body's static state: its optimizers, their moments and
    coefficient tables, its step counter, its (steps, *lead) loss rows,
    its (steps, S) host ``valid`` mask (one signal for a single model) and
    (on the card) its captured graph with the launches it holds."""

    def __init__(self, body, valid, device, opts, rows, lead=()):
        self.body = body
        self.valid = valid
        self.n_steps = valid.shape[0]
        self.opts = opts                      # [(optimizer, params, name)]
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.rows = {name: torch.empty((self.n_steps, *lead),
                                       dtype=torch.float32, device=device)
                     for name in rows}
        self.moments = {}                     # name -> static opt state
        self.tables = {}                      # name -> (bc1, ..., stab)
        self.graph = None
        self.launches = {}                    # (wrapper, counter) -> n


class _Program:
    """What both programs share: the static state in and out, the epoch's
    draws and tables, the capture, the replays and the epoch loop. A
    subclass makes ``self.critic`` and ``self.generator`` (:class:`_Pass`)
    and gives ``_pick``, ``_schedule``, ``_check_state``, ``_epoch_means``
    and ``_metrics``."""

    draws = None

    # ------------------------------------------------------------------
    # what the bodies share
    # ------------------------------------------------------------------

    def _update(self, p, grads_by_opt):
        for (opt, params, name), grads in zip(p.opts, grads_by_opt):
            new = opt.update(grads, p.moments[name], params,
                             self._schedule(p, name), 0)
            _store_moments(p.moments[name], new)

    @staticmethod
    def _store_rows(p, counter, **values):
        for name, v in values.items():
            p.rows[name].index_copy_(0, counter, v.detach().reshape(
                (1,) + tuple(p.rows[name].shape[1:])))

    # ------------------------------------------------------------------
    # the host side: static state in and out, capture, replays
    # ------------------------------------------------------------------

    def _passes(self):
        return (self.critic, self.generator)

    def _load_state(self, state):
        """The state's moments into the static ones; returns its step
        counts, each (S,) int64 (one signal for a single model)."""
        steps = {}
        for p in self._passes():
            for _, _, name in p.opts:
                st = getattr(state, name)
                if name not in p.moments:
                    p.moments[name] = dataclasses.replace(
                        st, mu=_clone_moments(st.mu),
                        nu=_clone_moments(st.nu))
                else:
                    _store_moments(p.moments[name], st)
                steps[name] = np.array(st.step, np.int64).reshape(-1)
        return steps

    def _unload_state(self, state, steps):
        """Copies of the static moments, and the step counts, into
        ``state``."""
        for p in self._passes():
            for _, _, name in p.opts:
                m = p.moments[name]
                setattr(state, name, dataclasses.replace(
                    m, step=self._steps_out(steps[name]),
                    mu=_clone_moments(m.mu), nu=_clone_moments(m.nu)))

    def _load_epoch(self, draws, steps):
        """One epoch's draws and coefficient tables into the static
        buffers (on the CPU, the tensors themselves), the counters to 0;
        each step count advanced by its pass's valid steps."""
        if self.capture:
            if self.draws is None:
                self.draws = {k: torch.empty(v.shape, dtype=v.dtype,
                                             device=self.device)
                              for k, v in draws.items()}
            for k, v in draws.items():
                self.draws[k].copy_(v)
        else:
            self.draws = {k: v.to(self.device) for k, v in draws.items()}
        for p in self._passes():
            p.counter.zero_()
            for opt, _, name in p.opts:
                st = p.moments[name]
                sched = opt.schedule(dataclasses.replace(
                    st, step=steps[name]), p.valid)
                tables = tuple(getattr(sched, t) for t in _TABLES)
                if self.capture and name in p.tables:
                    for dst, src in zip(p.tables[name], tables):
                        dst.copy_(src)
                else:
                    p.tables[name] = tables
                steps[name] = steps[name] + p.valid.sum(axis=0)

    def _run_pass(self, p):
        if p.n_steps == 0:
            return
        if not self.capture:
            for _ in range(p.n_steps):
                p.body()
            return
        done = 0
        if p.graph is None:
            done = min(WARMUP_STEPS, p.n_steps)
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(done):
                    p.body()
            main.wait_stream(side)
            self._capture(p)
        for _ in range(p.n_steps - done):
            p.graph.replay()
        advance_counters(p.launches, p.n_steps - done)

    def _capture(self, p):
        """Capture ``p``'s body (which runs nothing) and what it launches;
        the wrappers' counters are left as they were."""
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph):
                p.body()

        _, p.launches = counted_capture(capture)
        p.graph = graph

    def run(self, state, draws_by_epoch):
        """Train ``state`` (whose parameters are this program's) one epoch
        for each draws dict that ``draws_by_epoch`` yields (it is advanced
        only once the previous epoch's replays are enqueued, so the host
        makes the next draws while the card runs). Updates ``state`` in
        place; returns one metrics dict an epoch, read from the device in
        one copy."""
        self._check_state(state)
        steps = self._load_state(state)
        means = []
        draws_iter = iter(draws_by_epoch)
        draws = next(draws_iter, None)
        while draws is not None:
            self._load_epoch(draws, steps)
            for p in self._passes():
                self._run_pass(p)
            state.epoch += 1
            draws = next(draws_iter, None)
            means.append(self._epoch_means())
        self._unload_state(state, steps)
        if not means:
            return []
        return self._metrics(torch.stack(means).cpu())


class EpochProgram(_Program):
    """The two step bodies of one model on one ``X`` and their static
    state; :meth:`run` trains epochs from given draws (as
    ``trainer.epoch_draws`` makes them). ``X`` (N, W) float32 on the
    model's device."""

    def __init__(self, model, X, *, lr, hyperbolic, batch_size,
                 fused_critics):
        check_fused_critics(fused_critics)
        nb = X.shape[0] // batch_size
        if nb < 1:
            raise ValueError(f"{X.shape[0]} windows make no batch of "
                             f"{batch_size}")
        self.model, self.X = model, X
        self.lr, self.hyperbolic = lr, hyperbolic
        self.batch_size, self.fused_critics = batch_size, fused_critics
        self.device = X.device
        self.capture = self.device.type == "cuda"
        opt_cx, opt_cz, opt_gen = make_fleet_optimizers(lr, hyperbolic)
        self.critic = _Pass(self.critic_step,
                            np.ones((N_CRITICS * nb, 1), bool), self.device,
                            [(opt_cx, critic_params(model["critic_x"],
                                                    "critic_x"), "opt_cx"),
                             (opt_cz, critic_params(model["critic_z"],
                                                    "critic_z"), "opt_cz")],
                            ("lx", "lz"))
        self.generator = _Pass(self.generator_step, np.ones((nb, 1), bool),
                               self.device,
                               [(opt_gen, gen_params(model), "opt_gen")],
                               ("loss", "rec"))

    def key(self):
        """What the graphs hold the addresses of, and the configuration
        they were captured for."""
        return _key(self.model, self.X, self.lr, self.hyperbolic,
                    self.batch_size, self.fused_critics)

    # ------------------------------------------------------------------
    # the step bodies: what the card captures, and the CPU runs eagerly
    # ------------------------------------------------------------------

    def _pick(self, name, counter):
        """Row ``counter`` of the epoch's draw ``name``, gathered on the
        device."""
        return self.draws[name].index_select(0, counter)[0]

    def _schedule(self, p, name):
        return DeviceStep(p.tables[name], p.counter)

    def critic_step(self):
        p = self.critic
        s = p.counter
        x = self.X.index_select(0, self._pick("critic_idx", s))
        d = {k: self._pick(k, s) for k in CRITIC_DRAWS}
        lx, lz, gx, gz = _critic_step(self.model, x, d, self.hyperbolic,
                                      self.fused_critics)
        self._update(p, (gx, gz))
        self._store_rows(p, s, lx=lx, lz=lz)
        s.add_(1)

    def generator_step(self):
        p = self.generator
        s = p.counter
        _, params, _ = p.opts[0]
        x = self.X.index_select(0, self._pick("gen_idx", s))
        masks = {"m_cx": self._pick("gen_m_cx", s),
                 "m_cz": self._pick("gen_m_cz", s),
                 "m_dec": self._pick("gen_m_dec", s)}
        with torch.enable_grad():
            loss, rec = generator_loss(self.model, x, self.hyperbolic,
                                       self._pick("gen_z", s), masks)
            grads = torch.autograd.grad(loss, list(params.values()))
        self._update(p, (dict(zip(params, grads)),))
        self._store_rows(p, s, loss=loss, rec=rec)
        s.add_(1)

    # ------------------------------------------------------------------
    # the state and the metrics
    # ------------------------------------------------------------------

    def _check_state(self, state):
        if state.model is not self.model:
            raise ValueError("EpochProgram.run: the state's model is not "
                             "the program's")

    @staticmethod
    def _steps_out(steps):
        return int(steps[0])

    def _epoch_means(self):
        rows = (self.critic.rows["lx"], self.critic.rows["lz"],
                self.generator.rows["loss"], self.generator.rows["rec"])
        return torch.stack([r.mean() for r in rows])

    @staticmethod
    def _metrics(means):
        return [dict(zip(METRICS, m)) for m in means.tolist()]


class FleetProgram(_Program):
    """The two step bodies of a fleet, S models stacked as in
    ``train/fleet.py``, on one (S, N, W) window shape with signal i's
    real rows ``[0, n_real[i])``, and their static state; :meth:`run`
    trains epochs from given draws (as ``trainer.fleet_epoch_draws`` makes
    them, signal-major), each bitwise ``trainer.fleet_epoch_device``'s on
    the same draws. ``params``: the fleet's stacked parameters, updated in
    place; ``Xs`` the windows, copied into the program's own stack (on
    the card) by :meth:`set_windows`."""

    def __init__(self, params, Xs, n_real, *, lr, hyperbolic, batch_size,
                 fused_critics):
        check_fused_critics(fused_critics)
        self.params = params
        self.n_real = tuple(int(n) for n in n_real)
        self.lr, self.hyperbolic = lr, hyperbolic
        self.batch_size, self.fused_critics = batch_size, fused_critics
        self.device = Xs.device
        self.capture = self.device.type == "cuda"
        self.shape = tuple(Xs.shape)
        S = self.shape[0]
        if len(self.n_real) != S:
            raise ValueError(f"FleetProgram: {len(self.n_real)} lengths for "
                             f"{S} signals")
        self.Xs = torch.empty_like(Xs) if self.capture else Xs
        self.nb = self.shape[1] // batch_size
        valid_c, valid_g = fleet_valid(self.n_real, batch_size, self.nb)
        nb_i = np.asarray(self.n_real, np.int64) // batch_size
        self.denoms = [torch.as_tensor(np.maximum(d, 1), device=self.device,
                                       dtype=torch.float32)
                       for d in (N_CRITICS * nb_i, nb_i)]
        opt_cx, opt_cz, opt_gen = make_fleet_optimizers(lr, hyperbolic)
        P = params
        # the masks laid out as fleet_epoch_device lays them (transposed
        # views): the metrics' masked sums then reduce in its order
        self.critic = _Pass(self.critic_step, valid_c.T, self.device,
                            [(opt_cx, _prefixed(P, "critic_x"), "opt_cx"),
                             (opt_cz, _prefixed(P, "critic_z"), "opt_cz")],
                            ("lx", "lz"), (S,))
        self.generator = _Pass(self.generator_step, valid_g.T, self.device,
                               [(opt_gen, _prefixed(P, "encoder", "decoder"),
                                 "opt_gen")],
                               ("loss", "rec"), (S,))
        for p in self._passes():
            p.valid_rows = torch.as_tensor(p.valid, device=self.device)

    def key(self):
        return _fleet_key(self.params, self.shape, self.device, self.n_real,
                          self.lr, self.hyperbolic, self.batch_size,
                          self.fused_critics)

    def set_windows(self, Xs):
        """The (S, N, W) windows of the next :meth:`run`: on the card
        copied into the program's stack, whose address the graphs hold;
        on the CPU used as they are."""
        if tuple(Xs.shape) != self.shape or Xs.device != self.device:
            raise ValueError(f"FleetProgram: windows {tuple(Xs.shape)} on "
                             f"{Xs.device}, expected {self.shape} on "
                             f"{self.device}")
        if self.capture:
            self.Xs.copy_(Xs)
        else:
            self.Xs = Xs

    # ------------------------------------------------------------------
    # the step bodies: what the card captures, and the CPU runs eagerly
    # ------------------------------------------------------------------

    def _pick(self, name, counter):
        """Every signal's row ``counter`` of the epoch's draw ``name``
        ((S, steps, ...)), gathered on the device: (S, ...), contiguous."""
        return self.draws[name].index_select(1, counter).squeeze(1)

    def _schedule(self, p, name):
        return DeviceFleetStep(p.tables[name], p.valid_rows, p.counter)

    def critic_step(self):
        p = self.critic
        s = p.counter
        x = _gather_rows(self.Xs, self._pick("critic_idx", s))
        d = {k: self._pick(k, s) for k in CRITIC_DRAWS}
        lx, lz, gx, gz = _fleet_critic_step(self.params, x, d,
                                            self.hyperbolic,
                                            self.fused_critics)
        self._update(p, (gx, gz))
        self._store_rows(p, s, lx=lx, lz=lz)
        s.add_(1)

    def generator_step(self):
        p = self.generator
        s = p.counter
        _, p_gen, _ = p.opts[0]
        P = self.params
        x = _gather_rows(self.Xs, self._pick("gen_idx", s))
        masks = {"m_cx": self._pick("gen_m_cx", s),
                 "m_cz": self._pick("gen_m_cz", s),
                 "m_dec": self._pick("gen_m_dec", s)}
        with torch.enable_grad():
            Pg = {**P, **{k: P[k].detach().requires_grad_(True)
                          for k in p_gen}}
            loss, rec = generator_loss_fleet(Pg, x, self.hyperbolic,
                                             self._pick("gen_z", s), masks)
            grads = torch.autograd.grad(loss.sum(), [Pg[k] for k in p_gen])
        self._update(p, (dict(zip(p_gen, grads)),))
        self._store_rows(p, s, loss=loss, rec=rec)
        s.add_(1)

    # ------------------------------------------------------------------
    # the state, the draws and the metrics
    # ------------------------------------------------------------------

    def _check_state(self, state):
        if state.params is not self.params:
            raise ValueError("FleetProgram.run: the state's parameters are "
                             "not the program's")

    def _load_epoch(self, draws, steps):
        want = (self.shape[0], self.nb)
        if tuple(draws["gen_idx"].shape[:2]) != want:
            raise ValueError(f"FleetProgram: generator draws "
                             f"{tuple(draws['gen_idx'].shape)}, expected "
                             f"(S, nb) = {want}")
        super()._load_epoch(draws, steps)

    @staticmethod
    def _steps_out(steps):
        return steps.copy()

    def _epoch_means(self):
        """The (4, S) means over each signal's real steps, as
        ``trainer.fleet_epoch_device`` reduces them."""
        c, g = self.critic, self.generator
        dc, dg = self.denoms
        return torch.stack([
            torch.where(c.valid_rows, c.rows["lx"], 0.0).sum(dim=0) / dc,
            torch.where(c.valid_rows, c.rows["lz"], 0.0).sum(dim=0) / dc,
            torch.where(g.valid_rows, g.rows["loss"], 0.0).sum(dim=0) / dg,
            torch.where(g.valid_rows, g.rows["rec"], 0.0).sum(dim=0) / dg])

    @staticmethod
    def _metrics(means):
        return [fleet_metrics(m) for m in means.numpy()]


def _key(model, X, lr, hyperbolic, batch_size, fused_critics):
    return (tuple(p.data_ptr() for p in model.parameters()), X.data_ptr(),
            tuple(X.shape), tuple(X.stride()), str(X.device), float(lr),
            bool(hyperbolic), int(batch_size), str(fused_critics))


def _fleet_key(params, shape, device, n_real, lr, hyperbolic, batch_size,
               fused_critics):
    return (tuple((k, v.data_ptr()) for k, v in params.items()),
            tuple(shape), str(device), tuple(int(n) for n in n_real),
            float(lr), bool(hyperbolic), int(batch_size), str(fused_critics))


def program_for(state, X, *, lr, hyperbolic, batch_size, fused_critics):
    """The :class:`EpochProgram` of ``state``'s model on ``X``: on the card
    the one kept in ``state.program`` if it was made for the same model,
    parameter and ``X`` storage and configuration (its graphs hold their
    addresses), else a new one, kept there; on the CPU a new one."""
    prog = state.program
    if (prog is not None and prog.model is state.model
            and prog.key() == _key(state.model, X, lr, hyperbolic,
                                   batch_size, fused_critics)):
        return prog
    prog = EpochProgram(state.model, X, lr=lr, hyperbolic=hyperbolic,
                        batch_size=batch_size, fused_critics=fused_critics)
    state.program = prog if prog.capture else None
    return prog


def fleet_program_for(states, Xs, n_real, *, lr, hyperbolic, batch_size,
                      fused_critics):
    """The :class:`FleetProgram` of the ``FleetState`` ``states`` on the
    windows ``Xs`` (S, N, W), set to them: on the card the one kept in
    ``states.program`` if it was made for the same parameter storage,
    window shape, lengths and configuration, else a new one, kept there;
    on the CPU a new one."""
    prog = states.program
    if not (isinstance(prog, FleetProgram) and prog.params is states.params
            and prog.key() == _fleet_key(states.params, Xs.shape, Xs.device,
                                         n_real, lr, hyperbolic, batch_size,
                                         fused_critics)):
        prog = FleetProgram(states.params, Xs, n_real, lr=lr,
                            hyperbolic=hyperbolic, batch_size=batch_size,
                            fused_critics=fused_critics)
        states.program = prog if prog.capture else None
    prog.set_windows(Xs)
    return prog
