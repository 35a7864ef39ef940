"""The fleet epoch's host-phase profiler (hypad_tpu_torch.profile_fleet),
on the CPU: its two ways of making the draws hand the program the same
epochs' draws, the prefetching one starting each next epoch's before the
current one is taken, and its timed run records each host phase once a
call of it and leaves the program as it was, its numbers those of an
untimed run."""

from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hypad_tpu_torch import profile_fleet as pf
from hypad_tpu_torch.models.tadgan import init_tadgan
from hypad_tpu_torch.train import fleet as fl
from hypad_tpu_torch.train import graphed
from hypad_tpu_torch.train import trainer as tr

W, B, LR = 8, 8, 5e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [0, 1, 3])
def test_both_ways_hand_over_the_same_epochs(n):
    """``draws_after`` and ``draws_prefetched`` yield epochs 5 .. 5 + n -
    1's draws in order; the prefetching one has asked for epoch e + 1's
    before epoch e's is taken (and for no epoch past the last)."""
    asked = []

    def make(e):
        asked.append(e)
        return {"epoch": e}

    assert [d["epoch"] for d in pf.draws_after(make, 5, n)] == \
        list(range(5, 5 + n))
    asked.clear()
    seen = [(d["epoch"], list(asked))
            for d in pf.draws_prefetched(make, 5, n, _InPlace())]
    assert [e for e, _ in seen] == list(range(5, 5 + n))
    for e, before in seen:
        assert before == list(range(5, min(e + 2, 5 + n)))
    with ThreadPoolExecutor(1) as pool:
        assert [d["epoch"] for d in pf.draws_prefetched(make, 5, n, pool)] \
            == list(range(5, 5 + n))


class _InPlace:
    """A pool that runs each submitted call at once, so the order of the
    asks is the order of the submissions."""

    def submit(self, fn, *args):
        done = Future()
        done.set_result(fn(*args))
        return done


def test_timed_run_times_each_phase_and_changes_no_number():
    """Two epochs of a ragged 2-signal fleet (24 and 16 windows of 8,
    batch 8) through ``timed_run``: one load and one means an epoch, two
    passes an epoch, the program's methods its own again after; the
    metrics and parameters bitwise an untimed run's from the same
    weights."""
    Xs, n_real = fl.pad_and_stack([
        np.random.default_rng(i).uniform(-1, 1, (n, W)).astype(np.float32)
        for i, n in enumerate((24, 16))])
    Xs = torch.from_numpy(Xs)
    runs = []
    for timed in (True, False):
        state = fl.init_fleet_state(
            [init_tadgan(torch.Generator().manual_seed(i), W,
                         hyperbolic=True, device="cpu") for i in range(2)],
            LR, True)
        program = graphed.fleet_program_for(
            state, Xs, n_real, lr=LR, hyperbolic=True, batch_size=B,
            fused_critics="full")
        draws = pf.draws_after(lambda e: tr.fleet_epoch_draws(
            [0, 1], e, n_real, B, state.params), 0, 2)
        if timed:
            metrics, wall, phases = pf.timed_run(program, state, draws,
                                                 lambda: None)
            assert wall > 0
            assert [len(phases[k]) for k in ("load_epoch", "run_pass",
                                             "epoch_means")] == [2, 4, 2]
            assert not {"_load_epoch", "_run_pass",
                        "_epoch_means"} & set(vars(program))
        else:
            metrics = program.run(state, draws)
        runs.append((state, metrics))
    (got, got_m), (want, want_m) = runs
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), k
    for g, w in zip(got_m, want_m):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
