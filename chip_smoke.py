"""Smoke run of the PyTorch/CUDA port (hypad_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each failing loudly (a failed check raises and the exit code is not
0):

1. build: compile the hand-written kernels in hypad_tpu_torch/csrc with nvcc
   (one process per source, all at once) and print the ptxas report;
2. kernels against their plain PyTorch versions on the card: the fused
   MobiusLinear forward at the detect and training shapes (max abs diff
   <= 1e-6) and the KDE argmax (tie
   level: a differing value is a sample of its own row, at most 1% of rows
   differ);
   and the critic-step kernels K5 and K4 against their plain autograd
   versions (B = 64 hyperbolic, B = 64 Euclidean, B = 13; the JAX tests'
   tolerances; two launches bitwise equal);
3. detect path: a seeded synthetic univariate signal with 3 injected
   anomalies, windowed to 20,000 windows of width 100, through
   ``detect_univariate(..., combination="mult", device="cuda")`` with a
   full-width hyperbolic model (random weights from a seed). The kernels'
   launch counters are zeroed just before and read just after; the scores
   must be finite and the intervals and F1 equal the same call on the CPU;
4. training path: a 1,420-sample synthetic signal (the length of Yahoo A1
   ``real_1``) windowed to 1,320 windows, through ``train_tadgan(...,
   hyperbolic=True, batch_size=64, lr=5e-4, n_epochs=2, device="cuda")``
   from ``init_tadgan`` seed 0 with zeroed counters: K5 must launch 200
   times, K1 80, K4 none; the losses must be finite. One epoch from the same
   weights and draws on the card and on the CPU (plain path) must give
   parameters within 5e-3 relative / 2e-4 absolute; the trained weights
   must detect the same intervals and F1 on the card and on the CPU. A
   one-epoch run with ``fused_critics=True`` must launch K4 100 times;
5. timing: warm detect throughput, warm epoch seconds for each
   ``fused_critics`` value, and each kernel's time beside its plain
   version's and its bound at the path's shapes;
6. report: one JSON line of the kernels, the card's name and power limit,
   and last the JSON line the GPU check reads.

TF32 is switched off for matmuls and cuDNN: every product runs in full f32,
as on the CPU the results are compared with.

Exits with a non-zero code, and prints no result, without CUDA or outside
the repository.
"""

import json
import statistics
import subprocess
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM
N_WINDOWS = 20_000
WIDTH = 100
SEED = 0
TRAIN_LR = 5e-4
EPOCH_TOL = dict(rtol=5e-3, atol=2e-4)   # tests/test_critic_kernel.py:227-236
K4_TOL = (dict(rtol=2e-5, atol=1e-6), dict(rtol=5e-5, atol=5e-7))   # :83-93
K5_TOL = (dict(rtol=5e-5, atol=2e-6), dict(rtol=1e-4, atol=1e-6))   # :113-122
OUT_DIR = Path("chiprun_out")


def fail(message):
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def tie_flips(got, want, vals, mask):
    """Rows where the KDE argmax picked another value; raises unless every
    such value is a sample of its own row and at most 1% of rows differ."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    v, m = vals.cpu().numpy(), mask.cpu().numpy()
    rows = [int(i) for i in (got != want).nonzero()[0]]
    foreign = [i for i in rows if got[i] not in v[i][m[i]]]
    if foreign:
        fail(f"KDE argmax rows {foreign[:10]} hold no sample of their row")
    if len(rows) > max(1, int(0.01 * len(got))):
        fail(f"KDE argmax differs on {len(rows)} of {len(got)} rows")
    return len(rows)


def phase_build():
    from hypad_tpu_torch import _build

    t0 = time.perf_counter()
    report = _build.build()
    seconds = time.perf_counter() - t0
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    for name, (_, log) in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"[build] {len(report)} kernel sources built in {seconds:.2f} s "
          f"(all nvcc processes at once)")


def phase_kernels(device):
    """K1 and K2 against their plain versions at the shapes of the detect
    and training paths and at the edge cases; returns the largest K1 diff and the K2 tie flips
    summed over the cases."""
    import torch

    from hypad_tpu_torch.data.pipeline import A1_BATCH_SIZE as TRAIN_BATCH
    from hypad_tpu_torch.manifold.kernels import (
        mobius_linear,
        mobius_linear_kernel,
    )
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.ops.kde import kde_argmax_rows, kde_argmax_rows_parts
    from hypad_tpu_torch.ops.kde_kernel import (
        kde_argmax_kernel,
        kde_argmax_rows_fused,
    )
    from hypad_tpu_torch.ops.unroll import antidiagonal_gather

    k1_err = 0.0
    # detect: the decoder head and the target embedding on every window;
    # train: the generator step's decoder head on 2B rows and target
    # embedding on B rows; then an odd shape and a huge weight (the clamps)
    for rows, dim, w_scale in ((N_WINDOWS, WIDTH, 1.0),
                               (2 * TRAIN_BATCH, WIDTH, 1.0),
                               (TRAIN_BATCH, WIDTH, 1.0), (130, 64, 1.0),
                               (8, WIDTH, 1e6)):
        gen = torch.Generator().manual_seed(rows)
        head = init_tadgan(gen, dim, hyperbolic=True,
                           device=device)["decoder"].hyperbolic_linear
        w = (head.w.detach() * w_scale).contiguous()
        b = head.b.detach()
        x = (torch.rand(rows, dim, generator=gen) * 2 - 1).to(device)
        got = mobius_linear_kernel(x, w, b)
        torch.cuda.synchronize()
        err = (got - mobius_linear(x, w, b)).abs().max().item()
        print(f"[kernels] K1 mobius_linear ({rows}, {dim}) x ({dim}, {dim})"
              f"{' w x 1e6' if w_scale != 1.0 else ''}: max abs diff {err:.3e}")
        if not err <= 1e-6:
            fail(f"K1 differs from its plain version by {err}")
        k1_err = max(k1_err, err)

    flips_total = 0
    for n, width, const in ((N_WINDOWS, WIDTH, False), (700, 64, False),
                            (300, WIDTH, True)):
        critic = torch.randn(n, generator=torch.Generator().manual_seed(n))
        if const:
            critic[10:40] = 0.5  # zero-variance rows: the median fallback
        vals, mask = antidiagonal_gather(critic.to(device)[:, None]
                                         .expand(n, width))
        kde_val, use = kde_argmax_kernel(vals, mask)
        fused = kde_argmax_rows_fused(vals, mask)
        torch.cuda.synchronize()
        want_val, want_use = kde_argmax_rows_parts(vals, mask)
        if not torch.equal(use, want_use):
            fail(f"K2 use flags differ at T={vals.shape[0]}, W={width}")
        flips = tie_flips(kde_val, want_val, vals, mask)
        tie_flips(fused, kde_argmax_rows(vals, mask), vals, mask)
        fallback = int((~use).sum().item())
        print(f"[kernels] K2 kde_argmax T={vals.shape[0]} W={width}"
              f"{' constant runs' if const else ''}: {flips} tie flips, "
              f"{fallback} rows on the median fallback")
        flips_total += flips
    return k1_err, flips_total


def check_same_detection(got, want, known):
    """Fail unless two detect_univariate results give the same intervals,
    confusion and F1 (and interval scores within 1e-3 relative)."""
    import numpy as np

    scores = got["scores"]
    score_diff = float(np.max(np.abs(scores - want["scores"])
                              / np.maximum(np.abs(want["scores"]), 1e-6)))
    print(f"[detect] scores: max relative diff to the CPU {score_diff:.3e}; "
          f"exact zeros at the same positions: "
          f"{np.array_equal(scores == 0, want['scores'] == 0)}")
    iv, want_iv = got["intervals"], want["intervals"]
    print(f"[detect] intervals (start, end, score): {iv.tolist()}")
    print(f"[detect] known anomalies: {np.asarray(known).tolist()}")
    print(f"[detect] confusion (tn, fp, fn, tp) {got['confusion']}, "
          f"metrics {got['metrics']}")
    if iv.shape != want_iv.shape or not np.array_equal(iv[:, :2],
                                                       want_iv[:, :2]):
        fail(f"intervals differ from the CPU's: {want_iv.tolist()}")
    if not np.allclose(iv[:, 2], want_iv[:, 2], rtol=1e-3):
        fail(f"interval scores differ from the CPU's: {want_iv.tolist()}")
    if tuple(got["confusion"]) != tuple(want["confusion"]):
        fail(f"confusion differs from the CPU's {want['confusion']}")
    f1, want_f1 = ((m or {}).get("f1") for m in (got["metrics"],
                                                  want["metrics"]))
    if f1 != want_f1:
        fail(f"F1 {f1} differs from the CPU's {want_f1}")
    return f1


def critic_case(device, hyperbolic, B):
    """A full-width model and one critic step's inputs from a seed."""
    import torch

    from hypad_tpu_torch.models.tadgan import init_tadgan

    g = torch.Generator().manual_seed(100 + B + hyperbolic)
    model = init_tadgan(g, WIDTH, hyperbolic=hyperbolic, device=device)
    draws = {"z_x": torch.randn(B, 20, generator=g),
             "a_x": torch.rand(B, WIDTH, generator=g),
             "z_z": torch.randn(B, 20, generator=g),
             "a_z": torch.rand(B, 20, generator=g),
             "m_cx": torch.rand(4, 3 * B, 20, generator=g) < 0.75,
             "m_cz": torch.rand(2, 3 * B, 20, generator=g) < 0.8,
             "m_dec": torch.rand(B, 128, generator=g) < 0.8}
    x = torch.rand(B, WIDTH, generator=g) * 2 - 1
    return model, x.to(device), {k: v.to(device) for k, v in draws.items()}


def critic_err(got, want, tols, what):
    """Largest abs diff of (lx, lz, grads_cx, grads_cz) against ``want``;
    fails where an element is outside |a - b| <= atol + rtol |b|."""
    worst = 0.0
    pairs = [("lx", got[0], want[0]), ("lz", got[1], want[1])] + [
        (k, got[i][k], want[i][k]) for i in (2, 3) for k in want[i]]
    for j, (name, a, b) in enumerate(pairs):
        tol = tols[0] if j < 2 else tols[1]
        diff = (a - b).abs()
        if not bool((diff <= tol["atol"] + tol["rtol"] * b.abs()).all()):
            fail(f"{what} {name} differs from autograd by "
                 f"{diff.max().item():.3e} (tolerance {tol})")
        worst = max(worst, diff.max().item())
    return worst


def bitwise_equal(a, b):
    import torch

    return all(torch.equal(x, y) for x, y in zip(a[:2], b[:2])) and all(
        torch.equal(a[i][k], b[i][k]) for i in (2, 3) for k in a[i])


def phase_critic_kernels(device):
    """K5 and K4 against their plain autograd versions; returns the
    largest abs diff of each over the cases."""
    import torch

    from hypad_tpu_torch.data.pipeline import A1_BATCH_SIZE as TRAIN_BATCH
    from hypad_tpu_torch.train import critic_kernel as ck

    errs = {"critic_step_full": 0.0, "critics_fused_grads": 0.0}
    for hyperbolic, B in ((True, TRAIN_BATCH), (False, TRAIN_BATCH),
                          (True, 13)):
        model, x, d = critic_case(device, hyperbolic, B)
        want = ck.critic_step_plain(model, x, d, hyperbolic)
        got = ck.critic_step_fused_full(model, x, d, hyperbolic)
        again = ck.critic_step_fused_full(model, x, d, hyperbolic)
        torch.cuda.synchronize()
        e5 = critic_err(got, want, K5_TOL, f"K5 (B={B}, {hyperbolic})")
        if not bitwise_equal(got, again):
            fail(f"two K5 launches differ (B={B}, hyperbolic={hyperbolic})")
        bigx, bigz = ck.critic_step_inputs(model, x, d, hyperbolic)
        args = (model["critic_x"], model["critic_z"], bigx, bigz,
                d["m_cx"], d["m_cz"])
        got = ck.critics_fused_grads(*args)
        again = ck.critics_fused_grads(*args)
        torch.cuda.synchronize()
        e4 = critic_err(got, ck.critics_fused_grads_plain(*args), K4_TOL,
                        f"K4 (B={B}, {hyperbolic})")
        if not bitwise_equal(got, again):
            fail(f"two K4 launches differ (B={B}, hyperbolic={hyperbolic})")
        print(f"[kernels] K5 critic_step_full B={B} hyperbolic={hyperbolic}:"
              f" max abs diff {e5:.3e}; K4 critics_fused_grads: {e4:.3e}; "
              f"both bitwise repeatable")
        errs["critic_step_full"] = max(errs["critic_step_full"], e5)
        errs["critics_fused_grads"] = max(errs["critics_fused_grads"], e4)
    return errs


def zero_counters():
    from hypad_tpu_torch.manifold.kernels import mobius_linear_kernel
    from hypad_tpu_torch.ops.kde_kernel import kde_argmax_kernel
    from hypad_tpu_torch.train import critic_kernel as ck

    counters = {"mobius_linear": mobius_linear_kernel,
                "kde_argmax": kde_argmax_kernel,
                "critics_fused_grads": ck.critics_fused_grads,
                "critic_step_full": ck.critic_step_fused_full}
    for fn in counters.values():
        fn.launches = 0
    return lambda: {name: fn.launches for name, fn in counters.items()}


def phase_train(device):
    """The training path on the card with zeroed counters, the card's epoch
    against the CPU's, detection with the trained weights on both, and the
    fused_critics=True run. Returns a dict of what it saw."""
    import numpy as np
    import torch

    from hypad_tpu_torch.data.pipeline import (
        A1_BATCH_SIZE as TRAIN_BATCH,
        A1_WINDOWS,
        synthetic_detect_input,
    )
    from hypad_tpu_torch.detect.detector import detect_univariate
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.train import trainer as tr

    X, index, known = synthetic_detect_input(A1_WINDOWS, WIDTH,
                                             anomaly_len=50, seed=SEED)
    if X.shape != (A1_WINDOWS, WIDTH):
        fail(f"pipeline gave training windows of shape {X.shape}")
    n_batches = X.shape[0] // TRAIN_BATCH
    kwargs = dict(lr=TRAIN_LR, hyperbolic=True, batch_size=TRAIN_BATCH)

    def init(dev):
        return init_tadgan(torch.Generator().manual_seed(SEED), WIDTH,
                           hyperbolic=True, device=dev)

    logs = []
    model = init(device)
    read = zero_counters()
    t0 = time.perf_counter()
    state = tr.train_tadgan(model, X, n_epochs=2, device=device,
                            log_cb=lambda e, m: logs.append(m), **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read()
    print(f"[train] train_tadgan, {X.shape[0]} windows, batch "
          f"{TRAIN_BATCH}, 2 epochs, fused_critics='full', on {device}: "
          f"{seconds:.3f} s (first call); kernel launches {launches}")
    for e, m in enumerate(logs, 1):
        print(f"[train] epoch {e}: {m}")
    want = {"mobius_linear": 2 * n_batches * 2,
            "kde_argmax": 0, "critics_fused_grads": 0,
            "critic_step_full": tr.N_CRITICS * n_batches * 2}
    if launches != want:
        fail(f"expected launches {want}, got {launches}")
    if not all(np.isfinite(v) for m in logs for v in m.values()):
        fail(f"a training loss is not finite: {logs}")

    # one epoch from the same weights and draws, card against CPU
    cpu_model = init("cpu")
    draws = tr.epoch_draws(tr.epoch_generator(SEED, 0), X.shape[0],
                           TRAIN_BATCH, cpu_model)
    results = {}
    for label, dev, m in (("card", device, init(device)),
                          ("cpu", "cpu", cpu_model)):
        st_ = tr.init_train_state(m, TRAIN_LR, True)
        t0 = time.perf_counter()
        _, metrics = tr.run_epoch(st_, torch.as_tensor(X, device=dev), draws,
                                  **{k: v for k, v in kwargs.items()
                                     if k != "batch_size"})
        results[label] = (
            {k: v.detach().cpu() for k, v in m.state_dict().items()},
            metrics, time.perf_counter() - t0)
    (card, card_m, card_s), (host, host_m, host_s) = (results["card"],
                                                      results["cpu"])
    worst_abs, worst_rel, worst_key = 0.0, 0.0, ""
    for key, want_p in host.items():
        diff = (card[key] - want_p).abs()
        if not bool((diff <= EPOCH_TOL["atol"]
                     + EPOCH_TOL["rtol"] * want_p.abs()).all()):
            fail(f"epoch parameters {key} differ from the CPU's by "
                 f"{diff.max().item():.3e} (tolerance {EPOCH_TOL})")
        if diff.max().item() > worst_abs:
            worst_abs, worst_key = diff.max().item(), key
        worst_rel = max(worst_rel, (diff / want_p.abs().clamp_min(1e-3))
                        .max().item())
    print(f"[train] one epoch, same weights and draws, card ({card_s:.3f} s)"
          f" against CPU plain path ({host_s:.3f} s): largest parameter "
          f"diff {worst_abs:.3e} ({worst_key}), largest relative (|p| >= "
          f"1e-3 floor) {worst_rel:.3e}; losses card {card_m}, CPU {host_m}")

    # the trained weights detect the same on the card and on the CPU
    trained = state.model
    cpu_trained = init("cpu")
    cpu_trained.load_state_dict({k: v.cpu() for k, v in
                                 trained.state_dict().items()})
    got = detect_univariate(trained, X, index, known, combination="mult",
                            device=device)
    want_det = detect_univariate(cpu_trained, X, index, known,
                                 combination="mult", device="cpu")
    f1 = check_same_detection(got, want_det, known)

    # the fused_critics=True path: generator forwards in torch, then K4
    read = zero_counters()
    tr.train_tadgan(init(device), X, n_epochs=1, device=device,
                    fused_critics=True, **kwargs)
    torch.cuda.synchronize()
    launches_true = read()
    print(f"[train] one epoch with fused_critics=True: kernel launches "
          f"{launches_true}")
    want = {"mobius_linear": (tr.N_CRITICS + 2) * n_batches,
            "kde_argmax": 0, "critics_fused_grads": tr.N_CRITICS * n_batches,
            "critic_step_full": 0}
    if launches_true != want:
        fail(f"expected launches {want}, got {launches_true}")
    return {"launches": launches, "launches_fused_true": launches_true,
            "logs": logs, "epoch_max_abs_diff": worst_abs,
            "epoch_max_rel_diff": worst_rel, "trained_f1": f1, "X": X,
            "first_call_s": seconds}


def critic_cost(B, critic, in_width):
    """(bytes, f32 operations) of one critic's loss and gradients on 3B
    stacked rows: the parameters and keep-masks read, the gradients
    written; the forward, the GP input-gradient chain, the first-order
    backward and the second-order (u-chain) gradients, 2 per FMA."""
    R = 3 * B
    dims = [(layer.w.shape[1], layer.w.shape[0])
            for layer in (getattr(critic, f"dense{i}")
                          for i in range(1, 10) if hasattr(critic,
                                                           f"dense{i}"))]
    hidden, (H, _) = dims[:-1], dims[-1]
    params = sum(d_in * d_out + d_out for d_in, d_out in dims)
    macs = R * sum(i * o for i, o in hidden) + R * H      # forward
    macs += B * sum(i * o for i, o in hidden)              # GP input grad
    macs += R * H * H * (len(hidden) - 1) + R * H          # wl backward
    macs += R * sum(i * o for i, o in hidden) + R * H      # wl weight grads
    macs += 2 * B * sum(i * o for i, o in hidden) + B * H  # GP grads
    elementwise = 8 * R * H * len(hidden)
    bytes_ = 4 * R * in_width + R * H * len(hidden) + 2 * 4 * params + 4
    return bytes_, 2 * macs + elementwise


def generator_cost(model, B):
    """(bytes, operations) of K5's generator forwards on B rows: the
    weights read once (not the unused w_hh), the three used LSTM gates."""
    enc, dec = model["encoder"], model["decoder"]
    W = dec.dense2.w.shape[0]
    weights = 0
    macs = 0
    for lstm in (enc.lstm[0], dec.lstm[0], dec.lstm[1]):
        for sfx in ("", "_rev"):
            w = lstm["w_ih" + sfx]
            weights += w.numel() + 2 * w.shape[0]
            macs += B * 3 * (w.shape[0] // 4) * w.shape[1]
    for layer in (enc.dense, dec.dense1, dec.dense2, dec.hyperbolic_linear):
        weights += layer.w.numel() + layer.b.numel()
        macs += B * layer.w.numel()
    inputs = 4 * (2 * B * W + 3 * B * 20) + B * 128
    elementwise = B * (12 * 2 * (50 + 64 + 64) + 30 * W)
    return 4 * weights + inputs, 2 * macs + elementwise


def phase_train_timing(device, X):
    """Warm epoch seconds for each fused_critics value, and K4 and K5
    beside their plain versions and bounds at the training shapes."""
    import statistics as stats

    import torch

    from hypad_tpu_torch.data.pipeline import A1_BATCH_SIZE as TRAIN_BATCH
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.profile_detect import cuda_ms
    from hypad_tpu_torch.train import critic_kernel as ck
    from hypad_tpu_torch.train import trainer as tr

    Xt = torch.as_tensor(X, device=device)
    epochs = {}
    for mode in ("full", True, False):
        model = init_tadgan(torch.Generator().manual_seed(SEED), WIDTH,
                            hyperbolic=True, device=device)
        state = tr.init_train_state(model, TRAIN_LR, True)
        walls = []
        for e in range(4):  # one warm-up epoch, then three timed
            t0 = time.perf_counter()
            draws = tr.epoch_draws(tr.epoch_generator(SEED, e), X.shape[0],
                                   TRAIN_BATCH, model)
            state, _ = tr.run_epoch(state, Xt, draws, lr=TRAIN_LR,
                                    hyperbolic=True, fused_critics=mode)
            walls.append(time.perf_counter() - t0)  # run_epoch synchronises
        epochs[str(mode)] = {"median_s": stats.median(walls[1:]),
                             "runs_s": walls[1:]}
        print(f"[timing] warm epoch, fused_critics={mode!r}: median "
              f"{stats.median(walls[1:]):.4f} s (runs {walls[1:]})")

    model, x, d = critic_case(device, True, TRAIN_BATCH)
    bigx, bigz = ck.critic_step_inputs(model, x, d, True)
    args = (model["critic_x"], model["critic_z"], bigx, bigz, d["m_cx"],
            d["m_cz"])
    k5 = {"ms": cuda_ms(lambda: ck.critic_step_fused_full(model, x, d, True),
                        100),
          "plain_ms": cuda_ms(lambda: ck.critic_step_plain(model, x, d, True),
                              20)}
    k4 = {"ms": cuda_ms(lambda: ck.critics_fused_grads(*args), 100),
          "plain_ms": cuda_ms(lambda: ck.critics_fused_grads_plain(*args),
                              20)}
    bx, ox = critic_cost(TRAIN_BATCH, model["critic_x"], WIDTH)
    bz, oz = critic_cost(TRAIN_BATCH, model["critic_z"], 20)
    bg, og = generator_cost(model, TRAIN_BATCH)
    k4["bytes"], k4["ops"] = bx + bz, ox + oz
    # K5 reads x, a_x, z_x, z_z, a_z instead of bigx and bigz
    k5["bytes"] = bx + bz + bg - 4 * 3 * TRAIN_BATCH * (WIDTH + 20)
    k5["ops"] = ox + oz + og
    for name, k in (("K5 critic_step_full", k5), ("K4 critics_fused_grads",
                                                  k4)):
        t_bytes = k["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = k["ops"] / H100_F32_FLOP_PER_S * 1e3
        k["bound_ms"] = max(t_bytes, t_ops)
        k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[timing] {name} at B={TRAIN_BATCH}: kernel {k['ms']:.5f} ms,"
              f" plain {k['plain_ms']:.5f} ms, bound {k['bound_ms']:.6f} ms "
              f"({k['bound_by']}: {k['bytes']} bytes, {k['ops']} ops; far "
              f"below launch latency)")
    return epochs, k4, k5


def phase_main_path(device):
    """The detector on the card once with zeroed launch counters, then the
    same call on the CPU; returns (launches, windows, model)."""
    import numpy as np
    import torch

    from hypad_tpu_torch.data.pipeline import synthetic_detect_input
    from hypad_tpu_torch.detect.detector import detect_univariate
    from hypad_tpu_torch.models.tadgan import init_tadgan

    X, index, known = synthetic_detect_input(N_WINDOWS, WIDTH, seed=SEED)
    if X.shape != (N_WINDOWS, WIDTH):
        fail(f"pipeline gave windows of shape {X.shape}")
    model = init_tadgan(torch.Generator().manual_seed(SEED), WIDTH,
                        hyperbolic=True, device=device)

    read = zero_counters()
    t0 = time.perf_counter()
    got = detect_univariate(model, X, index, known, combination="mult",
                            device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read()
    print(f"[main] detect_univariate, {N_WINDOWS} windows of {WIDTH}, "
          f"combination mult, on {device}: {seconds:.3f} s (first call); "
          f"kernel launches {launches}")
    if launches != {"mobius_linear": 2, "kde_argmax": 1,
                    "critics_fused_grads": 0, "critic_step_full": 0}:
        fail(f"expected 2 MobiusLinear and 1 KDE launch, got {launches}")
    scores = got["scores"]
    if scores.shape != (N_WINDOWS,) or not np.all(np.isfinite(scores)):
        fail(f"scores of shape {scores.shape}, finite: "
             f"{np.isfinite(scores).all()}")

    cpu_model = init_tadgan(torch.Generator().manual_seed(SEED), WIDTH,
                            hyperbolic=True, device="cpu")
    t0 = time.perf_counter()
    want = detect_univariate(cpu_model, X, index, known, combination="mult",
                             device="cpu")
    print(f"[main] the same call on the CPU: "
          f"{time.perf_counter() - t0:.3f} s")
    check_same_detection(got, want, known)
    return launches, X, model


def phase_timing(device, X, model):
    """Warm detect throughput, and each kernel beside its plain version at
    the path's shapes. Returns per-kernel timing dicts."""
    import numpy as np
    import torch

    from hypad_tpu_torch.detect.scorer import _critic_antidiag, detect_scores
    from hypad_tpu_torch.manifold.kernels import (
        mobius_linear,
        mobius_linear_kernel,
    )
    from hypad_tpu_torch.ops.kde import kde_argmax_rows_parts
    from hypad_tpu_torch.ops.kde_kernel import kde_argmax_kernel
    from hypad_tpu_torch.profile_detect import cuda_ms

    detect_scores(model, X, True, "mult", fetch_inference=False,
                  device=device)
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        detect_scores(model, X, True, "mult", fetch_inference=False,
                      device=device)  # returns host scores: synchronised
        walls.append(time.perf_counter() - t0)
    wps = N_WINDOWS / statistics.median(walls)
    print(f"[timing] warm detect_scores at {N_WINDOWS} windows: median "
          f"{statistics.median(walls) * 1e3:.3f} ms, {wps:.0f} windows/s "
          f"(runs in ms: {[round(w * 1e3, 3) for w in walls]})")

    head = model["decoder"].hyperbolic_linear
    w, b = head.w.detach(), head.b.detach()
    with torch.inference_mode():
        Xt = torch.as_tensor(X, device=device)
        critic = model["critic_x"](Xt)[:, 0]
        vals, mask = _critic_antidiag(critic, N_WINDOWS, WIDTH)
        k1 = {"ms": cuda_ms(lambda: mobius_linear_kernel(Xt, w, b), 200),
              "plain_ms": cuda_ms(lambda: mobius_linear(Xt, w, b), 50)}
        k1["max_abs_err"] = (mobius_linear_kernel(Xt, w, b)
                             - mobius_linear(Xt, w, b)).abs().max().item()
        k2 = {"ms": cuda_ms(lambda: kde_argmax_kernel(vals, mask), 50),
              "plain_ms": cuda_ms(lambda: kde_argmax_rows_parts(vals, mask),
                                  5)}
        got, _ = kde_argmax_kernel(vals, mask)
        want, _ = kde_argmax_rows_parts(vals, mask)
        k2["tie_flips"] = tie_flips(got, want, vals, mask)
        k2["max_abs_err"] = (got - want).abs().max().item()

    rows, din = Xt.shape
    dout = w.shape[0]
    # x, W, b read once, out written once; the product plus the ~16 f32
    # operations of the clamp chain per output lane
    k1["bytes"] = 4 * (rows * din + dout * din + dout + rows * dout)
    k1["ops"] = 2 * rows * din * dout + 16 * rows * dout
    # vals (f32) and mask (bool) read once, kde_val (f32) and use (bool)
    # written once; per pair of samples of a row: difference, square, scale,
    # exp, sum; plus ~8 operations per sample for mean and variance
    cnt = mask.sum(dim=1).double()
    k2["bytes"] = 5 * vals.numel() + 5 * vals.shape[0]
    k2["ops"] = int(5 * (cnt * cnt).sum().item() + 8 * cnt.sum().item())
    k2["exps"] = int((cnt * cnt).sum().item())
    for k in (k1, k2):
        t_bytes = k["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = k["ops"] / H100_F32_FLOP_PER_S * 1e3
        k["bound_ms"] = max(t_bytes, t_ops)
        k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    for name, k in (("K1 mobius_linear", k1), ("K2 kde_argmax", k2)):
        print(f"[timing] {name}: kernel {k['ms']:.5f} ms, plain "
              f"{k['plain_ms']:.5f} ms, bound {k['bound_ms']:.5f} ms "
              f"({k['bound_by']}: {k['bytes']} bytes, {k['ops']} ops)")
    if not np.isfinite([k1["ms"], k2["ms"]]).all():
        fail("a kernel time is not finite")
    return wps, k1, k2


def gpu_name_and_power_limit():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs on a GPU")
    if not (Path(__file__).resolve().parent / "hypad_tpu_torch").is_dir():
        fail("hypad_tpu_torch is not beside this script: run it from the "
             "repository root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 is off for matmuls and cuDNN: every product runs in f32")
    device = torch.device("cuda", 0)
    card = gpu_name_and_power_limit()
    print(f"card: {torch.cuda.get_device_name(0)} ({card}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    phase_build()
    k1_err, k2_flips = phase_kernels(device)
    k45_err = phase_critic_kernels(device)
    launches, X, model = phase_main_path(device)
    train = phase_train(device)
    wps, k1, k2 = phase_timing(device, X, model)
    epochs, k4, k5 = phase_train_timing(device, train["X"])
    by_path = {name: {"detect": launches[name],
                      "train": train["launches"][name],
                      "train_fused_critics_true":
                          train["launches_fused_true"][name]}
               for name in launches}
    tol_text = "loss rtol {0[rtol]} atol {0[atol]}, grads rtol {1[rtol]} " \
               "atol {1[atol]} against autograd; two launches bitwise equal"

    kernels = [
        {"name": "mobius_linear", "route": "cuda",
         "source": "hypad_tpu_torch/csrc/mobius_linear.cu",
         "replaces": "hypad_tpu/manifold/kernels.py:35",
         "launches": launches["mobius_linear"],
         "launches_per_call": launches["mobius_linear"],
         "launches_by_path": by_path["mobius_linear"],
         "max_abs_err": max(k1_err, k1["max_abs_err"]),
         "tolerance": "max abs diff <= 1e-6",
         "ms": k1["ms"], "kernel_ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None},
        {"name": "kde_argmax", "route": "cuda",
         "source": "hypad_tpu_torch/csrc/kde_argmax.cu",
         "replaces": "hypad_tpu/ops/kde_pallas.py:42",
         "launches": launches["kde_argmax"],
         "launches_per_call": launches["kde_argmax"],
         "launches_by_path": by_path["kde_argmax"],
         "max_abs_err": k2["max_abs_err"],
         "tolerance": "tie level: a differing value is a sample of its own "
                      "row, at most 1% of rows differ",
         "tie_flips": k2["tie_flips"], "edge_case_tie_flips": k2_flips,
         "exps": k2["exps"],
         "ms": k2["ms"], "kernel_ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "critics_fused_grads", "route": "cuda",
         "source": "hypad_tpu_torch/csrc/critic_step.cu",
         "replaces": "hypad_tpu/train/critic_kernel.py:156",
         "launches": train["launches_fused_true"]["critics_fused_grads"],
         "launches_path": "train, fused_critics=True, 1 epoch",
         "launches_by_path": by_path["critics_fused_grads"],
         "max_abs_err": k45_err["critics_fused_grads"],
         "tolerance": tol_text.format(*K4_TOL),
         "ms": k4["ms"], "kernel_ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": None},
        {"name": "critic_step_full", "route": "cuda",
         "source": "hypad_tpu_torch/csrc/critic_step.cu",
         "replaces": "hypad_tpu/train/critic_kernel.py:350",
         "launches": train["launches"]["critic_step_full"],
         "launches_path": "train, fused_critics='full', 2 epochs",
         "launches_by_path": by_path["critic_step_full"],
         "max_abs_err": k45_err["critic_step_full"],
         "tolerance": tol_text.format(*K5_TOL),
         "ms": k5["ms"], "kernel_ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None},
    ]
    OUT_DIR.mkdir(exist_ok=True)
    summary = {"card": card, "detect_20k_wps": wps,
               "train_epoch_s": epochs,
               "train_losses": train["logs"],
               "train_first_call_s": train["first_call_s"],
               "epoch_card_vs_cpu_max_abs_diff": train["epoch_max_abs_diff"],
               "epoch_card_vs_cpu_max_rel_diff": train["epoch_max_rel_diff"],
               "trained_detect_f1": train["trained_f1"],
               "kernels": kernels,
               "seconds": time.perf_counter() - t_start}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    print(f"[done] all phases passed in {summary['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
