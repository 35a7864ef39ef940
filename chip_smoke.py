"""Smoke run of the PyTorch/CUDA port (hypad_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each failing loudly (a failed check raises and the exit code is not
0):

1. build: compile the hand-written kernels in hypad_tpu_torch/csrc with nvcc
   (one process per source, all at once) and print the ptxas report; an
   empty kernel (the launch-to-end yardstick) and, where a parent commit's
   sources are unpacked under _checkout/parent (gitignored), the parent's
   K1, K2 and K3 build in the same round;
2. kernels against their plain PyTorch versions on the card: the fused
   MobiusLinear forward (K1) at the detect and training shapes (max abs
   diff <= 1e-6; the diff to the parent's K1 printed where it was built);
   K2 and K3, each of whose one launch also takes the masked-median
   fallback, on eight cases (the detect shape, W = 64, constant runs of 30
   and 240, NaNs in the critic, row widths 1, 4 and 5): use flags bitwise,
   fallback rows bitwise ``masked_median``, NaN where it is NaN, values
   elsewhere at tie level (a differing value is a sample of its own row,
   at most 1% of rows differ), the flips printed; K3 against K2 at tie
   level; K2 bitwise the parent's K2 and K3 at tie level against the
   parent's K3 (its kernel, then the fallback outside it) where built;
   ``kde_argmax_rows_fused`` launches K2 ("v1") or K3 ("v2") alone, no
   sort, as the profiler shows; the checks are ``profile_kernels``' own;
   and the critic-step kernels K5 and K4, each launched as 2 clusters of 8
   blocks, against their plain autograd versions (B = 64 hyperbolic, B = 64
   Euclidean, B = 13, B = 3 with fewer rows than a cluster's blocks, B =
   100 with rows split unevenly; the JAX tests' tolerances; two launches
   bitwise equal);
3. detect path: a seeded synthetic univariate signal with 3 injected
   anomalies, windowed to 20,000 windows of width 100, through
   ``detect_univariate(..., combination="mult", device="cuda")`` with a
   full-width hyperbolic model (random weights from a seed). The kernels'
   launch counters are zeroed just before and read just after (K1 2, K2
   1); the scores must be finite and the intervals and F1 equal the same
   call on the CPU;
4. Euclidean detect path (the TadGAN of configs/nab_euclidean.yaml): the
   same windows through ``detect_univariate(..., hyperbolic=False,
   rec_error=r, combination="mult", kde_version="v2")`` with a full-width
   Euclidean model, for r in point, area and dtw, counters zeroed before
   each call (K3 1, K1 and K2 0); the scores must be finite, N + W - 1
   long, and the intervals, confusion and F1 equal the CPU's;
5. training path: a 1,420-sample synthetic signal (the length of Yahoo A1
   ``real_1``) windowed to 1,320 windows, through ``train_tadgan(...,
   hyperbolic=True, batch_size=64, lr=5e-4, n_epochs=2, device="cuda")``
   from ``init_tadgan`` seed 0 with zeroed counters: K5 must launch 200
   times, K1 80, K4 none; the losses must be finite. One epoch from the same
   weights and draws on the card and on the CPU (plain path) must give
   parameters within 5e-3 relative / 2e-4 absolute; the trained weights
   must detect the same intervals and F1 on the card and on the CPU. A
   one-epoch run with ``fused_critics=True`` must launch K4 100 times;
6. Euclidean training path: the same 2 epochs with ``hyperbolic=False``
   (K5 200, K1 0), then detection with the trained weights (point, mult,
   K3) on the card and on the CPU: the same intervals and F1;
7. command line ([cli]): ``hypad_tpu_torch.cli.main`` at the published
   widths on a Yahoo A1 CSV and a NAB-style CSV (1,420 samples each, 1,320
   windows) written to a temporary directory, counters zeroed around each
   command: hyperbolic ``train`` as configs/yahoo_a1_hyper.yaml with 2
   epochs and fused_critics "full" (K5 200, K1 82, K2 1; state_1.pt,
   state_final.pt, train_log.jsonl, anomalies.csv, inference.npz and the
   results CSV written; detection reads the training windows already on
   the card), its ``detect --device cpu`` (the card's intervals,
   confusion and F1) and ``detect`` on the card (K1 2, K2 1), and under
   ``load: true`` from its inference.npz staged on the card (K2 1, K1 0;
   the same intervals); ``resume:
   true`` from state_1.pt within 5e-3 relative / 2e-4 absolute of the
   straight run; Euclidean ``train`` on the NAB-style CSV (rec_error dtw,
   1 epoch, HYPAD_KDE_PALLAS=1: K5 100, K3 1, K1 0); ``detect
   --rec-errors point,area,dtw --combinations all`` (12 cells, K3 1, K1 0,
   each cell's confusion equal to a single-cell ``detect``) and the
   hyperbolic ``--combinations all`` grid (8 cells, K1 2, K2 1); ``train``
   under fused_critics false (no critic kernel; K1 142, since the critic
   steps' generator forwards run it too) and true (K4 100); the CLI's
   wall-clock lines and stage table beside the card's name and power
   limit (each command's stdout in OUT_DIR, cli_*.log);
8. staged path: at 20,000 windows, ``run_inference`` (chunks of 1,024)
   must give the one call's forward outputs within 1e-5 relative / 1e-6
   absolute; ``score_anomalies_euclidean`` (Euclidean model) and
   ``score_anomalies_hyperbolic`` (hyperbolic model) on the one call's
   forward must give ``detect_scores``' scores within the scores'
   tolerance; on ``run_inference``'s output, the same zero and NaN
   positions and intervals (chunks sum the forward in another order, and a
   last-bit change of a critic value can flip a KDE tie);
9. timing: warm detect throughput (hyperbolic under K2 and K3, Euclidean
   for each rec_error), warm epoch seconds for each ``fused_critics``
   value, and each kernel's time beside its plain version's and its bound
   at the path's shapes (K1 at the detect shape and at the generator
   step's two, beside an empty kernel; cuBLAS's f32 x @ w.T as an
   informative line, not K1's function);
10. report: one JSON line of the kernels, the card's name and power limit,
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
# exps on the special-function units: 16 per clock per SM, 132 SMs, at the
# 1.98 GHz boost clock (H100 SXM); an estimate beside the table's bound
H100_SFU_EXP_PER_S = 132 * 16 * 1.98e9
SCORE_TOL = dict(rtol=1e-4, atol=1e-6)   # tests/test_torch_detect.py
FORWARD_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_torch_eucl.py
REC_ERRORS = ("point", "area", "dtw")
N_WINDOWS = 20_000
WIDTH = 100
SEED = 0
TRAIN_LR = 5e-4
EPOCH_TOL = dict(rtol=5e-3, atol=2e-4)   # tests/test_critic_kernel.py:227-236
K4_TOL = (dict(rtol=2e-5, atol=1e-6), dict(rtol=5e-5, atol=5e-7))   # :83-93
K5_TOL = (dict(rtol=5e-5, atol=2e-6), dict(rtol=1e-4, atol=1e-6))   # :113-122
OUT_DIR = Path("chiprun_out")
# a parent commit's kernels, unpacked with ``git archive`` (gitignored); K1
# is held against its parent's where they are present
PARENT_CSRC = Path("_checkout/parent/hypad_tpu_torch/csrc")


def fail(message):
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def phase_build():
    """Build the kernels, an empty kernel (the launch-to-end yardstick) and,
    where a parent commit is unpacked at PARENT_CSRC, the parent's K1, K2
    and K3 (from where they lie, with the parent's headers), all nvcc
    processes at once. Returns {name: library} of the extra builds."""
    import ctypes

    from hypad_tpu_torch import _build
    from hypad_tpu_torch.profile_critic_step import variant_jobs
    from hypad_tpu_torch.profile_kernels import EMPTY_SOURCE, baseline_jobs

    parent = PARENT_CSRC.is_dir()
    extra_jobs = {**variant_jobs({"empty": EMPTY_SOURCE}),
                  **(baseline_jobs(PARENT_CSRC, "parent") if parent else {})}
    t0 = time.perf_counter()
    report = _build.build(extra_jobs=extra_jobs)
    seconds = time.perf_counter() - t0
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    for name, (_, log) in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"[build] {len(report)} sources built in {seconds:.2f} s (all nvcc "
          f"processes at once); parent K1, K2 and K3 "
          f"{'from ' + str(PARENT_CSRC) if parent else 'not present'}")
    return {name: ctypes.CDLL(str(lib)) for name, (_, lib) in
            extra_jobs.items()}


def kde_case(device, n, width, runs, nans=False):
    """(vals, mask, label) of ``profile_kernels.k2_case``: a seeded
    critic's anti-diagonal rows, critic[10:runs] set to 0.5 (zero-variance
    rows, the median fallback, where a run is longer than the window), and
    with ``nans`` NaNs in the critic (fallback rows whose middle ranks fall
    on the masked entries' fill or on the NaNs)."""
    from hypad_tpu_torch.profile_kernels import k2_case

    vals, mask = k2_case(n, width, runs, device, nans)
    label = (f"T={vals.shape[0]} W={width}"
             f"{f' constant run of {runs - 10}' if runs else ''}"
             f"{' NaNs' if nans else ''}")
    return vals, mask, label


def kernels_launched(fn):
    """Names of the device kernels that ``fn()`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def phase_kernels(device, libs):
    """K1, K2 and K3 against their plain versions at the shapes of the
    detect and training paths and at the edge cases, and against the
    parent's where they were built; returns the largest K1 diffs (plain,
    parent) and the K2 and K3 tie flips summed over the cases."""
    import torch

    from hypad_tpu_torch.data.pipeline import A1_BATCH_SIZE as TRAIN_BATCH
    from hypad_tpu_torch.manifold import kernels as mk
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.ops import kde_kernel as kk
    from hypad_tpu_torch.ops.kde_kernel import (
        kde_argmax_kernel,
        kde_argmax_rows_fused,
        kde_argmax_v2_kernel,
    )
    from hypad_tpu_torch.profile_kernels import (
        bind_k3,
        check_k1,
        check_k2,
        check_k3,
        kernel_then_median,
        same_values,
        tie_flips,
    )

    parent = libs.get("mobius_linear_parent")
    parent_fn = mk.bind(parent) if parent is not None else None
    parent_k2 = parent_k3 = None
    if "kde_argmax_parent" in libs:
        parent_k2 = kk.bind(libs["kde_argmax_parent"], "kde_argmax_forward")
        k3_fn, outside = bind_k3(libs, "parent")
        parent_k3 = ((lambda v, m: kernel_then_median(k3_fn, v, m))
                     if outside else
                     (lambda v, m: kk.launch_with(k3_fn, v, m)))
    k1_err, k1_parent = 0.0, None
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
        got = mk.mobius_linear_kernel(x, w, b)
        parent_got = (None if parent_fn is None
                      else mk.launch_with(parent_fn, x, w, b))
        torch.cuda.synchronize()
        case = (f"({rows}, {dim}) x ({dim}, {dim})"
                f"{' w x 1e6' if w_scale != 1.0 else ''}")
        err, d = check_k1(got, x, w, b, parent_got, case)
        vs_parent = ""
        if d is not None:
            k1_parent = max(k1_parent or 0.0, d)
            vs_parent = f"; {d:.3e} from the parent's kernel"
        print(f"[kernels] K1 mobius_linear {case}: max abs diff {err:.3e}"
              f"{vs_parent}")
        k1_err = max(k1_err, err)

    # K2 and K3 each emit the final value (the median on fallback rows) in
    # one launch
    flips_total = {"kde_argmax": 0, "kde_argmax_v2": 0}
    for n, width, runs, nans in (
            (N_WINDOWS, WIDTH, 0, False), (700, 64, 0, False),
            (300, WIDTH, 40, False), (300, WIDTH, 250, False),
            (300, WIDTH, 0, True), (300, 1, 0, False), (300, 4, 0, False),
            (300, 5, 0, False)):
        vals, mask, case = kde_case(device, n, width, runs, nans)
        outs = {}
        for name, kernel, version in (("kde_argmax", kde_argmax_kernel, "v1"),
                                      ("kde_argmax_v2", kde_argmax_v2_kernel,
                                       "v2")):
            before = kernel.launches
            value, use = kernel(vals, mask)
            fused = kde_argmax_rows_fused(vals, mask, version)
            torch.cuda.synchronize()
            if kernel.launches != before + 2:
                fail(f"{name} launched {kernel.launches - before} times for "
                     f"two calls at {case}")
            if not same_values(fused, value):
                fail(f"kde_argmax_rows_fused {version!r} differs from "
                     f"{name} at {case}")
            outs[name] = (value, use)
        (value, use), (value3, use3) = (outs["kde_argmax"],
                                        outs["kde_argmax_v2"])
        rec = check_k2(value, use, vals, mask, case=case)
        same = ""
        if parent_k2 is not None:
            old = kk.launch_with(parent_k2, vals, mask)
            if not (same_values(old[0], value) and torch.equal(old[1], use)):
                fail(f"kde_argmax differs from the parent's K2 at {case}")
            same = "; bitwise the parent's K2"
        print(f"[kernels] kde_argmax {case}: use flags bitwise; "
              f"{rec['fallback_rows']} rows on the median fallback, bitwise "
              f"masked_median; {rec['flips_vs_plain']} tie flips against its "
              f"plain version{same}")
        flips_total["kde_argmax"] += rec["flips_vs_plain"]
        old3 = parent_k3(vals, mask) if parent_k3 is not None else None
        rec3 = check_k3(value3, use3, vals, mask, old3, case)
        vs_parent = ("" if old3 is None else
                     f", {rec3['flips_vs_baseline']} against the parent's K3")
        print(f"[kernels] kde_argmax_v2 {case}: use flags bitwise; "
              f"{rec3['fallback_rows']} rows on the median fallback, bitwise "
              f"masked_median; {rec3['flips_vs_plain']} tie flips against "
              f"its plain version{vs_parent}")
        flips_total["kde_argmax_v2"] += rec3["flips_vs_plain"]
        if not torch.equal(use, use3):
            fail(f"K2 and K3 use flags differ at {case}")
        cross = tie_flips(value3[use], value[use], vals[use], mask[use])
        print(f"[kernels] K3 against K2 {case}: {cross} tie flips (the "
              f"fallback rows are bitwise masked_median in both)")

    vals, mask, case = kde_case(device, N_WINDOWS, WIDTH, 0)
    for version, kernel in (("v1", "kde_argmax_kernel"),
                            ("v2", "kde_argmax_v2_kernel")):
        names = kernels_launched(
            lambda: kde_argmax_rows_fused(vals, mask, version))
        print(f"[kernels] kde_argmax_rows_fused {version!r} at {case} "
              f"launches {names}")
        if len(names) != 1 or kernel not in names[0]:
            fail(f"kde_argmax_rows_fused {version!r} launched {names}, not "
                 f"{kernel} alone")
    return k1_err, k1_parent, flips_total


def interval_score_atol(scores, rel):
    """The most that a relative change of at most ``rel`` in every score
    can move an interval score, to first order. An interval score is
    (max - threshold) / (mean + std) of its threshold window, with the
    threshold mean + 4 std: the run's max moves by at most rel max|s|, the
    mean by rel mean|s| and the std by rel rms(s), so the numerator by
    rel (max|s| + mean|s| + 4 rms) and the denominator by rel (mean|s| +
    rms). Taken over the detector's threshold windows; a merged interval
    averages window scores, so it stays within the largest, as long as no
    window gains or prunes a run."""
    import numpy as np

    from hypad_tpu_torch.detect import intervals as iv
    from hypad_tpu_torch.detect.detector import _UNIVARIATE_FA_KW as kw

    s = np.asarray(scores, np.float64).reshape(-1)
    size, step = iv._window_geometry(len(s), None, kw["window_size_portion"],
                                     None, kw["window_step_size_portion"])
    worst, start, end = 0.0, 0, 0
    while end < len(s):
        end = start + size
        w = s[start:end]
        mean_abs, rms, max_abs = (np.abs(w).mean(), np.sqrt(np.mean(w * w)),
                                  np.abs(w).max())
        den = abs(w.mean() + w.std())
        num = max_abs + mean_abs + 4 * rms   # also bounds |max - threshold|
        worst = max(worst, rel * (num + num / den * (mean_abs + rms)) / den)
        start += step
    return float(worst)


def check_same_detection(got, want, known, tag="detect",
                         atol_from_scores=False):
    """Fail unless two detect_univariate results give the same intervals,
    confusion and F1, and interval scores within 1e-3 relative. Under
    ``atol_from_scores`` they may also differ by what the measured relative
    score difference can make of them (:func:`interval_score_atol`)."""
    import numpy as np

    scores = got["scores"]
    score_diff = float(np.max(np.abs(scores - want["scores"])
                              / np.maximum(np.abs(want["scores"]), 1e-6)))
    print(f"[{tag}] scores: max relative diff to the CPU {score_diff:.3e}; "
          f"exact zeros at the same positions: "
          f"{np.array_equal(scores == 0, want['scores'] == 0)}")
    score_atol = 0.0
    if atol_from_scores:
        score_atol = interval_score_atol(want["scores"], score_diff)
        print(f"[{tag}] interval-score limit from that difference: "
              f"{score_atol:.3e} absolute")
    # no interval comes back as an empty (0,) array
    iv, want_iv = (np.asarray(r["intervals"]).reshape(-1, 3)
                   for r in (got, want))
    print(f"[{tag}] intervals (start, end, score): {iv.tolist()}")
    print(f"[{tag}] known anomalies: {np.asarray(known).tolist()}")
    print(f"[{tag}] confusion (tn, fp, fn, tp) {got['confusion']}, "
          f"metrics {got['metrics']}")
    if iv.shape != want_iv.shape or not np.array_equal(iv[:, :2],
                                                       want_iv[:, :2]):
        fail(f"intervals differ from the CPU's: {want_iv.tolist()}")
    print(f"[{tag}] interval scores: max abs diff to the CPU "
          f"{float(np.max(np.abs(iv[:, 2] - want_iv[:, 2]), initial=0)):.3e}")
    if not np.allclose(iv[:, 2], want_iv[:, 2], rtol=1e-3, atol=score_atol):
        fail(f"interval scores differ from the CPU's: {want_iv.tolist()}")
    if tuple(got["confusion"]) != tuple(want["confusion"]):
        fail(f"confusion differs from the CPU's {want['confusion']}")
    f1, want_f1 = ((m or {}).get("f1") for m in (got["metrics"],
                                                  want["metrics"]))
    if f1 != want_f1:
        fail(f"F1 {f1} differs from the CPU's {want_f1}")
    return f1


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


def critic_launch_shape():
    """K4's and K5's launch shape as the built library reports it."""
    from hypad_tpu_torch.train import critic_kernel as ck

    clusters, blocks, threads = ck.launch_shape()
    return (f"{clusters} clusters x {blocks} blocks x {threads} threads")


def phase_critic_kernels(device):
    """K5 and K4 against their plain autograd versions; returns the
    largest abs diff of each over the cases."""
    import torch

    from hypad_tpu_torch.data.pipeline import A1_BATCH_SIZE as TRAIN_BATCH
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.train import critic_kernel as ck

    print(f"[kernels] K5 and K4 launch as {critic_launch_shape()}")
    errs = {"critic_step_full": 0.0, "critics_fused_grads": 0.0}
    for hyperbolic, B in ((True, TRAIN_BATCH), (False, TRAIN_BATCH),
                          (True, 13), (True, 3), (True, 100)):
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
    """Set every kernel's launch count to 0; returns a function that reads
    them all."""
    from hypad_tpu_torch.manifold.kernels import mobius_linear_kernel
    from hypad_tpu_torch.ops.kde_kernel import (
        kde_argmax_kernel,
        kde_argmax_v2_kernel,
    )
    from hypad_tpu_torch.train import critic_kernel as ck

    counters = {"mobius_linear": mobius_linear_kernel,
                "kde_argmax": kde_argmax_kernel,
                "kde_argmax_v2": kde_argmax_v2_kernel,
                "critics_fused_grads": ck.critics_fused_grads,
                "critic_step_full": ck.critic_step_fused_full}
    for fn in counters.values():
        fn.launches = 0
    return lambda: {name: fn.launches for name, fn in counters.items()}


def launches_of(**nonzero):
    """The full launch dict that ``zero_counters``' reader gives: the named
    counts, every other kernel 0."""
    want = dict.fromkeys(("mobius_linear", "kde_argmax", "kde_argmax_v2",
                          "critics_fused_grads", "critic_step_full"), 0)
    want.update(nonzero)
    return want


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
    want = launches_of(mobius_linear=2 * n_batches * 2,
                       critic_step_full=tr.N_CRITICS * n_batches * 2)
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
    want = launches_of(mobius_linear=(tr.N_CRITICS + 2) * n_batches,
                       critics_fused_grads=tr.N_CRITICS * n_batches)
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
    from hypad_tpu_torch.profile_critic_step import critic_case
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
    shape = critic_launch_shape()
    for name, k in (("K5 critic_step_full", k5), ("K4 critics_fused_grads",
                                                  k4)):
        k["launch_shape"] = shape
        t_bytes = k["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = k["ops"] / H100_F32_FLOP_PER_S * 1e3
        k["bound_ms"] = max(t_bytes, t_ops)
        k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[timing] {name} at B={TRAIN_BATCH}, {shape}: kernel "
              f"{k['ms']:.5f} ms, plain {k['plain_ms']:.5f} ms, bound {k['bound_ms']:.6f} ms "
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
    if launches != launches_of(mobius_linear=2, kde_argmax=1):
        fail(f"expected 2 MobiusLinear and 1 KDE (K2) launch, got "
             f"{launches}")
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


def init_model(device, hyperbolic):
    """The full-width model of seed SEED on ``device``."""
    import torch

    from hypad_tpu_torch.models.tadgan import init_tadgan

    return init_tadgan(torch.Generator().manual_seed(SEED), WIDTH,
                       hyperbolic=hyperbolic, device=device)


def phase_eucl_detect(device):
    """The Euclidean detector (K3) on the card for each rec_error with
    zeroed counters, each against the same call on the CPU; returns
    ({rec_error: launches}, model)."""
    import numpy as np
    import torch

    from hypad_tpu_torch.data.pipeline import synthetic_detect_input
    from hypad_tpu_torch.detect.detector import detect_univariate

    X, index, known = synthetic_detect_input(N_WINDOWS, WIDTH, seed=SEED)
    model, cpu_model = init_model(device, False), init_model("cpu", False)
    launches = {}
    for rec_error in REC_ERRORS:
        kwargs = dict(combination="mult", hyperbolic=False,
                      rec_error=rec_error, kde_version="v2")
        read = zero_counters()
        t0 = time.perf_counter()
        got = detect_univariate(model, X, index, known, device=device,
                                **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[rec_error] = read()
        print(f"[eucl] detect_univariate, Euclidean, rec_error {rec_error}, "
              f"{N_WINDOWS} windows, mult, kde_version v2, on {device}: "
              f"{seconds:.3f} s (first call); kernel launches "
              f"{launches[rec_error]}")
        if launches[rec_error] != launches_of(kde_argmax_v2=1):
            fail(f"expected 1 KDE (K3) launch, got {launches[rec_error]}")
        scores = got["scores"]
        if (scores.shape != (N_WINDOWS + WIDTH - 1,)
                or not np.all(np.isfinite(scores))):
            fail(f"Euclidean scores of shape {scores.shape}, finite: "
                 f"{np.isfinite(scores).all()}")
        t0 = time.perf_counter()
        want = detect_univariate(cpu_model, X, index, known, device="cpu",
                                 **kwargs)
        print(f"[eucl] the same call on the CPU: "
              f"{time.perf_counter() - t0:.3f} s")
        check_same_detection(got, want, known, tag=f"eucl {rec_error}")
    return launches, model


def phase_eucl_train(device):
    """The Euclidean training path on the card with zeroed counters, then
    detection with the trained weights (K3) on the card and the CPU."""
    import numpy as np
    import torch

    from hypad_tpu_torch.data.pipeline import (
        A1_BATCH_SIZE as TRAIN_BATCH,
        A1_WINDOWS,
        synthetic_detect_input,
    )
    from hypad_tpu_torch.detect.detector import detect_univariate
    from hypad_tpu_torch.train import trainer as tr

    X, index, known = synthetic_detect_input(A1_WINDOWS, WIDTH,
                                             anomaly_len=50, seed=SEED)
    n_batches = X.shape[0] // TRAIN_BATCH
    logs = []
    read = zero_counters()
    t0 = time.perf_counter()
    state = tr.train_tadgan(init_model(device, False), X, lr=TRAIN_LR,
                            hyperbolic=False, batch_size=TRAIN_BATCH,
                            n_epochs=2, device=device,
                            log_cb=lambda e, m: logs.append(m))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read()
    print(f"[train-eucl] train_tadgan, Euclidean, {X.shape[0]} windows, "
          f"batch {TRAIN_BATCH}, 2 epochs, fused_critics='full', on "
          f"{device}: {seconds:.3f} s (first call); kernel launches "
          f"{launches}")
    for e, m in enumerate(logs, 1):
        print(f"[train-eucl] epoch {e}: {m}")
    want = launches_of(critic_step_full=tr.N_CRITICS * n_batches * 2)
    if launches != want:
        fail(f"expected launches {want}, got {launches}")
    if not all(np.isfinite(v) for m in logs for v in m.values()):
        fail(f"a Euclidean training loss is not finite: {logs}")

    cpu_trained = init_model("cpu", False)
    cpu_trained.load_state_dict({k: v.cpu() for k, v in
                                 state.model.state_dict().items()})
    kwargs = dict(combination="mult", hyperbolic=False, rec_error="point",
                  kde_version="v2")
    read = zero_counters()
    got = detect_univariate(state.model, X, index, known, device=device,
                            **kwargs)
    detect_launches = read()
    if detect_launches != launches_of(kde_argmax_v2=1):
        fail(f"expected 1 KDE (K3) launch, got {detect_launches}")
    want_det = detect_univariate(cpu_trained, X, index, known, device="cpu",
                                 **kwargs)
    f1 = check_same_detection(got, want_det, known, tag="train-eucl")
    return {"launches": launches, "detect_launches": detect_launches,
            "logs": logs, "trained_f1": f1, "first_call_s": seconds}


def write_config(path, cfg):
    """``cfg`` as flat YAML, checked to read back as it was written."""
    from hypad_tpu_torch.utils.config import parse_flat_yaml

    def scalar(v):
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        return "null" if v is None else repr(v)

    path.write_text("".join(f"{k}: {scalar(v)}\n" for k, v in cfg.items()))
    if parse_flat_yaml(path.read_text()) != cfg:
        fail(f"the config written to {path} does not read back")
    return str(path)


def cli_inputs(root):
    """The [cli] phase's two signal CSVs under ``root/data``: Yahoo A1
    ``real_1`` (timestamp,value,is_anomaly; 1,420 samples, the length of
    the real one) and a NAB-style ``nab_sig`` (timestamp,value; 1,420
    samples 21,600 s apart, so interval 21600 keeps each) with its
    anomalies.csv. Returns the NAB signal's known anomalies."""
    import numpy as np

    from hypad_tpu_torch.data.pipeline import (
        A1_WINDOWS,
        extract_known_anomalies,
        synthetic_signal,
    )

    n = A1_WINDOWS + WIDTH
    _, values, flags = synthetic_signal(n, anomaly_len=50, seed=SEED)
    yahoo = root / "data" / "YAHOO" / "A1Benchmark"
    yahoo.mkdir(parents=True)
    (yahoo / "real_1.csv").write_text(
        "timestamp,value,is_anomaly\n" + "".join(
            f"{i + 1},{float(v)!r},{f}\n"
            for i, (v, f) in enumerate(zip(values, flags))))
    stamps = 1_400_000_000 + 21600 * np.arange(n)
    _, values, flags = synthetic_signal(n, anomaly_len=50, seed=SEED + 1)
    (root / "data" / "nab_sig.csv").write_text("timestamp,value\n" + "".join(
        f"{t},{float(v)!r}\n" for t, v in zip(stamps, values)))
    known = np.stack(extract_known_anomalies(flags, stamps), axis=1)
    (root / "data" / "anomalies.csv").write_text(
        'signal,events\nnab_sig,"'
        + json.dumps([[int(a), int(b)] for a, b in known]) + '"\n')
    return known


def run_cli(argv, log_name, card, env=None):
    """``hypad_tpu_torch.cli.main(argv)`` in this process with zeroed launch
    counters (and ``env`` set around it); its stdout goes to
    OUT_DIR/cli_{log_name}.log and its wall-clock lines are printed beside
    the card. Returns (result, launches)."""
    import contextlib
    import io
    import os

    import torch

    from hypad_tpu_torch import cli

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    out = io.StringIO()
    read = zero_counters()
    try:
        with contextlib.redirect_stdout(out):
            result = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = read()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"cli_{log_name}.log").write_text(out.getvalue())
    for line in out.getvalue().splitlines():
        if "wall-clock" in line:
            print(f"[cli] {log_name}: {line} ({card})")
    print(f"[cli] {log_name}: kernel launches {launches}")
    return result, launches


def state_diff(a, b):
    """Largest abs diff between two TrainStates' parameters and optimizer
    moments, and whether every element is within EPOCH_TOL."""
    def tensors(state):
        out = dict(state.model.state_dict())
        for name in ("opt_cx", "opt_cz", "opt_gen"):
            opt = getattr(state, name)
            for m in ("mu", "nu"):
                moments = getattr(opt, m)
                items = (moments.items() if isinstance(moments, dict)
                         else [("", moments)])
                out.update({f"{name}.{m}.{k}": v for k, v in items})
        return out

    ta, tb = tensors(a), tensors(b)
    worst, within = 0.0, True
    for key, want in tb.items():
        diff = (ta[key] - want).abs()
        worst = max(worst, diff.max().item())
        within &= bool((diff <= EPOCH_TOL["atol"]
                        + EPOCH_TOL["rtol"] * want.abs()).all())
    return worst, within


def phase_cli(device, card):
    """The command line, ``python -m hypad_tpu_torch.cli``'s ``main``, at
    the published widths on a Yahoo A1 and a NAB-style CSV, with launch
    counters zeroed around each command: hyperbolic ``train`` (K5, K1,
    K2), its ``detect`` on the CPU and on the card, ``resume``, Euclidean
    ``train`` under HYPAD_KDE_PALLAS=1 (K5, K3), the grids of both
    geometries, and ``train`` under fused_critics false and true. Returns
    {path: launches} and the numbers it printed."""
    import csv
    import shutil
    import tempfile

    import numpy as np

    from hypad_tpu_torch.data.pipeline import A1_WINDOWS
    from hypad_tpu_torch.detect import scorer as sc
    from hypad_tpu_torch.detect.scorer import COMBINATIONS, EUCL_COMBOS
    from hypad_tpu_torch.train import trainer as tr
    from hypad_tpu_torch.utils.config import parse_flat_yaml, run_dir
    from hypad_tpu_torch.utils.config import load_config
    from hypad_tpu_torch.utils.profiling import report, reset_stages

    n_batches = A1_WINDOWS // 64
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    paths, info = {}, {}
    try:
        nab_known = cli_inputs(root)
        reset_stages()

        # 1. hyperbolic train on Yahoo A1, as configs/yahoo_a1_hyper.yaml
        # with 2 epochs and K5; the windows it puts on the card are the
        # ones detection reads
        hyper = parse_flat_yaml(Path("configs/yahoo_a1_hyper.yaml")
                                .read_text())
        hyper.update(epochs=2, fused_critics="full",
                     data_root=str(root / "data"),
                     output_root=str(root / "hyper"))
        cfg_h = write_config(root / "hyper.yaml", hyper)
        seen = {}
        train_tadgan, detect_scores = tr.train_tadgan, sc.detect_scores

        def spy_train(model, X, **kw):
            seen["train_X"] = X
            return train_tadgan(model, X, **kw)

        def spy_detect(params, X, *a, **kw):
            seen["detect_X"] = X
            return detect_scores(params, X, *a, **kw)

        tr.train_tadgan, sc.detect_scores = spy_train, spy_detect
        try:
            (state, run, trained), paths["cli_train_hyper"] = run_cli(
                ["train", "--config", cfg_h, "--profile"], "train_hyper",
                card)
        finally:
            tr.train_tadgan, sc.detect_scores = train_tadgan, detect_scores
        reused = seen["detect_X"] is seen["train_X"]
        print(f"[cli] detection after train read the training windows "
              f"already on the card: {reused}")
        if not reused:
            fail("detection after train uploaded the windows again")
        want = launches_of(critic_step_full=tr.N_CRITICS * n_batches * 2,
                           mobius_linear=2 * n_batches * 2 + 2, kde_argmax=1)
        if paths["cli_train_hyper"] != want:
            fail(f"hyperbolic train: expected launches {want}")
        files = sorted(p.name for p in Path(run).iterdir())
        print(f"[cli] run directory {Path(run).relative_to(root)}: {files}")
        for name in ("state_1.pt", "state_final.pt", "train_log.jsonl",
                     "anomalies.csv", "inference.npz", "config.yaml"):
            if name not in files:
                fail(f"hyperbolic train wrote no {name}")
        log_rows = (Path(run) / "train_log.jsonl").read_text().splitlines()
        results_csv = root / "hyper" / "results" / hyper["filename"]
        if len(log_rows) != 2 or not results_csv.is_file():
            fail(f"{len(log_rows)} train_log rows; results CSV present: "
                 f"{results_csv.is_file()}")
        scores = trained["scores"]
        if scores.shape != (A1_WINDOWS,) or not np.isfinite(scores).all():
            fail(f"hyperbolic scores of shape {scores.shape}")
        known = np.asarray([[float(r[1]), float(r[2])] for r in list(
            csv.reader(open(root / "data" / "YAHOO" / "A1Benchmark"
                            / "real_1_known_anomalies.csv")))[1:]])
        cpu, _ = run_cli(["detect", "--config", cfg_h, "--device", "cpu"],
                         "detect_hyper_cpu", card)
        # an interval's score is a difference of near-equal scores in units
        # of their spread, so the scores' card-CPU difference reaches a
        # small interval score as an absolute, not a relative, difference
        info["train_hyper_f1"] = check_same_detection(
            trained, cpu, known, tag="cli hyper", atol_from_scores=True)

        # 2. detect re-enters from state_final.pt on the card
        again, paths["cli_detect_hyper"] = run_cli(
            ["detect", "--config", cfg_h], "detect_hyper", card)
        if paths["cli_detect_hyper"] != launches_of(mobius_linear=2,
                                                    kde_argmax=1):
            fail("hyperbolic detect: expected K1 2, K2 1")
        check_same_detection(again, trained, known, tag="cli detect")

        # the cached path: load: true reads inference.npz, stages it on
        # the card once and scores it there (K2 1, no forward, so no K1)
        load_cfg = write_config(root / "hyper_load.yaml",
                                dict(hyper, load=True))
        cached, paths["cli_detect_hyper_load"] = run_cli(
            ["detect", "--config", load_cfg], "detect_hyper_load", card)
        if paths["cli_detect_hyper_load"] != launches_of(kde_argmax=1):
            fail("load: true detect: expected K2 1 and nothing else")
        check_same_detection(cached, trained, known, tag="cli load")

        # 3. resume from state_1.pt: the straight run's state within the
        # card's epoch tolerance
        resumed_cfg = write_config(root / "hyper_resume.yaml",
                                   dict(hyper, resume=True))
        (resumed, _, _), paths["cli_resume_hyper"] = run_cli(
            ["train", "--config", resumed_cfg], "resume_hyper", card)
        worst, within = state_diff(resumed, state)
        info["resume_max_abs_diff"] = worst
        print(f"[cli] resume from state_1.pt against the straight 2 "
              f"epochs: largest parameter or moment diff {worst:.3e} "
              f"(tolerance {EPOCH_TOL})")
        if resumed.epoch != 2 or not within:
            fail("the resumed run left another state")
        if paths["cli_resume_hyper"] != launches_of(
                critic_step_full=tr.N_CRITICS * n_batches,
                mobius_linear=2 * n_batches + 2, kde_argmax=1):
            fail("resume: expected K5 100, K1 42, K2 1")

        # 4. Euclidean train on the NAB-style CSV, K3 by JAX's switch
        eucl = parse_flat_yaml(Path("configs/nab_euclidean.yaml")
                               .read_text())
        eucl.update(signal="nab_sig", epochs=1, rec_error="dtw",
                    fused_critics="full", data_root=str(root / "data"),
                    output_root=str(root / "eucl"))
        cfg_e = write_config(root / "eucl.yaml", eucl)
        k3 = {"HYPAD_KDE_PALLAS": "1"}
        (_, _, eucl_res), paths["cli_train_eucl"] = run_cli(
            ["train", "--config", cfg_e], "train_eucl", card, env=k3)
        if paths["cli_train_eucl"] != launches_of(
                critic_step_full=tr.N_CRITICS * n_batches, kde_argmax_v2=1):
            fail("Euclidean train: expected K5 100, K3 1, K1 0")
        if eucl_res["scores"].shape != (A1_WINDOWS + WIDTH - 1,):
            fail(f"Euclidean scores of shape {eucl_res['scores'].shape}")

        # 5. the grids: one forward pass and one KDE launch each; every
        # cell's confusion is a single-cell detect's
        grid, paths["cli_grid_eucl"] = run_cli(
            ["detect", "--config", cfg_e, "--rec-errors", "point,area,dtw",
             "--combinations", "all"], "grid_eucl", card, env=k3)
        if paths["cli_grid_eucl"] != launches_of(kde_argmax_v2=1):
            fail("Euclidean grid: expected K3 1 and nothing else")
        rows = list(csv.DictReader(open(Path(run_dir(load_config(cfg_e)))
                                        / "grid_results.csv")))
        if len(grid) != 3 * len(EUCL_COMBOS) or len(rows) != len(grid):
            fail(f"{len(grid)} cells, {len(rows)} grid_results.csv rows")
        for (re_, cb), cell in grid.items():
            single_cfg = write_config(root / "eucl_cell.yaml",
                                      dict(eucl, rec_error=re_,
                                           combination=cb))
            single, _ = run_cli(["detect", "--config", single_cfg],
                                f"detect_eucl_{re_}_{cb}", card, env=k3)
            if tuple(single["confusion"]) != tuple(cell["confusion"]):
                fail(f"grid cell {re_}/{cb}: confusion {cell['confusion']}"
                     f", single-cell detect {single['confusion']}")
        print(f"[cli] Euclidean grid: {len(grid)} cells, each cell's "
              f"confusion equal to its single-cell detect's; nab_sig known "
              f"anomalies {nab_known.tolist()}")
        hgrid, paths["cli_grid_hyper"] = run_cli(
            ["detect", "--config", cfg_h, "--combinations", "all"],
            "grid_hyper", card)
        if (len(hgrid) != len(COMBINATIONS) or paths["cli_grid_hyper"]
                != launches_of(mobius_linear=2, kde_argmax=1)):
            fail("hyperbolic grid: expected 8 cells, K1 2, K2 1")
        if tuple(hgrid[(None, hyper["combination"])]["confusion"]) != tuple(
                again["confusion"]):
            fail("the hyperbolic grid's config cell differs from detect")

        # 6. the configs' default critic step (autograd) and K4, 1 epoch;
        # the critic steps' generator forwards run K1 in both
        for mode, key in ((False, "cli_train_fused_false"),
                          (True, "cli_train_fused_true")):
            cfg = write_config(root / f"{key}.yaml",
                               dict(hyper, epochs=1, fused_critics=mode,
                                    output_root=str(root / key)))
            _, paths[key] = run_cli(["train", "--config", cfg],
                                    key.removeprefix("cli_"), card)
            want = launches_of(
                mobius_linear=(tr.N_CRITICS + 2) * n_batches + 2,
                kde_argmax=1,
                critics_fused_grads=tr.N_CRITICS * n_batches if mode else 0)
            if paths[key] != want:
                fail(f"fused_critics {mode}: expected launches {want}")

        # 7. the stages of every command above
        print(f"[cli] stage table ({card}):")
        for line in report().splitlines():
            print(f"[cli]   {line}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths, info


def phase_staged(device, X, eucl_model, hyper_model):
    """run_inference then score_anomalies_* against detect_scores' one
    call, for both geometries at the detect shape: (a) the chunked forward
    within FORWARD_TOL of the one call's; (b) the staged scorer on the one
    call's own forward outputs within SCORE_TOL of its scores; (c) the
    staged path end to end with the one call's zero and NaN positions and
    intervals. Its scores are held at tie level only: a batch of 1,024
    rows and one of 20,000 sum the forward's products in other orders, and
    a last-bit change of a critic value can flip a KDE tie."""
    import numpy as np
    import torch

    from hypad_tpu_torch.detect import intervals as iv
    from hypad_tpu_torch.detect import scorer as sc

    for label, model, hyperbolic, kde_version in (
            ("Euclidean", eucl_model, False, "v2"),
            ("hyperbolic", hyper_model, True, "v1")):
        one, one_inf = sc.detect_scores(model, X, hyperbolic, "mult",
                                        kde_version=kde_version,
                                        device=device)

        def staged_scores(inf):
            if hyperbolic:
                return sc.score_anomalies_hyperbolic(inf, "mult", kde_version,
                                                     device=device)
            return sc.score_anomalies_euclidean(
                inf.true_signal, inf.recons_signal, inf.critic_score, "point",
                "mult", kde_version=kde_version, device=device)

        t0 = time.perf_counter()
        inf = sc.run_inference(model, X, hyperbolic, device=device)
        staged = staged_scores(inf)
        seconds = time.perf_counter() - t0
        for a, b in zip(inf, one_inf):
            if a is not None and not np.allclose(a, b, **FORWARD_TOL):
                fail(f"{label} run_inference differs from the one call's "
                     f"forward by {np.max(np.abs(a - b)):.3e}")
        forward_diff = max(float(np.max(np.abs(a - b)))
                           for a, b in zip(inf, one_inf) if a is not None)
        same_inputs = staged_scores(one_inf)
        if not (np.array_equal(np.isnan(same_inputs), np.isnan(one))
                and np.allclose(same_inputs, one, equal_nan=True,
                                **SCORE_TOL)):
            fail(f"{label} staged scorer on the one call's forward differs "
                 f"from its scores (tolerance {SCORE_TOL})")
        # KDE maxima that moved by more than the critic's last bits
        kde = [sc.kde_argmax_rows_fused(
            *sc._critic_antidiag(torch.as_tensor(c, device=device), len(X),
                                 X.shape[1]), kde_version).cpu().numpy()
            for c in (inf.critic_score, one_inf.critic_score)]
        kde_flips = int(np.sum(np.abs(kde[0] - kde[1]) > 1e-6))
        rel = float(np.max(np.abs(staged - one)
                           / np.maximum(np.abs(one), 1e-6)))
        same_rel = float(np.max(np.abs(same_inputs - one)
                                / np.maximum(np.abs(one), 1e-6)))
        index = np.arange(len(one), dtype=np.float64)
        intervals = [np.asarray(iv.find_anomalies(
            s, index, window_size_portion=0.33, window_step_size_portion=0.1,
            fixed_threshold=True)).reshape(-1, 3) for s in (staged, one)]
        print(f"[staged] {label}: run_inference (chunks of 1,024) and "
              f"score_anomalies in {seconds:.3f} s; forward within "
              f"{forward_diff:.3e} of the one call's; {kde_flips} KDE tie "
              f"flips between the two forwards' critics; scores within "
              f"{rel:.3e} relative (on the one call's forward: "
              f"{same_rel:.3e}); intervals {intervals[0][:, :2].tolist()}")
        if not (np.array_equal(staged == 0, one == 0)
                and np.array_equal(np.isnan(staged), np.isnan(one))):
            fail(f"{label} staged scores' zero or NaN positions differ from "
                 f"the one call's")
        if not np.array_equal(intervals[0][:, :2], intervals[1][:, :2]):
            fail(f"{label} staged intervals {intervals[0].tolist()} differ "
                 f"from the one call's {intervals[1].tolist()}")


def warm_detect_ms(calls, rounds=7):
    """{label: [wall ms of each round]} of warm detect calls, each
    ``calls[label]()`` once a round, in turns, after one warm-up each.
    Each call returns host scores, so it ends synchronised."""
    for call in calls.values():
        call()
    walls = {label: [] for label in calls}
    for _ in range(rounds):
        for label, call in calls.items():
            t0 = time.perf_counter()
            call()
            walls[label].append((time.perf_counter() - t0) * 1e3)
    return walls


def k1_cost(rows, din, dout):
    """(bytes, operations) of K1: x, W, b read once, out written once; the
    product plus the ~16 f32 operations of the clamp chain per output."""
    return (4 * (rows * din + dout * din + dout + rows * dout),
            2 * rows * din * dout + 16 * rows * dout)


def bound(k):
    """Set k's bound_ms and bound_by from its bytes and ops."""
    t_bytes = k["bytes"] / H100_BYTES_PER_S * 1e3
    t_ops = k["ops"] / H100_F32_FLOP_PER_S * 1e3
    k["bound_ms"] = max(t_bytes, t_ops)
    k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return k


def phase_timing(device, X, model, eucl_model, libs):
    """Warm detect throughput (hyperbolic under K2 and K3, Euclidean for
    each rec_error), and each detect kernel beside its plain version at the
    path's shapes: K1 at the detect shape and at the generator step's, with
    an empty kernel's launch-to-end time beside them. Returns (throughputs,
    per-kernel timing dicts)."""
    import numpy as np
    import torch

    from hypad_tpu_torch.data.pipeline import A1_BATCH_SIZE as TRAIN_BATCH
    from hypad_tpu_torch.detect.scorer import _critic_antidiag, detect_scores
    from hypad_tpu_torch.manifold.kernels import (
        mobius_linear,
        mobius_linear_kernel,
    )
    from hypad_tpu_torch.ops.kde import (
        kde_argmax_rows_and_use,
        kde_argmax_rows_v2_and_use,
    )
    from hypad_tpu_torch.ops.kde_kernel import (
        kde_argmax_kernel,
        kde_argmax_v2_kernel,
    )
    from hypad_tpu_torch.profile_detect import cuda_ms
    from hypad_tpu_torch.profile_kernels import empty_launch, tie_flips

    def detect(m, hyperbolic, **kw):
        return lambda: detect_scores(m, X, hyperbolic, "mult",
                                     fetch_inference=False, device=device,
                                     **kw)

    calls = {"hyperbolic v1": detect(model, True, kde_version="v1"),
             "hyperbolic v2": detect(model, True, kde_version="v2")}
    calls.update({f"euclidean {r} v2": detect(eucl_model, False,
                                              rec_error=r, kde_version="v2")
                  for r in REC_ERRORS})
    wps = {}
    for label, walls in warm_detect_ms(calls).items():
        median = statistics.median(walls)
        wps[label] = N_WINDOWS / median * 1e3
        print(f"[timing] warm detect_scores, {label}, {N_WINDOWS} windows: "
              f"median {median:.3f} ms, {wps[label]:.0f} windows/s (runs in "
              f"ms: {[round(w, 3) for w in walls]})")

    head = model["decoder"].hyperbolic_linear
    w, b = head.w.detach(), head.b.detach()
    empty = empty_launch(libs["empty"].empty_forward)
    with torch.inference_mode():
        Xt = torch.as_tensor(X, device=device)
        critic = model["critic_x"](Xt)[:, 0]
        vals, mask = _critic_antidiag(critic, N_WINDOWS, WIDTH)
        empty_ms = cuda_ms(empty, 200)
        print(f"[timing] an empty kernel, launch to end: {empty_ms:.5f} ms")
        by_shape = {}
        for rows in (N_WINDOWS, 2 * TRAIN_BATCH, TRAIN_BATCH):
            x = Xt[:rows].contiguous()
            k = {"ms": cuda_ms(lambda: mobius_linear_kernel(x, w, b), 200),
                 "plain_ms": cuda_ms(lambda: mobius_linear(x, w, b), 50),
                 "max_abs_err": (mobius_linear_kernel(x, w, b)
                                 - mobius_linear(x, w, b)).abs().max().item()}
            k["bytes"], k["ops"] = k1_cost(rows, x.shape[1], w.shape[0])
            by_shape[f"({rows}, {WIDTH})"] = bound(k)
            print(f"[timing] K1 mobius_linear ({rows}, {WIDTH}): kernel "
                  f"{k['ms']:.5f} ms ({k['ms'] / empty_ms:.2f}x an empty "
                  f"kernel), plain {k['plain_ms']:.5f} ms, bound "
                  f"{k['bound_ms']:.6f} ms ({k['bound_by']})")
        k1 = dict(by_shape[f"({N_WINDOWS}, {WIDTH})"], ms_by_shape={
            shape: {key: k[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")}
            for shape, k in by_shape.items()}, empty_kernel_ms=empty_ms)
        k1["max_abs_err"] = max(k["max_abs_err"] for k in by_shape.values())
        cublas_ms = cuda_ms(lambda: Xt @ w.T, 200)
        print(f"[timing] informative, not K1's function: cuBLAS f32 x @ w.T "
              f"at ({N_WINDOWS}, {WIDTH}) x ({WIDTH}, {WIDTH}): "
              f"{cublas_ms:.5f} ms")
        kde = {}
        for name, kernel, plain in (
                ("kde_argmax", kde_argmax_kernel, kde_argmax_rows_and_use),
                ("kde_argmax_v2", kde_argmax_v2_kernel,
                 kde_argmax_rows_v2_and_use)):
            k = {"ms": cuda_ms(lambda: kernel(vals, mask), 50),
                 "plain_ms": cuda_ms(lambda: plain(vals, mask), 5)}
            got, _ = kernel(vals, mask)
            want, _ = plain(vals, mask)
            k["tie_flips"] = tie_flips(got, want, vals, mask)
            k["max_abs_err"] = (got - want).abs().max().item()
            kde[name] = k
    k2, k3 = kde["kde_argmax"], kde["kde_argmax_v2"]
    k1["cublas_matmul_ms"] = cublas_ms

    # vals (f32) and mask (bool) read once, value (f32) and use (bool)
    # written once. Both kernels compute each unordered pair of samples of
    # a row once: difference, square, scale, exp and two sums; plus ~8
    # operations per sample for mean and variance (the in-kernel median
    # touches the few fallback rows only)
    cnt = mask.sum(dim=1).double()
    pairs = (cnt * (cnt - 1) / 2).sum().item()
    for k in (k2, k3):
        k["bytes"] = 5 * vals.numel() + 5 * vals.shape[0]
        k["exps"] = int(pairs)
        k["ops"] = int(6 * pairs + 8 * cnt.sum().item())
        bound(k)
        k["sfu_ms"] = k["exps"] / H100_SFU_EXP_PER_S * 1e3
    for name, k in (("K2 kde_argmax, median fallback included", k2),
                    ("K3 kde_argmax_v2, median fallback included", k3)):
        print(f"[timing] {name}: kernel {k['ms']:.5f} ms, plain "
              f"{k['plain_ms']:.5f} ms, bound {k['bound_ms']:.5f} ms "
              f"({k['bound_by']}: {k['bytes']} bytes, {k['ops']} ops); SFU "
              f"estimate {k['sfu_ms']:.5f} ms for {k['exps']} exps")
    if not np.isfinite([k1["ms"], k2["ms"], k3["ms"]]).all():
        fail("a kernel time is not finite")
    return wps, k1, k2, k3


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

    libs = phase_build()
    k1_err, k1_parent, kde_flips = phase_kernels(device, libs)
    k45_err = phase_critic_kernels(device)
    launches, X, model = phase_main_path(device)
    eucl_launches, eucl_model = phase_eucl_detect(device)
    train = phase_train(device)
    eucl_train = phase_eucl_train(device)
    cli_paths, cli_info = phase_cli(device, card)
    phase_staged(device, X, eucl_model, model)
    wps, k1, k2, k3 = phase_timing(device, X, model, eucl_model, libs)
    epochs, k4, k5 = phase_train_timing(device, train["X"])
    paths = {"detect": launches,
             **{f"detect_euclidean_{r}": eucl_launches[r]
                for r in REC_ERRORS},
             "train": train["launches"],
             "train_fused_critics_true": train["launches_fused_true"],
             "train_euclidean": eucl_train["launches"],
             "detect_euclidean_trained": eucl_train["detect_launches"],
             **cli_paths}
    by_path = {name: {path: counts[name] for path, counts in paths.items()}
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
         "max_abs_diff_to_parent_kernel": k1_parent,
         "tolerance": "max abs diff <= 1e-6",
         "ms": k1["ms"], "kernel_ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "ms_by_shape": k1["ms_by_shape"],
         "empty_kernel_ms": k1["empty_kernel_ms"],
         "cublas_matmul_ms_informative": k1["cublas_matmul_ms"],
         "library_ms": None},
        {"name": "kde_argmax", "route": "cuda",
         "source": "hypad_tpu_torch/csrc/kde_argmax.cu",
         "replaces": "hypad_tpu/ops/kde_pallas.py:42",
         "launches": launches["kde_argmax"],
         "launches_per_call": launches["kde_argmax"],
         "launches_by_path": by_path["kde_argmax"],
         "max_abs_err": k2["max_abs_err"],
         "tolerance": "use flags bitwise; fallback rows bitwise "
                      "masked_median; elsewhere tie level: a differing value "
                      "is a sample of its own row, at most 1% of rows differ",
         "median_fallback": "in the kernel, one launch",
         "tie_flips": k2["tie_flips"],
         "edge_case_tie_flips": kde_flips["kde_argmax"],
         "exps": k2["exps"], "sfu_ms": k2["sfu_ms"],
         "ms": k2["ms"], "kernel_ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "kde_argmax_v2", "route": "cuda",
         "source": "hypad_tpu_torch/csrc/kde_argmax.cu",
         "replaces": "hypad_tpu/ops/kde_pallas.py:91",
         "launches": eucl_launches["point"]["kde_argmax_v2"],
         "launches_per_call": eucl_launches["point"]["kde_argmax_v2"],
         "launches_path": "detect, Euclidean, rec_error point, "
                          "kde_version v2",
         "launches_by_path": by_path["kde_argmax_v2"],
         "max_abs_err": k3["max_abs_err"],
         "tolerance": "use flags bitwise; fallback rows bitwise "
                      "masked_median; elsewhere tie level: a differing value "
                      "is a sample of its own row, at most 1% of rows differ",
         "median_fallback": "in the kernel, one launch",
         "tie_flips": k3["tie_flips"],
         "edge_case_tie_flips": kde_flips["kde_argmax_v2"],
         "exps": k3["exps"], "sfu_ms": k3["sfu_ms"],
         "ms": k3["ms"], "kernel_ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None},
        {"name": "critics_fused_grads", "route": "cuda",
         "source": "hypad_tpu_torch/csrc/critic_step.cu",
         "replaces": "hypad_tpu/train/critic_kernel.py:156",
         "launches": train["launches_fused_true"]["critics_fused_grads"],
         "launches_path": "train, fused_critics=True, 1 epoch",
         "launches_by_path": by_path["critics_fused_grads"],
         "max_abs_err": k45_err["critics_fused_grads"],
         "tolerance": tol_text.format(*K4_TOL),
         "launch_shape": k4["launch_shape"],
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
         "launch_shape": k5["launch_shape"],
         "ms": k5["ms"], "kernel_ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None},
    ]
    OUT_DIR.mkdir(exist_ok=True)
    summary = {"card": card, "detect_20k_wps": wps["hyperbolic v1"],
               "detect_20k_wps_by_path": wps,
               "train_epoch_s": epochs,
               "train_losses": train["logs"],
               "train_first_call_s": train["first_call_s"],
               "epoch_card_vs_cpu_max_abs_diff": train["epoch_max_abs_diff"],
               "epoch_card_vs_cpu_max_rel_diff": train["epoch_max_rel_diff"],
               "trained_detect_f1": train["trained_f1"],
               "euclidean_train_losses": eucl_train["logs"],
               "euclidean_trained_detect_f1": eucl_train["trained_f1"],
               "cli": cli_info,
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
