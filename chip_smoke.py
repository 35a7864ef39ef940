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
8. fleet ([fleet]): K1, K5 and K4 with a signal axis at S = 1, 3 and 9
   (K1 at the generator step's 2B = 128 rows a signal, K5 and K4 at B =
   64), each one launch whose every signal is bitwise that signal's
   single-signal launch and within the plain version's tolerance, timed
   against S single launches; K1 also at fleet detection's (9, 2,280,
   100); a 2-epoch hyperbolic seed band (S = 3,
   1,320 windows, batch 64, "full") through ``train_fleet`` with zeroed
   counters (K5 200, K1 80: one signal's launches), each signal held
   against ``train_tadgan(seed=i)`` on the card within 5e-3 / 2e-4; one
   ragged fleet epoch (640, 448 and 0 windows) on the card, each signal
   element-wise its single-model epoch on the card, its mean losses
   within 1e-3 / 1e-4 of the CPU's from the same weights and draws; warm
   fleet epochs at S = 1, 3 and
   9 (host seconds, all device launches an epoch under torch.profiler)
   beside a warm single-model epoch; ``detect_scores_fleet`` of 9 signals
   (K1 2, K2 1), each signal's intervals, confusion, F1 and zero and NaN
   positions those of its own ``detect_scores`` call on the card and of
   the CPU's ``detect_scores_fleet``, then timed against 9
   ``detect_scores`` calls, warm windows/s;
9. sweep ([sweep]): ``sweep`` of configs/nab_sweep.yaml (9 signals,
   Euclidean, cut to 1 epoch) through ``hypad_tpu_torch.cli.main`` on 9
   NAB-style CSVs of 1,420 to 2,380 samples (K2 1: the one fleet
   detection), then ``sweep --detect-only --device cpu`` on the card's
   checkpoints: every signal's intervals, confusion and F1 equal, interval
   scores within the limit the measured score difference allows; then on
   the card ``sweep --detect-only`` (the same detections), ``detect``
   re-entering a sweep run directory, and ``--signals`` x ``--seeds 0,1``
   (runs under seed_0/ and seed_1/), each one K2 launch; the fleet grid,
   ``sweep --detect-only --rec-errors all --combinations all`` (12 cells
   of each of the 9 signals in one call, K2 1) on the card and then with
   ``--device cpu``: every cell's intervals, confusion and F1 equal, every
   run's grid_results.csv and the family's sweep_grid.csv line for line,
   and each signal's cells those of its own card ``detect_grid``; then the
   warm fleet grid against the 9 ``detect_scores_grid`` calls it replaces
   (medians of 5, windows/s);
10. multivariate ([mv]; its kernel checks run right after phase 2, before
   the long profiler traces of [fleet]): the wide instances of K1 (at (64,
   F), (128, F) and (50,000, F)), K2 and K3 (T = 50,000 + F - 1 rows of width F) and
   K5 and K4 (B = 64, one signal and three in one launch) at F = 150 and
   256 against their plain versions (K2 and K3: use flags and fallback
   rows bitwise, every other differing row a float64 density tie), and
   at F = 123 the narrow instances, each named by the profiler; the main
   path, ``cli train`` (1 epoch) then ``detect`` on a WADI-format pair
   written here (8,000 training and 50,000 test rows of 123 features,
   three level-shift runs) at configs/multivariate.yaml's widths
   (hyperbolic, batch 64, fused_critics false: K1 (N_CRITICS + 2) x 125
   + 2, K2 1), then ``detect --device cpu`` on the card's checkpoint: the
   same intervals, interval scores within what the score difference
   allows, the same zeros and NaNs; the warm epoch at that width; the
   CASAS width, ``detect_scores(multivariate=True)`` at 50,000 rows of
   150 on the card (the wide K1 2, K2 1) against the CPU and
   ``detect_grid`` over the 8 combinations; ``sweep`` of 3 CASAS
   residents (.pt tensors, 2,000 rows of 150, 1 epoch, "full": the wide
   K5 once a fleet critic step) and its ``--detect-only --device cpu``:
   each resident's intervals, confusion and F1 equal; the same under
   HYPAD_KDE_PALLAS=1 (the wide K3), the family's fleet grid
   (``sweep --detect-only --combinations all``, K1 2 and K2 1 wide, then
   K3 1 under HYPAD_KDE_PALLAS=1) card against CPU as in [sweep], and one
   resident's ``train`` under fused_critics true (the wide K4); warm
   detect rows/s at 50,000 rows of 51, 123 and 150;
10b. widths above 256 ([xwide]; its kernel checks run after [mv]'s): the
   any-width instances of K1 (at (64, W), (128, W) and (4,096, W)), K2
   and K3 (T = 4,096 rows at W = 300 and 512, 2,048 at 1,024, the plain
   K2 128 rows at a time; a constant run and NaNs at 300) for W = 300,
   512 and 1,024, and K5 and K4 (B = 64, one signal and three in one
   launch) at 300 and 512 against their plain versions, each named by
   the profiler; the main path at width 300 through the CLI, on a
   WADI-format stream of 300 features (2,000 training and 2,000 test
   rows): ``train`` (1 epoch, fused_critics "full": the any-width K5 and
   K1), ``detect`` (K1 2, K2 1) against train's own detection and
   against ``detect --device cpu`` from the card's checkpoint (intervals,
   confusion, zeros and NaNs equal), the same under HYPAD_KDE_PALLAS=1
   (K3), and ``train`` under fused_critics true (K4);
11. staged path: at 20,000 windows, ``run_inference`` (chunks of 1,024)
   must give the one call's forward outputs within 1e-5 relative / 1e-6
   absolute; ``score_anomalies_euclidean`` (Euclidean model) and
   ``score_anomalies_hyperbolic`` (hyperbolic model) on the one call's
   forward must give ``detect_scores``' scores within the scores'
   tolerance; on ``run_inference``'s output, the same zero and NaN
   positions and intervals (chunks sum the forward in another order, and a
   last-bit change of a critic value can flip a KDE tie);
12. timing: warm detect throughput (hyperbolic under K2 and K3, Euclidean
   for each rec_error), warm epoch seconds for each ``fused_critics``
   value, and each kernel's time beside its plain version's and its bound
   at the path's shapes (K1 at the detect shape and at the generator
   step's two, beside an empty kernel; cuBLAS's f32 x @ w.T as an
   informative line, not K1's function); each wide instance beside its
   plain version, its bound and the narrow instance at F = 100; each
   any-width instance beside its plain version and its bound at the
   width-300 path's shapes, and K1 at (50,000, 256) and at the WADI
   training shapes (64 and 128 rows of 123);
13. report: one JSON line of the kernels (the wide instances as
   ``{name}_wide`` entries, the any-width ones as ``{name}_xwide``) (with
   each signal-axis kernel's
   times at S = 1, 3 and 9), the card's name and power limit,
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
# an epoch's mean losses: test_torch_train.py's
# test_epoch_tracks_jax_with_injected_draws
METRIC_TOL = dict(rtol=1e-3, atol=1e-4)
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


def kernels_launched(fn, tries=8):
    """Names of the device kernels that ``fn()`` launches, from a second
    call: the profiler can miss a kernel's first launch (its module is
    loaded lazily then). A trace with no device event (it happens now and
    then, after many traces) is taken again after a short pause, up to
    ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            return names
        print("[kernels] the profiler recorded no device event; tracing "
              "again")
        time.sleep(0.5)
    return names


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


def interval_score_atol(scores, rel, multivariate=False):
    """The most that a relative change of at most ``rel`` in every score
    can move an interval score, to first order. An interval score is
    (max - threshold) / (mean + std) of its threshold window, with the
    threshold mean + 4 std: the run's max moves by at most rel max|s|, the
    mean by rel mean|s| and the std by rel rms(s), so the numerator by
    rel (max|s| + mean|s| + 4 rms) and the denominator by rel (mean|s| +
    rms). Taken over the detector's threshold windows (univariate, or per
    timestep for a multivariate run); a merged interval averages window
    scores, so it stays within the largest, as long as no window gains or
    prunes a run."""
    import numpy as np

    worst = 0.0
    for w in threshold_windows(scores, multivariate):
        mean_abs, rms, max_abs = (np.abs(w).mean(), np.sqrt(np.mean(w * w)),
                                  np.abs(w).max())
        den = abs(w.mean() + w.std())
        num = max_abs + mean_abs + 4 * rms   # also bounds |max - threshold|
        worst = max(worst, rel * (num + num / den * (mean_abs + rms)) / den)
    return float(worst)


def threshold_windows(scores, multivariate=False):
    """The detector's threshold windows of ``scores`` (univariate, or per
    timestep for a multivariate run), as float64 slices."""
    import numpy as np

    from hypad_tpu_torch.detect import detector
    from hypad_tpu_torch.detect import intervals as iv

    kw = detector._MV_FA_KW if multivariate else detector._UNIVARIATE_FA_KW
    s = np.asarray(scores, np.float64).reshape(-1)
    size, step = iv._window_geometry(len(s), None, kw["window_size_portion"],
                                     None, kw["window_step_size_portion"])
    start, end = 0, 0
    while end < len(s):
        end = start + size
        yield s[start:end]
        start += step


def check_same_detection(got, want, known, tag="detect",
                         atol_from_scores=False, multivariate=False,
                         verbose=True):
    """Fail unless two detect_univariate results give the same intervals,
    confusion and F1, and interval scores within 1e-3 relative. Under
    ``atol_from_scores`` they may also differ by what the measured relative
    score difference can make of them (:func:`interval_score_atol`).
    ``verbose=False`` prints nothing unless a check fails (a grid's many
    cells)."""
    import builtins

    import numpy as np

    print = builtins.print if verbose else (lambda *a, **k: None)
    scores = got["scores"]
    score_diff = float(np.max(np.abs(scores - want["scores"])
                              / np.maximum(np.abs(want["scores"]), 1e-6)))
    print(f"[{tag}] scores: max relative diff to the CPU {score_diff:.3e}; "
          f"exact zeros at the same positions: "
          f"{np.array_equal(scores == 0, want['scores'] == 0)}")
    score_atol = 0.0
    if atol_from_scores:
        score_atol = interval_score_atol(want["scores"], score_diff,
                                         multivariate)
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
        fail(f"[{tag}] intervals {iv.tolist()} differ from the CPU's: "
             f"{want_iv.tolist()}")
    print(f"[{tag}] interval scores: max abs diff to the CPU "
          f"{float(np.max(np.abs(iv[:, 2] - want_iv[:, 2]), initial=0)):.3e}")
    if not np.allclose(iv[:, 2], want_iv[:, 2], rtol=1e-3, atol=score_atol):
        fail(f"[{tag}] interval scores {iv.tolist()} differ from the CPU's:"
             f" {want_iv.tolist()}")
    if tuple(got["confusion"]) != tuple(want["confusion"]):
        fail(f"[{tag}] confusion {got['confusion']} differs from the CPU's "
             f"{want['confusion']}")
    f1, want_f1 = ((m or {}).get("f1") for m in (got["metrics"],
                                                  want["metrics"]))
    if f1 != want_f1:
        fail(f"[{tag}] F1 {f1} differs from the CPU's {want_f1}")
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
        fn.launches = fn.wide_launches = fn.xwide_launches = 0
    # each kernel's launches, then those of its wide instance (widths of
    # 129 to 256) among them as "{name}_wide" and of its any-width instance
    # (above 256) as "{name}_xwide"
    return lambda: {**{name: fn.launches for name, fn in counters.items()},
                    **{f"{name}_wide": fn.wide_launches
                       for name, fn in counters.items()},
                    **{f"{name}_xwide": fn.xwide_launches
                       for name, fn in counters.items()}}


KERNEL_NAMES = ("mobius_linear", "kde_argmax", "kde_argmax_v2",
                "critics_fused_grads", "critic_step_full")


def launches_of(**nonzero):
    """The full launch dict that ``zero_counters``' reader gives: the named
    counts, every other kernel (and wide or any-width instance) 0."""
    want = dict.fromkeys(KERNEL_NAMES + tuple(
        f"{k}_{kind}" for kind in ("wide", "xwide") for k in KERNEL_NAMES), 0)
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
        for e in range(3):  # one warm-up epoch, then two timed
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


FLEET_SIZES = (1, 3, 9)
# the windows of the 9 signals fleet detection scores (1,320 to 2,280)
FLEET_DETECT_LENS = tuple(1320 + 120 * i for i in range(9))
FLEET_TOL = dict(rtol=3e-4, atol=1e-5)   # tests/test_fleet_detect.py


def fleet_models(device, S, hyperbolic=True, seed0=0):
    """S full-width models of seeds seed0 .. seed0 + S - 1."""
    import torch

    from hypad_tpu_torch.models.tadgan import init_tadgan

    return [init_tadgan(torch.Generator().manual_seed(seed0 + i), WIDTH,
                        hyperbolic=hyperbolic, device=device)
            for i in range(S)]


def fleet_step_case(device, S, B, hyperbolic=True):
    """S full-width models, their stacked parameters, x (S, B, W) and one
    critic step's draws with a leading S, each signal its own."""
    import torch

    from hypad_tpu_torch.train import fleet as fl

    models = fleet_models(device, S, hyperbolic, seed0=50)
    g = torch.Generator().manual_seed(100 + S)
    d = {"z_x": torch.randn(S, B, 20, generator=g),
         "a_x": torch.rand(S, B, WIDTH, generator=g),
         "z_z": torch.randn(S, B, 20, generator=g),
         "a_z": torch.rand(S, B, 20, generator=g),
         "m_cx": torch.rand(S, 4, 3 * B, 20, generator=g) < 0.75,
         "m_cz": torch.rand(S, 2, 3 * B, 20, generator=g) < 0.8,
         "m_dec": torch.rand(S, B, 128, generator=g) < 0.8}
    x = torch.rand(S, B, WIDTH, generator=g) * 2 - 1
    return (models, fl.stack_models(models), x.to(device),
            {k: v.to(device) for k, v in d.items()})


def fleet_kernel_checks(device):
    """K1, K5 and K4 with a signal axis at S = 1, 3 and 9: one launch each,
    each signal bitwise its single-signal launch, the plain version's
    tolerance; timed against S single launches. Returns {kernel: {S:
    record}}."""
    import torch

    from hypad_tpu_torch.data.pipeline import A1_BATCH_SIZE as TRAIN_BATCH
    from hypad_tpu_torch.manifold.kernels import (
        mobius_linear,
        mobius_linear_kernel,
    )
    from hypad_tpu_torch.profile_detect import cuda_ms
    from hypad_tpu_torch.train import critic_kernel as ck
    from hypad_tpu_torch.train import fleet as fl

    def k1_check(xs, w, b, what):
        """One K1 launch over xs (S, rows, W): each signal bitwise its own
        single-signal launch, within 1e-6 of the plain version. Returns
        the max abs diff to plain."""
        S = xs.shape[0]
        read = zero_counters()
        got = mobius_linear_kernel(xs, w, b)
        torch.cuda.synchronize()
        if read()["mobius_linear"] != 1:
            fail(f"K1 {what} launched {read()['mobius_linear']} times")
        singles = [mobius_linear_kernel(xs[i].contiguous(), w[i], b[i])
                   for i in range(S)]
        if not all(torch.equal(got[i], singles[i]) for i in range(S)):
            fail(f"K1 {what}: a signal differs from its own launch")
        err = (got - mobius_linear(xs, w, b)).abs().max().item()
        if err > 1e-6:
            fail(f"K1 {what}: max abs diff {err:.3e} to plain > 1e-6")
        return err

    out = {"mobius_linear": {}, "critic_step_full": {},
           "critics_fused_grads": {}}
    B = TRAIN_BATCH
    for S in FLEET_SIZES:
        models, P, x, d = fleet_step_case(device, S, B)
        # K1 at the generator step's decoder-head shape, 2B rows a signal
        w = P["decoder.hyperbolic_linear.w"]
        b = P["decoder.hyperbolic_linear.b"]
        xs = torch.cat([x, x.flip(1)], dim=1).contiguous()
        err = k1_check(xs, w, b, f"with S={S}")
        rows = xs.shape[1]
        one = [(xs[i].contiguous(), w[i], b[i]) for i in range(S)]
        rec = {"ms": cuda_ms(lambda: mobius_linear_kernel(xs, w, b), 100),
               "single_launches_ms": cuda_ms(
                   lambda: [mobius_linear_kernel(*a) for a in one], 100),
               "plain_ms": cuda_ms(lambda: mobius_linear(xs, w, b), 20),
               "max_abs_err": err, "rows_a_signal": rows}
        rec["bytes"], rec["ops"] = (v * S for v in k1_cost(rows, WIDTH,
                                                           WIDTH))
        out["mobius_linear"][S] = bound(rec)

        # K5 and K4 at B = 64 a signal
        read = zero_counters()
        got5 = ck.critic_step_fused_full_fleet(P, x, d, True)
        bigx, bigz = ck.critic_step_inputs_fleet(P, x, d, True)
        got4 = ck.critics_fused_grads_fleet(P, bigx, bigz, d["m_cx"],
                                            d["m_cz"])
        torch.cuda.synchronize()
        n = read()
        if (n["critic_step_full"], n["critics_fused_grads"]) != (1, 1):
            fail(f"K5 / K4 with S={S} launched {n}")
        args = []
        for i, m in enumerate(models):
            di = {k: v[i] for k, v in d.items()}
            one5 = ck.critic_step_fused_full(m, x[i], di, True)
            a4 = (m["critic_x"], m["critic_z"], bigx[i], bigz[i],
                  di["m_cx"], di["m_cz"])
            one4 = ck.critics_fused_grads(*a4)
            args.append((m, x[i], di, a4))
            for name, fleet_out, single in (("K5", got5, one5),
                                            ("K4", got4, one4)):
                same = (torch.equal(fleet_out[0][i], single[0])
                        and torch.equal(fleet_out[1][i], single[1])
                        and all(torch.equal(fleet_out[j][k][i], single[j][k])
                                for j in (2, 3) for k in single[j]))
                if not same:
                    fail(f"{name} with S={S}: signal {i} differs from its "
                         "own single-signal launch")
        plain5 = ck.critic_step_fleet_plain(P, x, d, True)
        plain4 = ck.critics_fused_grads_fleet_plain(P, bigx, bigz, d["m_cx"],
                                                    d["m_cz"])
        e5 = critic_err(got5, plain5, K5_TOL, f"K5 with S={S}")
        e4 = critic_err(got4, plain4, K4_TOL, f"K4 with S={S}")
        r5 = {"ms": cuda_ms(lambda: ck.critic_step_fused_full_fleet(
                  P, x, d, True), 100),
              "single_launches_ms": cuda_ms(lambda: [
                  ck.critic_step_fused_full(m, xi, di, True)
                  for m, xi, di, _ in args], 100),
              "plain_ms": cuda_ms(lambda: ck.critic_step_fleet_plain(
                  P, x, d, True), 10), "max_abs_err": e5}
        r4 = {"ms": cuda_ms(lambda: ck.critics_fused_grads_fleet(
                  P, bigx, bigz, d["m_cx"], d["m_cz"]), 100),
              "single_launches_ms": cuda_ms(lambda: [
                  ck.critics_fused_grads(*a4) for *_, a4 in args], 100),
              "plain_ms": cuda_ms(lambda: ck.critics_fused_grads_fleet_plain(
                  P, bigx, bigz, d["m_cx"], d["m_cz"]), 10),
              "max_abs_err": e4}
        bx, ox = critic_cost(B, models[0]["critic_x"], WIDTH)
        bz, oz = critic_cost(B, models[0]["critic_z"], 20)
        bg, og = generator_cost(models[0], B)
        r4["bytes"], r4["ops"] = S * (bx + bz), S * (ox + oz)
        r5["bytes"] = S * (bx + bz + bg - 4 * 3 * B * (WIDTH + 20))
        r5["ops"] = S * (ox + oz + og)
        out["critic_step_full"][S] = bound(r5)
        out["critics_fused_grads"][S] = bound(r4)
        for name, r in (("K1 (2B rows a signal)", rec),
                        ("K5", r5), ("K4", r4)):
            print(f"[fleet] {name} with S={S}: one launch {r['ms']:.5f} ms "
                  f"against {S} single launches {r['single_launches_ms']:.5f}"
                  f" ms; plain {r['plain_ms']:.5f} ms; bound "
                  f"{r['bound_ms']:.6f} ms ({r['bound_by']}); each signal "
                  f"bitwise its single launch; max abs diff to plain "
                  f"{r['max_abs_err']:.3e}")

    # K1 at fleet detection's shape: 9 signals padded to the longest's
    # 2,280 rows, which takes K1's large-tile path
    S, rows = len(FLEET_DETECT_LENS), max(FLEET_DETECT_LENS)
    P = fl.stack_models(fleet_models(device, S, seed0=20))
    g = torch.Generator().manual_seed(7)
    xs = (torch.rand(S, rows, WIDTH, generator=g) * 2 - 1).to(device)
    err = k1_check(xs, P["decoder.hyperbolic_linear.w"],
                   P["decoder.hyperbolic_linear.b"],
                   f"at fleet detection's shape ({S}, {rows}, {WIDTH})")
    out["mobius_linear_detect_shape"] = {"signals": S, "rows_a_signal": rows,
                                         "max_abs_err": err}
    print(f"[fleet] K1 at fleet detection's shape ({S}, {rows}, {WIDTH}): "
          f"one launch, each signal bitwise its single launch; max abs diff "
          f"to plain {err:.3e}")
    return out


def ragged_epoch_card_vs_cpu(device, X):
    """One ragged hyperbolic fleet epoch (640, 448 and 0 windows of ``X``)
    from the same weights and draws on the card (K5 with a signal axis),
    on the card signal by signal (``run_epoch``), on the CPU in f32 (the
    plain path) and on the CPU in f64 (the plain path, the MobiusLinear
    head as its plain composition).

    The gates: the fleet on the card gives each signal its single-model
    epoch on the card within EPOCH_TOL, element by element; the card's
    (S,) epoch metrics lie within METRIC_TOL of the CPU f32's; step
    counters equal; the dummy signal unchanged. The parameters against the
    CPU are information only: element-wise EPOCH_TOL cannot hold there,
    since GAN training turns a last-bit change into up to a step of Adam's
    lr wherever a gradient is near zero, and on these windows the CPU's own
    f32 epoch lies up to 4x EPOCH_TOL from its f64 epoch, at elements that
    differ from run to run. Printed: the largest card - CPU f32 and CPU f32
    - f64 diffs, and how many elements of each lie outside EPOCH_TOL of the
    f64 epoch. Returns (largest card - CPU f32 diff, largest CPU f32 - f64
    diff)."""
    import torch

    from hypad_tpu_torch.data.pipeline import A1_BATCH_SIZE as TRAIN_BATCH
    from hypad_tpu_torch.manifold.kernels import mobius_linear
    from hypad_tpu_torch.models import fleet as mf
    from hypad_tpu_torch.train import fleet as fl
    from hypad_tpu_torch.train import trainer as tr

    Xs, n_real = fl.pad_and_stack([X[:640], X[:448], X[:0]])
    runs = {}
    for label, dev, dtype in (("card", device, torch.float32),
                              ("cpu", torch.device("cpu"), torch.float32),
                              ("cpu_f64", torch.device("cpu"),
                               torch.float64)):
        models = [m.to(dtype) for m in fleet_models(dev, 3, seed0=30)]
        state = fl.init_fleet_state(models, TRAIN_LR, True)
        draws = tr.fleet_epoch_draws([0, 1, 2], 0, n_real, TRAIN_BATCH,
                                     state.params)
        draws = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in draws.items()}
        head = mf.mobius_linear_fused
        if dtype == torch.float64:   # K1's wrapper takes f32 only
            mf.mobius_linear_fused = mobius_linear
        try:
            t0 = time.perf_counter()
            state, metrics = tr.run_fleet_epoch(
                state, torch.as_tensor(Xs, device=dev, dtype=dtype), n_real,
                draws, lr=TRAIN_LR, hyperbolic=True,
                fused_critics="full" if dtype == torch.float32 else False)
            runs[label] = (state, time.perf_counter() - t0, metrics)
        finally:
            mf.mobius_linear_fused = head
    card, cpu, exact = (runs[k][0] for k in ("card", "cpu", "cpu_f64"))
    single_diff = 0.0
    for i in (0, 1):
        model = fleet_models(device, 3, seed0=30)[i]
        one = tr.init_train_state(model, TRAIN_LR, True)
        n = int(n_real[i])
        one, _ = tr.run_epoch(
            one, torch.as_tensor(Xs[i, :n], device=device),
            tr.epoch_draws(tr.epoch_generator(i, 0), n, TRAIN_BATCH, model),
            lr=TRAIN_LR, hyperbolic=True)
        for key, want in one.model.state_dict().items():
            diff = (card.params[key][i] - want).abs()
            if not bool((diff <= EPOCH_TOL["atol"]
                         + EPOCH_TOL["rtol"] * want.abs()).all()):
                fail(f"fleet epoch signal {i} {key} differs from its "
                     f"single-model epoch on the card by "
                     f"{diff.max().item():.3e} (tolerance {EPOCH_TOL})")
            single_diff = max(single_diff, diff.max().item())
    import numpy as np

    card_m, cpu_m = runs["card"][2], runs["cpu"][2]
    for key, want in cpu_m.items():
        # the dummy signal's metrics are 0 / 0
        got, want = card_m[key][:2], want[:2]
        if not np.allclose(got, want, **METRIC_TOL):
            fail(f"fleet epoch {key} {got.tolist()} differs from the CPU's "
                 f"{want.tolist()} beyond {METRIC_TOL}")
    diff_cpu = spread = 0.0
    outside = {"card": 0, "cpu": 0}
    for key, ref in exact.params.items():
        c = card.params[key].cpu().double()
        h = cpu.params[key].double()
        limit = EPOCH_TOL["atol"] + EPOCH_TOL["rtol"] * ref.abs()
        for label, t in (("card", c), ("cpu", h)):
            outside[label] += int(((t - ref).abs() > limit).sum())
        diff_cpu = max(diff_cpu, (c - h).abs().max().item())
        spread = max(spread, (h - ref).abs().max().item())
    for key, p0 in fleet_models(torch.device("cpu"), 3, seed0=30)[2] \
            .state_dict().items():
        if not torch.equal(card.params[key][2].cpu(), p0):
            fail(f"fleet epoch: the dummy signal's {key} changed")
    if not (list(card.opt_gen.step) == list(cpu.opt_gen.step) == [10, 7, 0]):
        fail(f"fleet epoch generator steps {list(card.opt_gen.step)}, "
             f"expected [10, 7, 0]")
    n_el = sum(t[:2].numel() for t in exact.params.values())
    print(f"[fleet] one ragged fleet epoch (640, 448 and 0 windows): on the "
          f"card ({runs['card'][1]:.3f} s) against each signal's single-model"
          f" epoch on the card: largest parameter diff {single_diff:.3e}; "
          f"metrics within {METRIC_TOL} of the CPU's; generator steps [10, "
          f"7, 0]; the dummy signal unchanged. Information: parameters "
          f"against the CPU f32 ({runs['cpu'][1]:.3f} s) {diff_cpu:.3e}, "
          f"the CPU f32 against its f64 epoch {spread:.3e}; elements outside"
          f" EPOCH_TOL of the f64 epoch: card {outside['card']}, CPU f32 "
          f"{outside['cpu']} of {n_el}")
    return diff_cpu, spread


def device_work(fn):
    """(device launches, device ms, host ms) of one ``fn()`` under
    torch.profiler tracing the card's activity only (kernels, copies and
    sets; no host events, which at ~20,000 launches an epoch would take
    longer to collect than the epoch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        fail("torch.profiler recorded no device activity")
    return (len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3,
            wall_ms)


def fleet_epoch_timing(device, X):
    """Warm fleet epochs (hyperbolic, "full") at S = 1, 3 and 9 on the A1
    windows: host seconds (median of 2 after a warm-up), the draws' share
    of them, and all device
    launches of one epoch (torch.profiler), beside a warm single-model
    epoch. Returns the records."""
    import statistics as stats

    import torch

    from hypad_tpu_torch.data.pipeline import A1_BATCH_SIZE as TRAIN_BATCH
    from hypad_tpu_torch.train import fleet as fl
    from hypad_tpu_torch.train import trainer as tr

    Xt = torch.as_tensor(X, device=device)
    model = fleet_models(device, 1)[0]
    state = tr.init_train_state(model, TRAIN_LR, True)
    walls = []
    for e in range(3):
        t0 = time.perf_counter()
        draws = tr.epoch_draws(tr.epoch_generator(SEED, e), X.shape[0],
                               TRAIN_BATCH, model)
        state, _ = tr.run_epoch(state, Xt, draws, lr=TRAIN_LR,
                                hyperbolic=True)
        walls.append(time.perf_counter() - t0)
    single = stats.median(walls[1:])
    print(f"[fleet] warm single-model epoch: median {single:.4f} s (runs "
          f"{walls[1:]})")
    out = {"single_epoch_s": single, "single_runs_s": walls[1:]}
    for S in FLEET_SIZES:
        Xs = Xt[None].expand(S, *Xt.shape).contiguous()
        n_real = [X.shape[0]] * S
        state = fl.init_fleet_state(fleet_models(device, S), TRAIN_LR, True)

        draw_s = []

        def epoch():
            t0 = time.perf_counter()
            draws = tr.fleet_epoch_draws(list(range(S)), state.epoch, n_real,
                                         TRAIN_BATCH, state.params)
            draw_s.append(time.perf_counter() - t0)
            tr.run_fleet_epoch(state, Xs, n_real, draws, lr=TRAIN_LR,
                               hyperbolic=True)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            epoch()   # reads the metrics: synchronises
            walls.append(time.perf_counter() - t0)
        read = zero_counters()
        launches, device_ms, wall_ms = device_work(epoch)
        counts = read()
        busy = device_ms / wall_ms
        rec = {"median_s": stats.median(walls[1:]), "runs_s": walls[1:],
               "draws_median_s": stats.median(draw_s[1:3]),
               "launches": launches, "device_ms": device_ms,
               "busy_share": busy, "kernel_launches": counts,
               "single_epochs_s": S * single}
        out[S] = rec
        print(f"[fleet] warm fleet epoch S={S}: median {rec['median_s']:.4f}"
              f" s (runs {walls[1:]}), of which the draws on the host "
              f"{rec['draws_median_s']:.4f} s, against {S} single epochs "
              f"{S * single:.4f} s; {rec['launches']} device launches an "
              f"epoch (profiler), device work {rec['device_ms']:.3f} ms, "
              f"busy {busy:.4f} of the profiled epoch; kernel counts "
              f"{counts}")
    return out


def detection_of(scores, index, known):
    """detect_univariate's result dict for ``scores`` computed elsewhere:
    the intervals on ``index``, the confusion and the metrics."""
    from hypad_tpu_torch.detect import detector

    intervals = detector._intervals(scores, index, False)
    confusion, metrics = detector._confusion_and_metrics(known, intervals,
                                                         verbose=False)
    return {"scores": scores, "intervals": intervals, "confusion": confusion,
            "metrics": metrics}


def same_zeros_and_nans(got, want, what):
    import numpy as np

    for name, f in (("NaN", np.isnan), ("exact-zero", lambda v: v == 0)):
        if not np.array_equal(f(got), f(want)):
            fail(f"{what}: {name} positions differ at "
                 f"{np.nonzero(f(got) != f(want))[0][:10].tolist()}")


def fleet_detect_timing(device):
    """A 9-signal hyperbolic family (1,320 to 2,280 windows): one
    ``detect_scores_fleet`` (K1 2, K2 1), held per signal against the
    signal's own ``detect_scores`` on the card (``canonical=False``, which
    snaps nothing, as the single call does) and against the CPU's
    ``detect_scores_fleet`` (the default, with the 256-ulp snap): the same
    intervals, confusion and F1, interval scores within what the measured
    score difference allows, NaN and exact-zero positions equal. Then timed
    against 9 ``detect_scores`` calls, warm, windows/s of each (medians of
    5)."""
    import numpy as np
    import torch

    from hypad_tpu_torch.data.pipeline import synthetic_detect_input
    from hypad_tpu_torch.detect.scorer import (
        detect_scores,
        detect_scores_fleet,
    )
    from hypad_tpu_torch.train import fleet as fl

    lens = list(FLEET_DETECT_LENS)
    inputs = [synthetic_detect_input(n, WIDTH, anomaly_len=50, seed=SEED + i)
              for i, n in enumerate(lens)]
    X_list = [x for x, _, _ in inputs]
    models = fleet_models(device, 9, seed0=20)
    P = fl.stack_models(models)
    read = zero_counters()
    got = detect_scores_fleet(P, X_list, True, "mult", device=device)
    torch.cuda.synchronize()
    counts = read()
    if counts != launches_of(mobius_linear=2, kde_argmax=1):
        fail(f"fleet detection launched {counts}, expected K1 2, K2 1")
    if not all(g.shape == (n,) and np.isfinite(g).all()
               for g, n in zip(got, lens)):
        fail("fleet detection: scores of another shape, or not finite")
    unsnapped = detect_scores_fleet(P, X_list, True, "mult", canonical=False,
                                    device=device)
    single = [detect_scores(m, X, True, "mult", fetch_inference=False,
                            device=device)[0]
              for m, X in zip(models, X_list)]
    cpu = torch.device("cpu")
    on_cpu = detect_scores_fleet({k: v.to(cpu) for k, v in P.items()},
                                 X_list, True, "mult", device=cpu)
    rel = {}
    f1 = []
    for i, (_, index, known) in enumerate(inputs):
        index = np.asarray(index)
        for label, a, b in (("single", unsnapped[i], single[i]),
                            ("cpu", got[i], on_cpu[i])):
            what = f"fleet detect signal {i} against {label}"
            same_zeros_and_nans(a, b, what)
            check_same_detection(detection_of(a, index, known),
                                 detection_of(b, index, known), known,
                                 tag=what, atol_from_scores=True)
            rel[label] = max(rel.get(label, 0.0), float(np.max(
                np.abs(a - b) / np.maximum(np.abs(b), 1e-6))))
        f1.append((detection_of(got[i], index, known)["metrics"]
                   or {}).get("f1"))

    def fleet_call():
        detect_scores_fleet(P, X_list, True, "mult", device=device)

    def single_calls():
        for m, X in zip(models, X_list):
            detect_scores(m, X, True, "mult", fetch_inference=False,
                          device=device)
    walls = warm_detect_ms({"fleet": fleet_call, "9 single": single_calls},
                           rounds=5)
    n_win = sum(lens)
    rec = {label: {"median_ms": statistics.median(w),
                   "windows_per_s": n_win / statistics.median(w) * 1e3,
                   "runs_ms": w} for label, w in walls.items()}
    rec.update(windows=n_win, launches=counts,
               max_rel_diff_to_single=rel["single"],
               max_rel_diff_to_cpu=rel["cpu"], f1=f1)
    print(f"[fleet] detection of 9 signals, {n_win} windows: one "
          f"detect_scores_fleet {rec['fleet']['median_ms']:.3f} ms "
          f"({rec['fleet']['windows_per_s']:.0f} windows/s) against 9 "
          f"detect_scores {rec['9 single']['median_ms']:.3f} ms "
          f"({rec['9 single']['windows_per_s']:.0f} windows/s); launches "
          f"{counts}; every signal's intervals, confusion and F1 equal its "
          f"single call's and the CPU fleet's, NaN and zero positions "
          f"equal; scores' max relative diff to the single calls "
          f"{rel['single']:.3e}, to the CPU {rel['cpu']:.3e}; F1 {f1}")
    return rec


def phase_fleet(device):
    """[fleet]: the signal-axis kernels, a 2-epoch hyperbolic seed band
    (S = 3) against ``train_tadgan(seed=i)`` on the card, one ragged fleet
    epoch against the CPU's, and the fleet's epoch and detection timing.
    Returns what it saw."""
    import numpy as np
    import torch

    from hypad_tpu_torch.data.pipeline import (
        A1_BATCH_SIZE as TRAIN_BATCH,
        A1_WINDOWS,
        synthetic_detect_input,
    )
    from hypad_tpu_torch.train import fleet as fl
    from hypad_tpu_torch.train import trainer as tr

    t0 = time.perf_counter()
    kernels = fleet_kernel_checks(device)
    print(f"[time] fleet kernels: {time.perf_counter() - t0:.1f} s")

    X, _, _ = synthetic_detect_input(A1_WINDOWS, WIDTH, anomaly_len=50,
                                     seed=SEED)
    S, n_batches = 3, A1_WINDOWS // TRAIN_BATCH
    kwargs = dict(lr=TRAIN_LR, hyperbolic=True, batch_size=TRAIN_BATCH,
                  n_epochs=2, device=device)
    logs = []
    state = fl.init_fleet_state(fleet_models(device, S), TRAIN_LR, True)
    read = zero_counters()
    t0 = time.perf_counter()
    state = fl.train_fleet(state, [X] * S, seeds=list(range(S)),
                           log_cb=lambda e, m: logs.append(m), **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read()
    print(f"[fleet] seed band S={S}, {A1_WINDOWS} windows, batch "
          f"{TRAIN_BATCH}, 2 epochs, fused_critics='full': {seconds:.3f} s "
          f"(first call); kernel launches {launches}")
    want = launches_of(mobius_linear=2 * n_batches * 2,
                       critic_step_full=tr.N_CRITICS * n_batches * 2)
    if launches != want:
        fail(f"expected launches {want} (one signal's), got {launches}")
    if not all(np.isfinite(v).all() for m in logs for v in m.values()):
        fail(f"a fleet loss is not finite: {logs}")
    worst = 0.0
    for i in range(S):
        single = tr.train_tadgan(fleet_models(device, S)[i], X, seed=i,
                                 **{k: v for k, v in kwargs.items()})
        got = fl.unstack_state(state, i)
        diff, within = state_diff(got, single)
        bit = all(torch.equal(v, single.model.state_dict()[k])
                  for k, v in got.model.state_dict().items())
        print(f"[fleet] band signal {i} against train_tadgan(seed={i}) on the"
              f" card: largest diff {diff:.3e} (parameters and moments), "
              f"bitwise {bit}")
        if not within:
            fail(f"band signal {i} differs from train_tadgan(seed={i}) "
                 f"beyond {EPOCH_TOL}")
        worst = max(worst, diff)

    t0 = time.perf_counter()
    epoch_diff, epoch_spread = ragged_epoch_card_vs_cpu(device, X)
    print(f"[time] fleet ragged epoch, card and CPU: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    epochs = fleet_epoch_timing(device, X)
    print(f"[time] fleet epochs: {time.perf_counter() - t0:.1f} s")
    detect = fleet_detect_timing(device)
    return {"kernels": kernels, "band_launches": launches,
            "k1_detect_shape": kernels.pop("mobius_linear_detect_shape"),
            "band_first_call_s": seconds, "band_max_diff": worst,
            "band_logs": [{k: v.tolist() for k, v in m.items()}
                          for m in logs],
            "epoch_card_vs_cpu_max_abs_diff": epoch_diff,
            "epoch_cpu_f32_vs_f64_max_abs_diff": epoch_spread,
            "epochs": epochs, "detect": detect}


def sweep_inputs(root, signals):
    """NAB-style CSVs under ``root/data`` for ``signals``, of 1,420 to 2,380
    samples (1,320 to 2,280 windows), 21,600 s apart, each with 3
    injected level shifts, and their anomalies.csv. Returns {signal:
    known anomalies}."""
    import numpy as np

    from hypad_tpu_torch.data.pipeline import (
        extract_known_anomalies,
        synthetic_signal,
    )

    data = root / "data"
    data.mkdir(parents=True)
    rows, known = [], {}
    for i, sig in enumerate(signals):
        n = 1320 + 120 * i + WIDTH
        _, values, flags = synthetic_signal(n, anomaly_len=50,
                                            seed=SEED + 10 + i)
        stamps = 1_400_000_000 + 21600 * np.arange(n)
        (data / f"{sig}.csv").write_text("timestamp,value\n" + "".join(
            f"{t},{float(v)!r}\n" for t, v in zip(stamps, values)))
        known[sig] = np.stack(extract_known_anomalies(flags, stamps), axis=1)
        rows.append(f'{sig},"' + json.dumps(
            [[int(a), int(b)] for a, b in known[sig]]) + '"')
    (data / "anomalies.csv").write_text("signal,events\n"
                                        + "\n".join(rows) + "\n")
    return known


def largest_window_scale(scores, multivariate=False):
    """The largest (mean + std) over the detector's threshold windows of
    ``scores``: the denominator of an interval score."""
    return max(abs(w.mean() + w.std())
               for w in threshold_windows(scores, multivariate))


def check_same_cell(got, want, known, tag, multivariate=False):
    """One grid cell of two detections: ``check_same_detection`` where the
    intervals' bounds agree. Where they do not, every interval found on
    one side only must be a threshold tie, which a last-bit change of the
    scores can add or drop: its margin over the threshold (its score times
    the largest mean + std of the threshold windows) at most 6 times the
    largest absolute score difference d (the max moves by at most d, the
    threshold mean + 4 std by at most 5 d); then the cell's confusion and
    F1 may differ, and are printed. Returns (f1, tied)."""
    import numpy as np

    iv, want_iv = (np.asarray(r["intervals"]).reshape(-1, 3)
                   for r in (got, want))
    if iv.shape == want_iv.shape and np.array_equal(iv[:, :2],
                                                    want_iv[:, :2]):
        return check_same_detection(got, want, known, tag=tag,
                                    atol_from_scores=True,
                                    multivariate=multivariate,
                                    verbose=False), False
    d = float(np.max(np.abs(got["scores"] - want["scores"])))
    scale = largest_window_scale(want["scores"], multivariate)
    a = {tuple(float(x) for x in r[:2]): float(r[2]) for r in iv}
    b = {tuple(float(x) for x in r[:2]): float(r[2]) for r in want_iv}
    only = ([(k, v, "card") for k, v in a.items() if k not in b]
            + [(k, v, "CPU") for k, v in b.items() if k not in a])
    for bounds, score, side in only:
        if not abs(score) * scale <= 6 * d:
            fail(f"[{tag}] interval {list(bounds)} (score {score}) found on "
                 f"the {side} only is no threshold tie: margin "
                 f"{abs(score) * scale:.3e} > 6 x the score difference "
                 f"{d:.3e}; card {iv.tolist()}, CPU {want_iv.tolist()}")
    print(f"[{tag}] threshold tie: {[(list(k), v, side) for k, v, side in only]}"
          f" on one side only, each margin <= 6 x the largest score "
          f"difference {d:.3e} (window scale {scale:.3e}); confusion "
          f"{got['confusion']} against {want['confusion']}, F1 "
          f"{(got['metrics'] or {}).get('f1')} against "
          f"{(want['metrics'] or {}).get('f1')}")
    return (got["metrics"] or {}).get("f1"), True


def check_same_grid(got, want, known, tag, multivariate=False):
    """Fail unless two grids of detection results ({cell: result}) hold the
    same cells in the same order, each with the same intervals, confusion
    and F1 up to threshold ties (``check_same_cell``). Returns ({cell:
    f1}, [tied cells])."""
    if list(got) != list(want):
        fail(f"{tag}: cells {list(got)} differ from {list(want)}")
    f1s, tied = {}, []
    for cell in want:
        f1s[cell], tie = check_same_cell(got[cell], want[cell], known,
                                         f"{tag} {cell}", multivariate)
        if tie:
            tied.append(cell)
    return f1s, tied


def grid_files(cfg_path, signals):
    """The lines of each run's grid_results.csv ({signal: lines}) and of
    the family's sweep_grid.csv (key None) that a sweep of the config at
    ``cfg_path`` wrote."""
    from hypad_tpu_torch.utils.config import load_config, run_dir

    out = {}
    for sig in signals:
        p = load_config(str(cfg_path))
        p.signal = sig
        path = Path(run_dir(p))
        out[sig] = (path / "grid_results.csv").read_text().splitlines()
        if sig == signals[0]:
            out[None] = (path / "sweep_grid.csv").read_text().splitlines()
    return out


def check_sweep_grid(card_runs, cpu_runs, card_files, cpu_files, known,
                     tag, multivariate=False):
    """A fleet-grid sweep on the card against its ``--device cpu`` run:
    every run's cells (``check_same_grid``), every grid_results.csv and the
    sweep_grid.csv line for line but for the rows of cells that hold a
    threshold tie, which are printed. Returns ({signal: {cell: f1}},
    [(signal, cell) tied])."""
    if [r[:2] for r in card_runs] != [r[:2] for r in cpu_runs]:
        fail(f"{tag}: runs {[r[:2] for r in card_runs]} differ from the "
             f"CPU's {[r[:2] for r in cpu_runs]}")
    f1s, tied = {}, []
    for (sig, _, got), (_, _, want) in zip(card_runs, cpu_runs):
        f1s[sig], t = check_same_grid(got, want, known[sig], f"{tag} {sig}",
                                      multivariate)
        tied += [(sig, cell) for cell in t]

    def tie_row(key, line):
        fields = line.split(",")
        if key is None:   # sweep_grid.csv: signal, seed, rec_error, comb, f1
            return (fields[0], ((fields[2] or None), fields[3])) in tied
        return (key, ((fields[0] or None), fields[1])) in tied

    for key, lines in card_files.items():
        other = cpu_files[key]
        what = "sweep_grid.csv" if key is None else \
            f"{key}'s grid_results.csv"
        if len(lines) != len(other) or lines[0] != other[0]:
            fail(f"{tag}: the card's {what} differs from the CPU's in its "
                 f"rows or columns")
        for a, b in zip(lines[1:], other[1:]):
            if a != b and not tie_row(key, b):
                fail(f"{tag}: the card's {what} row {a!r} differs from the "
                     f"CPU's {b!r}")
            if a != b:
                print(f"[{tag}] {what}: {a!r} (card) against {b!r} (CPU), "
                      f"a threshold tie")
    print(f"[{tag}] {len(card_runs)} runs x {len(card_runs[0][2])} cells: "
          f"intervals, confusion and F1 equal to the CPU's in every cell but "
          f"{len(tied)} threshold tie(s) {tied}; every grid_results.csv and "
          f"sweep_grid.csv ({len(card_files[None])} lines) equal but the "
          f"tied cells' rows")
    return f1s, tied


def phase_sweep(device, card):
    """[sweep]: ``sweep`` of configs/nab_sweep.yaml (9 signals, cut to 1
    epoch) on the card through the CLI, then ``sweep --detect-only
    --device cpu`` on the card's checkpoints: every signal's intervals,
    confusion and F1 equal, scores within what the measured relative score
    difference allows (``interval_score_atol``); ``sweep --detect-only``
    on the card (the same detections), ``detect`` re-entering the first
    signal's run directory, and ``--signals`` x ``--seeds 0,1`` (four runs
    under seed_0/ and seed_1/), each one K2 launch. Returns (launches,
    info)."""
    import shutil
    import tempfile

    from hypad_tpu_torch.detect import detector
    from hypad_tpu_torch.utils.config import (
        dump_flat_yaml,
        load_config,
        parse_flat_yaml,
        run_dir,
    )

    cfg = parse_flat_yaml(Path("configs/nab_sweep.yaml").read_text())
    signals = cfg["signals"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_"))
    seen = []
    real_detect = detector.detect

    def recording_detect(params, *args, **kw):
        result = real_detect(params, *args, **kw)
        seen.append((params.signal, result))
        return result

    try:
        known = sweep_inputs(root, signals)
        cfg.update(epochs=1, data_root=str(root / "data"),
                   output_root=str(root / "out"), devices=1)
        card_cfg = root / "sweep_card.yaml"
        card_cfg.write_text(dump_flat_yaml(cfg))
        cpu_cfg = root / "sweep_cpu.yaml"
        cpu_cfg.write_text(dump_flat_yaml(dict(
            cfg, filename="cpu_" + cfg["filename"])))
        detector.detect = recording_detect
        results, launches = run_cli(["sweep", "--config", str(card_cfg)],
                                    "sweep", card)
        card_runs = dict(seen)
        seen.clear()
        cpu_results, _ = run_cli(["sweep", "--detect-only", "--config",
                                  str(cpu_cfg), "--device", "cpu"],
                                 "sweep_detect_only_cpu", card)
        cpu_runs = dict(seen)
        seen.clear()
        _, again_launches = run_cli(["sweep", "--detect-only", "--config",
                                     str(card_cfg)], "sweep_detect_only",
                                    card)
        card_again = dict(seen)
        seen.clear()
        first = load_config(str(card_cfg))
        first.signal = signals[0]
        _, reentry_launches = run_cli(
            ["detect", "--config", str(Path(run_dir(first)) / "config.yaml")],
            "sweep_detect_reentry", card)
        reentry = dict(seen)
        # the fleet grid: every (rec_error x combination) cell of the 9
        # signals in one call, on the card, then on the CPU
        grid_flags = ["--rec-errors", "all", "--combinations", "all"]
        grid_card, grid_launches = run_cli(
            ["sweep", "--detect-only", "--config", str(card_cfg),
             *grid_flags], "sweep_grid", card)
        card_files = grid_files(card_cfg, signals)
        grid_cpu, _ = run_cli(
            ["sweep", "--detect-only", "--config", str(cpu_cfg), "--device",
             "cpu", *grid_flags], "sweep_grid_cpu", card)
        cpu_files = grid_files(cpu_cfg, signals)
        grid_own, grid_timing = sweep_grid_own_and_timing(
            device, card_cfg, signals, root / "own")
        band, band_launches = run_cli(
            ["sweep", "--config", str(card_cfg), "--signals",
             ",".join(signals[:2]), "--seeds", "0,1"], "sweep_band", card)
        band_dirs = []
        for sig, sd, _ in band:
            p = load_config(str(card_cfg))
            p.signal, p.output_root = sig, str(root / "out" / f"seed_{sd}")
            band_dirs.append(all((Path(run_dir(p)) / name).exists() for name
                                 in ("config.yaml", "state_final.pt",
                                     "anomalies.csv")))
    finally:
        detector.detect = real_detect
        shutil.rmtree(root, ignore_errors=True)
    if [r[0] for r in results] != signals or len(card_runs) != 9:
        fail(f"sweep ran {[r[0] for r in results]}, expected {signals}")
    for what, n in (("sweep", launches), ("sweep --detect-only",
                                          again_launches),
                    ("detect re-entering a sweep run", reentry_launches),
                    ("sweep --seeds", band_launches)):
        if n != launches_of(kde_argmax=1):
            fail(f"{what} (Euclidean, fused_critics false) launched {n}; "
                 "expected one K2 launch (the detection), no K1")
    f1s = {}
    for sig in signals:
        f1s[sig] = check_same_detection(card_runs[sig], cpu_runs[sig],
                                        known[sig], tag=f"sweep {sig}",
                                        atol_from_scores=True)
        check_same_detection(card_again[sig], card_runs[sig], known[sig],
                             tag=f"sweep --detect-only {sig}")
    if [r[2] for r in results] != [r[2] for r in cpu_results]:
        fail("the CPU's detect-only F1s differ from the card's sweep's")
    if grid_launches != launches_of(kde_argmax=1):
        fail(f"sweep --rec-errors all --combinations all launched "
             f"{grid_launches}; expected one K2 launch, no K1")
    grid_f1, grid_ties = check_sweep_grid(grid_card, grid_cpu, card_files,
                                          cpu_files, known, "sweep grid")
    own_ties = []
    for sig, _, cells in grid_card:
        own_ties += [(sig, c) for c in check_same_grid(
            cells, grid_own[sig], known[sig],
            f"sweep grid {sig} against its own detect_grid")[1]]
    print(f"[sweep grid] each signal's cells equal its own card "
          f"detect_grid's but {len(own_ties)} threshold tie(s) {own_ties} "
          f"(the ranking is in cli_sweep_grid.log)")
    check_same_detection(reentry[signals[0]], card_runs[signals[0]],
                         known[signals[0]], tag="detect re-entry",
                         atol_from_scores=True)
    want = [(sig, sd) for sig in signals[:2] for sd in (0, 1)]
    if [(r[0], r[1]) for r in band] != want or not all(band_dirs):
        fail(f"sweep --signals --seeds ran {[(r[0], r[1]) for r in band]} "
             f"with run directories {band_dirs}; expected {want}, each with "
             "config.yaml, state_final.pt and anomalies.csv under seed_k/")
    print(f"[sweep] 9 signals: the card's intervals, confusion and F1 equal "
          f"the CPU's --detect-only on every one, and the card's "
          f"--detect-only; detect re-entering {signals[0]}'s run directory "
          f"agrees; --signals x --seeds ran {want} under seed_0/ and "
          f"seed_1/; F1 {f1s}")
    return launches, grid_launches, {
        "f1": f1s, "band": [list(r) for r in band],
        "grid_f1": {sig: {"/".join(filter(None, c)): f for c, f in
                          cells.items()} for sig, cells in grid_f1.items()},
        "grid_threshold_ties_card_vs_cpu": [[s_, "/".join(filter(None, c))]
                                            for s_, c in grid_ties],
        "grid_threshold_ties_vs_own_detect_grid": [
            [s_, "/".join(filter(None, c))] for s_, c in own_ties],
        "grid_timing": grid_timing}


def sweep_grid_own_and_timing(device, cfg_path, signals, own_dir):
    """Each signal's own card ``detect_grid`` of every cell from its
    checkpoint ({signal: cells}), then the warm fleet grid
    (``detect_scores_fleet_grid``, one call) against the S
    ``detect_scores_grid`` calls it replaces, in turns: medians of 5
    rounds and windows/s."""
    import statistics as stats

    from hypad_tpu_torch.data.registry import dataset_selection
    from hypad_tpu_torch.detect import detector
    from hypad_tpu_torch.detect import scorer as sc
    from hypad_tpu_torch.train import fleet as fl
    from hypad_tpu_torch.utils import checkpoint as ck
    from hypad_tpu_torch.utils.config import load_config, run_dir

    own, models, X_list = {}, [], []
    for sig in signals:
        p = load_config(str(cfg_path))
        p.signal = sig
        model = ck.restore_state(run_dir(p), "final", device).model
        _, test_data, _ = dataset_selection(p)
        own[sig] = detector.detect_grid(
            p, model, test_data, str(own_dir / sig),
            rec_errors=list(sc.REC_ERRORS),
            combinations=list(sc.EUCL_COMBOS), device=device)
        models.append(model)
        X_list.append(test_data.X)
    stacked = fl.stack_models(models)
    recs, combos = list(sc.REC_ERRORS), list(sc.EUCL_COMBOS)
    calls = {
        "fleet grid": lambda: sc.detect_scores_fleet_grid(
            stacked, X_list, False, combos, recs, device=device),
        f"{len(signals)} detect_scores_grid": lambda: [
            sc.detect_scores_grid(m, X, False, combos, recs, device=device)
            for m, X in zip(models, X_list)]}
    n_win = sum(len(X) for X in X_list)
    timing = {}
    for label, walls in warm_detect_ms(calls, rounds=5).items():
        median = stats.median(walls)
        timing[label] = {"median_ms": median,
                         "windows_per_s": n_win / median * 1e3,
                         "runs_ms": walls}
        print(f"[sweep grid] warm {label}, {len(signals)} signals / {n_win} "
              f"windows x {len(recs) * len(combos)} cells: median "
              f"{median:.3f} ms, {n_win / median * 1e3:.0f} windows/s (runs "
              f"in ms: {[round(w, 3) for w in walls]})")
    return own, timing


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


# ---------------------------------------------------------------------------
# [mv]: multivariate HypAD at the published feature counts
# ---------------------------------------------------------------------------

MV_ROWS = 50_000          # test rows of the main path and the CASAS width
MV_TRAIN_ROWS = 8_000     # WADI-format training rows
WADI_F, SWAT_F, CASAS_F = 123, 51, 150
MV_WIDE = (CASAS_F, 256)  # the wide instances' checks
CASAS_RESIDENTS = ("kitchen", "bedroom", "bathroom")
CASAS_ROWS = 2_000        # each resident's test rows, and the normal rows
MV_BATCH = 64             # configs/multivariate.yaml
MV_REPEATS = 20           # WADI detections held bitwise against the first


def mv_rows(n, F, seed, run_len=200):
    """Seeded (n, F) rows in the shape of a plant's sensors (random walks
    around per-feature sines) with three injected level-shift runs of
    ``run_len`` rows on a third of the features; returns (rows float64,
    labels (n,) int)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    X = (np.sin(2 * np.pi * t / rng.uniform(50, 500, F))
         + 0.05 * rng.standard_normal((n, F)).cumsum(axis=0) / np.sqrt(n)
         + 0.05 * rng.standard_normal((n, F)))
    y = np.zeros(n, int)
    for k, start in enumerate(np.linspace(0.2 * n, 0.8 * n, 3).astype(int)):
        X[start:start + run_len, k::3] += 3.0 if k % 2 == 0 else -3.0
        y[start:start + run_len] = 1
    return X, y


def write_wadi(root, train_rows, test_rows, F, seed=SEED):
    """A WADI-format pair under root/WADI_downsampled: WADI_train.csv (every
    column a feature) and WADI_test_mine.csv (Time, the features, label),
    as reference utils/dataloader_multivariate.py:91-106 reads them.
    Returns the test labels."""
    import numpy as np

    base = root / "WADI_downsampled"
    base.mkdir(parents=True, exist_ok=True)
    names = ",".join(f"f{i}" for i in range(F))
    train, _ = mv_rows(train_rows, F, seed)
    np.savetxt(base / "WADI_train.csv", train, fmt="%.7g", delimiter=",",
               header=names, comments="")
    test, y = mv_rows(test_rows, F, seed + 1)
    table = np.column_stack([np.arange(test_rows), test, y])
    np.savetxt(base / "WADI_test_mine.csv", table,
               fmt=["%d"] + ["%.7g"] * F + ["%d"], delimiter=",",
               header=f"Time,{names},label", comments="")
    return y


def write_casas(root, residents, rows, F, seed=SEED):
    """A CASAS family under root/DATASETS/CASAS: normal_sequences.pt and,
    per resident, POINTS/{r}/{r}_sequences_id1.pt and its ground truth.
    Returns {resident: labels}."""
    import torch

    base = root / "DATASETS" / "CASAS"
    base.mkdir(parents=True, exist_ok=True)
    normal, _ = mv_rows(rows, F, seed, run_len=0)
    torch.save(torch.tensor(normal.reshape(-1, 4, F), dtype=torch.float32),
               base / "normal_sequences.pt")
    labels = {}
    for i, r in enumerate(residents):
        X, y = mv_rows(rows, F, seed + 10 + i, run_len=60)
        points = base / "POINTS" / r
        points.mkdir(parents=True, exist_ok=True)
        torch.save(torch.tensor(X, dtype=torch.float32),
                   points / f"{r}_sequences_id1.pt")
        torch.save(torch.tensor(y, dtype=torch.float32),
                   points / f"{r}_groundtruth_id1.pt")
        labels[r] = y
    return labels


def short_name(name):
    """A profiler kernel name without its namespace, return type and
    arguments, e.g. ``mobius_linear_wide_kernel<19, 2>``."""
    import re

    m = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
    return m.group(1) if m else name


def instance_named(name):
    """The instance a profiler kernel name is: "xwide" (an
    ``_xwide_kernel``, ``critic_step_kernel<0>``), "wide" (a
    ``_wide_kernel``, ``critic_step_kernel<256>``) or "narrow"."""
    if "_xwide_kernel" in name or "critic_step_kernel<0>" in name:
        return "xwide"
    if "_wide_kernel" in name or "critic_step_kernel<256>" in name:
        return "wide"
    return "narrow"


def kernel_named(names, kind):
    """Whether ``names`` (``kernels_launched``) is one launch, of the
    instance ``kind`` ("narrow", "wide" or "xwide")."""
    return len(names) == 1 and instance_named(names[0]) == kind


def mv_kernel_checks(device):
    """The wide instances against their plain versions at F = 150 and 256,
    at the multivariate path's shapes, and one case of width at most 128
    launching the narrow instance (by the profiler's kernel names).
    Returns the largest errors and the tie flips."""
    import torch

    from hypad_tpu_torch.manifold import kernels as mk
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch._build import instance
    from hypad_tpu_torch.ops.kde import (
        kde_argmax_rows_and_use,
        kde_argmax_rows_v2_and_use,
    )
    from hypad_tpu_torch.ops.kde_kernel import (
        kde_argmax_kernel,
        kde_argmax_v2_kernel,
    )
    from hypad_tpu_torch.ops.unroll import masked_median
    from hypad_tpu_torch.profile_kernels import (
        check_k1,
        k2_case,
        near_tie_flips,
        same_values,
    )

    out = {"k1_err": 0.0, "flips": {"kde_argmax": 0, "kde_argmax_v2": 0},
           "k5_err": 0.0, "k4_err": 0.0}
    # K1: the generator step's 2B and B rows and a detect call's 50,000,
    # at the wide widths and at the main path's F = 123 (narrow instance)
    for F, rows in [(F, r) for F in MV_WIDE + (WADI_F,)
                    for r in (2 * MV_BATCH, MV_BATCH, MV_ROWS)]:
        gen = torch.Generator().manual_seed(rows + F)
        head = init_tadgan(gen, F, hyperbolic=True,
                           device=device)["decoder"].hyperbolic_linear
        w, b = head.w.detach(), head.b.detach()
        x = (torch.rand(rows, F, generator=gen) * 2 - 1).to(device)
        names = kernels_launched(lambda: mk.mobius_linear_kernel(x, w, b))
        if not kernel_named(names, mk.instance(F, F)):
            fail(f"K1 at ({rows}, {F}) launched {names}")
        err, _ = check_k1(mk.mobius_linear_kernel(x, w, b), x, w, b,
                          case=f"({rows}, {F})")
        out["k1_err"] = max(out["k1_err"], err)
        print(f"[mv] K1 mobius_linear ({rows}, {F}) x ({F}, {F}): max abs "
              f"diff {err:.3e}; launches {short_name(names[0])}")
    # K2 and K3 on a detect call's anti-diagonal rows, T = 50,000 + F - 1
    for F, runs in [(F, 40) for F in MV_WIDE] + [(WADI_F, 40)]:
        vals, mask = k2_case(MV_ROWS, F, runs, device)
        case = f"T={vals.shape[0]} W={F}"
        values = {}
        for name, kernel, plain in (
                ("kde_argmax", kde_argmax_kernel, kde_argmax_rows_and_use),
                ("kde_argmax_v2", kde_argmax_v2_kernel,
                 kde_argmax_rows_v2_and_use)):
            names = kernels_launched(lambda: kernel(vals, mask))
            if not kernel_named(names, instance(F)):
                fail(f"{name} at {case} launched {names}")
            value, use = kernel(vals, mask)
            want, want_use = plain(vals, mask)
            if not torch.equal(use, want_use):
                fail(f"{name} use flags differ from the plain version's at "
                     f"{case}")
            if not same_values(value[~use],
                               masked_median(vals, mask)[~use]):
                fail(f"{name} fallback rows differ from masked_median at "
                     f"{case}")
            flips = near_tie_flips(value[use], want[use], vals[use],
                                   mask[use])
            out["flips"][name] += flips
            values[name] = value
            print(f"[mv] {name} {case}: use flags bitwise; "
                  f"{int((~use).sum())} fallback rows bitwise masked_median;"
                  f" {flips} flips against the plain version, each a float64"
                  f" density tie; launches {short_name(names[0])}")
        cross = near_tie_flips(values["kde_argmax_v2"][use],
                               values["kde_argmax"][use], vals[use],
                               mask[use])
        print(f"[mv] K3 against K2 {case}: {cross} flips, each a tie")
    # K5 and K4 at B = 64: one signal, then three in one launch
    for F in MV_WIDE + (WADI_F,):
        e5, e4, names, k4_names = critic_instance_check(device, F, "mv")
        for label, n in (("K5", names), ("K4", k4_names)):
            if not kernel_named(n, instance(F)):
                fail(f"{label} at F={F} launched {n}")
        out["k5_err"], out["k4_err"] = (max(out["k5_err"], e5),
                                        max(out["k4_err"], e4))
        print(f"[mv] K5 critic_step_full F={F} B={MV_BATCH}: max abs diff "
              f"{e5:.3e}; K4 {e4:.3e}; S=3 in one launch within the same "
              f"tolerances, each signal bitwise its own launch; launches "
              f"{short_name(names[0])}")
    return out


XWIDE = (300, 512, 1024)    # the any-width instances' checks
XWIDE_KDE_ROWS = {300: 4096, 512: 4096, 1024: 2048}   # T of K2 / K3
XWIDE_PLAIN_BLOCK = 128     # the plain K2's rows a block: (128, W, W) f32


def critic_instance_check(device, F, tag):
    """K5 and K4 at B = 64 and width F, one signal and three in one launch,
    against their plain versions (two launches bitwise equal, each signal
    of the three bitwise its own launch); returns (K5 err, K4 err, the
    profiler's names of K5's and of K4's launch)."""
    tols = (K5_TOL, K4_TOL)
    import torch

    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.train import critic_kernel as ck
    from hypad_tpu_torch.train import fleet as fl

    model, x, d = critic_case(device, True, MV_BATCH, F)
    names = kernels_launched(
        lambda: ck.critic_step_fused_full(model, x, d, True))
    got = ck.critic_step_fused_full(model, x, d, True)
    e5 = critic_err(got, ck.critic_step_plain(model, x, d, True), tols[0],
                    f"{tag} K5 (F={F})")
    if not bitwise_equal(got, ck.critic_step_fused_full(model, x, d, True)):
        fail(f"{tag}: two K5 launches differ at F={F}")
    bigx, bigz = ck.critic_step_inputs(model, x, d, True)
    args = (model["critic_x"], model["critic_z"], bigx, bigz, d["m_cx"],
            d["m_cz"])
    k4_names = kernels_launched(lambda: ck.critics_fused_grads(*args))
    e4 = critic_err(ck.critics_fused_grads(*args),
                    ck.critics_fused_grads_plain(*args), tols[1],
                    f"{tag} K4 (F={F})")
    cases = [critic_case(device, True, MV_BATCH, F, seed=i)
             for i in range(3)]
    P = fl.stack_models([c[0] for c in cases])
    xs = torch.stack([c[1] for c in cases])
    ds = {k: torch.stack([c[2][k] for c in cases]) for k in cases[0][2]}
    got3 = ck.critic_step_fused_full_fleet(P, xs, ds, True)
    critic_err(got3, ck.critic_step_fleet_plain(P, xs, ds, True), tols[0],
               f"{tag} K5 S=3 (F={F})")
    for i, c in enumerate(cases):
        one = ck.critic_step_fused_full(c[0], c[1], c[2], True)
        if not (torch.equal(got3[0][i], one[0]) and all(
                torch.equal(got3[j][k][i], one[j][k])
                for j in (2, 3) for k in one[j])):
            fail(f"{tag}: K5 S=3 signal {i} differs from its own launch "
                 f"(F={F})")
    bx3, bz3 = ck.critic_step_inputs_fleet(P, xs, ds, True)
    critic_err(ck.critics_fused_grads_fleet(P, bx3, bz3, ds["m_cx"],
                                            ds["m_cz"]),
               ck.critics_fused_grads_fleet_plain(P, bx3, bz3, ds["m_cx"],
                                                  ds["m_cz"]),
               tols[1], f"{tag} K4 S=3 (F={F})")
    return e5, e4, names, k4_names


def xwide_kernel_checks(device):
    """The any-width instances (widths above 256) against their plain
    versions, each named by the profiler: K1 at (64, W), (128, W) and
    (4,096, W) and K2 and K3 on T rows (XWIDE_KDE_ROWS: 4,096 at 300 and
    512, 2,048 at 1,024, the plain K2 taking XWIDE_PLAIN_BLOCK rows at a
    time so that its (rows, W, W) intermediate stays at 0.5 GB) for W =
    300, 512 and 1,024, with a constant run and NaNs at 300; K5 and K4 at
    B = 64, W = 300 and 512, one signal and three in one launch. Returns
    the largest errors and the tie flips."""
    import functools

    import torch

    from hypad_tpu_torch.manifold import kernels as mk
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.ops.kde import (
        kde_argmax_rows_and_use,
        kde_argmax_rows_v2_and_use,
    )
    from hypad_tpu_torch.ops.kde_kernel import (
        kde_argmax_kernel,
        kde_argmax_v2_kernel,
    )
    from hypad_tpu_torch.ops.unroll import masked_median
    from hypad_tpu_torch.profile_kernels import (
        check_k1,
        k2_case,
        near_tie_flips,
        same_values,
    )

    out = {"k1_err": 0.0, "flips": {"kde_argmax": 0, "kde_argmax_v2": 0},
           "k5_err": 0.0, "k4_err": 0.0, "names": {}}
    for F in XWIDE:
        for rows in (MV_BATCH, 2 * MV_BATCH, 4096):
            gen = torch.Generator().manual_seed(rows + F)
            head = init_tadgan(gen, F, hyperbolic=True,
                               device=device)["decoder"].hyperbolic_linear
            w, b = head.w.detach(), head.b.detach()
            x = (torch.rand(rows, F, generator=gen) * 2 - 1).to(device)
            launched = ""
            if rows == MV_BATCH:   # one trace a width
                names = kernels_launched(
                    lambda: mk.mobius_linear_kernel(x, w, b))
                if not kernel_named(names, "xwide"):
                    fail(f"K1 at ({rows}, {F}) launched {names}")
                out["names"]["mobius_linear"] = short_name(names[0])
                launched = f"; launches {short_name(names[0])}"
            err, _ = check_k1(mk.mobius_linear_kernel(x, w, b), x, w, b,
                              case=f"({rows}, {F})")
            out["k1_err"] = max(out["k1_err"], err)
            print(f"[xwide] K1 mobius_linear ({rows}, {F}) x ({F}, {F}): "
                  f"max abs diff {err:.3e}{launched}")
    cases = [(F, 0, False) for F in XWIDE] + [(300, 10 + 300 + 400, False),
                                              (300, 0, True)]
    for F, runs, nans in cases:
        T = XWIDE_KDE_ROWS[F]
        vals, mask = k2_case(T - F + 1, F, runs, device, nans)
        case = (f"T={vals.shape[0]} W={F}"
                f"{' constant run' if runs else ''}{' NaNs' if nans else ''}")
        values = {}
        for name, kernel, plain in (
                ("kde_argmax", kde_argmax_kernel, functools.partial(
                    kde_argmax_rows_and_use, block=XWIDE_PLAIN_BLOCK)),
                ("kde_argmax_v2", kde_argmax_v2_kernel,
                 kde_argmax_rows_v2_and_use)):
            launched = ""
            if not (runs or nans):   # one trace a width
                names = kernels_launched(lambda: kernel(vals, mask))
                if not kernel_named(names, "xwide"):
                    fail(f"{name} at {case} launched {names}")
                out["names"][name] = short_name(names[0])
                launched = f"; launches {short_name(names[0])}"
            value, use = kernel(vals, mask)
            want, want_use = plain(vals, mask)
            if not torch.equal(use, want_use):
                fail(f"{name} use flags differ from the plain version's at "
                     f"{case}")
            if not same_values(value[~use], masked_median(vals, mask)[~use]):
                fail(f"{name} fallback rows differ from masked_median at "
                     f"{case}")
            flips = near_tie_flips(value[use], want[use], vals[use],
                                   mask[use])
            out["flips"][name] += flips
            values[name] = value
            print(f"[xwide] {name} {case}: use flags bitwise; "
                  f"{int((~use).sum())} fallback rows bitwise masked_median;"
                  f" {flips} flips against the plain version, each a float64"
                  f" density tie{launched}")
        cross = near_tie_flips(values["kde_argmax_v2"][use],
                               values["kde_argmax"][use], vals[use],
                               mask[use])
        print(f"[xwide] K3 against K2 {case}: {cross} flips, each a tie")
    for F in XWIDE[:2]:
        e5, e4, names, k4_names = critic_instance_check(device, F, "xwide")
        for label, n in (("K5", names), ("K4", k4_names)):
            if not kernel_named(n, "xwide"):
                fail(f"{label} at F={F} launched {n}")
        out["names"]["critic_step_full"] = short_name(names[0])
        out["names"]["critics_fused_grads"] = short_name(k4_names[0])
        out["k5_err"], out["k4_err"] = (max(out["k5_err"], e5),
                                        max(out["k4_err"], e4))
        print(f"[xwide] K5 critic_step_full F={F} B={MV_BATCH}: max abs diff "
              f"{e5:.3e}; K4 {e4:.3e}; S=3 in one launch within the same "
              f"tolerances, each signal bitwise its own launch; launches "
              f"{short_name(names[0])}")
    return out


def check_reentry(state, path, trained, detections, device):
    """Fail unless ``state_final.pt`` in ``path`` holds ``state``'s weights
    bit for bit and every card detection from it (``detections``, {name:
    result}) gives train's own scores bit for bit: one checkpoint, one card,
    one program."""
    import numpy as np
    import torch

    from hypad_tpu_torch.utils import checkpoint as ck

    saved = ck.restore_state(path, "final", device).model.state_dict()
    live = state.model.state_dict()
    differ = [k for k, v in live.items() if not torch.equal(v, saved[k])]
    strided = [k for k, v in live.items() if not v.is_contiguous()]
    print(f"[mv wadi re-entry] state_final.pt against the trained weights: "
          f"{len(live) - len(differ)} of {len(live)} tensors bitwise; "
          f"{len(strided)} non-contiguous in the trainer {strided}")
    if differ:
        fail(f"state_final.pt differs from the trained weights in {differ}")
    want = trained["scores"]
    for name, result in detections.items():
        got = result["scores"]
        off = np.flatnonzero(got != want)
        print(f"[mv wadi re-entry] {name} from state_final.pt against "
              f"train's own scores: {len(off)} of {len(want)} differ, max "
              f"abs diff {float(np.max(np.abs(got - want), initial=0)):.3e}"
              f"{'' if not len(off) else f', first at {off[:8].tolist()}'}")
        if len(off):
            fail(f"WADI {name} from the checkpoint differs from train's own")


def mv_detection(scores, labels):
    """detect's multivariate epilogue on arrays: intervals over the
    timesteps (0.2 / 0.1 windows, padding 200), the ground truth from
    ``casas_anomalies``, confusion and metrics."""
    import numpy as np

    from hypad_tpu_torch.data.multivariate import MultivariateData
    from hypad_tpu_torch.detect import detector

    known = detector._multivariate_ground_truth(
        MultivariateData(np.zeros((len(labels), 1)), y=labels))
    intervals = detector._intervals(scores, None, True)
    confusion, metrics = detector._confusion_and_metrics(known, intervals,
                                                         verbose=False)
    return {"scores": np.asarray(scores), "intervals": intervals,
            "confusion": confusion, "metrics": metrics}, known


def phase_mv(device, card):
    """[mv]: multivariate HypAD (the wide kernel instances are checked by
    ``mv_kernel_checks``, earlier). The main path, ``cli train`` (1 epoch)
    then ``detect``
    on a WADI-format pair at configs/multivariate.yaml's widths (F = 123),
    and ``detect --device cpu`` on the card's checkpoint; the CASAS width
    (F = 150): ``detect_scores(multivariate=True)`` at 50,000 rows, card
    against CPU, and one ``detect_grid`` over the multivariate
    combinations; a ``sweep`` of 3 CASAS residents (fused_critics "full")
    and its ``--detect-only --device cpu``; the warm epoch at the WADI
    width and the detect rows/s at 50,000 x {51, 123, 150}. Returns
    ({path: launches}, info)."""
    import shutil
    import statistics as stats
    import tempfile

    import numpy as np
    import torch

    from hypad_tpu_torch.data.multivariate import MultivariateData, load_wadi
    from hypad_tpu_torch.detect import detector
    from hypad_tpu_torch.detect import scorer as sc
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.train import trainer as tr
    from hypad_tpu_torch.utils.config import (
        dump_flat_yaml,
        load_config,
        parse_flat_yaml,
        run_dir,
    )

    t_phase = time.perf_counter()
    info = {}
    paths = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mv_"))
    seen = []
    real_detect = detector.detect

    def recording_detect(params, *args, **kw):
        result = real_detect(params, *args, **kw)
        seen.append((params.signal, result))
        return result

    try:
        # 1. the main path: configs/multivariate.yaml (WADI, F = 123,
        # hyperbolic, batch 64, lr 5e-4, fused_critics false, mult), 1 epoch
        t0 = time.perf_counter()
        wadi_y = write_wadi(root / "data", MV_TRAIN_ROWS, MV_ROWS, WADI_F)
        info["wadi_write_s"] = time.perf_counter() - t0
        cfg = parse_flat_yaml(Path("configs/multivariate.yaml").read_text())
        cfg.update(epochs=1, data_root=str(root / "data"),
                   output_root=str(root / "out"), devices=1,
                   save_plots=False)
        wadi_cfg = root / "wadi.yaml"
        wadi_cfg.write_text(dump_flat_yaml(cfg))
        (state, path, trained), paths["mv_wadi_train"] = run_cli(
            ["train", "--config", str(wadi_cfg)], "mv_wadi_train", card)
        n_batches = MV_TRAIN_ROWS // MV_BATCH
        want = launches_of(mobius_linear=(tr.N_CRITICS + 2) * n_batches + 2,
                           kde_argmax=1)
        if paths["mv_wadi_train"] != want:
            fail(f"WADI train (fused_critics false, F={WADI_F}) launched "
                 f"{paths['mv_wadi_train']}, expected {want}")
        cpu_det, _ = run_cli(["detect", "--config", str(wadi_cfg),
                              "--device", "cpu"], "mv_wadi_detect_cpu", card)
        card_det, paths["mv_wadi_detect"] = run_cli(
            ["detect", "--config", str(wadi_cfg)], "mv_wadi_detect", card)
        if paths["mv_wadi_detect"] != launches_of(mobius_linear=2,
                                                  kde_argmax=1):
            fail(f"WADI detect launched {paths['mv_wadi_detect']}")
        for res in (trained, card_det):
            s = res["scores"]
            if s.shape != (MV_ROWS,) or not np.isfinite(s).all():
                fail(f"WADI scores of shape {s.shape}, finite "
                     f"{np.isfinite(s).all()}")
        again, _ = run_cli(["detect", "--config", str(wadi_cfg)],
                           "mv_wadi_detect_again", card)
        check_reentry(state, path, trained, {"detect": card_det,
                                             "detect again": again}, device)
        check_same_detection(card_det, trained, np.zeros((0, 2)),
                             tag="mv wadi re-entry", multivariate=True)
        # the card's detection gives the same bits call after call (a
        # one-row cumsum through CUB's scan did not: ops.rolling)
        X_test = load_wadi(str(root / "data"), True).X

        def wadi_scores():
            return sc.detect_scores(state.model, X_test, True, "mult",
                                    fetch_inference=False, multivariate=True,
                                    device=device)[0]

        first = wadi_scores()
        differ = sum(not np.array_equal(first, wadi_scores(), equal_nan=True)
                     for _ in range(MV_REPEATS))
        print(f"[mv] WADI detect_scores repeated {MV_REPEATS} times on the "
              f"trained weights: {differ} differ from the first in a bit")
        if differ:
            fail(f"{differ} of {MV_REPEATS} WADI detections differ from the "
                 f"first")
        check_same_detection(card_det, cpu_det, np.zeros((0, 2)),
                             tag="mv wadi", atol_from_scores=True,
                             multivariate=True)
        info["wadi_labels"] = int(wadi_y.sum())

        # the warm epoch at the WADI width: the CLI's epoch above, at the
        # same shapes in this process, was the warm-up; one timed epoch
        # (an epoch under false takes seconds at this size)
        X = torch.as_tensor(load_wadi(str(root / "data"), False).X,
                            device=device)
        model = init_tadgan(torch.Generator().manual_seed(SEED), WADI_F,
                            hyperbolic=True, device=device)
        state = tr.init_train_state(model, TRAIN_LR, True)
        t0 = time.perf_counter()
        draws = tr.epoch_draws(tr.epoch_generator(SEED, 1), X.shape[0],
                               MV_BATCH, model)
        tr.run_epoch(state, X, draws, lr=TRAIN_LR, hyperbolic=True,
                     fused_critics=False)   # run_epoch synchronises
        wall = time.perf_counter() - t0
        info["wadi_epoch_s"] = {"s": wall, "rows": MV_TRAIN_ROWS}
        print(f"[mv] warm epoch at the WADI width ({MV_TRAIN_ROWS} rows of "
              f"{WADI_F}, batch {MV_BATCH}, fused_critics false): {wall:.4f}"
              f" s ({card})")

        # 2. the CASAS width: 50,000 rows of 150, card against the CPU
        Xc, yc = mv_rows(MV_ROWS, CASAS_F, SEED + 5)
        Xc = MultivariateData(Xc).X
        models = {dev: init_tadgan(torch.Generator().manual_seed(SEED),
                                   CASAS_F, hyperbolic=True, device=dev)
                  for dev in (device, "cpu")}
        read = zero_counters()
        card_s, _ = sc.detect_scores(models[device], Xc, True, "mult",
                                     fetch_inference=False,
                                     multivariate=True, device=device)
        paths["mv_casas_detect"] = read()
        if paths["mv_casas_detect"] != launches_of(
                mobius_linear=2, mobius_linear_wide=2, kde_argmax=1,
                kde_argmax_wide=1):
            fail(f"CASAS-width detect launched {paths['mv_casas_detect']}")
        cpu_s, _ = sc.detect_scores(models["cpu"], Xc, True, "mult",
                                    fetch_inference=False,
                                    multivariate=True, device="cpu")
        got, known = mv_detection(card_s, yc)
        want_det, _ = mv_detection(cpu_s, yc)
        info["casas_f1"] = check_same_detection(
            got, want_det, known, tag="mv casas", atol_from_scores=True,
            multivariate=True)
        params = load_config(dict(cfg, dataset="CASAS", signal="kitchen",
                                  signal_shape=CASAS_F))
        read = zero_counters()
        grid = detector.detect_grid(params, models[device],
                                    MultivariateData(Xc, y=yc),
                                    str(root / "grid"),
                                    combinations=list(sc.COMBINATIONS),
                                    device=device)
        paths["mv_casas_grid"] = read()
        if paths["mv_casas_grid"] != launches_of(
                mobius_linear=2, mobius_linear_wide=2, kde_argmax=1,
                kde_argmax_wide=1) or len(grid) != 8:
            fail(f"CASAS grid of {len(grid)} cells launched "
                 f"{paths['mv_casas_grid']}")
        check_same_detection(grid[(None, "mult")], got, known,
                             tag="mv casas grid mult")

        # 3. a CASAS family as one fleet: sweep, then its detect-only on the
        # CPU from the card's checkpoints
        labels = write_casas(root / "data", CASAS_RESIDENTS, CASAS_ROWS,
                             CASAS_F)
        scfg = dict(cfg, dataset="CASAS", signal=CASAS_RESIDENTS[0], id=1,
                    signal_shape=CASAS_F, signals=list(CASAS_RESIDENTS),
                    fused_critics="full", save_result=True,
                    filename="mv_sweep.csv")
        card_cfg = root / "casas_sweep.yaml"
        card_cfg.write_text(dump_flat_yaml(scfg))
        cpu_cfg = root / "casas_sweep_cpu.yaml"
        cpu_cfg.write_text(dump_flat_yaml(dict(scfg,
                                               filename="mv_sweep_cpu.csv")))
        detector.detect = recording_detect
        results, paths["mv_casas_sweep"] = run_cli(
            ["sweep", "--config", str(card_cfg)], "mv_casas_sweep", card)
        card_runs = dict(seen)
        seen.clear()
        cpu_results, _ = run_cli(["sweep", "--detect-only", "--config",
                                  str(cpu_cfg), "--device", "cpu"],
                                 "mv_casas_sweep_cpu", card)
        cpu_runs = dict(seen)
        seen.clear()
        sb = CASAS_ROWS // MV_BATCH
        want = launches_of(critic_step_full=tr.N_CRITICS * sb,
                           critic_step_full_wide=tr.N_CRITICS * sb,
                           mobius_linear=2 * sb + 2,
                           mobius_linear_wide=2 * sb + 2,
                           kde_argmax=1, kde_argmax_wide=1)
        if paths["mv_casas_sweep"] != want:
            fail(f"CASAS sweep launched {paths['mv_casas_sweep']}, expected "
                 f"{want}")
        info["casas_sweep_f1"] = {}
        for r in CASAS_RESIDENTS:
            known_r = detector._multivariate_ground_truth(
                MultivariateData(np.zeros((CASAS_ROWS, 1)), y=labels[r]))
            info["casas_sweep_f1"][r] = check_same_detection(
                card_runs[r], cpu_runs[r], known_r, tag=f"mv sweep {r}",
                atol_from_scores=True, multivariate=True)
        if [x[2] for x in results] != [x[2] for x in cpu_results]:
            fail("the CPU's detect-only F1s differ from the card's sweep's")
        first = load_config(str(card_cfg))
        if not (Path(run_dir(first)) / "state_final.pt").exists():
            fail("the sweep left no checkpoint in the first run directory")
        # K3's wide instance: the family's detection under HYPAD_KDE_PALLAS=1
        k3_env = {"HYPAD_KDE_PALLAS": "1"}
        _, paths["mv_casas_sweep_detect_v2"] = run_cli(
            ["sweep", "--detect-only", "--config", str(card_cfg)],
            "mv_casas_sweep_detect_v2", card, env=k3_env)
        card_v2 = dict(seen)
        seen.clear()
        run_cli(["sweep", "--detect-only", "--config", str(cpu_cfg),
                 "--device", "cpu"], "mv_casas_sweep_detect_v2_cpu", card,
                env=k3_env)
        cpu_v2 = dict(seen)
        seen.clear()
        if paths["mv_casas_sweep_detect_v2"] != launches_of(
                mobius_linear=2, mobius_linear_wide=2, kde_argmax_v2=1,
                kde_argmax_v2_wide=1):
            fail("CASAS sweep --detect-only under HYPAD_KDE_PALLAS=1 "
                 f"launched {paths['mv_casas_sweep_detect_v2']}")
        for r in CASAS_RESIDENTS:
            check_same_detection(card_v2[r], cpu_v2[r], np.zeros((0, 2)),
                                 tag=f"mv sweep v2 {r}",
                                 atol_from_scores=True, multivariate=True)
        # the fleet grid of the family: every combination of every
        # resident in one call, card against CPU, under K2 then K3
        known_res = {r: detector._multivariate_ground_truth(MultivariateData(
            np.zeros((CASAS_ROWS, 1)), y=labels[r])) for r in CASAS_RESIDENTS}
        info["casas_sweep_grid_f1"] = {}
        for tag, env, kde in (("mv_casas_sweep_grid", None, "kde_argmax"),
                              ("mv_casas_sweep_grid_v2", k3_env,
                               "kde_argmax_v2")):
            flags = ["--detect-only", "--combinations", "all"]
            grid_card, paths[tag] = run_cli(
                ["sweep", *flags, "--config", str(card_cfg)], tag, card,
                env=env)
            card_files = grid_files(card_cfg, list(CASAS_RESIDENTS))
            grid_cpu, _ = run_cli(
                ["sweep", *flags, "--config", str(cpu_cfg), "--device",
                 "cpu"], f"{tag}_cpu", card, env=env)
            cpu_files = grid_files(cpu_cfg, list(CASAS_RESIDENTS))
            if paths[tag] != launches_of(
                    mobius_linear=2, mobius_linear_wide=2,
                    **{kde: 1, f"{kde}_wide": 1}):
                fail(f"CASAS sweep grid ({tag}) launched {paths[tag]}")
            f1s, ties = check_sweep_grid(grid_card, grid_cpu, card_files,
                                         cpu_files, known_res, tag,
                                         multivariate=True)
            info[f"{tag}_threshold_ties"] = [[r, c[1]] for r, c in ties]
            info["casas_sweep_grid_f1"][tag] = {
                r: {c[1]: f for c, f in cells.items()}
                for r, cells in f1s.items()}
        # K4's wide instance: one resident's train under fused_critics true
        k4_cfg = root / "casas_k4.yaml"
        k4_cfg.write_text(dump_flat_yaml(dict(
            scfg, fused_critics=True, output_root=str(root / "out_k4"))))
        detector.detect = real_detect
        _, paths["mv_casas_train_fused_true"] = run_cli(
            ["train", "--config", str(k4_cfg)], "mv_casas_train_fused_true",
            card)
        want = launches_of(critics_fused_grads=tr.N_CRITICS * sb,
                           critics_fused_grads_wide=tr.N_CRITICS * sb,
                           mobius_linear=(tr.N_CRITICS + 2) * sb + 2,
                           mobius_linear_wide=(tr.N_CRITICS + 2) * sb + 2,
                           kde_argmax=1, kde_argmax_wide=1)
        if paths["mv_casas_train_fused_true"] != want:
            fail(f"CASAS train (fused_critics true) launched "
                 f"{paths['mv_casas_train_fused_true']}, expected {want}")

        # 4. warm detect rows/s at 50,000 rows of 51, 123 and 150
        calls = {}
        for F in (SWAT_F, WADI_F, CASAS_F):
            m = init_tadgan(torch.Generator().manual_seed(SEED), F,
                            hyperbolic=True, device=device)
            XF = MultivariateData(mv_rows(MV_ROWS, F, SEED + F)[0]).X

            def call(m=m, XF=XF):
                return sc.detect_scores(m, XF, True, "mult",
                                        fetch_inference=False,
                                        multivariate=True, device=device)
            calls[F] = call
        info["detect_rows_per_s"] = {}
        for F, walls in warm_detect_ms(calls, rounds=5).items():
            median = stats.median(walls)
            info["detect_rows_per_s"][F] = MV_ROWS / median * 1e3
            print(f"[mv] warm detect_scores(multivariate=True), {MV_ROWS} "
                  f"rows of {F}, mult: median {median:.3f} ms, "
                  f"{MV_ROWS / median * 1e3:.0f} rows/s (runs in ms: "
                  f"{[round(w, 3) for w in walls]}) ({card})")
    finally:
        detector.detect = real_detect
        shutil.rmtree(root, ignore_errors=True)
    info["seconds"] = time.perf_counter() - t_phase
    print(f"[mv] all checks passed in {info['seconds']:.1f} s: K1, K2, K3, "
          f"K4, K5 wide instances against their plain versions; WADI train "
          f"-> detect equal to the CPU's; CASAS width card = CPU; the CASAS "
          f"sweep's residents card = CPU ({card})")
    return paths, info


XW_F = 300             # the width-300 path's feature count
XW_TEST_ROWS = 2_000   # its training rows, and its test rows


def phase_xwide(device, card):
    """[xwide]: the main path at a width above 256 through the CLI: a
    WADI-format stream of XW_F features (2,000 training and 2,000 test
    rows, three level-shift runs; the CASAS loader's width is fixed at
    150), configs/multivariate.yaml's settings but ``train`` (1 epoch,
    hyperbolic,
    fused_critics "full": the any-width K5 and K1), ``detect`` on the
    card (the any-width K1 2, K2 1) and ``detect --device cpu`` from the
    card's checkpoint: the same intervals, confusion, F1, zeros and NaNs,
    interval scores within what the score difference allows; the same
    under HYPAD_KDE_PALLAS=1 (the any-width K3), and ``train`` under
    fused_critics true (the any-width K4). Returns ({path: launches},
    info)."""
    import shutil
    import tempfile

    import numpy as np

    from hypad_tpu_torch.train import trainer as tr
    from hypad_tpu_torch.utils.config import dump_flat_yaml, parse_flat_yaml

    t_phase = time.perf_counter()
    paths, info = {}, {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_xwide_"))
    try:
        write_wadi(root / "data", XW_TEST_ROWS, XW_TEST_ROWS, XW_F)
        known = np.zeros((0, 2))   # a WADI stream carries no ground truth
        cfg = parse_flat_yaml(Path("configs/multivariate.yaml").read_text())
        cfg.update(signal_shape=XW_F, epochs=1, fused_critics="full",
                   data_root=str(root / "data"),
                   output_root=str(root / "out"), devices=1,
                   save_plots=False)
        cfg_path = root / "xwide.yaml"
        cfg_path.write_text(dump_flat_yaml(cfg))
        nb = XW_TEST_ROWS // MV_BATCH
        (_, _, trained), paths["xwide_train"] = run_cli(
            ["train", "--config", str(cfg_path)], "xwide_train", card)
        want = launches_of(critic_step_full=tr.N_CRITICS * nb,
                           critic_step_full_xwide=tr.N_CRITICS * nb,
                           mobius_linear=2 * nb + 2,
                           mobius_linear_xwide=2 * nb + 2,
                           kde_argmax=1, kde_argmax_xwide=1)
        if paths["xwide_train"] != want:
            fail(f"width-{XW_F} train (fused_critics full) launched "
                 f"{paths['xwide_train']}, expected {want}")
        card_det, paths["xwide_detect"] = run_cli(
            ["detect", "--config", str(cfg_path)], "xwide_detect", card)
        if paths["xwide_detect"] != launches_of(
                mobius_linear=2, mobius_linear_xwide=2, kde_argmax=1,
                kde_argmax_xwide=1):
            fail(f"width-{XW_F} detect launched {paths['xwide_detect']}")
        s = card_det["scores"]
        if s.shape != (XW_TEST_ROWS,) or not np.isfinite(s).all():
            fail(f"width-{XW_F} scores of shape {s.shape}, finite "
                 f"{np.isfinite(s).all()}")
        check_same_detection(card_det, trained, known,
                             tag="xwide re-entry", multivariate=True)
        cpu_det, _ = run_cli(["detect", "--config", str(cfg_path),
                              "--device", "cpu"], "xwide_detect_cpu", card)
        info["f1"] = check_same_detection(card_det, cpu_det, known,
                                          tag="xwide", atol_from_scores=True,
                                          multivariate=True)
        same_zeros_and_nans(card_det["scores"], cpu_det["scores"],
                            f"width-{XW_F} detect")
        k3_env = {"HYPAD_KDE_PALLAS": "1"}
        card_v2, paths["xwide_detect_v2"] = run_cli(
            ["detect", "--config", str(cfg_path)], "xwide_detect_v2", card,
            env=k3_env)
        if paths["xwide_detect_v2"] != launches_of(
                mobius_linear=2, mobius_linear_xwide=2, kde_argmax_v2=1,
                kde_argmax_v2_xwide=1):
            fail(f"width-{XW_F} detect under HYPAD_KDE_PALLAS=1 launched "
                 f"{paths['xwide_detect_v2']}")
        cpu_v2, _ = run_cli(["detect", "--config", str(cfg_path), "--device",
                             "cpu"], "xwide_detect_v2_cpu", card, env=k3_env)
        info["f1_v2"] = check_same_detection(
            card_v2, cpu_v2, known, tag="xwide v2", atol_from_scores=True,
            multivariate=True)
        same_zeros_and_nans(card_v2["scores"], cpu_v2["scores"],
                            f"width-{XW_F} detect, K3")
        k4_cfg = root / "xwide_k4.yaml"
        k4_cfg.write_text(dump_flat_yaml(dict(
            cfg, fused_critics=True, output_root=str(root / "out_k4"))))
        _, paths["xwide_train_fused_true"] = run_cli(
            ["train", "--config", str(k4_cfg)], "xwide_train_fused_true",
            card)
        want = launches_of(critics_fused_grads=tr.N_CRITICS * nb,
                           critics_fused_grads_xwide=tr.N_CRITICS * nb,
                           mobius_linear=(tr.N_CRITICS + 2) * nb + 2,
                           mobius_linear_xwide=(tr.N_CRITICS + 2) * nb + 2,
                           kde_argmax=1, kde_argmax_xwide=1)
        if paths["xwide_train_fused_true"] != want:
            fail(f"width-{XW_F} train (fused_critics true) launched "
                 f"{paths['xwide_train_fused_true']}, expected {want}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    info["seconds"] = time.perf_counter() - t_phase
    print(f"[xwide] all checks passed in {info['seconds']:.1f} s: the "
          f"width-{XW_F} train -> detect on the card equals the CPU's "
          f"detect from its checkpoint (K2 and K3), every launch of the "
          f"any-width instances ({card})")
    return paths, info


def mv_kernel_timing(device):
    """Each wide instance's time beside its plain version, its bound and
    the narrow instance at F = 100, in one call: K1 at (50,000, 150), K2
    and K3 on the detect call's anti-diagonal rows at W = 150, K5 and K4
    at B = 64 and F = 150. Returns {name: timing dict}."""
    import torch

    from hypad_tpu_torch.manifold.kernels import (
        mobius_linear,
        mobius_linear_kernel,
    )
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.ops.kde import (
        kde_argmax_rows_and_use,
        kde_argmax_rows_v2_and_use,
    )
    from hypad_tpu_torch.ops.kde_kernel import (
        kde_argmax_kernel,
        kde_argmax_v2_kernel,
    )
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.profile_detect import cuda_ms
    from hypad_tpu_torch.profile_kernels import k2_case
    from hypad_tpu_torch.train import critic_kernel as ck

    out = {}
    heads = {}
    for F in (CASAS_F, WIDTH):
        gen = torch.Generator().manual_seed(F)
        head = init_tadgan(gen, F, hyperbolic=True,
                           device=device)["decoder"].hyperbolic_linear
        x = (torch.rand(MV_ROWS, F, generator=gen) * 2 - 1).to(device)
        heads[F] = (x, head.w.detach(), head.b.detach())
    x, w, b = heads[CASAS_F]
    k = {"ms": cuda_ms(lambda: mobius_linear_kernel(x, w, b), 100),
         "plain_ms": cuda_ms(lambda: mobius_linear(x, w, b), 20),
         "narrow_ms_at_F100": cuda_ms(
             lambda: mobius_linear_kernel(*heads[WIDTH]), 100),
         "max_abs_err": (mobius_linear_kernel(x, w, b)
                         - mobius_linear(x, w, b)).abs().max().item(),
         "shape": f"({MV_ROWS}, {CASAS_F})"}
    k["bytes"], k["ops"] = k1_cost(MV_ROWS, CASAS_F, CASAS_F)
    out["mobius_linear_wide"] = bound(k)
    for name, kernel, plain in (
            ("kde_argmax_wide", kde_argmax_kernel, kde_argmax_rows_and_use),
            ("kde_argmax_v2_wide", kde_argmax_v2_kernel,
             kde_argmax_rows_v2_and_use)):
        vals, mask = k2_case(MV_ROWS, CASAS_F, 0, device)
        nv, nm = k2_case(MV_ROWS, WIDTH, 0, device)
        got, use = kernel(vals, mask)
        want, _ = plain(vals, mask)
        k = {"ms": cuda_ms(lambda: kernel(vals, mask), 30),
             "plain_ms": cuda_ms(lambda: plain(vals, mask), 3),
             "narrow_ms_at_F100": cuda_ms(lambda: kernel(nv, nm), 30),
             "max_abs_err": (got[use] - want[use]).abs().max().item(),
             "shape": f"({vals.shape[0]}, {CASAS_F})"}
        cnt = mask.sum(dim=1).double()
        pairs = (cnt * (cnt - 1) / 2).sum().item()
        k["bytes"] = 5 * vals.numel() + 5 * vals.shape[0]
        k["exps"] = int(pairs)
        k["ops"] = int(6 * pairs + 8 * cnt.sum().item())
        out[name] = bound(k)
    model, xc, d = critic_case(device, True, MV_BATCH, CASAS_F)
    nmodel, nx, nd = critic_case(device, True, MV_BATCH, WIDTH)
    bigx, bigz = ck.critic_step_inputs(model, xc, d, True)
    args = (model["critic_x"], model["critic_z"], bigx, bigz, d["m_cx"],
            d["m_cz"])
    nbx, nbz = ck.critic_step_inputs(nmodel, nx, nd, True)
    nargs = (nmodel["critic_x"], nmodel["critic_z"], nbx, nbz, nd["m_cx"],
             nd["m_cz"])
    bx, ox = critic_cost(MV_BATCH, model["critic_x"], CASAS_F)
    bz, oz = critic_cost(MV_BATCH, model["critic_z"], 20)
    bg, og = generator_cost(model, MV_BATCH)
    k5 = {"ms": cuda_ms(lambda: ck.critic_step_fused_full(model, xc, d,
                                                          True), 100),
          "plain_ms": cuda_ms(lambda: ck.critic_step_plain(model, xc, d,
                                                           True), 20),
          "narrow_ms_at_F100": cuda_ms(
              lambda: ck.critic_step_fused_full(nmodel, nx, nd, True), 100),
          "bytes": bx + bz + bg - 4 * 3 * MV_BATCH * (CASAS_F + 20),
          "ops": ox + oz + og, "shape": f"B={MV_BATCH}, F={CASAS_F}"}
    k4 = {"ms": cuda_ms(lambda: ck.critics_fused_grads(*args), 100),
          "plain_ms": cuda_ms(lambda: ck.critics_fused_grads_plain(*args),
                              20),
          "narrow_ms_at_F100": cuda_ms(lambda: ck.critics_fused_grads(*nargs),
                                       100),
          "bytes": bx + bz, "ops": ox + oz,
          "shape": f"B={MV_BATCH}, F={CASAS_F}"}
    out["critic_step_full_wide"] = bound(k5)
    out["critics_fused_grads_wide"] = bound(k4)
    for name, k in out.items():
        print(f"[timing] {name} at {k['shape']}: kernel {k['ms']:.5f} ms, "
              f"plain {k['plain_ms']:.5f} ms, bound {k['bound_ms']:.6f} ms "
              f"({k['bound_by']}: {k['bytes']} bytes, {k['ops']} ops); the "
              f"narrow instance at F = {WIDTH}: {k['narrow_ms_at_F100']:.5f} "
              f"ms")
    return out


def xwide_kernel_timing(device):
    """Each any-width instance's time beside its plain version and its
    bound at the width-300 path's shapes (``phase_xwide``): K1 at
    (XW_TEST_ROWS, 300), K2 and K3 on that detect call's anti-diagonal
    rows, K5 and K4 at B = 64; and K1 at shapes not timed before, the wide
    instance at (50,000, 256) and the narrow one at the WADI training
    shapes (64 and 128 rows of 123). Returns {name: timing dict}."""
    import functools

    import torch

    from hypad_tpu_torch.manifold.kernels import (
        mobius_linear,
        mobius_linear_kernel,
    )
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.ops.kde import (
        kde_argmax_rows_and_use,
        kde_argmax_rows_v2_and_use,
    )
    from hypad_tpu_torch.ops.kde_kernel import (
        kde_argmax_kernel,
        kde_argmax_v2_kernel,
    )
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.profile_detect import cuda_ms
    from hypad_tpu_torch.profile_kernels import k2_case
    from hypad_tpu_torch.train import critic_kernel as ck

    def k1_case(rows, F):
        gen = torch.Generator().manual_seed(rows + F)
        head = init_tadgan(gen, F, hyperbolic=True,
                           device=device)["decoder"].hyperbolic_linear
        x = (torch.rand(rows, F, generator=gen) * 2 - 1).to(device)
        return x, head.w.detach(), head.b.detach()

    def k1_timing(rows, F):
        x, w, b = k1_case(rows, F)
        k = {"ms": cuda_ms(lambda: mobius_linear_kernel(x, w, b), 100),
             "plain_ms": cuda_ms(lambda: mobius_linear(x, w, b), 20),
             "max_abs_err": (mobius_linear_kernel(x, w, b)
                             - mobius_linear(x, w, b)).abs().max().item(),
             "shape": f"({rows}, {F})"}
        k["bytes"], k["ops"] = k1_cost(rows, F, F)
        return bound(k)

    out = {"mobius_linear_xwide": k1_timing(XW_TEST_ROWS, XW_F)}
    for name, kernel, plain in (
            ("kde_argmax_xwide", kde_argmax_kernel, functools.partial(
                kde_argmax_rows_and_use, block=XWIDE_PLAIN_BLOCK)),
            ("kde_argmax_v2_xwide", kde_argmax_v2_kernel,
             kde_argmax_rows_v2_and_use)):
        vals, mask = k2_case(XW_TEST_ROWS, XW_F, 0, device)
        got, use = kernel(vals, mask)
        want, _ = plain(vals, mask)
        k = {"ms": cuda_ms(lambda: kernel(vals, mask), 20),
             "plain_ms": cuda_ms(lambda: plain(vals, mask), 3),
             "max_abs_err": (got[use] - want[use]).abs().max().item(),
             "shape": f"({vals.shape[0]}, {XW_F})"}
        cnt = mask.sum(dim=1).double()
        pairs = (cnt * (cnt - 1) / 2).sum().item()
        k["bytes"] = 5 * vals.numel() + 5 * vals.shape[0]
        k["exps"] = int(pairs)
        k["ops"] = int(6 * pairs + 8 * cnt.sum().item())
        out[name] = bound(k)
    model, xc, d = critic_case(device, True, MV_BATCH, XW_F)
    bigx, bigz = ck.critic_step_inputs(model, xc, d, True)
    args = (model["critic_x"], model["critic_z"], bigx, bigz, d["m_cx"],
            d["m_cz"])
    bx, ox = critic_cost(MV_BATCH, model["critic_x"], XW_F)
    bz, oz = critic_cost(MV_BATCH, model["critic_z"], 20)
    bg, og = generator_cost(model, MV_BATCH)
    k5 = {"ms": cuda_ms(lambda: ck.critic_step_fused_full(model, xc, d,
                                                          True), 50),
          "plain_ms": cuda_ms(lambda: ck.critic_step_plain(model, xc, d,
                                                           True), 20),
          "bytes": bx + bz + bg - 4 * 3 * MV_BATCH * (XW_F + 20),
          "ops": ox + oz + og, "shape": f"B={MV_BATCH}, F={XW_F}"}
    k4 = {"ms": cuda_ms(lambda: ck.critics_fused_grads(*args), 50),
          "plain_ms": cuda_ms(lambda: ck.critics_fused_grads_plain(*args),
                              20),
          "bytes": bx + bz, "ops": ox + oz,
          "shape": f"B={MV_BATCH}, F={XW_F}"}
    out["critic_step_full_xwide"] = bound(k5)
    out["critics_fused_grads_xwide"] = bound(k4)
    for name, k in out.items():
        print(f"[timing] {name} at {k['shape']}: kernel {k['ms']:.5f} ms, "
              f"plain {k['plain_ms']:.5f} ms, bound {k['bound_ms']:.6f} ms "
              f"({k['bound_by']}: {k['bytes']} bytes, {k['ops']} ops)")
    out["k1_untimed_shapes"] = {}
    for rows, F in ((MV_ROWS, 256), (MV_BATCH, WADI_F),
                    (2 * MV_BATCH, WADI_F)):
        k = k1_timing(rows, F)
        out["k1_untimed_shapes"][k["shape"]] = k
        print(f"[timing] K1 mobius_linear at {k['shape']}: kernel "
              f"{k['ms']:.5f} ms, plain {k['plain_ms']:.5f} ms, bound "
              f"{k['bound_ms']:.6f} ms ({k['bound_by']})")
    return out


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

    phase_s = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[fn.__name__] = time.perf_counter() - t0
        print(f"[time] {fn.__name__}: {phase_s[fn.__name__]:.1f} s")
        return out

    libs = timed(phase_build)
    k1_err, k1_parent, kde_flips = timed(phase_kernels, device, libs)
    k45_err = timed(phase_critic_kernels, device)
    # the wide instances, named by the profiler before the long traces of
    # [fleet]
    mv_errs = timed(mv_kernel_checks, device)
    xw_errs = timed(xwide_kernel_checks, device)
    launches, X, model = timed(phase_main_path, device)
    eucl_launches, eucl_model = timed(phase_eucl_detect, device)
    train = timed(phase_train, device)
    eucl_train = timed(phase_eucl_train, device)
    cli_paths, cli_info = timed(phase_cli, device, card)
    fleet = timed(phase_fleet, device)
    sweep_launches, sweep_grid_launches, sweep_info = timed(
        phase_sweep, device, card)
    mv_paths, mv_info = timed(phase_mv, device, card)
    xw_paths, xw_info = timed(phase_xwide, device, card)
    timed(phase_staged, device, X, eucl_model, model)
    wps, k1, k2, k3 = timed(phase_timing, device, X, model, eucl_model, libs)
    epochs, k4, k5 = timed(phase_train_timing, device, train["X"])
    mv_timing = timed(mv_kernel_timing, device)
    xw_timing = timed(xwide_kernel_timing, device)
    paths = {"detect": launches,
             **{f"detect_euclidean_{r}": eucl_launches[r]
                for r in REC_ERRORS},
             "train": train["launches"],
             "train_fused_critics_true": train["launches_fused_true"],
             "train_euclidean": eucl_train["launches"],
             "detect_euclidean_trained": eucl_train["detect_launches"],
             **cli_paths,
             "fleet_seed_band_S3_2_epochs": fleet["band_launches"],
             "fleet_detect_S9": fleet["detect"]["launches"],
             "sweep_nab_9_signals_1_epoch": sweep_launches,
             "sweep_nab_9_signals_grid_detect_only": sweep_grid_launches,
             **mv_paths, **xw_paths}
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
    # the wide instances (feature counts of 129 to 256), each with the
    # launches of the multivariate path that runs it
    wide_paths = {"mobius_linear": "mv_casas_detect",
                  "kde_argmax": "mv_casas_detect",
                  "kde_argmax_v2": "mv_casas_sweep_detect_v2",
                  "critics_fused_grads": "mv_casas_train_fused_true",
                  "critic_step_full": "mv_casas_sweep"}
    wide_err = {"mobius_linear": max(mv_errs["k1_err"],
                                     mv_timing["mobius_linear_wide"][
                                         "max_abs_err"]),
                "kde_argmax": mv_timing["kde_argmax_wide"]["max_abs_err"],
                "kde_argmax_v2": mv_timing["kde_argmax_v2_wide"][
                    "max_abs_err"],
                "critics_fused_grads": mv_errs["k4_err"],
                "critic_step_full": mv_errs["k5_err"]}
    for k in list(kernels):
        name, wide = k["name"], f"{k['name']}_wide"
        w = mv_timing[wide]
        path = wide_paths[name]
        kernels.append({
            "name": wide, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "instance": "widths 129 to 256",
            "launches": mv_paths[path][wide], "launches_path": path,
            "launches_by_path": by_path[wide],
            "max_abs_err": wide_err[name],
            "tolerance": (k["tolerance"] if name.startswith("critic") or
                          name == "mobius_linear" else
                          "use flags bitwise; fallback rows bitwise "
                          "masked_median; elsewhere each differing row a "
                          "sample of its own row at a float64 density tie "
                          "(gap <= n 2^-22)"),
            "shape": w["shape"], "ms": w["ms"], "kernel_ms": w["ms"],
            "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
            "bound_by": w["bound_by"],
            "narrow_instance_ms_at_F100": w["narrow_ms_at_F100"],
            "library_ms": None})
    # the any-width instances (widths above 256), each with the launches
    # of the width-300 path that runs it
    xwide_paths = {"mobius_linear": "xwide_detect",
                   "kde_argmax": "xwide_detect",
                   "kde_argmax_v2": "xwide_detect_v2",
                   "critics_fused_grads": "xwide_train_fused_true",
                   "critic_step_full": "xwide_train"}
    xwide_err = {"mobius_linear": max(xw_errs["k1_err"],
                                      xw_timing["mobius_linear_xwide"][
                                          "max_abs_err"]),
                 "kde_argmax": xw_timing["kde_argmax_xwide"]["max_abs_err"],
                 "kde_argmax_v2": xw_timing["kde_argmax_v2_xwide"][
                     "max_abs_err"],
                 "critics_fused_grads": xw_errs["k4_err"],
                 "critic_step_full": xw_errs["k5_err"]}
    for k in kernels[:len(KERNEL_NAMES)]:
        name, xwide = k["name"], f"{k['name']}_xwide"
        w = xw_timing[xwide]
        path = xwide_paths[name]
        kernels.append({
            "name": xwide, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "instance": "widths above 256",
            "profiler_name": xw_errs["names"][name],
            "launches": xw_paths[path][xwide], "launches_path": path,
            "launches_by_path": by_path[xwide],
            "max_abs_err": xwide_err[name],
            "tolerance": (k["tolerance"] if name.startswith("critic") or
                          name == "mobius_linear" else
                          "use flags bitwise; fallback rows bitwise "
                          "masked_median; elsewhere each differing row a "
                          "sample of its own row at a float64 density tie "
                          "(gap <= n 2^-22)"),
            "shape": w["shape"], "ms": w["ms"], "kernel_ms": w["ms"],
            "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
            "bound_by": w["bound_by"], "library_ms": None})
    for k in kernels:
        by_s = fleet["kernels"].get(k["name"])
        if by_s:
            k["signal_axis"] = {
                f"S={S}": {key: r[key] for key in (
                    "ms", "single_launches_ms", "plain_ms", "bound_ms",
                    "bound_by", "max_abs_err")} for S, r in by_s.items()}
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
               "fleet": {k: v for k, v in fleet.items() if k != "kernels"},
               "sweep": sweep_info,
               "mv": mv_info,
               "mv_kernel_checks": mv_errs,
               "xwide": xw_info,
               "xwide_kernel_checks": xw_errs,
               "k1_untimed_shapes": xw_timing["k1_untimed_shapes"],
               "kernels": kernels,
               "phase_seconds": phase_s,
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
