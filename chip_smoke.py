"""Smoke run of the PyTorch/CUDA port (hypad_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each failing loudly (a failed check raises and the exit code is not
0):

1. build: compile the hand-written kernels in hypad_tpu_torch/csrc with nvcc
   (one process per source, all at once) and print the ptxas report;
2. kernels against their plain PyTorch versions on the card: the fused
   MobiusLinear forward (max abs diff <= 1e-6) and the KDE argmax (tie
   level: a differing value is a sample of its own row, at most 1% of rows
   differ);
3. main path: a seeded synthetic univariate signal with 3 injected anomalies,
   windowed to 20,000 windows of width 100, through
   ``detect_univariate(..., combination="mult", device="cuda")`` with a
   full-width hyperbolic model (random weights from a seed). The kernels'
   launch counters are zeroed just before and read just after; the scores
   must be finite and the intervals and F1 equal the same call on the CPU.
   Then warm detect throughput, and each kernel's time beside its plain
   version's and its bound at the path's shapes;
4. report: one JSON line of the kernels, the card's name and power limit,
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
    """K1 and K2 against their plain versions at the path's shapes and at
    the edge cases; returns the largest K1 diff and the K2 tie flips
    summed over the cases."""
    import torch

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
    for rows, dim, w_scale in ((N_WINDOWS, WIDTH, 1.0), (130, 64, 1.0),
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


def phase_main_path(device):
    """The detector on the card once with zeroed launch counters, then the
    same call on the CPU; returns (launches, windows, model)."""
    import numpy as np
    import torch

    from hypad_tpu_torch.data.pipeline import synthetic_detect_input
    from hypad_tpu_torch.detect.detector import detect_univariate
    from hypad_tpu_torch.manifold.kernels import mobius_linear_kernel
    from hypad_tpu_torch.models.tadgan import init_tadgan
    from hypad_tpu_torch.ops.kde_kernel import kde_argmax_kernel

    X, index, known = synthetic_detect_input(N_WINDOWS, WIDTH, seed=SEED)
    if X.shape != (N_WINDOWS, WIDTH):
        fail(f"pipeline gave windows of shape {X.shape}")
    model = init_tadgan(torch.Generator().manual_seed(SEED), WIDTH,
                        hyperbolic=True, device=device)

    mobius_linear_kernel.launches = 0
    kde_argmax_kernel.launches = 0
    t0 = time.perf_counter()
    got = detect_univariate(model, X, index, known, combination="mult",
                            device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"mobius_linear": mobius_linear_kernel.launches,
                "kde_argmax": kde_argmax_kernel.launches}
    print(f"[main] detect_univariate, {N_WINDOWS} windows of {WIDTH}, "
          f"combination mult, on {device}: {seconds:.3f} s (first call); "
          f"kernel launches {launches}")
    if launches != {"mobius_linear": 2, "kde_argmax": 1}:
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
    score_diff = float(np.max(np.abs(scores - want["scores"])
                              / np.maximum(np.abs(want["scores"]), 1e-6)))
    print(f"[main] scores: max relative diff to the CPU {score_diff:.3e}; "
          f"exact zeros at the same positions: "
          f"{np.array_equal(scores == 0, want['scores'] == 0)}")
    iv, want_iv = got["intervals"], want["intervals"]
    print(f"[main] intervals (start, end, score): {iv.tolist()}")
    print(f"[main] known anomalies: {known.tolist()}")
    print(f"[main] confusion (tn, fp, fn, tp) {got['confusion']}, "
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
    launches, X, model = phase_main_path(device)
    wps, k1, k2 = phase_timing(device, X, model)

    kernels = [
        {"name": "mobius_linear", "route": "cuda",
         "source": "hypad_tpu_torch/csrc/mobius_linear.cu",
         "replaces": "hypad_tpu/manifold/kernels.py:35",
         "launches": launches["mobius_linear"],
         "launches_per_call": launches["mobius_linear"],
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
         "max_abs_err": k2["max_abs_err"],
         "tolerance": "tie level: a differing value is a sample of its own "
                      "row, at most 1% of rows differ",
         "tie_flips": k2["tie_flips"], "edge_case_tie_flips": k2_flips,
         "exps": k2["exps"],
         "ms": k2["ms"], "kernel_ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
    ]
    OUT_DIR.mkdir(exist_ok=True)
    summary = {"card": card, "detect_20k_wps": wps, "kernels": kernels,
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
