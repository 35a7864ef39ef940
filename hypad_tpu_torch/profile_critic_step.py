"""Variants of the critic-step kernel (K4, K5) side by side on a GPU.

    python3 -m hypad_tpu_torch.profile_critic_step [--baseline OLD.cu]
        [--cluster-blocks 1 8 16]

Builds ``csrc/critic_step.cu`` once for each cluster size (its
``kClusterBlocks`` constant replaced; a size above 8, the portable maximum,
also allows non-portable clusters) and, with ``--baseline``, another source
of the same interface, for example a parent commit's kernel from
``git show REV:hypad_tpu_torch/csrc/critic_step.cu``. For each case (B = 64
hyperbolic and Euclidean, B = 13, 3 and 100, the cases of ``chip_smoke.py``)
it launches every variant's K5 and K4 twice and prints the largest abs diff
against the plain autograd versions, whether the two launches give the same
bits, and whether the losses, the gradients and K5's bigx and bigz equal
the first variant's bit for bit. Then it times K5 and K4 at B = 64 with CUDA
events, the variants in turns (in order, then reversed, twice). Prints one
line per case and variant, then one JSON line. Needs CUDA; the libraries go
under ``hypad_tpu_torch/_build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from hypad_tpu_torch import _build
from hypad_tpu_torch.profile_detect import cuda_ms
from hypad_tpu_torch.train import critic_kernel as ck

OUT = _build.BUILD_DIR / "variants"
SHIPPED = "constexpr int kClusterBlocks = 8;"
LAUNCH = "  const cudaError_t err = cudaLaunchKernelEx("
NON_PORTABLE = ("  cudaFuncSetAttribute(kernel, "
                "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")
CASES = ((True, 64), (False, 64), (True, 13), (True, 3), (True, 100))
WIDTH, LATENT, HIDDEN = 100, 20, 20


def variant_sources(baseline, sizes):
    """{name: source text}: the baseline first, then one per cluster size."""
    shipped = (_build.CSRC / "critic_step.cu").read_text()
    if SHIPPED not in shipped or LAUNCH not in shipped:
        raise RuntimeError("csrc/critic_step.cu no longer has the cluster "
                           "constant or the launch this tool rewrites")
    out = {"baseline": Path(baseline).read_text()} if baseline else {}
    for n in sizes:
        text = shipped.replace(SHIPPED, f"constexpr int kClusterBlocks = {n};")
        out[f"cluster{n}"] = (text.replace(LAUNCH, NON_PORTABLE + LAUNCH)
                              if n > 8 else text)
    return out


def variant_jobs(sources):
    """``_build.compile_sources`` jobs of {name: CUDA source text}: each
    text written to ``_build/variants/<name>.cu`` (so ``csrc/`` is its
    include path), its library beside it."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        jobs[name] = (src, OUT / f"lib{name}.so")
    return jobs


def compile_variants(sources):
    """{name: ctypes.CDLL} of {name: CUDA source text}, built with all nvcc
    processes at once; prints each variant's ptxas lines."""
    jobs = variant_jobs(sources)
    for name, (_, log) in _build.compile_sources(jobs).items():
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"[build] {name}: {line.strip()}")
    return {name: ctypes.CDLL(str(lib)) for name, (_, lib) in jobs.items()}


def build(sources):
    """{name: bound critic-step library} of {name: source text}."""
    return {name: ck.bind(lib)
            for name, lib in compile_variants(sources).items()}


def launcher(lib, fn, ptrs, dims, extra):
    """A function that launches ``fn`` of ``lib`` on prepared slots; the
    workspace is allocated once and held by the returned closure."""
    ws = torch.empty(int(lib.critic_step_workspace_floats(dims)),
                     dtype=torch.float32, device="cuda")
    ptrs[ck.SLOT_WS] = ws.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = getattr(lib, fn)(ptrs, dims, *extra, stream)
        if err != 0:
            raise RuntimeError(f"{fn}: CUDA error {err}")
    return go


def critic_case(device, hyperbolic, B, width=WIDTH, seed=0):
    """A full-width model and one critic step's inputs (x, draws) on
    ``device``, from ``seed``; ``width`` is the signal's (a multivariate
    run's feature count)."""
    from hypad_tpu_torch.models.tadgan import init_tadgan

    g = torch.Generator().manual_seed(100 + B + hyperbolic + 1000 * seed)
    model = init_tadgan(g, width, hyperbolic=hyperbolic, device=device)
    draws = {"z_x": torch.randn(B, LATENT, generator=g),
             "a_x": torch.rand(B, width, generator=g),
             "z_z": torch.randn(B, LATENT, generator=g),
             "a_z": torch.rand(B, LATENT, generator=g),
             "m_cx": torch.rand(4, 3 * B, HIDDEN, generator=g) < 0.75,
             "m_cz": torch.rand(2, 3 * B, HIDDEN, generator=g) < 0.8,
             "m_dec": torch.rand(B, 128, generator=g) < 0.8}
    x = torch.rand(B, width, generator=g) * 2 - 1
    return model, x.to(device), {k: v.to(device) for k, v in draws.items()}


def flat(out):
    """(lx, lz, grads_cx, grads_cz) as one list of tensors, the gradients
    in key order."""
    return [out[0], out[1]] + [out[i][k] for i in (2, 3)
                               for k in sorted(out[i])]


def same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def max_diff(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def run_k5(lib, model, x, d, hyperbolic):
    ptrs, dims, out, rows = ck.k5_launch_args(model, x, d, hyperbolic)
    launcher(lib, "critic_step_full_forward", ptrs, dims,
             (int(hyperbolic),))()
    torch.cuda.synchronize()
    return flat(out) + list(rows)


def run_k4(lib, args):
    ptrs, dims, out = ck.k4_launch_args(*args)
    launcher(lib, "critics_fused_grads_forward", ptrs, dims, ())()
    torch.cuda.synchronize()
    return flat(out)


def check_cases(libs):
    """One line per case and variant; returns the per-case records."""
    records = []
    for hyperbolic, B in CASES:
        model, x, d = critic_case("cuda", hyperbolic, B)
        bigx, bigz = ck.critic_step_inputs(model, x, d, hyperbolic)
        args = (model["critic_x"], model["critic_z"], bigx, bigz, d["m_cx"],
                d["m_cz"])
        want5 = flat(ck.critic_step_plain(model, x, d, hyperbolic))
        want4 = flat(ck.critics_fused_grads_plain(*args))
        first = None
        for name, lib in libs.items():
            k5, k5b = (run_k5(lib, model, x, d, hyperbolic) for _ in "ab")
            k4, k4b = (run_k4(lib, args) for _ in "ab")
            first = first or (k5, k4)
            rec = {"case": f"B={B} hyperbolic={hyperbolic}", "variant": name,
                   "k5_max_abs_diff": max_diff(k5[:-2], want5),
                   "k4_max_abs_diff": max_diff(k4, want4),
                   "repeatable": same_bits(k5, k5b) and same_bits(k4, k4b),
                   "rows_same_bits_as_first": same_bits(k5[-2:],
                                                        first[0][-2:]),
                   "grads_same_bits_as_first": (same_bits(k5, first[0])
                                                and same_bits(k4, first[1]))}
            records.append(rec)
            print(f"[check] {rec['case']} {name}: K5 "
                  f"{rec['k5_max_abs_diff']:.3e}, K4 "
                  f"{rec['k4_max_abs_diff']:.3e} from autograd; "
                  f"repeatable {rec['repeatable']}; bigx/bigz "
                  f"{rec['rows_same_bits_as_first']} and losses, gradients "
                  f"{rec['grads_same_bits_as_first']} bit for bit as "
                  f"{next(iter(libs))}")
    return records


def time_variants(libs):
    """{name: {"k5": [ms...], "k4": [ms...]}} at B = 64, hyperbolic."""
    model, x, d = critic_case("cuda", True, 64)
    bigx, bigz = ck.critic_step_inputs(model, x, d, True)
    args = (model["critic_x"], model["critic_z"], bigx, bigz, d["m_cx"],
            d["m_cz"])
    calls, keep = {}, []
    for name, lib in libs.items():
        p5, dims5, out5, rows = ck.k5_launch_args(model, x, d, True)
        p4, dims4, out4 = ck.k4_launch_args(*args)
        keep.append((p5, dims5, out5, rows, p4, dims4, out4))
        calls[name] = (launcher(lib, "critic_step_full_forward", p5, dims5,
                                (1,)),
                       launcher(lib, "critics_fused_grads_forward", p4, dims4,
                                ()))
    times = {name: {"k5": [], "k4": []} for name in calls}
    for _ in range(2):
        for name in list(calls) + list(reversed(calls)):
            k5, k4 = calls[name]
            times[name]["k5"].append(cuda_ms(k5, 200))
            times[name]["k4"].append(cuda_ms(k4, 200))
    for name, t in times.items():
        print(f"[time] {name}: K5 ms {t['k5']}, K4 ms {t['k4']}")
    return times


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", help="another critic_step.cu source")
    parser.add_argument("--cluster-blocks", type=int, nargs="+", default=[8])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_critic_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build(variant_sources(args.baseline, args.cluster_blocks))
    records = check_cases(libs)
    times = time_variants(libs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "cases": records, "times_ms": times}))


if __name__ == "__main__":
    main()
