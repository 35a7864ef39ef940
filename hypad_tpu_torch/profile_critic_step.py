"""Variants of the critic-step kernel (K4, K5) side by side on a GPU.

    python3 -m hypad_tpu_torch.profile_critic_step [--baseline OLD.cu]
        [--cluster-blocks 1 8 16] [--phases]

Builds ``csrc/critic_step.cu`` once for each cluster size (its
``kClusterBlocks`` constant replaced; a size above 8, the portable maximum,
also allows non-portable clusters), with ``--baseline`` another source of
the same interface (for example a parent commit's kernel from ``git show
REV:hypad_tpu_torch/csrc/critic_step.cu``), and the tree's two probe
builds (its ``HYPAD_CS_PROBE`` hook): "stage", which
copies every weight into shared memory as the kernel would, waits for the
copies and exits, and "smem_w", which issues no copy and waits for none, so
that every phase computes on whatever shared memory holds (its numbers are
wrong: it is for timing, the kernel without the cost of its copies).
With ``--phases``, every source also built to return at each of PHASES
(four points of the critic), timed at the first timed shape: the phases'
times are the differences.

For each case of CASES (``chip_smoke.py``'s B = 64 hyperbolic and
Euclidean, B = 13, 3 and 100; the wide instance at F = 150 and the
any-width one at F = 300; the signal axis at S = 3 and 9) it launches every
variant's K5 and K4 twice and prints the largest abs diff against the
plain autograd versions, whether the two launches give the same bits, and
whether the losses, the gradients and K5's bigx and bigz equal the first
variant's (the baseline's, where given) bit for bit; the probes are not
checked. Then at each shape of TIMED it times K5 and K4 with CUDA events,
every variant and probe in turns (in order, then reversed, twice; the
median of the four). Prints one line per case and variant, the shared
memory a block of the tree holds at each shape, the card, then one JSON
line, also written to ``profile_critic_step.json`` in
``profile_detect.OUT_DIR``. Needs CUDA; the libraries go under
``hypad_tpu_torch/_build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from hypad_tpu_torch import _build
from hypad_tpu_torch.profile_detect import OUT_DIR, cuda_ms
from hypad_tpu_torch.train import critic_kernel as ck

OUT = _build.BUILD_DIR / "variants"
SHIPPED = "constexpr int kClusterBlocks = 8;"
LAUNCH = "  const cudaError_t err = cudaLaunchKernelEx("
NON_PORTABLE = ("  cudaFuncSetAttribute(kernel, "
                "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")
WIDTH, LATENT, HIDDEN = 100, 20, 20
# (hyperbolic, B, width, signals): chip_smoke.py's cases, the wide (F =
# 150) and any-width (F = 300) instances, and the signal axis (S = 3, 9)
CASES = ((True, 64, WIDTH, None), (False, 64, WIDTH, None),
         (True, 13, WIDTH, None), (True, 3, WIDTH, None),
         (True, 100, WIDTH, None), (True, 64, 150, None),
         (True, 64, 300, None), (True, 64, WIDTH, 3), (True, 64, WIDTH, 9))
TIMED = ((True, 64, WIDTH, None), (False, 64, WIDTH, None),
         (True, 64, 150, None), (True, 64, 300, None), (True, 64, WIDTH, 3),
         (True, 64, WIDTH, 9))
PROBE_HOOK = "HYPAD_CS_PROBE"
PROBES = {"stage": 1, "smem_w": 2}
# Phase probes of any critic_step.cu, the parent's too: the kernel built to
# return at a point of the critic, (anchor, "after" or "before") each, the
# first anchor the source holds once; the phases' times are differences. A
# source that stages by cp.async first waits for its own copies.
PHASES = {
    "to_critic": (("  const Rows brows = rank_rows(B, rank, 1);  // batch "
                   "rows b\n", "after"),),
    "to_gp": (("  // GP input gradient: the backward chain on the "
               "interpolate rows\n", "before"),),
    "to_bar1": (("  // Barrier 1: every rank's wl and sum g^2 partials are "
                 "written.\n", "before"),),
    "to_bar2": (("  // Barrier 2: every partial is written. Each gradient "
                 "entry has one owner\n", "before"),),
}


def k5_weight_bytes(dims, hyperbolic):
    """{"x": bytes, "z": bytes} of the weights one block of each side of K5
    reads, at dims (B, W, L, Hx, Hz, He, D1, Hd): side x the decoder's
    dense1, both LSTM layers' i, g and o rows of w_ih, b_ih and b_hh in
    both directions, dense2, the Mobius head when hyperbolic, and
    critic_x; side z the encoder's LSTM rows the same way, its dense layer
    and critic_z. At T = 1 with zero state the f rows and w_hh are never
    read."""
    _, W, L, Hx, Hz, He, D1, Hd = dims

    def dense(d_out, d_in):
        return d_out * d_in + d_out

    def lstm(H, d_in):  # both directions
        return 2 * (3 * H * d_in + 6 * H)

    def critic(d_in, H, layers):
        return dense(H, d_in) + (layers - 1) * dense(H, H) + dense(1, H)

    x = (dense(D1, L) + lstm(Hd, D1) + lstm(Hd, 2 * Hd) + dense(W, 2 * Hd)
         + (dense(W, W) if hyperbolic else 0) + critic(W, Hx, 4))
    z = lstm(He, W) + dense(L, 2 * He) + critic(L, Hz, 2)
    return {"x": 4 * x, "z": 4 * z}


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


def probe_source(text, kind):
    """``text`` (a ``critic_step.cu`` with the probe hook) built as the
    probe ``kind``, a key of PROBES."""
    if f"#if {PROBE_HOOK}" not in text:
        raise RuntimeError(f"this critic_step.cu has no {PROBE_HOOK} hook")
    return f"#define {PROBE_HOOK} {PROBES[kind]}\n{text}"


def phase_source(text, phase):
    """``text`` (a ``critic_step.cu``) built to return at ``phase``, a key
    of PHASES."""
    for anchor, where in PHASES[phase]:
        if text.count(anchor) == 1:
            exit_ = ("  hypad::cp_async_wait_all();\n  return;\n"
                     if "hypad::cp_async" in text else "  return;\n")
            return text.replace(anchor, anchor + exit_ if where == "after"
                                else exit_ + anchor)
    raise RuntimeError(f"this critic_step.cu has no anchor of phase "
                       f"{phase!r}")


def probe_sources():
    """{"probe_<kind>": source} of the tree's probes."""
    shipped = (_build.CSRC / "critic_step.cu").read_text()
    return {f"probe_{kind}": probe_source(shipped, kind) for kind in PROBES}


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
    workspace is allocated once and held by the returned function."""
    ws = torch.empty(int(lib.critic_step_workspace_floats(dims)),
                     dtype=torch.float32, device="cuda")
    ptrs[ck.SLOT_WS] = ws.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = getattr(lib, fn)(ptrs, dims, *extra, stream)
        if err != 0:
            raise RuntimeError(f"{fn}: CUDA error {err}")
    go.workspace = ws
    return go


def fleet_launcher(lib, fn, slots, dims, signals, extra):
    """:func:`launcher` for a signal-axis entry: ``slots`` a
    ``critic_kernel._FleetSlots``, one workspace slice a signal."""
    ws = torch.empty((signals, int(lib.critic_step_workspace_floats(dims))),
                     dtype=torch.float32, device="cuda")
    slots.put(ck.SLOT_WS, ws, "workspace")
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = getattr(lib, fn)(slots.ptrs, slots.strides, dims, signals,
                               *extra, stream)
        if err != 0:
            raise RuntimeError(f"{fn}: CUDA error {err}")
    go.workspace = ws
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


def case_label(hyperbolic, B, width, signals):
    return (f"B={B} F={width} {'hyperbolic' if hyperbolic else 'euclidean'}"
            + (f" S={signals}" if signals else ""))


def case_inputs(device, hyperbolic, B, width, signals):
    """(model, x, draws) of a case; with ``signals``, S models of seeds 0
    .. S - 1 stacked as the fleet stacks them, x and draws with a leading
    S."""
    if signals is None:
        return critic_case(device, hyperbolic, B, width)
    from hypad_tpu_torch.train import fleet as fl

    cases = [critic_case(device, hyperbolic, B, width, seed=i)
             for i in range(signals)]
    return (fl.stack_models([c[0] for c in cases]),
            torch.stack([c[1] for c in cases]),
            {k: torch.stack([c[2][k] for c in cases]) for k in cases[0][2]})


def plain(hyperbolic, signals, inputs):
    """(K5's, K4's) plain autograd outputs, flat, of a case's inputs."""
    model, x, d = inputs
    if signals is None:
        bigx, bigz = ck.critic_step_inputs(model, x, d, hyperbolic)
        return (flat(ck.critic_step_plain(model, x, d, hyperbolic)),
                flat(ck.critics_fused_grads_plain(
                    model["critic_x"], model["critic_z"], bigx, bigz,
                    d["m_cx"], d["m_cz"])))
    bigx, bigz = ck.critic_step_inputs_fleet(model, x, d, hyperbolic)
    return (flat(ck.critic_step_fleet_plain(model, x, d, hyperbolic)),
            flat(ck.critics_fused_grads_fleet_plain(model, bigx, bigz,
                                                    d["m_cx"], d["m_cz"])))


def launchers(lib, hyperbolic, signals, inputs):
    """(k5, k4, out5, out4): functions that launch ``lib``'s K5 and K4 on
    a case's inputs, slots prepared once, and the flat outputs each fills
    (K5's with bigx and bigz last); the returned functions hold every
    buffer they write."""
    model, x, d = inputs
    if signals is None:
        p5, dims5, o5, rows = ck.k5_launch_args(model, x, d, hyperbolic)
        bigx, bigz = ck.critic_step_inputs(model, x, d, hyperbolic)
        p4, dims4, o4 = ck.k4_launch_args(model["critic_x"],
                                          model["critic_z"], bigx, bigz,
                                          d["m_cx"], d["m_cz"])
        k5 = launcher(lib, "critic_step_full_forward", p5, dims5,
                      (int(hyperbolic),))
        k4 = launcher(lib, "critics_fused_grads_forward", p4, dims4, ())
    else:
        s5, dims5, o5, rows = ck.k5_fleet_launch_args(model, x, d,
                                                      hyperbolic)
        bigx, bigz = ck.critic_step_inputs_fleet(model, x, d, hyperbolic)
        s4, dims4, o4 = ck.k4_fleet_launch_args(model, bigx, bigz, d["m_cx"],
                                                d["m_cz"])
        k5 = fleet_launcher(lib, "critic_step_full_signals_forward", s5,
                            dims5, signals, (int(hyperbolic),))
        k4 = fleet_launcher(lib, "critics_fused_grads_signals_forward", s4,
                            dims4, signals, ())
    out5, out4 = flat(o5) + list(rows), flat(o4)
    k5.outputs, k4.outputs = out5, out4 + [bigx, bigz]
    return k5, k4, out5, out4


def flat(out):
    """(lx, lz, grads_cx, grads_cz) as one list of tensors, the gradients
    in key order."""
    return [out[0], out[1]] + [out[i][k] for i in (2, 3)
                               for k in sorted(out[i])]


def same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def max_diff(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def run_twice(fn, outputs):
    """Two launches of ``fn``: copies of ``outputs`` after each."""
    got = []
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        got.append([t.clone() for t in outputs])
    return got


def check_cases(libs, cases=CASES):
    """One line per case and variant; returns the per-case records."""
    records = []
    for case in cases:
        hyperbolic, B, width, signals = case
        inputs = case_inputs("cuda", *case)
        want5, want4 = plain(hyperbolic, signals, inputs)
        first = None
        for name, lib in libs.items():
            k5, k4, out5, out4 = launchers(lib, hyperbolic, signals, inputs)
            k5a, k5b = run_twice(k5, out5)
            k4a, k4b = run_twice(k4, out4)
            first = first or (k5a, k4a)
            rec = {"case": case_label(*case), "variant": name,
                   "k5_max_abs_diff": max_diff(k5a[:-2], want5),
                   "k4_max_abs_diff": max_diff(k4a, want4),
                   "repeatable": same_bits(k5a, k5b) and same_bits(k4a, k4b),
                   "rows_same_bits_as_first": same_bits(k5a[-2:],
                                                        first[0][-2:]),
                   "grads_same_bits_as_first": (same_bits(k5a, first[0])
                                                and same_bits(k4a, first[1]))}
            records.append(rec)
            print(f"[check] {rec['case']} {name}: K5 "
                  f"{rec['k5_max_abs_diff']:.3e}, K4 "
                  f"{rec['k4_max_abs_diff']:.3e} from autograd; "
                  f"repeatable {rec['repeatable']}; bigx/bigz "
                  f"{rec['rows_same_bits_as_first']} and losses, gradients "
                  f"{rec['grads_same_bits_as_first']} bit for bit as "
                  f"{next(iter(libs))}")
    return records


def time_case(libs, case, reps=200):
    """{name: {"k5": median ms, "k4": median ms, "k5_runs": [...],
    "k4_runs": [...]}} of every library at one case, in turns."""
    hyperbolic, B, width, signals = case
    inputs = case_inputs("cuda", *case)
    calls = {name: launchers(lib, hyperbolic, signals, inputs)[:2]
             for name, lib in libs.items()}
    runs = {name: {"k5_runs": [], "k4_runs": []} for name in calls}
    for _ in range(2):
        for name in list(calls) + list(reversed(calls)):
            k5, k4 = calls[name]
            runs[name]["k5_runs"].append(cuda_ms(k5, reps))
            runs[name]["k4_runs"].append(cuda_ms(k4, reps))
    for name, r in runs.items():
        r["k5"] = statistics.median(r["k5_runs"])
        r["k4"] = statistics.median(r["k4_runs"])
    print(f"[time] {case_label(*case)}: " + "; ".join(
        f"{name} K5 {r['k5']:.5f} K4 {r['k4']:.5f} ms"
        for name, r in runs.items()))
    return runs


def smem_report(lib):
    """{case label: {"k5": ..., "k4": ...}} of ``critic_kernel.smem_bytes``
    at each timed shape (one signal's)."""
    out = {}
    for hyperbolic, B, width, signals in TIMED:
        dims = (B, width, LATENT, HIDDEN, HIDDEN, 50, 50, 64)
        rec = {"k5": ck.smem_bytes(dims, True, hyperbolic, lib),
               "k4": ck.smem_bytes(dims, False, hyperbolic, lib)}
        out[case_label(hyperbolic, B, width, signals)] = rec
        print(f"[smem] {case_label(hyperbolic, B, width, signals)}: K5 "
              f"{rec['k5']}; K4 {rec['k4']}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", help="another critic_step.cu source")
    parser.add_argument("--cluster-blocks", type=int, nargs="+", default=[8])
    parser.add_argument("--phases", action="store_true",
                        help="also time every variant built to return at "
                        "each of PHASES, at the first timed shape")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_critic_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = variant_sources(args.baseline, args.cluster_blocks)
    phases = {f"{name}_{phase}": phase_source(text, phase)
              for name, text in sources.items()
              for phase in (PHASES if args.phases else ())}
    libs = build({**sources, **probe_sources(), **phases})
    checked = {name: libs[name] for name in sources}
    records = check_cases(checked)
    timed = {name: lib for name, lib in libs.items() if name not in phases}
    times = {case_label(*case): time_case(timed, case) for case in TIMED}
    if phases:
        times["phases, " + case_label(*TIMED[0])] = time_case(
            {**checked, **{name: libs[name] for name in phases}}, TIMED[0])
    tree = next((name for name in sources if name == "cluster8"), None)
    smem = smem_report(libs[tree]) if tree else {}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    out = {"card": card, "cases": records, "times_ms": times, "smem": smem}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "profile_critic_step.json").write_text(json.dumps(out,
                                                                 indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
