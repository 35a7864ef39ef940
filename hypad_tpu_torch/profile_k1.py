"""K1 (MobiusLinear) at the generator step's shapes, beside a baseline's K1,
on a GPU: where its time goes, and what a zero-padded launch would cost.

    python3 -m hypad_tpu_torch.profile_k1 --baseline-dir DIR [--reps N]
        [--variant kFewWarps=2 ...] [--widths 150 256 ...]
        [--split-ranks 4 ...] [--split-slice 16 ...] [--split-blocks 132 ...]

``DIR`` holds another ``mobius_linear.cu`` of the same C interface, for
example a parent commit's ``hypad_tpu_torch/csrc`` unpacked with ``git
archive`` into the gitignored ``_checkout/``.

Shapes: the generator step's 2B and B rows (128 and 64, batch 64) and 64
rows a signal on the signal axis (S = 3), at the feature counts of the
shipped configurations, the wide instance's and the any-width one's (51,
100, 123, 150, 256, 300), and the many-rows shapes: the detector's (20,000,
100), the CASAS-width detections (20,000 and 50,000 rows of 150), the wide
instance's (50,000, 256) and the any-width instance's (2,000, 300) and
(4,096, 512).

At each shape:

* checks: the tree's K1 within 1e-6 of the plain version, bitwise the
  baseline's, and on the signal axis each signal bitwise its own
  single-signal launch;
* names the kernel the tree's K1 launches at the shape (``launched``: the
  few-rows split instance, ``mobius_linear_kernel_split`` /
  ``mobius_linear_wide_kernel_split``, at the generator step's shapes up
  to 256 columns), and gives its plan there (``split_plan``);
* times, with CUDA events: the baseline's and the tree's K1 in turns
  (baseline, tree, tree, baseline); each ``--variant`` (the tree with
  ``constexpr int`` constants set otherwise, checked bitwise the tree;
  ``--split-ranks``, ``--split-slice`` and ``--split-blocks`` are
  variants of the few-rows split instance's cluster size, the fewest
  columns of a rank's slice and the blocks a launch aims at, which set
  the rows of a tile a rank owns);
  the probes, at the few-rows shapes: "stage", the kernel built to stage
  W and the x tiles and exit (no FMAs, no epilogue, no store), and
  "no_w", the kernel built without staging W (it computes on whatever
  shared memory holds), of both; and of the tree, "fma" and "epilogue",
  built to exit after the FMAs and after the epilogue (neither stores),
  and, where the source has the few-rows split instance, "handoff", built
  to exit after the products' hand-off and its cluster barrier; so that
  W's staging is about full - no_w, the FMAs fma - stage, the hand-off
  handoff - fma, the epilogue epilogue - fma (or - handoff) and the store
  full - epilogue (the baseline's
  at the few-rows shapes only; the tree's also at every shape above 128
  columns, whose probe builds wait for their copies before they exit); the
  plain version's time and the bound (``k1_cost``); an empty kernel's
  launch-to-end time; and, at 51 and 123, the yardstick of JAX's
  wrapper, which pads the lanes: x and W zero-padded to the next width
  the bulk copy takes (52, 124) and the baseline's K1 launched on them
  (the padding itself is timed apart); and on the host clock, the
  baseline's and the tree's call in turns (``host_in_turns``: the
  wrapper and the C entry up to the launch, the shape's planning
  included).

The tree's probes come from its ``HYPAD_K1_PROBE`` hooks (1 stage, 2 no_w,
3 fma, 4 epilogue, 5 handoff); a baseline without them (the K1 of before the hooks)
gets "stage" and "no_w" by text substitutions of its source, written
beside it so that it includes its own headers. Prints one line a shape
and the card, then one JSON line, also written to ``profile_k1.json`` in
``profile_detect.OUT_DIR``. Needs CUDA; the libraries go under
``hypad_tpu_torch/_build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import time
from pathlib import Path

import torch

from hypad_tpu_torch import _build
from hypad_tpu_torch.manifold import kernels as mk
from hypad_tpu_torch.profile_critic_step import OUT, variant_jobs
from hypad_tpu_torch.profile_detect import OUT_DIR, cuda_ms

TRAIN_WIDTHS = (51, 100, 123, 150, 256, 300)
TRAIN_BATCH = 64    # configs' batch_size: the step runs 2B and B rows
FLEET_SIGNALS = 3
MANY_ROWS = ((20_000, 100), (20_000, 150), (50_000, 150), (50_000, 256),
             (2_000, 300), (4_096, 512))
# peak rates of the H100 SXM (data sheet): HBM3, f32 outside the tensor
# cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12
# accurate expf issues one ex2 on the special-function units: 16 a clock an
# SM, 132 SMs, at the 1.98 GHz boost clock
H100_SFU_EXP_PER_S = 132 * 16 * 1.98e9
K1_TOL = 1e-6
PROBES = {"stage": 1, "no_w": 2, "fma": 3, "epilogue": 4, "handoff": 5}
# the K1 of before the HYPAD_K1_PROBE hooks: (old, new) text substitutions
# of each probe, each old text found exactly once
BASELINE_PROBES = {
    "stage": (
        ("    fma_tile<TN, TM>(acc, xt + rl * s.xs, s.xs, ws + c0 * s.xs, "
         "s.xs, s.xs);", "    return;"),
        ("      if (live)\n        fma_tile<TN, TM>(acc, xt + rl * s.xs + "
         "k0, s.xs, ws + c0 * cs, cs, n);\n", ""),
        ("    if (live) {\n      const float b2 = bias_sq<TN>(bias, c0);",
         "    if (false) {\n      const float b2 = bias_sq<TN>(bias, c0);"),
    ),
    "no_w": (
        ("      hypad::mbar_expect_bytes(wbar, w_bytes);\n"
         "      hypad::bulk_load(ws, w, w_bytes, wbar);",
         "      hypad::mbar_expect_bytes(wbar, 0u * w_bytes);"),
        ("    for (int idx = threadIdx.x; idx < kCols * s.xs; idx += "
         "blockDim.x) {\n      const int j = idx / s.xs, k = idx - j * "
         "s.xs;\n      ws[idx] = (j < s.dout && k < s.din) ? w[j * s.din + "
         "k] : 0.0f;\n    }\n", ""),
        ("        for (int idx = threadIdx.x; idx < kCols * n; idx += "
         "blockDim.x) {\n          const int j = idx / n, k = idx - j * n;\n"
         "          ws[j * cs + k] = (j < s.dout && k0 + k < s.din)\n"
         "                               ? w[(size_t)j * s.din + k0 + k]\n"
         "                               : 0.0f;\n        }\n", ""),
    ),
}


def probe_source(text, kind):
    """``text`` (a ``mobius_linear.cu``) built as the probe ``kind`` (a key
    of PROBES): through its ``HYPAD_K1_PROBE`` hook where it has one, else
    by ``BASELINE_PROBES``' substitutions ("stage" and "no_w" only)."""
    if "HYPAD_K1_PROBE" in text:
        return f"#define HYPAD_K1_PROBE {PROBES[kind]}\n{text}"
    for old, new in BASELINE_PROBES[kind]:
        if text.count(old) != 1:
            raise RuntimeError(f"probe {kind!r}: the baseline's K1 does not "
                               f"hold this text once:\n{old}")
        text = text.replace(old, new)
    return text


# the few-rows split instance's constants that --split-ranks,
# --split-slice and --split-own-rows set
SPLIT_FLAGS = {"split_ranks": "kFewSplitRanks", "split_slice": "kFewSplitSlice",
               "split_blocks": "kFewSplitBlocks"}


def split_variants(args):
    """The ``--variant`` specs of the split flags in ``args`` (an argparse
    namespace or a dict of SPLIT_FLAGS' keys): one variant a value."""
    get = args.get if isinstance(args, dict) else (
        lambda key: getattr(args, key, None))
    return [f"{name}={value}" for key, name in SPLIT_FLAGS.items()
            for value in get(key) or ()]


SPLIT_PLAN_KEYS = ("ranks", "slice", "own", "tile_rows", "clusters",
                   "threads", "smem")


def split_plan(lib, signals, rows, din, dout, sms):
    """The few-rows split instance's plan (``mobius_linear_split_plan`` of
    ``lib``, a build of csrc/mobius_linear.cu) for a launch of ``signals``
    x ``rows`` of din -> dout on a card of ``sms`` SMs: {SPLIT_PLAN_KEYS:
    value}, or None where the few-rows kernels take the launch."""
    fn = lib.mobius_linear_split_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * len(SPLIT_PLAN_KEYS))()
    if fn(signals, rows, din, dout, sms, out) != 0:
        return None
    return dict(zip(SPLIT_PLAN_KEYS, out))


def launched(fn, tries=8):
    """The names of the device kernels ``fn()`` launches (a second call,
    under ``torch.profiler``; a trace with no device event is taken again
    after a short pause, up to ``tries`` times), or [] where the profiler
    records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
        time.sleep(0.5)
    return names


def variant_source(text, spec):
    """``text`` with the ``constexpr int`` constants that ``spec``
    ("name=value,name=value") names set to its values."""
    for item in spec.split(","):
        name, value = item.split("=")
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            raise RuntimeError(f"mobius_linear.cu does not define {name} "
                               "once")
    return text


def k1_cost(rows, din, dout):
    """(bytes, operations) of K1: x, W, b read once, out written once; the
    product plus the ~16 f32 operations of the clamp chain per output."""
    return (4 * (rows * din + dout * din + dout + rows * dout),
            2 * rows * din * dout + 16 * rows * dout)


def bound(nbytes, ops, exps=0):
    """(ms, "bytes" or "operations"): the least time on the H100 of work
    that moves ``nbytes``, does ``ops`` f32 operations and ``exps``
    accurate exps, the largest of the bytes over the memory rate, the
    operations over the f32 rate and the exps over the special-function
    units' rate, and which it is (the exps are operations too)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = max(ops / H100_F32_FLOP_PER_S, exps / H100_SFU_EXP_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_bound_ms(rows, width, signals=None):
    """The least time of K1 at (rows, width) (``signals`` stacked) on the
    H100 (``bound``)."""
    return bound(*(v * (signals or 1) for v in k1_cost(rows, width, width)))[0]


def probed(rows, width):
    """Whether the probe builds are timed at (rows, width): the few-rows
    shapes, and every shape above 128 columns (the tree's wide and
    any-width instances wait for their copies before a probe exits; the
    narrow many-rows kernel would exit with a tile's copy in flight)."""
    return rows <= 2 * TRAIN_BATCH or width > 128


def bulk_width(width):
    """The next width at or above ``width`` whose rows the narrow kernel
    takes by one bulk copy (a multiple of 4 whose quarter is odd), or
    None above the narrow instance's 128."""
    d = (width + 3) // 4 * 4
    if (d // 4) % 2 == 0:
        d += 4
    return d if d <= 128 else None


def k1_case(rows, width, signals=None, device="cuda"):
    """(x, w, b) of the full model's MobiusLinear head at ``width``
    features, seeded from the shape: x (rows, width) uniform in [-1, 1];
    with ``signals``, S heads stacked and x (S, rows, width)."""
    from hypad_tpu_torch.models.tadgan import init_tadgan

    g = torch.Generator().manual_seed(rows + width + (signals or 0))
    heads = [init_tadgan(g, width, hyperbolic=True,
                         device=device)["decoder"].hyperbolic_linear
             for _ in range(signals or 1)]
    w = torch.stack([h.w.detach() for h in heads])
    b = torch.stack([h.b.detach() for h in heads])
    x = (torch.rand(signals or 1, rows, width, generator=g) * 2 - 1).to(
        device)
    if signals is None:
        return x[0].contiguous(), w[0].contiguous(), b[0].contiguous()
    return x.contiguous(), w.contiguous(), b.contiguous()


def training_shapes():
    """[(label, rows, width, signals)] of the generator step's K1 calls
    and the detector's two, in the order they are printed."""
    shapes = []
    for width in TRAIN_WIDTHS:
        shapes += [(f"({2 * TRAIN_BATCH}, {width})", 2 * TRAIN_BATCH, width,
                    None),
                   (f"({TRAIN_BATCH}, {width})", TRAIN_BATCH, width, None),
                   (f"({FLEET_SIGNALS}, {TRAIN_BATCH}, {width})",
                    TRAIN_BATCH, width, FLEET_SIGNALS)]
    return shapes + [(f"({rows}, {width})", rows, width, None)
                     for rows, width in MANY_ROWS]


def launcher(lib):
    """fn(x, w, b) -> out through the library ``lib``'s entries (the
    signal-axis one for a 3-D x)."""
    one, signals = mk.bind(lib), mk.bind_signals(lib)
    return lambda x, w, b: mk.launch_with(signals if x.dim() == 3 else one,
                                          x, w, b)


def padded(x, w, width):
    """x and W zero-padded along k to ``width`` (b unchanged): the
    yardstick's inputs."""
    pad = width - x.shape[-1]
    return (torch.nn.functional.pad(x, (0, pad)).contiguous(),
            torch.nn.functional.pad(w, (0, pad)).contiguous())


def check_case(tree, x, w, b, label, baseline=None):
    """The tree's output at one shape: within K1_TOL of plain, bitwise
    the ``baseline`` launcher's where given, and on the signal axis each
    signal bitwise its own launch. Returns (max abs diff to plain,
    whether bitwise the baseline or None); raises on a failed check."""
    got = tree(x, w, b)
    err = (got - mk.mobius_linear(x, w, b)).abs().max().item()
    if not err <= K1_TOL:
        raise SystemExit(f"FAILED: K1 at {label} differs from its plain "
                         f"version by {err}")
    if x.dim() == 3:
        for i in range(x.shape[0]):
            if not torch.equal(got[i], tree(x[i].contiguous(), w[i], b[i])):
                raise SystemExit(f"FAILED: K1 at {label}: signal {i} is not "
                                 "bitwise its own launch")
    same = None if baseline is None else torch.equal(got,
                                                     baseline(x, w, b))
    return err, same


def build(baseline_dir, variants=()):
    """{"tree", "baseline", "probes": {name: fn}, "variants": {spec: fn},
    "empty"}: every library built at once, the baseline's and its probes
    from where they lie."""
    from hypad_tpu_torch.profile_kernels import EMPTY_SOURCE

    base = Path(baseline_dir)
    tree = (_build.CSRC / "mobius_linear.cu").read_text()
    old = (base / "mobius_linear.cu").read_text()
    sources = {"empty": EMPTY_SOURCE, "k1_tree": tree}
    for kind in PROBES:
        sources[f"k1_tree_{kind}"] = probe_source(tree, kind)
    for i, spec in enumerate(variants):
        sources[f"k1_variant{i}"] = variant_source(tree, spec)
    jobs = variant_jobs(sources)
    OUT.mkdir(parents=True, exist_ok=True)
    jobs["k1_baseline"] = (base / "mobius_linear.cu",
                           OUT / "libk1_baseline.so")
    old_probes = ({kind: n for kind, n in PROBES.items()
                   if f"HYPAD_K1_PROBE == {n}" in old or n < 5}
                  if "HYPAD_K1_PROBE" in old else BASELINE_PROBES)
    for kind in old_probes:
        src = base / f"mobius_linear_probe_{kind}.cu"
        src.write_text(probe_source(old, kind))
        jobs[f"k1_baseline_{kind}"] = (src, OUT / f"libk1_baseline_{kind}.so")
    for name, (_, log) in _build.compile_sources(jobs).items():
        for line in log.splitlines():
            if name == "k1_tree" and ("entry function" in line
                                      or "registers" in line
                                      or "spill" in line):
                print(f"[build] {name}: {line.strip()}")
    libs = {name: ctypes.CDLL(str(lib)) for name, (_, lib) in jobs.items()}
    empty = libs["empty"].empty_forward
    empty.argtypes = [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"tree": launcher(libs["k1_tree"]),
            "plan": lambda rows, width, signals: split_plan(
                libs["k1_tree"], signals or 1, rows, width, width, sms),
            "baseline": launcher(libs["k1_baseline"]),
            "probes": {**{f"baseline_{kind}":
                          launcher(libs[f"k1_baseline_{kind}"])
                          for kind in old_probes},
                       **{f"tree_{kind}": launcher(libs[f"k1_tree_{kind}"])
                          for kind in PROBES}},
            "variants": {spec: launcher(libs[f"k1_variant{i}"])
                         for i, spec in enumerate(variants)},
            "empty": empty}


def in_turns(fns, reps):
    """{label: median ms} of each ``fns[label]()``, timed in the order
    given, then reversed, then given again (three ``cuda_ms`` each)."""
    order = list(fns)
    times = {label: [] for label in order}
    for label in order + order[::-1] + order:
        times[label].append(cuda_ms(fns[label], reps))
    return {label: statistics.median(t) for label, t in times.items()}


def host_us(fn, calls=200):
    """The median microseconds of the host that a call of ``fn`` takes,
    over ``calls`` calls; the device is synchronised every 10 calls,
    outside the timed spans, so that its queue never fills."""
    times = []
    for i in range(calls):
        if i % 10 == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_in_turns(fns):
    """{label: median us} of ``host_us`` of each ``fns[label]``, in the
    order given, then reversed, then given again."""
    order = list(fns)
    times = {label: [] for label in order}
    for label in order + order[::-1] + order:
        times[label].append(host_us(fns[label]))
    return {label: statistics.median(t) for label, t in times.items()}


def profile(fns, reps, widths=None):
    """One record a shape (those of ``widths`` where given): checks and
    times (see the module's docstring)."""
    from hypad_tpu_torch.profile_kernels import empty_launch

    empty = empty_launch(fns["empty"])
    records = {"empty_kernel_ms": in_turns({"empty": empty}, reps)["empty"]}
    print(f"[k1] an empty kernel, launch to end: "
          f"{records['empty_kernel_ms']:.5f} ms")
    for label, rows, width, signals in training_shapes():
        if widths and width not in widths:
            continue
        x, w, b = k1_case(rows, width, signals)
        err, same = check_case(fns["tree"], x, w, b, label, fns["baseline"])
        calls = {"baseline": lambda: fns["baseline"](x, w, b),
                 "tree": lambda: fns["tree"](x, w, b)}
        for spec, fn in fns["variants"].items():
            if not torch.equal(fn(x, w, b), fns["tree"](x, w, b)):
                raise SystemExit(f"FAILED: variant {spec} is not bitwise the "
                                 f"tree at {label}")
            calls[spec] = lambda fn=fn: fn(x, w, b)
        pad = bulk_width(width) if width != bulk_width(width) else None
        if pad is not None:
            xp, wp = padded(x, w, pad)
            if not torch.equal(fns["baseline"](xp, wp, b),
                               fns["baseline"](x, w, b)):
                raise SystemExit(f"FAILED: the padded yardstick at {label} "
                                 "is not bitwise the baseline")
            calls[f"yardstick (padded to {pad})"] = (
                lambda: fns["baseline"](xp, wp, b))
            calls["padding x and W"] = lambda: padded(x, w, pad)
        # the baseline's probes at the few-rows shapes only (see probed)
        for name, fn in fns["probes"].items():
            if probed(rows, width) and (rows <= 2 * TRAIN_BATCH
                                        or name.startswith("tree_")):
                calls[f"probe {name}"] = lambda fn=fn: fn(x, w, b)
        rec = {"max_abs_err": err, "bitwise_baseline": same,
               "kernel": launched(calls["tree"]),
               "split_plan": fns["plan"](rows, width, signals),
               "ms": in_turns(calls, reps),
               "plain_ms": cuda_ms(lambda: mk.mobius_linear(x, w, b),
                                   max(reps // 10, 5)),
               "bound_ms": k1_bound_ms(rows, width, signals),
               "host_us": host_in_turns({"baseline": calls["baseline"],
                                         "tree": calls["tree"]})}
        records[label] = rec
        t = rec["ms"]
        print(f"[k1] {label}: baseline {t['baseline']:.5f} ms, tree "
              f"{t['tree']:.5f} ms, plain {rec['plain_ms']:.5f} ms, bound "
              f"{rec['bound_ms']:.6f} ms; max abs diff {err:.3e}, bitwise "
              f"the baseline: {same}; host us baseline "
              f"{rec['host_us']['baseline']:.2f}, tree "
              f"{rec['host_us']['tree']:.2f}; tree launches "
              f"{rec['kernel']}, split plan {rec['split_plan']}; "
              + ", ".join(f"{k} {v:.5f}" for k, v in t.items()
                          if k not in ("baseline", "tree")))
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline-dir", required=True,
                        help="directory of the baseline's mobius_linear.cu")
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--widths", type=int, nargs="*",
                        help="only the shapes of these widths")
    parser.add_argument("--variant", nargs="*", default=(),
                        help="also build the tree with these constants "
                        "(name=value,...), check its bits, and time it")
    parser.add_argument("--split-ranks", type=int, nargs="*",
                        help="variants of the few-rows split instance's "
                        "cluster size (kFewSplitRanks; 0: not launched)")
    parser.add_argument("--split-slice", type=int, nargs="*",
                        help="variants of the fewest columns of a rank's "
                        "slice (kFewSplitSlice)")
    parser.add_argument("--split-blocks", type=int, nargs="*",
                        help="variants of the blocks a launch aims at "
                        "(kFewSplitBlocks), which set a rank's rows")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_k1: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(args.baseline_dir, list(args.variant) + split_variants(args))
    records = profile(fns, args.reps, args.widths)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    out = {"card": card, "records": records}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "profile_k1.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
