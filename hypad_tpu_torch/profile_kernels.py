"""K1 (MobiusLinear), K2 and K3 (KDE argmax) of the tree beside a
baseline's, on a GPU.

    python3 -m hypad_tpu_torch.profile_kernels --baseline-dir DIR
        [--reps N] [--k3-variant kK3GroupThreads=256,kK3MaxGroups=4 ...]
        [--k3-probe no_exp ...] [--k2-variant kK2Ex2=0 ...]
        [--k2-probe no_exp no_hand] [--wide-only] [--narrow-only]

``DIR`` holds another ``mobius_linear.cu`` and ``kde_argmax.cu`` of the same
C interfaces, for example a parent commit's ``hypad_tpu_torch/csrc``
unpacked with ``git archive`` into the gitignored ``_checkout/``. Its K3 is
``kde_argmax_v2_forward`` of ``DIR/kde_argmax_v2.cu`` where that file exists
(a K3 without the median fallback inside, which then runs after it), else
of ``DIR/kde_argmax.cu``. The baseline's sources build where they lie, so
they include their own headers; the tree's, an empty kernel and, with
``--k3-variant``, the tree's source with K3's launch constants
(``K3_CONSTANTS``: the narrow instance's ``kK3Rows`` and
``kByOffsetBlocksPerSM``, the wider instances' ``kK3GroupThreads``,
``kK3MaxGroups``, ``kK3Threads`` and ``kK3TriMaxW``) set otherwise, and
with ``--k3-probe`` the probe builds of ``K3_PROBES``, build at once with
them; ``--k2-variant`` and ``--k2-probe`` do the same for K2
(``K2_CONSTANTS``: its group kernels' launch constants and ``kK2Ex2``, the
pair's term as ``expf`` (0) or the SFU's ``ex2`` (1); ``K2_PROBES``, built
of the baseline too where its source holds the probe's text).

Checks, at the main path's shapes:

* K1 at (20,000, 100), (128, 100) and (64, 100), the full model's head:
  the tree's kernel within 1e-6 of the plain version and of the baseline's;
* K2 and K3 at T = 20,099, W = 100 on a random critic, at T = 399 with a
  constant run of 240 (143 fallback rows), with NaNs in the critic, and at
  row widths 1, 4 and 5: the tree's use flags equal the plain version's and
  the baseline's bit for bit, its fallback rows equal ``masked_median``
  bit for bit (NaN where it is NaN), and its other rows equal the plain
  version's and the baseline's final values at tie level; K2's values and
  use flags equal the baseline K2's bit for bit, or, where
  ``k2_tie_level`` (its term the SFU's ex2), its use flags and fallback
  rows do and each other differing row is a float64 density tie; each K3
  variant's equal the tree's K3's bit for bit.

``check_k1``, ``check_k2``, ``check_k3`` and ``tie_flips`` are the checks
``chip_smoke.py`` holds the kernels to as well.

Then times, with CUDA events, in turns (baseline, tree, tree, baseline):
K1 at each shape, an empty kernel's launch-to-end time, K2 and K3 as the
detector runs them (one launch of the tree's against the baseline's, its
kernel plus the fallback's sort where the fallback is outside it), and the
scorer's IQR quartiles and its whole IQR stage on K2's output, with two
``torch.quantile`` calls as the baseline against ``scorer.quartiles``' one
sort; then the K3 variants in turns (in order, then reversed, twice).

Then the instances above 128 columns (``kde_shapes``: the CASAS-width
detect at 50,000 and 20,000 windows, the wide instance's widest and
narrowest widths, the width-300 detect and ``chip_smoke.py``'s any-width
checks), with the detector's narrow shape as a yardstick: K2 and K3 of the
tree bitwise the baseline's (K3 tie level where the baseline's fallback
runs outside it), K3's use flags bitwise and its values at a float64
density tie of the plain version's, each K3 variant bitwise the tree's,
on those shapes and on ``WIDE_EDGE_CASES``; then the times of the
baseline's and the tree's K2 and K3 in turns (baseline, tree, tree,
baseline, twice), their medians, each shape's pairs and its bound
(``kde_cost``), and the K3 and K2 variants and probes in turns.
``--wide-only`` runs only this part. K2 on rows of 129 to ``kK3TriMaxW``
columns (its group kernels) is held at tie level against the baseline's
and its plain version: use flags and fallback rows bitwise, each other
differing row a float64 density tie (``near_tie_flips``), the flips
printed; so is K2 on narrower rows with the ``ex2`` term (``k2_tie_level``);
K2 elsewhere bitwise the baseline's. ``--narrow-only`` runs this part on
the narrow detect shape alone, its variants and probes too.

Prints one line per check and time, then the card and one JSON line. Needs
CUDA; the libraries go under ``hypad_tpu_torch/_build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from hypad_tpu_torch import _build
from hypad_tpu_torch.detect import scorer
from hypad_tpu_torch.manifold import kernels as mk
from hypad_tpu_torch.ops import kde_kernel as kk
from hypad_tpu_torch.ops.kde import (
    kde_argmax_rows_and_use,
    kde_argmax_rows_v2_and_use,
)
from hypad_tpu_torch.ops.unroll import antidiagonal_gather, masked_median
from hypad_tpu_torch.profile_critic_step import OUT, variant_jobs
from hypad_tpu_torch.profile_detect import OUT_DIR, cuda_ms

EMPTY_SOURCE = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_forward(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return cudaGetLastError();
}
"""
K1_SHAPES = ((20_000, 100), (128, 100), (64, 100))
WIDTH = 100
K1_TOL = 1e-6
# (windows, row width, constant run end, NaNs) of the K2 cases
K2_CASES = ((20_000, WIDTH, 0, False), (300, WIDTH, 250, False),
            (300, WIDTH, 0, True), (300, 1, 0, False), (300, 4, 0, False),
            (300, 5, 0, False))
SMOOTH = 200  # the scorer's smoothing window at 20,000 windows
K3_CONSTANTS = ("kK3Rows", "kByOffsetBlocksPerSM", "kK3GroupThreads",
                "kK3MaxGroups", "kK3Threads", "kK3TriMaxW")
K2_CONSTANTS = ("kK2GroupThreads", "kK2XGroupThreads", "kK2MaxGroups",
                "kK2Ex2")
# (windows, row width) of the KDE shapes above 128 columns, in the order
# of ``kde_shapes``; the anti-diagonal rows are windows + width - 1
WIDE_SHAPES = ((50_000, 150), (20_000, 150), (50_000, 256), (50_000, 129))
XWIDE_SHAPES = ((2_000, 300), (3_797, 300), (3_585, 512), (1_025, 1_024))
NARROW_SHAPE = (20_000, WIDTH)
# (windows, row width, constant run end, NaNs) checked beside the shapes:
# fallback rows and masked edges of each instance, and the widths on
# either side of 256
WIDE_EDGE_CASES = ((300, 150, 250, False), (300, 150, 0, True),
                   (1_000, 257, 0, False), (1_000, 300, 710, False),
                   (1_000, 300, 0, True), (200, 129, 0, True))


# probe builds of the tree's K3 above 128 columns, timed only (their values
# are wrong): (old, new) text substitutions of csrc/kde_argmax.cu, each old
# text found the given number of times
K3_PROBES = {
    # each pair's term without its exp
    "no_exp": ((("  return expf(sc * (d * d));\n", "  return sc * (d * d);\n"),
                1),),
    # the group kernels' rounds without the hand-off's barrier
    "no_bar": ((("    group_sync(bar, gthreads);\n"
                 "    const float4* gh = hand + 4 * I;\n",
                 "    const float4* gh = hand + 4 * I;\n"), 1),),
    # the group kernels' rounds without the hand-off through shared memory
    "no_hand": (((
        "        hand[4 * (I - D) + b] = make_float4(f[0][b], f[1][b], f[2][b],\n"
        "                                            f[3][b]);\n"
        "    }\n    group_sync(bar, gthreads);\n"
        "    const float4* gh = hand + 4 * I;\n",
        "        f[0][b] += 0.0f;\n    }\n    group_sync(bar, gthreads);\n"
        "    const float4 zeros[4] = {};\n    const float4* gh = zeros;\n"),
        1),),
}


# probe builds of K2 above 128 columns, timed only (their values are
# wrong), as K3_PROBES; a count of None takes the text wherever it is (the
# probe of a baseline whose K2 lies elsewhere in its source, or of the
# narrow instance too), and the probe must change the source
K2_PROBES = {
    # each pair's term without its exp (every KDE instance's)
    "no_exp": ((("expf(", "("), None), (("hypad::ex2_approx(", "("), None)),
    # the rounds without the hand-off through shared memory: the column
    # partials kept live but not stored, zeros read instead
    "no_hand": (
        (("slot[J] = make_float4(c[0], c[1], c[2], c[3]);",
          'asm volatile("" ::"f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));'),
         None),
        (("const float4 c = slot[I];",
          "const float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);"), None)),
    # the rounds without their barrier (the tree's K2 only)
    "no_bar": ((("    sync();\n", ""), 1),),
}


def k3_probe_source(text, name, probes=K3_PROBES):
    """``text`` (csrc/kde_argmax.cu) built as the probe ``name`` of
    ``probes`` (K3_PROBES or K2_PROBES)."""
    out = text
    for (old, new), n in probes[name]:
        if n is not None and out.count(old) != n:
            raise RuntimeError(f"probe {name!r}: csrc/kde_argmax.cu does not "
                               f"hold this text {n} times:\n{old}")
        out = out.replace(old, new)
    if out == text:
        raise RuntimeError(f"probe {name!r}: csrc/kde_argmax.cu holds none "
                           f"of its text")
    return out


def k3_variant_source(text, spec, constants=K3_CONSTANTS):
    """``text`` (csrc/kde_argmax.cu) with the launch constants of
    ``constants`` (K3_CONSTANTS or K2_CONSTANTS) that ``spec``
    ("name=value,name=value") names set to its values."""
    for item in spec.split(","):
        name, value = item.split("=")
        if name not in constants:
            raise ValueError(f"{name} is not one of {constants}")
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            raise RuntimeError(f"csrc/kde_argmax.cu no longer defines "
                               f"{name} once")
    return text


def kde_shapes(narrow_only=False):
    """[(label, windows, width)] of the KDE timings above 128 columns, the
    narrow detect shape first as the yardstick (``narrow_only``: it alone):
    T = windows + width - 1 anti-diagonal rows of ``width``."""
    kinds = (("narrow", (NARROW_SHAPE,)),) + (() if narrow_only else (
        ("wide", WIDE_SHAPES), ("xwide", XWIDE_SHAPES)))
    return [(f"{kind} ({n + w - 1}, {w})", n, w)
            for kind, shapes in kinds for n, w in shapes]


def kde_pairs(windows, width):
    """Unordered pairs of masked-in samples over the anti-diagonal rows of
    ``windows`` windows of ``width``: row t holds the entries (i, j) with
    i + j = t, 0 <= i < windows, 0 <= j < width."""
    total = 0
    for t in range(windows + width - 1):
        cnt = min(t, width - 1) - max(0, t - windows + 1) + 1
        total += cnt * (cnt - 1) // 2
    return total


def kde_cost(windows, width):
    """(bytes, f32 operations, exps) of one K2 or K3 launch on those rows:
    vals (f32) and mask (bool) read once, value (f32) and use (bool)
    written once; each unordered pair's difference, square, scale, exp and
    two sums (6 operations, one exp), ~8 operations a sample for the
    statistics."""
    rows = windows + width - 1
    pairs = kde_pairs(windows, width)
    return (5 * rows * width + 5 * rows, 6 * pairs + 8 * windows * width,
            pairs)


def kde_bound_ms(windows, width):
    """(ms, "bytes" or "operations") of ``kde_cost`` at the H100's rates
    (``profile_k1.bound``, the exps at the special-function units')."""
    from hypad_tpu_torch.profile_k1 import bound

    return bound(*kde_cost(windows, width))


def k3_constants(text=None, names=K3_CONSTANTS + ("kMaxW",)):
    """{name: value} of ``names`` (``K3_CONSTANTS`` and ``kMaxW`` by
    default) as ``text`` (csrc/kde_argmax.cu by default) defines them."""
    if text is None:
        text = (_build.CSRC / "kde_argmax.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                text).group(1))
            for name in names}


def k2_tie_level(width, text=None):
    """Whether K2's bits at ``width`` may differ from a parent's whose K2
    took another term or order there: with the SFU's ex2 term (kK2Ex2 = 1)
    every K2 row up to kK3TriMaxW columns (its narrow kernel and its group
    kernels), with ``expf`` the group kernels' rows above 256 columns,
    which sum in another order than the parent's K2x. K2's contract is tie
    level there (csrc/kde_argmax.cu's header); ``text`` is the source
    (csrc/kde_argmax.cu by default)."""
    c = k3_constants(text, names=("kK3TriMaxW", "kK2Ex2"))
    return (0 if c["kK2Ex2"] else 256) < width <= c["kK3TriMaxW"]


def k2_probe_sources(tree, base, names):
    """{library name: (label, source)} of the K2 probes ``names`` of the
    tree's source ("probe NAME") and, where its text takes the probe, of
    the baseline's ("probe baseline NAME", built beside the tree's, so with
    the tree's headers)."""
    sources = {}
    for name in names:
        sources[f"k2_probe_{name}"] = (f"probe {name}", k3_probe_source(
            tree, name, K2_PROBES))
        try:
            sources[f"k2_probe_baseline_{name}"] = (
                f"probe baseline {name}", k3_probe_source(
                    (base / "kde_argmax.cu").read_text(), name, K2_PROBES))
        except RuntimeError:
            print(f"[build] the baseline's K2 does not take probe {name!r}")
    return sources


def build(baseline_dir, k3_variants=(), k3_probes=(), k2_variants=(),
          k2_probes=()):
    """{"k1": (baseline fn, tree fn), "k2": (...), "k3": (...),
    "k3_fallback_outside": bool, "k3_variants": {spec: fn}, "k3_probes":
    {name: fn}, "k2_variants": {spec: fn}, "k2_probes": {name: fn},
    "empty": fn}: every library built at once, the baseline's from where
    it lies."""
    base = Path(baseline_dir)
    tree = (_build.CSRC / "kde_argmax.cu").read_text()
    sources = {"empty": EMPTY_SOURCE,
               "mobius_linear_tree": (_build.CSRC
                                      / "mobius_linear.cu").read_text(),
               "kde_argmax_tree": tree}
    for i, spec in enumerate(k3_variants):
        sources[f"k3_variant{i}"] = k3_variant_source(tree, spec)
    for name in k3_probes:
        sources[f"k3_probe_{name}"] = k3_probe_source(tree, name)
    for i, spec in enumerate(k2_variants):
        sources[f"k2_variant{i}"] = k3_variant_source(tree, spec,
                                                      K2_CONSTANTS)
    k2_probe_libs = k2_probe_sources(tree, base, k2_probes)
    sources.update({lib: src for lib, (_, src) in k2_probe_libs.items()})
    jobs = {**variant_jobs(sources), **baseline_jobs(base, "baseline")}
    for name, (_, log) in _build.compile_sources(jobs).items():
        if name.startswith("mobius_linear"):
            continue
        for line in log.splitlines():
            if ("registers" in line or "stack frame" in line
                    or "Compiling entry" in line):
                print(f"[build] {name}: {line.strip()}")
    libs = {name: ctypes.CDLL(str(lib)) for name, (_, lib) in jobs.items()}
    empty = libs["empty"].empty_forward
    empty.argtypes = [ctypes.c_void_p]
    k1 = tuple(mk.bind(libs[f"mobius_linear_{v}"])
               for v in ("baseline", "tree"))
    k2 = tuple(kk.bind(libs[f"kde_argmax_{v}"], "kde_argmax_forward")
               for v in ("baseline", "tree"))
    k3_base, k3_outside = bind_k3(libs, "baseline")
    k3 = (k3_base, kk.bind(libs["kde_argmax_tree"], "kde_argmax_v2_forward"))
    variants = {spec: kk.bind(libs[f"k3_variant{i}"],
                              "kde_argmax_v2_forward")
                for i, spec in enumerate(k3_variants)}
    probes = {f"probe {name}": kk.bind(libs[f"k3_probe_{name}"],
                                       "kde_argmax_v2_forward")
              for name in k3_probes}
    k2_variants = {spec: kk.bind(libs[f"k2_variant{i}"],
                                 "kde_argmax_forward")
                   for i, spec in enumerate(k2_variants)}
    k2_probes = {label: kk.bind(libs[lib], "kde_argmax_forward")
                 for lib, (label, _) in k2_probe_libs.items()}
    return {"k1": k1, "k2": k2, "k3": k3, "k3_fallback_outside": k3_outside,
            "k3_variants": variants, "k3_probes": probes,
            "k2_variants": k2_variants, "k2_probes": k2_probes,
            "empty": empty}


def baseline_jobs(base, tag):
    """``_build.compile_sources`` jobs of the K1 and KDE sources in the
    directory ``base`` (and its K3 without the fallback, where it has one),
    built where they lie so that they include their own headers; the
    libraries are named ``<source>_<tag>``."""
    names = ["mobius_linear", "kde_argmax"]
    if (base / "kde_argmax_v2.cu").is_file():
        names.append("kde_argmax_v2")
    OUT.mkdir(parents=True, exist_ok=True)
    return {f"{name}_{tag}": (base / f"{name}.cu",
                              OUT / f"lib{name}_{tag}.so") for name in names}


def bind_k3(libs, tag):
    """(the K3 entry of the ``baseline_jobs`` libraries ``libs`` tagged
    ``tag``, whether the median fallback runs outside it)."""
    outside = f"kde_argmax_v2_{tag}" in libs
    lib = libs[f"kde_argmax_v2_{tag}" if outside else f"kde_argmax_{tag}"]
    return kk.bind(lib, "kde_argmax_v2_forward"), outside


def empty_launch(fn):
    def go():
        err = fn(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel: CUDA error {err}")
    return go


def k1_case(rows, seed=0):
    """(x, w, b) of the full model's MobiusLinear head at ``rows`` rows."""
    from hypad_tpu_torch.models.tadgan import init_tadgan

    g = torch.Generator().manual_seed(seed + rows)
    head = init_tadgan(g, WIDTH, hyperbolic=True,
                       device="cuda")["decoder"].hyperbolic_linear
    x = (torch.rand(rows, WIDTH, generator=g) * 2 - 1).cuda()
    return x, head.w.detach().contiguous(), head.b.detach().contiguous()


def k2_case(n, width=WIDTH, runs=0, device="cuda", nans=False):
    """(vals, mask) of the anti-diagonal rows of a seeded critic of n
    windows; ``runs`` sets critic[10:runs] to 0.5: zero-variance rows, the
    median fallback, where the run is longer than the window. ``nans``
    sets critic[:2] and critic[100:200] to NaN: fallback rows whose middle
    ranks fall on the masked entries' f32-maximum fill or on the NaNs,
    which sort last."""
    critic = torch.randn(n, generator=torch.Generator().manual_seed(n))
    if runs:
        critic[10:runs] = 0.5
    if nans:
        critic[:2] = critic[100:200] = float("nan")
    return antidiagonal_gather(critic.to(device)[:, None].expand(n, width))


def fail(message):
    raise SystemExit(f"FAILED: {message}")


def tie_flips(got, want, vals, mask):
    """Rows where the KDE argmax picked another value; fails unless every
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


def near_tie_flips(got, want, vals, mask):
    """Rows where the KDE argmax picked another value; fails unless every
    such value is a sample of its own row whose float64 density is within
    n 2^-22 (relative) of the other's, n the row's samples: a bound on
    the rounding of two f32 sums of n terms of at most 1, each term's
    ``expf`` and the f32 bandwidth. The wide rows' check (129 to 256
    samples): there a tie within 1e-6 of two samples on either side of a
    row's mode is common enough that the 1% row cap of ``tie_flips``
    does not describe ties."""
    import numpy as np

    got, want = got.cpu().numpy(), want.cpu().numpy()
    v, m = vals.cpu().numpy(), mask.cpu().numpy()
    rows = np.nonzero(got != want)[0]
    for i in rows:
        s = v[i][m[i]].astype(np.float64)
        if got[i] not in s:
            fail(f"KDE argmax row {i} holds no sample of its row")
        # the row's Gaussian KDE in float64: mean, unbiased variance,
        # Scott bandwidth h^2 = var n^-0.4
        scale = -0.5 / (s.var(ddof=1) * len(s) ** -0.4)
        d_got, d_want = (np.exp(scale * (float(x) - s) ** 2).sum()
                         for x in (got[i], want[i]))
        if abs(d_got - d_want) > len(s) * 2.0 ** -22 * d_want:
            fail(f"KDE argmax row {i} differs by more than a tie: density "
                 f"{d_got} against {d_want}")
    return len(rows)


def same_values(a, b):
    """Equal bit for bit, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def check_k1(got, x, w, b, baseline=None, case=""):
    """(max abs diff of K1's output ``got`` to the plain version, to the
    ``baseline`` output or None); fails above K1_TOL."""
    err = (got - mk.mobius_linear(x, w, b)).abs().max().item()
    if not err <= K1_TOL:
        fail(f"K1 differs from its plain version by {err} at {case}")
    if baseline is None:
        return err, None
    vs = (got - baseline).abs().max().item()
    if not vs <= K1_TOL:
        fail(f"K1 differs from the baseline's by {vs} at {case}")
    return err, vs


def check_kde(name, plain_fn, value, use, vals, mask, baseline=None,
              case=""):
    """A KDE kernel's one-launch output against its plain version
    ``plain_fn`` and, where given, the ``baseline``'s (value, use): use
    flags bitwise, fallback rows bitwise ``masked_median``, the other rows
    at tie level. Returns the fallback rows and the tie flips."""
    plain, plain_use = plain_fn(vals, mask)
    if not torch.equal(use, plain_use):
        fail(f"{name} use flags differ from the plain version's at {case}")
    fallback = ~use
    if not same_values(value[fallback], masked_median(vals, mask)[fallback]):
        fail(f"{name} fallback rows differ from masked_median at {case}")
    rows = (value[use], vals[use], mask[use])
    rec = {"fallback_rows": int(fallback.sum()),
           "flips_vs_plain": tie_flips(rows[0], plain[use], *rows[1:])}
    if baseline is not None:
        if not torch.equal(use, baseline[1]):
            fail(f"{name} use flags differ from the baseline's at {case}")
        rec["flips_vs_baseline"] = tie_flips(rows[0], baseline[0][use],
                                             *rows[1:])
    return rec


def check_k2(value, use, vals, mask, baseline=None, case=""):
    """K2's output, held as ``check_kde`` holds it."""
    return check_kde("K2", kde_argmax_rows_and_use, value, use, vals, mask,
                     baseline, case)


def check_k3(value, use, vals, mask, baseline=None, case=""):
    """K3's output, held as ``check_kde`` holds it, against the plain
    densities summed by offset."""
    return check_kde("K3", kde_argmax_rows_v2_and_use, value, use, vals,
                     mask, baseline, case)


def kernel_then_median(fn, vals, mask):
    """A KDE kernel without the fallback inside, as the detector ran it:
    the kernel, then the fallback's sort."""
    kde_val, use = kk.launch_with(fn, vals, mask)
    return torch.where(use, kde_val, masked_median(vals, mask)), use


def baseline_k3(fns):
    """A function (vals, mask) -> (value, use) of the baseline's K3 as the
    detector runs it: one launch, or the kernel and then the fallback's
    sort where the fallback lies outside it."""
    fn = fns["k3"][0]
    if fns["k3_fallback_outside"]:
        return lambda vals, mask: kernel_then_median(fn, vals, mask)
    return lambda vals, mask: kk.launch_with(fn, vals, mask)


def check(fns):
    """One line per case; returns the records."""
    records = {}
    for rows, din in K1_SHAPES:
        x, w, b = k1_case(rows)
        old, new = (mk.launch_with(f, x, w, b) for f in fns["k1"])
        torch.cuda.synchronize()
        case = f"({rows}, {din})"
        vs_plain, vs_baseline = check_k1(new, x, w, b, old, case)
        rec = {"vs_plain": vs_plain, "vs_baseline": vs_baseline,
               "baseline_vs_plain": check_k1(old, x, w, b, case=case)[0]}
        print(f"[check] K1 {case}: tree {vs_plain:.3e} from plain, "
              f"{vs_baseline:.3e} from the baseline (baseline "
              f"{rec['baseline_vs_plain']:.3e} from plain)")
        records[f"k1_{rows}"] = rec
    k3_base = baseline_k3(fns)
    for n, width, runs, nans in K2_CASES:
        vals, mask = k2_case(n, width, runs, nans=nans)
        case = (f"T={vals.shape[0]} W={width}"
                f"{' constant run' if runs else ''}{' NaNs' if nans else ''}")
        old = kk.launch_with(fns["k2"][0], vals, mask)
        new, use = kk.launch_with(fns["k2"][1], vals, mask)
        torch.cuda.synchronize()
        if same_values(new, old[0]) and torch.equal(use, old[1]):
            words = "bitwise the baseline's"
        elif k2_tie_level(width):
            near = k2_near_ties((new, use), vals, mask, old, case)
            words = (f"use flags and fallback rows bitwise the baseline's, "
                     f"{near['flips_vs_baseline']} density-tie flips "
                     f"against it, {near['flips_vs_plain']} against plain "
                     f"(baseline {near['baseline_flips_vs_plain']})")
        else:
            fail(f"K2 differs from the baseline K2's bits at {case}")
        rec = check_k2(new, use, vals, mask, case=case)
        print(f"[check] K2 {case}: {words}; use flags bitwise; "
              f"{rec['fallback_rows']} fallback rows bitwise masked_median; "
              f"{rec['flips_vs_plain']} tie flips against plain")
        records[f"k2 {case}"] = rec

        old3 = k3_base(vals, mask)
        new3, use3 = kk.launch_with(fns["k3"][1], vals, mask)
        torch.cuda.synchronize()
        rec = check_k3(new3, use3, vals, mask, old3, case)
        rec["baseline_flips_vs_plain"] = check_k3(
            *old3, vals, mask, case=case)["flips_vs_plain"]
        rec["flips_vs_k2"] = tie_flips(new3[use3], new[use3], vals[use3],
                                       mask[use3])
        for spec, fn in fns["k3_variants"].items():
            got = kk.launch_with(fn, vals, mask)
            if not (same_values(got[0], new3) and torch.equal(got[1], use3)):
                fail(f"K3 variant {spec} differs from the tree's K3 at "
                     f"{case}")
        print(f"[check] K3 {case}: use flags bitwise; "
              f"{rec['fallback_rows']} fallback rows bitwise masked_median; "
              f"tie flips {rec['flips_vs_baseline']} against the baseline, "
              f"{rec['flips_vs_plain']} against plain (baseline "
              f"{rec['baseline_flips_vs_plain']}), {rec['flips_vs_k2']} "
              f"against K2; variants {sorted(fns['k3_variants'])} bitwise")
        records[f"k3 {case}"] = rec
    return records


def plain_k2(width):
    """K2's plain version at ``width``, its (rows, W, W) intermediate kept
    at 0.5 GB past 1,024 columns' 128 rows a block."""
    import functools

    block = min(1024, max(1, 128 * 1024 ** 2 // width ** 2))
    return functools.partial(kde_argmax_rows_and_use, block=block)


def k2_near_ties(got, vals, mask, baseline, case):
    """K2's (value, use) ``got`` on rows its group kernels take, against
    its plain version and the ``baseline``'s (value, use): use flags and
    fallback rows bitwise both, the other rows at a float64 density tie
    (``near_tie_flips``). Returns {"bitwise_baseline", "fallback_rows",
    "flips_vs_plain", "flips_vs_baseline", "baseline_flips_vs_plain"}."""
    value, use = got
    plain, plain_use = plain_k2(vals.shape[1])(vals, mask)
    if not (torch.equal(use, plain_use) and torch.equal(use, baseline[1])):
        fail(f"K2 use flags differ from the plain version's or the "
             f"baseline's at {case}")
    fallback = ~use
    if not (same_values(value[fallback], masked_median(vals, mask)[fallback])
            and same_values(value[fallback], baseline[0][fallback])):
        fail(f"K2 fallback rows differ from masked_median or the "
             f"baseline's at {case}")
    rows = (vals[use], mask[use])
    return {"bitwise_baseline": same_values(value, baseline[0]),
            "fallback_rows": int(fallback.sum()),
            "flips_vs_plain": near_tie_flips(value[use], plain[use], *rows),
            "flips_vs_baseline": near_tie_flips(value[use],
                                                baseline[0][use], *rows),
            "baseline_flips_vs_plain": near_tie_flips(baseline[0][use],
                                                      plain[use], *rows)}


def check_wide_k2(fns, vals, mask, case):
    """The tree's K2 against the baseline's: two launches bitwise; where
    ``k2_tie_level`` ``k2_near_ties``, elsewhere bitwise the baseline's;
    each K2 variant bitwise the tree's or, where its arithmetic differs,
    at ``k2_near_ties`` of the baseline. Returns (the tree's output, the
    record)."""
    old, new = (kk.launch_with(f, vals, mask) for f in fns["k2"])
    again = kk.launch_with(fns["k2"][1], vals, mask)
    if not (same_values(again[0], new[0]) and torch.equal(again[1], new[1])):
        fail(f"two K2 launches differ at {case}")
    tie = k2_tie_level(vals.shape[1])
    if tie:
        rec = k2_near_ties(new, vals, mask, old, case)
    elif same_values(new[0], old[0]) and torch.equal(new[1], old[1]):
        rec = {"bitwise_baseline": True}
    else:
        fail(f"K2 differs from the baseline K2's bits at {case}")
    rec["variants_bitwise"] = {}
    for spec, fn in fns["k2_variants"].items():
        got = kk.launch_with(fn, vals, mask)
        bitwise = same_values(got[0], new[0]) and torch.equal(got[1], new[1])
        if not bitwise:
            if not tie:
                fail(f"K2 variant {spec} differs from the tree's K2 at "
                     f"{case}")
            rec.setdefault("variant_vs_baseline", {})[spec] = k2_near_ties(
                got, vals, mask, old, case)
        rec["variants_bitwise"][spec] = bitwise
    return new, rec


def check_wide(fns, narrow_only=False):
    """The tree's K2 and K3 against the baseline's and their plain versions
    on ``kde_shapes`` and ``WIDE_EDGE_CASES`` (see the module docstring;
    ``narrow_only``: on the narrow shape alone); one line a case. Returns
    the records."""
    k3_base = baseline_k3(fns)
    cases = [(n, w, 0, False) for _, n, w in kde_shapes(narrow_only)]
    records = {}
    for n, width, runs, nans in cases + (
            [] if narrow_only else list(WIDE_EDGE_CASES)):
        vals, mask = k2_case(n, width, runs, nans=nans)
        case = (f"T={vals.shape[0]} W={width}"
                f"{' constant run' if runs else ''}{' NaNs' if nans else ''}")
        new, k2 = check_wide_k2(fns, vals, mask, case)
        k2_words = ("bitwise the baseline's" if k2["bitwise_baseline"] else
                    "use flags and fallback rows bitwise the baseline's")
        if "flips_vs_plain" in k2:
            k2_words += (f", {k2['flips_vs_plain']} density-tie flips against"
                         f" plain (baseline {k2['baseline_flips_vs_plain']}),"
                         f" {k2['flips_vs_baseline']} against the baseline")
        if k2["variants_bitwise"]:
            k2_words += f", variants bitwise the tree {k2['variants_bitwise']}"
        for spec, v in k2.get("variant_vs_baseline", {}).items():
            same = "bitwise" if v["bitwise_baseline"] else "not bitwise"
            k2_words += (f", variant {spec} {same} the baseline "
                         f"({v['flips_vs_plain']} flips against plain)")
        old3 = k3_base(vals, mask)
        new3, use3 = kk.launch_with(fns["k3"][1], vals, mask)
        again = kk.launch_with(fns["k3"][1], vals, mask)
        torch.cuda.synchronize()
        if not (same_values(again[0], new3) and torch.equal(again[1], use3)):
            fail(f"two K3 launches differ at {case}")
        bitwise = same_values(new3, old3[0]) and torch.equal(use3, old3[1])
        if not (bitwise or fns["k3_fallback_outside"]):
            fail(f"K3 differs from the baseline K3's bits at {case}")
        plain, plain_use = kde_argmax_rows_v2_and_use(vals, mask)
        if not torch.equal(use3, plain_use):
            fail(f"K3 use flags differ from the plain version's at {case}")
        if not same_values(new3[~use3], masked_median(vals, mask)[~use3]):
            fail(f"K3 fallback rows differ from masked_median at {case}")
        rec = {"bitwise_baseline": bitwise,
               "fallback_rows": int((~use3).sum()),
               "flips_vs_plain": near_tie_flips(new3[use3], plain[use3],
                                                vals[use3], mask[use3]),
               "flips_vs_k2": near_tie_flips(new3[use3], new[0][use3],
                                             vals[use3], mask[use3]),
               "k2": k2}
        for spec, fn in fns["k3_variants"].items():
            got = kk.launch_with(fn, vals, mask)
            if not (same_values(got[0], new3) and torch.equal(got[1], use3)):
                fail(f"K3 variant {spec} differs from the tree's K3 at "
                     f"{case}")
        print(f"[check] wide {case}: K2 {k2_words}; K3 "
              f"{'bitwise' if bitwise else 'not bitwise'} the baseline's, "
              f"two launches bitwise, use flags bitwise, "
              f"{rec['fallback_rows']} fallback rows bitwise masked_median, "
              f"{rec['flips_vs_plain']} density-tie flips against plain, "
              f"{rec['flips_vs_k2']} against K2; variants "
              f"{sorted(fns['k3_variants'])} bitwise")
        records[case] = rec
    return records


def time_wide(fns, reps, narrow_only=False):
    """{label: record} of ``kde_shapes`` (``narrow_only``: the narrow
    shape alone): the baseline's and the tree's K2
    and K3 in turns (baseline, tree, tree, baseline, twice), ms of each
    run and the medians, the pairs and the bound; then {label: {"k3" or
    "k2": {variant: [ms]}}} of the K3 and K2 variants and probes in turns.
    One line a shape."""
    out, variants = {}, {}
    for label, n, width in kde_shapes(narrow_only):
        vals, mask = k2_case(n, width)
        rec = {"rows": vals.shape[0], "width": width,
               "pairs": kde_pairs(n, width)}
        rec["bound_ms"], rec["bound_by"] = kde_bound_ms(n, width)
        for kernel in ("k2", "k3"):
            t = {"baseline": [], "tree": []}
            for which in ("baseline", "tree", "tree", "baseline") * 2:
                f = fns[kernel][which == "tree"]
                t[which].append(cuda_ms(
                    lambda f=f: kk.launch_with(f, vals, mask), reps))
            rec[kernel] = {**t, **{f"{w}_median": statistics.median(t[w])
                                   for w in t}}
        print(f"[time] {label}: K2 baseline {rec['k2']['baseline_median']:.5f}"
              f" / tree {rec['k2']['tree_median']:.5f} ms, K3 baseline "
              f"{rec['k3']['baseline_median']:.5f} / tree "
              f"{rec['k3']['tree_median']:.5f} ms (medians of 4 in turns); "
              f"{rec['pairs']} pairs, bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']})")
        for kernel in ("k3", "k2"):
            named = {"tree": fns[kernel][1], **fns[f"{kernel}_variants"],
                     **fns[f"{kernel}_probes"]}
            if len(named) == 1:
                continue
            order = list(named)
            v = {name: [] for name in named}
            for name in order + order[::-1]:
                v[name].append(cuda_ms(
                    lambda f=named[name]: kk.launch_with(f, vals, mask),
                    reps))
            variants.setdefault(label, {})[kernel] = v
            print(f"[time] {kernel.upper()} variants {label}: "
                  f"{ {k: [round(x, 5) for x in ms] for k, ms in v.items()} }")
        out[label] = rec
    return out, variants


def torch_quantile_quartiles(x):
    """The baseline's quartiles: two ``torch.quantile`` calls, a sort
    each."""
    return torch.stack([torch.quantile(x, 0.25), torch.quantile(x, 0.75)])


def with_quartiles(fn, quartiles):
    """``fn`` with the scorer's ``quartiles`` swapped for ``quartiles``
    while it runs."""
    def go():
        kept = scorer.quartiles
        scorer.quartiles = quartiles
        try:
            return fn()
        finally:
            scorer.quartiles = kept
    return go


def time_all(fns, reps, stage_reps=20):
    """{label: [ms in turns]}: baseline, tree, tree, baseline. The IQR
    entries, tens of small ops each, run ``stage_reps`` times, few enough
    for ``cuda_ms``' sleep to cover the host's enqueue."""
    calls = {"empty kernel": (empty_launch(fns["empty"]),) * 2}
    for rows, _ in K1_SHAPES:
        x, w, b = k1_case(rows)
        calls[f"K1 ({rows}, {WIDTH})"] = tuple(
            (lambda f=f, x=x, w=w, b=b: mk.launch_with(f, x, w, b))
            for f in fns["k1"])
    vals, mask = k2_case(20_000)
    calls["K2, one launch (T=20099)"] = tuple(
        (lambda f=f: kk.launch_with(f, vals, mask)) for f in fns["k2"])
    k3_base = baseline_k3(fns)
    calls["K3 with fallback (T=20099)"] = (
        lambda: k3_base(vals, mask),
        lambda: kk.launch_with(fns["k3"][1], vals, mask))
    calls["K3 kernel alone (T=20099)"] = tuple(
        (lambda f=f: kk.launch_with(f, vals, mask)) for f in fns["k3"])
    calls = {label: (*pair, reps) for label, pair in calls.items()}
    kde_max = kk.launch_with(fns["k2"][1], vals, mask)[0]
    calls["IQR quartiles (T=20099)"] = (
        lambda: torch_quantile_quartiles(kde_max),
        lambda: scorer.quartiles(kde_max), stage_reps)

    def stage():
        return scorer._critic_scores_from_kde(kde_max, SMOOTH)

    calls["IQR mean, std, rolling mean stage (T=20099)"] = (
        with_quartiles(stage, torch_quantile_quartiles), stage, stage_reps)
    times = {}
    for label, (old, new, n) in calls.items():
        t = {"baseline": [], "tree": []}
        for which, fn in (("baseline", old), ("tree", new), ("tree", new),
                          ("baseline", old)):
            t[which].append(cuda_ms(fn, n))
        times[label] = t
        print(f"[time] {label}: baseline ms {t['baseline']}, tree ms "
              f"{t['tree']}")
    variants = {"tree": fns["k3"][1], **fns["k3_variants"]}
    if len(variants) > 1:
        t = {name: [] for name in variants}
        order = list(variants)
        for name in order + order[::-1] + order + order[::-1]:
            t[name].append(cuda_ms(
                lambda f=variants[name]: kk.launch_with(f, vals, mask), reps))
        times["K3 variants (T=20099)"] = t
        print(f"[time] K3 variants (T=20099): {t}")
    return times


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline-dir", required=True,
                        help="directory of the baseline's mobius_linear.cu "
                             "and kde_argmax.cu (and kde_argmax_v2.cu)")
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--k3-variant", nargs="*", default=(),
                        help="also build the tree's K3 with these launch "
                        "constants (name=value,...), check that it gives "
                        "the tree's bits, and time it")
    parser.add_argument("--k3-probe", nargs="*", default=(),
                        choices=sorted(K3_PROBES),
                        help="also build these probes of the tree's K3 and "
                        "time them beside it above 128 columns")
    parser.add_argument("--k2-variant", nargs="*", default=(),
                        help="also build the tree's K2 with these constants "
                        "(name=value,...; kK2Ex2=0 for expf), check it and "
                        "time it")
    parser.add_argument("--k2-probe", nargs="*", default=(),
                        choices=sorted(K2_PROBES),
                        help="also build these probes of the tree's K2 (and "
                        "the baseline's) and time them above 128 columns")
    parser.add_argument("--wide-only", action="store_true",
                        help="only the KDE shapes above 128 columns")
    parser.add_argument("--narrow-only", action="store_true",
                        help="only the narrow KDE shape of the --wide-only "
                        "part (its checks, times, variants and probes)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(args.baseline_dir, args.k3_variant, args.k3_probe,
                args.k2_variant, args.k2_probe)
    records, times = {}, {}
    if not (args.wide_only or args.narrow_only):
        records = check(fns)
        times = time_all(fns, args.reps)
    records["wide"] = check_wide(fns, args.narrow_only)
    times["wide"], times["wide_variants"] = time_wide(fns, args.reps // 4,
                                                      args.narrow_only)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "profile_kernels.json").write_text(json.dumps(
        {"card": card, "checks": records, "times_ms": times}, indent=1))
    print(json.dumps({"card": card, "checks": records, "times_ms": times}))


if __name__ == "__main__":
    main()
