"""K1 (MobiusLinear), K2 and K3 (KDE argmax) of the tree beside a
baseline's, on a GPU.

    python3 -m hypad_tpu_torch.profile_kernels --baseline-dir DIR
        [--reps N] [--k3-variant kK3Rows=8,kByOffsetBlocksPerSM=4 ...]

``DIR`` holds another ``mobius_linear.cu`` and ``kde_argmax.cu`` of the same
C interfaces, for example a parent commit's ``hypad_tpu_torch/csrc``
unpacked with ``git archive`` into the gitignored ``_checkout/``. Its K3 is
``kde_argmax_v2_forward`` of ``DIR/kde_argmax_v2.cu`` where that file exists
(a K3 without the median fallback inside, which then runs after it), else
of ``DIR/kde_argmax.cu``. The baseline's sources build where they lie, so
they include their own headers; the tree's, an empty kernel and, with
``--k3-variant``, the tree's source with K3's launch constants
(``kK3Rows``, ``kByOffsetBlocksPerSM``) set otherwise build at once with
them.

Checks, at the main path's shapes:

* K1 at (20,000, 100), (128, 100) and (64, 100), the full model's head:
  the tree's kernel within 1e-6 of the plain version and of the baseline's;
* K2 and K3 at T = 20,099, W = 100 on a random critic, at T = 399 with a
  constant run of 240 (143 fallback rows), with NaNs in the critic, and at
  row widths 1, 4 and 5: the tree's use flags equal the plain version's and
  the baseline's bit for bit, its fallback rows equal ``masked_median``
  bit for bit (NaN where it is NaN), and its other rows equal the plain
  version's and the baseline's final values at tie level; K2's values and
  use flags equal the baseline K2's bit for bit; each K3 variant's equal
  the tree's K3's bit for bit.

``check_k1``, ``check_k2``, ``check_k3`` and ``tie_flips`` are the checks
``chip_smoke.py`` holds the kernels to as well.

Then times, with CUDA events, in turns (baseline, tree, tree, baseline):
K1 at each shape, an empty kernel's launch-to-end time, K2 and K3 as the
detector runs them (one launch of the tree's against the baseline's, its
kernel plus the fallback's sort where the fallback is outside it), and the
scorer's IQR quartiles and its whole IQR stage on K2's output, with two
``torch.quantile`` calls as the baseline against ``scorer.quartiles``' one
sort; then the K3 variants in turns (in order, then reversed, twice).
Prints one line per check and time, then the card and one JSON line. Needs
CUDA; the libraries go under ``hypad_tpu_torch/_build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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
from hypad_tpu_torch.profile_detect import cuda_ms

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
K3_CONSTANTS = ("kK3Rows", "kByOffsetBlocksPerSM")


def k3_variant_source(text, spec):
    """``text`` (csrc/kde_argmax.cu) with the K3 launch constants that
    ``spec`` ("name=value,name=value") names set to its values."""
    for item in spec.split(","):
        name, value = item.split("=")
        if name not in K3_CONSTANTS:
            raise ValueError(f"{name} is not one of {K3_CONSTANTS}")
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            raise RuntimeError(f"csrc/kde_argmax.cu no longer defines "
                               f"{name} once")
    return text


def build(baseline_dir, k3_variants=()):
    """{"k1": (baseline fn, tree fn), "k2": (...), "k3": (...),
    "k3_fallback_outside": bool, "k3_variants": {spec: fn}, "empty": fn}:
    every library built at once, the baseline's from where it lies."""
    base = Path(baseline_dir)
    tree = (_build.CSRC / "kde_argmax.cu").read_text()
    sources = {"empty": EMPTY_SOURCE,
               "mobius_linear_tree": (_build.CSRC
                                      / "mobius_linear.cu").read_text(),
               "kde_argmax_tree": tree}
    for i, spec in enumerate(k3_variants):
        sources[f"k3_variant{i}"] = k3_variant_source(tree, spec)
    jobs = {**variant_jobs(sources), **baseline_jobs(base, "baseline")}
    for name, (_, log) in _build.compile_sources(jobs).items():
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line:
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
    return {"k1": k1, "k2": k2, "k3": k3, "k3_fallback_outside": k3_outside,
            "k3_variants": variants, "empty": empty}


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
        if not (same_values(new, old[0]) and torch.equal(use, old[1])):
            fail(f"K2 differs from the baseline K2's bits at {case}")
        rec = check_k2(new, use, vals, mask, case=case)
        print(f"[check] K2 {case}: bitwise the baseline's; use flags "
              f"bitwise; {rec['fallback_rows']} fallback rows bitwise "
              f"masked_median; {rec['flips_vs_plain']} tie flips against "
              f"plain")
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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(args.baseline_dir, args.k3_variant)
    records = check(fns)
    times = time_all(fns, args.reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "checks": records, "times_ms": times}))


if __name__ == "__main__":
    main()
