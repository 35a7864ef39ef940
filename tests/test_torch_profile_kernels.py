"""``hypad_tpu_torch.profile_kernels``' pure parts on the CPU: the KDE shapes
above 128 columns, their pair counts against a loop over the anti-diagonal
rows, the bound's three terms, and the probe and variant sources of K3."""

from __future__ import annotations

import pytest
import torch

from hypad_tpu_torch.profile_k1 import (
    H100_BYTES_PER_S,
    H100_F32_FLOP_PER_S,
    H100_SFU_EXP_PER_S,
    bound,
)
from hypad_tpu_torch.profile_kernels import (
    K3_CONSTANTS,
    K3_PROBES,
    k2_case,
    k3_probe_source,
    k3_variant_source,
    kde_bound_ms,
    kde_cost,
    kde_pairs,
    kde_shapes,
)


def test_kde_shapes_are_the_issue_shapes():
    """The narrow yardstick, K3w's four shapes and K3x's four, as (rows,
    width) labels of windows + width - 1 anti-diagonal rows."""
    got = [(label.split()[0], n + w - 1, w) for label, n, w in kde_shapes()]
    assert got == [("narrow", 20_099, 100), ("wide", 50_149, 150),
                   ("wide", 20_149, 150), ("wide", 50_255, 256),
                   ("wide", 50_128, 129), ("xwide", 2_299, 300),
                   ("xwide", 4_096, 300), ("xwide", 4_096, 512),
                   ("xwide", 2_048, 1_024)]
    for label, n, w in kde_shapes():
        assert label.endswith(f"({n + w - 1}, {w})")


@pytest.mark.parametrize("windows,width,want", [
    (50_000, 150, 558_187_525), (2_000, 300, 85_200_050),
    (20_000, 100, 98_833_350), (5, 8, None), (1, 4, None), (9, 9, None)])
def test_kde_pairs_count_the_masks(windows, width, want):
    """The pairs of masked-in samples, counted on the anti-diagonal masks
    themselves (the issue's counts at (50,000, 150) and (2,000, 300))."""
    got = kde_pairs(windows, width)
    if want is not None:
        assert got == want
    if windows * width <= 20_000 * 100:
        _, mask = k2_case(windows, width, device="cpu")
        cnt = mask.sum(dim=1).to(torch.int64)
        assert got == int((cnt * (cnt - 1) // 2).sum())
        rows = windows + width - 1
        assert kde_cost(windows, width) == (
            5 * rows * width + 5 * rows, 6 * got + 8 * int(cnt.sum()), got)


def test_bound_takes_the_largest_of_three_terms():
    """Bytes over 3.35 TB/s, f32 operations over 67 TFLOP/s, exps over the
    SFUs' 132 x 16 x 1.98e9 a second; the exps count as operations."""
    assert H100_SFU_EXP_PER_S == 132 * 16 * 1.98e9
    ms, by = bound(3.35e9, 67e9)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = bound(1.0, 67e9, 0)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = bound(1.0, 1.0, H100_SFU_EXP_PER_S * 2e-3)
    assert (ms, by) == (pytest.approx(2.0), "operations")
    nbytes, ops, exps = kde_cost(50_000, 150)
    ms, by = kde_bound_ms(50_000, 150)
    assert by == "operations"
    assert ms == pytest.approx(exps / H100_SFU_EXP_PER_S * 1e3)
    assert ms > ops / H100_F32_FLOP_PER_S * 1e3
    assert ms > nbytes / H100_BYTES_PER_S * 1e3
    assert ms == pytest.approx(0.13348, abs=5e-5)
    assert kde_bound_ms(2_000, 300)[0] == pytest.approx(0.02037, abs=5e-5)


def test_chip_smoke_bound_prints_both_operation_bounds():
    """``chip_smoke.bound`` keeps bytes and ops, adds the exps term and
    both operation bounds apart under ``bound_terms`` for a KDE record, and
    leaves K1's alone."""
    import chip_smoke

    nbytes, ops, exps = kde_cost(20_000, 100)
    k = chip_smoke.bound({"bytes": nbytes, "ops": ops, "exps": exps})
    terms = k["bound_terms"]
    assert terms["exps"] == exps
    assert k["bound_ms"] == pytest.approx(terms["sfu_ms"])
    assert terms["f32_ms"] == pytest.approx(ops / H100_F32_FLOP_PER_S * 1e3)
    assert "sfu_ms" not in k and "f32_ms" not in k
    assert "SFU" in chip_smoke.kde_bounds_text(k)
    k1 = chip_smoke.bound({"bytes": 4e6, "ops": 1e9})
    assert "bound_terms" not in k1 and k1["bound_by"] == "operations"


@pytest.mark.parametrize("name", sorted(K3_PROBES))
def test_k3_probes_change_only_their_text(name):
    """Each probe source differs from csrc/kde_argmax.cu in the lines it
    names and nowhere else."""
    from hypad_tpu_torch import _build

    text = (_build.CSRC / "kde_argmax.cu").read_text()
    out = k3_probe_source(text, name)
    assert out != text
    for (old, new), n in K3_PROBES[name]:
        assert out.count(old) == 0 or old in new
    lines_a, lines_b = text.splitlines(), out.splitlines()
    assert abs(len(lines_a) - len(lines_b)) <= 4


@pytest.mark.parametrize("name", K3_CONSTANTS)
def test_every_k3_constant_is_a_variant(name):
    """Each name ``--k3-variant`` takes is one ``constexpr int`` of
    csrc/kde_argmax.cu, rewritten alone."""
    import re

    from hypad_tpu_torch import _build

    text = (_build.CSRC / "kde_argmax.cu").read_text()
    value = int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    out = k3_variant_source(text, f"{name}={value + 1}")
    changed = [b for a, b in zip(text.splitlines(), out.splitlines())
               if a != b]
    assert changed == [f"constexpr int {name} = {value + 1};"]
