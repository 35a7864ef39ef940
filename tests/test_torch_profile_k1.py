"""The CPU side of ``hypad_tpu_torch.profile_k1``, which times K1 at the
generator step's shapes on the card: its shapes, the padded yardstick's
inputs and the sources of its probe and variant builds."""

import re

import numpy as np
import pytest
import torch

from hypad_tpu_torch import _build
from hypad_tpu_torch.manifold.kernels import mobius_linear
from hypad_tpu_torch.profile_k1 import (
    MANY_ROWS,
    PROBES,
    bulk_width,
    check_case,
    k1_bound_ms,
    k1_case,
    k1_cost,
    bound,
    padded,
    SPLIT_FLAGS,
    probe_source,
    probed,
    split_variants,
    training_shapes,
    variant_source,
)


@pytest.mark.parametrize("width,want", [(51, 52), (100, 100), (123, 124),
                                        (64, 68), (1, 4), (128, None),
                                        (150, None), (256, None)])
def test_bulk_width_is_the_next_width_a_bulk_copy_takes(width, want):
    """A multiple of 4 whose quarter is odd (neighbouring rows in distinct
    banks), at or above the width, within the narrow instance."""
    assert bulk_width(width) == want


def test_training_shapes_cover_the_generator_step_and_the_detector():
    shapes = {label: (rows, width, signals)
              for label, rows, width, signals in training_shapes()}
    for width in (51, 100, 123, 150, 256, 300):
        assert shapes[f"(128, {width})"] == (128, width, None)
        assert shapes[f"(64, {width})"] == (64, width, None)
        assert shapes[f"(3, 64, {width})"] == (64, width, 3)
    for rows, width in ((20000, 100), (20000, 150), (50000, 150),
                        (50000, 256), (2000, 300), (4096, 512)):
        assert shapes[f"({rows}, {width})"] == (rows, width, None)
    assert len(shapes) == 6 * 3 + 6


@pytest.mark.parametrize("label,rows,width,signals", training_shapes())
def test_every_shape_has_its_bound(label, rows, width, signals):
    """Each timed shape's bound is the larger of k1_cost's bytes at 3.35
    TB/s and operations at 67 TFLOP/s, times the signals."""
    nbytes, ops = k1_cost(rows, width, width)
    s = signals or 1
    want = max(s * nbytes / 3.35e12, s * ops / 67e12) * 1e3
    assert k1_bound_ms(rows, width, signals) == pytest.approx(want,
                                                              rel=1e-12)


@pytest.mark.parametrize("nbytes,ops,want", [
    (3.35e12, 67e11, (1000.0, "bytes")), (3.35e11, 67e12, (1000.0,
                                                           "operations"))])
def test_bound_is_the_slower_of_bytes_and_operations(nbytes, ops, want):
    ms, by = bound(nbytes, ops)
    assert ms == pytest.approx(want[0], rel=1e-12) and by == want[1]


def test_k1_cost_counts_each_input_once_and_the_clamp_chain():
    assert k1_cost(2, 3, 5) == (4 * (6 + 15 + 5 + 10), 2 * 30 + 16 * 10)


@pytest.mark.parametrize("rows,width,want", [
    (64, 51, True), (128, 123, True), (20000, 100, False),
    (20000, 150, True), (50000, 256, True), (2000, 300, True)])
def test_probes_run_where_their_builds_wait_for_their_copies(rows, width,
                                                             want):
    """The probe builds are timed at the few-rows shapes and above 128
    columns, never on the narrow many-rows kernel (whose probe would exit
    with a tile's bulk copy in flight)."""
    assert probed(rows, width) is want
    assert all(probed(r, w) for r, w in MANY_ROWS if w > 128)


@pytest.mark.parametrize("rows,width,signals", [(64, 51, None),
                                                (64, 123, 3)])
def test_padded_yardstick_inputs_give_the_same_function(rows, width,
                                                        signals):
    """x and W padded with zero columns to the bulk width: the product, and
    so the MobiusLinear output, is the unpadded one (within the last bits
    of a longer sum)."""
    x, w, b = k1_case(rows, width, signals, device="cpu")
    xp, wp = padded(x, w, bulk_width(width))
    assert xp.shape[-1] == wp.shape[-1] == bulk_width(width)
    assert torch.equal(xp[..., :width], x) and torch.equal(wp[..., :width], w)
    assert not xp[..., width:].any() and not wp[..., width:].any()
    np.testing.assert_allclose(mobius_linear(xp, wp, b).numpy(),
                               mobius_linear(x, w, b).numpy(), rtol=0,
                               atol=1e-6)


def test_check_case_holds_the_signal_axis_to_each_signals_launch():
    """On CPU tensors the kernel wrapper is the plain version: each signal
    of a stacked call equals its own call, within 1e-6 of plain."""
    from hypad_tpu_torch.manifold.kernels import mobius_linear_kernel

    x, w, b = k1_case(64, 123, 3, device="cpu")
    err, same = check_case(mobius_linear_kernel, x, w, b, "(3, 64, 123)")
    assert err == 0.0 and same is None


@pytest.mark.parametrize("kind", sorted(PROBES))
def test_probe_builds_of_the_tree_set_its_hook(kind):
    text = (_build.CSRC / "mobius_linear.cu").read_text()
    out = probe_source(text, kind)
    assert out == f"#define HYPAD_K1_PROBE {PROBES[kind]}\n{text}"


def test_variant_source_sets_one_constant():
    text = (_build.CSRC / "mobius_linear.cu").read_text()
    now = int(re.search(r"constexpr int kFewWarps = (\d+);", text)[1])
    out = variant_source(text, f"kFewWarps={now + 1}")
    assert f"constexpr int kFewWarps = {now + 1};" in out
    assert out.replace(f"kFewWarps = {now + 1};", "") == text.replace(
        f"kFewWarps = {now};", "")
    with pytest.raises(RuntimeError):
        variant_source(text, "kNoSuchConstant=1")


def test_split_flags_are_variants_of_the_few_rows_split_instance():
    """--split-ranks, --split-slice and --split-blocks each give one
    variant a value, of a constexpr int the source defines once, which
    variant_source sets alone."""
    text = (_build.CSRC / "mobius_linear.cu").read_text()
    specs = split_variants({"split_ranks": [4, 0], "split_slice": [16],
                            "split_blocks": [132]})
    assert specs == ["kFewSplitRanks=4", "kFewSplitRanks=0",
                     "kFewSplitSlice=16", "kFewSplitBlocks=132"]
    assert split_variants({}) == []
    for name in SPLIT_FLAGS.values():
        assert len(re.findall(rf"constexpr int {name} = \d+;", text)) == 1
    for spec in specs:
        name, value = spec.split("=")
        out = variant_source(text, spec)
        assert f"constexpr int {name} = {value};" in out
        assert len(out.splitlines()) == len(text.splitlines())


def test_the_handoff_probe_is_the_few_rows_split_instances():
    """The "handoff" probe (5) exits after the products' hand-off, a hook
    only the few-rows split instance has; a baseline source without it is
    not built as that probe."""
    text = (_build.CSRC / "mobius_linear.cu").read_text()
    assert PROBES["handoff"] == 5
    assert "HYPAD_K1_PROBE == 5" in text
