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
    PROBES,
    bulk_width,
    check_case,
    k1_case,
    padded,
    probe_source,
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
    for width in (51, 100, 123, 150, 256):
        assert shapes[f"(128, {width})"] == (128, width, None)
        assert shapes[f"(64, {width})"] == (64, width, None)
        assert shapes[f"(3, 64, {width})"] == (64, width, 3)
    assert shapes["(20000, 100)"] == (20000, 100, None)
    assert shapes["(50000, 150)"] == (50000, 150, None)


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
