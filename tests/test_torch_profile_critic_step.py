"""The CPU side of ``hypad_tpu_torch.profile_critic_step``, which times K5
and K4 (``csrc/critic_step.cu``) beside a parent's build and its probe
builds on the card: the probes' sources, the cases it checks and times,
and the count of the weight bytes each side's block stages."""

import pytest
import torch

from hypad_tpu_torch import _build
from hypad_tpu_torch.models.tadgan import init_tadgan
from hypad_tpu_torch.profile_critic_step import (
    CASES,
    PROBES,
    TIMED,
    case_inputs,
    case_label,
    k5_weight_bytes,
    probe_source,
    probe_sources,
)

# the published widths: latent 20, critics 20 wide, encoder LSTM 50,
# decoder dense1 50 and LSTM 64
A1_DIMS = (64, 100, 20, 20, 20, 50, 50, 64)


@pytest.mark.parametrize("kind", sorted(PROBES))
def test_probe_builds_of_the_tree_set_its_hook(kind):
    """Each probe defines the source's own hook ahead of it and changes
    nothing else; a source without the hook (a parent's) is refused."""
    text = (_build.CSRC / "critic_step.cu").read_text()
    assert "#if HYPAD_CS_PROBE" in text
    out = probe_source(text, kind)
    assert out != text
    assert out == f"#define HYPAD_CS_PROBE {PROBES[kind]}\n{text}"
    assert probe_sources()[f"probe_{kind}"] == out
    with pytest.raises(RuntimeError, match="hook"):
        probe_source("// a kernel without the hook\n", kind)


def test_cases_cover_every_instance_and_the_signal_axis():
    """The checked cases reach the narrow, wide and any-width instances
    (by K5's widest layer, generator included), both geometries, batches
    that leave ranks without rows or split them unevenly, and S = 3 and
    9; every timed shape is a checked case."""
    gen = (A1_DIMS[6], 2 * A1_DIMS[7], 2 * A1_DIMS[5])
    kinds = {_build.instance(max((width, 20) + gen))
             for _, _, width, _ in CASES}
    assert kinds == {"narrow", "wide", "xwide"}
    assert {hyp for hyp, *_ in CASES} == {True, False}
    assert {B for _, B, _, _ in CASES} >= {3, 13, 64, 100}
    assert {S for *_, S in CASES} == {None, 3, 9}
    assert {w for _, _, w, _ in TIMED} == {100, 150, 300}
    assert set(TIMED) <= set(CASES)
    assert len({case_label(*c) for c in CASES}) == len(CASES)


@pytest.mark.parametrize("hyperbolic", [True, False])
def test_weight_bytes_are_the_state_dicts_rows_each_side_reads(hyperbolic):
    """k5_weight_bytes equals the sum over init_tadgan's state dict of
    what K5 reads: every dense and critic weight and bias, and of each
    LSTM's w_ih, b_ih and b_hh the i, g and o rows only (no f rows, no
    w_hh); side x the decoder and critic_x, side z the encoder and
    critic_z. At the A1 widths about 380 and 131 KiB (hyperbolic)."""
    model = init_tadgan(torch.Generator().manual_seed(0), 100,
                        hyperbolic=hyperbolic, device="cpu")
    got = {"x": 0, "z": 0}
    for key, t in model.state_dict().items():
        if "w_hh" in key:
            continue
        side = "x" if key.startswith(("decoder", "critic_x")) else "z"
        if ".lstm." in key:
            H = t.shape[0] // 4
            got[side] += 4 * 3 * H * (t.shape[1] if t.dim() == 2 else 1)
        else:
            got[side] += 4 * t.numel()
    assert k5_weight_bytes(A1_DIMS, hyperbolic) == got
    if hyperbolic:
        assert 375 <= got["x"] / 1024 <= 385
        assert 128 <= got["z"] / 1024 <= 134


def test_case_inputs_stack_the_fleet_as_single_cases():
    """A signal-axis case stacks S single cases of seeds 0 .. S - 1."""
    from hypad_tpu_torch.profile_critic_step import critic_case

    P, x, d = case_inputs("cpu", True, 8, 100, 3)
    assert x.shape == (3, 8, 100) and d["m_cx"].shape == (3, 4, 24, 20)
    for i in range(3):
        model, xi, di = critic_case("cpu", True, 8, 100, seed=i)
        assert torch.equal(x[i], xi)
        assert torch.equal(P["critic_x.dense1.w"][i],
                           model["critic_x"].dense1.w.detach())
        assert all(torch.equal(d[k][i], di[k]) for k in di)


@pytest.mark.parametrize("phase", ["to_critic", "to_gp", "to_bar1",
                                   "to_bar2"])
def test_phase_probes_return_once_at_their_point(phase):
    """A phase probe adds one early return to the current source, after
    waiting for the thread's own cp.async copies; a source without the
    anchor raises."""
    from hypad_tpu_torch.profile_critic_step import phase_source

    text = (_build.CSRC / "critic_step.cu").read_text()
    out = phase_source(text, phase)
    exit_ = "  hypad::cp_async_wait_all();\n  return;\n"
    assert out.count(exit_) == text.count(exit_) + 1
    with pytest.raises(RuntimeError, match="anchor"):
        phase_source("// another kernel\n", phase)
