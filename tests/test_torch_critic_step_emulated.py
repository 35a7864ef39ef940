"""K4 and K5 (``hypad_tpu_torch/csrc/critic_step.cu``) run on the CPU in an
emulation of a cluster (``tests/critic_emu``): the kernel source itself,
built with g++, one pthread per CUDA thread.

A launch runs each cluster's blocks either all at once or one block at a
time between cluster barriers, in ascending or in descending rank order.
Every phase of the kernel reads only rows its own block wrote until a
cluster barrier, so every order must give the same bits; a phase where one
rank reads floats another rank writes before the same barrier gives
different bits in the two orders. The copies into shared memory land either
when they are issued (a slot refilled while it is still read shows) or only
when they are waited for (a read before its wait shows). Each case is held
against the plain autograd versions with the card's tolerances.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from hypad_tpu_torch import _build

EMU = Path(__file__).parent / "critic_emu"
# the kernel's shared-memory declarations, as the emulation provides them
SHARED = (
    ("  __shared__ float red[kWarps + 1];\n",
     "  float* red = (float*)emu::shared(0);\n"),
    ("  __shared__ float static_tile[kIn == kAnyIn ? 1\n"
     "                                             : tile_rows<kIn>() * "
     "(kIn + 1)];\n",
     "  float* static_tile = (float*)emu::shared(1);\n"),
    ("  __shared__ Staging st;\n",
     "  Staging& st = *(Staging*)emu::shared(2);\n"),
    ("  extern __shared__ __align__(16) float dyn[];\n",
     "  float* dyn = (float*)emu::dynamic_shared();\n"),
)
# The race between ranks that the GP chains had until each rank's rows
# began where its first row lies at the widest layer: every layer's rows
# laid out from the buffer's start, `din` floats apart, so that a rank at a
# hidden layer writes floats of the rows a slower rank at layer 0 wrote
# and still reads.
RACY_GP_ROWS = (
    ("    return buf + (size_t)brows.b0 * (wide - d);\n",
     "    return buf;\n"),
)
FREE, ASCENDING, DESCENDING = 0, 1, 2
STATIC = 33712  # the static shared memory the emulated plans assume
K4_TOL = (dict(rtol=2e-5, atol=1e-6), dict(rtol=5e-5, atol=5e-7))
K5_TOL = (dict(rtol=5e-5, atol=2e-6), dict(rtol=1e-4, atol=1e-6))


def substitute(text, pairs):
    for old, new in pairs:
        assert text.count(old) == 1, f"critic_step.cu no longer holds:\n{old}"
        text = text.replace(old, new)
    return text


def emulated_source(text):
    """``text`` (a ``critic_step.cu``) with its shared memory as the
    emulation provides it."""
    text = substitute(text, SHARED)
    assert "__shared__" not in text
    return text


def compile_emulated(text, root, sms):
    """The path of the emulated library of CUDA source ``text``, built with
    g++ once for each text under ``root`` (shared by the test workers), on
    a card of ``sms`` SMs: one copy of the library for each SM count, since
    a launch may ask a device's SM count once."""
    emu = "".join((EMU / name).read_text() for name in sorted(
        ("emu.cpp", "bulk_copy.cuh", "cuda_runtime.h",
         "cooperative_groups.h")))
    common = (_build.CSRC / "common.cuh").read_text()
    tag = hashlib.sha256((text + emu + common).encode()).hexdigest()[:16]
    out = root / tag
    lib = out / "libcritic_emu.so"
    root.mkdir(parents=True, exist_ok=True)
    with open(root / f"{tag}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            out.mkdir(exist_ok=True)
            (out / "k.cpp").write_text(text)
            for name in ("bulk_copy.cuh", "cuda_runtime.h",
                         "cooperative_groups.h"):
                shutil.copy(EMU / name, out / name)
            shutil.copy(_build.CSRC / "common.cuh", out / "common.cuh")
            subprocess.run(
                ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                 "-w", "-I", str(out), str(out / "k.cpp"),
                 str(EMU / "emu.cpp"), "-o", str(lib) + ".tmp"],
                check=True, timeout=600)
            Path(str(lib) + ".tmp").rename(lib)
        copy = out / f"libcritic_emu_{sms}.so"
        if not copy.exists():
            shutil.copy(lib, copy)
    return copy


def build_emulated(text, root, sms):
    """The emulated critic-step library of CUDA source ``text`` (see
    compile_emulated), bound as ``critic_kernel.bind`` binds the card's."""
    from hypad_tpu_torch.train import critic_kernel as ck

    lib = ck.bind(ctypes.CDLL(str(compile_emulated(text, root, sms))))
    lib.critic_emu_schedule.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_int]
    lib.critic_emu_schedule(FREE, 0, STATIC, sms)
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the emulation is built with g++")
    root = tmp_path_factory.getbasetemp().parent / "critic_emu"
    return lambda text, sms=132: build_emulated(emulated_source(text), root,
                                                sms)


def tree_source():
    return (_build.CSRC / "critic_step.cu").read_text()


def k5(lib, inputs, hyperbolic, schedule, sms=132):
    """K5's (lx, lz, grads_cx, grads_cz, bigx, bigz) from one emulated
    launch under ``schedule`` (order, lazy)."""
    from hypad_tpu_torch.train import critic_kernel as ck

    model, x, d = inputs
    ptrs, dims, out, rows = ck.k5_launch_args(model, x, d, hyperbolic)
    ws = torch.full((int(lib.critic_step_workspace_floats(dims)),),
                    float("nan"))
    ptrs[ck.SLOT_WS] = ws.data_ptr()
    lib.critic_emu_schedule(*schedule, STATIC, sms)
    assert lib.critic_step_full_forward(ptrs, dims, int(hyperbolic),
                                        None) == 0
    return (*out, *rows)


def k4(lib, inputs, hyperbolic, schedule):
    """K4's (lx, lz, grads_cx, grads_cz) from one emulated launch on the
    plain version's bigx and bigz."""
    from hypad_tpu_torch.train import critic_kernel as ck

    model, x, d = inputs
    bigx, bigz = ck.critic_step_inputs(model, x, d, hyperbolic)
    ptrs, dims, out = ck.k4_launch_args(model["critic_x"], model["critic_z"],
                                        bigx, bigz, d["m_cx"], d["m_cz"])
    ws = torch.full((int(lib.critic_step_workspace_floats(dims)),),
                    float("nan"))
    ptrs[ck.SLOT_WS] = ws.data_ptr()
    lib.critic_emu_schedule(*schedule, STATIC, 132)
    assert lib.critics_fused_grads_forward(ptrs, dims, None) == 0
    return out


def flat(out):
    return [out[0], out[1]] + [out[i][k] for i in (2, 3)
                               for k in sorted(out[i])] + list(out[4:])


def same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


def assert_close(got, want, tol):
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, **tol[0])
    for i in (2, 3):
        assert sorted(got[i]) == sorted(want[i])
        for key in want[i]:
            torch.testing.assert_close(got[i][key], want[i][key], msg=key,
                                       **tol[1])


def plan_parts(lib, inputs, hyperbolic, full):
    """critic_step_smem_bytes's parts at a case's widths (the emulation's
    static shared memory is the narrow instance's)."""
    from hypad_tpu_torch.train import critic_kernel as ck

    model, x, _ = inputs
    dims = (x.shape[0], x.shape[1], 20, 20, 20, 50, 50, 64)
    return ck.smem_bytes(dims, full, hyperbolic, lib)


@pytest.mark.parametrize("hyperbolic,B,width,direct", [
    (True, 64, 100, (0, 0)),   # the A1 widths, staged
    (False, 13, 123, (0, 0)),  # rows of 492 bytes; rank 7 owns no rows
    # critic_x (20 x 3000) past what shared memory holds: side x reads in
    # place, side z stages
    (False, 8, 3000, (1, 0)),
])
def test_k5_and_k4_give_the_same_bits_in_every_schedule(
        emulated, hyperbolic, B, width, direct):
    """K5 and K4 with every rank in turn first and last between cluster
    barriers, and the copies landing at issue or only when waited for:
    the same bits every way, within the card's tolerances of autograd; K5
    stages its weights where they fit and reads them in place where not,
    K4 always in place."""
    from hypad_tpu_torch.profile_critic_step import critic_case
    from hypad_tpu_torch.train import critic_kernel as ck

    torch.set_num_threads(1)
    lib = emulated(tree_source())
    inputs = critic_case("cpu", hyperbolic, B, width)
    parts5 = plan_parts(lib, inputs, hyperbolic, True)
    assert (parts5["direct_x"], parts5["direct_z"]) == direct
    parts4 = plan_parts(lib, inputs, hyperbolic, False)
    assert (parts4["direct_x"], parts4["direct_z"]) == (1, 1)
    model, x, d = inputs
    a = k5(lib, inputs, hyperbolic, (ASCENDING, 0))
    b = k5(lib, inputs, hyperbolic, (DESCENDING, 1))
    assert same_bits(a, b)
    assert_close(a, ck.critic_step_plain(model, x, d, hyperbolic), K5_TOL)
    bigx, bigz = ck.critic_step_inputs(model, x, d, hyperbolic)
    torch.testing.assert_close(a[4], bigx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a[5], bigz, rtol=1e-5, atol=1e-6)
    a = k4(lib, inputs, hyperbolic, (ASCENDING, 0))
    assert same_bits(a, k4(lib, inputs, hyperbolic, (DESCENDING, 1)))
    assert_close(a, ck.critics_fused_grads_plain(
        model["critic_x"], model["critic_z"], bigx, bigz, d["m_cx"],
        d["m_cz"]), K4_TOL)


def test_the_schedules_show_a_race_between_ranks(emulated):
    """With the GP chains' rows laid out as before their repair (each
    layer's `din` floats apart), the two orders disagree: the emulation
    sees the race the card never showed. The tree agrees with itself."""
    from hypad_tpu_torch.profile_critic_step import critic_case

    torch.set_num_threads(1)
    inputs = critic_case("cpu", True, 64, 100)
    racy = emulated(substitute(tree_source(), RACY_GP_ROWS))
    assert not same_bits(k4(racy, inputs, True, (ASCENDING, 0)),
                         k4(racy, inputs, True, (DESCENDING, 0)))
    lib = emulated(tree_source())
    assert same_bits(k4(lib, inputs, True, (ASCENDING, 0)),
                     k4(lib, inputs, True, (DESCENDING, 0)))


@pytest.mark.parametrize("sms", [132, 16])
def test_k5_signal_axis_gives_each_signal_its_own_bits(emulated, sms):
    """K5 with a signal axis of 2, on a card where its 32 blocks fit at
    once (the grid (16, S)) and on one where they do not (the grid (8, S,
    2), side x's clusters first): each signal's losses, gradients and rows
    bitwise its own single-signal launch."""
    from hypad_tpu_torch.profile_critic_step import case_inputs, critic_case
    from hypad_tpu_torch.train import critic_kernel as ck

    torch.set_num_threads(1)
    lib = emulated(tree_source(), sms)
    P, x, d = case_inputs("cpu", True, 8, 100, 2)
    slots, dims, out, rows = ck.k5_fleet_launch_args(P, x, d, True)
    ws = torch.full((2, int(lib.critic_step_workspace_floats(dims))),
                    float("nan"))
    slots.put(ck.SLOT_WS, ws, "workspace")
    lib.critic_emu_schedule(FREE, 0, STATIC, sms)
    assert lib.critic_step_full_signals_forward(slots.ptrs, slots.strides,
                                                dims, 2, 1, None) == 0
    for i in range(2):
        one = k5(lib, critic_case("cpu", True, 8, 100, seed=i), True,
                 (FREE, 0), sms)
        assert torch.equal(out[0][i], one[0])
        assert torch.equal(out[1][i], one[1])
        for j in (2, 3):
            assert all(torch.equal(out[j][k][i], one[j][k]) for k in one[j])
        assert torch.equal(rows[0][i], one[4])
        assert torch.equal(rows[1][i], one[5])
