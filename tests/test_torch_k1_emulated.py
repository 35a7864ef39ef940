"""K1's instances above 128 columns (``hypad_tpu_torch/csrc/mobius_linear.cu``)
run on the CPU in the emulation of ``tests/critic_emu``: the kernel source
itself, built with g++, one pthread per CUDA thread.

The any-width split kernel spreads a tile's columns over the ranks of a
cluster and sends each row's products to its owner's shared memory; the
emulation runs each cluster's blocks at once, or one at a time between
cluster barriers in ascending or descending rank order, with the copies
landing when issued or only when waited for. A rank that read a row
before every rank had written it would give different bits in the two
orders. Each launch is held against the plain ``mobius_linear`` (1e-6, as
on the card) and, bitwise, against the kernels that share every output's
FMA chain and the epilogue's order: the split kernel against the ring
kernel, with each row's products in shared memory and (as it runs past
about 10,000 columns) in the output itself, and the wide ring kernel
against the wide kernel's few-rows path.
"""

from __future__ import annotations

import ctypes
import re
import shutil

import pytest
import torch

from hypad_tpu_torch import _build

from test_torch_critic_step_emulated import (
    ASCENDING,
    DESCENDING,
    FREE,
    STATIC,
    compile_emulated,
)

SHARED = "  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
EMU_SHARED = ("  unsigned char* smem_raw = "
              "(unsigned char*)emu::dynamic_shared();\n")
LAUNCH = re.compile(r"(\w+)<<<(dim3\([^()]*\)), ([^,]+), ([^,]+), [^>]+>>>\(")
# which any-width kernel takes a launch: 0 the split kernel where it
# applies, 1 the ring kernel, 2 the ring kernel with the products in the
# output; each route planned apart
PATHS = (
    ("  const size_t smem = split_plan(pl->p, s, sms, &clusters);\n",
     "  const size_t smem =\n"
     "      k1_emu_path < 1 ? split_plan(pl->p, s, sms, &clusters) : 0;\n"),
    ("  for (int io = 0; io <= (kAny ? 1 : 0) && !smem; ++io) {\n",
     "  for (int io = kAny && k1_emu_path > 1; io <= (kAny ? 1 : 0) && !smem;"
     "\n       ++io) {\n"),
    ("  const std::array<int, 6> key = {device, sms, s.rows, s.din, s.dout,\n",
     "  const std::array<int, 6> key = {device, sms + 1000 * k1_emu_path,\n"
     "                                  s.rows, s.din, s.dout,\n"),
)
SPLIT, RING, IN_OUT = 0, 1, 2


def emulated_source(text):
    """``text`` (a ``mobius_linear.cu``) with its shared memory and
    launches as the emulation provides them and the any-width path chosen
    by ``k1_emu_path``."""
    n = text.count(SHARED)
    assert n >= 4, "mobius_linear.cu no longer declares smem_raw so"
    text = text.replace(SHARED, EMU_SHARED)
    text, launches = LAUNCH.subn(r"emu_launch(\1, \2, \3, \4, ", text)
    assert launches >= 3 and "<<<" not in text and "__shared__" not in text
    for old, new in PATHS:
        assert text.count(old) == 1, f"the source no longer holds:\n{old}"
        text = text.replace(old, new)
    return 'extern "C" {\nint k1_emu_path = 0;\n}\n' + text


@pytest.fixture(scope="module")
def k1(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the emulation is built with g++")
    from hypad_tpu_torch.manifold import kernels as mk

    root = tmp_path_factory.getbasetemp().parent / "k1_emu"
    text = emulated_source((_build.CSRC / "mobius_linear.cu").read_text())
    lib = ctypes.CDLL(str(compile_emulated(text, root, 132)))
    forward = mk.bind_signals(lib)
    lib.critic_emu_schedule.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_int]
    path = ctypes.c_int.in_dll(lib, "k1_emu_path")

    def run(x, w, b, schedule=(FREE, 0), sms=132, route=SPLIT):
        x3, w3, b3 = ((x, w, b) if x.dim() == 3 else
                      (x[None], w[None], b[None]))
        out = torch.full((*x3.shape[:-1], w3.shape[-2]), float("nan"))
        path.value = route
        lib.critic_emu_schedule(*schedule, STATIC, sms)
        assert forward(x3.data_ptr(), w3.data_ptr(), b3.data_ptr(),
                       out.data_ptr(), *x3.shape, w3.shape[-2], None) == 0
        return out if x.dim() == 3 else out[0]

    return run


def case(rows, width, signals=None, dout=None):
    from hypad_tpu_torch.profile_k1 import k1_case

    x, w, b = k1_case(rows, width, signals, device="cpu")
    if dout is not None:  # the first dout output columns
        w, b = w[..., :dout, :].contiguous(), b[..., :dout].contiguous()
    return x, w, b


def within_plain(got, x, w, b):
    from hypad_tpu_torch.manifold.kernels import mobius_linear

    assert (got - mobius_linear(x, w, b)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("rows,width,signals,dout", [
    (9, 300, None, None), (5, 260, None, None), (9, 300, 3, None),
    (6, 301, None, 100)])
def test_any_width_split_kernel_same_bits_every_schedule(k1, rows, width,
                                                         signals, dout):
    """The split kernel (ranks of 64 columns; rows of 1,204 and 1,040 bytes
    by one bulk copy a row, 301 by 4-byte copies) gives the same bits with
    the ranks in turns both ways and the copies landing early or late, the
    bits of the ring kernel with the products in shared memory and in the
    output, each signal its own launch's, within 1e-6 of plain."""
    torch.set_num_threads(1)
    x, w, b = case(rows, width, signals, dout)
    got = k1(x, w, b, (ASCENDING, 0))
    assert torch.equal(got, k1(x, w, b, (DESCENDING, 1)))
    assert torch.equal(got, k1(x, w, b, route=RING))
    assert torch.equal(got, k1(x, w, b, route=IN_OUT))
    within_plain(got, x, w, b)
    if signals:
        for i in range(signals):
            assert torch.equal(got[i], k1(x[i].contiguous(), w[i], b[i]))


@pytest.mark.parametrize("width", [150, 256])
def test_wide_many_rows_bitwise_the_few_rows_path(k1, width):
    """40 rows on a card of one SM take the many-rows kernels (256: the
    ring, W's k chunks through three slots; 150: mobius_linear_wide_kernel's
    rounds, W whole); on 132 SMs the few-rows path. Both give the same
    bits, with the copies landing early or late, within 1e-6 of plain."""
    torch.set_num_threads(1)
    x, w, b = case(40, width)
    got = k1(x, w, b, (FREE, 1), sms=1)
    assert torch.equal(got, k1(x, w, b, (FREE, 0), sms=132))
    within_plain(got, x, w, b)
