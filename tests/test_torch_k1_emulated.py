"""K1's instances above 128 columns and its few-rows split instance
(``hypad_tpu_torch/csrc/mobius_linear.cu``) run on the CPU in the emulation
of ``tests/critic_emu``: the kernel source itself, built with g++, one
pthread per CUDA thread.

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

The few-rows split instance (``mobius_linear_kernel_split`` /
``mobius_linear_wide_kernel_split``) spreads a tile's padded columns over
a cluster's ranks in the same way and runs, on each row's owner, the
epilogue of the
few-rows kernel it replaces (``mobius_linear_kernel<TN, 1>`` /
``mobius_linear_wide_kernel<TN, 1>``, which the route FEW_KERNEL takes):
each launch is held bitwise against that kernel in the same emulation,
one tile a cluster as on the card, and the extension's own count of its
launches (``mobius_linear_split_launches``) says which kernel took each.
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
    ("  const std::array<int, 7> key = {device, sms, s.rows, s.din, s.dout,\n",
     "  const std::array<int, 7> key = {device, sms + 1000 * k1_emu_path,\n"
     "                                  s.rows, s.din, s.dout,\n"),
    # the few rows: the split instance (k1_emu_few 0) or the few-rows
    # kernels it replaces (1)
    ("  if (s.rows <= 32 * sms &&\n",
     "  if (k1_emu_few == 0 && s.rows <= 32 * sms &&\n"),
)
SPLIT, RING, IN_OUT = 0, 1, 2
FEW_SPLIT, FEW_KERNEL = 0, 1


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
    return ('extern "C" {\nint k1_emu_path = 0;\nint k1_emu_few = 0;\n}\n'
            + text)


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
    few_route = ctypes.c_int.in_dll(lib, "k1_emu_few")
    few_launches = lib.mobius_linear_split_launches
    few_launches.restype = ctypes.c_longlong

    def run(x, w, b, schedule=(FREE, 0), sms=132, route=SPLIT,
            few=FEW_SPLIT):
        """K1's output in the emulation; ``run.split`` tells whether the
        few-rows split instance took the launch."""
        x3, w3, b3 = ((x, w, b) if x.dim() == 3 else
                      (x[None], w[None], b[None]))
        out = torch.full((*x3.shape[:-1], w3.shape[-2]), float("nan"))
        path.value, few_route.value = route, few
        before = few_launches()
        lib.critic_emu_schedule(*schedule, STATIC, sms)
        assert forward(x3.data_ptr(), w3.data_ptr(), b3.data_ptr(),
                       out.data_ptr(), *x3.shape, w3.shape[-2], None) == 0
        run.split = few_launches() > before
        return out if x.dim() == 3 else out[0]

    run.lib = lib
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


@pytest.mark.parametrize("rows,width,signals", [
    (64, 100, None), (64, 100, 3), (128, 100, None), (64, 51, 3),
    (64, 123, None), (64, 256, None), (14, 100, None), (14, 150, None)])
def test_few_rows_split_bitwise_the_few_rows_kernel(k1, rows, width,
                                                    signals):
    """The few-rows split instance at the generator step's shapes (ranks of
    13 columns at 100 by one bulk copy into place, 8 at 51, 16 at 123 and
    32 at 256 by one bulk copy from the 16-byte boundary below and a
    repack, 19 at 150; 14 rows: the second tile partial), a tile a cluster
    on 132 SMs as on the card: the same bits with the ranks in turns both
    ways and the copies landing early or late, the bits of the few-rows
    kernel it replaces, each signal its own launch's, within 1e-6 of plain.
    A rank that read a row before every rank had sent its products would
    not (the hand-off's cluster barrier taken out)."""
    torch.set_num_threads(1)
    x, w, b = case(rows, width, signals)
    got = k1(x, w, b, (ASCENDING, 0))
    assert k1.split
    assert torch.equal(got, k1(x, w, b, (DESCENDING, 1)))
    assert torch.equal(got, k1(x, w, b, few=FEW_KERNEL))
    assert not k1.split
    within_plain(got, x, w, b)
    if signals:
        for i in range(signals):
            assert torch.equal(got[i], k1(x[i].contiguous(), w[i], b[i]))


def off_boundary(t):
    """A copy of ``t`` one float past a 16-byte boundary."""
    moved = torch.empty(t.numel() + 1)[1:].view(t.shape)
    assert moved.data_ptr() % 16 == 4
    return moved.copy_(t)


@pytest.mark.parametrize("moved", ["x", "w"])
def test_few_rows_split_unaligned_after_aligned(k1, moved):
    """(64, 100) on 16-byte-aligned x and W copies each rank's W rows and
    the tile into place; the same shape then launched on an x (or W) one
    float off the boundary is planned apart and copies from the boundary
    below into raw regions, repacked: the split instance takes both
    launches, with the copies landing early or late, each bitwise the
    aligned launch and the few-rows kernel on the same tensors. A plan
    shared by the two layouts would copy from an address off the 16-byte
    boundary, which the emulation (as the card) refuses."""
    torch.set_num_threads(1)
    x, w, b = case(64, 100)
    got = k1(x, w, b, (ASCENDING, 0))
    assert k1.split
    args = (off_boundary(x), w, b) if moved == "x" else (x, off_boundary(w),
                                                        b)
    for schedule in ((ASCENDING, 0), (DESCENDING, 1)):
        assert torch.equal(got, k1(*args, schedule))
        assert k1.split
    assert torch.equal(got, k1(*args, few=FEW_KERNEL))
    assert not k1.split


@pytest.mark.parametrize("signals,rows,width,sms,want", [
    (1, 64, 100, 132, (8, 13, 1, 8, 8, 128)),
    (1, 128, 100, 132, (8, 13, 2, 16, 8, 224)),
    (3, 64, 100, 132, (8, 13, 2, 16, 4, 224)),
    (3, 64, 51, 132, (8, 8, 2, 16, 4, 128)),
    (1, 64, 123, 132, (8, 16, 1, 8, 8, 128)),
    (1, 64, 150, 132, (8, 19, 1, 8, 8, 160)),
    (1, 128, 256, 132, (8, 32, 2, 16, 8, 512)),
    (1, 14, 100, 8, None),
    (1, 64, 100, 8, None),
    (9, 128, 100, 132, None), (3, 2280, 100, 132, None),
    (1, 64, 300, 132, None), (1, 20000, 100, 132, None),
    (1, 5000, 150, 132, None)])
def test_few_rows_split_plan(k1, signals, rows, width, sms, want):
    """``mobius_linear_split_plan`` (the instance's plan, as the dispatch
    makes it): 8 ranks of ceil(8 TN / 8) columns, the fewest rows a rank
    (1, 2 or 4) that keep the launch at or under 96 blocks, a thread an
    output (512 at most); none where even 4 rows a rank exceed 96 blocks (9
    signals of 128 rows), where the tiles outnumber the clusters that fit
    at one block a SM (2,280 rows; on 8 SMs, one cluster, even 14 rows),
    past 256 columns or on many rows."""
    from hypad_tpu_torch.profile_k1 import split_plan

    plan = split_plan(k1.lib, signals, rows, width, width, sms)
    if want is None:
        assert plan is None
        return
    got = tuple(plan[key] for key in ("ranks", "slice", "own", "tile_rows",
                                      "clusters", "threads"))
    assert got == want
    assert plan["clusters"] * plan["ranks"] * signals <= 96
    assert 0 < plan["smem"] <= 227 * 1024
