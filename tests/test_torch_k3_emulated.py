"""K3's instances above 128 columns (``hypad_tpu_torch/csrc/kde_argmax.cu``,
the group kernels) run on the CPU in the emulation of ``tests/critic_emu``:
the kernel source itself, built with g++, one pthread per CUDA thread.

A group of rows hands each round's forward terms to the threads whose back
terms they are, under its own named barrier. The emulation runs a block's
warps all at once, or one warp at a time between barriers in ascending or
descending order: a warp that read a hand-off before its writer had
written it, or a writer that overwrote a buffer still being read, would
give different bits in the two orders. Each launch is held bitwise against
the other schedules, against one persistent block walking every row group
and against one group a block of other rows, within a density
tie of the plain v2 form, and bitwise against the parent's kernels, which
the source still holds: the wide instance as ``kde_argmax_body<256, true>``
(instantiated here as the parent launched it) and the one-block-a-row
``kde_argmax_v2_xwide_kernel`` (the width at which the group kernels end set
below the rows).
"""

from __future__ import annotations

import ctypes
import re
import shutil

import pytest
import torch

from hypad_tpu_torch import _build

from test_torch_critic_step_emulated import compile_emulated

SHARED = (
    ("  extern __shared__ __align__(16) unsigned char smem_raw[];\n",
     "  unsigned char* smem_raw = (unsigned char*)emu::dynamic_shared();\n",
     2),
    ("  __shared__ float redf[kXwMaxWarps];\n",
     "  float* redf = (float*)emu::shared(0);\n", 1),
    ("  __shared__ int redi[kXwMaxWarps];\n",
     "  int* redi = (int*)emu::shared(1);\n", 1),
    ("  __shared__ int first;\n",
     "  int& first = *(int*)emu::shared(2);\n", 1),
    ('  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");\n',
     "  emu::named_sync(id, threads);\n", 1),
)
LAUNCH = re.compile(r"(\w+)<<<([^,<>]+), ([^,<>]+), ([^,<>]+), [^>]+>>>\(")
# the parent's wide K3, launched as the parent's entry launched it
PARENT_WIDE = """
__global__ void emu_parent_v2_wide_kernel(const float* vals,
                                          const unsigned char* mask,
                                          float* kde_val, unsigned char* use,
                                          int rows, int width) {
  kde_argmax_body<kWideMaxW, true>(vals, mask, kde_val, use, rows, width);
}
int emu_parent_v2_wide(const float* vals, const unsigned char* mask,
                       float* kde_val, unsigned char* use, int rows,
                       int width) {
  const int nb = row_blocks<kWideRows>(width);
  emu_launch(emu_parent_v2_wide_kernel,
             dim3((rows + kWideRows - 1) / kWideRows), dim3(kWideRows * nb),
             smem_bytes<kWideRows>(nb, true), vals, mask, kde_val, use, rows,
             width);
  return 0;
}
"""
PARENT_WIDE_ENTRY = """
extern "C" int emu_parent_v2_wide_forward(const float* vals,
                                          const unsigned char* mask,
                                          float* kde_val, unsigned char* use,
                                          int rows, int width, void*) {
  return emu_parent_v2_wide(vals, mask, kde_val, use, rows, width);
}
"""
FREE, ASCENDING, DESCENDING = 0, 1, 2
STATIC = 33712
H100_SMEM_OPTIN = 232448   # the dynamic shared memory a block may opt in to
PLAN_KEYS = ("R", "gthreads", "G", "blocks", "smem")


def set_constant(text, name, value):
    text, n = re.subn(rf"constexpr int {name} = \d+;",
                      f"constexpr int {name} = {value};", text)
    assert n == 1, f"kde_argmax.cu no longer defines {name} once"
    return text


def emulated_source(text, **constants):
    """``text`` (a ``kde_argmax.cu``) with its shared memory, barriers and
    launches as the emulation provides them, the ``constexpr int``
    constants given set, and the parent's wide K3 beside it."""
    for old, new, n in SHARED:
        assert text.count(old) == n, f"kde_argmax.cu no longer holds:\n{old}"
        text = text.replace(old, new)
    text, launches = LAUNCH.subn(r"emu_launch(\1, dim3(\2), dim3(\3), \4, ",
                                text)
    assert launches >= 3 and "<<<" not in text and "__shared__" not in text
    assert "asm" not in text
    for name, value in constants.items():
        text = set_constant(text, name, value)
    head, tail = text.rsplit("}  // namespace", 1)
    return (head + PARENT_WIDE + "}  // namespace" + tail
            + PARENT_WIDE_ENTRY)


def emulated_root(tmp_path_factory):
    """Where the emulated K3 libraries are built, shared by the workers."""
    return tmp_path_factory.getbasetemp().parent / "k3_emu"


def tree_library(tmp_path_factory):
    """The tree's kde_argmax.cu built in the emulation (one build for the
    test workers); skips without g++."""
    if shutil.which("g++") is None:
        pytest.skip("the emulation is built with g++")
    text = emulated_source((_build.CSRC / "kde_argmax.cu").read_text())
    return ctypes.CDLL(str(compile_emulated(
        text, emulated_root(tmp_path_factory), 1)))


def group_plan(lib, rows, width, sms, smem_optin=H100_SMEM_OPTIN):
    """The plan ``kde_argmax_v2_group_plan`` of ``lib`` (a build of
    kde_argmax.cu) makes for a K3 launch on ``rows`` rows of ``width`` on a
    card of ``sms`` SMs: {"R", "gthreads", "G", "blocks", "smem"} and
    "walks", the row groups each group walks at most (row group q, rows
    qR..qR+R-1, goes to group s // blocks of block s % blocks, s = q mod
    blocks G, walked in ascending q); None where the group kernels do not
    take the shape."""
    fn = lib.kde_argmax_v2_group_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    if fn(rows, width, sms, smem_optin, out) != 0:
        return None
    plan = dict(zip(PLAN_KEYS, out))
    groups = -(-rows // plan["R"])
    plan["walks"] = -(-groups // (plan["blocks"] * plan["G"]))
    return plan


@pytest.fixture(scope="module")
def k3(tmp_path_factory):
    """run(vals, mask, lib, warps, sms, blocks_down) -> (value, use) of a K3
    launch in the emulation: lib "tree", "one_group" (one group a block, of 2 rows at
    150 columns and 1 at 300), "parent_xwide" (rows above 256
    on the parent's one-block-a-row kernel) or "parent_wide" (the parent's
    wide K3); warps FREE, ASCENDING or DESCENDING; a card of ``sms`` SMs;
    the blocks one after another, in ascending or (``blocks_down``)
    descending order. A launch asks the card's SM count once, so each SM
    count has its own copy of a library."""
    if shutil.which("g++") is None:
        pytest.skip("the emulation is built with g++")
    from hypad_tpu_torch.ops import kde_kernel as kk

    root = emulated_root(tmp_path_factory)
    text = (_build.CSRC / "kde_argmax.cu").read_text()
    sources = {"tree": emulated_source(text),
               "one_group": emulated_source(text, kK3MaxGroups=1,
                                            kK3GroupThreads=128),
               "parent_xwide": emulated_source(text, kK3TriMaxW=256)}
    libs = {}

    def library(name, sms):
        if (name, sms) not in libs:
            lib = ctypes.CDLL(str(compile_emulated(sources[name], root,
                                                   sms)))
            lib.critic_emu_schedule.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
            lib.emu_warp_order.argtypes = [ctypes.c_int]
            lib.emu_block_order.argtypes = [ctypes.c_int]
            libs[name, sms] = lib
        return libs[name, sms]

    entry = {"tree": ("tree", "kde_argmax_v2_forward"),
             "one_group": ("one_group", "kde_argmax_v2_forward"),
             "parent_xwide": ("parent_xwide", "kde_argmax_v2_forward"),
             "parent_wide": ("tree", "emu_parent_v2_wide_forward")}

    def run(vals, mask, lib="tree", warps=FREE, sms=1, blocks_down=False):
        name, symbol = entry[lib]
        built = library(name, sms)
        fn = kk.bind(built, symbol)
        built.critic_emu_schedule(FREE, 0, STATIC, sms)
        built.emu_warp_order(warps)
        built.emu_block_order(int(blocks_down))
        T, W = vals.shape
        value = torch.full((T,), float("nan"))
        use = torch.zeros(T, dtype=torch.bool)
        try:
            assert fn(vals.data_ptr(), mask.data_ptr(), value.data_ptr(),
                      use.data_ptr(), T, W, None) == 0
        finally:
            built.emu_warp_order(FREE)
            built.emu_block_order(0)
        return value, use

    return run


def rows_of(width, n, runs=0, nans=False, take=None):
    """A few anti-diagonal rows of ``profile_kernels.k2_case``: the first
    ``take[0]`` rows (the masked edge, a row of one sample first), full
    rows from the middle, and the last ``take[2]`` rows."""
    from hypad_tpu_torch.profile_kernels import k2_case

    vals, mask = k2_case(n, width, runs, device="cpu", nans=nans)
    head, mid, tail = take
    m0 = vals.shape[0] // 2
    idx = torch.cat([torch.arange(head), torch.arange(m0, m0 + mid),
                     torch.arange(vals.shape[0] - tail, vals.shape[0])])
    return vals[idx].contiguous(), mask[idx].contiguous()


def same(a, b):
    from hypad_tpu_torch.profile_kernels import same_values

    return same_values(a[0], b[0]) and torch.equal(a[1], b[1])


def near_plain(got, vals, mask):
    """Use flags bitwise the plain v2 form's, fallback rows bitwise
    masked_median, the other rows a sample at a float64 density tie."""
    from hypad_tpu_torch.ops.kde import kde_argmax_rows_v2_and_use
    from hypad_tpu_torch.ops.unroll import masked_median
    from hypad_tpu_torch.profile_kernels import near_tie_flips, same_values

    value, use = got
    want, want_use = kde_argmax_rows_v2_and_use(vals, mask)
    assert torch.equal(use, want_use)
    assert same_values(value[~use], masked_median(vals, mask)[~use])
    near_tie_flips(value[use], want[use], vals[use], mask[use])


# (width, windows, constant run end, NaNs, rows taken: head, middle, tail)
CASES = [(150, 300, 0, False, (6, 12, 4)), (150, 300, 250, False, (4, 8, 4)),
         (300, 700, 0, False, (4, 8, 4)), (300, 700, 0, True, (3, 6, 3))]


@pytest.mark.parametrize("width,n,runs,nans,take", CASES)
def test_group_kernels_same_bits_every_schedule(k3, width, n, runs, nans,
                                                take):
    """The warps one at a time both ways, all at once, one persistent block
    walking every row group or a block a row group, and one group a block
    of other rows (its many blocks also in descending order) give the same
    bits, the parent's kernel's, within a density tie of the plain v2 form
    (fallback rows bitwise masked_median)."""
    torch.set_num_threads(1)
    vals, mask = rows_of(width, n, runs, nans, take)
    got = k3(vals, mask, warps=ASCENDING)
    assert same(got, k3(vals, mask, warps=DESCENDING))
    assert same(got, k3(vals, mask, sms=132))
    assert same(got, k3(vals, mask, "one_group"))
    assert same(got, k3(vals, mask, "one_group", DESCENDING, sms=132,
                        blocks_down=True))
    parent = "parent_wide" if width <= 256 else "parent_xwide"
    assert same(got, k3(vals, mask, parent))
    near_plain(got, vals, mask)
