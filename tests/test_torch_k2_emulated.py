"""K2's group kernels above 128 columns (``kde_argmax_group_wide_kernel`` /
``_xwide_kernel`` of ``hypad_tpu_torch/csrc/kde_argmax.cu``) run on the CPU
in the emulation of ``tests/critic_emu``: the kernel source itself, built
with g++, one pthread per CUDA thread.

A group of rows hands each round's column partials to the partner block's
thread through one of two buffers, under its own named barrier. A warp that
read a partial before its writer had written it, or a writer that
overwrote a buffer still being read, would give other bits when the warps
run one at a time in ascending or in descending order. The pair's term on
the card is the SFU's ``ex2``; the emulation's ``hypad::ex2_approx``
(``critic_emu/cuda_runtime.h``) is a host stand-in, not the card's bits, so
launches are compared bit for bit only with other emulated launches:

* the warps in turns both ways and all at once, one persistent block
  walking every row group and one group a block, give the same bits;
* use flags and fallback rows are bitwise the plain version's
  (``ops/kde.py`` ``kde_argmax_rows_and_use``), the other rows at a float64
  density tie (``near_tie_flips``);
* with the term as ``expf`` (``kK2Ex2 = 0``) the group kernels sum in the
  parent's order, so up to 256 columns they are bitwise the parent's wide
  K2, ``kde_argmax_body<256, false>`` (instantiated here as the parent
  launched it);
* the narrow K2 (``kde_argmax_kernel``, up to 128 columns) takes the same
  term: within a density tie of the plain version and of its ``expf``
  build (the narrow K2 before the term), use flags and fallback rows
  bitwise; the narrow K3 (``kde_argmax_v2_kernel``), whose term stays
  ``expf``, has the same bits in both builds.

The libraries build once for the test workers (``compile_emulated``); the
tree's is ``test_torch_k3_emulated``'s.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import shutil

import pytest
import torch

from hypad_tpu_torch import _build

from test_torch_critic_step_emulated import compile_emulated
from test_torch_k3_emulated import (
    ASCENDING,
    DESCENDING,
    FREE,
    H100_SMEM_OPTIN,
    PLAN_KEYS,
    STATIC,
    emulated_root,
    emulated_source,
    rows_of,
    same,
)

# the parent's wide K2, launched as the parent's entry launched it
PARENT_K2_WIDE = """
__global__ void emu_parent_wide_kernel(const float* vals,
                                       const unsigned char* mask,
                                       float* kde_val, unsigned char* use,
                                       int rows, int width) {
  kde_argmax_body<kWideMaxW, false>(vals, mask, kde_val, use, rows, width);
}
int emu_parent_wide(const float* vals, const unsigned char* mask,
                    float* kde_val, unsigned char* use, int rows, int width) {
  const int nb = row_blocks<kWideRows>(width);
  emu_launch(emu_parent_wide_kernel,
             dim3((rows + kWideRows - 1) / kWideRows), dim3(kWideRows * nb),
             smem_bytes<kWideRows>(nb, false), vals, mask, kde_val, use, rows,
             width);
  return 0;
}
"""
PARENT_K2_WIDE_ENTRY = """
extern "C" int emu_parent_wide_forward(const float* vals,
                                       const unsigned char* mask,
                                       float* kde_val, unsigned char* use,
                                       int rows, int width, void*) {
  return emu_parent_wide(vals, mask, kde_val, use, rows, width);
}
"""
TRI_MAX_W = 4096   # kK3TriMaxW: the group kernels' widest row
MAX_THREADS = 1024  # kK3Threads: a block's threads at most


def expf_source(text):
    """``text`` in the emulation with the pair's term as ``expf``, one
    group a block of about 128 threads, and the parent's wide K2 beside
    it."""
    text = emulated_source(text, kK2Ex2=0, kK2MaxGroups=1,
                           kK2GroupThreads=128, kK2XGroupThreads=128)
    head, tail = text.rsplit("}  // namespace", 1)
    return (head + PARENT_K2_WIDE + "}  // namespace" + tail
            + PARENT_K2_WIDE_ENTRY)


@pytest.fixture(scope="module")
def k2(tmp_path_factory):
    """run(vals, mask, lib, warps, sms, blocks_down) -> (value, use) of a K2
    launch in the emulation: lib "tree" (the source as it is), "expf" (the
    term as expf, one group a block) or "parent_wide" (the parent's wide
    K2, in the "expf" build), or of a K3 launch: "k3_tree" and "k3_expf"
    (K3 of the two builds); warps FREE, ASCENDING or DESCENDING; a card of
    ``sms`` SMs; the blocks in ascending or (``blocks_down``) descending
    order. Also ``run.plan(rows, width, sms, smem_optin)``, the tree's
    ``kde_argmax_group_plan``."""
    if shutil.which("g++") is None:
        pytest.skip("the emulation is built with g++")
    from hypad_tpu_torch.ops import kde_kernel as kk

    root = emulated_root(tmp_path_factory)
    text = (_build.CSRC / "kde_argmax.cu").read_text()
    sources = {"tree": emulated_source(text), "expf": expf_source(text)}
    # one g++ a source, all at once, and a copy for each SM count the tests
    # use
    keys = [(name, sms) for name in sources for sms in (1, 132)]
    with concurrent.futures.ThreadPoolExecutor(len(keys)) as pool:
        built = {key: pool.submit(compile_emulated, sources[key[0]], root,
                                  key[1]) for key in keys}
        libs = {key: ctypes.CDLL(str(f.result())) for key, f in built.items()}
    for lib in libs.values():
        lib.critic_emu_schedule.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        lib.emu_warp_order.argtypes = [ctypes.c_int]
        lib.emu_block_order.argtypes = [ctypes.c_int]
    entry = {"tree": ("tree", "kde_argmax_forward"),
             "expf": ("expf", "kde_argmax_forward"),
             "parent_wide": ("expf", "emu_parent_wide_forward"),
             "k3_tree": ("tree", "kde_argmax_v2_forward"),
             "k3_expf": ("expf", "kde_argmax_v2_forward")}

    def run(vals, mask, lib="tree", warps=FREE, sms=1, blocks_down=False):
        name, symbol = entry[lib]
        built = libs[name, sms]
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

    def plan(rows, width, sms, smem_optin=H100_SMEM_OPTIN):
        fn = libs["tree", 1].kde_argmax_group_plan
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
        out = (ctypes.c_longlong * len(PLAN_KEYS))()
        if fn(rows, width, sms, smem_optin, out) != 0:
            return None
        return dict(zip(PLAN_KEYS, out))

    run.plan = plan
    return run


def near_plain(got, vals, mask):
    """Use flags bitwise the plain version's, fallback rows bitwise
    masked_median, the other rows a sample at a float64 density tie of the
    plain pick."""
    from hypad_tpu_torch.ops.kde import kde_argmax_rows_and_use
    from hypad_tpu_torch.ops.unroll import masked_median
    from hypad_tpu_torch.profile_kernels import near_tie_flips, same_values

    value, use = got
    want, want_use = kde_argmax_rows_and_use(vals, mask)
    assert torch.equal(use, want_use)
    assert same_values(value[~use], masked_median(vals, mask)[~use])
    near_tie_flips(value[use], want[use], vals[use], mask[use])


# (width, windows, constant run end, NaNs, rows taken: head, middle, tail):
# nb = 38 blocks a row at 150 (the last round taken by half the blocks),
# 33 at 129 and 75 at 300 (every round by all)
CASES = [(150, 300, 0, False, (6, 12, 4)), (150, 300, 250, False, (4, 8, 4)),
         (300, 700, 0, True, (3, 6, 3))]
EXPF_CASES = [(150, 300, 0, False, (6, 12, 4)),
              (129, 300, 250, False, (4, 8, 4)),
              (300, 700, 0, True, (3, 6, 3))]


@pytest.mark.parametrize("width,n,runs,nans,take", CASES)
def test_group_kernels_same_bits_every_schedule(k2, width, n, runs, nans,
                                                take):
    """The tree's K2 (the SFU term's stand-in), its groups as the plan
    makes them: the warps one at a time both ways and all at once give the
    same bits, within a density tie of the plain version (use flags and
    fallback rows bitwise)."""
    torch.set_num_threads(1)
    vals, mask = rows_of(width, n, runs, nans, take)
    got = k2(vals, mask, warps=ASCENDING)
    assert same(got, k2(vals, mask, warps=DESCENDING))
    assert same(got, k2(vals, mask))
    near_plain(got, vals, mask)


@pytest.mark.parametrize("width,n,runs,nans,take", EXPF_CASES)
def test_group_kernels_expf_keep_the_parent_order(k2, width, n, runs, nans,
                                                  take):
    """With the term as expf and one group a block: one persistent block
    walking every row group gives a block a row group's bits, the warps in
    descending turns too, within a density tie of the plain version; up to
    256 columns these are the parent's wide K2's bits."""
    torch.set_num_threads(1)
    vals, mask = rows_of(width, n, runs, nans, take)
    got = k2(vals, mask, "expf", warps=ASCENDING)
    assert same(got, k2(vals, mask, "expf", DESCENDING, sms=132,
                        blocks_down=True))
    if width <= 256:
        assert same(got, k2(vals, mask, "parent_wide"))
    near_plain(got, vals, mask)


# (width, windows, constant run end, NaNs, rows taken) of the narrow
# instances: nb = 25 blocks a row at 100 (13 rounds, every block busy), 16
# at 64 (the last round taken by half the blocks), 2 at 5 (8 blocks a row,
# 32 / R, most of them sentinels)
NARROW_CASES = [(100, 300, 0, False, (6, 12, 4)),
                (100, 300, 250, False, (4, 8, 4)),
                (64, 300, 0, True, (4, 8, 4)), (5, 300, 0, False, (4, 8, 4))]


@pytest.mark.parametrize("width,n,runs,nans,take", NARROW_CASES)
def test_narrow_k2_ex2_at_tie_level_k3_keeps_expf(k2, width, n, runs, nans,
                                                  take):
    """The narrow K2 on the SFU term's stand-in: two launches the same
    bits, within a density tie of the plain version (use flags and fallback
    rows bitwise) and of its ``expf`` build, the narrow K2 of before the
    term (use flags and fallback rows bitwise); the narrow K3 the same bits
    in both builds."""
    from hypad_tpu_torch.profile_kernels import near_tie_flips, same_values

    torch.set_num_threads(1)
    vals, mask = rows_of(width, n, runs, nans, take)
    got = k2(vals, mask)
    assert same(got, k2(vals, mask))
    near_plain(got, vals, mask)
    old = k2(vals, mask, "expf")
    use = got[1]
    assert torch.equal(use, old[1])
    assert same_values(got[0][~use], old[0][~use])
    near_tie_flips(got[0][use], old[0][use], vals[use], mask[use])
    assert same(k2(vals, mask, "k3_tree"), k2(vals, mask, "k3_expf"))


@pytest.mark.parametrize("width", [129, 150, 256, 257, 300, 512, 1024, 4096])
def test_k2_group_plan_fits_a_block(k2, width):
    """The source's K2 plan (``kde_argmax_group_plan``) fits its groups in a
    block's 1,024 threads and the shared memory a block may opt in to, the
    H100's 227 KB and a card of 99 KB alike (K2's hand-off is 2 R nb
    float4s, so every width to 4,096 has a plan there), each group whole
    warps of R rows x nb blocks, and the row groups cover the rows once;
    widths outside 129 to 4,096 have no plan."""
    nb = (width + 3) // 4
    for rows, sms, optin in ((50_149, 132, H100_SMEM_OPTIN),
                             (2_299, 132, H100_SMEM_OPTIN),
                             (7, 132, H100_SMEM_OPTIN),
                             (1_000, 1, H100_SMEM_OPTIN),
                             (50_149, 132, 101_376)):
        plan = k2.plan(rows, width, sms, optin)
        assert plan is not None
        R = plan["R"]
        assert R & (R - 1) == 0 and R <= (8 if width <= 256 else 4)
        assert R * nb <= plan["gthreads"] < R * nb + 32
        assert plan["gthreads"] % 32 == 0
        assert 1 <= plan["G"] and plan["G"] * plan["gthreads"] <= MAX_THREADS
        gsmem, left = divmod(plan["smem"], plan["G"])
        assert left == 0 and gsmem % 16 == 0
        assert gsmem >= 16 * 2 * R * nb + 4 * R * (4 * nb + 2 * nb)
        assert plan["smem"] <= optin
        assert 1 <= plan["blocks"] <= sms
        groups = -(-rows // R)
        slots = plan["blocks"] * plan["G"]
        walks = -(-groups // slots)
        assert slots * walks * R >= rows > (slots * walks - slots) * R
    if width == 129:
        assert k2.plan(100, 128, 132) is None
        assert k2.plan(100, TRI_MAX_W + 1, 132) is None
