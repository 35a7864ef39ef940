"""K3's group kernels above 128 columns (``hypad_tpu_torch/csrc/kde_argmax.cu``
``kde_argmax_v2_group_*``), modelled in numpy: the plan (R rows a group, G
groups a persistent block, row groups walked in turn), each group's hand-off
buffer kept across its row groups as shared memory is, and each round's
adds and carries as ``add_round`` makes them. Every density, masked-in or
not, must be bitwise the plain v2 form's (ascending offset, the forward term
before the back term), whatever block, group and walk its row falls to.
The plan is the source's own, ``kde_argmax_v2_group_plan`` of kde_argmax.cu
built in the emulation of ``tests/critic_emu``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hypad_tpu_torch.ops.kde import SENTINEL, kde_stats
from hypad_tpu_torch.profile_kernels import k2_case, k3_constants

from test_torch_k3_emulated import H100_SMEM_OPTIN, group_plan, tree_library

F32 = np.float32


@pytest.fixture(scope="module")
def plan_of(tmp_path_factory):
    """plan_of(rows, width, sms, smem_optin=H100's) -> the source's group
    plan (``test_torch_k3_emulated.group_plan``)."""
    lib = tree_library(tmp_path_factory)
    return lambda *args: group_plan(lib, *args)


def plain_v2_densities(vals, mask):
    """The plain v2 form's densities of every sample (``ops/kde.py``)."""
    _, _, scale = kde_stats(vals, mask)
    vs = torch.where(mask, vals, SENTINEL)
    width = vals.shape[1]
    col = torch.arange(width)
    dens = torch.ones_like(vals)
    for r in range(1, width):
        d = vs - torch.roll(vs, r, dims=1)
        e = torch.where(col >= r, torch.exp(scale[:, None] * (d * d)), 0.0)
        dens = dens + e + torch.roll(e, width - r, dims=1)
    return dens.numpy()


def group_densities(vs, scale, width, hand):
    """The densities of one row group's rows vs (R, 4 nb, padded with the
    sentinel) as the group's threads (r, I) sum them, round by round, the
    forward terms handed through ``hand`` (2, R, 4 nb + 1, 4): float4
    ``hand[D & 1, r, 4 (I - D) + b]`` holds the terms of pairs (4I + a,
    4(I - D) + b), a = 0..3, as thread (r, I) writes them."""
    R, wp = vs.shape
    nb = wp // 4
    d = torch.from_numpy(vs)[:, :, None] - torch.from_numpy(vs)[:, None, :]
    term = torch.exp(torch.from_numpy(scale)[:, None, None] * (d * d)).numpy()
    idx = np.arange(nb)
    a4 = np.arange(4)
    inside = (4 * idx[:, None] + a4[None, :]) < width          # (nb, 4)

    def tm(rows_i, cols_j):  # term[r, rows_i, cols_j] for every r
        return term[:, rows_i, cols_j]

    blk = 4 * idx[:, None] + a4[None, :]                         # (nb, 4)
    e = np.zeros((R, nb, 4, 4), F32)
    for a in range(1, 4):
        for b in range(a):
            e[:, :, a, b] = np.where(inside[:, a], tm(blk[:, a], blk[:, b]),
                                     F32(0))
    one = F32(1)
    p = np.stack([np.full((R, nb), one), (one + e[..., 1, 0]) + e[..., 2, 1],
                  (one + e[..., 2, 1]) + e[..., 3, 2], np.full((R, nb), one)],
                 -1).astype(F32)
    b0 = np.stack([e[..., 1, 0], e[..., 2, 0], e[..., 3, 0]], -1)
    b1, f2 = e[..., 3, 1].copy(), e[..., 2, 0].copy()
    f3 = np.stack([e[..., 3, 2], e[..., 3, 1], e[..., 3, 0]], -1)
    last = np.maximum(idx, nb - 1 - idx) + 1
    for D in range(1, nb + 1):
        left, right = idx >= D, idx + D < nb
        f = np.zeros((R, nb, 4, 4), F32)
        if left.any():
            I = idx[left]
            for a in range(4):
                for b in range(4):
                    f[:, I, a, b] = np.where(inside[I, a],
                                             tm(4 * I + a, 4 * (I - D) + b),
                                             F32(0))
            for b in range(4):
                hand[D & 1][:, 4 * (I - D) + b, :] = f[..., b][:, I, :]
        # the group's barrier; then each thread reads its back terms
        g = np.zeros((R, nb, 4, 4), F32)
        if right.any():
            I = idx[right]
            for a in range(4):
                g[:, I, a, :] = hand[D & 1][:, 4 * I + a, :]
        kF = np.broadcast_to(left[None, :], (R, nb))
        kG = np.broadcast_to(right[None, :], (R, nb))
        act = np.broadcast_to((left | right | (D == last))[None, :], (R, nb))
        T = np.ones((R, nb), bool)
        seqs = (
            [(kF, f[..., 0, 3]), (T, b0[..., 0]), (kF, f[..., 0, 2]),
             (T, b0[..., 1]), (kF, f[..., 0, 1]), (T, b0[..., 2]),
             (kF, f[..., 0, 0]), (kG, g[..., 0, 0])],
            [(kF, f[..., 1, 3]), (T, b1), (kF, f[..., 1, 2]),
             (kG, g[..., 1, 0]), (kF, f[..., 1, 1]), (kG, g[..., 1, 1]),
             (kF, f[..., 1, 0]), (kG, g[..., 1, 2])],
            [(T, f2), (kG, g[..., 2, 0]), (kF, f[..., 2, 3]),
             (kG, g[..., 2, 1]), (kF, f[..., 2, 2]), (kG, g[..., 2, 2]),
             (kF, f[..., 2, 1]), (kG, g[..., 2, 3])],
            [(T, f3[..., 0]), (kG, g[..., 3, 0]), (T, f3[..., 1]),
             (kG, g[..., 3, 1]), (T, f3[..., 2]), (kG, g[..., 3, 2]),
             (kF, f[..., 3, 3]), (kG, g[..., 3, 3])])
        for a, seq in enumerate(seqs):
            for cond, x in seq:
                p[..., a] = np.where(act & cond, p[..., a] + x, p[..., a])
        zero = F32(0)
        b0 = np.where(act[..., None],
                      np.where(kG[..., None], g[..., 0, 1:], zero), b0)
        b1 = np.where(act, np.where(kG, g[..., 1, 3], zero), b1)
        f2 = np.where(act, np.where(kF, f[..., 2, 0], zero), f2)
        f3 = np.where(act[..., None],
                      np.where(kF[..., None], f[..., 3, 2::-1], zero), f3)
    return p.reshape(R, wp)


def schedule_densities(vals, mask, plan):
    """Every row's densities as the group kernels' ``plan`` distributes the
    rows over blocks, groups and walks, each group's hand-off buffer left
    as its last row group left it; also the number of times each row was
    summed."""
    T, width = vals.shape
    R, G, blocks = plan["R"], plan["G"], plan["blocks"]
    nb = (width + 3) // 4
    _, _, scale = kde_stats(vals, mask)
    vs = np.full((T, 4 * nb), F32(SENTINEL), F32)
    vs[:, :width] = torch.where(mask, vals, SENTINEL).numpy()
    scale = scale.numpy()
    out = np.zeros((T, width), F32)
    seen = np.zeros(T, int)
    n_groups = -(-T // R)
    for blk in range(blocks):
        for grp in range(G):
            hand = np.full((2, R, 4 * nb + 1, 4), np.nan, F32)
            for q in range(grp * blocks + blk, n_groups, blocks * G):
                rows = np.arange(q * R, q * R + R)
                real = rows < T
                gv = np.full((R, 4 * nb), F32(SENTINEL), F32)
                gs = np.full(R, F32(-0.5), F32)
                gv[real], gs[real] = vs[rows[real]], scale[rows[real]]
                dens = group_densities(gv, gs, width, hand)
                out[rows[real]] = dens[real, :width]
                seen[rows[real]] += 1
    return out, seen


def few_rows(width, n, runs=0, nans=False, take=(6, 20, 4)):
    vals, mask = k2_case(n, width, runs, device="cpu", nans=nans)
    head, mid, tail = take
    m0 = vals.shape[0] // 2
    idx = torch.cat([torch.arange(head), torch.arange(m0, m0 + mid),
                     torch.arange(vals.shape[0] - tail, vals.shape[0])])
    return vals[idx].contiguous(), mask[idx].contiguous()


@pytest.mark.parametrize("width,runs,nans,sms", [
    (129, 0, False, 2), (150, 0, False, 2), (150, 160, False, 1),
    (256, 0, False, 2), (257, 0, True, 2), (300, 0, False, 3),
    (300, 310, False, 1), (512, 0, False, 2)])
def test_group_schedule_keeps_v2_order(plan_of, width, runs, nans, sms):
    """Every row is summed once, by one group of one block in one walk,
    and each density equals the plain v2 form's bit for bit: masked edges
    (the first rows), constant runs, NaNs, groups walking several row
    groups through the same hand-off buffer."""
    torch.set_num_threads(1)
    vals, mask = few_rows(width, 2 * width, runs, nans)
    plan = plan_of(vals.shape[0], width, sms)
    got, seen = schedule_densities(vals, mask, plan)
    assert (seen == 1).all()
    assert plan["walks"] >= 2 or plan["G"] * plan["blocks"] >= 2
    np.testing.assert_array_equal(got, plain_v2_densities(vals, mask))


@pytest.mark.parametrize("width", [129, 150, 256, 257, 300, 512, 1024, 4096])
def test_group_plan_fits_a_block(plan_of, width):
    """The source's plan fits its groups in the block's 1,024 threads and
    the shared memory a block may opt in to (the H100's 227 KB, and a card
    of less, where the widest rows have none), each group whole warps of R
    rows x nb blocks with room for its two hand-off buffers and its rows,
    and the row groups cover the rows once; widths outside 129 to
    kK3TriMaxW have no plan."""
    c = k3_constants()
    assert c["kMaxW"] == 128 and c["kK3TriMaxW"] >= 1024
    nb = (width + 3) // 4
    for rows, sms, optin in ((50_149, 132, H100_SMEM_OPTIN),
                             (2_299, 132, H100_SMEM_OPTIN),
                             (7, 132, H100_SMEM_OPTIN),
                             (1_000, 1, H100_SMEM_OPTIN),
                             (50_149, 132, 101_376)):
        plan = plan_of(rows, width, sms, optin)
        if plan is None:   # one group of 4,096 columns takes 160 KB
            assert optin < H100_SMEM_OPTIN and width == 4096
            continue
        assert plan["R"] & (plan["R"] - 1) == 0
        assert plan["R"] <= (8 if width <= 256 else 4)
        assert plan["R"] * nb <= plan["gthreads"] < plan["R"] * nb + 32
        assert plan["gthreads"] % 32 == 0
        assert 1 <= plan["G"] <= c["kK3MaxGroups"]
        assert plan["G"] * plan["gthreads"] <= c["kK3Threads"]
        gsmem, left = divmod(plan["smem"], plan["G"])
        assert left == 0 and gsmem % 16 == 0
        assert gsmem >= 16 * 2 * plan["R"] * (4 * nb + 1) + 5 * plan["R"] * nb
        assert plan["smem"] <= optin
        assert 1 <= plan["blocks"] <= sms
        slots = plan["blocks"] * plan["G"] * plan["walks"]
        assert slots * plan["R"] >= rows > (slots - plan["blocks"]
                                            * plan["G"]) * plan["R"]
    if width == 129:
        assert plan_of(100, 128, 132, H100_SMEM_OPTIN) is None
        assert plan_of(100, c["kK3TriMaxW"] + 1, 132,
                       H100_SMEM_OPTIN) is None
