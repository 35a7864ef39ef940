"""Device meshes for data parallelism over several cards: a port of
``hypad_tpu.parallel.mesh``.

One process drives every card, as JAX's single controller does; nothing
here uses ``torch.distributed``. A :class:`Mesh` is an array of
``torch.device``\\ s with axis names. A sharded call splits rows (or a
fleet's signals) over the devices of the mesh's ``dp`` axis into
contiguous slabs, the last one shorter where the count does not divide
(GSPMD's uneven shards, without their pad rows), runs each slab's
row-independent work on its device with copies of the parameters there,
and gathers the results to the lead device (the mesh's first), where the
global reductions run. The host enqueues every slab's work before it
waits for any, so distinct cards overlap. On a mesh with more axes
(``shape=(4, 2)``), rows split over ``dp`` and the other axes replicate,
as JAX's PartitionSpecs name only ``dp``.

Duplicate devices: an explicit device list may name a device more than
once, ``[torch.device("cpu")] * 8`` or ``["cuda:0"] * 2`` on a one-card
machine. Each entry is then a shard of its own, run after the others on
that device. This is the port's counterpart of JAX's virtual host devices
(``--xla_force_host_platform_device_count``): it reaches every sharded
line on one device, and its times are not those of several cards.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "shard_leading", "batch_multiple",
           "dp_devices", "lead_device", "row_slices", "gather_rows",
           "map_rows", "on_device"]


class Mesh:
    """``devices``: an array of ``torch.device`` whose axes are named by
    ``axis_names``, as ``jax.sharding.Mesh`` holds them."""

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(arr[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axis names "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def _platform_devices(platform):
    if platform == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(platform)]


def make_mesh(devices="all", axis_name="dp", shape=None, axis_names=None,
              platform="cuda"):
    """Build a device mesh. Default: 1-D data-parallel over ``axis_name``.

    ``devices``: "all" (every device of ``platform``: each CUDA card, or
    the one CPU), an int (the first that many of them, as
    ``jax.devices()[:n]`` truncates), or an explicit device list (which
    may repeat a device; see the module docstring). Returns None for a
    single device (the callers then run unsharded).

    ``shape``/``axis_names``: an n-D layout such as ``shape=(4, 2)``,
    ``axis_names=("dp", "mp")`` (the default names); rows shard over
    ``dp`` and replicate over the other axes."""
    if devices == "all":
        devs = _platform_devices(platform)
    elif isinstance(devices, int):
        devs = _platform_devices(platform)[:devices]
    else:
        devs = [torch.device(d) for d in devices]
    if shape is not None:
        n = int(np.prod(shape))
        if len(devs) < n:
            raise ValueError(f"mesh shape {shape} needs {n} devices, "
                             f"have {len(devs)}")
        names = axis_names or ("dp", "mp")[: len(shape)]
        arr = np.empty(n, dtype=object)
        arr[:] = devs[:n]
        return Mesh(arr.reshape(shape), names)
    if len(devs) <= 1:
        return None
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, (axis_name,))


def batch_multiple(batch_size, mesh):
    """Largest batch size <= batch_size divisible by the mesh's device
    count, at least that count (JAX's ``batch_multiple``)."""
    if mesh is None:
        return batch_size
    n = mesh.size
    return max((batch_size // n) * n, n)


def dp_devices(mesh, axis_name="dp"):
    """The devices along ``axis_name``, the other axes at index 0: one per
    shard of a sharded call."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis_name!r} axis: "
                         f"{mesh.axis_names}")
    ax = mesh.axis_names.index(axis_name)
    idx = [0] * mesh.devices.ndim
    idx[ax] = slice(None)
    return list(mesh.devices[tuple(idx)])


def lead_device(mesh):
    """The mesh's first device, where gathered results and the parameters
    live; None without a mesh."""
    return None if mesh is None else mesh.devices.flat[0]


def row_slices(n, k):
    """The contiguous slabs of ``n`` rows over ``k`` shards, as GSPMD
    shards them: ceil(n / k) rows each, the last shorter, empty ones
    dropped. Returns [(shard index, slice)]."""
    per = -(-n // k) if n else 0
    return [(i, slice(i * per, min((i + 1) * per, n)))
            for i in range(k) if i * per < n]


def _slab(x, sl, axis):
    if torch.is_tensor(x) and x.dim():
        ax = axis % x.dim()
        return x.narrow(ax, sl.start, sl.stop - sl.start)
    return x


def gather_rows(parts, device, axis=0):
    """The slabs ``parts`` concatenated along ``axis`` on ``device``; a
    tuple of outputs gathers element-wise."""
    if isinstance(parts[0], (tuple, list)):
        return type(parts[0])(gather_rows([p[i] for p in parts], device, axis)
                              for i in range(len(parts[0])))
    return torch.cat([p.to(device) for p in parts], dim=axis)


def map_rows(mesh, fn, *args, axis=0, n_rows=None, axis_name="dp"):
    """``fn(device, *slabs)`` on every shard of the mesh's ``axis_name``
    devices, each tensor argument cut to the shard's rows along ``axis``
    and copied to its device (a 0-d tensor or a non-tensor passes as it
    is), the outputs gathered along ``axis`` on the lead device. Every
    shard is enqueued before any output is read. ``n_rows`` defaults to
    the first tensor argument's row count."""
    devs = dp_devices(mesh, axis_name)
    if n_rows is None:
        n_rows = next(a for a in args
                      if torch.is_tensor(a) and a.dim()).shape[axis]
    outs = []
    for i, sl in row_slices(n_rows, len(devs)):
        slabs = [_slab(a, sl, axis).to(devs[i]) if torch.is_tensor(a)
                 else a for a in args]
        outs.append(fn(devs[i], *slabs))
    return gather_rows(outs, lead_device(mesh), axis)


def on_device(model, device, fn, *args):
    """``fn(model, *args)`` with ``model``'s parameters and buffers swapped
    for copies on ``device`` made by a differentiable ``.to``: a gradient
    taken through the output reaches the model's own parameters, summed
    over every such call. ``model`` is any ``nn.Module`` (a TadGAN
    ``ModuleDict``, one of its modules)."""
    state = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return torch.func.functional_call(
        _Apply(model), {f"model.{k}": v.to(device) for k, v in state.items()},
        (fn, *args))


class _Apply(torch.nn.Module):
    """Calls ``fn(model, *args)``: lets ``functional_call`` swap the
    parameters of a model that has no ``forward`` of its own."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


def shard_leading(mesh, axis_name="dp"):
    """Returns f(tree) splitting the LEADING axis of every tensor leaf of
    ``tree`` (a dict, list or tuple of tensors) over the mesh's
    ``axis_name`` devices: a list of (device, slice, tree slab on that
    device). Without a mesh, one shard of the whole tree where it lies
    (device None). Used by the fleet trainer and detector: the signal axis
    is embarrassingly parallel, so each device owns its slab of the fleet
    with zero collectives."""
    def split(tree):
        leaves = _leaves(tree)
        n = leaves[0].shape[0]
        if mesh is None:
            return [(None, slice(0, n), tree)]
        devs = dp_devices(mesh, axis_name)
        return [(devs[i], sl, _tree_map(
            lambda x, sl=sl, d=devs[i]: x[sl].to(d), tree))
            for i, sl in row_slices(n, len(devs))]

    return split


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
