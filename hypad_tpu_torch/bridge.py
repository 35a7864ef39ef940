"""Weights between the JAX parameter pytree and the port's modules.

The JAX package's ``init_tadgan`` pytree is nested dicts (and, for LSTM
layers, lists) of arrays whose leaves are already in torch layout: dense
``w`` is (out, in), LSTM ``w_ih`` is (4H, in). The port's modules name their
parameters after the pytree, so a leaf at path ``encoder/lstm/0/w_ih`` is the
``state_dict`` entry ``encoder.lstm.0.w_ih``, and the conversion is a
renaming. ``save_params_npz`` / ``load_params_npz`` store the same leaves in
one ``.npz`` keyed by the pytree path, a weight file the detector reads
without orbax.

A fleet's stacked parameters (JAX's ``stack_states(...).params``, every leaf
with a leading signal axis S) carry across the same way, to and from the
port's stacked dict ``{state_dict name: (S, ...) tensor}``
(``train/fleet.py``): :func:`from_jax_stacked_params` and
:func:`to_jax_stacked_params`.
"""

from __future__ import annotations

import numpy as np
import torch

from hypad_tpu_torch.models.tadgan import build_tadgan


def flatten_tree(tree, prefix=""):
    """{"a/b/0/c": leaf} of a nested dict/list pytree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    flat = {}
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = value
    return flat


def unflatten_tree(flat):
    """Inverse of :func:`flatten_tree`: numeric path parts become list
    indices."""
    root = {}
    for path, value in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def from_jax_params(tree, device="cuda"):
    """The port's ``nn.ModuleDict`` of encoder, decoder, critic_x and
    critic_z carrying the weights of a JAX ``init_tadgan`` pytree (leaves
    as numpy arrays, or anything ``np.asarray`` takes)."""
    return model_from_state_dict(
        {path.replace("/", "."): torch.from_numpy(np.array(leaf,
                                                           dtype=np.float32))
         for path, leaf in flatten_tree(tree).items()}, device=device)


def model_from_state_dict(state, device="cuda"):
    """The port's modules built to the shapes of ``state`` (a
    ``state_dict`` of an ``init_tadgan`` model) and carrying its weights."""
    signal_shape = int(state["encoder.lstm.0.w_ih"].shape[1])
    latent_dim = int(state["encoder.dense.w"].shape[0])
    hyperbolic = "decoder.hyperbolic_linear.w" in state
    model = build_tadgan(signal_shape, latent_dim, hyperbolic, device)
    model.load_state_dict(state, strict=True)
    return model


def to_jax_params(model):
    """The nested dict/list pytree (numpy float32 leaves) of ``model``."""
    return unflatten_tree({
        key.replace(".", "/"): value.detach().cpu().numpy()
        for key, value in model.state_dict().items()})


def save_params_npz(model, path):
    """Write ``model``'s weights to ``path`` (.npz), keyed by pytree path."""
    np.savez(path, **flatten_tree(to_jax_params(model)))


def load_params_npz(path, device="cuda"):
    """Modules from a weight file written by :func:`save_params_npz`."""
    with np.load(path) as data:
        flat = {key: data[key] for key in data.files}
    return from_jax_params(unflatten_tree(flat), device=device)


def from_jax_stacked_params(tree, device="cuda"):
    """{state_dict name: (S, ...) float32 tensor on ``device``} of a JAX
    stacked parameter pytree (leaves with a leading signal axis)."""
    from hypad_tpu_torch._device import resolve_device

    device = resolve_device(device)
    return {path.replace("/", "."): torch.from_numpy(
                np.array(leaf, dtype=np.float32)).to(device)
            for path, leaf in flatten_tree(tree).items()}


def to_jax_stacked_params(params):
    """The nested dict/list pytree (numpy float32 leaves, leading S) of
    the port's stacked parameters."""
    return unflatten_tree({key.replace(".", "/"): v.detach().cpu().numpy()
                           for key, v in params.items()})
