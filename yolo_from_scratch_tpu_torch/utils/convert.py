"""Weights between the JAX package's variables and the port's state dict.

The JAX variables are `{'params': ..., 'batch_stats': ...}` nested dicts
of numpy arrays (as `yolo_from_scratch_tpu.utils.checkpoint` stores them).
Module paths are the same on both sides (`a/b/conv` is `a.b.conv`); the
leaves map as

    params      .../conv/kernel (HWIO)  -> ....conv.weight (OIHW)
    params      .../conv/bias           -> ....conv.bias
    params      .../bn/scale, bias      -> ....bn.scale, ....bn.bias
    batch_stats .../bn/mean, var        -> ....bn.mean, ....bn.var
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "scale"}
_STAT_LEAVES = {"mean": "mean", "var": "var"}


def _flatten(tree, prefix=()):
    for key in sorted(tree):
        val = tree[key]
        path = prefix + (key,)
        if isinstance(val, dict):
            yield from _flatten(val, path)
        else:
            yield path, val


def from_flax_variables(variables, model: nn.Module,
                        collections=("params", "batch_stats")) -> dict:
    """Map a JAX variables tree onto `model`'s state-dict keys.

    Every JAX leaf is consumed exactly once, and every key of
    `model.state_dict()` must be produced with its shape: an unmatched key
    on either side, or a shape mismatch, raises ValueError. Returns a dict
    of float32 CPU tensors. `collections=("params",)` maps a params-shaped
    tree alone (Adam's moments in the optax layout) onto the parameters.
    """
    kinds = {"params": _PARAM_LEAVES, "batch_stats": _STAT_LEAVES}
    expected = {k: v for k, v in model.state_dict().items()
                if k.rsplit(".", 1)[-1] in set().union(
                    *(kinds[c].values() for c in collections))}
    out = {}
    for collection, leaves in ((c, kinds[c]) for c in collections):
        for path, arr in _flatten(variables.get(collection, {})):
            if path[-1] not in leaves:
                raise ValueError(f"unknown JAX leaf {collection}/"
                                 f"{'/'.join(path)}")
            key = ".".join(path[:-1] + (leaves[path[-1]],))
            arr = np.asarray(arr, np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if key in out:
                raise ValueError(f"JAX leaf maps twice onto {key}")
            if key not in expected:
                raise ValueError(f"JAX leaf {collection}/{'/'.join(path)} "
                                 f"has no counterpart {key} in the model")
            if tuple(expected[key].shape) != arr.shape:
                raise ValueError(f"{key}: model shape "
                                 f"{tuple(expected[key].shape)} != JAX "
                                 f"{arr.shape}")
            # a copy: arrays decoded from a checkpoint are read-only
            out[key] = torch.tensor(arr)
    missing = sorted(set(expected) - set(out))
    extra = sorted(set(variables) - set(collections))
    if missing or extra:
        raise ValueError(f"unmatched keys: model keys without a JAX leaf "
                         f"{missing}, unknown JAX collections {extra}")
    return out


def _jax_location(key, shape):
    """(collection, JAX path, JAX shape) of a state-dict key."""
    *mods, leaf = key.split(".")
    inverse = {v: ("params", k) for k, v in _PARAM_LEAVES.items()}
    inverse.update({v: ("batch_stats", k) for k, v in _STAT_LEAVES.items()})
    if leaf not in inverse:
        raise ValueError(f"no JAX leaf for state-dict key {key}")
    collection, name = inverse[leaf]
    if leaf == "weight":
        shape = (shape[2], shape[3], shape[1], shape[0])  # OIHW -> HWIO
    return collection, tuple(mods) + (name,), tuple(shape)


def to_flax_variables(state_dict) -> dict:
    """The inverse of `from_flax_variables`: a state dict (any device,
    float32 or bfloat16) -> `{'params': ..., 'batch_stats': ...}` nested
    dicts of float32 C-contiguous numpy arrays, conv kernels HWIO. The
    arrays are copies: they never alias a CPU tensor of the state dict."""
    tree = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        collection, path, _ = _jax_location(key, tuple(t.shape))
        arr = t.detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        _insert(tree[collection], path, np.array(arr, order="C", copy=True))
    return tree


def _insert(tree, path, value):
    for m in path[:-1]:
        tree = tree.setdefault(m, {})
    tree[path[-1]] = value


def random_variables(model: nn.Module, seed: int) -> dict:
    """Seeded random weights in the JAX layout for `model`'s shapes (the
    model may live on the meta device).

    Conv kernels and biases are U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (the
    PyTorch and JAX-package default), BN statistics and affine terms are
    non-trivial (so the parity checks exercise them), and the anchor head's
    objectness bias gets the p=0.01 prior, as a freshly initialised model
    has (obj ~ sigmoid(-4.6) ~ 0.01). The anchor-free head's `box_pred` and
    `cls_pred` biases stay uniform like any conv bias: its class bias gets
    no prior, so the class scores sit near sigmoid(0) = 0.5 (a fresh model
    would start at `v8_cls_prior`).
    """
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    tree = {"params": {}, "batch_stats": {}}
    for key, shape in shapes.items():
        collection, path, fshape = _jax_location(key, shape)
        module, leaf = path[:-1], path[-1]
        if leaf == "kernel" or (leaf == "bias" and module[-1] != "bn"):
            w = shapes[".".join(module + ("weight",))]  # OIHW
            bound = 1.0 / np.sqrt(w[1] * w[2] * w[3])
            new = rng.uniform(-bound, bound, fshape)
            if leaf == "bias" and module[-1] == "pred":
                new = new.reshape(-1, w[0] // 3)  # (anchors, 5 + nc)
                new[:, 4] += -np.log((1.0 - 0.01) / 0.01)
                new = new.reshape(fshape)
        elif leaf in ("scale", "var"):
            new = rng.uniform(0.5, 1.5, fshape)
        else:  # BN bias, mean
            new = rng.normal(0.0, 0.1, fshape)
        _insert(tree[collection], path, new.astype(np.float32))
    return tree
