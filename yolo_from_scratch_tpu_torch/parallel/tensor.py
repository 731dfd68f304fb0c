"""Tensor (model) parallelism: channel-sharded convs on the 2-D `data x
model` mesh of `--model-parallel N` (counterpart of
`yolo_from_scratch_tpu/parallel/tensor.py`).

The JAX package places its state on the mesh by a rule on each leaf's
shape (`tp_leaf_sharding`): a leaf whose last axis is at least
`MIN_SHARD_SIZE` and divides by N has that axis split N ways, and GSPMD
derives the rest. In the port's layout the rule reads each leaf's
canonical (flax) shape, so an OIHW conv weight, its bias and its
BatchNorm's scale, bias, mean and var are all split on their output
channels, dim 0 (`sharded_keys`); the Adam moments follow their
parameters. Rank r of a model group holds rows [m * c / N, (m + 1) * c /
N) (m = r % N) of every sharded leaf and the replicated leaves whole
(`shard_model_`, `shard_state_tp`); `gather_state_tp` is the inverse, for
checkpoints, serving and EMA export.

The step computes the single-device step with explicit collectives over
the model group, two around every sharded conv (`models/blocks.py`, the
heads' 1x1 predictions):

- its input passes `model_input`: the identity forward; backward, the
  sum over the model group of the ranks' dx, each of which is partial,
  a contraction over this rank's output channels alone;
- its output (after its BatchNorm and SiLU, or a prediction's bias)
  passes `gather_channels`: the whole tensor, each rank's channels in
  its slot of one buffer summed over the group (x + 0 is exact, so the
  channels arrive bit for bit; bf16 travels as float32); backward, this
  rank's channels of the gradient, which is whole and equal on every
  rank of the group.

So every tensor between layers is whole across a model group: residual
adds, concats, SPPF, upsampling and both heads' losses run unchanged,
each rank of a group computing the loss of its data shard, and a
replicated leaf's gradient is computed by every rank of the group. The
ranks compute the replicated layers each on its own, and two processes'
convolutions may round differently (on the card cuDNN picks an algorithm
per process), so `sync_replicated_` gives every rank of a group model
index 0's replicated gradients and BatchNorm statistics each step: the
copies of a replicated leaf never drift apart. Only `all_reduce` and
`broadcast` are used, which `gloo` runs on CUDA tensors too, so ranks
can share one card. A failed collective raises; nothing falls back to an
unsharded path.

A conv that K2's gate selects (`ops/conv_bwd.py::use_fused_bwd`, read at
the global cin and cout) keeps that choice when it is cut:
`conv3x3_same_tp`'s backward gathers dy and the weight over the model
group and runs `fused_bwd` at the global 64->64 shapes, as GSPMD hands a
`pallas_call` without a partitioning rule its operands whole, so every
rank launches the kernel as often as one process does. It returns the
whole dx (equal on every rank of the group, so its input takes no
`model_input`) and this rank's rows of dW.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from yolo_from_scratch_tpu_torch.ops.conv_bwd import fused_bwd_any_layout
from yolo_from_scratch_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from yolo_from_scratch_tpu_torch.parallel.spatial import _wire

# channel widths below this stay replicated: the gather for a small conv
# costs more than its compute (the 's' stem, the anchor head's preds)
MIN_SHARD_SIZE = 64


def tp_leaf_sharding(n_model: int, shape, min_size: int = MIN_SHARD_SIZE):
    """JAX's rule on one leaf's canonical shape, as the PartitionSpec it
    gives (a tuple): the last axis on `model` when it is at least
    `min_size` and divides by `n_model`, else () (replicated)."""
    shape = tuple(shape)
    if len(shape) >= 1 and shape[-1] >= min_size and shape[-1] % n_model == 0:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


def sharded_keys(state, n_model: int, min_size: int = MIN_SHARD_SIZE):
    """The keys of a full-size state dict (or {key: shape}) whose leaf the
    rule shards N ways, each read at its canonical shape."""
    from yolo_from_scratch_tpu_torch.utils.convert import _jax_location

    if n_model == 1:
        return frozenset()
    return frozenset(
        k for k, t in state.items()
        if tp_leaf_sharding(n_model, _jax_location(k, tuple(getattr(
            t, "shape", t)))[2], min_size))


def _rows(t, mesh: Mesh):
    c = t.shape[0] // mesh.n_model
    return t[mesh.model_index * c:(mesh.model_index + 1) * c]


def shard_state_tp(mesh: Mesh, state: dict, keys) -> dict:
    """This rank's part of a full state in the port's layout (a state
    dict, or Adam moments by parameter name): its rows of the leaves in
    `keys`, copies; the other leaves as they are."""
    return {k: _rows(t, mesh).clone() if k in keys else t
            for k, t in state.items()}


def gather_state_tp(mesh: Mesh, state: dict, keys) -> dict:
    """The inverse of `shard_state_tp`: every rank's rows of the leaves in
    `keys` joined along dim 0 in rank order, through one all-reduce of a
    flat buffer over the model group (collective: every rank of the group
    calls it with the same keys). Other leaves are returned as they
    are."""
    names = [k for k in state if k in keys]
    if not names or mesh.model_group is None:
        return dict(state)
    local = [state[k] for k in names]
    sizes = [t.numel() for t in local]
    buf = local[0].new_zeros((mesh.n_model, sum(sizes)),
                             dtype=torch.float32)
    buf[mesh.model_index] = torch.cat([t.reshape(-1).float() for t in local])
    dist.all_reduce(buf, group=mesh.model_group)
    out = dict(state)
    offset = 0
    for k, t, n in zip(names, local, sizes):
        parts = buf[:, offset:offset + n].reshape(mesh.n_model, *t.shape)
        out[k] = parts.reshape(-1, *t.shape[1:]).to(t.dtype)
        offset += n
    return out


def gather_weight(t, mesh: Mesh):
    """One sharded leaf (a weight) joined along dim 0 over the model
    group."""
    return gather_state_tp(mesh, {"t": t}, {"t"})["t"]


def gather_channels_plain(y, mesh: Mesh):
    """NCHW y's channels joined over the model group in rank order: (B,
    N * C, H, W), channels-last in memory, in y's dtype; outside autograd
    (K2's dy on a model mesh)."""
    n, m = mesh.n_model, mesh.model_index
    b, c, h, w = y.shape
    buf = y.new_zeros((n, b, h, w, c), dtype=_wire(y.dtype))
    buf[m] = y.permute(0, 2, 3, 1)
    dist.all_reduce(buf, group=mesh.model_group)
    out = buf.permute(1, 2, 3, 0, 4).reshape(b, h, w, n * c)
    return out.to(y.dtype).permute(0, 3, 1, 2)


class _ModelInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        buf = dx.to(_wire(dx.dtype), copy=True)
        dist.all_reduce(buf, group=ctx.mesh.model_group)
        return buf.to(dx.dtype), None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh, ctx.c = mesh, y.shape[1]
        return gather_channels_plain(y, mesh)

    @staticmethod
    def backward(ctx, dy):
        m, c = ctx.mesh.model_index, ctx.c
        return dy[:, m * c:(m + 1) * c], None


def model_input(x, mesh: Mesh):
    """The input of a channel-sharded conv: x itself; backward, the ranks'
    partial dx summed over the model group."""
    return _ModelInput.apply(x, mesh)


def gather_channels(y, mesh: Mesh):
    """The output of a channel-sharded conv, this rank's channels of NCHW
    y, as the whole tensor (B, N * C, H, W) on every rank of the model
    group; backward, this rank's channels of the gradient."""
    return _GatherChannels.apply(y, mesh)


class _Conv3x3SameTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh):
        ctx.save_for_backward(x, w)
        ctx.mesh = mesh
        return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        mesh = ctx.mesh
        dx, dw = fused_bwd_any_layout(
            x, gather_channels_plain(dy.to(x.dtype), mesh),
            gather_weight(w, mesh))
        return dx.to(x.dtype), _rows(dw, mesh).to(w.dtype), None


def conv3x3_same_tp(x, w, mesh: Mesh):
    """`conv_bwd.conv3x3_same` of a conv cut for a model mesh: x whole, w
    this rank's rows of the output channels; forward == `F.conv2d` of the
    rank's channels, backward == `fused_bwd` at the global shapes on the
    gathered dy and w, returning the whole dx and this rank's rows of
    dW."""
    return _Conv3x3SameTP.apply(x, w, mesh)


def _sharded_convs(model):
    """(name, module, weight key) of every conv whose forward the rule
    changes: each `ConvBNSiLU` (its conv and BatchNorm share the output
    channels) and each raw conv outside one (the heads' predictions)."""
    from yolo_from_scratch_tpu_torch.models.blocks import ConvBNSiLU

    inner = {id(m.conv) for m in model.modules() if isinstance(m, ConvBNSiLU)}
    for name, module in model.named_modules():
        if isinstance(module, ConvBNSiLU):
            yield name, module, f"{name}.conv.weight"
        elif isinstance(module, nn.Conv2d) and id(module) not in inner:
            yield name, module, f"{name}.weight"


def shard_model_(model, mesh: Mesh | None, min_size: int = MIN_SHARD_SIZE):
    """Cut `model` (full size, on any device) in place to this rank's
    slices: every parameter and BatchNorm statistic of `sharded_keys`
    becomes its rows, and each conv that holds them gathers its output
    over `mesh`'s model group (`ConvBNSiLU.tp`, a prediction conv's `tp`).
    `model.tp_mesh` and `model.tp_keys` record the cut. A packed conv
    (`models/packed.py`) is cut on its canonical leaves like any other and
    rebuilds its packed kernel's gather map over its slice
    (`index_canonical_`). Nothing changes without a model axis. Returns
    `model`."""
    if mesh is None or mesh.n_model == 1:
        return model
    state = model.state_dict()
    keys = sharded_keys(state, mesh.n_model, min_size)
    for name, module, weight in _sharded_convs(model):
        owned = [k for k in state if k.startswith(name + ".")]
        if weight in keys:
            if not keys.issuperset(owned):
                raise ValueError(f"{name}: the rule shards {weight} but not "
                                 f"all of {owned}")
            module.tp = mesh
        elif keys.intersection(owned):
            raise ValueError(f"{name}: the rule shards part of {owned}")
    with torch.no_grad():
        for name, module in model.named_modules():
            prefix = f"{name}." if name else ""
            for leaf, p in list(module.named_parameters(recurse=False)):
                if prefix + leaf in keys:
                    setattr(module, leaf, nn.Parameter(
                        _rows(p, mesh).clone(), requires_grad=p.requires_grad))
            for leaf, b in list(module.named_buffers(recurse=False)):
                if prefix + leaf in keys:
                    setattr(module, leaf, _rows(b, mesh).clone())
    for module in model.modules():
        if getattr(module, "tp", None) is not None and hasattr(
                module, "index_canonical_"):
            module.index_canonical_()
    model.tp_mesh, model.tp_keys = mesh, keys
    return model


def sync_replicated_(model, grads):
    """On a cut model, every rank of a model group takes model index 0's
    gradients of the replicated parameters (`grads`, in `parameters()`
    order) and its replicated BatchNorm statistics, in place, through one
    broadcast of a flat buffer over the group. Nothing for a whole
    model."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    mesh = model_mesh(model)
    if mesh is None or mesh.model_group is None:
        return
    keys = model.tp_keys
    tensors = [g for (name, _), g in zip(model.named_parameters(), grads)
               if name not in keys]
    tensors += [b for name, b in model.named_buffers() if name not in keys]
    flat = _flatten_dense_tensors(tensors)
    # the global rank of model index 0 in this rank's group
    dist.broadcast(flat, mesh.rank - mesh.model_index, group=mesh.model_group)
    for t, synced in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(synced)


def model_mesh(model):
    """The mesh `model` was cut for, or None for a whole model."""
    return getattr(model, "tp_mesh", None)


def full_state_dict(model) -> dict:
    """`model`'s state dict at full size: gathered over the model group
    when the model is cut (collective), else the state dict itself."""
    mesh = model_mesh(model)
    if mesh is None:
        return model.state_dict()
    return gather_state_tp(mesh, model.state_dict(), model.tp_keys)


def local_state(model, state: dict) -> dict:
    """This rank's part of a full-size state for `model` (its slices when
    the model is cut)."""
    mesh = model_mesh(model)
    if mesh is None:
        return state
    return shard_state_tp(mesh, state, model.tp_keys)


def load_full_state_dict_(model, state: dict):
    """Load a full-size state dict into `model`, cut or whole."""
    model.load_state_dict(local_state(model, state))
    return model


def sharded_fraction(model) -> float:
    """The share of parameters (by element count, at full size) whose
    leaves are sharded over `model`, as the JAX package counts it over
    `state.params`; 0.0 for a whole model."""
    keys = getattr(model, "tp_keys", frozenset())
    n = getattr(model_mesh(model), "n_model", 1)
    total = sharded = 0
    for name, p in model.named_parameters():
        if name in keys:
            sharded += p.numel() * n
            total += p.numel() * n
        else:
            total += p.numel()
    return sharded / max(total, 1)
