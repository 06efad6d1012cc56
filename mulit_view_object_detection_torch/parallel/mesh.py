"""The device mesh: data, view and tensor parallelism over process groups.

Port of `mulit_view_object_detection_tpu/parallel/mesh.py`. There, GSPMD
places arrays on a (data, view[, model]) device mesh and inserts the
collectives; here every process is one device of the mesh, holds its own
part of the batch and of the parameters, and the code reduces over the
process group that each quantity needs:

  * `data`: the batch rows are split (data parallelism, as in
    `parallel/distributed.py`);
  * `view`: with view sharding, the images' view axis is split, so each
    rank runs the backbone and the FPN on its own views; the pyramid
    levels are then gathered over the view group
    (`models/detector.py`), and everything after the gather (the
    unprojection, the fusion, the reprojection, the RPN, the heads and
    the losses) is the same on every view rank;
  * `model`: Megatron's output-channel tensor parallelism by the JAX
    package's shape rule (`param_spec`), each sharded layer a
    `models/layers.py::ColumnParallel` whose output is gathered.

Which group each sum runs over (`train/step.py`): the backbone and FPN
gradients, upstream of the view gather, over data x view; every other
gradient over data alone; none over model (a sharded leaf's gradient is
whole for its slice, a replicated one's the same on every model rank).
TRAIN_BN's statistics follow the same split (`models/resnet.py`); the
losses' denominators and the ROI priorities use the data group. So
every rank ends a step with the one-process step's parameters, its own
slice of a sharded one.

A single process gets a mesh of ones whose groups are all None and runs
the one-process code with no collective. `globalize_batch` keeps each
process's shard as it is: torch has no global array.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.layers import CAST_LAYERS, ColumnParallel, shard_of
from ..utils.convert import (bn_module_names, flax_kernel_axes, flax_path,
                             ln_module_names)
from .distributed import (broadcast_tensors, host_local_batch_slice,
                          init_distributed)

__all__ = ["Mesh", "Sharding", "as_mesh", "batch_sharding",
           "gather_shards", "globalize_batch", "host_local_batch_slice",
           "init_distributed", "make_mesh", "make_parallel_train_step",
           "param_spec", "replicate_state", "replicated", "shard_batch",
           "shard_params", "shard_state_tp"]

AXES = ("data", "view", "model")
# the groups a mesh holds: each axis alone, data x view (the ranks that
# share a model coordinate: the backbone's gradients and statistics),
# view x model (the ranks that compute the same replicated work) and the
# whole mesh
_GROUPS = {"data": ("data",), "view": ("view",), "model": ("model",),
           "data_view": ("data", "view"), "view_model": ("view", "model"),
           "mesh": AXES}


class Mesh:
    """A (data, view[, model]) grid of processes, row-major: the process
    of global rank (d * view + v) * model + m sits at (d, v, m).

    `shape` is a dict, as the JAX mesh's ({"data": ..., "view": ...[,
    "model": ...]}), `axis_names` its keys; `coords` this process's
    {axis: index} (None outside the mesh). `data_group`, `view_group`,
    `model_group`, `data_view_group`, `view_model_group` and
    `mesh_group` (all of the mesh) are the process groups of this
    process along those axes: None where the group has one process
    (nothing to reduce) and outside the mesh."""

    def __init__(self, shape, coords, groups):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.coords = coords
        for name in _GROUPS:
            setattr(self, f"{name}_group", groups.get(name))

    @property
    def member(self):
        return self.coords is not None

    def coord(self, axis):
        """This process's index along `axis` (0 on an axis the mesh does
        not have)."""
        if not self.member:
            raise ValueError("this process is not in the mesh")
        return self.coords.get(axis, 0)

    def size(self, axis):
        return self.shape.get(axis, 1)

    def group(self, axes):
        """The group along `axes` (a subset of AXES, in AXES order)."""
        for name, along in _GROUPS.items():
            if along == tuple(axes):
                return getattr(self, f"{name}_group")
        raise ValueError(f"a mesh holds no group along {axes}")

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords})"


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data=None, view=1, model=1):
    """A (data, view[, model]) mesh over the processes of the initialised
    world (a single process without one). `data` defaults to the
    processes over view x model. The model axis exists only when
    model > 1, as in the JAX package. The mesh takes the first
    data x view x model processes; the others get a mesh they are not in
    (`member` False). Every process of the world must call it, with the
    same arguments: it creates the groups."""
    world, rank = _world()
    if data is None:
        data = world // (view * model)
    if data < 1:
        raise ValueError(f"not enough processes: {world} < view({view}) "
                         f"x model({model})")
    n = data * view * model
    if n > world:
        raise ValueError(f"mesh {data}x{view}x{model} > {world} processes")
    shape = {"data": data, "view": view}
    if model > 1:
        shape["model"] = model
    sizes = (data, view, model)
    coords = {r: dict(zip(AXES, np.unravel_index(r, sizes))) for r in range(n)}
    groups = {}
    for name, axes in _GROUPS.items():
        span = int(np.prod([sizes[AXES.index(a)] for a in axes]))
        if span == 1:
            continue
        rest = [a for a in AXES if a not in axes]
        keys = sorted({tuple(int(c[a]) for a in rest)
                       for c in coords.values()})
        for key in keys:
            ranks = [r for r, c in coords.items()
                     if tuple(int(c[a]) for a in rest) == key]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = group
    mine = coords.get(rank)
    if mine is not None:
        mine = {a: int(mine[a]) for a in shape}
    return Mesh(shape, mine, groups)


def as_mesh(group):
    """`group` as a mesh: a Mesh as it is; None (one process) or a
    data-parallel process group (`parallel/distributed.py`) as a
    data-only mesh over it."""
    if isinstance(group, Mesh):
        return group
    if group is None:
        return Mesh({"data": 1, "view": 1}, {"data": 0, "view": 0}, {})
    return Mesh({"data": dist.get_world_size(group), "view": 1},
                {"data": dist.get_rank(group), "view": 0},
                {"data": group, "mesh": group})


class Sharding(NamedTuple):
    """The placement of one batch key on a mesh: `spec` names the mesh
    axis that splits each leading dimension (None: whole), as the JAX
    PartitionSpec does; () is replicated."""
    mesh: Mesh
    spec: tuple


def batch_sharding(mesh, view_sharding=False):
    """The Sharding of each batch key: the batch axis over "data"; with
    `view_sharding`, the images' view axis (axis 1) over "view".

    Only the images are split by view: the pose, intrinsics and depths
    stay whole on every view rank, since everything after the pyramid
    gather runs on all the views there (the JAX spec also shards Rcam
    and depths by view). This is a placement, not a change of the math:
    every rank computes what the one-process model computes."""
    vs = "view" if view_sharding else None
    spec = {
        "images": ("data", vs),
        "image_meta": ("data",),
        "anchors": (),                  # replicated constant
        "Rcam": ("data",),
        "Kmat": ("data",),
        "depths": ("data",),
        "gt_class_ids": ("data",),
        "gt_boxes": ("data",),
        "gt_masks": ("data",),
        "rpn_match": ("data",),
        "rpn_bbox": ("data",),
    }
    return {k: Sharding(mesh, v) for k, v in spec.items()}


def replicated(mesh):
    return Sharding(mesh, ())


def _local_slice(n, sharding, axis, key, dim):
    parts = sharding.mesh.size(axis)
    if n % parts:
        raise ValueError(f"{key}: {n} along axis {dim} does not split "
                         f"over the mesh's {parts} {axis} ranks")
    per = n // parts
    start = sharding.mesh.coord(axis) * per
    return slice(start, start + per)


def shard_batch(batch, shardings):
    """This process's part of a global host batch: each key with a
    sharding cut along the axes its spec names (numpy arrays or
    tensors); other keys pass through. A dimension that its axis does
    not divide raises ValueError."""
    out = {}
    for k, v in batch.items():
        s = shardings.get(k)
        if s is None or not any(s.spec):
            out[k] = v
            continue
        index = tuple(slice(None) if axis is None else
                      _local_slice(v.shape[dim], s, axis, k, dim)
                      for dim, axis in enumerate(s.spec))
        out[k] = v[index]
    return out


def globalize_batch(batch, shardings):
    """The batch a process loaded for its own part of the mesh (every
    host its rows of the data axis, `host_local_batch_slice`), as the
    step takes it. In the JAX package this stitches global arrays; torch
    has no global array, so each process keeps its local shard as it
    is: keys with a sharding become tensors, the others pass through."""
    return {k: torch.as_tensor(np.asarray(v)) if k in shardings
            and not torch.is_tensor(v) else v for k, v in batch.items()}


def _tensors(model, optimizer):
    """(tensor, Shard or None) for the parameters, buffers and momentum
    buffers of `model` and `optimizer`."""
    for p in model.parameters():
        yield p.data, shard_of(p)
    for b in model.buffers():
        yield b, None
    if optimizer is not None:
        for p, state in optimizer.state.items():
            buf = state.get("momentum_buffer")
            if buf is not None:
                yield buf, shard_of(p)


def replicate_state(model, mesh, optimizer=None):
    """Make every process's model (and momentum, given the optimizer)
    that of the mesh's first process: whole tensors broadcast over the
    mesh, a tensor-parallel slice over the data x view group, from the
    rank that holds the same slice. Nothing to do for a single
    process."""
    whole, split = [], []
    for t, shard in _tensors(model, optimizer):
        (whole if shard is None else split).append(t)
    for tensors, group in ((whole, mesh.mesh_group),
                           (split, mesh.data_view_group)):
        if group is not None and tensors:
            broadcast_tensors(tensors, group)
    return model


def param_spec(path, shape, mesh):
    """The tensor-parallel placement of the leaf at flax `path` whose
    torch tensor has `shape`, in torch's layout: () to replicate it, or
    a tuple with "model" at the dimension to split. The JAX package's
    rule, decided on the flax layout (`utils/convert.py`'s mapping): a
    leaf of at least 2 dimensions whose last flax dimension (a kernel's
    output features) is a multiple of the model axis and at least twice
    it is split along that dimension; vectors (biases, BatchNorm scales
    and statistics) and the rest are replicated. Shape-based, so the
    momentum follows its parameter."""
    if "model" not in mesh.shape:
        return ()
    m = mesh.shape["model"]
    axes = flax_kernel_axes(path, len(shape))
    if len(shape) >= 2:
        out = shape[axes[-1]]
        if out % m == 0 and out >= 2 * m:
            return tuple("model" if d == axes[-1] else None
                         for d in range(len(shape)))
    return ()


def _specs(model, mesh):
    """`param_spec` of each parameter, by name, on the flax path that
    `utils/convert.py`'s converter gives it."""
    params = dict(model.named_parameters())
    bns = bn_module_names(model.state_dict())
    lns = ln_module_names(params, bns)
    return {n: param_spec(flax_path(n, bns, lns), tuple(p.shape), mesh)
            for n, p in params.items()}


def shard_params(model, mesh):
    """Split the leaves that `param_spec` shards, in place: each layer
    whose weight it splits becomes a `ColumnParallel` over the mesh's
    model group, keeping this process's slice (a bias of more than one
    axis split with it). Nothing to do without a model axis. Returns the
    model."""
    if mesh.size("model") == 1:
        return model
    specs = _specs(model, mesh)
    rank, size = mesh.coord("model"), mesh.size("model")
    for name, layer in list(model.named_modules()):
        if not isinstance(layer, CAST_LAYERS) or not specs[name + ".weight"]:
            continue
        if specs[name + ".weight"].index("model") != layer.out_dim:
            raise ValueError(f"{name}: the rule splits "
                             f"{specs[name + '.weight']}, not the output")
        wrapped = ColumnParallel(layer, mesh.model_group, rank, size,
                                 shard_bias=bool(specs[name + ".bias"]))
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent), attr, wrapped)
    return model


def shard_state_tp(model, optimizer, mesh):
    """Place a model and its SGD optimizer on a tensor-parallel (and data
    and view) mesh: the parameters by `shard_params`, the momentum of a
    split parameter sliced the same way (the optimizer keeps its
    parameter objects), everything else whole. Returns the model."""
    whole = {p: p.shape for p in model.parameters()}
    shard_params(model, mesh)
    if optimizer is not None:
        for p, state in optimizer.state.items():
            buf, shard = state.get("momentum_buffer"), shard_of(p)
            if buf is not None and shard is not None \
                    and buf.shape == whole[p]:
                n = buf.shape[shard.dim] // shard.size
                state["momentum_buffer"] = buf.narrow(
                    shard.dim, shard.rank * n, n).clone()
    return model


def _placed(v, device):
    t = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
    if t.dtype in (torch.int32, torch.int64):
        t = t.long()
    return t.to(device)


def make_parallel_train_step(train_step, mesh, view_sharding=False):
    """Wrap `train_step` (train/step.py's) for the mesh: the returned
    step(model, optimizer, batch, config, mask, generator) takes the
    global host batch, keeps this process's part (`batch_sharding`),
    places it on the model's device and steps with the mesh's
    reductions. On its first call for a model the state is replicated
    from the mesh's first process (`replicate_state`), as the JAX
    wrapper replicates a host state; a split leaf stays split. Returns
    train_step's metrics, the global batch's, on every process."""
    shardings = batch_sharding(mesh, view_sharding)
    placed = weakref.WeakSet()

    def step(model, optimizer, batch, config, mask, generator):
        if model not in placed:
            replicate_state(model, mesh, optimizer)
            placed.add(model)
        device = next(model.parameters()).device
        local = {k: _placed(v, device)
                 for k, v in shard_batch(batch, shardings).items()}
        return train_step(model, optimizer, local, config, mask, generator,
                          mesh)

    return step


def gather_shards(named):
    """{name: tensor} with every tensor-parallel slice gathered whole
    over its group (every process of the group must call it), whole
    tensors as they are. `named`: (name, tensor, Shard or None)
    triples."""
    out = {}
    for name, t, shard in named:
        if shard is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(shard.size)]
        dist.all_gather(parts, t.contiguous(), group=shard.group)
        out[name] = torch.cat(parts, shard.dim)
    return out

