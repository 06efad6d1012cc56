"""Convolution and dense layers that keep float32 parameters and compute
in the model's compute dtype, as flax's `param_dtype=float32, dtype=...`
layers do.

Each layer casts its input, weight and bias to `compute_dtype` at use
(a no-op in float32). The parameters, their gradients and the optimizer
state stay float32, so an SGD update smaller than a bfloat16 rounding
step of the weight is not lost; for inference the weights are rounded to
bfloat16 once per call, which gives the same values as weights stored in
bfloat16. The detector sets `compute_dtype` on every layer it builds.

Tensor parallelism (`parallel/mesh.py::shard_params`): `ColumnParallel`
wraps one of these layers whose output features are split over the
ranks of a process group, Megatron's column-parallel layer with its
output gathered. Its two collectives are autograd Functions:
`copy_in` (identity forward, a sum over the group backward) and
`gather` (an all-gather forward, this rank's slice backward), which the
detector also uses to gather the views' pyramid (`models/detector.py`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _Cast:
    compute_dtype = torch.float32

    def _cast(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return x.to(dt), self.weight.to(dt), bias


    def forward(self, x):
        return self.op(*self._cast(x))


class Conv2d(_Cast, nn.Conv2d):
    out_dim = 0              # of the weight; the output's is 1

    def op(self, x, w, b, groups=None):
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation,
                        groups or self.groups)


class Conv3d(_Cast, nn.Conv3d):
    out_dim = 0

    def op(self, x, w, b, groups=None):
        return F.conv3d(x, w, b, self.stride, self.padding, self.dilation,
                        groups or self.groups)


class ConvTranspose2d(_Cast, nn.ConvTranspose2d):
    out_dim = 1              # the weight is [in, out, kh, kw]

    def op(self, x, w, b, groups=None):
        return F.conv_transpose2d(x, w, b, self.stride, self.padding,
                                  self.output_padding, groups or self.groups,
                                  self.dilation)


class ConvTranspose3d(_Cast, nn.ConvTranspose3d):
    out_dim = 1

    def op(self, x, w, b, groups=None):
        return F.conv_transpose3d(x, w, b, self.stride, self.padding,
                                  self.output_padding, groups or self.groups,
                                  self.dilation)


class Linear(_Cast, nn.Linear):
    out_dim = 0

    def op(self, x, w, b, groups=None):
        return F.linear(x, w, b)


class DenseGeneral(_Cast, nn.Module):
    """flax's DenseGeneral as MultiHeadDotProductAttention uses it: the
    input's last len(in_shape) axes contract with the kernel's to give
    out_shape. `weight` is the flax kernel [*in_shape, *out_shape] with
    its input axes moved last, [*out_shape, *in_shape] (Linear's order);
    `bias` is out_shape."""

    def __init__(self, in_shape, out_shape):
        super().__init__()
        self.n_in = len(in_shape)
        self.fan_in = math.prod(in_shape)
        # the last output axis, flax's last kernel axis
        self.out_dim = len(out_shape) - 1
        self.weight = nn.Parameter(torch.empty(*out_shape, *in_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def op(self, x, w, b, groups=None):
        k = self.n_in
        y = torch.tensordot(x, w, dims=(list(range(x.ndim - k, x.ndim)),
                                        list(range(w.ndim - k, w.ndim))))
        return y if b is None else y + b


CAST_LAYERS = (Conv2d, Conv3d, ConvTranspose2d, ConvTranspose3d, Linear,
               DenseGeneral)


class Shard(NamedTuple):
    """How a tensor-parallel parameter is split: its torch dimension
    `dim`, cut in `size` equal slices over the process group `group`,
    this rank holding slice `rank`. `ColumnParallel` sets it on its
    parameters as their `shard` attribute."""
    dim: int
    group: object
    rank: int
    size: int


def shard_of(param):
    """The parameter's `Shard`, or None for a whole (replicated) one."""
    return getattr(param, "shard", None)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_in(x, group):
    """`x` as it is; its gradient summed over `group`: each rank's layer
    reads all of `x` for its own slice of the outputs, so the gradient
    of `x` is the sum of the ranks' parts."""
    return _CopyIn.apply(x, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * n, n), None, None


def gather(x, dim, group):
    """The ranks' `x` of `group` concatenated along `dim` in rank order,
    on every rank. Its backward returns this rank's slice of the incoming
    gradient and reduces nothing: what follows the gather is the same on
    every rank of `group`, so each rank's gradient of the whole is
    already the whole gradient (a reduce-scatter, the backward of
    torch.distributed.nn's all_gather, would count it once a rank)."""
    return _Gather.apply(x, dim, group)


class ColumnParallel(_Cast, nn.Module):
    """`layer` (one of CAST_LAYERS) with its output features split over
    the ranks of `group`: this rank keeps slice `rank` of `size` of the
    weight along its output dimension (`layer.out_dim`) and computes
    those output channels, and the gather puts the whole output together
    on every rank, in the layer's own output layout (channels at 1 for a
    convolution, last for Linear and DenseGeneral). The input comes in
    through `copy_in`. A 1-D bias is kept whole and added after the
    gather, so its gradient is whole and the same on every rank; a
    DenseGeneral bias of more than one axis is split with the weight
    (`shard_bias`) and added before it. A grouped convolution reads the
    input channels of its own groups only.

    The parameters are the layer's own objects with their data sliced,
    under the same names, so an optimizer built over them and the
    state_dict's keys stay valid; each carries its `Shard`."""

    def __init__(self, layer, group, rank, size, shard_bias=False):
        super().__init__()
        if not isinstance(layer, CAST_LAYERS):
            raise TypeError(f"{type(layer).__name__} is not a cast layer")
        self.compute_dtype = layer.compute_dtype
        self.group, self.rank, self.size = group, rank, size
        dim = layer.out_dim
        w = layer.weight
        out, groups = w.shape[dim], getattr(layer, "groups", 1)
        if out % size or (groups > 1 and groups % size):
            raise ValueError(f"{out} output features in {groups} groups "
                             f"do not split over {size} ranks")
        self.out_axis = -1 if isinstance(layer, (Linear, DenseGeneral)) else 1
        _split(w, Shard(dim, group, rank, size))
        if shard_bias:
            _split(layer.bias, Shard(layer.bias.ndim - 1, group, rank, size))
        self.weight, self.bias = w, layer.bias
        self.__dict__["layer"] = layer       # not a submodule: same names

    def __getattr__(self, name):
        # the layer's own attributes (in_features, out_channels, stride
        # ...) read through the wrapper; they describe the whole layer
        try:
            return super().__getattr__(name)
        except AttributeError:
            if "layer" not in self.__dict__:
                raise
            return getattr(self.__dict__["layer"], name)

    def forward(self, x):
        layer = self.layer
        x, w, b = self._cast(copy_in(x, self.group))
        groups = getattr(layer, "groups", 1)
        if groups > 1:
            per = x.shape[1] // self.size
            x = x.narrow(1, self.rank * per, per)
        split_bias = shard_of(self.bias) is not None
        y = layer.op(x, w, b if split_bias else None,
                     groups // self.size if groups > 1 else None)
        y = gather(y, self.out_axis % y.ndim, self.group)
        if split_bias:
            return y
        if self.out_axis == 1:
            b = b.view((1, -1) + (1,) * (y.ndim - 2))
        return y + b


def _split(param, shard):
    """Keep this rank's slice of `param`'s data, in place, and mark it."""
    n = param.shape[shard.dim] // shard.size
    param.data = param.data.narrow(shard.dim, shard.rank * n, n).clone()
    param.shard = shard


def set_compute_dtype(module, dtype):
    """Make every cast layer under `module` compute in `dtype`."""
    for mod in module.modules():
        if isinstance(mod, (*CAST_LAYERS, ColumnParallel)):
            mod.compute_dtype = dtype
    return module
