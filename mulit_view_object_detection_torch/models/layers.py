"""Convolution and dense layers that keep float32 parameters and compute
in the model's compute dtype, as flax's `param_dtype=float32, dtype=...`
layers do.

Each layer casts its input, weight and bias to `compute_dtype` at use
(a no-op in float32). The parameters, their gradients and the optimizer
state stay float32, so an SGD update smaller than a bfloat16 rounding
step of the weight is not lost; for inference the weights are rounded to
bfloat16 once per call, which gives the same values as weights stored in
bfloat16. The detector sets `compute_dtype` on every layer it builds.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class _Cast:
    compute_dtype = torch.float32

    def _cast(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return x.to(dt), self.weight.to(dt), bias


class Conv2d(_Cast, nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(*self._cast(x))


class Conv3d(_Cast, nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(*self._cast(x))


class ConvTranspose2d(_Cast, nn.ConvTranspose2d):
    def forward(self, x):
        x, w, b = self._cast(x)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class ConvTranspose3d(_Cast, nn.ConvTranspose3d):
    def forward(self, x):
        x, w, b = self._cast(x)
        return F.conv_transpose3d(x, w, b, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class Linear(_Cast, nn.Linear):
    def forward(self, x):
        return F.linear(*self._cast(x))


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
        self.weight = nn.Parameter(torch.empty(*out_shape, *in_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def forward(self, x):
        x, w, b = self._cast(x)
        k = self.n_in
        return torch.tensordot(
            x, w, dims=(list(range(x.ndim - k, x.ndim)),
                        list(range(w.ndim - k, w.ndim)))) + b


CAST_LAYERS = (Conv2d, Conv3d, ConvTranspose2d, ConvTranspose3d, Linear,
               DenseGeneral)


def set_compute_dtype(module, dtype):
    """Make every cast layer under `module` compute in `dtype`."""
    for mod in module.modules():
        if isinstance(mod, CAST_LAYERS):
            mod.compute_dtype = dtype
    return module
