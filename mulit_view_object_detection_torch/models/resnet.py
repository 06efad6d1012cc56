"""ResNet-50/101 backbone, BatchNorm and flax SAME padding.

Port of `mulit_view_object_detection_tpu/models/resnet.py` (the
reference's model.py:95-206), with the same layer names so converted
flax weights load by name. Views are folded into the batch axis by the
caller. Tensors are NCHW.

Padding hazards kept from the JAX module:
  * the stem is an explicit pad of 3, then a VALID 7x7/2 conv;
  * the stem's 3x3/2 max-pool is flax SAME, which pads (0, 1) on an even
    input — padded here with -inf, not torch's symmetric padding=1;
  * a block's stride sits on its 1x1 conv2a (and the 1x1 shortcut).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.distributed import all_reduce_sum
from .layers import Conv2d

BLOCK_COUNTS = {"resnet50": 3, "resnet101": 22}


def same_pads(sizes, kernel, stride):
    """flax/XLA SAME padding of the spatial dims `sizes`, as the flat
    (last dim first) list F.pad takes: out = ceil(n / s), the extra pixel
    of an odd total at the end."""
    pads = []
    for n, k, s in reversed(list(zip(sizes, kernel, stride))):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def pad_same(x, kernel, stride, value=0.0):
    """F.pad x [N, C, *spatial] to flax SAME for `kernel`/`stride`."""
    pads = same_pads(x.shape[2:], kernel, stride)
    return F.pad(x, pads, value=value) if any(pads) else x


MOMENTUM = 0.9     # of the running statistics, flax's nn.BatchNorm's


class BatchStats:
    """TRAIN_BN's mode for the BatchNorms of one forward (flax's
    nn.BatchNorm(use_running_average=False)), and the statistics they
    took.

    A BatchNorm given one normalises its input with the input's own
    statistics over every axis but the channel axis (N·H·W of a 2-D map,
    B·X·Y·Z of a fusion grid, the B·N ROI rows of a head, padded ROIs
    included), summed over the ranks of `group` when one is given, so
    that they are the global batch's; it records (module, mean, biased
    variance) in `records` and writes nothing. `commit()` writes them
    into the running statistics once: a train step commits, a
    validation step and BN_EVAL_BATCH_STATS inference do not."""

    def __init__(self, group=None):
        self.group = group
        self.records = []

    def over(self, group):
        """These statistics reduced over `group` instead, recording into
        the same list. On a mesh with sharded views
        (`parallel/mesh.py`), the backbone's BatchNorms see only the
        rank's views and sum over the data x view group; the fusion's
        and the heads', after the views' gather, over the data group."""
        out = BatchStats(group)
        out.records = self.records
        return out

    @torch.no_grad()
    def commit(self):
        """running = MOMENTUM * running + (1 - MOMENTUM) * batch, with the
        biased variance, as flax updates its batch_stats."""
        for bn, mean, var in self.records:
            bn.running_mean.copy_(MOMENTUM * bn.running_mean
                                  + (1 - MOMENTUM) * mean)
            bn.running_var.copy_(MOMENTUM * bn.running_var
                                 + (1 - MOMENTUM) * var)
        self.records = []


class BatchNorm(nn.Module):
    """BatchNorm, epsilon 1e-3 as the JAX module's nn.BatchNorm
    (resnet.py:63-68): frozen (running statistics), or, given a
    `BatchStats` (TRAIN_BN), normalised with the batch's statistics.

    As in flax, its parameters and statistics stay float32 whatever the
    compute dtype: it normalises a bfloat16 input in float32 and rounds
    once on output. Batch statistics are flax's too: sums of x and x^2 in
    at least float32, the biased variance E[x^2] - E[x]^2 clipped at 0.

    Folded (utils/bn_fold.py::fold_bn_model, for inference) it takes one
    of two forms, with the same parameter and buffer names: "identity",
    where its affine went into the conv before it (it launches nothing),
    or "affine", x * weight + bias in the compute dtype (the JAX
    `_AffineBN`, resnet.py:38-48). A folded BatchNorm has no batch
    statistics mode: the JAX package folds only where not train_bn."""

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.form = "batch_norm"
        self.compute_dtype = torch.float32
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def fold(self, form, dtype):
        if form not in ("identity", "affine"):
            raise ValueError(f"unknown folded BatchNorm form {form!r}")
        self.form = form
        self.compute_dtype = dtype

    def forward(self, x, stats=None):
        if self.form != "batch_norm":
            if stats is not None:
                raise ValueError("a folded BatchNorm cannot normalise with "
                                 "batch statistics")
            if self.form == "identity":
                return x
            dt = self.compute_dtype
            shape = (1, -1) + (1,) * (x.ndim - 2)
            return (x.to(dt) * self.weight.to(dt).view(shape)
                    + self.bias.to(dt).view(shape))
        if stats is None:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0] + list(range(2, x.ndim))
        count = x32.new_full((1,), float(x32.numel() // x32.shape[1]))
        sums = torch.cat([x32.sum(dims), (x32 * x32).sum(dims), count])
        if stats.group is not None:
            sums = all_reduce_sum(sums, stats.group)
        c = x.shape[1]
        mean = sums[:c] / sums[-1]
        var = torch.clamp_min(sums[c:2 * c] / sums[-1] - mean * mean, 0.0)
        stats.records.append((self, mean.detach(), var.detach()))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (x32 - mean.view(shape)) * (
            torch.rsqrt(var + self.eps) * self.weight).view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


def checkpointed(module, x, stats=None):
    """module(x, stats) with its activations recomputed in the backward
    pass (torch.utils.checkpoint, non-reentrant; JAX nn.remat). The
    recomputation normalises as the forward did, and writes nothing: the
    batch statistics come out of the checkpointed call, and only the
    forward's go into `stats`."""
    if stats is None:
        return checkpoint(module, x, use_reentrant=False)

    def run(x):
        inner = BatchStats(stats.group)
        return module(x, inner), inner.records

    y, records = checkpoint(run, x, use_reentrant=False)
    stats.records.extend(records)
    return y


class Bottleneck(nn.Module):
    """conv_block / identity_block (model.py:95-168)."""

    def __init__(self, cin, filters, stride=1, conv_shortcut=False):
        super().__init__()
        f1, f2, f3 = filters
        self.conv2a = Conv2d(cin, f1, 1, stride=stride)
        self.bn2a = BatchNorm(f1)
        self.conv2b = Conv2d(f1, f2, 3, padding=1)
        self.bn2b = BatchNorm(f2)
        self.conv2c = Conv2d(f2, f3, 1)
        self.bn2c = BatchNorm(f3)
        self.conv_shortcut = conv_shortcut
        if conv_shortcut:
            self.conv1 = Conv2d(cin, f3, 1, stride=stride)
            self.bn1 = BatchNorm(f3)

    def forward(self, x, stats=None):
        y = F.relu(self.bn2a(self.conv2a(x), stats))
        y = F.relu(self.bn2b(self.conv2b(y), stats))
        y = self.bn2c(self.conv2c(y), stats)
        shortcut = (self.bn1(self.conv1(x), stats) if self.conv_shortcut
                    else x)
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """x [N, 3, H, W] molded images -> [C1, C2, C3, C4, C5]. `stats`: the
    BatchNorms' batch statistics (TRAIN_BN), or None for frozen ones;
    `remat`: each bottleneck recomputed in the backward pass (REMAT in
    training, resnet.py:151,160)."""

    def __init__(self, architecture="resnet101", stage4_blocks=None):
        super().__init__()
        if architecture not in BLOCK_COUNTS:
            raise ValueError(f"unknown backbone {architecture!r}")
        self.conv1 = Conv2d(3, 64, 7, stride=2)
        self.bn_conv1 = BatchNorm(64)
        n4 = (stage4_blocks if stage4_blocks is not None
              else BLOCK_COUNTS[architecture])
        # per stage: (name, cin, filters, stride, conv_shortcut)
        stages = [
            [("res2a", 64, (64, 64, 256), 1, True)]
            + [(f"res2{s}", 256, (64, 64, 256), 1, False) for s in "bc"],
            [("res3a", 256, (128, 128, 512), 2, True)]
            + [(f"res3{s}", 512, (128, 128, 512), 1, False) for s in "bcd"],
            [("res4a", 512, (256, 256, 1024), 2, True)]
            + [(f"res4{chr(98 + i)}", 1024, (256, 256, 1024), 1, False)
               for i in range(n4)],
            [("res5a", 1024, (512, 512, 2048), 2, True)]
            + [(f"res5{s}", 2048, (512, 512, 2048), 1, False) for s in "bc"],
        ]
        self.stage_names = []
        for stage in stages:
            for name, cin, filters, stride, short in stage:
                self.add_module(name, Bottleneck(cin, filters, stride, short))
            self.stage_names.append([spec[0] for spec in stage])

    def forward(self, x, stats=None, remat=False):
        y = self.conv1(F.pad(x, (3, 3, 3, 3)))
        y = F.relu(self.bn_conv1(y, stats))
        c1 = y = F.max_pool2d(pad_same(y, (3, 3), (2, 2), float("-inf")),
                              3, 2)
        outs = [c1]
        for names in self.stage_names:
            for name in names:
                block = getattr(self, name)
                y = checkpointed(block, y, stats) if remat else block(y, stats)
            outs.append(y)
        return outs
