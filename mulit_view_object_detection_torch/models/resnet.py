"""ResNet-50/101 backbone, frozen BatchNorm and flax SAME padding.

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


class BatchNorm(nn.Module):
    """Frozen BatchNorm (running statistics), epsilon 1e-3 as the JAX
    module's nn.BatchNorm (resnet.py:65-68). TRAIN_BN is not ported, so
    it never updates its statistics.

    As in flax, its parameters and statistics stay float32 whatever the
    compute dtype: F.batch_norm normalises a bfloat16 input in float32
    and rounds once on output."""

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


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

    def forward(self, x):
        y = F.relu(self.bn2a(self.conv2a(x)))
        y = F.relu(self.bn2b(self.conv2b(y)))
        y = self.bn2c(self.conv2c(y))
        shortcut = self.bn1(self.conv1(x)) if self.conv_shortcut else x
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """x [N, 3, H, W] molded images -> [C1, C2, C3, C4, C5]."""

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

    def forward(self, x):
        y = self.conv1(F.pad(x, (3, 3, 3, 3)))
        y = F.relu(self.bn_conv1(y))
        c1 = y = F.max_pool2d(pad_same(y, (3, 3), (2, 2), float("-inf")),
                              3, 2)
        outs = [c1]
        for names in self.stage_names:
            for name in names:
                y = getattr(self, name)(y)
            outs.append(y)
        return outs
