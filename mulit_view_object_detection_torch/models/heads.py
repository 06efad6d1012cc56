"""FPN box/class and mask heads.

Port of `mulit_view_object_detection_tpu/models/heads.py`:
  ClassifierHead (model.py:904-957): two conv-as-FC layers (+BN, relu),
    class logits and per-class box deltas.
  MaskHead (model.py:960-1009): 4x (3x3 conv + BN + relu), a 2x2/2
    deconv, a 1x1 sigmoid per class; 128 filters in the multi-view fork.
Heads take pooled features [B, N, S, S, C] (channels-last, the ROI
align layout) and fold the ROIs into the batch axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, ConvTranspose2d, Linear
from .resnet import BatchNorm


def _fold(pooled):
    b, n, s, _, c = pooled.shape
    return pooled.reshape(b * n, s, s, c).permute(0, 3, 1, 2)


class ClassifierHead(nn.Module):
    def __init__(self, in_channels, num_classes, pool_size=7,
                 fc_layers_size=1024):
        super().__init__()
        self.num_classes = num_classes
        self.mrcnn_class_conv1 = Conv2d(in_channels, fc_layers_size,
                                        pool_size)
        self.mrcnn_class_bn1 = BatchNorm(fc_layers_size)
        self.mrcnn_class_conv2 = Conv2d(fc_layers_size, fc_layers_size, 1)
        self.mrcnn_class_bn2 = BatchNorm(fc_layers_size)
        self.mrcnn_class_logits = Linear(fc_layers_size, num_classes)
        self.mrcnn_bbox_fc = Linear(fc_layers_size, num_classes * 4)

    def forward(self, pooled):
        """-> (logits [B, N, NC], probs [B, N, NC], bbox [B, N, NC, 4])."""
        b, n = pooled.shape[:2]
        x = F.relu(self.mrcnn_class_bn1(self.mrcnn_class_conv1(_fold(pooled))))
        x = F.relu(self.mrcnn_class_bn2(self.mrcnn_class_conv2(x)))
        shared = x.reshape(b * n, -1)
        logits = self.mrcnn_class_logits(shared).reshape(
            b, n, self.num_classes).float()
        bbox = self.mrcnn_bbox_fc(shared).reshape(
            b, n, self.num_classes, 4).float()
        return logits, torch.softmax(logits, dim=-1), bbox


class MaskHead(nn.Module):
    def __init__(self, in_channels, num_classes, conv_filters=256):
        super().__init__()
        cin = in_channels
        for i in range(1, 5):
            self.add_module(f"mrcnn_mask_conv{i}",
                            Conv2d(cin, conv_filters, 3, padding=1))
            self.add_module(f"mrcnn_mask_bn{i}", BatchNorm(conv_filters))
            cin = conv_filters
        # flax ConvTranspose 2x2/2 SAME pads the dilated input (1, 1), as
        # torch's padding=0 does; the converter flips the kernel
        self.mrcnn_mask_deconv = ConvTranspose2d(conv_filters,
                                                 conv_filters, 2, stride=2)
        self.mrcnn_mask = Conv2d(conv_filters, num_classes, 1)

    def forward(self, pooled):
        """-> masks [B, N, 2S, 2S, NC] (sigmoid, float32)."""
        b, n, s = pooled.shape[:3]
        x = _fold(pooled)
        for i in range(1, 5):
            conv = getattr(self, f"mrcnn_mask_conv{i}")
            bn = getattr(self, f"mrcnn_mask_bn{i}")
            x = F.relu(bn(conv(x)))
        x = F.relu(self.mrcnn_mask_deconv(x))
        x = torch.sigmoid(self.mrcnn_mask(x).float())
        return x.permute(0, 2, 3, 1).reshape(b, n, 2 * s, 2 * s, -1)
