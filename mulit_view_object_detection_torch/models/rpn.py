"""Region Proposal Network head.

Port of `mulit_view_object_detection_tpu/models/rpn.py` (model.py:
830-897): a 3x3/512 shared conv (flax SAME at the anchor stride) and two
1x1 convs, one module shared by every pyramid level.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d
from .resnet import pad_same


class RPNHead(nn.Module):
    def __init__(self, in_channels, anchors_per_location=3, anchor_stride=1):
        super().__init__()
        k = anchors_per_location
        self.anchor_stride = anchor_stride
        self.rpn_conv_shared = Conv2d(in_channels, 512, 3,
                                      stride=anchor_stride)
        self.rpn_class_raw = Conv2d(512, 2 * k, 1)
        self.rpn_bbox_pred = Conv2d(512, 4 * k, 1)

    def forward(self, fmap):
        """fmap [N, C, H, W] -> (logits [N, HWk, 2], probs [N, HWk, 2],
        deltas [N, HWk, 4]), float32, anchors in (h, w, k) order."""
        n = fmap.shape[0]
        s = self.anchor_stride
        shared = F.relu(self.rpn_conv_shared(
            pad_same(fmap, (3, 3), (s, s))))
        logits = self.rpn_class_raw(shared).permute(0, 2, 3, 1).reshape(
            n, -1, 2).float()
        deltas = self.rpn_bbox_pred(shared).permute(0, 2, 3, 1).reshape(
            n, -1, 4).float()
        return logits, torch.softmax(logits, dim=-1), deltas
