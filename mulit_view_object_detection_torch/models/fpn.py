"""Feature Pyramid Network neck.

Port of `mulit_view_object_detection_tpu/models/fpn.py` (model.py:
1906-1929, model_multi.py:609-641): 1x1 laterals, nearest x2 top-down
upsampling, 3x3 output convs, the multi-view post-P-conv ReLU, and P6 as
the 1x1/2 VALID max-pool of P5 (a stride-2 subsample). NCHW.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


def upsample2x(x):
    """Nearest-neighbour x2 (KL.UpSampling2D)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPN(nn.Module):
    def __init__(self, out_channels=256, post_relu=False):
        super().__init__()
        k = out_channels
        self.post_relu = post_relu
        self.fpn_c5p5 = Conv2d(2048, k, 1)
        self.fpn_c4p4 = Conv2d(1024, k, 1)
        self.fpn_c3p3 = Conv2d(512, k, 1)
        self.fpn_c2p2 = Conv2d(256, k, 1)
        for i in (2, 3, 4, 5):
            self.add_module(f"fpn_p{i}", Conv2d(k, k, 3, padding=1))

    def forward(self, c2, c3, c4, c5):
        p5 = self.fpn_c5p5(c5)
        p4 = upsample2x(p5) + self.fpn_c4p4(c4)
        p3 = upsample2x(p4) + self.fpn_c3p3(c3)
        p2 = upsample2x(p3) + self.fpn_c2p2(c2)
        ps = [self.fpn_p2(p2), self.fpn_p3(p3), self.fpn_p4(p4),
              self.fpn_p5(p5)]
        if self.post_relu:
            ps = [F.relu(p) for p in ps]
        return ps + [ps[3][:, :, ::2, ::2]]
