"""Cross-view voxel-grid fusion (conv3d U-Net) and depth-sample collapse.

Port of `mulit_view_object_detection_tpu/models/fusion.py`:
`GridFusion` in conv3d mode (fusion.py:357-397, model_multi.py:394-463)
and the conv3d `DepthCollapse` (fusion.py:517-533, model_multi.py:
466-488), with the same layer names. One module pair per pyramid level.

Voxel axes X, Y, Z map to torch's D, H, W. Hazards kept exactly:
  * down1/down2 are 3^3 stride-2 flax SAME convs, which pad (0, 1) on an
    even input where torch's padding=1 pads (1, 1): padded explicitly;
  * up1/up2 are flax SAME ConvTranspose 3^3/2 (transpose_kernel=False),
    which pads the dilated input (2, 1). torch's ConvTranspose3d with
    padding=0 pads it (2, 2) with the kernel flipped, so its first 2n
    outputs are flax's (the converter flips the kernel);
  * the skip concat order is [deconv1, conv1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Conv3d, ConvTranspose3d
from .resnet import BatchNorm, pad_same


def deconv_same(layer, x):
    """flax SAME stride-2 ConvTranspose output (2n per axis) from a torch
    ConvTranspose3d with padding=0 (2n + 1 per axis)."""
    y = layer(x)
    return y[..., :2 * x.shape[2], :2 * x.shape[3], :2 * x.shape[4]]


class GridFusion(nn.Module):
    """conv3d U-Net: [B, V*C, X, Y, Z] relu'd view-concatenated grid (the
    unprojection kernel's output) -> fused [B, C, X, Y, Z]."""

    def __init__(self, channels, num_views):
        super().__init__()
        c = channels
        self.down1 = Conv3d(num_views * c, 2 * c, 3, stride=2)
        self.bn1 = BatchNorm(2 * c)
        self.down2 = Conv3d(2 * c, 4 * c, 3, stride=2)
        self.bn2 = BatchNorm(4 * c)
        self.up1 = ConvTranspose3d(4 * c, 2 * c, 3, stride=2)
        self.bn_up1 = BatchNorm(2 * c)
        self.up2 = ConvTranspose3d(4 * c, c, 3, stride=2)
        self.bn_up2 = BatchNorm(c)

    def forward(self, x):
        k, s = (3, 3, 3), (2, 2, 2)
        conv1 = F.relu(self.bn1(self.down1(pad_same(x, k, s))))
        conv2 = F.relu(self.bn2(self.down2(pad_same(conv1, k, s))))
        deconv1 = F.relu(self.bn_up1(deconv_same(self.up1, conv2)))
        x = torch.cat([deconv1, conv1], dim=1)
        return F.relu(self.bn_up2(deconv_same(self.up2, x)))


class DepthCollapse(nn.Module):
    """conv3d-mode collapse: ray slices [B, D, S, S, C] (the reprojection
    kernel's layout) -> [B, C, S, S]. Samples fold into channels as
    channel c*D + d, then a depthwise + pointwise stack."""

    def __init__(self, channels, samples):
        super().__init__()
        feat = channels * samples
        self.dw1 = Conv2d(feat, feat, 1, groups=feat)
        self.pw1 = Conv2d(feat, 512, 1)
        self.bn1 = BatchNorm(512)
        self.dw2 = Conv2d(512, 512, 1, groups=512)
        self.pw2 = Conv2d(512, channels, 1)
        self.bn2 = BatchNorm(channels)

    def forward(self, rays):
        b, d, s1, s2, c = rays.shape
        x = rays.permute(0, 4, 1, 2, 3).reshape(b, c * d, s1, s2)
        x = F.relu(self.bn1(self.pw1(self.dw1(x))))
        return F.relu(self.bn2(self.pw2(self.dw2(x))))
