"""Cross-view voxel-grid fusion and depth-sample collapse.

Port of `mulit_view_object_detection_tpu/models/fusion.py`: `GridFusion`
in every mode (fusion.py:338-405, model_multi.py:394-463), the scanned
`ConvLSTM3D` (fusion.py:36-53, 86-120) and both `DepthCollapse` modes
(fusion.py:506-544, model_multi.py:466-488), with the same layer names.
One module pair per pyramid level. The hoisted ConvLSTM input conv
(LSTM_HOIST_INPUT) is a TPU lowering of the same math and is not ported.

Voxel axes X, Y, Z map to torch's D, H, W. Hazards kept exactly:
  * down1/down2 are 3^3 stride-2 flax SAME convs, which pad (0, 1) on an
    even input where torch's padding=1 pads (1, 1): padded explicitly;
  * up1/up2 are flax SAME ConvTranspose 3^3/2 (transpose_kernel=False),
    which pads the dilated input (2, 1). torch's ConvTranspose3d with
    padding=0 pads it (2, 2) with the kernel flipped, so its first 2n
    outputs are flax's (the converter flips the kernel);
  * the skip concat order is [deconv1, conv1];
  * the ConvLSTM gate conv reads the channel concat [x, h] and splits its
    output as (j, i, f, o), with forget_bias 1 added to f.
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


class ConvLSTMCell3D(nn.Module):
    """One fused-gate ConvLSTM step (recurrent.py:443-478 semantics): a
    3^3 SAME conv over [x, h] to 4F gates (j, i, f, o)."""

    def __init__(self, in_channels, filters, forget_bias=1.0):
        super().__init__()
        self.forget_bias = forget_bias
        self.lstm_gates = Conv3d(in_channels + filters, 4 * filters, 3,
                                 padding=1)

    def forward(self, carry, x):
        memory, output = carry
        y = self.lstm_gates(torch.cat([x, output], dim=1))
        j, i, f, o = torch.chunk(y, 4, dim=1)
        memory = (memory * torch.sigmoid(f + self.forget_bias)
                  + torch.sigmoid(i) * torch.tanh(j))
        output = torch.tanh(memory) * torch.sigmoid(o)
        return memory, output


class ConvLSTM3D(nn.Module):
    """ConvLSTM over the view axis, returning the last hidden state (the
    JAX module's nn.scan, the reference's ConvRNN3D with
    return_sequences=False): [B, V, C, X, Y, Z] -> [B, F, X, Y, Z]. The
    state starts at zero in the input's dtype."""

    def __init__(self, in_channels, filters, forget_bias=1.0):
        super().__init__()
        self.filters = filters
        self.cell = ConvLSTMCell3D(in_channels, filters, forget_bias)

    def forward(self, xs):
        b, v, _, nx, ny, nz = xs.shape
        zeros = xs.new_zeros(b, self.filters, nx, ny, nz)
        carry = (zeros, zeros)
        for i in range(v):
            carry = self.cell(carry, xs[:, i])
        return carry[1]


class GridFusion(nn.Module):
    """Fuse the views of one level's voxel grid -> [B, C, X, Y, Z].

    Input, by mode:
      conv3d, ident    [B, V*C, X, Y, Z], the views concatenated on
                       channels and relu'd (the fused unprojection
                       kernel's output);
      add, mean,       [B, V, C, X, Y, Z], one grid per view (the
      lstm3d           per-view kernel's output).
    Modes: add (sum over views, BN, ReLU), mean (no parameters), ident
    (1x1x1 conv V*C -> C, BN, ReLU), conv3d (the U-Net), lstm3d (ReLU,
    ConvLSTM over the views, BN, ReLU)."""

    def __init__(self, channels, num_views, mode="conv3d"):
        super().__init__()
        self.mode = mode
        c = channels
        if mode in ("add", "ident", "lstm3d"):
            self.fuse_bn = BatchNorm(c)
        if mode == "ident":
            self.ident_conv = Conv3d(num_views * c, c, 1)
        elif mode == "lstm3d":
            self.convlstm = ConvLSTM3D(c, c)
        elif mode == "conv3d":
            self.down1 = Conv3d(num_views * c, 2 * c, 3, stride=2)
            self.bn1 = BatchNorm(2 * c)
            self.down2 = Conv3d(2 * c, 4 * c, 3, stride=2)
            self.bn2 = BatchNorm(4 * c)
            self.up1 = ConvTranspose3d(4 * c, 2 * c, 3, stride=2)
            self.bn_up1 = BatchNorm(2 * c)
            self.up2 = ConvTranspose3d(4 * c, c, 3, stride=2)
            self.bn_up2 = BatchNorm(c)
        elif mode not in ("add", "mean"):
            raise ValueError(f"unknown fusion mode {mode}")

    def forward(self, x, stats=None):
        """`stats`: the BatchNorms' batch statistics (TRAIN_BN), or None
        for frozen ones."""
        if self.mode == "mean":
            return x.mean(dim=1)
        if self.mode == "add":
            return F.relu(self.fuse_bn(x.sum(dim=1), stats))
        if self.mode == "ident":
            return F.relu(self.fuse_bn(self.ident_conv(x), stats))
        if self.mode == "lstm3d":
            return F.relu(self.fuse_bn(self.convlstm(F.relu(x)), stats))
        k, s = (3, 3, 3), (2, 2, 2)
        conv1 = F.relu(self.bn1(self.down1(pad_same(x, k, s)), stats))
        conv2 = F.relu(self.bn2(self.down2(pad_same(conv1, k, s)), stats))
        deconv1 = F.relu(self.bn_up1(deconv_same(self.up1, conv2), stats))
        x = torch.cat([deconv1, conv1], dim=1)
        return F.relu(self.bn_up2(deconv_same(self.up2, x), stats))


class DepthCollapse(nn.Module):
    """Ray slices [B, D, S, S, C] (the reprojection kernel's layout) ->
    [B, C, S, S].

    conv3d mode: samples fold into channels as channel c*D + d, then a
    depthwise + pointwise stack. Every other mode: one 1x1 conv collapses
    the D samples of each channel to one value, its weights shared across
    channels, then a BatchNorm over that single feature (the reference's
    channels-last BN on [B, C, S, S, 1])."""

    def __init__(self, channels, samples, mode="conv3d"):
        super().__init__()
        self.mode = mode
        if mode != "conv3d":
            self.collapse = Conv2d(samples, 1, 1)
            self.bn = BatchNorm(1)
            return
        feat = channels * samples
        self.dw1 = Conv2d(feat, feat, 1, groups=feat)
        self.pw1 = Conv2d(feat, 512, 1)
        self.bn1 = BatchNorm(512)
        self.dw2 = Conv2d(512, 512, 1, groups=512)
        self.pw2 = Conv2d(512, channels, 1)
        self.bn2 = BatchNorm(channels)

    def forward(self, rays, stats=None):
        b, d, s1, s2, c = rays.shape
        if self.mode != "conv3d":
            x = rays.permute(0, 4, 1, 2, 3).reshape(b * c, d, s1, s2)
            x = F.relu(self.bn(self.collapse(x), stats))  # [B*C, 1, S, S]
            return x.reshape(b, c, s1, s2)
        x = rays.permute(0, 4, 1, 2, 3).reshape(b, c * d, s1, s2)
        x = F.relu(self.bn1(self.pw1(self.dw1(x)), stats))
        return F.relu(self.bn2(self.pw2(self.dw2(x)), stats))
