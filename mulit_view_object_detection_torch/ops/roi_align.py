"""ROI Align in torch: crop-and-resize and pyramid ROI align.

Port of `mulit_view_object_detection_tpu/ops/roi_align.py`, with the exact
tf.image.crop_and_resize semantics the reference uses (model.py:421-423):
sample i of S > 1 sits at the convex combination
(lo*(1 - i/(S-1)) + hi*(i/(S-1))) * (H-1), the (h-1, w-1) normalisation,
the box center for S == 1, and 0 for samples outside [0, H-1] x [0, W-1].
The per-box FPN level dispatch is index arithmetic into one flattened
pyramid, so the output keeps the order of the boxes.

Feature maps are channels-last [B, H, W, C], as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _sample_coords(lo, hi, extent_minus_1, size):
    """[..., size] absolute sample coordinates along one axis (exact
    endpoints, see the JAX module)."""
    steps = torch.arange(size, dtype=torch.float32, device=lo.device)
    if size > 1:
        t = steps / (size - 1)
        return ((lo[..., None] * (1.0 - t) + hi[..., None] * t)
                * extent_minus_1[..., None])
    return (0.5 * (lo + hi) * extent_minus_1)[..., None] + 0.0 * steps


def _bilinear(flat, bidx, off, width, ys, xs, h_lim, w_lim):
    """Bilinear samples of flat [B', T, C] at rows ys [..., Sh] and columns
    xs [..., Sw]; off/width [...] locate each box's map in flat.
    Returns [..., Sh, Sw, C] float32, 0 outside the map."""
    y_valid = (ys >= 0) & (ys <= h_lim[..., None])
    x_valid = (xs >= 0) & (xs <= w_lim[..., None])
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    ly = ys - y0f
    lx = xs - x0f
    hmax = h_lim[..., None].long()
    wmax = w_lim[..., None].long()
    # a NaN coordinate (a box from overflowed deltas) reads row/column 0
    # and is masked below, as the JAX gather clamps its index
    y0 = torch.minimum(y0f.clamp_min(0), h_lim[..., None]).nan_to_num(
        0.0).long()
    x0 = torch.minimum(x0f.clamp_min(0), w_lim[..., None]).nan_to_num(
        0.0).long()
    y1 = torch.minimum(y0 + 1, hmax)
    x1 = torch.minimum(x0 + 1, wmax)

    def gather(yi, xi):
        idx = (off[..., None, None] + yi[..., :, None] * width[..., None, None]
               + xi[..., None, :])
        return flat[bidx, idx].float()

    ly = ly[..., :, None, None]
    lx = lx[..., None, :, None]
    out = (gather(y0, x0) * (1 - ly) * (1 - lx)
           + gather(y0, x1) * (1 - ly) * lx
           + gather(y1, x0) * ly * (1 - lx)
           + gather(y1, x1) * ly * lx)
    valid = (y_valid[..., :, None] & x_valid[..., None, :])[..., None]
    return torch.where(valid, out, 0.0)


def crop_and_resize_pairs(images, boxes, size, extrapolation_value=0.0):
    """Bilinear crop of images[i] [N, H, W, C] by boxes[i] [N, 4]
    normalized (1:1 pairing) to size (Sh, Sw) -> [N, Sh, Sw, C], samples
    outside the image `extrapolation_value`; matches
    tf.image.crop_and_resize(images, boxes, range(N), size) (mask
    targets, model.py:598-600)."""
    n, h, w, c = images.shape
    sh, sw = size
    boxes = boxes.float()
    hm1 = torch.full((n,), h - 1, dtype=torch.float32, device=images.device)
    wm1 = torch.full((n,), w - 1, dtype=torch.float32, device=images.device)
    ys = _sample_coords(boxes[:, 0], boxes[:, 2], hm1, sh)
    xs = _sample_coords(boxes[:, 1], boxes[:, 3], wm1, sw)
    zeros = torch.zeros(n, dtype=torch.int64, device=images.device)
    bidx = torch.arange(n, device=images.device)[:, None, None]
    out = _bilinear(images.reshape(n, h * w, c), bidx, zeros,
                    torch.full_like(zeros, w), ys, xs, hm1, wm1)
    if extrapolation_value:
        valid = (((ys >= 0) & (ys <= h - 1))[:, :, None]
                 & ((xs >= 0) & (xs <= w - 1))[:, None, :])[..., None]
        out = torch.where(valid, out, float(extrapolation_value))
    return out.to(images.dtype)


def roi_levels(boxes, image_shape, num_levels=4):
    """0-based FPN level per box over [P2..P5] (model.py:389-393)."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    image_area = float(image_shape[0] * image_shape[1])
    sqrt_hw = torch.sqrt(torch.clamp_min(h * w, 1e-12))
    lvl = torch.log2(sqrt_hw / (224.0 / np.sqrt(image_area)))
    lvl = torch.clamp(torch.round(lvl).to(torch.int64) + 4, 2,
                      2 + num_levels - 1)
    return lvl - 2


def pyramid_roi_align(boxes, feature_maps, image_shape, pool_size):
    """boxes [B, N, 4] normalized (zero-padded allowed); feature_maps list
    of [B, H_l, W_l, C] for P2..P5. Returns [B, N, S, S, C] in the order
    of `boxes`, in the feature maps' dtype."""
    b, n, _ = boxes.shape
    c = feature_maps[0].shape[-1]
    dev = boxes.device
    heights = torch.tensor([fm.shape[1] for fm in feature_maps], device=dev)
    widths = torch.tensor([fm.shape[2] for fm in feature_maps], device=dev)
    sizes = [fm.shape[1] * fm.shape[2] for fm in feature_maps]
    offsets = torch.tensor([0] + list(np.cumsum(sizes)[:-1]), device=dev)
    flat = torch.cat([fm.reshape(b, -1, c) for fm in feature_maps], dim=1)

    boxes = boxes.float()
    lvl = roi_levels(boxes, image_shape, len(feature_maps))
    h_lim = heights[lvl].float() - 1
    w_lim = widths[lvl].float() - 1
    ys = _sample_coords(boxes[..., 0], boxes[..., 2], h_lim, pool_size)
    xs = _sample_coords(boxes[..., 1], boxes[..., 3], w_lim, pool_size)
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    out = _bilinear(flat, bidx, offsets[lvl], widths[lvl], ys, xs,
                    h_lim, w_lim)
    return out.to(feature_maps[0].dtype)

