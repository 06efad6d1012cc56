"""Box coordinate ops: torch (device) and numpy (host) halves.

Port of `mulit_view_object_detection_tpu/ops/boxes.py` (the reference's
mrcnn/model.py:213-252 and utils.py:1112-1143). All boxes are
[..., (y1, x1, y2, x2)].
"""

from __future__ import annotations

import numpy as np
import torch


def apply_box_deltas(boxes, deltas):
    """Apply (dy, dx, log(dh), log(dw)) deltas. boxes/deltas: [..., 4]."""
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    center_y = boxes[..., 0] + 0.5 * height
    center_x = boxes[..., 1] + 0.5 * width
    center_y = center_y + deltas[..., 0] * height
    center_x = center_x + deltas[..., 1] * width
    height = height * torch.exp(deltas[..., 2])
    width = width * torch.exp(deltas[..., 3])
    y1 = center_y - 0.5 * height
    x1 = center_x - 0.5 * width
    return torch.stack([y1, x1, y1 + height, x1 + width], dim=-1)


def clip_boxes(boxes, window):
    """Clip boxes [..., 4] to window [4] (y1, x1, y2, x2)."""
    wy1, wx1, wy2, wx2 = window[0], window[1], window[2], window[3]
    return torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], wy1), wy2),
        torch.minimum(torch.maximum(boxes[..., 1], wx1), wx2),
        torch.minimum(torch.maximum(boxes[..., 2], wy1), wy2),
        torch.minimum(torch.maximum(boxes[..., 3], wx1), wx2),
    ], dim=-1)


def overlaps(boxes1, boxes2):
    """Pairwise IoU [N1, N2]; a pair with an empty union gives 0."""
    b1 = boxes1[:, None, :]
    b2 = boxes2[None, :, :]
    y1 = torch.maximum(b1[..., 0], b2[..., 0])
    x1 = torch.maximum(b1[..., 1], b2[..., 1])
    y2 = torch.minimum(b1[..., 2], b2[..., 2])
    x2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = area1 + area2 - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def norm_boxes(boxes, shape):
    """Pixel -> normalized coordinates, (h-1, w-1) convention."""
    h, w = shape[0], shape[1]
    scale = boxes.new_tensor([h - 1, w - 1, h - 1, w - 1],
                             dtype=torch.float32)
    shift = boxes.new_tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float32)
    return (boxes.float() - shift) / scale


def _norm_coeffs(shape):
    h, w = shape
    return (np.array([h - 1, w - 1, h - 1, w - 1]), np.array([0, 0, 1, 1]))


def norm_boxes_np(boxes, shape):
    scale, shift = _norm_coeffs(shape)
    return ((boxes - shift) / scale).astype(np.float32)


def denorm_boxes_np(boxes, shape):
    scale, shift = _norm_coeffs(shape)
    return np.around(boxes * scale + shift).astype(np.int32)
