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


def box_refinement(box, gt_box):
    """Deltas that take `box` onto `gt_box`, float32 (utils.py:442-465)."""
    box = box.float()
    gt_box = gt_box.float()
    height = box[..., 2] - box[..., 0]
    width = box[..., 3] - box[..., 1]
    center_y = box[..., 0] + 0.5 * height
    center_x = box[..., 1] + 0.5 * width
    gt_height = gt_box[..., 2] - gt_box[..., 0]
    gt_width = gt_box[..., 3] - gt_box[..., 1]
    gt_center_y = gt_box[..., 0] + 0.5 * gt_height
    gt_center_x = gt_box[..., 1] + 0.5 * gt_width
    return torch.stack([(gt_center_y - center_y) / height,
                        (gt_center_x - center_x) / width,
                        torch.log(gt_height / height),
                        torch.log(gt_width / width)], dim=-1)


def iou_one_to_many(box, boxes):
    """IoU of one box [4] against boxes [N, 4] -> [N]; an empty union
    gives 0."""
    y1 = torch.maximum(box[0], boxes[:, 0])
    x1 = torch.maximum(box[1], boxes[:, 1])
    y2 = torch.minimum(box[2], boxes[:, 2])
    x2 = torch.minimum(box[3], boxes[:, 3])
    inter = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area + areas - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def norm_boxes(boxes, shape):
    """Pixel -> normalized coordinates, (h-1, w-1) convention."""
    h, w = shape[0], shape[1]
    scale = boxes.new_tensor([h - 1, w - 1, h - 1, w - 1],
                             dtype=torch.float32)
    shift = boxes.new_tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float32)
    return (boxes.float() - shift) / scale


def denorm_boxes(boxes, shape):
    """Normalized -> pixel coordinates, int32 (utils.py:1129-1143)."""
    h, w = shape[0], shape[1]
    scale = boxes.new_tensor([h - 1, w - 1, h - 1, w - 1],
                             dtype=torch.float32)
    shift = boxes.new_tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float32)
    return torch.round(boxes * scale + shift).to(torch.int32)


# ---------------------------------------------------------------------------
# numpy (host: dataset preparation, evaluation), copies of the JAX
# package's
# ---------------------------------------------------------------------------

def compute_overlaps_np(boxes1, boxes2):
    """Pairwise IoU [N1, N2] in float32, one broadcast (inputs cast to
    float32 first, so the RPN matcher's exact tie compare sees the same
    values whatever the callers' dtype)."""
    c1 = np.ascontiguousarray(boxes1.T, dtype=np.float32)
    c2 = np.ascontiguousarray(boxes2.T, dtype=np.float32)
    ih = np.minimum.outer(c1[2], c2[2])
    ih -= np.maximum.outer(c1[0], c2[0])
    iw = np.minimum.outer(c1[3], c2[3])
    iw -= np.maximum.outer(c1[1], c2[1])
    np.clip(ih, 0, None, out=ih)
    np.clip(iw, 0, None, out=iw)
    ih *= iw
    inter = ih
    a1 = (c1[2] - c1[0]) * (c1[3] - c1[1])
    a2 = (c2[2] - c2[0]) * (c2[3] - c2[1])
    union = a1[:, None] + a2[None, :] - inter
    return inter / union


def compute_overlaps_masks_np(masks1, masks2):
    """IoU between two mask stacks [H, W, N] via one flattened matmul
    (utils.py:359-378)."""
    n1, n2 = masks1.shape[-1], masks2.shape[-1]
    if n1 == 0 or n2 == 0:
        return np.zeros((n1, n2))
    flat1 = (masks1 > 0.5).reshape(-1, n1).astype(np.float32)
    flat2 = (masks2 > 0.5).reshape(-1, n2).astype(np.float32)
    inter = flat1.T @ flat2
    union = flat1.sum(0)[:, None] + flat2.sum(0)[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def _areas_np(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def compute_iou_np(box, boxes, box_area, boxes_area):
    """IoU of one box [4] against boxes [N, 4], no epsilon: a degenerate
    union propagates as in the reference (utils.py:319-337)."""
    lo = np.maximum(box[:2], boxes[:, :2])
    hi = np.minimum(box[2:4], boxes[:, 2:4])
    inter = np.prod(np.maximum(hi - lo, 0), axis=-1)
    return inter / (box_area + boxes_area - inter)


def non_max_suppression_np(boxes, scores, threshold):
    """Greedy score-descending NMS; returns the kept indices, int32. A box
    goes at an IoU strictly above `threshold` (utils.py:381-415)."""
    assert boxes.shape[0] > 0
    boxes = boxes.astype(np.float32) if boxes.dtype.kind != "f" else boxes
    areas = _areas_np(boxes)
    order = scores.argsort()[::-1]
    alive = np.ones(boxes.shape[0], dtype=bool)
    kept = []
    for rank in range(order.shape[0]):
        idx = order[rank]
        if not alive[idx]:
            continue
        kept.append(idx)
        rest = order[rank + 1:]
        iou = compute_iou_np(boxes[idx], boxes[rest], areas[idx],
                             areas[rest])
        alive[rest[iou > threshold]] = False
    return np.asarray(kept, dtype=np.int32)


def _box_geometry_np(boxes):
    """(centers [N, (cy, cx)], sizes [N, (h, w)]) of float32 boxes."""
    sizes = boxes[:, 2:4] - boxes[:, 0:2]
    return boxes[:, 0:2] + 0.5 * sizes, sizes


def apply_box_deltas_np(boxes, deltas):
    """Apply (dy, dx, log dh, log dw) refinements (utils.py:418-439)."""
    centers, sizes = _box_geometry_np(boxes.astype(np.float32))
    centers = centers + deltas[:, 0:2] * sizes
    sizes = sizes * np.exp(deltas[:, 2:4])
    corner = centers - 0.5 * sizes
    return np.concatenate([corner, corner + sizes], axis=1)


def box_refinement_np(box, gt_box):
    """Deltas taking `box` onto `gt_box` (utils.py:468-491)."""
    centers, sizes = _box_geometry_np(box.astype(np.float32))
    gt_centers, gt_sizes = _box_geometry_np(gt_box.astype(np.float32))
    return np.concatenate(
        [(gt_centers - centers) / sizes, np.log(gt_sizes / sizes)], axis=1)


def extract_bboxes_np(mask):
    """Tight boxes from masks [H, W, N] -> [N, (y1, x1, y2, x2)] int32,
    bottom-right exclusive; an empty mask gives the zero box
    (utils.py:293-316)."""
    h, w, _ = mask.shape
    cols = mask.any(axis=0)                      # [W, N]
    rows = mask.any(axis=1)                      # [H, N]
    x1 = cols.argmax(axis=0)
    y1 = rows.argmax(axis=0)
    x2 = w - cols[::-1].argmax(axis=0)           # last occupied col + 1
    y2 = h - rows[::-1].argmax(axis=0)
    boxes = np.stack([y1, x1, y2, x2], axis=1).astype(np.int32)
    boxes[~cols.any(axis=0)] = 0
    return boxes


def _norm_coeffs(shape):
    h, w = shape
    return (np.array([h - 1, w - 1, h - 1, w - 1]), np.array([0, 0, 1, 1]))


def norm_boxes_np(boxes, shape):
    scale, shift = _norm_coeffs(shape)
    return ((boxes - shift) / scale).astype(np.float32)


def denorm_boxes_np(boxes, shape):
    scale, shift = _norm_coeffs(shape)
    return np.around(boxes * scale + shift).astype(np.int32)
