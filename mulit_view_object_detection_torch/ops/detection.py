"""Final detection refinement in torch.

Port of `mulit_view_object_detection_tpu/ops/detection.py` (the
reference's refine_detections_graph / DetectionLayer, model.py:684-823):
background and low-confidence rows are masked, per-class NMS is one
greedy NMS gated on class equality, and the first
DETECTION_MAX_INSTANCES selections are emitted in descending score order.
Output [B, DETECTION_MAX_INSTANCES, (y1, x1, y2, x2, class_id, score)],
zero-padded, normalized coordinates.
"""

from __future__ import annotations

import torch

from .boxes import apply_box_deltas, clip_boxes
from .nms import nms


def refine_detections(rois, probs, deltas, windows, *, bbox_std_dev,
                      detection_min_confidence, detection_max_instances,
                      detection_nms_threshold):
    """rois [B, N, 4]; probs [B, N, NC]; deltas [B, N, NC, 4]; windows
    [B, 4] normalized. Returns detections [B, max_instances, 6]."""
    std = deltas.new_tensor(bbox_std_dev)
    out = []
    for rois_i, probs_i, deltas_i, window_i in zip(rois, probs, deltas,
                                                   windows):
        n = rois_i.shape[0]
        rows = torch.arange(n, device=rois_i.device)
        class_ids = torch.argmax(probs_i, dim=1)
        class_scores = probs_i[rows, class_ids]
        refined = clip_boxes(
            apply_box_deltas(rois_i, deltas_i[rows, class_ids] * std),
            window_i)
        keep = class_ids > 0
        if detection_min_confidence:
            keep &= class_scores >= detection_min_confidence
        keep_idx, keep_valid = nms(
            refined, class_scores, detection_max_instances,
            detection_nms_threshold, valid_mask=keep, class_ids=class_ids)
        idx = keep_idx.clamp_min(0)
        det = torch.cat([refined[idx], class_ids[idx, None].float(),
                         class_scores[idx, None]], dim=1)
        out.append(torch.where(keep_valid[:, None], det, 0.0))
    return torch.stack(out)
