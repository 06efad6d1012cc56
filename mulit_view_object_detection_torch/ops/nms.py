"""Greedy non-max suppression in torch.

Port of `mulit_view_object_detection_tpu/ops/nms.py::nms` (the reference
reaches NMS through tf.image.non_max_suppression, model.py:319-321 and
736-740). Same fixed-point formulation: sort by score with ties broken
lowest-index-first (a stable descending sort, the order jax.lax.top_k
gives), build the "j suppresses i" matrix T (j before i, IoU >
threshold, optional class gating), and iterate kept[i] = valid[i] and
not any_j(T[j, i] and kept[j]) until it is stable. The fixed point is
exactly greedy NMS's kept set. Suppression gated on class equality equals
independent per-class NMS merged in score order.
"""

from __future__ import annotations

import torch

from .boxes import overlaps

_NEG_INF = -1e9


def nms(boxes, scores, max_output_size, iou_threshold, valid_mask=None,
        class_ids=None):
    """boxes [N, 4]; scores [N]; valid_mask / class_ids optional [N].

    Returns (keep_idx [K] int64 indices in descending score order, -1 past
    the last kept box; keep_valid [K] bool), K = max_output_size."""
    n = boxes.shape[0]
    k = max_output_size
    scores = scores.float()
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, _NEG_INF)
    sorted_scores, order = torch.sort(scores, descending=True, stable=True)
    valid_s = sorted_scores > _NEG_INF / 2

    supp = overlaps(boxes[order], boxes[order]) > iou_threshold
    supp = torch.triu(supp, diagonal=1) & valid_s[:, None]
    if class_ids is not None:
        cls_s = class_ids[order]
        supp &= cls_s[:, None] == cls_s[None, :]

    kept = valid_s
    for _ in range(n):
        new_kept = valid_s & ~(supp & kept[:, None]).any(dim=0)
        if torch.equal(new_kept, kept):
            break
        kept = new_kept

    sel = order[kept][:k]
    keep_idx = torch.full((k,), -1, dtype=torch.int64, device=boxes.device)
    keep_idx[:sel.shape[0]] = sel
    return keep_idx, keep_idx >= 0
