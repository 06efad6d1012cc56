"""RPN proposal generation in torch.

Port of `mulit_view_object_detection_tpu/ops/proposals.py` (the
reference's ProposalLayer, model.py:255-332): top-k by score -> apply
deltas -> clip -> greedy NMS -> zero-padded proposals.

Tie order: the constant-folded zero pyramid levels make about 94% of the
anchors exact score ties at the flagship shape. The JAX package selects
with jax.lax.top_k (ties lowest-index-first), through its exact const-span
merge. `torch.topk` guarantees no tie order on CUDA, so this port selects
with a stable descending sort, which gives the same indices in the same
order.
"""

from __future__ import annotations

import torch

from .boxes import apply_box_deltas, clip_boxes
from .nms import nms


def generate_proposals(rpn_probs, rpn_deltas, anchors, *, proposal_count,
                       nms_threshold, pre_nms_limit, bbox_std_dev):
    """rpn_probs [B, A, 2]; rpn_deltas [B, A, 4]; anchors [A, 4] normalized.
    Returns proposals [B, proposal_count, 4] normalized, zero-padded."""
    scores = rpn_probs[:, :, 1]
    deltas = rpn_deltas * rpn_deltas.new_tensor(bbox_std_dev)
    k = min(pre_nms_limit, anchors.shape[0])
    window = anchors.new_tensor([0.0, 0.0, 1.0, 1.0])
    out = []
    for scores_i, deltas_i in zip(scores, deltas):
        top_scores, ix = torch.sort(scores_i, descending=True, stable=True)
        top_scores, ix = top_scores[:k], ix[:k]
        boxes = clip_boxes(apply_box_deltas(anchors[ix], deltas_i[ix]),
                           window)
        keep_idx, keep_valid = nms(boxes, top_scores, proposal_count,
                                   nms_threshold)
        props = boxes[keep_idx.clamp_min(0)]
        out.append(torch.where(keep_valid[:, None], props, 0.0))
    return torch.stack(out)
