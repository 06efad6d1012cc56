"""The five Mask R-CNN losses as static-shape masked means.

Port of `mulit_view_object_detection_tpu/models/losses.py` (the
reference's model.py:1016-1183). The reference gathers dynamic index
lists and means over them; here each loss is a masked sum over a count,
with the same value. Every loss is float32.

Each loss is a mean over the whole batch, so under data parallelism the
mean of the ranks' means is not the global loss. Given a process
`group`, a loss divides its rank's masked sum by the count summed over
the group (detached, so that it carries no gradient, as the masks carry
none): the ranks' losses then add up to the global batch's loss, and
their gradients to its gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

LOSS_NAMES = ("rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
              "mrcnn_bbox_loss", "mrcnn_mask_loss")


def _weighted_mean(loss, weight, group):
    """sum(loss * weight) over the count sum(weight), summed over the
    ranks of `group` when one is given; 0 when the count is 0."""
    count = weight.sum().detach()
    if group is not None:
        dist.all_reduce(count, group=group)
    return torch.where(count > 0,
                       (loss * weight).sum() / count.clamp_min(1.0), 0.0)


def _masked_mean(loss, mask, group=None):
    """Mean over the elements of `loss` whose (broadcast) mask is 1; 0
    when none is."""
    mask = mask.to(loss.dtype)
    while mask.dim() < loss.dim():
        mask = mask[..., None]
    return _weighted_mean(loss, mask.expand(loss.shape), group)


def smooth_l1(y_true, y_pred):
    """model.py:1016-1023."""
    diff = (y_true - y_pred).abs()
    return torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)


def rpn_class_loss(rpn_match, rpn_class_logits, group=None):
    """rpn_match [B, A] in {-1, 0, 1}; logits [B, A, 2]. Neutral anchors
    do not contribute (model.py:1026-1048)."""
    anchor_class = (rpn_match == 1).long()
    logp = F.log_softmax(rpn_class_logits.float(), dim=-1)
    ce = -logp.gather(-1, anchor_class[..., None])[..., 0]
    return _masked_mean(ce, rpn_match != 0, group)


def rpn_bbox_loss(target_bbox, rpn_match, rpn_bbox, group=None):
    """target_bbox [B, MAX_POS, 4] packed in positive-anchor order;
    rpn_match [B, A]; rpn_bbox [B, A, 4] (model.py:1051-1077). Each
    positive anchor takes the target row of its rank among positives."""
    positive = rpn_match == 1
    rank = (positive.long().cumsum(dim=1) - 1).clamp(
        0, target_bbox.shape[1] - 1)
    tgt = target_bbox.float().gather(1, rank[..., None].expand(-1, -1, 4))
    return _masked_mean(smooth_l1(tgt, rpn_bbox.float()), positive, group)


def mrcnn_class_loss(target_class_ids, pred_class_logits, active_class_ids,
                     group=None):
    """target_class_ids [B, T]; logits [B, T, C]; active_class_ids [B, C]
    (model.py:1080-1113). Every ROI slot contributes, weighted by whether
    its PREDICTED class is active; image 0's active ids serve the whole
    batch, as in the reference (under a process group, the global batch's
    image 0: the group's first rank's)."""
    logits = pred_class_logits.float()
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, target_class_ids.long()[..., None])[..., 0]
    active = active_class_ids[0].float()
    if group is not None:
        active = active.contiguous()
        dist.broadcast(active, src=dist.get_global_rank(group, 0),
                       group=group)
    return _weighted_mean(ce, active[logits.argmax(dim=-1)], group)


def mrcnn_bbox_loss(target_bbox, target_class_ids, pred_bbox, group=None):
    """target_bbox [B, T, 4]; target_class_ids [B, T]; pred_bbox
    [B, T, C, 4] (model.py:1116-1144). Positive ROIs only, the target
    class's deltas only."""
    positive = target_class_ids > 0
    cls = target_class_ids.long().clamp_min(0)
    pred = pred_bbox.float().gather(
        2, cls[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    return _masked_mean(smooth_l1(target_bbox.float(), pred), positive, group)


def mrcnn_mask_loss(target_masks, target_class_ids, pred_masks, group=None):
    """target_masks [B, T, h, w]; target_class_ids [B, T]; pred_masks
    [B, T, h, w, C] sigmoid outputs (model.py:1147-1183)."""
    positive = target_class_ids > 0
    cls = target_class_ids.long().clamp_min(0)
    b, t, h, w, _ = pred_masks.shape
    pred = pred_masks.float().gather(
        -1, cls[:, :, None, None, None].expand(b, t, h, w, 1))[..., 0]
    eps = 1e-7
    p = pred.clamp(eps, 1.0 - eps)
    tm = target_masks.float()
    bce = -(tm * torch.log(p) + (1.0 - tm) * torch.log(1 - p))
    return _masked_mean(bce, positive, group)


def total_loss(parts, loss_weights):
    """Weighted sum of the five losses (model.py:2172-2182)."""
    return sum(parts[n] * loss_weights.get(n, 1.0) for n in LOSS_NAMES)
