"""Training targets: head targets on the device, RPN targets on the host.

Port of `mulit_view_object_detection_tpu/ops/targets.py`.

* `detection_targets` (model.py:486-677) samples TRAIN_ROIS_PER_IMAGE
  ROIs from the proposals by a masked top-k over random priorities (a
  uniform random priority top-k is a uniform subsample without
  replacement) and builds their class, box and mask targets. The two
  priority vectors are inputs here: the JAX package draws them inside the
  model from its "sampling" key (targets.py:66-76); the port's train step
  draws them from an explicit torch.Generator, and a test can hand both
  packages the same numbers.
* `build_rpn_targets` (model.py:1449-1557) labels anchors on the host in
  numpy and consumes the RandomState exactly as the JAX function does.
  It matches anchors with the numpy matrix path, which the JAX package
  keeps bit-identical to its C++ matcher (native/maskops.cpp).
"""

from __future__ import annotations

import numpy as np
import torch

from .boxes import (box_refinement, box_refinement_np, compute_overlaps_np,
                    overlaps)
from .roi_align import crop_and_resize

_NEG_INF = -1e9
_DUMMY_BOX = (0.0, 0.0, 1.0, 1.0)


def detection_targets(proposals, gt_class_ids, gt_boxes, gt_masks,
                      pos_priority, neg_priority, *, train_rois_per_image,
                      roi_positive_ratio, mask_shape, use_mini_mask,
                      bbox_std_dev):
    """Sample ROIs and build head targets for ONE image.

    proposals [P, 4] normalized, zero-padded; gt_class_ids [G] (0 = pad,
    < 0 = crowd); gt_boxes [G, 4] normalized; gt_masks [G, mh, mw]
    (mini-masks when use_mini_mask); pos_priority, neg_priority [P]
    uniform in [0, 1).

    Returns (rois [T, 4], target_class_ids [T] int64, target_deltas
    [T, 4], target_masks [T, mask_h, mask_w]), T = train_rois_per_image,
    positives first, zero-padded as the reference pads (model.py:610-619).
    """
    dev = proposals.device
    proposals = proposals.float()
    gt_boxes = gt_boxes.float()
    gt_class_ids = gt_class_ids.long()
    pos_cap = int(train_rois_per_image * roi_positive_ratio)
    neg_cap = train_rois_per_image - pos_cap

    valid_prop = (proposals != 0).any(dim=1)
    valid_gt = (gt_boxes != 0).any(dim=1)
    crowd = valid_gt & (gt_class_ids < 0)
    non_crowd = valid_gt & (gt_class_ids > 0)

    ov = overlaps(proposals, gt_boxes)                      # [P, G]
    roi_iou_max = torch.where(non_crowd[None], ov, 0.0).max(dim=1).values
    crowd_iou_max = torch.where(crowd[None], ov, 0.0).max(dim=1).values
    no_crowd = crowd_iou_max < 0.001
    positive = valid_prop & (roi_iou_max >= 0.5)
    negative = valid_prop & (roi_iou_max < 0.5) & no_crowd

    pos_vals, pos_idx = torch.topk(
        torch.where(positive, pos_priority.float(), _NEG_INF), pos_cap)
    pos_valid = pos_vals > _NEG_INF / 2
    pos_count = pos_valid.sum()
    # negatives to keep the positive ratio (model.py:555-558)
    neg_target = (torch.floor((1.0 / roi_positive_ratio)
                              * pos_count.float()).long() - pos_count)
    neg_vals, neg_idx = torch.topk(
        torch.where(negative, neg_priority.float(), _NEG_INF), neg_cap)
    neg_valid = (neg_vals > _NEG_INF / 2) & (
        torch.arange(neg_cap, device=dev) < neg_target)

    pos_rois_raw = proposals[pos_idx]
    pos_rois = torch.where(pos_valid[:, None], pos_rois_raw, 0.0)
    neg_rois = torch.where(neg_valid[:, None], proposals[neg_idx], 0.0)

    # each positive to its best non-crowd GT (first on ties, as argmax)
    gt_assign = torch.where(non_crowd[None], ov, -1.0)[pos_idx].argmax(dim=1)
    roi_gt_boxes = gt_boxes[gt_assign]
    class_pos = torch.where(pos_valid, gt_class_ids[gt_assign], 0)

    # deltas, with invalid slots sanitised against log(0)
    dummy = proposals.new_tensor(_DUMMY_BOX)
    safe_rois = torch.where(pos_valid[:, None], pos_rois_raw, dummy)
    safe_gt = torch.where(pos_valid[:, None], roi_gt_boxes, dummy)
    deltas = box_refinement(safe_rois, safe_gt) / proposals.new_tensor(
        np.asarray(bbox_std_dev, np.float32))
    deltas = torch.where(pos_valid[:, None], deltas, 0.0)

    # mask targets: the assigned GT mask cropped to the ROI (model.py:
    # 577-606), in mini-mask (= GT box) coordinates when mini-masks are on
    roi_masks = gt_masks[gt_assign].float()[..., None]
    if use_mini_mask:
        gt_h = torch.clamp_min(safe_gt[:, 2] - safe_gt[:, 0], 1e-8)
        gt_w = torch.clamp_min(safe_gt[:, 3] - safe_gt[:, 1], 1e-8)
        crop_boxes = torch.stack([
            (safe_rois[:, 0] - safe_gt[:, 0]) / gt_h,
            (safe_rois[:, 1] - safe_gt[:, 1]) / gt_w,
            (safe_rois[:, 2] - safe_gt[:, 0]) / gt_h,
            (safe_rois[:, 3] - safe_gt[:, 1]) / gt_w], dim=1)
    else:
        crop_boxes = safe_rois
    masks = crop_and_resize(roi_masks, crop_boxes, tuple(mask_shape))
    masks = torch.round(masks[..., 0])                 # binarise (:606)
    masks = torch.where(pos_valid[:, None, None], masks, 0.0)

    rois = torch.cat([pos_rois, neg_rois])
    target_class_ids = torch.cat([class_pos, class_pos.new_zeros(neg_cap)])
    target_deltas = torch.cat([deltas, deltas.new_zeros(neg_cap, 4)])
    target_masks = torch.cat(
        [masks, masks.new_zeros((neg_cap,) + tuple(mask_shape))])
    return rois, target_class_ids, target_deltas, target_masks


def detection_targets_batch(proposals, gt_class_ids, gt_boxes, gt_masks,
                            pos_priority, neg_priority, **kw):
    """`detection_targets` per image, stacked on a leading batch axis;
    the priorities are [B, P]."""
    outs = [detection_targets(*args, **kw) for args in zip(
        proposals, gt_class_ids, gt_boxes, gt_masks, pos_priority,
        neg_priority)]
    return tuple(torch.stack(t) for t in zip(*outs))


def _match_anchors(anchors, gt_boxes):
    """(best_gt [A], best_iou [A], forced [A] bool): per-anchor argmax and
    max IoU, and the anchors that some GT overlaps best (ties included)."""
    iou = compute_overlaps_np(anchors, gt_boxes)
    best_gt = iou.argmax(axis=1)
    best_iou = iou[np.arange(anchors.shape[0]), best_gt]
    forced = (iou == iou.max(axis=0)).any(axis=1)
    return best_gt, best_iou, forced


def _demote_excess(labels, value, budget, rnd):
    """Randomly flip `value`-labelled anchors back to neutral (0) until at
    most `budget` remain: the RPN minibatch balancer."""
    slots = np.nonzero(labels == value)[0]
    surplus = slots.size - budget
    if surplus > 0:
        labels[rnd.choice(slots, surplus, replace=False)] = 0


def build_rpn_targets(anchors, gt_class_ids, gt_boxes, config,
                      rnd_state=None):
    """Host-side RPN anchor labels and regression targets.

    anchors [A, 4] pixels; gt_class_ids [G] (negative = crowd); gt_boxes
    [G, 4] pixels. Returns (rpn_match [A] int32 in {-1, 0, 1}, rpn_bbox
    [RPN_TRAIN_ANCHORS_PER_IMAGE, 4] std-dev-normalised deltas packed in
    positive-anchor order).

    Rules, later ones winning: anchors under 0.3 IoU with every GT are
    negative unless they touch a crowd box; each GT's best anchors (ties
    included) are positive; anchors at IoU >= 0.7 are positive. Then each
    side is thinned at random to the budget, half positive at most."""
    rnd = rnd_state or np.random
    num_anchors = anchors.shape[0]
    rpn_match = np.zeros(num_anchors, dtype=np.int32)
    rpn_bbox = np.zeros((config.RPN_TRAIN_ANCHORS_PER_IMAGE, 4))

    is_crowd = gt_class_ids < 0
    clear_of_crowds = np.ones(num_anchors, dtype=bool)
    if is_crowd.any():
        crowd = _match_anchors(anchors, gt_boxes[is_crowd])
        clear_of_crowds = crowd[1] < 0.001
        keep = gt_class_ids > 0
        gt_class_ids, gt_boxes = gt_class_ids[keep], gt_boxes[keep]

    if gt_boxes.shape[0] == 0:
        rpn_match[clear_of_crowds] = -1
        return rpn_match, rpn_bbox

    best_gt, best_iou, forced = _match_anchors(anchors, gt_boxes)
    rpn_match[(best_iou < 0.3) & clear_of_crowds] = -1
    rpn_match[forced] = 1
    rpn_match[best_iou >= 0.7] = 1

    budget = config.RPN_TRAIN_ANCHORS_PER_IMAGE
    _demote_excess(rpn_match, 1, budget // 2, rnd)
    _demote_excess(rpn_match, -1, budget - int(np.sum(rpn_match == 1)), rnd)

    positives = np.nonzero(rpn_match == 1)[0]
    if positives.size:
        deltas = box_refinement_np(anchors[positives],
                                   gt_boxes[best_gt[positives]])
        rpn_bbox[:positives.size] = deltas / config.RPN_BBOX_STD_DEV
    return rpn_match, rpn_bbox
