"""VOC-style detection and instance-segmentation metrics (host numpy).

A copy of `mulit_view_object_detection_tpu/eval/metrics.py`: the port
imports nothing of the JAX package, not even a module without jax. Same
evaluation contract as the reference stack: greedy score-ordered
matching on mask IoU, the interpolated-precision AP integral, and the
IoU-sweep average:

  compute_matches   utils.py:915-971
  compute_ap        utils.py:974-1010
  compute_ap_range  utils.py:1013-1034
  compute_recall    utils.py:1037-1052
"""

from __future__ import annotations

import numpy as np

from ..ops.boxes import compute_overlaps_masks_np, compute_overlaps_np


def trim_zeros(x):
    """Drop all-zero rows from a 2-D array (padding convention: real rows
    never vanish to exactly zero)."""
    assert x.ndim == 2
    return x[np.any(x != 0, axis=1)]


def compute_matches(gt_boxes, gt_class_ids, gt_masks,
                    pred_boxes, pred_class_ids, pred_scores, pred_masks,
                    iou_threshold=0.5, score_threshold=0.0):
    """Greedily match predictions to ground truth on mask IoU.

    Predictions are visited in descending score order; each takes its
    highest-IoU unclaimed GT of the same class, provided IoU clears
    `iou_threshold`. Returns (gt_match [G], pred_match [P], overlaps
    [P, G]) where the match arrays hold the paired index or -1.
    """
    gt_boxes = trim_zeros(gt_boxes)
    gt_masks = gt_masks[..., :gt_boxes.shape[0]]
    pred_boxes = trim_zeros(pred_boxes)
    pred_scores = pred_scores[:pred_boxes.shape[0]]
    # descending score; ties resolved identically to the reference
    order = np.argsort(pred_scores)[::-1]
    pred_boxes = pred_boxes[order]
    pred_class_ids = pred_class_ids[order]
    pred_scores = pred_scores[order]
    pred_masks = pred_masks[..., order]

    overlaps = compute_overlaps_masks_np(pred_masks, gt_masks)
    num_pred, num_gt = pred_boxes.shape[0], gt_boxes.shape[0]
    gt_match = np.full(num_gt, -1.0)
    pred_match = np.full(num_pred, -1.0)
    for p in range(num_pred):
        candidates = np.argsort(overlaps[p])[::-1]
        below = np.nonzero(overlaps[p, candidates] < score_threshold)[0]
        if below.size:
            candidates = candidates[:below[0]]
        for g in candidates:
            if gt_match[g] > -1:
                continue  # already claimed by a higher-scoring prediction
            if overlaps[p, g] < iou_threshold:
                break     # candidates are IoU-sorted: nothing better left
            if pred_class_ids[p] == gt_class_ids[g]:
                gt_match[g] = p
                pred_match[p] = g
                break
    return gt_match, pred_match, overlaps


def greedy_box_matches(ref_boxes, ref_class_ids, boxes, class_ids,
                       iou_threshold=0.9):
    """Greedy same-class BOX matching between two detection sets (pixel
    or normalized boxes, same convention on both sides): each reference
    detection claims its best-IoU unclaimed same-class counterpart.
    Returns [(ref_i, other_i, iou)] for pairs with IoU >= threshold.
    Used by the executed-reference parity checks
    (tests/test_fullgraph_parity.py, tools/check_multiview_golden.py),
    which match final detections rather than mask instances."""
    overlaps = compute_overlaps_np(np.asarray(boxes, np.float32),
                                   np.asarray(ref_boxes, np.float32))
    matches, used = [], set()
    for gi in range(len(ref_boxes)):
        best, best_iou = None, 0.0
        for oi in range(len(boxes)):
            if oi in used or class_ids[oi] != ref_class_ids[gi]:
                continue
            if overlaps[oi, gi] > best_iou:
                best, best_iou = oi, overlaps[oi, gi]
        if best is not None and best_iou >= iou_threshold:
            used.add(best)
            matches.append((gi, best, float(best_iou)))
    return matches


def compute_ap(gt_boxes, gt_class_ids, gt_masks,
               pred_boxes, pred_class_ids, pred_scores, pred_masks,
               iou_threshold=0.5):
    """Average precision at one IoU threshold: area under the
    interpolated (monotone-envelope) precision-recall curve."""
    gt_match, pred_match, overlaps = compute_matches(
        gt_boxes, gt_class_ids, gt_masks,
        pred_boxes, pred_class_ids, pred_scores, pred_masks, iou_threshold)

    hits = np.cumsum(pred_match > -1)
    precisions = hits / (np.arange(pred_match.size) + 1)
    recalls = hits.astype(np.float32) / gt_match.size

    # sentinel-pad, then take the running max from the right so precision
    # is non-increasing in recall (the VOC interpolation)
    precisions = np.concatenate([[0.0], precisions, [0.0]])
    recalls = np.concatenate([[0.0], recalls, [1.0]])
    precisions = np.maximum.accumulate(precisions[::-1])[::-1]

    steps = np.nonzero(recalls[1:] != recalls[:-1])[0] + 1
    ap = float(np.sum((recalls[steps] - recalls[steps - 1]) *
                      precisions[steps]))
    return ap, precisions, recalls, overlaps


def compute_ap_range(gt_box, gt_class_id, gt_mask,
                     pred_box, pred_class_id, pred_score, pred_mask,
                     iou_thresholds=None, verbose=1):
    """AP averaged over an IoU sweep (default COCO-style 0.5:0.05:0.95)."""
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    aps = []
    for threshold in iou_thresholds:
        ap = compute_ap(gt_box, gt_class_id, gt_mask, pred_box,
                        pred_class_id, pred_score, pred_mask,
                        iou_threshold=threshold)[0]
        aps.append(ap)
        if verbose:
            print("AP @{:.2f}:\t {:.3f}".format(threshold, ap))
    mean_ap = float(np.mean(aps))
    if verbose:
        print("AP @{:.2f}-{:.2f}:\t {:.3f}".format(
            iou_thresholds[0], iou_thresholds[-1], mean_ap))
    return mean_ap


def compute_recall(pred_boxes, gt_boxes, iou):
    """Fraction of GT boxes covered by some prediction at >= iou.
    Returns (recall, indices of covering predictions)."""
    overlaps = compute_overlaps_np(pred_boxes, gt_boxes)
    best_iou = overlaps.max(axis=1)
    covered_preds = np.nonzero(best_iou >= iou)[0]
    claimed_gts = np.unique(overlaps.argmax(axis=1)[covered_preds])
    return claimed_gts.size / gt_boxes.shape[0], covered_preds
