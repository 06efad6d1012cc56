"""Visualization: matplotlib rendering of detections and masks.

A numpy + matplotlib copy of `mulit_view_object_detection_tpu/utils/
visualize.py` (the port imports nothing of the JAX package), with the
reference's API (mrcnn/visualize.py): display_images (:32-53),
display_instances (:80-150), draw_rois (:154-214), draw_box (:216),
display_detections (:228-284), display_top_masks (:286-306),
plot_precision_recall (:309), plot_overlaps (:323-360), draw_boxes
(:362), display_table / display_weight_stats (:464/478), headless
save_image (:506-595). Every function takes numpy arrays or tensors;
a tensor is moved to the host where it enters (`_host`). matplotlib
renders on its Agg backend; save_image draws with OpenCV where
matplotlib is not installed. display_weight_stats takes the port's
state_dict where the JAX function takes a flax tree.
"""

from __future__ import annotations

import colorsys
import importlib.util
import os
import random

import numpy as np


def _host(x):
    """A tensor as a numpy array on the host; anything else as it is."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        return x.detach().cpu().numpy()
    return x


def _hue_palette(n, brightness):
    """n maximally-separated hues at fixed saturation/value."""
    return [colorsys.hsv_to_rgb(i / n, 1, brightness) for i in range(n)]


def random_colors(n, bright=True):
    colors = _hue_palette(n, 1.0 if bright else 0.7)
    random.shuffle(colors)
    return colors


def fixed_colors(n, bright=True, seed=0):
    """Deterministic variant for reproducible renders."""
    colors = _hue_palette(n, 1.0 if bright else 0.7)
    random.Random(seed).shuffle(colors)
    return colors


def apply_mask(image, mask, color, alpha=0.5):
    """Alpha-blend a binary mask into an image, vectorized over channels."""
    image, mask = _host(image), _host(mask)
    rgb = np.asarray(color, dtype=np.float32) * 255.0
    on = np.asarray(mask)[..., None] == 1
    blended = image * (1 - alpha) + alpha * rgb
    return np.where(on, blended, image).astype(image.dtype)


def _axes(ax, figsize):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    if ax is not None:
        return ax
    return plt.subplots(1, figsize=figsize)[1]


def _box_patch(box, color, linewidth=2, style="solid", alpha=1.0):
    from matplotlib import patches
    y1, x1, y2, x2 = box[:4]
    return patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                             linewidth=linewidth, alpha=alpha,
                             linestyle=style, edgecolor=color,
                             facecolor="none")


def display_instances(image, boxes, masks, class_ids, class_names,
                      scores=None, title="", figsize=(16, 16), ax=None,
                      show_mask=True, show_bbox=True, colors=None,
                      captions=None):
    """Draw detections on an image; returns the matplotlib axis."""
    image, boxes, masks, class_ids, scores = map(
        _host, (image, boxes, masks, class_ids, scores))
    n = boxes.shape[0]
    if not n:
        print("\n*** No instances to display *** \n")
    else:
        assert boxes.shape[0] == masks.shape[-1] == class_ids.shape[0]

    ax = _axes(ax, figsize)
    colors = colors or random_colors(max(n, 1))
    height, width = image.shape[:2]
    ax.set_ylim(height + 10, -10)
    ax.set_xlim(-10, width + 10)
    ax.axis("off")
    ax.set_title(title)

    canvas = image.astype(np.uint32).copy()
    for i in range(n):
        if not np.any(boxes[i]):
            continue  # padded slot
        color = colors[i % len(colors)]
        if show_bbox:
            ax.add_patch(_box_patch(boxes[i], color, style="dashed",
                                    alpha=0.7))
        if captions is not None:
            caption = captions[i]
        else:
            label = class_names[class_ids[i]]
            score = scores[i] if scores is not None else None
            caption = f"{label} {score:.3f}" if score else label
        ax.text(boxes[i][1], boxes[i][0] + 8, caption, color="w", size=11,
                backgroundcolor="none")
        if show_mask:
            canvas = apply_mask(canvas, masks[:, :, i], color)
    ax.imshow(canvas.astype(np.uint8))
    return ax


def draw_box(image, box, color):
    """2px solid box drawn in place on a numpy image."""
    y1, x1, y2, x2 = _host(box)
    image[y1:y1 + 2, x1:x2] = color
    image[y2:y2 + 2, x1:x2] = color
    image[y1:y2, x1:x1 + 2] = color
    image[y1:y2, x2:x2 + 2] = color
    return image


def save_image(image, image_name, boxes, masks, class_ids, scores,
               class_names, filter_classs_names=None, scores_thresh=0.1,
               save_dir=None, mode=0):
    """Headless render to <save_dir>/<image_name>.jpg. mode: 0 box+mask+
    label, 1 box+label, 2 box only, 3 mask only. (The misspelled
    `filter_classs_names` kwarg is kept for reference API parity.)

    Drawn with matplotlib as the JAX package draws (the same pixels);
    where matplotlib is not installed, with OpenCV alone: the same
    masks, 2-pixel boxes and captions at the image's own size."""
    assert mode in (0, 1, 2, 3)
    image, boxes, masks, class_ids, scores = map(
        _host, (image, boxes, masks, class_ids, scores))
    save_dir = save_dir or os.getcwd()
    os.makedirs(save_dir, exist_ok=True)

    # instance selection: drop padded slots, filtered classes, low scores
    selected = []
    for i in range(boxes.shape[0]):
        if not np.any(boxes[i]):
            continue
        label = class_names[class_ids[i]]
        if filter_classs_names and label not in filter_classs_names:
            continue
        if scores is not None and scores[i] < scores_thresh:
            continue
        selected.append(i)

    colors = fixed_colors(max(len(selected), 1))
    canvas = image.astype(np.uint32).copy()
    if mode != 2:  # modes with masks
        for slot, i in enumerate(selected):
            canvas = apply_mask(canvas, masks[:, :, i], colors[slot])
    captions = [f"{class_names[class_ids[i]]} {scores[i]:.3f}"
                if scores is not None else class_names[class_ids[i]]
                for i in selected]
    path = os.path.join(save_dir, f"{image_name}.jpg")
    if importlib.util.find_spec("matplotlib") is None:
        _save_cv2(path, canvas.astype(np.uint8), boxes[selected], colors,
                  captions if mode in (0, 1) else None, mode != 3)
        return path

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, figsize=(8, 8))
    ax.axis("off")
    ax.imshow(canvas.astype(np.uint8))
    if mode != 3:  # modes with boxes
        for slot, i in enumerate(selected):
            ax.add_patch(_box_patch(boxes[i], colors[slot]))
            if mode != 2:
                ax.text(boxes[i][1], boxes[i][0] + 8, captions[slot],
                        color="w", size=11)
    fig.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return path


def _save_cv2(path, canvas, boxes, colors, captions, with_boxes):
    """save_image without matplotlib: RGB `canvas` with each box in its
    colour and its caption in white, written as a JPEG."""
    import cv2

    out = np.ascontiguousarray(canvas[..., ::-1])           # BGR
    for slot, (y1, x1, y2, x2) in enumerate(np.asarray(boxes).astype(int)):
        bgr = tuple(int(round(255 * c)) for c in colors[slot][::-1])
        if with_boxes:
            cv2.rectangle(out, (x1, y1), (x2, y2), bgr, 2)
        if captions is not None:
            cv2.putText(out, captions[slot], (x1, y1 + 8),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1)
    if not cv2.imwrite(path, out):
        raise OSError(f"cv2 could not write {path}")


def draw_boxes(image, boxes=None, refined_boxes=None, masks=None,
               captions=None, visibilities=None, title="", ax=None):
    """Debug renderer: anchors/proposals/refinements in one frame.
    visibility 0 = gray dotted, 1 = color dotted, 2+ = color solid."""
    image, boxes, refined_boxes, masks = map(
        _host, (image, boxes, refined_boxes, masks))
    n = max(boxes.shape[0] if boxes is not None else 0,
            refined_boxes.shape[0] if refined_boxes is not None else 0)
    ax = _axes(ax, (12, 12))
    colors = random_colors(max(n, 1))
    margin = image.shape[0] // 10
    ax.set_ylim(image.shape[0] + margin, -margin)
    ax.set_xlim(-margin, image.shape[1] + margin)
    ax.axis("off")
    ax.set_title(title)

    canvas = image.astype(np.uint32).copy()
    for i in range(n):
        visibility = visibilities[i] if visibilities is not None else 1
        if visibility == 0:
            color, style, alpha = "gray", "dotted", 0.5
        else:
            color = colors[i]
            style = "dotted" if visibility == 1 else "solid"
            alpha = 1
        if boxes is not None and np.any(boxes[i]):
            ax.add_patch(_box_patch(boxes[i], color, style=style,
                                    alpha=alpha))
        if refined_boxes is not None and visibility > 0:
            ax.add_patch(_box_patch(refined_boxes[i].astype(np.int32),
                                    color))
        if captions is not None and i < len(captions):
            x, y = (boxes[i][1], boxes[i][0]) if boxes is not None \
                else (10, 10)
            ax.text(x, y, captions[i], size=11, color="w",
                    backgroundcolor="none")
        if masks is not None and i < masks.shape[-1]:
            canvas = apply_mask(canvas, masks[:, :, i], colors[i])
    ax.imshow(canvas.astype(np.uint8))
    return ax


def display_images(images, titles=None, cols=4, cmap=None, norm=None,
                   interpolation=None):
    """Grid layout of images with optional titles (visualize.py:32-53)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = [_host(img) for img in images]
    titles = titles if titles is not None else [""] * len(images)
    rows = (len(images) + cols - 1) // cols
    fig = plt.figure(figsize=(14, 14 * rows // max(cols, 1)))
    for slot, (img, label) in enumerate(zip(images, titles), start=1):
        ax = fig.add_subplot(rows, cols, slot)
        ax.set_title(label, fontsize=9)
        ax.axis("off")
        ax.imshow(img.astype(np.uint8), cmap=cmap, norm=norm,
                  interpolation=interpolation)
    return fig


def draw_rois(image, rois, refined_rois, mask, class_ids, class_names,
              limit=10):
    """Training-debug view of sampled ROIs (visualize.py:154-214): a random
    subset of `limit` ROIs, each drawn dotted at its proposal position; the
    positives (class_id > 0) additionally get a solid refined box, an arrow
    between the two, and their target mask blended in."""
    image, rois, refined_rois, mask, class_ids = map(
        _host, (image, rois, refined_rois, mask, class_ids))
    ax = _axes(None, (18, 18))
    sample = np.arange(rois.shape[0])
    if rois.shape[0] > limit:
        sample = np.random.choice(sample, limit, replace=False)
    n_pos = int(np.sum(class_ids > 0))
    print(f"{rois.shape[0]} rois, {n_pos} positive "
          f"(showing {len(sample)})")

    margin = image.shape[0] // 10
    ax.set_ylim(image.shape[0] + margin, -margin)
    ax.set_xlim(-margin, image.shape[1] + margin)
    ax.axis("off")
    ax.set_title(f"ROIs sampled for training ({len(sample)} of "
                 f"{rois.shape[0]})")

    colors = random_colors(len(sample))
    canvas = image.astype(np.uint32).copy()
    for slot, i in enumerate(sample):
        color = colors[slot]
        is_pos = class_ids[i] > 0
        ax.add_patch(_box_patch(rois[i], color if is_pos else "gray",
                                style="dashed",
                                alpha=1.0 if is_pos else 0.5))
        if is_pos:
            y1, x1, y2, x2 = refined_rois[i].astype(np.int32)
            ax.add_patch(_box_patch((y1, x1, y2, x2), color))
            ax.annotate("", (x1, y1), xytext=(rois[i][1], rois[i][0]),
                        arrowprops=dict(color=color, arrowstyle="-"))
            label = class_names[class_ids[i]]
            ax.text(x1, y1 + 8, label, color="w", size=11,
                    backgroundcolor="none")
            if mask is not None:
                canvas = apply_mask(canvas, mask[:, :, i], color)
    ax.imshow(canvas.astype(np.uint8))
    return ax


def display_detections(image, gt_boxes, boxes, masks, class_ids,
                       class_names, scores=None):
    """Detections with dashed boxes, labels, blended masks and mask contour
    polygons (visualize.py:228-284). gt_boxes is accepted for reference API
    parity but, as in the reference, not rendered."""
    from matplotlib.patches import Polygon
    try:
        from skimage.measure import find_contours
    except ImportError:
        find_contours = None

    image, boxes, masks, class_ids, scores = map(
        _host, (image, boxes, masks, class_ids, scores))
    assert boxes.shape[0] == masks.shape[-1] == class_ids.shape[0]
    ax = _axes(None, (20, 20))
    n = boxes.shape[0]
    colors = random_colors(max(n, 1))
    height, width = image.shape[:2]
    ax.set_ylim(height + 10, -10)
    ax.set_xlim(-10, width + 10)
    ax.axis("off")

    canvas = image.astype(np.uint32).copy()
    for i in range(n):
        if not np.any(boxes[i]):
            continue  # padded slot
        color = colors[i]
        ax.add_patch(_box_patch(boxes[i], color, style="dashed", alpha=0.7))
        label = class_names[class_ids[i]]
        caption = (f"{label} {scores[i]:.3f}" if scores is not None
                   else label)
        ax.text(boxes[i][1], boxes[i][0] + 8, caption, color="w", size=11,
                backgroundcolor="none")
        canvas = apply_mask(canvas, masks[:, :, i], color)
        if find_contours is not None:
            # contours on a 1px-padded mask so edge-touching masks close
            framed = np.zeros(
                (masks.shape[0] + 2, masks.shape[1] + 2), np.uint8)
            framed[1:-1, 1:-1] = masks[:, :, i]
            for contour in find_contours(framed, 0.5):
                ax.add_patch(Polygon(np.fliplr(contour) - 1,
                                     facecolor="none", edgecolor=color))
    ax.imshow(canvas.astype(np.uint8))
    return ax


def display_top_masks(image, mask, class_ids, class_names, limit=4):
    """The image plus per-class union masks for the `limit` classes with the
    largest total mask area (visualize.py:286-306). Each panel sums the
    class's instance masks weighted by instance index so instances remain
    distinguishable under a sequential colormap."""
    image, mask, class_ids = map(_host, (image, mask, class_ids))
    panels = [image]
    titles = [f"H x W={image.shape[0]}x{image.shape[1]}"]
    present = np.unique(class_ids)
    areas = {c: int(mask[:, :, class_ids == c].sum()) for c in present}
    ranked = [c for c in sorted(present, key=lambda c: -areas[c])
              if areas[c] > 0]
    for slot in range(limit):
        cid = ranked[slot] if slot < len(ranked) else -1
        m = mask[:, :, class_ids == cid] if cid != -1 \
            else np.zeros(mask.shape[:2] + (0,), mask.dtype)
        panels.append(np.sum(m * np.arange(1, m.shape[-1] + 1), -1))
        titles.append(class_names[cid] if cid != -1 else "-")
    return display_images(panels, titles=titles, cols=limit + 1,
                          cmap="Blues_r")


def plot_overlaps(gt_class_ids, pred_class_ids, pred_scores, overlaps,
                  class_names, threshold=0.5):
    """IoU matrix heatmap between predictions (rows) and ground truth
    (columns) with match/wrong annotations (visualize.py:323-360)."""
    import itertools
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gt_class_ids, pred_class_ids, pred_scores, overlaps = map(
        _host, (gt_class_ids, pred_class_ids, pred_scores, overlaps))
    gt_class_ids = gt_class_ids[gt_class_ids != 0]
    pred_class_ids = pred_class_ids[pred_class_ids != 0]

    fig = plt.figure(figsize=(12, 10))
    plt.imshow(overlaps, interpolation="nearest", cmap=plt.cm.Blues)
    plt.yticks(np.arange(len(pred_class_ids)),
               [f"{class_names[int(c)]} ({pred_scores[i]:.2f})"
                for i, c in enumerate(pred_class_ids)])
    plt.xticks(np.arange(len(gt_class_ids)),
               [class_names[int(c)] for c in gt_class_ids], rotation=90)

    mid = overlaps.max() / 2.0
    for r, c in itertools.product(range(overlaps.shape[0]),
                                  range(overlaps.shape[1])):
        verdict = ""
        if overlaps[r, c] > threshold:
            verdict = ("match" if gt_class_ids[c] == pred_class_ids[r]
                       else "wrong")
        shade = ("white" if overlaps[r, c] > mid
                 else "black" if overlaps[r, c] > 0 else "grey")
        plt.text(c, r, f"{overlaps[r, c]:.3f}\n{verdict}",
                 horizontalalignment="center", verticalalignment="center",
                 fontsize=9, color=shade)
    plt.tight_layout()
    plt.xlabel("Ground Truth")
    plt.ylabel("Predictions")
    return fig


def plot_precision_recall(AP, precisions, recalls):
    """PR curve for one AP evaluation."""
    precisions, recalls = _host(precisions), _host(recalls)
    ax = _axes(None, None)
    ax.set_title(f"Precision-Recall Curve. AP@50 = {AP:.3f}")
    ax.set_ylim(0, 1.1)
    ax.set_xlim(0, 1.1)
    ax.plot(recalls, precisions)
    return ax


def display_table(table):
    """Plain-text table (the reference renders HTML in IPython)."""
    for row in table:
        print(" | ".join(str(cell) for cell in row))


def display_weight_stats(state_dict):
    """Weight statistics table over the port's state_dict: name, shape,
    min, max, std. Returns the table."""
    table = [["WEIGHT NAME", "SHAPE", "MIN", "MAX", "STD"]]
    for name, leaf in state_dict.items():
        # a bfloat16 tensor has no numpy form: float32, as flax keeps it
        leaf = np.asarray(_host(leaf.float() if hasattr(leaf, "float")
                                else leaf))
        table.append([name, str(leaf.shape), f"{leaf.min():+10.4f}",
                      f"{leaf.max():+10.4f}", f"{leaf.std():+9.4f}"])
    display_table(table)
    return table
