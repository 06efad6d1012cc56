"""Anchor pyramid generation (host-side numpy).

A copy of `mulit_view_object_detection_tpu/ops/anchors.py`, not an
import of it: importing any module under that `ops` package runs its
`__init__`, which imports jax, and this port never imports jax.

Semantics match mrcnn/utils.py:842-898 and model_multi.py:89-103: one
scale per FPN level, all ratios per cell, boxes [y1, x1, y2, x2].
"""

from __future__ import annotations

import math

import numpy as np


def compute_backbone_shapes(config, image_shape):
    """[(h, w)] per backbone stage (model_multi.py:89-103)."""
    assert config.BACKBONE in ("resnet50", "resnet101")
    return np.array([
        [int(math.ceil(image_shape[0] / stride)),
         int(math.ceil(image_shape[1] / stride))]
        for stride in config.BACKBONE_STRIDES
    ])


def generate_anchors(scales, ratios, shape, feature_stride, anchor_stride):
    """All anchors for one feature-map level (utils.py:842-878)."""
    scales, ratios = np.meshgrid(np.array(scales), np.array(ratios))
    scales = scales.flatten()
    ratios = ratios.flatten()

    heights = scales / np.sqrt(ratios)
    widths = scales * np.sqrt(ratios)

    shifts_y = np.arange(0, shape[0], anchor_stride) * feature_stride
    shifts_x = np.arange(0, shape[1], anchor_stride) * feature_stride
    shifts_x, shifts_y = np.meshgrid(shifts_x, shifts_y)

    box_widths, box_centers_x = np.meshgrid(widths, shifts_x)
    box_heights, box_centers_y = np.meshgrid(heights, shifts_y)

    box_centers = np.stack([box_centers_y, box_centers_x],
                           axis=2).reshape([-1, 2])
    box_sizes = np.stack([box_heights, box_widths], axis=2).reshape([-1, 2])

    return np.concatenate(
        [box_centers - 0.5 * box_sizes, box_centers + 0.5 * box_sizes],
        axis=1)


def generate_pyramid_anchors(scales, ratios, feature_shapes, feature_strides,
                             anchor_stride):
    """Anchors over all pyramid levels, concatenated in level order
    (utils.py:881-898). Returns [anchor_count, (y1, x1, y2, x2)]."""
    return np.concatenate([
        generate_anchors(scales[i], ratios, feature_shapes[i],
                         feature_strides[i], anchor_stride)
        for i in range(len(scales))], axis=0)


def get_anchors(config, image_shape):
    """Normalized anchor pyramid [A, 4] float32 for an image shape, with
    the (h-1, w-1) convention (utils.py:1112-1126). Callers cache it."""
    a = generate_pyramid_anchors(
        config.RPN_ANCHOR_SCALES, config.RPN_ANCHOR_RATIOS,
        compute_backbone_shapes(config, image_shape),
        config.BACKBONE_STRIDES, config.RPN_ANCHOR_STRIDE)
    h, w = image_shape[:2]
    scale = np.array([h - 1, w - 1, h - 1, w - 1])
    shift = np.array([0, 0, 1, 1])
    return ((a - shift) / scale).astype(np.float32)
