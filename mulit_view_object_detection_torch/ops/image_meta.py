"""Image-meta codec: a flat float vector carrying per-image molding info.

A copy of `mulit_view_object_detection_tpu/ops/image_meta.py`, not an
import of it: importing any module under that `ops` package runs its
`__init__`, which imports jax, and this port never imports jax.

Layout (model.py:2732-2802):
  [image_id(1), original_shape(3), image_shape(3), window(4, pixel y1x1y2x2),
   scale(1), active_class_ids(NUM_CLASSES)]
"""

from __future__ import annotations

import numpy as np


def compose_image_meta(image_id, original_image_shape, image_shape, window,
                       scale, active_class_ids):
    return np.array(
        [image_id]
        + list(original_image_shape)
        + list(image_shape)
        + list(window)
        + [scale]
        + list(active_class_ids),
        dtype=np.float32)


def parse_image_meta(meta):
    """meta: [..., META_SIZE] (numpy array or tensor). Returns slices."""
    return {
        "image_id": meta[..., 0],
        "original_image_shape": meta[..., 1:4],
        "image_shape": meta[..., 4:7],
        "window": meta[..., 7:11],
        "scale": meta[..., 11],
        "active_class_ids": meta[..., 12:],
    }
