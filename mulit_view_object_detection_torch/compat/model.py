"""Matterport-style engine API over the PyTorch model, inference only.

Port of `mulit_view_object_detection_tpu/compat/model.py`:
`MaskRCNN(mode, config, model_dir, device=...)` with `detect(images,
Rcam, Kmat)`, `mold_inputs` / `unmold_detections` (the same contract as
the JAX engine; molding and unmolding reuse the JAX package's jax-free
`data/molding.py`), weights from the JAX package's flax variables
(`load_flax_variables`) or a seeded initialisation (`init_weights`).
"""

from __future__ import annotations

import numpy as np
import torch

from mulit_view_object_detection_tpu.data.molding import (mold_image,
                                                          resize_image,
                                                          unmold_mask)

from ..config import Config  # noqa: F401  (re-export)
from ..models.detector import MaskRCNN as _Model
from ..ops.anchors import get_anchors
from ..ops.boxes import denorm_boxes_np, norm_boxes_np
from ..ops.image_meta import compose_image_meta
from ..utils.convert import flax_to_torch


class MaskRCNN:
    """Engine wrapper. Only mode="inference" is ported."""

    def __init__(self, mode, config, model_dir, device="cpu"):
        if mode == "training":
            raise NotImplementedError(
                "training is slice 2 of the PyTorch port and is not ported "
                "yet; use mode='inference'")
        if mode != "inference":
            raise ValueError(f"mode must be 'inference', got {mode!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False")
        self.mode = mode
        self.config = config
        self.model_dir = model_dir
        self.model = _Model(config).to(self.device).eval()
        self._anchors = {}

    # ------------------------------------------------------------------ #
    # weights
    # ------------------------------------------------------------------ #
    def init_weights(self, generator):
        """Seeded initialisation (flax's default scheme) from a CPU
        torch.Generator: identical weights on every device."""
        self.model.init_weights(generator)
        return self

    def load_flax_variables(self, tree):
        """Load the JAX package's variables ({"params", "batch_stats"}
        nested dicts of numpy arrays); every parameter must match."""
        self.model.load_state_dict(flax_to_torch(tree), strict=True)
        return self

    # ------------------------------------------------------------------ #
    # molding
    # ------------------------------------------------------------------ #
    def mold_inputs(self, images):
        """images: list of [H, W, 3] uint8. Returns (molded [N, h, w, 3]
        float32, metas [N, META], windows [N, 4]) (model.py:2666-2696)."""
        cfg = self.config
        molded_images, image_metas, windows = [], [], []
        for image in images:
            molded, window, scale, _, _ = resize_image(
                image, min_dim=cfg.IMAGE_MIN_DIM, min_scale=cfg.IMAGE_MIN_SCALE,
                max_dim=cfg.IMAGE_MAX_DIM, mode=cfg.IMAGE_RESIZE_MODE)
            molded_images.append(mold_image(molded, cfg.MEAN_PIXEL))
            image_metas.append(compose_image_meta(
                0, image.shape, molded.shape, window, scale,
                np.zeros([cfg.NUM_CLASSES], dtype=np.int32)))
            windows.append(window)
        return (np.stack(molded_images), np.stack(image_metas),
                np.stack(windows))

    def unmold_detections(self, detections, mrcnn_mask, original_image_shape,
                          image_shape, window):
        """Model outputs of one image -> pixel-space (boxes, class_ids,
        scores, full masks) (model.py:2954-3017)."""
        zero_ix = np.where(detections[:, 4] == 0)[0]
        n = zero_ix[0] if zero_ix.shape[0] > 0 else detections.shape[0]

        boxes = detections[:n, :4]
        class_ids = detections[:n, 4].astype(np.int32)
        scores = detections[:n, 5]
        masks = mrcnn_mask[np.arange(n), :, :, class_ids]

        wy1, wx1, wy2, wx2 = norm_boxes_np(np.asarray(window, np.float32),
                                           image_shape[:2])
        shift = np.array([wy1, wx1, wy1, wx1])
        wh = wy2 - wy1
        ww = wx2 - wx1
        boxes = np.divide(boxes - shift, np.array([wh, ww, wh, ww]))
        boxes = denorm_boxes_np(boxes, original_image_shape[:2])

        keep = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) > 0
        boxes, class_ids = boxes[keep], class_ids[keep]
        scores, masks = scores[keep], masks[keep]

        full_masks = [unmold_mask(m, bx, original_image_shape)
                      for m, bx in zip(masks, boxes)]
        full_masks = (np.stack(full_masks, axis=-1) if full_masks
                      else np.empty(original_image_shape[:2] + (0,)))
        return boxes, class_ids, scores, full_masks

    def get_anchors(self, image_shape):
        """Normalized anchors [A, 4] on the engine's device, cached."""
        key = tuple(int(s) for s in image_shape[:2])
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(
                get_anchors(self.config, key)).to(self.device)
        return self._anchors[key]

    # ------------------------------------------------------------------ #
    # inference
    # ------------------------------------------------------------------ #
    def run_model(self, images, Rcam=None, Kmat=None):
        """Mold `images` (each a [V, H, W, 3] stack, main view first, or
        one [H, W, 3] image) and run the model. Returns (the model's
        output tensors on the device, molded shape [h, w, 3], windows
        [B, 4]) — detect() without the unmolding."""
        molded, metas, windows = [], [], []
        for item in images:
            views = np.asarray(item)
            if views.ndim == 3:
                views = views[None]
            m, meta, win = self.mold_inputs(list(views))
            molded.append(m)
            metas.append(meta[0])
            windows.append(win[0])
        molded = np.stack(molded)                     # [B, V, h, w, 3]
        b, v = molded.shape[:2]
        if Rcam is None:
            Rcam = np.tile(np.eye(3, 4, dtype=np.float32), (b, v, 1, 1))
        if Kmat is None:
            Kmat = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
        dev = self.device
        batch = {
            "images": torch.from_numpy(molded).to(dev),
            "image_meta": torch.from_numpy(np.stack(metas)).to(dev),
            "anchors": self.get_anchors(molded.shape[2:]),
            "Rcam": torch.as_tensor(np.asarray(Rcam, np.float32), device=dev),
            "Kmat": torch.as_tensor(np.asarray(Kmat, np.float32), device=dev),
        }
        return self.model(batch), molded.shape[2:5], np.stack(windows)

    def detect(self, images, Rcam=None, Kmat=None, verbose=0):
        """Run detection. For multi-view, each element of `images` is a
        [V, H, W, 3] uint8 stack whose first view is the main view; Rcam
        [B, V, 3, 4] cam->world, Kmat [B, 3, 3] (model_multi.py:
        3019-3082). Returns a list of dicts with rois/class_ids/scores/
        masks."""
        outputs, molded_shape, windows = self.run_model(images, Rcam, Kmat)
        detections = outputs["detections"].float().cpu().numpy()
        masks = outputs["mrcnn_masks"].float().cpu().numpy()
        results = []
        for i, item in enumerate(images):
            views = np.asarray(item)
            original_shape = (views if views.ndim == 3 else views[0]).shape
            rois, class_ids, scores, full_masks = self.unmold_detections(
                detections[i], masks[i], original_shape, molded_shape,
                windows[i])
            results.append({"rois": rois, "class_ids": class_ids,
                            "scores": scores, "masks": full_masks})
        return results

