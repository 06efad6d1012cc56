"""Host-side input pipeline: GT loading and multi-view batch assembly.

A copy of `mulit_view_object_detection_tpu/data/generator.py` (numpy, no
jax; the port imports nothing of the JAX package), without the
process-based prefetcher, which is not ported yet. For the same dataset
and seed it yields the same batches, bit for bit. It replaces the
reference's single-threaded Python `data_generator` (model_multi.py:
2065-2293, fit_generator workers=1) with:

  * `load_image_gt` — image + GT molding for one image
    (model_multi.py:1621-1721 semantics);
  * `make_batch` — one fixed-shape multi-view batch as a dict of numpy
    arrays keyed exactly like models.detector.MaskRCNN inputs (GT boxes
    normalized, masks instance-major [G, mh, mw], everything zero-padded to
    static shapes);
  * `BatchPrefetcher` — a thread-pool prefetch queue keeping the device
    fed.

Error tolerance matches the reference (skip bad images, raise after 5
consecutive failures, model_multi.py:2284-2293).
"""

from __future__ import annotations

import logging
import queue
import threading

import numpy as np

from ..ops.anchors import (compute_backbone_shapes, generate_pyramid_anchors)
from ..ops.boxes import extract_bboxes_np, norm_boxes_np
from ..ops.image_meta import compose_image_meta
from ..ops.targets import build_rpn_targets
from .augment import apply_augmentation
from .molding import minimize_mask, resize_image, resize_mask

log = logging.getLogger(__name__)


def load_image_gt(dataset, config, image_id, use_mini_mask=False,
                  augmentation=None, rnd=None):
    """Returns (image, image_meta, class_ids, bbox, mask[H,W,N]).

    `augmentation` is a callable `(image, mask, rng) -> (image, mask)` —
    see data.augment for built-ins (the reference takes imgaug pipelines,
    model_multi.py:1621-1695; GT boxes are re-extracted from the augmented
    mask either way, so geometry stays consistent).
    """
    image = dataset.load_image(image_id)
    mask, class_ids = dataset.load_mask(image_id)
    original_shape = image.shape
    image, window, scale, padding, crop = resize_image(
        image,
        min_dim=config.IMAGE_MIN_DIM,
        min_scale=config.IMAGE_MIN_SCALE,
        max_dim=config.IMAGE_MAX_DIM,
        mode=config.IMAGE_RESIZE_MODE)
    if mask.shape[-1] > 0:
        mask = resize_mask(mask, scale, padding, crop)
    else:
        mask = np.zeros(image.shape[:2] + (0,), dtype=bool)

    if augmentation is not None:
        rnd = rnd if rnd is not None else np.random.RandomState()
        image, mask = apply_augmentation(augmentation, image, mask, rnd)

    # drop instances whose mask was cropped away (bool any — an int sum
    # over [H, W, N] promotes to int64 and costs real milliseconds here)
    _idx = np.any(mask, axis=(0, 1))
    mask = mask[:, :, _idx]
    class_ids = class_ids[_idx]
    bbox = extract_bboxes_np(mask)

    active_class_ids = np.zeros([dataset.num_classes], dtype=np.int32)
    source_class_ids = dataset.source_class_ids[
        dataset.image_info[image_id]["source"]]
    active_class_ids[source_class_ids] = 1

    if use_mini_mask and mask.shape[-1] > 0:
        mask = minimize_mask(bbox, mask, config.MINI_MASK_SHAPE)

    image_meta = compose_image_meta(image_id, original_shape, image.shape,
                                    window, scale, active_class_ids)
    return image, image_meta, class_ids, bbox, mask


_ANCHOR_CACHE = {}


def pixel_anchors(config, image_shape):
    """Pixel-space anchor pyramid, cached per (config geometry, image
    shape) — the reference caches this too (model_multi.py:2139-2146);
    regenerating ~100k anchors per sample would starve the device."""
    # BACKBONE is part of the key: compute_backbone_shapes depends on it
    # (callable backbones / COMPUTE_BACKBONE_SHAPE overrides), and two
    # configs differing only there must not share anchors
    key = (tuple(config.RPN_ANCHOR_SCALES), tuple(config.RPN_ANCHOR_RATIOS),
           tuple(config.BACKBONE_STRIDES), config.RPN_ANCHOR_STRIDE,
           str(config.BACKBONE),
           tuple(np.asarray(image_shape).ravel()[:2]))
    if key not in _ANCHOR_CACHE:
        backbone_shapes = compute_backbone_shapes(config, image_shape)
        _ANCHOR_CACHE[key] = generate_pyramid_anchors(
            config.RPN_ANCHOR_SCALES, config.RPN_ANCHOR_RATIOS,
            backbone_shapes, config.BACKBONE_STRIDES,
            config.RPN_ANCHOR_STRIDE).astype(np.float32)
    return _ANCHOR_CACHE[key]


def _pad_to(arr, n, axis=0):
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, max(0, n - arr.shape[axis]))
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(0, n)
    return np.pad(arr, pad)[tuple(sl)]


def make_sample(dataset, config, view_ids, rnd_state=None,
                with_depth=False, augmentation=None):
    """Assemble one multi-view training sample. view_ids[0] is the main view
    (GT comes from it only, model_multi.py:2150-2153). Augmentation applies
    to the main view's image+GT only, matching the reference's
    load_image_gt call path (model_multi.py:2150-2153) — support views feed
    the projection geometry and are left untouched."""
    cfg = config
    v = len(view_ids)
    if v != cfg.NUM_VIEWS:
        # a short list would stack into a ragged batch (or leave zero
        # views); raise inside make_batch's 5-failure tolerance instead
        raise ValueError(
            f"sample has {v} views, config.NUM_VIEWS={cfg.NUM_VIEWS} "
            f"(sparse-view samples should be skipped by load_view)")
    hw = int(cfg.IMAGE_SHAPE[0])
    main_id = view_ids[0]
    rnd = np.random.RandomState(rnd_state) if rnd_state is not None else \
        np.random.RandomState()

    image, image_meta, gt_class_ids, gt_boxes_px, gt_masks = load_image_gt(
        dataset, cfg, main_id, use_mini_mask=cfg.USE_MINI_MASK,
        augmentation=augmentation, rnd=rnd)

    uint8_xfer = bool(getattr(cfg, "UINT8_IMAGE_TRANSFER", False))
    images = np.zeros((v, hw, hw, 3),
                      np.uint8 if uint8_xfer else np.float32)
    R = np.zeros((v, 3, 4), np.float32)
    # depth maps ride at the P5 feature resolution (the transformer tokens
    # are P5 pixels — model_transformer.py:2419-2438), whatever the image
    # size is.
    ds = hw // cfg.BACKBONE_STRIDES[3]
    depths = (np.zeros((v, ds, ds), np.float32) if with_depth else None)
    # mold straight into the preallocated batch slot: one fused
    # subtract-with-cast instead of astype + subtract + copy
    mean_pixel = np.asarray(cfg.MEAN_PIXEL, np.float32)
    if uint8_xfer:
        # raw resized pixels; the device graph de-molds (detector.py) —
        # bit-identical since resize_image hands back uint8 either way.
        # Augmenters may return FLOAT images though, and an astype here
        # would silently truncate/wrap pixels — same guard as
        # compat.MaskRCNN.mold_inputs' uint8_ok check.
        if image.dtype != np.uint8:
            raise TypeError(
                f"UINT8_IMAGE_TRANSFER requires uint8 images end-to-end "
                f"but the (possibly augmented) main view is "
                f"{image.dtype}; return uint8 from the augmenter or "
                f"disable UINT8_IMAGE_TRANSFER")
        images[0] = image
    else:
        np.subtract(image, mean_pixel, out=images[0], casting="unsafe")
    R[0] = dataset.load_R(main_id)
    if with_depth:
        depths[0] = dataset.load_depth(main_id, cfg)
    for i, vid in enumerate(view_ids[1:], start=1):
        im = dataset.load_image(vid)
        im, _, _, _, _ = resize_image(
            im, min_dim=cfg.IMAGE_MIN_DIM, min_scale=cfg.IMAGE_MIN_SCALE,
            max_dim=cfg.IMAGE_MAX_DIM, mode=cfg.IMAGE_RESIZE_MODE)
        if uint8_xfer:
            if im.dtype != np.uint8:
                raise TypeError(
                    f"UINT8_IMAGE_TRANSFER requires uint8 images but "
                    f"dataset.load_image returned {im.dtype}")
            images[i] = im
        else:
            np.subtract(im, mean_pixel, out=images[i], casting="unsafe")
        R[i] = dataset.load_R(vid)
        if with_depth:
            depths[i] = dataset.load_depth(vid, cfg)

    # RPN targets (host-side numpy, model_multi.py:2191-2192)
    anchors = pixel_anchors(cfg, cfg.IMAGE_SHAPE)
    rpn_match, rpn_bbox = build_rpn_targets(
        anchors, gt_class_ids, gt_boxes_px.astype(np.float32), cfg,
        rnd_state=rnd)

    g = cfg.MAX_GT_INSTANCES
    n_inst = min(gt_class_ids.shape[0], g)
    gt_boxes_n = norm_boxes_np(gt_boxes_px.astype(np.float32), (hw, hw))
    mh, mw = (cfg.MINI_MASK_SHAPE if cfg.USE_MINI_MASK else (hw, hw))
    masks_gm = np.zeros((g, mh, mw), np.float32)
    if n_inst:
        # [H, W, N] -> instance-major [N, h, w]
        masks_gm[:n_inst] = np.transpose(
            gt_masks[:, :, :n_inst], (2, 0, 1)).astype(np.float32)

    sample = {
        "images": images,
        "image_meta": image_meta,
        "rpn_match": rpn_match.astype(np.int32),
        "rpn_bbox": rpn_bbox.astype(np.float32),
        "gt_class_ids": _pad_to(gt_class_ids.astype(np.int32), g),
        "gt_boxes": _pad_to(gt_boxes_n[:n_inst], g),
        "gt_masks": masks_gm,
        "Rcam": R,
        "Kmat": getattr(dataset, "K", np.eye(3)).astype(np.float32),
    }
    if with_depth:
        sample["depths"] = depths
    return sample


def make_batch(dataset, config, rnd_state=None, with_depth=False,
               keys=None, augmentation=None, batch_size=None):
    """One batch of multi-view samples + normalized anchors. `batch_size`
    defaults to config.BATCH_SIZE; multi-host training passes the per-host
    share instead (parallel.mesh.host_local_batch_slice)."""
    from ..ops.anchors import get_anchors

    cfg = config
    batch_size = batch_size if batch_size is not None else cfg.BATCH_SIZE
    rnd = np.random.RandomState(rnd_state)
    keys = keys if keys is not None else list(dataset.view_map.keys())
    samples = []
    errors = 0
    while len(samples) < batch_size:
        try:
            key = keys[rnd.randint(len(keys))]
            view_ids = dataset.load_view(cfg.NUM_VIEWS, key,
                                         rnd_state=rnd.randint(2 ** 31))
            if view_ids is None:
                continue
            samples.append(make_sample(dataset, cfg, view_ids,
                                       rnd_state=rnd.randint(2 ** 31),
                                       with_depth=with_depth,
                                       augmentation=augmentation))
            errors = 0
        except Exception:  # noqa: BLE001 — reference behavior
            errors += 1
            log.exception("error building sample")
            if errors > 5:
                raise
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    batch["anchors"] = get_anchors(cfg, cfg.IMAGE_SHAPE).astype(np.float32)
    return batch


class BatchPrefetcher:
    """Thread-pool batch prefetcher — keeps the device fed
    (the answer to fit_generator workers=1).

    Failure contract: `make_fn` (make_batch) already absorbs transient
    per-sample errors and raises only after 5 CONSECUTIVE failures
    (reference model_multi.py:2284-2293) — a systematic problem. Such an
    exception is terminal: the worker pushes it through the queue and
    the consumer re-raises as PrefetchError instead of blocking forever
    on an empty queue while workers silently spin."""

    _ERROR = object()   # queue sentinel, paired with self._error_tb

    def __init__(self, make_fn, num_threads=4, prefetch=8, seed=0):
        self._queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._seed = seed
        self._seed_lock = threading.Lock()
        self._make_fn = make_fn
        self._error_tb = None
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def _next_seed(self):
        with self._seed_lock:
            self._seed += 1
            return self._seed

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self._make_fn(self._next_seed())
            except Exception:
                log.exception("prefetch worker failed (terminal)")
                import traceback
                self._error_tb = traceback.format_exc()
                batch = self._ERROR
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if batch is self._ERROR:
                return

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._ERROR:
            self._stop.set()
            raise PrefetchError(
                "prefetch worker failed:\n" + (self._error_tb or ""))
        return item

    def close(self):
        """Stop the workers and wait for each to finish its batch."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60.0)


class PrefetchError(RuntimeError):
    """Raised by BatchPrefetcher when its workers can no longer produce
    batches (a worker hit the consecutive-failure cap)."""
