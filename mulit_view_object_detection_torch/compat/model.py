"""Matterport-style engine API over the PyTorch model: inference and
training.

Port of `mulit_view_object_detection_tpu/compat/model.py`:
`MaskRCNN(mode, config, model_dir, device="cuda")` with `detect(images,
Rcam, Kmat, depths)`, `detect_molded`, `run_graph` and `ancestor`,
`mold_inputs` / `unmold_detections` (the JAX engine's contract; molding
from the port's numpy copy `data/molding.py`, or on the device with
UINT8_IMAGE_TRANSFER),
`train(...)` (with per-epoch JSONL and TensorBoard scalars in `log_dir`),
`save_weights` / `load_weights` (checkpoint directories, and Keras .h5
files by layer name), `find_last` and `set_log_dir`. The engine runs on
the card unless the caller asks for the CPU. Weights start from flax's
initialisation scheme drawn from seed 0 (the JAX engine starts from
PRNGKey(0)), and can come from the JAX package's flax variables
(`load_flax_variables`) or a seeded `init_weights`. With FOLD_BN the
inference calls run a BN-folded copy of the model (`inference_model`);
training and `save_weights` keep the unfolded one. In a data-parallel
run (`parallel.init_distributed` called before the engine is built),
`train` trains on every process together (see its docstring).
"""

from __future__ import annotations

import copy
import datetime
import itertools
import logging
import os
import re

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config  # noqa: F401  (re-export)
from ..data.generator import BatchPrefetcher, make_batch
from ..data.molding import mold_image, resize_image, unmold_mask
from ..models.detector import MaskRCNN as _Model
from ..ops.anchors import get_anchors
from ..ops.boxes import denorm_boxes_np, norm_boxes_np
from ..ops.image_meta import compose_image_meta
from ..parallel.distributed import (broadcast_module, data_parallel_group,
                                    host_local_batch_slice)
from ..train.checkpoint import (latest_step, restore_checkpoint,
                                save_checkpoint)
from ..train.optim import make_optimizer
from ..train.step import train_step, val_step
from ..train.trainable import trainable_mask
from ..utils.bn_fold import fold_bn_model
from ..utils.convert import flax_to_torch
from ..utils.logging_utils import MetricsLogger, TBEventWriter

log = logging.getLogger(__name__)

# batch keys the device needs, with their dtypes (anchors are shared)
_BATCH_DTYPES = {"images": torch.float32, "image_meta": torch.float32,
                 "anchors": torch.float32, "Rcam": torch.float32,
                 "Kmat": torch.float32, "rpn_match": torch.int64,
                 "rpn_bbox": torch.float32, "gt_class_ids": torch.int64,
                 "gt_boxes": torch.float32, "gt_masks": torch.float32,
                 "depths": torch.float32}


class MaskRCNN:
    """Engine wrapper: mode in {"training", "inference"}."""

    def __init__(self, mode, config, model_dir, device="cuda"):
        if mode not in ("training", "inference"):
            raise ValueError(
                f"mode must be 'training' or 'inference', got {mode!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run on the CPU")
        self.mode = mode
        self.config = config
        self.model_dir = model_dir
        model = _Model(config)
        model.init_weights(torch.Generator().manual_seed(0))
        self.model = model.to(self.device).eval()
        self.epoch = 0
        self._anchors = {}
        self._folded = None          # (weights' versions, folded copy)
        # ROI sampling priorities of the train and validation steps
        self._sampling = torch.Generator(self.device).manual_seed(0)
        self.set_log_dir()

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

    def load_weights(self, filepath, by_name=True, exclude=None):
        """Load a Keras `.h5` file or a checkpoint directory.

        An h5 file merges by layer name (the reference's
        model.load_weights("mask_rcnn_coco.h5", by_name=True,
        exclude=[...]), model.py:2102-2144): `exclude` lists keras layer
        names, inner or saved, whose weights stay as they are; the
        importer's report (loaded, skipped, excluded layers) is kept in
        `last_h5_report`, and the epoch count is untouched.

        A checkpoint directory written by `save_weights` or `train` loads
        its latest step and resumes the epoch count from it, as the
        reference's load_weights does (model_multi.py:2642); there
        `exclude` keeps the current weights of those top-level modules."""
        if str(filepath).endswith((".h5", ".hdf5")):
            from ..utils.h5_import import load_h5_state_dict
            state, self.last_h5_report = load_h5_state_dict(
                filepath, self.model.state_dict(), exclude=exclude)
            self.model.load_state_dict(state, strict=True)
            return self
        keep = {k: v.clone() for k, v in self.model.state_dict().items()
                if exclude and k.split(".", 1)[0] in exclude}
        if restore_checkpoint(filepath, self.model) is None:
            raise FileNotFoundError(f"no checkpoint in {filepath}")
        if keep:
            self.model.load_state_dict(keep, strict=False)
        self.set_log_dir(filepath)
        return self

    def save_weights(self, filepath, step=None):
        """Save the weights as step `step` (default: the epoch count) of
        the checkpoint directory `filepath`."""
        return save_checkpoint(filepath, self.model,
                               step=self.epoch if step is None else step)

    def find_last(self):
        """Newest checkpoint directory under model_dir (model.py:
        2073-2100)."""
        if os.path.isdir(self.model_dir):
            names = [d for d in sorted(os.listdir(self.model_dir))
                     if d.startswith((self.config.NAME or "").lower())]
            for d in reversed(names):
                ckpt = os.path.join(self.model_dir, d, "checkpoints")
                if latest_step(ckpt) is not None:
                    return ckpt
        ckpt = os.path.join(self.log_dir, "checkpoints")
        if latest_step(ckpt) is not None:
            return ckpt
        raise FileNotFoundError(
            f"Could not find weight files in {self.model_dir}")

    def set_log_dir(self, model_path=None):
        """Epoch and log-directory bookkeeping (model.py:2245-2281): the
        epoch is the checkpoint step of `model_path`, if it names one."""
        self.epoch = 0
        if model_path is not None:
            step = latest_step(model_path)
            if step is not None:
                self.epoch = int(step)
        name = (self.config.NAME or "maskrcnn").lower()
        self.log_dir = os.path.join(
            self.model_dir,
            "{}{:%Y%m%dT%H%M}".format(name, datetime.datetime.now()))
        self.checkpoint_dir = os.path.join(self.log_dir, "checkpoints")

    # ------------------------------------------------------------------ #
    # molding
    # ------------------------------------------------------------------ #
    def mold_inputs(self, images):
        """images: list of [H, W, 3] uint8. Returns (molded [N, h, w, 3],
        metas [N, META], windows [N, 4]) (model.py:2666-2696). Molded is
        float32, mean-subtracted; with UINT8_IMAGE_TRANSFER and every
        image uint8 it is the resized uint8 pixels, which the model
        de-molds on the device (4x fewer bytes to the card)."""
        cfg = self.config
        molded_images, image_metas, windows = [], [], []
        for image in images:
            molded, window, scale, _, _ = resize_image(
                image, min_dim=cfg.IMAGE_MIN_DIM, min_scale=cfg.IMAGE_MIN_SCALE,
                max_dim=cfg.IMAGE_MAX_DIM, mode=cfg.IMAGE_RESIZE_MODE)
            molded_images.append(molded)
            image_metas.append(compose_image_meta(
                0, image.shape, molded.shape, window, scale,
                np.zeros([cfg.NUM_CLASSES], dtype=np.int32)))
            windows.append(window)
        # a whole-batch decision: the model de-molds by the batch's dtype,
        # so one float image sends every image through host molding
        if not (cfg.UINT8_IMAGE_TRANSFER
                and all(m.dtype == np.uint8 for m in molded_images)):
            molded_images = [mold_image(m, cfg.MEAN_PIXEL)
                             for m in molded_images]
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
    def inference_model(self):
        """The model that detect, detect_molded and run_graph run. With
        FOLD_BN a copy of the model with its BatchNorms folded
        (utils/bn_fold.py), made on the engine's device (a second set of
        weights there) and made again whenever a weight of the model has
        changed since (load_weights, load_flax_variables, init_weights,
        train, or any other in-place write); else the model itself, and
        with TRAIN_BN and BN_EVAL_BATCH_STATS too (a folded BatchNorm
        has no batch statistics)."""
        cfg = self.config
        if not cfg.FOLD_BN or (cfg.TRAIN_BN and getattr(
                cfg, "BN_EVAL_BATCH_STATS", False)):
            return self.model
        key = tuple((id(t), t._version) for t in itertools.chain(
            self.model.parameters(), self.model.buffers()))
        if self._folded is None or self._folded[0] != key:
            self._folded = None                   # one copy on the card
            # the copy shares the config: a later edit reaches both
            folded = copy.deepcopy(self.model,
                                   {id(self.config): self.config})
            fold_bn_model(folded)
            self._folded = (key, folded)
        return self._folded[1]

    def _mold_batch(self, images):
        """images: each a [V, H, W, 3] stack (main view first) or one
        [H, W, 3] image -> (molded [B, V, h, w, 3], metas [B, META],
        windows [B, 4]), each scene's meta and window those of its main
        view. Every view of every scene is molded in one mold_inputs
        call, so UINT8_IMAGE_TRANSFER decides for the whole batch."""
        scenes = [np.asarray(item) for item in images]
        scenes = [s[None] if s.ndim == 3 else s for s in scenes]
        if len({len(s) for s in scenes}) != 1:
            raise ValueError("every scene of a batch needs the same number "
                             "of views")
        molded, metas, windows = self.mold_inputs(
            [view for s in scenes for view in s])
        v = len(scenes[0])
        return (molded.reshape(len(scenes), v, *molded.shape[1:]),
                metas[::v], windows[::v])

    def _device_batch(self, molded, metas, Rcam, Kmat, depths):
        """The model's inference batch on the engine's device from molded
        [B, V, h, w, 3] (float32, or uint8 pixels) and metas [B, META];
        Rcam and Kmat default to identities."""
        b, v = molded.shape[:2]
        if Rcam is None:
            Rcam = np.tile(np.eye(3, 4, dtype=np.float32), (b, v, 1, 1))
        if Kmat is None:
            Kmat = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
        dev = self.device
        batch = {
            "images": torch.from_numpy(np.ascontiguousarray(molded)).to(dev),
            "image_meta": torch.from_numpy(
                np.asarray(metas, np.float32)).to(dev),
            "anchors": self.get_anchors(molded.shape[2:]),
            "Rcam": torch.as_tensor(np.asarray(Rcam, np.float32), device=dev),
            "Kmat": torch.as_tensor(np.asarray(Kmat, np.float32), device=dev),
        }
        if self.config.TRANSFORMER:
            if depths is None:
                raise ValueError("TRANSFORMER fusion needs `depths`")
            batch["depths"] = torch.as_tensor(np.asarray(depths, np.float32),
                                              device=dev)
        return batch

    def run_model(self, images, Rcam=None, Kmat=None, depths=None):
        """Mold `images` (each a [V, H, W, 3] stack, main view first, or
        one [H, W, 3] image) and run the model; `depths` [B, V, h5, w5]
        (metric depth at P5's resolution) is required with TRANSFORMER.
        Returns (the model's output tensors on the device, molded shape
        [h, w, 3], windows [B, 4]) — detect() without the unmolding."""
        molded, metas, windows = self._mold_batch(images)
        batch = self._device_batch(molded, metas, Rcam, Kmat, depths)
        return self.inference_model()(batch), molded.shape[2:5], windows

    def _unmold_all(self, outputs, original_shapes, molded_shape, windows):
        """detect()'s result dicts from the model's outputs, one per
        original image shape."""
        detections = outputs["detections"].float().cpu().numpy()
        masks = outputs["mrcnn_masks"].float().cpu().numpy()
        results = []
        for i, original_shape in enumerate(original_shapes):
            rois, class_ids, scores, full_masks = self.unmold_detections(
                detections[i], masks[i], original_shape, molded_shape,
                windows[i])
            results.append({"rois": rois, "class_ids": class_ids,
                            "scores": scores, "masks": full_masks})
        return results

    def detect(self, images, Rcam=None, Kmat=None, depths=None, verbose=0):
        """Run detection. For multi-view, each element of `images` is a
        [V, H, W, 3] uint8 stack whose first view is the main view; Rcam
        [B, V, 3, 4] cam->world, Kmat [B, 3, 3] (model_multi.py:
        3019-3082); depths [B, V, h5, w5] with TRANSFORMER. Returns a list
        of dicts with rois/class_ids/scores/masks."""
        outputs, molded_shape, windows = self.run_model(images, Rcam, Kmat,
                                                        depths)
        originals = [(views if views.ndim == 3 else views[0]).shape
                     for views in map(np.asarray, images)]
        return self._unmold_all(outputs, originals, molded_shape, windows)

    def detect_molded(self, molded_images, image_metas, Rcam=None,
                      Kmat=None, depths=None):
        """Run detection on already-molded inputs (model.py:2547-2608):
        molded_images [B, V, h, w, 3] (or [B, h, w, 3] single-view) float,
        image_metas [B, META]; each result unmolds to the original shape
        and window its meta records."""
        molded = np.asarray(molded_images, np.float32)
        if molded.ndim == 4:
            molded = molded[:, None]
        metas = np.asarray(image_metas, np.float32)
        outputs = self.inference_model()(
            self._device_batch(molded, metas, Rcam, Kmat, depths))
        originals = [tuple(m[1:4].astype(int)) for m in metas]
        return self._unmold_all(outputs, originals, molded.shape[2:5],
                                metas[:, 7:11].astype(int))

    def run_graph(self, images, outputs=None, Rcam=None, Kmat=None,
                  depths=None):
        """Partial-graph debugger (model_multi.py:3213-3271): run inference
        on `images` (as detect takes them) and return the named outputs
        of the model as numpy arrays in the JAX package's layouts (float
        tensors as float32). `outputs` lists keys of the model's output
        dict ('proposals', 'rpn_probs', 'detections', with
        EXPOSE_FUSED_PYRAMID 'fused_p2'..'fused_p5', ...); None returns
        every one."""
        result, _, _ = self.run_model(images, Rcam, Kmat, depths)
        names = list(result) if outputs is None else list(outputs)
        return {k: (result[k].float() if result[k].is_floating_point()
                    else result[k]).cpu().numpy() for k in names}

    def ancestor(self, pattern, images=None, **kwargs):
        """Regex search over the inference graph's named outputs (the
        reference's graph search, model_multi.py:3164-3190; the names are
        run_graph's keys). Without images, the list of matching names (no
        compute runs); with images, {name: array} of run_graph(images,
        **kwargs) for every matching name."""
        rx = re.compile(pattern)
        if images is None:
            # the inference outputs in the JAX engine's order
            names = ["rpn_class_logits", "rpn_probs", "rpn_bbox",
                     "proposals", "mrcnn_class_logits", "mrcnn_probs",
                     "mrcnn_bbox", "detections", "mrcnn_masks"]
            if self.config.EXPOSE_FUSED_PYRAMID:
                names[4:4] = ["fused_p2", "fused_p3", "fused_p4",
                              "fused_p5"]
            return [n for n in names if rx.search(n)]
        result = self.run_graph(images, outputs=None, **kwargs)
        return {k: v for k, v in result.items() if rx.search(k)}

    def get_imagenet_weights(self):
        """The reference downloads the keras ImageNet ResNet weights
        (model.py:2644-2656); this package reaches no network."""
        raise NotImplementedError(
            "No network access: download the Matterport COCO h5 or the keras "
            "ResNet ImageNet h5 elsewhere and pass it to load_weights.")

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #
    def to_device(self, batch):
        """A host batch (make_batch's numpy dict) as tensors on the
        engine's device."""
        return {k: torch.as_tensor(np.asarray(batch[k])).to(
            self.device, dt) for k, dt in _BATCH_DTYPES.items() if k in batch}

    def train(self, train_dataset, val_dataset, learning_rate, epochs,
              layers, custom_callbacks=None, augmentation=None,
              prefetch_threads=4, save_every_epochs=50):
        """Stage-wise training loop (model_multi.py:2785-2912). `layers`
        is 'heads' | 'grid+' | 'grid+-' | 'grid_only' | '3+' | '4+' | '5+'
        | 'all' or a path regex; `epochs` is the TOTAL epoch target, so a
        call continues from self.epoch.

        Each call creates the optimizer afresh at `learning_rate`, so
        momentum restarts, as every keras compile() of the reference does
        (model_multi.py:2843-2850). After each epoch, VALIDATION_STEPS
        batches of `val_dataset` are scored with the training graph and no
        update; a checkpoint is written every `save_every_epochs` epochs
        and after the last. `augmentation` is a callable (image, mask,
        rng) -> (image, mask), see data.augment. With TRANSFORMER the
        batches carry depth maps, and the transformer's dropout draws from
        the engine's sampling generator. Each epoch's mean metrics go to
        `log_dir`: a line of `metrics.jsonl` and a TensorBoard scalar
        event at step epoch + 1, as in the JAX engine, and a printed
        line.

        Data parallelism: with a process group of more than one process
        (`parallel.init_distributed`), each process loads its share
        BATCH_SIZE / processes of every batch (data seeds offset by
        rank * 1000003, as in the JAX engine), starts from rank 0's
        weights, and steps with the global batch's gradient; the ROI
        priorities come from the sampling generator, the same on every
        rank. Every rank reports the global losses; rank 0 alone writes
        checkpoints, metrics.jsonl and the TensorBoard events."""
        if self.mode != "training":
            raise ValueError("create the engine in training mode to train")
        cfg = self.config
        model = self.model
        group = data_parallel_group()
        rank = 0 if group is None else dist.get_rank(group)
        rows = host_local_batch_slice(cfg.BATCH_SIZE)
        local_bs = rows.stop - rows.start
        host_off = rank * 1000003
        if group is not None:
            broadcast_module(model, group)
        mask = trainable_mask(model, layers)
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
        optimizer = make_optimizer(
            [p for n, p in model.named_parameters() if mask[n]],
            learning_rate, cfg.LEARNING_MOMENTUM)
        with_depth = bool(cfg.TRANSFORMER)
        prefetcher = BatchPrefetcher(
            lambda seed: make_batch(train_dataset, cfg,
                                    rnd_state=seed + host_off,
                                    with_depth=with_depth,
                                    augmentation=augmentation,
                                    batch_size=local_bs),
            num_threads=prefetch_threads)
        writer = rank == 0
        if writer:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            jsonl = MetricsLogger(self.log_dir)
            tb = TBEventWriter(self.log_dir)
        try:
            for epoch in range(self.epoch, epochs):
                acc = {}
                for _ in range(cfg.STEPS_PER_EPOCH):
                    metrics = train_step(model, optimizer,
                                         self.to_device(next(prefetcher)),
                                         cfg, mask, self._sampling, group)
                    for k, v in metrics.items():
                        acc.setdefault(k, []).append(v)
                means = {k: float(np.mean(v)) for k, v in acc.items()}
                if val_dataset is not None:
                    vacc = {}
                    for vstep in range(cfg.VALIDATION_STEPS):
                        vbatch = make_batch(
                            val_dataset, cfg,
                            rnd_state=epoch * 10007 + vstep + host_off,
                            with_depth=with_depth, batch_size=local_bs)
                        for k, v in val_step(model, self.to_device(vbatch),
                                             cfg, self._sampling,
                                             group).items():
                            vacc.setdefault(k, []).append(v)
                    means.update({f"val_{k}": float(np.mean(v))
                                  for k, v in vacc.items()})
                log.info("epoch %d: %s", epoch + 1, means)
                print(f"epoch {epoch + 1}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in sorted(means.items())),
                    flush=True)
                if writer:
                    jsonl.log(epoch + 1, **means)
                    tb.add_scalars(epoch + 1, means)
                if writer and ((epoch + 1) % save_every_epochs == 0
                               or epoch + 1 == epochs):
                    save_checkpoint(self.checkpoint_dir, model, optimizer,
                                    step=epoch + 1)
                if custom_callbacks:
                    for cb in custom_callbacks:
                        cb(epoch + 1, means)
        finally:
            prefetcher.close()
            if writer:
                jsonl.close()
                tb.close()
        if group is not None:
            # the other ranks may read rank 0's checkpoint from here on
            dist.barrier(group)
        self.epoch = max(self.epoch, epochs)
