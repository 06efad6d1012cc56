"""What the measurement tools (`cli/profile_variants.py`,
`cli/mfu_report.py`, `cli/trace_analysis.py`) share: the device they
run on and the card's fields, the loop-difference timer, the seeded
inference model and its chained loop, and the flagship training
workload.

`flagship_train_config` and `make_flagship_train_batch` are the port's
copies of the top-level `bench_train.py`'s, which imports jax: the one
training workload that `cli/mfu_report.py` and a train-step benchmark
both measure.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config
from ..models.detector import MaskRCNN, make_dummy_batch
from ..utils.bn_fold import fold_bn_model
from .train_to_ap import device_info


def resolve_device(device):
    """torch.device(device); cuda without a card raises (no CPU
    fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass --device cpu to run on the CPU")
    return device


def card_fields(device):
    """{"device", "power_limit"}: nvidia-smi's name and power limit of
    the card; on the CPU the processor's name and None."""
    info = device_info(torch.device(device))
    return {"device": info["name"], "power_limit": info["power_limit"]}


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_loop(run, device, short=2, long=12):
    """ms of one iteration by the loop difference: run(short) and
    run(long) once each to warm up, then timed, the device synchronised
    before and after each; (t_long - t_short) / (long - short)."""
    def timed(iters):
        synchronize(device)
        t0 = time.perf_counter()
        run(iters)
        synchronize(device)
        return time.perf_counter() - t0

    timed(short)
    timed(long)
    ts = timed(short)
    tl = timed(long)
    return (tl - ts) / (long - short) * 1e3


def inference_setup(cfg, device):
    """A seeded model at `cfg` on `device` (BN-folded when cfg.FOLD_BN) in
    eval mode, and the JAX tools' inference batch on the device:
    make_dummy_batch's inputs with seeded N(0, 50^2) pixels."""
    model = MaskRCNN(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    if cfg.FOLD_BN:
        fold_bn_model(model)
    batch = make_dummy_batch(cfg, training=False)
    rng = np.random.RandomState(0)
    batch["images"] = rng.randn(*batch["images"].shape).astype(
        np.float32) * 50.0
    return model, {k: torch.from_numpy(v).to(device)
                   for k, v in batch.items()}


def infer_loop(model, batch, iters):
    """`iters` forwards, each one's images chained through the previous
    one's detections; returns the last detections."""
    cfg = model.config
    images = batch["images"]
    det = torch.zeros(cfg.BATCH_SIZE, cfg.DETECTION_MAX_INSTANCES, 6,
                      device=images.device)
    with torch.no_grad():
        for _ in range(iters):
            chained = dict(batch, images=images + det[0, 0, 0] * 0.0)
            det = model(chained)["detections"]
    return det


def flagship_train_config(batch=1, remat=False, name="bench_train"):
    """bench_train.py's training shape (interior_multi.py:370-394) with
    the multi-view fork's 5-block ResNet-50 stage 4 (model_multi.py:596):
    2 views at 640^2, conv3d, bfloat16, stage "all", frozen BatchNorm."""

    class TrainBench(Config):
        NAME = name
        NUM_CLASSES = 23
        NUM_VIEWS = 2
        BACKBONE = "resnet50"
        RESNET50_STAGE4_BLOCKS = 5
        TOP_DOWN_PYRAMID_SIZE = 64
        GRID_REAS = "conv3d"
        IMAGE_MIN_DIM = 640
        IMAGE_MAX_DIM = 640
        PRE_NMS_LIMIT = 1500
        POST_NMS_ROIS_TRAINING = 500
        TRAIN_ROIS_PER_IMAGE = 200
        DETECTION_MAX_INSTANCES = 100
        MAX_GT_INSTANCES = 100
        nvox = 40
        nvox_z = 40
        vmin, vmax = -2.5, 2.5
        vmin_z, vmax_z = 1.0, 10.0
        samples = 20
        COMPUTE_DTYPE = "bfloat16"

    TrainBench.IMAGES_PER_GPU = batch
    TrainBench.REMAT = remat
    return TrainBench()


def make_flagship_train_batch(cfg):
    """bench_train.py's deterministic training batch, as numpy arrays: 3
    ground truth instances, 32 positive and 224 negative RPN anchors."""
    batch = make_dummy_batch(cfg, training=True)
    rng = np.random.RandomState(0)
    batch["images"] = rng.randn(*batch["images"].shape).astype(
        np.float32) * 50.0
    batch["gt_class_ids"][:, :3] = [1, 2, 3]
    batch["gt_boxes"][:, 0] = [0.2, 0.2, 0.5, 0.5]
    batch["gt_boxes"][:, 1] = [0.5, 0.5, 0.8, 0.8]
    batch["gt_boxes"][:, 2] = [0.3, 0.55, 0.6, 0.9]
    batch["gt_masks"][:, :3] = 1.0
    a = batch["anchors"].shape[0]
    batch["rpn_match"] = np.zeros((cfg.BATCH_SIZE, a), np.int32)
    batch["rpn_match"][:, :32] = 1
    batch["rpn_match"][:, 32:256] = -1
    batch["rpn_bbox"] = np.zeros(
        (cfg.BATCH_SIZE, cfg.RPN_TRAIN_ANCHORS_PER_IMAGE, 4), np.float32)
    return batch
