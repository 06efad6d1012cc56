"""Train-to-AP harness: train the detector from scratch and measure it.

Port of `tools/train_to_ap.py`. Trains the multi-view configuration from
scratch on procedurally generated synthetic scenes (data/synthetic.py:
true pinhole projection, consistent multi-view geometry) and measures
mask AP@0.5 through the real evaluation path: cli.interior_multi.
_eval_views -> compat.MaskRCNN.detect -> eval.metrics.compute_ap, the
protocol of the reference's InteriorNet evaluation
(samples/interior/interior_multi.py:504-565). It runs on the card unless
`--device cpu` is given, and never falls back to the CPU.

    python -m mulit_view_object_detection_torch.cli.train_to_ap \
        --steps 1500 --image-size 64 --num-views 4 --diagnostics
    python -m mulit_view_object_detection_torch.cli.train_to_ap \
        --device cpu --steps 60 --smoke

Long runs go through cli/train_supervisor.py, which restarts this
command across checkpointed segments (`--until-step`, `--ckpt`,
`--max-rss-gb`, exit status 75).

Notes:
  * TRAIN_BN=True: the reference default (False) assumes pretrained BN
    statistics; from scratch it freezes BN at init and the net collapses.
  * ZERO_PG_LEVELS=(): at 64 px every ROI routes to P2/P3, which the
    faithful multi-view memory cap would zero out.
  * The learning rate: without --warmup a constant LEARNING_RATE, and at
    the drop step a new optimizer at LEARNING_RATE / 10 (its momentum
    starts from zero, as the JAX tool's rebuilt optax state does); with
    --warmup one schedule over the absolute step
    (train/optim.py::warmup_schedule).
  * Randomness: the weights from `init_weights` with a generator seeded
    by --seed; the ROI sampling priorities from a generator on the
    device seeded with --seed + 100, restarted in every segment as the
    JAX tool's PRNGKey(seed + 100) is.
  * The inference engine gets the training model's parameters and
    BatchNorm statistics (its state_dict, loaded strictly) before each
    evaluation.
  * `diagnose` reads the ground truth of the dataset it diagnoses (the
    JAX tool reads the training dataset's, which on a held-out set is
    another scene's or another pose's); an entry appended to the history
    sidecar after a partial last line starts on a line of its own (the
    JAX tool's is glued to it and lost); an --eval-only result's "steps"
    is the checkpoint's (the JAX tool adds --steps, which it did not
    train).
  * The result adds "device": the card's name and power limit as
    nvidia-smi gives them; "backend" reads "gpu" on the card, as JAX
    names CUDA.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import platform
import resource
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..compat import MaskRCNN
from ..config import Config
from ..data.generator import load_image_gt, make_batch
from ..data.molding import resize_image
from ..data.synthetic import SyntheticMultiViewDataset
from ..eval.metrics import compute_ap, compute_matches, compute_recall
from ..models.detector import MaskRCNN as Model
from ..ops.boxes import compute_overlaps_np, denorm_boxes_np, extract_bboxes_np
from ..train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..train.optim import make_optimizer, warmup_schedule
from ..train.step import train_step
from ..train.trainable import trainable_mask
from .interior_multi import _eval_views
from .interior_transformer import _detect_with_depth

SYNTHETIC_CLASSES = 4  # background and the synthetic scenes' 3 classes
RESTART = 75          # exit status: checkpointed, relaunch with --resume


def _nms_ap_ceiling(ds, cfg):
    """Upper bound the per-class detection NMS places on mean per-scene
    AP@0.5 for this dataset: even a perfect detector cannot emit two
    same-class detections overlapping more than DETECTION_NMS_THRESHOLD
    (refine_detections' per-class NMS, model.py:729-753), so a GT layout
    with same-class box IoU above the threshold caps recall below 1 no
    matter the model. The mean over scenes of (largest same-class-NMS-
    compatible GT subset) / n_gt, brute force over subsets (n_gt is
    tiny); numpy only."""
    thr = cfg.DETECTION_NMS_THRESHOLD
    fracs = []
    for key in list(ds.view_map.keys()):
        # max_views=5 is the eval protocol's scene-inclusion rule
        # (_eval_views, interior_multi.py:516-520): the ceiling covers the
        # scenes evaluation covers; only the main view's GT enters it
        view_ids = ds.load_view(5, key, rnd_state=0)
        if view_ids is None:
            continue
        mask, cls = ds.load_mask(view_ids[0])
        if mask.shape[-1] == 0:
            continue
        boxes = extract_bboxes_np(mask).astype(np.float32)
        ious = compute_overlaps_np(boxes, boxes)
        n = len(cls)
        best = 0
        for r in range(n, 0, -1):
            for sub in itertools.combinations(range(n), r):
                if all(cls[i] != cls[j] or ious[i, j] <= thr
                       for i, j in itertools.combinations(sub, 2)):
                    best = r
                    break
            if best:
                break
        fracs.append(best / max(n, 1))
    return round(float(np.mean(fracs)), 4) if fracs else 1.0


def build_config(image_size, num_views, variant="conv3d", nvox_override=None,
                 samples_override=None, grid_reas=None, xformer_arch=None):
    """The harness's config (tools/train_to_ap.py:78-146)."""

    class TrainToAPConfig(Config):
        NAME = "train_to_ap"
        NUM_CLASSES = SYNTHETIC_CLASSES
        NUM_VIEWS = num_views
        BACKBONE = "resnet50"
        TOP_DOWN_PYRAMID_SIZE = 64
        FPN_CLASSIF_FC_LAYERS_SIZE = 128
        IMAGE_MIN_DIM = image_size
        IMAGE_MAX_DIM = image_size
        # the reference's unmodified ladder at its 640^2 operating point
        # (config.py:76); scaled down only for the small harness. With a
        # halved ladder a ~330 px object's best anchor sits on the zeroed
        # P6 of the P5-only protocol and localisation is unlearnable.
        RPN_ANCHOR_SCALES = ((8, 16, 32, 64, 128) if image_size <= 128
                             else (32, 64, 128, 256, 512))
        PRE_NMS_LIMIT = 512
        POST_NMS_ROIS_TRAINING = 64
        POST_NMS_ROIS_INFERENCE = 64
        TRAIN_ROIS_PER_IMAGE = 32
        DETECTION_MAX_INSTANCES = 8
        DETECTION_MIN_CONFIDENCE = 0.5
        MAX_GT_INSTANCES = 8
        GRID_REAS = grid_reas or "conv3d"
        nvox = nvox_override or 16
        nvox_z = nvox_override or 16
        vmin, vmax = -2.0, 2.0
        vmin_z, vmax_z = 1.0, 7.0
        samples = samples_override or 8
        LEARNING_RATE = 0.002
        TRAIN_BN = True          # from-scratch training (module doc)
        ZERO_PG_LEVELS = ()      # small-scale ROIs live on P2/P3
        USE_MINI_MASK = True
        MINI_MASK_SHAPE = (28, 28)

    if variant == "xformer":
        # BASELINE config #4's fusion (interior_transformer.py:378-407)
        # scaled to the harness: depth-conditioned P5 tokens, a small
        # encoder, the main view's features kept on the other levels
        class XformerConfig(TrainToAPConfig):
            GRID_REAS = "ident"
            TRANSFORMER = True
            TOP_DOWN_PYRAMID_SIZE = 72
            XFORMER_D_MODEL = 72
            XFORMER_NUM_LAYERS = 2
            XFORMER_NUM_HEADS = 4
            XFORMER_DFF = 128
            XFORMER_DROPOUT = 0.0
            XFORMER_KEEP_MAIN_LEVELS = True
            samples = 1
        if xformer_arch:
            # the reference's encoder (model_transformer.py:361): "6,8,256"
            layers, heads, dff = (int(x) for x in xformer_arch.split(","))
            XformerConfig.XFORMER_NUM_LAYERS = layers
            XformerConfig.XFORMER_NUM_HEADS = heads
            XformerConfig.XFORMER_DFF = dff
        return XformerConfig()
    return TrainToAPConfig()


def make_parser():
    """The JAX tool's flags (tools/train_to_ap.py:148-306) and --device."""
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--variant", choices=["conv3d", "xformer"],
                   default="conv3d")
    p.add_argument("--nvox", type=int, default=0,
                   help="voxel grid resolution (0 = the default 16)")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--num-views", type=int, default=2)
    p.add_argument("--scenes", type=int, default=4)
    p.add_argument("--eval-every", type=int, default=0,
                   help="0 = evaluate only at the end")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--lr-drop", type=float, default=None,
                   help="fraction of steps after which LR /= 10 (default "
                        "0.75 for fresh runs; off on --resume unless given)")
    p.add_argument("--out", default=None, help="write the JSON result here")
    p.add_argument("--smoke", action="store_true",
                   help="no AP threshold enforced")
    p.add_argument("--skip-eval", action="store_true",
                   help="skip the final AP evaluation")
    p.add_argument("--diagnostics", action="store_true",
                   help="loss curves, box vs mask AP, RPN proposal recall")
    p.add_argument("--lr", type=float, default=0.0,
                   help="override LEARNING_RATE")
    p.add_argument("--warmup", type=int, default=0,
                   help="linear LR warmup steps")
    p.add_argument("--zero-pg", default=None,
                   help="comma list overriding ZERO_PG_LEVELS ('0,1': the "
                        "faithful memory cap)")
    p.add_argument("--keep-main-levels", default=None, choices=["0", "1"],
                   help="override XFORMER_KEEP_MAIN_LEVELS")
    p.add_argument("--ap-thresh", type=float, default=0.5,
                   help="pass/fail AP threshold (not with --smoke)")
    p.add_argument("--samples", type=int, default=0,
                   help="override the ray depth samples")
    p.add_argument("--grid-reas", default=None,
                   choices=["add", "mean", "ident", "conv3d", "lstm3d"],
                   help="override GRID_REAS of the conv3d-family variant")
    p.add_argument("--min-conf", type=float, default=0.5,
                   help="DETECTION_MIN_CONFIDENCE at evaluation")
    p.add_argument("--batch", type=int, default=0,
                   help="override IMAGES_PER_GPU (the training batch)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory, written before evaluation")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="also checkpoint every N steps")
    p.add_argument("--max-rss-gb", type=float, default=0,
                   help="if > 0: when the host's peak RSS passes it, save "
                        "--ckpt and exit 75 (a supervisor restarts with "
                        "--resume)")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training; restore --ckpt and evaluate")
    p.add_argument("--resume", action="store_true",
                   help="restore --ckpt (parameters, optimizer, BN "
                        "statistics) if present and train --steps more")
    p.add_argument("--until-step", type=int, default=0,
                   help="absolute step target: train max(0, N - restored "
                        "step) steps; overrides --steps")
    p.add_argument("--uint8-input", action="store_true",
                   help="UINT8_IMAGE_TRANSFER: uint8 images to the device, "
                        "molded there")
    p.add_argument("--obj-px", default=None,
                   help="'lo,hi' on-screen object size in pixels")
    p.add_argument("--det-nms", type=float, default=None,
                   help="override DETECTION_NMS_THRESHOLD at evaluation")
    p.add_argument("--xformer-arch", default=None,
                   help="'layers,heads,dff' of the transformer encoder "
                        "('6,8,256': the reference's)")
    p.add_argument("--anchor-scales", default=None,
                   help="comma list overriding RPN_ANCHOR_SCALES")
    p.add_argument("--xformer-zero-init", action="store_true",
                   help="zero-initialise the transformer fusion's token "
                        "projection (XFORMER_ZERO_INIT)")
    p.add_argument("--stage4-blocks", type=int, default=0,
                   help="ResNet-50 stage-4 blocks (5: the multi-view "
                        "fork's; 0: the default)")
    p.add_argument("--scene-mode", default="legacy",
                   choices=["legacy", "shapes", "hard"],
                   help="synthetic scene generator mode (data/synthetic.py)")
    p.add_argument("--num-objects", type=int, default=3,
                   help="objects per scene")
    p.add_argument("--holdout-scenes", type=int, default=0,
                   help="if > 0: also evaluate on N held-out scenes drawn "
                        "with --holdout-seed")
    p.add_argument("--holdout-seed", type=int, default=0,
                   help="seed of the held-out scenes (default --seed + 1000)")
    p.add_argument("--holdout-view-seed", type=int, default=0,
                   help="if > 0: also evaluate the training scenes from "
                        "fresh camera poses seeded here")
    p.add_argument("--bn-eval-batch-stats", action="store_true",
                   help="evaluate with BatchNorm in batch-statistics mode")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be asked for)")
    return p


def train_config(args):
    """build_config with the command line's instance-level overrides."""
    cfg = build_config(args.image_size, args.num_views, args.variant,
                       nvox_override=args.nvox or None,
                       samples_override=args.samples or None,
                       grid_reas=args.grid_reas,
                       xformer_arch=args.xformer_arch)
    if args.stage4_blocks:
        cfg.RESNET50_STAGE4_BLOCKS = args.stage4_blocks
    if args.lr:
        cfg.LEARNING_RATE = args.lr
    if args.batch:
        # instance level: the evaluation config keeps batch 1
        cfg.IMAGES_PER_GPU = args.batch
        cfg.BATCH_SIZE = args.batch * cfg.GPU_COUNT
    if args.uint8_input:
        cfg.UINT8_IMAGE_TRANSFER = True
    if args.zero_pg is not None:
        cfg.ZERO_PG_LEVELS = tuple(
            int(x) for x in args.zero_pg.split(",") if x != "")
    if args.keep_main_levels is not None:
        cfg.XFORMER_KEEP_MAIN_LEVELS = args.keep_main_levels == "1"
    if args.xformer_zero_init:
        cfg.XFORMER_ZERO_INIT = True
    if args.anchor_scales:
        cfg.RPN_ANCHOR_SCALES = tuple(
            int(x) for x in args.anchor_scales.split(","))
    return cfg


def eval_config(cfg, args):
    """The inference engine's config. It is made anew from the class, so
    every instance-level override that shapes the model is pinned here:
    ZERO_PG_LEVELS decides which grid_fusion_p* modules exist, and a
    mismatch would fail the strict load after the training budget is
    spent."""

    class EvalConfig(type(cfg)):
        DETECTION_MIN_CONFIDENCE = args.min_conf
        BN_EVAL_BATCH_STATS = args.bn_eval_batch_stats
        ZERO_PG_LEVELS = cfg.ZERO_PG_LEVELS
        XFORMER_KEEP_MAIN_LEVELS = cfg.XFORMER_KEEP_MAIN_LEVELS
        RPN_ANCHOR_SCALES = cfg.RPN_ANCHOR_SCALES
        RESNET50_STAGE4_BLOCKS = getattr(cfg, "RESNET50_STAGE4_BLOCKS", None)
        DETECTION_NMS_THRESHOLD = (args.det_nms if args.det_nms is not None
                                   else cfg.DETECTION_NMS_THRESHOLD)
    return EvalConfig()


def share_weights(engine, model):
    """Give the inference engine the training model's parameters and
    BatchNorm statistics."""
    engine.model.load_state_dict(model.state_dict(), strict=True)


def make_dataset(args, num_scenes, seed, view_seed=None):
    return SyntheticMultiViewDataset(
        num_scenes=num_scenes, num_views=args.num_views,
        image_size=args.image_size, num_classes=SYNTHETIC_CLASSES, seed=seed,
        obj_px_range=_obj_px(args), view_seed=view_seed,
        scene_mode=args.scene_mode, num_objects=args.num_objects)


def _obj_px(args):
    return (tuple(float(x) for x in args.obj_px.split(","))
            if args.obj_px else None)


def evaluate(engine, dataset, config, args):
    """Mean mask AP@0.5 of the engine's weights over `dataset`'s scenes
    (the training scenes give train-scene AP; a held-out set is the
    reference's val-split protocol, interior_multi.py:504-510). With
    TRANSFORMER the detections are depth-conditioned
    (interior_transformer.py's protocol)."""
    keys = list(dataset.view_map.keys())
    if not config.TRANSFORMER:
        return _eval_views(dataset, config, engine, keys, args.num_views,
                           rnd_state=0)
    aps = []
    for key in keys:
        view_ids = dataset.load_view(5, key, rnd_state=0)
        if view_ids is None:
            continue
        view_ids = view_ids[:args.num_views]
        _, _, gt_class_id, gt_bbox, gt_mask = load_image_gt(
            dataset, config, view_ids[0], use_mini_mask=False)
        r = _detect_with_depth(engine, dataset, config, view_ids)[0]
        if r["masks"].shape[-1] == 0 or gt_mask.shape[-1] == 0:
            aps.append(0.0)
            continue
        ap, *_ = compute_ap(
            gt_bbox.astype(np.float32), gt_class_id, gt_mask,
            r["rois"].astype(np.float32), r["class_ids"], r["scores"],
            r["masks"], iou_threshold=0.5)
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


def _boxes_to_masks(boxes, hw):
    m = np.zeros((hw, hw, boxes.shape[0]), np.float32)
    for i, (y1, x1, y2, x2) in enumerate(boxes.astype(np.int32)):
        m[max(y1, 0):max(y2, 0), max(x1, 0):max(x2, 0), i] = 1.0
    return m


def _scene_inputs(dataset, config, view_ids):
    """(views [V, h, w, 3], Rcam [1, V, 3, 4], Kmat [1, 3, 3], depths
    [1, V, h5, w5] with TRANSFORMER else None) of one scene."""
    v = len(view_ids)
    views, rcam = [], np.zeros((1, v, 3, 4), np.float32)
    depths = None
    if config.TRANSFORMER:
        fh = int(config.IMAGE_SHAPE[0]) // config.BACKBONE_STRIDES[3]
        depths = np.zeros((1, v, fh, fh), np.float32)
    for i, vid in enumerate(view_ids):
        im, *_ = resize_image(
            dataset.load_image(vid), min_dim=config.IMAGE_MIN_DIM,
            min_scale=config.IMAGE_MIN_SCALE, max_dim=config.IMAGE_MAX_DIM,
            mode=config.IMAGE_RESIZE_MODE)
        views.append(im)
        rcam[0, i] = dataset.load_R(vid)
        if depths is not None:
            depths[0, i] = dataset.load_depth(vid, config)
    return (np.stack(views), rcam, dataset.K[None].astype(np.float32),
            depths)


def diagnose(engine, dataset, config, args):
    """Plateau diagnostics of the engine's weights on `dataset`: box AP
    against mask AP (masks blurred, or detections missing?), RPN proposal
    recall at IoU 0.5 (does the detector see the objects?), the mean
    number of detections, the NMS protocol ceiling, and per scene the
    missed GT, false positives and scores."""
    mask_aps, box_aps, recalls, ndet, per_scene = [], [], [], [], []
    h = config.IMAGE_SHAPE[0]
    for key in list(dataset.view_map.keys()):
        view_ids = dataset.load_view(5, key, rnd_state=0)
        if view_ids is None:
            continue
        view_ids = view_ids[:args.num_views]
        _, _, gt_class_id, gt_bbox, gt_mask = load_image_gt(
            dataset, config, view_ids[0], use_mini_mask=False)
        gt_bbox = gt_bbox.astype(np.float32)
        views, rcam, kmat, depths = _scene_inputs(dataset, config, view_ids)
        r = engine.detect([views], Rcam=rcam, Kmat=kmat, depths=depths)[0]
        rois = r["rois"].astype(np.float32)
        ndet.append(int(r["class_ids"].shape[0]))
        if r["masks"].shape[-1] == 0 or gt_mask.shape[-1] == 0:
            mask_aps.append(0.0)
            box_aps.append(0.0)
        else:
            m_ap, *_ = compute_ap(gt_bbox, gt_class_id, gt_mask, rois,
                                  r["class_ids"], r["scores"], r["masks"],
                                  iou_threshold=0.5)
            b_ap, *_ = compute_ap(gt_bbox, gt_class_id,
                                  _boxes_to_masks(gt_bbox, h), rois,
                                  r["class_ids"], r["scores"],
                                  _boxes_to_masks(r["rois"], h),
                                  iou_threshold=0.5)
            mask_aps.append(m_ap)
            box_aps.append(b_ap)
        # proposal-stage recall through run_graph
        g = engine.run_graph([views], outputs=["proposals"], Rcam=rcam,
                             Kmat=kmat, depths=depths)
        props = denorm_boxes_np(np.asarray(g["proposals"])[0], (h, h))
        recalls.append(compute_recall(props, gt_bbox, 0.5)[0])
        if r["masks"].shape[-1]:
            gm, pm, _ = compute_matches(gt_bbox, gt_class_id, gt_mask, rois,
                                        r["class_ids"], r["scores"],
                                        r["masks"], iou_threshold=0.5)
        else:
            gm, pm = np.full(len(gt_class_id), -1.0), np.array([])
        per_scene.append({
            "scene": str(key),
            "n_gt": int(len(gt_class_id)),
            "n_det": int(r["class_ids"].shape[0]),
            "false_pos": int((pm == -1).sum()) if pm.size else 0,
            "missed": [
                {"class": int(gt_class_id[i]),
                 "area": int(gt_mask[..., i].sum()),
                 "box": [int(x) for x in gt_bbox[i]]}
                for i in range(len(gt_class_id)) if gm[i] == -1],
            "scores": [round(float(s), 3) for s in r["scores"]],
        })
    return {
        "mask_ap50": round(float(np.mean(mask_aps)), 4),
        "box_ap50": round(float(np.mean(box_aps)), 4),
        "proposal_recall50": round(float(np.mean(recalls)), 4),
        "mean_detections": round(float(np.mean(ndet)), 2),
        "nms_protocol_ap_ceiling": _nms_ap_ceiling(dataset, config),
        "per_scene": per_scene,
    }


def device_info(device):
    """{"name", "power_limit"} of the card as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` gives them; on the CPU the
    processor's name and no limit."""
    if device.type != "cuda":
        return {"name": platform.processor() or platform.machine() or "cpu",
                "power_limit": None}
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        name, limit = (s.strip() for s in
                       lines[min(index, len(lines) - 1)].split(",", 1))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        name, limit = torch.cuda.get_device_name(index), None
    return {"name": name, "power_limit": limit}


def _to_device(batch, device):
    """make_batch's numpy dict as tensors on `device` (uint8 images stay
    uint8: the model de-molds them, UINT8_IMAGE_TRANSFER)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.is_floating_point():
            t = t.float()
        elif t.dtype != torch.uint8:
            t = t.long()
        out[k] = t.to(device)
    return out


def append_history(hist_path, entry):
    """Append one JSON line to the history sidecar, after a newline if a
    killed segment left a partial last line (else this entry would be
    glued to it and lost with it)."""
    with open(hist_path, "a+b") as f:
        if f.seek(0, os.SEEK_END):
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                f.write(b"\n")
        f.write((json.dumps(entry) + "\n").encode())


def read_history(hist_path):
    """(AP history, loss history, summed segment seconds or None) from the
    history sidecar, by absolute step keeping the last sample (a
    restarted segment replays the tail of the previous one). A segment
    killed mid-append leaves a partial last line, which is skipped."""
    ap_by, loss_by, seg_seconds = {}, {}, []
    with open(hist_path) as f:
        for line in f:
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if "segment_seconds" in e:
                seg_seconds.append(e["segment_seconds"])
                continue
            (ap_by if "ap50" in e else loss_by)[e["step"]] = e
    return ([ap_by[s] for s in sorted(ap_by)],
            [loss_by[s] for s in sorted(loss_by)],
            round(sum(seg_seconds), 1) if seg_seconds else None)


def _set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr


def main(argv=None):
    args = make_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {args.device!r} requested but torch.cuda.is_available() "
            f"is False; pass --device cpu to run on the CPU")
    cfg = train_config(args)
    with_depth = bool(cfg.TRANSFORMER)
    ds = make_dataset(args, args.scenes, args.seed)

    model = Model(cfg)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    model = model.to(device).eval()
    mask = trainable_mask(model, "all")
    params = [p for n, p in model.named_parameters() if mask[n]]
    optimizer = make_optimizer(params, cfg.LEARNING_RATE,
                               cfg.LEARNING_MOMENTUM)
    eval_cfg = eval_config(cfg, args)
    engine = None

    def evaluated(dataset, fn=evaluate):
        nonlocal engine
        if engine is None:
            engine = MaskRCNN("inference", eval_cfg, os.path.join(
                tempfile.gettempdir(), "train_to_ap_logs"),
                device=args.device)
        share_weights(engine, model)
        return fn(engine, dataset, eval_cfg, args)

    # cross-segment history: supervised runs restart this process many
    # times, so every loss/AP sample and each segment's wall time goes to
    # a sidecar next to the checkpoint, and the result is rebuilt from it
    hist_path = (args.ckpt.rstrip("/") + "_history.jsonl"
                 if args.ckpt else None)

    def record_history(entry):
        if hist_path:
            append_history(hist_path, entry)

    generator = torch.Generator(device).manual_seed(args.seed + 100)
    lr_drop = args.lr_drop
    if lr_drop is None:
        lr_drop = 0.0 if args.resume else 0.75
    drop_at = int(args.steps * lr_drop) if lr_drop else -1
    schedule = None
    if args.warmup:
        # one schedule over the absolute step, the LR/10 drop folded in
        if args.until_step:
            abs_drop = args.lr_drop if args.lr_drop is not None else 0.75
            drop_step = int(args.until_step * abs_drop) if abs_drop else 0
        else:
            drop_step = int(args.steps * lr_drop) if lr_drop else 0
        schedule = warmup_schedule(cfg.LEARNING_RATE, args.warmup, drop_step)
    start_step = 0
    if args.eval_only or args.resume or (args.until_step and args.ckpt):
        restored = (restore_checkpoint(args.ckpt, model, optimizer)
                    if args.ckpt and latest_step(args.ckpt) is not None
                    else None)
        if restored is None and args.eval_only:
            raise FileNotFoundError(f"no checkpoint in {args.ckpt}")
        if restored is not None:
            start_step = restored
            print(f"restored {args.ckpt} at step {start_step}", flush=True)
    _set_lr(optimizer, cfg.LEARNING_RATE)
    # an --eval-only run trains nothing: its "steps" is the checkpoint's
    n_steps = 0 if args.eval_only else args.steps
    if args.until_step and not args.eval_only:
        n_steps = max(0, args.until_step - start_step)
        print(f"until-step {args.until_step}: {n_steps} steps to run "
              f"from {start_step}", flush=True)
        # the drop in absolute step space against the final target, so a
        # restarted segment does not rerun 75% of its remainder at full LR
        abs_drop = args.lr_drop if args.lr_drop is not None else 0.75
        drop_at = (int(args.until_step * abs_drop) - start_step
                   if abs_drop else -1)
        if drop_at < 0 and abs_drop:
            drop_at = 0          # restored past the boundary: drop now
    t0 = time.time()
    losses, history, loss_history = [], [], []
    for step in range(n_steps):
        if schedule is not None:
            _set_lr(optimizer, schedule(start_step + step))
        elif step == drop_at:
            # fine-tune at LR/10 with a new optimizer: momentum from zero
            optimizer = make_optimizer(params, cfg.LEARNING_RATE / 10,
                                       cfg.LEARNING_MOMENTUM)
        batch = make_batch(ds, cfg, rnd_state=start_step + step,
                           with_depth=with_depth)
        metrics = train_step(model, optimizer, _to_device(batch, device),
                             cfg, mask, generator)
        losses.append(float(metrics["loss"]))
        if step % 100 == 0 or step == n_steps - 1:
            if args.diagnostics:
                entry = {"step": start_step + step,
                         **{k: round(float(v), 4)
                            for k, v in metrics.items()}}
                loss_history.append(entry)
                record_history(entry)
            rss_gb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                      / 1024.0 / 1024.0)  # KiB on Linux
            print(f"step {step}: loss={losses[-1]:.4f} "
                  f"({time.time() - t0:.0f}s, rss {rss_gb:.1f} GB)",
                  flush=True)
            if args.max_rss_gb and rss_gb > args.max_rss_gb and args.ckpt:
                save_checkpoint(args.ckpt, model, optimizer,
                                step=start_step + step + 1)
                record_history({"segment_seconds": round(time.time() - t0, 1),
                                "segment_steps": step + 1})
                print(f"RSS {rss_gb:.1f} GB > {args.max_rss_gb} GB budget: "
                      f"checkpointed at step {start_step + step + 1}, "
                      f"exiting {RESTART} for supervised restart",
                      flush=True)
                raise SystemExit(RESTART)
        if (args.ckpt_every and args.ckpt
                and (step + 1) % args.ckpt_every == 0):
            save_checkpoint(args.ckpt, model, optimizer,
                            step=start_step + step + 1)
        if args.eval_every and (step + 1) % args.eval_every == 0:
            ap = evaluated(ds)
            entry = {"step": start_step + step + 1, "ap50": round(ap, 4)}
            history.append(entry)
            record_history(entry)
            print(f"step {start_step + step + 1}: mask AP@0.5 = {ap:.4f}",
                  flush=True)

    elapsed = time.time() - t0
    if args.ckpt and not args.eval_only:
        # persist the trained state before evaluation, so that a failing
        # evaluation cannot lose the training budget
        save_checkpoint(args.ckpt, model, optimizer, step=start_step + n_steps)
        print(f"checkpoint saved to {args.ckpt}", flush=True)
    ap = -1.0 if args.skip_eval else evaluated(ds)
    if not args.skip_eval and not args.eval_only:
        record_history({"step": start_step + n_steps, "ap50": round(ap, 4)})
    # held-out evaluation: the same weights and protocol on scenes (or
    # viewpoints) the model never trained on
    holdout_scene_ap = holdout_view_ap = None
    holdout_scene_ceiling = holdout_view_ceiling = None
    holdout_seed = args.holdout_seed or (args.seed + 1000)
    if args.holdout_scenes and not args.skip_eval:
        hs_ds = make_dataset(args, args.holdout_scenes, holdout_seed)
        holdout_scene_ap = evaluated(hs_ds)
        holdout_scene_ceiling = _nms_ap_ceiling(hs_ds, eval_cfg)
        print(f"held-out-scene mask AP@0.5 = {holdout_scene_ap:.4f} "
              f"(nms ceiling {holdout_scene_ceiling})", flush=True)
    if args.holdout_view_seed and not args.skip_eval:
        hv_ds = make_dataset(args, args.scenes, args.seed,
                             view_seed=args.holdout_view_seed)
        holdout_view_ap = evaluated(hv_ds)
        holdout_view_ceiling = _nms_ap_ceiling(hv_ds, eval_cfg)
        print(f"held-out-viewpoint mask AP@0.5 = {holdout_view_ap:.4f} "
              f"(nms ceiling {holdout_view_ceiling})", flush=True)
    diag = diag_hv = diag_hs = None
    if args.diagnostics:
        diag = evaluated(ds, diagnose)
        print("diagnostics:", json.dumps(diag), flush=True)
        # attribute a generalisation gap to boxes, masks, classes or
        # proposals on the unseen sets
        if holdout_view_ap is not None:
            diag_hv = evaluated(hv_ds, diagnose)
            print("diagnostics (holdout-view):",
                  json.dumps({k: v for k, v in diag_hv.items()
                              if k != "per_scene"}), flush=True)
        if holdout_scene_ap is not None:
            diag_hs = evaluated(hs_ds, diagnose)
            print("diagnostics (holdout-scene):",
                  json.dumps({k: v for k, v in diag_hs.items()
                              if k != "per_scene"}), flush=True)
    if not args.eval_only and losses:
        record_history({"segment_seconds": round(elapsed, 1),
                        "segment_steps": n_steps})
    cumulative_seconds = None
    if hist_path and os.path.exists(hist_path):
        ap_hist, loss_hist, cumulative_seconds = read_history(hist_path)
        history = ap_hist or history
        loss_history = loss_hist or loss_history
    result = {
        "metric": "synthetic_train_to_ap50",
        "variant": args.variant,
        "grid_reas": cfg.GRID_REAS,
        "samples": cfg.samples,
        "nvox": cfg.nvox,
        "ap50": round(ap, 4),
        # train-scene AP (fit); the holdout_* fields are generalisation
        "ap50_eval_scope": "train scenes (same scenes used for training)",
        "steps": start_step + n_steps,
        "image_size": args.image_size,
        "num_views": args.num_views,
        "scenes": args.scenes,
        "final_loss": round(float(np.mean(losses[-20:])), 4)
        if losses else None,
        "initial_loss": round(float(np.mean(losses[:20])), 4)
        if losses else None,
        "seconds": round(elapsed, 1),
        "seconds_scope": (
            "final segment only (resumed/eval-only; earlier segments' "
            "wall time and losses are not included)"
            if (args.resume or args.eval_only) else "full run"),
        "backend": "gpu" if device.type == "cuda" else device.type,
        "device": device_info(device),
        "history": history,
        "lr": cfg.LEARNING_RATE,
        "warmup": args.warmup,
        "zero_pg_levels": list(cfg.ZERO_PG_LEVELS),
        "obj_px": list(_obj_px(args)) if args.obj_px else None,
        "det_nms_threshold": eval_cfg.DETECTION_NMS_THRESHOLD,
        "rpn_anchor_scales": list(cfg.RPN_ANCHOR_SCALES),
        "seed": args.seed,
        "scene_mode": args.scene_mode,
        "num_objects": args.num_objects,
        "stage4_blocks": args.stage4_blocks or None,
    }
    if cumulative_seconds is not None:
        result["cumulative_seconds"] = cumulative_seconds
        result["cumulative_seconds_scope"] = (
            "sum of all segments' training wall time (cross-restart "
            "ledger in the history sidecar; excludes eval time)")
    if holdout_scene_ap is not None:
        result["holdout_scene_ap50"] = round(holdout_scene_ap, 4)
        result["holdout_scene_nms_ceiling"] = holdout_scene_ceiling
        result["holdout_scenes"] = args.holdout_scenes
        result["holdout_seed"] = holdout_seed
    if holdout_view_ap is not None:
        result["holdout_view_ap50"] = round(holdout_view_ap, 4)
        result["holdout_view_nms_ceiling"] = holdout_view_ceiling
        result["holdout_view_seed"] = args.holdout_view_seed
    if args.variant == "xformer":
        result["xformer_arch"] = {
            "layers": cfg.XFORMER_NUM_LAYERS,
            "heads": cfg.XFORMER_NUM_HEADS,
            "dff": cfg.XFORMER_DFF,
            "d_model": cfg.XFORMER_D_MODEL,
            "keep_main_levels": bool(
                getattr(cfg, "XFORMER_KEEP_MAIN_LEVELS", False)),
            "zero_init": bool(getattr(cfg, "XFORMER_ZERO_INIT", False)),
        }
    if diag:
        result["diagnostics"] = diag
    if diag_hv:
        result["diagnostics_holdout_view"] = diag_hv
    if diag_hs:
        result["diagnostics_holdout_scene"] = diag_hs
    if loss_history:
        result["loss_history"] = loss_history
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if not args.smoke and not args.skip_eval and ap < args.ap_thresh:
        raise AssertionError(
            f"mask AP@0.5 = {ap:.4f} < {args.ap_thresh} target")
    return result


if __name__ == "__main__":
    main()
