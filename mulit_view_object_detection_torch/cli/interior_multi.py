"""Multi-view InteriorNet command line: train / evaluate / visualize.

The port of `mulit_view_object_detection_tpu/cli/interior_multi.py`,
which mirrors samples/interior/interior_multi.py:335-605: the same
commands, the same config values (TrainConfig at :370-394), the same
3-stage schedule (:483-501) with absolute epoch targets, and the same
AP@0.5 evaluation protocol (:504-565), on the PyTorch engine. It runs on
the card unless `--device cpu` is given.

Differences from the JAX command line:
  * `--overrides` refuses a derived key (BATCH_SIZE, IMAGE_SHAPE,
    IMAGE_META_SIZE, vsize, vsize_z) instead of letting the config's
    re-initialisation overwrite it without a word;
  * `--model coco` goes through `MaskRCNN.load_weights(h5, exclude=...)`;
  * the multi-process flags (`--coordinator`, `--num-processes`,
    `--process-id`, or torchrun's or SLURM's environment) start data
    parallelism over torch.distributed (parallel/distributed.py): gloo
    for `--device cpu` or where torchrun or SLURM put more processes on
    a host than it has GPUs, else NCCL; each process on the GPU of its
    local rank; rank 0 alone writes checkpoints and logs;
  * `visualize` writes under `--results` (default "Results", the JAX
    command's fixed directory), and draws with OpenCV where matplotlib
    is not installed.

Usage:
  python -m mulit_view_object_detection_torch.cli.interior_multi train \
      --dataset /path/to/InteriorNet/HD7 --model coco --logs ./logs
  # two processes (run each; or torchrun --nproc-per-node 2 ... train ...)
  python -m mulit_view_object_detection_torch.cli.interior_multi train \
      --dataset ... --coordinator 127.0.0.1:29500 --num-processes 2 \
      --process-id 0
  python -m mulit_view_object_detection_torch.cli.interior_multi evaluate \
      --dataset /path/to/InteriorNet/HD7 --model last --logs ./logs
  # Results/NV2/<key>.jpg: detections drawn on each key's main view
  python -m mulit_view_object_detection_torch.cli.interior_multi visualize \
      --dataset /path/to/InteriorNet/HD7 --model last --logs ./logs
"""

from __future__ import annotations

import argparse
import ast
import os
import time

import numpy as np
import torch.distributed as dist

from ..compat import MaskRCNN
from ..config import Config
from ..data.classes import NYU40_TO_SELECTED, SELECTED_CLASSES
from ..data.generator import load_image_gt
from ..data.interiornet import InteriorNetDataset
from ..data.molding import resize_image
from ..eval.metrics import compute_ap, compute_ap_range
from ..parallel.distributed import init_distributed, local_device
from ..utils import visualize

DEFAULT_LOGS_DIR = "logs"

# The reference's head-swap transfer list for the COCO h5 (interior_multi.
# py:447): the 81-class heads, the 256-channel FPN convs (64 here) and the
# RPN submodel keep their fresh weights. Naming them, rather than riding
# on shape-mismatch skips, leaves no layer half-assigned.
COCO_EXCLUDE = [
    "mrcnn_bbox_fc", "mrcnn_class_logits", "mrcnn_mask",
    "fpn_c5p5", "fpn_c4p4", "fpn_c3p3", "fpn_c2p2",
    "fpn_p5", "fpn_p4", "fpn_p3", "fpn_p2", "rpn_model",
    "mrcnn_mask_conv1", "mrcnn_class_conv1", "mrcnn_mask_bn1",
    "mrcnn_mask_conv2", "mrcnn_mask_bn2", "mrcnn_mask_conv3",
    "mrcnn_mask_bn3", "mrcnn_mask_conv4", "mrcnn_mask_bn4",
    "mrcnn_mask_deconv"]


class InteriorNetConfig(Config):
    """interior_multi.py:61-80 + TrainConfig :370-394."""
    NAME = "interior"
    NUM_CLASSES = len(SELECTED_CLASSES)      # 23 incl. BG
    IMAGES_PER_GPU = 1
    STEPS_PER_EPOCH = 100
    IMAGE_MIN_DIM = 640
    IMAGE_MAX_DIM = 640
    BACKBONE = "resnet50"
    RESNET50_STAGE4_BLOCKS = 5               # fork quirk, model_multi.py:596
    TOP_DOWN_PYRAMID_SIZE = 64
    POST_NMS_ROIS_TRAINING = 500
    PRE_NMS_LIMIT = 1500
    NUM_VIEWS = 2
    GRID_REAS = "conv3d"
    VANILLA = False
    nvox = 40
    nvox_z = 40
    vmin, vmax = -2.5, 2.5
    vmin_z, vmax_z = 1.0, 10.0
    samples = 20
    COMPUTE_DTYPE = "bfloat16"


class InferenceConfig(InteriorNetConfig):
    GPU_COUNT = 1
    IMAGES_PER_GPU = 1
    DETECTION_MIN_CONFIDENCE = 0.7


def load_dataset(dataset_dir, subset):
    ds = InteriorNetDataset()
    ds.load_interiornet(dataset_dir, subset, NYU40_TO_SELECTED,
                        SELECTED_CLASSES)
    ds.prepare()
    return ds


def _split_items(spec):
    """'A=1,B=(2, 3)' -> ['A=1', 'B=(2, 3)']: commas inside brackets stay."""
    items, depth, cur = [], 0, []
    for ch in spec:
        if ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
            continue
        depth += ch in "([{"
        depth -= ch in ")]}"
        cur.append(ch)
    if cur:
        items.append("".join(cur))
    return items


def _apply_overrides(config, spec):
    """Apply 'KEY=VAL,KEY2=VAL2' config overrides (the command-line analog
    of the reference's subclass-and-override pattern; values parse as
    Python literals, else stay strings), then recompute the derived
    values. Unknown keys are refused, so a typo cannot pass unnoticed;
    so are the derived keys that the recompute would overwrite."""
    if not spec:
        return config
    derived = set(vars(type(config)()))
    for item in _split_items(spec):
        key, _, raw = item.partition("=")
        key = key.strip()
        if key in derived:
            raise SystemExit(
                f"--overrides: {key!r} is derived from other keys; "
                f"override those instead")
        if not hasattr(type(config), key):
            raise SystemExit(f"--overrides: unknown config key {key!r}")
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        setattr(config, key, val)
    config.__init__()
    return config


def cmd_train(args):
    """The 3-stage schedule (interior_multi.py:483-501). --epochs gives
    the absolute epoch targets of the stages, so a run resumed with
    --model last skips the stages it has finished. Returns the engine."""
    config = _apply_overrides(InteriorNetConfig(), args.overrides)
    config.display()
    model = MaskRCNN("training", config, args.logs, device=args.device)
    if args.model:
        _load_model_weights(model, args)

    dataset_train = load_dataset(args.dataset, "train")
    dataset_val = load_dataset(args.dataset, "val")

    e1, e2, e3 = (int(x) for x in args.epochs.split(","))
    print("Training grid fusion and heads")
    model.train(dataset_train, dataset_val,
                learning_rate=config.LEARNING_RATE, epochs=e1,
                layers="grid+", save_every_epochs=args.save_every)
    print("Training Resnet stage 4 and up")
    model.train(dataset_train, dataset_val,
                learning_rate=config.LEARNING_RATE, epochs=e2,
                layers="4+", save_every_epochs=args.save_every)
    print("Fine tune all layers")
    model.train(dataset_train, dataset_val,
                learning_rate=config.LEARNING_RATE / 10, epochs=e3,
                layers="all", save_every_epochs=args.save_every)
    return model


def _load_model_weights(model, args):
    """--model last (the newest checkpoint under --logs, epoch count
    included), coco (the Matterport h5 with COCO_EXCLUDE) or a path."""
    if args.model.lower() == "last":
        model.load_weights(model.find_last())
    elif args.model.lower() == "coco":
        model.load_weights(args.coco_weights, exclude=COCO_EXCLUDE)
        report = model.last_h5_report
        print(f"h5 import: {len(report['loaded'])} layers loaded, "
              f"{len(report['skipped'])} skipped: {report['skipped'][:10]}")
    else:
        model.load_weights(args.model)


def _eval_views(dataset, config, model, keys, num_views, rnd_state=0,
                max_views=5, iou_range=False):
    """Mean AP over view_map entries (interior_multi.py:504-565): AP@0.5,
    or COCO-style AP@0.5:0.95 with iou_range=True (the reference computed
    the range too but left it commented out, interior_multi.py:551-552).
    A key whose sample has too few views is skipped; one without a
    detection or a GT mask scores 0. Prints one line per key, with its
    AP and the milliseconds from loading its views to its AP."""
    aps = []
    for count, key in enumerate(keys):
        t0 = time.perf_counter()
        view_ids = dataset.load_view(max_views, key, rnd_state=rnd_state)
        if view_ids is None:
            continue
        view_ids = view_ids[:num_views]
        image, image_meta, gt_class_id, gt_bbox, gt_mask = load_image_gt(
            dataset, config, view_ids[0], use_mini_mask=False)
        views = []
        R = np.zeros((1, num_views, 3, 4), np.float32)
        for i, vid in enumerate(view_ids):
            im = dataset.load_image(vid)
            im, *_ = resize_image(im, min_dim=config.IMAGE_MIN_DIM,
                                  min_scale=config.IMAGE_MIN_SCALE,
                                  max_dim=config.IMAGE_MAX_DIM,
                                  mode=config.IMAGE_RESIZE_MODE)
            views.append(im)
            R[0, i] = dataset.load_R(vid)
        K = dataset.K[None].astype(np.float32)
        r = model.detect([np.stack(views)], Rcam=R, Kmat=K)[0]
        if r["masks"].shape[-1] == 0 or gt_mask.shape[-1] == 0:
            ap = 0.0
        elif iou_range:
            ap = compute_ap_range(
                gt_bbox.astype(np.float32), gt_class_id, gt_mask,
                r["rois"].astype(np.float32), r["class_ids"], r["scores"],
                r["masks"], verbose=False)
        else:
            ap, *_ = compute_ap(gt_bbox.astype(np.float32), gt_class_id,
                                gt_mask, r["rois"].astype(np.float32),
                                r["class_ids"], r["scores"], r["masks"],
                                iou_threshold=0.5)
        aps.append(ap)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{count}: key={key} AP={ap:.4f} "
              f"running meanAP={np.mean(aps):.4f} ms={ms:.3f}", flush=True)
    return float(np.mean(aps)) if aps else 0.0


def cmd_evaluate(args):
    """mAP@50 (or @50:95 with --iou-range) over the val subset's view
    map, the first --limit keys. Returns it."""
    config = _apply_overrides(InferenceConfig(), args.overrides)
    model = MaskRCNN("inference", config, args.logs, device=args.device)
    _load_model_weights(model, args)
    dataset_val = load_dataset(args.dataset, "val")
    keys = list(dataset_val.view_map.keys())
    if args.limit:
        keys = keys[:args.limit]
    mean_ap = _eval_views(dataset_val, config, model, keys,
                          config.NUM_VIEWS, rnd_state=0,
                          iou_range=args.iou_range)
    label = "mAP@50:95" if args.iou_range else "mAP@50"
    print(f"{label}: {mean_ap:.4f}")
    return mean_ap


def cmd_visualize(args):
    """Detections of the first --limit (default 20) keys of the val
    subset's view map, each drawn on its main view into
    <results>/NV<views>/<key>.jpg. Returns the paths written."""
    config = _apply_overrides(InferenceConfig(), args.overrides)
    model = MaskRCNN("inference", config, args.logs, device=args.device)
    _load_model_weights(model, args)
    dataset_val = load_dataset(args.dataset, "val")
    keys = list(dataset_val.view_map.keys())[:args.limit or 20]
    out_dir = os.path.join(args.results, f"NV{config.NUM_VIEWS}")
    paths = []
    for key in keys:
        view_ids = dataset_val.load_view(5, key, rnd_state=0)
        if view_ids is None:
            continue
        view_ids = view_ids[:config.NUM_VIEWS]
        views, R = [], np.zeros((1, config.NUM_VIEWS, 3, 4), np.float32)
        for i, vid in enumerate(view_ids):
            im = dataset_val.load_image(vid)
            im, *_ = resize_image(im, min_dim=config.IMAGE_MIN_DIM,
                                  max_dim=config.IMAGE_MAX_DIM,
                                  mode=config.IMAGE_RESIZE_MODE)
            views.append(im)
            R[0, i] = dataset_val.load_R(vid)
        r = model.detect([np.stack(views)], Rcam=R,
                         Kmat=dataset_val.K[None].astype(np.float32))[0]
        paths.append(visualize.save_image(
            views[0], str(key), r["rois"], r["masks"], r["class_ids"],
            r["scores"], SELECTED_CLASSES, save_dir=out_dir, mode=0))
        print(f"saved {key} -> {out_dir}")
    return paths


def base_parser(description, commands):
    """The arguments every InteriorNet command line shares."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("command", choices=commands)
    parser.add_argument("--dataset", required=True,
                        help="root of InteriorNet HD1/HD7")
    parser.add_argument("--model", default=None,
                        help="'coco', 'last', or a checkpoint path")
    parser.add_argument("--coco-weights", default="mask_rcnn_coco.h5",
                        help="path to the Matterport COCO h5 "
                             "(for --model coco)")
    parser.add_argument("--logs", default=DEFAULT_LOGS_DIR)
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the engine (default: cuda; "
                             "cpu runs the plain versions of the kernels)")
    if "visualize" in commands:
        parser.add_argument("--results", default="Results",
                            help="visualize: the directory the images go "
                                 "under")
    return parser


def main(argv=None):
    """Run a command; returns the trained engine (train), the mean AP
    (evaluate) or the images' paths (visualize)."""
    parser = base_parser(
        "Train/evaluate/visualize multi-view Mask R-CNN on InteriorNet.",
        ["train", "evaluate", "visualize"])
    parser.add_argument("--overrides", default="",
                        help="config overrides KEY=VAL,... (the command-"
                             "line analog of the reference's subclass-and-"
                             "override pattern)")
    parser.add_argument("--save-every", type=int, default=50,
                        help="checkpoint every N epochs (and at stage "
                             "ends); 1 = per epoch for kill/resume")
    parser.add_argument("--epochs", default="301,4001,4501",
                        help="absolute 3-stage epoch targets (reference "
                             "defaults: interior_multi.py:483-501)")
    parser.add_argument("--iou-range", action="store_true",
                        help="evaluate COCO-style mAP@0.5:0.95 instead of "
                             "mAP@0.5")
    # multi-process data parallelism (one process per GPU, or several on
    # the CPU): also started by torchrun's or SLURM's environment with no
    # flags; see parallel/distributed.py
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0, where the processes "
                             "meet")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)
    parallel = init_distributed(args.coordinator, args.num_processes,
                                args.process_id, device=args.device)
    if parallel:
        args.device = str(local_device(args.device))
    try:
        return {"train": cmd_train, "evaluate": cmd_evaluate,
                "visualize": cmd_visualize}[args.command](args)
    finally:
        if parallel:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
