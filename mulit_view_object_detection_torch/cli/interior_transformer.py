"""Transformer view-fusion InteriorNet command line: train / evaluate /
visualize.

The port of `mulit_view_object_detection_tpu/cli/interior_transformer.py`,
which mirrors samples/interior/interior_transformer.py: TrainConfig at
:378-407 (TOP_DOWN_PYRAMID_SIZE = 72 = d_model, nvox = 60, vmin/vmax =
+-5, GRID_DIST = 6, samples = 1, NUM_VIEWS = 2, GRID_REAS = 'ident',
TRANSFORMER = True), the depth-conditioned detect(..., depths) at :572,
and evaluation on the 'test' subset (:530). It runs on the card unless
`--device cpu` is given. `visualize` draws the test subset's detections
into <--results>/transformer/<key>.jpg (as cli/interior_multi.py's).

    python -m mulit_view_object_detection_torch.cli.interior_transformer \
        evaluate --dataset /path/to/InteriorNet/HD7 --model last
"""

from __future__ import annotations

import os

import numpy as np

from ..compat import MaskRCNN
from ..data.classes import SELECTED_CLASSES
from ..data.generator import load_image_gt
from ..data.molding import resize_image
from ..eval.metrics import compute_ap
from ..utils import visualize
from .interior_multi import (InteriorNetConfig, _load_model_weights,
                             base_parser, load_dataset)


class TransformerConfig(InteriorNetConfig):
    """interior_transformer.py:378-407."""
    NAME = "interior_transformer"
    TOP_DOWN_PYRAMID_SIZE = 72          # == transformer d_model
    nvox = 60
    vmin, vmax = -5.0, 5.0
    GRID_DIST = 6.0
    samples = 1
    NUM_VIEWS = 2
    GRID_REAS = "ident"
    TRANSFORMER = True
    XFORMER_D_MODEL = 72


class TransformerInferenceConfig(TransformerConfig):
    GPU_COUNT = 1
    IMAGES_PER_GPU = 1


def _detect_with_depth(model, dataset, config, view_ids):
    """detect() on the views with their depth maps at P5's resolution."""
    views, R = [], np.zeros((1, config.NUM_VIEWS, 3, 4), np.float32)
    ds = int(config.IMAGE_SHAPE[0]) // config.BACKBONE_STRIDES[3]
    depths = np.zeros((1, config.NUM_VIEWS, ds, ds), np.float32)
    for i, vid in enumerate(view_ids):
        im = dataset.load_image(vid)
        im, *_ = resize_image(im, min_dim=config.IMAGE_MIN_DIM,
                              max_dim=config.IMAGE_MAX_DIM,
                              mode=config.IMAGE_RESIZE_MODE)
        views.append(im)
        R[0, i] = dataset.load_R(vid)
        depths[0, i] = dataset.load_depth(vid, config)
    return model.detect([np.stack(views)], Rcam=R,
                        Kmat=dataset.K[None].astype(np.float32),
                        depths=depths)


def cmd_train(args):
    config = TransformerConfig()
    config.display()
    model = MaskRCNN("training", config, args.logs, device=args.device)
    if args.model:
        _load_model_weights(model, args)
    dataset_train = load_dataset(args.dataset, "train")
    dataset_val = load_dataset(args.dataset, "val")
    model.train(dataset_train, dataset_val,
                learning_rate=config.LEARNING_RATE, epochs=301,
                layers="grid+")
    model.train(dataset_train, dataset_val,
                learning_rate=config.LEARNING_RATE, epochs=4001,
                layers="4+")
    model.train(dataset_train, dataset_val,
                learning_rate=config.LEARNING_RATE / 10, epochs=4501,
                layers="all")
    return model


def cmd_evaluate(args):
    """mAP@50 over the test subset's view map, the first --limit keys."""
    config = TransformerInferenceConfig()
    model = MaskRCNN("inference", config, args.logs, device=args.device)
    _load_model_weights(model, args)
    dataset = load_dataset(args.dataset, "test")
    keys = list(dataset.view_map.keys())
    if args.limit:
        keys = keys[:args.limit]
    aps = []
    for key in keys:
        view_ids = dataset.load_view(5, key, rnd_state=0)
        if view_ids is None:
            continue
        view_ids = view_ids[:config.NUM_VIEWS]
        _, _, gt_class_id, gt_bbox, gt_mask = load_image_gt(
            dataset, config, view_ids[0], use_mini_mask=False)
        r = _detect_with_depth(model, dataset, config, view_ids)[0]
        if r["masks"].shape[-1] == 0 or gt_mask.shape[-1] == 0:
            aps.append(0.0)
            continue
        ap, *_ = compute_ap(gt_bbox.astype(np.float32), gt_class_id, gt_mask,
                            r["rois"].astype(np.float32), r["class_ids"],
                            r["scores"], r["masks"], iou_threshold=0.5)
        aps.append(ap)
        print(f"running meanAP = {np.mean(aps):.4f}")
    mean_ap = float(np.mean(aps)) if aps else 0.0
    print(f"mAP@50: {mean_ap:.4f}")
    return mean_ap


def cmd_visualize(args):
    """Detections of the first --limit (default 20) keys of the test
    subset, each drawn on its main view into <results>/transformer/
    <key>.jpg. Returns the paths written."""
    config = TransformerInferenceConfig()
    model = MaskRCNN("inference", config, args.logs, device=args.device)
    _load_model_weights(model, args)
    dataset = load_dataset(args.dataset, "test")
    out_dir = os.path.join(args.results, "transformer")
    paths = []
    for key in list(dataset.view_map.keys())[:args.limit or 20]:
        view_ids = dataset.load_view(5, key, rnd_state=0)
        if view_ids is None:
            continue
        view_ids = view_ids[:config.NUM_VIEWS]
        r = _detect_with_depth(model, dataset, config, view_ids)[0]
        im = dataset.load_image(view_ids[0])
        im, *_ = resize_image(im, min_dim=config.IMAGE_MIN_DIM,
                              max_dim=config.IMAGE_MAX_DIM,
                              mode=config.IMAGE_RESIZE_MODE)
        paths.append(visualize.save_image(
            im, str(key), r["rois"], r["masks"], r["class_ids"],
            r["scores"], SELECTED_CLASSES, save_dir=out_dir, mode=0))
    return paths


def main(argv=None):
    args = base_parser("Train/evaluate/visualize transformer view fusion "
                       "on InteriorNet.",
                       ["train", "evaluate", "visualize"]).parse_args(argv)
    return {"train": cmd_train, "evaluate": cmd_evaluate,
            "visualize": cmd_visualize}[args.command](args)


if __name__ == "__main__":
    main()
