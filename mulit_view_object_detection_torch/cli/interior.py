"""Single-view InteriorNet command line: train / evaluate.

The port of `mulit_view_object_detection_tpu/cli/interior.py`, which
mirrors samples/interior/interior.py (broken as shipped: it imports the
missing mrcnn.model50; its semantics, per SURVEY.md, are mrcnn/model.py's
with a ResNet-50 backbone). Stages: heads -> 23 epochs, 4+ -> 23, all ->
35 with LR/10 (interior.py:326-352). It runs on the card unless
`--device cpu` is given.

    python -m mulit_view_object_detection_torch.cli.interior evaluate \
        --dataset /path/to/InteriorNet/HD7 --model last --logs ./logs
"""

from __future__ import annotations

import numpy as np

from ..compat import MaskRCNN
from ..config import Config
from ..data.classes import SELECTED_CLASSES
from ..data.generator import load_image_gt
from ..eval.metrics import compute_ap
from .interior_multi import _load_model_weights, base_parser, load_dataset


class SingleViewConfig(Config):
    NAME = "interior_sv"
    NUM_CLASSES = len(SELECTED_CLASSES)
    IMAGES_PER_GPU = 1
    STEPS_PER_EPOCH = 1000
    IMAGE_MIN_DIM = 640
    IMAGE_MAX_DIM = 640
    BACKBONE = "resnet50"
    NUM_VIEWS = 1
    COMPUTE_DTYPE = "bfloat16"


class SingleViewInferenceConfig(SingleViewConfig):
    GPU_COUNT = 1
    IMAGES_PER_GPU = 1
    DETECTION_MIN_CONFIDENCE = 0.7


def cmd_train(args):
    config = SingleViewConfig()
    model = MaskRCNN("training", config, args.logs, device=args.device)
    if args.model:
        _load_model_weights(model, args)
    dataset_train = load_dataset(args.dataset, "train")
    dataset_val = load_dataset(args.dataset, "val")
    # As in the reference, `epochs` is a cumulative target (Keras
    # initial_epoch semantics) and stages 1 and 2 both pass 23
    # (interior.py:339-346): the '4+' stage trains no epoch and 'all'
    # runs epochs 24-35. Kept as it is.
    model.train(dataset_train, dataset_val, config.LEARNING_RATE, 23,
                layers="heads")
    model.train(dataset_train, dataset_val, config.LEARNING_RATE, 23,
                layers="4+")
    model.train(dataset_train, dataset_val, config.LEARNING_RATE / 10, 35,
                layers="all")
    return model


def cmd_evaluate(args):
    """mAP@50 over the first --limit images of the val subset."""
    config = SingleViewInferenceConfig()
    model = MaskRCNN("inference", config, args.logs, device=args.device)
    _load_model_weights(model, args)
    dataset = load_dataset(args.dataset, "val")
    ids = dataset.image_ids[:args.limit or len(dataset.image_ids)]
    aps = []
    for image_id in ids:
        image, _, gt_class_id, gt_bbox, gt_mask = load_image_gt(
            dataset, config, image_id, use_mini_mask=False)
        r = model.detect([image])[0]
        if r["masks"].shape[-1] == 0 or gt_mask.shape[-1] == 0:
            aps.append(0.0)
            continue
        ap, *_ = compute_ap(gt_bbox.astype(np.float32), gt_class_id, gt_mask,
                            r["rois"].astype(np.float32), r["class_ids"],
                            r["scores"], r["masks"], iou_threshold=0.5)
        aps.append(ap)
    mean_ap = float(np.mean(aps)) if aps else 0.0
    print(f"mAP@50: {mean_ap:.4f}")
    return mean_ap


def main(argv=None):
    args = base_parser("Train/evaluate single-view Mask R-CNN on "
                       "InteriorNet.", ["train", "evaluate"]).parse_args(argv)
    return {"train": cmd_train, "evaluate": cmd_evaluate}[args.command](args)


if __name__ == "__main__":
    main()
