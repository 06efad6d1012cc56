"""Per-variant inference time by the loop-difference method: where do
the milliseconds go?

    python -m mulit_view_object_detection_torch.cli.profile_variants \\
        [variant[:bN] ...] [--device cuda]

The port's copy of the top-level `tools/profile_variants.py`, which
imports the JAX package. Variants: vanilla and vanilla4 (2 and 4 views
through the backbone, no geometry), ident and ident4 (the unprojection
and reprojection without the U-Net), conv3d (the flagship) and conv3d4,
lstm3d4 (4-view ConvLSTM) and xformer (the transformer fusion); a
`:bN` suffix runs batch N. Every variant has the JAX tool's `Base`
shapes: 640^2, ResNet-50 with the fork's 5-block stage 4, pyramid 64, a
40^3 grid, 20 depth samples, bfloat16, PRE_NMS_LIMIT 1500,
POST_NMS_ROIS_INFERENCE 500 and FOLD_BN on. The TPU lowerings
(ZFOLD_FUSION, PHASE_DECONV, LSTM_HOIST_INPUT) stay off: the port runs
the plain layers they lower (`config.py::check_supported` refuses them),
and their `BENCH_*` environment variables are not read.

`time_variant` times the model's forward up to the detections as the
JAX tool times its `infer_loop`: 2 and then 12 iterations, each one's
images chained through the previous iteration's detections (+ 0 *
detection), so that none can be skipped, the device synchronised at
both ends; ms/frame = (t12 - t2) / 10 / batch. Weights are seeded and
BN-folded (`utils/bn_fold.py::fold_bn_model`). One JSON line a variant:
the JAX tool's fields (variant, batch, ms_per_frame, fps) plus the
device's name and its power limit as nvidia-smi gives them.

`variant_config` is the one source of the variants' configs: the other
tools and chip_smoke.py build theirs from it. What the tools share
(the timer, the inference loop, the flagship training workload) is in
`cli/measure.py`.

Runs on the card unless `--device cpu` is passed; asked for cuda
without a card it raises.
"""

from __future__ import annotations

import argparse
import json

from ..config import Config
from .measure import (
    card_fields, inference_setup, infer_loop, resolve_device, time_loop)

VARIANTS = ("vanilla", "vanilla4", "ident", "ident4", "conv3d", "conv3d4",
            "lstm3d4", "xformer")


class Base(Config):
    NAME = "prof"
    NUM_CLASSES = 23
    BACKBONE = "resnet50"
    # multi-view fork backbone: 5-block stage 4 (model_multi.py:596)
    RESNET50_STAGE4_BLOCKS = 5
    TOP_DOWN_PYRAMID_SIZE = 64
    IMAGE_MIN_DIM = 640
    IMAGE_MAX_DIM = 640
    PRE_NMS_LIMIT = 1500
    POST_NMS_ROIS_INFERENCE = 500
    DETECTION_MAX_INSTANCES = 100
    nvox = 40
    nvox_z = 40
    vmin, vmax = -2.5, 2.5
    vmin_z, vmax_z = 1.0, 10.0
    samples = 20
    COMPUTE_DTYPE = "bfloat16"
    FOLD_BN = True


_VARIANT_KEYS = {
    "vanilla": dict(NUM_VIEWS=2, VANILLA=True),
    "vanilla4": dict(NUM_VIEWS=4, VANILLA=True),
    "ident": dict(NUM_VIEWS=2, GRID_REAS="ident"),
    "ident4": dict(NUM_VIEWS=4, GRID_REAS="ident"),
    "conv3d": dict(NUM_VIEWS=2, GRID_REAS="conv3d"),
    "conv3d4": dict(NUM_VIEWS=4, GRID_REAS="conv3d"),
    "lstm3d4": dict(NUM_VIEWS=4, GRID_REAS="lstm3d"),
    "xformer": dict(NUM_VIEWS=2, GRID_REAS="ident", TRANSFORMER=True,
                    TOP_DOWN_PYRAMID_SIZE=72, XFORMER_D_MODEL=72,
                    samples=1),
}


def variant_config(name, batch=1):
    """The config of variant `name` at `batch` images (the JAX tool's
    `variant_config` with its TPU lowerings off)."""
    if name not in _VARIANT_KEYS:
        raise ValueError(name)
    cls = type(name, (Base,), dict(_VARIANT_KEYS[name],
                                   IMAGES_PER_GPU=batch))
    return cls()


def time_variant(name, batch=1, device="cuda"):
    """ms/frame of variant `name` at `batch`; returns the JSON line's
    fields."""
    device = resolve_device(device)
    cfg = variant_config(name, batch)
    model, inputs = inference_setup(cfg, device)
    ms = time_loop(lambda n: infer_loop(model, inputs, n), device) \
        / cfg.BATCH_SIZE
    return {"variant": name, "batch": cfg.BATCH_SIZE,
            "ms_per_frame": round(ms, 4), "fps": round(1e3 / ms, 2),
            **card_fields(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=["vanilla", "conv3d"],
                    help="variant names, each optionally suffixed :bN")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for v in args.variants:
        name, _, b = v.partition(":b")
        print(json.dumps(time_variant(name, int(b) if b else 1,
                                      args.device)), flush=True)


if __name__ == "__main__":
    main()
