"""Serve a trained multi-view detector over HTTP.

    python -m mulit_view_object_detection_torch.cli.serve \\
        --weights ./logs/interior20xxxxxx/checkpoints --port 8080 \\
        --num-classes 23 --num-views 2 --image-size 640 --batch 4

The port of `mulit_view_object_detection_tpu/cli/serve.py`: the same
flags and config (FOLD_BN, bfloat16), plus `--device`; it runs on the
card unless `--device cpu` is given. The endpoint micro-batches
concurrent POST /detect requests into one fixed-size batch on the card
(serve/batcher.py); see serve/http_server.py for the wire protocol and
`serve.detect_remote` for a client helper. The reference has no serving
path at all: its inference is a bare python loop (model.py:2510-2545).
"""

from __future__ import annotations

import argparse

from ..compat import MaskRCNN
from ..config import Config
from ..serve import serve_forever


def build_config(args):
    class ServeConfig(Config):
        NAME = "serve"
        NUM_CLASSES = args.num_classes
        NUM_VIEWS = args.num_views
        BACKBONE = args.backbone
        TOP_DOWN_PYRAMID_SIZE = args.pyramid_size
        IMAGE_MIN_DIM = args.image_size
        IMAGE_MAX_DIM = args.image_size
        GRID_REAS = args.grid_reas
        nvox = args.nvox
        nvox_z = args.nvox
        samples = args.samples
        COMPUTE_DTYPE = "bfloat16"
        FOLD_BN = True               # serving mode: BNs folded into convs
        # must match the checkpoint's backbone: interior checkpoints use
        # the multi-view fork's 5-block stage 4 (model_multi.py:596)
        RESNET50_STAGE4_BLOCKS = args.stage4_blocks

    ServeConfig.IMAGES_PER_GPU = args.batch
    return ServeConfig()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--weights", required=True,
                        help="a checkpoint directory written by this "
                             "package (save_weights or train) or a Keras "
                             ".h5 file; an Orbax directory of the JAX "
                             "package cannot be read")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--batch", type=int, default=4,
                        help="dispatch batch size (one set of shapes)")
    parser.add_argument("--max-delay-ms", type=float, default=10.0)
    parser.add_argument("--num-classes", type=int, default=23)
    parser.add_argument("--num-views", type=int, default=2)
    parser.add_argument("--image-size", type=int, default=640)
    parser.add_argument("--backbone", default="resnet50")
    parser.add_argument("--pyramid-size", type=int, default=64)
    parser.add_argument("--grid-reas", default="conv3d")
    parser.add_argument("--nvox", type=int, default=40)
    parser.add_argument("--samples", type=int, default=20)
    parser.add_argument("--stage4-blocks", type=int, default=5,
                        help="resnet50 stage-4 block count; 5 = the "
                             "multi-view fork (interior checkpoints), "
                             "3 = the single-view reference backbone")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the engine (default: the "
                             "card; 'cpu' to run on the CPU)")
    return parser.parse_args(argv)


def build_engine(args):
    """The inference engine of `args` on args.device, its weights loaded
    from args.weights."""
    engine = MaskRCNN("inference", build_config(args), "serve_logs",
                      device=args.device)
    engine.load_weights(args.weights)
    return engine


def main(argv=None):
    args = parse_args(argv)
    engine = build_engine(args)
    print(f"serving on :{args.port} (batch={args.batch}, "
          f"{args.image_size}^2 x {args.num_views} views, "
          f"device={args.device})", flush=True)
    serve_forever(engine, args.port, batch_size=args.batch,
                  max_delay_ms=args.max_delay_ms)


if __name__ == "__main__":
    main()
