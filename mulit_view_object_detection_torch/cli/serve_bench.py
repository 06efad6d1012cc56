"""Serving throughput: MicroBatcher end to end on the card.

    python -m mulit_view_object_detection_torch.cli.serve_bench \\
        [--batch 4] [--requests 64] [--size 640] [--device cuda]

The port's copy of the top-level `tools/serve_bench.py`, which imports
the JAX package: the same flags (plus `--device`), config (the flagship
2-view conv3d model at bfloat16 with FOLD_BN, seeded weights), warm-up
(one full batch) and one JSON line (requests/s, mean latency, batches,
padded slots), plus the mean number of detections a request (unmolding
each costs host time) and the device's name and, on the card, its name
and power limit as nvidia-smi gives them. It measures sustained request
throughput and per-request latency through the whole serving stack
(molding, the forward, unmolding and the batching queue) at an offered
load of `--requests` scenes submitted at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..compat import MaskRCNN
from ..config import Config
from ..serve import MicroBatcher


def build_config(batch, size):
    class ServeConfig(Config):
        NAME = "serve_bench"
        NUM_CLASSES = 23
        NUM_VIEWS = 2
        BACKBONE = "resnet50"
        # multi-view fork backbone: 5-block stage 4 (model_multi.py:596)
        RESNET50_STAGE4_BLOCKS = 5
        TOP_DOWN_PYRAMID_SIZE = 64
        GRID_REAS = "conv3d"
        IMAGE_MIN_DIM = size
        IMAGE_MAX_DIM = size
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

    ServeConfig.IMAGES_PER_GPU = batch
    return ServeConfig()


def scene(size, num_views):
    """tools/serve_bench.py's request: seeded pixels, identity rotations,
    the second view 0.3 m along x, focal 0.625 * size."""
    rng = np.random.RandomState(0)
    views = (rng.rand(num_views, size, size, 3) * 255).astype(np.uint8)
    Rcam = np.zeros((1, num_views, 3, 4), np.float32)
    Rcam[:, :, :3, :3] = np.eye(3)
    Rcam[:, 1, 0, 3] = 0.3
    f = size * 0.625
    Kmat = np.array([[[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]]],
                    np.float32)
    return views, Rcam, Kmat


def measure(engine, batch, requests, max_delay_ms=20.0):
    """Warm up with one full batch, then submit `requests` copies of the
    scene at once and wait for all; returns the result line's fields."""
    cfg = engine.config
    size = cfg.IMAGE_MAX_DIM
    views, Rcam, Kmat = scene(size, cfg.NUM_VIEWS)
    with MicroBatcher(engine, batch_size=batch,
                      max_delay_ms=max_delay_ms) as mb:
        for fu in [mb.submit(views, Rcam=Rcam, Kmat=Kmat)
                   for _ in range(batch)]:
            fu.result(timeout=2400)
        t0 = time.perf_counter()
        futs = [mb.submit(views, Rcam=Rcam, Kmat=Kmat)
                for _ in range(requests)]
        found = [len(fu.result(timeout=2400)["class_ids"]) for fu in futs]
        wall = time.perf_counter() - t0
        stats = mb.stats()
    return {
        "metric": "serving_requests_per_sec",
        "value": requests / wall,
        "unit": "requests/s on one device (end to end, host included)",
        "batch": batch,
        "requests": requests,
        "mean_latency_ms": stats["mean_latency_ms"],
        "batches": stats["batches"],
        "padded_slots": stats["padded_slots"],
        "mean_detections": sum(found) / requests,
        "image": f"{size}^2 x {cfg.NUM_VIEWS} views",
    }


def card(device):
    """The device's name; on the card also nvidia-smi's name and power
    limit line."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": str(device)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(device),
            "nvidia_smi": smi[device.index or 0]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--max-delay-ms", type=float, default=20.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the card)")
    args = ap.parse_args(argv)
    engine = MaskRCNN("inference", build_config(args.batch, args.size),
                      "serve_bench_logs", device=args.device)
    out = measure(engine, args.batch, args.requests, args.max_delay_ms)
    print(json.dumps({**out, **card(args.device)}), flush=True)


if __name__ == "__main__":
    main()
