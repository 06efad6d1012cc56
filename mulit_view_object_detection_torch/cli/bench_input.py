"""Host input-pipeline throughput: can the host's batch generator keep
the card fed?

    python -m mulit_view_object_detection_torch.cli.bench_input \\
        [--image-size 640] [--num-views 2] [--batches 48] \\
        [--workers 1 4 8] [--mode thread|process] [--uint8]

The port's copy of the top-level `tools/bench_input.py`, which imports
the JAX package: the same config, flags and JSON line, over the port's
`data/generator.py`. It measures batches/s (and frames/s = batches x
BATCH_SIZE, view images/s = that x NUM_VIEWS) of the prefetcher over
the synthetic multi-view dataset at the reference's flagship shape
(640^2, 2 views, mini-masks, flip augmentation) for several worker
counts: image synthesis, resizing and molding, mask molding, RPN
target building and batching. Pure host work; no device.

Thread mode runs `BatchPrefetcher`; process mode `ProcessPrefetcher`,
whose spawned workers each hold at most one finished batch in a pipe of
their own (the JAX prefetcher shares one queue of `prefetch` batches).
After the first batch (which warms the caches) the batches the workers
piled up meanwhile are drained untimed, so that none is counted at no
cost; a worker's error met while draining is kept, not dropped: the
thread sentinel goes back on the queue and the process error tuple is
raised, so it surfaces as PrefetchError.
"""

from __future__ import annotations

import argparse
import json
import time

from ..config import Config
from ..data import augment
from ..data.generator import (
    BatchPrefetcher, ProcessPrefetcher, make_batch)
from ..data.synthetic import SyntheticMultiViewDataset


class InputBenchConfig(Config):
    """Module-level (so spawn-picklable) bench config."""
    NAME = "bench_input"
    NUM_CLASSES = 23
    BACKBONE = "resnet50"
    MAX_GT_INSTANCES = 100
    USE_MINI_MASK = True

    def __init__(self, image_size, num_views, uint8):
        self.NUM_VIEWS = num_views
        self.IMAGE_MIN_DIM = image_size
        self.IMAGE_MAX_DIM = image_size
        self.UINT8_IMAGE_TRANSFER = uint8
        super().__init__()


class BenchBatchFn:
    """Picklable make_fn: ProcessPrefetcher's spawned workers pickle the
    callable, so a local closure over the dataset and config would fail
    at start."""

    def __init__(self, ds, cfg, aug):
        self.ds, self.cfg, self.aug = ds, cfg, aug

    def __call__(self, seed):
        return make_batch(self.ds, self.cfg, rnd_state=seed,
                          augmentation=self.aug)


def make_fn(image_size, num_views, uint8=False):
    """The bench's (config, BenchBatchFn): 8 synthetic scenes, seed 0,
    flips with probability 0.5."""
    cfg = InputBenchConfig(image_size, num_views, uint8)
    ds = SyntheticMultiViewDataset(num_scenes=8, num_views=num_views,
                                   image_size=image_size, num_classes=4,
                                   seed=0)
    return cfg, BenchBatchFn(ds, cfg, augment.Fliplr(0.5))


def prefetcher(mode, fn, workers):
    if mode == "process":
        return ProcessPrefetcher(fn, num_procs=workers)
    return BatchPrefetcher(fn, num_threads=workers, prefetch=8)


def drain(pf):
    """Take the batches `pf`'s workers have ready, untimed. A thread
    worker's error sentinel is put back and ends the drain; a process
    worker's error is raised by the prefetcher itself (PrefetchError)."""
    if isinstance(pf, ProcessPrefetcher):
        while pf._conns[pf._next].poll(0):
            next(pf)
        return
    while True:
        try:
            item = pf._queue.get_nowait()
        except Exception:       # queue.Empty
            return
        if item is BatchPrefetcher._ERROR:
            pf._queue.put(item)
            return


def measure(mode, fn, cfg, workers, batches):
    """The JSON line's fields for `workers` workers of `mode`."""
    pf = prefetcher(mode, fn, workers)
    try:
        it = iter(pf)
        next(it)                # warm caches (anchors etc.)
        drain(pf)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        dt = time.perf_counter() - t0
    finally:
        pf.close()
    bps = batches / dt
    return {
        "metric": "host_input_pipeline",
        "mode": mode,
        "uint8": bool(cfg.UINT8_IMAGE_TRANSFER),
        "workers": workers,
        "image_size": int(cfg.IMAGE_MAX_DIM),
        "batches_per_sec": round(bps, 3),
        "frames_per_sec": round(bps * cfg.BATCH_SIZE, 3),
        "view_images_per_sec": round(bps * cfg.BATCH_SIZE * cfg.NUM_VIEWS,
                                     3),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image-size", type=int, default=640)
    p.add_argument("--num-views", type=int, default=2)
    p.add_argument("--batches", type=int, default=48)
    p.add_argument("--workers", type=int, nargs="*", default=[1, 4, 8])
    p.add_argument("--mode", choices=["thread", "process"], default="thread")
    p.add_argument("--uint8", action="store_true",
                   help="UINT8_IMAGE_TRANSFER batches: skip the host-side "
                        "float32 mold (the mean subtraction moves to the "
                        "device) and emit 4x smaller image buffers")
    args = p.parse_args(argv)
    cfg, fn = make_fn(args.image_size, args.num_views, args.uint8)
    for workers in args.workers:
        print(json.dumps(measure(args.mode, fn, cfg, workers, args.batches)),
              flush=True)


if __name__ == "__main__":
    main()
