"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device  — a CUDA device is required (no CPU fallback); prints the
               `nvidia-smi --query-gpu=name,power.limit` line.
  2. build   — compiles the CUDA kernels from csrc/ with nvcc.
  3. kernels — each of the six kernels (unprojection in the fused and the
               per-view layout and reprojection, forward and backward)
               against its plain torch version at the flagship shapes
               (B=1, C=64, 40^3 grid, 20 depth samples; P4/P5/P6 =
               40^2/20^2/10^2; V=2 for the fused unprojection, and V=4
               at P4 too, V=4 for the per-view one), float32 with TF32
               off and bfloat16: max abs error vs the stated tolerance;
               the device time per call (CUDA events around 20 calls queued
               behind a spinning kernel) of the kernel, of the plain
               version and of F.grid_sample (the library call that
               computes the same gather, or its backward: timed only,
               never used by the port); the median host-clock call time;
               the bound (bytes over 3.35 TB/s or operations over
               67 TFLOP/s, whichever is larger) from this run's inputs,
               the achieved GB/s and the share of the bound (or, where a
               kernel runs under its HBM bound because the repeated calls
               are served from the 50 MB L2, l2_served=True and no
               share). Every line names the variant launched (the
               flagship tensors must launch the vector forward, the
               unprojection's walk backward and the reprojection's vector
               backward); the unprojection lines also the largest and mean
               number of valid taps that land on one pixel of a view (the
               adds a direct scatter makes to one address per channel).
               The reprojection backward is held to the plain version on a
               CPU copy, exactly, and to itself run to run. Then one level
               of each other variant against plain: the scalar forward and
               the direct backward of both unprojection layouts and the
               reprojection's scalar forward and backward (P4 tensors
               offset by one element, so not 16-byte aligned), and the
               reprojection's chunked backward (80^2 pixels a sample).
               Last, one profiled reprojection backward a dtype: one
               kernel, no memset, no cast.
  4. main    — inference: the engine (compat.MaskRCNN.detect) at the
               flagship config (2 views at 640^2, ResNet-50 with a 5-block
               stage 4, pyramid 64, conv3d, 40^3 grid, 20 samples,
               bfloat16) with seeded random weights, on 3 requests after one
               warm-up; forward launches must be 3 levels x 3 calls (the
               unprojection's in its vector variant) and no backward
               kernel runs; every reprojection launch the vector
               variants. Then the same requests once more, timed part by
               part on the host clock, and one under torch.profiler: its
               host synchronisations. Then the device time of the layout
               copies on either side of the reprojection at each level
               (the fused grid made [B, X, Y, Z, C] for the kernel, the
               rays reshaped by DepthCollapse, and their gradients).
  5. train   — training: compat.MaskRCNN("training").train on a 640^2
               2-view synthetic dataset at the flagship training config
               (bench_train.py's: POST_NMS_ROIS_TRAINING 500,
               TRAIN_ROIS_PER_IMAGE 200, MAX_GT_INSTANCES 100, stage "all",
               frozen BatchNorm), 1 epoch of 3 steps (every kernel launched
               exactly 3 levels x 3 steps; the unprojection's forward in
               its vector variant, its backward in the walk), then a new
               engine resumes from the checkpoint to epoch 2 with
               validation. Losses finite,
               parameters float32. Then the step time after warm-up (host
               clock) and one profiled step's device time.
  6. parity  — inference in float32, TF32 off: detections of the CPU run
               (plain versions) and the GPU run (kernels) must agree, for
               conv3d, add, mean, ident and lstm3d at 256^2 (16^3 grid, 8
               samples) and for the transformer at its 640^2 config (at
               256^2 no ROI routes to P5, the one level it fills).
  7. train parity — one training step each of conv3d (stage "all") and
               lstm3d (stage "grid+": the backbone frozen, so that the
               backbone's ReLU flips stay out of the per-view backward's
               check) at 256^2 in float32, TF32 off, CPU (plain versions)
               against GPU (kernels) from the same weights, batch and ROI
               priorities:
               the five losses within 1e-4 relative, every gradient within
               1e-3 of its tensor's largest magnitude (floor: 1e-6 of the
               step's largest) for 95% of the tensors, and within 1e-2 for
               all (ReLU flips, see GRAD_TOL).
  8. lstm3d main — inference at the per-view kernel's configuration of
               record (phase 4's model with 4 views and lstm3d fusion,
               tools/profile_variants.py:90-93), 3 requests after one
               warm-up: the per-view forward launches 3 levels x 3 calls,
               the fused one never, no backward kernel; the host-clock
               breakdown of each request.
  9. lstm3d train — 3 training steps of that model on a 640^2 4-view
               synthetic dataset (phase 5's training settings): the
               per-view forward and backward launch 3 x 3 times; losses
               finite, parameters float32; step time and one profiled
               step's device time.
 10. transformer — the transformer config (tools/profile_variants.py:
               94-101: 2 views, pyramid and d_model 72, one sample, the
               XFORMER_* defaults) with seeded depths: 3 detect requests
               and 3 training steps (dropout 0.1 from the engine's
               generator); no geometry kernel launches.
The line before the last is the kernels' JSON record; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False — needs a GPU")

import torch.nn.functional as F  # noqa: E402

from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.config import Config  # noqa: E402
from mulit_view_object_detection_torch.data.generator import (  # noqa: E402
    make_batch)
from mulit_view_object_detection_torch.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset)
from mulit_view_object_detection_torch.kernels import (  # noqa: E402
    build, reproject, unproject)
from mulit_view_object_detection_torch.ops import projection as plain  # noqa: E402
from mulit_view_object_detection_torch.train.optim import (  # noqa: E402
    make_optimizer)
from mulit_view_object_detection_torch.train.step import (  # noqa: E402
    draw_priorities, loss_and_grads, train_step)
from mulit_view_object_detection_torch.train.trainable import (  # noqa: E402
    trainable_mask)
from tools.torch_kernel_ab import host_syncs  # noqa: E402

DEV = torch.device("cuda", 0)
LEVELS = {"P4": 40, "P5": 20, "P6": 10}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12                 # outside the tensor cores (the kernels'
                                   # arithmetic is float32 in any dtype)
BF16_STEP = 2.0 ** -7           # a bf16 step: at most 2^-7 of the value
# Forward: unprojection plain and kernel round the same float32 ops in the
# same order (explicitly rounded in the kernel), then the same ReLU;
# bfloat16 rounds the same float32 sum once: exact in both layouts.
# Reprojection copies values: exact. Its backward adds each voxel's g rows
# in float32 from 0 in ascending (sample, pixel) order and rounds once, as
# the plain index_add_ does on the CPU: exact against the plain version
# computed on a CPU copy (on the card the plain version adds with atomics
# in no fixed order). Absolute tolerances.
TOL = {("unproject", torch.float32): 0.0,
       ("unproject", torch.bfloat16): 0.0,
       ("unproject_view", torch.float32): 0.0,
       ("unproject_view", torch.bfloat16): 0.0,
       ("reproject", torch.float32): 0.0,
       ("reproject", torch.bfloat16): 0.0,
       ("reproject_bwd", torch.float32): 0.0,
       ("reproject_bwd", torch.bfloat16): 0.0}
# The unprojection's backward: both sides sum in float32 with atomics in
# no fixed order (up to 4,720 terms per element at P6, phase 3's
# adds_per_pixel_max), so |got - ref| <= 1e-4 * max|ref|; bfloat16 casts
# that sum once: where the two sums straddle a rounding boundary they
# differ by one bf16 step of the element more.
BWD_REL = 1e-4
REPLACES = {
    "unproject": "mulit_view_object_detection_tpu/kernels/"
                 "unproject_pallas.py:185",
    "unproject_bwd": "mulit_view_object_detection_tpu/kernels/"
                     "unproject_pallas.py:293",
    "unproject_view": "mulit_view_object_detection_tpu/kernels/"
                      "unproject_pallas.py:250",
    "unproject_view_bwd": "mulit_view_object_detection_tpu/kernels/"
                          "unproject_pallas.py:293",
    "reproject": "mulit_view_object_detection_tpu/kernels/"
                 "reproject_pallas.py:168",
    "reproject_bwd": "mulit_view_object_detection_tpu/kernels/"
                     "reproject_pallas.py:228",
}
JSON_NAMES = {"unproject": "unproject_fused",
              "unproject_bwd": "unproject_fused_bwd",
              "unproject_view": "unproject",
              "unproject_view_bwd": "unproject_bwd",
              "reproject": "reproject_nearest",
              "reproject_bwd": "reproject_nearest_bwd"}
# Train-step parity, CPU vs GPU: a ReLU whose input lies within float32
# noise of zero passes its gradient on one device and not the other. At
# this size one such input (|x| < 3e-5) in each of res4e's and res4f's
# bn2a changes sign between the CPU and the H100: it moves the tensors
# before it by up to 0.6%, and every layer below by ~0.1% through the
# backward pass; run to run on the GPU alone (same forward) the step
# repeats to 3e-6. So every gradient is held within GRAD_FLIP_TOL of its
# tensor's largest magnitude, and all but GRAD_FLIP_SHARE of the tensors
# within GRAD_TOL.
GRAD_TOL = 1e-3
GRAD_FLIP_TOL = 1e-2
GRAD_FLIP_SHARE = 0.05
_CSRC = "mulit_view_object_detection_torch/csrc/"
SOURCES = {"unproject": _CSRC + "unproject.cu",
           "unproject_bwd": _CSRC + "unproject.cu",
           "unproject_view": _CSRC + "unproject.cu",
           "unproject_view_bwd": _CSRC + "unproject.cu",
           "reproject": _CSRC + "reproject.cu",
           "reproject_bwd": _CSRC + "reproject.cu"}
KERNELS = ("unproject", "unproject_bwd", "unproject_view",
           "unproject_view_bwd", "reproject", "reproject_bwd")


class FlagshipConfig(Config):
    """bench.py's flagship BenchConfig, with the TPU-only lowerings off
    (the port runs the plain layers they lower)."""
    NAME = "flagship_640"
    NUM_CLASSES = 23
    NUM_VIEWS = 2
    BACKBONE = "resnet50"
    RESNET50_STAGE4_BLOCKS = 5
    TOP_DOWN_PYRAMID_SIZE = 64
    GRID_REAS = "conv3d"
    IMAGE_MIN_DIM = 640
    IMAGE_MAX_DIM = 640
    PRE_NMS_LIMIT = 1500
    POST_NMS_ROIS_INFERENCE = 500
    DETECTION_MAX_INSTANCES = 100
    DETECTION_MIN_CONFIDENCE = 0.0   # random weights still give rows
    nvox = 40
    nvox_z = 40
    vmin, vmax = -2.5, 2.5
    vmin_z, vmax_z = 1.0, 10.0
    samples = 20
    COMPUTE_DTYPE = "bfloat16"


class FlagshipTrainConfig(FlagshipConfig):
    """bench_train.py:22-53's flagship training config; 3 steps an
    epoch, 1 validation step."""
    NAME = "flagship_train_640"
    POST_NMS_ROIS_TRAINING = 500
    TRAIN_ROIS_PER_IMAGE = 200
    MAX_GT_INSTANCES = 100
    STEPS_PER_EPOCH = 3
    VALIDATION_STEPS = 1


class Lstm4Config(FlagshipConfig):
    """The per-view kernel's configuration of record: bench.py:97-116's
    BenchConfig with 4 views and lstm3d fusion (tools/profile_variants.py:
    90-93, BENCH_4VIEW_r05.json's 4view_640_lstm3d row)."""
    NAME = "lstm3d4_640"
    NUM_VIEWS = 4
    GRID_REAS = "lstm3d"


class Lstm4TrainConfig(Lstm4Config):
    """Lstm4Config with FlagshipTrainConfig's training settings."""
    NAME = "lstm3d4_train_640"
    POST_NMS_ROIS_TRAINING = 500
    TRAIN_ROIS_PER_IMAGE = 200
    MAX_GT_INSTANCES = 100
    STEPS_PER_EPOCH = 3


class XformerConfig(FlagshipConfig):
    """tools/profile_variants.py:94-101: 2 views, the transformer on P5
    (pyramid and d_model 72, one sample per ray), XFORMER_* defaults
    (6 layers, 8 heads, dff 256, dropout 0.1)."""
    NAME = "xformer_640"
    GRID_REAS = "ident"
    TRANSFORMER = True
    TOP_DOWN_PYRAMID_SIZE = 72
    XFORMER_D_MODEL = 72
    samples = 1


class XformerTrainConfig(XformerConfig):
    NAME = "xformer_train_640"
    POST_NMS_ROIS_TRAINING = 500
    TRAIN_ROIS_PER_IMAGE = 200
    MAX_GT_INSTANCES = 100
    STEPS_PER_EPOCH = 3


class Flagship256(FlagshipConfig):
    """The shape of __graft_entry__._flagship_config(256), in float32."""
    NAME = "flagship_256"
    IMAGE_MIN_DIM = 256
    IMAGE_MAX_DIM = 256
    RPN_ANCHOR_SCALES = (16, 32, 64, 128, 256)
    nvox = 16
    nvox_z = 16
    samples = 8
    COMPUTE_DTYPE = "float32"


class Flagship256Train(Flagship256):
    """The 256^2 parity model training, with fewer proposals and ROIs so
    that fewer NMS and top-k decisions sit near a float32 tie."""
    NAME = "flagship_train_256"
    PRE_NMS_LIMIT = 500
    POST_NMS_ROIS_TRAINING = 100
    TRAIN_ROIS_PER_IMAGE = 50
    MAX_GT_INSTANCES = 10


def with_fusion(cls, mode):
    """`cls` with GRID_REAS = mode (its name suffixed)."""
    return type(f"{cls.__name__}_{mode}", (cls,), {
        "NAME": f"{cls.NAME}_{mode}", "GRID_REAS": mode})


class Xformer640F32(XformerConfig):
    """The transformer's parity config: its config of record in float32."""
    NAME = "xformer_640_f32"
    COMPUTE_DTYPE = "float32"


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def poses(rng, b, v):
    """Seeded cam->world poses: view 0 is the grid's frame, the others
    turn by up to ~17 degrees and shift by up to 0.6 m, so that part of
    the grid falls outside them."""
    out = np.tile(np.eye(3, 4, dtype=np.float32), (b, v, 1, 1))
    for i in range(b):
        for j in range(1, v):
            a = rng.uniform(-0.3, 0.3, 3)
            c, s = np.cos(a), np.sin(a)
            rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
            ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
            rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
            out[i, j, :, :3] = rx @ ry @ rz
            out[i, j, :, 3] = rng.uniform(-0.6, 0.6, 3)
    return out


def intrinsics(b, hw):
    return np.tile(np.array([[0.9 * hw, 0, hw / 2], [0, 0.9 * hw, hw / 2],
                             [0, 0, 1]], np.float32), (b, 1, 1))


def median_ms(fn, runs=30):
    """Median host-clock time of one call that ends in a synchronise
    (CUDA events around each call: host launch overhead included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs=20):
    """Device time per call, ms: the calls are queued behind a kernel that
    spins (torch.cuda._sleep) for longer than the host takes to launch
    them, so the CUDA events around them time the device running them back
    to back, not the host's launch overhead. (A call that synchronises the
    host would stall the queue and count host time too.)"""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * runs * host_ms + 5) * 2e6))   # <= 2 GHz
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def device_profile(fn, attempts=3):
    """One profiled call of fn (torch.profiler). Returns (device time of
    its kernels, copies and memsets in ms, device events), or
    (None, None) if no attempt recorded device time."""
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in events)
        if busy_us > 0:
            return busy_us / 1e3, sum(e.count for e in events)
    return None, None


def device_events(fn):
    """The device events of one profiled call of fn (torch.profiler):
    {kernel, memset or copy name: count}."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def bound_ms(nbytes, flops):
    """(least time the card could take in ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    say("device", name=json.dumps(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name


def phase_build():
    t = time.perf_counter()
    build.build()
    build.library.cache_clear()
    build.library()
    say("build", seconds=round(time.perf_counter() - t, 3),
        library=build.library_path().relative_to(build.BUILD_DIR.parents[1]))


def _unproject_cases(feats, x, y, s, v, dtype):
    """The unprojection's forward and backward: (kernel, plain, library,
    bytes, flops, tolerance check) for each, at one level."""
    bv, p, c = feats.shape
    n = x.shape[1]
    es = feats.element_size()
    saved = unproject.gather_fused(feats, x, y, s, s, v, True)
    gen = torch.Generator(DEV).manual_seed(s)
    g = torch.randn(saved.shape, generator=gen, device=DEV).to(dtype)
    # F.grid_sample: NCHW view of the features, coordinates normalised for
    # align_corners=True, in the input's dtype (the library's rule)
    inp = feats.reshape(bv, s, s, c).permute(0, 3, 1, 2)
    coords = torch.stack([2 * x / (s - 1) - 1, 2 * y / (s - 1) - 1],
                         -1)[:, None].to(dtype)
    lib_in = inp.detach().clone().requires_grad_()
    lib_out = F.grid_sample(lib_in, coords, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
    lib_g = torch.randn(lib_out.shape, generator=gen, device=DEV).to(dtype)
    passing = int((saved > 0).sum())
    coord_bytes = 2 * bv * n * 4
    return {
        "unproject": (
            lambda: unproject.gather_fused(feats, x, y, s, s, v, True),
            lambda: plain.bilinear_gather_fused(feats, x, y, s, s, v, True),
            lambda: F.grid_sample(inp, coords, mode="bilinear",
                                  padding_mode="zeros", align_corners=True),
            bv * p * c * es + coord_bytes + saved.numel() * es,
            7 * saved.numel()),
        # the backward reads saved everywhere and g where saved > 0
        "unproject_bwd": (
            lambda: unproject.gather_fused_bwd(g, saved, x, y, s, s, v, True),
            lambda: plain.bilinear_gather_fused_bwd(g, saved, x, y, s, s, v,
                                                    True, dtype),
            lambda: torch.autograd.grad(lib_out, lib_in, lib_g,
                                        retain_graph=True),
            saved.numel() * es + passing * es + coord_bytes
            + bv * p * c * es,
            8 * passing),
    }


def _unproject_view_cases(feats, x, y, s, dtype):
    """The per-view unprojection's forward and backward, as
    _unproject_cases gives the fused one's."""
    bv, p, c = feats.shape
    n = x.shape[1]
    es = feats.element_size()
    gen = torch.Generator(DEV).manual_seed(s + 1)
    g = torch.randn((bv, n, c), generator=gen, device=DEV).to(dtype)
    inp = feats.reshape(bv, s, s, c).permute(0, 3, 1, 2)
    coords = torch.stack([2 * x / (s - 1) - 1, 2 * y / (s - 1) - 1],
                         -1)[:, None].to(dtype)
    lib_in = inp.detach().clone().requires_grad_()
    lib_out = F.grid_sample(lib_in, coords, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
    lib_g = torch.randn(lib_out.shape, generator=gen, device=DEV).to(dtype)
    coord_bytes = 2 * bv * n * 4
    return {
        "unproject_view": (
            lambda: unproject.gather(feats, x, y, s, s),
            lambda: plain.bilinear_gather(feats, x, y, s, s),
            lambda: F.grid_sample(inp, coords, mode="bilinear",
                                  padding_mode="zeros", align_corners=True),
            bv * p * c * es + coord_bytes + bv * n * c * es,
            7 * bv * n * c),
        # reads all of g, writes dfeats
        "unproject_view_bwd": (
            lambda: unproject.gather_bwd(g, x, y, s, s),
            lambda: plain.bilinear_gather_bwd(g, x, y, s, s, dtype),
            lambda: torch.autograd.grad(lib_out, lib_in, lib_g,
                                        retain_graph=True),
            bv * n * c * es + coord_bytes + bv * p * c * es,
            8 * bv * n * c),
    }


def adds_per_pixel(x, y, s):
    """(largest, mean) number of valid taps of x, y [BV, N] that land on
    one pixel of one view's s x s map: the adds a direct scatter makes to
    one address per channel."""
    counts = torch.zeros(x.shape[0] * s * s, device=x.device)
    base = torch.arange(x.shape[0], device=x.device)[:, None] * s * s
    for idx, _, valid in plain._bilinear_taps(x, y, s, s):
        hit = (base + idx)[valid]
        counts.index_add_(0, hit, torch.ones_like(hit, dtype=torch.float32))
    return int(counts.max()), float(counts.mean())


def variants_of(name):
    """The launch counter by variant of kernel `name` (its layout's, for
    the unprojection)."""
    if name.startswith("unproject_view"):
        return unproject.view_variants
    if name.startswith("unproject"):
        return unproject.fused_variants
    return reproject.variants


def launched_variant(name, fn):
    """fn's result and the variant of kernel `name` that it launched."""
    counter = variants_of(name)
    before = dict(counter)
    out = fn()
    grew = [k for k, n in counter.items() if n > before.get(k, 0)]
    return out, ",".join(grew) or None


def _reproject_cases(grid, xg, yg, iz, dtype):
    """The reprojection's forward and backward, as _unproject_cases gives
    the unprojection's; the backward's tuple ends with its exact
    reference, the plain version on a CPU copy."""
    b, nx, ny, nz, c = grid.shape
    s_d, npix = xg.shape[1], xg.shape[2]
    es = grid.element_size()
    idx, valid = plain._nearest_voxels(xg, yg, iz, nx, ny, nz)
    n_valid = int(valid.sum())
    touched = int(torch.unique(
        (idx + torch.arange(b, device=DEV)[:, None, None] * nx * ny * nz)
        [valid]).numel())
    gen = torch.Generator(DEV).manual_seed(nz + s_d)
    g = torch.randn((b, s_d, npix, c), generator=gen, device=DEV).to(dtype)
    # F.grid_sample 5-D nearest: [B, C, D=nx, H=ny, W=nz] view of the
    # grid, coordinates (W, H, D) = (iz, y, x) normalised for
    # align_corners=True (iz = -1 lands outside: zeros)
    vol = grid.permute(0, 4, 1, 2, 3)
    izt = torch.as_tensor(np.asarray(iz, np.float32), device=DEV)
    coords = torch.stack([
        (2 * izt / (nz - 1) - 1)[None, :, None].expand(b, s_d, npix),
        2 * yg / (ny - 1) - 1, 2 * xg / (nx - 1) - 1], -1)[:, :, :, None]
    coords = coords.to(dtype)
    lib_in = vol.detach().clone().requires_grad_()
    lib_out = F.grid_sample(lib_in, coords, mode="nearest",
                            padding_mode="zeros", align_corners=True)
    lib_g = torch.randn(lib_out.shape, generator=gen, device=DEV).to(dtype)
    coord_bytes = 2 * b * s_d * npix * 4
    return {
        # the gather reads the voxels it selects, once each
        "reproject": (
            lambda: reproject.gather(grid, xg, yg, iz),
            lambda: plain.zslice_gather(grid, xg, yg, iz),
            lambda: F.grid_sample(vol, coords, mode="nearest",
                                  padding_mode="zeros", align_corners=True),
            touched * c * es + coord_bytes + b * s_d * npix * c * es, 0),
        # the scatter reads g of the valid samples, writes the whole grid
        "reproject_bwd": (
            lambda: reproject.gather_bwd(g, xg, yg, iz, tuple(grid.shape)),
            lambda: plain.zslice_gather_bwd(g, xg, yg, iz, tuple(grid.shape),
                                            dtype),
            lambda: torch.autograd.grad(lib_out, lib_in, lib_g,
                                        retain_graph=True),
            n_valid * c * es + coord_bytes + grid.numel() * es,
            n_valid * c,
            lambda: plain.zslice_gather_bwd(g.cpu(), xg.cpu(), yg.cpu(), iz,
                                            tuple(grid.shape), dtype)),
    }


def _check(name, got, want, dtype):
    """(max abs error, tolerance description); raises past tolerance."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                           f"{tuple(want.shape)} {want.dtype}")
    err = (got.float().to(want.device) - want.float()).abs()
    max_err = float(err.max())
    if (name, dtype) in TOL:
        tol = TOL[(name, dtype)]
        ok = max_err <= tol
    else:
        scale = float(want.float().abs().max())
        allowed = BWD_REL * scale
        tol = f"{BWD_REL}*{scale:.4g}"
        if dtype == torch.bfloat16:
            allowed = allowed + BF16_STEP * want.float().abs()
            tol += "+2^-7*|ref|"
        ok = bool((err <= allowed).all())
    if not ok:
        raise RuntimeError(f"{name} {dtype}: max abs error {max_err} "
                           f"beyond {tol}")
    return max_err, tol


def rate(nbytes, ms, b_ms):
    """Achieved GB/s and the share of the bound; where the kernel ran
    under its HBM bound, the calls were served from L2: no share."""
    out = {"gbps": round(nbytes / ms / 1e6, 1)}
    if ms < b_ms:
        out["l2_served"] = True
    else:
        out["bound_share"] = round(b_ms / ms, 3)
    return out


def variant_checks(rcam, rcam4, kmat, pts, gen):
    """One level (P4: 40^2, C=64, 40^3 voxels; 2 views in the fused layout,
    4 in the per-view one) of the variants that the flagship tensors do
    not reach, against plain: the scalar forward and the direct backward
    of each layout, on features and g offset by one element from their
    allocations (not 16-byte aligned); then the reprojection's
    (`_reproject_variant_checks`)."""
    c, s = 64, LEVELS["P4"]
    for dtype in (torch.float32, torch.bfloat16):
        for name, r, v in (("unproject", rcam, 2),
                           ("unproject_view", rcam4, 4)):
            x, y = plain.project_voxel_coords(r, kmat, (640, 640), pts, s, s)
            x, y = x.contiguous(), y.contiguous()
            n = x.shape[1]
            feats = torch.randn(v * s * s * c + 1, generator=gen).to(
                DEV, dtype)[1:].view(v, s * s, c)
            g = torch.randn(v * n * c + 1, generator=gen).to(
                DEV, dtype)[1:]
            if name == "unproject":
                g = g.view(1, n, v * c)
                saved = plain.bilinear_gather_fused(feats, x, y, s, s, v,
                                                    True)
                checks = (
                    (name, "fwd_scalar",
                     lambda: unproject.gather_fused(feats, x, y, s, s, v,
                                                    True),
                     lambda: plain.bilinear_gather_fused(feats, x, y, s, s,
                                                         v, True)),
                    (name + "_bwd", "bwd_direct",
                     lambda: unproject.gather_fused_bwd(g, saved, x, y, s,
                                                        s, v, True),
                     lambda: plain.bilinear_gather_fused_bwd(
                         g, saved, x, y, s, s, v, True, dtype)))
            else:
                g = g.view(v, n, c)
                checks = (
                    (name, "fwd_scalar",
                     lambda: unproject.gather(feats, x, y, s, s),
                     lambda: plain.bilinear_gather(feats, x, y, s, s)),
                    (name + "_bwd", "bwd_direct",
                     lambda: unproject.gather_bwd(g, x, y, s, s),
                     lambda: plain.bilinear_gather_bwd(g, x, y, s, s,
                                                       dtype)))
            run_variant_checks([(v, "P4") + check for check in checks],
                               dtype)
        run_variant_checks(_reproject_variant_checks(kmat, gen, dtype),
                           dtype)


def run_variant_checks(runs, dtype):
    """Each (views, level, kernel, variant, kernel call, reference) of
    `runs`: the kernel against its reference, the variant it launched,
    and its device time; one line each."""
    for v, level, kname, expect, kern, ref in runs:
        got, variant = launched_variant(kname, kern)
        want = ref()
        torch.cuda.synchronize()
        err, tol = _check(kname, got, want, dtype)
        if variant != expect:
            raise RuntimeError(f"{kname} launched {variant}, not {expect}")
        say("kernels", kernel=kname, variant=variant, level=level, views=v,
            dtype=str(dtype).split(".")[1], max_abs_err=err, tol=tol,
            ms=round(device_ms(kern), 5))


def _reproject_variant_checks(kmat, gen, dtype):
    """The reprojection's variants that the flagship tensors do not reach,
    as (views, level, kernel, variant, kernel call, exact reference): at
    P4 (40^2 pixels, 20 samples, C=64, 40^3 grid) the scalar forward on a
    grid and the scalar backward on a g offset by one element (not
    16-byte aligned); and the vector backward on 80^2 pixels a sample, a
    P3-sized map, which a block maps in chunks of MAX_CHUNK. The
    backward's reference is the plain version on a CPU copy."""
    cfg = FlagshipConfig()
    n, c, shape = cfg.nvox, 64, (1, 40, 40, 40, 64)
    out = []
    for level, s, offset in (("P4", LEVELS["P4"], 1), ("P3", 80, 0)):
        xg, yg, iz = plain.reprojection_coords(kmat, (640, 640), s,
                                               cfg.samples, cfg, n, n, n)
        xg, yg = xg.contiguous(), yg.contiguous()
        size = cfg.samples * s * s * c
        g = torch.randn(size + offset, generator=gen).to(DEV, dtype)[
            offset:].view(1, cfg.samples, s * s, c)
        grid = torch.randn(n ** 3 * c + offset, generator=gen).to(
            DEV, dtype)[offset:].view(shape)
        variant = "scalar" if offset else "vector_chunked"
        if offset:
            out.append((1, level, "reproject", "fwd_scalar",
                        lambda grid=grid, xg=xg, yg=yg, iz=iz:
                        reproject.gather(grid, xg, yg, iz),
                        lambda grid=grid, xg=xg, yg=yg, iz=iz:
                        plain.zslice_gather(grid, xg, yg, iz)))
        out.append((1, level, "reproject_bwd", "bwd_" + variant,
                    lambda g=g, xg=xg, yg=yg, iz=iz:
                    reproject.gather_bwd(g, xg, yg, iz, shape),
                    lambda g=g, xg=xg, yg=yg, iz=iz:
                    plain.zslice_gather_bwd(g.cpu(), xg.cpu(), yg.cpu(), iz,
                                            shape, dtype)))
    return out


def measure(name, case, level, dtype, views, adds, outside):
    """Kernel `name` at one level against its plain version (the
    tolerance, the variant launched), then the device times of the
    kernel, the plain version and the library call, the host-clock call
    times and the bound; prints one line and returns its numbers."""
    kern, ref, lib, nbytes, flops, *exact = case
    got, variant = launched_variant(name, kern)
    want = exact[0]() if exact else ref()
    torch.cuda.synchronize()
    err, tol = _check(name, got, want, dtype)
    # the flagship tensors take the vector forward and the walk backward
    # (the reprojection: its vector backward)
    want_variant = "fwd_vector"
    if name.endswith("_bwd"):
        want_variant = ("bwd_vector" if name.startswith("reproject")
                        else "bwd_walk")
    if variant != want_variant:
        raise RuntimeError(f"{name} launched {variant}, not {want_variant}")
    # runs of the same kernel on the same inputs: the spread that float
    # atomics leave in a backward's last bits (none in the reprojection's)
    spread = (max(float((kern().float() - got.float()).abs().max())
                  for _ in range(3)) if name.endswith("_bwd") else 0.0)
    if name == "reproject_bwd" and spread != 0.0:
        raise RuntimeError(f"{name} {dtype}: two runs differ by {spread}")
    ms, plain_ms, lib_ms = device_ms(kern), device_ms(ref), device_ms(lib)
    call_ms, plain_call_ms = median_ms(kern), median_ms(ref)
    b_ms, b_by = bound_ms(nbytes, flops)
    extra = dict(variant=variant)
    if name.startswith("unproject"):
        extra.update(adds_per_pixel_max=adds[0],
                     adds_per_pixel_mean=round(adds[1], 2))
    say("kernels", kernel=name, level=level, views=views,
        dtype=str(dtype).split(".")[1], shape=list(got.shape),
        max_abs_err=err, tol=tol, run_to_run=spread,
        ms=round(ms, 5), plain_ms=round(plain_ms, 5),
        library_ms=round(lib_ms, 5), bound_ms=round(b_ms, 5),
        bound_by=b_by, mbytes=round(nbytes / 1e6, 3),
        **rate(nbytes, ms, b_ms), **extra,
        call_ms=round(call_ms, 4), plain_call_ms=round(plain_call_ms, 4),
        view2_voxels_outside=round(outside, 3))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = FlagshipConfig()
    rng = np.random.RandomState(0)
    g = torch.Generator().manual_seed(0)
    b, v, c = 1, 2, 64
    rcam = torch.from_numpy(poses(rng, b, v)).to(DEV)
    rcam4 = torch.from_numpy(poses(rng, b, 4)).to(DEV)
    kmat = torch.from_numpy(intrinsics(b, 640)).to(DEV)
    pts = torch.from_numpy(plain.voxel_grid_points(cfg)).to(DEV)
    nx = ny = cfg.nvox
    nz = cfg.nvox_z
    record = {}

    def keep(name, level, dtype, got):
        """The JSON record: the largest error over every run; P4 bf16 at
        the flagship's views (V=2 fused) as the kernel's numbers, and
        every bf16 level's times beside them."""
        rec = record.setdefault(name, {"max_abs_err": 0.0,
                                       "bf16_by_level": {}})
        rec["max_abs_err"] = max(rec["max_abs_err"], got["max_abs_err"])
        if dtype == torch.bfloat16:
            rec["bf16_by_level"][level] = {
                k: got[k] for k in ("ms", "bound_ms", "library_ms")}
            if level == "P4":
                rec.update({k: got[k] for k in ("ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")})

    for dtype in (torch.float32, torch.bfloat16):
        for level, s in LEVELS.items():
            feats = torch.randn(b * v, s * s, c, generator=g).to(DEV, dtype)
            x, y = plain.project_voxel_coords(rcam, kmat, (640, 640), pts,
                                              s, s)
            x, y = x.contiguous(), y.contiguous()
            outside = float(((x[1] < -1) | (x[1] > s) | (y[1] < -1)
                             | (y[1] > s)).float().mean())
            feats4 = torch.randn(b * 4, s * s, c, generator=g).to(DEV, dtype)
            x4, y4 = plain.project_voxel_coords(rcam4, kmat, (640, 640), pts,
                                                s, s)
            x4, y4 = x4.contiguous(), y4.contiguous()
            grid = torch.randn(b, nx, ny, nz, c, generator=g).to(DEV, dtype)
            xg, yg, iz = plain.reprojection_coords(kmat, (640, 640), s,
                                                   cfg.samples, cfg, nx, ny,
                                                   nz)
            xg, yg = xg.contiguous(), yg.contiguous()
            adds, adds4 = adds_per_pixel(x, y, s), adds_per_pixel(x4, y4, s)
            # (kernel, case, views, taps a pixel, record label)
            runs = [(name, case, v, adds, level) for name, case in
                    _unproject_cases(feats, x, y, s, v, dtype).items()]
            runs += [(name, case, 4, adds4, level) for name, case in
                     _unproject_view_cases(feats4, x4, y4, s, dtype).items()]
            runs += [(name, case, 1, adds, level) for name, case in
                     _reproject_cases(grid, xg, yg, iz, dtype).items()]
            if level == "P4":
                # the fused kernels at the 4-view conv3d's width too
                runs += [(name, case, 4, adds4, "P4_v4") for name, case in
                         _unproject_cases(feats4, x4, y4, s, 4,
                                          dtype).items()]
            for name, case, views, a, label in runs:
                keep(name, label, dtype,
                     measure(name, case, level, dtype, views, a, outside))
    variant_checks(rcam, rcam4, kmat, pts, g)
    trace_reproject_bwd(kmat, g)
    return record


def trace_reproject_bwd(kmat, gen):
    """One profiled call of the reprojection backward at P4 in each dtype:
    it must run as one kernel, with no memset and no cast pass."""
    cfg = FlagshipConfig()
    n = cfg.nvox
    xg, yg, iz = plain.reprojection_coords(kmat, (640, 640), LEVELS["P4"],
                                           cfg.samples, cfg, n, n, n)
    xg, yg = xg.contiguous(), yg.contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn(1, cfg.samples, xg.shape[2], 64, generator=gen).to(
            DEV, dtype)
        events = device_events(lambda: reproject.gather_bwd(
            g, xg, yg, iz, (1, n, n, n, 64)))
        say("kernels", kernel="reproject_bwd", level="P4",
            dtype=str(dtype).split(".")[1],
            device_events=json.dumps(events, separators=(",", ":")))
        if len(events) != 1 or sum(events.values()) != 1 or \
                "bwd_kernel" not in next(iter(events)):
            raise RuntimeError(f"reproject_bwd ran {events}, not one "
                               f"kernel")


def request_images(rng, n, hw, views=2):
    return [rng.randint(0, 256, (views, hw, hw, 3)).astype(np.uint8)
            for _ in range(n)]


def request_depths(rng, n, cfg):
    """Seeded depth maps [1, V, h5, w5] at P5's resolution, 1.5-8 m."""
    s5 = cfg.IMAGE_MAX_DIM // cfg.BACKBONE_STRIDES[3]
    return [rng.uniform(1.5, 8.0, (1, cfg.NUM_VIEWS, s5, s5)).astype(
        np.float32) for _ in range(n)]


def reset_counts():
    unproject.launches = unproject.bwd_launches = 0
    unproject.view_launches = unproject.view_bwd_launches = 0
    unproject.view_variants.clear()
    unproject.fused_variants.clear()
    reproject.launches = reproject.bwd_launches = 0
    reproject.variants.clear()


def read_counts():
    return {"unproject": unproject.launches,
            "unproject_bwd": unproject.bwd_launches,
            "unproject_view": unproject.view_launches,
            "unproject_view_bwd": unproject.view_bwd_launches,
            "reproject": reproject.launches,
            "reproject_bwd": reproject.bwd_launches}


def check_variants(tag, counts):
    """The kernel variants launched since the counts were reset: on the
    main paths every launch must be the vector forward, the walk backward
    of the unprojection or the reprojection's one-pass vector backward.
    Returns them, by kernel family and variant."""
    got = {f"fused_{k}": n for k, n in unproject.fused_variants.items() if n}
    got.update({f"view_{k}": n for k, n in unproject.view_variants.items()
                if n})
    got.update({f"reproject_{k}": n for k, n in reproject.variants.items()
                if n})
    want = {k: n for k, n in (
        ("fused_fwd_vector", counts["unproject"]),
        ("fused_bwd_walk", counts["unproject_bwd"]),
        ("view_fwd_vector", counts["unproject_view"]),
        ("view_bwd_walk", counts["unproject_view_bwd"]),
        ("reproject_fwd_vector", counts["reproject"]),
        ("reproject_bwd_vector", counts["reproject_bwd"])) if n}
    if got != want:
        raise RuntimeError(f"{tag} launched the variants {got}, not {want}")
    return got


def expected(**counts):
    """A launch count for every kernel: those named, 0 for the others."""
    return {k: counts.get(k, 0) for k in KERNELS}


def run_requests(tag, cfg, per_request, probe=None):
    """The engine's detect at `cfg` with seeded weights: one warm-up
    request (every raw output must be finite), 3 counted requests, then
    the same 3 once more, timed part by part on the host clock, and one
    more under torch.profiler, for its host synchronisations. `probe`,
    if given, is called with the engine and a call of run_model on a
    request. `per_request` is the launch count each kernel must reach per
    request. Returns the counts of the counted run."""
    t = time.perf_counter()
    eng = MaskRCNN("inference", cfg, "build")
    eng.init_weights(torch.Generator().manual_seed(0))
    setup_s = time.perf_counter() - t
    rng = np.random.RandomState(1)
    reqs = request_images(rng, 4, cfg.IMAGE_MAX_DIM, cfg.NUM_VIEWS)
    rcams = [poses(rng, 1, cfg.NUM_VIEWS) for _ in reqs]
    depths = (request_depths(rng, len(reqs), cfg) if cfg.TRANSFORMER
              else [None] * len(reqs))
    kmat = intrinsics(1, cfg.IMAGE_MAX_DIM)

    outs, _, _ = eng.run_model([reqs[0]], rcams[0], kmat, depths[0])
    torch.cuda.synchronize()
    for k, t_ in outs.items():
        if not torch.isfinite(t_.float()).all():
            raise RuntimeError(f"{tag} output {k} is not finite")
    say(tag, warmup="ok", setup_s=round(setup_s, 3),
        outputs={k: list(t_.shape) for k, t_ in outs.items()})

    reset_counts()
    lat = []
    for img, rcam, dep in zip(reqs[1:], rcams[1:], depths[1:]):
        t = time.perf_counter()
        r = eng.detect([img], rcam, kmat, dep)[0]
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        n = len(r["class_ids"])
        if not (np.isfinite(r["scores"]).all() and r["masks"].shape
                == img.shape[1:3] + (n,) and r["rois"].shape == (n, 4)):
            raise RuntimeError(f"{tag} produced malformed detections")
        say(tag, detections=n, rois=list(r["rois"].shape),
            masks=list(r["masks"].shape),
            classes=sorted(set(int(c) for c in r["class_ids"])),
            latency_ms=round(lat[-1], 3))
    launches = read_counts()
    expect = expected(**{k: n * len(lat) for k, n in per_request.items()})
    say(tag, calls=len(lat), launches=launches, expected=expect,
        variants=check_variants(tag, launches),
        latency_ms_median=round(statistics.median(lat), 3))
    if launches != expect:
        raise RuntimeError(f"{tag} kernel launches {launches} != {expect}")

    # host-clock breakdown of the same requests, unprofiled, after the
    # counted run: detect() is run_model (molding included), the copy of
    # its outputs to the host, and unmolding
    for img, rcam, dep in zip(reqs[1:], rcams[1:], depths[1:]):
        t0 = time.perf_counter()
        eng.mold_inputs(list(img))
        t1 = time.perf_counter()
        outs, shape, windows = eng.run_model([img], rcam, kmat, dep)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        det = outs["detections"].float().cpu().numpy()
        masks = outs["mrcnn_masks"].float().cpu().numpy()
        t3 = time.perf_counter()
        eng.unmold_detections(det[0], masks[0], img.shape[1:], shape,
                              windows[0])
        t4 = time.perf_counter()
        say(tag, breakdown_ms=json.dumps({
            "mold": round((t1 - t0) * 1e3, 3),
            "run_model_incl_mold": round((t2 - t1) * 1e3, 3),
            "copy_out": round((t3 - t2) * 1e3, 3),
            "unmold": round((t4 - t3) * 1e3, 3),
            "request": round((t4 - t1) * 1e3, 3)}, separators=(",", ":")))
    img, rcam, dep = reqs[1], rcams[1], depths[1]
    syncs = host_syncs(lambda: eng.detect([img], rcam, kmat, dep))
    say(tag, host_syncs_per_request=sum(syncs.values()),
        host_syncs=json.dumps(syncs, separators=(",", ":")))
    if probe is not None:
        probe(eng, lambda: eng.run_model([img], rcam, kmat, dep))
    return launches


def phase_main():
    return run_requests("main", FlagshipConfig(),
                        {"unproject": 3, "reproject": 3},
                        probe=layout_copies)


def layout_copies(eng, forward):
    """The device time of the layout copies on either side of the
    reprojection at each level, on the tensors of one forward: the fused
    grid [B, C, X, Y, Z] (the U-Net's output, in its memory format) made
    [B, X, Y, Z, C] contiguous for the kernel, and its gradient made the
    U-Net's format again; the rays [B, D, S, S, C] permuted and reshaped
    to [B, C*D, S, S] by DepthCollapse, and its gradient made [B, D, S, S,
    C] contiguous for the backward kernel. A copy that is a view costs
    nothing (copy=False)."""
    taken, hooks = {}, []
    for lvl in (4, 5, 6):
        hooks.append(getattr(eng.model, f"grid_fusion_p{lvl}")
                     .register_forward_hook(
                         lambda m, a, out, lvl=lvl: taken.__setitem__(
                             ("fused", lvl), out.detach())))
        hooks.append(getattr(eng.model, f"depth_collapse_p{lvl}")
                     .register_forward_hook(
                         lambda m, a, out, lvl=lvl: taken.__setitem__(
                             ("rays", lvl), a[0].detach())))
    forward()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    for lvl in (4, 5, 6):
        fused, rays = taken[("fused", lvl)], taken[("rays", lvl)]
        b, c, x, y, z = fused.shape
        fmt = (torch.channels_last_3d if fused.is_contiguous(
            memory_format=torch.channels_last_3d) else torch.contiguous_format)
        d, s1, s2 = rays.shape[1:4]
        dgrid = torch.randn(b, x, y, z, c, device=DEV).to(fused.dtype)
        drays = torch.randn(b, c * d, s1, s2, device=DEV).to(rays.dtype)
        copies = {
            "grid_fwd": lambda: fused.permute(0, 2, 3, 4, 1).contiguous(),
            "grid_bwd": lambda: dgrid.permute(0, 4, 1, 2, 3).contiguous(
                memory_format=fmt),
            "collapse_fwd": lambda: rays.permute(0, 4, 1, 2, 3).reshape(
                b, c * d, s1, s2),
            "collapse_bwd": lambda: drays.reshape(b, c, d, s1, s2).permute(
                0, 2, 3, 4, 1).contiguous()}
        sources = {"grid_fwd": fused, "grid_bwd": dgrid,
                   "collapse_fwd": rays, "collapse_bwd": drays}
        say("layouts", level=f"P{lvl}", fused_format=str(fmt).split(".")[1],
            **{k: json.dumps({
                "ms": round(device_ms(fn), 5),
                "copy": fn().data_ptr() != sources[k].data_ptr(),
                "mbytes": round(sources[k].numel()
                                * sources[k].element_size() / 1e6, 3)},
                separators=(",", ":")) for k, fn in copies.items()})


def time_steps(tag, eng, ds, cfg):
    """Step time after warm-up (host clock around train_step, which ends
    in a copy of the losses to the host), then one profiled step for the
    device's share."""
    model = eng.model
    mask = trainable_mask(model, "all")
    opt = make_optimizer([p for n, p in model.named_parameters()
                          if mask[n]], cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)
    batch = eng.to_device(make_batch(ds, cfg, rnd_state=99,
                                     with_depth=bool(cfg.TRANSFORMER)))
    gen = torch.Generator(DEV).manual_seed(1)

    def step():
        return train_step(model, opt, batch, cfg, mask, gen)

    step()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    reset_counts()
    busy_ms, device_events = device_profile(step)
    per_step = read_counts()
    step_ms = statistics.median(times)
    say(tag, step_ms=[round(t_, 3) for t_ in times],
        step_ms_median=round(step_ms, 3),
        device_busy_ms=busy_ms and round(busy_ms, 3),
        device_idle_share=busy_ms and round(1 - busy_ms / step_ms, 4),
        device_events_per_step=device_events,
        kernel_launches_per_step=per_step,
        peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))


def check_trained(losses, model):
    for ep, means in losses.items():
        if not all(np.isfinite(v) for v in means.values()):
            raise RuntimeError(f"epoch {ep} losses not finite: {means}")
    bad = [n for n, p in model.named_parameters() if p.dtype != torch.float32]
    if bad:
        raise RuntimeError(f"parameters not float32: {bad[:5]}")


def phase_train():
    cfg = FlagshipTrainConfig()
    ds = SyntheticMultiViewDataset(num_scenes=4, num_views=2, image_size=640,
                                   num_classes=cfg.NUM_CLASSES, seed=0)
    val = SyntheticMultiViewDataset(num_scenes=1, num_views=2,
                                    image_size=640,
                                    num_classes=cfg.NUM_CLASSES, seed=1)
    losses = {}                     # epoch -> the epoch's mean losses
    keep = losses.__setitem__
    with tempfile.TemporaryDirectory(dir="build") as model_dir:
        eng = MaskRCNN("training", cfg, model_dir)
        reset_counts()
        t = time.perf_counter()
        eng.train(ds, None, cfg.LEARNING_RATE, 1, "all",
                  custom_callbacks=[keep], prefetch_threads=2)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t
        launches = read_counts()
        n = 3 * cfg.STEPS_PER_EPOCH
        expect = expected(unproject=n, unproject_bwd=n, reproject=n,
                          reproject_bwd=n)
        say("train", epoch=1, steps=cfg.STEPS_PER_EPOCH, launches=launches,
            expected=expect, variants=check_variants("train", launches),
            seconds=round(epoch_s, 3),
            losses=json.dumps(losses[1], separators=(",", ":")))
        if launches != expect:
            raise RuntimeError(f"train launches {launches} != {expect}")

        # resume: a new engine loads the checkpoint (its epoch count
        # included) and trains to epoch 2, with a validation step
        ckpt = eng.find_last()
        eng2 = MaskRCNN("training", cfg, model_dir)
        eng2.load_weights(ckpt)
        if eng2.epoch != 1:
            raise RuntimeError(f"resumed at epoch {eng2.epoch}, not 1")
        for (n1, p1), (_, p2) in zip(eng.model.named_parameters(),
                                     eng2.model.named_parameters()):
            if not torch.equal(p1, p2):
                raise RuntimeError(f"checkpoint lost {n1}")
        reset_counts()
        eng2.train(ds, val, cfg.LEARNING_RATE, 2, "all",
                   custom_callbacks=[keep], prefetch_threads=2)
        torch.cuda.synchronize()
        resumed = read_counts()
        say("train", epoch=2, resumed_from=ckpt.split(model_dir)[-1],
            launches=resumed, variants=check_variants("train", resumed),
            losses=json.dumps(losses[2], separators=(",", ":")))
        want = expected(unproject=3 * (cfg.STEPS_PER_EPOCH + 1),
                        reproject=3 * (cfg.STEPS_PER_EPOCH + 1),
                        unproject_bwd=n, reproject_bwd=n)
        if resumed != want:
            raise RuntimeError(f"resumed launches {resumed} != {want}")
        check_trained(losses, eng2.model)
        time_steps("train", eng2, ds, cfg)
    return launches


def run_training(tag, cfg, per_step):
    """compat.MaskRCNN("training").train for one epoch of
    cfg.STEPS_PER_EPOCH steps on a seeded 640^2 synthetic dataset with
    cfg.NUM_VIEWS views; each kernel must launch per_step[k] times a
    step. Then the step time and a profiled step. Returns the counts."""
    ds = SyntheticMultiViewDataset(num_scenes=4, num_views=cfg.NUM_VIEWS,
                                   image_size=cfg.IMAGE_MAX_DIM,
                                   num_classes=cfg.NUM_CLASSES, seed=0)
    losses = {}
    with tempfile.TemporaryDirectory(dir="build") as model_dir:
        eng = MaskRCNN("training", cfg, model_dir)
        reset_counts()
        t = time.perf_counter()
        eng.train(ds, None, cfg.LEARNING_RATE, 1, "all",
                  custom_callbacks=[losses.__setitem__], prefetch_threads=2)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t
        launches = read_counts()
        expect = expected(**{k: n * cfg.STEPS_PER_EPOCH
                             for k, n in per_step.items()})
        say(tag, epoch=1, steps=cfg.STEPS_PER_EPOCH, launches=launches,
            expected=expect, variants=check_variants(tag, launches),
            seconds=round(epoch_s, 3),
            losses=json.dumps(losses[1], separators=(",", ":")))
        if launches != expect:
            raise RuntimeError(f"{tag} launches {launches} != {expect}")
        check_trained(losses, eng.model)
        time_steps(tag, eng, ds, cfg)
    return launches


def phase_lstm_main():
    return run_requests("lstm3d_main", Lstm4Config(),
                        {"unproject_view": 3, "reproject": 3})


def phase_lstm_train():
    return run_training("lstm3d_train", Lstm4TrainConfig(),
                        {"unproject_view": 3, "unproject_view_bwd": 3,
                         "reproject": 3, "reproject_bwd": 3})


def phase_xformer():
    """3 detect requests and 3 training steps; the transformer path runs
    no geometry kernel."""
    return (run_requests("xformer_main", XformerConfig(), {}),
            run_training("xformer_train", XformerTrainConfig(), {}))


def _iou(a, b):
    lo = np.maximum(a[:2], b[:2])
    hi = np.minimum(a[2:], b[2:])
    inter = float(np.prod(np.clip(hi - lo, 0, None)))
    union = (float(np.prod(a[2:] - a[:2])) + float(np.prod(b[2:] - b[:2]))
             - inter)
    return inter / union if union > 0 else 0.0


PARITY_CONFIGS = (Flagship256, with_fusion(Flagship256, "add"),
                  with_fusion(Flagship256, "mean"),
                  with_fusion(Flagship256, "ident"),
                  with_fusion(Flagship256, "lstm3d"), Xformer640F32)


def phase_parity(cfg):
    """CPU plain versions vs GPU kernels at `cfg` (float32), TF32 off:
    the bar of tests/test_fullgraph_parity.py (counts within one; each
    reference detection matched by class and box IoU >= 0.9 with score
    within 0.02 and mask IoU > 0.85, at most one unmatched)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(2)
    hw = cfg.IMAGE_MAX_DIM
    img = request_images(rng, 1, hw, cfg.NUM_VIEWS)[0]
    rcam, kmat = poses(rng, 1, cfg.NUM_VIEWS), intrinsics(1, hw)
    depths = request_depths(rng, 1, cfg)[0] if cfg.TRANSFORMER else None
    ref, got = [
        MaskRCNN("inference", cfg, "build", device=dev)
        .init_weights(torch.Generator().manual_seed(3))
        .detect([img], rcam, kmat, depths)[0]
        for dev in ("cpu", "cuda")]
    n_ref, n_got = len(ref["class_ids"]), len(got["class_ids"])
    used, matched, worst_score, worst_mask = set(), 0, 0.0, 1.0
    for i in range(n_ref):
        best, best_iou = None, 0.0
        for j in range(n_got):
            if j in used or got["class_ids"][j] != ref["class_ids"][i]:
                continue
            iou = _iou(ref["rois"][i].astype(np.float64),
                       got["rois"][j].astype(np.float64))
            if iou > best_iou:
                best, best_iou = j, iou
        if best is None or best_iou < 0.9:
            continue
        used.add(best)
        matched += 1
        worst_score = max(worst_score, abs(float(ref["scores"][i])
                                           - float(got["scores"][best])))
        a, b = ref["masks"][..., i], got["masks"][..., best]
        union = np.logical_or(a, b).sum()
        if union:
            worst_mask = min(worst_mask,
                             np.logical_and(a, b).sum() / union)
    say("parity", config=cfg.NAME, cpu_detections=n_ref,
        gpu_detections=n_got, matched=matched, max_score_diff=worst_score,
        min_mask_iou=round(float(worst_mask), 4))
    if n_ref == 0:
        raise RuntimeError(f"{cfg.NAME} parity run produced no detections "
                           f"to compare")
    if (abs(n_ref - n_got) > 1 or matched < n_ref - 1
            or worst_score >= 0.02 or worst_mask <= 0.85):
        raise RuntimeError(f"{cfg.NAME}: CPU and GPU detections disagree")


def _grad_errs(ref, got, floor):
    """Per tensor: max |got - ref| over max(max |ref|, floor)."""
    return {n: float((got[n] - r).abs().max()) / max(float(r.abs().max()),
                                                      floor)
            for n, r in ref.items()}


def phase_train_parity(cfg, kernels, stage="all"):
    """One train step's losses and gradients at `cfg` and trainable
    `stage`, CPU plain versions vs GPU kernels, in float32 with TF32 off,
    same weights, batch and ROI sampling priorities; the GPU step twice,
    for its own spread; each of `kernels` launched 3 times (P4, P5, P6) in
    the GPU step. Also counts the backbone ReLU inputs (bn2a, bn2b
    outputs) whose sign differs between the CPU and the GPU forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2, image_size=256,
                                   num_classes=cfg.NUM_CLASSES, seed=2)
    host = make_batch(ds, cfg, rnd_state=0)
    runs = []
    with tempfile.TemporaryDirectory(dir="build") as model_dir:
        for dev in ("cpu", "cuda", "cuda"):
            eng = MaskRCNN("training", cfg, model_dir, device=dev)
            eng.init_weights(torch.Generator().manual_seed(3))
            batch = draw_priorities(eng.to_device(host), cfg,
                                    torch.Generator().manual_seed(0))
            signs = {}
            for name, mod in eng.model.backbone.named_modules():
                if name.endswith((".bn2a", ".bn2b")):
                    mod.register_forward_hook(
                        lambda m, a, out, name=name: signs.__setitem__(
                            name, (out > 0).cpu()))
            reset_counts()
            mask = trainable_mask(eng.model, stage)
            for n, p in eng.model.named_parameters():
                p.requires_grad_(mask[n])
            _, parts = loss_and_grads(eng.model, batch, cfg, mask)
            runs.append((
                {k: v.item() for k, v in parts.items()},
                {n: p.grad.detach().float().cpu()
                 for n, p in eng.model.named_parameters()
                 if p.grad is not None},
                read_counts(), signs))
    (lc, gc, _, sc), (lg, gg, counts, sg), (_, gg2, _, _) = runs
    if set(gc) != set(gg):
        raise RuntimeError("CPU and GPU steps reached different parameters")
    loss_err = max(abs(lc[k] - lg[k]) / max(abs(lc[k]), 1e-6) for k in lc)
    floor = 1e-6 * max(float(t.abs().max()) for t in gc.values())
    errs = _grad_errs(gc, gg, floor)
    repeat = max(_grad_errs(gg, gg2, floor).values())
    flips = {n: int((sc[n] != sg[n]).sum()) for n in sc}
    worst_name = max(errs, key=errs.get)
    beyond = sorted(n for n, e in errs.items() if e > GRAD_TOL)
    say("train_parity", config=cfg.NAME, stage=stage,
        losses_cpu=json.dumps(lc, separators=(",", ":")),
        losses_gpu=json.dumps(lg, separators=(",", ":")),
        max_loss_rel_err=loss_err, max_grad_err=errs[worst_name],
        worst_tensor=worst_name, tensors=len(gc),
        beyond_1e_3=json.dumps({n: round(errs[n], 6) for n in beyond}),
        relu_flips=json.dumps({n: k for n, k in flips.items() if k}),
        gpu_repeat_max_grad_err=repeat, gpu_launches=counts)
    want = expected(**{k: 3 for k in kernels})
    if counts != want:
        raise RuntimeError(f"GPU step launched {counts}, not {want}")
    if not (loss_err <= 1e-4 and errs[worst_name] <= GRAD_FLIP_TOL
            and len(beyond) <= GRAD_FLIP_SHARE * len(errs)):
        raise RuntimeError(f"{cfg.NAME}: CPU and GPU train steps disagree")


def main():
    name = phase_device()
    phase_build()
    record = phase_kernels()
    paths = {"inference": phase_main(), "train": phase_train()}
    for cfg_cls in PARITY_CONFIGS:
        phase_parity(cfg_cls())
    phase_train_parity(Flagship256Train(), ("unproject", "unproject_bwd",
                                            "reproject", "reproject_bwd"))
    # the lstm3d step checks the per-view backward kernel: with the
    # backbone frozen (stage grid+), every gradient it feeds is compared,
    # and the backbone's CPU-vs-GPU ReLU flips (GRAD_TOL) stay out of it
    phase_train_parity(with_fusion(Flagship256Train, "lstm3d")(),
                       ("unproject_view", "unproject_view_bwd", "reproject",
                        "reproject_bwd"), stage="grid+")
    paths["lstm3d_inference"] = phase_lstm_main()
    paths["lstm3d_train"] = phase_lstm_train()
    paths["xformer_inference"], paths["xformer_train"] = phase_xformer()
    kernels = []
    for key in KERNELS:
        by_path = {path: counts[key] for path, counts in paths.items()}
        kernels.append({
            "name": JSON_NAMES[key], "route": "cuda",
            "source": SOURCES[key],
            "replaces": REPLACES[key],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **record[key]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
