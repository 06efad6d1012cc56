"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
  1. device  — a CUDA device is required (no CPU fallback); prints the
               `nvidia-smi --query-gpu=name,power.limit` line.
  2. build   — compiles the CUDA kernels from csrc/ with nvcc.
  3. kernels — each kernel against its plain torch version at the
               flagship shapes (B=1, V=2, C=64, 40^3 grid, 20 depth
               samples; P4/P5/P6 = 40^2/20^2/10^2), float32 with TF32 off
               and bfloat16: max abs error vs the stated tolerance, and the
               median of 30 CUDA-event-timed runs of each.
  4. main    — the engine (compat.MaskRCNN.detect) at the flagship
               config (2 views at 640^2, ResNet-50 with a 5-block stage 4,
               pyramid 64, conv3d, 40^3 grid, 20 samples, bfloat16) with
               seeded random weights, on 3 requests after one warm-up; the
               kernels' launch counts must be 3 levels x 3 calls. Then the
               same requests once more, timed part by part on the host
               clock (molding, run_model, copy-out, unmolding).
  5. parity  — one model at 256^2 (16^3 grid, 8 samples) in float32 with
               TF32 off: detections of the CPU run (plain versions) and the
               GPU run (kernels) must agree.
The line before the last is the kernels' JSON record; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False — needs a GPU")

from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.config import Config  # noqa: E402
from mulit_view_object_detection_torch.kernels import (  # noqa: E402
    build, reproject, unproject)
from mulit_view_object_detection_torch.ops import projection as plain  # noqa: E402

DEV = torch.device("cuda", 0)
LEVELS = {"P4": 40, "P5": 20, "P6": 10}
# unprojection: plain and kernel round the same float32 ops in the same
# order (explicitly rounded in the kernel), so the tolerance only covers
# summation order; bfloat16: one rounding of the same float32 sum (1 ulp
# at |x| < 4). Reprojection copies values: exact.
TOL = {("unproject", torch.float32): 1e-5,
       ("unproject", torch.bfloat16): 2.0 ** -6,
       ("reproject", torch.float32): 0.0,
       ("reproject", torch.bfloat16): 0.0}


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


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = FlagshipConfig()
    rng = np.random.RandomState(0)
    g = torch.Generator().manual_seed(0)
    b, v, c = 1, 2, 64
    rcam = torch.from_numpy(poses(rng, b, v)).to(DEV)
    kmat = torch.from_numpy(intrinsics(b, 640)).to(DEV)
    pts = torch.from_numpy(plain.voxel_grid_points(cfg)).to(DEV)
    nx = ny = cfg.nvox
    nz = cfg.nvox_z
    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        for level, s in LEVELS.items():
            feats = torch.randn(b * v, s * s, c, generator=g).to(DEV, dtype)
            x, y = plain.project_voxel_coords(rcam, kmat, (640, 640), pts,
                                              s, s)
            x, y = x.contiguous(), y.contiguous()
            outside = float(((x[1] < -1) | (x[1] > s) | (y[1] < -1)
                             | (y[1] > s)).float().mean())
            grid = torch.randn(b, nx, ny, nz, c, generator=g).to(DEV, dtype)
            xg, yg, iz = plain.reprojection_coords(kmat, (640, 640), s,
                                                   cfg.samples, cfg, nx, ny,
                                                   nz)
            xg, yg = xg.contiguous(), yg.contiguous()
            cases = {
                "unproject": (
                    lambda: unproject.bilinear_gather_fused(
                        feats, x, y, s, s, v, True),
                    lambda: plain.bilinear_gather_fused(
                        feats, x, y, s, s, v, True)),
                "reproject": (
                    lambda: reproject.zslice_gather(grid, xg, yg, iz),
                    lambda: plain.zslice_gather(grid, xg, yg, iz)),
            }
            for name, (kern, ref) in cases.items():
                got, want = kern(), ref()
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise RuntimeError(f"{name} {level}: {got.shape} "
                                       f"{got.dtype} vs {want.shape}")
                err = float((got.float() - want.float()).abs().max())
                tol = TOL[(name, dtype)]
                ms, plain_ms = median_ms(kern), median_ms(ref)
                say("kernels", kernel=name, level=level,
                    dtype=str(dtype).split(".")[1], shape=list(got.shape),
                    max_abs_err=err, tol=tol, ms=round(ms, 4),
                    plain_ms=round(plain_ms, 4),
                    view2_voxels_outside=round(outside, 3))
                if not err <= tol:
                    raise RuntimeError(f"{name} {level} {dtype}: max abs "
                                       f"error {err} > {tol}")
                rec = record.setdefault(name, {"max_abs_err": 0.0})
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if level == "P4" and dtype == torch.bfloat16:
                    rec.update(ms=ms, plain_ms=plain_ms)
    return record


def request_images(rng, n, hw):
    return [rng.randint(0, 256, (2, hw, hw, 3)).astype(np.uint8)
            for _ in range(n)]


def phase_main():
    cfg = FlagshipConfig()
    t = time.perf_counter()
    eng = MaskRCNN("inference", cfg, "build", device="cuda")
    eng.init_weights(torch.Generator().manual_seed(0))
    setup_s = time.perf_counter() - t
    rng = np.random.RandomState(1)
    reqs = request_images(rng, 4, 640)
    rcams = [poses(rng, 1, 2) for _ in reqs]
    kmat = intrinsics(1, 640)

    # warm-up request: also checks every raw output is finite
    outs, _, _ = eng.run_model([reqs[0]], rcams[0], kmat)
    torch.cuda.synchronize()
    for k, t_ in outs.items():
        if not torch.isfinite(t_.float()).all():
            raise RuntimeError(f"main path output {k} is not finite")
    say("main", warmup="ok", setup_s=round(setup_s, 3),
        outputs={k: list(t_.shape) for k, t_ in outs.items()})

    unproject.launches = 0
    reproject.launches = 0
    lat = []
    for img, rcam in zip(reqs[1:], rcams[1:]):
        t = time.perf_counter()
        r = eng.detect([img], rcam, kmat)[0]
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        n = len(r["class_ids"])
        if not (np.isfinite(r["scores"]).all() and r["masks"].shape
                == img.shape[1:3] + (n,) and r["rois"].shape == (n, 4)):
            raise RuntimeError("main path produced malformed detections")
        say("main", detections=n, rois=list(r["rois"].shape),
            masks=list(r["masks"].shape),
            classes=sorted(set(int(c) for c in r["class_ids"])),
            latency_ms=round(lat[-1], 3))
    launches = {"unproject": unproject.launches,
                "reproject": reproject.launches}
    expect = 3 * len(lat)
    say("main", calls=len(lat), launches=launches, expected=expect,
        latency_ms_median=round(statistics.median(lat), 3))
    if any(n != expect for n in launches.values()):
        raise RuntimeError(f"kernel launches {launches} != {expect}")

    # host-clock breakdown of the same requests, unprofiled, after the
    # counted run: detect() is run_model (molding included), the copy of
    # its outputs to the host, and unmolding
    for img, rcam in zip(reqs[1:], rcams[1:]):
        t0 = time.perf_counter()
        eng.mold_inputs(list(img))
        t1 = time.perf_counter()
        outs, shape, windows = eng.run_model([img], rcam, kmat)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        det = outs["detections"].float().cpu().numpy()
        masks = outs["mrcnn_masks"].float().cpu().numpy()
        t3 = time.perf_counter()
        eng.unmold_detections(det[0], masks[0], img.shape[1:], shape,
                              windows[0])
        t4 = time.perf_counter()
        say("main", breakdown_ms=json.dumps({
            "mold": round((t1 - t0) * 1e3, 3),
            "run_model_incl_mold": round((t2 - t1) * 1e3, 3),
            "copy_out": round((t3 - t2) * 1e3, 3),
            "unmold": round((t4 - t3) * 1e3, 3),
            "request": round((t4 - t1) * 1e3, 3)}, separators=(",", ":")))
    return launches


def _iou(a, b):
    lo = np.maximum(a[:2], b[:2])
    hi = np.minimum(a[2:], b[2:])
    inter = float(np.prod(np.clip(hi - lo, 0, None)))
    union = (float(np.prod(a[2:] - a[:2])) + float(np.prod(b[2:] - b[:2]))
             - inter)
    return inter / union if union > 0 else 0.0


def phase_parity():
    """CPU plain versions vs GPU kernels at 256^2, float32, TF32 off:
    the bar of tests/test_fullgraph_parity.py (counts within one; each
    reference detection matched by class and box IoU >= 0.9 with score
    within 0.02 and mask IoU > 0.85, at most one unmatched)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Flagship256()
    rng = np.random.RandomState(2)
    img = request_images(rng, 1, 256)[0]
    rcam, kmat = poses(rng, 1, 2), intrinsics(1, 256)
    ref, got = [
        MaskRCNN("inference", cfg, "build", device=dev)
        .init_weights(torch.Generator().manual_seed(3))
        .detect([img], rcam, kmat)[0]
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
    say("parity", cpu_detections=n_ref, gpu_detections=n_got,
        matched=matched, max_score_diff=worst_score,
        min_mask_iou=round(float(worst_mask), 4))
    if n_ref == 0:
        raise RuntimeError("parity run produced no detections to compare")
    if (abs(n_ref - n_got) > 1 or matched < n_ref - 1
            or worst_score >= 0.02 or worst_mask <= 0.85):
        raise RuntimeError("CPU and GPU detections disagree")


def main():
    name = phase_device()
    phase_build()
    record = phase_kernels()
    launches = phase_main()
    phase_parity()
    kernels = [
        {"name": "unproject_fused", "route": "cuda",
         "source": "mulit_view_object_detection_torch/csrc/unproject.cu",
         "replaces": "mulit_view_object_detection_tpu/kernels/"
                     "unproject_pallas.py:185",
         "launches": launches["unproject"], **record["unproject"]},
        {"name": "reproject_nearest", "route": "cuda",
         "source": "mulit_view_object_detection_torch/csrc/reproject.cu",
         "replaces": "mulit_view_object_detection_tpu/kernels/"
                     "reproject_pallas.py:168",
         "launches": launches["reproject"], **record["reproject"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
