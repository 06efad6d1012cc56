"""Time the PyTorch port's geometry kernels in this tree and in an older
checkout of it, on one card, through each tree's own wrappers, and count
each tree's host synchronisations in a conv3d request.

    python3 tools/torch_kernel_ab.py OLD_TREE [--rounds 2]

OLD_TREE is an unpacked older commit of this repository, for example

    mkdir -p build/old_tree && git archive <commit> | tar -x -C build/old_tree

Each turn is a fresh process that puts one tree first on the path,
builds its kernels (into that tree's build/), makes `chip_smoke.py` phase
3's inputs (the same seeds in both trees: B=1, C=64, 40^3 voxels, 20
depth samples, P4/P5/P6, float32 and bfloat16; V=2 fused, V=4 per view)
and times every kernel case that tree's `chip_smoke.py` defines
(`_unproject_cases`, `_unproject_view_cases`, `_reproject_cases`) with its
`device_ms` (20 calls queued behind a spinning kernel, CUDA events) — the
phase-3 numbers, without the checks. Turns run old, new, new, old,
`--rounds` times. Prints one line per kernel, level and dtype with the
times and the ratio of the medians (new / old). The first round's turns
also run that tree's engine (`chip_smoke.py`'s FlagshipConfig, seeded
weights, one warm-up request) on one detect request under
torch.profiler and count its host synchronisations (`host_syncs`): one
line per tree. Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARK = "KERNEL_AB "
SYNCS = "host_syncs conv3d request"


def host_syncs(fn):
    """The CUDA runtime calls of one call of fn that make the host wait
    for the card (torch.profiler's record of cudaStreamSynchronize,
    cudaDeviceSynchronize, cudaEventSynchronize and the synchronous
    cudaMemcpy): {name: count}."""
    import torch
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
    return {e.key: e.count for e in prof.key_averages()
            if e.key.endswith("Synchronize") or e.key == "cudaMemcpy"}


def request_syncs(cs):
    """host_syncs of one conv3d detect request of the tree whose
    chip_smoke module is `cs`, after one warm-up request."""
    import numpy as np
    import torch
    cfg = cs.FlagshipConfig()
    eng = cs.MaskRCNN("inference", cfg, "build")
    eng.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    img = cs.request_images(rng, 1, cfg.IMAGE_MAX_DIM, cfg.NUM_VIEWS)
    rcam = cs.poses(rng, 1, cfg.NUM_VIEWS)
    kmat = cs.intrinsics(1, cfg.IMAGE_MAX_DIM)
    eng.detect(img, rcam, kmat)
    return host_syncs(lambda: eng.detect(img, rcam, kmat))


def child(tree, syncs=False):
    """Time the phase-3 kernel cases of the tree at `tree` (and, with
    `syncs`, count the host synchronisations of its conv3d request);
    print them as one JSON line after MARK."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs  # exits without a CUDA device
    from mulit_view_object_detection_torch.kernels import build
    from mulit_view_object_detection_torch.ops import projection as plain

    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, cfg = cs.DEV, cs.FlagshipConfig()
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    b, v, c = 1, 2, 64
    rcam = torch.from_numpy(cs.poses(rng, b, v)).to(dev)
    rcam4 = torch.from_numpy(cs.poses(rng, b, 4)).to(dev)
    kmat = torch.from_numpy(cs.intrinsics(b, 640)).to(dev)
    pts = torch.from_numpy(plain.voxel_grid_points(cfg)).to(dev)
    nx = ny = cfg.nvox
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for level, s in cs.LEVELS.items():
            feats = torch.randn(b * v, s * s, c, generator=gen).to(dev, dtype)
            x, y = (t.contiguous() for t in plain.project_voxel_coords(
                rcam, kmat, (640, 640), pts, s, s))
            feats4 = torch.randn(b * 4, s * s, c, generator=gen).to(dev,
                                                                    dtype)
            x4, y4 = (t.contiguous() for t in plain.project_voxel_coords(
                rcam4, kmat, (640, 640), pts, s, s))
            grid = torch.randn(b, nx, ny, cfg.nvox_z, c, generator=gen).to(
                dev, dtype)
            xg, yg, iz = plain.reprojection_coords(
                kmat, (640, 640), s, cfg.samples, cfg, nx, ny, cfg.nvox_z)
            cases = cs._unproject_cases(feats, x, y, s, v, dtype)
            cases.update(cs._unproject_view_cases(feats4, x4, y4, s, dtype))
            cases.update(cs._reproject_cases(grid, xg.contiguous(),
                                             yg.contiguous(), iz, dtype))
            for name, case in cases.items():
                key = f"{name} {level} {str(dtype).split('.')[1]}"
                out[key] = cs.device_ms(case[0])
    if syncs:
        out[SYNCS] = request_syncs(cs)
    print(MARK + json.dumps(out), flush=True)


def turn(tree, syncs=False):
    """One child process on `tree`: {kernel level dtype: ms}, and with
    `syncs` {SYNCS: {runtime call: count}}."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         str(tree)] + (["--syncs"] if syncs else []), capture_output=True,
        text=True, check=False)
    for line in proc.stdout.splitlines():
        if line.startswith(MARK):
            return json.loads(line[len(MARK):])
    raise RuntimeError(f"turn on {tree} failed ({proc.returncode}):\n"
                       f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_tree", nargs="?")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--syncs", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child).resolve(), args.syncs)
        return
    if not args.old_tree:
        ap.error("OLD_TREE is required")
    trees = {"old": Path(args.old_tree).resolve(), "new": ROOT}
    times = {"old": [], "new": []}
    for i, tag in enumerate(("old", "new", "new", "old") * args.rounds):
        times[tag].append(turn(trees[tag], syncs=i < 4))
    for tag in ("old", "new"):
        counts = [t.pop(SYNCS) for t in times[tag] if SYNCS in t]
        print(SYNCS, tag, [sum(c.values()) for c in counts],
              json.dumps(counts[0]), flush=True)
    for key in times["new"][0]:
        if key not in times["old"][0]:
            continue
        old = [t[key] for t in times["old"]]
        new = [t[key] for t in times["new"]]
        ratio = statistics.median(new) / statistics.median(old)
        print(key, "old", [round(t, 5) for t in old], "new",
              [round(t, 5) for t in new], "ratio", round(ratio, 4),
              flush=True)


if __name__ == "__main__":
    main()
