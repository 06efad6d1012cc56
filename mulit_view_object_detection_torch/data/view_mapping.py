"""Offline view-graph builders.

A numpy copy of `mulit_view_object_detection_tpu/data/view_mapping.py`:
the port imports nothing of the JAX package, not even a module without
jax.

  build_view_mapping_seq — sequential HD1: each frame's neighbors are the
    surrounding frames in a sliding window of `view_range`
    (samples/interior/view_mapping_seq.py:25-71).

  build_view_mapping — non-sequential HD7: for each image pair (i, j) in a
    scene, project a probe voxel grid anchored `grid_dist` meters in front
    of camera i into camera j; j is a neighbor of i if more than
    `threshold` of the probe voxels land inside j's frame
    (samples/interior/view_mapping.py:36-194, 20% threshold at :180).

  build_instance_mapping — instance-centric index: instance ->
    [[class_id, frame_id], ...] over frames where it is visible
    (samples/interior/instance_mapping.py:26-69).
"""

from __future__ import annotations

import json

import numpy as np


def build_view_mapping_seq(frame_ids, view_range=20):
    """frame_ids: ordered frame names of ONE sequential scene.
    Returns {frame: [neighbors...]} (the surrounding view_range-1 frames)."""
    n = len(frame_ids)
    mapping = {}
    for i, fid in enumerate(frame_ids):
        lo = max(0, i - view_range // 2)
        hi = min(n, lo + view_range)
        lo = max(0, hi - view_range)
        mapping[fid] = [frame_ids[j] for j in range(lo, hi) if j != i]
    return mapping


def _probe_grid(pose, grid_dist=6.0, extent=3.0, n=10):
    """10^3 probe voxel centers anchored grid_dist in front of camera
    `pose` (cam->world [3,4]) — world coordinates [3, n^3]."""
    r = np.linspace(-extent / 2, extent / 2, n)
    xs, ys, zs = np.meshgrid(r, r, r + grid_dist, indexing="ij")
    pts_cam = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=0)
    R, t = pose[:, :3], pose[:, 3:4]
    return R @ pts_cam + t


def covisibility(pose_i, pose_j, K, image_shape, grid_dist=6.0,
                 threshold=0.2, n=10):
    """Fraction of camera-i's probe voxels visible in camera j's frame, and
    whether it exceeds threshold."""
    pts_w = _probe_grid(pose_i, grid_dist=grid_dist, n=n)
    R, t = pose_j[:, :3], pose_j[:, 3:4]
    # world -> cam j
    pts_c = R.T @ (pts_w - t)
    z = pts_c[2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = (K[:2, :2] @ (pts_c[:2] / z)) + K[:2, 2:3]
    h, w = image_shape
    inside = ((z > 0) & (uv[0] >= 0) & (uv[0] < w)
              & (uv[1] >= 0) & (uv[1] < h))
    frac = float(np.mean(inside))
    return frac, frac > threshold


def build_view_mapping(poses, K, image_shape, grid_dist=6.0, threshold=0.2):
    """poses: {frame_id: cam->world [3,4]} for ONE scene.
    Returns {frame: [co-visible neighbor frames...]}."""
    ids = list(poses.keys())
    mapping = {fid: [] for fid in ids}
    for i, fi in enumerate(ids):
        for fj in ids:
            if fi == fj:
                continue
            _, ok = covisibility(poses[fi], poses[fj], K, image_shape,
                                 grid_dist=grid_dist, threshold=threshold)
            if ok:
                mapping[fi].append(fj)
    return mapping


def build_instance_mapping(frames_to_instances):
    """frames_to_instances: {frame_id: [(instance_id, class_id), ...]}.
    Returns {instance_id: [[class_id, frame_id], ...]}."""
    out = {}
    for frame_id, instances in frames_to_instances.items():
        for instance_id, class_id in instances:
            out.setdefault(str(instance_id), []).append(
                [int(class_id), frame_id])
    return out


def save_json(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)
