"""Camera pose math (host-side numpy).

A numpy copy of `mulit_view_object_detection_tpu/utils/pose.py`, not an
import of it: the port imports nothing of the JAX package, not even
a module that imports no jax itself, so it runs where jax is absent.

  quat2rot  -> mrcnn/utils.py:1175-1194 (and duplicated in model_multi.py:372,
               projection.py) — implemented once here.
  vec2rot   -> mrcnn/utils.py:1210-1218 (InteriorNet eye/lookat/up -> R;
               note the reference returns R.T — preserved).
  make_extrinsics / invert_extrinsics — [R|t] helpers for the projective
               pipeline (model_multi.py:137-143 builds [R^T | -R^T t]).
"""

from __future__ import annotations

import numpy as np


def normalize(v):
    return v / np.linalg.norm(v)


def quat2rot(q):
    """q = [w, x, y, z] -> 3x3 rotation matrix."""
    eps = 1e-5
    w, x, y, z = q
    n = np.linalg.norm(q)
    s = 0 if n < eps else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def vec2rot(view_pose):
    """InteriorNet HD7 camera pose: [eye(3), lookat(3), up(3)] -> rotation.

    Matches utils.py:1210-1218 including the final transpose.
    """
    camera_pose = view_pose[:3]
    lookat_pose = view_pose[3:6]
    up = view_pose[6:]
    R = np.diag(np.ones(3))
    R[2, :3] = normalize(lookat_pose - camera_pose)
    R[0, :3] = normalize(np.cross(R[2, :3], (up - camera_pose)))
    R[1, :3] = -normalize(np.cross(R[0, :3], R[2, :3]))
    return R.T


def make_extrinsics(R, t):
    """[R|t] 3x4 world->camera extrinsics."""
    Rt = np.zeros((3, 4))
    Rt[:, :3] = R
    Rt[:, 3] = t
    return Rt


def invert_extrinsics(Rt):
    """[R|t] -> [R^T | -R^T t] (camera->world as a 3x4)."""
    R = Rt[:, :3]
    t = Rt[:, 3]
    out = np.zeros((3, 4))
    out[:, :3] = R.T
    out[:, 3] = -R.T @ t
    return out


def look_at_extrinsics(eye, target, up=(0.0, 1.0, 0.0)):
    """Build a world->camera [R|t] looking from eye at target (synthetic
    scenes / tests). Camera convention: +z forward, y down-ish as in
    vec2rot."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    z = normalize(target - eye)
    x = normalize(np.cross(z, up))
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)  # world->camera rows
    t = -R @ eye
    return make_extrinsics(R, t)
