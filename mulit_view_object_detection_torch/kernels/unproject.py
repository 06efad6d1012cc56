"""Fused voxel-grid unprojection on the GPU (CUDA kernel).

Replaces the Pallas TPU kernel
`mulit_view_object_detection_tpu/kernels/unproject_pallas.py::
bilinear_gather_fused`; source `csrc/unproject.cu`. The TPU kernel recast
the 4-tap bilinear gather as a one-hot matmul for the MXU (O(N*P*C)
work); on Hopper each output element is at most 4 loads, so the kernel is
bound by the bytes it writes, and its design is one thread per output
element with channel-contiguous loads and stores.

Output layout: channels-last `[B, nx, ny, nz, V*C]`, the JAX layout. The
conv3d U-Net reads it as `[B, V*C, nx, ny, nz]` in torch.channels_last_3d
memory format (a permuted view, no copy).

The wrapper takes the plain version (`ops/projection.py`) for a CPU
tensor only; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..ops import projection as plain
from .build import check_launch, library

# Launches of the CUDA kernel in this process (plain CPU calls not counted).
launches = 0


def bilinear_gather_fused(feats, x, y, fh, fw, v, relu=True):
    """feats [B*V, fh*fw, C] float32/bfloat16; x, y [B*V, N] float32.
    Returns [B, N, V*C] in feats' dtype (see ops/projection.py)."""
    global launches
    if feats.device.type == "cpu":
        return plain.bilinear_gather_fused(feats, x, y, fh, fw, v, relu)
    if feats.device.type != "cuda":
        raise ValueError(f"unproject kernel: unsupported device {feats.device}")
    bv, p, c = feats.shape
    n = x.shape[1]
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unproject kernel: feats dtype {feats.dtype}")
    if torch.is_grad_enabled() and feats.requires_grad:
        raise NotImplementedError(
            "unproject kernel: no backward kernel yet (training is slice 2)")
    if p != fh * fw or bv % v:
        raise ValueError(f"unproject kernel: feats {tuple(feats.shape)} vs "
                         f"fh={fh} fw={fw} v={v}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32 or tuple(t.shape) != (bv, n) \
                or t.device != feats.device:
            raise ValueError(f"unproject kernel: {name} must be float32 "
                             f"[{bv}, {n}] on {feats.device}")
    for t in (feats, x, y):
        if not t.is_contiguous():
            raise ValueError("unproject kernel: inputs must be contiguous")
    out = torch.empty((bv // v, n, v * c), dtype=feats.dtype,
                      device=feats.device)
    with torch.cuda.device(feats.device):
        err = library().mvod_unproject_fused(
            feats.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            bv // v, v, fh, fw, c, n, int(relu),
            int(feats.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_unproject_fused")
    launches += 1
    return out


def unproject_features_fused(feats, Rcam, Kmat, image_shape, grid_pts,
                             grid_shape, relu=True):
    """Lift every view's features into the voxel grid.

    feats [B, V, fh, fw, C]; Rcam [B, V, 3, 4]; Kmat [B, 3, 3]; grid_pts
    [4, N] tensor from voxel_grid_points; grid_shape (nx, ny, nz).
    Returns [B, nx, ny, nz, V*C]: the views concatenated on channels and
    relu'd, the layout the conv3d U-Net reads."""
    b, v, fh, fw, c = feats.shape
    nx, ny, nz = grid_shape
    x, y = plain.project_voxel_coords(Rcam, Kmat, image_shape, grid_pts,
                                      fh, fw)
    out = bilinear_gather_fused(
        feats.reshape(b * v, fh * fw, c), x.contiguous(), y.contiguous(),
        fh, fw, v, relu)
    return out.reshape(b, nx, ny, nz, v * c)
