"""Voxel-grid -> ray-slice reprojection on the GPU (CUDA kernel).

Replaces the Pallas TPU kernel
`mulit_view_object_detection_tpu/kernels/reproject_pallas.py::
zslice_gather`; source `csrc/reproject.cu`. The TPU kernel recast the
nearest-voxel gather as a one-hot matmul per depth sample over a z-major
copy of the grid; on Hopper each output element is one load and one
store, so the kernel is bound by the bytes it writes, and it reads the
`[B, nx, ny, nz, C]` grid in place, one thread per output element with
channel-contiguous loads and stores. A copy, so exact in any dtype.

The wrapper takes the plain version (`ops/projection.py`) for a CPU
tensor only; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import projection as plain
from .build import check_launch, library

# Launches of the CUDA kernel in this process (plain CPU calls not counted).
launches = 0


def zslice_gather(grid, xg, yg, iz):
    """grid [B, nx, ny, nz, C] float32/bfloat16; xg, yg [B, S_d, npix]
    float32; iz [S_d] host ints in [-1, nz). The kernel takes at most
    kMaxSamples (csrc/reproject.cu) depth samples and reports more as a
    launch error. Returns [B, S_d, npix, C]."""
    global launches
    if grid.device.type == "cpu":
        return plain.zslice_gather(grid, xg, yg, iz)
    if grid.device.type != "cuda":
        raise ValueError(f"reproject kernel: unsupported device {grid.device}")
    b, nx, ny, nz, c = grid.shape
    s_d, npix = xg.shape[1], xg.shape[2]
    if grid.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"reproject kernel: grid dtype {grid.dtype}")
    if torch.is_grad_enabled() and grid.requires_grad:
        raise NotImplementedError(
            "reproject kernel: no backward kernel yet (training is slice 2)")
    for name, t in (("xg", xg), ("yg", yg)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, s_d, npix) \
                or t.device != grid.device:
            raise ValueError(f"reproject kernel: {name} must be float32 "
                             f"[{b}, {s_d}, {npix}] on {grid.device}")
    for t in (grid, xg, yg):
        if not t.is_contiguous():
            raise ValueError("reproject kernel: inputs must be contiguous")
    iz = np.ascontiguousarray(iz, np.int32)
    if iz.shape != (s_d,) or (iz < -1).any() or (iz >= nz).any():
        raise ValueError(f"reproject kernel: iz must be [{s_d}] in "
                         f"[-1, {nz})")
    out = torch.empty((b, s_d, npix, c), dtype=grid.dtype, device=grid.device)
    with torch.cuda.device(grid.device):
        err = library().mvod_reproject_nearest(
            grid.data_ptr(), xg.data_ptr(), yg.data_ptr(), iz.ctypes.data,
            out.data_ptr(), b, nx, ny, nz, c, s_d, npix,
            int(grid.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_reproject_nearest")
    launches += 1
    return out


def project_grid_nearest(grid, Kmat, image_shape, proj_size, samples,
                         config):
    """Render the fused grid [B, nx, ny, nz, C] to the main view as
    depth-sampled ray slices [B, samples, S, S, C] (nearest voxel,
    model_multi.py:357-369)."""
    b, nx, ny, nz, c = grid.shape
    xg, yg, iz = plain.reprojection_coords(Kmat, image_shape, proj_size,
                                           samples, config, nx, ny, nz)
    out = zslice_gather(grid, xg.contiguous(), yg.contiguous(), iz)
    return out.reshape(b, samples, proj_size, proj_size, c)
