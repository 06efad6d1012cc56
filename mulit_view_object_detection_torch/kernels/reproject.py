"""Voxel-grid -> ray-slice reprojection on the GPU (CUDA kernels), with
gradient.

Replaces the Pallas TPU kernels of
`mulit_view_object_detection_tpu/kernels/reproject_pallas.py`:
`zslice_gather` (forward, `_fwd_kernel`) and its backward (`_bwd_kernel`,
via `_reproj_bwd`); source `csrc/reproject.cu`. The TPU kernels recast the
nearest-voxel gather and its transpose as one-hot matmuls per depth sample
over a z-major copy of the grid; on Hopper each output element is one load
and one store, and each gradient element one atomic add, so both kernels
are bound by bytes and work on the `[B, nx, ny, nz, C]` grid in place, one
thread per element of `[B, S_d, npix, C]`, channel fastest. The forward is
a copy, so exact in any dtype.

`zslice_gather` is differentiable in the grid (a torch.autograd.Function,
as `jax.custom_vjp` is in the JAX package). Each wrapper takes the plain
version (`ops/projection.py`) for a CPU tensor only; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import projection as plain
from .build import check_launch, library

# Launches of the CUDA kernels in this process (plain CPU calls not
# counted): the forward and the backward.
launches = 0
bwd_launches = 0


def _check(t, what, xg, yg, iz, b, nz):
    """Validate a call on the card; returns iz as contiguous host int32."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"reproject kernel: {what} dtype {t.dtype}")
    s_d, npix = xg.shape[1], xg.shape[2]
    for name, c in (("xg", xg), ("yg", yg)):
        if c.dtype != torch.float32 or tuple(c.shape) != (b, s_d, npix) \
                or c.device != t.device or not c.is_contiguous():
            raise ValueError(f"reproject kernel: {name} must be contiguous "
                             f"float32 [{b}, {s_d}, {npix}] on {t.device}")
    iz = np.ascontiguousarray(iz, np.int32)
    if iz.shape != (s_d,) or (iz < -1).any() or (iz >= nz).any():
        raise ValueError(f"reproject kernel: iz must be [{s_d}] in "
                         f"[-1, {nz})")
    return iz


def _device(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"reproject kernel: unsupported device {t.device}")
    return t.device.type


def gather(grid, xg, yg, iz):
    """Forward only. grid [B, nx, ny, nz, C] float32/bfloat16; xg, yg
    [B, S_d, npix] float32; iz [S_d] host ints in [-1, nz). The kernel
    takes at most kMaxSamples (csrc/reproject.cu) depth samples and
    reports more as a launch error. Returns [B, S_d, npix, C]."""
    global launches
    if _device(grid) == "cpu":
        return plain.zslice_gather(grid, xg, yg, iz)
    b, nx, ny, nz, c = grid.shape
    iz = _check(grid, "grid", xg, yg, iz, b, nz)
    if not grid.is_contiguous():
        raise ValueError("reproject kernel: grid must be contiguous")
    s_d, npix = xg.shape[1], xg.shape[2]
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


def gather_bwd(g, xg, yg, iz, grid_shape):
    """Gradient of `gather` with respect to the grid: g [B, S_d, npix, C];
    grid_shape (B, nx, ny, nz, C). Returns [B, nx, ny, nz, C] in g's
    dtype, summed in float32 (atomics on the card, so the last bits vary
    from run to run); voxels no valid sample read are 0."""
    global bwd_launches
    if _device(g) == "cpu":
        return plain.zslice_gather_bwd(g, xg, yg, iz, grid_shape, g.dtype)
    b, nx, ny, nz, c = grid_shape
    iz = _check(g, "g", xg, yg, iz, b, nz)
    s_d, npix = xg.shape[1], xg.shape[2]
    if tuple(g.shape) != (b, s_d, npix, c):
        raise ValueError(f"reproject bwd: g {tuple(g.shape)} vs "
                         f"[{b}, {s_d}, {npix}, {c}]")
    g = g.contiguous()
    acc = torch.empty(tuple(grid_shape), dtype=torch.float32, device=g.device)
    dgrid = acc if g.dtype == torch.float32 else torch.empty_like(
        acc, dtype=g.dtype)
    with torch.cuda.device(g.device):
        err = library().mvod_reproject_nearest_bwd(
            g.data_ptr(), xg.data_ptr(), yg.data_ptr(), iz.ctypes.data,
            acc.data_ptr(), dgrid.data_ptr(), b, nx, ny, nz, c, s_d, npix,
            int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_reproject_nearest_bwd")
    bwd_launches += 1
    return dgrid


class _ZSliceGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, xg, yg, iz):
        ctx.iz = iz
        ctx.grid_shape = tuple(grid.shape)
        ctx.save_for_backward(xg, yg)
        return gather(grid, xg, yg, iz)

    @staticmethod
    def backward(ctx, g):
        xg, yg = ctx.saved_tensors
        return gather_bwd(g, xg, yg, ctx.iz, ctx.grid_shape), None, None, None


def zslice_gather(grid, xg, yg, iz):
    """Differentiable `gather`: grid [B, nx, ny, nz, C]; xg, yg
    [B, S_d, npix] float32 (no gradient); iz [S_d] host ints."""
    return _ZSliceGather.apply(grid, xg, yg, np.asarray(iz))


def project_grid_nearest(grid, Kmat, image_shape, proj_size, samples,
                         config):
    """Render the fused grid [B, nx, ny, nz, C] to the main view as
    depth-sampled ray slices [B, samples, S, S, C] (nearest voxel,
    model_multi.py:357-369); differentiable in the grid."""
    b, nx, ny, nz, c = grid.shape
    with torch.no_grad():
        xg, yg, iz = plain.reprojection_coords(Kmat, image_shape, proj_size,
                                               samples, config, nx, ny, nz)
    out = zslice_gather(grid, xg.contiguous(), yg.contiguous(), iz)
    return out.reshape(b, samples, proj_size, proj_size, c)
