"""Voxel-grid -> ray-slice reprojection on the GPU (CUDA kernels), with
gradient.

Replaces the Pallas TPU kernels of
`mulit_view_object_detection_tpu/kernels/reproject_pallas.py`:
`zslice_gather` (forward, `_fwd_kernel`) and its backward (`_bwd_kernel`,
via `_reproj_bwd`); source `csrc/reproject.cu`. The TPU kernels recast the
nearest-voxel gather and its transpose as one-hot matmuls per depth sample
over a z-major copy of the grid; on Hopper both move bytes and work on the
`[B, nx, ny, nz, C]` grid in place. The forward copies 16-byte channel
groups, one thread per (sample, pixel, group): exact in any dtype. The
backward writes every element of the gradient grid once, in g's dtype: a
block owns a band of one z-slice, builds the band's voxel -> pixel map in
shared memory from the samples that read the slice (none: it stores
zeros), and sums each voxel's g rows in float32 in ascending (sample,
pixel) order, the plain CPU `index_add_`'s order, so it equals the plain
version bit for bit and repeats itself run to run. Each kernel has a
scalar variant for a C that is not a whole number of 16-byte groups or an
unaligned tensor, and the backward maps the pixels in chunks where a
sample has more than MAX_CHUNK; the variant is a pure function of shape
and alignment (`fwd_plan`, `bwd_plan`), chosen before the launch.

`zslice_gather` is differentiable in the grid (a torch.autograd.Function,
as `jax.custom_vjp` is in the JAX package). Each wrapper takes the plain
version (`ops/projection.py`) for a CPU tensor only; for a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from ..ops import projection as plain
from . import unproject
from .build import check_launch, library

# Launches of the CUDA kernels in this process (plain CPU calls not
# counted): the forward and the backward, and both by variant
# ("fwd_vector", "fwd_scalar", "bwd_vector", "bwd_scalar",
# "bwd_vector_chunked", "bwd_scalar_chunked").
launches = 0
bwd_launches = 0
variants = collections.Counter()

THREADS = unproject.THREADS   # threads a block has (kThreads)
MAX_ACC = 32                  # float32 sums a backward thread keeps
                              # (kMaxAcc): items * vec
MAX_BAND = 256                # voxels a backward block owns (kMaxBand)
MAX_CHUNK = 4096              # pixels a backward block maps (kMaxChunk)
WARPS = THREADS // 32         # warps a block has (kWarps)

# The forward's variant and block: the unprojection forward's rule
# (16-byte groups where C is a whole number of them and the grid and
# output pointers are 16-byte aligned, else one channel a thread; gx
# threads over the groups, vy pixels a block).
fwd_plan = unproject.fwd_plan


class BwdPlan(NamedTuple):
    """Launch of the backward: `vec` channels a thread (1 for the scalar
    variants, else 16 bytes' worth); a block of THREADS threads owns `gx`
    channel groups (one of `slices`) of `band` = items * (THREADS // gx)
    voxels of a z-slice (one of `bands`), each thread `items` voxels; a
    block row stores one unread slice's zeros and sums one read slice; it
    maps at most `chunk` pixels of a sample at a time (the "_chunked"
    variants where a sample has more); `smem` bytes of shared memory."""
    variant: str
    vec: int
    gx: int
    items: int
    band: int
    bands: int
    slices: int
    chunk: int
    smem: int


def bwd_plan(nx, ny, c, npix, dtype, *pointers):
    """The backward's launch for an nx x ny slice, C channels of `dtype`,
    npix pixels a sample, g and the gradient grid at `pointers`: 16-byte
    groups where C is a whole number of them and every pointer is 16-byte
    aligned, else one channel a thread; as many voxels a thread as
    MAX_ACC float32 sums hold (4 in bf16, 8 in float32: a band of 128
    voxels at C = 64), at most MAX_BAND a band; chunks of MAX_CHUNK
    pixels where a sample has more."""
    vec = 128 // torch.finfo(dtype).bits        # channels in 16 bytes
    if c % vec or any(ptr % 16 for ptr in pointers):
        kind, vec = "scalar", 1
    else:
        kind = "vector"
    groups = max(1, c // vec)
    gx = min(groups, THREADS)
    vy = THREADS // gx
    items = max(1, min(MAX_ACC // vec, MAX_BAND // vy))
    band = items * vy
    chunk = max(1, min(npix, MAX_CHUNK))
    if npix > MAX_CHUNK:
        kind += "_chunked"
    smem = 4 * (2 * chunk + band * WARPS + WARPS)
    return BwdPlan(kind, vec, gx, items, band, -(-(nx * ny) // band),
                   -(-groups // gx), chunk, smem)


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
    plan = fwd_plan(c, grid.dtype, grid.data_ptr(), out.data_ptr())
    with torch.cuda.device(grid.device):
        err = library().mvod_reproject_nearest(
            grid.data_ptr(), xg.data_ptr(), yg.data_ptr(), iz.ctypes.data,
            out.data_ptr(), b, nx, ny, nz, c, s_d, npix, plan.vec, plan.gx,
            plan.vy, int(grid.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_reproject_nearest")
    launches += 1
    variants["fwd_" + plan.variant] += 1
    return out


def gather_bwd(g, xg, yg, iz, grid_shape):
    """Gradient of `gather` with respect to the grid: g [B, S_d, npix, C];
    grid_shape (B, nx, ny, nz, C). Returns [B, nx, ny, nz, C] in g's
    dtype: each voxel's float32 sum of the g rows that read it, in
    ascending (sample, pixel) order, rounded once (the plain version's
    sum on the CPU, bit for bit); voxels no valid sample read are 0."""
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
    dgrid = torch.empty(tuple(grid_shape), dtype=g.dtype, device=g.device)
    plan = bwd_plan(nx, ny, c, npix, g.dtype, g.data_ptr(), dgrid.data_ptr())
    with torch.cuda.device(g.device):
        err = library().mvod_reproject_nearest_bwd(
            g.data_ptr(), xg.data_ptr(), yg.data_ptr(), iz.ctypes.data,
            dgrid.data_ptr(), b, nx, ny, nz, c, s_d, npix, plan.vec, plan.gx,
            plan.items, plan.chunk, int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_reproject_nearest_bwd")
    bwd_launches += 1
    variants["bwd_" + plan.variant] += 1
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
