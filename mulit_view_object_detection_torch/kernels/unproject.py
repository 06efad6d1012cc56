"""Voxel-grid unprojection on the GPU (CUDA kernels), with gradient.

Replaces the Pallas TPU kernels of
`mulit_view_object_detection_tpu/kernels/unproject_pallas.py`:
`bilinear_gather_fused` (forward, `_fwd_kernel_fused`), `bilinear_gather`
(forward, `_fwd_kernel`) and their backward (`_bwd_kernel`, reached from
`_bwd_rule_fused` and `_bwd_rule`). The TPU kernels recast the 4-tap
bilinear gather and its transpose as one-hot matmuls for the MXU
(O(N*P*C) work); on Hopper each output element is at most 4 loads, and
each gradient element at most 4 adds, so the kernels are bound by bytes.

Two output layouts, one set of kernels (`csrc/unproject.cu`): the
per-view layout is the fused one with B*V batch elements of one view each
and no ReLU.
  * fused (`unproject_features_fused`): channels-last
    `[B, nx, ny, nz, V*C]`, the views concatenated on channels and relu'd,
    the JAX layout that the conv3d U-Net and the ident fusion read (as
    `[B, V*C, nx, ny, nz]` in torch.channels_last_3d memory format, a
    permuted view, no copy);
  * per view (`unproject_features`): `[B, V, nx, ny, nz, C]`, which the
    add, mean and lstm3d fusions read.
The forward moves 16-byte channel groups (the scalar variant where C or a
pointer does not allow them); the backward walks each lane's voxels and
adds running sums per tap only when the tap's pixel changes (the direct
scatter where C, g or the saved output does not allow groups of 4
channels). The variant is a pure function of shape and alignment
(`fwd_plan`, `bwd_plan`), chosen before the launch.

Both gathers are differentiable in `feats` (torch.autograd.Functions, as
`jax.custom_vjp` is in the JAX package); the coordinates carry no
gradient. Each wrapper takes the plain version (`ops/projection.py`) for a
CPU tensor only; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from ..ops import projection as plain
from .build import check_launch, library

# Launches of the CUDA kernels in this process (plain CPU calls not
# counted): the fused layout's forward and backward, and the per-view
# layout's; each layout's also by variant ("fwd_vector", "fwd_scalar",
# "bwd_walk", "bwd_direct").
launches = 0
bwd_launches = 0
fused_variants = collections.Counter()
view_launches = 0
view_bwd_launches = 0
view_variants = collections.Counter()

THREADS = 256               # threads a block has (kThreads)
WALK_VEC = 4                # channels a backward walk thread owns
WALK_BLOCKS_PER_SM = 2      # blocks a SM of the backward walk's grid
MAX_GROUPS = 32             # channel groups of a backward slice


def _check_device(t, what):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unproject kernel: unsupported device {t.device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unproject kernel: {what} dtype {t.dtype}")


def _check_coords(x, y, bv, n, device):
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32 or tuple(t.shape) != (bv, n) \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"unproject kernel: {name} must be contiguous "
                             f"float32 [{bv}, {n}] on {device}")


def _forward(feats, x, y, fh, fw, v, relu):
    """Launch mvod_unproject_fused: feats [B*V, fh*fw, C] on the card;
    returns (out [B, N, V*C], the launch plan)."""
    bv, p, c = feats.shape
    n = x.shape[1]
    if p != fh * fw or bv % v:
        raise ValueError(f"unproject kernel: feats {tuple(feats.shape)} vs "
                         f"fh={fh} fw={fw} v={v}")
    if not feats.is_contiguous():
        raise ValueError("unproject kernel: feats must be contiguous")
    _check_coords(x, y, bv, n, feats.device)
    out = torch.empty((bv // v, n, v * c), dtype=feats.dtype,
                      device=feats.device)
    plan = fwd_plan(c, feats.dtype, feats.data_ptr(), out.data_ptr())
    with torch.cuda.device(feats.device):
        err = library().mvod_unproject_fused(
            feats.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            bv // v, v, fh, fw, c, n, int(relu), plan.vec, plan.gx, plan.vy,
            int(feats.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_unproject_fused")
    return out, plan


def _backward(g, saved, x, y, fh, fw, v, relu):
    """Launch mvod_unproject_fused_bwd: g (and, with relu, saved)
    [B, N, V*C] on the card; returns (dfeats [B*V, fh*fw, C], the launch
    plan)."""
    b, n, vc = g.shape
    if vc % v:
        raise ValueError(f"unproject bwd: g {tuple(g.shape)} vs v={v}")
    c = vc // v
    if relu and (saved is None or saved.shape != g.shape
                 or saved.dtype != g.dtype or saved.device != g.device):
        raise ValueError("unproject bwd: relu needs the forward's output, "
                         "shaped and typed as g")
    g = g.contiguous()
    saved = saved.contiguous() if relu else None
    _check_coords(x, y, b * v, n, g.device)
    acc = torch.empty((b * v, fh * fw, c), dtype=torch.float32,
                      device=g.device)
    dfeats = acc if g.dtype == torch.float32 else torch.empty_like(
        acc, dtype=g.dtype)
    pointers = (g.data_ptr(),) + ((saved.data_ptr(),) if relu else ())
    plan = bwd_plan(b * v, c, n, g.dtype, *pointers,
                    sms=_sm_count(g.device.index))
    with torch.cuda.device(g.device):
        err = library().mvod_unproject_fused_bwd(
            g.data_ptr(), saved.data_ptr() if relu else None,
            x.data_ptr(), y.data_ptr(), acc.data_ptr(), dfeats.data_ptr(),
            b, v, fh, fw, c, n, int(relu), plan.gx, plan.lanes, plan.chunk,
            int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_unproject_fused_bwd")
    return dfeats, plan


def gather_fused(feats, x, y, fh, fw, v, relu=True):
    """Forward only. feats [B*V, fh*fw, C] float32/bfloat16; x, y
    [B*V, N] float32. Returns [B, N, V*C] in feats' dtype (see
    ops/projection.py::bilinear_gather_fused)."""
    global launches
    _check_device(feats, "feats")
    if feats.device.type == "cpu":
        return plain.bilinear_gather_fused(feats, x, y, fh, fw, v, relu)
    out, plan = _forward(feats, x, y, fh, fw, v, relu)
    launches += 1
    fused_variants["fwd_" + plan.variant] += 1
    return out


def gather_fused_bwd(g, saved, x, y, fh, fw, v, relu=True):
    """Gradient of `gather_fused` with respect to feats. g and saved (its
    output, read when relu) [B, N, V*C]; x, y [B*V, N] float32. Returns
    dfeats [B*V, fh*fw, C] in g's dtype, summed in float32 (atomics on
    the card, so the last bits vary from run to run)."""
    global bwd_launches
    _check_device(g, "g")
    if g.device.type == "cpu":
        return plain.bilinear_gather_fused_bwd(g, saved, x, y, fh, fw, v,
                                               relu, g.dtype)
    dfeats, plan = _backward(g, saved, x, y, fh, fw, v, relu)
    bwd_launches += 1
    fused_variants["bwd_" + plan.variant] += 1
    return dfeats


class _GatherFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, x, y, fh, fw, v, relu):
        out = gather_fused(feats, x, y, fh, fw, v, relu)
        ctx.geometry = (fh, fw, v, relu)
        ctx.save_for_backward(x, y, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, saved = ctx.saved_tensors
        fh, fw, v, relu = ctx.geometry
        return (gather_fused_bwd(g, saved, x, y, fh, fw, v, relu),
                None, None, None, None, None, None)


def bilinear_gather_fused(feats, x, y, fh, fw, v, relu=True):
    """Differentiable `gather_fused`: feats [B*V, fh*fw, C]; x, y [B*V, N]
    float32 (no gradient). Returns [B, N, V*C] in feats' dtype."""
    return _GatherFused.apply(feats, x, y, fh, fw, v, relu)


class FwdPlan(NamedTuple):
    """Launch of the forward (either layout): `vec` channels a thread (1
    for the scalar variant, else 16 bytes' worth), a block of `gx` threads
    over each view's C / vec channel groups times `vy` voxels at a time,
    which walks a tile of THREADS voxels of one view."""
    variant: str
    vec: int
    gx: int
    vy: int


class BwdPlan(NamedTuple):
    """Launch of the backward (either layout). "walk": a block of
    (gx, lanes) threads owns gx groups of WALK_VEC channels (one of
    `slices`) and `chunk` voxels (one of `nchunks`) of one view row; each
    lane walks chunk / lanes of the voxels. "direct": one thread per
    element of g (the other fields 0)."""
    variant: str
    gx: int
    lanes: int
    slices: int
    chunk: int
    nchunks: int


def _vec(dtype):
    """Channels in 16 bytes of `dtype`."""
    return 128 // torch.finfo(dtype).bits


def fwd_plan(c, dtype, *pointers):
    """The forward's variant for C channels a view of `dtype` at the given
    data pointers (features and output): 16-byte groups where C is a whole
    number of them (then every view's offset in a fused row, view * C, is
    aligned too) and every pointer is 16-byte aligned, else the scalar
    variant."""
    vec = _vec(dtype)
    if c % vec or any(ptr % 16 for ptr in pointers):
        variant, vec = "scalar", 1
    else:
        variant = "vector"
    gx = max(1, min(c // vec, THREADS))
    return FwdPlan(variant, vec, gx, max(1, THREADS // gx))


def bwd_plan(bv, c, n, dtype, *pointers, sms=132):
    """The backward's launch for BV view rows, C channels a view of
    `dtype` and N voxels, g (and, under the ReLU, the saved output) at
    `pointers`, on a card with `sms` SMs: the walk where C is a multiple
    of WALK_VEC (then every view's offset in a fused row is too) and
    every pointer is aligned to WALK_VEC elements, else the direct
    scatter. A slice is up to MAX_GROUPS groups; the voxels are cut into
    chunks for WALK_BLOCKS_PER_SM blocks a SM (longer walks sum more taps
    before each atomic; fewer blocks leave SMs idle)."""
    es = torch.finfo(dtype).bits // 8
    if c == 0 or c % WALK_VEC or any(ptr % (WALK_VEC * es)
                                     for ptr in pointers):
        return BwdPlan("direct", 0, 0, 0, 0, 0)
    groups = c // WALK_VEC
    gx = min(groups, MAX_GROUPS)
    slices = -(-groups // gx)
    lanes = THREADS // gx
    want = sms * WALK_BLOCKS_PER_SM // max(1, bv * slices)
    nchunks = max(1, min(want, -(-n // lanes)))
    chunk = max(1, -(-n // nchunks))
    return BwdPlan("walk", gx, lanes, slices, chunk, max(1, -(-n // chunk)))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def gather(feats, x, y, fh, fw):
    """Forward only, per-view layout (the fused kernel with one view a
    batch element and no ReLU). feats [B*V, fh*fw, C] float32/bfloat16;
    x, y [B*V, N] float32. Returns [B*V, N, C] in feats' dtype (see
    ops/projection.py::bilinear_gather)."""
    global view_launches
    _check_device(feats, "feats")
    if feats.device.type == "cpu":
        return plain.bilinear_gather(feats, x, y, fh, fw)
    out, plan = _forward(feats, x, y, fh, fw, 1, False)
    view_launches += 1
    view_variants["fwd_" + plan.variant] += 1
    return out


def gather_bwd(g, x, y, fh, fw):
    """Gradient of `gather` with respect to feats. g [B*V, N, C]; x, y
    [B*V, N] float32. Returns dfeats [B*V, fh*fw, C] in g's dtype, summed
    in float32 (atomics on the card, so the last bits vary from run to
    run)."""
    global view_bwd_launches
    _check_device(g, "g")
    if g.device.type == "cpu":
        return plain.bilinear_gather_bwd(g, x, y, fh, fw, g.dtype)
    dfeats, plan = _backward(g, None, x, y, fh, fw, 1, False)
    view_bwd_launches += 1
    view_variants["bwd_" + plan.variant] += 1
    return dfeats


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, x, y, fh, fw):
        ctx.geometry = (fh, fw)
        ctx.save_for_backward(x, y)
        return gather(feats, x, y, fh, fw)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return gather_bwd(g, x, y, *ctx.geometry), None, None, None, None


def bilinear_gather(feats, x, y, fh, fw):
    """Differentiable `gather`: feats [B*V, fh*fw, C]; x, y [B*V, N]
    float32 (no gradient). Returns [B*V, N, C] in feats' dtype."""
    return _Gather.apply(feats, x, y, fh, fw)


def _voxel_coords(feats, Rcam, Kmat, image_shape, grid_pts):
    """Per-view feature-plane coords x, y [B*V, N] of the voxel centers,
    contiguous float32, no gradient."""
    fh, fw = feats.shape[2:4]
    with torch.no_grad():
        x, y = plain.project_voxel_coords(Rcam, Kmat, image_shape, grid_pts,
                                          fh, fw)
    return x.contiguous(), y.contiguous()


def unproject_features(feats, Rcam, Kmat, image_shape, grid_pts, grid_shape):
    """Lift every view's features into the voxel grid, view by view.

    feats [B, V, fh, fw, C]; Rcam [B, V, 3, 4]; Kmat [B, 3, 3]; grid_pts
    [4, N] tensor from voxel_grid_points; grid_shape (nx, ny, nz).
    Returns [B, V, nx, ny, nz, C] (unproject_features_pallas's layout);
    differentiable in feats."""
    b, v, fh, fw, c = feats.shape
    x, y = _voxel_coords(feats, Rcam, Kmat, image_shape, grid_pts)
    out = bilinear_gather(feats.reshape(b * v, fh * fw, c), x, y, fh, fw)
    return out.reshape(b, v, *grid_shape, c)


def unproject_features_fused(feats, Rcam, Kmat, image_shape, grid_pts,
                             grid_shape, relu=True):
    """Lift every view's features into the voxel grid.

    feats [B, V, fh, fw, C]; Rcam [B, V, 3, 4]; Kmat [B, 3, 3]; grid_pts
    [4, N] tensor from voxel_grid_points; grid_shape (nx, ny, nz).
    Returns [B, nx, ny, nz, V*C]: the views concatenated on channels and
    relu'd, the layout the conv3d U-Net reads; differentiable in feats."""
    b, v, fh, fw, c = feats.shape
    x, y = _voxel_coords(feats, Rcam, Kmat, image_shape, grid_pts)
    out = bilinear_gather_fused(feats.reshape(b * v, fh * fw, c), x, y,
                                fh, fw, v, relu)
    return out.reshape(b, *grid_shape, v * c)
