"""Voxel-grid unprojection on the GPU (CUDA kernels), with gradient.

Replaces the Pallas TPU kernels of
`mulit_view_object_detection_tpu/kernels/unproject_pallas.py`:
`bilinear_gather_fused` (forward, `_fwd_kernel_fused`), `bilinear_gather`
(forward, `_fwd_kernel`) and their backward (`_bwd_kernel`, reached from
`_bwd_rule_fused` and `_bwd_rule`); source `csrc/unproject.cu`. The TPU
kernels recast the 4-tap bilinear gather and its transpose as one-hot
matmuls for the MXU (O(N*P*C) work); on Hopper each output element is at
most 4 loads, and each gradient element at most 4 atomic adds, so the
kernels are bound by bytes, one thread per element of the output (or of
the gradient), channel fastest.

Two output layouts, one kernel template:
  * fused (`unproject_features_fused`): channels-last
    `[B, nx, ny, nz, V*C]`, the views concatenated on channels and relu'd,
    the JAX layout that the conv3d U-Net and the ident fusion read (as
    `[B, V*C, nx, ny, nz]` in torch.channels_last_3d memory format, a
    permuted view, no copy);
  * per view (`unproject_features`): `[B, V, nx, ny, nz, C]`, which the
    add, mean and lstm3d fusions read.

Both gathers are differentiable in `feats` (torch.autograd.Functions, as
`jax.custom_vjp` is in the JAX package); the coordinates carry no
gradient. Each wrapper takes the plain version (`ops/projection.py`) for a
CPU tensor only; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from ..ops import projection as plain
from .build import check_launch, library

# Launches of the CUDA kernels in this process (plain CPU calls not
# counted): the fused layout's forward and backward, and the per-view
# layout's.
launches = 0
bwd_launches = 0
view_launches = 0
view_bwd_launches = 0


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


def gather_fused(feats, x, y, fh, fw, v, relu=True):
    """Forward only. feats [B*V, fh*fw, C] float32/bfloat16; x, y
    [B*V, N] float32. Returns [B, N, V*C] in feats' dtype (see
    ops/projection.py::bilinear_gather_fused)."""
    global launches
    _check_device(feats, "feats")
    if feats.device.type == "cpu":
        return plain.bilinear_gather_fused(feats, x, y, fh, fw, v, relu)
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
    with torch.cuda.device(feats.device):
        err = library().mvod_unproject_fused(
            feats.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            bv // v, v, fh, fw, c, n, int(relu),
            int(feats.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_unproject_fused")
    launches += 1
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
    with torch.cuda.device(g.device):
        err = library().mvod_unproject_fused_bwd(
            g.data_ptr(), saved.data_ptr() if relu else None,
            x.data_ptr(), y.data_ptr(), acc.data_ptr(), dfeats.data_ptr(),
            b, v, fh, fw, c, n, int(relu), int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_unproject_fused_bwd")
    bwd_launches += 1
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


def gather(feats, x, y, fh, fw):
    """Forward only, per-view layout. feats [B*V, fh*fw, C]
    float32/bfloat16; x, y [B*V, N] float32. Returns [B*V, N, C] in
    feats' dtype (see ops/projection.py::bilinear_gather)."""
    global view_launches
    _check_device(feats, "feats")
    if feats.device.type == "cpu":
        return plain.bilinear_gather(feats, x, y, fh, fw)
    bv, p, c = feats.shape
    n = x.shape[1]
    if p != fh * fw:
        raise ValueError(f"unproject kernel: feats {tuple(feats.shape)} vs "
                         f"fh={fh} fw={fw}")
    if not feats.is_contiguous():
        raise ValueError("unproject kernel: feats must be contiguous")
    _check_coords(x, y, bv, n, feats.device)
    out = torch.empty((bv, n, c), dtype=feats.dtype, device=feats.device)
    with torch.cuda.device(feats.device):
        err = library().mvod_unproject(
            feats.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            bv, fh, fw, c, n, int(feats.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_unproject")
    view_launches += 1
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
    bv, n, c = g.shape
    g = g.contiguous()
    _check_coords(x, y, bv, n, g.device)
    acc = torch.empty((bv, fh * fw, c), dtype=torch.float32, device=g.device)
    dfeats = acc if g.dtype == torch.float32 else torch.empty_like(
        acc, dtype=g.dtype)
    with torch.cuda.device(g.device):
        err = library().mvod_unproject_bwd(
            g.data_ptr(), x.data_ptr(), y.data_ptr(), acc.data_ptr(),
            dfeats.data_ptr(), bv, fh, fw, c, n,
            int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "mvod_unproject_bwd")
    view_bwd_launches += 1
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
