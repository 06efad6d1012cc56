"""Projective multi-view geometry in torch, and the plain versions of the
two gathers that `kernels/` runs as CUDA kernels.

Port of `mulit_view_object_detection_tpu/ops/projection.py` plus the
coordinate prologues of its Pallas wrappers
(`kernels/unproject_pallas.py::_project_voxel_coords`,
`kernels/reproject_pallas.py::_coords`). Conventions kept exactly:

  * `Rcam[b, v]` is a [3, 4] camera->world pose; world->camera is
    [R^T | -R^T t]. The voxel grid lives in the main view's camera frame.
  * Grid tensors are channels-last `[B, nx, ny, nz, C]`, voxel axes x, y,
    z with z fastest; features are `[B, V, fh, fw, C]`.
  * Every out-of-bounds bilinear tap contributes zero, tap by tap.
  * Nearest reprojection rounds half-to-even; flat indices are x-major.
  * The reprojection's z index depends only on the depth sample, so it is
    computed on the host (`np.rint`), -1 meaning out of grid.

The plain gathers here serve CPU tensors and are the oracles the CUDA
kernels are held against on the card.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Grid construction (host-side, static) — a numpy copy, see ops/anchors.py
# for why the JAX package's module cannot be imported
# ---------------------------------------------------------------------------

def voxel_grid_points(config):
    """Homogeneous voxel-center coordinates [4, nx*ny*nz] in the main-view
    camera frame, index order (x, y, z) with z fastest."""
    gx = np.arange(config.vmin + config.vsize / 2.0, config.vmax,
                   config.vsize)[:config.nvox]
    gz = np.arange(config.vmin_z + config.vsize_z / 2.0, config.vmax_z,
                   config.vsize_z)[:config.nvox_z]
    xs, ys, zs = np.meshgrid(gx, gx, gz, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), zs.ravel(),
                    np.ones(xs.size)], axis=0)
    return pts.astype(np.float32)


# ---------------------------------------------------------------------------
# Camera math
# ---------------------------------------------------------------------------

def pose_inverse(Rt):
    """[..., 3, 4] cam->world pose -> world->cam [R^T | -R^T t]."""
    R_T = Rt[..., :, :3].transpose(-1, -2)
    return torch.cat([R_T, -R_T @ Rt[..., :, 3:4]], dim=-1)


def _to_hom4(Rt):
    """[..., 3, 4] -> [..., 4, 4] by appending [0, 0, 0, 1]."""
    last = Rt.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        Rt.shape[:-2] + (1, 4))
    return torch.cat([Rt, last], dim=-2)


def project_voxel_coords(Rcam, Kmat, image_shape, grid_pts, fh, fw):
    """Voxel centers -> per-view feature-map pixel coords x, y [B*V, N]
    float32 (the main-view re-anchoring composition, model_multi.py:
    174-188; `_project_voxel_coords` in the JAX kernels)."""
    b, v = Rcam.shape[:2]
    rsz_h = fh / float(image_shape[0])
    rsz_w = fw / float(image_shape[1])
    KR = torch.einsum("bij,bvjk->bvik", Kmat, pose_inverse(Rcam))
    M = torch.einsum("bvij,bjk->bvik", KR, _to_hom4(Rcam[:, 0]))
    uvw = torch.einsum("bvij,jn->bvin", M, grid_pts)
    z = uvw[:, :, 2]
    x = (uvw[:, :, 0] / z * rsz_w).reshape(b * v, -1)
    y = (uvw[:, :, 1] / z * rsz_h).reshape(b * v, -1)
    return x, y


def reprojection_coords(Kmat, image_shape, proj_size, samples, config,
                        nx, ny, nz):
    """Fractional grid coords (x, y) [B, S_d, S*S] float32 of every depth
    sample of every pixel ray, and the per-sample z index [S_d] int32
    (host numpy, -1 = out of grid). `_coords` of the JAX reprojection
    kernel (model_multi.py:252-298)."""
    s = proj_size
    npix = s * s
    rsz = float(proj_size) / float(image_shape[0])
    r = np.arange(0.5, s, 1.0, dtype=np.float32)
    xs, ys = np.meshgrid(r, r)
    pix = torch.from_numpy(np.stack(
        [xs.ravel(), ys.ravel(), np.full(npix, rsz, np.float32)],
        axis=0)).to(Kmat.device)
    rays = torch.einsum("bij,jn->bin", torch.linalg.inv(Kmat * rsz), pix)

    z_samples = np.linspace(config.vmin_z + config.vsize_z / 2.0,
                            config.vmax_z - config.vsize_z / 2.0,
                            samples).astype(np.float32)
    vminv = np.array([config.vmin, config.vmin,
                      config.vmin_z + config.vsize_z / 2.0], np.float32)
    vmaxv = np.array([config.vmax, config.vmax, config.vmax_z], np.float32)
    nvoxv = np.array([nx, ny, nz], np.float32)
    span = vmaxv - vminv

    zt = torch.from_numpy(z_samples).to(Kmat.device)[None, :, None]
    xg = (rays[:, 0, None, :] * zt - float(vminv[0])) / float(span[0]) \
        * float(nvoxv[0])
    yg = (rays[:, 1, None, :] * zt - float(vminv[1])) / float(span[1]) \
        * float(nvoxv[1])

    zg = (z_samples - vminv[2]) / span[2] * nvoxv[2]
    iz = np.rint(zg).astype(np.int32)
    iz = np.where((iz >= 0) & (iz < nz), iz, -1).astype(np.int32)
    return xg, yg, iz


# ---------------------------------------------------------------------------
# Plain unprojection gather (oracle of kernels/unproject.py)
# ---------------------------------------------------------------------------

def bilinear_gather_fused(feats, x, y, fh, fw, v, relu=True):
    """feats [B*V, fh*fw, C]; x, y [B*V, N] float32 feature-plane coords.
    Returns [B, N, V*C] in feats' dtype: per view the 4-tap bilinear
    sample with each out-of-bounds tap zeroed, views concatenated on
    channels (view-major), optionally relu'd. Accumulates in float32."""
    bv, p, c = feats.shape
    n = x.shape[1]
    f = feats.float()
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    lx = x - x0f
    ly = y - y0f

    def tap(dy, dx, wgt):
        yi = y0f + dy
        xi = x0f + dx
        valid = (yi >= 0) & (yi < fh) & (xi >= 0) & (xi < fw)
        idx = (torch.where(valid, yi, 0.0).long() * fw
               + torch.where(valid, xi, 0.0).long())
        vals = torch.gather(f, 1, idx[..., None].expand(bv, n, c))
        return vals * (wgt * valid)[..., None]

    out = (tap(0, 0, (1 - ly) * (1 - lx))
           + tap(0, 1, (1 - ly) * lx)
           + tap(1, 0, ly * (1 - lx))
           + tap(1, 1, ly * lx))
    if relu:
        out = torch.relu(out)
    out = out.to(feats.dtype)
    return out.reshape(bv // v, v, n, c).transpose(1, 2).reshape(
        bv // v, n, v * c)


# ---------------------------------------------------------------------------
# Plain reprojection gather (oracle of kernels/reproject.py)
# ---------------------------------------------------------------------------

def zslice_gather(grid, xg, yg, iz):
    """grid [B, nx, ny, nz, C]; xg, yg [B, S_d, npix] float32; iz [S_d]
    int (-1 = invalid). Returns [B, S_d, npix, C]: for each sample the
    voxel of slice iz[s] nearest to (x, y), rounded half-to-even; 0 where
    the voxel is out of the grid. A copy, exact in any dtype."""
    b, nx, ny, nz, c = grid.shape
    s_d, npix = xg.shape[1], xg.shape[2]
    izt = torch.as_tensor(np.asarray(iz, np.int64),
                          device=grid.device)[None, :, None]
    ix = torch.round(xg)
    iy = torch.round(yg)
    valid = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (izt >= 0)
    idx = ((torch.where(valid, ix, 0.0).long() * ny
            + torch.where(valid, iy, 0.0).long()) * nz
           + torch.where(valid, izt, 0))
    vals = torch.gather(grid.reshape(b, nx * ny * nz, c), 1,
                        idx.reshape(b, s_d * npix, 1).expand(-1, -1, c))
    vals = vals.reshape(b, s_d, npix, c)
    return torch.where(valid[..., None], vals, vals.new_zeros(()))

