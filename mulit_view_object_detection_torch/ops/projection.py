"""Projective multi-view geometry in torch, the transformer's
depth-conditioned ray lift, and the plain versions of the gathers that
`kernels/` runs as CUDA kernels.

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

The plain gathers and their plain backward scatters (explicit
`index_add_` of what each output element read) serve CPU tensors and are
the oracles the CUDA kernels are held against on the card.
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=64)
def _ray_constants(device, image_h, proj_size, samples, vmin, vmax, vmin_z,
                   vsize_z, vmax_z, nx, ny, nz):
    """What `reprojection_coords` computes from shapes and the grid
    config alone, once per (device, shapes, config): the pixel vectors
    [3, S*S] and the sample depths [1, S_d, 1] on `device` (each copy from
    host memory synchronises the host with the card), the offsets and
    scales of x and y, and the z index [S_d] (numpy)."""
    s = proj_size
    npix = s * s
    rsz = float(proj_size) / float(image_h)
    r = np.arange(0.5, s, 1.0, dtype=np.float32)
    xs, ys = np.meshgrid(r, r)
    pix = torch.from_numpy(np.stack(
        [xs.ravel(), ys.ravel(), np.full(npix, rsz, np.float32)],
        axis=0)).to(device)

    z_samples = np.linspace(vmin_z + vsize_z / 2.0, vmax_z - vsize_z / 2.0,
                            samples).astype(np.float32)
    vminv = np.array([vmin, vmin, vmin_z + vsize_z / 2.0], np.float32)
    vmaxv = np.array([vmax, vmax, vmax_z], np.float32)
    nvoxv = np.array([nx, ny, nz], np.float32)
    span = vmaxv - vminv
    zt = torch.from_numpy(z_samples).to(device)[None, :, None]

    zg = (z_samples - vminv[2]) / span[2] * nvoxv[2]
    iz = np.rint(zg).astype(np.int32)
    iz = np.where((iz >= 0) & (iz < nz), iz, -1).astype(np.int32)
    scale = tuple((float(vminv[k]), float(span[k]), float(nvoxv[k]))
                  for k in range(2))
    return rsz, pix, zt, scale, iz


def reprojection_coords(Kmat, image_shape, proj_size, samples, config,
                        nx, ny, nz):
    """Fractional grid coords (x, y) [B, S_d, S*S] float32 of every depth
    sample of every pixel ray, and the per-sample z index [S_d] int32
    (host numpy, -1 = out of grid). `_coords` of the JAX
    reprojection kernel (model_multi.py:252-298). On the card it makes no
    host synchronisation: the constants are cached (`_ray_constants`)
    and the inverse is `inv_ex`'s, which checks nothing on the host."""
    rsz, pix, zt, ((x0, xspan, xn), (y0, yspan, yn)), iz = _ray_constants(
        Kmat.device, image_shape[0], proj_size, samples, config.vmin,
        config.vmax, config.vmin_z, config.vsize_z, config.vmax_z, nx, ny,
        nz)
    rays = torch.einsum("bij,jn->bin",
                        torch.linalg.inv_ex(Kmat * rsz).inverse, pix)
    xg = (rays[:, 0, None, :] * zt - x0) / xspan * xn
    yg = (rays[:, 1, None, :] * zt - y0) / yspan * yn
    return xg, yg, iz.copy()


# ---------------------------------------------------------------------------
# Plain unprojection gathers and their backward (oracles of
# kernels/unproject.py)
# ---------------------------------------------------------------------------

def _bilinear_taps(x, y, fh, fw):
    """The four taps of every coordinate, in the kernels' order: a list of
    (flat index [BV, N] int64, weight [BV, N] float32, valid [BV, N]
    bool), the index 0 where the tap is out of bounds and the weight not
    masked. Taps are tested one by one, the floor is a floor (x in
    (-1, 0) keeps tap x0 + 1), and at fw == 1 the x0+1 and y0+1 taps stay
    separate."""
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    lx = x - x0f
    ly = y - y0f
    taps = []
    for dy, dx, wgt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                        (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
        yi = y0f + dy
        xi = x0f + dx
        valid = (yi >= 0) & (yi < fh) & (xi >= 0) & (xi < fw)
        idx = (torch.where(valid, yi, 0.0).long() * fw
               + torch.where(valid, xi, 0.0).long())
        taps.append((idx, wgt, valid))
    return taps


def _gather_taps(feats, x, y, fh, fw):
    """feats [BV, fh*fw, C]; x, y [BV, N]. The float32 sum
    t00 + t01 + t10 + t11 [BV, N, C], each tap value * (weight * valid)."""
    bv, _, c = feats.shape
    n = x.shape[1]
    f = feats.float()
    out = 0.0
    for idx, w, valid in _bilinear_taps(x, y, fh, fw):
        vals = torch.gather(f, 1, idx[..., None].expand(bv, n, c))
        out = out + vals * (w * valid)[..., None]
    return out


def _scatter_taps(g, x, y, fh, fw):
    """Transpose of `_gather_taps`: g [BV, N, C] float32 times each valid
    tap's weight added into the tap it was read from; an invalid tap
    (NaN coordinates included) adds nothing. Returns [BV, fh*fw, C]
    float32."""
    bv, n, c = g.shape
    p = fh * fw
    base = torch.arange(bv, device=g.device)[:, None] * p
    df = torch.zeros(bv * p, c, dtype=torch.float32, device=g.device)
    for idx, w, valid in _bilinear_taps(x, y, fh, fw):
        df.index_add_(0, (base + idx).reshape(-1),
                      torch.where(valid[..., None], g * w[..., None], 0.0)
                      .reshape(-1, c))
    return df.reshape(bv, p, c)


def scatter_taps_blocked(g, x, y, fh, fw, cs, chunk, lanes=1, v=1,
                         saved=None):
    """`_scatter_taps` in the decomposition of the backward kernel's walk
    (csrc/unproject.cu, kernels/unproject.py::bwd_plan): each (view row,
    slice of `cs` channels, chunk of `chunk` voxels) is split among
    `lanes` lanes, each of which walks ceil(chunk / lanes) consecutive
    voxels; every lane sums its own float32 partial of dfeats, and the
    partials are added into the result. g is [B, N, V*C] with `v` views
    (the per-view layout [B*V, N, C] is v = 1); with `saved` (the fused
    forward's output, shaped as g) g passes only where saved > 0, the
    ReLU's mask. Used by the tests, to hold the kernel's blocking to the
    plain scatter."""
    b, n, vc = g.shape
    c = vc // v
    if saved is not None:
        g = torch.where(saved > 0, g, 0.0)
    g = g.reshape(b, n, v, c).transpose(1, 2).reshape(b * v, n, c)
    df = torch.zeros(b * v, fh * fw, c, dtype=torch.float32,
                     device=g.device)
    for c0 in range(0, c, cs):
        for n0 in range(0, n, chunk):
            n1 = min(n, n0 + chunk)
            span = -(-(n1 - n0) // lanes)
            for l0 in range(n0, n1, span):
                l1 = min(n1, l0 + span)
                df[:, :, c0:c0 + cs] += _scatter_taps(
                    g[:, l0:l1, c0:c0 + cs], x[:, l0:l1], y[:, l0:l1], fh,
                    fw)
    return df


def bilinear_gather(feats, x, y, fh, fw):
    """feats [B*V, fh*fw, C]; x, y [B*V, N] float32 feature-plane coords.
    Returns [B*V, N, C] in feats' dtype: per view the 4-tap bilinear
    sample with each out-of-bounds tap zeroed, accumulated in float32 and
    rounded once (the Pallas kernel's rule, unproject_pallas.py:98-103)."""
    return _gather_taps(feats, x, y, fh, fw).to(feats.dtype)


def bilinear_gather_bwd(g, x, y, fh, fw, dtype):
    """Gradient of `bilinear_gather` with respect to feats: each element
    of g [B*V, N, C] times each tap weight added into the tap it was read
    from, in float32. Returns dfeats [B*V, fh*fw, C] in `dtype`."""
    return _scatter_taps(g.float(), x, y, fh, fw).to(dtype)


def bilinear_gather_fused(feats, x, y, fh, fw, v, relu=True):
    """`bilinear_gather` with the views concatenated on channels: returns
    [B, N, V*C] (view-major) in feats' dtype, optionally relu'd before the
    rounding."""
    bv, _, c = feats.shape
    n = x.shape[1]
    out = _gather_taps(feats, x, y, fh, fw)
    if relu:
        out = torch.relu(out)
    out = out.to(feats.dtype)
    return out.reshape(bv // v, v, n, c).transpose(1, 2).reshape(
        bv // v, n, v * c)


def bilinear_gather_fused_bwd(g, saved, x, y, fh, fw, v, relu, dtype):
    """Gradient of `bilinear_gather_fused` with respect to feats.

    g, saved (the forward's output; read when relu) [B, N, V*C]; x, y
    [B*V, N]. Where the output is > 0 (with relu), each element's g times
    each tap weight is added into the tap it was read from, in float32.
    Returns dfeats [B*V, fh*fw, C] in `dtype`."""
    b, n, vc = g.shape
    c = vc // v
    gf = g.float()
    if relu:
        gf = torch.where(saved > 0, gf, 0.0)
    gbv = gf.reshape(b, n, v, c).transpose(1, 2).reshape(b * v, n, c)
    return _scatter_taps(gbv, x, y, fh, fw).to(dtype)


# ---------------------------------------------------------------------------
# Plain reprojection gather and its backward (oracles of
# kernels/reproject.py)
# ---------------------------------------------------------------------------

def _nearest_voxels(xg, yg, iz, nx, ny, nz):
    """Flat voxel index [B, S_d, npix] (x-major, z fastest) of every
    sample's nearest voxel in slice iz[s], rounded half-to-even, and
    whether it lies in the grid (iz[s] >= 0 and x, y in bounds); index 0
    where it does not."""
    izt = torch.as_tensor(np.asarray(iz, np.int64),
                          device=xg.device)[None, :, None]
    ix = torch.round(xg)
    iy = torch.round(yg)
    valid = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (izt >= 0)
    idx = ((torch.where(valid, ix, 0.0).long() * ny
            + torch.where(valid, iy, 0.0).long()) * nz
           + torch.where(valid, izt, 0))
    return idx, valid


def zslice_gather(grid, xg, yg, iz):
    """grid [B, nx, ny, nz, C]; xg, yg [B, S_d, npix] float32; iz [S_d]
    int (-1 = invalid). Returns [B, S_d, npix, C]: for each sample the
    voxel of slice iz[s] nearest to (x, y), rounded half-to-even; 0 where
    the voxel is out of the grid. A copy, exact in any dtype."""
    b, nx, ny, nz, c = grid.shape
    s_d, npix = xg.shape[1], xg.shape[2]
    idx, valid = _nearest_voxels(xg, yg, iz, nx, ny, nz)
    vals = torch.gather(grid.reshape(b, nx * ny * nz, c), 1,
                        idx.reshape(b, s_d * npix, 1).expand(-1, -1, c))
    vals = vals.reshape(b, s_d, npix, c)
    return torch.where(valid[..., None], vals, vals.new_zeros(()))


def zslice_gather_bwd(g, xg, yg, iz, grid_shape, dtype):
    """Gradient of `zslice_gather` with respect to the grid: each valid
    sample's g [B, S_d, npix, C] added into the voxel it was read from,
    in float32. Voxels no sample read, whole z-slices included, are 0.
    Returns [B, nx, ny, nz, C] in `dtype`."""
    b, nx, ny, nz, c = grid_shape
    idx, valid = _nearest_voxels(xg, yg, iz, nx, ny, nz)
    flat = idx + torch.arange(b, device=g.device)[:, None, None] * (
        nx * ny * nz)
    contrib = torch.where(valid[..., None], g.float(), 0.0)
    dg = torch.zeros(b * nx * ny * nz, c, dtype=torch.float32,
                     device=g.device)
    dg.index_add_(0, flat.reshape(-1), contrib.reshape(-1, c))
    return dg.reshape(b, nx, ny, nz, c).to(dtype)


def reproject_buckets(keys, nvb, warps):
    """The backward kernel's inverse map of one chunk (csrc/reproject.cu,
    step 2): keys [m] int (a voxel of the band, or -1) cut into `warps`
    contiguous runs; the counts per (voxel, run), their exclusive scan in
    (voxel, run) order, and each run's entries placed in order of their
    rank among the run's equal keys. Returns (start [nvb], size [nvb],
    entries): bucket v is entries[start[v]:start[v] + size[v]]."""
    keys = np.asarray(keys)
    m = len(keys)
    per = -(-m // warps)
    counts = np.zeros((nvb, warps), np.int64)
    for j, k in enumerate(keys):
        if k >= 0:
            counts[k, j // per] += 1
    off = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1)).reshape(
        nvb, warps)
    entries = np.full(int(counts.sum()), -1, np.int64)
    for j, k in enumerate(keys):
        if k >= 0:
            entries[off[k, j // per]] = j
            off[k, j // per] += 1
    size = counts.sum(1)
    return np.cumsum(size) - size, size, entries


def zslice_gather_bwd_blocked(g, xg, yg, iz, grid_shape, dtype, band, chunk,
                              warps=8):
    """`zslice_gather_bwd` in the decomposition of the backward kernel
    (csrc/reproject.cu, kernels/reproject.py::bwd_plan): per batch
    element, z-slice and band of `band` consecutive voxels (ix, iy) of the
    slice, the samples with iz[s] == z in ascending s and their pixels in
    chunks of `chunk`; each chunk's map from `reproject_buckets`, and each
    voxel's float32 sum added in its bucket's order, position by position,
    starting from 0 (slices no sample reads stay 0). Returns
    [B, nx, ny, nz, C] in `dtype`. Used by the tests, to hold the
    kernel's order to the plain scatter's."""
    b, nx, ny, nz, c = grid_shape
    s_d, npix = xg.shape[1], xg.shape[2]
    iz = np.asarray(iz)
    ix = torch.round(xg)
    iy = torch.round(yg)
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    flat = torch.where(inside, torch.where(inside, ix, 0.0).long() * ny
                       + torch.where(inside, iy, 0.0).long(), -1).numpy()
    gf = g.float()
    dg = torch.zeros(b, nx * ny, nz, c, dtype=torch.float32)
    for bi in range(b):
        for z in range(nz):
            for v0 in range(0, nx * ny, band):
                nvb = min(band, nx * ny - v0)
                acc = torch.zeros(nvb, c, dtype=torch.float32)
                for s in np.flatnonzero(iz == z):
                    for p0 in range(0, npix, chunk):
                        keys = flat[bi, s, p0:p0 + chunk] - v0
                        keys = np.where((keys >= 0) & (keys < nvb), keys, -1)
                        start, size, entries = reproject_buckets(keys, nvb,
                                                                 warps)
                        for r in range(int(size.max(initial=0))):
                            has = np.flatnonzero(size > r)
                            rows = gf[bi, s, p0 + entries[start[has] + r]]
                            acc[has] = acc[has] + rows
                dg[bi, v0:v0 + nvb, z] = acc
    return dg.reshape(b, nx, ny, nz, c).to(dtype)


# ---------------------------------------------------------------------------
# Depth-conditioned ray lift (transformer fusion)
# ---------------------------------------------------------------------------

def unproject_rays(feats, Rcam, Kmat, depth, image_shape, samples=1,
                   faithful_pairing=False):
    """Backproject each feature-map pixel along its ray to its measured
    depth (`ops/projection.py::unproject_rays` of the JAX package,
    model_transformer.py:372-424).

    feats [B, V, fh, fw, C]; Rcam [B, V, 3, 4] cam->world; Kmat [B, 3, 3];
    depth [B, V, fh, fw]. Returns (positions [B, V*fh*fw, 3] world xyz,
    tokens [B, V*fh*fw, C]), token order (v, y, x), each token paired
    with its own ray. `faithful_pairing` reproduces the reference's two
    deviations for its parity goldens: rays solved against feature-scale
    pixel vectors [x, y, 1], and depth and features flattened transposed
    (x-major) against a row-major ray grid."""
    b, v, fh, fw, c = feats.shape
    if samples != 1:
        raise ValueError(
            f"unproject_rays: samples must be 1 (got {samples}); the "
            f"depth-conditioned lift has one measured depth per ray")
    npix = fh * fw
    rsz = fh / float(image_shape[0])
    xs, ys = np.meshgrid(np.arange(0.5, fw, 1.0, dtype=np.float32),
                         np.arange(0.5, fh, 1.0, dtype=np.float32))
    z = 1.0 if faithful_pairing else rsz
    pix = torch.from_numpy(np.stack(
        [xs.ravel(), ys.ravel(), np.full(npix, z, np.float32)],
        axis=0)).to(Kmat.device)
    rays = torch.einsum("bij,jn->bin", torch.linalg.inv(Kmat * rsz), pix)
    if faithful_pairing:
        if fh != fw:
            raise ValueError("faithful pairing needs a square feature map")
        depth = depth.transpose(2, 3)
        feats = feats.transpose(2, 3)
    xc = rays[:, None] * depth.reshape(b, v, 1, npix)      # [B, V, 3, npix]
    xc_h = torch.cat([xc, xc.new_ones(b, v, 1, npix)], dim=2)
    xw = torch.einsum("bvij,bvjn->bvin", Rcam, xc_h)       # [B, V, 3, npix]
    positions = xw.transpose(2, 3).reshape(b, -1, 3)
    return positions, feats.reshape(b, -1, c)
