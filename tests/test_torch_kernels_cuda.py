"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`: these need an NVIDIA GPU, nvcc and the sm_90a target, and
skip where torch.cuda.is_available() is false. The file imports neither
jax nor the repo's conftest, so on a GPU host it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: the unprojection kernels (fused and per-view layouts, every
variant of the forward) use explicitly rounded float32
operations in the plain version's order, so float32 agrees bit for bit;
in bfloat16 both round the same float32 sum once, also exact. The
reprojection copies values: exact. The backward kernels sum with float32
atomics in no fixed order (so does the plain `index_add_` on the card):
float32 within 1e-5 of the largest magnitude; bfloat16 casts the float32
sum once, so where the two sums straddle a rounding boundary they differ
by one bf16 step (at most 2^-7 of the value), plus that.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mulit_view_object_detection_torch.kernels import (  # noqa: E402
    reproject, unproject)
from mulit_view_object_detection_torch.ops import projection as P  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fh,fw", [(8, 1), (1, 1), (8, 2), (40, 40)])
def test_unproject_kernel_matches_plain(dev, dtype, fh, fw):
    g = torch.Generator().manual_seed(fh * 100 + fw)
    bv, v, c, n = 4, 2, 64, 3000
    feats = torch.randn(bv, fh * fw, c, generator=g).to(dtype)
    x = torch.rand(bv, n, generator=g) * (fw + 2.0) - 1.5
    y = torch.rand(bv, n, generator=g) * (fh + 2.0) - 1.5
    x[:, :64] = -torch.rand(64, generator=g) * 0.98 - 0.01   # (-1, 0)
    y[:, 64:128] = -torch.rand(64, generator=g) * 0.98 - 0.01
    x[:, 128:192] = 0.25
    for relu in (False, True):
        ref = P.bilinear_gather_fused(feats.to(dev), x.to(dev), y.to(dev),
                                      fh, fw, v, relu)
        before = unproject.launches
        got = unproject.bilinear_gather_fused(feats.to(dev), x.to(dev),
                                              y.to(dev), fh, fw, v, relu)
        torch.cuda.synchronize()
        assert unproject.launches == before + 1
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("iz", [(0, 2, -1), (-1, 1, 1, 3), (3, 3, 0)])
def test_reproject_kernel_matches_plain(dev, dtype, iz):
    g = torch.Generator().manual_seed(len(iz))
    b, nx, ny, nz, c = 2, 5, 4, 4, 64
    s_d, npix = len(iz), 400
    grid = torch.randn(b, nx, ny, nz, c, generator=g).to(dtype)
    xg = torch.rand(b, s_d, npix, generator=g) * (nx + 1.5) - 1.0
    yg = torch.rand(b, s_d, npix, generator=g) * (ny + 1.5) - 1.0
    ties = torch.tensor([-0.5, 0.5, 1.5, 2.5, 3.5, 4.5]).repeat(4)
    xg[:, :, :24] = ties
    yg[:, :, 24:48] = ties
    args = (grid.to(dev), xg.to(dev), yg.to(dev), np.asarray(iz))
    ref = P.zslice_gather(*args)
    before = reproject.launches
    got = reproject.zslice_gather(*args)
    torch.cuda.synchronize()
    assert reproject.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fh,fw", [(8, 1), (1, 1), (8, 2), (40, 40)])
def test_unproject_bwd_kernel_matches_plain(dev, dtype, fh, fw):
    """Gradient through the autograd Function (the kernel) against the
    plain index_add_ scatter, with and without the ReLU mask; x in
    (-1, 0), y in (-1, 0) and fw == 1 included."""
    g = torch.Generator().manual_seed(fh * 100 + fw + 7)
    bv, v, c, n = 4, 2, 64, 3000
    feats = torch.randn(bv, fh * fw, c, generator=g).to(dtype).to(dev)
    x = torch.rand(bv, n, generator=g) * (fw + 2.0) - 1.5
    y = torch.rand(bv, n, generator=g) * (fh + 2.0) - 1.5
    x[:, :64] = -torch.rand(64, generator=g) * 0.98 - 0.01
    y[:, 64:128] = -torch.rand(64, generator=g) * 0.98 - 0.01
    x, y = x.to(dev), y.to(dev)
    gout = torch.randn(bv // v, n, v * c, generator=g).to(dtype).to(dev)
    for relu in (False, True):
        leaf = feats.clone().requires_grad_()
        out = unproject.bilinear_gather_fused(leaf, x, y, fh, fw, v, relu)
        before = unproject.bwd_launches
        out.backward(gout)
        torch.cuda.synchronize()
        assert unproject.bwd_launches == before + 1
        ref = P.bilinear_gather_fused_bwd(gout, out.detach(), x, y, fh, fw,
                                          v, relu, dtype)
        got = leaf.grad
        assert got.dtype == dtype and got.shape == ref.shape
        err = (got.float() - ref.float()).abs()
        tol = 1e-5 * float(ref.float().abs().max())
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * ref.float().abs()
        assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("iz", [(0, 2, -1), (-1, 1, 1, 3), (3, 3, 0),
                                (2, 3, -1)])
def test_reproject_bwd_kernel_matches_plain(dev, dtype, iz):
    """Gradient through the autograd Function (the kernel) against the
    plain index_add_ scatter: .5 ties round half to even, slices no
    sample reads are zero, and a trailing iz = -1 leaves slice 0 alone."""
    g = torch.Generator().manual_seed(len(iz) + 11)
    b, nx, ny, nz, c = 2, 5, 4, 4, 64
    s_d, npix = len(iz), 400
    grid = torch.randn(b, nx, ny, nz, c, generator=g).to(dtype).to(dev)
    xg = torch.rand(b, s_d, npix, generator=g) * (nx + 1.5) - 1.0
    yg = torch.rand(b, s_d, npix, generator=g) * (ny + 1.5) - 1.0
    ties = torch.tensor([-0.5, 0.5, 1.5, 2.5, 3.5, 4.5]).repeat(4)
    xg[:, :, :24] = ties
    yg[:, :, 24:48] = ties
    xg, yg = xg.to(dev), yg.to(dev)
    gout = torch.randn(b, s_d, npix, c, generator=g).to(dtype).to(dev)
    leaf = grid.clone().requires_grad_()
    out = reproject.zslice_gather(leaf, xg, yg, np.asarray(iz))
    before = reproject.bwd_launches
    out.backward(gout)
    torch.cuda.synchronize()
    assert reproject.bwd_launches == before + 1
    ref = P.zslice_gather_bwd(gout, xg, yg, np.asarray(iz), tuple(grid.shape),
                              dtype)
    got = leaf.grad
    assert got.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    tol = 1e-5 * float(ref.float().abs().max())
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.float().abs()
    assert bool((err <= tol).all()), float(err.max())
    for z in range(nz):
        if z not in iz:
            assert not bool(got[..., z, :].any()), z


def _edge_coords(g, bv, n, fh, fw):
    """Every border, x and y in (-1, 0), an in-bounds x0 == 0 column, and
    exact .5 ties."""
    x = torch.rand(bv, n, generator=g) * (fw + 2.0) - 1.5
    y = torch.rand(bv, n, generator=g) * (fh + 2.0) - 1.5
    x[:, :64] = -torch.rand(64, generator=g) * 0.98 - 0.01
    y[:, 64:128] = -torch.rand(64, generator=g) * 0.98 - 0.01
    x[:, 128:192] = 0.25
    x[:, 192:256] = torch.arange(64) % (fw + 2) - 0.5
    return x, y


# The per-view layout of csrc/unproject.cu's kernels: (fh, fw, C, N, bv,
# element offset of feats and g from their allocations, forward variant
# and backward variant by dtype (float32, bfloat16)). C = 6 and 12 reach
# the scalar forward where C is not a whole number of 16-byte groups, C = 6
# the direct backward (C not a multiple of 4), the offset tensors both by
# alignment, the
# 10 x 10 map with 64,000 voxels the heavy contention of P6, the 256^2
# map a map of 65,536 pixels.
VIEW_CASES = {
    "8x1": (8, 1, 64, 3000, 8, 0, ("vector",) * 2, ("walk",) * 2),
    "1x1": (1, 1, 64, 3000, 8, 0, ("vector",) * 2, ("walk",) * 2),
    "8x2": (8, 2, 64, 3000, 8, 0, ("vector",) * 2, ("walk",) * 2),
    "40x40": (40, 40, 64, 3000, 8, 0, ("vector",) * 2, ("walk",) * 2),
    "c6": (8, 8, 6, 3000, 4, 0, ("scalar",) * 2, ("direct",) * 2),
    "c12": (8, 8, 12, 3000, 4, 0, ("vector", "scalar"), ("walk",) * 2),
    "offset": (40, 40, 64, 3000, 4, 1, ("scalar",) * 2, ("direct",) * 2),
    "p6_contention": (10, 10, 64, 64000, 4, 0, ("vector",) * 2,
                      ("walk",) * 2),
    "256x256": (256, 256, 64, 3000, 4, 0, ("vector",) * 2, ("walk",) * 2),
}


def _offset(t, offset, dev):
    """t on dev, `offset` elements past the start of its allocation."""
    base = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
    out = base[offset:].view(t.shape)
    out.copy_(t)
    return out


def _view_case(name, dtype, dev, seed):
    fh, fw, c, n, bv, offset = VIEW_CASES[name][:6]
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(bv, fh * fw, c, generator=g).to(dtype)
    x, y = (t.to(dev) for t in _edge_coords(g, bv, n, fh, fw))
    gout = torch.randn(bv, n, c, generator=g).to(dtype)
    return _offset(feats, offset, dev), x, y, _offset(gout, offset, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(VIEW_CASES))
def test_unproject_view_kernel_matches_plain(dev, dtype, case):
    """The per-view layout [B*V, N, C] (`gather`) against the plain
    bilinear_gather, in the variant the shape and alignment select: equal
    bit for bit."""
    fh, fw, c, n, bv = VIEW_CASES[case][:5]
    variant = VIEW_CASES[case][6][dtype == torch.bfloat16]
    feats, x, y, _ = _view_case(case, dtype, dev, fh * 100 + fw + c + 3)
    ref = P.bilinear_gather(feats, x, y, fh, fw)
    before, fused = unproject.view_launches, unproject.launches
    used = unproject.view_variants["fwd_" + variant]
    got = unproject.bilinear_gather(feats, x, y, fh, fw)
    torch.cuda.synchronize()
    assert unproject.view_launches == before + 1
    assert unproject.view_variants["fwd_" + variant] == used + 1
    assert unproject.launches == fused
    assert got.dtype == dtype and got.shape == (bv, n, c)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(VIEW_CASES))
def test_unproject_view_bwd_kernel_matches_plain(dev, dtype, case):
    """Gradient of the per-view gather (`gather_bwd`) against the
    plain index_add_ scatter: through its autograd Function, and called
    on g itself, in the variant g's width and alignment select."""
    fh, fw, c, n, bv = VIEW_CASES[case][:5]
    variant = VIEW_CASES[case][7][dtype == torch.bfloat16]
    feats, x, y, gout = _view_case(case, dtype, dev, fh * 100 + fw + c + 5)
    leaf = feats.clone().requires_grad_()
    out = unproject.bilinear_gather(leaf, x, y, fh, fw)
    before = unproject.view_bwd_launches
    out.backward(gout)
    used = unproject.view_variants["bwd_" + variant]
    direct = unproject.gather_bwd(gout, x, y, fh, fw)
    torch.cuda.synchronize()
    assert unproject.view_bwd_launches == before + 2
    assert unproject.view_variants["bwd_" + variant] == used + 1
    ref = P.bilinear_gather_bwd(gout, x, y, fh, fw, dtype)
    tol = 1e-5 * float(ref.float().abs().max())
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.float().abs()
    for got in (leaf.grad, direct):
        assert got.dtype == dtype and got.shape == ref.shape
        err = (got.float() - ref.float()).abs()
        assert bool((err <= tol).all()), float(err.max())


def test_unproject_view_bwd_ignores_invalid_taps(dev):
    """NaN and infinite coordinates, and out-of-bounds voxels whose g is
    not finite, add nothing (both variants): the gradient equals that of
    the same call without those voxels."""
    g = torch.Generator().manual_seed(17)
    for c, variant in ((8, "walk"), (6, "direct")):
        bv, fh, n = 2, 10, 600
        x, y = _edge_coords(g, bv, n, fh, fh)
        gout = torch.randn(bv, n, c, generator=g)
        x[:, 300], y[:, 301] = float("nan"), float("nan")
        x[:, 302], y[:, 303] = float("inf"), -float("inf")
        x[:, 304:306], gout[:, 304:306] = -5.0, float("inf")
        keep = [j for j in range(n) if j not in range(300, 306)]
        args = [t.to(dev) for t in (gout, x, y)]
        cut = [t[:, keep].contiguous() for t in args]
        used = unproject.view_variants["bwd_" + variant]
        got = unproject.gather_bwd(*args, fh, fh)
        torch.cuda.synchronize()
        assert unproject.view_variants["bwd_" + variant] == used + 1
        want = P.bilinear_gather_bwd(*cut, fh, fh, torch.float32)
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


# The fused layout [B, N, V*C] of csrc/unproject.cu's kernels: (fh, fw,
# C, N, B, V, element offset of feats and g from their allocations,
# forward variant and backward variant by dtype (float32, bfloat16)).
# V = 1 to 8; C = 6 reaches the scalar forward and the direct backward,
# C = 12 the scalar forward in bfloat16 only, the offset tensors both by
# alignment; the 10 x 10 maps with 64,000 voxels the contention of P6.
FUSED_CASES = {
    "v1": (40, 40, 64, 3000, 4, 1, 0, ("vector",) * 2, ("walk",) * 2),
    "v2": (40, 40, 64, 3000, 2, 2, 0, ("vector",) * 2, ("walk",) * 2),
    "v3_8x1": (8, 1, 64, 3000, 2, 3, 0, ("vector",) * 2, ("walk",) * 2),
    "v4": (20, 20, 64, 3000, 1, 4, 0, ("vector",) * 2, ("walk",) * 2),
    "v8": (10, 10, 64, 3000, 1, 8, 0, ("vector",) * 2, ("walk",) * 2),
    "v2_c6": (8, 8, 6, 3000, 2, 2, 0, ("scalar",) * 2, ("direct",) * 2),
    "v3_c12": (8, 8, 12, 3000, 1, 3, 0, ("vector", "scalar"),
               ("walk",) * 2),
    "v2_offset": (40, 40, 64, 3000, 1, 2, 1, ("scalar",) * 2,
                  ("direct",) * 2),
    "v4_offset": (20, 20, 64, 3000, 1, 4, 1, ("scalar",) * 2,
                  ("direct",) * 2),
    "v2_p6_contention": (10, 10, 64, 64000, 1, 2, 0, ("vector",) * 2,
                         ("walk",) * 2),
    "v4_p6_contention": (10, 10, 64, 64000, 1, 4, 0, ("vector",) * 2,
                         ("walk",) * 2),
}


def _fused_case(name, dtype, dev, seed):
    fh, fw, c, n, b, v, offset = FUSED_CASES[name][:7]
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(b * v, fh * fw, c, generator=g).to(dtype)
    x, y = (t.to(dev) for t in _edge_coords(g, b * v, n, fh, fw))
    gout = torch.randn(b, n, v * c, generator=g).to(dtype)
    return _offset(feats, offset, dev), x, y, _offset(gout, offset, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_unproject_fused_kernel_matches_plain(dev, dtype, case):
    """The fused layout (mvod_unproject_fused) against the plain
    bilinear_gather_fused, with and without the ReLU, in the variant the
    shape and alignment select: equal bit for bit."""
    fh, fw, c, n, b, v = FUSED_CASES[case][:6]
    variant = FUSED_CASES[case][7][dtype == torch.bfloat16]
    feats, x, y, _ = _fused_case(case, dtype, dev, fh * 100 + fw + c + v)
    for relu in (False, True):
        ref = P.bilinear_gather_fused(feats, x, y, fh, fw, v, relu)
        before, view = unproject.launches, unproject.view_launches
        used = unproject.fused_variants["fwd_" + variant]
        got = unproject.bilinear_gather_fused(feats, x, y, fh, fw, v, relu)
        torch.cuda.synchronize()
        assert unproject.launches == before + 1
        assert unproject.fused_variants["fwd_" + variant] == used + 1
        assert unproject.view_launches == view
        assert got.dtype == dtype and got.shape == (b, n, v * c)
        assert torch.equal(got, ref)
        if relu:
            assert bool((got >= 0).all()) and bool((ref == 0).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_unproject_fused_bwd_kernel_matches_plain(dev, dtype, case):
    """Gradient of the fused gather (mvod_unproject_fused_bwd) against the
    plain index_add_ scatter, with and without the ReLU mask: through its
    autograd Function, and called on g itself, in the variant g's (and
    the saved output's) width and alignment select."""
    fh, fw, c, n, b, v = FUSED_CASES[case][:6]
    variant = FUSED_CASES[case][8][dtype == torch.bfloat16]
    feats, x, y, gout = _fused_case(case, dtype, dev, fh * 100 + fw + c + 9)
    for relu in (False, True):
        leaf = feats.clone().requires_grad_()
        out = unproject.bilinear_gather_fused(leaf, x, y, fh, fw, v, relu)
        saved = out.detach()
        before = unproject.bwd_launches
        used = unproject.fused_variants["bwd_" + variant]
        out.backward(gout)
        direct = unproject.gather_fused_bwd(gout, saved, x, y, fh, fw, v,
                                            relu)
        torch.cuda.synchronize()
        assert unproject.bwd_launches == before + 2
        assert unproject.fused_variants["bwd_" + variant] == used + 2
        ref = P.bilinear_gather_fused_bwd(gout, saved, x, y, fh, fw, v,
                                          relu, dtype)
        tol = 1e-5 * float(ref.float().abs().max())
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * ref.float().abs()
        for got in (leaf.grad, direct):
            assert got.dtype == dtype and got.shape == ref.shape
            err = (got.float() - ref.float()).abs()
            assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unproject_fused_bwd_checks_the_saved_alignment(dev, dtype):
    """Under the ReLU the walk reads the saved output beside g: a saved
    output one element past its allocation takes the direct scatter, the
    same output aligned the walk; both within tolerance of plain."""
    fh, fw, c, n, b, v = 20, 20, 64, 3000, 1, 2
    g = torch.Generator().manual_seed(23)
    feats = torch.randn(b * v, fh * fw, c, generator=g).to(dtype).to(dev)
    x, y = (t.to(dev) for t in _edge_coords(g, b * v, n, fh, fw))
    gout = torch.randn(b, n, v * c, generator=g).to(dtype).to(dev)
    saved = unproject.gather_fused(feats, x, y, fh, fw, v, True)
    ref = P.bilinear_gather_fused_bwd(gout, saved, x, y, fh, fw, v, True,
                                      dtype)
    for s, variant in ((_offset(saved, 1, dev), "direct"), (saved, "walk")):
        used = unproject.fused_variants["bwd_" + variant]
        got = unproject.gather_fused_bwd(gout, s, x, y, fh, fw, v, True)
        torch.cuda.synchronize()
        assert unproject.fused_variants["bwd_" + variant] == used + 1
        err = (got.float() - ref.float()).abs()
        tol = 1e-5 * float(ref.float().abs().max())
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * ref.float().abs()
        assert bool((err <= tol).all()), float(err.max())


def test_unproject_fused_bwd_ignores_invalid_taps(dev):
    """Fused layout, no ReLU: NaN and infinite coordinates, and
    out-of-bounds voxels whose g is not finite, add nothing (both
    variants): the gradient equals that of the same call without those
    voxels."""
    g = torch.Generator().manual_seed(19)
    for c, variant in ((8, "walk"), (6, "direct")):
        b, v, fh, n = 1, 3, 10, 600
        x, y = _edge_coords(g, b * v, n, fh, fh)
        gout = torch.randn(b, n, v * c, generator=g)
        x[:, 300], y[:, 301] = float("nan"), float("nan")
        x[:, 302], y[:, 303] = float("inf"), -float("inf")
        x[:, 304:306], gout[:, 304:306] = -5.0, float("inf")
        keep = [j for j in range(n) if j not in range(300, 306)]
        args = [t.to(dev) for t in (gout, x, y)]
        cut = [t[:, keep].contiguous() for t in args]
        used = unproject.fused_variants["bwd_" + variant]
        got = unproject.gather_fused_bwd(args[0], None, *args[1:], fh, fh,
                                         v, False)
        torch.cuda.synchronize()
        assert unproject.fused_variants["bwd_" + variant] == used + 1
        want = P.bilinear_gather_fused_bwd(cut[0], None, *cut[1:], fh, fh,
                                           v, False, torch.float32)
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_kernel_wrappers_reject_bad_inputs(dev):
    feats = torch.zeros(4, 16, 8, device=dev)
    xy = torch.zeros(4, 10, device=dev)
    with pytest.raises(TypeError):
        unproject.bilinear_gather_fused(feats.half(), xy, xy, 4, 4, 2)
    with pytest.raises(ValueError):
        unproject.bilinear_gather_fused(feats, xy.double(), xy, 4, 4, 2)
    with pytest.raises(ValueError):
        unproject.bilinear_gather_fused(feats[:, ::2], xy, xy, 2, 4, 2)
    g = torch.zeros(2, 10, 16, device=dev)
    with pytest.raises(ValueError):            # relu needs the saved output
        unproject.gather_fused_bwd(g, None, xy, xy, 4, 4, 2, relu=True)
    with pytest.raises(ValueError):
        unproject.gather_fused_bwd(g, g, xy[:, :5].contiguous(), xy, 4, 4,
                                   2, relu=True)
    with pytest.raises(TypeError):
        unproject.bilinear_gather(feats.half(), xy, xy, 4, 4)
    with pytest.raises(ValueError):
        unproject.bilinear_gather(feats, xy, xy, 4, 5)
    with pytest.raises(ValueError):
        unproject.gather_bwd(torch.zeros(4, 10, 8, device=dev),
                             xy[:, :5].contiguous(), xy, 4, 4)
    grid = torch.zeros(1, 2, 2, 2, 8, device=dev)
    gxy = torch.zeros(1, 2, 4, device=dev)
    with pytest.raises(ValueError):
        reproject.zslice_gather(grid, gxy, gxy, np.array([0, 2]))
    with pytest.raises(ValueError):
        reproject.gather_bwd(torch.zeros(1, 2, 4, 4, device=dev), gxy, gxy,
                             np.array([0, 1]), (1, 2, 2, 2, 8))


# ---------------------------------------------------------------------------
# the reprojection kernels' variants (csrc/reproject.cu): the flagship
# shapes (B=1, 40^3 grid, C=64, 20 samples, P4/P5/P6 = 40^2/20^2/10^2
# pixels), a chunked map (80^2 pixels a sample), C=6 and offset tensors;
# the backward against the plain version on a CPU copy, exactly
# ---------------------------------------------------------------------------

class _Flagship:
    """The flagship grid config's reprojection geometry (chip_smoke.py's
    FlagshipConfig: 40^3 voxels over [-2.5, 2.5]^2 x [1, 10] m, 20
    samples)."""
    nvox = nvox_z = 40
    vmin, vmax = -2.5, 2.5
    vmin_z, vmax_z = 1.0, 10.0
    vsize_z = (vmax_z - vmin_z) / nvox_z
    samples = 20


def _reproject_case(dev, dtype, s, c=64, offset=0, seed=0):
    """Coordinates of an s x s ray map from a 640^2 camera looking into
    the flagship grid, and a grid and a g of `dtype`, both `offset`
    elements past their allocations."""
    cfg = _Flagship()
    kmat = torch.tensor([[[576.0, 0, 320], [0, 576.0, 320], [0, 0, 1]]],
                        device=dev)
    xg, yg, iz = P.reprojection_coords(kmat, (640, 640), s, cfg.samples, cfg,
                                       40, 40, 40)
    gen = torch.Generator().manual_seed(seed)
    shape = (1, 40, 40, 40, c)
    grid = _offset(torch.randn(*shape, generator=gen).to(dtype), offset, dev)
    g = _offset(torch.randn(1, cfg.samples, s * s, c, generator=gen).to(
        dtype), offset, dev)
    return grid, xg.contiguous(), yg.contiguous(), iz, g, shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,c,offset,fwd,bwd", [
    (40, 64, 0, "fwd_vector", "bwd_vector"),
    (20, 64, 0, "fwd_vector", "bwd_vector"),
    (10, 64, 0, "fwd_vector", "bwd_vector"),
    (40, 64, 1, "fwd_scalar", "bwd_scalar"),
    (40, 6, 0, "fwd_scalar", "bwd_scalar"),
    (80, 64, 0, "fwd_vector", "bwd_vector_chunked"),
    (80, 64, 1, "fwd_scalar", "bwd_scalar_chunked"),
])
def test_reproject_variants_match_plain(dev, dtype, s, c, offset, fwd, bwd):
    """Each variant of both kernels: the forward equal to the plain
    version, the backward equal to the plain version computed on a CPU
    copy (both add each voxel's rows in ascending order from 0), and to
    itself on a second run."""
    grid, xg, yg, iz, g, shape = _reproject_case(dev, dtype, s, c, offset,
                                                 seed=s + c + offset)
    reproject.variants.clear()
    out = reproject.gather(grid, xg, yg, iz)
    assert torch.equal(out, P.zslice_gather(grid, xg, yg, iz))
    got = reproject.gather_bwd(g, xg, yg, iz, shape)
    again = reproject.gather_bwd(g, xg, yg, iz, shape)
    torch.cuda.synchronize()
    assert dict(reproject.variants) == {fwd: 1, bwd: 2}
    want = P.zslice_gather_bwd(g.cpu(), xg.cpu(), yg.cpu(), iz, shape, dtype)
    assert got.dtype == dtype and torch.equal(got.cpu(), want)
    assert torch.equal(again, got)
    assert bool(want.float().abs().max() > 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("iz", [(0, 2, 2, -1), (-1, -1, -1, -1),
                                (39, 39, 0, -1), (5, 0, 5, 5)])
def test_reproject_bwd_shared_and_invalid_slices(dev, dtype, iz):
    """Samples sharing a slice (in order or not), every sample invalid,
    NaN coordinates: exact against the plain version on a CPU copy, and
    slices no sample reads are zero."""
    grid, xg, yg, _, g, shape = _reproject_case(dev, dtype, 40, seed=3)
    s_d = len(iz)
    xg, yg = xg[:, :s_d].contiguous(), yg[:, :s_d].contiguous()
    xg[:, :, :40] = float("nan")
    g = g[:, :s_d].contiguous()
    iz = np.asarray(iz)
    got = reproject.gather_bwd(g, xg, yg, iz, shape)
    want = P.zslice_gather_bwd(g.cpu(), xg.cpu(), yg.cpu(), iz, shape, dtype)
    assert torch.equal(got.cpu(), want)
    for z in range(40):
        if z not in iz:
            assert not bool(got[..., z, :].any()), z


# ---------------------------------------------------------------------------
# the serving batch: both main-path forwards at B = 4 (the flagship grid,
# 2 views at 640^2, each scene with its own poses and intrinsics), against
# the plain versions and against each scene run alone at B = 1
# ---------------------------------------------------------------------------

class _Flagship4(_Flagship):
    vsize = (_Flagship.vmax - _Flagship.vmin) / _Flagship.nvox


def _scene_geometry(dev, b, v=2):
    """Per-scene poses (view 0 the grid's frame, the others turned and
    shifted) and intrinsics that differ from scene to scene."""
    g = torch.Generator().manual_seed(b)
    rcam = torch.eye(3, 4).repeat(b, v, 1, 1)
    for i in range(b):
        for j in range(1, v):
            a = (torch.rand(3, generator=g) - 0.5) * 0.6
            c, s = torch.cos(a), torch.sin(a)
            rz = torch.tensor([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
            rx = torch.tensor([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
            rcam[i, j, :, :3] = rx @ rz
            rcam[i, j, :, 3] = (torch.rand(3, generator=g) - 0.5) * 1.2
    f = 576.0 + 16.0 * torch.arange(b, dtype=torch.float32)
    kmat = torch.zeros(b, 3, 3)
    kmat[:, 0, 0] = kmat[:, 1, 1] = f
    kmat[:, 0, 2] = kmat[:, 1, 2] = 320.0
    kmat[:, 2, 2] = 1.0
    return rcam.to(dev), kmat.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [40, 20, 10])
def test_unproject_fused_at_batch_four(dev, dtype, s):
    """unproject_features_fused at B = 4 (the serving batch): one vector
    launch, equal to the plain gather, and scene i equal to the kernel on
    scene i's rows alone with the same coordinates (the batch strides of
    feats, coordinates and output). The coordinates of a scene projected
    in a batch of 4 and alone may differ in the last bit (the batched
    matmul of project_voxel_coords picks its kernel by batch size), so
    the per-scene check reuses the batch's."""
    cfg = _Flagship4()
    b, v, c = 4, 2, 64
    rcam, kmat = _scene_geometry(dev, b, v)
    pts = torch.from_numpy(P.voxel_grid_points(cfg)).to(dev)
    g = torch.Generator().manual_seed(s)
    feats = torch.randn(b, v, s, s, c, generator=g).to(dev, dtype)
    unproject.fused_variants.clear()
    got = unproject.unproject_features_fused(feats, rcam, kmat, (640, 640),
                                             pts, (40, 40, 40))
    torch.cuda.synchronize()
    assert dict(unproject.fused_variants) == {"fwd_vector": 1}
    x, y = P.project_voxel_coords(rcam, kmat, (640, 640), pts, s, s)
    want = P.bilinear_gather_fused(feats.reshape(b * v, s * s, c),
                                   x.contiguous(), y.contiguous(), s, s, v,
                                   True).reshape(got.shape)
    assert got.shape == (b, 40, 40, 40, v * c)
    assert torch.equal(got, want)
    for i in range(b):
        rows = slice(i * v, (i + 1) * v)
        alone = unproject.bilinear_gather_fused(
            feats[i].reshape(v, s * s, c), x[rows].contiguous(),
            y[rows].contiguous(), s, s, v, True)
        assert torch.equal(alone[0].reshape(got[i].shape), got[i]), i
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [40, 20, 10])
def test_reproject_at_batch_four(dev, dtype, s):
    """project_grid_nearest at B = 4 with each scene's own intrinsics: one
    vector launch, equal to the plain gather, and scene i equal to scene
    i run alone."""
    cfg = _Flagship4()
    b, c = 4, 64
    _, kmat = _scene_geometry(dev, b)
    g = torch.Generator().manual_seed(s + 1)
    grid = torch.randn(b, 40, 40, 40, c, generator=g).to(dev, dtype)
    reproject.variants.clear()
    got = reproject.project_grid_nearest(grid, kmat, (640, 640), s,
                                         cfg.samples, cfg)
    torch.cuda.synchronize()
    assert dict(reproject.variants) == {"fwd_vector": 1}
    xg, yg, iz = P.reprojection_coords(kmat, (640, 640), s, cfg.samples, cfg,
                                       40, 40, 40)
    want = P.zslice_gather(grid, xg.contiguous(), yg.contiguous(), iz)
    assert got.shape == (b, cfg.samples, s, s, c)
    assert torch.equal(got, want.reshape(got.shape))
    for i in range(b):
        alone = reproject.project_grid_nearest(grid[i:i + 1], kmat[i:i + 1],
                                               (640, 640), s, cfg.samples,
                                               cfg)
        assert torch.equal(alone[0], got[i]), i
    assert not torch.equal(got[0], got[1])


def test_trilinear_reprojection_on_card_matches_cpu(dev):
    """TRILINEAR_REPROJECTION's gather (plain torch on every device) at
    the flagship's P4 shapes: the card's values and gradient in the grid
    against the CPU's within 1e-5 of their largest magnitude (the
    coordinates' einsum and inverse and the gradient's scatter-add round
    differently on the two devices)."""
    cfg = _Flagship()
    b, s, c = 2, 40, 64
    _, kmat = _scene_geometry(dev, b)
    g = torch.Generator().manual_seed(7)
    grid = torch.randn(b, 40, 40, 40, c, generator=g)
    cot = torch.randn(b, cfg.samples, s, s, c, generator=g)
    outs = []
    for d in ("cpu", dev):
        leaf = grid.detach().to(d).requires_grad_(True)
        out = P.project_grid_trilinear(leaf, kmat.to(d), (640, 640), s,
                                       cfg.samples, cfg)
        (out * cot.to(d)).sum().backward()
        outs.append((out.detach().cpu(), leaf.grad.cpu()))
    (ref, ref_g), (got, got_g) = outs
    assert got.shape == (b, cfg.samples, s, s, c)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert (got_g - ref_g).abs().max() <= 1e-5 * ref_g.abs().max()
    assert (ref != 0).any()


def test_remat_step_launch_counts(dev):
    """One REMAT + TRAIN_BN training step of a small conv3d model on the
    card: each geometry kernel launches once a projected level, forward
    and backward; REMAT's recomputation of GridFusion and DepthCollapse
    launches none, and the per-view kernels none."""
    from mulit_view_object_detection_torch.compat import MaskRCNN
    from mulit_view_object_detection_torch.config import Config
    from mulit_view_object_detection_torch.data.generator import make_batch
    from mulit_view_object_detection_torch.data.synthetic import (
        SyntheticMultiViewDataset)
    from mulit_view_object_detection_torch.train.step import (
        draw_priorities, loss_and_grads)
    from mulit_view_object_detection_torch.train.trainable import (
        trainable_mask)

    class Small(Config):
        NAME = "cuda_remat"
        NUM_CLASSES = 4
        NUM_VIEWS = 2
        BACKBONE = "resnet50"
        TOP_DOWN_PYRAMID_SIZE = 16
        FPN_CLASSIF_FC_LAYERS_SIZE = 32
        IMAGE_MIN_DIM = IMAGE_MAX_DIM = 256
        POST_NMS_ROIS_TRAINING = 64
        TRAIN_ROIS_PER_IMAGE = 16
        MAX_GT_INSTANCES = 4
        nvox = nvox_z = 16
        samples = 8
        TRAIN_BN = True
        REMAT = True

    cfg = Small()
    eng = MaskRCNN("training", cfg, "build", device="cuda")
    model = eng.model
    ds = SyntheticMultiViewDataset(num_scenes=1, num_views=2, image_size=256,
                                   num_classes=4, seed=0)
    batch = draw_priorities(eng.to_device(make_batch(ds, cfg, rnd_state=0)),
                            cfg, torch.Generator().manual_seed(0))
    counts = ("launches", "bwd_launches", "view_launches",
              "view_bwd_launches")
    before = ([getattr(unproject, k) for k in counts]
              + [reproject.launches, reproject.bwd_launches])
    loss_and_grads(model, batch, cfg, trainable_mask(model, "all"))
    torch.cuda.synchronize()
    after = ([getattr(unproject, k) for k in counts]
             + [reproject.launches, reproject.bwd_launches])
    levels = 3                                     # P4, P5, P6
    assert [a - b for a, b in zip(after, before)] == [levels, levels, 0, 0,
                                                      levels, levels]
