"""The plain backward versions of the two geometry gathers
(mulit_view_object_detection_torch/ops/projection.py, reached through the
kernel wrappers' autograd Functions on CPU tensors) against `jax.grad` of
the Pallas kernels in interpret mode (their custom_vjp backward kernels,
as tests/test_pallas_kernels.py runs them), of the plain XLA ops, and of
torch.autograd through the plain forward.

Tolerances: float32 scatters summed in another order than the Pallas
one-hot matmuls and the XLA scatter: atol 1e-5 on O(1) gradients (1e-4
where a gradient sums ~30 terms). In bfloat16 the Pallas backward rounds
its weights and each voxel tile's partial sum to bf16
(unproject_pallas.py:116-121) where the port sums in float32 and rounds
once: held to four bf16 steps (2^-8 relative) of the largest gradient.
The reprojection's gradient adds copies of g: exact in float32 when at
most two samples share a voxel, else to 1e-6.

The library yardsticks that chip_smoke.py times beside the kernels
(torch.nn.functional.grid_sample) are checked here to compute the same
functions: bilinear with zero padding and align_corners=True is the
unprojection's 4-tap gather, and 5-D nearest rounds half to even as the
reprojection does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.kernels.reproject_pallas import (  # noqa: E402
    project_grid_pallas, zslice_gather as jax_zslice_gather)
from mulit_view_object_detection_tpu.kernels.unproject_pallas import (  # noqa: E402
    bilinear_gather_fused as jax_gather_fused)
from mulit_view_object_detection_tpu.ops.projection import (  # noqa: E402
    project_grid, unproject_features)
from mulit_view_object_detection_torch.kernels import (  # noqa: E402
    reproject, unproject)
from mulit_view_object_detection_torch.ops import projection as P  # noqa: E402
from tests.test_projection import VoxCfg, simple_K  # noqa: E402
from tests.test_torch_projection import _poses, _t  # noqa: E402

BF16_EPS = 2.0 ** -8


def _edge_coords(rng, bv, n, fh, fw):
    """Coordinates across every border, x and y in (-1, 0), in-bounds
    x0 == 0 (as tests/test_torch_projection.py)."""
    x = rng.uniform(-1.5, fw + 0.5, (bv, n)).astype(np.float32)
    y = rng.uniform(-1.5, fh + 0.5, (bv, n)).astype(np.float32)
    x[:, :8] = rng.uniform(-0.99, -0.01, (bv, 8))
    y[:, 8:16] = rng.uniform(-0.99, -0.01, (bv, 8))
    x[:, 16:24] = 0.25
    return x, y


def _unproject_grads(feats, x, y, fh, fw, v, relu, gout):
    """(plain backward, torch.autograd through the Function, autograd of
    the plain forward) for the cotangent gout [B, N, V*C]."""
    f = _t(feats).requires_grad_()
    out = unproject.bilinear_gather_fused(f, _t(x), _t(y), fh, fw, v, relu)
    out.backward(_t(gout))
    direct = P.bilinear_gather_fused_bwd(
        _t(gout), out.detach(), _t(x), _t(y), fh, fw, v, relu,
        torch.float32)
    f2 = _t(feats).requires_grad_()
    P.bilinear_gather_fused(f2, _t(x), _t(y), fh, fw, v, relu).backward(
        _t(gout))
    return direct.numpy(), f.grad.numpy(), f2.grad.numpy()


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("fh,fw", [(8, 1), (1, 1), (8, 2), (5, 7)])
def test_unproject_bwd_matches_pallas_grad(fh, fw, relu):
    """fw == 1 (the colliding x0+1 / y0+1 taps), a 1x1 plane, x in
    (-1, 0) and every border: vs jax.grad of the Pallas fused kernel
    (its _bwd_rule_fused -> _bwd_kernel) in interpret mode."""
    rng = np.random.RandomState(fh * 10 + fw + relu)
    bv, v, c, n = 4, 2, 3, 64
    feats = rng.randn(bv, fh * fw, c).astype(np.float32)
    x, y = _edge_coords(rng, bv, n, fh, fw)
    gout = rng.randn(bv // v, n, v * c).astype(np.float32)

    def loss(f):
        return jnp.sum(jax_gather_fused(f, jnp.asarray(x), jnp.asarray(y),
                                        fh, fw, v, 128, relu)
                       * jnp.asarray(gout))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(feats)))
    direct, via_fn, via_plain = _unproject_grads(feats, x, y, fh, fw, v,
                                                 relu, gout)
    assert np.abs(ref).max() > 0.1                 # the test has signal
    np.testing.assert_allclose(direct, ref, atol=1e-5)
    np.testing.assert_array_equal(via_fn, direct)
    np.testing.assert_allclose(via_plain, direct, atol=1e-5)


def test_unproject_bwd_matches_xla_grad_through_geometry():
    """Through the projection: the port's unproject_features_fused vs the
    plain XLA unproject_features + relu(concat) (the JAX detector's CPU
    path), gradient of a random linear loss with respect to the
    features."""
    rng = np.random.RandomState(3)
    cfg = VoxCfg()
    b, v, c, fh = 2, 2, 3, 16
    feats = rng.randn(b, v, fh, fh, c).astype(np.float32)
    rcam = _poses(rng, b, v)
    K = np.stack([simple_K(), simple_K(f=70.0, c=30.0)])
    pts = P.voxel_grid_points(cfg)
    gs = (cfg.nvox, cfg.nvox, cfg.nvox_z)
    gout = rng.randn(b, *gs, v * c).astype(np.float32)

    def loss(f):
        out = unproject_features(f, jnp.asarray(rcam), jnp.asarray(K),
                                 (64, 64), jnp.asarray(pts), gs)
        out = jax.nn.relu(out.transpose(0, 2, 3, 4, 1, 5).reshape(
            gout.shape))
        return jnp.sum(out * jnp.asarray(gout))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(feats)))
    f = _t(feats).requires_grad_()
    unproject.unproject_features_fused(f, _t(rcam), _t(K), (64, 64),
                                       _t(pts), gs).backward(_t(gout))
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(f.grad.numpy(), ref, atol=1e-4)


def test_unproject_bwd_bfloat16_matches_pallas_grad():
    """bfloat16 features and cotangent: the gradient comes back in
    bfloat16, summed in float32 and rounded once."""
    rng = np.random.RandomState(7)
    bv, v, c, n, fh, fw = 4, 2, 8, 256, 6, 6
    feats = torch.from_numpy(rng.randn(bv, fh * fw, c).astype(
        np.float32)).bfloat16()
    x, y = _edge_coords(rng, bv, n, fh, fw)
    gout = torch.from_numpy(rng.randn(bv // v, n, v * c).astype(
        np.float32)).bfloat16()

    def loss(f):
        out = jax_gather_fused(f, jnp.asarray(x), jnp.asarray(y), fh, fw, v,
                               128, True)
        return jnp.sum(out.astype(jnp.float32)
                       * jnp.asarray(gout.float().numpy()))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(feats.float().numpy(),
                                                jnp.bfloat16)), np.float32)
    f = feats.clone().requires_grad_()
    unproject.bilinear_gather_fused(f, _t(x), _t(y), fh, fw, v, True
                                    ).backward(gout)
    assert f.grad.dtype == torch.bfloat16
    got = f.grad.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=4 * BF16_EPS * np.abs(ref).max())
    # the port rounds once: equal to the float32 gradient rounded
    exact = P.bilinear_gather_fused_bwd(
        gout, unproject.gather_fused(feats, _t(x), _t(y), fh, fw, v, True),
        _t(x), _t(y), fh, fw, v, True, torch.float32)
    np.testing.assert_array_equal(got, exact.bfloat16().float().numpy())


def _zslice_case(rng, iz, b=2, nx=5, ny=4, nz=4, c=3, npix=40):
    s_d = len(iz)
    grid = rng.randn(b, nx, ny, nz, c).astype(np.float32)
    xg = rng.uniform(-1.0, nx + 0.5, (b, s_d, npix)).astype(np.float32)
    yg = rng.uniform(-1.0, ny + 0.5, (b, s_d, npix)).astype(np.float32)
    ties = np.array([-0.5, 0.5, 1.5, 2.5, 3.5, 4.5], np.float32)
    xg[:, :, :12] = np.resize(ties, 12)
    yg[:, :, 12:24] = np.resize(ties, 12)
    gout = rng.randn(b, s_d, npix, c).astype(np.float32)
    return grid, xg, yg, gout


def _jax_zslice_grad(grid, xg, yg, iz, gout):
    b, nx, ny, nz, c = grid.shape

    def loss(gz):
        return jnp.sum(jax_zslice_gather(gz, jnp.asarray(xg),
                                         jnp.asarray(yg), tuple(iz), nx, ny,
                                         128) * jnp.asarray(gout))

    grid_z = grid.transpose(0, 3, 1, 2, 4).reshape(b, nz, nx * ny, c)
    dgz = np.asarray(jax.grad(loss)(jnp.asarray(grid_z)))
    return dgz.reshape(b, nz, nx, ny, c).transpose(0, 2, 3, 1, 4)


@pytest.mark.parametrize("iz", [(0, 2, -1), (-1, 1, 1, 3), (3, 3, 0),
                                (0, 1, -1, -1)])
def test_reproject_bwd_matches_pallas_grad(iz):
    """.5 ties (half-to-even), every border, leading and trailing
    iz = -1, two samples sharing a slice: vs jax.grad of the Pallas
    z-slice kernel (its _reproj_bwd -> _bwd_kernel) in interpret mode,
    and torch.autograd through the plain forward."""
    rng = np.random.RandomState(len(iz) + sum(iz))
    grid, xg, yg, gout = _zslice_case(rng, iz)
    ref = _jax_zslice_grad(grid, xg, yg, iz, gout)

    g = _t(grid).requires_grad_()
    reproject.zslice_gather(g, _t(xg), _t(yg), np.asarray(iz)).backward(
        _t(gout))
    direct = P.zslice_gather_bwd(_t(gout), _t(xg), _t(yg), np.asarray(iz),
                                 grid.shape, torch.float32).numpy()
    g2 = _t(grid).requires_grad_()
    P.zslice_gather(g2, _t(xg), _t(yg), np.asarray(iz)).backward(_t(gout))

    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(direct, ref, atol=1e-6)
    np.testing.assert_array_equal(g.grad.numpy(), direct)
    np.testing.assert_allclose(g2.grad.numpy(), direct, atol=1e-6)
    untouched = [z for z in range(grid.shape[3]) if z not in iz]
    assert not direct[:, :, :, untouched].any()


def test_reproject_bwd_trailing_invalid_keeps_slice_zero():
    """tests/test_pallas_kernels.py::test_zslice_gather_grad_with_trailing_
    invalid for the port: a trailing iz = -1 adds nothing, so the
    gradient equals the same call without it, and slice 0 keeps its
    gradient."""
    rng = np.random.RandomState(0)
    b, nz, nx, ny, c, npix = 1, 4, 8, 16, 2, 128
    grid = rng.rand(b, nx, ny, nz, c).astype(np.float32)
    xg = (rng.rand(b, 3, npix) * nx).astype(np.float32)
    yg = (rng.rand(b, 3, npix) * ny).astype(np.float32)

    def grad(iz, s_d):
        g = _t(grid).requires_grad_()
        out = reproject.zslice_gather(g, _t(xg[:, :s_d]), _t(yg[:, :s_d]),
                                      np.asarray(iz))
        (out ** 2).sum().backward()
        return g.grad.numpy()

    g_with, g_ref = grad((0, 1, -1), 3), grad((0, 1), 2)
    assert np.abs(g_ref[:, :, :, 0]).max() > 0
    np.testing.assert_array_equal(g_with, g_ref)
    gout = 2 * P.zslice_gather(_t(grid), _t(xg), _t(yg),
                               np.array([0, 1, -1])).numpy()
    np.testing.assert_allclose(
        g_with, _jax_zslice_grad(grid, xg, yg, (0, 1, -1), gout), atol=1e-5)


def test_reproject_bwd_matches_xla_grad_through_geometry():
    """Through the ray geometry: the port's project_grid_nearest vs the
    plain XLA project_grid and the Pallas project_grid_pallas
    (interpret), gradient of a quadratic loss with respect to the grid
    (as tests/test_pallas_kernels.py::test_project_grid_pallas_grad)."""
    rng = np.random.RandomState(1)
    cfg = VoxCfg()
    K = simple_K()[None]
    grid = rng.rand(1, 8, 8, 8, 2).astype(np.float32)
    tgt = rng.rand(1, cfg.samples, 8, 8, 2).astype(np.float32)

    def jloss(fn):
        return lambda g: jnp.sum((fn(g) - tgt) ** 2)

    ref_x = np.asarray(jax.grad(jloss(lambda g: project_grid(
        g, jnp.asarray(K), (64, 64), 8, cfg.samples, cfg)))(
            jnp.asarray(grid)))
    ref_p = np.asarray(jax.grad(jloss(lambda g: project_grid_pallas(
        g, jnp.asarray(K), (64, 64), 8, cfg.samples, cfg, tile=128)))(
            jnp.asarray(grid)))
    g = _t(grid).requires_grad_()
    out = reproject.project_grid_nearest(g, _t(K), (64, 64), 8, cfg.samples,
                                         cfg)
    ((out - _t(tgt)) ** 2).sum().backward()
    assert np.abs(ref_x).max() > 0.5
    np.testing.assert_allclose(g.grad.numpy(), ref_x, atol=1e-5)
    np.testing.assert_allclose(g.grad.numpy(), ref_p, atol=1e-5)


def test_reproject_bwd_bfloat16_rounds_once():
    rng = np.random.RandomState(2)
    grid, xg, yg, gout = _zslice_case(rng, (0, 2, 2, -1), c=8, npix=200)
    gb = torch.from_numpy(gout).bfloat16()
    g = torch.from_numpy(grid).bfloat16().requires_grad_()
    reproject.zslice_gather(g, _t(xg), _t(yg), np.array([0, 2, 2, -1])
                            ).backward(gb)
    assert g.grad.dtype == torch.bfloat16
    exact = P.zslice_gather_bwd(gb, _t(xg), _t(yg), np.array([0, 2, 2, -1]),
                                grid.shape, torch.float32)
    assert torch.equal(g.grad, exact.bfloat16())
    ref = _jax_zslice_grad(grid, xg, yg, (0, 2, 2, -1),
                           gb.float().numpy())
    np.testing.assert_allclose(exact.numpy(), ref, atol=1e-6)


def test_grid_sample_yardsticks_compute_the_same_functions():
    """F.grid_sample, timed on the card beside the kernels, is the library
    call for both gathers: bilinear, zeros padding, align_corners=True is
    the 4-tap unprojection with each out-of-bounds tap zeroed (x in
    (-1, 0) included), and 5-D nearest rounds .5 half to even, as the
    reprojection does."""
    import torch.nn.functional as F
    rng = np.random.RandomState(4)
    bv, v, c, n, fh, fw = 4, 2, 3, 64, 5, 7
    feats = rng.randn(bv, fh * fw, c).astype(np.float32)
    x, y = _edge_coords(rng, bv, n, fh, fw)
    grid = np.stack([2 * x / (fw - 1) - 1, 2 * y / (fh - 1) - 1], -1)
    lib = F.grid_sample(_t(feats).reshape(bv, fh, fw, c).permute(0, 3, 1, 2),
                        _t(grid)[:, None].float(), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    lib = lib[:, :, 0].permute(0, 2, 1)                    # [BV, N, C]
    ref = P.bilinear_gather_fused(_t(feats), _t(x), _t(y), fh, fw, v,
                                  relu=False)
    ref = ref.reshape(bv // v, n, v, c).transpose(1, 2).reshape(bv, n, c)
    np.testing.assert_allclose(lib.numpy(), ref.numpy(), atol=1e-5)

    b, nx, ny, nz = 1, 5, 5, 5          # (size - 1) a power of two: the
    vol = rng.randn(b, nx, ny, nz, c).astype(np.float32)   # ties stay exact
    ties = np.array([0.5, 1.5, 2.5, 3.5], np.float32)
    xg = np.resize(ties, (b, 1, 16))
    yg = np.resize(ties[::-1], (b, 1, 16))
    iz = np.array([2])
    coords = np.stack([np.full_like(xg, 2 * 2 / (nz - 1) - 1),
                       2 * yg / (ny - 1) - 1, 2 * xg / (nx - 1) - 1], -1)
    lib = F.grid_sample(_t(vol).permute(0, 4, 1, 2, 3),
                        _t(coords)[:, :, :, None].float(), mode="nearest",
                        padding_mode="zeros", align_corners=True)
    lib = lib[:, :, :, :, 0].permute(0, 2, 3, 1)           # [B, 1, 16, C]
    ref = P.zslice_gather(_t(vol), _t(xg), _t(yg), iz)
    np.testing.assert_array_equal(lib.numpy(), ref.numpy())
