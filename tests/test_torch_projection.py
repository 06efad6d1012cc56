"""Geometry of the port (mulit_view_object_detection_torch/ops/
projection.py and the kernel wrappers on CPU) against the JAX package:
the Pallas kernels run in interpret mode on CPU as
tests/test_pallas_kernels.py runs them, and the plain XLA ops.

Tolerances: the unprojection is float32 bilinear arithmetic whose
projection coordinates come from einsums summed in another order, so
atol 1e-5 on O(1) features; in bfloat16 one rounding step. The
reprojection copies values: exact in either dtype.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.kernels.reproject_pallas import (  # noqa: E402
    project_grid_pallas, zslice_gather as jax_zslice_gather)
from mulit_view_object_detection_tpu.kernels.unproject_pallas import (  # noqa: E402
    bilinear_gather_fused as jax_gather_fused,
    unproject_features_pallas_fused)
from mulit_view_object_detection_tpu.ops.projection import (  # noqa: E402
    project_grid, unproject_features,
    voxel_grid_points as jax_voxel_grid_points)
from mulit_view_object_detection_torch.kernels import (  # noqa: E402
    build, reproject, unproject)
from mulit_view_object_detection_torch.ops import projection as P  # noqa: E402
from tests.test_projection import VoxCfg, simple_K  # noqa: E402


def _poses(rng, b, v):
    """Cam->world poses: view 0 near identity, the others rotated and
    shifted so that part of the grid falls outside their image."""
    out = np.zeros((b, v, 3, 4), np.float32)
    for i in range(b):
        for j in range(v):
            a = rng.uniform(-0.4, 0.4, 3) * (j > 0)
            cx, cy, cz = np.cos(a)
            sx, sy, sz = np.sin(a)
            rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
            ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            out[i, j, :, :3] = rx @ ry @ rz
            out[i, j, :, 3] = rng.uniform(-0.8, 0.8, 3) * (j > 0)
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_voxel_grid_points_match():
    cfg = VoxCfg()
    np.testing.assert_array_equal(P.voxel_grid_points(cfg),
                                  jax_voxel_grid_points(cfg))


@pytest.mark.parametrize("fh", [16, 8, 1])
def test_unproject_fused_matches_jax(fh):
    """Port plain unprojection (coords + gather + relu, view-concat
    layout) vs the Pallas fused kernel (interpret) and vs the plain XLA
    unproject_features + relu(concat). fh = 1 is the 1-wide plane."""
    rng = np.random.RandomState(fh)
    cfg = VoxCfg()
    b, v, c = 2, 2, 3
    feats = rng.randn(b, v, fh, fh, c).astype(np.float32)
    rcam = _poses(rng, b, v)
    K = np.stack([simple_K(), simple_K(f=70.0, c=30.0)])
    pts = P.voxel_grid_points(cfg)
    gs = (cfg.nvox, cfg.nvox, cfg.nvox_z)

    got = unproject.unproject_features_fused(
        _t(feats), _t(rcam), _t(K), (64, 64), _t(pts), gs, relu=True).numpy()
    ref_pallas = np.asarray(unproject_features_pallas_fused(
        jnp.asarray(feats), jnp.asarray(rcam), jnp.asarray(K), (64, 64),
        jnp.asarray(pts), gs, relu=True, tile=128))
    ref_xla = np.asarray(unproject_features(
        jnp.asarray(feats), jnp.asarray(rcam), jnp.asarray(K), (64, 64),
        jnp.asarray(pts), gs))
    ref_xla = np.maximum(ref_xla.transpose(0, 2, 3, 4, 1, 5).reshape(
        got.shape), 0)
    assert got.shape == (b,) + gs + (v * c,)
    assert (got > 0).mean() > 0.2            # the test has signal
    assert (got == 0).mean() > 0.2           # ... and out-of-view voxels
    np.testing.assert_allclose(got, ref_pallas, atol=1e-5)
    np.testing.assert_allclose(got, ref_xla, atol=1e-5)


@pytest.mark.parametrize("fh,fw", [(8, 1), (1, 1), (8, 2), (5, 7)])
def test_bilinear_gather_edges_match_pallas(fh, fw):
    """Coordinates in (-1, 0) (floor, not truncation), taps tested one by
    one across every border, and the fw == 1 tap collision, vs the Pallas
    fused kernel in interpret mode, with and without the relu."""
    rng = np.random.RandomState(fh * 10 + fw)
    bv, v, c, n = 4, 2, 3, 64
    feats = rng.randn(bv, fh * fw, c).astype(np.float32)
    x = rng.uniform(-1.5, fw + 0.5, (bv, n)).astype(np.float32)
    y = rng.uniform(-1.5, fh + 0.5, (bv, n)).astype(np.float32)
    x[:, :8] = rng.uniform(-0.99, -0.01, (bv, 8))   # x in (-1, 0)
    y[:, 8:16] = rng.uniform(-0.99, -0.01, (bv, 8))
    x[:, 16:24] = 0.25                                # in-bounds x0 == 0
    for relu in (False, True):
        got = unproject.bilinear_gather_fused(_t(feats), _t(x), _t(y), fh,
                                              fw, v, relu).numpy()
        ref = np.asarray(jax_gather_fused(
            jnp.asarray(feats), jnp.asarray(x), jnp.asarray(y), fh, fw, v,
            128, relu))
        np.testing.assert_allclose(got, ref, atol=1e-5,
                                   err_msg=f"relu={relu}")


def test_project_grid_nearest_matches_jax():
    """Port reprojection vs the Pallas z-slice kernel (interpret) and the
    plain XLA project_grid, at two projection sizes: exact."""
    rng = np.random.RandomState(0)
    cfg = VoxCfg()
    K = np.stack([simple_K(), simple_K(f=70.0, c=30.0)])
    grid = rng.rand(2, 8, 8, 8, 4).astype(np.float32)
    for s in (16, 8):
        got = reproject.project_grid_nearest(
            _t(grid), _t(K), (64, 64), s, cfg.samples, cfg).numpy()
        ref_pallas = np.asarray(project_grid_pallas(
            jnp.asarray(grid), jnp.asarray(K), (64, 64), s, cfg.samples,
            cfg, tile=128))
        ref_xla = np.asarray(project_grid(
            jnp.asarray(grid), jnp.asarray(K), (64, 64), s, cfg.samples,
            cfg))
        assert (got != 0).mean() > 0.2
        np.testing.assert_array_equal(got, ref_pallas)
        np.testing.assert_array_equal(got, ref_xla)


BF16_EPS = 2.0 ** -8         # bfloat16's relative rounding step


def test_unproject_bfloat16_matches_jax():
    """bfloat16 features, as the bf16 slice feeds them. The taps are read
    in bf16, weighted and summed in float32 and rounded once after the
    ReLU, as the XLA path does (its bf16 * f32 product promotes to f32
    and the U-Net's first conv rounds it). Another summation order may
    move a value across a rounding boundary: within one bf16 step, and
    equal bit for bit in >= 99% of elements. The Pallas kernel
    (interpret) also rounds its bilinear weights to bf16 for the MXU
    (unproject_pallas.py:93-94), which the port does not: against it,
    within two bf16 steps of the largest feature."""
    rng = np.random.RandomState(5)
    cfg = VoxCfg()
    b, v, c, fh = 2, 2, 8, 16
    feats = torch.from_numpy(
        rng.randn(b, v, fh, fh, c).astype(np.float32)).bfloat16()
    rcam = _poses(rng, b, v)
    K = np.stack([simple_K(), simple_K(f=70.0, c=30.0)])
    pts = P.voxel_grid_points(cfg)
    gs = (cfg.nvox, cfg.nvox, cfg.nvox_z)

    got = unproject.unproject_features_fused(
        feats, _t(rcam), _t(K), (64, 64), _t(pts), gs, relu=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    jfeats = jnp.asarray(feats.float().numpy(), jnp.bfloat16)
    ref_pallas = np.asarray(unproject_features_pallas_fused(
        jfeats, jnp.asarray(rcam), jnp.asarray(K), (64, 64),
        jnp.asarray(pts), gs, relu=True, tile=128), np.float32)
    ref_xla = np.asarray(unproject_features(
        jfeats, jnp.asarray(rcam), jnp.asarray(K), (64, 64),
        jnp.asarray(pts), gs), np.float32)
    ref_xla = np.maximum(ref_xla.transpose(0, 2, 3, 4, 1, 5).reshape(
        got.shape), 0)
    ref_xla = torch.from_numpy(ref_xla).bfloat16().float().numpy()
    assert (got > 0).mean() > 0.2
    np.testing.assert_allclose(got, ref_xla, rtol=BF16_EPS, atol=1e-30)
    assert (got == ref_xla).mean() >= 0.99
    fmax = float(feats.float().abs().max())
    np.testing.assert_allclose(got, ref_pallas, rtol=0,
                               atol=2 * BF16_EPS * fmax)


def test_project_grid_bfloat16_matches_jax():
    """A bfloat16 grid is reprojected in bf16 (a copy): equal bit for bit
    to the Pallas kernel's bf16 output and to the XLA path's, which casts
    the grid to float32 first (detector.py:414)."""
    rng = np.random.RandomState(6)
    cfg = VoxCfg()
    K = np.stack([simple_K(), simple_K(f=70.0, c=30.0)])
    grid = torch.from_numpy(rng.randn(2, 8, 8, 8, 4).astype(np.float32))
    grid = grid.bfloat16()
    got = reproject.project_grid_nearest(grid, _t(K), (64, 64), 16,
                                         cfg.samples, cfg)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    g32 = grid.float().numpy()
    ref_pallas = np.asarray(project_grid_pallas(
        jnp.asarray(g32, jnp.bfloat16), jnp.asarray(K), (64, 64), 16,
        cfg.samples, cfg, tile=128), np.float32)
    ref_xla = np.asarray(project_grid(
        jnp.asarray(g32), jnp.asarray(K), (64, 64), 16, cfg.samples, cfg))
    assert (got != 0).mean() > 0.2
    np.testing.assert_array_equal(got, ref_pallas)
    np.testing.assert_array_equal(got, ref_xla)


def test_reprojection_coords_match_pallas_prologue():
    from mulit_view_object_detection_tpu.kernels.reproject_pallas import (
        _coords)
    cfg = VoxCfg()
    K = np.stack([simple_K(), simple_K(f=70.0, c=30.0)])
    xg, yg, iz = P.reprojection_coords(_t(K), (64, 64), 16, cfg.samples,
                                       cfg, 8, 8, 8)
    rx, ry, riz = _coords(jnp.asarray(K), (64, 64), 16, cfg.samples, cfg,
                          8, 8, 8)
    np.testing.assert_allclose(xg.numpy(), np.asarray(rx), atol=1e-5)
    np.testing.assert_allclose(yg.numpy(), np.asarray(ry), atol=1e-5)
    np.testing.assert_array_equal(iz, riz)


@pytest.mark.parametrize("iz", [(0, 2, -1), (-1, 1, 1, 3), (3, 3, 0)])
def test_zslice_gather_ties_and_invalid_samples(iz):
    """Exact .5 ties round half-to-even, coordinates straddle every grid
    border, and iz = -1 (leading, trailing) zeroes its sample: vs the
    Pallas z-slice kernel in interpret mode, exact."""
    rng = np.random.RandomState(len(iz))
    b, nx, ny, nz, c = 2, 5, 4, 4, 3
    s_d, npix = len(iz), 40
    grid = rng.randn(b, nx, ny, nz, c).astype(np.float32)
    xg = rng.uniform(-1.0, nx + 0.5, (b, s_d, npix)).astype(np.float32)
    yg = rng.uniform(-1.0, ny + 0.5, (b, s_d, npix)).astype(np.float32)
    ties = np.array([-0.5, 0.5, 1.5, 2.5, 3.5, 4.5], np.float32)
    xg[:, :, :12] = np.resize(ties, 12)
    yg[:, :, 12:24] = np.resize(ties, 12)
    got = reproject.zslice_gather(_t(grid), _t(xg), _t(yg),
                                  np.asarray(iz)).numpy()
    grid_z = grid.transpose(0, 3, 1, 2, 4).reshape(b, nz, nx * ny, c)
    ref = np.asarray(jax_zslice_gather(jnp.asarray(grid_z), jnp.asarray(xg),
                                       jnp.asarray(yg), tuple(iz), nx, ny,
                                       128))
    np.testing.assert_array_equal(got, ref)
    for s, z in enumerate(iz):
        if z < 0:
            assert not got[:, s].any()


def test_wrappers_take_plain_version_only_on_cpu(monkeypatch, tmp_path):
    """A CPU tensor takes the plain version and launches nothing; a tensor
    on any other device never does: on a non-CUDA device the wrappers
    raise, and the kernel library cannot build without nvcc (no
    fallback)."""
    unproject.launches = 0
    reproject.launches = 0
    feats = torch.zeros(2, 4, 3)
    xy = torch.zeros(2, 5)
    unproject.bilinear_gather_fused(feats, xy, xy, 2, 2, 2)
    reproject.zslice_gather(torch.zeros(1, 2, 2, 2, 3), torch.zeros(1, 2, 4),
                            torch.zeros(1, 2, 4), np.array([0, -1]))
    assert unproject.launches == 0 and reproject.launches == 0

    meta = torch.zeros(2, 4, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        unproject.bilinear_gather_fused(meta, xy, xy, 2, 2, 2)
    with pytest.raises(ValueError, match="device"):
        reproject.zslice_gather(torch.zeros(1, 2, 2, 2, 3, device="meta"),
                                xy, xy, np.array([0]))

    # no nvcc: the build raises instead of falling back
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    build.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.library()
    finally:
        build.library.cache_clear()
