"""The reprojection kernels' design, on the CPU: the one-pass backward's
decomposition (ops/projection.py::zslice_gather_bwd_blocked: per
z-slice band, the voxel -> pixel map of `reproject_buckets`, each voxel's
float32 sum in its bucket's order) against the plain scatter and against
`jax.grad` of the Pallas `zslice_gather` in interpret mode; the
wrappers' launch plans (kernels/reproject.py::fwd_plan, bwd_plan), which
are pure Python, and that they mirror csrc/reproject.cu; the cached
constants of `reprojection_coords`.

Tolerances: the decomposition adds each voxel's g rows from 0 in
ascending (sample, pixel) order, the order in which the plain
`index_add_` adds on the CPU, so the two are equal bit for bit in
float32, and in bfloat16 (each rounds the same float32 sum once). The
Pallas backward sums one-hot matmuls in another order: 1e-5 relative to
the largest gradient.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.kernels.reproject_pallas import (  # noqa: E402
    zslice_gather as jax_zslice_gather)
from mulit_view_object_detection_torch.kernels import reproject as R  # noqa: E402
from mulit_view_object_detection_torch.ops import projection as P  # noqa: E402
from tests.test_projection import VoxCfg, simple_K  # noqa: E402

CSRC = Path(R.__file__).resolve().parents[1] / "csrc"


def _case(rng, iz, b=2, nx=9, ny=7, nz=6, c=8, npix=160, crowd=20):
    """Coordinates across every border (voxels outside the grid), exact .5
    ties, NaN coordinates, and `crowd` pixels of every sample on one
    voxel; g of magnitudes 1e-3 to 1e3, so that the order of a sum shows
    in its last bits."""
    s_d = len(iz)
    xg = rng.uniform(-1.5, nx + 0.5, (b, s_d, npix)).astype(np.float32)
    yg = rng.uniform(-1.5, ny + 0.5, (b, s_d, npix)).astype(np.float32)
    ties = np.arange(-0.5, max(nx, ny) + 0.5, 1.0, dtype=np.float32)
    xg[:, :, :12] = np.resize(ties, 12)
    yg[:, :, 12:24] = np.resize(ties, 12)
    xg[:, :, 24:30] = np.nan
    yg[:, :, 30:33] = np.nan
    xg[:, :, 40:40 + crowd] = 3.0
    yg[:, :, 40:40 + crowd] = 2.5               # rounds to 2
    g = (rng.randn(b, s_d, npix, c)
         * 10.0 ** rng.uniform(-3, 3, (b, s_d, npix, 1))).astype(np.float32)
    return xg, yg, g, (b, nx, ny, nz, c)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


IZ = [(0, 2, 2, -1),      # duplicate slice, trailing -1
      (-1, 1, 1, 3),      # leading -1
      (-1, -1, -1),       # every sample outside the grid
      (5, 0, 5, 5),       # three samples on the last slice
      (4,)]               # one sample, every other slice untouched


@pytest.mark.parametrize("iz", IZ)
@pytest.mark.parametrize("band,chunk", [(256, 4096), (16, 64), (5, 7)])
def test_blocked_backward_equals_plain(iz, band, chunk):
    """The kernel's decomposition (one band for the whole slice and one
    chunk a sample; bands that split rows and chunks that split the
    crowded voxel's pixels) equals the plain scatter bit for bit, in
    float32 and bfloat16."""
    rng = np.random.RandomState(sum(iz) + 10 * len(iz) + band)
    xg, yg, g, shape = _case(rng, iz)
    for dtype in (torch.float32, torch.bfloat16):
        gt = _t(g).to(dtype)
        want = P.zslice_gather_bwd(gt, _t(xg), _t(yg), np.asarray(iz), shape,
                                   dtype)
        got = P.zslice_gather_bwd_blocked(gt, _t(xg), _t(yg), np.asarray(iz),
                                          shape, dtype, band, chunk)
        assert got.dtype == dtype
        assert torch.equal(got, want)
    untouched = [z for z in range(shape[3]) if z not in iz]
    assert not got[:, :, :, untouched].any()
    if max(iz) >= 0:
        assert float(want.float().abs().max()) > 1.0


def test_blocked_backward_order_shows_in_the_last_bits():
    """The test above can tell orders apart: the crowded voxel's sum in
    descending pixel order differs from the plain one in float32."""
    rng = np.random.RandomState(3)
    xg, yg, g, shape = _case(rng, (2,), crowd=40)
    want = P.zslice_gather_bwd(_t(g), _t(xg), _t(yg), np.array([2]), shape,
                               torch.float32)
    rev = P.zslice_gather_bwd(_t(g[:, :, ::-1]), _t(xg[:, :, ::-1]),
                              _t(yg[:, :, ::-1]), np.array([2]), shape,
                              torch.float32)
    assert not torch.equal(rev, want)
    np.testing.assert_allclose(rev.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * np.abs(g).max())


def test_buckets_list_pixels_in_ascending_order():
    """reproject_buckets, the kernel's step 2: each bucket holds exactly
    the chunk's entries with its key, in ascending order (a stable sort
    by key), whatever the runs the chunk is cut into."""
    rng = np.random.RandomState(5)
    for m, nvb, warps in ((300, 17, 8), (7, 3, 8), (1, 1, 8), (64, 5, 1)):
        keys = rng.randint(-1, nvb, m)
        keys[:m // 3] = nvb // 2                 # a crowded voxel
        start, size, entries = P.reproject_buckets(keys, nvb, warps)
        for v in range(nvb):
            got = entries[start[v]:start[v] + size[v]]
            np.testing.assert_array_equal(got, np.flatnonzero(keys == v))
        assert size.sum() == (keys >= 0).sum()


def _jax_grad(xg, yg, iz, g, shape):
    """jax.grad of the Pallas zslice_gather (interpret mode on the CPU),
    in the port's [B, nx, ny, nz, C] layout."""
    b, nx, ny, nz, c = shape

    def loss(gz):
        return jnp.sum(jax_zslice_gather(gz, jnp.asarray(xg),
                                         jnp.asarray(yg), tuple(iz), nx, ny,
                                         128) * jnp.asarray(g))

    grid_z = jnp.zeros((b, nz, nx * ny, c), jnp.float32)
    dgz = np.asarray(jax.grad(loss)(grid_z))
    return dgz.reshape(b, nz, nx, ny, c).transpose(0, 2, 3, 1, 4)


@pytest.mark.parametrize("iz", [(0, 2, 2, -1), (-1, 1, 1, 3), (-1, -1, -1),
                                (0, 5, 5, 5), (4,)])
def test_blocked_backward_matches_pallas_grad(iz):
    """Against jax.grad of the Pallas kernel: duplicate, leading,
    trailing and all -1 iz, .5 ties, voxels outside the grid, 20 pixels
    of a sample on one voxel. The Pallas backward takes iz ascending
    apart from -1 (the sorted sample depths: it zeroes a slice on the
    first of its consecutive visits), so (5, 0, 5, 5) is held to the
    plain scatter only. NaN coordinates add nothing in the port;
    the Pallas kernel is given those pixels with g = 0, so they add
    nothing there either, whatever it makes of a NaN coordinate."""
    rng = np.random.RandomState(len(iz) + 7)
    xg, yg, g, shape = _case(rng, iz, b=1, nx=8, ny=6, nz=6, c=4, npix=128)
    g = g / np.abs(g).max(-1, keepdims=True)      # O(1) rows
    g[:, :, 40:60] = np.abs(g[:, :, 40:60])      # the crowd adds up
    got = P.zslice_gather_bwd_blocked(_t(g), _t(xg), _t(yg), np.asarray(iz),
                                      shape, torch.float32, 16, 48).numpy()
    nan = np.isnan(xg) | np.isnan(yg)
    ref = _jax_grad(np.where(nan, 0.0, xg), np.where(nan, 0.0, yg), iz,
                    np.where(nan[..., None], 0.0, g), shape)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    if max(iz) >= 0:
        assert np.abs(ref).max() > 5.0            # 20 rows on one voxel


def test_wrappers_take_the_plain_path_on_the_cpu():
    """A CPU tensor goes to the plain versions: no launch is counted."""
    rng = np.random.RandomState(9)
    xg, yg, g, shape = _case(rng, (0, 3, -1))
    grid = _t(rng.randn(*shape).astype(np.float32))
    counts = (R.launches, R.bwd_launches, dict(R.variants))
    iz = np.array([0, 3, -1])
    assert torch.equal(R.gather(grid, _t(xg), _t(yg), iz),
                       P.zslice_gather(grid, _t(xg), _t(yg), iz))
    assert torch.equal(R.gather_bwd(_t(g), _t(xg), _t(yg), iz, shape),
                       P.zslice_gather_bwd(_t(g), _t(xg), _t(yg), iz, shape,
                                           torch.float32))
    assert (R.launches, R.bwd_launches, dict(R.variants)) == counts


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

def _ptrs(dtype, offset=0):
    es = torch.finfo(dtype).bits // 8
    return 0x10000 + offset * es, 0x20000


@pytest.mark.parametrize("dtype,vec,gx,items", [
    (torch.bfloat16, 8, 8, 4),
    (torch.float32, 4, 16, 8),
])
def test_plans_at_the_flagship_shapes(dtype, vec, gx, items):
    """C=64 on the 40^3 grid at P4 / P5 / P6: the vector forward (8 bf16
    or 4 float32 channels a thread) and the vector backward, 32 float32
    sums a thread, one chunk a sample, 13 bands of 128 voxels a slice
    (260 blocks at B=1 for 20 read slices paired with 20 unread ones:
    one wave of 132 SMs at two blocks each)."""
    for npix in (1600, 400, 100):
        assert R.fwd_plan(64, dtype, *_ptrs(dtype)) == (
            "vector", vec, gx, R.THREADS // gx)
        plan = R.bwd_plan(40, 40, 64, npix, dtype, *_ptrs(dtype))
        assert plan == ("vector", vec, gx, items, 128, 13, 1, npix,
                        4 * (2 * npix + 128 * R.WARPS + R.WARPS))
        assert plan.smem <= 48 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plans_for_odd_widths_offset_pointers_and_large_maps(dtype):
    """C=6 and tensors one element past their allocation take the scalar
    variants; more than MAX_CHUNK pixels a sample the chunked backward."""
    assert R.fwd_plan(6, dtype, *_ptrs(dtype)).variant == "scalar"
    assert R.bwd_plan(40, 40, 6, 1600, dtype, *_ptrs(dtype)) == (
        "scalar", 1, 6, 6, 252, 7, 1, 1600, 4 * (3200 + 252 * 8 + 8))
    assert R.fwd_plan(64, dtype, *_ptrs(dtype, 1)) == ("scalar", 1, 64, 4)
    assert R.fwd_plan(64, dtype, _ptrs(dtype)[0], 0x20002).variant == \
        "scalar"
    for ptrs in (_ptrs(dtype, 1), (0x10000, 0x20002)):
        plan = R.bwd_plan(40, 40, 64, 1600, dtype, *ptrs)
        assert plan[:5] == ("scalar", 1, 64, 32, 128)
    big = R.bwd_plan(40, 40, 64, 160 * 160, dtype, *_ptrs(dtype))
    assert big.variant == "vector_chunked" and big.chunk == R.MAX_CHUNK
    assert R.bwd_plan(40, 40, 64, R.MAX_CHUNK, dtype,
                      *_ptrs(dtype)).variant == "vector"
    assert R.bwd_plan(40, 40, 6, 5000, dtype,
                      *_ptrs(dtype)).variant == "scalar_chunked"


def test_bwd_plans_cover_every_voxel_and_channel():
    """Over widths, grids and pixel counts: the slices cover every
    channel group, the bands every voxel of a slice, a band is at most
    MAX_BAND voxels and a thread keeps at most MAX_ACC sums, and the
    shared memory stays under the 48 KB a block gets without opting
    in."""
    for dtype in (torch.float32, torch.bfloat16):
        for c in (1, 3, 6, 8, 64, 256, 3000):
            for nx, ny in ((1, 1), (8, 5), (40, 40), (128, 96)):
                for npix in (1, 100, 4096, 4097, 100000):
                    p = R.bwd_plan(nx, ny, c, npix, dtype, 0, 0)
                    groups = c // p.vec
                    assert p.slices * p.gx >= groups > (p.slices - 1) * p.gx
                    assert p.band == p.items * (R.THREADS // p.gx)
                    assert p.items * p.vec <= R.MAX_ACC
                    assert p.band <= R.MAX_BAND
                    assert p.bands * p.band >= nx * ny > (
                        p.bands - 1) * p.band
                    assert 1 <= p.chunk <= min(max(npix, 1), R.MAX_CHUNK)
                    assert p.variant.endswith("_chunked") == (
                        npix > R.MAX_CHUNK)
                    assert p.smem <= 48 * 1024


def test_plans_mirror_the_cuda_source():
    """THREADS, MAX_ACC, MAX_BAND, MAX_CHUNK and WARPS are
    csrc/reproject.cu's constants, the shared memory is its layout, and
    the source exports exactly the forward and the backward entry points,
    whose signatures kernels/build.py declares."""
    from mulit_view_object_detection_torch.kernels import build
    common = (CSRC / "common.cuh").read_text()
    src = (CSRC / "reproject.cu").read_text()
    assert re.search(rf"constexpr int kThreads = {R.THREADS};", common)
    for name, value in (("kMaxAcc", R.MAX_ACC),
                        ("kMaxBand", R.MAX_BAND),
                        ("kMaxChunk", R.MAX_CHUNK)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int kWarps = kThreads / 32;" in src
    assert R.WARPS == R.THREADS // 32
    assert ("sizeof(int) * (2 * chunk + band * kWarps + kWarps)" in src)
    names = sorted(re.findall(r'extern "C" int (\w+)\(', src))
    assert names == ["mvod_reproject_nearest", "mvod_reproject_nearest_bwd"]
    for name in names:
        body = src.split(f'extern "C" int {name}(')[1].split(")")[0]
        assert len(body.split(",")) == len(build._SIGNATURES[name]), name


# ---------------------------------------------------------------------------
# reprojection_coords: constants cached, no host check of the inverse
# ---------------------------------------------------------------------------

def test_reprojection_coords_cache_and_inverse():
    """The constants are built once per (device, shapes, config) and the
    coordinates equal the uncached arithmetic with torch.linalg.inv bit
    for bit; the z index returned is the caller's own copy."""
    cfg = VoxCfg()
    K = _t(np.stack([simple_K(), simple_K(f=70.0, c=30.0)]))
    P._ray_constants.cache_clear()
    xg, yg, iz = P.reprojection_coords(K, (64, 64), 16, cfg.samples, cfg,
                                       8, 8, 8)
    iz[:] = 99
    xg2, yg2, iz2 = P.reprojection_coords(K, (64, 64), 16, cfg.samples,
                                          cfg, 8, 8, 8)
    info = P._ray_constants.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    assert (iz2 < 8).all()
    assert torch.equal(xg, xg2) and torch.equal(yg, yg2)
    rsz = 16 / 64
    assert torch.equal(torch.linalg.inv_ex(K * rsz).inverse,
                       torch.linalg.inv(K * rsz))
