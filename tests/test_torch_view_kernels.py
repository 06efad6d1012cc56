"""The per-view unprojection kernels' design, on the CPU: the blocked
decomposition of the backward (ops/projection.py::scatter_taps_blocked:
the walk's partials per view row, channel slice, voxel chunk and lane,
summed) against the plain scatter and against `jax.grad` of the Pallas
per-view gather in interpret mode, and the wrapper's launch plans
(kernels/unproject.py::fwd_plan, bwd_plan), which are pure Python.

Tolerances: the blocked and the plain scatter add the same float32
products, grouped otherwise: within 1e-6 of the largest magnitude. The
Pallas backward sums one-hot matmuls in another order: 1e-5 on O(1)
gradients (as tests/test_torch_fusion.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.kernels.unproject_pallas import (  # noqa: E402
    bilinear_gather as jax_gather)
from mulit_view_object_detection_torch.kernels import unproject as U  # noqa: E402
from mulit_view_object_detection_torch.ops import projection as P  # noqa: E402

CSRC = Path(U.__file__).resolve().parents[1] / "csrc"


def _coords(rng, bv, n, fh, fw):
    """Every border, x and y in (-1, 0), .5 ties and integers, and runs
    of 12 voxels on one pixel, each across a multiple of 32, so that
    chunk boundaries split the pixel's contributors."""
    x = rng.uniform(-1.5, fw + 0.5, (bv, n)).astype(np.float32)
    y = rng.uniform(-1.5, fh + 0.5, (bv, n)).astype(np.float32)
    x[:, :8] = rng.uniform(-0.99, -0.01, (bv, 8))
    y[:, 8:16] = rng.uniform(-0.99, -0.01, (bv, 8))
    x[:, 16:24] = np.resize(np.arange(-0.5, fw + 0.5, 1.0), 8)
    y[:, 24:32] = np.resize(np.arange(-0.5, fh + 0.5, 1.0), 8)
    x[:, 32:40] = np.resize(np.arange(-1.0, fw + 1.0, 1.0), 8)
    run = (np.arange(40, n) + 6) % 32 < 12
    x[:, 40:][:, run] = min(0.25, fw - 0.75)
    y[:, 40:][:, run] = min(0.5, fh - 0.5)
    return x, y


CASES = [  # fh, fw, c, n, cs, chunk, lanes
    (8, 1, 6, 200, 4, 16, 1),       # fw == 1; a slice of 4 of 6 channels
    (1, 1, 5, 120, 2, 48, 5),       # one pixel; slices 2, 2, 1
    (6, 6, 12, 500, 8, 64, 3),      # slices 8 + 4; lanes of 22, 21, 21
    (5, 7, 3, 333, 3, 100, 1),      # whole rows, a ragged last chunk
    (10, 10, 64, 2000, 32, 160, 8),  # a P6-shaped map
]


@pytest.mark.parametrize("fh,fw,c,n,cs,chunk,lanes", CASES)
def test_blocked_scatter_matches_plain(fh, fw, c, n, cs, chunk, lanes):
    rng = np.random.RandomState(fh * 100 + fw * 10 + c)
    bv = 3
    x, y = _coords(rng, bv, n, fh, fw)
    g = torch.from_numpy(rng.randn(bv, n, c).astype(np.float32))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    want = P.bilinear_gather_bwd(g, xt, yt, fh, fw, torch.float32)
    got = P.scatter_taps_blocked(g, xt, yt, fh, fw, cs, chunk, lanes)
    scale = float(want.abs().max())
    assert scale > 0.5
    assert float((got - want).abs().max()) <= 1e-6 * scale
    # the test has what it claims: some pixel's contributors lie in two
    # chunks
    hits = [set() for _ in range(-(-n // chunk))]
    for idx, w, valid in P._bilinear_taps(xt, yt, fh, fw):
        for j in range(n):
            if valid[0, j]:
                hits[j // chunk].add(int(idx[0, j]))
    assert any(a & b for i, a in enumerate(hits) for b in hits[i + 1:])


@pytest.mark.parametrize("fh,fw,c,cs,chunk", [(8, 1, 3, 2, 16),
                                              (1, 1, 4, 4, 7),
                                              (8, 2, 5, 4, 30),
                                              (5, 7, 6, 4, 25)])
def test_blocked_scatter_matches_pallas_grad(fh, fw, c, cs, chunk):
    """The blocked partials, summed, against jax.grad of the Pallas
    bilinear_gather (its _bwd_rule -> _bwd_kernel) in interpret mode."""
    rng = np.random.RandomState(fh * 10 + fw + c)
    bv, n = 4, 96
    feats = rng.randn(bv, fh * fw, c).astype(np.float32)
    x, y = _coords(rng, bv, n, fh, fw)
    gout = rng.randn(bv, n, c).astype(np.float32)

    def loss(f):
        return jnp.sum(jax_gather(f, jnp.asarray(x), jnp.asarray(y), fh, fw,
                                  128) * jnp.asarray(gout))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(feats)))
    got = P.scatter_taps_blocked(torch.from_numpy(gout), torch.from_numpy(x),
                                 torch.from_numpy(y), fh, fw, cs, chunk, 4)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_blocked_scatter_at_the_plans_blocking():
    """The decomposition the wrapper would launch (a P6-shaped map, C=64,
    on a card of 4 SMs so that the voxels are cut into several chunks,
    each walked by many lanes) against the plain scatter, for a float32
    and a bfloat16 g."""
    rng = np.random.RandomState(6)
    bv, fh, fw, c, n = 2, 10, 10, 64, 3000
    x, y = _coords(rng, bv, n, fh, fw)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for dtype in (torch.float32, torch.bfloat16):
        plan = U.bwd_plan(bv, c, n, dtype, 0x1000, sms=4)
        assert plan.variant == "walk" and plan.nchunks > 1
        g = torch.from_numpy(rng.randn(bv, n, c).astype(np.float32)).to(dtype)
        want = P.bilinear_gather_bwd(g, xt, yt, fh, fw, torch.float32)
        got = P.scatter_taps_blocked(g.float(), xt, yt, fh, fw,
                                     plan.gx * U.WALK_VEC, plan.chunk,
                                     plan.lanes)
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


def test_scatter_ignores_invalid_taps():
    """NaN coordinates, and out-of-bounds voxels whose g is not finite,
    add nothing, in the plain and the blocked scatter alike: the gradient
    equals that of the same call without those voxels."""
    rng = np.random.RandomState(3)
    bv, fh, fw, c, n = 2, 4, 5, 3, 64
    x, y = _coords(rng, bv, n, fh, fw)
    g = rng.randn(bv, n, c).astype(np.float32)
    x[:, 50], y[:, 51] = np.nan, np.nan
    x[:, 52], y[:, 53] = np.inf, -np.inf
    x[:, 54:56], g[:, 54:56] = -5.0, np.inf       # all four taps invalid
    keep = [j for j in range(n) if j not in range(50, 56)]
    args = (torch.from_numpy(g), torch.from_numpy(x), torch.from_numpy(y))
    cut = tuple(t[:, keep].contiguous() for t in args)
    want = P.bilinear_gather_bwd(*cut, fh, fw, torch.float32)
    assert bool(torch.isfinite(want).all()) and float(want.abs().max()) > 0
    assert torch.equal(P.bilinear_gather_bwd(*args, fh, fw, torch.float32),
                       want)
    got = P.scatter_taps_blocked(*args, fh, fw, 2, 16, 3)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,dtype,ptrs,variant,vec,gx,vy", [
    (64, torch.bfloat16, (0x1000, 0x2000), "vector", 8, 8, 32),
    (64, torch.float32, (0x1000, 0x2000), "vector", 4, 16, 16),
    (6, torch.bfloat16, (0x1000, 0x2000), "scalar", 1, 6, 42),
    (6, torch.float32, (0x1000, 0x2000), "scalar", 1, 6, 42),
    (12, torch.float32, (0x1000, 0x2000), "vector", 4, 3, 85),
    (12, torch.bfloat16, (0x1000, 0x2000), "scalar", 1, 12, 21),
    (64, torch.bfloat16, (0x1002, 0x2000), "scalar", 1, 64, 4),  # offset
    (64, torch.float32, (0x1000, 0x2004), "scalar", 1, 64, 4),
    (4096, torch.float32, (0x1000, 0x2000), "vector", 4, 256, 1),
])
def test_view_fwd_plan(c, dtype, ptrs, variant, vec, gx, vy):
    plan = U.fwd_plan(c, dtype, *ptrs)
    assert plan == (variant, vec, gx, vy)
    assert plan.gx * plan.vy <= U.THREADS


def test_view_fwd_plan_on_a_sliced_tensor():
    """A tensor offset by one element from its allocation is not 16-byte
    aligned: the scalar variant."""
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.zeros(4 * 100 * 64 + 1, dtype=dtype)
        feats = base[1:].view(4, 100, 64)
        assert feats.is_contiguous()
        out = torch.empty(4, 50, 64, dtype=dtype)
        assert U.fwd_plan(64, dtype, base.data_ptr(),
                               out.data_ptr()).variant == "vector"
        assert U.fwd_plan(64, dtype, feats.data_ptr(),
                               out.data_ptr()).variant == "scalar"


@pytest.mark.parametrize("c,dtype,ptr,plan", [
    (64, torch.bfloat16, 0x1000, ("walk", 16, 16, 1, 970, 66)),
    (64, torch.float32, 0x1000, ("walk", 16, 16, 1, 970, 66)),
    (12, torch.bfloat16, 0x1008, ("walk", 3, 85, 1, 970, 66)),
    (1024, torch.float32, 0x1000, ("walk", 32, 8, 8, 8000, 8)),
    (6, torch.float32, 0x1000, ("direct", 0, 0, 0, 0, 0)),
    (64, torch.bfloat16, 0x1002, ("direct", 0, 0, 0, 0, 0)),  # offset
    (64, torch.float32, 0x1008, ("direct", 0, 0, 0, 0, 0)),
])
def test_view_bwd_plan(c, dtype, ptr, plan):
    """The 4-view flagship (64,000 voxels) on 132 SMs, and the shapes and
    alignments that take the direct scatter."""
    assert U.bwd_plan(4, c, 64000, dtype, ptr, sms=132) == plan


def test_view_bwd_plan_covers_every_voxel_and_channel():
    """Over widths, voxel counts and view rows: the slices cover every
    channel group, the chunks every voxel, a block has at most THREADS
    threads, and the blocks fill at most one wave of the card (or are
    one chunk a slice)."""
    for dtype in (torch.float32, torch.bfloat16):
        vec = U.WALK_VEC
        for c in (vec, 3 * vec, 64, 256, 1024):
            for n in (1, 7, 300, 64000, 1_000_000):
                for bv in (1, 4, 16):
                    plan = U.bwd_plan(bv, c, n, dtype, 0, sms=132)
                    assert plan.variant == "walk"
                    groups = c // vec
                    assert plan.slices * plan.gx >= groups > (
                        plan.slices - 1) * plan.gx
                    assert plan.gx * plan.lanes <= U.THREADS
                    assert plan.chunk * plan.nchunks >= n > (
                        plan.nchunks - 1) * plan.chunk
                    assert plan.nchunks == 1 or (
                        bv * plan.slices * plan.nchunks
                        <= 132 * U.WALK_BLOCKS_PER_SM)


def test_plans_mirror_the_cuda_source():
    """THREADS is the sources' kThreads, the forward's 16-byte groups hold
    4 float32 or 8 bfloat16 channels, as csrc/common.cuh's Vec16, a walk
    thread owns WALK_VEC channels, and the source has one forward and one
    backward entry point, which serve both layouts."""
    common = (CSRC / "common.cuh").read_text()
    assert re.search(rf"constexpr int kThreads = {U.THREADS};", common)
    src = (CSRC / "unproject.cu").read_text()
    assert "constexpr int kTile = kThreads;" in src
    for dtype, bits in ((torch.float32, "float"),
                        (torch.bfloat16, "__nv_bfloat16")):
        assert re.search(rf"struct Vec16<{bits}> {{\n  static constexpr int "
                         rf"kN = {U._vec(dtype)};", common)
    assert U.WALK_VEC == 4 and "__device__ __forceinline__ void load4(" in src
    assert re.search(rf"constexpr int kWalkVec = {U.WALK_VEC};", src)
    assert sorted(re.findall(r'extern "C" int (\w+)\(', src)) == [
        "mvod_unproject_fused", "mvod_unproject_fused_bwd"]
