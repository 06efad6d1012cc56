"""The fused-layout unprojection kernels' design, on the CPU.

The fused layout [B, N, V*C] is the per-view layout [B*V, N, C] with the
views of a batch element side by side in each voxel's row, so the CUDA
kernels (csrc/unproject.cu) serve both with a voxel stride of V*C and a
ReLU flag. Here: the backward walk's blocked decomposition in the fused
layout with the ReLU mask (ops/projection.py::scatter_taps_blocked with
v and saved) against the plain fused backward and against `jax.grad` of
the Pallas fused gather with relu=True in interpret mode; and the launch
plans the fused wrappers take (kernels/unproject.py::fwd_plan, bwd_plan,
pure Python) at the flagship shapes, odd widths and offset pointers.

Tolerances: the blocked and the plain scatter add the same float32
products, grouped otherwise: within 1e-6 of the largest magnitude. The
Pallas backward sums one-hot matmuls in another order: 1e-5 on O(1)
gradients (as tests/test_torch_view_kernels.py). Both sides take the
ReLU's mask from the same forward output, so a value at float32 noise
of 0 cannot pass on one side only.

NaN coordinates: the port's scatters add nothing for an invalid tap; the
Pallas backward multiplies the masked (zero) cotangent by the NaN weight
of its one-hot row and returns NaN. So the port's gradient with NaN
voxels is held to the Pallas gradient of the same input without them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.kernels.unproject_pallas import (  # noqa: E402
    bilinear_gather_fused as jax_gather_fused)
from mulit_view_object_detection_torch.kernels import unproject as U  # noqa: E402
from mulit_view_object_detection_torch.ops import projection as P  # noqa: E402
from tests.test_torch_view_kernels import _coords  # noqa: E402

NAN_VOXELS = (50, 51, 52)       # x NaN, y NaN, both


def _fused_inputs(rng, b, v, c, n, fh, fw, nan=True):
    """feats [B*V, fh*fw, C], coordinates [B*V, N] (every border, x and y
    in (-1, 0), .5 ties, runs of voxels on one pixel across chunk
    boundaries, and NaN voxels), cotangent [B, N, V*C]."""
    feats = rng.randn(b * v, fh * fw, c).astype(np.float32)
    x, y = _coords(rng, b * v, n, fh, fw)
    if nan:
        x[:, NAN_VOXELS[0]] = y[:, NAN_VOXELS[1]] = np.nan
        x[:, NAN_VOXELS[2]] = y[:, NAN_VOXELS[2]] = np.nan
    gout = rng.randn(b, n, v * c).astype(np.float32)
    return feats, x, y, gout


@pytest.mark.parametrize("fh,fw", [(8, 1), (8, 5), (1, 1)])
@pytest.mark.parametrize("c", [6, 8])
@pytest.mark.parametrize("v", [2, 3])
def test_fused_blocked_scatter_matches_plain_and_pallas(v, c, fh, fw):
    """The walk's partials in the fused layout, under the ReLU mask,
    summed: against the plain fused backward, and against jax.grad of the
    Pallas bilinear_gather_fused(..., relu=True) (its _bwd_rule_fused ->
    _bwd_kernel) in interpret mode."""
    rng = np.random.RandomState(100 * v + 10 * c + fh + fw)
    b, n = 2, 300
    feats, x, y, gout = _fused_inputs(rng, b, v, c, n, fh, fw)
    xt, yt, gt = (torch.from_numpy(a) for a in (x, y, gout))

    # against the plain fused backward, the mask from the plain forward
    saved = P.bilinear_gather_fused(torch.from_numpy(feats), xt, yt, fh, fw,
                                    v, True)
    want = P.bilinear_gather_fused_bwd(gt, saved, xt, yt, fh, fw, v, True,
                                       torch.float32)
    got = P.scatter_taps_blocked(gt, xt, yt, fh, fw, 4, 64, 3, v=v,
                                 saved=saved)
    scale = float(want.abs().max())
    assert scale > 0.5 and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    # the mask has work to do: some outputs are not > 0 (NaN ones too)
    assert 0 < int((saved > 0).sum()) < saved.numel()
    assert bool(torch.isnan(saved).any())

    # against the Pallas backward, the mask from the Pallas forward
    def fused(f, xs, ys):
        return jax_gather_fused(f, jnp.asarray(xs), jnp.asarray(ys), fh, fw,
                                v, 128, True)

    saved_jax = torch.from_numpy(np.array(fused(jnp.asarray(feats), x, y)))
    keep = [j for j in range(n) if j not in NAN_VOXELS]
    g_cut = jnp.asarray(gout[:, keep])
    ref = np.asarray(jax.grad(lambda f: jnp.sum(
        fused(f, x[:, keep], y[:, keep]) * g_cut))(jnp.asarray(feats)))
    got = P.scatter_taps_blocked(gt, xt, yt, fh, fw, 4, 64, 3, v=v,
                                 saved=saved_jax)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_fused_blocked_scatter_at_the_plans_blocking(relu):
    """The decomposition the fused wrapper would launch at V=2 and V=4 (a
    P6-shaped map, C=64, on a card of 4 SMs so that the voxels are cut
    into several chunks, each walked by many lanes) against the plain
    fused backward, with and without the ReLU."""
    rng = np.random.RandomState(7 + relu)
    b, fh, fw, c, n = 1, 10, 10, 64, 3000
    for v in (2, 4):
        feats, x, y, gout = _fused_inputs(rng, b, v, c, n, fh, fw)
        xt, yt, gt = (torch.from_numpy(a) for a in (x, y, gout))
        saved = P.bilinear_gather_fused(torch.from_numpy(feats), xt, yt, fh,
                                        fw, v, relu)
        ptrs = (0x1000, 0x2000) if relu else (0x1000,)
        plan = U.bwd_plan(b * v, c, n, torch.float32, *ptrs, sms=4)
        assert plan.variant == "walk" and plan.nchunks > 1
        want = P.bilinear_gather_fused_bwd(gt, saved, xt, yt, fh, fw, v,
                                           relu, torch.float32)
        got = P.scatter_taps_blocked(gt, xt, yt, fh, fw,
                                     plan.gx * U.WALK_VEC, plan.chunk,
                                     plan.lanes, v=v,
                                     saved=saved if relu else None)
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


def test_fused_wrappers_take_the_plain_path_on_the_cpu():
    """A CPU tensor goes to the plain versions: no launch is counted, and
    the results are the plain versions' own."""
    rng = np.random.RandomState(9)
    b, v, c, n, fh, fw = 1, 2, 8, 64, 4, 4
    feats, x, y, gout = _fused_inputs(rng, b, v, c, n, fh, fw, nan=False)
    f, xt, yt, gt = (torch.from_numpy(a) for a in (feats, x, y, gout))
    counts = (U.launches, U.bwd_launches, dict(U.fused_variants))
    out = U.gather_fused(f, xt, yt, fh, fw, v, True)
    assert torch.equal(out, P.bilinear_gather_fused(f, xt, yt, fh, fw, v,
                                                    True))
    dfeats = U.gather_fused_bwd(gt, out, xt, yt, fh, fw, v, True)
    assert torch.equal(dfeats, P.bilinear_gather_fused_bwd(
        gt, out, xt, yt, fh, fw, v, True, torch.float32))
    assert (U.launches, U.bwd_launches, dict(U.fused_variants)) == counts


# ---------------------------------------------------------------------------
# launch plans of the fused wrappers
# ---------------------------------------------------------------------------

def _aligned(dtype, offset=0):
    """Pointers of a feats, out, g and saved allocation (16-byte aligned,
    as torch allocates), `offset` elements past it."""
    es = torch.finfo(dtype).bits // 8
    return tuple(base + offset * es
                 for base in (0x10000, 0x20000, 0x30000, 0x40000))


@pytest.mark.parametrize("v", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plans_at_the_flagship_shapes(v, dtype):
    """The flagship fused shapes (B=1, C=64, 40^3 voxels; V=2 for conv3d
    and ident, V=4 for the 4-view conv3d) on 132 SMs: the vector forward
    (8 bf16 or 4 float32 channels a thread, a block of 8 or 16 threads a
    voxel) and the walk, with its chunks filling two blocks a SM."""
    feats_p, out_p, g_p, saved_p = _aligned(dtype)
    fwd = U.fwd_plan(64, dtype, feats_p, out_p)
    vec = 8 if dtype == torch.bfloat16 else 4
    assert fwd == ("vector", vec, 64 // vec, U.THREADS // (64 // vec))
    bwd = U.bwd_plan(v, 64, 64000, dtype, g_p, saved_p, sms=132)
    chunk = -(-64000 // (132 * U.WALK_BLOCKS_PER_SM // v))
    assert bwd == ("walk", 16, 16, 1, chunk, -(-64000 // chunk))
    # the relu'd backward reads saved beside g: the same plan as g alone
    assert bwd == U.bwd_plan(v, 64, 64000, dtype, g_p, sms=132)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plans_for_odd_widths_and_offset_pointers(dtype):
    """C=6 takes the scalar forward and the direct backward; so does a
    tensor one element past its allocation, each pointer on its own (the
    saved output of the ReLU'd backward included)."""
    ptrs = _aligned(dtype)
    assert U.fwd_plan(6, dtype, *ptrs[:2]).variant == "scalar"
    assert U.bwd_plan(4, 6, 300, dtype, *ptrs[2:]).variant == "direct"
    odd = _aligned(dtype, 1)
    for i in range(2):
        p = list(ptrs[:2])
        p[i] = odd[i]
        assert U.fwd_plan(64, dtype, *p) == ("scalar", 1, 64, 4)
    for i in (2, 3):
        p = list(ptrs[2:])
        p[i - 2] = odd[i]
        assert U.bwd_plan(4, 64, 64000, dtype, *p) == (
            "direct", 0, 0, 0, 0, 0)
    # one element past is still aligned to the walk's 4 elements when it
    # is four elements past
    assert U.bwd_plan(4, 64, 64000, dtype,
                      *_aligned(dtype, 4)[2:]).variant == "walk"


def test_fused_plans_cover_every_voxel_and_channel():
    """Over views (up to 8), widths, voxel counts and batch sizes: the
    forward's block covers a view's channel groups in whole strides and
    has at most THREADS threads; the walk's slices cover every channel
    group of a view, its chunks every voxel, its grid rows every (batch
    element, view), and its blocks fill at most one wave of the card (or
    are one chunk a slice)."""
    for dtype in (torch.float32, torch.bfloat16):
        for c in (4, 8, 12, 64, 256):
            fwd = U.fwd_plan(c, dtype, 0, 0)
            assert fwd.gx * fwd.vy <= U.THREADS
            assert c % fwd.vec == 0 and fwd.gx <= c // fwd.vec
            for v in (1, 2, 3, 4, 8):
                for b in (1, 2, 8):
                    for n in (1, 300, 64000):
                        plan = U.bwd_plan(b * v, c, n, dtype, 0, 0, sms=132)
                        assert plan.variant == "walk"
                        groups = c // U.WALK_VEC
                        assert plan.slices * plan.gx >= groups > (
                            plan.slices - 1) * plan.gx
                        assert plan.gx * plan.lanes <= U.THREADS
                        assert plan.chunk * plan.nchunks >= n > (
                            plan.nchunks - 1) * plan.chunk
                        assert plan.nchunks == 1 or (
                            b * v * plan.slices * plan.nchunks
                            <= 132 * U.WALK_BLOCKS_PER_SM)
