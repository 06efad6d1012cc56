"""Slice 3 of the port, module by module, against the JAX package on CPU:
the per-view unprojection gather and its backward (the plain versions the
CUDA kernels are held to), the GridFusion modes add, mean, ident and
lstm3d, the scanned ConvLSTM3D, both DepthCollapse modes, and the
transformer fusion (positional encoding, encoder layer, the whole stack,
the depth-conditioned ray lift).

Tolerances: the per-view gather sums the same four float32 products as
the Pallas kernel's one-hot matmul (interpret mode), in another order:
1e-6 on O(1) features. Through the projection the coordinates come from
einsums summed in another order: 1e-5. The backward scatters float32
in another order than the Pallas matmuls: 1e-5. Modules compare float32
through two conv/matmul backends (XLA vs oneDNN): 1e-4 of their O(1)
outputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.kernels.unproject_pallas import (  # noqa: E402
    bilinear_gather as jax_gather, unproject_features_pallas)
from mulit_view_object_detection_tpu.models import fusion as jfusion  # noqa: E402
from mulit_view_object_detection_tpu.models import transformer as jxf  # noqa: E402
from mulit_view_object_detection_tpu.ops.projection import (  # noqa: E402
    unproject_features as xla_unproject, unproject_rays as jax_rays)
from mulit_view_object_detection_torch.kernels import unproject  # noqa: E402
from mulit_view_object_detection_torch.models import fusion  # noqa: E402
from mulit_view_object_detection_torch.models import transformer as xf  # noqa: E402
from mulit_view_object_detection_torch.ops import projection as P  # noqa: E402
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch)
from tests.test_projection import VoxCfg, simple_K  # noqa: E402
from tests.test_torch_convert import random_like  # noqa: E402
from tests.test_torch_projection import _poses, _t  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _flax_vars(module, *args, seed=0, **kw):
    return random_like(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kw)), seed)


def _load(torch_module, variables):
    torch_module.load_state_dict(flax_to_torch(variables), strict=True)
    return torch_module.eval()


# ---------------------------------------------------------------------------
# per-view unprojection gather (kernel row 2) and its backward
# ---------------------------------------------------------------------------

def _coords(rng, bv, n, fh, fw):
    """Every border, x and y in (-1, 0) (floor, not truncation), an
    in-bounds x0 == 0 column, and exact .5 ties and integers (the cases
    of tests/test_pallas_kernels.py:14-72)."""
    x = rng.uniform(-1.5, fw + 0.5, (bv, n)).astype(np.float32)
    y = rng.uniform(-1.5, fh + 0.5, (bv, n)).astype(np.float32)
    x[:, :8] = rng.uniform(-0.99, -0.01, (bv, 8))
    y[:, 8:16] = rng.uniform(-0.99, -0.01, (bv, 8))
    x[:, 16:24] = 0.25
    y[:, 16:24] = rng.uniform(0.1, max(fh - 1.1, 0.2), (bv, 8)) + 0.5
    x[:, 24:32] = np.resize(np.arange(-0.5, fw + 0.5, 1.0), 8)
    y[:, 32:40] = np.resize(np.arange(-1.0, fh + 1.0, 1.0), 8)
    return x, y


@pytest.mark.parametrize("fh,fw", [(8, 1), (1, 1), (8, 2), (5, 7)])
def test_bilinear_gather_matches_pallas(fh, fw):
    """Plain per-view gather (the wrapper on CPU tensors) vs the Pallas
    bilinear_gather in interpret mode: fw == 1 (the colliding x0+1 / y0+1
    taps), a 1x1 plane, out-of-bounds taps, x in (-1, 0), .5 ties."""
    rng = np.random.RandomState(fh * 10 + fw)
    bv, c, n = 3, 4, 64
    feats = rng.randn(bv, fh * fw, c).astype(np.float32)
    x, y = _coords(rng, bv, n, fh, fw)
    got = unproject.bilinear_gather(_t(feats), _t(x), _t(y), fh, fw)
    assert got.shape == (bv, n, c) and got.dtype == torch.float32
    ref = np.asarray(jax_gather(jnp.asarray(feats), jnp.asarray(x),
                                jnp.asarray(y), fh, fw, 128))
    assert np.abs(ref).max() > 0.5 and (ref == 0).any()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # the plain version is the fused one's per-view layout, without relu
    fused = P.bilinear_gather_fused(_t(feats), _t(x), _t(y), fh, fw, 1,
                                    relu=False)
    assert torch.equal(got, fused)


@pytest.mark.parametrize("v", [2, 3])
def test_unproject_features_matches_xla_and_pallas(v):
    """Through the projection: the port's unproject_features vs the XLA
    unproject_features (the JAX detector's CPU path) and the Pallas
    unproject_features_pallas (interpret), [B, V, nx, ny, nz, C]."""
    rng = np.random.RandomState(v)
    cfg = VoxCfg()
    b, c, fh = 2, 3, 16
    feats = rng.randn(b, v, fh, fh, c).astype(np.float32)
    rcam = _poses(rng, b, v)
    K = np.stack([simple_K(), simple_K(f=70.0, c=30.0)])
    pts = P.voxel_grid_points(cfg)
    gs = (cfg.nvox, cfg.nvox, cfg.nvox_z)
    args = (jnp.asarray(feats), jnp.asarray(rcam), jnp.asarray(K), (64, 64),
            jnp.asarray(pts), gs)
    got = unproject.unproject_features(_t(feats), _t(rcam), _t(K), (64, 64),
                                       _t(pts), gs).numpy()
    ref_xla = np.asarray(xla_unproject(*args))
    ref_pallas = np.asarray(unproject_features_pallas(*args, tile=128))
    assert got.shape == (b, v) + gs + (c,)
    assert (got != 0).mean() > 0.2 and (got == 0).mean() > 0.05
    np.testing.assert_allclose(got, ref_xla, atol=1e-5)
    np.testing.assert_allclose(got, ref_pallas, atol=1e-5)


@pytest.mark.parametrize("fh,fw", [(8, 1), (1, 1), (8, 2), (5, 7)])
def test_bilinear_gather_bwd_matches_pallas_grad(fh, fw):
    """Plain backward (direct, and through the autograd Function) vs
    jax.grad of the Pallas bilinear_gather (its _bwd_rule -> _bwd_kernel)
    in interpret mode, and torch.autograd through the plain forward."""
    rng = np.random.RandomState(fh * 10 + fw + 1)
    bv, c, n = 4, 3, 64
    feats = rng.randn(bv, fh * fw, c).astype(np.float32)
    x, y = _coords(rng, bv, n, fh, fw)
    gout = rng.randn(bv, n, c).astype(np.float32)

    def loss(f):
        return jnp.sum(jax_gather(f, jnp.asarray(x), jnp.asarray(y), fh, fw,
                                  128) * jnp.asarray(gout))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(feats)))
    direct = P.bilinear_gather_bwd(_t(gout), _t(x), _t(y), fh, fw,
                                   torch.float32).numpy()
    f = _t(feats).requires_grad_()
    unproject.bilinear_gather(f, _t(x), _t(y), fh, fw).backward(_t(gout))
    f2 = _t(feats).requires_grad_()
    (P.bilinear_gather(f2, _t(x), _t(y), fh, fw) * _t(gout)).sum().backward()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(direct, ref, atol=1e-5)
    np.testing.assert_array_equal(f.grad.numpy(), direct)
    np.testing.assert_allclose(f2.grad.numpy(), direct, atol=1e-5)


def test_bilinear_gather_bfloat16_rounds_once():
    """bfloat16 features: the taps are summed in float32 and rounded once
    (the Pallas kernel's rule), and the gradient comes back in bfloat16,
    the float32 sum rounded once."""
    rng = np.random.RandomState(9)
    bv, c, n, fh, fw = 4, 8, 128, 6, 6
    feats = torch.from_numpy(rng.randn(bv, fh * fw, c).astype(
        np.float32)).bfloat16()
    x, y = _coords(rng, bv, n, fh, fw)
    got = unproject.bilinear_gather(feats, _t(x), _t(y), fh, fw)
    assert got.dtype == torch.bfloat16
    exact = P.bilinear_gather(feats.float(), _t(x), _t(y), fh, fw)
    assert torch.equal(got, exact.bfloat16())
    g = torch.from_numpy(rng.randn(bv, n, c).astype(np.float32)).bfloat16()
    f = feats.clone().requires_grad_()
    unproject.bilinear_gather(f, _t(x), _t(y), fh, fw).backward(g)
    assert f.grad.dtype == torch.bfloat16
    want = P.bilinear_gather_bwd(g, _t(x), _t(y), fh, fw, torch.float32)
    assert torch.equal(f.grad, want.bfloat16())


# ---------------------------------------------------------------------------
# GridFusion modes, ConvLSTM3D, DepthCollapse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v", [2, 3])
@pytest.mark.parametrize("mode", ["add", "mean", "ident", "lstm3d"])
def test_grid_fusion_matches_flax(mode, v):
    """GridFusion on per-view grids [B, V, X, Y, Z, C] (the JAX module's
    unfused input). The port's ident reads the fused kernel's relu'd
    view-concatenated layout; add, mean and lstm3d read one grid per
    view."""
    rng = np.random.RandomState(v * 7 + len(mode))
    b, c, n = 2, 4, 4
    x = rng.randn(b, v, n, n, n, c).astype(np.float32)
    jmod = jfusion.GridFusion(mode, c, v)
    var = (_flax_vars(jmod, jnp.asarray(x), seed=v) if mode != "mean"
           else {})
    ref = np.asarray(jmod.apply(var, jnp.asarray(x)))
    mod = fusion.GridFusion(c, v, mode)
    if mode != "mean":
        _load(mod, var)
    assert (mode == "mean") == (not list(mod.parameters()))
    if mode == "ident":
        inp = np.maximum(x.transpose(0, 2, 3, 4, 1, 5).reshape(
            b, n, n, n, v * c), 0)
        inp = _t(inp).permute(0, 4, 1, 2, 3)
    else:
        inp = _t(x).permute(0, 1, 5, 2, 3, 4)
    with torch.no_grad():
        got = mod(inp).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == ref.shape == (b, n, n, n, c)
    np.testing.assert_allclose(got, ref, **TOL)


def test_convlstm3d_matches_flax():
    """The scanned ConvLSTM3D over V = 3 views with C != F, so the [x, h]
    concat order, the (j, i, f, o) gate order and forget_bias 1 are each
    pinned (a swap of any changes the output)."""
    rng = np.random.RandomState(3)
    b, v, n, c, filters = 1, 3, 5, 3, 4
    x = rng.randn(b, v, n, n, n, c).astype(np.float32)
    jmod = jfusion.ConvLSTM3D(filters)
    var = _flax_vars(jmod, jnp.asarray(x), seed=4)
    assert var["params"]["cell"]["lstm_gates"]["kernel"].shape == (
        3, 3, 3, c + filters, 4 * filters)
    ref = np.asarray(jmod.apply(var, jnp.asarray(x)))
    mod = _load(fusion.ConvLSTM3D(c, filters), var)
    with torch.no_grad():
        got = mod(_t(x).permute(0, 1, 5, 2, 3, 4)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # without the forget bias the last state differs: the test sees it
    mod.cell.forget_bias = 0.0
    with torch.no_grad():
        off = mod(_t(x).permute(0, 1, 5, 2, 3, 4)).permute(0, 2, 3, 4, 1)
    assert np.abs(off.numpy() - ref).max() > 1e-2


@pytest.mark.parametrize("mode", ["conv3d", "add"])
def test_depth_collapse_modes_match_flax(mode):
    """Both collapses: conv3d's depthwise + pointwise stack and, for every
    other mode, the 1x1 conv over the samples (kernel [1, 1, D, 1],
    shared across channels) with a BatchNorm of one feature."""
    rng = np.random.RandomState(len(mode))
    b, d, s, c = 2, 5, 6, 4
    x = rng.randn(b, d, s, s, c).astype(np.float32)
    jmod = jfusion.DepthCollapse(mode, c, d)
    var = _flax_vars(jmod, jnp.asarray(x))
    ref = np.asarray(jmod.apply(var, jnp.asarray(x)))
    mod = _load(fusion.DepthCollapse(c, d, mode), var)
    with torch.no_grad():
        got = mod(_t(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


# ---------------------------------------------------------------------------
# transformer fusion
# ---------------------------------------------------------------------------

def test_positional_encoding_3d_matches():
    rng = np.random.RandomState(0)
    pos = rng.uniform(-5, 5, (2, 30, 3)).astype(np.float32)
    for d in (24, 72):
        got = xf.positional_encoding_3d(_t(pos), d).numpy()
        ref = np.asarray(jxf.positional_encoding_3d(jnp.asarray(pos), d))
        np.testing.assert_allclose(got, ref, atol=1e-5)
    with pytest.raises(ValueError):
        xf.positional_encoding_3d(_t(pos), 15)        # 15 / 3 is odd


def test_encoder_layer_matches_flax():
    """Post-LN encoder layer: flax MultiHeadDotProductAttention (head-split
    query/key/value kernels, merged out kernel), LayerNorm eps 1e-6, ReLU
    FFN; deterministic."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 10, 24).astype(np.float32)
    jmod = jxf.EncoderLayer(24, 4, 32)
    var = _flax_vars(jmod, jnp.asarray(x))
    ref = np.asarray(jmod.apply(var, jnp.asarray(x)))
    mod = _load(xf.EncoderLayer(24, 4, 32), var)
    with torch.no_grad():
        got = mod(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("faithful", [False, True],
                         ids=["row_major", "faithful_output"])
def test_view_fusion_transformer_matches_flax(faithful):
    """The whole stack, deterministic: scaled tokens + 3-axis PE, 2 layers,
    the token-axis projection to T^2 and the [T, T] map (transposed when
    faithful_output)."""
    rng = np.random.RandomState(2)
    b, n, d, t = 2, 18, 24, 3
    tokens = rng.randn(b, n, d).astype(np.float32)
    pos = rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)
    jmod = jxf.ViewFusionTransformer(2, d, 4, 32, t, 0.1,
                                     faithful_output=faithful)
    var = _flax_vars(jmod, jnp.asarray(tokens), jnp.asarray(pos))
    ref = np.asarray(jmod.apply(var, jnp.asarray(tokens), jnp.asarray(pos)))
    mod = _load(xf.ViewFusionTransformer(2, d, 4, 32, t, n, 0.1,
                                         faithful_output=faithful), var)
    with torch.no_grad():
        got = mod(_t(tokens), _t(pos)).numpy()
    assert got.shape == ref.shape == (b, t, t, d)
    np.testing.assert_allclose(got, ref, **TOL)


def test_dropout_follows_flax():
    """Dropout keeps with probability 1 - rate and scales the kept values
    by 1 / (1 - rate); it draws only from the generator it is given, so
    the same seed gives the same mask."""
    x = torch.ones(4000)
    a = xf.dropout(x, 0.25, torch.Generator().manual_seed(3))
    b = xf.dropout(x, 0.25, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert xf.dropout(x, 0.25, None) is x


@pytest.mark.parametrize("faithful", [False, True],
                         ids=["own_ray", "faithful_pairing"])
def test_unproject_rays_matches(faithful):
    """World positions and token order of the depth-conditioned lift, each
    token with its own ray, or the reference's feature-scale rays and
    transposed pairing; samples != 1 is refused."""
    rng = np.random.RandomState(int(faithful))
    b, v, s, c = 2, 2, 4, 3
    feats = rng.randn(b, v, s, s, c).astype(np.float32)
    rcam = _poses(rng, b, v)
    K = np.stack([simple_K(), simple_K(f=70.0, c=30.0)])
    depth = rng.uniform(1.0, 5.0, (b, v, s, s)).astype(np.float32)
    got_p, got_t = P.unproject_rays(_t(feats), _t(rcam), _t(K), _t(depth),
                                    (64, 64), faithful_pairing=faithful)
    ref_p, ref_t = jax_rays(jnp.asarray(feats), jnp.asarray(rcam),
                            jnp.asarray(K), jnp.asarray(depth), (64, 64),
                            faithful_pairing=faithful)
    assert got_p.shape == (b, v * s * s, 3)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    with pytest.raises(ValueError, match="samples"):
        P.unproject_rays(_t(feats), _t(rcam), _t(K), _t(depth), (64, 64),
                         samples=2)
