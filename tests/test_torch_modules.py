"""The port's nn.Modules against the JAX package's flax modules, with the
same (converted) weights: backbone C2-C5, FPN P2-P6, the conv3d
GridFusion U-Net, DepthCollapse, RPN and the two heads, plus the flax
SAME padding rules they depend on.

Tolerance: float32 on CPU through two conv backends (XLA vs oneDNN) that
sum in different orders; relative drift grows with depth, so outputs are
held at rtol 1e-4 / atol 1e-4 of their O(1) scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.models import fpn as jfpn  # noqa: E402
from mulit_view_object_detection_tpu.models import fusion as jfusion  # noqa: E402
from mulit_view_object_detection_tpu.models import heads as jheads  # noqa: E402
from mulit_view_object_detection_tpu.models import resnet as jresnet  # noqa: E402
from mulit_view_object_detection_tpu.models import rpn as jrpn  # noqa: E402
from mulit_view_object_detection_torch.models import (  # noqa: E402
    fpn, fusion, heads, resnet, rpn)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch)
from tests.test_torch_convert import random_like  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _flax_vars(module, *args, seed=0):
    return random_like(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args)), seed)


def _load(torch_module, variables):
    torch_module.load_state_dict(flax_to_torch(variables), strict=True)
    return torch_module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.mark.parametrize("n", [7, 8])
def test_same_padding_rules(n):
    """flax SAME stride-2 conv pads (0, 1) on even inputs (torch's
    padding=1 pads (1, 1)), and the SAME 3x3/2 max-pool pads with -inf:
    both pinned against flax in 2D and 3D."""
    rng = np.random.RandomState(n)
    x2 = rng.randn(1, n, n + 1, 3).astype(np.float32)
    x3 = rng.randn(1, n, n - 1, n, 2).astype(np.float32)
    for x, ks in ((x2, (3, 3)), (x3, (3, 3, 3))):
        mod = fnn.Conv(4, ks, strides=2, padding="SAME")
        v = _flax_vars(mod, jnp.asarray(x))
        ref = np.asarray(mod.apply(v, jnp.asarray(x)))
        conv = (torch.nn.Conv2d if len(ks) == 2 else torch.nn.Conv3d)(
            x.shape[-1], 4, 3, stride=2)
        sd = flax_to_torch({"params": {"c": v["params"]}})
        conv.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
        got = conv(resnet.pad_same(_nchw(x), ks, (2,) * len(ks)))
        np.testing.assert_allclose(_nhwc(got), ref, atol=1e-5)
    ref = np.asarray(fnn.max_pool(jnp.asarray(x2), (3, 3), strides=(2, 2),
                                  padding="SAME"))
    got = torch.nn.functional.max_pool2d(
        resnet.pad_same(_nchw(x2) - 10.0, (3, 3), (2, 2), float("-inf")),
        3, 2) + 10.0
    np.testing.assert_allclose(_nhwc(got), ref, atol=1e-5)


def test_backbone_and_fpn_match():
    """ResNet-50 with the 5-block stage 4 (C1-C5) and the post-relu FPN
    (P2-P6) on a 64^2 input, two images folded in the batch axis."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jnet = jresnet.ResNet("resnet50", stage4_blocks=5)
    v = _flax_vars(jnet, jnp.asarray(x))
    refs = jnet.apply(v, jnp.asarray(x))
    net = _load(resnet.ResNet("resnet50", stage4_blocks=5), v)
    with torch.no_grad():
        outs = net(_nchw(x))
    for i, (o, r) in enumerate(zip(outs, refs)):
        r = np.asarray(r)
        scale = max(1.0, np.abs(r).max())
        np.testing.assert_allclose(_nhwc(o) / scale, r / scale, **TOL,
                                   err_msg=f"C{i + 1}")

    cs = [np.asarray(r) for r in refs[1:]]
    jf = jfpn.FPN(8, post_relu=True)
    vf = _flax_vars(jf, *map(jnp.asarray, cs), seed=1)
    prefs = jf.apply(vf, *map(jnp.asarray, cs))
    f = _load(fpn.FPN(8, post_relu=True), vf)
    with torch.no_grad():
        ps = f(*[_nchw(c) for c in cs])
    for i, (p, r) in enumerate(zip(ps, prefs)):
        np.testing.assert_allclose(_nhwc(p), np.asarray(r), **TOL,
                                   err_msg=f"P{i + 2}")


@pytest.mark.parametrize("nvox", [4, 8])
def test_grid_fusion_conv3d_matches(nvox):
    """The conv3d U-Net (SAME stride-2 downs, SAME ConvTranspose ups, skip
    concat [deconv1, conv1]) on the kernel's view-concatenated grid."""
    rng = np.random.RandomState(nvox)
    c, v = 4, 2
    x = np.maximum(rng.randn(1, nvox, nvox, nvox, v * c), 0).astype(
        np.float32)
    jmod = jfusion.GridFusion("conv3d", c, v, inputs_fused=True)
    var = _flax_vars(jmod, jnp.asarray(x))
    ref = np.asarray(jmod.apply(var, jnp.asarray(x)))
    mod = _load(fusion.GridFusion(c, v), var)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), ref, **TOL)


def test_depth_collapse_matches():
    rng = np.random.RandomState(3)
    b, d, s, c = 2, 5, 6, 4
    x = rng.randn(b, d, s, s, c).astype(np.float32)
    jmod = jfusion.DepthCollapse("conv3d", c, d)
    var = _flax_vars(jmod, jnp.asarray(x))
    ref = np.asarray(jmod.apply(var, jnp.asarray(x)))
    mod = _load(fusion.DepthCollapse(c, d), var)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(_nhwc(got), ref, **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_rpn_head_matches(stride):
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 7, 6, 8).astype(np.float32)
    jmod = jrpn.RPNHead(3, stride)
    var = _flax_vars(jmod, jnp.asarray(x))
    refs = jmod.apply(var, jnp.asarray(x))
    mod = _load(rpn.RPNHead(8, 3, stride), var)
    with torch.no_grad():
        outs = mod(_nchw(x))
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_heads_match():
    """Classifier (conv-as-FC) and the 128-filter mask head with its
    2x2/2 deconv, on pooled [B, N, S, S, C] features."""
    rng = np.random.RandomState(5)
    c, nc = 8, 4
    pooled = rng.randn(2, 3, 7, 7, c).astype(np.float32)
    jc = jheads.ClassifierHead(nc, 7, 16)
    var = _flax_vars(jc, jnp.asarray(pooled))
    refs = jc.apply(var, jnp.asarray(pooled))
    mod = _load(heads.ClassifierHead(c, nc, 7, 16), var)
    with torch.no_grad():
        outs = mod(torch.from_numpy(pooled))
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)

    pooled_m = rng.randn(2, 3, 14, 14, c).astype(np.float32)
    jm = jheads.MaskHead(nc, 128)
    var = _flax_vars(jm, jnp.asarray(pooled_m), seed=1)
    ref = np.asarray(jm.apply(var, jnp.asarray(pooled_m)))
    mod = _load(heads.MaskHead(c, nc, 128), var)
    with torch.no_grad():
        got = mod(torch.from_numpy(pooled_m)).numpy()
    assert got.shape == (2, 3, 28, 28, nc)
    np.testing.assert_allclose(got, ref, **TOL)


def test_heads_match_executed_reference_golden(tmp_path):
    """The port's pyramid ROI align + heads on the reference's real FPN
    features and seeded weights (tests/fixtures/golden_heads.npz, the
    reference's own executed head graphs), weights through the route h5
    fixture -> the JAX package's h5 importer -> the converter. Tolerances
    as tests/test_golden_heads.py: probs and masks 2e-4, box deltas 2e-3."""
    import os

    from mulit_view_object_detection_tpu.models.detector import (
        MaskRCNN as JaxMaskRCNN, make_dummy_batch)
    from mulit_view_object_detection_tpu.utils.h5_fixture import (
        write_matterport_h5)
    from mulit_view_object_detection_tpu.utils.h5_import import (
        load_h5_weights)
    from mulit_view_object_detection_torch.ops.roi_align import (
        pyramid_roi_align)
    from tests.test_fullgraph_parity import GOLDEN, _config

    fx = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                              "golden_heads.npz"))
    h5 = str(tmp_path / "golden.h5")
    write_matterport_h5(
        h5, num_classes=GOLDEN["num_classes"],
        architecture=GOLDEN["architecture"], top_down=GOLDEN["top_down"],
        fc_size=GOLDEN["fc_size"], mask_filters=GOLDEN["mask_filters"],
        seed=GOLDEN["seed"], init="fanin")
    cfg = _config()
    shapes = jax.eval_shape(lambda: JaxMaskRCNN(cfg).init(
        jax.random.PRNGKey(0), make_dummy_batch(cfg)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   dict(shapes))
    params, stats, _ = load_h5_weights(h5, zeros["params"],
                                       zeros["batch_stats"])

    def sub(name):
        return {"params": {name: params[name]},
                "batch_stats": {name: stats[name]}}

    feats = [torch.from_numpy(fx[n]) for n in
             ("fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5")]
    s = GOLDEN["image_size"]
    rois = torch.from_numpy(fx["rois"])
    cls = heads.ClassifierHead(GOLDEN["top_down"], cfg.NUM_CLASSES,
                               cfg.POOL_SIZE, cfg.FPN_CLASSIF_FC_LAYERS_SIZE)
    cls.load_state_dict({k.split(".", 1)[1]: v for k, v in flax_to_torch(
        sub("classifier_head")).items()}, strict=True)
    mask = heads.MaskHead(GOLDEN["top_down"], cfg.NUM_CLASSES,
                          GOLDEN["mask_filters"])
    mask.load_state_dict({k.split(".", 1)[1]: v for k, v in flax_to_torch(
        sub("mask_head")).items()}, strict=True)
    with torch.no_grad():
        _, probs, bbox = cls.eval()(pyramid_roi_align(
            rois, feats, (s, s), cfg.POOL_SIZE))
        masks = mask.eval()(pyramid_roi_align(rois, feats, (s, s),
                                              cfg.MASK_POOL_SIZE))
    np.testing.assert_allclose(probs.numpy(), fx["probs"], atol=2e-4)
    np.testing.assert_allclose(bbox.numpy(), fx["bbox"], atol=2e-3)
    np.testing.assert_allclose(masks.numpy(), fx["masks"], atol=2e-4)
