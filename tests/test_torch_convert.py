"""Weight bridge flax <-> torch (mulit_view_object_detection_torch/utils/
convert.py) against the JAX package's own variable trees and layers.

Tolerances: the round trip is a pure relayout, so it is bit-exact. Layer
outputs compare float32 on CPU through two conv backends (XLA vs oneDNN),
whose summation orders differ: atol 1e-5 on O(1) values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from mulit_view_object_detection_tpu.config import Config  # noqa: E402
from mulit_view_object_detection_tpu.models.detector import (  # noqa: E402
    MaskRCNN as JaxMaskRCNN, make_dummy_batch)
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN)
from mulit_view_object_detection_torch.models.fusion import (  # noqa: E402
    deconv_same)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)


class TinyMultiView(Config):
    NAME = "torch_port_tiny"
    NUM_CLASSES = 4
    NUM_VIEWS = 2
    BACKBONE = "resnet50"
    RESNET50_STAGE4_BLOCKS = 5
    TOP_DOWN_PYRAMID_SIZE = 8
    FPN_CLASSIF_FC_LAYERS_SIZE = 16
    IMAGE_MIN_DIM = 64
    IMAGE_MAX_DIM = 64
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    PRE_NMS_LIMIT = 128
    POST_NMS_ROIS_INFERENCE = 16
    DETECTION_MAX_INSTANCES = 6
    DETECTION_MIN_CONFIDENCE = 0.0
    nvox = 4
    nvox_z = 4
    vmin, vmax = -2.0, 2.0
    vmin_z, vmax_z = 1.0, 5.0
    samples = 4


def random_like(shapes, seed=0):
    """Seeded numpy values for a flax variable tree of shapes (from
    jax.eval_shape: no init compile). Kernels ~ N(0, 1/fan_in); BatchNorm
    statistics are non-trivial so their mapping is exercised."""
    rng = np.random.RandomState(seed)

    def draw(leaf, s):
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v)
                for k, v in tree.items()}

    return walk(jax.tree_util.tree_map(lambda x: x, dict(shapes)))


def random_variables(config, seed=0):
    """The JAX MaskRCNN's variable tree with seeded random values."""
    batch = make_dummy_batch(config)
    return random_like(jax.eval_shape(lambda: JaxMaskRCNN(config).init(
        {"params": jax.random.PRNGKey(0)}, batch)), seed)


@pytest.fixture(scope="module")
def variables():
    return random_variables(TinyMultiView())


def test_round_trip_is_bit_exact(variables):
    back = torch_to_flax(flax_to_torch(variables))
    a = flatten_dict(variables)
    b = flatten_dict(back)
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))


def test_strict_load_reaches_every_parameter(variables):
    model = MaskRCNN(TinyMultiView())
    sd = flax_to_torch(variables)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), sd[name].numpy(), name)
    # every flax leaf landed in exactly one torch tensor
    n_flax = len(flatten_dict(variables))
    assert n_flax == len(sd)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_conv_transpose_3d_same_pinned(n):
    """flax SAME ConvTranspose 3^3/2 pads the dilated input (2, 1); the
    port's padding=0 torch layer + first-2n slice, with the converter's
    kernel flip, must equal it (also at odd n)."""
    rng = np.random.RandomState(n)
    x = rng.randn(1, n, n + 1, 2, 3).astype(np.float32)
    mod = fnn.ConvTranspose(5, (3, 3, 3), strides=(2, 2, 2), padding="SAME")
    params = {"kernel": rng.randn(3, 3, 3, 3, 5).astype(np.float32),
              "bias": rng.randn(5).astype(np.float32)}
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    layer = torch.nn.ConvTranspose3d(3, 5, 3, stride=2)
    sd = flax_to_torch({"params": {"up1": params}})
    layer.load_state_dict({"weight": sd["up1.weight"],
                           "bias": sd["up1.bias"]})
    got = deconv_same(layer, torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               ref, atol=1e-5)


def _slice3_config(kind):
    """TinyMultiView with each of slice 3's weight trees: the add, ident
    and lstm3d fusions (fuse_bn, ident_conv, the ConvLSTM's gate conv, the
    1x1 depth collapse with its one-feature BN) and the transformer
    (multi-head attention, LayerNorms, Dense layers, token projection)."""
    attrs = {"GRID_REAS": kind}
    if kind == "transformer":
        attrs = {"TRANSFORMER": True, "TOP_DOWN_PYRAMID_SIZE": 12,
                 "XFORMER_D_MODEL": 12, "XFORMER_NUM_HEADS": 2,
                 "XFORMER_DFF": 16, "XFORMER_NUM_LAYERS": 2, "samples": 1}
    return type(f"Tiny_{kind}", (TinyMultiView,), attrs)()


@pytest.mark.parametrize("kind", ["add", "ident", "lstm3d", "transformer"])
def test_slice3_trees_round_trip_and_load_strictly(kind):
    """Each slice 3 tree: every flax leaf lands in exactly one torch
    tensor of the right shape, the model loads it strictly, and the round
    trip back to flax is bit-exact."""
    cfg = _slice3_config(kind)
    variables = random_variables(cfg, seed=1)
    flat = flatten_dict(variables)
    sd = flax_to_torch(variables)
    model = MaskRCNN(cfg)
    assert set(sd) == set(model.state_dict()) and len(sd) == len(flat)
    model.load_state_dict(sd, strict=True)
    back = flatten_dict(torch_to_flax(model.state_dict()))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg="/".join(k))
    leaves = {"/".join(k[1:]) for k in flat}
    expect = {
        "add": ["grid_fusion_p4/fuse_bn/BatchNorm_0/scale",
                "depth_collapse_p4/collapse/kernel",
                "depth_collapse_p4/bn/BatchNorm_0/scale"],
        "ident": ["grid_fusion_p5/ident_conv/kernel"],
        "lstm3d": ["grid_fusion_p6/convlstm/cell/lstm_gates/kernel"],
        "transformer": ["view_transformer/layer1/mha/out/kernel",
                        "view_transformer/layer0/ln2/scale",
                        "view_transformer/token_proj/kernel"]}[kind]
    assert set(expect) <= leaves
    if kind == "lstm3d":
        c = cfg.TOP_DOWN_PYRAMID_SIZE
        assert sd["grid_fusion_p6.convlstm.cell.lstm_gates.weight"].shape == (
            4 * c, 2 * c, 3, 3, 3)
    if kind == "transformer":
        w = sd["view_transformer.layer0.mha.query.weight"]
        assert w.shape == (2, 6, 12)        # [heads, d / heads, d]
        np.testing.assert_array_equal(
            w.numpy(), np.moveaxis(flat[("params", "view_transformer",
                                         "layer0", "mha", "query",
                                         "kernel")], 0, -1))


def test_mask_deconv_matches_tf_keras_golden():
    """The converter's ConvTranspose transform on a REAL tf.keras
    Conv2DTranspose (tests/fixtures/golden_tf.npz), through the h5
    importer's keras->flax kernel transform, reproduces the keras layer."""
    import os
    g = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "golden_tf.npz"))
    kernel = g["deconv_kernel"]                  # keras [kh, kw, out, in]
    flax_kernel = np.transpose(kernel[::-1, ::-1], (0, 1, 3, 2))
    sd = flax_to_torch({"params": {"mrcnn_mask_deconv": {
        "kernel": flax_kernel, "bias": g["deconv_bias"]}}})
    layer = torch.nn.ConvTranspose2d(kernel.shape[3], kernel.shape[2], 2,
                                     stride=2)
    layer.load_state_dict({"weight": sd["mrcnn_mask_deconv.weight"],
                           "bias": sd["mrcnn_mask_deconv.bias"]})
    x = torch.from_numpy(g["deconv_x"]).permute(0, 3, 1, 2)
    got = layer(x).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, g["deconv_expected"], rtol=1e-5,
                               atol=1e-5)


def test_dense_and_grouped_conv_layouts():
    """Dense [in, out] -> Linear [out, in]; a depthwise flax conv kernel
    [1, 1, 1, C] -> torch [C, 1, 1, 1] with groups=C."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 3, 6).astype(np.float32)
    k = rng.randn(1, 1, 1, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    ref = fnn.Conv(6, (1, 1), feature_group_count=6).apply(
        {"params": {"kernel": k, "bias": b}}, jnp.asarray(x))
    sd = flax_to_torch({"params": {"dw1": {"kernel": k, "bias": b}}})
    conv = torch.nn.Conv2d(6, 6, 1, groups=6)
    conv.load_state_dict({"weight": sd["dw1.weight"], "bias": sd["dw1.bias"]})
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-6)

    kd = rng.randn(6, 4).astype(np.float32)
    ref = np.asarray(fnn.Dense(4).apply(
        {"params": {"kernel": kd, "bias": b[:4]}}, jnp.asarray(x)))
    sd = flax_to_torch({"params": {"fc": {"kernel": kd, "bias": b[:4]}}})
    lin = torch.nn.Linear(6, 4)
    lin.load_state_dict({"weight": sd["fc.weight"], "bias": sd["fc.bias"]})
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(),
                               ref, atol=1e-5)
