"""The port's Keras h5 importer (utils/h5_import.py) against the JAX
package's, on h5 files in every layout the JAX importer's own tests
cover: the Matterport backbone and heads (utils/h5_fixture.py's
write_matterport_h5), the multi-view fork's conv3d, add, ident, lstm3d
and transformer inventories (write_h5_from_inventory: 3D convs and their
transposes, depthwise kernels, the fused ConvLSTM kernel, the encoder's
auto-named layers), and hand-written groups for the split ConvLSTM
kernels, a TimeDistributed layer's auto-named inner and an offset
transformer counter.

Each case starts both importers from the same weights (the port model's
seeded init, through utils/convert.py's torch_to_flax) and holds the
port's state_dict exactly equal to the JAX importer's tree converted by
flax_to_torch, and the two reports equal. With the command line's
22-name exclude list too, and through MaskRCNN.load_weights."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
h5py = pytest.importorskip("h5py")

from mulit_view_object_detection_torch.utils.h5_fixture import (  # noqa: E402
    write_h5_from_inventory, write_matterport_h5)
from mulit_view_object_detection_tpu.utils.h5_import import (  # noqa: E402
    load_h5_weights as jax_load_h5_weights)
from mulit_view_object_detection_torch.cli.interior_multi import (  # noqa: E402
    COCO_EXCLUDE)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.config import Config  # noqa: E402
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as TorchMaskRCNN)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)
from mulit_view_object_detection_torch.utils.h5_import import (  # noqa: E402
    load_h5_state_dict)


class MatterportSmall(Config):
    NAME = "h5_matterport"
    NUM_CLASSES = 4
    NUM_VIEWS = 1
    BACKBONE = "resnet50"
    RESNET50_STAGE4_BLOCKS = 5     # res4a + res4b-res4f, as the h5
    TOP_DOWN_PYRAMID_SIZE = 32
    FPN_CLASSIF_FC_LAYERS_SIZE = 64
    IMAGE_MIN_DIM = IMAGE_MAX_DIM = 64
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)


class MultiViewSmall(MatterportSmall):
    NAME = "h5_multiview"
    NUM_VIEWS = 2
    TOP_DOWN_PYRAMID_SIZE = 8
    nvox = nvox_z = 8
    samples = 4


def _model(cfg, seed=0):
    model = TorchMaskRCNN(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _both(h5, state_dict, exclude=None):
    """(port state_dict, port report) after checking them against the
    JAX importer from the same start."""
    got, report = load_h5_state_dict(h5, state_dict, exclude=exclude)
    start = torch_to_flax(state_dict)
    params, stats, ref_report = jax_load_h5_weights(
        h5, start["params"], start["batch_stats"], exclude=exclude)
    ref = flax_to_torch({"params": params, "batch_stats": stats})
    assert set(got) == set(ref) == set(state_dict)
    for name, t in got.items():
        assert t.dtype == torch.float32
        assert torch.equal(t, ref[name]), name
    assert report == ref_report
    return got, report


def _changed(before, after):
    return {k for k in before if not torch.equal(before[k], after[k])}


def _matterport_h5(path, cfg):
    write_matterport_h5(path, num_classes=cfg.NUM_CLASSES,
                        architecture="resnet50",
                        top_down=cfg.TOP_DOWN_PYRAMID_SIZE,
                        fc_size=cfg.FPN_CLASSIF_FC_LAYERS_SIZE)


@pytest.fixture(scope="module")
def matterport(tmp_path_factory):
    cfg = MatterportSmall()
    path = str(tmp_path_factory.mktemp("h5") / "matterport.h5")
    _matterport_h5(path, cfg)
    return cfg, path, _model(cfg).state_dict()


def test_matterport_layout_loads_every_parameter(matterport):
    cfg, path, sd = matterport
    got, report = _both(path, sd)
    assert report["loaded"] and not report["excluded"]
    assert not report["skipped"], report["skipped"]
    assert _changed(sd, got) == set(sd)


@pytest.mark.parametrize("exclude", [COCO_EXCLUDE, ["rpn_model"],
                                     ["mrcnn_class_logits", "res2a_branch2a"]])
def test_matterport_exclude(matterport, exclude):
    cfg, path, sd = matterport
    got, report = _both(path, sd, exclude=exclude)
    kept = set(sd) - _changed(sd, got)
    assert report["excluded"] and kept
    if exclude is COCO_EXCLUDE:
        assert len(exclude) == 22
        assert {"fpn.fpn_p2.weight", "rpn.rpn_conv_shared.weight",
                "mask_head.mrcnn_mask_deconv.weight",
                "classifier_head.mrcnn_class_logits.bias"} <= kept
        assert "backbone.conv1.weight" not in kept
    if exclude == ["rpn_model"]:
        assert {k for k in kept} == {k for k in sd if k.startswith("rpn.")}


def test_engine_load_weights_h5(matterport, tmp_path):
    cfg, path, sd = matterport
    eng = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
    eng.init_weights(torch.Generator().manual_seed(0))
    eng.epoch = 7
    eng.load_weights(path, by_name=True, exclude=COCO_EXCLUDE)
    want, report = load_h5_state_dict(path, sd, exclude=COCO_EXCLUDE)
    for name, t in eng.model.state_dict().items():
        assert torch.equal(t, want[name]), name
    assert eng.last_h5_report == report
    assert eng.epoch == 7                  # an h5 file carries no epoch


INVENTORIES = ("conv3d", "add", "ident", "lstm3d", "transformer")


def _inventory_case(case):
    if case == "transformer":
        from tools.check_transformer_golden import build_config
        from tools.gen_transformer_golden import GOLDEN_XF, fixture_paths
        return build_config(), fixture_paths()[1], GOLDEN_XF["seed"]
    from tools.check_multiview_golden import build_config
    from tools.gen_multiview_golden import GOLDEN_MV, fixture_paths
    return build_config(case), fixture_paths(case)[1], GOLDEN_MV["seed"]


@pytest.mark.parametrize("case", INVENTORIES)
def test_fork_inventories(case, tmp_path):
    cfg, inventory, seed = _inventory_case(case)
    path = str(tmp_path / f"{case}.h5")
    with open(inventory) as f:
        write_h5_from_inventory(path, json.load(f), seed=seed)
    sd = _model(cfg).state_dict()
    got, report = _both(path, sd)
    changed = _changed(sd, got)
    if case == "conv3d":
        assert any(".up1." in k for k in changed)          # deconvolution
        assert any(".dw1." in k for k in changed)          # depthwise
    if case == "lstm3d":
        assert any("lstm_gates" in k for k in changed)     # fused kernel
    if case == "transformer":
        assert any(k.startswith("view_transformer.") for k in changed)
    assert not report["excluded"]


def _write_groups(path, groups):
    """A keras-2-protocol h5: groups = {saved layer: {inner layer:
    {weight: array}}}."""
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in groups])
        for outer, inners in groups.items():
            g = f.create_group(outer)
            names = []
            for inner, weights in inners.items():
                for wname, arr in weights.items():
                    g.create_dataset(f"{inner}/{wname}:0", data=arr)
                    names.append(f"{inner}/{wname}:0".encode())
            g.attrs["weight_names"] = np.array(names)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def test_split_convlstm_and_timedistributed_inner(tmp_path):
    """Keras-standard ConvLSTM kernel + recurrent_kernel (concatenated on
    the input-channel axis), the reference's fused weights_lstm3d, and the
    depth collapse's TimeDistributed Conv2D saved under its auto-generated
    inner name (mapped by the saved name when it is the only inner)."""
    cfg = type("Lstm", (MultiViewSmall,), {"GRID_REAS": "lstm3d"})()
    sd = _model(cfg).state_dict()
    tree = torch_to_flax(sd)["params"]
    gates = tree["grid_fusion_p4"]["convlstm"]["cell"]["lstm_gates"]
    k = gates["kernel"]
    f = k.shape[-1] // 4
    c = k.shape[-2] - f
    rng = np.random.RandomState(0)
    collapse = tree["depth_collapse_p5"]["collapse"]
    groups = {
        "grid_reas_P4_convlstm3d": {"grid_reas_P4_convlstm3d": {
            "kernel": _rand(rng, *k.shape[:3], c, 4 * f),
            "recurrent_kernel": _rand(rng, *k.shape[:3], f, 4 * f),
            "bias": _rand(rng, 4 * f)}},
        "grid_reas_P5_convlstm3d": {"grid_reas_P5_convlstm3d": {
            "weights_lstm3d": _rand(rng, *k.shape),
            "bias_lstm3d": _rand(rng, 4 * f)}},
        "grid_reas_depth_PG52DConv": {"conv2d_57": {
            "kernel": _rand(rng, *collapse["kernel"].shape),
            "bias": _rand(rng, *collapse["bias"].shape)}},
    }
    path = str(tmp_path / "lstm.h5")
    _write_groups(path, groups)
    got, report = _both(path, sd)
    assert sorted(report["loaded"]) == sorted(
        ["grid_reas_P4_convlstm3d", "grid_reas_P5_convlstm3d", "conv2d_57"])
    split = groups["grid_reas_P4_convlstm3d"]["grid_reas_P4_convlstm3d"]
    fused = np.concatenate([split["kernel"], split["recurrent_kernel"]], -2)
    back = torch_to_flax(got)["params"]
    np.testing.assert_array_equal(
        back["grid_fusion_p4"]["convlstm"]["cell"]["lstm_gates"]["kernel"],
        fused)
    np.testing.assert_array_equal(
        back["depth_collapse_p5"]["collapse"]["kernel"],
        groups["grid_reas_depth_PG52DConv"]["conv2d_57"]["kernel"])


def test_transformer_offset_counters(tmp_path):
    """The encoder's inner layers with keras's session-global counters
    starting at dense_7 / layer_normalization_3: normalised by the group's
    minimum, as in the JAX importer; a wrong-sized one is skipped and
    leaves its tensors untouched."""
    cfg = type("Xf", (MultiViewSmall,), {
        "GRID_REAS": "ident", "TRANSFORMER": True, "samples": 1,
        "TOP_DOWN_PYRAMID_SIZE": 12, "XFORMER_D_MODEL": 12,
        "XFORMER_NUM_HEADS": 2, "XFORMER_DFF": 24, "XFORMER_NUM_LAYERS": 2,
        "XFORMER_TARGET_SIZE": 2})()
    sd = _model(cfg).state_dict()
    root = torch_to_flax(sd)["params"]["view_transformer"]
    d, dff = cfg.XFORMER_D_MODEL, cfg.XFORMER_DFF
    rng = np.random.RandomState(1)
    inner = {}
    for i in range(cfg.XFORMER_NUM_LAYERS):
        for j, (kin, kout) in enumerate(
                [(d, d)] * 4 + [(d, dff), (dff, d)]):
            inner[f"dense_{7 + 6 * i + j}"] = {
                "kernel": _rand(rng, kin, kout), "bias": _rand(rng, kout)}
        for j in range(2):
            inner[f"layer_normalization_{3 + 2 * i + j}"] = {
                "gamma": _rand(rng, d), "beta": _rand(rng, d)}
    proj = root["token_proj"]
    inner[f"dense_{7 + 6 * cfg.XFORMER_NUM_LAYERS}"] = {
        "kernel": _rand(rng, *proj["kernel"].shape),
        "bias": _rand(rng, *proj["bias"].shape)}
    inner["dense_8"]["bias"] = _rand(rng, 3 * d)      # wrong size: skipped
    path = str(tmp_path / "xf.h5")
    _write_groups(path, {"transformer": inner})
    got, report = _both(path, sd)
    assert report["skipped"] == ["dense_8"]
    assert len(report["loaded"]) == len(inner) - 1
    key = [k for k in sd if k.startswith("view_transformer.layer0.mha.key")]
    assert key and all(torch.equal(sd[k], got[k]) for k in key)
    changed = _changed(sd, got)
    assert "view_transformer.token_proj.weight" in changed
    assert "view_transformer.layer1.ln2.weight" in changed
