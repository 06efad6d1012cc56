"""The whole slice: the port's MaskRCNN (models/detector.py) and engine
(compat/model.py) against the JAX package's MaskRCNN.apply and engine on
CPU, with the same converted weights. On CPU the JAX detector takes its
plain XLA geometry (detector.py:331-332) and the port its plain torch
versions; the Pallas/CUDA kernels are held to those elsewhere.

Tolerances: float32 through two conv backends (XLA vs oneDNN) drifts
~1e-5 relative after the backbone, so tensors are held at 1e-4 (scaled
by their magnitude). Through top-k and NMS such drift can swap a tail
detection, so engine results are held to the bar of
tests/test_fullgraph_parity.py: counts within one, matched detections
(class and IoU >= 0.9) with scores within 0.02 and mask IoU > 0.85, and
at most one unmatched.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.compat.model import (  # noqa: E402
    MaskRCNN as JaxEngine)
from mulit_view_object_detection_tpu.eval.metrics import (  # noqa: E402
    greedy_box_matches)
from mulit_view_object_detection_tpu.models.detector import (  # noqa: E402
    MaskRCNN as JaxMaskRCNN)
from mulit_view_object_detection_tpu.train.step import TrainState  # noqa: E402
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.config import (  # noqa: E402
    Config, check_supported)
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as TorchMaskRCNN)
from mulit_view_object_detection_torch.ops.anchors import get_anchors  # noqa: E402
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch)
from tests.test_torch_convert import random_variables  # noqa: E402
from tests.test_torch_projection import _poses  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SliceConfig(Config):
    """The main path at test size: 2 views, 128^2, ResNet-50 with the
    fork's 5-block stage 4, conv3d fusion on an 8^3 grid."""
    NAME = "torch_slice"
    NUM_CLASSES = 4
    NUM_VIEWS = 2
    BACKBONE = "resnet50"
    RESNET50_STAGE4_BLOCKS = 5
    TOP_DOWN_PYRAMID_SIZE = 16
    FPN_CLASSIF_FC_LAYERS_SIZE = 32
    IMAGE_MIN_DIM = 128
    IMAGE_MAX_DIM = 128
    RPN_ANCHOR_SCALES = (16, 32, 64, 128, 256)
    PRE_NMS_LIMIT = 256
    POST_NMS_ROIS_INFERENCE = 24
    DETECTION_MAX_INSTANCES = 8
    DETECTION_MIN_CONFIDENCE = 0.0
    nvox = 8
    nvox_z = 8
    vmin, vmax = -2.0, 2.0
    vmin_z, vmax_z = 1.0, 5.0
    samples = 4


class AllLevels(SliceConfig):
    # project P2/P3 too: at 128^2 every ROI routes to P2/P3, so with the
    # faithful zeroed levels the heads would see only zeros
    ZERO_PG_LEVELS = ()


def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    hw, v = cfg.IMAGE_MAX_DIM, cfg.NUM_VIEWS
    images = rng.randint(0, 256, (1, v, hw, hw, 3)).astype(np.uint8)
    rcam = _poses(rng, 1, v)
    kmat = np.array([[[hw, 0, hw / 2], [0, hw, hw / 2], [0, 0, 1]]],
                    np.float32)
    return images, rcam, kmat


def _batch(cfg, images, rcam, kmat):
    hw = cfg.IMAGE_MAX_DIM
    meta = np.zeros((1, cfg.IMAGE_META_SIZE), np.float32)
    meta[:, 1:4] = meta[:, 4:7] = [hw, hw, 3]
    meta[:, 7:11] = [0, 0, hw, hw]
    return {
        "images": images.astype(np.float32) - np.float32(cfg.MEAN_PIXEL),
        "image_meta": meta,
        "anchors": get_anchors(cfg, (hw, hw)),
        "Rcam": rcam, "Kmat": kmat,
    }


def _close(got, ref, err):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale,
                               rtol=1e-4, atol=1e-4, err_msg=err)


def _run_both(cfg, seed=0):
    variables = random_variables(cfg, seed=seed)
    images, rcam, kmat = _inputs(cfg, seed)
    batch = _batch(cfg, images, rcam, kmat)
    ref = jax.jit(lambda v, b: JaxMaskRCNN(cfg).apply(v, b))(
        variables, {k: jnp.asarray(a) for k, a in batch.items()})
    model = TorchMaskRCNN(cfg).eval()
    model.load_state_dict(flax_to_torch(variables), strict=True)
    got = model({k: torch.from_numpy(np.asarray(a))
                 for k, a in batch.items()})
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in ref.items()})


@pytest.mark.parametrize("cfg_cls", [AllLevels, SliceConfig],
                         ids=["all_levels", "zeroed_p2_p3"])
def test_slice_matches_jax(cfg_cls):
    """Every output of MaskRCNN.apply. With P2/P3 zeroed (the faithful
    default) the RPN's constant-folded levels make most anchors exact
    score ties, so equal proposals pin the tie order."""
    got, ref = _run_both(cfg_cls())
    for key in ("rpn_class_logits", "rpn_probs", "rpn_bbox", "proposals",
                "mrcnn_class_logits", "mrcnn_probs", "mrcnn_bbox",
                "detections", "mrcnn_masks"):
        assert got[key].shape == ref[key].shape, key
        _close(got[key], ref[key], key)
    if cfg_cls is AllLevels:
        assert (got["detections"][0, :, 4] > 0).sum() >= 3   # has signal


@pytest.mark.parametrize("views,vanilla", [(1, False), (2, True)],
                         ids=["single_view", "vanilla"])
def test_single_view_and_vanilla_match_jax(views, vanilla):
    class C(SliceConfig):
        NUM_VIEWS = views
        VANILLA = vanilla
        IMAGE_MIN_DIM = IMAGE_MAX_DIM = 64
        RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    got, ref = _run_both(C(), seed=1)
    for key in ("rpn_probs", "proposals", "detections", "mrcnn_masks"):
        _close(got[key], ref[key], key)


BF16_EPS = 2.0 ** -8         # bfloat16's relative rounding step


def _jax_stages(cfg, variables, batch):
    """MaskRCNN.apply's outputs plus its backbone, FPN, fusion and
    collapse outputs (flax capture_intermediates), as float32 numpy."""
    out, state = jax.jit(lambda v, b: JaxMaskRCNN(cfg).apply(
        v, b, capture_intermediates=True, mutable=["intermediates"]))(
            variables, {k: jnp.asarray(a) for k, a in batch.items()})
    inter = state["intermediates"]
    st = {f"C{i + 1}": c for i, c in enumerate(inter["backbone"]["__call__"][0])}
    st.update({f"P{i + 2}": p
               for i, p in enumerate(inter["fpn"]["__call__"][0])})
    st.update({k: m["__call__"][0] for k, m in inter.items()
               if k.startswith(("grid_fusion", "depth_collapse"))})
    st.update(out)
    return {k: np.asarray(v, np.float32) for k, v in st.items()}


def _torch_stages(model, batch):
    """The same stages of the port's MaskRCNN, channels-last like the JAX
    module's, in the dtype they were computed in."""
    st = {}

    def hook(name):
        def fn(mod, args, out):
            if name == "backbone":
                st.update({f"C{i + 1}": c.movedim(1, -1)
                           for i, c in enumerate(out)})
            elif name == "fpn":
                st.update({f"P{i + 2}": p.movedim(1, -1)
                           for i, p in enumerate(out)})
            else:
                st[name] = out.movedim(1, -1)
        return fn

    hooks = [mod.register_forward_hook(hook(name))
             for name, mod in model.named_children()
             if name in ("backbone", "fpn")
             or name.startswith(("grid_fusion", "depth_collapse"))]
    try:
        st.update(model({k: torch.from_numpy(np.asarray(a))
                         for k, a in batch.items()}))
    finally:
        for h in hooks:
            h.remove()
    return st


def test_bfloat16_compute_dtype():
    """COMPUTE_DTYPE="bfloat16" against the JAX module in bfloat16, same
    weights, at the slice's test size. The dtype policy is flax's: every
    parameter stays float32 and the convs compute in bf16 (weights and
    activations cast at use), BatchNorm keeps float32 parameters and
    statistics and normalises in float32, scores, boxes and masks come
    out float32.

    Tolerances, in bf16 rounding steps (2^-8 relative): two conv backends
    accumulate in another order and round at slightly other points (flax
    rounds the conv, then adds the bf16 bias), so single elements differ
    by an ulp, and ~60 layers of random weights compound that. Every stage
    is held to 10 steps of its largest magnitude, one step on average.
    That bound alone would also pass a float32 run, so the stem (one conv,
    one BN, ReLU, max-pool) must agree bit for bit in >= 70% of elements:
    it does in ~77%, while a float32 stem agrees in <1% and bf16 BN
    parameters drop it to ~61% (measured at this seed). The softmaxes and
    the mask sigmoid run in float32 on both sides, so at most 5% of their
    values may be bf16-representable (~1% in the JAX module; all of them
    if they ran in bf16)."""
    cfg = SliceConfig()
    cfg.COMPUTE_DTYPE = "bfloat16"
    variables = random_variables(cfg, seed=3)
    batch = _batch(cfg, *_inputs(cfg, seed=3))
    ref = _jax_stages(cfg, variables, batch)
    model = TorchMaskRCNN(cfg).eval()
    model.load_state_dict(flax_to_torch(variables), strict=True)
    got = _torch_stages(model, batch)

    for conv in (model.backbone.conv1, model.grid_fusion_p4.down1):
        assert conv.weight.dtype == torch.float32
        assert conv.compute_dtype == torch.bfloat16
    for bn in (model.backbone.bn_conv1, model.grid_fusion_p4.bn1):
        for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            assert t.dtype == torch.float32
    stages = ["C1", "C2", "C3", "C4", "C5", "P4", "P5", "P6"] + [
        f"{m}_p{i}" for m in ("grid_fusion", "depth_collapse")
        for i in (4, 5, 6)]
    for key in stages:
        assert got[key].dtype == torch.bfloat16, key
        g, r = got[key].float().numpy(), ref[key]
        assert g.shape == r.shape, key
        err = np.abs(g - r) / np.abs(r).max()
        assert err.max() <= 10 * BF16_EPS, (key, err.max())
        assert err.mean() <= BF16_EPS, (key, err.mean())
    stem_equal = (got["C1"].float().numpy() == ref["C1"]).mean()
    assert stem_equal >= 0.7, stem_equal

    for key in ("rpn_class_logits", "rpn_probs", "mrcnn_probs",
                "detections", "mrcnn_masks"):
        assert got[key].dtype == torch.float32, key
        assert torch.isfinite(got[key]).all(), key
        g, r = got[key].numpy(), ref[key]
        scale = max(1.0, float(np.abs(r).max()))
        err = np.abs(g - r) / scale
        assert err.mean() <= BF16_EPS, (key, err.mean())
        if key != "rpn_probs":       # softmax of logits a few ulps apart
            assert err.max() <= 10 * BF16_EPS, (key, err.max())
    for key in ("rpn_probs", "mrcnn_probs", "mrcnn_masks"):
        g = got[key]
        assert (g.bfloat16().float() == g).float().mean() <= 0.05, key


def test_engine_detect_matches_jax_engine(tmp_path):
    """compat.MaskRCNN.detect (mold -> model -> unmold) vs the JAX
    engine's detect on the same uint8 views and poses."""
    cfg = AllLevels()
    variables = random_variables(cfg, seed=2)
    images, rcam, kmat = _inputs(cfg, seed=2)

    jeng = JaxEngine("inference", cfg, str(tmp_path))
    jeng._state = TrainState(step=0, params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=None, tx=None,
                             apply_fn=jeng.model.apply)
    ref = jeng.detect([images[0]], rcam, kmat)[0]
    eng = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
    eng.load_flax_variables(variables)
    got = eng.detect([images[0]], rcam, kmat)[0]

    n_ref = len(ref["class_ids"])
    assert n_ref >= 3
    assert abs(n_ref - len(got["class_ids"])) <= 1
    matches = greedy_box_matches(
        np.asarray(ref["rois"], np.float32), ref["class_ids"],
        np.asarray(got["rois"], np.float32), got["class_ids"],
        iou_threshold=0.9)
    assert len(matches) >= n_ref - 1
    for ri, gi, _ in matches:
        assert abs(float(got["scores"][gi]) - float(ref["scores"][ri])) < 0.02
        a, b = ref["masks"][..., ri], got["masks"][..., gi]
        union = np.logical_or(a, b).sum()
        if union:
            assert np.logical_and(a, b).sum() / union > 0.85
    assert got["masks"].shape[:2] == images.shape[2:4]


def test_engine_refuses_what_it_cannot_run(tmp_path):
    """No fallback hides the device: the engine defaults to the card, and
    device='cuda' without CUDA raises; the TPU-only lowerings are
    refused, not approximated, and so is a GRID_REAS that no GridFusion
    mode has; the serving options (FOLD_BN, UINT8_IMAGE_TRANSFER,
    EXPOSE_FUSED_PYRAMID), the training options (TRAIN_BN,
    BN_EVAL_BATCH_STATS, REMAT, TRILINEAR_REPROJECTION) and VIEW_SHARDING
    (read by nothing, as in the JAX package: view sharding is the
    mesh's, parallel/mesh.py) are accepted."""
    cfg = SliceConfig()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            MaskRCNN("inference", cfg, str(tmp_path))
        with pytest.raises(RuntimeError, match="cuda"):
            MaskRCNN("training", cfg, str(tmp_path), device="cuda")
    with pytest.raises(ValueError, match="mode"):
        MaskRCNN("serving", cfg, str(tmp_path), device="cpu")
    for flag in ("PHASE_DECONV", "ZFOLD_FUSION", "STEM_S2D",
                 "CROSS_LEVEL_FUSION", "LSTM_HOIST_INPUT"):
        bad = SliceConfig()
        setattr(bad, flag, True)
        with pytest.raises(ValueError, match=flag):
            check_supported(bad)
    # the serving and training options and view sharding are ported
    for flag in ("FOLD_BN", "UINT8_IMAGE_TRANSFER", "EXPOSE_FUSED_PYRAMID",
                 "TRAIN_BN", "BN_EVAL_BATCH_STATS", "REMAT",
                 "TRILINEAR_REPROJECTION", "VIEW_SHARDING"):
        ok = SliceConfig()
        setattr(ok, flag, True)
        check_supported(ok)
    bad = SliceConfig()
    bad.GRID_REAS = "transformer"
    with pytest.raises(ValueError, match="GRID_REAS"):
        check_supported(bad)


class TrainingSlice(AllLevels):
    POST_NMS_ROIS_TRAINING = 32
    TRAIN_ROIS_PER_IMAGE = 8
    MAX_GT_INSTANCES = 4
    RPN_TRAIN_ANCHORS_PER_IMAGE = 64
    STEPS_PER_EPOCH = 1


def test_engine_trains(tmp_path, capsys):
    """The engine in training mode takes a step on the CPU: finite
    losses printed for the epoch, float32 parameters that moved, and a
    checkpoint of step 1 (the whole step is held to the JAX package in
    tests/test_torch_train.py)."""
    from mulit_view_object_detection_torch.data.synthetic import (
        SyntheticMultiViewDataset)
    cfg = TrainingSlice()
    ds = SyntheticMultiViewDataset(num_scenes=1, num_views=2, image_size=128,
                                   num_classes=cfg.NUM_CLASSES, seed=3)
    eng = MaskRCNN("training", cfg, str(tmp_path), device="cpu")
    before = eng.model.mask_head.mrcnn_mask.weight.detach().clone()
    eng.train(ds, None, 0.01, 1, "all", prefetch_threads=1)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("epoch 1:")][0]
    losses = dict(kv.split("=") for kv in line.split()[2:])
    assert set(losses) >= {"loss", "rpn_class_loss", "mrcnn_mask_loss"}
    assert all(np.isfinite(float(v)) for v in losses.values()), line
    w = eng.model.mask_head.mrcnn_mask.weight
    assert w.dtype == torch.float32 and not torch.equal(w, before)
    assert eng.epoch == 1 and os.path.isdir(
        os.path.join(eng.checkpoint_dir, "1"))


def test_seeded_init_is_deterministic():
    cfg = SliceConfig()
    a = TorchMaskRCNN(cfg)
    b = TorchMaskRCNN(cfg)
    a.init_weights(torch.Generator().manual_seed(7))
    b.init_weights(torch.Generator().manual_seed(7))
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    w = a.backbone.conv1.weight
    assert 0.5 < float(w.detach().std() * (3 * 7 * 7) ** 0.5) < 1.5


def test_port_imports_no_jax():
    """Importing the port (package, engine, models, kernels, training,
    data) leaves jax and flax out of sys.modules."""
    code = ("import sys\n"
            "import mulit_view_object_detection_torch\n"
            "import mulit_view_object_detection_torch.compat\n"
            "import mulit_view_object_detection_torch.compat.model\n"
            "import mulit_view_object_detection_torch.models.detector\n"
            "import mulit_view_object_detection_torch.kernels.unproject\n"
            "import mulit_view_object_detection_torch.kernels.reproject\n"
            "import mulit_view_object_detection_torch.utils.convert\n"
            "import mulit_view_object_detection_torch.train.step\n"
            "import mulit_view_object_detection_torch.train.checkpoint\n"
            "import mulit_view_object_detection_torch.data.generator\n"
            "import mulit_view_object_detection_torch.data.synthetic\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', "
            "'mulit_view_object_detection_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
