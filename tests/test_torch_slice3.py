"""Slice 3 of the port as a whole, against the JAX package on CPU: the
projected path with the add, mean, ident and lstm3d fusions and the
transformer fusion, through MaskRCNN.apply and the engines, and one train
step each of lstm3d and the transformer against JAX make_train_step.

Weights: the JAX module's tree with seeded random values
(tests/test_torch_convert.py::random_variables). Random BatchNorm
statistics do not normalise, and without a conv between the views and the
RPN (add, mean) the fused maps reach ~1e3 and the box deltas overflow to
NaN in both packages; so the fusion and collapse BatchNorms get the mean
and the variance of what they normalise on the test's own input
(`calibrated_variables`), as trained statistics would.

The transformer reads P5 without a post-P ReLU or any normalisation
before its first LayerNorm: from 0..255 pixels random weights give tokens
of ~1e3, the first layer's attention softmax saturates to one-hot, and
float32 gradients of its query and key are rounding noise (as are RPN
probabilities of logits of ~1e2). Its tests feed pixels divided by 64
(`PIXEL_SCALE`), so that what is compared is well conditioned.

Tolerances as tests/test_torch_detector.py (tensors 1e-4 of their
magnitude, engine results the bar of tests/test_fullgraph_parity.py) and
tests/test_torch_train.py (losses 1e-4 relative, gradients and updated
parameters 1e-3 of each tensor's largest magnitude).
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

import mulit_view_object_detection_tpu.models.detector as jdetector  # noqa: E402
from mulit_view_object_detection_tpu.compat.model import (  # noqa: E402
    MaskRCNN as JaxEngine)
from mulit_view_object_detection_tpu.data.generator import (  # noqa: E402
    make_batch as jax_make_batch)
from mulit_view_object_detection_tpu.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset as JaxSynthetic)
from mulit_view_object_detection_tpu.eval.metrics import (  # noqa: E402
    greedy_box_matches)
from mulit_view_object_detection_tpu.train.optim import (  # noqa: E402
    make_optimizer as jax_make_optimizer)
from mulit_view_object_detection_tpu.train.step import (  # noqa: E402
    TrainState, make_train_step)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.config import check_supported  # noqa: E402
from mulit_view_object_detection_torch.models import losses as L  # noqa: E402
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as TorchMaskRCNN)
from mulit_view_object_detection_torch.models.resnet import BatchNorm  # noqa: E402
from mulit_view_object_detection_torch.train.optim import (  # noqa: E402
    clip_per_tensor_norm, make_optimizer)
from mulit_view_object_detection_torch.train.step import (  # noqa: E402
    loss_and_grads)
from mulit_view_object_detection_torch.train.trainable import (  # noqa: E402
    trainable_mask)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)
from tests.test_torch_convert import random_variables  # noqa: E402
from tests.test_torch_detector import (  # noqa: E402
    SliceConfig, _batch, _close, _inputs)
from tests.test_torch_train import TrainSlice, _jax_priorities, _t  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIXEL_SCALE = 1 / 64         # molded pixels of the transformer's tests


class ModeSlice(SliceConfig):
    """The slice's test size (2 views, 128^2, ResNet-50 with the 5-block
    stage 4, 8^3 grid, 4 samples) with every level projected, so that the
    heads read fused maps (at 128^2 the ROIs route to P2/P3)."""
    ZERO_PG_LEVELS = ()


class XformerSlice(SliceConfig):
    """The transformer at test size: pyramid and d_model 24 (divisible by
    3, with 24 / 3 even, and by the 4 heads), 2 encoder layers, dff 32,
    one sample; P5 is 4x4, so 32 tokens project to a 4x4 map."""
    NAME = "torch_xformer_slice"
    TRANSFORMER = True
    GRID_REAS = "ident"
    TOP_DOWN_PYRAMID_SIZE = 24
    XFORMER_D_MODEL = 24
    XFORMER_NUM_HEADS = 4
    XFORMER_DFF = 32
    XFORMER_NUM_LAYERS = 2
    samples = 1


def _mode_config(mode):
    return type(f"{mode.capitalize()}Slice", (ModeSlice,),
                {"GRID_REAS": mode})()


def _xformer_config(variant):
    """"faithful": the reference's protocol (every level but P5 zeroed,
    its ray pairing and output transpose); "keep_main": the main view's
    features on the other levels, each token with its own ray."""
    return type(f"Xformer_{variant}", (XformerSlice,), {
        "XFORMER_FAITHFUL_PAIRING": variant == "faithful",
        "XFORMER_KEEP_MAIN_LEVELS": variant == "keep_main"})()


def _depths(cfg, rng, b=1):
    s5 = cfg.IMAGE_MAX_DIM // 32
    return rng.uniform(1.0, 5.0, (b, cfg.NUM_VIEWS, s5, s5)).astype(
        np.float32)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}


def calibrated_variables(cfg, batch, seed=0):
    """random_variables, with each fusion and collapse BatchNorm's mean
    (per channel) and variance (one for the layer) taken from its input
    on `batch`, in order, so each normalises what it is fed."""
    model = TorchMaskRCNN(cfg).eval()
    model.load_state_dict(flax_to_torch(random_variables(cfg, seed)),
                          strict=True)

    def calibrate(mod, args):
        x = args[0].float()
        dims = [d for d in range(x.ndim) if d != 1]
        mod.running_mean.copy_(x.mean(dims))
        mod.running_var.fill_(float(x.var(dims, unbiased=False).mean()))

    hooks = [mod.register_forward_pre_hook(calibrate)
             for name, mod in model.named_modules()
             if isinstance(mod, BatchNorm)
             and name.startswith(("grid_fusion", "depth_collapse"))]
    try:
        with torch.no_grad():
            model(_torch_batch(batch))
    finally:
        for h in hooks:
            h.remove()
    return torch_to_flax(model.state_dict())


def _run_both(cfg, variables, batch):
    ref = jax.jit(lambda v, b: jdetector.MaskRCNN(cfg).apply(v, b))(
        variables, {k: jnp.asarray(a) for k, a in batch.items()})
    model = TorchMaskRCNN(cfg).eval()
    model.load_state_dict(flax_to_torch(variables), strict=True)
    got = model(_torch_batch(batch))
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in ref.items()})


OUTPUTS = ("rpn_class_logits", "rpn_probs", "rpn_bbox", "proposals",
           "mrcnn_class_logits", "mrcnn_probs", "mrcnn_bbox", "detections",
           "mrcnn_masks")


@pytest.mark.parametrize("mode", ["add", "mean", "ident", "lstm3d"])
def test_fusion_modes_match_jax(mode):
    """Every output of MaskRCNN.apply for each fusion mode; the port's
    add, mean and lstm3d read the per-view unprojection, ident the fused
    one, and each collapses with the 1x1 DepthCollapse."""
    cfg = _mode_config(mode)
    batch = _batch(cfg, *_inputs(cfg, seed=4))
    variables = calibrated_variables(cfg, batch, seed=4)
    got, ref = _run_both(cfg, variables, batch)
    for key in OUTPUTS:
        assert got[key].shape == ref[key].shape, key
        _close(got[key], ref[key], key)
    assert (got["detections"][0, :, 4] > 0).sum() >= 3   # has signal


@pytest.mark.parametrize("variant", ["faithful", "keep_main"])
def test_transformer_matches_jax(variant):
    """TRANSFORMER: the FPN without its post-P ReLU, P5's tokens lifted
    by the depths and fused, every other level zeroed (the RPN folds
    levels {0, 1, 2, 4}) or, with XFORMER_KEEP_MAIN_LEVELS, the main
    view's."""
    cfg = _xformer_config(variant)
    rng = np.random.RandomState(5)
    batch = _batch(cfg, *_inputs(cfg, seed=5))
    batch["images"] = batch["images"] * PIXEL_SCALE
    batch["depths"] = _depths(cfg, rng)
    variables = random_variables(cfg, seed=5)
    model = TorchMaskRCNN(cfg)
    assert not model.fpn.post_relu
    assert model.zero_levels == (set() if variant == "keep_main"
                                 else {0, 1, 2, 4})
    got, ref = _run_both(cfg, variables, batch)
    for key in OUTPUTS:
        assert got[key].shape == ref[key].shape, key
        _close(got[key], ref[key], key)


def test_transformer_engine_detect_matches_jax_engine(tmp_path):
    """compat.MaskRCNN.detect with depths vs the JAX engine's detect on
    the same views, poses and depths; without depths the engine raises."""
    cfg = _xformer_config("keep_main")
    variables = random_variables(cfg, seed=6)
    images, rcam, kmat = _inputs(cfg, seed=6)
    depths = _depths(cfg, np.random.RandomState(6))

    jeng = JaxEngine("inference", cfg, str(tmp_path))
    jeng._state = TrainState(step=0, params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=None, tx=None,
                             apply_fn=jeng.model.apply)
    ref = jeng.detect([images[0]], rcam, kmat, depths=depths)[0]
    eng = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
    eng.load_flax_variables(variables)
    got = eng.detect([images[0]], rcam, kmat, depths=depths)[0]

    n_ref = len(ref["class_ids"])
    assert n_ref >= 3 and abs(n_ref - len(got["class_ids"])) <= 1
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
    with pytest.raises(ValueError, match="depths"):
        eng.detect([images[0]], rcam, kmat)


def test_check_supported_accepts_slice3():
    """Every fusion mode and TRANSFORMER run, and so do the training
    options TRILINEAR_REPROJECTION, TRAIN_BN and REMAT, and VIEW_SHARDING
    (the mesh's, parallel/mesh.py); the TPU lowerings (the hoisted
    ConvLSTM input conv among them) stay refused, and
    GRID_REAS="transformer" points at the TRANSFORMER flag.
    FOLD_BN, once a refused lowering, is ported
    (tests/test_torch_detector.py::test_engine_refuses_what_it_cannot_run
    checks that it is accepted)."""
    for mode in ("add", "mean", "ident", "conv3d", "lstm3d"):
        check_supported(_mode_config(mode))
    check_supported(_xformer_config("faithful"))
    for flag in ("TRILINEAR_REPROJECTION", "TRAIN_BN", "REMAT",
                 "VIEW_SHARDING"):
        ok = _mode_config("lstm3d")
        setattr(ok, flag, True)
        check_supported(ok)
    for flag in ("LSTM_HOIST_INPUT", "CROSS_LEVEL_FUSION"):
        bad = _mode_config("lstm3d")
        setattr(bad, flag, True)
        with pytest.raises(ValueError, match=flag):
            check_supported(bad)
    bad = _mode_config("add")
    bad.GRID_REAS = "transformer"
    with pytest.raises(ValueError, match="TRANSFORMER"):
        check_supported(bad)


# ---------------------------------------------------------------------------
# one whole train step against the JAX package
# ---------------------------------------------------------------------------

class LstmTrain(TrainSlice):
    GRID_REAS = "lstm3d"


class XformerTrain(TrainSlice):
    TRANSFORMER = True
    XFORMER_KEEP_MAIN_LEVELS = True
    XFORMER_DROPOUT = 0.0
    TOP_DOWN_PYRAMID_SIZE = 24
    XFORMER_D_MODEL = 24
    XFORMER_NUM_HEADS = 4
    XFORMER_DFF = 32
    XFORMER_NUM_LAYERS = 2
    samples = 1


@pytest.mark.parametrize("cfg_cls", [LstmTrain, XformerTrain],
                         ids=["lstm3d", "transformer"])
def test_train_step_matches_jax(cfg_cls, monkeypatch):
    """One step at the slice's test size, stage "all", as
    tests/test_torch_train.py::test_train_step_matches_jax does for
    conv3d: the five losses and the total, every clipped gradient and
    every updated parameter, against JAX make_train_step(donate=False)
    with its sampling key pinned (the transformer without dropout)."""
    cfg = cfg_cls()
    lr = 1e3
    key = jax.random.PRNGKey(42)
    orig = jdetector.detection_targets_batch
    monkeypatch.setattr(jdetector, "detection_targets_batch",
                        lambda rng, *a, **kw: orig(key, *a, **kw))
    ds = JaxSynthetic(num_scenes=2, num_views=2, image_size=128,
                      num_classes=4, seed=0)
    batch = jax_make_batch(ds, cfg, rnd_state=1,
                           with_depth=bool(cfg.TRANSFORMER))
    if cfg.TRANSFORMER:
        batch["images"] = batch["images"] * np.float32(PIXEL_SCALE)
    variables = random_variables(cfg, seed=5)

    tx = jax_make_optimizer(lr, cfg.LEARNING_MOMENTUM,
                            cfg.GRADIENT_CLIP_NORM)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(params), tx=tx,
                       apply_fn=jdetector.MaskRCNN(cfg).apply)
    new_state, metrics = make_train_step(cfg, "all", donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    ref_new = flax_to_torch({"params": jax.tree_util.tree_map(
        np.asarray, new_state.params)})

    model = TorchMaskRCNN(cfg)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    tb = {k: _t(v) for k, v in batch.items()}
    pos, neg = _jax_priorities(key, 1, cfg.POST_NMS_ROIS_TRAINING)
    tb.update(pos_priority=_t(pos), neg_priority=_t(neg),
              rpn_match=tb["rpn_match"].long())
    mask = trainable_mask(model, "all")
    opt = make_optimizer(model.parameters(), lr, cfg.LEARNING_MOMENTUM)
    total, parts = loss_and_grads(model, tb, cfg, mask)
    clip_per_tensor_norm(model.parameters(), cfg.GRADIENT_CLIP_NORM)
    opt.step()

    for name in L.LOSS_NAMES:
        assert parts[name].item() == pytest.approx(float(metrics[name]),
                                                   rel=1e-4, abs=1e-6), name
    assert total.item() == pytest.approx(float(metrics["loss"]), rel=1e-4)
    ref_grads = {n: (old[n] - ref_new[n]) / lr for n in old}
    floor = 1e-6 * max(float(g.abs().max()) for g in ref_grads.values())
    fusion = "view_transformer" if cfg.TRANSFORMER else "grid_fusion_p4"
    reached = 0
    for n, p in model.named_parameters():
        ref_g = ref_grads[n]
        scale = max(float(ref_g.abs().max()), floor)
        np.testing.assert_allclose(p.grad.numpy() / scale,
                                   ref_g.numpy() / scale, atol=1e-3,
                                   err_msg=n)
        pscale = float(ref_new[n].abs().max())
        np.testing.assert_allclose(p.detach().numpy() / pscale,
                                   ref_new[n].numpy() / pscale, atol=1e-3,
                                   err_msg=n)
        reached += n.startswith(fusion) and float(ref_g.abs().max()) > 0
    # gradients reached the fusion (through the per-view backward for
    # lstm3d, through the tokens for the transformer)
    assert reached >= 2


def test_port_runs_slice3_with_jax_blocked():
    """With jax, flax, optax and the JAX package unimportable, the port
    builds an lstm3d and a transformer model, detects and takes a CPU
    train step with each."""
    code = f"""
import importlib.abc
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "mulit_view_object_detection_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from mulit_view_object_detection_torch.compat import MaskRCNN
from mulit_view_object_detection_torch.config import Config
from mulit_view_object_detection_torch.data.synthetic import (
    SyntheticMultiViewDataset)

class Tiny(Config):
    NAME = "blocked"
    NUM_CLASSES = 3
    NUM_VIEWS = 2
    BACKBONE = "resnet50"
    TOP_DOWN_PYRAMID_SIZE = 12
    FPN_CLASSIF_FC_LAYERS_SIZE = 16
    IMAGE_MIN_DIM = IMAGE_MAX_DIM = 64
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    PRE_NMS_LIMIT = 64
    POST_NMS_ROIS_INFERENCE = 16
    POST_NMS_ROIS_TRAINING = 16
    TRAIN_ROIS_PER_IMAGE = 8
    MAX_GT_INSTANCES = 3
    STEPS_PER_EPOCH = 1
    nvox = nvox_z = 4
    samples = 2

class Lstm(Tiny):
    GRID_REAS = "lstm3d"

class Xformer(Tiny):
    TRANSFORMER = True
    XFORMER_D_MODEL = 12
    XFORMER_NUM_HEADS = 2
    XFORMER_DFF = 16
    XFORMER_NUM_LAYERS = 1
    samples = 1

ds = SyntheticMultiViewDataset(num_scenes=1, num_views=2, image_size=64,
                               num_classes=3)
rng = np.random.RandomState(0)
views = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
rcam = np.tile(np.eye(3, 4, dtype=np.float32), (1, 2, 1, 1))
kmat = np.array([[[64, 0, 32], [0, 64, 32], [0, 0, 1]]], np.float32)
depths = np.full((1, 2, 2, 2), 2.0, np.float32)
for cfg in (Lstm(), Xformer()):
    with tempfile.TemporaryDirectory() as d:
        eng = MaskRCNN("training", cfg, d, device="cpu")
        eng.train(ds, None, 0.001, 1, "all", prefetch_threads=1)
        eng.detect([views], rcam, kmat, depths=depths)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("RAN")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RAN" in proc.stdout and proc.stdout.count("epoch 1:") == 2
