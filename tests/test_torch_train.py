"""Slice 2 of the port, training, against the JAX package on CPU: losses,
targets, optimizer, trainable stages, checkpoints, the batch pipeline and
one whole train step with the same weights and batch.

Sampling: the JAX model draws the ROI priorities from its "sampling" key
(ops/targets.py:66-76); the port takes them as inputs. The tests draw them
with JAX's own keys and hand the port the same numbers; the whole-step
test pins the JAX model's key by monkeypatching its module's
`detection_targets_batch` (nothing in the JAX package changes).

Tolerances: losses within 1e-4 relative (float32 through two conv
backends); gradients and updated parameters within 1e-3 of each tensor's
largest magnitude (gradients with a floor of 1e-6 of the step's largest
gradient); host-side numpy (RPN targets, batches) bit for bit;
optimizer arithmetic to 1e-6.
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
import optax  # noqa: E402

import mulit_view_object_detection_tpu.models.detector as jdetector  # noqa: E402
from mulit_view_object_detection_tpu.data.generator import (  # noqa: E402
    make_batch as jax_make_batch)
from mulit_view_object_detection_tpu.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset as JaxSynthetic)
from mulit_view_object_detection_tpu.models import losses as JL  # noqa: E402
from mulit_view_object_detection_tpu.ops import targets as JT  # noqa: E402
from mulit_view_object_detection_tpu.train.optim import (  # noqa: E402
    clip_per_leaf_norm, l2_regularization as jax_l2, make_optimizer as
    jax_make_optimizer)
from mulit_view_object_detection_tpu.train.step import (  # noqa: E402
    TrainState, lr_schedule as jax_lr_schedule, make_train_step)
from mulit_view_object_detection_tpu.train.trainable import (  # noqa: E402
    trainable_mask as jax_trainable_mask)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.data.generator import (  # noqa: E402
    make_batch)
from mulit_view_object_detection_torch.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset)
from mulit_view_object_detection_torch.models import losses as L  # noqa: E402
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as TorchMaskRCNN)
from mulit_view_object_detection_torch.ops import targets as T  # noqa: E402
from mulit_view_object_detection_torch.train import checkpoint as C  # noqa: E402
from mulit_view_object_detection_torch.train.optim import (  # noqa: E402
    clip_per_tensor_norm, l2_regularization, make_optimizer)
from mulit_view_object_detection_torch.train.step import (  # noqa: E402
    loss_and_grads, lr_schedule)
from mulit_view_object_detection_torch.train.trainable import (  # noqa: E402
    param_paths, trainable_mask)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)
from tests.test_torch_convert import random_variables  # noqa: E402
from tests.test_torch_detector import SliceConfig, _inputs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TrainSlice(SliceConfig):
    """The slice's test size with training shapes cut down: every level
    projected (at 128^2 the ROIs route to P2/P3), 128 proposals (enough
    that random weights leave a few positive ROIs), 16 ROIs, 4 GT slots."""
    NAME = "torch_train_slice"
    ZERO_PG_LEVELS = ()
    POST_NMS_ROIS_TRAINING = 128
    TRAIN_ROIS_PER_IMAGE = 16
    MAX_GT_INSTANCES = 4
    RPN_TRAIN_ANCHORS_PER_IMAGE = 64
    STEPS_PER_EPOCH = 2
    VALIDATION_STEPS = 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_priorities(key, b, p):
    """The priorities JAX's detection_targets_batch draws from `key`
    (targets.py:66-76, 130-133), as [B, P] numpy arrays."""
    pos, neg = [], []
    for r in jax.random.split(key, b):
        rp, rn = jax.random.split(r)
        pos.append(np.asarray(jax.random.uniform(rp, (p,))))
        neg.append(np.asarray(jax.random.uniform(rn, (p,))))
    return np.stack(pos), np.stack(neg)


# ---------------------------------------------------------------------------
# losses and targets
# ---------------------------------------------------------------------------

def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    b, a, t, nc, m = 2, 50, 12, 5, 6
    match = rng.choice([-1, 0, 1], (b, a)).astype(np.int32)
    tcls = rng.randint(0, nc, (b, t)).astype(np.int32)
    tcls[:, -3:] = 0
    active = (rng.rand(b, nc) > 0.3).astype(np.float32)
    active[:, 0] = 1
    return {
        "rpn_match": match,
        "rpn_class_logits": rng.randn(b, a, 2).astype(np.float32),
        "rpn_target_bbox": rng.randn(b, 20, 4).astype(np.float32),
        "rpn_bbox": rng.randn(b, a, 4).astype(np.float32) * 2,
        "target_class_ids": tcls,
        "mrcnn_class_logits": rng.randn(b, t, nc).astype(np.float32),
        "active_class_ids": active,
        "target_deltas": rng.randn(b, t, 4).astype(np.float32),
        "mrcnn_bbox": rng.randn(b, t, nc, 4).astype(np.float32) * 2,
        "target_masks": (rng.rand(b, t, m, m) > 0.5).astype(np.float32),
        "mrcnn_masks": rng.rand(b, t, m, m, nc).astype(np.float32),
    }


_LOSS_ARGS = {
    "rpn_class_loss": ("rpn_match", "rpn_class_logits"),
    "rpn_bbox_loss": ("rpn_target_bbox", "rpn_match", "rpn_bbox"),
    "mrcnn_class_loss": ("target_class_ids", "mrcnn_class_logits",
                         "active_class_ids"),
    "mrcnn_bbox_loss": ("target_deltas", "target_class_ids", "mrcnn_bbox"),
    "mrcnn_mask_loss": ("target_masks", "target_class_ids", "mrcnn_masks"),
}


@pytest.mark.parametrize("name", sorted(_LOSS_ARGS))
def test_loss_matches_jax(name):
    for seed in (0, 1):
        x = _loss_inputs(seed)
        args = [x[k] for k in _LOSS_ARGS[name]]
        got = float(getattr(L, name)(*map(_t, args)))
        ref = float(getattr(JL, name)(*map(jnp.asarray, args)))
        assert got == pytest.approx(ref, rel=1e-5, abs=1e-7), seed
    # a batch with nothing to count gives 0, not NaN
    x = _loss_inputs(2)
    x["rpn_match"][:] = 0
    x["target_class_ids"][:] = 0
    x["active_class_ids"][:] = 0
    args = [x[k] for k in _LOSS_ARGS[name]]
    assert float(getattr(L, name)(*map(_t, args))) == 0.0


def test_total_loss_matches_jax():
    parts = {n: float(i + 1) / 7 for i, n in enumerate(L.LOSS_NAMES)}
    w = {"rpn_class_loss": 2.0, "mrcnn_mask_loss": 0.5}
    got = L.total_loss({k: torch.tensor(v) for k, v in parts.items()}, w)
    assert float(got) == pytest.approx(float(JL.total_loss(parts, w)),
                                       rel=1e-6)


def _target_case(seed, use_mini):
    rng = np.random.RandomState(seed)
    p, g = 40, 5
    gt = np.zeros((g, 4), np.float32)
    cls = np.zeros(g, np.int32)
    for i in range(4):
        y1, x1 = rng.uniform(0.05, 0.55, 2)
        gt[i] = [y1, x1, y1 + rng.uniform(0.2, 0.4), x1 + rng.uniform(0.2,
                                                                       0.4)]
    cls[:4] = [1, 3, 2, -1]                        # one crowd box
    props = np.clip(np.repeat(gt[:4], 8, 0)
                    + rng.normal(0, 0.06, (32, 4)), 0, 1).astype(np.float32)
    props = np.concatenate([props, rng.uniform(0, 1, (4, 4)).astype(
        np.float32), np.zeros((4, 4), np.float32)])        # zero padding
    props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 0.02)
    mh = 14 if use_mini else 32
    masks = (rng.rand(g, mh, mh) > 0.4).astype(np.float32)
    return props[:p], cls, gt, masks


@pytest.mark.parametrize("use_mini", [True, False], ids=["mini", "full"])
def test_detection_targets_match_jax(use_mini):
    """Same proposals and GT, priorities from JAX's keys: the same ROIs,
    classes, deltas and masks, zero padding included."""
    kw = dict(train_rois_per_image=20, roi_positive_ratio=0.33,
              mask_shape=(28, 28), use_mini_mask=use_mini,
              bbox_std_dev=np.array([0.1, 0.1, 0.2, 0.2]))
    cases = [_target_case(s, use_mini) for s in (0, 1)]
    props, cls, gt, masks = (np.stack(x) for x in zip(*cases))
    key = jax.random.PRNGKey(5)
    ref = JT.detection_targets_batch(key, *map(jnp.asarray, (props, cls, gt,
                                                            masks)), **kw)
    pos, neg = _jax_priorities(key, 2, props.shape[1])
    got = T.detection_targets_batch(*map(_t, (props, cls, gt, masks, pos,
                                              neg)), **kw)
    assert int((np.asarray(ref[1]) > 0).sum()) >= 4     # has positives
    for name, g, r in zip(("rois", "class_ids", "deltas", "masks"), got,
                          ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("gt_kind", ["objects", "with_crowd", "empty"])
def test_build_rpn_targets_bit_equal(gt_kind):
    """Same anchors, GT and RandomState seed: identical labels and
    deltas, and the RandomState consumed identically."""
    cfg = TrainSlice()
    from mulit_view_object_detection_torch.data.generator import (
        pixel_anchors)
    anchors = pixel_anchors(cfg, cfg.IMAGE_SHAPE)
    rng = np.random.RandomState(3)
    n = {"objects": 4, "with_crowd": 4, "empty": 0}[gt_kind]
    y1x1 = rng.uniform(0, 80, (n, 2))
    boxes = np.concatenate([y1x1, y1x1 + rng.uniform(10, 48, (n, 2))],
                           1).astype(np.float32)
    cls = np.arange(1, n + 1).astype(np.int32)
    if gt_kind == "with_crowd":
        cls[1] = -1
    r1, r2 = np.random.RandomState(11), np.random.RandomState(11)
    got = T.build_rpn_targets(anchors, cls, boxes, cfg, rnd_state=r1)
    ref = JT.build_rpn_targets(anchors, cls, boxes, cfg, rnd_state=r2)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert r1.randint(2 ** 31) == r2.randint(2 ** 31)
    if n:
        assert (got[0] == 1).sum() >= 1 and (got[0] == -1).sum() >= 1


# ---------------------------------------------------------------------------
# optimizer, L2, trainable stages, schedule
# ---------------------------------------------------------------------------

def test_clipnorm_and_sgd_steps_match_optax():
    """Per-tensor clipnorm then SGD with momentum, two steps, against
    optax's chain in the JAX package (one tensor above the clip norm, one
    under)."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{"a": rng.randn(4, 3).astype(np.float32) * 10,
              "b": rng.randn(5).astype(np.float32) * 0.01} for _ in range(2)]
    tx = jax_make_optimizer(0.1, 0.9, 5.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: _t(v).clone().requires_grad_() for k, v in params.items()}
    opt = make_optimizer(list(tp.values()), 0.1, 0.9)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = _t(g[k]).clone()
        clip_per_tensor_norm(tp.values(), 5.0)
        assert float(tp["a"].grad.norm()) == pytest.approx(5.0, rel=1e-5)
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
    # the clip alone, as the JAX transformation computes it
    clipped, _ = clip_per_leaf_norm(5.0).update(
        {k: jnp.asarray(v) for k, v in grads[0].items()}, optax.EmptyState())
    for k, p in tp.items():
        p.grad = _t(grads[0][k]).clone()
    clip_per_tensor_norm(tp.values(), 5.0)
    for k, p in tp.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(clipped[k]),
                                   rtol=1e-6)


@pytest.fixture(scope="module")
def slice_model():
    model = TorchMaskRCNN(TrainSlice())
    model.init_weights(torch.Generator().manual_seed(0))
    return model


STAGES = ["heads", "grid+", "grid+-", "grid_only", "3+", "4+", "5+", "all",
          r"backbone/res5.*", r"fpn/fpn_p\d/kernel"]


@pytest.mark.parametrize("stage", STAGES)
def test_trainable_mask_and_l2_match_jax(slice_model, stage):
    """Every stage's mask on the port's parameters equals the JAX mask on
    the same weights as a flax tree (by flax path), and L2 over the
    trainable non-BatchNorm weights equals the JAX l2_regularization."""
    tree = torch_to_flax(slice_model.state_dict())["params"]
    jmask = jax_trainable_mask(tree, stage)
    flat = {tuple(getattr(k, "key", str(k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    mask = trainable_mask(slice_model, stage)
    paths = param_paths(slice_model)
    assert {paths[n] for n in mask} == set(flat)
    for n, m in mask.items():
        assert m == flat[paths[n]], (stage, n)
    assert any(mask.values())
    ref = float(jax_l2(jax.tree_util.tree_map(jnp.asarray, tree), jmask,
                       0.5))
    got = float(l2_regularization(slice_model.named_parameters(), paths,
                                  mask, 0.5))
    assert got == pytest.approx(ref, rel=1e-5)


def test_lr_schedule_matches_jax():
    stages = [(301, 0.001), (4001, 0.0005), (4501, 0.0001)]
    got, ref = lr_schedule(0.001, stages), jax_lr_schedule(0.001, stages)
    for step in (0, 300, 301, 4000, 4001, 4500, 9999):
        assert got(step) == pytest.approx(float(ref(step)), rel=1e-7)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_and_resume(tmp_path):
    """Parameters, BatchNorm statistics, optimizer state and step come
    back; the newest `max_to_keep` steps are kept; an engine loading the
    directory resumes its epoch count."""
    cfg = TrainSlice()
    a = TorchMaskRCNN(cfg)
    a.init_weights(torch.Generator().manual_seed(1))
    a.backbone.bn_conv1.running_mean.fill_(0.25)
    opt = make_optimizer(list(a.parameters())[:3], 0.1, 0.9)
    for p in list(a.parameters())[:3]:
        p.grad = torch.ones_like(p)
    opt.step()
    ckpt = str(tmp_path / "ckpt")
    assert C.latest_step(ckpt) is None
    for step in (1, 2, 3):
        C.save_checkpoint(ckpt, a, opt, step=step, max_to_keep=2)
    assert C.latest_step(ckpt) == 3
    assert sorted(os.listdir(ckpt)) == ["2", "3"]

    b = TorchMaskRCNN(cfg)
    opt_b = make_optimizer(list(b.parameters())[:3], 0.1, 0.9)
    assert C.restore_checkpoint(ckpt, b, opt_b) == 3
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    for pa, pb in zip(opt.param_groups[0]["params"],
                      opt_b.param_groups[0]["params"]):
        assert torch.equal(opt.state[pa]["momentum_buffer"],
                           opt_b.state[pb]["momentum_buffer"])

    eng = MaskRCNN("training", cfg, str(tmp_path), device="cpu")
    eng.load_weights(ckpt)
    assert eng.epoch == 3
    assert torch.equal(eng.model.backbone.bn_conv1.running_mean,
                       a.backbone.bn_conv1.running_mean)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def test_make_batch_bit_equal_to_jax():
    """The port's numpy pipeline (synthetic scenes, molding, GT, mini
    masks, RPN targets) gives JAX's batch for the same seed, bit for
    bit."""
    cfg = TrainSlice()
    kw = dict(num_scenes=3, num_views=2, image_size=96, num_classes=4,
              seed=4)
    got = make_batch(SyntheticMultiViewDataset(**kw), cfg, rnd_state=7)
    ref = jax_make_batch(JaxSynthetic(**kw), cfg, rnd_state=7)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (got["gt_class_ids"] > 0).sum() >= 2
    assert (got["rpn_match"] == 1).sum() >= 1


# ---------------------------------------------------------------------------
# one whole train step against the JAX package
# ---------------------------------------------------------------------------

def test_train_step_matches_jax(monkeypatch):
    """One step at the slice's test size from the same weights and
    batch, stage "all": the five losses and the total (with L2), every
    clipped gradient and every updated parameter, against JAX
    make_train_step(donate=False). The JAX model's sampling key is pinned
    and the port gets the priorities that key gives."""
    cfg = TrainSlice()
    # a large step, so that (old - new) / lr resolves even the smallest
    # gradients (P6's, ~1e-6) above float32 rounding of the parameters
    lr = 1e3
    key = jax.random.PRNGKey(42)
    orig = jdetector.detection_targets_batch
    monkeypatch.setattr(jdetector, "detection_targets_batch",
                        lambda rng, *a, **kw: orig(key, *a, **kw))
    ds = JaxSynthetic(num_scenes=2, num_views=2, image_size=128,
                      num_classes=4, seed=0)
    batch = jax_make_batch(ds, cfg, rnd_state=1)     # 2 positive ROIs
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
        assert float(metrics[name]) > 0, name          # every loss has signal
    assert total.item() == pytest.approx(float(metrics["loss"]), rel=1e-4)
    ref_grads = {n: (old[n] - ref_new[n]) / lr         # fresh momentum
                 for n in old}
    # a tensor whose gradient is below a millionth of the step's largest
    # (P6's, 1e-9..1e-6: residuals of saturated softmaxes) is held at
    # that floor, float32's resolution of the terms it cancels
    floor = 1e-6 * max(float(g.abs().max()) for g in ref_grads.values())
    n_grad = 0
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
        n_grad += float(ref_g.abs().max()) > 0
    # gradients reached the backbone through both geometry backwards
    assert n_grad > 0.9 * len(old)


# ---------------------------------------------------------------------------
# the engine trains, and the port runs without jax
# ---------------------------------------------------------------------------

def test_engine_trains_and_resumes(tmp_path, capsys):
    """compat.MaskRCNN("training").train on the CPU: one epoch of two
    steps with validation writes a checkpoint; a new engine loads it and
    continues to epoch 2 at stage "heads". Parameters stay float32, the
    frozen ones untouched."""
    cfg = TrainSlice()
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2,
                                   image_size=128, num_classes=4, seed=0)
    eng = MaskRCNN("training", cfg, str(tmp_path), device="cpu")
    eng.train(ds, ds, 0.001, 1, "all", prefetch_threads=1)
    out = capsys.readouterr().out
    assert "epoch 1:" in out and "val_loss=" in out
    ckpt = eng.find_last()
    assert C.latest_step(ckpt) == 1

    eng2 = MaskRCNN("training", cfg, str(tmp_path), device="cpu")
    eng2.load_weights(ckpt)
    assert eng2.epoch == 1
    before = {n: p.detach().clone() for n, p in eng2.model.named_parameters()}
    eng2.train(ds, None, 0.001, 2, "heads", prefetch_threads=1)
    assert eng2.epoch == 2 and "epoch 2:" in capsys.readouterr().out
    for n, p in eng2.model.named_parameters():
        assert p.dtype == torch.float32, n
        frozen = n.startswith(("backbone.", "grid_fusion"))
        # P6's 12 anchors (scale 256 on a 128^2 image) are negatives the
        # 64-anchor RPN sample seldom draws, so P6's depth collapse gets
        # no gradient, or one below float32's step: it stays put
        dead = n.startswith("depth_collapse_p6.")
        assert torch.equal(p, before[n]) == (frozen or dead), n
    with pytest.raises(ValueError, match="training mode"):
        MaskRCNN("inference", cfg, str(tmp_path), device="cpu").train(
            ds, None, 0.001, 1, "all")


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float32_model_computes_without_tf32(tmp_path, dtype):
    """Under COMPUTE_DTYPE "float32" the engine's training step (forward
    and backward) and its detect see cuDNN's and cuBLAS's TF32 off
    (models/detector.py::float32_arithmetic); a bfloat16 model sees them
    as the process set them. The flags are restored after each call."""
    cfg = type("Cfg", (TrainSlice,), {"COMPUTE_DTYPE": dtype})()
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2,
                                   image_size=128, num_classes=4, seed=0)
    eng = MaskRCNN("training", cfg, str(tmp_path), device="cpu")
    stem = eng.model.backbone.conv1
    seen = {"forward": set(), "backward": set()}
    stem.register_forward_hook(
        lambda *_: seen["forward"].add(_tf32_flags()))
    stem.register_full_backward_hook(
        lambda *_: seen["backward"].add(_tf32_flags()))
    outside = (True, True)
    saved = _tf32_flags()
    try:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = outside
        eng.train(ds, None, 0.001, 1, "all", prefetch_threads=1)
        assert _tf32_flags() == outside
        inside = (False, False) if dtype == "float32" else outside
        assert seen == {"forward": {inside}, "backward": {inside}}
        seen["forward"].clear()
        infer = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
        infer.model.backbone.conv1.register_forward_hook(
            lambda *_: seen["forward"].add(_tf32_flags()))
        images, rcam, kmat = _inputs(cfg, seed=3)
        infer.detect([images[0]], rcam, kmat)
        assert _tf32_flags() == outside
        assert seen["forward"] == {inside}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_port_trains_with_jax_blocked():
    """With jax, flax, optax and the JAX package made unimportable (a
    meta-path finder that raises ImportError), the port imports and takes
    two CPU train steps."""
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
    TOP_DOWN_PYRAMID_SIZE = 8
    FPN_CLASSIF_FC_LAYERS_SIZE = 16
    IMAGE_MIN_DIM = IMAGE_MAX_DIM = 64
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    PRE_NMS_LIMIT = 64
    POST_NMS_ROIS_TRAINING = 16
    TRAIN_ROIS_PER_IMAGE = 8
    MAX_GT_INSTANCES = 3
    STEPS_PER_EPOCH = 2
    nvox = nvox_z = 4
    samples = 2

ds = SyntheticMultiViewDataset(num_scenes=1, num_views=2, image_size=64,
                               num_classes=3)
with tempfile.TemporaryDirectory() as d:
    MaskRCNN("training", Tiny(), d, device="cpu").train(
        ds, None, 0.001, 1, "all", prefetch_threads=1)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("TRAINED")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TRAINED" in proc.stdout and "epoch 1:" in proc.stdout
