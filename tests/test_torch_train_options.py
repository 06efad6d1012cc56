"""The training options of the port on the CPU, against the JAX package:
TRAIN_BN (BatchNorm with batch statistics), BN_EVAL_BATCH_STATS, REMAT
and TRILINEAR_REPROJECTION.

* `models/resnet.py::BatchNorm` in batch-statistics mode against the JAX
  package's BatchNorm(train_bn=True) (flax nn.BatchNorm) on 2-D maps,
  fusion grids and ROI rows, in float32 and bfloat16: outputs and the
  updated running statistics.
* One TRAIN_BN train step of the 2-view conv3d slice against JAX
  make_train_step, with REMAT off and on in both: the losses, every
  updated batch_stats leaf, and the gradients by chip_smoke.py phase 7's
  rule (every tensor within 1e-2 of its largest magnitude, 95% within
  1e-3); stage "heads" writes the frozen backbone's statistics too.
* The validation step and BN_EVAL_BATCH_STATS inference write no
  statistics; the inference against MaskRCNN.apply with batch
  statistics.
* REMAT on against off, with and without TRAIN_BN: the same losses,
  gradients and statistics (written once).
* The trilinear `project_grid` and its gradient against JAX's
  (jax.grad), and a TRILINEAR_REPROJECTION forward against
  MaskRCNN.apply.
* The batch statistics round-trip through a checkpoint, and a TRAIN_BN
  engine's BN-folded copy is rebuilt from the updated statistics.
* A TRAIN_BN + REMAT + trilinear engine trains with jax made
  unimportable.
"""

import copy
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
from mulit_view_object_detection_tpu.data.generator import (  # noqa: E402
    make_batch as jax_make_batch)
from mulit_view_object_detection_tpu.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset as JaxSynthetic)
from mulit_view_object_detection_tpu.models.detector import (  # noqa: E402
    MaskRCNN as JaxMaskRCNN)
from mulit_view_object_detection_tpu.models.resnet import (  # noqa: E402
    BatchNorm as JaxBatchNorm)
from mulit_view_object_detection_tpu.ops.projection import (  # noqa: E402
    project_grid as jax_project_grid)
from mulit_view_object_detection_tpu.train.optim import (  # noqa: E402
    make_optimizer as jax_make_optimizer)
from mulit_view_object_detection_tpu.train.step import (  # noqa: E402
    TrainState, make_train_step)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset)
from mulit_view_object_detection_torch.kernels import unproject  # noqa: E402
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as TorchMaskRCNN)
from mulit_view_object_detection_torch.models.layers import (  # noqa: E402
    set_compute_dtype)
from mulit_view_object_detection_torch.models.resnet import (  # noqa: E402
    BatchNorm, BatchStats)
from mulit_view_object_detection_torch.ops.projection import (  # noqa: E402
    project_grid_trilinear)
from mulit_view_object_detection_torch.train.optim import (  # noqa: E402
    clip_per_tensor_norm, make_optimizer)
from mulit_view_object_detection_torch.train.step import (  # noqa: E402
    draw_priorities, loss_and_grads, val_step)
from mulit_view_object_detection_torch.train.trainable import (  # noqa: E402
    trainable_mask)
from mulit_view_object_detection_torch.utils.bn_fold import (  # noqa: E402
    fold_bn_model)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch)
from tests.test_torch_convert import random_variables  # noqa: E402
from tests.test_torch_detector import (  # noqa: E402
    AllLevels, _batch, _close, _inputs, _run_both)
from tests.test_torch_train import (  # noqa: E402
    TrainSlice, _jax_priorities, _t)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_STEP = 2.0 ** -7        # a bfloat16 rounding step: at most 2^-7 of |x|
GRAD_TOL, GRAD_FLIP_TOL, GRAD_FLIP_SHARE = 1e-3, 1e-2, 0.05   # phase 7's


def _stats(model):
    """Every BatchNorm's running statistics, cloned."""
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _rel(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


# ---------------------------------------------------------------------------
# BatchNorm against flax
# ---------------------------------------------------------------------------

_BN_SHAPES = {"map2d": (3, 6, 5, 8), "grid3d": (2, 4, 3, 5, 8),
              "roi_rows": (24, 1, 1, 8)}      # channels last, C = 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(_BN_SHAPES))
def test_batch_norm_matches_flax(kind, dtype):
    """Output, and the running statistics updated as 0.9 old + 0.1 batch
    with the biased variance; bfloat16 inputs normalised in float32 and
    rounded once."""
    rng = np.random.RandomState(len(kind))
    shape = _BN_SHAPES[kind]
    c = shape[-1]
    x = (rng.randn(*shape) * rng.uniform(0.5, 3, c)
         + rng.uniform(-2, 2, c)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c), rng.uniform(-1, 1, c)
    mean, var = rng.uniform(-1, 1, c), rng.uniform(0.5, 2, c)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    variables = {"params": {"BatchNorm_0": {
        "scale": jnp.asarray(scale, jnp.float32),
        "bias": jnp.asarray(bias, jnp.float32)}},
        "batch_stats": {"BatchNorm_0": {
            "mean": jnp.asarray(mean, jnp.float32),
            "var": jnp.asarray(var, jnp.float32)}}}
    xj = jnp.asarray(x).astype(jdt)
    ref, new = JaxBatchNorm(train_bn=True, dtype=jdt).apply(
        variables, xj, mutable=["batch_stats"])
    assert ref.dtype == jdt

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(tdt)
    stats = BatchStats()
    got = bn(xt.movedim(-1, 1), stats).movedim(1, -1)
    assert got.dtype == tdt and len(stats.records) == 1
    assert torch.equal(bn.running_mean, torch.from_numpy(mean).float())
    stats.commit()                                # written only here
    got = got.detach().float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    else:
        assert (np.abs(got - ref) <= BF16_STEP * np.abs(ref) + 1e-6).all()
    for ours, theirs in ((bn.running_mean, new["batch_stats"]["BatchNorm_0"]
                          ["mean"]), (bn.running_var, new["batch_stats"]
                                      ["BatchNorm_0"]["var"])):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=1e-7)


def test_folded_batch_norm_refuses_batch_statistics():
    bn = BatchNorm(4)
    bn.fold("affine", torch.float32)
    with pytest.raises(ValueError, match="folded"):
        bn(torch.zeros(2, 4, 3, 3), BatchStats())


# ---------------------------------------------------------------------------
# one TRAIN_BN train step against the JAX package
# ---------------------------------------------------------------------------

class BNSlice(TrainSlice):
    NAME = "torch_train_bn_slice"
    TRAIN_BN = True


def _jax_bn_step(cfg, variables, batch, stage, monkeypatch, lr):
    """JAX make_train_step's step at `stage`, computed in float64 (see
    test_train_bn_step_matches_jax), with its sampling key pinned.
    Returns (new params and statistics as a state_dict, the metrics, the
    float32 priorities the key gives)."""
    key = jax.random.PRNGKey(42)
    orig = jdetector.detection_targets_batch
    monkeypatch.setattr(jdetector, "detection_targets_batch",
                        lambda rng, *a, **kw: orig(key, *a, **kw))
    tx = jax_make_optimizer(lr, cfg.LEARNING_MOMENTUM,
                            cfg.GRADIENT_CLIP_NORM)
    with monkeypatch.context() as m, jax.enable_x64(True):
        m.setattr(JaxMaskRCNN, "_dtype", lambda self: jnp.float64)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(params), tx=tx,
                           apply_fn=JaxMaskRCNN(cfg).apply)
        new_state, metrics = make_train_step(cfg, stage, donate=False)(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))
        priorities = _jax_priorities(key, 1, cfg.POST_NMS_ROIS_TRAINING)
    ref = flax_to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    return (ref, {k: float(v) for k, v in metrics.items()},
            tuple(p.astype(np.float32) for p in priorities))


def _port_step(cfg, variables, batch, priorities, stage="all",
               dtype=torch.float32):
    """loss_and_grads + clipnorm at `stage` from the converted weights
    with the given priorities, the model computing in `dtype`. Returns
    (model, total, parts)."""
    model = TorchMaskRCNN(cfg)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    if dtype != torch.float32:
        model = model.to(dtype)
        set_compute_dtype(model, dtype)
        model.compute_dtype = dtype
    tb = {k: _t(v) for k, v in batch.items()}
    pos, neg = priorities
    tb.update(pos_priority=_t(pos), neg_priority=_t(neg),
              rpn_match=tb["rpn_match"].long())
    tb = {k: v.to(dtype) if v.dtype == torch.float32 else v
          for k, v in tb.items()}
    mask = trainable_mask(model, stage)
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
    total, parts = loss_and_grads(model, tb, cfg, mask)
    clip_per_tensor_norm(model.parameters(), cfg.GRADIENT_CLIP_NORM)
    return model, total, parts


def _grad_errs(ref, got, floor):
    return {n: float((got[n] - r).abs().max()) / max(float(r.abs().max()),
                                                      floor)
            for n, r in ref.items()}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_bn_step_matches_jax(remat, monkeypatch):
    """TRAIN_BN (and REMAT) on in both packages, stage "all", one step
    from the same weights, batch and priorities, the JAX step computed in
    float64 (its modules' compute dtype patched, jax's x64 mode on; the
    weights are the same float32 values): the port's step in float64 has
    the five losses and the total within 1e-4, every updated running
    statistic within 1e-4 of its tensor's largest magnitude and every
    clipped gradient by phase 7's rule; its float32 step, the losses and
    the statistics.

    Why float64. On the CPU at this size (batch statistics over 2 views
    of 128^2, 32 values a channel at C5) float32 rounding is amplified
    by every batch-statistics BatchNorm:
    * forward: the JAX package's float32 batch statistics are off by
      1.3e-4 of the largest value at C1 and 3.9e-3 at C5 against a
      float64 run of the same backbone (the port's float32: 8.4e-7 and
      5.0e-5), since flax's one-pass E[x^2] - E[x]^2 summed in XLA's
      order cancels where a mean is large against its spread; that moves
      the RPN scores enough to reorder the proposals, and the heads see
      other ROIs;
    * backward: the port's float32 gradients differ from its own float64
      gradients by up to 0.5% of a tensor's largest value (a BatchNorm
      scale) and in the rounding noise of every conv bias before a
      batch-statistics BatchNorm, whose exact gradient is zero; a
      two-pass variance changes neither.
    In float64 the two packages agree to 5e-5 on every gradient."""
    cfg = BNSlice()
    cfg.REMAT = remat
    lr = 1e3                      # (old - new) / lr resolves the gradient
    ds = JaxSynthetic(num_scenes=2, num_views=2, image_size=128,
                      num_classes=4, seed=0)
    batch = jax_make_batch(ds, cfg, rnd_state=1)
    variables = random_variables(cfg, seed=5)
    ref, metrics, priorities = _jax_bn_step(cfg, variables, batch, "all",
                                            monkeypatch, lr)
    monkeypatch.setattr(unproject, "_check_device", lambda t, what: None)
    old = flax_to_torch(variables)
    for dtype in (torch.float32, torch.float64):
        model, total, parts = _port_step(cfg, variables, batch, priorities,
                                         dtype=dtype)
        for name, part in parts.items():
            assert part.item() == pytest.approx(metrics[name], rel=1e-4,
                                                abs=1e-6), (dtype, name)
            assert metrics[name] > 0, name
        assert total.item() == pytest.approx(metrics["loss"], rel=1e-4)
        stats = _stats(model)
        assert stats and all(not torch.equal(stats[n].float(), old[n])
                             for n in stats)
        for n, t in stats.items():
            assert _rel(t.float(), ref[n]) <= 1e-4, (dtype, n)
    ref_grads = {n: (torch.as_tensor(old[n]) - ref[n]).double() / lr
                 for n, _ in model.named_parameters()}
    got = {n: p.grad for n, p in model.named_parameters()}
    floor = 1e-6 * max(float(g.abs().max()) for g in ref_grads.values())
    errs = _grad_errs(ref_grads, got, floor)
    beyond = [n for n, e in errs.items() if e > GRAD_TOL]
    assert max(errs.values()) <= GRAD_FLIP_TOL, max(errs, key=errs.get)
    assert len(beyond) <= GRAD_FLIP_SHARE * len(errs), beyond


def test_heads_stage_writes_frozen_statistics():
    """Stage "heads" freezes the backbone's parameters but not its
    statistics: a "heads" step writes every BatchNorm's running
    statistics, the same as an "all" step from the same start."""
    cfg = BNSlice()
    ds = JaxSynthetic(num_scenes=2, num_views=2, image_size=128,
                      num_classes=4, seed=0)
    batch = jax_make_batch(ds, cfg, rnd_state=1)
    variables = random_variables(cfg, seed=5)
    priorities = _jax_priorities(jax.random.PRNGKey(42), 1,
                                 cfg.POST_NMS_ROIS_TRAINING)
    heads, _, _ = _port_step(cfg, variables, batch, priorities, "heads")
    every, _, _ = _port_step(cfg, variables, batch, priorities, "all")
    assert all(p.grad is None for n, p in heads.named_parameters()
               if n.startswith("backbone."))
    old = flax_to_torch(variables)
    got, want = _stats(heads), _stats(every)
    assert any(n.startswith("backbone.") for n in got)
    for n in got:
        assert not torch.equal(got[n], torch.as_tensor(old[n])), n
        torch.testing.assert_close(got[n], want[n], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# statistics that are not written
# ---------------------------------------------------------------------------

class EvalBNSlice(AllLevels):
    NAME = "torch_eval_bn_slice"
    TRAIN_BN = True
    BN_EVAL_BATCH_STATS = True


def test_validation_and_bn_eval_inference_write_no_statistics(monkeypatch):
    """val_step (TRAIN_BN) and BN_EVAL_BATCH_STATS inference normalise
    with batch statistics and write none; the inference's outputs equal
    MaskRCNN.apply's with batch statistics (its batch_stats mutation
    discarded, as make_eval_step does), computed in float64 for the
    reason test_train_bn_step_matches_jax gives."""
    cfg = EvalBNSlice()
    variables = random_variables(cfg, seed=0)
    images, rcam, kmat = _inputs(cfg, 0)
    batch = _batch(cfg, images, rcam, kmat)
    with monkeypatch.context() as m, jax.enable_x64(True):
        m.setattr(JaxMaskRCNN, "_dtype", lambda self: jnp.float64)
        ref, _ = jax.jit(lambda v, b: JaxMaskRCNN(cfg).apply(
            v, b, mutable=["batch_stats"]))(
                variables, {k: jnp.asarray(a) for k, a in batch.items()})
        ref = {k: np.asarray(v, np.float32) for k, v in ref.items()}
    monkeypatch.setattr(unproject, "_check_device", lambda t, what: None)
    model = TorchMaskRCNN(cfg).eval()
    model.load_state_dict(flax_to_torch(variables), strict=True)
    model = model.double()
    set_compute_dtype(model, torch.float64)
    model.compute_dtype = torch.float64
    before = _stats(model)
    inputs = {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}
    inputs = {k: v.double() if v.dtype == torch.float32 else v
              for k, v in inputs.items()}
    got = model(inputs)
    for key in ("rpn_probs", "rpn_bbox", "proposals", "mrcnn_probs",
                "mrcnn_bbox", "detections", "mrcnn_masks"):
        _close(got[key].float().numpy(), ref[key], key)
    frozen = copy.deepcopy(model)
    frozen.config = AllLevels()
    assert not torch.allclose(frozen(inputs)["rpn_probs"], got["rpn_probs"])
    assert all(torch.equal(before[n], t) for n, t in _stats(model).items())

    tcfg = BNSlice()
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2,
                                   image_size=128, num_classes=4, seed=0)
    eng = MaskRCNN("training", tcfg, "unused", device="cpu")
    eng.load_flax_variables(random_variables(tcfg, seed=5))
    before = _stats(eng.model)
    from mulit_view_object_detection_torch.data.generator import make_batch
    metrics = val_step(eng.model, eng.to_device(make_batch(ds, tcfg, 1)),
                       tcfg, torch.Generator().manual_seed(0))
    assert all(np.isfinite(v) for v in metrics.values())
    assert all(torch.equal(before[n], t)
               for n, t in _stats(eng.model).items())


# ---------------------------------------------------------------------------
# REMAT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train_bn", [False, True], ids=["frozen", "train_bn"])
def test_remat_equals_plain_step(train_bn):
    """The port's step with REMAT on and off from the same weights and
    batch: the same losses, gradients and running statistics within 1e-6
    relative. The recomputation writes nothing: the statistics move once
    (0.9 old + 0.1 batch, not twice)."""
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2,
                                   image_size=128, num_classes=4, seed=0)
    results = []
    for remat in (False, True):
        cfg = BNSlice() if train_bn else TrainSlice()
        cfg.REMAT = remat
        eng = MaskRCNN("training", cfg, "unused", device="cpu")
        eng.load_flax_variables(random_variables(cfg, seed=5))
        from mulit_view_object_detection_torch.data.generator import (
            make_batch)
        batch = draw_priorities(eng.to_device(make_batch(ds, cfg, 1)), cfg,
                                torch.Generator().manual_seed(0))
        mask = trainable_mask(eng.model, "all")
        total, parts = loss_and_grads(eng.model, batch, cfg, mask)
        results.append((dict(parts, loss=total),
                        {n: p.grad for n, p in eng.model.named_parameters()},
                        _stats(eng.model)))
    (lp, gp, sp), (lr_, gr, sr) = results
    for k in lp:
        assert lr_[k].item() == pytest.approx(lp[k].item(), rel=1e-6), k
    for n in gp:
        assert _rel(gr[n], gp[n]) <= 1e-6, n
    for n in sp:
        assert _rel(sr[n], sp[n]) <= 1e-6, n
    initial = flax_to_torch(random_variables(TrainSlice(), seed=5))
    moved = [n for n in sp if not torch.equal(sp[n],
                                              torch.as_tensor(initial[n]))]
    assert len(moved) == (len(sp) if train_bn else 0)


def test_remat_backbone_blocks_are_checkpointed(monkeypatch):
    """REMAT wraps each backbone block and each level's GridFusion and
    DepthCollapse in a checkpoint, only in training."""
    import mulit_view_object_detection_torch.models.detector as det
    import mulit_view_object_detection_torch.models.resnet as res
    calls = []

    def spy(module, x, stats=None):
        calls.append(type(module).__name__)
        return module(x, stats)

    monkeypatch.setattr(res, "checkpointed", spy)
    monkeypatch.setattr(det, "checkpointed", spy)
    cfg = TrainSlice()
    cfg.REMAT = True
    eng = MaskRCNN("training", cfg, "unused", device="cpu")
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2,
                                   image_size=128, num_classes=4, seed=0)
    from mulit_view_object_detection_torch.data.generator import make_batch
    batch = draw_priorities(eng.to_device(make_batch(ds, cfg, 1)), cfg,
                            torch.Generator().manual_seed(0))
    eng.model(batch, training=True)
    blocks = sum(len(names) for names in eng.model.backbone.stage_names)
    levels = 5                              # ZERO_PG_LEVELS = ()
    assert calls.count("Bottleneck") == blocks
    assert calls.count("GridFusion") == calls.count("DepthCollapse") == levels
    calls.clear()
    eng.model(batch)                        # inference: no remat
    assert not calls


# ---------------------------------------------------------------------------
# trilinear reprojection
# ---------------------------------------------------------------------------

def test_trilinear_project_grid_matches_jax():
    """Values and the gradient in the grid (for a seeded cotangent)
    against JAX project_grid(method="trilinear") within 1e-5; rays that
    leave the grid read zeros."""
    cfg = AllLevels()
    rng = np.random.RandomState(3)
    b, n, c, s, d = 2, 8, 5, 12, 6
    grid = rng.randn(b, n, n, n, c).astype(np.float32)
    kmat = np.stack([np.array([[f, 0, 64 + o], [0, f, 64 - o], [0, 0, 1]],
                              np.float32)
                     for f, o in ((110.0, 3.0), (160.0, -9.0))])
    cot = rng.randn(b, d, s, s, c).astype(np.float32)

    def f(g):
        return jax_project_grid(g, jnp.asarray(kmat), (128, 128), s, d,
                                cfg, method="trilinear")
    ref = np.asarray(f(jnp.asarray(grid)))
    ref_g = np.asarray(jax.grad(lambda g: jnp.sum(f(g) * cot))(
        jnp.asarray(grid)))
    gt = torch.from_numpy(grid).requires_grad_(True)
    got = project_grid_trilinear(gt, torch.from_numpy(kmat), (128, 128), s,
                                 d, cfg)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gt.grad.numpy(), ref_g, rtol=1e-5, atol=1e-5)
    assert (ref == 0).any() and (ref != 0).any()


class TrilinearSlice(AllLevels):
    NAME = "torch_trilinear_slice"
    TRILINEAR_REPROJECTION = True


def test_trilinear_detect_matches_jax():
    """A TRILINEAR_REPROJECTION forward against MaskRCNN.apply with the
    same weights: every output within test_slice_matches_jax's 1e-4."""
    got, ref = _run_both(TrilinearSlice())
    for key in ("rpn_class_logits", "rpn_probs", "rpn_bbox", "proposals",
                "mrcnn_class_logits", "mrcnn_probs", "mrcnn_bbox",
                "detections", "mrcnn_masks"):
        assert got[key].shape == ref[key].shape, key
        _close(got[key], ref[key], key)
    nearest, _ = _run_both(AllLevels())
    assert not np.allclose(nearest["rpn_probs"], got["rpn_probs"])


# ---------------------------------------------------------------------------
# checkpoints and the folded copy
# ---------------------------------------------------------------------------

def test_train_bn_statistics_round_trip_and_refold(tmp_path):
    """A TRAIN_BN engine (FOLD_BN on) trains an epoch: its statistics
    moved, a new engine restores them exactly from the checkpoint, and
    the folded inference copy is the fold of the updated statistics."""
    cfg = BNSlice()
    cfg.FOLD_BN = True
    ds = SyntheticMultiViewDataset(num_scenes=2, num_views=2,
                                   image_size=128, num_classes=4, seed=0)
    eng = MaskRCNN("training", cfg, str(tmp_path), device="cpu")
    folded_before = {k: v.clone()
                     for k, v in eng.inference_model().state_dict().items()}
    before = _stats(eng.model)
    eng.train(ds, None, 0.001, 1, "heads", prefetch_threads=1)
    after = _stats(eng.model)
    assert all(not torch.equal(after[n], before[n]) for n in after)

    eng2 = MaskRCNN("training", cfg, str(tmp_path), device="cpu")
    eng2.load_weights(eng.find_last())
    assert all(torch.equal(t, after[n]) for n, t in _stats(eng2.model).items())
    want = copy.deepcopy(eng.model)
    fold_bn_model(want)
    folded = eng.inference_model().state_dict()
    for k, v in want.state_dict().items():
        assert torch.equal(folded[k], v), k
    assert any(not torch.equal(folded[k], folded_before[k]) for k in folded
               if k.startswith("backbone."))


# ---------------------------------------------------------------------------
# no jax
# ---------------------------------------------------------------------------

def test_train_options_with_jax_blocked():
    """With jax, flax, optax and the JAX package made unimportable, an
    engine with TRAIN_BN, REMAT and TRILINEAR_REPROJECTION on takes two
    CPU train steps and a validation step, and its statistics move."""
    code = """
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
    VALIDATION_STEPS = 1
    TRAIN_BN = True
    REMAT = True
    TRILINEAR_REPROJECTION = True
    nvox = nvox_z = 4
    samples = 2

ds = SyntheticMultiViewDataset(num_scenes=1, num_views=2, image_size=64,
                               num_classes=3)
with tempfile.TemporaryDirectory() as d:
    eng = MaskRCNN("training", Tiny(), d, device="cpu")
    var0 = eng.model.backbone.bn_conv1.running_var.clone()
    eng.train(ds, ds, 0.001, 1, "all", prefetch_threads=1)
    assert not torch.equal(var0, eng.model.backbone.bn_conv1.running_var)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("TRAINED")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TRAINED" in proc.stdout and "val_loss=" in proc.stdout
