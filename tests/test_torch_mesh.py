"""The device mesh on the CPU (`parallel/mesh.py`): view sharding and
tensor parallelism over (data, view, model) process groups.

Without spawning:
* `param_spec` splits exactly the leaves that the JAX package's
  `param_spec` splits, on the same parameters in flax's layout, at a
  model axis of 2 and of 4, for the conv3d, lstm3d and transformer
  models (conv, transposed conv, dense and the attention's DenseGeneral
  kernels); JAX's function gets a stub mesh with `axis_names` and
  `shape`, all it reads. `shard_params` wraps exactly those layers;
  `shard_state_tp` slices a split leaf's momentum with it.
* `batch_sharding` and `shard_batch` cut the rows and views each mesh
  position holds; a count that the axis does not divide raises.
* A single-process `make_mesh()` gives a mesh of ones with no group, and
  a train step through `make_parallel_train_step` on it is bit-equal to
  today's `train_step`.
* VIEW_SHARDING is accepted.

One spawn of 4 gloo ranks (`torch.multiprocessing`), all cases in it, in
float64 (the transformer's forward in float32) at the JAX package's
mesh-test size
(`__graft_entry__._flagship_config(image_size=64, tiny=True)`: ResNet-50
with a 3-block stage 4, pyramid 32, a 4^3 grid, 2 samples; batch 2, 2
views) with every level fused (ZERO_PG_LEVELS = ()): at 64^2 every ROI
routes to P2, which the tiny config zeroes, and the heads would read
zeros. The batch holds 8 and 5 positive anchors in its two rows, at P2
and P4, so the losses' global denominators matter.
* Inference in every GridFusion mode (add, mean, ident, conv3d,
  lstm3d) and the transformer, views sharded on a (2, 2, 1) mesh, and
  conv3d, lstm3d and the transformer split by the TP rule on (2, 1, 2),
  against the one-process forward: every output within rtol 1e-5, atol
  2e-5 (the JAX bar, tests/test_parallel.py:78). VANILLA with sharded
  views raises.
* One conv3d train step on (2, 2, 1), (2, 1, 2) and (1, 2, 2), TRAIN_BN
  off and on, through `make_parallel_train_step` with view sharding,
  against the port's one-process step on the same global batch and ROI
  priorities: the losses within 1e-6 relative, and every parameter
  (split ones gathered) and statistic within 1e-6 of its update's norm
  (a floor of 1e-9 of the step's largest update for the conv biases
  before a batch-statistics BatchNorm, whose exact gradient is zero, so
  that they move by rounding alone). Every whole parameter bit-equal
  across the ranks that share it; a split one stays split.
* That one-process step against the JAX package's single-device
  make_train_step on the same weights, batch and ROI priorities, in
  float64, TRAIN_BN off and on (two more spawned processes, beside the
  ranks; each also runs JAX on the batch nudged by one float32 rounding
  step, for JAX's own spread): so mesh == one process == JAX on the
  same inputs.
* Every one of these steps trains the box and mask heads: the batch's
  ground truth boxes lie on proposals of the seeded model, so positive
  ROIs reach them (`mrcnn_bbox_loss` and `mrcnn_mask_loss` above 0).
* A (1, 1, 2) mesh (ranks 2 and 3 outside it): one step, a checkpoint
  saved from both ranks, loaded in one process bit-equal to the
  gathered state, momentum included; restored into a new split model,
  each rank's slices bit-equal to its own. FOLD_BN on a split model
  raises.
"""

import copy
import hashlib
import os
import socket
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from mulit_view_object_detection_torch.config import (  # noqa: E402
    Config, check_supported)
from mulit_view_object_detection_torch.kernels import unproject  # noqa: E402
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as DetectorModel, make_dummy_batch)
from mulit_view_object_detection_torch.models.layers import (  # noqa: E402
    ColumnParallel, Conv2d, Linear, set_compute_dtype, shard_of)
from mulit_view_object_detection_torch.parallel import (  # noqa: E402
    Mesh, batch_sharding, init_distributed, make_mesh,
    make_parallel_train_step, param_spec, shard_batch, shard_params,
    shard_state_tp)
from mulit_view_object_detection_torch.train.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint, whole_state)
from mulit_view_object_detection_torch.train.optim import (  # noqa: E402
    make_optimizer)
from mulit_view_object_detection_torch.train.step import (  # noqa: E402
    draw_priorities, train_step)
from mulit_view_object_detection_torch.train.trainable import (  # noqa: E402
    param_paths, trainable_mask)
from mulit_view_object_detection_torch.utils.bn_fold import (  # noqa: E402
    fold_bn_model)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)

JOIN_S = 300          # every spawned rank must end within this
MODES = ("add", "mean", "ident", "conv3d", "lstm3d", "transformer")
# split by the TP rule: grouped, transposed, 3-D and dense layers and the
# attention's DenseGeneral with its 2-D biases
TP_MODES = ("conv3d", "lstm3d", "transformer")
MESHES = ((2, 2, 1), (2, 1, 2), (1, 2, 2))
F64 = torch.float64


class MeshTiny(Config):
    """The port's copy of `__graft_entry__._flagship_config(image_size=64,
    tiny=True)` (without PHASE_DECONV, a TPU lowering), a batch of 2,
    every level fused."""
    NAME = "mesh_tiny"
    NUM_CLASSES = 23
    NUM_VIEWS = 2
    BACKBONE = "resnet50"
    RESNET50_STAGE4_BLOCKS = 3
    TOP_DOWN_PYRAMID_SIZE = 32
    GRID_REAS = "conv3d"
    IMAGE_MIN_DIM = IMAGE_MAX_DIM = 64
    RPN_ANCHOR_SCALES = (16, 32, 64, 128, 256)
    PRE_NMS_LIMIT = 64
    POST_NMS_ROIS_TRAINING = 8
    POST_NMS_ROIS_INFERENCE = 8
    TRAIN_ROIS_PER_IMAGE = 8
    DETECTION_MAX_INSTANCES = 4
    MAX_GT_INSTANCES = 4
    FPN_CLASSIF_FC_LAYERS_SIZE = 128
    RPN_TRAIN_ANCHORS_PER_IMAGE = 64
    nvox = nvox_z = 4
    vmin, vmax = -2.5, 2.5
    vmin_z, vmax_z = 1.0, 10.0
    samples = 2
    ZERO_PG_LEVELS = ()
    IMAGES_PER_GPU = 2


def _config(mode="conv3d", **extra):
    name = "_".join(["MeshTiny", mode] + [f"{k}{v}" for k, v in
                                          sorted(extra.items())])
    if mode == "transformer":
        extra = dict(dict(TRANSFORMER=True, GRID_REAS="ident",
                          TOP_DOWN_PYRAMID_SIZE=24, XFORMER_D_MODEL=24,
                          XFORMER_NUM_HEADS=4, XFORMER_DFF=32,
                          XFORMER_NUM_LAYERS=2, samples=1), **extra)
    else:
        extra = dict(GRID_REAS=mode, **extra)
    return type(name, (MeshTiny,), extra)()


# Three ground truth boxes a row, on proposals that the seeded model makes
# (with TRAIN_BN off and on; the proposals do not depend on the ground
# truth): each mode has at least 2 proposals a row with an IoU >= 0.5,
# so positive ROIs reach the box and mask heads, and every proposal's
# best IoU is at least 0.13 from the 0.5 edge, so rounding cannot move a
# proposal across it.
GT_BOXES = np.array([
    [[0.03125, 0.578125, 0.84375, 1.0], [0.25, 0.09375, 0.484375, 0.359375],
     [0.25, 0.140625, 0.5, 0.453125]],
    [[0.0, 0.53125, 0.5625, 1.0], [0.171875, 0.53125, 0.875, 1.0],
     [0.0625, 0.21875, 0.3125, 0.546875]]], np.float32)
GT_CLASS_IDS = np.array([[1, 4, 7], [3, 2, 9]], np.int32)


def _host_batch(cfg):
    """JAX's mesh-test batch (tests/test_parallel.py:163-176) in float64,
    its two rows different: 8 and 5 positive anchors, at P2 and P4, every
    class active; its ground truth GT_BOXES, each mini-mask its left
    half."""
    b = make_dummy_batch(cfg, training=True, batch_size=2, num_views=2,
                         image_size=64)
    rng = np.random.RandomState(11)
    b["images"] = rng.randn(*b["images"].shape).astype(np.float32) * 30.0
    b["image_meta"][:, 12:] = 1.0                  # active class ids
    g = GT_BOXES.shape[1]
    b["gt_class_ids"][:, :g] = GT_CLASS_IDS
    b["gt_boxes"][:, :g] = GT_BOXES
    b["gt_masks"][:, :g, :, :b["gt_masks"].shape[-1] // 2] = 1.0
    n = b["anchors"].shape[0]
    p4 = 16 * 16 * 3 + 8 * 8 * 3                   # P4's first anchor
    match = np.zeros((2, n), np.int32)
    match[:, 8:64] = -1
    match[:, p4 + 10:p4 + 30] = -1
    match[0, [0, 1, 2, 3, 4, p4, p4 + 1, p4 + 2]] = 1
    match[1, [5, 6, p4 + 3, p4 + 4, p4 + 5]] = 1
    b["rpn_match"] = match
    b["rpn_bbox"] = np.zeros((2, cfg.RPN_TRAIN_ANCHORS_PER_IMAGE, 4),
                             np.float32)
    b["rpn_bbox"][:, :8] = rng.uniform(-1, 1, (2, 8, 4))
    if cfg.TRANSFORMER:
        # float32, its pixels scaled as tests/test_torch_slice3.py scales
        # them: random weights give P5 tokens that saturate the softmax
        b["depths"] = rng.uniform(1.0, 5.0, b["depths"].shape)
        b["images"] *= np.float32(1 / 64)
        return b
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in b.items()}


_TEMPLATES = {}


def _quick_trunc_normal(t, mean, std, a, b, generator=None):
    return t.normal_(mean, std, generator=generator).clamp_(a, b)


def _bare_model(cfg):
    """The detector's model for `cfg`, its parameters left as allocated
    (torch's default initialisation skipped: the seeded one overwrites
    every parameter)."""
    keep = lambda t, *args, **kwargs: t                # noqa: E731
    with mock.patch.object(torch.nn.init, "kaiming_uniform_", keep), \
            mock.patch.object(torch.nn.init, "uniform_", keep):
        return DetectorModel(cfg)


def _model(cfg):
    """A copy of the model of `cfg`'s fusion mode from seeded weights, in
    float64; the transformer in float32 (its LayerNorms normalise in
    float32, as flax's do). Each mode's model is built once a process,
    its lecun-normal kernels clipped at 2 std rather than redrawn there
    (a quicker stand-in: the test compares processes, not
    initialisations); the copy reads `cfg` (TRAIN_BN, VANILLA)."""
    key = "transformer" if cfg.TRANSFORMER else cfg.GRID_REAS
    if key not in _TEMPLATES:
        dtype = torch.float32 if cfg.TRANSFORMER else F64
        model = _bare_model(cfg)
        with mock.patch.object(torch.nn.init, "trunc_normal_",
                               _quick_trunc_normal):
            model.init_weights(torch.Generator().manual_seed(3))
        model.to(dtype)
        set_compute_dtype(model, dtype)
        model.compute_dtype = dtype
        _TEMPLATES[key] = model
    model = copy.deepcopy(_TEMPLATES[key])
    model.config = cfg
    return model


def _float32(model):
    model.float()
    set_compute_dtype(model, torch.float32)
    model.compute_dtype = torch.float32
    return model


def _tensors(batch):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32
            else torch.as_tensor(v) for k, v in batch.items()}


def _infer(cfg, batch, mesh=None):
    """The inference outputs of `cfg`'s model on `batch` (this rank's
    part of it on `mesh`, the model split by the TP rule there)."""
    model = _model(cfg)
    if mesh is not None:
        shard_params(model, mesh)
    with torch.no_grad():
        out = model(_tensors(batch), training=False, mesh=mesh)
    return {k: v.clone() for k, v in out.items()}


def _step(cfg, mesh=None):
    """One train step at stage "all" from the seeded weights on the
    global batch: through make_parallel_train_step on `mesh` with view
    sharding (the model split by the TP rule first), else train_step on
    one process. Returns the metrics, the state before and after (split
    parameters gathered) and this rank's own parameters."""
    model = _model(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model.parameters(), cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)
    mask = trainable_mask(model, "all")
    gen = torch.Generator().manual_seed(0)
    host = _host_batch(cfg)
    if mesh is None:
        metrics = train_step(model, opt, _tensors(host), cfg, mask, gen)
    else:
        shard_state_tp(model, opt, mesh)
        step = make_parallel_train_step(train_step, mesh, view_sharding=True)
        metrics = step(model, opt, host, cfg, mask, gen)
    after, _ = whole_state(model)
    return {"metrics": metrics, "before": before, "after": after,
            "own": {n: (p.detach(), shard_of(p) is not None)
                    for n, p in model.named_parameters()}}


def _digests(tensors):
    """{name: sha1 of the tensor's bytes}: bit-equality without moving
    the tensors between processes."""
    return {k: hashlib.sha1(t.detach().contiguous().numpy().tobytes())
            .hexdigest() for k, t in tensors.items()}


def _summary(ref, got):
    """What the parent checks of a mesh step against the one-process
    `ref`: both metrics, each state tensor's distance from the
    reference's and the reference's update norm, and digests."""
    before, want = ref["before"], ref["after"]
    return {"metrics": got["metrics"], "ref_metrics": ref["metrics"],
            "errors": {k: (float((got["after"][k] - w).norm()),
                           float((w - before[k]).norm()))
                       for k, w in want.items()},
            "after": _digests(got["after"]),
            "own": {n: (_digests({n: t})[n], split)
                    for n, (t, split) in got["own"].items()}}


def _checkpoint_case(mesh, outdir):
    """(1, 1, 2), in float32: one step, save, restore into a new split
    model. Returns the digests of the whole state and momentum."""
    cfg = _config()
    model = _float32(_model(cfg))
    opt = make_optimizer(model.parameters(), cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)
    shard_state_tp(model, opt, mesh)
    with pytest.raises(ValueError, match="tensor-parallel"):
        fold_bn_model(model)
    step = make_parallel_train_step(train_step, mesh, view_sharding=True)
    host = {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in _host_batch(cfg).items()}
    step(model, opt, host, cfg, trainable_mask(model, "all"),
         torch.Generator().manual_seed(0))
    ckpt = os.path.join(outdir, "ckpt")
    save_checkpoint(ckpt, model, opt, step=1)
    whole, whole_opt = whole_state(model, opt)
    dist.barrier(group=mesh.model_group)
    fresh = _float32(_model(cfg))
    fresh_opt = make_optimizer(fresh.parameters(), cfg.LEARNING_RATE,
                               cfg.LEARNING_MOMENTUM)
    shard_state_tp(fresh, fresh_opt, mesh)
    assert restore_checkpoint(ckpt, fresh, fresh_opt) == 1
    for (n, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           fresh_opt.state[q]["momentum_buffer"]), n
    return {"whole": _digests(whole), "momentum": _digests(
        {i: st["momentum_buffer"] for i, st in whole_opt["state"].items()})}


def _rank(rank, port, outdir):
    torch.set_num_threads(1)
    # the plain geometry gathers run in float64 on the CPU; the wrappers'
    # check is the kernels' (float32, bfloat16)
    unproject._check_device = lambda t, what: None
    assert init_distributed(f"127.0.0.1:{port}", 4, rank, backend="gloo")
    try:
        out = {}
        mesh = make_mesh(2, 2, 1)
        for mode in MODES:
            cfg = _config(mode)
            out[("infer", mode)] = _infer(cfg, shard_batch(
                _host_batch(cfg), batch_sharding(mesh, True)), mesh)
        mesh = make_mesh(2, 1, 2)
        for mode in TP_MODES:
            cfg = _config(mode)
            out[("infer_tp", mode)] = _infer(cfg, shard_batch(
                _host_batch(cfg), batch_sharding(mesh)), mesh)
        mesh = make_mesh(2, 2, 1)
        with pytest.raises(ValueError, match="VANILLA"):
            _infer(_config(VANILLA=True), shard_batch(
                _host_batch(_config()), batch_sharding(mesh, True)), mesh)
        for train_bn in (False, True):
            # the one-process step, the same in every rank
            ref = _step(_config(TRAIN_BN=train_bn))
            for shape in MESHES:
                mesh = make_mesh(*shape)
                out[("step", shape, train_bn)] = _summary(
                    ref, _step(_config(TRAIN_BN=train_bn), mesh))
            del ref
        mesh = make_mesh(1, 1, 2)
        if mesh.member:
            out["checkpoint"] = _checkpoint_case(mesh, outdir)
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class _Drawn:
    """`jax.random` for the JAX package's ops/targets.py with its draws
    given: the "key" is the batch's [B, 2, P] priorities; `split` of it
    gives its rows, of a row its (positive, negative) halves, and
    `uniform` returns a half as the draw."""

    @staticmethod
    def split(key, num=2):
        return key if key.ndim == 3 else (key[0], key[1])

    @staticmethod
    def uniform(key, shape):
        assert key.shape == shape
        return key


def _jax_step(cfg, model, hosts, priorities):
    """JAX make_train_step's single-device step from `model`'s weights on
    each host batch of `hosts` (one jitted step for all), with its ROI
    sampling drawing `priorities` (the port's, [2, B, P]) in place of its
    uniform draws, computed in float64 (its modules' compute dtype
    patched, jax's x64 mode on). Returns, for each batch, (the step's
    change of each parameter and statistic as a state_dict, the
    metrics). The change, not the new value: the converter rounds to
    float32, which keeps a change to 6e-8 of itself but would round away
    one below a weight's float32 spacing."""
    import jax
    import jax.numpy as jnp
    import mulit_view_object_detection_tpu.models.detector as jdetector
    import mulit_view_object_detection_tpu.ops.targets as jtargets
    from mulit_view_object_detection_tpu.train.optim import (
        make_optimizer as jax_make_optimizer)
    from mulit_view_object_detection_tpu.train.step import (
        TrainState, make_train_step)

    variables = torch_to_flax(model.state_dict())
    tx = jax_make_optimizer(cfg.LEARNING_RATE, cfg.LEARNING_MOMENTUM,
                            cfg.GRADIENT_CLIP_NORM)
    out = []
    with pytest.MonkeyPatch.context() as m, jax.enable_x64(True):
        drawn = jnp.asarray(np.stack([p.numpy() for p in priorities], 1),
                            jnp.float64)
        m.setattr(jtargets, "jax", types.SimpleNamespace(
            random=_Drawn, lax=jax.lax, vmap=jax.vmap))
        m.setattr(jdetector, "detection_targets_batch",
                  lambda rng, *a, **kw: jtargets.detection_targets_batch(
                      drawn, *a, **kw))
        m.setattr(jdetector.MaskRCNN, "_dtype", lambda self: jnp.float64)
        # the weights in float64, as the port's: a float32 weight would
        # round away an update below its spacing
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"]))
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats,
                           opt_state=tx.init(params), tx=tx,
                           apply_fn=jdetector.MaskRCNN(cfg).apply)
        step = make_train_step(cfg, "all", donate=False)
        for host in hosts:
            new_state, metrics = step(
                state, {k: jnp.asarray(v) for k, v in host.items()},
                jax.random.PRNGKey(0))
            change = flax_to_torch(jax.tree_util.tree_map(
                lambda new, old: np.asarray(new - old),
                {"params": new_state.params,
                 "batch_stats": new_state.batch_stats},
                {"params": params, "batch_stats": stats}))
            out.append((change, {k: float(v) for k, v in metrics.items()}))
    return out


def _nudged(host):
    """`host` with every pixel moved by one float32 rounding step (a
    relative 2^-23, its sign drawn from a seeded RandomState)."""
    sign = np.random.RandomState(0).choice([-1.0, 1.0],
                                           host["images"].shape)
    return dict(host, images=host["images"] * (1 + 2.0 ** -23 * sign))


def _priorities(cfg, host):
    """The ROI priorities the port's one-process step draws (its
    generator seeded 0): (positive, negative), each [B, P]."""
    pri = draw_priorities({"images": torch.zeros(host["images"].shape)},
                          cfg, torch.Generator().manual_seed(0))
    return pri["pos_priority"], pri["neg_priority"]


def _jax_rank(train_bn, outdir):
    """A process of its own: the JAX step of the one-process check, XLA
    on one thread (the ranks run beside it)."""
    os.environ["XLA_FLAGS"] = " ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_cpu_multi_thread_eigen=false",
        "intra_op_parallelism_threads=1")))
    cfg = _config(TRAIN_BN=train_bn)
    host = _host_batch(cfg)
    (change, metrics), (nudged, _) = _jax_step(
        cfg, _model(cfg), (host, _nudged(host)), _priorities(cfg, host))
    torch.save({"change": change, "metrics": metrics, "spread": {
        k: float((nudged[k] - c).norm()) for k, c in change.items()}},
               os.path.join(outdir, f"jax_{train_bn}.pt"))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _references():
    """The one-process forwards the ranks are held to, by mode, and the
    one-process steps, by TRAIN_BN, on one thread as the ranks run."""
    unproject_check = unproject._check_device
    unproject._check_device = lambda t, what: None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ({mode: _infer(_config(mode), _host_batch(_config(mode)))
                 for mode in MODES},
                {train_bn: _step(_config(TRAIN_BN=train_bn))
                 for train_bn in (False, True)})
    finally:
        unproject._check_device = unproject_check
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(their directory, the 4 ranks' results {rank: {case: ...}}, the
    one-process forwards, the one-process steps, the JAX steps {TRAIN_BN:
    ...}), the one-process runs computed while the ranks run, the two JAX
    steps in two processes of their own beside them."""
    outdir = tmp_path_factory.mktemp("mesh")
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, port, str(outdir)))
             for r in range(4)]
    procs += [ctx.Process(target=_jax_rank, args=(train_bn, str(outdir)))
              for train_bn in (False, True)]
    for p in procs:
        p.start()
    try:
        refs, steps = _references()
        for p in procs:
            p.join(timeout=JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    load = lambda name: torch.load(outdir / name,         # noqa: E731
                                   weights_only=False)
    return (outdir, {r: load(f"rank{r}.pt") for r in range(4)}, refs, steps,
            {train_bn: load(f"jax_{train_bn}.pt")
             for train_bn in (False, True)})


def _assert_heads_trained(metrics, where):
    """Positive ROIs reached the box and mask heads in this step."""
    for k in ("mrcnn_bbox_loss", "mrcnn_mask_loss"):
        assert metrics[k] > 0, (where, k, metrics[k])


# ---------------------------------------------------------------------------
# without spawning
# ---------------------------------------------------------------------------

def _stub_mesh(m):
    """What JAX's param_spec reads of a mesh, and the port's Mesh."""
    shape = {"data": 1, "view": 1, "model": m}
    return (types.SimpleNamespace(axis_names=tuple(shape), shape=shape),
            Mesh(shape, {"data": 0, "view": 0, "model": 0}, {}))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("mode", ["conv3d", "lstm3d", "transformer"])
def test_param_spec_splits_the_leaves_jax_splits(mode, m):
    jax_mesh = pytest.importorskip(
        "mulit_view_object_detection_tpu.parallel.mesh")
    stub, mesh = _stub_mesh(m)
    model = _bare_model(_config(mode))
    params = dict(model.named_parameters())
    flax = torch_to_flax(model.state_dict())["params"]
    split = set()
    for name, path in param_paths(model).items():
        leaf = flax
        for key in path:
            leaf = leaf[key]
        want = jax_mesh.param_spec(leaf, stub)
        got = param_spec(path, tuple(params[name].shape), mesh)
        assert bool(want) == bool(got), (name, want, got)
        if got:
            split.add(name)
            assert tuple(want)[-1] == "model" and len(got) == leaf.ndim
            # the split torch dimension holds flax's last one
            assert params[name].shape[got.index("model")] == leaf.shape[-1]
    assert len(split) >= 10
    shard_params(model, types.SimpleNamespace(
        size=mesh.size, shape=mesh.shape, coord=mesh.coord,
        model_group=None))
    wrapped = {n + ".weight" for n, mod in model.named_modules()
               if isinstance(mod, ColumnParallel)}
    assert wrapped == {n for n in split if n.endswith(".weight")}
    assert all(n[:-4] + "weight" in wrapped for n in split
               if n.endswith(".bias"))


def test_shard_state_tp_slices_the_momentum_of_split_leaves():
    """After a step, the second of 2 model ranks keeps its half of the
    split conv's weight and momentum (the optimizer's own parameter
    objects); the Linear with 3 outputs (not a multiple of 2) and every
    bias stay whole."""
    model = torch.nn.Module()
    model.conv = Conv2d(4, 8, 3)
    model.lin = Linear(8, 3)
    opt = make_optimizer(model.parameters(), 0.1, 0.9)
    model.lin(model.conv(torch.randn(2, 4, 5, 5)).mean((2, 3))).sum(
        ).backward()
    opt.step()
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    momentum = {n: opt.state[p]["momentum_buffer"].clone()
                for n, p in model.named_parameters()}
    _, mesh = _stub_mesh(2)
    shard_state_tp(model, opt, types.SimpleNamespace(
        size=mesh.size, shape=mesh.shape, model_group=None,
        coord=lambda axis: 1 if axis == "model" else 0))
    assert isinstance(model.conv, ColumnParallel)
    assert isinstance(model.lin, Linear)
    for n, p in model.named_parameters():
        split = n == "conv.weight"
        assert (shard_of(p) is not None) == split, n
        want = whole[n][4:] if split else whole[n]
        assert torch.equal(p, want), n
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           momentum[n][4:] if split else momentum[n]), n
    assert opt.param_groups[0]["params"][0] is model.conv.weight


def test_batch_sharding_and_shard_batch_cut_rows_and_views():
    cfg = _config()
    host = _host_batch(cfg)
    host["images"] = np.arange(2 * 2 * 64 * 64 * 3, dtype=np.float64
                               ).reshape(host["images"].shape)
    for d in (0, 1):
        for v in (0, 1):
            mesh = Mesh({"data": 2, "view": 2}, {"data": d, "view": v}, {})
            for view_sharding in (False, True):
                local = shard_batch(host, batch_sharding(mesh,
                                                         view_sharding))
                views = slice(v, v + 1) if view_sharding else slice(None)
                np.testing.assert_array_equal(
                    local["images"], host["images"][d:d + 1, views])
                for k in ("Rcam", "Kmat", "image_meta", "rpn_match",
                          "gt_masks"):
                    np.testing.assert_array_equal(local[k], host[k][d:d + 1])
                np.testing.assert_array_equal(local["anchors"],
                                              host["anchors"])
    three = Mesh({"data": 3, "view": 1}, {"data": 0, "view": 0}, {})
    with pytest.raises(ValueError, match="split"):
        shard_batch(host, batch_sharding(three))
    single_view = {"images": host["images"][:, :1]}
    with pytest.raises(ValueError, match="split"):
        shard_batch(single_view, batch_sharding(mesh, True))


def test_single_process_mesh_step_is_bit_equal_to_train_step():
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "view": 1}
    assert mesh.coords == {"data": 0, "view": 0}
    assert all(getattr(mesh, f"{g}_group") is None
               for g in ("data", "view", "model", "data_view"))
    with pytest.raises(ValueError, match="processes"):
        make_mesh(view=2)
    cfg = _config()
    unproject_check = unproject._check_device
    unproject._check_device = lambda t, what: None
    try:
        ref, got = _step(cfg), _step(cfg, mesh)
    finally:
        unproject._check_device = unproject_check
    assert got["metrics"] == ref["metrics"]
    _assert_heads_trained(got["metrics"], "make_mesh()")
    for k, t in ref["after"].items():
        assert torch.equal(got["after"][k], t), k


def test_view_sharding_is_accepted():
    cfg = _config()
    cfg.VIEW_SHARDING = True
    check_supported(cfg)


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case, modes", [("infer", MODES),
                                         ("infer_tp", TP_MODES)])
def test_sharded_forward_matches_one_process(ranks, case, modes):
    """"infer": the views sharded on (2, 2, 1); "infer_tp": the layers
    split on (2, 1, 2). Each rank's row of every output against the
    one-process forward's."""
    _, results, refs, _, _ = ranks
    for mode in modes:
        ref = refs[mode]
        for r in range(4):
            d = r // 2
            got = results[r][(case, mode)]
            assert set(got) == set(ref)
            for k, want in ref.items():
                np.testing.assert_allclose(
                    got[k].numpy(), want[d:d + 1].numpy(), rtol=1e-5,
                    atol=2e-5, err_msg=f"{case} {mode} {k} rank {r}")


@pytest.mark.parametrize("train_bn", [False, True])
def test_mesh_train_steps_match_one_process(ranks, train_bn):
    """Losses within 1e-6 relative: the port computes every loss in
    float32 (models/losses.py, as the JAX package does), so in a float64
    step they agree to float32 rounding, the ranks' shares summed in
    another order than one process sums them. Every state tensor within
    1e-6 of
    its update's norm (floor: 1e-9 of the step's largest update); the
    ranks bit-equal; whole parameters whole on every rank, split ones
    split where the mesh has a model axis."""
    _, results, _, _, _ = ranks
    for shape in MESHES:
        case = (shape, train_bn)
        got = [results[r][("step", shape, train_bn)] for r in range(4)]
        for k, v in got[0]["ref_metrics"].items():
            assert got[0]["metrics"][k] == pytest.approx(v, rel=1e-6), \
                (case, k)
        errors = got[0]["errors"]
        floor = 1e-9 * max(u for _, u in errors.values())
        for k, (err, upd) in errors.items():
            assert err <= 1e-6 * max(upd, floor), (case, k, err, upd)
        moved = sum(u > 0 for _, u in errors.values())
        assert moved > len(errors) // 2, (case, moved)
        for r in range(4):
            _assert_heads_trained(got[r]["metrics"], (case, r))
        split = {n for n, (_, s) in got[0]["own"].items() if s}
        for r in range(1, 4):
            assert got[r]["metrics"] == got[0]["metrics"], (case, r)
            assert got[r]["after"] == got[0]["after"], (case, r)
            for n, (digest, s) in got[0]["own"].items():
                assert s == got[r]["own"][n][1], (case, n, r)
                if not s:
                    assert got[r]["own"][n][0] == digest, (case, n, r)
        assert bool(split) == (shape[2] > 1), case


@pytest.mark.parametrize("train_bn", [False, True])
def test_one_process_step_matches_jax(ranks, train_bn):
    """The one-process step that the mesh steps are held to, at their
    config and batch (MeshTiny, 64^2, every level fused, float64), is the
    JAX package's single-device step: JAX make_train_step from the same
    weights on the same batch with the same ROI priorities, computed in
    float64 (weights included). The parent's one-process step is the
    ranks' reference (their metrics equal), so mesh == one process ==
    JAX on the same inputs. Positive ROIs train the box and mask heads
    on both sides. The losses within 1e-5 relative. Every parameter's and
    statistic's change within 1e-4 of its norm (floor: 1e-9 of the
    step's largest change; tests/test_torch_train_options.py holds its
    float64 steps to 1e-4 as well), or within JAX's own nudge spread:
    how far JAX's change moves when every pixel moves by one float32
    rounding step (`_nudged`). Both packages compute the losses in
    float32 and sum in other orders, and with TRAIN_BN every
    batch-statistics BatchNorm amplifies that rounding, most in the mask
    head, whose changes are the step's smallest (on the CPU: losses
    within 2.6e-7; changes within 1e-4 without TRAIN_BN; with it 170 of
    548 beyond 1e-4, up to 2.3e-3 in the mask head, each within 0.81 of
    its spread)."""
    _, results, _, steps, jax_steps = ranks
    ref = steps[train_bn]
    change, metrics, spread = (jax_steps[train_bn][k]
                               for k in ("change", "metrics", "spread"))
    for shape in MESHES:
        assert results[0][("step", shape, train_bn)]["ref_metrics"] == \
            ref["metrics"], shape
    assert set(metrics) == set(ref["metrics"])
    _assert_heads_trained(ref["metrics"], "one process")
    _assert_heads_trained(metrics, "JAX")
    for k, v in metrics.items():
        assert ref["metrics"][k] == pytest.approx(v, rel=1e-5), (k, v)
    assert set(change) == set(ref["after"])
    errors = {k: (float((ref["after"][k] - ref["before"][k] - c).norm()),
                  float(c.norm())) for k, c in change.items()}
    floor = 1e-9 * max(u for _, u in errors.values())
    for k, (err, upd) in errors.items():
        assert err <= max(1e-4 * max(upd, floor), spread[k]), \
            (k, err, upd, spread[k])


def test_tensor_parallel_checkpoint_loads_in_one_process(ranks):
    outdir, results, _, _, _ = ranks
    assert "checkpoint" not in results[2] and "checkpoint" not in results[3]
    saved = results[0]["checkpoint"]
    assert results[1]["checkpoint"] == saved
    cfg = _config()
    model = _float32(_model(cfg))
    opt = make_optimizer(model.parameters(), cfg.LEARNING_RATE,
                         cfg.LEARNING_MOMENTUM)
    assert restore_checkpoint(str(outdir / "ckpt"), model, opt) == 1
    assert _digests(model.state_dict()) == saved["whole"]
    state = opt.state_dict()["state"]
    assert _digests({i: st["momentum_buffer"] for i, st in state.items()}
                    ) == saved["momentum"]
