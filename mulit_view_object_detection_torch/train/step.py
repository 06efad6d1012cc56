"""Train and validation steps.

Port of `mulit_view_object_detection_tpu/train/step.py`: the forward with
on-device ROI sampling, the five losses plus L2 regularization, gradients
masked to the trainable stage, per-tensor clipnorm, an SGD-with-momentum
update. Where the JAX step draws the sampling priorities from its
"sampling" key inside the model, this step draws them from an explicit
torch.Generator (`draw_priorities`) and puts them in the batch; the
transformer's dropout, which the JAX step draws from its "dropout" key,
draws its masks from the same generator.

With TRAIN_BN the step writes every BatchNorm's running statistics once,
from the forward's batch statistics, frozen stages included (JAX
step.py:87-109 keeps the new batch_stats whatever the stage mask); the
validation step writes none (step.py:119-138).

Data parallelism (`group`, a torch.distributed process group; None for
one process): each rank holds its rows of the global batch and computes
its share of the global loss (the losses' denominators and TRAIN_BN's
statistics are the global batch's); the gradients are summed over the
ranks, and the L2 term is counted on the group's first rank only, so
every rank steps with the gradient of the global-batch loss. The ROI
priorities of a rank's scenes are the rows a single process would draw
for them from the same generator, so the generator must be the same on
every rank. The transformer's dropout masks, drawn after them, are not
the single process's (not checked under a group).

A mesh (`parallel/mesh.py::Mesh`, in place of the group) adds view
sharding and tensor parallelism: the losses' denominators, the ROI
priorities and the reported losses use its data group; the gradients
of the modules before the views' gather (`models/detector.py::
UPSTREAM`) are summed over the data x view group when the views are
sharded, every other gradient over the data group, none over the model
group. The view and model ranks of one data slot draw the same rows and
the same dropout masks. The L2 term is added once to every gradient
that is then summed: for the upstream parameters on one rank of the
data x view group, for the others on data rank 0 of every view rank,
each model rank adding its own slice's share of a split leaf; the
reported L2 is the whole tensors' on every rank. The ranks that compute
the same thing apart (the view ranks after the gather, the model ranks
for a whole layer) end each step with the first one's gradients,
statistics and metrics (`_sync_replicas`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models import losses as L
from ..models.detector import UPSTREAM, view_group_of
from ..models.layers import shard_of
from ..models.resnet import BatchStats
from ..ops.image_meta import parse_image_meta
from ..parallel.distributed import all_reduce_gradients, broadcast_tensors
from ..parallel.mesh import as_mesh
from .optim import clip_per_tensor_norm, l2_terms, mask_gradients
from .trainable import param_paths


def compute_losses(outputs, batch, config, group=None):
    """The five losses from the training outputs and the host-built RPN
    targets (batch "rpn_match", "rpn_bbox"); under `group`, this rank's
    shares of the global batch's losses."""
    active = parse_image_meta(batch["image_meta"])["active_class_ids"]
    return {
        "rpn_class_loss": L.rpn_class_loss(batch["rpn_match"],
                                           outputs["rpn_class_logits"],
                                           group),
        "rpn_bbox_loss": L.rpn_bbox_loss(batch["rpn_bbox"],
                                         batch["rpn_match"],
                                         outputs["rpn_bbox"], group),
        "mrcnn_class_loss": L.mrcnn_class_loss(
            outputs["target_class_ids"], outputs["mrcnn_class_logits"],
            active, group),
        "mrcnn_bbox_loss": L.mrcnn_bbox_loss(
            outputs["target_deltas"], outputs["target_class_ids"],
            outputs["mrcnn_bbox"], group),
        "mrcnn_mask_loss": L.mrcnn_mask_loss(
            outputs["target_masks"], outputs["target_class_ids"],
            outputs["mrcnn_masks"], group),
    }


def draw_priorities(batch, config, generator, group=None):
    """Add the ROI sampling priorities (two [B, POST_NMS_ROIS_TRAINING]
    uniform draws, positives then negatives) to `batch`, drawn from
    `generator` on its own device and moved to the images' device, and
    the generator itself as "dropout_generator" (the transformer's
    dropout draws from it during the forward). Under `group` the draw is
    the global batch's (B times the group's size rows) and this rank
    takes its own rows; under a mesh, the rows of its data coordinate."""
    b = batch["images"].shape[0]
    mesh = as_mesh(group)
    rank, size = mesh.coord("data"), mesh.size("data")
    shape = (2, b * size, config.POST_NMS_ROIS_TRAINING)
    pri = torch.rand(shape, generator=generator, device=generator.device)
    pri = pri[:, rank * b:(rank + 1) * b].to(batch["images"].device)
    return dict(batch, pos_priority=pri[0], neg_priority=pri[1],
                dropout_generator=generator)


def loss_and_grads(model, batch, config, mask, group=None):
    """Forward (training graph) and backward; TRAIN_BN's running
    statistics written once. `batch` carries the priorities; `group` is
    None, a data-parallel process group or a Mesh. Returns (total loss
    with L2, the five losses) as tensors (this rank's shares of the
    global batch's under a group or mesh, which its data group sums);
    the gradients, summed as the module's docstring says and masked to
    `mask`, are in each parameter's .grad."""
    mesh = as_mesh(group)
    data = mesh.data_group
    named = list(model.named_parameters())
    for _, p in named:
        p.grad = None
    views_sharded = view_group_of(mesh, batch["images"].shape[1],
                                  config.NUM_VIEWS) is not None
    stats = BatchStats(data)
    outputs = model(batch, training=True, stats=stats, mesh=mesh)
    parts = compute_losses(outputs, batch, config, data)
    total = L.total_loss(parts, config.LOSS_WEIGHTS)
    paths = param_paths(model)
    upstream = {n for n, _ in named if n.split(".")[0] in UPSTREAM}
    first_view = not views_sharded or mesh.coord("view") == 0
    terms = dict(l2_terms(named, paths, mask))
    # this rank's L2 terms: each counted once in the sum its gradient joins
    own = [t for n, t in terms.items() if mesh.coord("data") == 0
           and (first_view or n not in upstream)]
    loss = total
    if own:
        loss = total + config.WEIGHT_DECAY * torch.stack(own).sum()
    loss.backward()
    summed_over_views = upstream if views_sharded else set()
    _reduce([p for n, p in named if n in summed_over_views],
            mesh.data_view_group)
    _reduce([p for n, p in named if n not in summed_over_views], data)
    _sync_replicas(named, summed_over_views, mesh)
    mask_gradients(named, mask)
    committed = [bn for bn, _, _ in stats.records]
    stats.commit()
    if committed and mesh.view_model_group is not None:
        broadcast_tensors([t for bn in committed
                           for t in (bn.running_mean, bn.running_var)],
                          mesh.view_model_group)
    # the reported L2 is the whole tensors', counted once in the data
    # group's sum
    if terms and mesh.coord("data") == 0:
        total = total + config.WEIGHT_DECAY * _whole_terms(
            terms, dict(named)).sum()
    return total.detach(), parts


def _reduce(params, group):
    if group is not None:
        all_reduce_gradients(params, group)


def _sync_replicas(named, summed_over_views, mesh):
    """Give every rank that holds a parameter the same gradient: the
    group's first rank's, over the ranks that computed it apart — the
    view ranks, where the gradient was not summed over them, and the
    model ranks for a whole parameter. They ran the same computation,
    but on the card kernels with atomics and the convolution library's
    choices round differently process to process, and replicas that are
    not synchronised drift apart."""
    by_group = {}
    for n, p in named:
        if p.grad is None:
            continue
        axes = tuple(a for a, apart in (
            ("view", n not in summed_over_views),
            ("model", shard_of(p) is None)) if apart)
        group = mesh.group(axes) if axes else None
        if group is not None:
            by_group.setdefault(axes, (group, []))[1].append(p.grad)
    for group, grads in by_group.values():
        broadcast_tensors(grads, group)


@torch.no_grad()
def _whole_terms(terms, params):
    """The L2 `terms` ({name: term}) of the whole tensors: a split leaf's
    slices' terms summed over its group, in one all-reduce."""
    vals = torch.stack(list(terms.values()))
    shards = [shard_of(params[n]) for n in terms]
    split = [i for i, s in enumerate(shards) if s is not None]
    if split:
        part = vals[split]
        dist.all_reduce(part, group=shards[split[0]].group)
        vals[split] = part
    return vals


def train_step(model, optimizer, batch, config, mask, generator,
               group=None):
    """One step: priorities from `generator`, losses, masked gradients,
    TRAIN_BN's running statistics, per-tensor clipnorm, the optimizer's
    update. Returns the metrics as floats (the five losses and "loss",
    the total with L2; the global batch's under `group`, the same on
    every rank). `group`: None, a data-parallel process group or a
    Mesh (parallel/mesh.py::make_parallel_train_step places a global
    batch on one)."""
    batch = draw_priorities(batch, config, generator, group)
    total, parts = loss_and_grads(model, batch, config, mask, group)
    clip_per_tensor_norm(model.parameters(), config.GRADIENT_CLIP_NORM)
    optimizer.step()
    return _floats(dict(parts, loss=total), group)


@torch.no_grad()
def val_step(model, batch, config, generator, group=None):
    """The training graph and the five losses, without gradient or
    update (model_multi.py:2901-2912); with TRAIN_BN it normalises with
    batch statistics and writes none. Returns the metrics as floats
    ("loss" without L2, as the JAX val_step; the global batch's under
    `group`)."""
    batch = draw_priorities(batch, config, generator, group)
    mesh = as_mesh(group)
    outputs = model(batch, training=True,
                    stats=BatchStats(mesh.data_group), mesh=mesh)
    parts = compute_losses(outputs, batch, config, mesh.data_group)
    return _floats(dict(parts, loss=L.total_loss(parts, config.LOSS_WEIGHTS)),
                   group)


def make_eval_step(config):
    """The inference step of the JAX `make_eval_step`: returns
    eval_step(model, batch) -> the inference outputs, the batch's tensors
    on the model's device, the model standing for the JAX TrainState.
    The BatchNorms follow the model's config (`config`, as the engine
    builds it): with TRAIN_BN and BN_EVAL_BATCH_STATS (a diagnostic) they
    normalise with the batch's statistics, which the forward drops, so
    the running statistics stay as they are."""
    del config  # the model reads its own

    @torch.no_grad()
    def eval_step(model, batch):
        return model(batch, training=False)

    return eval_step


def _floats(metrics, group=None):
    """The metrics as floats; under `group` summed over its (data) ranks
    (each holds its share of the global losses)."""
    vals = torch.stack([t.detach().float() for t in metrics.values()])
    mesh = as_mesh(group)
    if mesh.data_group is not None:
        dist.all_reduce(vals, group=mesh.data_group)
    if mesh.view_model_group is not None:
        # the view and model ranks of a data slot computed them apart
        broadcast_tensors([vals], mesh.view_model_group)
    return dict(zip(metrics, vals.cpu().tolist()))


def lr_schedule(base_lr, stages):
    """Piecewise-constant learning rate over steps: stages =
    [(until_step, lr), ...], the reference's 3-stage schedule
    (interior_multi.py:483-501). Returns step -> lr."""
    del base_lr
    bounds = np.array([s for s, _ in stages[:-1]])
    values = np.array([lr for _, lr in stages], dtype=np.float32)

    def fn(step):
        return float(values[np.searchsorted(bounds, step, side="right")])

    return fn
