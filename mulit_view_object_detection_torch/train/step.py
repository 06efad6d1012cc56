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
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models import losses as L
from ..models.resnet import BatchStats
from ..ops.image_meta import parse_image_meta
from ..parallel.distributed import all_reduce_gradients
from .optim import clip_per_tensor_norm, l2_regularization, mask_gradients
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


def _rank_and_size(group):
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def draw_priorities(batch, config, generator, group=None):
    """Add the ROI sampling priorities (two [B, POST_NMS_ROIS_TRAINING]
    uniform draws, positives then negatives) to `batch`, drawn from
    `generator` on its own device and moved to the images' device, and
    the generator itself as "dropout_generator" (the transformer's
    dropout draws from it during the forward). Under `group` the draw is
    the global batch's (B times the group's size rows) and this rank
    takes its own rows."""
    b = batch["images"].shape[0]
    rank, size = _rank_and_size(group)
    shape = (2, b * size, config.POST_NMS_ROIS_TRAINING)
    pri = torch.rand(shape, generator=generator, device=generator.device)
    pri = pri[:, rank * b:(rank + 1) * b].to(batch["images"].device)
    return dict(batch, pos_priority=pri[0], neg_priority=pri[1],
                dropout_generator=generator)


def loss_and_grads(model, batch, config, mask, group=None):
    """Forward (training graph) and backward; TRAIN_BN's running
    statistics written once. `batch` carries the priorities. Returns
    (total loss, the five losses) as tensors (this rank's shares under
    `group`); the gradients, summed over `group` and masked to `mask`,
    are in each parameter's .grad."""
    named = list(model.named_parameters())
    for _, p in named:
        p.grad = None
    stats = BatchStats(group)
    outputs = model(batch, training=True, stats=stats)
    parts = compute_losses(outputs, batch, config, group)
    total = L.total_loss(parts, config.LOSS_WEIGHTS)
    if _rank_and_size(group)[0] == 0:
        total = total + l2_regularization(named, param_paths(model), mask,
                                          config.WEIGHT_DECAY)
    total.backward()
    if group is not None:
        all_reduce_gradients([p for _, p in named], group)
    mask_gradients(named, mask)
    stats.commit()
    return total, parts


def train_step(model, optimizer, batch, config, mask, generator,
               group=None):
    """One step: priorities from `generator`, losses, masked gradients,
    TRAIN_BN's running statistics, per-tensor clipnorm, the optimizer's
    update. Returns the metrics as floats (the five losses and "loss",
    the total with L2; the global batch's under `group`, the same on
    every rank)."""
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
    outputs = model(batch, training=True, stats=BatchStats(group))
    parts = compute_losses(outputs, batch, config, group)
    return _floats(dict(parts, loss=L.total_loss(parts, config.LOSS_WEIGHTS)),
                   group)


def _floats(metrics, group=None):
    """The metrics as floats; under `group` summed over its ranks (each
    holds its share of the global losses)."""
    vals = torch.stack([t.detach().float() for t in metrics.values()])
    if group is not None:
        dist.all_reduce(vals, group=group)
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
