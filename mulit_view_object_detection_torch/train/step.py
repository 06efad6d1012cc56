"""Train and validation steps.

Port of `mulit_view_object_detection_tpu/train/step.py`: the forward with
on-device ROI sampling, the five losses plus L2 regularization, gradients
masked to the trainable stage, per-tensor clipnorm, an SGD-with-momentum
update. Where the JAX step draws the sampling priorities from its
"sampling" key inside the model, this step draws them from an explicit
torch.Generator (`draw_priorities`) and puts them in the batch; the
transformer's dropout, which the JAX step draws from its "dropout" key,
draws its masks from the same generator.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import losses as L
from ..ops.image_meta import parse_image_meta
from .optim import clip_per_tensor_norm, l2_regularization, mask_gradients
from .trainable import param_paths


def compute_losses(outputs, batch, config):
    """The five losses from the training outputs and the host-built RPN
    targets (batch "rpn_match", "rpn_bbox")."""
    active = parse_image_meta(batch["image_meta"])["active_class_ids"]
    return {
        "rpn_class_loss": L.rpn_class_loss(batch["rpn_match"],
                                           outputs["rpn_class_logits"]),
        "rpn_bbox_loss": L.rpn_bbox_loss(batch["rpn_bbox"],
                                         batch["rpn_match"],
                                         outputs["rpn_bbox"]),
        "mrcnn_class_loss": L.mrcnn_class_loss(
            outputs["target_class_ids"], outputs["mrcnn_class_logits"],
            active),
        "mrcnn_bbox_loss": L.mrcnn_bbox_loss(
            outputs["target_deltas"], outputs["target_class_ids"],
            outputs["mrcnn_bbox"]),
        "mrcnn_mask_loss": L.mrcnn_mask_loss(
            outputs["target_masks"], outputs["target_class_ids"],
            outputs["mrcnn_masks"]),
    }


def draw_priorities(batch, config, generator):
    """Add the ROI sampling priorities (two [B, POST_NMS_ROIS_TRAINING]
    uniform draws, positives then negatives) to `batch`, drawn from
    `generator` on its own device and moved to the images' device, and
    the generator itself as "dropout_generator" (the transformer's
    dropout draws from it during the forward)."""
    b = batch["images"].shape[0]
    shape = (2, b, config.POST_NMS_ROIS_TRAINING)
    pri = torch.rand(shape, generator=generator, device=generator.device)
    pri = pri.to(batch["images"].device)
    return dict(batch, pos_priority=pri[0], neg_priority=pri[1],
                dropout_generator=generator)


def loss_and_grads(model, batch, config, mask):
    """Forward (training graph) and backward. `batch` carries the
    priorities. Returns (total loss, the five losses) as tensors; the
    gradients, masked to `mask`, are in each parameter's .grad."""
    named = list(model.named_parameters())
    for _, p in named:
        p.grad = None
    outputs = model(batch, training=True)
    parts = compute_losses(outputs, batch, config)
    total = L.total_loss(parts, config.LOSS_WEIGHTS) + l2_regularization(
        named, param_paths(model), mask, config.WEIGHT_DECAY)
    total.backward()
    mask_gradients(named, mask)
    return total, parts


def train_step(model, optimizer, batch, config, mask, generator):
    """One step: priorities from `generator`, losses, masked gradients,
    per-tensor clipnorm, the optimizer's update. Returns the metrics as
    floats (the five losses and "loss", the total with L2)."""
    batch = draw_priorities(batch, config, generator)
    total, parts = loss_and_grads(model, batch, config, mask)
    clip_per_tensor_norm(model.parameters(), config.GRADIENT_CLIP_NORM)
    optimizer.step()
    return _floats(dict(parts, loss=total))


@torch.no_grad()
def val_step(model, batch, config, generator):
    """The training graph and the five losses, without gradient or
    update (model_multi.py:2901-2912). Returns the metrics as floats
    ("loss" without L2, as the JAX val_step)."""
    batch = draw_priorities(batch, config, generator)
    parts = compute_losses(model(batch, training=True), batch, config)
    return _floats(dict(parts, loss=L.total_loss(parts, config.LOSS_WEIGHTS)))


def _floats(metrics):
    vals = torch.stack([t.detach().float() for t in metrics.values()])
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
