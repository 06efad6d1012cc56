"""Optimizer of the reference's compile() (model.py:2152-2206).

Port of `mulit_view_object_detection_tpu/train/optim.py`: per-tensor
gradient clipping at GRADIENT_CLIP_NORM (Keras `clipnorm`: each gradient
tensor by its own L2 norm), then SGD with momentum. optax's `sgd` keeps a
trace t = g + momentum * t and steps by -lr * t, which is
`torch.optim.SGD` with dampening 0 and no Nesterov. Weight decay is not
the optimizer's: `l2_regularization` adds WEIGHT_DECAY * mean(w^2) of the
trainable non-BatchNorm weights to the loss (model.py:2184-2190).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.layers import shard_of
from ..utils.convert import _BN


def make_optimizer(params, learning_rate, momentum=0.9):
    """SGD with momentum over `params` (an iterable of tensors)."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           dampening=0.0, nesterov=False, weight_decay=0.0)


def warmup_schedule(base_lr, warmup_steps, drop_step=0):
    """step -> learning rate, step the absolute count of updates: linear
    from 0 to `base_lr` over `warmup_steps` (optax.linear_schedule, whose
    first update has rate 0), then from `drop_step` on (if > 0) a constant
    base_lr / 10 (optax.join_schedules). An SGD group's "lr" set from it
    before each update scales that update as optax's schedule scales the
    momentum trace; the count restarts nowhere, so the schedule survives a
    checkpoint and a resume."""

    def lr(step):
        if drop_step > 0 and step >= drop_step:
            return base_lr / 10
        if warmup_steps <= 0:
            return base_lr
        return base_lr * min(max(step, 0), warmup_steps) / warmup_steps

    return lr


@torch.no_grad()
def clip_per_tensor_norm(params, max_norm):
    """Scale each gradient in place by min(1, max_norm / ||g||). The norm
    of a tensor-parallel slice (`models/layers.py::Shard`) is the whole
    tensor's: its square is summed over the slice's group first, in one
    all-reduce for all of them, as the JAX clip sees the global array."""
    params = [p for p in params if p.grad is not None]
    squares = [torch.sum(torch.square(p.grad.float())) for p in params]
    split = [i for i, p in enumerate(params) if shard_of(p) is not None]
    if split:
        total = torch.stack([squares[i] for i in split])
        dist.all_reduce(total, group=shard_of(params[split[0]]).group)
        for j, i in enumerate(split):
            squares[i] = total[j]
    for p, sq in zip(params, squares):
        norm = torch.sqrt(sq)
        p.grad.mul_(torch.clamp(max_norm / torch.clamp_min(norm, 1e-12),
                                max=1.0))


def l2_terms(named_params, paths, mask):
    """(name, mean(w^2)) of each trainable parameter whose flax path has
    no BatchNorm_0 (model.py:2184-2190). named_params: (name, tensor)
    pairs; paths and mask: by name. A tensor-parallel slice's term is its
    share of its whole tensor's mean."""
    return [(n, _mean_square(p)) for n, p in named_params
            if mask[n] and _BN not in paths[n]]


def l2_regularization(named_params, paths, mask, weight_decay):
    """sum of weight_decay * mean(w^2) over `l2_terms`."""
    terms = [t for _, t in l2_terms(named_params, paths, mask)]
    if not terms:
        return 0.0
    return weight_decay * torch.stack(terms).sum()


def _mean_square(p):
    shard = shard_of(p)
    if shard is None:
        return torch.mean(torch.square(p))
    return torch.sum(torch.square(p)) / (p.numel() * shard.size)


def mask_gradients(named_params, mask):
    """Drop the gradients of frozen parameters (set_trainable,
    model.py:2709-2745): a frozen tensor gets no update, as a zero
    gradient with zero momentum gets none in optax."""
    for n, p in named_params:
        if not mask[n]:
            p.grad = None
