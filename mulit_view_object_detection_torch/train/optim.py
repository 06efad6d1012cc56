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

from ..utils.convert import _BN


def make_optimizer(params, learning_rate, momentum=0.9):
    """SGD with momentum over `params` (an iterable of tensors)."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           dampening=0.0, nesterov=False, weight_decay=0.0)


@torch.no_grad()
def clip_per_tensor_norm(params, max_norm):
    """Scale each gradient in place by min(1, max_norm / ||g||)."""
    for p in params:
        if p.grad is not None:
            norm = torch.sqrt(torch.sum(torch.square(p.grad.float())))
            p.grad.mul_(torch.clamp(max_norm / torch.clamp_min(norm, 1e-12),
                                    max=1.0))


def l2_regularization(named_params, paths, mask, weight_decay):
    """sum of weight_decay * mean(w^2) over the trainable parameters whose
    flax path has no BatchNorm_0 (model.py:2184-2190). named_params:
    (name, tensor) pairs; paths and mask: by name."""
    terms = [torch.mean(torch.square(p)) for n, p in named_params
             if mask[n] and _BN not in paths[n]]
    if not terms:
        return 0.0
    return weight_decay * torch.stack(terms).sum()


def mask_gradients(named_params, mask):
    """Drop the gradients of frozen parameters (set_trainable,
    model.py:2709-2745): a frozen tensor gets no update, as a zero
    gradient with zero momentum gets none in optax."""
    for n, p in named_params:
        if not mask[n]:
            p.grad = None
