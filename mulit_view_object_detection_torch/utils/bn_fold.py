"""Inference-time BatchNorm folding.

Port of `mulit_view_object_detection_tpu/utils/bn_fold.py`, working on
the port's state_dict (and modules) instead of a flax tree, with no jax:
the JAX module maps its tree with `jax.tree_util.tree_map`.

With frozen running statistics every BatchNorm is a per-channel affine
``y = x*s + t`` with ``s = gamma/sqrt(var+eps)``, ``t = beta - mean*s``.
Where a conv directly precedes the BN (`_CONV_FOR_BN`, the JAX module's
table: the port's module names are the flax names), the affine folds
into the conv's weight and bias and the BN launches nothing; the other
BNs (GridFusion add and lstm3d `fuse_bn`, and any the table does not
pair) keep (s, t) as their weight and bias and compute ``x*s + t``.

The arithmetic is the JAX module's: float64 on the host, cast to
float32, so `fold_bn_state_dict(flax_to_torch(tree))` equals
`flax_to_torch(fold_bn_variables(tree))` exactly. The statistics become
mean 0 and var 1 - eps, so the folded weights also load into (and give
the same results in) the unfolded model, and folding twice changes
nothing. `group_fusion_variables` is not ported: it serves only
CROSS_LEVEL_FUSION, a TPU lowering the port refuses.
"""

from __future__ import annotations

import torch

from ..models.layers import ColumnParallel
from .convert import TRANSPOSED_CONVS, bn_module_names

BN_EPS = 1e-3  # models.resnet.BatchNorm's epsilon

# BN module name -> candidate preceding-conv names within the same parent
# module (first present wins); the JAX module's table, as it is.
_CONV_FOR_BN = {
    "bn_conv1": ("conv1",),
    "bn2a": ("conv2a",),
    "bn2b": ("conv2b",),
    "bn2c": ("conv2c",),
    "bn1": ("conv1", "down1", "pw1"),
    "bn2": ("down2", "pw2"),
    "bn_up1": ("up1",),
    "bn_up2": ("up2",),
    "bn": ("collapse",),
    "fuse_bn": ("ident_conv",),
    "mrcnn_class_bn1": ("mrcnn_class_conv1",),
    "mrcnn_class_bn2": ("mrcnn_class_conv2",),
    "mrcnn_mask_bn1": ("mrcnn_mask_conv1",),
    "mrcnn_mask_bn2": ("mrcnn_mask_conv2",),
    "mrcnn_mask_bn3": ("mrcnn_mask_conv3",),
    "mrcnn_mask_bn4": ("mrcnn_mask_conv4",),
}


def _conv_for(bn, state_dict):
    """The full name of the conv module `bn` folds into, or None."""
    parent, _, name = bn.rpartition(".")
    prefix = parent + "." if parent else ""
    for cand in _CONV_FOR_BN.get(name, ()):
        w = state_dict.get(prefix + cand + ".weight")
        if w is not None and w.ndim > 1:         # a kernel, not a norm
            return prefix + cand
    return None


def _fold(state_dict):
    """(folded state_dict of float32 CPU tensors, {BN name: conv name or
    None}, report). BNs are visited in the JAX walk's order (sorted keys
    at every level), so the reports list them in the same order."""
    sd = {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}
    forms, report = {}, {"folded": [], "affine": []}
    f32 = torch.float32
    for bn in sorted(bn_module_names(sd), key=lambda n: n.split(".")):
        gamma = sd[bn + ".weight"].double()
        beta = sd[bn + ".bias"].double()
        mean = sd[bn + ".running_mean"].double()
        var = sd[bn + ".running_var"].double()
        s = gamma / torch.sqrt(var + BN_EPS)
        t = beta - mean * s
        conv = _conv_for(bn, sd)
        if conv is not None:
            if conv + ".bias" not in sd:
                raise ValueError(f"cannot fold {bn} into {conv}: it has no "
                                 f"bias")
            w = sd[conv + ".weight"]
            # torch keeps a conv's out-features on dim 0, a transposed
            # conv's on dim 1 (flax: last for both)
            axis = 1 if conv.rpartition(".")[2] in TRANSPOSED_CONVS else 0
            shape = [1] * w.ndim
            shape[axis] = -1
            sd[conv + ".weight"] = (w.double() * s.view(shape)).to(f32)
            sd[conv + ".bias"] = (sd[conv + ".bias"].double() * s
                                  + t).to(f32)
            sd[bn + ".weight"] = torch.ones_like(gamma, dtype=f32)
            sd[bn + ".bias"] = torch.zeros_like(beta, dtype=f32)
            report["folded"].append(
                f"{conv.rpartition('.')[2]}<-{bn.rpartition('.')[2]}")
        else:
            sd[bn + ".weight"] = s.to(f32)
            sd[bn + ".bias"] = t.to(f32)
            report["affine"].append(bn.rpartition(".")[2])
        # var = 1 - eps makes sqrt(var + eps) exactly 1.0: the folded
        # weights are exact under the unfolded BatchNorm too
        sd[bn + ".running_mean"] = torch.zeros_like(mean, dtype=f32)
        sd[bn + ".running_var"] = torch.full_like(var, 1.0 - BN_EPS,
                                                  dtype=f32)
        forms[bn] = conv
    return sd, forms, report


def fold_bn_state_dict(state_dict):
    """Fold every frozen BatchNorm of a state_dict. Returns a new
    state_dict (float32 CPU tensors, same keys and shapes) and the report
    {"folded": ["conv<-bn", ...], "affine": ["bn", ...]} of the JAX
    `fold_bn_variables`. Idempotent."""
    sd, _, report = _fold(state_dict)
    return sd, report


def fold_bn_model(model):
    """Fold `model`'s BatchNorms in place: its weights become the folded
    ones, a BN folded into its conv runs as the identity and an
    affine-only one as x * weight + bias in the model's compute dtype
    (models/resnet.py::BatchNorm). For inference only; a model with
    tensor-parallel layers raises (the JAX package folds only the
    train state's frozen BatchNorms, for serving). Returns the report."""
    if any(isinstance(m, ColumnParallel) for m in model.modules()):
        raise ValueError("FOLD_BN folds a whole model: this one has "
                         "tensor-parallel layers (parallel/mesh.py); "
                         "fold a one-process copy of its checkpoint")
    sd, forms, report = _fold(model.state_dict())
    model.load_state_dict(sd, strict=True)
    dtype = getattr(model, "compute_dtype", torch.float32)
    modules = dict(model.named_modules())
    for bn, conv in forms.items():
        modules[bn].fold("identity" if conv is not None else "affine",
                         dtype)
    return report
