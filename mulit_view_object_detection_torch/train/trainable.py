"""Stage-wise layer freezing.

Port of `mulit_view_object_detection_tpu/train/trainable.py`: the
reference's regex over layer names (model_multi.py:2822-2836, set_trainable
model_multi.py:2709-2745) as a predicate over each parameter's flax path.
The port evaluates it on the flax path of each torch parameter, as
`utils/convert.py::flax_path` gives it, so a stage (regexes included)
means the same in both packages.

Stages:
  heads     rpn + classifier/mask heads + fpn (+ depth collapse)
  grid+     heads + grid fusion
  grid+-    grid+ minus fpn
  grid_only grid fusion only
  3+ / 4+ / 5+   resnet stage N and up + the grid+ set
  all       everything
  otherwise a regex over the "/"-joined flax path
"""

from __future__ import annotations

import re

from ..models.resnet import BatchNorm
from ..utils.convert import flax_path, ln_module_names

HEAD_TOPS = ("rpn", "classifier_head", "mask_head", "fpn", "depth_collapse",
             "view_transformer")
GRID_TOPS = ("grid_fusion",)


def _in(top, tops):
    # per-level fusion modules are named grid_fusion_p4 / depth_collapse_p5
    return top.startswith(tops)


def _backbone_stage(name):
    m = re.match(r"res(\d)", name)
    if m:
        return int(m.group(1))
    if name in ("conv1", "bn_conv1"):
        return 1
    return None


def path_trainable(path, stage):
    """Whether the parameter at flax `path` (tuple of keys) trains in
    `stage`."""
    top = path[0]
    if stage == "all":
        return True
    if stage == "heads":
        return _in(top, HEAD_TOPS)
    if stage == "grid+":
        return _in(top, HEAD_TOPS) or _in(top, GRID_TOPS)
    if stage == "grid+-":
        no_fpn = tuple(t for t in HEAD_TOPS if t != "fpn")
        return _in(top, no_fpn) or _in(top, GRID_TOPS)
    if stage == "grid_only":
        return _in(top, GRID_TOPS)
    m = re.match(r"(\d)\+$", stage)
    if m:
        min_stage = int(m.group(1))
        if _in(top, HEAD_TOPS) or _in(top, GRID_TOPS):
            return True
        if top == "backbone" and len(path) > 1:
            s = _backbone_stage(path[1])
            return s is not None and s >= min_stage
        return False
    dotted = "/".join(path)
    return re.fullmatch(stage, dotted) is not None or \
        re.match(stage, dotted) is not None


def param_paths(model):
    """{parameter name: flax path} for every parameter of `model`."""
    bns = {n for n, m in model.named_modules() if isinstance(m, BatchNorm)}
    params = dict(model.named_parameters())
    lns = ln_module_names(params, bns)
    return {n: flax_path(n, bns, lns) for n in params}


def trainable_mask(model, stage):
    """{parameter name: True to train, False to freeze} for `stage`."""
    return {n: path_trainable(p, stage)
            for n, p in param_paths(model).items()}
