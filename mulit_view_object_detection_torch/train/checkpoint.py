"""Checkpoints: parameters, optimizer state and step.

Port of `mulit_view_object_detection_tpu/train/checkpoint.py` with
`torch.save` in place of Orbax: one directory per step under the
checkpoint directory (`<dir>/<step>/state.pt`, written to a temporary
name and renamed, so a directory with a state file is complete), the
newest `max_to_keep` kept. `latest_step` is the `find_last` of the
reference (model.py:2073-2100). Files are read back with
`weights_only=True`: tensors and plain containers only. The state_dict
carries the BatchNorms' running statistics (buffers), so TRAIN_BN's
updated statistics round-trip.
"""

from __future__ import annotations

import os
import shutil

import torch

_STATE = "state.pt"


def _steps(ckpt_dir):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit()
                  and os.path.isfile(os.path.join(ckpt_dir, d, _STATE)))


def latest_step(ckpt_dir):
    """The newest complete step in `ckpt_dir`, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir, model, optimizer=None, step=0, max_to_keep=5):
    """Save the model's state_dict (parameters and BatchNorm statistics),
    the optimizer's state_dict and `step` under `ckpt_dir/<step>/`."""
    step = int(step)
    target = os.path.join(os.path.abspath(ckpt_dir), str(step))
    os.makedirs(target, exist_ok=True)
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": (optimizer.state_dict() if optimizer is not None
                      else None),
        "step": step,
    }
    tmp = os.path.join(target, _STATE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(target, _STATE))
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return step


def restore_checkpoint(ckpt_dir, model, optimizer=None, step=None):
    """Load `step` (default: the latest) into `model` (strict) and, when
    given, `optimizer`. Returns the step, or None if there is none."""
    step = latest_step(ckpt_dir) if step is None else int(step)
    if step is None:
        return None
    payload = torch.load(os.path.join(ckpt_dir, str(step), _STATE),
                         map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    if optimizer is not None and payload["optimizer"] is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return int(payload["step"])
