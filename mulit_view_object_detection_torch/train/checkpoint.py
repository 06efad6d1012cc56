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

A tensor-parallel model (`parallel/mesh.py::shard_state_tp`) is saved
whole: its split parameters and their momentum are gathered over their
groups, so every process must call `save_checkpoint`, and the world's
first process writes. Such a checkpoint loads in one process, and a
split model restores from a whole checkpoint by taking its own slices.
"""

from __future__ import annotations

import os
import shutil

import torch
import torch.distributed as dist

from ..models.layers import shard_of
from ..parallel.mesh import gather_shards

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


def _shards(model):
    return {n: shard_of(p) for n, p in model.named_parameters()
            if shard_of(p) is not None}


def _momentum_owners(optimizer):
    """{index in the optimizer's state_dict: parameter}."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return dict(enumerate(params))


def whole_state(model, optimizer=None):
    """(model state_dict, optimizer state_dict or None) with every
    tensor-parallel slice gathered whole. With split parameters every
    process of their groups must call it."""
    shards = _shards(model)
    state = gather_shards((k, v.detach(), shards.get(k))
                          for k, v in model.state_dict().items())
    opt = None
    if optimizer is not None:
        opt = optimizer.state_dict()
        if shards:
            owners = _momentum_owners(optimizer)
            opt["state"] = {i: dict(st, **gather_shards(
                [("momentum_buffer", st["momentum_buffer"],
                  shard_of(owners[i]))]))
                if st.get("momentum_buffer") is not None else st
                for i, st in opt["state"].items()}
    return state, opt


def _own_slice(t, shard):
    n = t.shape[shard.dim] // shard.size
    return t.narrow(shard.dim, shard.rank * n, n).clone()


def save_checkpoint(ckpt_dir, model, optimizer=None, step=0, max_to_keep=5):
    """Save the model's state_dict (parameters and BatchNorm statistics),
    the optimizer's state_dict and `step` under `ckpt_dir/<step>/`; a
    tensor-parallel model whole (every process calls, the first writes).
    """
    step = int(step)
    split = bool(_shards(model))
    state, opt = whole_state(model, optimizer)
    if split and dist.get_rank() != 0:
        return step
    target = os.path.join(os.path.abspath(ckpt_dir), str(step))
    os.makedirs(target, exist_ok=True)
    payload = {
        "model": {k: v.cpu() for k, v in state.items()},
        "optimizer": opt,
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
    given, `optimizer`; a tensor-parallel model takes its own slices of
    the whole tensors. Returns the step, or None if there is none."""
    step = latest_step(ckpt_dir) if step is None else int(step)
    if step is None:
        return None
    payload = torch.load(os.path.join(ckpt_dir, str(step), _STATE),
                         map_location="cpu", weights_only=True)
    shards = _shards(model)
    model.load_state_dict({k: _own_slice(v, shards[k]) if k in shards
                           else v for k, v in payload["model"].items()},
                          strict=True)
    opt = payload["optimizer"]
    if optimizer is not None and opt is not None:
        if shards:
            owners = _momentum_owners(optimizer)
            for i, st in opt["state"].items():
                shard = shard_of(owners[i])
                if shard is not None and st.get("momentum_buffer") \
                        is not None:
                    st["momentum_buffer"] = _own_slice(
                        st["momentum_buffer"], shard)
        optimizer.load_state_dict(opt)
    return int(payload["step"])
