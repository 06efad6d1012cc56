"""Model FLOP utilisation and roofline report for the flagship configs.

    python -m mulit_view_object_detection_torch.cli.mfu_report \\
        [inference[:variant]] [train] [--device cuda]

The port's copy of the top-level `tools/mfu_report.py`, which reads
XLA's cost analysis of the JAX package's compiled step. PyTorch has no
such analysis, so the two quantities are defined here:

* `model_flops(model, batch, training)`: 2 x the multiply-adds of every
  convolution (2D, 3D, transposed) and every matrix product (dense,
  einsum, attention) that one forward runs, and with `training` its
  backward too, as `torch.utils.flop_counter.FlopCounterMode` counts
  them (a transposed convolution by its input positions, a backward by
  the gradients it computes, each at its forward's count: torch's own
  backward formula overcounts a grouped convolution's weight gradient).
  `tests/test_torch_tools_flops.py` holds it, integer for integer, to a
  count taken from the JAX model's own jaxpr. This is the count to
  divide a step's time by for a model FLOP utilisation share.
* `eager_bytes(fn)`: `min_bytes`, the bytes that `fn` must move, each
  input read once and each output written once. An input is a storage
  that an op reads before any op of `fn` made it (the parameters, the
  batch, the optimizer's state), counted once by the largest tensor an
  op reads from it (a tensor `fn` builds outside the dispatcher, from
  numpy, is one too); an output is a storage that existed before `fn`
  and an op wrote (a parameter updated in place), or a tensor that `fn`
  returns. The hand kernels read and write storages that dispatched ops
  made, so they change nothing here. No implementation of the step,
  fused or not, moves fewer bytes through memory unless they sit in
  cache, so the roofline fields
  (`gbytes`, the arithmetic intensity, `hbm_bw_util`, `roofline_bound`,
  `roofline_floor_ms`, `speed_of_light_frac`) are computed from it.
  Beside it, `eager_bytes` and `eager_ops`: the input and output tensor
  bytes of every op that `fn` dispatches, summed (a TorchDispatchMode;
  views and uninitialised allocations left out). That is what an
  unfused eager step moves absent cache hits, an estimate and not a
  bound: it counts each intermediate twice (written by its producer,
  read by its consumer), an in-place op's tensor as read and written,
  and not the hand kernels (`kernels/`), which are launched outside the
  dispatcher. XLA's fused "bytes accessed" is a third quantity, so
  bytes are not held to the JAX package.

Time is the loop difference, as in the JAX tool: inference 2 and 12
forwards chained through the detections (`cli/profile_variants.py`),
training 1 and 6 steps of `train/step.py::train_step`. Peaks are the
H100 SXM data sheet's, keyed by the card's nvidia-smi name: 989 TFLOP/s
dense bfloat16, 67 TFLOP/s float32 (a float32 model computes with TF32
off, `models/detector.py::float32_arithmetic`), 3.35 TB/s; any other
card raises, and there is no default peak (on the CPU the shares and
the roofline read None). One JSON line a workload: the JAX tool's
fields plus the exact FLOP count, the must-move and the eager bytes,
the eager ops, and the device's name and power limit.

Workloads: `inference` (any profile_variants variant as
`inference:<variant>`, default conv3d; the BN-folded model) and `train`
(bench_train.py's flagship train step, conv3d_2view_640_train_step).
Runs on the card unless `--device cpu` is passed; asked for cuda without
a card it raises.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from ..models.detector import MaskRCNN
from ..train.optim import make_optimizer
from ..train.step import draw_priorities, loss_and_grads, train_step
from ..train.trainable import trainable_mask
from .measure import (
    card_fields, flagship_train_config, inference_setup, infer_loop,
    make_flagship_train_batch, resolve_device, time_loop)
from .profile_variants import variant_config
from .train_to_ap import _to_device

# NVIDIA H100 SXM data sheet: dense tensor-core bfloat16, float32
# outside the tensor cores, HBM3
PEAKS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 67e12,
                                   "bytes": 3.35e12}}

_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided")
_OVERWRITES = ("copy_", "fill_", "zero_")


def peaks(card_name, compute_dtype):
    """(peak FLOP/s for the compute dtype, peak bytes/s) of the card named
    `card_name` by nvidia-smi; any other card raises."""
    if card_name not in PEAKS:
        raise ValueError(f"no peak rates for {card_name!r}: known cards "
                         f"are {sorted(PEAKS)}")
    p = PEAKS[card_name]
    return p[str(compute_dtype).replace("torch.", "")], p["bytes"]


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None, **_):
    """Each gradient a convolution's backward computes (input, weight)
    counts its forward's multiply-adds. torch's own formula counts a
    grouped convolution's weight gradient `groups` times over (it
    convolves the transposed input with the transposed output gradient
    as if ungrouped): a depthwise DepthCollapse layer's by its width."""
    fwd = conv_flop_count(list(x_shape), list(w_shape), list(grad_out_shape),
                          transposed)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def model_flops(model, batch, training=False):
    """2 x the multiply-adds of the convolutions and matrix products of
    one forward of `model` on `batch` (a dict of tensors on the model's
    device) and, with `training`, of its backward from the total loss
    with every parameter trainable (`batch` then carries the training
    inputs; the ROI priorities are drawn from a seeded generator if
    absent). The parameters' .grad are left set."""
    cfg = model.config
    mapping = {torch.ops.aten.convolution_backward: _conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        if training:
            if "pos_priority" not in batch:
                gen = torch.Generator(batch["images"].device)
                batch = draw_priorities(batch, cfg, gen.manual_seed(0))
            loss_and_grads(model, batch, cfg, trainable_mask(model, "all"))
        else:
            with torch.no_grad():
                model(batch)
    return counter.get_total_flops()


def _storage(t):
    return t.untyped_storage().data_ptr()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _written(func, args, kwargs):
    """(the tensors `func` writes, those of them it does not read): its
    arguments marked `(a!)`; an out= argument and the target of an
    overwrite (copy_, fill_, zero_) are not read."""
    written, unread = [], []
    overwrite = func.overloadpacket.__name__ in _OVERWRITES
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        ts = _tensors(args[i] if i < len(args) else kwargs.get(arg.name))
        written += ts
        if arg.kwarg_only or overwrite:
            unread += ts
    return written, unread


class _ByteCounter(TorchDispatchMode):
    """Sums every dispatched op's tensor bytes (`eager`), and keeps the
    storages that ops made (`made`), those an op read before any op made
    them (`reads`) and those that existed before and an op wrote
    (`writes`), each by the largest tensor seen on it."""

    def __init__(self):
        super().__init__()
        self.eager = 0
        self.ops = 0
        self.made, self.reads, self.writes = set(), {}, {}

    @staticmethod
    def _note(table, t):
        key = _storage(t)
        table[key] = min(max(table.get(key, 0), t.numel() * t.element_size()),
                         t.untyped_storage().nbytes())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        written, unread = _written(func, args, kwargs)
        if not func.is_view:
            skip = {id(t) for t in unread}
            for t in ins:
                if id(t) not in skip and _storage(t) not in self.made:
                    self._note(self.reads, t)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in written:
            if _storage(t) not in self.made:
                self._note(self.writes, t)
        if not func.is_view:
            self.made.update(_storage(t) for t in outs
                             if _storage(t) not in self.writes)
            if func.overloadpacket.__name__ not in _ALLOCATIONS:
                self.ops += 1
                self.eager += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
        return out


def eager_bytes(fn):
    """{"min_bytes", "eager_bytes", "eager_ops"} of fn(): the bytes it
    must move (its inputs read once, its outputs written once: the
    storages it reads before making them, those it writes that existed
    before, and the tensors it returns), and every dispatched op's input
    and output bytes summed, with the number of those ops (views and
    uninitialised allocations are not counted)."""
    counter = _ByteCounter()
    with counter:
        result = fn()
    returned = {_storage(t): t.numel() * t.element_size()
                for t in _tensors(result) if _storage(t) not in counter.writes}
    return {"min_bytes": sum(counter.reads.values())
            + sum(counter.writes.values()) + sum(returned.values()),
            "eager_bytes": counter.eager, "eager_ops": counter.ops}


def report(name, flops, nbytes, ms, peak_flops, peak_bytes):
    """The JAX tool's `_report` fields for one workload, `nbytes` the
    bytes it must move (`eager_bytes(...)["min_bytes"]`); the shares and
    the roofline are None without peak rates (on the CPU)."""
    out = {"workload": name, "ms": round(ms, 4),
           "gflops": round(flops / 1e9, 3),
           "gbytes": round(nbytes / 1e9, 3),
           "arith_intensity_flop_per_byte": round(
               flops / max(nbytes, 1.0), 2)}
    if peak_flops is None:
        return dict(out, mfu=None, hbm_bw_util=None,
                    ridge_flop_per_byte=None, roofline_bound=None,
                    roofline_floor_ms=None, speed_of_light_frac=None)
    secs = ms / 1e3
    ridge = peak_flops / peak_bytes
    floor_ms = max(flops / peak_flops, nbytes / peak_bytes) * 1e3
    return dict(
        out, mfu=round(flops / secs / peak_flops, 7),
        hbm_bw_util=round(nbytes / secs / peak_bytes, 7),
        ridge_flop_per_byte=round(ridge, 2),
        roofline_bound=("compute" if flops / max(nbytes, 1.0) >= ridge
                        else "memory"),
        roofline_floor_ms=round(floor_ms, 4),
        speed_of_light_frac=round(floor_ms / ms, 7))


def _peaks_for(model, device):
    """(the card's fields, (peak FLOP/s, peak bytes/s)); no peaks on the
    CPU."""
    card = card_fields(device)
    if device.type != "cuda":
        return card, (None, None)
    return card, peaks(card["device"], model.compute_dtype)


def inference_report(variant="conv3d", device="cuda", batch=1):
    """The report of `variant`'s BN-folded inference at `batch`, with
    its FLOPs ("flops", exact) and eager bytes beside it."""
    device = resolve_device(device)
    cfg = variant_config(variant, batch)
    model, inputs = inference_setup(cfg, device)
    card, (pf, pb) = _peaks_for(model, device)
    flops = model_flops(model, inputs)
    moved = eager_bytes(lambda: infer_loop(model, inputs, 1))
    ms = time_loop(lambda n: infer_loop(model, inputs, n), device)
    suffix = "" if batch == 1 else f"_b{batch}"
    return {**report(f"{variant}_640_inference{suffix}", flops,
                     moved["min_bytes"], ms, pf, pb),
            "flops": flops, **moved, **card}


def train_workload(device):
    """bench_train.py's flagship train step (stage "all", SGD with
    momentum, frozen BatchNorm) on `device`: (model, batch, steps), where
    steps(n) runs n steps."""
    cfg = flagship_train_config(name="mfu_train")
    model = MaskRCNN(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(device).train()
    batch = _to_device(make_flagship_train_batch(cfg), device)
    mask = trainable_mask(model, "all")
    optimizer = make_optimizer(model.parameters(), cfg.LEARNING_RATE,
                               cfg.LEARNING_MOMENTUM)
    gen = torch.Generator(device).manual_seed(3)

    def steps(n):
        for _ in range(n):
            train_step(model, optimizer, batch, cfg, mask, gen)

    return model, batch, steps


def train_report(device="cuda"):
    """The report of bench_train.py's flagship train step."""
    device = resolve_device(device)
    model, batch, steps = train_workload(device)
    card, (pf, pb) = _peaks_for(model, device)
    flops = model_flops(model, batch, training=True)
    moved = eager_bytes(lambda: steps(1))
    ms = time_loop(steps, device, short=1, long=6)
    return {**report("conv3d_2view_640_train_step", flops,
                     moved["min_bytes"], ms, pf, pb),
            "flops": flops, **moved, **card}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workloads", nargs="*", default=["inference", "train"],
                    help="inference, inference:<variant>, train")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for w in args.workloads:
        if w == "train":
            out = train_report(args.device)
        elif w.startswith("inference"):
            _, _, variant = w.partition(":")
            out = inference_report(variant or "conv3d", args.device)
        else:
            raise SystemExit(f"unknown workload {w!r}")
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
