"""`cli/mfu_report.py::model_flops` held to the JAX model's own jaxpr on
the CPU, and its `eager_bytes` to a hand count.

The count on the JAX side walks `jax.make_jaxpr` of `MaskRCNN.apply`
(inference) or of `train/step.py::make_train_step`'s step (training:
the gradient of the loss and the SGD update) and sums its
`conv_general_dilated` and `dot_general` equations, descending into
every sub-jaxpr (pjit, custom_jvp and custom_vjp calls, remat, scan with
its body counted x its length), bar the two named below. The rules:

* a dot_general: 2 x batch x contracted x free(lhs) x free(rhs);
* a convolution: 2 x (output batch x output features) x rhs input
  features x a spatial count, per axis. torch's FlopCounterMode counts
  a convolution by its output positions x kernel taps, padding taps
  included, a transposed one by its input positions x taps, and each
  gradient of either by the count of its forward; the rule gives each
  JAX equation that count:
  - without an lhs dilation: output positions x rhs taps (a forward
    convolution; a weight gradient, whose output is the kernel and whose
    rhs the output gradient); in an input gradient (its rhs a `rev` of
    the kernel, as JAX's transpose rule makes it) min(lhs, output)
    positions x rhs taps, the lhs being the output gradient: so a VALID
    7x7 head conv's input gradient is not counted over the 6 padding
    taps on each side that XLA's equation carries;
  - with an lhs dilation (a transposed convolution, or the input
    gradient of a strided one) the inserted zeros are no multiply-adds:
    every real lhs element meets each kernel tap once, lhs positions x
    min(rhs, output), the kernel being the rhs, or the output in the
    weight gradient of a transposed convolution. A naive output x rhs
    count would count the zeros (4x for flax's 2x2/2 mask deconv).

Left out, on both sides, with the reason:
* `custom_linear_solve` (not descended): the 3x3 inverse of the scaled
  intrinsics (JAX `ops/projection.py:187`, `jnp.linalg.inv`), an LU
  solve; the port inverts it with `torch.linalg.inv_ex`, which the
  counter does not count either. The solve's matvec jaxpr is there for
  autodiff and runs no product in the forward.
* `while` (not descended): JAX's NMS sweeps ([N, N] @ [N] per sweep, a
  data-dependent number of them, JAX `ops/nms.py:76-85`); NMS is
  post-processing, and the port's NMS runs no matrix product.
The camera geometry's products (the voxel projection's einsums, JAX
`ops/projection.py`, and the reprojection's `bij,jn->bin`) run on the
device in both packages, as `bmm`s in the port, and are counted on both
sides. The backward lists differ (torch counts each convolution's and
matmul's gradient ops, JAX its transposed equations); equal totals are
the bar, integer for integer.

Configs: JAX `tools/profile_variants.py`'s vanilla, conv3d, lstm3d4 and
xformer at test size (64^2, nvox 8, 4 depth samples, a 1-block stage 4,
FOLD_BN off: a BatchNorm folded or not runs the same convolutions), and
one conv3d train step of `bench_train.py`'s config at the same size.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.models.detector import (  # noqa: E402
    MaskRCNN as JaxMaskRCNN)
from mulit_view_object_detection_tpu.train.optim import (  # noqa: E402
    make_optimizer as jax_make_optimizer)
from mulit_view_object_detection_tpu.train.step import (  # noqa: E402
    TrainState, make_train_step)
from mulit_view_object_detection_torch.cli import (  # noqa: E402
    measure, mfu_report, profile_variants as pv)
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as TorchMaskRCNN)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch)
from tests.test_torch_convert import random_variables  # noqa: E402
from tests.test_torch_projection import _poses  # noqa: E402

NOT_DESCENDED = ("custom_linear_solve", "while")


# ---------------------------------------------------------------------------
# the jaxpr walker
# ---------------------------------------------------------------------------

def dot_flops(eqn):
    (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
    ls, rs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
    batch = math.prod(ls[i] for i in lb)
    contract = math.prod(ls[i] for i in lc)
    lfree = math.prod(s for i, s in enumerate(ls) if i not in (*lc, *lb))
    rfree = math.prod(s for i, s in enumerate(rs) if i not in (*rc, *rb))
    return 2 * batch * contract * lfree * rfree


def conv_flops(eqn, reversed_rhs=False):
    """`reversed_rhs`: the rhs is a `rev` of a kernel, as JAX's input
    gradient of a convolution makes it."""
    lhs, rhs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
    out = eqn.outvars[0].aval.shape
    lspec, rspec, ospec = eqn.params["dimension_numbers"]
    dilated = any(d > 1 for d in eqn.params["lhs_dilation"])
    spatial = 1
    for ld, rd, od in zip(lspec[2:], rspec[2:], ospec[2:]):
        if dilated:
            spatial *= lhs[ld] * min(rhs[rd], out[od])
        elif reversed_rhs:
            spatial *= min(lhs[ld], out[od]) * rhs[rd]
        else:
            spatial *= out[od] * rhs[rd]
    return 2 * out[ospec[0]] * out[ospec[1]] * rhs[rspec[1]] * spatial


def _subjaxprs(eqn):
    for p in eqn.params.values():
        for sub in (p if isinstance(p, (list, tuple)) else (p,)):
            if hasattr(sub, "eqns"):
                yield sub
            elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                yield sub.jaxpr


def jaxpr_flops(jaxpr):
    """The walker's count of a (closed) jaxpr."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    total = 0
    reversed_vars = set()
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "rev":
            reversed_vars.add(eqn.outvars[0])
        elif name == "conv_general_dilated":
            total += conv_flops(eqn, eqn.invars[1] in reversed_vars)
        elif name == "dot_general":
            total += dot_flops(eqn)
        if name in NOT_DESCENDED:
            continue
        if name == "cond":
            counts = {jaxpr_flops(b) for b in eqn.params["branches"]}
            assert len(counts) == 1, ("a cond's branches differ", counts)
            total += counts.pop()
            continue
        times = eqn.params["length"] if name == "scan" else 1
        total += times * sum(jaxpr_flops(s) for s in _subjaxprs(eqn))
    return total


# ---------------------------------------------------------------------------
# the configs and inputs
# ---------------------------------------------------------------------------

SMALL = dict(IMAGE_MIN_DIM=64, IMAGE_MAX_DIM=64, nvox=8, nvox_z=8,
             samples=4, RESNET50_STAGE4_BLOCKS=1, FOLD_BN=False,
             PRE_NMS_LIMIT=200, POST_NMS_ROIS_INFERENCE=50,
             DETECTION_MAX_INSTANCES=10)


def small(cfg, **extra):
    """`cfg`'s class at the test size, instantiated."""
    keys = dict(SMALL, **extra)
    if getattr(cfg, "TRANSFORMER", False):
        keys["samples"] = 1
    return type("Small_" + type(cfg).__name__, (type(cfg),), keys)()


def _inference_batch(cfg):
    """make_dummy_batch's inputs at `cfg` with seeded pixels and poses
    (views apart, so the geometry is not degenerate)."""
    from mulit_view_object_detection_torch.models.detector import (
        make_dummy_batch)
    batch = make_dummy_batch(cfg, training=False)
    rng = np.random.RandomState(0)
    batch["images"] = rng.randn(*batch["images"].shape).astype(
        np.float32) * 50.0
    if cfg.NUM_VIEWS > 1:
        batch["Rcam"] = _poses(rng, cfg.BATCH_SIZE, cfg.NUM_VIEWS)
    return batch


def _torch_inference_flops(cfg, variables, batch):
    model = TorchMaskRCNN(cfg).eval()
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return mfu_report.model_flops(
        model, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def _jax_inference_flops(cfg, variables, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jaxpr_flops(jax.make_jaxpr(
        lambda v, b: JaxMaskRCNN(cfg).apply(v, b)["detections"])(
            variables, jb))


@pytest.mark.parametrize("variant", ["vanilla", "conv3d", "lstm3d4",
                                     "xformer"])
def test_model_flops_equals_the_jaxpr_count_in_inference(variant,
                                                         monkeypatch):
    cfg = small(pv.variant_config(variant))
    variables = random_variables(cfg, seed=1)
    batch = _inference_batch(cfg)
    got = _torch_inference_flops(cfg, variables, batch)
    want = _jax_inference_flops(cfg, variables, batch)
    assert isinstance(got, int) and got > 0
    assert got == want, (variant, got, want, got - want)


def test_model_flops_equals_the_jaxpr_count_of_a_train_step():
    cfg = small(measure.flagship_train_config(), POST_NMS_ROIS_TRAINING=64,
                TRAIN_ROIS_PER_IMAGE=16, MAX_GT_INSTANCES=4)
    batch = measure.make_flagship_train_batch(cfg)
    batch["Rcam"] = _poses(np.random.RandomState(1), 1, cfg.NUM_VIEWS)
    variables = random_variables(cfg, seed=2)

    tx = jax_make_optimizer(cfg.LEARNING_RATE, cfg.LEARNING_MOMENTUM,
                            cfg.GRADIENT_CLIP_NORM)
    params = variables["params"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(params), tx=tx,
                       apply_fn=JaxMaskRCNN(cfg).apply)
    step = make_train_step(cfg, "all", donate=False)
    want = jaxpr_flops(jax.make_jaxpr(step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0)))

    model = TorchMaskRCNN(cfg).train()
    model.load_state_dict(flax_to_torch(variables), strict=True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb["rpn_match"] = tb["rpn_match"].long()
    tb["gt_class_ids"] = tb["gt_class_ids"].long()
    got = mfu_report.model_flops(model, tb, training=True)
    assert got > 0 and got == want, (got, want, got - want)


# ---------------------------------------------------------------------------
# eager bytes
# ---------------------------------------------------------------------------

def test_eager_bytes_of_a_two_layer_module_is_the_hand_count():
    """Linear(4 -> 8) then ReLU on a [2, 4] float32 input: addmm reads
    the bias (8), the input (2 x 4) and the weight (8 x 4, through a
    transposed view that moves nothing) and writes [2, 8]; relu reads
    and writes [2, 8]: (8 + 8 + 32 + 16) + (16 + 16) floats eager. It
    must move its inputs once and its output once: 8 + 8 + 32 + 16
    floats (the intermediate [2, 8] is not an input or an output)."""
    layer = torch.nn.Linear(4, 8)
    x = torch.ones(2, 4)
    moved = mfu_report.eager_bytes(lambda: torch.relu(layer(x)))
    assert moved == {"eager_ops": 2,
                     "eager_bytes": 4 * ((8 + 8 + 32 + 16) + (16 + 16)),
                     "min_bytes": 4 * (8 + 8 + 32 + 16)}


def test_min_bytes_counts_each_input_once_and_in_place_writes():
    """A [6] buffer that existed before is read by a mul and again, a
    slice of 3 of it, by an in-place add_ that writes that slice: read
    once (6), written once (3). The add_'s other input is read (3). An
    out= target is written, not read (5); a copy_ overwrites its target
    without reading it (4); the tensor made inside and returned is
    written once (6)."""
    buf, src = torch.ones(6), torch.arange(3.0)
    out, dst = torch.empty(5), torch.zeros(4)

    def fn():
        y = buf * 2.0
        buf[:3].add_(src)
        torch.add(torch.zeros(5), 1.0, out=out)
        dst.copy_(torch.ones(4))
        return y

    moved = mfu_report.eager_bytes(fn)
    assert moved["min_bytes"] == 4 * (6 + 3 + 3 + 5 + 4 + 6)
