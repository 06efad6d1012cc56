"""The port's small public names against the JAX package's, on seeded
inputs: the numpy box helpers (`apply_box_deltas_np`, `compute_iou_np`,
`non_max_suppression_np`), the torch `denorm_boxes` and
`iou_one_to_many`, `nms_sequential`, `crop_and_resize_pairs`,
`compat.batch_slice`, `camera_anchored_grid_points` and
`make_eval_step` (with BN_EVAL_BATCH_STATS).

Integer and index outputs must be equal; float32 outputs within 1e-6 (the
numpy copies run the same numpy code: equal); the model outputs of
`make_eval_step` at the detector tests' bar (`_close`: 1e-4 of the
output's scale), in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu import compat as jax_compat  # noqa: E402
from mulit_view_object_detection_tpu.models.detector import (  # noqa: E402
    MaskRCNN as JaxMaskRCNN)
from mulit_view_object_detection_tpu.ops import boxes as jboxes  # noqa: E402
from mulit_view_object_detection_tpu.ops import projection as jproj  # noqa: E402
from mulit_view_object_detection_tpu.ops.nms import (  # noqa: E402
    nms_sequential as jax_nms_sequential)
from mulit_view_object_detection_tpu.ops.roi_align import (  # noqa: E402
    crop_and_resize_pairs as jax_crop_and_resize_pairs)
from mulit_view_object_detection_tpu.train.step import (  # noqa: E402
    TrainState, make_eval_step as jax_make_eval_step)
from mulit_view_object_detection_torch import compat  # noqa: E402
from mulit_view_object_detection_torch.kernels import unproject  # noqa: E402
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as TorchMaskRCNN)
from mulit_view_object_detection_torch.models.layers import (  # noqa: E402
    set_compute_dtype)
from mulit_view_object_detection_torch.ops import boxes  # noqa: E402
from mulit_view_object_detection_torch.ops.nms import (  # noqa: E402
    nms_sequential)
from mulit_view_object_detection_torch.ops.projection import (  # noqa: E402
    camera_anchored_grid_points)
from mulit_view_object_detection_torch.ops.roi_align import (  # noqa: E402
    crop_and_resize_pairs)
from mulit_view_object_detection_torch.train.step import (  # noqa: E402
    make_eval_step)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch)
from tests.test_torch_convert import TinyMultiView, random_variables  # noqa: E402
from tests.test_torch_detector import (  # noqa: E402
    AllLevels, _batch, _close, _inputs)
from tests.test_torch_projection import _poses  # noqa: E402


def _boxes(rng, n, size=1.0, ints=False):
    """n boxes (y1, x1, y2, x2) inside [0, size]."""
    a = rng.uniform(0, size, (n, 2, 2))
    out = np.concatenate([a.min(1), a.max(1) + 0.01 * size], 1)
    return np.round(out).astype(np.int32) if ints else out.astype(np.float32)


# ---------------------------------------------------------------------------
# ops/boxes.py
# ---------------------------------------------------------------------------

def test_apply_box_deltas_np_matches_jax():
    rng = np.random.RandomState(0)
    b = _boxes(rng, 40, 64.0)
    d = rng.randn(40, 4).astype(np.float32) * 0.2
    np.testing.assert_array_equal(boxes.apply_box_deltas_np(b, d),
                                  jboxes.apply_box_deltas_np(b, d))


def test_compute_iou_np_matches_jax():
    rng = np.random.RandomState(1)
    b = _boxes(rng, 30, 50.0)
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    for i in range(3):
        np.testing.assert_array_equal(
            boxes.compute_iou_np(b[i], b, areas[i], areas),
            jboxes.compute_iou_np(b[i], b, areas[i], areas))


@pytest.mark.parametrize("ints", [False, True], ids=["float", "int"])
def test_non_max_suppression_np_matches_jax(ints):
    """Equal kept indices, score ties included (every score twice)."""
    rng = np.random.RandomState(2)
    b = _boxes(rng, 60, 32.0, ints=ints)
    scores = np.repeat(rng.uniform(size=30), 2).astype(np.float32)
    for threshold in (0.3, 0.5, 0.7):
        got = boxes.non_max_suppression_np(b, scores, threshold)
        want = jboxes.non_max_suppression_np(b, scores, threshold)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_denorm_boxes_matches_jax():
    rng = np.random.RandomState(3)
    b = rng.uniform(0, 1, (50, 4)).astype(np.float32)
    got = boxes.denorm_boxes(torch.from_numpy(b), (480, 640))
    want = np.asarray(jboxes.denorm_boxes(jnp.asarray(b), (480, 640)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_iou_one_to_many_matches_jax():
    """Zero-area boxes included: an empty union gives 0 on both sides."""
    rng = np.random.RandomState(4)
    b = _boxes(rng, 40)
    b[5] = b[5, [0, 1, 0, 1]]                    # zero area
    for i in (0, 5, 7):
        got = boxes.iou_one_to_many(torch.from_numpy(b[i]),
                                    torch.from_numpy(b))
        want = np.asarray(jboxes.iou_one_to_many(jnp.asarray(b[i]),
                                                 jnp.asarray(b)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# ops/nms.py, ops/roi_align.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [False, True], ids=["plain", "classes"])
def test_nms_sequential_matches_jax(gated):
    """Equal kept indices and validity, with invalid entries, per-class
    suppression and score ties, and K above the number kept."""
    rng = np.random.RandomState(5)
    n = 48
    b = _boxes(rng, n)
    scores = np.repeat(rng.uniform(size=n // 2), 2).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    cls = rng.randint(1, 4, n).astype(np.int32) if gated else None
    for k, thr in ((10, 0.5), (40, 0.3)):
        got_idx, got_ok = nms_sequential(
            torch.from_numpy(b), torch.from_numpy(scores), k, thr,
            torch.from_numpy(valid),
            None if cls is None else torch.from_numpy(cls))
        want_idx, want_ok = jax_nms_sequential(
            jnp.asarray(b), jnp.asarray(scores), k, thr, jnp.asarray(valid),
            None if cls is None else jnp.asarray(cls))
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert not got_ok.numpy().all()           # K = 40 keeps fewer


@pytest.mark.parametrize("extrapolation", [0.0, -1.5])
def test_crop_and_resize_pairs_matches_jax(extrapolation):
    """Boxes reaching outside the image: those samples take the
    extrapolation value."""
    rng = np.random.RandomState(6)
    images = rng.randn(5, 12, 10, 3).astype(np.float32)
    b = rng.uniform(-0.3, 1.3, (5, 2, 2))
    b = np.concatenate([b.min(1), b.max(1)], 1).astype(np.float32)
    for size in ((7, 7), (1, 1), (4, 6)):
        got = crop_and_resize_pairs(torch.from_numpy(images),
                                    torch.from_numpy(b), size, extrapolation)
        want = np.asarray(jax_crop_and_resize_pairs(
            jnp.asarray(images), jnp.asarray(b), size, extrapolation))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got.numpy() == extrapolation).any()


# ---------------------------------------------------------------------------
# compat, projection
# ---------------------------------------------------------------------------

def test_batch_slice_matches_jax():
    rng = np.random.RandomState(7)
    x, y = rng.randn(3, 4, 2), rng.randn(3, 5)

    def two(a, b):
        return a.sum(0), b * 2

    for fn, inputs in ((two, [x, y]), (lambda a: a.T, x)):
        got = compat.batch_slice(inputs, fn, 3)
        want = jax_compat.batch_slice(inputs, fn, 3)
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("grid_dist", [None, 6.0])
def test_camera_anchored_grid_points_matches_jax(grid_dist):
    """Seeded poses, as tests/test_projection.py:206 builds them; the
    Notebook's fallback distance without GRID_DIST."""
    cfg = TinyMultiView()
    if grid_dist is not None:
        cfg.GRID_DIST = grid_dist
    rcam = _poses(np.random.RandomState(8), 2, 2)
    got = camera_anchored_grid_points(cfg, torch.from_numpy(rcam))
    want = jproj.camera_anchored_grid_points(cfg, rcam)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_compat_exports_the_jax_names():
    names = ("Config", "MaskRCNN", "compute_backbone_shapes", "compute_ap",
             "compute_ap_range", "compute_matches", "compute_recall",
             "expand_mask", "minimize_mask", "mold_image", "resize_image",
             "resize_mask", "unmold_image", "unmold_mask", "batch_slice")
    assert all(hasattr(compat, n) for n in names)
    cfg = TinyMultiView()
    np.testing.assert_array_equal(
        compat.compute_backbone_shapes(cfg, (64, 64)),
        jax_compat.compute_backbone_shapes(cfg, (64, 64)))


# ---------------------------------------------------------------------------
# train/step.py::make_eval_step
# ---------------------------------------------------------------------------

class EvalSlice(AllLevels):
    """2 views at 64^2, conv3d, every level fused, float32."""
    NAME = "torch_eval_step"
    IMAGE_MIN_DIM = IMAGE_MAX_DIM = 64
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)


class EvalBatchStats(EvalSlice):
    NAME = "torch_eval_step_bn"
    TRAIN_BN = True
    BN_EVAL_BATCH_STATS = True


def test_make_eval_step_matches_jax(monkeypatch):
    """With TRAIN_BN and BN_EVAL_BATCH_STATS: the outputs of JAX
    make_eval_step and the port's from the same weights (BatchNorm
    statistics non-trivial) on the same batch, computed in float64 on
    both sides (float32 batch statistics amplify rounding past the bar:
    3.4e-4 in rpn_probs at 64^2; ROADMAP Queue 3); the port's BatchNorm
    buffers bit-unchanged after the call; the outputs differ from the
    frozen BatchNorms' (make_eval_step of the config without the flags,
    plain inference, held to JAX in tests/test_torch_detector.py)."""
    cfg = EvalBatchStats()
    variables = random_variables(cfg, seed=0)
    batch = _batch(cfg, *_inputs(cfg, 0))
    with monkeypatch.context() as m, jax.enable_x64(True):
        m.setattr(JaxMaskRCNN, "_dtype", lambda self: jnp.float64)
        state = TrainState(step=0, params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=None, tx=None,
                           apply_fn=JaxMaskRCNN(cfg).apply)
        ref = jax_make_eval_step(cfg)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        ref = {k: np.asarray(v, np.float32) for k, v in ref.items()}
    # the plain geometry gathers in float64 (the kernels' wrappers check
    # for float32 and bfloat16)
    monkeypatch.setattr(unproject, "_check_device", lambda t, what: None)
    model = TorchMaskRCNN(cfg).eval()
    model.load_state_dict(flax_to_torch(variables), strict=True)
    model.double()
    set_compute_dtype(model, torch.float64)
    model.compute_dtype = torch.float64
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    inputs = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    inputs = {k: v.double() if v.dtype == torch.float32 else v
              for k, v in inputs.items()}
    got = make_eval_step(cfg)(model, inputs)
    assert set(got) == set(ref)
    for key in ("rpn_probs", "rpn_bbox", "proposals", "mrcnn_probs",
                "mrcnn_bbox", "detections", "mrcnn_masks"):
        _close(got[key].float().numpy(), ref[key], key)
    assert all(torch.equal(b, buffers[n]) for n, b in model.named_buffers())
    model.config = EvalSlice()
    frozen = make_eval_step(model.config)(model, inputs)
    assert not torch.allclose(frozen["rpn_probs"], got["rpn_probs"])
    assert all(torch.equal(b, buffers[n]) for n, b in model.named_buffers())
