"""Detection ops of the port against the JAX package and against real
TensorFlow kernel outputs (tests/fixtures/golden_tf.npz): NMS with its
tie order, proposals over constant-span score ties, crop-and-resize,
pyramid ROI align, refine_detections, anchors, boxes and image meta.

Tolerances: selections (indices, order) must be identical; boxes and
samples are float32 arithmetic in the same order as the JAX ops, held at
the golden tests' own 1e-5 (rtol 1e-4 for refine, as
tests/test_golden_parity.py).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.ops import anchors as janchors  # noqa: E402
from mulit_view_object_detection_tpu.ops import boxes as jboxes  # noqa: E402
from mulit_view_object_detection_tpu.ops.detection import (  # noqa: E402
    refine_detections as jax_refine)
from mulit_view_object_detection_tpu.ops.nms import nms as jax_nms  # noqa: E402
from mulit_view_object_detection_tpu.ops.proposals import (  # noqa: E402
    generate_proposals as jax_proposals)
from mulit_view_object_detection_tpu.ops.roi_align import (  # noqa: E402
    pyramid_roi_align as jax_pyramid)
from mulit_view_object_detection_torch.ops import anchors, boxes  # noqa: E402
from mulit_view_object_detection_torch.ops import image_meta  # noqa: E402
from mulit_view_object_detection_torch.ops.detection import (  # noqa: E402
    refine_detections)
from mulit_view_object_detection_torch.ops.nms import nms  # noqa: E402
from mulit_view_object_detection_torch.ops.proposals import (  # noqa: E402
    generate_proposals)
from mulit_view_object_detection_torch.ops.roi_align import (  # noqa: E402
    crop_and_resize_pairs, pyramid_roi_align)
from tests.test_torch_convert import TinyMultiView  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_tf.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_matches_tf(golden, thresh):
    """Same survivors, same order as tf.image.non_max_suppression,
    including the score-tie block."""
    keep, valid = nms(_t(golden["nms_boxes"]), _t(golden["nms_scores"]), 32,
                      thresh)
    np.testing.assert_array_equal(keep[valid].numpy(),
                                  golden[f"nms_{thresh}_selected"])


def test_nms_class_gated_with_ties_matches_jax():
    rng = np.random.RandomState(0)
    n = 200
    y1x1 = rng.uniform(0, 0.8, (n, 2))
    b = np.concatenate([y1x1, y1x1 + rng.uniform(0.05, 0.3, (n, 2))],
                       axis=1).astype(np.float32)
    scores = np.round(rng.rand(n), 1).astype(np.float32)   # many exact ties
    cls = rng.randint(0, 3, n)
    valid = rng.rand(n) > 0.2
    for kw in ({}, {"class_ids": cls}, {"valid_mask": valid,
                                        "class_ids": cls}):
        got, gv = nms(_t(b), _t(scores), 40, 0.4,
                      **{k: _t(v) for k, v in kw.items()})
        ref, rv = jax_nms(jnp.asarray(b), jnp.asarray(scores), 40, 0.4,
                          **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


def test_proposals_const_span_ties_match_jax():
    """RPN scores where two pyramid levels are k-periodic constants (the
    constant-folded zero levels, ~all anchors exact ties): the stable sort
    selects the same anchors in the same order as the JAX const-span
    top-k merge."""
    cfg = TinyMultiView()
    a = anchors.get_anchors(cfg, (64, 64))
    counts = [16 * 16 * 3, 8 * 8 * 3, 4 * 4 * 3, 2 * 2 * 3, 1 * 1 * 3]
    rng = np.random.RandomState(1)
    b = 2
    probs = rng.rand(b, a.shape[0]).astype(np.float32)
    consts = rng.rand(2, b, 3).astype(np.float32)
    consts[1, :, 0] = consts[0, :, 0]                   # cross-level ties
    probs[:, 5] = consts[0, :, 2]                       # ... and real-level
    spans, off = [], 0
    for li, n_l in enumerate(counts):
        if li in (0, 1):
            probs[:, off:off + n_l] = np.tile(consts[li], n_l // 3)
            spans.append((off, n_l, 3))
        off += n_l
    rpn_probs = np.stack([1 - probs, probs], -1).astype(np.float32)
    deltas = (0.3 * rng.randn(b, a.shape[0], 4)).astype(np.float32)
    kw = dict(proposal_count=40, nms_threshold=0.7, pre_nms_limit=300,
              bbox_std_dev=np.array([0.1, 0.1, 0.2, 0.2]))
    got = generate_proposals(_t(rpn_probs), _t(deltas), _t(a), **kw)
    ref = jax_proposals(jnp.asarray(rpn_probs), jnp.asarray(deltas),
                        jnp.asarray(a), const_spans=tuple(spans), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("size", [(7, 7), (1, 1), (3, 5)])
def test_crop_and_resize_matches_tf(golden, size):
    key = f"car_{size[0]}x{size[1]}"
    got = crop_and_resize_pairs(_t(golden[f"{key}_images"]),
                                _t(golden[f"{key}_boxes"]), size)
    np.testing.assert_allclose(got.numpy(), golden[f"{key}_expected"],
                               rtol=1e-5, atol=1e-5)


def test_pyramid_roi_align_matches_jax():
    rng = np.random.RandomState(2)
    b, c = 2, 3
    maps = [rng.randn(b, s, s, c).astype(np.float32) for s in (32, 16, 8, 4)]
    y1x1 = rng.uniform(-0.1, 0.9, (b, 30, 2))
    hw = rng.uniform(0.01, 0.9, (b, 30, 2))
    bx = np.concatenate([y1x1, y1x1 + hw], -1).astype(np.float32)
    bx[:, -3:] = 0.0                                    # zero padding rows
    bx[0, 0] = [0.0, 0.0, 1.0, 1.0]                     # exact edges
    for pool in (7, 14):
        got = pyramid_roi_align(_t(bx), [_t(m) for m in maps], (128, 128),
                                pool)
        ref = jax_pyramid(jnp.asarray(bx), [jnp.asarray(m) for m in maps],
                          (128, 128), pool)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_refine_detections_matches_tf_and_jax(golden):
    kw = dict(bbox_std_dev=np.array([0.1, 0.1, 0.2, 0.2]),
              detection_min_confidence=0.3, detection_max_instances=16,
              detection_nms_threshold=0.3)
    args = [golden["refine_rois"][None], golden["refine_probs"][None],
            golden["refine_deltas"][None], golden["refine_window"][None]]
    got = refine_detections(*map(_t, args), **kw)[0].numpy()
    np.testing.assert_allclose(got, golden["refine_expected"], rtol=1e-4,
                               atol=1e-5)
    ref = np.asarray(jax_refine(*map(jnp.asarray, args), **kw))[0]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_host_helpers_match_jax():
    cfg = TinyMultiView()
    for shape in ((64, 64), (128, 96)):
        np.testing.assert_array_equal(anchors.get_anchors(cfg, shape),
                                      janchors.get_anchors(cfg, shape))
    rng = np.random.RandomState(3)
    bx = rng.uniform(0, 60, (10, 4)).astype(np.float32)
    np.testing.assert_array_equal(boxes.norm_boxes_np(bx, (64, 80)),
                                  jboxes.norm_boxes_np(bx, (64, 80)))
    np.testing.assert_array_equal(boxes.denorm_boxes_np(bx / 64, (64, 80)),
                                  jboxes.denorm_boxes_np(bx / 64, (64, 80)))
    np.testing.assert_allclose(
        boxes.norm_boxes(_t(bx), (64, 80)).numpy(),
        np.asarray(jboxes.norm_boxes(jnp.asarray(bx), (64, 80))), atol=1e-7)
    d = (0.2 * rng.randn(10, 4)).astype(np.float32)
    np.testing.assert_allclose(
        boxes.apply_box_deltas(_t(bx), _t(d)).numpy(),
        np.asarray(jboxes.apply_box_deltas(jnp.asarray(bx), jnp.asarray(d))),
        rtol=1e-6)
    np.testing.assert_allclose(
        boxes.overlaps(_t(bx), _t(bx[::-1])).numpy(),
        np.asarray(jboxes.overlaps(jnp.asarray(bx), jnp.asarray(bx[::-1]))),
        atol=1e-6)
    meta = image_meta.compose_image_meta(3, (60, 80, 3), (64, 64, 3),
                                         (2, 0, 62, 64), 0.8, np.ones(4))
    parsed = image_meta.parse_image_meta(meta)
    assert parsed["image_id"] == 3
    np.testing.assert_array_equal(parsed["window"], [2, 0, 62, 64])
    np.testing.assert_array_equal(parsed["active_class_ids"], np.ones(4))
