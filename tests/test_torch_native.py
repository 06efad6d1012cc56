"""The port's bindings of native/maskops.cpp (data/native.py) against the
JAX package's bindings of the same source and against their own numpy
plain versions, bit for bit: instance extraction from random label maps,
the anchor matcher on random boxes and on boxes with exact IoU ties, and
box extraction in both layouts. Then the RPN targets that now go through
the port's matcher, against the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mulit_view_object_detection_tpu.config import Config  # noqa: E402
from mulit_view_object_detection_tpu.data import native as jnative  # noqa: E402
from mulit_view_object_detection_tpu.ops import targets as JT  # noqa: E402
from mulit_view_object_detection_tpu.ops.anchors import (  # noqa: E402
    generate_pyramid_anchors)
from mulit_view_object_detection_torch.data import native  # noqa: E402
from mulit_view_object_detection_torch.ops.boxes import (  # noqa: E402
    extract_bboxes_np)
from mulit_view_object_detection_torch.ops import targets as T  # noqa: E402


def _label_maps(seed, h=40, w=56, n_inst=9):
    """Random blobby instance and NYU label maps: rectangles drawn over
    each other (so instances are cut into odd shapes), instance ids
    sparse, some NYU classes mapped to 0 (dropped)."""
    rng = np.random.RandomState(seed)
    inst = np.zeros((h, w), np.int32)
    nyu = np.ones((h, w), np.int32)
    ids = rng.choice(np.arange(1, 250), n_inst, replace=False)
    for i in ids:
        y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
        dy, dx = rng.randint(2, h // 2), rng.randint(2, w // 2)
        inst[y:y + dy, x:x + dx] = i
        nyu[y:y + dy, x:x + dx] = rng.randint(0, 41)
    nyu_map = {k: (k % 7) for k in range(41)}
    return inst, nyu, nyu_map


def _boxes(rng, n, size=64.0):
    a = rng.uniform(0, size, (n, 4)).astype(np.float32)
    return np.concatenate([np.minimum(a[:, :2], a[:, 2:]),
                           np.maximum(a[:, :2], a[:, 2:]) + 1.0], axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_extract_instances_equals_jax_and_plain(seed):
    inst, nyu, nyu_map = _label_maps(seed)
    got = native.extract_instances(inst, nyu, nyu_map)
    ref = jnative.extract_instances(inst, nyu, nyu_map)
    assert jnative._load() is not None
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    # the plain version lists instances by label, the library by first
    # pixel: the same set of (mask, class, box)
    plain = native.extract_instances_np(inst, nyu, nyu_map)
    assert len(plain[1]) == len(got[1]) > 0

    def key(masks, cls, boxes):
        return sorted((m.tobytes(), int(c), tuple(b))
                      for m, c, b in zip(masks, cls, boxes))
    assert key(*got) == key(*plain)


def test_extract_instances_all_dropped_and_capacity():
    inst, nyu, _ = _label_maps(5)
    masks, cls, boxes = native.extract_instances(inst, nyu, {})
    assert masks.shape == (0,) + inst.shape and cls.shape == (0,)
    got = native.extract_instances(inst, nyu, {k: 1 for k in range(41)},
                                   max_inst=2)
    ref = jnative.extract_instances(inst, nyu, {k: 1 for k in range(41)},
                                    max_inst=2)
    assert len(got[1]) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_anchor_gt_match_bit_equal(case):
    rng = np.random.RandomState(7)
    if case == "random":
        anchors, gt = _boxes(rng, 700), _boxes(rng, 9)
    else:
        # a grid of identical-size anchors: each GT box overlaps several
        # of them by exactly the same IoU, so the forced set has ties and
        # argmax must take the first of equal maxima
        ys, xs = np.meshgrid(np.arange(0, 64, 4.0), np.arange(0, 64, 4.0),
                             indexing="ij")
        anchors = np.stack([ys.ravel(), xs.ravel(), ys.ravel() + 8,
                            xs.ravel() + 8], 1).astype(np.float32)
        gt = np.array([[2, 2, 10, 10], [16, 16, 24, 24], [30, 6, 38, 14],
                       [2, 2, 10, 10]], np.float32)
    got = native.anchor_gt_match(anchors, gt)
    plain = native.anchor_gt_match_np(anchors, gt)
    ref = jnative.anchor_gt_match(anchors, gt)
    for g, p, r in zip(got, plain, ref):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype
    if case == "ties":
        assert got[2].sum() > gt.shape[0]       # ties: more than one each


def test_native_calls_validate_shapes():
    rng = np.random.RandomState(0)
    anchors = _boxes(rng, 10)
    with pytest.raises(ValueError):
        native.anchor_gt_match(anchors[:, :3], _boxes(rng, 2))
    inst, nyu, nyu_map = _label_maps(0)
    with pytest.raises(ValueError):
        native.extract_instances(inst, nyu[:-1], nyu_map)
    with pytest.raises(ValueError):
        native.anchor_gt_match(anchors, np.zeros((0, 4), np.float32))
    with pytest.raises(ValueError):
        native.anchor_gt_match(anchors, _boxes(rng, native.MAX_NATIVE_GT + 1))


@pytest.mark.parametrize("layout", ["HWN", "NHW"])
def test_extract_bboxes_bit_equal(layout):
    rng = np.random.RandomState(3)
    masks = rng.rand(6, 24, 40) > 0.97
    masks[2] = False                       # an empty mask: the zero box
    masks[4, :, 0] = True                  # a full-height column
    arr = masks if layout == "NHW" else np.transpose(masks, (1, 2, 0))
    got = native.extract_bboxes(arr, layout=layout)
    np.testing.assert_array_equal(got, jnative.extract_bboxes(arr, layout))
    np.testing.assert_array_equal(
        got, extract_bboxes_np(np.transpose(masks, (1, 2, 0))))
    np.testing.assert_array_equal(got[2], [0, 0, 0, 0])
    with pytest.raises(ValueError):
        native.extract_bboxes(arr, layout="WHN")


def test_library_builds_into_the_checkout():
    path = native.library_path()
    native.load()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    import os
    assert os.path.exists(path)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No quiet fallback: a library that cannot be built raises."""
    bad = tmp_path / "maskops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()


class RpnCfg(Config):
    NAME = "rpn_native"
    RPN_TRAIN_ANCHORS_PER_IMAGE = 64


@pytest.mark.parametrize("seed", [0, 1])
def test_rpn_targets_through_native_match_jax(seed):
    """build_rpn_targets with the port's native matcher equals the JAX
    function (which uses its own binding), crowds included."""
    cfg = RpnCfg()
    anchors = generate_pyramid_anchors((32, 64), (0.5, 1, 2),
                                       [(32, 32), (16, 16), (8, 8)],
                                       (4, 8, 16), 1).astype(np.float32)
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, 6, size=120.0)
    cls = np.array([1, 2, -1, 3, 1, 2], np.int32)
    got = T.build_rpn_targets(anchors, cls, boxes, cfg,
                              rnd_state=np.random.RandomState(seed))
    ref = JT.build_rpn_targets(anchors, cls, boxes, cfg,
                               rnd_state=np.random.RandomState(seed))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert (got[0] == 1).any() and (got[0] == -1).any()
