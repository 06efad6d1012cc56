"""The port's rendering (utils/visualize.py) and the `visualize` commands
against the JAX package's, on the CPU (matplotlib on its Agg backend).

* On seeded detections: the pixel arrays of `apply_mask`, `draw_box` and
  `save_image` (each mode; the JPEGs decoded) equal the JAX functions'
  arrays, the port's given tensors and JAX's numpy arrays;
  `random_colors` under the same Python seed and `fixed_colors` give the
  same colours; `display_weight_stats` the same table; the other
  renderers take tensors. Where matplotlib is not installed, save_image
  draws with OpenCV: a JPEG of the image's size with the masks blended.
* `cli/interior_multi.py visualize` against the JAX command on the
  synthetic InteriorNet export, with the same weights (the JAX tree
  converted by utils/convert.py): the same file names, and the same
  images where both drew the same detections, else the drawn detections
  at the bar of tests/test_fullgraph_parity.py:15-19 (one swapped tail
  detection allowed). The transformer command writes one image a key
  under Results/transformer, the JAX command's names (drawn without
  matplotlib).
"""

import argparse
import importlib.util
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")
pytest.importorskip("matplotlib")

from mulit_view_object_detection_tpu.cli import (  # noqa: E402
    interior_multi as jax_cli)
from mulit_view_object_detection_tpu.eval.metrics import (  # noqa: E402
    greedy_box_matches)
from mulit_view_object_detection_tpu.train.step import TrainState  # noqa: E402
from mulit_view_object_detection_tpu.utils import (  # noqa: E402
    visualize as jvis)
from mulit_view_object_detection_torch.cli import (  # noqa: E402
    interior_multi as cli, interior_transformer as xf_cli)
from mulit_view_object_detection_torch.utils import visualize  # noqa: E402
from tests.test_torch_cli import (  # noqa: E402, F401
    EVAL, SMALL, _checkpoint, _shrink, tree)
from tests.test_torch_convert import random_variables  # noqa: E402

NAMES = ["BG", "chair", "table", "sofa", "lamp"]


def _detections(seed=0, hw=64, n=5):
    """A seeded image and n detections: int boxes, blob masks inside
    them, class ids, scores (one below save_image's 0.1 threshold) and
    one zero (padded) slot."""
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (hw, hw, 3)).astype(np.uint8)
    boxes = np.zeros((n, 4), np.int32)
    masks = np.zeros((hw, hw, n), np.uint8)
    for i in range(n - 1):
        y1, x1 = rng.randint(0, hw // 2, 2)
        y2, x2 = y1 + rng.randint(8, hw // 2), x1 + rng.randint(8, hw // 2)
        boxes[i] = (y1, x1, y2, x2)
        masks[y1:y2, x1:x2, i] = rng.uniform(size=(y2 - y1, x2 - x1)) > 0.3
    class_ids = np.array([1, 2, 3, 4, 0], np.int32)[:n]
    scores = np.array([0.95, 0.8, 0.05, 0.6, 0.0], np.float32)[:n]
    return image, boxes, masks, class_ids, scores


@pytest.mark.parametrize("alpha", [0.5, 0.3])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint32])
def test_apply_mask_matches_jax(alpha, dtype):
    image, _, masks, _, _ = _detections()
    color = (1.0, 0.4, 0.1)
    for i in range(masks.shape[-1]):
        got = visualize.apply_mask(torch.from_numpy(image.astype(dtype)),
                                   torch.from_numpy(masks[:, :, i]), color,
                                   alpha)
        want = jvis.apply_mask(image.astype(dtype), masks[:, :, i], color,
                               alpha)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_draw_box_matches_jax():
    image, boxes, _, _, _ = _detections(1)
    for box in boxes:
        got = visualize.draw_box(image.copy(), torch.from_numpy(box),
                                 (255, 0, 0))
        want = jvis.draw_box(image.copy(), box, (255, 0, 0))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_save_image_matches_jax(tmp_path, mode):
    image, boxes, masks, class_ids, scores = _detections(2)
    got = visualize.save_image(
        torch.from_numpy(image), "scene", torch.from_numpy(boxes),
        torch.from_numpy(masks), torch.from_numpy(class_ids),
        torch.from_numpy(scores), NAMES, save_dir=str(tmp_path / "port"),
        mode=mode)
    want = jvis.save_image(image, "scene", boxes, masks, class_ids, scores,
                           NAMES, save_dir=str(tmp_path / "jax"), mode=mode)
    assert os.path.basename(got) == os.path.basename(want) == "scene.jpg"
    got, want = cv2.imread(got), cv2.imread(want)
    assert want is not None and want.size
    np.testing.assert_array_equal(got, want)


def test_colors_match_jax():
    random.seed(11)
    got = visualize.random_colors(9)
    random.seed(11)
    assert got == jvis.random_colors(9)
    for bright in (True, False):
        assert visualize.fixed_colors(7, bright, seed=3) == \
            jvis.fixed_colors(7, bright, seed=3)


def test_display_weight_stats_matches_jax():
    rng = np.random.RandomState(3)
    state = {"conv.weight": rng.randn(4, 3, 3, 3).astype(np.float32),
             "conv.bias": rng.randn(4).astype(np.float32)}
    got = visualize.display_weight_stats(
        {k: torch.from_numpy(v) for k, v in state.items()})
    want = jvis.display_weight_stats(state)
    # the state_dict's order; the JAX tree's keys are sorted
    assert got[0] == want[0] and sorted(got[1:]) == sorted(want[1:])
    assert len(got) == 3


def test_renderers_take_tensors():
    """The notebook renderers, each given tensors, draw without error."""
    image, boxes, masks, class_ids, scores = _detections(4)
    t = torch.from_numpy
    assert visualize.display_instances(t(image), t(boxes), t(masks),
                                       t(class_ids), NAMES, t(scores))
    visualize.draw_boxes(t(image), boxes=t(boxes),
                         refined_boxes=t(boxes.astype(np.float32)),
                         masks=t(masks), captions=list("abcde"),
                         visibilities=[0, 1, 2, 2, 1])
    assert visualize.display_images([t(image), image], titles=["1", "2"])
    assert visualize.draw_rois(t(image), t(boxes.astype(np.float32)),
                               t(boxes.astype(np.float32) + 1.0), t(masks),
                               t(class_ids), NAMES, limit=3)
    assert visualize.display_detections(t(image), t(boxes), t(boxes),
                                        t(masks), t(class_ids), NAMES,
                                        t(scores))
    assert visualize.display_top_masks(t(image), t(masks), t(class_ids),
                                       NAMES, limit=2)
    assert visualize.plot_overlaps(t(np.array([1, 2])), t(np.array([1, 1])),
                                   t(np.array([0.9, 0.7])),
                                   t(np.array([[0.8, 0.1], [0.2, 0.6]])),
                                   NAMES)
    assert visualize.plot_precision_recall(0.5, t(np.array([1.0, 0.5])),
                                           t(np.array([0.0, 1.0])))


def _without_matplotlib(monkeypatch):
    """importlib finds no matplotlib, as on a host without it."""
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == "matplotlib" else find_spec(name, *a))


def test_save_image_without_matplotlib(tmp_path, monkeypatch):
    """A JPEG of the image's own size; inside a mask and away from the
    boxes' lines and captions the pixels are the blended canvas's, up to
    JPEG's loss (on a smooth image)."""
    _without_matplotlib(monkeypatch)
    _, boxes, masks, class_ids, _ = _detections(5, hw=96)
    scores = np.array([0.9, 0.05, 0.05, 0.05, 0.0], np.float32)   # one drawn
    ramp = np.linspace(0, 255, 96)
    image = np.stack(np.broadcast_arrays(ramp[:, None], ramp[None, :],
                                         128.0), -1).astype(np.uint8)
    masks[:] = 0                       # solid masks: JPEG keeps them
    for i, (y1, x1, y2, x2) in enumerate(boxes):
        masks[y1:y2, x1:x2, i] = 1
    y1, x1, y2, x2 = boxes[0]
    path = visualize.save_image(image, "k", boxes, masks, class_ids, scores,
                                NAMES, save_dir=str(tmp_path), mode=0)
    assert path == str(tmp_path / "k.jpg")
    got = cv2.imread(path)[..., ::-1]
    assert got.shape == image.shape
    canvas = visualize.apply_mask(image.astype(np.uint32), masks[:, :, 0],
                                  visualize.fixed_colors(1)[0])
    inner = (slice(y1 + 12, y2 - 3), slice(x1 + 3, x2 - 3))
    diff = np.abs(got[inner].astype(int) - canvas[inner].astype(int))
    assert diff.mean() < 8, diff.mean()


# ---------------------------------------------------------------------------
# the visualize commands
# ---------------------------------------------------------------------------

def _recorded(module, monkeypatch):
    """Wrap `module.save_image` to keep each call's arguments."""
    calls, save = [], module.save_image

    def wrapped(image, name, boxes, masks, class_ids, scores, *a, **k):
        calls.append({"rois": np.asarray(boxes), "masks": np.asarray(masks),
                      "class_ids": np.asarray(class_ids),
                      "scores": np.asarray(scores)})
        return save(image, name, boxes, masks, class_ids, scores, *a, **k)
    monkeypatch.setattr(module, "save_image", wrapped)
    return calls


def _drawn(call):
    """What save_image draws: each selected detection's box, class and
    caption's score."""
    return [(tuple(call["rois"][i]), int(call["class_ids"][i]),
             f"{call['scores'][i]:.3f}")
            for i in range(len(call["class_ids"]))
            if np.any(call["rois"][i]) and call["scores"][i] >= 0.1]


def _at_the_bar(ref, got):
    """tests/test_fullgraph_parity.py:15-19's bar on two detect results."""
    n_ref = len(ref["class_ids"])
    assert abs(n_ref - len(got["class_ids"])) <= 1
    matches = greedy_box_matches(
        ref["rois"].astype(np.float32), ref["class_ids"],
        got["rois"].astype(np.float32), got["class_ids"], iou_threshold=0.9)
    assert len(matches) >= n_ref - 1
    for ri, gi, _ in matches:
        assert abs(float(got["scores"][gi]) - float(ref["scores"][ri])) < 0.02
        a, b = ref["masks"][..., ri], got["masks"][..., gi]
        union = np.logical_or(a, b).sum()
        if union:
            assert np.logical_and(a, b).sum() / union > 0.85


def test_visualize_command_matches_jax(tree, tmp_path, monkeypatch):
    jcfg = jax_cli._apply_overrides(jax_cli.InferenceConfig(), EVAL)
    variables = random_variables(jcfg, seed=2)

    def jax_weights(model, args):
        model._state = TrainState(
            step=0, params=variables["params"],
            batch_stats=variables["batch_stats"], opt_state=None, tx=None,
            apply_fn=model.model.apply)

    monkeypatch.setattr(jax_cli, "_load_model_weights", jax_weights)
    monkeypatch.setattr(cli, "_load_model_weights",
                        lambda model, args: model.load_flax_variables(
                            variables))
    jcalls = _recorded(jax_cli.visualize, monkeypatch)
    calls = _recorded(visualize, monkeypatch)
    args = dict(dataset=tree, model=None, logs=str(tmp_path), limit=2,
                overrides=EVAL)
    monkeypatch.chdir(tmp_path)
    jax_cli.cmd_visualize(argparse.Namespace(**args))
    paths = cli.main(["visualize", "--dataset", tree, "--logs",
                      str(tmp_path), "--limit", "2", "--overrides", EVAL,
                      "--device", "cpu", "--results", str(tmp_path / "port")])
    want_dir = os.path.join("Results", "NV2")
    names = sorted(os.listdir(want_dir))
    assert len(names) == len(calls) == len(jcalls) == 2
    assert sorted(os.path.basename(p) for p in paths) == names
    assert sorted(os.listdir(tmp_path / "port" / "NV2")) == names
    for name, ref, got in zip(names, jcalls, calls):
        assert len(_drawn(ref)) >= 3
        if _drawn(ref) == _drawn(got) and np.array_equal(ref["masks"],
                                                         got["masks"]):
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / "port" / "NV2" / name)),
                cv2.imread(os.path.join(want_dir, name)))
        else:
            _at_the_bar(ref, got)


def test_transformer_visualize_writes_the_jax_names(tree, tmp_path,
                                                     monkeypatch):
    overrides = (SMALL.replace("TOP_DOWN_PYRAMID_SIZE=16",
                               "TOP_DOWN_PYRAMID_SIZE=12")
                 + ",XFORMER_D_MODEL=12,XFORMER_NUM_HEADS=2,XFORMER_DFF=16,"
                 "XFORMER_NUM_LAYERS=1,XFORMER_TARGET_SIZE=4,nvox=8,"
                 "DETECTION_MIN_CONFIDENCE=0.0")
    ckpt = _checkpoint(xf_cli.TransformerInferenceConfig, overrides,
                       tmp_path)
    _shrink(monkeypatch, xf_cli.TransformerInferenceConfig, overrides)
    _without_matplotlib(monkeypatch)
    monkeypatch.chdir(tmp_path)
    paths = xf_cli.main(["visualize", "--dataset", tree, "--logs",
                         str(tmp_path), "--model", ckpt, "--limit", "1",
                         "--device", "cpu"])
    keys = list(xf_cli.load_dataset(tree, "test").view_map)[:1]
    assert paths == [os.path.join("Results", "transformer", f"{k}.jpg")
                     for k in keys]
    assert cv2.imread(paths[0]).shape[:2] == (128, 128)
