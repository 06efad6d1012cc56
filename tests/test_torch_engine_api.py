"""The rest of the port's engine API (compat/model.py): the uint8 image
transfer, detect_molded, run_graph, ancestor, and batches of more than
one scene, against the JAX engine (tests/test_compat.py:82-180) with the
same weights on CPU.

Tolerances: the uint8 transfer de-molds on the device with the host's
float32 arithmetic, so its detections equal the float path's bit for
bit; detect_molded runs the same forward as detect on the same floats:
equal. The port against the JAX package goes through two conv backends
(XLA vs oneDNN): run_graph's tensors within 1e-4 of each tensor's
magnitude (tests/test_torch_detector.py), but for mrcnn_masks within
1e-3: the mask head's five layers run on ROIs pooled at the detections'
boxes, which carry the drift of everything before them (seeds 0, 2 and 8
of this test measured 7.7e-5, 5.7e-4 and 2.1e-4); engine results at the bar of
tests/test_fullgraph_parity.py. A scene of a batch of two against the
same scene alone in the port: the same bar, and class ids, boxes and
scores of the matched detections within 1e-5 (oneDNN may block a batch
of two differently from one).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402,F401  (the JAX engine below)

from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from tests.test_torch_bn_fold import _jax_engine, assert_parity  # noqa: E402
from tests.test_torch_convert import random_variables  # noqa: E402
from tests.test_torch_detector import (  # noqa: E402
    AllLevels, _batch, _close, _inputs)
from tests.test_torch_slice3 import (  # noqa: E402
    ModeSlice, calibrated_variables)


def _scenes(cfg, seeds):
    """Scenes [V, H, W, 3] uint8 and their stacked poses and intrinsics."""
    scenes, rcams, kmats = [], [], []
    for seed in seeds:
        images, rcam, kmat = _inputs(cfg, seed)
        scenes.append(images[0])
        rcams.append(rcam)
        kmats.append(kmat)
    return scenes, np.concatenate(rcams), np.concatenate(kmats)


def _with(cfg_cls, **attrs):
    return type(cfg_cls.__name__, (cfg_cls,), attrs)()


def _assert_same(a, b):
    for k in ("rois", "class_ids", "scores", "masks"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """A CPU engine at the slice's AllLevels size (128^2, 2 views, every
    level projected), seeded random weights."""
    cfg = AllLevels()
    eng = MaskRCNN("inference", cfg, str(tmp_path_factory.mktemp("logs")),
                   device="cpu")
    eng.load_flax_variables(random_variables(cfg, seed=7))
    return eng


def test_uint8_transfer_is_bit_exact(engine):
    """UINT8_IMAGE_TRANSFER: mold_inputs keeps the resized uint8 pixels,
    the device de-molds them, and detect equals the host-molded float
    path bit for bit, on a batch of two scenes."""
    scenes, rcam, kmat = _scenes(engine.config, (1, 2))
    ref = engine.detect(scenes, rcam, kmat)
    engine.config.UINT8_IMAGE_TRANSFER = True
    try:
        molded, _, _ = engine.mold_inputs(list(scenes[0]))
        assert molded.dtype == np.uint8
        got = engine.detect(scenes, rcam, kmat)
    finally:
        engine.config.UINT8_IMAGE_TRANSFER = False
    assert len(ref[0]["class_ids"]) >= 3
    for r, g in zip(ref, got):
        _assert_same(r, g)


def test_a_float_image_sends_the_whole_batch_to_host_molding(engine):
    """One float image anywhere in the list (in mold_inputs, or in any
    scene of a detect batch) sends every image through host molding: the
    model de-molds by the batch's dtype."""
    rng = np.random.RandomState(0)
    img_u8 = rng.randint(0, 255, (96, 128, 3)).astype(np.uint8)
    img_f = img_u8.astype(np.float32)
    scenes, rcam, kmat = _scenes(engine.config, (3, 4))
    ref = engine.detect(scenes, rcam, kmat)
    engine.config.UINT8_IMAGE_TRANSFER = True
    try:
        molded, _, _ = engine.mold_inputs([img_f])
        assert molded.dtype == np.float32 and molded.min() < 0
        mixed, _, _ = engine.mold_inputs([img_u8, img_f])
        assert mixed.dtype == np.float32 and mixed.min() < 0
        raw, _, _ = engine.mold_inputs([img_u8])
        assert raw.dtype == np.uint8
        got = engine.detect([scenes[0], scenes[1].astype(np.float32)],
                            rcam, kmat)
    finally:
        engine.config.UINT8_IMAGE_TRANSFER = False
    for r, g in zip(ref, got):
        _assert_same(r, g)


def test_detect_molded_equals_detect(engine):
    """detect_molded on mold_inputs' output (each scene's main-view meta)
    gives detect's results."""
    scenes, rcam, kmat = _scenes(engine.config, (5, 6))
    molded, metas = [], []
    for views in scenes:
        m, meta, _ = engine.mold_inputs(list(views))
        molded.append(m)
        metas.append(meta[0])
    got = engine.detect_molded(np.stack(molded), np.stack(metas), rcam,
                               kmat)
    ref = engine.detect(scenes, rcam, kmat)
    assert len(ref[0]["class_ids"]) >= 3
    for r, g in zip(ref, got):
        _assert_same(r, g)


def test_run_graph_and_ancestor_match_jax(tmp_path):
    """run_graph returns the JAX engine's keys (with EXPOSE_FUSED_PYRAMID
    also fused_p2..fused_p5, NHWC) with its values; `outputs` selects
    keys; ancestor's name lists equal the JAX engine's with the flag on
    and off, and with images it returns run_graph's matching arrays."""
    cfg = _with(AllLevels, EXPOSE_FUSED_PYRAMID=True)
    variables = random_variables(cfg, seed=8)
    scenes, rcam, kmat = _scenes(cfg, (8,))
    jeng = _jax_engine(cfg, variables, str(tmp_path))
    ref = {k: np.asarray(v, np.float32) for k, v in
           jeng.run_graph(scenes, None, rcam, kmat).items()}
    eng = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
    eng.load_flax_variables(variables)
    got = eng.run_graph(scenes, None, rcam, kmat)
    assert set(got) == set(ref)
    assert {f"fused_p{i}" for i in range(2, 6)} <= set(got)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert got[k].dtype == np.float32, k
        if k == "mrcnn_masks":
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-3)
        else:
            _close(got[k], ref[k], k)
    assert (got["detections"][0, :, 4] > 0).sum() >= 3
    picked = eng.run_graph(scenes, ["proposals", "fused_p4"], rcam, kmat)
    assert list(picked) == ["proposals", "fused_p4"]
    np.testing.assert_array_equal(picked["fused_p4"], got["fused_p4"])

    for pattern in (r"^rpn_", r"fused|detections", r"mrcnn", r"."):
        assert eng.ancestor(pattern) == jeng.ancestor(pattern), pattern
    found = eng.ancestor(r"^fused|detections", images=scenes, Rcam=rcam,
                         Kmat=kmat)
    assert set(found) == {"fused_p2", "fused_p3", "fused_p4", "fused_p5",
                          "detections"}
    for k, v in found.items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    plain = _with(AllLevels)
    off = MaskRCNN("inference", plain, str(tmp_path), device="cpu")
    joff = _jax_engine(plain, variables, str(tmp_path))
    for pattern in (r"^rpn_", r"fused|detections", r"."):
        assert off.ancestor(pattern) == joff.ancestor(pattern), pattern
    assert not off.ancestor("fused")
    with pytest.raises(NotImplementedError, match="network"):
        eng.get_imagenet_weights()


@pytest.mark.parametrize("mode", ["conv3d", "lstm3d"])
def test_batch_of_two_matches_jax_and_batch_one(mode, tmp_path):
    """IMAGES_PER_GPU = 2: the port's detect of two scenes against the
    JAX engine's, scene by scene, and each scene against its own batch-1
    port detect (each scene's meta, window and DETECTION_MAX_INSTANCES
    rows go to its own result)."""
    if mode == "conv3d":
        cfg = _with(AllLevels, IMAGES_PER_GPU=2)
        variables = random_variables(cfg, seed=9)
    else:
        cfg = _with(ModeSlice, GRID_REAS="lstm3d", IMAGES_PER_GPU=2)
        variables = calibrated_variables(
            cfg, _batch(cfg, *_inputs(cfg, seed=9)), seed=9)
    assert cfg.BATCH_SIZE == 2
    scenes, rcam, kmat = _scenes(cfg, (9, 10))
    jeng = _jax_engine(cfg, variables, str(tmp_path))
    ref = jeng.detect(scenes, rcam, kmat)
    eng = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
    eng.load_flax_variables(variables)
    got = eng.detect(scenes, rcam, kmat)
    assert len(got) == 2
    for i in range(2):
        assert_parity(ref[i], got[i], min_ref=3)
        alone = eng.detect([scenes[i]], rcam[i:i + 1], kmat[i:i + 1])[0]
        assert_parity(alone, got[i], min_ref=3)
        np.testing.assert_array_equal(alone["class_ids"], got[i]["class_ids"])
        np.testing.assert_allclose(alone["scores"], got[i]["scores"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(alone["rois"], got[i]["rois"],
                                   rtol=1e-5, atol=1e-5)
    # the two scenes differ, so a swapped slot would show
    assert not np.array_equal(got[0]["scores"], got[1]["scores"])
