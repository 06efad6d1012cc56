"""BatchNorm folding of the port (utils/bn_fold.py, the folded
models/resnet.py::BatchNorm, the engine's FOLD_BN inference) against the
JAX package's fold (utils/bn_fold.py there), mirroring
tests/test_bn_fold.py with its FoldCfg.

Tolerances: the fold is the JAX module's float64 arithmetic cast to
float32, so the port's folded state_dict equals the converted JAX fold
bit for bit. Detections: folded against unfolded in the port reassociates
one multiply a conv in float32, the bar of tests/test_bn_fold.py (2e-4)
on the raw detections; the port against the JAX package goes through two
conv backends (XLA vs oneDNN), held at 1e-4 of each tensor's magnitude
on the raw detections (tests/test_torch_detector.py) and at the bar of
tests/test_fullgraph_parity.py on the engines' results.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from mulit_view_object_detection_tpu.compat.model import (  # noqa: E402
    MaskRCNN as JaxEngine)
from mulit_view_object_detection_tpu.models.detector import (  # noqa: E402
    MaskRCNN as JaxMaskRCNN, make_dummy_batch)
from mulit_view_object_detection_tpu.train.step import TrainState  # noqa: E402
from mulit_view_object_detection_tpu.utils.bn_fold import (  # noqa: E402
    fold_bn_variables)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as TorchMaskRCNN)
from mulit_view_object_detection_torch.models.resnet import BatchNorm  # noqa: E402
from mulit_view_object_detection_torch.utils.bn_fold import (  # noqa: E402
    fold_bn_model, fold_bn_state_dict)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch)
from tests.test_bn_fold import FoldCfg, _randomized_variables  # noqa: E402
from tests.test_torch_convert import random_variables  # noqa: E402
from tests.test_torch_detector import _close, _inputs  # noqa: E402

MODES = ["conv3d", "add", "ident", "lstm3d", "single_view"]


def fold_config(mode, **overrides):
    """FoldCfg (64^2, 2 views, 8^3 grid) with GRID_REAS = mode, or one
    view for "single_view"."""
    attrs = ({"NUM_VIEWS": 1} if mode == "single_view"
             else {"GRID_REAS": mode})
    attrs.update(overrides)
    return type(f"Fold_{mode}", (FoldCfg,), attrs)()


def assert_parity(ref, got, min_ref=1):
    """The bar of tests/test_fullgraph_parity.py: counts within one, each
    reference detection matched by class and box IoU >= 0.9 with score
    within 0.02 and mask IoU > 0.85, at most one unmatched."""
    from mulit_view_object_detection_tpu.eval.metrics import (
        greedy_box_matches)
    n_ref = len(ref["class_ids"])
    assert n_ref >= min_ref
    assert abs(n_ref - len(got["class_ids"])) <= 1
    matches = greedy_box_matches(
        np.asarray(ref["rois"], np.float32), ref["class_ids"],
        np.asarray(got["rois"], np.float32), got["class_ids"],
        iou_threshold=0.9)
    assert len(matches) >= n_ref - 1
    for ri, gi, _ in matches:
        assert abs(float(got["scores"][gi]) - float(ref["scores"][ri])) < 0.02
        a, b = ref["masks"][..., ri], got["masks"][..., gi]
        union = np.logical_or(a, b).sum()
        if union:
            assert np.logical_and(a, b).sum() / union > 0.85


@pytest.mark.parametrize("mode", MODES)
def test_folded_state_dict_equals_jax_fold(mode):
    """fold_bn_state_dict(flax_to_torch(tree)) ==
    flax_to_torch(fold_bn_variables(tree)) exactly, with the same report
    (folded "conv<-bn" and affine-only BNs, in the same order); the BN
    statistics of the tree are random (random_like)."""
    variables = random_variables(fold_config(mode), seed=1)
    jax_folded, jax_report = fold_bn_variables(variables)
    want = flax_to_torch(jax_folded)
    got, report = fold_bn_state_dict(flax_to_torch(variables))
    assert report == jax_report
    assert report["folded"]
    if mode in ("add", "lstm3d"):
        assert "fuse_bn" in report["affine"]
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", ["conv3d", "lstm3d"])
def test_fold_twice_changes_nothing(mode):
    """Folding a folded state_dict gives it back exactly; the folded
    state_dict has the unfolded one's keys and shapes (so it loads into
    either form); every BN statistic becomes mean 0, var 1 - eps."""
    sd = flax_to_torch(random_variables(fold_config(mode), seed=2))
    once, report = fold_bn_state_dict(sd)
    twice, report2 = fold_bn_state_dict(once)
    assert report2 == report
    assert list(once) == list(sd)
    for k in sd:
        assert once[k].shape == sd[k].shape, k
        assert torch.equal(once[k], twice[k]), k
        if k.endswith("running_mean"):
            assert not once[k].any(), k
        if k.endswith("running_var"):
            assert (once[k] == np.float32(1 - 1e-3)).all(), k


def test_fold_model_forms():
    """fold_bn_model: a BN folded into its conv becomes the identity (its
    input returned as is: nothing launched), an affine-only one computes
    x * weight + bias; one form per report entry, names unchanged."""
    cfg = fold_config("add")
    model = TorchMaskRCNN(cfg).eval()
    model.load_state_dict(flax_to_torch(random_variables(cfg, seed=3)))
    names = list(model.state_dict())
    report = fold_bn_model(model)
    assert list(model.state_dict()) == names
    forms = [m.form for m in model.modules() if isinstance(m, BatchNorm)]
    assert forms.count("identity") == len(report["folded"])
    assert forms.count("affine") == len(report["affine"])
    x = torch.randn(2, 32, 4, 4)
    bn = model.backbone.res2a.bn2a
    assert bn.form == "identity" and bn(x) is x
    fuse = model.grid_fusion_p4.fuse_bn
    assert fuse.form == "affine"
    want = x * fuse.weight.view(1, -1, 1, 1) + fuse.bias.view(1, -1, 1, 1)
    assert torch.equal(fuse(x), want)


def test_fold_refuses_a_conv_without_bias():
    """A BN the table pairs with a conv that has no bias is an error, not
    a dropped BN."""
    sd = {"blk.conv2a.weight": torch.ones(4, 3, 1, 1),
          "blk.bn2a.weight": torch.ones(4), "blk.bn2a.bias": torch.zeros(4),
          "blk.bn2a.running_mean": torch.zeros(4),
          "blk.bn2a.running_var": torch.ones(4)}
    with pytest.raises(ValueError, match="bias"):
        fold_bn_state_dict(sd)


@pytest.fixture(scope="module")
def fold_case():
    """FoldCfg with detections kept at any confidence, its randomised
    variables (tests/test_bn_fold.py::_randomized_variables) and one
    request of uint8 views."""
    cfg = fold_config("conv3d", DETECTION_MIN_CONFIDENCE=0.0)
    variables = _randomized_variables(JaxMaskRCNN(cfg),
                                      make_dummy_batch(cfg))
    return cfg, variables, _inputs(cfg, seed=4)


def _jax_engine(cfg, variables, model_dir):
    eng = JaxEngine("inference", cfg, model_dir)
    eng._state = TrainState(step=0, params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=None, tx=None,
                            apply_fn=eng.model.apply)
    return eng


def test_fold_bn_detect_matches_jax_and_unfolded(fold_case, tmp_path):
    """The port's FOLD_BN engine against the JAX FOLD_BN engine (same
    unfolded weights; each engine folds them) and against its own
    unfolded run: raw detections within the stated tolerances, engine
    results at the parity bar."""
    cfg, variables, (images, rcam, kmat) = fold_case
    folded_cfg = fold_config("conv3d", DETECTION_MIN_CONFIDENCE=0.0,
                             FOLD_BN=True)
    jeng = _jax_engine(folded_cfg, variables, str(tmp_path))
    ref = jeng.detect([images[0]], rcam, kmat)[0]
    ref_raw = np.asarray(jeng.run_graph([images[0]], ["detections"], rcam,
                                        kmat)["detections"])

    eng = MaskRCNN("inference", folded_cfg, str(tmp_path), device="cpu")
    eng.load_flax_variables(variables)
    got = eng.detect([images[0]], rcam, kmat)[0]
    raw, _, _ = eng.run_model([images[0]], rcam, kmat)
    got_raw = raw["detections"].numpy()
    plain = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
    plain.load_flax_variables(variables)
    unfolded = plain.detect([images[0]], rcam, kmat)[0]
    plain_raw, _, _ = plain.run_model([images[0]], rcam, kmat)

    assert (ref_raw[0, :, 4] > 0).sum() >= 3          # has signal
    _close(got_raw, ref_raw, "detections vs JAX FOLD_BN")
    np.testing.assert_allclose(got_raw, plain_raw["detections"].numpy(),
                               rtol=2e-4, atol=2e-4)
    assert_parity(ref, got, min_ref=3)
    assert_parity(unfolded, got, min_ref=3)
    # the engine's model stays unfolded: only the copy is folded
    assert all(m.form == "batch_norm" for m in eng.model.modules()
               if isinstance(m, BatchNorm))


def test_folded_copy_follows_the_weights(fold_case, tmp_path):
    """The folded copy is made once and reused, made again after the
    weights change (init_weights, load_flax_variables, load_weights), and
    save_weights writes the unfolded weights."""
    cfg, variables, _ = fold_case
    folded_cfg = fold_config("conv3d", FOLD_BN=True)
    eng = MaskRCNN("inference", folded_cfg, str(tmp_path), device="cpu")
    eng.load_flax_variables(variables)
    first = eng.inference_model()
    assert eng.inference_model() is first
    assert first is not eng.model and first.config is eng.config
    want, _ = fold_bn_state_dict(eng.model.state_dict())
    for k, t in first.state_dict().items():
        assert torch.equal(t, want[k]), k
    eng.init_weights(torch.Generator().manual_seed(5))
    second = eng.inference_model()
    assert second is not first
    eng.load_flax_variables(variables)
    third = eng.inference_model()
    assert third is not second
    for k, t in third.state_dict().items():
        assert torch.equal(t, want[k]), k
    eng.save_weights(str(tmp_path / "ckpt"), step=1)
    other = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
    other.load_weights(str(tmp_path / "ckpt"))
    for k, t in other.model.state_dict().items():
        assert torch.equal(t, eng.model.state_dict()[k]), k
    assert eng.inference_model() is third      # a load into another engine
