"""The port's InteriorNet command line (cli/interior_multi.py,
cli/interior.py, cli/interior_transformer.py) on the CPU, on a synthetic
HD7 tree written by the port's exporter at 96^2 (objects of 20-40
pixels), with the models cut to test size (128^2, pyramid 16, an 8^3
grid, 4 samples, float32) through --overrides, or on the config classes
of the single-view and transformer command lines, which take none.

* `_eval_views` against the JAX command line's: the two engines hold the
  same weights (the JAX tree converted by utils/convert.py), their
  detections of each key agree at the bar of
  tests/test_fullgraph_parity.py:15-19, and the per-key AP is equal
  within 1e-6; and with one stub detector returning the same
  GT-derived detections to both, so the AP is not 0.
* `train` through main(): 1 step an epoch, checkpoints, metrics.jsonl
  and tfevents; resumed with --model last to the right epoch; then
  `evaluate` prints mAP@50.
* `--device cuda` without a card raises; the overrides refuse unknown
  and derived keys; the single-view and transformer command lines run
  one evaluate key each; and the whole command line runs with jax, flax,
  optax, imageio and the JAX package made unimportable.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mulit_view_object_detection_tpu.cli import (  # noqa: E402
    interior_multi as jax_cli)
from mulit_view_object_detection_tpu.compat.model import (  # noqa: E402
    MaskRCNN as JaxEngine)
from mulit_view_object_detection_tpu.eval.metrics import (  # noqa: E402
    greedy_box_matches)
from mulit_view_object_detection_tpu.train.step import TrainState  # noqa: E402
from mulit_view_object_detection_tpu.utils.logging_utils import (  # noqa: E402
    read_tb_events as jax_read_tb_events)
from mulit_view_object_detection_torch.cli import (  # noqa: E402
    interior as sv_cli, interior_multi as cli,
    interior_transformer as xf_cli)
from mulit_view_object_detection_torch.cli.export_synthetic_interiornet import (  # noqa: E402
    export_subset)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.data.generator import (  # noqa: E402
    load_image_gt)
from mulit_view_object_detection_torch.utils.logging_utils import (  # noqa: E402
    read_tb_events)
from tests.test_torch_convert import random_variables  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ("IMAGE_MIN_DIM=128,IMAGE_MAX_DIM=128,TOP_DOWN_PYRAMID_SIZE=16,"
         "FPN_CLASSIF_FC_LAYERS_SIZE=32,RPN_ANCHOR_SCALES=(16, 32, 64, 128,"
         " 256),PRE_NMS_LIMIT=256,POST_NMS_ROIS_INFERENCE=24,"
         "POST_NMS_ROIS_TRAINING=32,TRAIN_ROIS_PER_IMAGE=8,"
         "MAX_GT_INSTANCES=4,RPN_TRAIN_ANCHORS_PER_IMAGE=64,"
         "DETECTION_MAX_INSTANCES=8,COMPUTE_DTYPE=float32")
MULTI = SMALL + ",nvox=8,nvox_z=8,samples=4,ZERO_PG_LEVELS=()"
TRAIN = MULTI + ",STEPS_PER_EPOCH=1,VALIDATION_STEPS=1"
EVAL = MULTI + ",DETECTION_MIN_CONFIDENCE=0.0"
OBJ_PX = (20.0, 40.0)          # object sizes that fit a 96^2 frame


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthnet"))
    for subset, seed in (("train", 21), ("val", 521), ("test", 77)):
        export_subset(root, subset, num_scenes=1, seed=seed, image_size=96,
                      num_views=6, obj_px=OBJ_PX)
    return os.path.join(root, "HD7")


def _engines(tmp_path):
    """The JAX and the port engine at the small inference config, with the
    same seeded weights; and the two configs."""
    jcfg = jax_cli._apply_overrides(jax_cli.InferenceConfig(), EVAL)
    cfg = cli._apply_overrides(cli.InferenceConfig(), EVAL)
    variables = random_variables(jcfg, seed=2)
    jeng = JaxEngine("inference", jcfg, str(tmp_path))
    jeng._state = TrainState(step=0, params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=None, tx=None,
                             apply_fn=jeng.model.apply)
    eng = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
    eng.load_flax_variables(variables)
    return jeng, eng, jcfg, cfg


def _recording(engine):
    """Wrap engine.detect to keep its results."""
    seen, detect = [], engine.detect

    def wrapped(*a, **k):
        out = detect(*a, **k)
        seen.append(out[0])
        return out
    engine.detect = wrapped
    return seen


def test_eval_views_matches_jax_same_weights(tree, tmp_path):
    jeng, eng, jcfg, cfg = _engines(tmp_path)
    jds = jax_cli.load_dataset(tree, "val")
    ds = cli.load_dataset(tree, "val")
    keys = list(ds.view_map)[:3]
    assert keys == list(jds.view_map)[:3]
    jseen, seen = _recording(jeng), _recording(eng)
    for key in keys:
        ap_ref = jax_cli._eval_views(jds, jcfg, jeng, [key], 2)
        ap = cli._eval_views(ds, cfg, eng, [key], 2)
        assert abs(ap - ap_ref) <= 1e-6, (key, ap, ap_ref)
    assert len(seen) == len(jseen) == len(keys)
    for ref, got in zip(jseen, seen):
        n_ref = len(ref["class_ids"])
        assert n_ref >= 3 and abs(n_ref - len(got["class_ids"])) <= 1
        matches = greedy_box_matches(
            np.asarray(ref["rois"], np.float32), ref["class_ids"],
            np.asarray(got["rois"], np.float32), got["class_ids"],
            iou_threshold=0.9)
        assert len(matches) >= n_ref - 1
        for ri, gi, _ in matches:
            assert abs(float(got["scores"][gi])
                       - float(ref["scores"][ri])) < 0.02
            a, b = ref["masks"][..., ri], got["masks"][..., gi]
            union = np.logical_or(a, b).sum()
            if union:
                assert np.logical_and(a, b).sum() / union > 0.85


class _StubDetector:
    """detect() that returns the main view's GT with one box dropped, one
    mask eroded and one spurious detection: an AP strictly inside (0, 1),
    the same for any caller."""

    def __init__(self, dataset, config, main_id):
        self.dataset, self.config, self.main_id = dataset, config, main_id

    def detect(self, images, Rcam=None, Kmat=None):
        _, _, cls, boxes, masks = load_image_gt(
            self.dataset, self.config, self.main_id, use_mini_mask=False)
        masks = masks.copy()
        masks[:, :, 0] = False
        masks[boxes[0, 0]:boxes[0, 0] + 3, boxes[0, 1]:boxes[0, 1] + 3, 0] = 1
        spurious = np.zeros(masks.shape[:2] + (1,), bool)
        spurious[:8, :8] = True
        return [{"rois": np.concatenate([boxes, [[0, 0, 8, 8]]]),
                 "class_ids": np.concatenate([cls, cls[:1]]),
                 "scores": np.linspace(0.9, 0.5, len(cls) + 1),
                 "masks": np.concatenate([masks, spurious], axis=-1)}]


def test_eval_views_matches_jax_same_detections(tree):
    jcfg = jax_cli._apply_overrides(jax_cli.InferenceConfig(), EVAL)
    cfg = cli._apply_overrides(cli.InferenceConfig(), EVAL)
    jds = jax_cli.load_dataset(tree, "val")
    ds = cli.load_dataset(tree, "val")
    keys = list(ds.view_map)
    aps = []
    for key in keys:
        results = []
        for mod, dataset, config in ((jax_cli, jds, jcfg), (cli, ds, cfg)):
            stub = _StubDetector(dataset, config,
                                 dataset.load_view(5, key, rnd_state=0)[0])
            results.append(mod._eval_views(dataset, config, stub, [key], 2))
        assert abs(results[0] - results[1]) <= 1e-6, (key, results)
        aps.append(results[1])
    assert any(0.0 < a < 1.0 for a in aps), aps


def _events(log_dir):
    events = []
    for path in sorted(glob.glob(os.path.join(log_dir, "events.out.*"))):
        assert read_tb_events(path) == jax_read_tb_events(path)
        events += read_tb_events(path)
    return events


def test_train_resume_evaluate(tree, tmp_path, capsys):
    logs = str(tmp_path / "logs")
    common = ["--dataset", tree, "--logs", logs, "--device", "cpu"]
    eng = cli.main(["train", *common, "--epochs", "1,1,2", "--save-every",
                    "1", "--overrides", TRAIN])
    assert eng.epoch == 2 and eng.device.type == "cpu"
    (run,) = glob.glob(os.path.join(logs, "interior*"))
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["1", "2"]
    recs = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["val_loss"])
               for r in recs)
    events = _events(run)
    assert [s for s, _ in events] == [1, 2]
    for (step, scalars), rec in zip(events, recs):
        assert scalars["loss"] == pytest.approx(rec["loss"], rel=1e-6)

    resumed = cli.main(["train", *common, "--epochs", "1,2,3",
                        "--save-every", "1", "--model", "last",
                        "--overrides", TRAIN])
    assert resumed.epoch == 3
    out = capsys.readouterr().out
    assert "epoch 3:" in out and "epoch 1:" in out.split("epoch 2:")[0]
    assert "epoch 3:" not in out.split("epoch 2:")[0]
    recs = [json.loads(x) for x in open(os.path.join(resumed.log_dir,
                                                     "metrics.jsonl"))]
    assert recs[-1]["step"] == 3
    assert [s for s, _ in _events(resumed.log_dir)][-1] == 3

    mean_ap = cli.main(["evaluate", *common, "--model", "last", "--limit",
                        "2", "--overrides", EVAL])
    out = capsys.readouterr().out
    assert f"mAP@50: {mean_ap:.4f}" in out and 0.0 <= mean_ap <= 1.0
    assert out.count(" AP=") == 2


def test_cuda_device_without_a_card_raises(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["evaluate", "--dataset", tree, "--logs", str(tmp_path),
                  "--model", "last", "--overrides", EVAL])


@pytest.mark.parametrize("key", ["BATCH_SIZE", "IMAGE_SHAPE",
                                 "IMAGE_META_SIZE", "vsize"])
def test_overrides_refuse_derived_keys(key):
    """The JAX command line lets config.__init__() overwrite these without
    a word; the port refuses them."""
    with pytest.raises(SystemExit, match="derived"):
        cli._apply_overrides(cli.InteriorNetConfig(), f"{key}=8")
    cfg = jax_cli._apply_overrides(jax_cli.InteriorNetConfig(), f"{key}=8")
    assert np.any(np.asarray(getattr(cfg, key)) != 8)


def test_overrides_apply_and_refuse_unknown_keys():
    cfg = cli._apply_overrides(
        cli.InteriorNetConfig(),
        "IMAGE_MIN_DIM=128,IMAGE_MAX_DIM=128,IMAGES_PER_GPU=2,"
        "ZERO_PG_LEVELS=(),RPN_ANCHOR_SCALES=(8, 16, 32, 64, 128)")
    assert cfg.IMAGE_MIN_DIM == 128 and cfg.ZERO_PG_LEVELS == ()
    assert cfg.RPN_ANCHOR_SCALES == (8, 16, 32, 64, 128)
    assert cfg.BATCH_SIZE == 2 and tuple(cfg.IMAGE_SHAPE[:2]) == (128, 128)
    with pytest.raises(SystemExit, match="unknown"):
        cli._apply_overrides(cli.InteriorNetConfig(), "IMGE_MIN_DIM=128")


def _shrink(monkeypatch, cfg_cls, overrides):
    """Cut a command line's config class to test size: the single-view
    and transformer command lines take no --overrides, as in the
    reference."""
    cfg = cli._apply_overrides(cfg_cls(), overrides)
    for item in cli._split_items(overrides):
        key = item.partition("=")[0].strip()
        monkeypatch.setattr(cfg_cls, key, getattr(cfg, key))


def _checkpoint(cfg_cls, overrides, path):
    cfg = cli._apply_overrides(cfg_cls(), overrides)
    eng = MaskRCNN("inference", cfg, str(path), device="cpu")
    eng.init_weights(torch.Generator().manual_seed(3))
    eng.save_weights(str(path / "ckpt"))
    return str(path / "ckpt")


def test_single_view_cli_evaluates(tree, tmp_path, capsys, monkeypatch):
    overrides = SMALL + ",DETECTION_MIN_CONFIDENCE=0.0"
    ckpt = _checkpoint(sv_cli.SingleViewInferenceConfig, overrides, tmp_path)
    _shrink(monkeypatch, sv_cli.SingleViewInferenceConfig, overrides)
    mean_ap = sv_cli.main(["evaluate", "--dataset", tree, "--logs",
                           str(tmp_path), "--model", ckpt, "--limit", "1",
                           "--device", "cpu"])
    assert 0.0 <= mean_ap <= 1.0
    assert "mAP@50: " in capsys.readouterr().out


def test_transformer_cli_evaluates(tree, tmp_path, capsys, monkeypatch):
    overrides = (SMALL.replace("TOP_DOWN_PYRAMID_SIZE=16",
                               "TOP_DOWN_PYRAMID_SIZE=12")
                 + ",XFORMER_D_MODEL=12,XFORMER_NUM_HEADS=2,XFORMER_DFF=16,"
                 "XFORMER_NUM_LAYERS=1,XFORMER_TARGET_SIZE=4,nvox=8,"
                 "DETECTION_MIN_CONFIDENCE=0.0")
    ckpt = _checkpoint(xf_cli.TransformerInferenceConfig, overrides,
                       tmp_path)
    _shrink(monkeypatch, xf_cli.TransformerInferenceConfig, overrides)
    mean_ap = xf_cli.main(["evaluate", "--dataset", tree, "--logs",
                           str(tmp_path), "--model", ckpt, "--limit", "1",
                           "--device", "cpu"])
    assert 0.0 <= mean_ap <= 1.0
    assert "mAP@50: " in capsys.readouterr().out


def test_cli_with_jax_blocked(tmp_path):
    """Export, train and evaluate through the port's command line with
    jax, flax, optax, imageio and the JAX package made unimportable."""
    code = f"""
import importlib.abc
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "imageio",
           "mulit_view_object_detection_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
from mulit_view_object_detection_torch.cli import (
    export_synthetic_interiornet as ex, interior_multi as cli)
root = {str(tmp_path)!r}
ex.main(["--root", root, "--train-scenes", "1", "--val-scenes", "1",
         "--image-size", "96", "--num-views", "6"])
common = ["--dataset", root + "/HD7", "--logs", root + "/logs",
          "--device", "cpu"]
cli.main(["train", *common, "--epochs", "1,1,1", "--overrides", {TRAIN!r}])
cli.main(["evaluate", *common, "--model", "last", "--limit", "1",
          "--overrides", {EVAL!r}])
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("CLI_DONE")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLI_DONE" in proc.stdout and "mAP@50: " in proc.stdout
    assert "epoch 1:" in proc.stdout
