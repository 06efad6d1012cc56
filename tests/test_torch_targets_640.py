"""`ops/targets.py::detection_targets` against the JAX package's at the
quality harness's 640^2 geometry (cli/train_to_ap.py's run 3:
AP_SYNTHETIC_640_FAITHFUL_HOLDOUT_r05.json's flags), on the CPU.

tests/test_torch_train.py::test_detection_targets_match_jax holds the
sampler on small hand-made boxes (14^2 mini-masks, 20 ROIs a image).
Here the ground truth is the harness's own: a batch of run 3's training
data (`make_batch` on 640^2 "shapes" scenes, objects of 180-380 px,
occlusion leaving some visible boxes smaller), its masks as 28x28
mini-masks (MINI_MASK_SHAPE) and targets of MASK_SHAPE 28x28,
TRAIN_ROIS_PER_IMAGE 32 from POST_NMS_ROIS_TRAINING 64 proposals. The
proposals are the ground truth boxes moved so that they cross the boxes'
edges (IoU on both sides of 0.5), a few stray boxes, and zero padding;
with few positives the sampler leaves padding rows among its 32. Same
priorities (drawn from JAX's keys): the same ROIs, classes, deltas and
mask targets within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.ops import targets as JT  # noqa: E402
from mulit_view_object_detection_torch.cli import train_to_ap as tta  # noqa: E402
from mulit_view_object_detection_torch.data.generator import make_batch  # noqa: E402
from mulit_view_object_detection_torch.ops import targets as T  # noqa: E402
from tests.test_torch_train import _jax_priorities, _t  # noqa: E402

RUN3 = ["--image-size", "640", "--num-views", "2", "--scenes", "12",
        "--seed", "9", "--samples", "20", "--nvox", "40", "--scene-mode",
        "shapes", "--num-objects", "3", "--zero-pg", "0,1", "--obj-px",
        "180,380", "--stage4-blocks", "5"]


def _run3():
    args = tta.make_parser().parse_args(RUN3)
    cfg = tta.train_config(args)
    return cfg, tta.make_dataset(args, 2, args.seed)


def _proposals(gt, n_valid, rng, n_props, per_gt, stray):
    """Each valid GT box moved by up to 45% of its size along each axis
    (so that the ROIs cross its edges), `stray` random boxes, then zero
    rows up to n_props."""
    rows = []
    for box in gt[:n_valid]:
        size = np.array([box[2] - box[0], box[3] - box[1]] * 2)
        for _ in range(per_gt):
            rows.append(box + rng.uniform(-0.45, 0.45, 4) * size)
    for _ in range(stray):
        y1, x1 = rng.uniform(0, 0.8, 2)
        rows.append([y1, x1, y1 + rng.uniform(0.05, 0.2),
                     x1 + rng.uniform(0.05, 0.2)])
    props = np.clip(np.asarray(rows, np.float32), 0.0, 1.0)
    props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 0.01)
    out = np.zeros((n_props, 4), np.float32)
    out[:len(props)] = props[:n_props]
    return out


@pytest.mark.parametrize("case", ["many_positives", "padding_rows"])
def test_detection_targets_match_jax_at_run3_geometry(case):
    cfg, ds = _run3()
    assert (cfg.IMAGE_SHAPE[0], tuple(cfg.MINI_MASK_SHAPE),
            tuple(cfg.MASK_SHAPE), cfg.TRAIN_ROIS_PER_IMAGE,
            cfg.POST_NMS_ROIS_TRAINING, cfg.USE_MINI_MASK) == (
        640, (28, 28), (28, 28), 32, 64, True)
    seed = {"many_positives": 0, "padding_rows": 1}[case]
    batch = make_batch(ds, cfg, rnd_state=seed)
    cls = batch["gt_class_ids"]
    gt = batch["gt_boxes"]
    masks = batch["gt_masks"]
    if masks.shape[-1] == cls.shape[-1]:       # [B, h, w, G] -> [B, G, h, w]
        masks = np.moveaxis(masks, -1, 1)
    b, g = cls.shape
    n_valid = [int((c > 0).sum()) for c in cls]
    assert min(n_valid) >= 2 and masks.shape[2:] == (28, 28)
    # visible boxes of 640^2 scenes: objects of 180-380 px, some occluded
    px = np.sqrt((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])) * 640
    assert px[cls > 0].max() > 180
    rng = np.random.RandomState(seed)
    per_gt, stray = (12, 6) if case == "many_positives" else (6, 2)
    props = np.stack([_proposals(gt[i], n_valid[i], rng,
                                 cfg.POST_NMS_ROIS_TRAINING, per_gt, stray)
                      for i in range(b)])
    kw = dict(train_rois_per_image=cfg.TRAIN_ROIS_PER_IMAGE,
              roi_positive_ratio=cfg.ROI_POSITIVE_RATIO,
              mask_shape=tuple(cfg.MASK_SHAPE),
              use_mini_mask=cfg.USE_MINI_MASK,
              bbox_std_dev=np.asarray(cfg.BBOX_STD_DEV))
    key = jax.random.PRNGKey(seed + 11)
    ref = JT.detection_targets_batch(
        key, *map(jnp.asarray, (props, cls, gt, masks)), **kw)
    pos, neg = _jax_priorities(key, b, props.shape[1])
    got = T.detection_targets_batch(*map(_t, (props, cls, gt, masks, pos,
                                              neg)), **kw)
    tcls = np.asarray(ref[1])
    positives = int((tcls > 0).sum())
    padding = int((np.asarray(ref[0]) == 0).all(-1).sum())
    if case == "many_positives":
        assert positives >= 8
    else:
        assert positives >= 2 and padding >= 8
    # the ROIs cross the ground truth's edges: their IoU with their box
    # spans both sides of the positive threshold
    ov = np.asarray(JT.overlaps(jnp.asarray(props[0]), jnp.asarray(gt[0])))
    best = ov.max(1)[(props[0] != 0).any(1)]
    assert (best >= 0.5).any() and ((best > 0.1) & (best < 0.5)).any()
    for name, gv, rv in zip(("rois", "class_ids", "deltas", "masks"), got,
                            ref):
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-5,
                                   err_msg=name)
    # the mask targets of the positives are not blank
    assert np.asarray(ref[3])[tcls > 0].mean() > 0.1
