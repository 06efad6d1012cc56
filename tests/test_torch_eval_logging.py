"""The port's evaluation metrics (eval/metrics.py) and training logs
(utils/logging_utils.py) against the JAX package's.

Metrics: seeded random GT and detections (some detections copies of GT
masks with a few pixels flipped, so AP is neither 0 nor 1), empty
prediction and GT sets included; every output equal, exactly.
Logs: files written by either package's MetricsLogger and TBEventWriter
read back through the other's reader to equal scalars, and the event
bytes of both writers are equal at the same wall time and host name.
"""

import json
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mulit_view_object_detection_tpu.eval import metrics as JM  # noqa: E402
from mulit_view_object_detection_tpu.ops.boxes import (  # noqa: E402
    compute_overlaps_masks_np as jax_mask_overlaps)
from mulit_view_object_detection_tpu.utils import (  # noqa: E402
    logging_utils as JL)
from mulit_view_object_detection_torch.eval import metrics as M  # noqa: E402
from mulit_view_object_detection_torch.ops.boxes import (  # noqa: E402
    compute_overlaps_masks_np)
from mulit_view_object_detection_torch.utils import (  # noqa: E402
    logging_utils as L)

HW = 32


def _instances(rng, n, classes=3):
    """n random rectangle masks [HW, HW, n], their boxes and classes."""
    masks = np.zeros((HW, HW, n), bool)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        y, x = rng.randint(0, HW - 6, 2)
        h, w = rng.randint(3, 14, 2)
        masks[y:y + h, x:x + w, i] = True
        boxes[i] = [y, x, min(y + h, HW), min(x + w, HW)]
    return masks, boxes, rng.randint(1, classes + 1, n).astype(np.int32)


def _case(seed, n_gt, n_pred):
    rng = np.random.RandomState(seed)
    gt_masks, gt_boxes, gt_cls = _instances(rng, n_gt)
    p_masks, p_boxes, p_cls = _instances(rng, n_pred)
    # half the predictions copy a GT instance with a few pixels flipped
    for i in range(min(n_pred // 2, n_gt)):
        g = rng.randint(n_gt)
        m = gt_masks[..., g].copy()
        flip = rng.rand(HW, HW) < 0.03
        p_masks[..., i] = m ^ flip
        p_boxes[i], p_cls[i] = gt_boxes[g], gt_cls[g]
    # scores with a tie, so the order of equal scores is exercised
    scores = rng.rand(n_pred).astype(np.float32)
    if n_pred > 2:
        scores[1] = scores[2]
    return (gt_boxes, gt_cls, gt_masks, p_boxes, p_cls, scores, p_masks)


CASES = [(0, 6, 9), (1, 4, 4), (2, 8, 12), (3, 5, 0), (4, 3, 7)]


def _equal(got, ref):
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _equal(g, r)
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("seed,n_gt,n_pred", CASES)
def test_metrics_equal_jax(seed, n_gt, n_pred):
    args = _case(seed, n_gt, n_pred)
    _equal(M.compute_matches(*args, iou_threshold=0.5),
           JM.compute_matches(*args, iou_threshold=0.5))
    for thr in (0.3, 0.5, 0.75):
        got = M.compute_ap(*args, iou_threshold=thr)
        _equal(got, JM.compute_ap(*args, iou_threshold=thr))
    assert (M.compute_ap_range(*args, verbose=0)
            == JM.compute_ap_range(*args, verbose=0))
    gt_boxes, gt_cls, _, p_boxes, p_cls = args[:5]
    if n_pred:
        _equal(M.compute_recall(p_boxes, gt_boxes, 0.5),
               JM.compute_recall(p_boxes, gt_boxes, 0.5))
    assert (M.greedy_box_matches(gt_boxes, gt_cls, p_boxes, p_cls, 0.5)
            == JM.greedy_box_matches(gt_boxes, gt_cls, p_boxes, p_cls, 0.5))
    np.testing.assert_array_equal(
        compute_overlaps_masks_np(args[6], args[2]),
        jax_mask_overlaps(args[6], args[2]))


def test_metrics_nontrivial_ap():
    """The random cases above reach an AP strictly between 0 and 1."""
    aps = [M.compute_ap(*_case(*c))[0] for c in CASES if c[2]]
    assert any(0.0 < a < 1.0 for a in aps), aps


def test_trim_zeros_and_empty_gt():
    x = np.array([[0, 0, 0, 0], [1, 2, 3, 4], [0, 0, 0, 0]], np.float32)
    np.testing.assert_array_equal(M.trim_zeros(x), JM.trim_zeros(x))
    args = _case(5, 3, 5)
    empty_gt = (np.zeros((0, 4), np.float32), np.zeros(0, np.int32),
                np.zeros((HW, HW, 0), bool)) + args[3:]
    with np.errstate(invalid="ignore", divide="ignore"):
        got = M.compute_ap(*empty_gt)
        ref = JM.compute_ap(*empty_gt)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def _fixed_clock(monkeypatch, t=1_700_000_000.25):
    monkeypatch.setattr(time, "time", lambda: t)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")


SCALARS = [(1, {"loss": 2.5, "rpn_class_loss": 0.75}),
           (2, {"loss": 1.25, "val_loss": float(np.float32(0.1))})]


def test_tb_events_bytes_equal_jax(tmp_path, monkeypatch):
    _fixed_clock(monkeypatch)
    paths = []
    for mod, sub in ((L, "port"), (JL, "jax")):
        w = mod.TBEventWriter(str(tmp_path / sub))
        for step, scalars in SCALARS:
            w.add_scalars(step, scalars)
        w.close()
        paths.append(w.path)
    port, ref = (open(p, "rb").read() for p in paths)
    assert port == ref
    assert paths[0].rsplit("/", 1)[1] == paths[1].rsplit("/", 1)[1]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tb_events_read_across(tmp_path, writer):
    wmod, other = (L, JL) if writer == "port" else (JL, L)
    w = wmod.TBEventWriter(str(tmp_path))
    for step, scalars in SCALARS:
        w.add_scalars(step, scalars)
    w.close()
    want = [(s, {k: float(np.float32(v)) for k, v in d.items()})
            for s, d in SCALARS]
    assert other.read_tb_events(w.path) == want
    assert wmod.read_tb_events(w.path) == want
    data = bytearray(open(w.path, "rb").read())
    data[-6] ^= 0xFF
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="crc"):
        other.read_tb_events(w.path)


def test_metrics_logger_equal_jax(tmp_path, monkeypatch):
    _fixed_clock(monkeypatch)
    lines = []
    for mod, sub in ((L, "port"), (JL, "jax")):
        m = mod.MetricsLogger(str(tmp_path / sub))
        m.log(3, loss=1.5, val_loss=np.float32(0.25))
        m.log(4, loss=1.0)
        m.close()
        lines.append(open(m.path).read())
    assert lines[0] == lines[1]
    recs = [json.loads(x) for x in lines[0].splitlines()]
    assert [r["step"] for r in recs] == [3, 4] and recs[0]["loss"] == 1.5


def test_timed_and_profile_trace(tmp_path):
    said = []
    with L.timed("block", sink=said.append):
        pass
    assert said and said[0].startswith("block: ")
    with L.profile_trace(str(tmp_path)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof is not None
    (trace,) = tmp_path.glob("trace.*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
