"""The port against the executed reference's multi-view goldens: the
conv3d fusion (tests/fixtures/golden_multiview.npz, the main path, which
runs through the reprojection), the add, ident and lstm3d fusions
(golden_multiview_{add,ident,lstm3d}.npz; all four produced by running
the reference's model_multi.py, tools/gen_multiview_golden.py) and the
transformer fusion
(golden_transformer.npz, model_transformer.py, tools/
gen_transformer_golden.py). 2 views at 640^2, float32, on the CPU.

Weights take the route h5 fixture (utils/h5_fixture.py, name-seeded from
the layer inventory) -> the JAX package's h5 importer (a flax tree) ->
the port's converter; the configs are the repo's check tools' own
(tools/check_multiview_golden.py, tools/check_transformer_golden.py;
the multi-view one is gen_multiview_golden.py:349-375's plus the fork's
5-block stage 4).

The bar is tests/test_fullgraph_parity.py:15-19: counts within one,
matched detections (class and box IoU >= 0.9) with scores within 0.02
and mask IoU > 0.85, at most one unmatched. The raw detections and mask
probabilities are also held to the check tools' gates (raw detections
1e-4, raw masks 5e-3). Random-weight mask probabilities hover near the
0.5 binarisation threshold, so the unmolded masks of a golden can miss
0.85 with raw masks equal to 1e-6: the JAX package's own run of the add
golden records a mask IoU of 0.7044 (MULTIVIEW_PARITY_r04.json). A case
is held to 0.85 or to that record, whichever is lower. Each case prints
one JSON line of its numbers (run with -s to see them).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from mulit_view_object_detection_tpu.eval.metrics import (  # noqa: E402
    greedy_box_matches)
from mulit_view_object_detection_tpu.models.detector import (  # noqa: E402
    MaskRCNN as JaxMaskRCNN, make_dummy_batch)
from mulit_view_object_detection_tpu.utils.h5_fixture import (  # noqa: E402
    write_h5_from_inventory)
from mulit_view_object_detection_tpu.utils.h5_import import (  # noqa: E402
    load_h5_weights)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_mask_iou(case):
    """The JAX package's recorded min mask IoU on the same golden."""
    if case == "transformer":
        with open(os.path.join(ROOT, "TRANSFORMER_PARITY_r04.json")) as f:
            return json.load(f)["min_mask_iou"]
    with open(os.path.join(ROOT, "MULTIVIEW_PARITY_r04.json")) as f:
        return {r["grid_reas"]: r["min_mask_iou"]
                for r in json.load(f)}[case]


def _golden(case):
    """(config, fixture path, inventory path, weight seed) of a case."""
    if case == "transformer":
        from tools.check_transformer_golden import build_config
        from tools.gen_transformer_golden import GOLDEN_XF, fixture_paths
        return (build_config(), *fixture_paths(), GOLDEN_XF["seed"])
    from tools.check_multiview_golden import build_config
    from tools.gen_multiview_golden import GOLDEN_MV, fixture_paths
    return (build_config(case), *fixture_paths(case), GOLDEN_MV["seed"])


@pytest.mark.parametrize("case", ["add", "ident", "lstm3d", "transformer",
                                  "conv3d"])
def test_port_matches_executed_reference_golden(case, tmp_path):
    cfg, fixture, inventory_path, seed = _golden(case)
    fx = np.load(fixture)
    with open(inventory_path) as f:
        inventory = json.load(f)
    h5 = str(tmp_path / f"golden_{case}.h5")
    write_h5_from_inventory(h5, inventory, seed=seed)
    shapes = jax.eval_shape(lambda: JaxMaskRCNN(cfg).init(
        jax.random.PRNGKey(0), make_dummy_batch(cfg)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   dict(shapes))
    params, stats, _ = load_h5_weights(h5, zeros["params"],
                                       zeros["batch_stats"])

    eng = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
    eng.load_flax_variables({"params": params, "batch_stats": stats})
    views = np.asarray(fx["views"])
    depths = fx["depths"] if case == "transformer" else None
    with torch.no_grad():
        out, molded_shape, windows = eng.run_model(
            [views], fx["Rcam"], fx["Kmat"], depths)
    det = out["detections"][0].numpy()
    raw_masks = out["mrcnn_masks"][0].numpy()
    rois, class_ids, scores, masks = eng.unmold_detections(
        det, raw_masks, views[0].shape, molded_shape, windows[0])

    n_gold, n_ours = len(fx["class_ids"]), len(class_ids)
    assert n_gold >= 5
    assert abs(n_gold - n_ours) <= 1, (n_gold, n_ours)
    matches = greedy_box_matches(np.asarray(fx["rois"], np.float32),
                                 np.asarray(fx["class_ids"]),
                                 np.asarray(rois, np.float32), class_ids,
                                 iou_threshold=0.9)
    assert len(matches) >= n_gold - 1, (len(matches), n_gold)
    score_err, mask_iou = 0.0, 1.0
    for gi, oi, _ in matches:
        score_err = max(score_err,
                        abs(float(scores[oi]) - float(fx["scores"][gi])))
        gm, om = fx["masks"][..., gi], masks[..., oi].astype(bool)
        union = np.logical_or(gm, om).sum()
        if union:
            mask_iou = min(mask_iou, np.logical_and(gm, om).sum() / union)
    raw_det_err = float(np.abs(det - fx["raw_detections"]).max())
    raw_mask_err = float(np.abs(raw_masks - fx["raw_masks"]).max())
    print(json.dumps({"golden": case, "reference_detections": n_gold,
                      "port_detections": n_ours, "matched": len(matches),
                      "max_score_err": score_err,
                      "min_mask_iou": round(float(mask_iou), 4),
                      "raw_det_err": raw_det_err,
                      "raw_mask_err": raw_mask_err}))
    assert score_err < 0.02
    assert mask_iou > min(0.85, _jax_mask_iou(case) - 1e-4), mask_iou
    assert raw_det_err < 1e-4 and raw_mask_err < 5e-3, (raw_det_err,
                                                        raw_mask_err)
