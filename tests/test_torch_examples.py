"""The port's example programs (mulit_view_object_detection_torch/
examples/) against the JAX package's (examples/*.py), on the CPU at the
programs' own sizes.

* demo_synthetic: the port's `run_demo` with the JAX engine's initial
  weights (flax's init from PRNGKey(0), converted by
  `utils/convert.py::flax_to_torch`) against the JAX engine's `detect` on
  the same scene, following examples/demo_synthetic.py's steps, at
  tests/test_fullgraph_parity.py's bar (matched detections agree, at most
  one swapped tail detection). At 64^2 the demo's ROIs route to the
  zeroed P2/P3, so every head row reads zeros and both packages return no
  detection; the raw outputs of the graph (RPN, proposals, head
  probabilities, masks) are held to JAX's as well, at
  tests/test_torch_detector.py's tolerance (1e-4 of each tensor's
  magnitude), so the unprojection and reprojection that feed the RPN are
  compared.
* projection_playground: the voxel grid, the mean-fused grid and the
  rays against JAX's `unproject_features` / `mean` / `project_grid` at
  float32, atol 1e-5, for the main-view lattice and the camera-anchored
  one (whose points are held to JAX's `camera_anchored_grid_points` and
  `pose_inverse`).
* With `--device cuda` and no card both programs raise.
* Both programs draw with OpenCV where matplotlib cannot be imported.
"""

import builtins
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.compat.model import (  # noqa: E402
    MaskRCNN as JaxEngine)
from mulit_view_object_detection_tpu.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset as JaxSynthetic)
from mulit_view_object_detection_tpu.data.synthetic import (  # noqa: E402
    SyntheticScene as JaxScene)
from mulit_view_object_detection_tpu.eval.metrics import (  # noqa: E402
    greedy_box_matches)
from mulit_view_object_detection_tpu.ops import (  # noqa: E402
    projection as jproj)
from mulit_view_object_detection_torch.examples import (  # noqa: E402
    demo_synthetic as demo)
from mulit_view_object_detection_torch.examples import (  # noqa: E402
    projection_playground as playground)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = ("rpn_probs", "rpn_bbox", "proposals", "mrcnn_probs", "mrcnn_bbox",
       "detections", "mrcnn_masks")


def _jax_example(name):
    """The JAX package's example script `examples/<name>.py` as a module
    (its main() is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, ref, err):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale,
                               rtol=1e-4, atol=1e-4, err_msg=err)


def _matched(ref, got):
    """tests/test_fullgraph_parity.py's bar: the counts within one, every
    class + IoU >= 0.9 match with its score within 0.02 and its mask IoU
    above 0.85, at most one reference detection unmatched."""
    n_ref = len(ref["class_ids"])
    assert abs(n_ref - len(got["class_ids"])) <= 1
    matches = greedy_box_matches(
        np.asarray(ref["rois"], np.float32), ref["class_ids"],
        np.asarray(got["rois"], np.float32), got["class_ids"],
        iou_threshold=0.9)
    for ri, gi, _ in matches:
        assert abs(float(got["scores"][gi]) - float(ref["scores"][ri])) < 0.02
        a, b = ref["masks"][..., ri], got["masks"][..., gi].astype(bool)
        union = np.logical_or(a, b).sum()
        if union:
            assert np.logical_and(a, b).sum() / union > 0.85
    assert len(matches) >= n_ref - 1


def test_demo_matches_jax(tmp_path):
    jdemo = _jax_example("demo_synthetic")
    jcfg = jdemo.DemoConfig()
    # examples/demo_synthetic.py's steps
    jds = JaxSynthetic(num_scenes=1, num_views=2, image_size=64)
    jeng = JaxEngine("inference", jcfg, str(tmp_path))
    view_ids = jds.load_view(2, "s0_v0")
    views = np.stack([jds.load_image(v) for v in view_ids])
    rcam = np.stack([jds.load_R(v) for v in view_ids])[None]
    kmat = jds.K[None].astype(np.float32)
    ref = jeng.detect([views], Rcam=rcam, Kmat=kmat)[0]
    ref_raw = jeng.run_graph([views], outputs=list(RAW), Rcam=rcam,
                             Kmat=kmat)

    state = jeng._ensure_state()
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    model = demo.build_model("cpu").load_flax_variables(variables)
    dataset = demo.make_dataset()
    got_views, got_rcam, got_kmat = demo.demo_inputs(dataset)
    np.testing.assert_array_equal(got_views, views)
    np.testing.assert_array_equal(got_rcam, rcam)
    np.testing.assert_array_equal(got_kmat, kmat)
    got = demo.run_demo(model, dataset)[0]
    _matched(ref, got)
    raw = model.run_graph([views], outputs=list(RAW), Rcam=rcam, Kmat=kmat)
    for key in RAW:
        assert raw[key].shape == ref_raw[key].shape, key
        _close(raw[key], ref_raw[key], key)
    # the raw outputs are not trivially equal: the RPN reads the fused
    # levels
    assert np.ptp(ref_raw["rpn_probs"][..., 1]) > 1e-2
    path = demo.save_demo(views, got, str(tmp_path))
    assert os.path.getsize(path) > 0


def _jax_playground(camera_anchored):
    """examples/projection_playground.py's pipeline: (images, voxel grid,
    fused grid, rays, lattice points) as numpy arrays."""
    cfg = _jax_example("projection_playground").GeoCfg()
    scene = JaxScene(np.random.RandomState(0), num_objects=3, num_views=2,
                     image_size=64)
    images = np.stack([scene.render(v)[0] for v in range(2)])
    feats = (images.astype(np.float32) / 255.0)[None]
    rcam = scene.poses[None].astype(np.float32)
    kmat = scene.K[None].astype(np.float32)
    if camera_anchored:
        pts_w = jproj.camera_anchored_grid_points(cfg, rcam)
        w2c0 = np.asarray(jproj.pose_inverse(jnp.asarray(rcam[:, 0])))
        cam = np.einsum("bij,bjn->bin", w2c0, pts_w)[0]
        pts = np.concatenate([cam, np.ones((1, cam.shape[-1]))],
                             axis=0).astype(np.float32)
    else:
        pts = jproj.voxel_grid_points(cfg)
    vox = jproj.unproject_features(
        jnp.asarray(feats), jnp.asarray(rcam), jnp.asarray(kmat), (64, 64),
        jnp.asarray(pts), (cfg.nvox, cfg.nvox, cfg.nvox_z))
    fused = jnp.mean(vox, axis=1)
    rays = jproj.project_grid(fused, jnp.asarray(kmat), (64, 64), 64,
                              cfg.samples, cfg)
    return (images, np.asarray(vox), np.asarray(fused), np.asarray(rays),
            pts)


@pytest.mark.parametrize("camera_anchored", [False, True],
                         ids=["main_view_lattice", "camera_anchored"])
def test_playground_matches_jax(camera_anchored):
    cfg = playground.GeoCfg()
    images, vox, fused, rays = playground.run_playground(
        cfg, camera_anchored, device="cpu")
    want = _jax_playground(camera_anchored)
    np.testing.assert_array_equal(images, want[0])
    rcam = playground.make_scene()[1]
    np.testing.assert_allclose(
        playground.lattice_points(cfg, rcam, camera_anchored), want[4],
        atol=1e-5)
    for name, got, ref in (("voxel grid", vox, want[1]),
                           ("fused grid", fused, want[2]),
                           ("rays", rays, want[3])):
        assert tuple(got.shape) == ref.shape, name
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, err_msg=name)
    # the scene lands in the lattice and comes back along the rays
    assert (fused.numpy() > 0).mean() > 0.05
    assert (rays.numpy() > 0).mean() > 0.05


@pytest.mark.parametrize("program", ["demo_synthetic",
                                     "projection_playground"])
def test_cuda_without_a_card_raises(program, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    module = demo if program == "demo_synthetic" else playground
    with pytest.raises(RuntimeError, match="is_available"):
        module.main([])
    with pytest.raises(RuntimeError, match="is_available"):
        module.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="is_available"):
        if module is demo:
            demo.build_model("cuda")
        else:
            playground.run_playground(playground.GeoCfg(), False, "cuda")
    assert not os.listdir(tmp_path)


def _without_matplotlib(monkeypatch):
    """matplotlib is neither found nor importable, as on a host without
    it."""
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == "matplotlib" else find_spec(name, *a))
    real_import = builtins.__import__

    def blocked(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"blocked: {name}")
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", blocked)
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)


def test_playground_contact_sheet_without_matplotlib(tmp_path, monkeypatch):
    """The sheet is written with OpenCV: two rows of captioned tiles, the
    first tile the main view scaled 3x."""
    cfg = playground.GeoCfg()
    images, _, _, rays = playground.run_playground(cfg, False, "cpu")
    _without_matplotlib(monkeypatch)
    monkeypatch.chdir(tmp_path)
    path = playground.draw_contact_sheet(images, rays[0].numpy(),
                                         cfg.samples)
    assert path == playground.OUTPUT
    assert "matplotlib" not in sys.modules
    sheet = cv2.imread(str(tmp_path / path))[..., ::-1]
    cols = cfg.samples // 2 + 1
    assert sheet.shape == (2 * (3 * 64 + 16), cols * 3 * 64, 3)
    tile = sheet[16:16 + 3 * 64, :3 * 64]
    np.testing.assert_array_equal(tile[::3, ::3], images[0])
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401


def test_demo_drawing_without_matplotlib(tmp_path, monkeypatch):
    """demo_output.jpg is written with OpenCV (no detection to draw from
    the seeded weights: the image is the main view)."""
    model = demo.build_model("cpu")
    dataset = demo.make_dataset()
    r = demo.run_demo(model, dataset)[0]
    views = demo.demo_inputs(dataset)[0]
    _without_matplotlib(monkeypatch)
    path = demo.save_demo(views, r, str(tmp_path))
    assert path == str(tmp_path / demo.DEMO_OUTPUT)
    assert "matplotlib" not in sys.modules
    got = cv2.imread(path)
    assert got is not None and got.shape == views[0].shape
