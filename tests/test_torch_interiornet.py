"""The port's InteriorNet data path against the JAX package's, on disk:
the loader (data/interiornet.py, which reads with cv2 where the JAX one
reads with imageio), the exporter of synthetic trees
(cli/export_synthetic_interiornet.py, cv2 again, against the top-level
tools/export_synthetic_interiornet.py), the view-graph builders
(data/view_mapping.py, cli/build_view_mappings.py) and the statistics
of data/inspection.py. Trees: the JAX exporter's at 96^2, and the hand-
written HD1 and HD7 trees of tests/test_interiornet_disk.py. Everything
is compared exactly."""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import imageio.v2 as imageio  # noqa: E402

from mulit_view_object_detection_tpu.cli import (  # noqa: E402
    build_view_mappings as jax_bvm)
from mulit_view_object_detection_tpu.data import (  # noqa: E402
    inspection as jax_inspection, view_mapping as jax_vm)
from mulit_view_object_detection_tpu.data.generator import (  # noqa: E402
    make_batch as jax_make_batch)
from mulit_view_object_detection_tpu.data.interiornet import (  # noqa: E402
    InteriorNetDataset as JaxInteriorNet)
from mulit_view_object_detection_torch.cli import (  # noqa: E402
    build_view_mappings as bvm)
from mulit_view_object_detection_torch.cli.export_synthetic_interiornet import (  # noqa: E402
    export_subset)
from mulit_view_object_detection_torch.data import (  # noqa: E402
    inspection, view_mapping as vm)
from mulit_view_object_detection_torch.data.generator import (  # noqa: E402
    make_batch)
from mulit_view_object_detection_torch.data.interiornet import (  # noqa: E402
    INTERIORNET_K, InteriorNetDataset, read_png, write_png)
from tests.test_interiornet_disk import (  # noqa: E402
    DiskConfig, _build_hd1, _build_hd7)
from tools.export_synthetic_interiornet import (  # noqa: E402
    export_subset as jax_export_subset)

SIZE = 96


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_jax"))
    jax_export_subset(root, "train", num_scenes=2, seed=21,
                      image_size=SIZE, num_views=6)
    return os.path.join(root, "HD7")


def _load(cls, root, subset="train"):
    ds = cls()
    ds.load_interiornet(root, subset)
    ds.prepare()
    return ds


def _same_info(a, b, root_a=None, root_b=None):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            if k == "R":
                np.testing.assert_array_equal(x[k], y[k])
            elif k == "path" and root_a:
                assert (os.path.relpath(x[k], root_a)
                        == os.path.relpath(y[k], root_b))
            else:
                assert x[k] == y[k], k


def _same_arrays(got, ref):
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            _same_arrays(g, r)
        return
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _compare_loaders(port, ref, views=(2, 3), seeds=(0, 1, 7, 123)):
    _same_info(port.image_info, ref.image_info)
    assert port.class_info == ref.class_info
    assert port.view_map == ref.view_map
    np.testing.assert_array_equal(port.K, ref.K)
    cfg = DiskConfig()
    for iid in port.image_ids:
        np.testing.assert_array_equal(port.load_R(iid), ref.load_R(iid))
        _same_arrays(port.load_image(iid), ref.load_image(iid))
        _same_arrays(port.load_mask(iid), ref.load_mask(iid))
        _same_arrays(port.load_depth(iid, cfg), ref.load_depth(iid, cfg))
    for key in list(port.view_map)[:4]:
        for n in views:
            for seed in seeds:
                assert (port.load_view(n, key, rnd_state=seed)
                        == ref.load_view(n, key, rnd_state=seed))


def test_loader_equals_jax_on_exported_tree(synth_root):
    port = _load(InteriorNetDataset, synth_root)
    ref = _load(JaxInteriorNet, synth_root)
    assert port.num_images == 12
    _compare_loaders(port, ref)


@pytest.mark.parametrize("hd", ["HD1", "HD7"])
def test_loader_equals_jax_on_handwritten_trees(tmp_path, hd):
    root = (_build_hd1 if hd == "HD1" else _build_hd7)(str(tmp_path))
    port = _load(InteriorNetDataset, root)
    ref = _load(JaxInteriorNet, root)
    # HD1 draws nothing at random, so rnd_state None is deterministic too
    seeds = (0, 3, None) if hd == "HD1" else (0, 3, 11)
    _compare_loaders(port, ref, views=(2, 3), seeds=seeds)
    if hd == "HD7":
        # the HD7 pose fix: the camera centre is the eye, vals[0:3]
        f = 2
        iid = port.image_from_source_map[
            "interior.3FO4IDEI1LAV_Bedroom_id2"]
        np.testing.assert_array_equal(port.load_R(iid)[:, 3],
                                      [0.5 * f, 0.1, 0.2])


@pytest.mark.parametrize("hd", ["HD1", "HD7"])
def test_load_view_returns_none_like_jax(tmp_path, hd):
    root = (_build_hd1 if hd == "HD1" else _build_hd7)(str(tmp_path))
    port = _load(InteriorNetDataset, root)
    ref = _load(JaxInteriorNet, root)
    key = next(iter(port.view_map))
    for ds in (port, ref):
        ds.view_map[key] = ds.view_map[key][:4]     # too few views
    for n in (2, 3, 6):
        assert port.load_view(n, key, rnd_state=0) is None
        assert ref.load_view(n, key, rnd_state=0) is None


def test_make_batch_equals_jax(synth_root):
    """The whole host batch (load_image_gt, RPN targets through the native
    matcher, molding) from the two loaders."""
    port = _load(InteriorNetDataset, synth_root)
    ref = _load(JaxInteriorNet, synth_root)
    cfg = DiskConfig()
    for seed in (0, 5):
        got = make_batch(port, cfg, rnd_state=seed)
        want = jax_make_batch(ref, cfg, rnd_state=seed)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_read_png_equals_imageio(synth_root, tmp_path):
    """Every PNG of the tree, and RGBA and 16-bit cases, read as imageio
    reads them; a missing file raises."""
    pngs = []
    for dirpath, _, files in os.walk(synth_root):
        pngs += [os.path.join(dirpath, f) for f in files
                 if f.endswith(".png")]
    assert len(pngs) == 12 * 4
    for p in pngs[::3]:
        _same_arrays(read_png(p), np.asarray(imageio.imread(p)))
    rng = np.random.RandomState(0)
    rgba = rng.randint(0, 256, (5, 7, 4)).astype(np.uint8)
    imageio.imwrite(str(tmp_path / "rgba.png"), rgba)
    _same_arrays(read_png(str(tmp_path / "rgba.png")), rgba)
    depth = rng.randint(0, 65536, (6, 5)).astype(np.uint16)
    write_png(str(tmp_path / "d" / "depth.png"), depth)
    _same_arrays(np.asarray(imageio.imread(str(tmp_path / "d/depth.png"))),
                 depth)
    rgb = rng.randint(0, 256, (4, 9, 3)).astype(np.uint8)
    write_png(str(tmp_path / "rgb.png"), rgb)
    _same_arrays(np.asarray(imageio.imread(str(tmp_path / "rgb.png"))), rgb)
    with pytest.raises(FileNotFoundError):
        read_png(str(tmp_path / "missing.png"))


def test_port_exporter_tree_equals_jax_exporter_tree(synth_root, tmp_path):
    """The port's exporter (cv2) against the tool (imageio), same seed:
    read back through the JAX loader, equal arrays, poses and view map."""
    root = str(tmp_path)
    export_subset(root, "train", num_scenes=2, seed=21, image_size=SIZE,
                  num_views=6)
    mine = _load(JaxInteriorNet, os.path.join(root, "HD7"))
    ref = _load(JaxInteriorNet, synth_root)
    _same_info(mine.image_info, ref.image_info,
               os.path.join(root, "HD7"), synth_root)
    for name in ("view_mapping.json",):
        with open(os.path.join(root, "HD7", "train", name)) as a, \
                open(os.path.join(synth_root, "train", name)) as b:
            assert json.load(a) == json.load(b)
    for scene in sorted(os.listdir(os.path.join(synth_root, "train"))):
        if scene.endswith(".json"):
            continue
        for fname in ("cam0.render", "cocolabel.json"):
            with open(os.path.join(root, "HD7", "train", scene, fname)) as a, \
                    open(os.path.join(synth_root, "train", scene,
                                      fname)) as b:
                assert a.read() == b.read()
    cfg = DiskConfig()
    for iid in ref.image_ids:
        _same_arrays(mine.load_image(iid), ref.load_image(iid))
        _same_arrays(mine.load_mask(iid), ref.load_mask(iid))
        _same_arrays(mine.load_depth(iid, cfg), ref.load_depth(iid, cfg))


def test_view_mapping_equals_jax():
    frames = [f"f{i}" for i in range(13)]
    for r in (4, 5, 20):
        assert (vm.build_view_mapping_seq(frames, r)
                == jax_vm.build_view_mapping_seq(frames, r))
    rng = np.random.RandomState(4)
    poses = {}
    for i in range(6):
        a = rng.uniform(-0.6, 0.6)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        poses[f"p{i}"] = np.concatenate(
            [R, rng.uniform(-1, 1, (3, 1))], axis=1)
    got = vm.build_view_mapping(poses, INTERIORNET_K, (640, 640))
    assert got == jax_vm.build_view_mapping(poses, INTERIORNET_K, (640, 640))
    assert any(got.values()) and not all(len(v) == 5 for v in got.values())
    assert (vm.covisibility(poses["p0"], poses["p3"], INTERIORNET_K,
                            (480, 640))
            == jax_vm.covisibility(poses["p0"], poses["p3"], INTERIORNET_K,
                                   (480, 640)))
    f2i = {"a": [(1, 3), (2, 5)], "b": [(2, 5)]}
    assert (vm.build_instance_mapping(f2i)
            == jax_vm.build_instance_mapping(f2i))


@pytest.mark.parametrize("flags", [[], ["--seq"], ["--instances"]])
def test_build_view_mappings_cli_equals_jax(synth_root, tmp_path, flags):
    outs = []
    for main, sub in ((bvm.main, "port"), (jax_bvm.main, "jax")):
        root = str(tmp_path / sub / "HD7")
        shutil.copytree(synth_root, root)
        main(["--dataset", root, "--subset", "train"] + flags)
        name = "view_mapping_seq.json" if flags == ["--seq"] else \
            "view_mapping.json"
        files = [name] + (["instance_mapping.json"]
                          if flags == ["--instances"] else [])
        outs.append([json.load(open(os.path.join(root, "train", f)))
                     for f in files])
    assert outs[0] == outs[1]


def test_inspection_equals_jax(synth_root, tmp_path, monkeypatch):
    port = _load(InteriorNetDataset, synth_root)
    ref = _load(JaxInteriorNet, synth_root)
    stats = inspection.instances_per_class(port)
    assert stats == jax_inspection.instances_per_class(ref)
    assert sum(stats.values()) > 0
    monkeypatch.chdir(tmp_path)
    inspection.main(["--dataset", synth_root, "--subset", "train"])
    text = (tmp_path / "instances_per_class_in_train.txt").read_text()
    assert text.splitlines()[0] == "BG: 0"
