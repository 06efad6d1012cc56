"""The port's h5 writers against the JAX package's.

* `utils/h5_fixture.py` (the port's numpy copy): the Matterport layout
  (`write_matterport_h5`, legacy and fan-in values) and every committed
  multi-view inventory (`write_h5_from_inventory`, name-seeded values)
  written by both packages from the same names and seed: the same groups,
  attributes and datasets, each bit-equal.
* `utils/h5_export.py`: the port's `save_h5_weights(state_dict)` against
  the JAX `save_h5_weights` of the flax tree that utils/convert.py makes
  of the same state_dict, for the conv3d, lstm3d, ident and add models
  (transposed 3-D convs, depthwise kernels, the fused ConvLSTM kernel,
  every BatchNorm's statistics): every dataset and attribute bit-equal,
  the same report. Then export -> the port's `load_h5_state_dict` into a
  model with other weights gives the state_dict back bit for bit, frozen
  BatchNorm statistics included; and through `MaskRCNN.load_weights`.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
h5py = pytest.importorskip("h5py")

from mulit_view_object_detection_tpu.utils import (  # noqa: E402
    h5_fixture as jax_fixture)
from mulit_view_object_detection_tpu.utils.h5_export import (  # noqa: E402
    save_h5_weights as jax_save_h5_weights)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as TorchMaskRCNN)
from mulit_view_object_detection_torch.utils import h5_fixture  # noqa: E402
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    torch_to_flax)
from mulit_view_object_detection_torch.utils.h5_export import (  # noqa: E402
    reference_layer_entries, save_h5_weights)
from mulit_view_object_detection_torch.utils.h5_import import (  # noqa: E402
    load_h5_state_dict)
from tests.test_torch_h5_import import MultiViewSmall  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _contents(path):
    """{h5 path: ("attrs", {name: value}) or ("data", array)} of a file,
    the root's attributes under "/"."""
    out = {"/": ("attrs", {})}
    with h5py.File(path, "r") as f:
        out["/"][1].update({k: np.asarray(v) for k, v in f.attrs.items()})

        def visit(name, obj):
            attrs = {k: np.asarray(v) for k, v in obj.attrs.items()}
            if isinstance(obj, h5py.Dataset):
                out[name] = ("data", np.asarray(obj), attrs)
            else:
                out[name] = ("attrs", attrs)
        f.visititems(visit)
    return out


def _assert_same_file(got_path, want_path):
    got, want = _contents(got_path), _contents(want_path)
    assert list(got) == list(want)
    for name, entry in want.items():
        other = got[name]
        assert other[0] == entry[0], name
        attrs_got, attrs_want = other[-1], entry[-1]
        assert set(attrs_got) == set(attrs_want), name
        for k, v in attrs_want.items():
            assert attrs_got[k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(attrs_got[k], v, err_msg=name)
        if entry[0] == "data":
            assert other[1].dtype == entry[1].dtype, name
            assert other[1].tobytes() == entry[1].tobytes(), name
    return want


# ---------------------------------------------------------------------------
# utils/h5_fixture.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init, seed", [("legacy", 0), ("fanin", 3)])
def test_matterport_fixture_matches_jax_writer(tmp_path, init, seed):
    kw = dict(num_classes=5, architecture="resnet50", top_down=16,
              fc_size=32, mask_filters=8, seed=seed, init=init)
    got = h5_fixture.write_matterport_h5(str(tmp_path / "port.h5"), **kw)
    want = jax_fixture.write_matterport_h5(str(tmp_path / "jax.h5"), **kw)
    assert h5_fixture.matterport_layer_specs(5, "resnet50", 16, 32, 8) == \
        jax_fixture.matterport_layer_specs(5, "resnet50", 16, 32, 8)
    assert list(got) == list(want)
    for layer, weights in want.items():
        assert list(got[layer]) == list(weights)
        for k, v in weights.items():
            assert got[layer][k].tobytes() == v.tobytes(), (layer, k)
    contents = _assert_same_file(tmp_path / "port.h5", tmp_path / "jax.h5")
    assert sum(e[0] == "data" for e in contents.values()) > 200


@pytest.mark.parametrize("inventory", sorted(
    f for f in os.listdir(FIXTURES)
    if "_layers" in f and f.endswith(".json")))
def test_inventory_fixture_matches_jax_writer(tmp_path, inventory):
    with open(os.path.join(FIXTURES, inventory)) as f:
        layers = json.load(f)
    h5_fixture.write_h5_from_inventory(str(tmp_path / "port.h5"), layers,
                                       seed=1)
    jax_fixture.write_h5_from_inventory(str(tmp_path / "jax.h5"), layers,
                                        seed=1)
    contents = _assert_same_file(tmp_path / "port.h5", tmp_path / "jax.h5")
    assert sum(e[0] == "data" for e in contents.values()) > 100
    name = layers[1]["weights"][0]["name"]
    shape = layers[1]["weights"][0]["shape"]
    assert h5_fixture.golden_inventory_value(name, shape, 1).tobytes() == \
        jax_fixture.golden_inventory_value(name, shape, 1).tobytes()


# ---------------------------------------------------------------------------
# utils/h5_export.py
# ---------------------------------------------------------------------------

def _random_state_dict(model, seed):
    """Seeded values in every tensor of `model` (variances positive), so
    that a round trip cannot pass by two initialisations agreeing."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in model.state_dict().items():
        v = rng.randn(*t.shape).astype(np.float32)
        if name.endswith("running_var"):
            v = np.abs(v) + 0.1
        out[name] = torch.from_numpy(v)
    return out


@pytest.mark.parametrize("mode", ["conv3d", "lstm3d", "ident", "add"])
def test_export_matches_jax_and_round_trips(tmp_path, mode):
    cfg = type(f"Export_{mode}", (MultiViewSmall,), {"GRID_REAS": mode})()
    model = TorchMaskRCNN(cfg)
    sd = _random_state_dict(model, seed=len(mode))
    report = save_h5_weights(str(tmp_path / "port.h5"), sd)
    tree = torch_to_flax(sd)
    want = jax_save_h5_weights(str(tmp_path / "jax.h5"), tree["params"],
                               tree["batch_stats"])
    assert report == want and not report["unmapped"]
    _assert_same_file(tmp_path / "port.h5", tmp_path / "jax.h5")
    entries, unmapped = reference_layer_entries(sd)
    assert [n for n, _ in entries] == report["layers"] and not unmapped

    # back into other weights, bit for bit
    other = _random_state_dict(model, seed=99)
    back, _ = load_h5_state_dict(str(tmp_path / "port.h5"), other)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    assert any(k.endswith("running_mean") for k in sd)
    if mode == "conv3d":
        eng = MaskRCNN("inference", cfg, str(tmp_path), device="cpu")
        eng.load_weights(str(tmp_path / "port.h5"))
        for k, v in eng.model.state_dict().items():
            assert torch.equal(v, sd[k]), k
