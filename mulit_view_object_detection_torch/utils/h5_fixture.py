"""Byte-exact reconstruction of the Matterport ``mask_rcnn_coco.h5`` group
tree (layout only: the weights are seeded random arrays), and the
name-seeded writer of the multi-view fork's inventories.

A numpy + h5py copy of `mulit_view_object_detection_tpu/utils/
h5_fixture.py`: the port imports nothing of the JAX package, not even a
module of it that imports no jax, so that it runs where jax is not
installed. tests/test_torch_h5_export.py holds every dataset and
attribute it writes bit-equal to the JAX writer's for the same names
and seed.

The real file is a Keras 2.0.8 ``save_weights`` HDF5
(model.py:2102-2144 reads it via ``layer_names``/``weight_names`` attrs;
utils.py:33 names the file). Its structure:

  /                       attrs: layer_names=[b"input_image", b"conv1", ...],
                                 backend=b"tensorflow", keras_version=b"2.0.8"
  /<layer>                attrs: weight_names=[b"conv1/kernel:0", ...]
  /<layer>/<inner>/<w>:0  datasets (inner = layer name, or for the nested
                          rpn_model submodel the inner layers' own names)

Every layer of the inference graph appears in ``layer_names``, including
weightless ones (inputs, lambdas, activations), which carry an empty
``weight_names``. The nested ``rpn_model`` (build_rpn_model,
model.py:830-868) is ONE entry whose weight_names span its three inner
conv layers.
"""

from __future__ import annotations

import numpy as np

# Weight-bearing layers of the Matterport COCO inference model, in build
# order (model.py resnet_graph + fpn + heads), with shape builders
# parameterized by (num_classes, top_down, fc_size).


def _resnet_layers(architecture="resnet101"):
    """[(layer_name, [(weight_name, shape), ...])] for the backbone
    (model.py:95-206: conv_block/identity_block naming)."""
    layers = [
        ("conv1", [("kernel", (7, 7, 3, 64)), ("bias", (64,))]),
        ("bn_conv1", "bn64"),
    ]
    stage_filters = {2: (64, 64, 256), 3: (128, 128, 512),
                     4: (256, 256, 1024), 5: (512, 512, 2048)}
    identity_counts = {2: 2, 3: 3,
                       4: {"resnet50": 5, "resnet101": 22}[architecture],
                       5: 2}
    in_ch = 64
    for stage in (2, 3, 4, 5):
        f1, f2, f3 = stage_filters[stage]
        blocks = ["a"] + [chr(98 + i) for i in range(identity_counts[stage])]
        for bi, block in enumerate(blocks):
            name = f"{stage}{block}"
            cin = in_ch if bi == 0 else f3
            layers += [
                (f"res{name}_branch2a",
                 [("kernel", (1, 1, cin, f1)), ("bias", (f1,))]),
                (f"bn{name}_branch2a", f"bn{f1}"),
                (f"res{name}_branch2b",
                 [("kernel", (3, 3, f1, f2)), ("bias", (f2,))]),
                (f"bn{name}_branch2b", f"bn{f2}"),
                (f"res{name}_branch2c",
                 [("kernel", (1, 1, f2, f3)), ("bias", (f3,))]),
                (f"bn{name}_branch2c", f"bn{f3}"),
            ]
            if bi == 0:  # conv block shortcut
                layers += [
                    (f"res{name}_branch1",
                     [("kernel", (1, 1, cin, f3)), ("bias", (f3,))]),
                    (f"bn{name}_branch1", f"bn{f3}"),
                ]
        in_ch = f3
    return layers


def _bn(n):
    return [("gamma", (n,)), ("beta", (n,)),
            ("moving_mean", (n,)), ("moving_variance", (n,))]


def matterport_layer_specs(num_classes=81, architecture="resnet101",
                           top_down=256, fc_size=1024, mask_filters=256):
    """Full weight-bearing layer list: [(layer_name, inner_specs)] where
    inner_specs is {inner_layer_name: [(weight_name, shape), ...]} — inner
    differs from the layer name only for the nested rpn_model."""
    td = top_down
    out = []
    for name, spec in _resnet_layers(architecture):
        if isinstance(spec, str):
            spec = _bn(int(spec[2:]))
        out.append((name, {name: spec}))
    out += [
        ("fpn_c5p5", {"fpn_c5p5": [("kernel", (1, 1, 2048, td)),
                                   ("bias", (td,))]}),
        ("fpn_c4p4", {"fpn_c4p4": [("kernel", (1, 1, 1024, td)),
                                   ("bias", (td,))]}),
        ("fpn_c3p3", {"fpn_c3p3": [("kernel", (1, 1, 512, td)),
                                   ("bias", (td,))]}),
        ("fpn_c2p2", {"fpn_c2p2": [("kernel", (1, 1, 256, td)),
                                   ("bias", (td,))]}),
        ("fpn_p2", {"fpn_p2": [("kernel", (3, 3, td, td)), ("bias", (td,))]}),
        ("fpn_p3", {"fpn_p3": [("kernel", (3, 3, td, td)), ("bias", (td,))]}),
        ("fpn_p4", {"fpn_p4": [("kernel", (3, 3, td, td)), ("bias", (td,))]}),
        ("fpn_p5", {"fpn_p5": [("kernel", (3, 3, td, td)), ("bias", (td,))]}),
        # nested keras Model: one saved layer, three inner conv layers
        # (anchors/ratios fixed at 3 ratios -> 6/12 outputs)
        ("rpn_model", {
            "rpn_conv_shared": [("kernel", (3, 3, td, 512)),
                                ("bias", (512,))],
            "rpn_class_raw": [("kernel", (1, 1, 512, 6)), ("bias", (6,))],
            "rpn_bbox_pred": [("kernel", (1, 1, 512, 12)), ("bias", (12,))],
        }),
        ("mrcnn_class_conv1", {"mrcnn_class_conv1": [
            ("kernel", (7, 7, td, fc_size)), ("bias", (fc_size,))]}),
        ("mrcnn_class_bn1", {"mrcnn_class_bn1": _bn(fc_size)}),
        ("mrcnn_class_conv2", {"mrcnn_class_conv2": [
            ("kernel", (1, 1, fc_size, fc_size)), ("bias", (fc_size,))]}),
        ("mrcnn_class_bn2", {"mrcnn_class_bn2": _bn(fc_size)}),
        ("mrcnn_class_logits", {"mrcnn_class_logits": [
            ("kernel", (fc_size, num_classes)), ("bias", (num_classes,))]}),
        ("mrcnn_bbox_fc", {"mrcnn_bbox_fc": [
            ("kernel", (fc_size, num_classes * 4)),
            ("bias", (num_classes * 4,))]}),
    ]
    for i in range(1, 5):
        cin = td if i == 1 else mask_filters
        out.append((f"mrcnn_mask_conv{i}", {f"mrcnn_mask_conv{i}": [
            ("kernel", (3, 3, cin, mask_filters)),
            ("bias", (mask_filters,))]}))
        out.append((f"mrcnn_mask_bn{i}",
                    {f"mrcnn_mask_bn{i}": _bn(mask_filters)}))
    out += [
        # keras Conv2DTranspose stores [kh, kw, OUT, IN]
        ("mrcnn_mask_deconv", {"mrcnn_mask_deconv": [
            ("kernel", (2, 2, mask_filters, mask_filters)),
            ("bias", (mask_filters,))]}),
        ("mrcnn_mask", {"mrcnn_mask": [
            ("kernel", (1, 1, mask_filters, num_classes)),
            ("bias", (num_classes,))]}),
    ]
    return out


# Weightless layers that also appear in layer_names in the real file
# (inputs / lambdas / activations / proposal+detection layers). The
# by_name loader skips them; including them keeps the tree faithful.
_WEIGHTLESS = [
    "input_image", "input_image_meta", "input_anchors", "zero_padding2d_1",
    "max_pooling2d_1", "fpn_p6", "ROI", "roi_align_classifier",
    "pool_squeeze", "mrcnn_class", "mrcnn_bbox", "mrcnn_detection",
    "roi_align_mask",
]


def write_matterport_h5(path, num_classes=81, architecture="resnet101",
                        top_down=256, fc_size=1024, mask_filters=256,
                        seed=0, scale=0.05, init="legacy"):
    """Write a mask_rcnn_coco.h5-layout weights file with seeded random
    values. Returns {layer_name: {inner/weight: array}} for assertions.

    init="legacy" draws every kernel at a flat `scale` std (fine for
    import-layout tests). init="fanin" draws kernels at 1/sqrt(fan_in)
    std so activations stay O(1) through the 50-conv backbone — required
    when the weights are meant to be RUN (the full-graph parity golden,
    tools/gen_fullgraph_golden.py), not just loaded: flat 0.05 kernels
    decay activations to ~0 and every head output collapses to its bias.
    """
    import h5py

    rng = np.random.RandomState(seed)
    specs = matterport_layer_specs(num_classes, architecture, top_down,
                                   fc_size, mask_filters)
    written = {}
    with h5py.File(path, "w") as f:
        layer_names = [name for name, _ in specs] + _WEIGHTLESS
        f.attrs["layer_names"] = np.array(
            [n.encode() for n in layer_names])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.0.8"
        for name, inners in specs:
            g = f.create_group(name)
            wnames = []
            store = written.setdefault(name, {})
            for inner, weights in inners.items():
                ig = g.create_group(inner)
                for wname, shape in weights:
                    if "moving_variance" in wname or wname == "gamma":
                        arr = (1.0 + scale * rng.randn(*shape)).astype(
                            np.float32)
                        arr = np.abs(arr) + 1e-3
                    elif init == "fanin" and len(shape) > 1:
                        fan_in = int(np.prod(shape[:-1]))
                        arr = (rng.randn(*shape) /
                               np.sqrt(max(fan_in, 1))).astype(np.float32)
                        # output heads: random BN stats don't normalize,
                        # so trunk activations keep the molded image's
                        # ~70 std (residual shortcuts carry it through);
                        # unscaled head logits then saturate softmax to
                        # 1.0 and score ORDER becomes tie-broken noise.
                        # 0.02 puts logits at O(1): spread, comparable
                        # scores.
                        if inner in ("rpn_class_raw", "rpn_bbox_pred",
                                     "mrcnn_class_logits", "mrcnn_bbox_fc",
                                     "mrcnn_mask"):
                            arr *= 0.02
                    else:
                        arr = (scale * rng.randn(*shape)).astype(np.float32)
                    ig.create_dataset(f"{wname}:0", data=arr)
                    wnames.append(f"{inner}/{wname}:0".encode())
                    store[f"{inner}/{wname}"] = arr
            g.attrs["weight_names"] = np.array(wnames)
        for name in _WEIGHTLESS:
            g = f.create_group(name)
            g.attrs["weight_names"] = np.array([], dtype="S1")
    return written


# output heads whose kernels get scaled down under init="fanin" so the
# random-weight goldens produce SPREAD scores instead of saturated ties
# (see write_matterport_h5's comment)
_HEAD_OUT_INNERS = ("rpn_class_raw", "rpn_bbox_pred", "mrcnn_class_logits",
                    "mrcnn_bbox_fc", "mrcnn_mask")


def golden_inventory_value(weight_name, shape, seed=0):
    """Deterministic value for one weight, seeded by its NAME — both the
    reference-side golden generator and the repo-side parity check call
    this, so neither needs the other's framework in-process."""
    import zlib

    rng = np.random.RandomState(
        zlib.crc32(f"{seed}:{weight_name}".encode()) & 0xFFFFFFFF)
    shape = tuple(int(s) for s in shape)
    wname = weight_name.split("/")[-1].split(":")[0]
    inner = weight_name.split("/")[0]
    if wname in ("moving_variance", "gamma"):
        return (np.abs(1.0 + 0.05 * rng.randn(*shape)) + 1e-3).astype(
            np.float32)
    if inner == "mrcnn_class_logits" and wname == "bias":
        # zero: in the multi-view golden the fused features reaching the
        # classifier are small (8 fan-in-scaled convs of decay), and any
        # class-bias spread would pin EVERY ROI's argmax to one class —
        # per-ROI feature variation must decide the class
        return np.zeros(shape, np.float32)
    if wname in ("moving_mean", "beta", "bias"):
        return (0.02 * rng.randn(*shape)).astype(np.float32)
    if len(shape) > 1:
        fan_in = int(np.prod(shape[:-1]))
        arr = (rng.randn(*shape) / np.sqrt(max(fan_in, 1))).astype(
            np.float32)
        if inner in ("mrcnn_class_logits", "rpn_class_raw"):
            # full scale: rpn_class_raw must let the FUSED levels' varied
            # scores beat the zeroed-PG2/PG3 levels' constant bias in the
            # proposal top-k, else every proposal is a tiny P2 anchor
            # that routes back to the zeroed levels and classifies BG
            pass
        elif inner in _HEAD_OUT_INNERS:
            arr *= 0.02
        return arr
    return (0.05 * rng.randn(*shape)).astype(np.float32)


def write_h5_from_inventory(path, inventory, seed=0):
    """Write a keras-2-protocol weights h5 from a layer INVENTORY — the
    [{"layer": name, "weights": [{"name": ..., "shape": [...]}]}] dump of
    a built keras model (tests/fixtures/golden_multiview_layers.json
    holds the multi-view fork's: 169 weighted layers from the
    model_multi.py inference build). Values are name-seeded via
    golden_inventory_value, so the reference side (keras by_name loader)
    and the repo side (utils.h5_import) reconstruct identical weights
    from the inventory alone."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [e["layer"].encode() for e in inventory])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.0.8"
        for e in inventory:
            g = f.create_group(e["layer"])
            wnames = []
            for w in e["weights"]:
                full = w["name"]
                g.create_dataset(
                    full, data=golden_inventory_value(full, w["shape"],
                                                      seed))
                wnames.append(full.encode())
            g.attrs["weight_names"] = (np.array(wnames) if wnames
                                       else np.array([], dtype="S1"))
