"""The port's weights -> a Keras h5 in the reference's layout (the
inverse of utils/h5_import.py).

A numpy + h5py copy of `mulit_view_object_detection_tpu/utils/
h5_export.py` (the port imports nothing of the JAX package) that starts
from the port's `state_dict`: utils/convert.py's `torch_to_flax` puts it
in the flax layout the JAX exporter walks, so the layer-name mapping
below is the JAX one, unchanged. tests/test_torch_h5_export.py holds
every dataset equal to the JAX `save_h5_weights` of the same tree, and
export -> `load_h5_state_dict` bit-equal to the state_dict.

The file follows the reference's on-disk protocol (Keras-2
``save_weights``: root ``layer_names`` attr, per-layer ``weight_names``
attrs, ``<layer>/<inner>/<weight>:0`` datasets, as mask_rcnn_coco.h5 and
model.py:2102-2144 / model_multi.py:2592-2642 read back with
``by_name=True``), so weights trained here load into the TF reference
graph. Weight transforms are the exact inverses of the importer's
(ConvTranspose spatial flip + channel transpose, DepthwiseConv
[kh,kw,1,C] -> [kh,kw,C,1], the fused ConvLSTM gate kernel ->
``weights_lstm3d``). The transformer's encoder is reported unmapped, as
in the JAX exporter: the TF side names its layers by session-global
counters.
"""

from __future__ import annotations

import numpy as np

from .convert import torch_to_flax

# our backbone submodule name -> keras name pieces
_RES_SUB = {"conv2a": ("res", "_branch2a"), "conv2b": ("res", "_branch2b"),
            "conv2c": ("res", "_branch2c"), "conv1": ("res", "_branch1"),
            "bn2a": ("bn", "_branch2a"), "bn2b": ("bn", "_branch2b"),
            "bn2c": ("bn", "_branch2c"), "bn1": ("bn", "_branch1")}


def _bn_leaves(params_node, stats_node):
    bn = params_node["BatchNorm_0"]
    sbn = (stats_node or {}).get("BatchNorm_0", {})
    out = [("gamma", bn["scale"]), ("beta", bn["bias"])]
    if "mean" in sbn:
        out += [("moving_mean", sbn["mean"]),
                ("moving_variance", sbn["var"])]
    return out


def _deconv_to_keras(kernel):
    """Inverse of the importer's flip+channel-transpose (h5_import.py:
    Conv{2,3}DTranspose case). Both ops are involutions and commute, so
    the inverse applies the same two steps."""
    nd = kernel.ndim
    flip = tuple(slice(None, None, -1) for _ in range(nd - 2))
    return np.transpose(np.asarray(kernel)[flip],
                        (*range(nd - 2), nd - 1, nd - 2))


def reference_layer_entries(state_dict):
    """([(saved_layer_name, {inner_name: [(weight_name, array), ...]})]
    in deterministic order, the unmappable modules) from the port's
    `state_dict`, by way of its flax-layout tree (utils/convert.py)."""
    tree = torch_to_flax(state_dict)
    params, stats = tree["params"], tree["batch_stats"]
    entries = []
    unmapped = []

    def conv(node):
        out = [("kernel", node["kernel"])]
        if "bias" in node:
            out.append(("bias", node["bias"]))
        return out

    def add(name, inner_weights, inner=None):
        entries.append((name, {inner or name: inner_weights}))

    # ---- backbone ------------------------------------------------------
    bb = params.get("backbone", {})
    sbb = stats.get("backbone", {})
    for mod in sorted(bb):
        node, snode = bb[mod], sbb.get(mod, {})
        if mod == "conv1":
            add("conv1", conv(node))
        elif mod == "bn_conv1":
            add("bn_conv1", _bn_leaves(node, snode))
        elif mod.startswith("res"):
            stage_block = mod[3:]                    # e.g. "2a", "4f"
            for sub in sorted(node):
                prefix, suffix = _RES_SUB[sub]
                kname = f"{prefix}{stage_block}{suffix}"
                if prefix == "bn":
                    add(kname, _bn_leaves(node[sub], snode.get(sub, {})))
                else:
                    add(kname, conv(node[sub]))
        else:
            unmapped.append(("backbone", mod))

    # ---- fpn / heads: keras names stored verbatim in the tree ----------
    for scope in ("fpn", "classifier_head", "mask_head"):
        for mod in sorted(params.get(scope, {})):
            node = params[scope][mod]
            snode = stats.get(scope, {}).get(mod, {})
            if "BatchNorm_0" in node:
                add(mod, _bn_leaves(node, snode))
            elif mod == "mrcnn_mask_deconv":
                add(mod, [("kernel", _deconv_to_keras(node["kernel"])),
                          ("bias", node["bias"])])
            else:
                add(mod, conv(node))

    # ---- rpn: ONE nested saved layer, three inner convs ----------------
    # Keras' by-name loader zips a nested submodel's stored weight list
    # against layer.weights in BUILD order (rpn_graph: shared conv ->
    # class raw -> bbox pred, model_multi.py:845-870) — alphabetical
    # order loads the wrong tensors into the wrong convs.
    if "rpn" in params:
        order = ("rpn_conv_shared", "rpn_class_raw", "rpn_bbox_pred")
        inners = {m: conv(params["rpn"][m])
                  for m in order if m in params["rpn"]}
        inners.update({m: conv(params["rpn"][m])
                       for m in sorted(params["rpn"]) if m not in inners})
        entries.append(("rpn_model", inners))

    # ---- multi-view fusion ---------------------------------------------
    for scope in sorted(params):
        if scope.startswith("grid_fusion_p"):
            lvl = scope[len("grid_fusion_p"):]
            node = params[scope]
            snode = stats.get(scope, {})
            for sub in sorted(node):
                if sub.startswith("down"):
                    add(f"grid_reas_P{lvl}_3D_conv_{sub[4:]}",
                        conv(node[sub]))
                elif sub.startswith("up"):
                    add(f"grid_reas_P{lvl}_3D_conv_deconv_{sub[2:]}",
                        [("kernel", _deconv_to_keras(node[sub]["kernel"])),
                         ("bias", node[sub]["bias"])])
                elif sub.startswith("bn_up"):
                    add(f"grid_reas_P{lvl}_batch_normdeconv_{sub[5:]}",
                        _bn_leaves(node[sub], snode.get(sub, {})))
                elif sub == "fuse_bn":
                    add(f"grid_reas_P{lvl}_batch_norm",
                        _bn_leaves(node[sub], snode.get(sub, {})))
                elif sub.startswith("bn"):
                    add(f"grid_reas_P{lvl}_batch_norm_{sub[2:]}",
                        _bn_leaves(node[sub], snode.get(sub, {})))
                elif sub == "ident_conv":
                    add(f"grid_reas_P{lvl}ident_conv", conv(node[sub]))
                elif sub == "convlstm":
                    gates = node[sub]["cell"]["lstm_gates"]
                    add(f"grid_reas_P{lvl}_convlstm3d",
                        [("weights_lstm3d", gates["kernel"]),
                         ("bias_lstm3d", gates["bias"])])
                else:
                    unmapped.append((scope, sub))
        elif scope.startswith("depth_collapse_p"):
            lvl = scope[len("depth_collapse_p"):]
            node = params[scope]
            snode = stats.get(scope, {})
            for sub in sorted(node):
                if sub.startswith("dw"):
                    # our grouped conv stores [kh, kw, 1, C]; keras
                    # DepthwiseConv2D wants [kh, kw, C, 1]
                    add(f"grid_reas_depth_PG{lvl}_DepthwiseConv_{sub[2:]}",
                        [("depthwise_kernel",
                          np.transpose(node[sub]["kernel"], (0, 1, 3, 2))),
                         ("bias", node[sub]["bias"])])
                elif sub.startswith("pw"):
                    add(f"grid_reas_depth_PG{lvl}2DConv_{sub[2:]}",
                        conv(node[sub]))
                elif sub == "collapse":
                    add(f"grid_reas_depth_PG{lvl}2DConv", conv(node[sub]))
                elif sub == "bn":
                    add(f"grid_reas_depth_PG{lvl}bn_deconv",
                        _bn_leaves(node[sub], snode.get(sub, {})))
                elif sub.startswith("bn"):
                    add(f"grid_reas_depth_PG{lvl}bn_{sub[2:]}",
                        _bn_leaves(node[sub], snode.get(sub, {})))
                else:
                    unmapped.append((scope, sub))
        elif scope in ("backbone", "fpn", "classifier_head", "mask_head",
                       "rpn"):
            pass
        elif scope == "view_transformer":
            # the encoder saves as auto-counted inner Dense/LayerNorm
            # layers whose counters are session-global on the TF side —
            # not reconstructable from our tree alone; the conv3d-family
            # flagship (the cross-check target) has no encoder.
            unmapped.append((scope,))
        else:
            unmapped.append((scope,))
    return entries, unmapped


def save_h5_weights(path, state_dict):
    """Write the port's `state_dict` as a reference-protocol weights h5.
    Returns {"layers": [...], "unmapped": [...]}."""
    import h5py

    entries, unmapped = reference_layer_entries(state_dict)
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [name.encode() for name, _ in entries])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.0.8"
        for name, inners in entries:
            g = f.create_group(name)
            wnames = []
            for inner, weights in inners.items():
                ig = g.create_group(inner)
                for wname, arr in weights:
                    ig.create_dataset(
                        f"{wname}:0",
                        data=np.asarray(arr, dtype=np.float32))
                    wnames.append(f"{inner}/{wname}:0".encode())
            g.attrs["weight_names"] = np.array(wnames)
    return {"layers": [n for n, _ in entries],
            "unmapped": [list(u) for u in unmapped]}
