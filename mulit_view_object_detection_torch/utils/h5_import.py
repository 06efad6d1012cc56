"""Keras h5 -> the port's weights, for Matterport Mask R-CNN files and
the multi-view fork's checkpoints.

A numpy + h5py copy of `mulit_view_object_detection_tpu/utils/h5_import.py`
(the port imports nothing of the JAX package): `load_h5_weights` merges
an h5 file into a flax-layout tree of numpy arrays exactly as the JAX
function does, with plain dict recursion in place of jax.tree_util, and
`load_h5_state_dict` takes the port's state_dict there and back through
`utils/convert.py` (`torch_to_flax`, then `flax_to_torch`), so the
layer-name mapping below is the only one.

It maps the reference's layer names (mask_rcnn_coco.h5, Matterport
release v2.0; utils.py:33, model.py:2102-2144 load_weights) onto the
parameter tree:

  conv1 / bn_conv1                  -> backbone/conv1, backbone/bn_conv1
  res{S}{B}_branch2{a,b,c}, _branch1 -> backbone/res{S}{B}/conv2{a,b,c}, conv1
  bn{S}{B}_branch*                  -> backbone/res{S}{B}/bn*
  fpn_c{2..5}p{2..5}, fpn_p{2..5}   -> fpn/*
  rpn_model/rpn_*                   -> rpn/*
  mrcnn_class_*, mrcnn_bbox_fc      -> classifier_head/*
  mrcnn_mask_*                      -> mask_head/*

Keras Conv kernels are [kh, kw, in, out] (as in flax); Dense [in, out]
(as in flax); Conv2DTranspose kernels are [kh, kw, out, in] and are
spatially flipped and channel-transposed to match flax nn.ConvTranspose's
fractionally-strided correlation. BatchNorm gamma/beta -> scale/bias
(params), moving_mean/moving_variance -> mean/var (batch_stats).
"""

from __future__ import annotations

import re

import numpy as np


def _h5_layer_weights(h5file):
    """{layer_name: {weight_name: array}} from a keras h5 file.

    Follows the reference's root switch exactly (model.py:2122-2123): use
    the file root when it carries ``layer_names``, else ``model_weights``.
    When the keras ``layer_names``/``weight_names`` attrs are present the
    real save_weights protocol is used (weight_names are paths inside the
    layer group; a nested submodel like ``rpn_model`` lists its inner
    layers' names — the inner layer is the addressable unit). Falls back
    to a structural walk for attr-less files.

    Returns ({inner_layer: {weight: array}}, {inner_layer: saved_layer})
    — the second map preserves the OUTER saved name (e.g. ``rpn_model``
    for its inner ``rpn_conv_shared``) so exclude= can address either,
    like the reference's by-name loader which keys on saved names."""
    out, outer_of = {}, {}
    if "layer_names" not in h5file.attrs and "model_weights" in h5file:
        root = h5file["model_weights"]
    else:
        root = h5file

    if "layer_names" in root.attrs:
        for lname in root.attrs["layer_names"]:
            lname = lname.decode() if isinstance(lname, bytes) else lname
            if lname not in root:
                continue
            g = root[lname]
            for wpath in g.attrs.get("weight_names", []):
                wpath = (wpath.decode() if isinstance(wpath, bytes)
                         else wpath)
                parts = wpath.split("/")
                inner = parts[-2] if len(parts) > 1 else lname
                wname = parts[-1].split(":")[0]
                out.setdefault(inner, {})[wname] = np.asarray(g[wpath])
                outer_of[inner] = lname
        return out, outer_of

    def visit(name, obj):
        import h5py as _h
        if isinstance(obj, _h.Dataset):
            parts = name.split("/")
            # .../<layer>/<weight>:0 ; nested models add prefixes
            layer = parts[-2]
            wname = parts[-1].split(":")[0]
            out.setdefault(layer, {})[wname] = np.asarray(obj)
            outer_of[layer] = parts[0] if parts else layer

    root.visititems(visit)
    return out, outer_of


_BOTTLENECK_RE = re.compile(r"^(res|bn)(\d)([a-z]+)_branch(2[abc]|1)$")

# multi-view fork fusion layers (model_multi.py:394-490; per-level scopes
# 'grid_reas_P{n}' / 'grid_reas_depth_PG{n}' at model_multi.py:2387-2403)
_GRID_CONV_RE = re.compile(r"^grid_reas_P(\d)_3D_conv(_deconv)?_([12])$")
_GRID_BN_RE = re.compile(
    r"^grid_reas_P(\d)_batch_norm(?:(deconv)?_([12]))?$")
_GRID_IDENT_RE = re.compile(r"^grid_reas_P(\d)ident_conv$")
_GRID_LSTM_RE = re.compile(r"^grid_reas_P(\d)_convlstm3d$")
# transformer-fusion encoder inner layers (model_transformer.py:216-349):
# the whole encoder saves as ONE 'transformer' layer group whose inner
# Dense/LayerNormalization layers carry keras-global auto counters
_XF_DENSE_RE = re.compile(r"^dense(?:_(\d+))?$")
_XF_LN_RE = re.compile(r"^layer_normalization(?:_(\d+))?$")
_DEPTH_RE = re.compile(
    r"^grid_reas_depth_PG(\d)"
    r"(?:_DepthwiseConv_([12])|2DConv_([12])|bn_([12])|2DConv|bn_deconv)$")


def _map_layer(name):
    """Keras layer name -> (tree path tuple, is_bn)."""
    m = _BOTTLENECK_RE.match(name)
    if m:
        kind, stage, block, branch = m.groups()
        mod = f"res{stage}{block}"
        prefix = "conv" if kind == "res" else "bn"
        sub = prefix + branch            # conv2a/conv2b/conv2c/conv1, bn...
        return ("backbone", mod, sub), kind == "bn"
    if name == "conv1":
        return ("backbone", "conv1"), False
    if name == "bn_conv1":
        return ("backbone", "bn_conv1"), True
    m = _GRID_CONV_RE.match(name)
    if m:
        lvl, deconv, idx = m.groups()
        sub = ("up" if deconv else "down") + idx
        return (f"grid_fusion_p{lvl}", sub), False
    m = _GRID_BN_RE.match(name)
    if m:
        lvl, deconv, idx = m.groups()
        if idx is None:
            sub = "fuse_bn"              # add / ident / lstm3d single BN
        else:
            sub = ("bn_up" if deconv else "bn") + idx
        return (f"grid_fusion_p{lvl}", sub), True
    m = _GRID_IDENT_RE.match(name)
    if m:
        return (f"grid_fusion_p{m.group(1)}", "ident_conv"), False
    m = _GRID_LSTM_RE.match(name)
    if m:
        # handled specially in load_h5_weights (kernel + recurrent_kernel
        # fuse into the single-gate-conv parameter)
        return (f"grid_fusion_p{m.group(1)}", "convlstm", "cell",
                "lstm_gates"), False
    m = _DEPTH_RE.match(name)
    if m:
        lvl, dw, pw, bn = m.groups()
        base = f"depth_collapse_p{lvl}"
        if dw:
            return (base, "dw" + dw), False
        if pw:
            return (base, "pw" + pw), False
        if bn:
            return (base, "bn" + bn), True
        if name.endswith("bn_deconv"):
            return (base, "bn"), True
        return (base, "collapse"), False    # name+'2DConv' (1x1 collapse)
    if name.startswith("fpn_"):
        return ("fpn", name), False
    if name.startswith("rpn_"):
        return ("rpn", name), False
    if name.startswith("mrcnn_mask"):
        bn = "bn" in name
        return ("mask_head", name), bn
    if name.startswith("mrcnn_"):
        bn = "bn" in name
        return ("classifier_head", name), bn
    return None, False


def _numpy_tree(tree):
    """A new nested dict with `tree`'s structure and its leaves as numpy
    arrays (what jax.tree_util.tree_map(np.asarray, tree) gives)."""
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def load_h5_weights(h5_path, params, batch_stats=None, verbose=False,
                    exclude=None):
    """Merge keras h5 weights into (a copy of) flax `params`/`batch_stats`
    by name; unmatched layers are left at their current values (keras
    by_name=True semantics). `exclude` is the reference's layer-name
    exclude list (model.py:2102-2144) — matching layers keep their current
    values (head-swap transfer learning). Returns
    (params, batch_stats, report)."""
    import h5py

    params = _numpy_tree(params)
    batch_stats = _numpy_tree(batch_stats or {})
    exclude = set(exclude or ())

    with h5py.File(h5_path, "r") as f:
        layers, outer_of = _h5_layer_weights(f)

    loaded, skipped, excluded = [], [], []
    for lname, weights in layers.items():
        # exclude matches either the inner layer name or the saved
        # (outer) layer name — the reference excludes by saved name, e.g.
        # exclude=["rpn_model"] drops the whole nested RPN submodel
        if lname in exclude or outer_of.get(lname) in exclude:
            excluded.append(lname)
            continue
        if outer_of.get(lname) == "transformer":
            # the whole encoder saved as one nested layer group; its
            # auto-named inner Dense/LayerNorm layers map structurally
            try:
                if _assign_transformer_layer(params, lname, weights,
                                             _xf_counter_bases(layers,
                                                               outer_of)):
                    loaded.append(lname)
                else:
                    skipped.append(lname)
            except KeyError:
                skipped.append(lname)
            continue
        semantic_name = lname
        path, is_bn = _map_layer(lname)
        if path is None:
            # TimeDistributed wrappers around UNNAMED sublayers (the
            # fork's non-conv3d depth collapse, model_multi.py:483:
            # KL.TimeDistributed(KL.Conv2D(1, (1,1)), name=...+'2DConv'))
            # save their weights under the sublayer's AUTO-GENERATED
            # name ('conv2d_57/kernel:0'); the addressable identity is
            # then the saved (outer) layer name. Only safe when the
            # outer wraps exactly ONE weighted inner — two inners would
            # silently overwrite each other at the same param path.
            outer = outer_of.get(lname, lname)
            siblings = [k for k, v in outer_of.items() if v == outer]
            if outer != lname and len(siblings) == 1:
                semantic_name = outer
                path, is_bn = _map_layer(outer)
        if path is None:
            skipped.append(lname)
            continue
        try:
            if is_bn:
                bn_path = path + ("BatchNorm_0",)
                _assign(params, bn_path, "scale", weights.get("gamma"))
                _assign(params, bn_path, "bias", weights.get("beta"))
                _assign(batch_stats, bn_path, "mean",
                        weights.get("moving_mean"))
                _assign(batch_stats, bn_path, "var",
                        weights.get("moving_variance"))
            else:
                kernel = weights.get("kernel")
                if "weights_lstm3d" in weights:
                    # the reference's ConvLSTMCell stores ONE fused gate
                    # kernel [k,k,k, C+F, 4F] named 'weights_lstm3d' and
                    # a 'bias_lstm3d' (recurrent.py:423-431) — the same
                    # layout as our cell's single gate conv, gate order
                    # (j,i,f,o) from tf.split (recurrent.py:460): direct
                    # assignment, no transform.
                    kernel = weights["weights_lstm3d"]
                elif "depthwise_kernel" in weights:
                    # Keras DepthwiseConv2D stores [kh, kw, in, mult=1]
                    # under `depthwise_kernel`; our grouped
                    # nn.Conv(feature_group_count=in) wants
                    # [kh, kw, in/groups=1, out=in]
                    kernel = np.transpose(weights["depthwise_kernel"],
                                          (0, 1, 3, 2))
                elif kernel is not None and "recurrent_kernel" in weights:
                    # Keras-standard ConvLSTM checkpoints keep separate
                    # input / recurrent kernels; our cell runs ONE conv
                    # over concat([x, h]) (recurrent.py:453-457), so the
                    # fused kernel is their concat along the
                    # input-channel axis
                    kernel = np.concatenate(
                        [kernel, weights["recurrent_kernel"]], axis=-2)
                elif kernel is not None and "deconv" in semantic_name:
                    # Keras Conv{2,3}DTranspose stores [k..., out, in] and
                    # computes the GRADIENT-of-conv deconvolution. Flax
                    # nn.ConvTranspose (transpose_kernel=False) computes a
                    # fractionally-strided CORRELATION over a [k..., in,
                    # out] kernel — the two differ by a spatial flip, so
                    # both the flip (every spatial dim) and the channel
                    # transpose are needed to reproduce TF numerics (see
                    # tests/test_h5_import.py::test_deconv_semantics).
                    nd = kernel.ndim
                    flip = tuple(slice(None, None, -1)
                                 for _ in range(nd - 2))
                    kernel = np.transpose(
                        kernel[flip], (*range(nd - 2), nd - 1, nd - 2))
                _assign(params, path, "kernel", kernel)
                _assign(params, path, "bias",
                        weights.get("bias", weights.get("bias_lstm3d")))
            loaded.append(lname)
        except KeyError:
            skipped.append(lname)
    report = {"loaded": loaded, "skipped": skipped, "excluded": excluded}
    if verbose:
        print(f"h5 import: {len(loaded)} layers loaded, "
              f"{len(skipped)} skipped: {skipped[:10]}")
    return params, batch_stats, report


def _xf_counter_bases(layers, outer_of):
    """Minimum Dense / LayerNormalization auto-counter among the
    'transformer' group's inner layers. Keras auto-counters are
    SESSION-global: a checkpoint saved after any other unnamed
    Dense/LayerNormalization was created carries offset counters
    (dense_7, dense_8, ...). The structural (i, j) = divmod mapping in
    _assign_transformer_layer assumes 0-based counters, so normalize by
    each family's minimum within the group — the encoder creates its
    inner layers consecutively, so min == the group's true base."""
    dense, ln = [], []
    for name in layers:
        if outer_of.get(name) != "transformer":
            continue
        m = _XF_DENSE_RE.match(name)
        if m:
            dense.append(int(m.group(1) or 0))
        m = _XF_LN_RE.match(name)
        if m:
            ln.append(int(m.group(1) or 0))
    return (min(dense) if dense else 0, min(ln) if ln else 0)


def _assign_transformer_layer(params, lname, weights, bases=(0, 0)):
    """Map one of the reference transformer encoder's auto-named inner
    layers (saved under the single 'transformer' layer group,
    model_transformer.py:216-349) onto
    models/transformer.py::ViewFusionTransformer ('view_transformer' in
    the detector tree).

    Dense counter N (normalized by the group's minimum counter, `bases`
    — see _xf_counter_bases) decomposes as (i, j) = divmod(N, 6):
    j in 0..3 are the i-th EncoderLayer's MHA wq/wk/wv/out projections
    (keras [d, d] kernels reshaped to flax
    MultiHeadDotProductAttention's head-split layout [d, H, d/H] /
    [H, d/H, d]); j == 4/5 the FFN pair. A dense whose encoder-layer
    index does not exist in the tree is the final token projection
    (Transformer.final_layer, model_transformer.py:340-345). LayerNorm
    counter M: encoder layer M//2, ln{M % 2 + 1} (gamma -> scale,
    beta -> bias). Returns True when assigned. All of a layer's writes
    are validated before any is applied, so a raising layer leaves the
    tree untouched ('skipped' really means untouched)."""
    root = params.get("view_transformer")
    if root is None:
        return False

    staged = []

    def reshape_to(tree_path, leaf, value):
        node = root
        for p in tree_path:
            node = node[p]
        expect = np.asarray(node[leaf])
        if expect.size != value.size:
            raise KeyError(f"size mismatch {expect.shape} vs {value.shape}")
        staged.append((node, leaf,
                       value.reshape(expect.shape).astype(expect.dtype)))

    def commit():
        for node, leaf, value in staged:
            node[leaf] = value
        return True

    m = _XF_DENSE_RE.match(lname)
    if m:
        n = int(m.group(1) or 0) - bases[0]
        i, j = divmod(n, 6)
        kernel, bias = weights["kernel"], weights["bias"]
        if f"layer{i}" not in root:
            reshape_to(("token_proj",), "kernel", kernel)
            reshape_to(("token_proj",), "bias", bias)
            return commit()
        sub = ({0: ("mha", "query"), 1: ("mha", "key"),
                2: ("mha", "value"), 3: ("mha", "out"),
                4: ("ffn1",), 5: ("ffn2",)})[j]
        reshape_to((f"layer{i}",) + sub, "kernel", kernel)
        reshape_to((f"layer{i}",) + sub, "bias", bias)
        return commit()
    m = _XF_LN_RE.match(lname)
    if m:
        n = int(m.group(1) or 0) - bases[1]
        i, j = divmod(n, 2)
        reshape_to((f"layer{i}", f"ln{j + 1}"), "scale", weights["gamma"])
        reshape_to((f"layer{i}", f"ln{j + 1}"), "bias", weights["beta"])
        return commit()
    return False


def _assign(tree, path, leaf, value):
    if value is None:
        return
    node = tree
    for p in path:
        if p not in node:
            raise KeyError(p)
        node = node[p]
    if leaf not in node:
        raise KeyError(leaf)
    expect = np.asarray(node[leaf])
    if expect.shape != value.shape:
        raise KeyError(f"shape mismatch {expect.shape} vs {value.shape}")
    node[leaf] = value.astype(expect.dtype)


def load_h5_state_dict(h5_path, state_dict, exclude=None, verbose=False):
    """Merge a keras h5 file into a copy of the port's `state_dict` by
    layer name (keras by_name=True semantics; `exclude` as in
    `load_h5_weights`). Returns ({name: float32 tensor} with every key of
    `state_dict`, report)."""
    from .convert import flax_to_torch, torch_to_flax

    tree = torch_to_flax(state_dict)
    params, batch_stats, report = load_h5_weights(
        h5_path, tree["params"], tree["batch_stats"], verbose=verbose,
        exclude=exclude)
    return (flax_to_torch({"params": params, "batch_stats": batch_stats}),
            report)
