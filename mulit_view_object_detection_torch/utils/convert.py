"""Weight bridge between the JAX package's flax variables and the port's
torch state_dict.

The flax tree is taken as nested dicts of numpy arrays
({"params": ..., "batch_stats": ...}), so no jax is needed. Layer names
are shared, so a key maps by path: "a/b/kernel" -> "a.b.weight". The
transforms, by layer kind:

  * Conv kernels HWIO -> OIHW, DHWIO -> OIDHW (voxel axes X, Y, Z are
    torch's D, H, W); grouped convs (DepthCollapse dw1/dw2) have
    I = in/groups on both sides, so they need nothing more.
  * flax ConvTranspose (transpose_kernel=False; the U-Net's up1/up2 and
    the mask head's deconv) convolves the dilated input with its kernel
    as is, where torch's ConvTranspose convolves with the kernel flipped:
    spatial flip, then [k.., I, O] -> [I, O, k..].
  * Dense kernels [in, out] -> [out, in].
  * The attention's DenseGeneral kernels (`mha/{query,key,value}` [d,
    heads, d/heads], `mha/out` [heads, d/heads, d]) move their input axes
    last: [heads, d/heads, d] and [d, heads, d/heads]; their biases keep
    their shapes.
  * BatchNorm `<bn>/BatchNorm_0/{scale, bias}` and batch_stats
    `{mean, var}` -> `<bn>.{weight, bias, running_mean, running_var}`
    (epsilon 1e-3 lives in the torch module).
  * LayerNorm `<ln>/{scale, bias}` -> `<ln>.{weight, bias}` (epsilon 1e-6
    lives in the torch module). On the torch side a LayerNorm is told
    from a BatchNorm by its missing running statistics: its weight is the
    one 1-D weight outside a BatchNorm.
"""

from __future__ import annotations

import numpy as np
import torch

# flax ConvTranspose layers, by their last path component
TRANSPOSED_CONVS = frozenset({"up1", "up2", "mrcnn_mask_deconv"})
_BN = "BatchNorm_0"
# the attention module; its "out" kernel has two input axes, the others one
_ATTENTION = "mha"


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _attention_inputs(path):
    """How many leading input axes the kernel at `path` (its module keys)
    has, if it is one of the attention's DenseGeneral kernels, else 0."""
    if len(path) >= 2 and path[-2] == _ATTENTION:
        return 2 if path[-1] == "out" else 1
    return 0


def _kernel_to_torch(path, kernel):
    layer = path[-1]
    nd = kernel.ndim
    n_in = _attention_inputs(path)
    if n_in:
        return np.moveaxis(kernel, tuple(range(n_in)),
                           tuple(range(nd - n_in, nd)))
    if nd == 2:
        return kernel.T
    spatial = tuple(range(nd - 2))
    if layer in TRANSPOSED_CONVS:
        kernel = np.flip(kernel, axis=spatial)
        return kernel.transpose((nd - 2, nd - 1) + spatial)
    return kernel.transpose((nd - 1, nd - 2) + spatial)


def _kernel_to_flax(path, weight):
    layer = path[-1]
    nd = weight.ndim
    n_in = _attention_inputs(path)
    if n_in:
        return np.moveaxis(weight, tuple(range(nd - n_in, nd)),
                           tuple(range(n_in)))
    if nd == 2:
        return weight.T
    spatial = tuple(range(2, nd))
    if layer in TRANSPOSED_CONVS:
        kernel = weight.transpose(spatial + (0, 1))
        return np.flip(kernel, axis=tuple(range(nd - 2)))
    return weight.transpose(spatial + (1, 0))


def flax_kernel_axes(path, ndim):
    """For the leaf at flax `path` with `ndim` dimensions: the torch
    dimension of each of its flax dimensions (the identity for all but
    kernels). Read off `_kernel_to_flax` itself, on a shape whose sizes
    tell the dimensions apart."""
    if path[-1] != "kernel":
        return tuple(range(ndim))
    sizes = tuple(range(2, 2 + ndim))
    probe = np.broadcast_to(np.zeros((), np.int8), sizes)
    return tuple(sizes.index(s)
                 for s in _kernel_to_flax(path[:-1], probe).shape)


def flax_to_torch(variables):
    """{"params": tree, "batch_stats": tree} of numpy arrays ->
    {name: float32 tensor} for MaskRCNN.load_state_dict(strict=True)."""
    out = {}
    for path, arr in _flatten(variables.get("params", {})):
        *mods, leaf = path
        if mods and mods[-1] == _BN:
            name = ".".join(mods[:-1]) + (".weight" if leaf == "scale"
                                           else ".bias")
            out[name] = arr
        elif leaf == "kernel":
            out[".".join(mods) + ".weight"] = _kernel_to_torch(mods, arr)
        elif leaf == "scale":                         # LayerNorm
            out[".".join(mods) + ".weight"] = arr
        elif leaf == "bias":
            out[".".join(mods) + ".bias"] = arr
        else:
            raise KeyError(f"unmapped flax parameter {'/'.join(path)}")
    for path, arr in _flatten(variables.get("batch_stats", {})):
        *mods, leaf = path
        if not mods or mods[-1] != _BN or leaf not in ("mean", "var"):
            raise KeyError(f"unmapped flax statistic {'/'.join(path)}")
        out[".".join(mods[:-1]) + ".running_" + leaf] = arr
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def flax_path(name, bn_modules, ln_modules=()):
    """The flax path of the torch tensor `name` ("a.b.weight"), as a tuple
    of keys: ("a", "b", "kernel"), or ("a", "b", "BatchNorm_0", "scale")
    when "a.b" is one of `bn_modules`, or ("a", "b", "scale") when it is
    one of `ln_modules`; a running statistic maps to its batch_stats path
    ("a", "b", "BatchNorm_0", "mean" / "var")."""
    mod, leaf = name.rsplit(".", 1)
    path = tuple(mod.split("."))
    if mod in bn_modules:
        if leaf.startswith("running_"):
            return path + (_BN, leaf[len("running_"):])
        return path + (_BN, "scale" if leaf == "weight" else "bias")
    if leaf == "weight":
        return path + ("scale" if mod in ln_modules else "kernel",)
    return path + ("bias",)


def bn_module_names(state_dict):
    """Names of the BatchNorm modules of a state_dict (those with running
    statistics)."""
    return {k[:-len(".running_mean")] for k in state_dict
            if k.endswith(".running_mean")}


def ln_module_names(state_dict, bn_modules):
    """Names of the LayerNorm modules of a state_dict: those whose weight
    is 1-D, outside a BatchNorm."""
    return {k[:-len(".weight")] for k, t in state_dict.items()
            if k.endswith(".weight") and t.ndim == 1
            and k[:-len(".weight")] not in bn_modules}


def torch_to_flax(state_dict):
    """Inverse of flax_to_torch: state_dict -> {"params", "batch_stats"}
    nested dicts of float32 numpy arrays."""
    bns = bn_module_names(state_dict)
    lns = ln_module_names(state_dict, bns)
    params, stats = {}, {}

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = np.ascontiguousarray(value, np.float32)

    for name, t in state_dict.items():
        arr = t.detach().float().cpu().numpy()
        path = flax_path(name, bns, lns)
        if name.rsplit(".", 1)[1].startswith("running_"):
            put(stats, path, arr)
        elif path[-1] == "kernel":
            put(params, path, _kernel_to_flax(path[:-1], arr))
        else:
            put(params, path, arr)
    return {"params": params, "batch_stats": stats}
