"""ctypes bindings for the C++ data-loader loops of `native/maskops.cpp`:
`extract_instances`, `anchor_gt_match` and `extract_bboxes`.

A copy of `mulit_view_object_detection_tpu/data/native.py` (the port
imports nothing of the JAX package), with two differences:

  * the library is built at first use into `build/native/` of the
    checkout (gitignored), not into the system's temporary directory;
  * a failed build raises. The JAX module falls back to numpy when g++
    fails; here the numpy versions (`*_np`, and `ops/boxes.py::
    extract_bboxes_np` for `extract_bboxes`) are only the plain versions
    the tests hold the library to, and no caller reaches them when the
    build breaks (the anchor matcher's numpy version also serves more
    than MAX_NATIVE_GT boxes, as in the JAX package).

This is host C++ for the data loader, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from ..ops.boxes import compute_overlaps_np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "maskops.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
# -ffp-contract=off: anchor_gt_match's tie detection relies on float32
# results matching numpy bit for bit (no FMA fusion; min, max and divide
# stay IEEE-exact under -march=native, which lets the anchor loops use
# the host's whole vector ISA)
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-march=native", "-shared",
             "-fPIC")
# the C++ anchor matcher keeps its per-GT maxima on the stack
MAX_NATIVE_GT = 256

_LIB = None
_LOCK = threading.Lock()


def _cpu_flags():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return ""


def library_path():
    """The .so for this source on this host: -march=native makes a build
    valid only on the ISA that made it, so the name hashes the source,
    the machine, the CPU flags and the compiler flags."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(
        src + platform.machine().encode() + _cpu_flags().encode()
        + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libmaskops-{tag}.so")


def _build(so_path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed to build {SOURCE}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, so_path)       # concurrent builders each rename whole


def load():
    """The loaded library, built on first use. Raises if g++ fails."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so_path = library_path()
            if not os.path.exists(so_path):
                _build(so_path)
            lib = ctypes.CDLL(so_path)
            c_i32p = ctypes.POINTER(ctypes.c_int32)
            c_u8p = ctypes.POINTER(ctypes.c_uint8)
            c_f32p = ctypes.POINTER(ctypes.c_float)
            lib.extract_instances.restype = ctypes.c_int
            lib.extract_instances.argtypes = [
                c_i32p, c_i32p, ctypes.c_int, ctypes.c_int, c_i32p,
                ctypes.c_int, c_u8p, c_i32p, c_i32p, ctypes.c_int]
            lib.extract_bboxes.restype = None
            lib.extract_bboxes.argtypes = [
                c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_i32p]
            lib.anchor_gt_match.restype = None
            lib.anchor_gt_match.argtypes = [
                c_f32p, ctypes.c_int, c_f32p, ctypes.c_int, c_i32p, c_f32p,
                c_u8p]
            _LIB = lib
    return _LIB


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _class_map(nyu_map):
    """A dict or sequence NYU class -> selected class as a [256] table."""
    map_arr = np.zeros(256, np.int32)
    if isinstance(nyu_map, dict):
        for k, v in nyu_map.items():
            if 0 <= int(k) < 256:
                map_arr[int(k)] = v
    else:
        map_arr[:len(nyu_map)] = nyu_map
    return map_arr


def extract_instances(instance_im, nyu_im, nyu_map, max_inst=256):
    """One-pass instance mask extraction.

    instance_im [H, W] int; nyu_im [H, W] int; nyu_map a dict or [256]
    array NYU class -> selected class (0 = drop). Returns (masks
    [N, H, W] bool, class_ids [N] int32, boxes [N, 4] int32), instances
    in the order their first pixel appears."""
    if instance_im.ndim != 2 or nyu_im.shape != instance_im.shape:
        raise ValueError(f"label maps of shapes {instance_im.shape} and "
                         f"{nyu_im.shape}; want two equal [H, W]")
    h, w = instance_im.shape
    map_arr = _class_map(nyu_map)
    lib = load()
    inst = np.ascontiguousarray(instance_im, np.int32)
    nyu = np.ascontiguousarray(nyu_im, np.int32)
    masks = np.zeros((max_inst, h, w), np.uint8)
    class_ids = np.zeros(max_inst, np.int32)
    boxes = np.zeros((max_inst, 4), np.int32)
    n = lib.extract_instances(
        _ptr(inst, ctypes.c_int32), _ptr(nyu, ctypes.c_int32), h, w,
        _ptr(map_arr, ctypes.c_int32), 256,
        _ptr(masks, ctypes.c_uint8), _ptr(class_ids, ctypes.c_int32),
        _ptr(boxes, ctypes.c_int32), max_inst)
    return masks[:n].astype(bool), class_ids[:n], boxes[:n]


def extract_instances_np(instance_im, nyu_im, nyu_map, max_inst=256):
    """Plain numpy version of `extract_instances` (the reference's loop,
    interior_multi.py:242-259): the same instances, in ascending order of
    their instance label."""
    h, w = instance_im.shape
    map_arr = _class_map(nyu_map)
    masks, class_ids, boxes = [], [], []
    for instance_id in np.unique(instance_im):
        binary = instance_im == instance_id
        nyu_class = int(nyu_im[binary][0])
        cls = int(map_arr[nyu_class]) if nyu_class < 256 else 0
        if cls == 0:
            continue
        ys, xs = np.where(binary)
        masks.append(binary)
        class_ids.append(cls)
        boxes.append([ys.min(), xs.min(), ys.max() + 1, xs.max() + 1])
        if len(masks) >= max_inst:
            break
    if masks:
        return (np.stack(masks), np.array(class_ids, np.int32),
                np.array(boxes, np.int32))
    return (np.zeros((0, h, w), bool), np.zeros(0, np.int32),
            np.zeros((0, 4), np.int32))


def anchor_gt_match(anchors, gt_boxes):
    """Per-anchor best GT and per-GT forced-anchor flags without the
    [A, G] IoU matrix (native/maskops.cpp::anchor_gt_match).

    anchors [A, 4], gt_boxes [G, 4] with 0 < G <= MAX_NATIVE_GT. Returns
    (best_gt [A] int32, best_iou [A] float32, forced [A] bool),
    bit-identical to `anchor_gt_match_np`."""
    if anchors.ndim != 2 or gt_boxes.ndim != 2 or \
            anchors.shape[1] != 4 or gt_boxes.shape[1] != 4:
        raise ValueError(f"boxes must be [N, 4], got {anchors.shape} and "
                         f"{gt_boxes.shape}")
    g = gt_boxes.shape[0]
    if not 0 < g <= MAX_NATIVE_GT:
        raise ValueError(f"anchor_gt_match takes 1..{MAX_NATIVE_GT} GT "
                         f"boxes, got {g}")
    lib = load()
    a = anchors.shape[0]
    anchors = np.ascontiguousarray(anchors, np.float32)
    gt_boxes = np.ascontiguousarray(gt_boxes, np.float32)
    best_gt = np.empty(a, np.int32)
    best_iou = np.empty(a, np.float32)
    forced = np.empty(a, np.uint8)
    lib.anchor_gt_match(
        _ptr(anchors, ctypes.c_float), a,
        _ptr(gt_boxes, ctypes.c_float), g,
        _ptr(best_gt, ctypes.c_int32), _ptr(best_iou, ctypes.c_float),
        _ptr(forced, ctypes.c_uint8))
    return best_gt, best_iou, forced.astype(bool)


def anchor_gt_match_np(anchors, gt_boxes):
    """Plain numpy version of `anchor_gt_match`: the [A, G] float32 IoU
    matrix, its row argmax and max, and the anchors that some GT overlaps
    best (ties included)."""
    iou = compute_overlaps_np(anchors, gt_boxes)
    best_gt = iou.argmax(axis=1)
    best_iou = iou[np.arange(anchors.shape[0]), best_gt]
    forced = (iou == iou.max(axis=0)).any(axis=1)
    return best_gt, best_iou, forced


def _nhw(masks, layout):
    if layout == "HWN":
        return np.ascontiguousarray(np.transpose(masks, (2, 0, 1)))
    if layout == "NHW":
        return np.ascontiguousarray(masks)
    raise ValueError(f"layout must be 'HWN' or 'NHW', got {layout!r}")


def extract_bboxes(masks, layout="HWN"):
    """Tight boxes of bool masks -> [N, 4] int32 (an empty mask gives the
    zero box). `layout` is explicit ('HWN', the reference's utils.py:293
    convention, or 'NHW'): a shape heuristic would misread 100 mini-masks
    of 56x56 passed as [100, 56, 56]."""
    nhw = _nhw(masks, layout)
    n, h, w = nhw.shape
    boxes = np.zeros((n, 4), np.int32)
    if n:
        m8 = nhw.astype(np.uint8)
        load().extract_bboxes(_ptr(m8, ctypes.c_uint8), n, h, w,
                              _ptr(boxes, ctypes.c_int32))
    return boxes

