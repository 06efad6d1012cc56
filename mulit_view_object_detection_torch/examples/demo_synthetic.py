"""End-to-end demo on synthetic multi-view scenes (the reference's
samples/demo.ipynb is a 0-byte file; this is the runnable equivalent),
the port of examples/demo_synthetic.py.

Builds a 2-view detector with seeded weights, runs detection on a
procedurally generated scene with known poses, and renders the result to
demo_output.jpg in the working directory. On the card the add fusion
lifts each view through the per-view unprojection kernel and renders the
fused grid back through the reprojection kernel.

  python -m mulit_view_object_detection_torch.examples.demo_synthetic \
      [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from .. import compat as mrcnn
from ..data.synthetic import SyntheticMultiViewDataset
from ..utils import visualize
from . import device as _device

CLASS_NAMES = ["BG", "class1", "class2", "class3"]
DEMO_NAME = "demo_output"
DEMO_OUTPUT = DEMO_NAME + ".jpg"      # save_image writes <name>.jpg


class DemoConfig(mrcnn.Config):
    NAME = "demo"
    NUM_CLASSES = 4
    NUM_VIEWS = 2
    BACKBONE = "resnet50"
    TOP_DOWN_PYRAMID_SIZE = 32
    FPN_CLASSIF_FC_LAYERS_SIZE = 64
    IMAGE_MIN_DIM = 64
    IMAGE_MAX_DIM = 64
    RPN_ANCHOR_SCALES = (8, 16, 32, 64, 128)
    PRE_NMS_LIMIT = 512
    POST_NMS_ROIS_INFERENCE = 64
    DETECTION_MAX_INSTANCES = 10
    DETECTION_MIN_CONFIDENCE = 0.0   # untrained weights: show raw output
    GRID_REAS = "add"
    nvox = 8
    nvox_z = 8
    vmin, vmax = -2.0, 2.0
    vmin_z, vmax_z = 1.0, 7.0
    samples = 4


def build_model(device="cuda"):
    """The inference engine at DemoConfig with seeded weights."""
    model = mrcnn.MaskRCNN("inference", DemoConfig(), tempfile.gettempdir(),
                           device=str(_device(device)))
    return model.init_weights(torch.Generator().manual_seed(0))


def make_dataset():
    return SyntheticMultiViewDataset(num_scenes=1, num_views=2,
                                     image_size=64)


def demo_inputs(dataset):
    """(views [2, 64, 64, 3] uint8, Rcam [1, 2, 3, 4], Kmat [1, 3, 3]) of
    the dataset's first scene."""
    view_ids = dataset.load_view(2, "s0_v0")
    views = np.stack([dataset.load_image(v) for v in view_ids])
    rcam = np.stack([dataset.load_R(v) for v in view_ids])[None]
    kmat = dataset.K[None].astype(np.float32)
    return views, rcam, kmat


def run_demo(model, dataset):
    """The detections of `model` on the dataset's first scene: detect's
    list of one result dict."""
    views, rcam, kmat = demo_inputs(dataset)
    return model.detect([views], Rcam=rcam, Kmat=kmat)


def save_demo(views, r, save_dir="."):
    """Draw detections `r` on the main view; returns the file's path."""
    return visualize.save_image(
        views[0], DEMO_NAME, r["rois"], r["masks"], r["class_ids"],
        r["scores"], CLASS_NAMES, save_dir=save_dir, mode=0,
        scores_thresh=0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    model = build_model(args.device)
    dataset = make_dataset()
    r = run_demo(model, dataset)[0]
    print(f"detections: {len(r['class_ids'])}")
    print("rois:", r["rois"])
    print("scores:", r["scores"])
    path = save_demo(demo_inputs(dataset)[0], r)
    print("wrote", path)
    return r


if __name__ == "__main__":
    main()
