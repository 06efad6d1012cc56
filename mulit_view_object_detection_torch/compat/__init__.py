"""Matterport mrcnn-style public API over the PyTorch model: `Config`,
`MaskRCNN`, the molding utilities and the metrics, as the JAX package's
`compat` gives them.

    from mulit_view_object_detection_torch import compat as mrcnn
    model = mrcnn.MaskRCNN("inference", cfg, model_dir)
    results = model.detect([image])
"""

import numpy as np

from ..config import Config  # noqa: F401
from ..data.molding import (expand_mask, minimize_mask, mold_image,  # noqa: F401
                            resize_image, resize_mask, unmold_image,
                            unmold_mask)
from ..eval.metrics import (compute_ap, compute_ap_range,  # noqa: F401
                            compute_matches, compute_recall)
from ..ops.anchors import compute_backbone_shapes  # noqa: F401
from .model import MaskRCNN  # noqa: F401


def batch_slice(inputs, graph_fn, batch_size, names=None):
    """utils.batch_slice (utils.py:1062-1096) on host data: `graph_fn` on
    each row of the `inputs` (one array or a list of them), each of its
    outputs stacked over the rows; one output comes back bare. `names`
    is accepted for the reference's signature and unused."""
    if not isinstance(inputs, list):
        inputs = [inputs]
    outputs = []
    for i in range(batch_size):
        output_slice = graph_fn(*[x[i] for x in inputs])
        if not isinstance(output_slice, (tuple, list)):
            output_slice = [output_slice]
        outputs.append(output_slice)
    result = [np.stack(o, axis=0) for o in zip(*outputs)]
    return result[0] if len(result) == 1 else result


def download_trained_weights(coco_model_path, verbose=1):
    """utils.py:1098-1109: the reference downloads mask_rcnn_coco.h5 here.
    The port, as the JAX package, fetches nothing: obtain the file
    elsewhere and load it with `MaskRCNN.load_weights(path)`, which reads
    it through utils/h5_import.py::load_h5_state_dict."""
    raise NotImplementedError(
        "No network egress in this environment; obtain mask_rcnn_coco.h5 "
        "elsewhere and load it with MaskRCNN.load_weights (the port's "
        "utils.h5_import.load_h5_state_dict).")
