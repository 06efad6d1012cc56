"""Runnable examples of the port, each a `python -m` module:
`demo_synthetic` (the detector on a synthetic 2-view scene) and
`projection_playground` (the geometry kernels alone, outside the
detector)."""

import torch


def device(name):
    """torch.device(name); a CUDA device that is not there raises rather
    than letting the example carry on on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False; pass --device cpu to run on the CPU")
    return dev
