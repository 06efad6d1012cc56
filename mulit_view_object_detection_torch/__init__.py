"""PyTorch + CUDA port of the multi-view Mask R-CNN.

The JAX package `mulit_view_object_detection_tpu` is the reference; this
package reproduces its multi-view inference and training paths on an
NVIDIA Hopper GPU. Plain tensor code is PyTorch; the two geometry gathers
that the JAX package wrote as Pallas TPU kernels, and their backward
kernels, are hand-written CUDA kernels here (`kernels/`, sources in
`csrc/`).

The package imports torch, numpy and scipy, and nothing of jax, flax or
the JAX package: it keeps its own copies of the numpy modules it needs.
"""

__version__ = "0.1.0"

from .config import Config, check_supported  # noqa: F401
