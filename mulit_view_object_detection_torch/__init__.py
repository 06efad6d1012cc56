"""PyTorch + CUDA port of the multi-view Mask R-CNN.

The JAX package `mulit_view_object_detection_tpu` is the reference; this
package reproduces its inference path on an NVIDIA Hopper GPU. Plain
tensor code is PyTorch; the two geometry gathers that the JAX package
wrote as Pallas TPU kernels are hand-written CUDA kernels here
(`kernels/`, sources in `csrc/`).

The package imports torch, numpy, scipy and the JAX package's jax-free
`config.py` and `data/molding.py` — never jax or flax.
"""

__version__ = "0.1.0"

from .config import Config, check_supported  # noqa: F401
