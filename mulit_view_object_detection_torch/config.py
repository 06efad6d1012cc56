"""Configuration: the JAX package's `Config`, reused as is, plus the check
of what this port runs.

`mulit_view_object_detection_tpu/config.py` imports only numpy, and the
package `__init__` on its path imports only it, so the port shares the
schema instead of forking it.
"""

from __future__ import annotations

from mulit_view_object_detection_tpu.config import Config  # noqa: F401

# TPU-only serving lowerings: identical parameters and math as the plain
# layers, so the port runs the plain layers and refuses the flags.
_TPU_LOWERINGS = ("FOLD_BN", "PHASE_DECONV", "PHASE_DECONV_MASK",
                  "ZFOLD_FUSION", "STEM_S2D", "CROSS_LEVEL_FUSION",
                  "LSTM_HOIST_INPUT")
# Paths the JAX package has and this port does not run yet.
_NOT_YET = ("TRAIN_BN", "TRANSFORMER", "TRILINEAR_REPROJECTION",
            "UINT8_IMAGE_TRANSFER", "EXPOSE_FUSED_PYRAMID", "VIEW_SHARDING")


def check_supported(cfg):
    """Raise ValueError on a config this port cannot run faithfully.

    Runs: multi-view conv3d fusion, VANILLA, single view; COMPUTE_DTYPE
    float32 or bfloat16. USE_PALLAS is ignored (the CUDA kernels run
    whenever the tensors are on the GPU)."""
    for name in _TPU_LOWERINGS:
        if getattr(cfg, name, False):
            raise ValueError(
                f"{name} is a TPU-only lowering of the plain layers; the "
                f"PyTorch port runs the plain layers — set {name} = False")
    for name in _NOT_YET:
        if getattr(cfg, name, False):
            raise ValueError(f"{name} is not ported to PyTorch yet")
    if cfg.GRID_REAS != "conv3d":
        raise ValueError(
            f"GRID_REAS={cfg.GRID_REAS!r} is not ported yet; the PyTorch "
            f"port runs conv3d fusion only")
    if cfg.COMPUTE_DTYPE not in ("float32", "bfloat16"):
        raise ValueError(f"COMPUTE_DTYPE={cfg.COMPUTE_DTYPE!r}")
    if callable(cfg.BACKBONE):
        raise ValueError("a callable BACKBONE is not ported")
