"""Engine API (Matterport-style) over the PyTorch model."""

from .model import MaskRCNN  # noqa: F401
