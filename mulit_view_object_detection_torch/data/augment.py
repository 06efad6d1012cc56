"""Host-side image/mask augmentation.

A numpy copy of `mulit_view_object_detection_tpu/data/augment.py`, not an
import of it: the port imports nothing of the JAX package, not even
a module that imports no jax itself, so it runs where jax is absent.

The reference hands augmentation to the imgaug library and whitelists the
geometry-safe augmenters that may also touch masks
(mrcnn/model_multi.py:1659-1695, MASK_AUGMENTERS). imgaug
is not a dependency here; instead the framework ships a tiny composable
augmenter set with the same division of labor:

  * geometric augmenters transform image AND mask identically (boxes are
    re-extracted from the transformed mask downstream, so they stay
    consistent for free);
  * photometric augmenters touch only the image.

Every augmenter is a callable `(image, mask, rng) -> (image, mask)` where
`image` is [H, W, 3] uint8/float, `mask` is [H, W, N] bool and `rng` is a
np.random.RandomState. Any user callable with that signature works as the
`augmentation=` argument of the data pipeline and of
`compat.MaskRCNN.train` — including a plain function.
"""

from __future__ import annotations

import numpy as np


class Augmenter:
    """Base class; subclasses implement __call__(image, mask, rng)."""

    def __call__(self, image, mask, rng):  # pragma: no cover - interface
        raise NotImplementedError


class Fliplr(Augmenter):
    """Horizontal flip with probability p — the reference's one built-in
    augmentation (`augment=True` legacy flag, model_multi.py:1659-1664)."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, image, mask, rng):
        if rng.uniform() < self.p:
            image = np.fliplr(image)
            mask = np.fliplr(mask)
        return image, mask


class Flipud(Augmenter):
    """Vertical flip with probability p."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, image, mask, rng):
        if rng.uniform() < self.p:
            image = np.flipud(image)
            mask = np.flipud(mask)
        return image, mask


class Rot90(Augmenter):
    """Rotate by a random multiple of 90 degrees (square images only)."""

    def __init__(self, ks=(0, 1, 2, 3)):
        self.ks = tuple(ks)

    def __call__(self, image, mask, rng):
        k = self.ks[rng.randint(len(self.ks))]
        if k:
            image = np.rot90(image, k)
            mask = np.rot90(mask, k)
        return image, mask


class Multiply(Augmenter):
    """Photometric: scale pixel intensities by a factor drawn from
    [lo, hi]. Image only — masks are never touched."""

    def __init__(self, lo=0.8, hi=1.2):
        self.lo, self.hi = lo, hi

    def __call__(self, image, mask, rng):
        factor = rng.uniform(self.lo, self.hi)
        scaled = image.astype(np.float32) * factor
        if np.issubdtype(image.dtype, np.integer):
            scaled = np.clip(scaled, 0, 255).astype(image.dtype)
        return scaled, mask


class AdditiveNoise(Augmenter):
    """Photometric: add iid Gaussian pixel noise with stddev `scale`."""

    def __init__(self, scale=8.0):
        self.scale = scale

    def __call__(self, image, mask, rng):
        noisy = image.astype(np.float32) + rng.normal(
            0.0, self.scale, size=image.shape).astype(np.float32)
        if np.issubdtype(image.dtype, np.integer):
            noisy = np.clip(noisy, 0, 255).astype(image.dtype)
        return noisy, mask


class Sometimes(Augmenter):
    """Apply `aug` with probability p (imgaug.Sometimes analog)."""

    def __init__(self, p, aug):
        self.p, self.aug = p, aug

    def __call__(self, image, mask, rng):
        if rng.uniform() < self.p:
            return self.aug(image, mask, rng)
        return image, mask


class Sequential(Augmenter):
    """Apply a list of augmenters in order."""

    def __init__(self, augs):
        self.augs = list(augs)

    def __call__(self, image, mask, rng):
        for aug in self.augs:
            image, mask = aug(image, mask, rng)
        return image, mask


def apply_augmentation(augmentation, image, mask, rng):
    """Run an augmenter and sanity-check the contract: shapes preserved,
    mask stays boolean (model_multi.py:1690-1694 performs the same
    assertions after imgaug)."""
    out_image, out_mask = augmentation(image, mask, rng)
    assert out_image.shape == image.shape, \
        "augmentation must not change image size"
    assert out_mask.shape == mask.shape, \
        "augmentation must not change mask size"
    return out_image, out_mask.astype(bool)
