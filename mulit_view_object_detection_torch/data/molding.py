"""Host-side image/mask molding (numpy + OpenCV).

A numpy copy of `mulit_view_object_detection_tpu/data/molding.py`, not an
import of it: the port imports nothing of the JAX package, not even
a module that imports no jax itself, so it runs where jax is absent.

Implements the same molding contract as the reference pipeline
(mrcnn/utils.py:647-835): the window/scale/padding bookkeeping feeds
coordinates into the device graphs, so that arithmetic is preserved
exactly. Pixel resampling runs on cv2 bilinear instead of skimage (not in
this image); only the coordinate math is parity-load-bearing.

  resize_image   utils.py:647-751 (modes none/square/pad64/crop)
  resize_mask    utils.py:754-773
  minimize_mask  utils.py:776-793  (mini-mask codec)
  expand_mask    utils.py:796-811
  unmold_mask    utils.py:819-835
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage


def resize(image, output_shape, order=1, preserve_range=True,
           anti_aliasing=False):
    """skimage.transform.resize-compatible wrapper (utils.py:1146-1167) on
    cv2; order=1 bilinear, order=0 nearest."""
    import cv2
    h, w = output_shape[:2]
    interp = cv2.INTER_NEAREST if order == 0 else cv2.INTER_LINEAR
    img = np.asarray(image)
    out = cv2.resize(img.astype(np.float32), (int(w), int(h)),
                     interpolation=interp)
    if img.ndim == 3 and out.ndim == 2:
        out = out[:, :, None]
    if preserve_range:
        return out
    return out / 255.0


def _split_padding(deficit):
    """Split a pad amount into (leading, trailing) with the extra pixel on
    the trailing side — the convention the device window math expects."""
    lead = deficit // 2
    return lead, deficit - lead


def _pick_scale(h, w, min_dim, max_dim, min_scale, cap_long_side):
    """Resize factor: bring the short side up to min_dim (never shrink
    below 1), respect min_scale, and in square mode cap the long side at
    max_dim. Order of precedence matches utils.py:676-692."""
    factor = max(1, min_dim / min(h, w)) if min_dim else 1
    if min_scale and factor < min_scale:
        factor = min_scale
    if cap_long_side and max_dim and round(max(h, w) * factor) > max_dim:
        factor = max_dim / max(h, w)
    return factor


def resize_image(image, min_dim=None, max_dim=None, min_scale=None,
                 mode="square"):
    """Returns (image, window, scale, padding, crop); see utils.py:647-751.

    window is (y1, x1, y2, x2): where the real pixels sit inside the
    padded output. padding is [(top, bottom), (left, right), (0, 0)].
    """
    in_dtype = image.dtype
    h, w = image.shape[:2]
    if mode == "none":
        return image, (0, 0, h, w), 1, [(0, 0), (0, 0), (0, 0)], None

    scale = _pick_scale(h, w, min_dim, max_dim, min_scale,
                        cap_long_side=(mode == "square"))
    if scale != 1:
        image = resize(image, (round(h * scale), round(w * scale)),
                       preserve_range=True)
    h, w = image.shape[:2]

    if mode == "square":
        top, bottom = _split_padding(max_dim - h)
        left, right = _split_padding(max_dim - w)
    elif mode == "pad64":
        # pad each side independently up to the next multiple of 64 (the
        # FPN downsampling requirement); min_dim must already comply.
        assert min_dim % 64 == 0, "Minimum dimension must be a multiple of 64"
        top, bottom = _split_padding(-h % 64)
        left, right = _split_padding(-w % 64)
    elif mode == "crop":
        y = np.random.randint(0, h - min_dim) if h > min_dim else 0
        x = np.random.randint(0, w - min_dim) if w > min_dim else 0
        image = image[y:y + min_dim, x:x + min_dim]
        return (image.astype(in_dtype), (0, 0, min_dim, min_dim), scale,
                [(0, 0), (0, 0), (0, 0)], (y, x, min_dim, min_dim))
    else:
        raise ValueError(f"unknown resize mode: {mode!r}")

    padding = [(top, bottom), (left, right), (0, 0)]
    image = np.pad(image, padding, mode="constant", constant_values=0)
    window = (top, left, h + top, w + left)
    return image.astype(in_dtype), window, scale, padding, None


def resize_mask(mask, scale, padding, crop=None):
    """Nearest-neighbor mask resize mirroring resize_image's geometry
    (utils.py:754-773). mask: [H, W, N]."""
    scaled = scipy.ndimage.zoom(mask, zoom=[scale, scale, 1], order=0)
    if crop is not None:
        y, x, ch, cw = crop
        return scaled[y:y + ch, x:x + cw]
    return np.pad(scaled, padding, mode="constant", constant_values=0)


def minimize_mask(bbox, mask, mini_shape):
    """Mini-mask codec: crop each instance to its box, resize to
    mini_shape (utils.py:776-793). mask: [H, W, N] bool."""
    num = mask.shape[-1]
    packed = np.zeros(tuple(mini_shape) + (num,), dtype=bool)
    for idx in range(num):
        y1, x1, y2, x2 = bbox[idx][:4]
        patch = mask[y1:y2, x1:x2, idx].astype(bool)
        if patch.size == 0:
            raise ValueError(
                f"instance {idx} has a zero-area box {bbox[idx][:4]}")
        patch = resize(patch.astype(np.float32), mini_shape, order=1)
        packed[:, :, idx] = np.around(patch).astype(bool)
    return packed


def expand_mask(bbox, mini_mask, image_shape):
    """Inverse of minimize_mask: paste each mini-mask back into its box in
    a full-size canvas (utils.py:796-811)."""
    num = mini_mask.shape[-1]
    canvas = np.zeros(image_shape[:2] + (num,), dtype=bool)
    for idx in range(num):
        y1, x1, y2, x2 = bbox[idx][:4]
        patch = resize(mini_mask[:, :, idx].astype(np.float32),
                       (y2 - y1, x2 - x1), order=1)
        canvas[y1:y2, x1:x2, idx] = np.around(patch).astype(bool)
    return canvas


def unmold_mask(mask, bbox, image_shape, threshold=0.5):
    """Place one predicted MASK_SHAPE soft mask into a full-image binary
    mask at its box (utils.py:819-835)."""
    y1, x1, y2, x2 = bbox
    soft = resize(mask, (y2 - y1, x2 - x1), order=1)
    full = np.zeros(image_shape[:2], dtype=bool)
    full[y1:y2, x1:x2] = soft >= threshold
    return full


def mold_image(images, mean_pixel):
    """Subtract mean pixel, cast float32 (model.py:2719-2724). The mean is
    cast to float32 first — a float64 mean would promote the whole image
    and double the host pipeline's memory traffic."""
    return images.astype(np.float32) - np.asarray(mean_pixel, np.float32)


def unmold_image(normalized_images, mean_pixel):
    return (normalized_images
            + np.asarray(mean_pixel, np.float32)).astype(np.uint8)
