"""Dataset base class — the image/class registry every dataset plugs into.

A numpy copy of `mulit_view_object_detection_tpu/data/dataset.py`, not an
import of it: the port imports nothing of the JAX package, not even
a module that imports no jax itself, so it runs where jax is absent.

API-compatible with the reference's Dataset (mrcnn/utils.py:498-644):
subclasses call add_class/add_image during construction, then prepare()
freezes the registry into contiguous internal ids and lookup maps.
Multi-view datasets additionally implement load_R, load_depth, load_view
(interior_multi.py:287-328).

Internal ids are row indices: class 0 is always background, image ids are
0..num_images-1 in registration order. External (source) ids map through
`class_from_source_map` / `image_from_source_map`, keyed "<source>.<id>".
"""

from __future__ import annotations

import numpy as np


class Dataset:
    def __init__(self, class_map=None):
        self._image_ids = []
        self.image_info = []
        self.class_info = [{"source": "", "id": 0, "name": "BG"}]
        self.source_class_ids = {}

    # ------------------------------------------------------------------ #
    # registration
    # ------------------------------------------------------------------ #
    def add_class(self, source, class_id, class_name):
        assert "." not in source, \
            "source names must not contain '.' (it is the map separator)"
        if any(c["source"] == source and c["id"] == class_id
               for c in self.class_info):
            return  # already registered
        self.class_info.append(
            {"source": source, "id": class_id, "name": class_name})

    def add_image(self, source, image_id, path, **kwargs):
        self.image_info.append(
            dict(kwargs, id=image_id, source=source, path=path))

    def image_reference(self, image_id):
        """Override: a link/debug string for the image's origin."""
        return ""

    def prepare(self, class_map=None):
        """Freeze the registry: assign contiguous internal ids and build
        the source-id lookup maps. Call once after all add_* calls."""
        self.num_classes = len(self.class_info)
        self.num_images = len(self.image_info)
        self.class_ids = np.arange(self.num_classes)
        self._image_ids = np.arange(self.num_images)
        # display names keep only the first comma-separated synonym
        self.class_names = [c["name"].split(",")[0] for c in self.class_info]

        self.class_from_source_map = {
            f"{c['source']}.{c['id']}": internal
            for internal, c in enumerate(self.class_info)}
        self.image_from_source_map = {
            f"{info['source']}.{info['id']}": internal
            for internal, info in enumerate(self.image_info)}

        # per-source internal class ids; background belongs to every source
        self.sources = list({c["source"] for c in self.class_info})
        self.source_class_ids = {
            source: [internal for internal, c in enumerate(self.class_info)
                     if internal == 0 or c["source"] == source]
            for source in self.sources}

    # ------------------------------------------------------------------ #
    # lookups
    # ------------------------------------------------------------------ #
    def map_source_class_id(self, source_class_id):
        """'coco.73' -> internal class id."""
        return self.class_from_source_map[source_class_id]

    def get_source_class_id(self, class_id, source):
        """Internal class id -> the source dataset's own id."""
        info = self.class_info[class_id]
        assert info["source"] == source
        return info["id"]

    @property
    def image_ids(self):
        return self._image_ids

    def source_image_link(self, image_id):
        return self.image_info[image_id]["path"]

    # ------------------------------------------------------------------ #
    # data hooks (override per dataset)
    # ------------------------------------------------------------------ #
    def load_image(self, image_id):
        """Load [H, W, 3] uint8; grayscale is broadcast to RGB and any
        alpha channel dropped."""
        import imageio.v2 as imageio
        image = imageio.imread(self.image_info[image_id]["path"])
        if image.ndim != 3:
            image = np.stack([image] * 3, axis=-1)
        return image[..., :3]

    def load_mask(self, image_id):
        """Override per dataset. Returns (masks [H, W, N] bool,
        class_ids [N] int32); the base class yields no instances."""
        return (np.empty([0, 0, 0], dtype=bool), np.empty([0], np.int32))
