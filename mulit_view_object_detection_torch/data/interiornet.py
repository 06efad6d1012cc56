"""InteriorNet dataset loader (HD1 sequential, HD7 non-sequential).

A copy of `mulit_view_object_detection_tpu/data/interiornet.py` (the port
imports nothing of the JAX package) that reads its PNGs with cv2 rather
than imageio, which the card's host may lack: `read_png` gives the
arrays imageio gives (RGB channel order, uint16 kept, alpha kept), and
raises on a file it cannot read, where cv2 alone returns None.

It re-implements InteriorDataset (samples/interior/interior_multi.py:
83-328) without pycocotools: the per-scene `cocolabel.json` is parsed
directly, for its image listing only; masks come from the
`<frame>_instance.png` + `<frame>_nyu.png` label pairs.

Layout (reference README and loader):
  <root>/<subset>/<scene>/cocolabel.json                (HD7)
  <root>/<subset>/<scene>/original_1_1/cocolabel.json   (HD1)
  <root>/<subset>/<scene>/[original_1_1/]label0/data/<frame>_instance.png
  <root>/<subset>/<scene>/[original_1_1/]label0/data/<frame>_nyu.png
  <root>/<subset>/<scene>/depth0/data/<frame>.png
  <root>/<subset>/<scene>/cam0.render                   (HD7 poses)
  <root>/<subset>/<scene>/velocity_angular_1_1/cam0_gt.visim  (HD1 poses)
  <root>/<subset>/view_mapping[_seq].json

Hard-coded InteriorNet intrinsics K = [[600,0,320],[0,600,320],[0,0,1]]
(interior_multi.py:150-156).
"""

from __future__ import annotations

import csv
import glob
import json
import os

import cv2
import numpy as np

from ..utils.pose import quat2rot, vec2rot
from .classes import NYU40_TO_SELECTED, SELECTED_CLASSES
from .dataset import Dataset
from .molding import resize_image
from .native import extract_instances

INTERIORNET_K = np.array([[600.0, 0, 320], [0, 600, 320], [0, 0, 1]])


def read_png(path):
    """An image file as imageio.imread returns it: [H, W] for one
    channel, [H, W, 3] RGB or [H, W, 4] RGBA, in the file's bit depth."""
    image = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if image is None:
        raise FileNotFoundError(f"cannot read image {path}")
    if image.ndim == 3 and image.shape[2] == 4:
        return cv2.cvtColor(image, cv2.COLOR_BGRA2RGBA)
    if image.ndim == 3:
        return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    return image


def write_png(path, image):
    """Write [H, W] or [H, W, 3] RGB (uint8 or uint16) as a PNG that
    `read_png` reads back unchanged; makes the parent directories."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if image.ndim == 3:
        image = cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
    if not cv2.imwrite(path, image):
        raise OSError(f"cannot write image {path}")


class InteriorNetDataset(Dataset):
    """Multi-view InteriorNet dataset."""

    def load_interiornet(self, dataset_dir, subset,
                         nyu40_to_sel_map=None, selected_classes=None,
                         class_ids=None):
        nyu40_to_sel_map = nyu40_to_sel_map or NYU40_TO_SELECTED
        selected_classes = selected_classes or SELECTED_CLASSES
        _, hd_folder = os.path.split(dataset_dir.rstrip("/"))
        self.hd_folder = hd_folder
        dataset_dir = os.path.join(dataset_dir, subset)
        self.dataset_dir = dataset_dir
        self.NYU40_to_sel_map = nyu40_to_sel_map
        self.K = INTERIORNET_K.copy()

        is_hd7 = hd_folder == "HD7"
        self.label_path = ("label0/data" if is_hd7
                           else "original_1_1/label0/data")
        view_map_name = ("view_mapping.json" if is_hd7
                         else "view_mapping_seq.json")
        vm_path = os.path.join(dataset_dir, view_map_name)
        self.view_map = {}
        if os.path.exists(vm_path):
            with open(vm_path) as f:
                self.view_map = json.load(f)

        for i in range(1, len(selected_classes)):
            self.add_class("interior", i, selected_classes[i])

        for scene_dir in sorted(glob.glob(os.path.join(dataset_dir, "*"))):
            if scene_dir.endswith(".json") or not os.path.isdir(scene_dir):
                continue
            add_path = "" if is_hd7 else "original_1_1"
            coco_path = os.path.join(scene_dir, add_path, "cocolabel.json")
            if not os.path.exists(coco_path):
                continue
            with open(coco_path) as f:
                coco = json.load(f)
            scene = os.path.split(scene_dir)[1]
            time_to_pose = self._load_poses(scene_dir, is_hd7)
            for img in coco.get("images", []):
                image_name = os.path.split(img["file_name"])[1][:-4]
                uid = scene + "_id" + image_name
                timestamp = int(img["timestamp"])
                if timestamp not in time_to_pose:
                    continue
                R = self._pose_to_R(time_to_pose[timestamp], is_hd7)
                self.add_image(
                    "interior", image_id=uid,
                    image_sub_id=image_name,
                    path=os.path.join(scene_dir, add_path, img["file_name"]),
                    width=img["width"], height=img["height"],
                    subfolder=scene, R=R)

    @staticmethod
    def _load_poses(scene_dir, is_hd7):
        """timestamp -> raw pose row (interior_multi.py:158-192)."""
        time_to_pose = {}
        if is_hd7:
            path = os.path.join(scene_dir, "cam0.render")
            if not os.path.exists(path):
                return time_to_pose
            with open(path) as f:
                reader = csv.reader(f, delimiter=" ")
                for _ in range(3):
                    next(reader, None)
                for row in reader:
                    if row:
                        time_to_pose[int(row[0])] = row[1:]
        else:
            path = os.path.join(scene_dir, "velocity_angular_1_1",
                                "cam0_gt.visim")
            if not os.path.exists(path):
                return time_to_pose
            with open(path) as f:
                reader = csv.reader(f, delimiter=",")
                next(reader, None)
                for row in reader:
                    if row:
                        time_to_pose[int(row[0])] = row[1:]
        return time_to_pose

    @staticmethod
    def _pose_to_R(row, is_hd7):
        """Raw pose row -> [R|t] 3x4 cam->world (interior_multi.py:188-192).

        HD7 translation: the reference uses `vec[1:4]` (interior_multi.py:
        192) on the same timestamp-stripped row whose eye position its own
        vec2rot reads as `vec[0:3]`, i.e. it stores (eye_y, eye_z,
        lookat_x) as the camera centre, an off-by-one that garbles every
        HD7 pose. The JAX package fixes it, and so does this copy: the
        camera centre is the eye, vals[0:3] (the rotation was already
        consistent with vals[0:3])."""
        vals = [float(x) for x in row]
        if is_hd7:
            return np.concatenate(
                [vec2rot(np.array(vals)),
                 np.array(vals[0:3]).reshape(3, 1)], axis=1)
        x, y, z, qw, qx, qy, qz = vals[:7]
        return np.concatenate(
            [quat2rot([qw, qx, qy, qz]), np.array([[x], [y], [z]])], axis=1)

    def image_reference(self, image_id):
        return self.image_info[image_id]["path"]

    def load_image(self, image_id):
        """[H, W, 3] uint8 RGB; grayscale is broadcast to RGB and any alpha
        channel dropped (the base class's contract, read with cv2)."""
        image = read_png(self.image_info[image_id]["path"])
        if image.ndim != 3:
            image = np.stack([image] * 3, axis=-1)
        return image[..., :3]

    def load_mask(self, image_id):
        """Masks from <frame>_instance.png + <frame>_nyu.png
        (interior_multi.py:218-268), by the one-pass C++ extraction."""
        info = self.image_info[image_id]
        base = os.path.join(self.dataset_dir, info["subfolder"],
                            self.label_path, str(info["image_sub_id"]))
        instance_im = read_png(base + "_instance.png")
        nyu_im = read_png(base + "_nyu.png")
        masks, class_ids, _ = extract_instances(
            instance_im, nyu_im, self.NYU40_to_sel_map)
        if len(class_ids):
            return np.transpose(masks, (1, 2, 0)), class_ids
        return super().load_mask(image_id)

    def load_depth(self, image_id, config):
        """Depth map resized to the transformer's token grid
        (interior_multi.py:271-284)."""
        info = self.image_info[image_id]
        depth_path = os.path.join(self.dataset_dir, info["subfolder"],
                                  "depth0/data",
                                  str(info["image_sub_id"]) + ".png")
        depth_image = read_png(depth_path)[:, :, None]
        ds = int(config.IMAGE_SHAPE[0]) // config.BACKBONE_STRIDES[3]
        depth_image, _, _, _, _ = resize_image(
            depth_image, min_dim=ds, min_scale=config.IMAGE_MIN_SCALE,
            max_dim=ds, mode=config.IMAGE_RESIZE_MODE)
        return depth_image[:, :, 0]

    def load_R(self, image_id):
        return self.image_info[image_id]["R"]

    def load_view(self, n, main_image, rnd_state=None):
        """Pick n view ids, main first: HD1 = stride-5 temporal neighbours,
        HD7 = random among >= 5 co-visible views (interior_multi.py:
        294-328). Returns None when the sample cannot supply n views
        (sparse-view samples are skipped, model_multi.py:2143-2146), never
        a short list, which would break batch stacking."""
        max_views = 5
        rnd = np.random.RandomState(rnd_state)
        if self.hd_folder != "HD7":
            num_skip = 5
            secondary = np.asarray(self.view_map[main_image])
            image_ids = secondary[::-1][num_skip:n * num_skip:num_skip]
            if image_ids.shape[0] < n - 1:   # scene shorter than the stride
                return None
            out = [self.image_from_source_map["interior." + main_image]]
            for iid in image_ids:
                out.append(self.image_from_source_map["interior." + iid])
            return out
        secondary = np.asarray(self.view_map[main_image])
        # the reference draws max_views-1 = 4 candidates and slices
        # [:n-1], capping NUM_VIEWS > 5 at five views; here the draw grows
        # with n (the same random stream for n <= 5)
        if secondary.shape[0] < max(max_views, n - 1):
            return None
        views = rnd.choice(range(secondary.shape[0]),
                           max(max_views - 1, n - 1), replace=False)
        image_ids = secondary[views][:n - 1]
        out = [self.image_from_source_map["interior." + main_image]]
        for iid in image_ids:
            out.append(self.image_from_source_map["interior." + iid])
        return out
