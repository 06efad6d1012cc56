"""Synthetic multi-view scenes for tests and benchmarks.

A numpy copy of `mulit_view_object_detection_tpu/data/synthetic.py`, not an
import of it: the port imports nothing of the JAX package, not even
a module that imports no jax itself, so it runs where jax is absent.

The reference has no test assets (SURVEY.md §4); this module provides
fixed-seed procedurally generated scenes: colored 3D billboards at known
positions, rendered into V views with known camera poses/intrinsics via
true pinhole projection — so the projective geometry ops see real,
consistent multi-view data and end-to-end smoke training has learnable
signal.
"""

from __future__ import annotations

import numpy as np

from ..utils.pose import look_at_extrinsics
from .dataset import Dataset

_COLORS = np.array([
    [200, 60, 60], [60, 200, 60], [60, 60, 200], [200, 200, 60],
    [200, 60, 200], [60, 200, 200],
], dtype=np.uint8)

# Class-coded silhouettes ("shapes"/"hard" scene modes): colors are drawn
# INDEPENDENTLY of class (as in legacy scenes), so the only class cue is
# shape — classification requires geometry/context, and held-out-SCENE
# evaluation is learnable in principle (in legacy scenes class identity
# is visually arbitrary, so cross-scene class generalization is
# impossible by construction; see VERDICT r4 #2).
_SHAPES = ("rect", "disk", "tri", "ring", "diamond", "cross")


def _shape_stencil(shape, h, w):
    """Boolean [h, w] silhouette of `shape` filling the box."""
    yy, xx = np.mgrid[0:h, 0:w]
    ny = (yy + 0.5) / h * 2.0 - 1.0
    nx = (xx + 0.5) / w * 2.0 - 1.0
    if shape == "rect":
        return np.ones((h, w), bool)
    if shape == "disk":
        return nx * nx + ny * ny <= 1.0
    if shape == "tri":  # apex top-center, base at the bottom
        return ny >= 2.0 * np.abs(nx) - 1.0
    if shape == "ring":
        return ~((np.abs(nx) < 0.55) & (np.abs(ny) < 0.55))
    if shape == "diamond":
        return np.abs(nx) + np.abs(ny) <= 1.0
    if shape == "cross":
        return (np.abs(nx) <= 0.34) | (np.abs(ny) <= 0.34)
    raise ValueError(shape)


class SyntheticScene:
    """A set of 3D billboards + V cameras around the origin-ish."""

    def __init__(self, rng, num_objects=3, num_views=2, image_size=64,
                 num_classes=4, focal=None, obj_px_range=None,
                 scene_mode="legacy"):
        """scene_mode:
          "legacy" — flat background, full-rectangle billboards, masks
            cover the full extent even when occluded (bit-identical to
            earlier rounds; same-seed checkpoint compatibility).
          "shapes" — class-coded silhouettes (_SHAPES) + VISIBILITY
            masks (occluded pixels removed, fully hidden objects
            dropped); same placement draws as legacy.
          "hard"   — shapes + textured 3D-consistent back wall +
            striped distractor billboards (no GT) + forced partial
            occluders + class assignment resampled so same-class
            visible boxes stay NMS-compatible (protocol ceiling 1.0).
        """
        self.image_size = image_size
        self.num_classes = num_classes
        self.mode = scene_mode
        f = focal or image_size
        c = image_size / 2.0
        self.K = np.array([[f, 0, c], [0, f, c], [0, 0, 1]], np.float64)
        # objects in the MAIN camera's viewing volume: x,y in [-1,1], z in [3,6]
        if obj_px_range is None:
            # legacy draw ORDER preserved (x, y, z, half): same-seed scenes
            # must stay identical to earlier rounds' runs/checkpoints
            cx = rng.uniform(-1.0, 1.0, num_objects)
            cy = rng.uniform(-1.0, 1.0, num_objects)
            z = rng.uniform(3.0, 6.0, num_objects)
            half = rng.uniform(0.3, 0.6, num_objects)
        else:
            z = rng.uniform(3.0, 6.0, num_objects)
            # Target an on-screen size in PIXELS so the scene exercises a
            # chosen ROI-routing regime (ops/roi_align.py::roi_levels):
            # Mask R-CNN routes a box of side s px to P4 iff s >~ 224/sqrt(2)
            # and to P5 iff s >~ 224*sqrt(2) at 640^2.  The flagship protocol
            # zeroes the fused P2/P3 maps (Config.ZERO_PG_LEVELS, matching
            # model_multi.py's memory cap), so quality runs at the
            # reference's 640^2 geometry need P4/P5-scale objects — exactly
            # the furniture-scale content of InteriorNet itself.
            lo, hi = obj_px_range
            px = rng.uniform(lo, hi, num_objects)
            half = px * z / (2.0 * f)           # size_px = 2*half*f/z
            # keep centers fully in frame (half-frame at depth z is c*z/f)
            # AND inside the voxel volume (|x|,|y| <= ~2, see train_to_ap's
            # vmin/vmax) so the fusion grid actually covers the objects
            m = np.clip(np.minimum((c / f) * z - half, 2.0 - half),
                        0.05, None)
            cx = rng.uniform(-1.0, 1.0, num_objects) * m
            cy = rng.uniform(-1.0, 1.0, num_objects) * m
        self.centers = np.stack([cx, cy, z], axis=1)
        self.half_sizes = half
        self.class_ids = rng.randint(1, num_classes, num_objects)
        self.colors = _COLORS[rng.randint(0, len(_COLORS), num_objects)]

        if scene_mode == "hard":
            # Forced partial occluders: objects 3.. sit in FRONT of
            # objects 0.. at nearly the same (x, y), so the main view
            # sees them overlapped while jittered support views see
            # around the occluder — the content multi-view fusion is for
            # (model_multi.py:130-228's rationale).
            n_occ = min(max(num_objects - 3, 0), 2)
            for k in range(n_occ):
                j, i = 3 + k, k
                zn = max(2.0, self.centers[i, 2] - rng.uniform(1.2, 2.2))
                off = rng.uniform(-0.25, 0.25, 2)
                self.centers[j, :2] = self.centers[i, :2] + off
                self.centers[j, 2] = zn
                if obj_px_range is not None:
                    px = rng.uniform(*obj_px_range)
                    self.half_sizes[j] = px * zn / (2.0 * f)
                else:
                    self.half_sizes[j] = self.half_sizes[i] * \
                        rng.uniform(0.6, 0.9)
            # NMS-compatible class layout: per-class detection NMS caps
            # recall when same-class GT boxes overlap (ops/detection.py);
            # resample class ids until analytic main-view boxes of
            # same-class pairs stay under IoU 0.25 — the hard set's
            # protocol ceiling is 1.0 BY CONSTRUCTION, so scores are
            # not ceiling-clamped (VERDICT r4 weak: saturated harness).
            def _main_boxes():
                zs = self.centers[:, 2]
                u0 = f * (self.centers[:, 0] - self.half_sizes) / zs + c
                u1 = f * (self.centers[:, 0] + self.half_sizes) / zs + c
                v0 = f * (self.centers[:, 1] - self.half_sizes) / zs + c
                v1 = f * (self.centers[:, 1] + self.half_sizes) / zs + c
                return np.stack([v0, u0, v1, u1], 1)

            def _worst_pair():
                b = _main_boxes()
                worst = None
                for i in range(num_objects):
                    for j in range(i + 1, num_objects):
                        if self.class_ids[i] != self.class_ids[j]:
                            continue
                        yy0 = max(b[i, 0], b[j, 0])
                        xx0 = max(b[i, 1], b[j, 1])
                        yy1 = min(b[i, 2], b[j, 2])
                        xx1 = min(b[i, 3], b[j, 3])
                        inter = max(0, yy1 - yy0) * max(0, xx1 - xx0)
                        a_i = (b[i, 2] - b[i, 0]) * (b[i, 3] - b[i, 1])
                        a_j = (b[j, 2] - b[j, 0]) * (b[j, 3] - b[j, 1])
                        iou = inter / max(a_i + a_j - inter, 1e-6)
                        if iou > 0.25 and (worst is None or iou > worst[0]):
                            worst = (iou, j)
                return worst

            for _ in range(40):
                w = _worst_pair()
                if w is None:
                    break
                self.class_ids[w[1]] = rng.randint(1, num_classes)

            # Striped distractor billboards: clutter with NO ground
            # truth. Deliberately distinct from class silhouettes
            # (stripes) so "ignore them" is learnable.
            nd = 4
            dz = rng.uniform(2.5, 6.5, nd)
            dm = np.clip((c / f) * dz, 0.2, 2.0)
            self.distractors = {
                "centers": np.stack([rng.uniform(-1, 1, nd) * dm,
                                     rng.uniform(-1, 1, nd) * dm,
                                     dz], 1),
                "half": rng.uniform(0.15, 0.35, nd),
                "colors": _COLORS[rng.randint(0, len(_COLORS), (nd, 2))],
            }
            # 3D-consistent textured back wall (world plane z = zwall):
            # two low-frequency sinusoids over WORLD (x, y), so every
            # view sees the same texture from its own pose.
            self.wall = {
                "z": 8.5,
                "freq": rng.uniform(2.0, 5.0, 2),
                "phase": rng.uniform(0, 2 * np.pi, 2),
                "colors": _COLORS[rng.randint(0, len(_COLORS), 2)],
            }
        else:
            self.distractors = None
            self.wall = None

        # cameras: view 0 at origin looking +z; others jittered around it
        self.poses = []  # cam->world [3, 4]
        for vi in range(num_views):
            if vi == 0:
                eye = np.zeros(3)
            else:
                eye = rng.uniform(-0.6, 0.6, 3) * np.array([1, 1, 0.3])
            w2c = look_at_extrinsics(eye, np.array([0.0, 0.0, 4.5]))
            R = w2c[:, :3]
            t = w2c[:, 3]
            # invert world->cam to cam->world
            pose = np.concatenate([R.T, (-R.T @ t)[:, None]], axis=1)
            self.poses.append(pose)
        self.poses = np.stack(self.poses)  # [V, 3, 4]

    def regenerate_poses(self, rng, jitter_main=True):
        """Replace ALL camera poses with fresh draws from `rng`, keeping
        the scene content (objects, classes, colors) identical. Used for
        held-out-VIEWPOINT evaluation (VERDICT r4 #1): the model trains
        on this scene's original cameras and is evaluated on novel ones.
        The main view is jittered too (smaller radius, so the scene stays
        framed) — GT is re-rendered from the new main view, so it remains
        exact. Clears the render memo."""
        poses = []
        for vi in range(len(self.poses)):
            if vi == 0 and not jitter_main:
                eye = np.zeros(3)
            elif vi == 0:
                eye = rng.uniform(-0.3, 0.3, 3) * np.array([1, 1, 0.3])
            else:
                eye = rng.uniform(-0.6, 0.6, 3) * np.array([1, 1, 0.3])
            w2c = look_at_extrinsics(eye, np.array([0.0, 0.0, 4.5]))
            R, t = w2c[:, :3], w2c[:, 3]
            poses.append(
                np.concatenate([R.T, (-R.T @ t)[:, None]], axis=1))
        self.poses = np.stack(poses)
        self._render_cache = {}

    def render(self, view):
        """Render view -> (image uint8 [S,S,3], masks [S,S,N], depth [S,S]).

        Scenes are static, so renders are memoized per view — load_image /
        load_mask / load_depth each hit this and would otherwise re-render
        the same frame three times per sample."""
        cached = getattr(self, "_render_cache", None)
        if cached is None:
            cached = self._render_cache = {}
        if view not in cached:
            cached[view] = (self._render(view) if self.mode == "legacy"
                            else self._render_v2(view))
        return cached[view]

    def _render(self, view):
        s = self.image_size
        image = np.full((s, s, 3), 30, np.uint8)
        masks = np.zeros((s, s, len(self.centers)), bool)
        depth = np.full((s, s), 50.0, np.float32)
        pose = self.poses[view]
        R, t = pose[:, :3], pose[:, 3]
        # world->cam
        Rw, tw = R.T, -R.T @ t
        order = np.argsort(-self.centers[:, 2])  # far to near
        for oi in order:
            cpos = Rw @ self.centers[oi] + tw
            if cpos[2] <= 0.1:
                continue
            r = self.half_sizes[oi]
            # billboard corners facing the camera
            u0 = self.K @ (cpos + np.array([-r, -r, 0.0]))
            u1 = self.K @ (cpos + np.array([r, r, 0.0]))
            x0, y0 = int(round(u0[0] / u0[2])), int(round(u0[1] / u0[2]))
            x1, y1 = int(round(u1[0] / u1[2])), int(round(u1[1] / u1[2]))
            x0, x1 = sorted((x0, x1))
            y0, y1 = sorted((y0, y1))
            x0c, x1c = max(0, x0), min(s, x1)
            y0c, y1c = max(0, y0), min(s, y1)
            if x1c <= x0c or y1c <= y0c:
                continue
            image[y0c:y1c, x0c:x1c] = self.colors[oi]
            masks[:, :, oi] = False
            masks[y0c:y1c, x0c:x1c, oi] = True
            depth[y0c:y1c, x0c:x1c] = cpos[2]
        return image, masks, depth

    def _render_v2(self, view):
        """"shapes"/"hard" renderer: class-coded silhouettes, painter's
        algorithm far->near over constant-depth billboards (exact),
        VISIBILITY masks (a nearer element erases farther masks where it
        covers them), and in hard mode a textured back wall + striped
        distractor billboards."""
        s = self.image_size
        image = np.full((s, s, 3), 30, np.uint8)
        masks = np.zeros((s, s, len(self.centers)), bool)
        depth = np.full((s, s), 50.0, np.float32)
        pose = self.poses[view]
        R, t = pose[:, :3], pose[:, 3]
        Rw, tw = R.T, -R.T @ t

        if self.wall is not None:
            # per-pixel rays o + u * (R @ K^-1 [px, py, 1]); intersect the
            # world plane z = zwall; texture from WORLD (x, y) ->
            # 3D-consistent across views. Camera-frame depth of the hit
            # point is exactly u (dirs_cam z-component is 1).
            yy, xx = np.mgrid[0:s, 0:s]
            pix = np.stack([xx + 0.5, yy + 0.5, np.ones_like(xx)], -1)
            dirs_cam = pix @ np.linalg.inv(self.K).T
            dirs_w = dirs_cam @ R.T
            dz = dirs_w[..., 2]
            hit = dz > 1e-6
            u = np.where(hit, (self.wall["z"] - t[2]) / np.where(
                hit, dz, 1.0), np.inf)
            wx = t[0] + u * dirs_w[..., 0]
            wy = t[1] + u * dirs_w[..., 1]
            fx, fy = self.wall["freq"]
            p1, p2 = self.wall["phase"]
            v = (0.5 + 0.25 * np.sin(fx * wx + p1)
                 + 0.25 * np.sin(fy * wy + p2))[..., None]
            cA = self.wall["colors"][0].astype(np.float32)
            cB = self.wall["colors"][1].astype(np.float32)
            tex = np.clip(cA * v + cB * (1 - v), 0, 255).astype(np.uint8)
            image = np.where(hit[..., None], tex, image)
            depth = np.where(hit, u, depth).astype(np.float32)

        # merged element list: (cam_z, kind, index) painted far -> near
        elems = []
        for oi, center in enumerate(self.centers):
            cz = (Rw @ center + tw)[2]
            elems.append((cz, "obj", oi))
        if self.distractors is not None:
            for di, center in enumerate(self.distractors["centers"]):
                cz = (Rw @ center + tw)[2]
                elems.append((cz, "dis", di))
        for cz, kind, idx in sorted(elems, key=lambda e: -e[0]):
            if cz <= 0.1:
                continue
            if kind == "obj":
                center = self.centers[idx]
                r = self.half_sizes[idx]
            else:
                center = self.distractors["centers"][idx]
                r = self.distractors["half"][idx]
            cpos = Rw @ center + tw
            u0 = self.K @ (cpos + np.array([-r, -r, 0.0]))
            u1 = self.K @ (cpos + np.array([r, r, 0.0]))
            x0, y0 = int(round(u0[0] / u0[2])), int(round(u0[1] / u0[2]))
            x1, y1 = int(round(u1[0] / u1[2])), int(round(u1[1] / u1[2]))
            x0, x1 = sorted((x0, x1))
            y0, y1 = sorted((y0, y1))
            if x1 <= x0 or y1 <= y0:
                continue
            x0c, x1c = max(0, x0), min(s, x1)
            y0c, y1c = max(0, y0), min(s, y1)
            if x1c <= x0c or y1c <= y0c:
                continue
            if kind == "obj":
                shape = _SHAPES[(self.class_ids[idx] - 1) % len(_SHAPES)]
                sten = _shape_stencil(shape, y1 - y0, x1 - x0)
            else:  # striped distractor
                w = x1 - x0
                xxd = np.arange(w)
                stripe = (xxd // max(1, w // 6)) % 2 == 0
                sten = np.broadcast_to(stripe, (y1 - y0, w)).copy()
                sten_all = np.ones((y1 - y0, w), bool)
            win = np.zeros((s, s), bool)
            win[y0c:y1c, x0c:x1c] = sten[y0c - y0:y1c - y0,
                                         x0c - x0:x1c - x0]
            if kind == "obj":
                image[win] = self.colors[idx]
                depth[win] = cpos[2]
                masks[win] = False         # visibility: erase occluded
                masks[win, idx] = True
            else:
                # both stripe phases occlude (it is a solid billboard);
                # stripes only differ in color
                winall = np.zeros((s, s), bool)
                winall[y0c:y1c, x0c:x1c] = sten_all[y0c - y0:y1c - y0,
                                                    x0c - x0:x1c - x0]
                cA, cB = self.distractors["colors"][idx]
                image[winall] = cB
                image[win] = cA
                depth[winall] = cpos[2]
                masks[winall] = False
        return image, masks, depth


class SyntheticMultiViewDataset(Dataset):
    """Dataset-API wrapper over SyntheticScene (supports load_R/load_depth/
    load_view/view_map like InteriorNetDataset)."""

    def __init__(self, num_scenes=4, num_views=3, image_size=64,
                 num_classes=4, seed=0, obj_px_range=None, view_seed=None,
                 scene_mode="legacy", num_objects=3):
        """`view_seed`: if given, every scene's cameras are REPLACED with
        fresh poses drawn from RandomState(view_seed + scene_index) after
        construction — same scenes, unseen viewpoints (held-out-viewpoint
        eval). Scene content draws are untouched, so a dataset built with
        the same `seed` has bit-identical objects with or without it."""
        super().__init__()
        self.scenes = []
        self.K = None
        rng = np.random.RandomState(seed)
        for i in range(1, num_classes):
            self.add_class("synthetic", i, f"class{i}")
        self.view_map = {}
        for si in range(num_scenes):
            scene = SyntheticScene(rng, num_objects=num_objects,
                                   num_views=num_views,
                                   image_size=image_size,
                                   num_classes=num_classes,
                                   obj_px_range=obj_px_range,
                                   scene_mode=scene_mode)
            if view_seed is not None:
                scene.regenerate_poses(
                    np.random.RandomState(view_seed + si))
            self.K = scene.K
            self.scenes.append(scene)
            ids = []
            for vi in range(num_views):
                uid = f"s{si}_v{vi}"
                self.add_image("synthetic", image_id=uid, path=uid,
                               scene=si, view=vi)
                ids.append(uid)
            self.view_map[ids[0]] = ids[1:]
        self.prepare()

    def _scene_view(self, image_id):
        info = self.image_info[image_id]
        return self.scenes[info["scene"]], info["view"]

    def load_image(self, image_id):
        scene, view = self._scene_view(image_id)
        return scene.render(view)[0]

    def load_mask(self, image_id):
        scene, view = self._scene_view(image_id)
        _, masks, _ = scene.render(view)
        if scene.mode == "legacy":
            keep = masks.any(axis=(0, 1))
        else:
            # visibility masks: drop near-fully-occluded slivers (a
            # 1-px GT is unmatchable and would penalize AP for a
            # protocol reason, not a model one). Threshold scales with
            # image area (8 px at 64^2).
            minpx = (scene.image_size / 64.0) ** 2 * 8.0
            keep = masks.sum(axis=(0, 1)) >= minpx
        return masks[:, :, keep], scene.class_ids[keep].astype(np.int32)

    def load_depth(self, image_id, config):
        from .molding import resize_image
        scene, view = self._scene_view(image_id)
        depth = scene.render(view)[2][:, :, None]
        # depth rides at P5 resolution (see data.generator.make_sample)
        ds = int(config.IMAGE_SHAPE[0]) // config.BACKBONE_STRIDES[3]
        depth, *_ = resize_image(depth, min_dim=ds, max_dim=ds,
                                 mode="square")
        return depth[:, :, 0]

    def load_R(self, image_id):
        scene, view = self._scene_view(image_id)
        return scene.poses[view].astype(np.float32)

    def load_view(self, n, main_image, rnd_state=None):
        ids = [main_image] + list(self.view_map[main_image])[:n - 1]
        return [self.image_from_source_map["synthetic." + i] for i in ids]
