"""Export synthetic multi-view scenes as an on-disk InteriorNet HD7 tree.

The port's copy of the top-level `tools/export_synthetic_interiornet.py`:
the same scenes from the port's own `data/synthetic.py`, written with cv2
(`data/interiornet.py::write_png`) rather than imageio, and importing
nothing of the JAX package, so it runs where neither is installed. The
PNG bytes may differ from the tool's; the decoded pixels, the poses and
`view_mapping.json` are the same for the same seed.

It writes the layout the reference's InteriorNet pipeline reads
(samples/interior/interior_multi.py:83-328): cocolabel.json image
listings, cam0/data RGB frames, label0/data instance + NYU label pairs,
depth0/data uint16 depth in millimetres, cam0.render eye/lookat/up pose
rows and a per-subset view_mapping.json, so the command line
(cli/interior_multi.py train / evaluate) runs end to end without the
real data. At 640^2 the scenes use focal 600, so the hard-coded
INTERIORNET_K holds exactly.

    python -m mulit_view_object_detection_torch.cli.export_synthetic_interiornet \
        --root build/synthnet --train-scenes 8 --val-scenes 3

Pose round trip: rows store (eye, lookat = eye + z_axis, up_point =
eye - y_axis); utils.pose.vec2rot rebuilds the exact cam->world rotation
from them (x = normalize(z x (up - eye)) = normalize(z x -y) = x).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.classes import NYU40_CLASS_NAMES
from ..data.interiornet import write_png
from ..data.synthetic import SyntheticScene

# synthetic class id (1..3) -> NYU40 id; the three map to distinct
# selected classes (chair, table, sofa)
_SYNTH_TO_NYU = {
    1: NYU40_CLASS_NAMES.index("chair"),
    2: NYU40_CLASS_NAMES.index("table"),
    3: NYU40_CLASS_NAMES.index("sofa"),
}


def export_subset(root, subset, num_scenes, seed, image_size=640,
                  num_views=8, scene_mode="shapes", obj_px=(180.0, 380.0),
                  num_objects=3):
    """Write <root>/HD7/<subset>/...; returns the scene count."""
    rng = np.random.RandomState(seed)
    scenes = [SyntheticScene(rng, num_objects=num_objects,
                             num_views=num_views, image_size=image_size,
                             num_classes=4, focal=600.0,
                             obj_px_range=obj_px, scene_mode=scene_mode)
              for _ in range(num_scenes)]

    subset_dir = os.path.join(root, "HD7", subset)
    view_map = {}
    for si, scene in enumerate(scenes):
        name = f"SYN{seed}S{si:02d}_Room"
        scene_dir = os.path.join(subset_dir, name)
        images = []
        rows = ["# render poses (synthetic export)", "# eye lookat up",
                "#"]
        for f in range(num_views):
            img, masks, depth = scene.render(f)
            inst = np.zeros(img.shape[:2], np.uint8)
            nyu = np.ones(img.shape[:2], np.uint8)   # background: wall
            for oi in range(masks.shape[-1]):
                m = masks[:, :, oi]
                inst[m] = oi + 1
                nyu[m] = _SYNTH_TO_NYU[int(scene.class_ids[oi])]
            write_png(os.path.join(scene_dir, "cam0", "data", f"{f}.png"),
                      img)
            write_png(os.path.join(scene_dir, "label0", "data",
                                   f"{f}_instance.png"), inst)
            write_png(os.path.join(scene_dir, "label0", "data",
                                   f"{f}_nyu.png"), nyu)
            write_png(os.path.join(scene_dir, "depth0", "data", f"{f}.png"),
                      np.clip(depth * 1000.0, 0, 65535).astype(np.uint16))
            images.append({"file_name": f"cam0/data/{f}.png",
                           "timestamp": f, "width": img.shape[1],
                           "height": img.shape[0]})
            C, t = scene.poses[f][:, :3], scene.poses[f][:, 3]
            eye = t
            lookat = t + C[:, 2]
            up_pt = t - C[:, 1]
            rows.append(" ".join(
                [str(f)] + [f"{v:.9f}" for v in (*eye, *lookat, *up_pt)]))
        with open(os.path.join(scene_dir, "cam0.render"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
        with open(os.path.join(scene_dir, "cocolabel.json"), "w") as fh:
            json.dump({"images": images}, fh)
        uids = [f"{name}_id{f}" for f in range(num_views)]
        for i, uid in enumerate(uids):
            view_map[uid] = [u for j, u in enumerate(uids) if j != i]
    os.makedirs(subset_dir, exist_ok=True)
    with open(os.path.join(subset_dir, "view_mapping.json"), "w") as fh:
        json.dump(view_map, fh)
    return num_scenes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--train-scenes", type=int, default=8)
    ap.add_argument("--val-scenes", type=int, default=3)
    ap.add_argument("--image-size", type=int, default=640)
    ap.add_argument("--num-views", type=int, default=8)
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--scene-mode", default="shapes",
                    choices=["shapes", "hard"])
    ap.add_argument("--obj-px", default="180,380")
    args = ap.parse_args(argv)
    obj_px = tuple(float(x) for x in args.obj_px.split(","))
    n_tr = export_subset(args.root, "train", args.train_scenes, args.seed,
                         args.image_size, args.num_views, args.scene_mode,
                         obj_px)
    n_val = export_subset(args.root, "val", args.val_scenes,
                          args.seed + 500, args.image_size,
                          args.num_views, args.scene_mode, obj_px)
    print(json.dumps({"root": os.path.join(args.root, "HD7"),
                      "train_scenes": n_tr, "val_scenes": n_val,
                      "views_per_scene": args.num_views,
                      "image_size": args.image_size,
                      "scene_mode": args.scene_mode}))


if __name__ == "__main__":
    main()
