"""Offline view-graph builder CLI.

The reference ships three one-off scripts run before training
(README.md:54): view_mapping.py (HD7 probe-grid co-visibility),
view_mapping_seq.py (HD1 sliding window), instance_mapping.py. This CLI
covers all three against an InteriorNet directory tree. The port of
`mulit_view_object_detection_tpu/cli/build_view_mappings.py`, over the
port's loader.

  python -m mulit_view_object_detection_torch.cli.build_view_mappings \
      --dataset /data/InteriorNet/HD7 --subset train [--seq] [--instances]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.interiornet import INTERIORNET_K, InteriorNetDataset
from ..data.view_mapping import (build_instance_mapping, build_view_mapping,
                                 build_view_mapping_seq, save_json)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--subset", default="train")
    parser.add_argument("--seq", action="store_true",
                        help="sequential (HD1) sliding-window mapping")
    parser.add_argument("--instances", action="store_true",
                        help="also build instance_mapping.json")
    parser.add_argument("--view-range", type=int, default=20)
    parser.add_argument("--grid-dist", type=float, default=6.0)
    parser.add_argument("--threshold", type=float, default=0.2)
    args = parser.parse_args(argv)

    ds = InteriorNetDataset()
    ds.load_interiornet(args.dataset, args.subset)
    ds.prepare()

    subset_dir = os.path.join(args.dataset, args.subset)
    by_scene = {}
    for info in ds.image_info:
        by_scene.setdefault(info["subfolder"], []).append(info)

    if args.seq:
        mapping = {}
        for scene, infos in by_scene.items():
            frames = [i["id"] for i in sorted(
                infos, key=lambda x: int(x["image_sub_id"]))]
            mapping.update(build_view_mapping_seq(frames,
                                                  args.view_range))
        out = os.path.join(subset_dir, "view_mapping_seq.json")
    else:
        mapping = {}
        for scene, infos in by_scene.items():
            poses = {i["id"]: np.asarray(i["R"]) for i in infos}
            h = infos[0].get("height", 480)
            w = infos[0].get("width", 640)
            mapping.update(build_view_mapping(
                poses, INTERIORNET_K, (h, w), grid_dist=args.grid_dist,
                threshold=args.threshold))
        out = os.path.join(subset_dir, "view_mapping.json")
    save_json(mapping, out)
    print(f"wrote {out} ({len(mapping)} entries)")

    if args.instances:
        frames_to_instances = {}
        for info in ds.image_info:
            image_id = ds.image_from_source_map["interior." + info["id"]]
            try:
                masks, class_ids = ds.load_mask(image_id)
            except Exception:
                continue
            frames_to_instances[info["id"]] = [
                (f"{info['subfolder']}_{k}", int(c))
                for k, c in enumerate(class_ids)]
        imap = build_instance_mapping(frames_to_instances)
        out = os.path.join(subset_dir, "instance_mapping.json")
        save_json(imap, out)
        print(f"wrote {out} ({len(imap)} instances)")


if __name__ == "__main__":
    main()
