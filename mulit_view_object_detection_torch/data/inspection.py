"""Dataset statistics — the reference's Notebook/data_inspection.ipynb
(class-frequency counts written to instances_per_class_in_{subset}.txt)
as a library function and a CLI. A copy of
`mulit_view_object_detection_tpu/data/inspection.py` over the port's
InteriorNet loader (the port imports nothing of the JAX package).

  python -m mulit_view_object_detection_torch.data.inspection \
      --dataset /data/InteriorNet/HD7 --subset train
"""

from __future__ import annotations

import argparse
from collections import Counter


def instances_per_class(dataset, limit=None):
    """Count instances per class over a Dataset. Returns
    {class_name: count} ordered by class id."""
    counts = Counter()
    ids = dataset.image_ids[:limit] if limit else dataset.image_ids
    for image_id in ids:
        try:
            _, class_ids = dataset.load_mask(image_id)
        except Exception:  # noqa: BLE001 — skip unreadable images
            continue
        for c in class_ids:
            counts[int(c)] += 1
    return {dataset.class_names[c]: counts.get(c, 0)
            for c in range(dataset.num_classes)}


def write_report(stats, path):
    with open(path, "w") as f:
        for name, count in stats.items():
            f.write(f"{name}: {count}\n")


def main(argv=None):
    from .classes import NYU40_TO_SELECTED, SELECTED_CLASSES
    from .interiornet import InteriorNetDataset

    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--subset", default="train")
    parser.add_argument("--limit", type=int, default=0)
    args = parser.parse_args(argv)

    ds = InteriorNetDataset()
    ds.load_interiornet(args.dataset, args.subset, NYU40_TO_SELECTED,
                        SELECTED_CLASSES)
    ds.prepare()
    stats = instances_per_class(ds, limit=args.limit or None)
    out = f"instances_per_class_in_{args.subset}.txt"
    write_report(stats, out)
    for name, count in stats.items():
        print(f"{name:20} {count}")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
