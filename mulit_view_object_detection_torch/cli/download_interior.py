"""InteriorNet HD7 scene downloader (samples/interior/download_interior.py).

The port's copy of the JAX package's `cli/download_interior.py`, with
its flags and its behaviour. The reference fetches scene zips from Google
Drive with gdown from a CSV manifest of (scene_id, drive_id) rows (train
500 / val 60 / test 60 scenes). The command reads the manifest, makes
`<out>/<subset>` and prints the plan; with `--dry-run` it stops there.
Otherwise it downloads each zip with gdown, unpacks it into the subset's
directory and removes the zip; without gdown it exits with a message.

    python -m mulit_view_object_detection_torch.cli.download_interior \
        --list hd7_train.csv --out InteriorNet/HD7 --subset train --dry-run
"""

from __future__ import annotations

import argparse
import csv
import os
import zipfile


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--list", required=True,
                        help="CSV manifest of (scene_id, drive_id) rows")
    parser.add_argument("--out", default="InteriorNet/HD7")
    parser.add_argument("--subset", default="train",
                        choices=["train", "val", "test"])
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    with open(args.list) as f:
        rows = [r for r in csv.reader(f) if r]
    if args.limit:
        rows = rows[:args.limit]
    out_dir = os.path.join(args.out, args.subset)
    os.makedirs(out_dir, exist_ok=True)
    print(f"{len(rows)} scenes -> {out_dir}")
    if args.dry_run:
        return
    try:
        import gdown  # noqa: PLC0415
    except ImportError:
        raise SystemExit(
            "gdown is not installed (and this environment has no network "
            "egress). Run this command on a machine with internet access.")
    for scene_id, drive_id in rows:
        zip_path = os.path.join(out_dir, f"{scene_id}.zip")
        gdown.download(id=drive_id, output=zip_path, quiet=False)
        with zipfile.ZipFile(zip_path) as z:
            z.extractall(out_dir)
        os.remove(zip_path)


if __name__ == "__main__":
    main()
