"""Standalone geometry sandbox — the runnable equivalent of the reference's
Notebook/projection.py ProjectionNet (unproject -> fuse -> reproject alone,
outside the detector), the port of examples/projection_playground.py.

  python -m mulit_view_object_detection_torch.examples.projection_playground \
      [--camera-anchored] [--device cpu]

Renders a 2-view synthetic scene, lifts the RGB images (as 3-channel
"features") into a 32^3 voxel grid through the per-view unprojection
kernel, mean-fuses, reprojects to the main view at several depths through
the reprojection kernel, and writes a contact sheet to
projection_playground.png in the working directory (with matplotlib where
it is installed, else with OpenCV). Three channels are not a whole number
of 16-byte groups, so both kernels run their scalar variants.
"""

import argparse
import importlib.util

import numpy as np
import torch

from ..config import Config
from ..data.synthetic import SyntheticScene
from ..kernels.reproject import project_grid_nearest
from ..kernels.unproject import unproject_features
from ..ops.projection import (camera_anchored_grid_points, pose_inverse,
                              voxel_grid_points)
from . import device as _device

OUTPUT = "projection_playground.png"


class GeoCfg(Config):
    NAME = "geo"
    NUM_VIEWS = 2
    IMAGE_MIN_DIM = 64
    IMAGE_MAX_DIM = 64
    nvox = 32
    nvox_z = 32
    vmin, vmax = -2.0, 2.0
    vmin_z, vmax_z = 1.0, 7.0
    samples = 6


def make_scene():
    """(images [2, 64, 64, 3] uint8, Rcam [1, 2, 3, 4], Kmat [1, 3, 3]) of
    the seeded 2-view scene."""
    scene = SyntheticScene(np.random.RandomState(0), num_objects=3,
                           num_views=2, image_size=64)
    images = np.stack([scene.render(v)[0] for v in range(2)])
    return (images, scene.poses[None].astype(np.float32),
            scene.K[None].astype(np.float32))


def lattice_points(cfg, rcam, camera_anchored):
    """Voxel centres [4, N] float32 in the main camera's frame: the fixed
    main-view lattice, or with `camera_anchored` the lattice centred
    GRID_DIST metres in front of the main camera (the reference's
    Notebook/projection.py:86-97 sandbox variant), taken from the world
    frame into the main camera's."""
    if not camera_anchored:
        return voxel_grid_points(cfg)
    pts_w = camera_anchored_grid_points(cfg, rcam)             # [1, 4, N]
    w2c0 = pose_inverse(torch.from_numpy(rcam[:, 0])).numpy()
    cam = np.einsum("bij,bjn->bin", w2c0, pts_w)[0]            # [3, N]
    return np.concatenate([cam, np.ones((1, cam.shape[-1]))],
                          axis=0).astype(np.float32)


def run_playground(cfg, camera_anchored, device="cuda"):
    """The pipeline on `device`: (images [2, 64, 64, 3] uint8, voxel grid
    [1, 2, nx, ny, nz, 3], fused grid [1, nx, ny, nz, 3], rays
    [1, samples, 64, 64, 3]), the tensors on `device`."""
    dev = _device(device)
    images, rcam, kmat = make_scene()
    feats = torch.from_numpy(images.astype(np.float32) / 255.0)[None]
    rcam_t, kmat_t = torch.from_numpy(rcam), torch.from_numpy(kmat)
    pts = torch.from_numpy(lattice_points(cfg, rcam, camera_anchored))
    vox = unproject_features(feats.to(dev), rcam_t.to(dev), kmat_t.to(dev),
                             (64, 64), pts.to(dev),
                             (cfg.nvox, cfg.nvox, cfg.nvox_z))
    fused = vox.mean(dim=1)                                    # mean fusion
    rays = project_grid_nearest(fused, kmat_t.to(dev), (64, 64), 64,
                                cfg.samples, cfg)
    return images, vox, fused, rays


def draw_contact_sheet(images, rays, samples):
    """The two views and each depth sample's rays [samples, 64, 64, 3] in
    a 2-row grid, written to OUTPUT in the working directory; matplotlib
    where it is installed, else OpenCV (a grid of tiles, each captioned).
    Returns the file's name."""
    cols = max(samples, 2) // 2 + 1
    tiles = [images[0], images[1]] + [
        (np.clip(rays[s], 0, 1) * 255).round().astype(np.uint8)
        for s in range(samples)]
    titles = ["view 0 (main)", "view 1"] + [
        f"reprojection depth {s}" for s in range(samples)]
    if importlib.util.find_spec("matplotlib") is not None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(2, cols, figsize=(14, 6))
        axes = axes.ravel()
        axes[0].imshow(images[0])
        axes[1].imshow(images[1])
        for s in range(samples):
            axes[2 + s].imshow(np.clip(rays[s], 0, 1))
        for ax, title in zip(axes, titles):
            ax.set_title(title)
        for ax in axes:
            ax.axis("off")
        fig.savefig(OUTPUT, bbox_inches="tight", dpi=80)
        plt.close(fig)
        return OUTPUT
    import cv2
    tile, cap = 3 * images.shape[1], 16     # tiles scaled 3x, a caption
    sheet = np.full((2 * (tile + cap), cols * tile, 3), 255, np.uint8)
    for i, (im, title) in enumerate(zip(tiles, titles)):
        y, x = (i // cols) * (tile + cap), (i % cols) * tile
        sheet[y + cap:y + cap + tile, x:x + tile] = cv2.resize(
            im, (tile, tile), interpolation=cv2.INTER_NEAREST)
        cv2.putText(sheet, title, (x + 2, y + 12), cv2.FONT_HERSHEY_SIMPLEX,
                    0.35, (0, 0, 0), 1)
    if not cv2.imwrite(OUTPUT, sheet[..., ::-1]):
        raise OSError(f"cv2 could not write {OUTPUT}")
    return OUTPUT


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--camera-anchored", action="store_true",
                    help="center the voxel lattice GRID_DIST meters in "
                         "front of the main camera (the reference's "
                         "Notebook/projection.py:86-97 sandbox variant) "
                         "instead of the fixed main-view-frame lattice")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    cfg = GeoCfg()
    images, _, _, rays = run_playground(cfg, args.camera_anchored,
                                        args.device)
    path = draw_contact_sheet(images, rays[0].cpu().numpy(), cfg.samples)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
