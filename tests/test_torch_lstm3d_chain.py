"""The lstm3d fusion chain trained for many steps against the JAX
package's, in float64 on the CPU.

One projected level of the lstm3d detector, the part no other fusion
mode shares: the per-view unprojection of a learnable feature map, the
GridFusion (ReLU, the ConvLSTM scanned over the views, a batch-statistics
BatchNorm, ReLU), the nearest-voxel reprojection and the 1x1 depth
collapse with its BatchNorm. Both sides start from the same variables and
take STEPS plain gradient steps on the same squared error, with the
BatchNorms in batch-statistics mode (TRAIN_BN) and their running
statistics committed after every step (flax's momentum 0.9). Every
step's loss stays within TOL of the JAX run's, and at the end every
parameter (the feature map included, so the unprojection's and the
reprojection's backwards are in the chain) and every running statistic,
relative to each tensor's magnitude. tests/test_torch_train.py
holds one step of the whole model; a whole-model run parts after a few
steps where ReLUs over all-padding head ROIs round apart.

The pose, focal length and samples are chosen off any half-voxel
boundary, so the nearest-voxel indices (computed in float32 by the port,
in float64 by JAX under x64) agree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mulit_view_object_detection_tpu.models import fusion as jfusion  # noqa: E402
from mulit_view_object_detection_tpu.ops.projection import (  # noqa: E402
    project_grid, unproject_features as jax_unproject, voxel_grid_points)
from mulit_view_object_detection_torch.kernels import reproject, unproject  # noqa: E402
from mulit_view_object_detection_torch.models import fusion  # noqa: E402
from mulit_view_object_detection_torch.models.resnet import BatchStats  # noqa: E402
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch)
from tests.test_projection import VoxCfg  # noqa: E402
from tests.test_torch_convert import random_like  # noqa: E402
from tests.test_torch_projection import _poses  # noqa: E402

STEPS = 30
LR = 0.05
# the port computes the unprojection's coordinates in float32 (the
# kernels' contract), JAX in float64 under x64: the bilinear weights
# differ by float32 rounding, ~2e-8 of the loss at every step (read:
# 5e-10 to 6e-8 over 12 steps, not growing)
TOL = 1e-6
B, V, C, FH = 1, 2, 6, 8          # feature maps 8x8 (a 64^2 image's P3)
IMAGE = (64, 64)


class _JaxChain(nn.Module):
    """The JAX detector's per-level lstm3d path (models/detector.py)."""

    @nn.compact
    def __call__(self, rcam, kmat, pts):
        cfg = VoxCfg()
        feats = self.param("feats", nn.initializers.normal(1.0),
                           (B, V, FH, FH, C), jnp.float64)
        grids = jax_unproject(feats, rcam, kmat, IMAGE, pts,
                              (cfg.nvox, cfg.nvox, cfg.nvox_z))
        fused = jfusion.GridFusion("lstm3d", C, V, train_bn=True,
                                   dtype=jnp.float64,
                                   name="grid_fusion")(grids)
        rays = project_grid(fused, kmat, IMAGE, FH, cfg.samples, cfg)
        return jfusion.DepthCollapse("lstm3d", C, cfg.samples, train_bn=True,
                                     dtype=jnp.float64,
                                     name="depth_collapse")(rays)


class _TorchChain(torch.nn.Module):
    """The port's (models/detector.py::_fuse_views for a per-view mode)."""

    def __init__(self):
        super().__init__()
        cfg = VoxCfg()
        self.feats = torch.nn.Parameter(torch.zeros(B, V, FH, FH, C,
                                                    dtype=torch.float64))
        self.grid_fusion = fusion.GridFusion(C, V, "lstm3d")
        self.depth_collapse = fusion.DepthCollapse(C, cfg.samples, "lstm3d")

    def forward(self, rcam, kmat, pts, stats):
        cfg = VoxCfg()
        vox = unproject.unproject_features(self.feats, rcam, kmat, IMAGE,
                                           pts, (cfg.nvox, cfg.nvox,
                                                 cfg.nvox_z))
        fused = self.grid_fusion(vox.permute(0, 1, 5, 2, 3, 4), stats)
        rays = reproject.project_grid_nearest(
            fused.permute(0, 2, 3, 4, 1).contiguous(), kmat, IMAGE, FH,
            cfg.samples, cfg)
        return self.depth_collapse(rays, stats).permute(0, 2, 3, 1)


def _to_torch(params, stats):
    """flax_to_torch of the chain's variables, the feature map beside."""
    params = dict(jax.device_get(params))
    feats = np.asarray(params.pop("feats"))
    out = flax_to_torch({"params": params,
                         "batch_stats": jax.device_get(stats)})
    out["feats"] = feats
    return out


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(1.0, float(np.abs(ref).max())))


def test_lstm3d_chain_trains_as_jax(monkeypatch):
    monkeypatch.setattr(unproject, "_check_device", lambda t, what: None)
    rng = np.random.RandomState(0)
    rcam = _poses(rng, B, V)
    kmat = np.array([[[61.3, 0.0, 31.7], [0.0, 60.9, 32.2],
                      [0.0, 0.0, 1.0]]], np.float32)
    pts = voxel_grid_points(VoxCfg())
    target = rng.randn(B, FH, FH, C)
    with jax.enable_x64(True):
        chain = _JaxChain()
        args = (jnp.asarray(rcam), jnp.asarray(kmat), jnp.asarray(pts))
        shapes = jax.eval_shape(lambda: chain.init(jax.random.PRNGKey(0),
                                                   *args))
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), random_like(shapes, 3))
        params, stats = variables["params"], variables["batch_stats"]

        def loss_fn(p, s):
            out, upd = chain.apply({"params": p, "batch_stats": s}, *args,
                                   mutable=["batch_stats"])
            return jnp.mean((out - target) ** 2), upd["batch_stats"]

        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        model = _TorchChain()
        model.load_state_dict(
            {k: torch.from_numpy(np.asarray(a)) for k, a in _to_torch(
                variables["params"], variables["batch_stats"]).items()},
            strict=True)
        model = model.double()
        t_args = (torch.from_numpy(rcam), torch.from_numpy(kmat),
                  torch.from_numpy(pts))
        t_target = torch.from_numpy(target)
        losses = []
        for i in range(STEPS):
            (ref_loss, stats), grads = step(params, stats)
            params = jax.tree_util.tree_map(lambda p, g: p - LR * g, params,
                                            grads)
            bn = BatchStats()
            model.zero_grad()
            loss = torch.mean((model(*t_args, bn) - t_target) ** 2)
            loss.backward()
            bn.commit()
            with torch.no_grad():
                for p in model.parameters():
                    p -= LR * p.grad
            losses.append(loss.item())
            assert losses[-1] == pytest.approx(float(ref_loss), rel=TOL), i
        ref = _to_torch(params, stats)
    got = model.state_dict()
    assert set(got) == set(ref)
    errs = {k: _rel(got[k].numpy(), ref[k]) for k in ref}
    assert max(errs.values()) < TOL, sorted(errs.items(),
                                            key=lambda e: -e[1])[:3]
    # the chain trained
    assert losses[-1] < 0.7 * losses[0]
