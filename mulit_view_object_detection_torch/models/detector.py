"""Multi-view Mask R-CNN, inference and training.

Port of `mulit_view_object_detection_tpu/models/detector.py`. One module
covers the variants the port runs, switched by config:

  NUM_VIEWS == 1   -> stock single-view Mask R-CNN
  TRANSFORMER      -> the views' P5 tokens, lifted to world xyz by their
                      depths, fused by a transformer and added to the main
                      view's P5; every other level zeroed (or the main
                      view's, with XFORMER_KEEP_MAIN_LEVELS). The FPN has
                      no post-P ReLU here (detector.py:110-117).
  VANILLA          -> the main view's features, P2/P3 zeroed
  otherwise        -> projected path: per level P4, P5, P6 a CUDA
                      unprojection kernel lifts every view into a voxel
                      grid (conv3d, ident: the fused kernel, views
                      concatenated on channels and relu'd; add, mean,
                      lstm3d: the per-view kernel), GridFusion fuses it,
                      the CUDA reprojection kernel samples it along the
                      main view's rays and DepthCollapse folds the
                      samples; P2/P3 are zeroed and never computed.

Views fold into the batch axis for backbone/FPN; the RPN on a zeroed
level is evaluated on a 1x1 zero tile and tiled (exact: a conv stack on
an all-zero input is spatially constant). On a mesh with sharded views
(`parallel/mesh.py`) the images hold this rank's block of the views:
the backbone and the FPN run on them, and the levels the fusion reads
are gathered over the view group (`models/layers.py::gather`) before
it, so that everything after runs on every view as one process runs
it. The levels are gathered, not the voxel grids: a view's P4-P6 at the
flagship are about 90x fewer bytes than its three unprojected grids,
and the unprojection done again on every view rank is cheap.

The dtype policy is flax's:
every parameter is float32, and under COMPUTE_DTYPE "bfloat16" the
convolutions cast their weights and inputs to bf16 at use
(`models/layers.py`), so activations are bf16; BatchNorm normalises in
float32, and geometry, scores, boxes and losses stay float32. Under
"float32" the model computes in float32 on the card as well: its forward
(and, in `train/step.py`, its backward) runs with cuDNN's and cuBLAS's
TF32 off (`float32_arithmetic`), which the H100 would otherwise use for
float32 convolutions.

`forward(batch, training=True)` is the training graph of the JAX module
(detector.py:166-241): proposals at POST_NMS_ROIS_TRAINING with their
gradient stopped, then `ops/targets.py::detection_targets_batch` samples
the head ROIs with the priorities the batch carries, and both heads run
on them. Gradients flow through the two geometry gathers into the
backward kernels (or, on the CPU, their plain versions). The
transformer's dropout draws its masks from the torch.Generator the batch
carries as "dropout_generator" (train/step.py::draw_priorities puts it
there); inference is deterministic.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn

from ..config import check_supported
from ..kernels.reproject import project_grid_nearest
from ..kernels.unproject import unproject_features, unproject_features_fused
from ..ops.anchors import get_anchors
from ..ops.boxes import norm_boxes
from ..ops.detection import refine_detections
from ..ops.image_meta import parse_image_meta
from ..ops.projection import (project_grid_trilinear, unproject_rays,
                              voxel_grid_points)
from ..ops.proposals import generate_proposals
from ..ops.roi_align import pyramid_roi_align
from ..ops.targets import detection_targets_batch
from .fpn import FPN
from .fusion import DepthCollapse, GridFusion
from .heads import ClassifierHead, MaskHead
from .layers import DenseGeneral, gather, set_compute_dtype
from .resnet import BatchNorm, BatchStats, ResNet, checkpointed
from .rpn import RPNHead
from .transformer import LayerNorm, ViewFusionTransformer

_INIT_LAYERS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d,
                nn.Linear, DenseGeneral)
# fusion modes that read one grid per view (the per-view unprojection
# kernel); conv3d and ident read the fused kernel's view-concatenated grid
PER_VIEW_FUSIONS = ("add", "mean", "lstm3d")
# the modules before the views' gather: on a mesh with sharded views their
# gradients and batch statistics are summed over the data x view group
UPSTREAM = ("backbone", "fpn")


def view_group_of(mesh, views, num_views):
    """The group over which a batch holding `views` of the model's
    `num_views` views is gathered: the view group of `mesh`
    (`parallel/mesh.py::Mesh`) when the views are sharded over it, None
    when the batch holds every view. Any other count raises."""
    if views == num_views:
        return None
    n = 1 if mesh is None else mesh.size("view")
    if n > 1 and views * n == num_views:
        return mesh.view_group
    raise ValueError(f"images carry {views} views: not the config's "
                     f"{num_views}, nor a 1/{n} shard of them")


@contextlib.contextmanager
def float32_arithmetic(model):
    """While inside, a model of COMPUTE_DTYPE "float32" computes float32
    convolutions and matmuls in float32 on the card: cuDNN's and cuBLAS's
    TF32 are off, and restored on exit. Nothing changes for a bfloat16
    model, or for an object that is not a MaskRCNN."""
    if getattr(model, "compute_dtype", None) is not torch.float32:
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class MaskRCNN(nn.Module):
    def __init__(self, config):
        super().__init__()
        check_supported(config)
        cfg = self.config = config
        self.compute_dtype = (torch.bfloat16
                              if cfg.COMPUTE_DTYPE == "bfloat16"
                              else torch.float32)
        c = cfg.TOP_DOWN_PYRAMID_SIZE
        self.multiview = cfg.NUM_VIEWS > 1
        self.transformer = bool(cfg.TRANSFORMER)
        self.projected = (self.multiview and not cfg.VANILLA
                          and not self.transformer)
        if self.transformer:
            # every level but the fused P5 is zeroed (model_transformer.py:
            # 2419-2438), unless the main view's features are kept
            self.zero_levels = (set() if cfg.XFORMER_KEEP_MAIN_LEVELS
                                else {0, 1, 2, 4})
        elif self.multiview:
            self.zero_levels = set(getattr(cfg, "ZERO_PG_LEVELS", (0, 1)))
        else:
            self.zero_levels = set()
        self.backbone = ResNet(cfg.BACKBONE,
                               getattr(cfg, "RESNET50_STAGE4_BLOCKS", None))
        self.fpn = FPN(c, post_relu=self.multiview and not self.transformer)
        if self.transformer:
            # P5 is ceil(image / 32) square; one token per view and pixel
            s5 = -(-int(cfg.IMAGE_SHAPE[0]) // cfg.BACKBONE_STRIDES[3])
            self.view_transformer = ViewFusionTransformer(
                cfg.XFORMER_NUM_LAYERS, cfg.XFORMER_D_MODEL,
                cfg.XFORMER_NUM_HEADS, cfg.XFORMER_DFF, s5,
                cfg.NUM_VIEWS * cfg.samples * s5 * s5, cfg.XFORMER_DROPOUT,
                faithful_output=bool(cfg.XFORMER_FAITHFUL_PAIRING))
        if self.projected:
            # separate fusion/collapse weights per active level
            # (model_multi.py:394-463)
            for li in range(5):
                if li not in self.zero_levels:
                    self.add_module(f"grid_fusion_p{li + 2}", GridFusion(
                        c, cfg.NUM_VIEWS, cfg.GRID_REAS))
                    self.add_module(f"depth_collapse_p{li + 2}",
                                    DepthCollapse(c, cfg.samples,
                                                  cfg.GRID_REAS))
        self.rpn = RPNHead(c, len(cfg.RPN_ANCHOR_RATIOS),
                           cfg.RPN_ANCHOR_STRIDE)
        self.classifier_head = ClassifierHead(
            c, cfg.NUM_CLASSES, cfg.POOL_SIZE, cfg.FPN_CLASSIF_FC_LAYERS_SIZE)
        # the multi-view fork narrows the mask convs (model_multi.py:1412)
        self.mask_head = MaskHead(c, cfg.NUM_CLASSES,
                                  128 if self.multiview else 256)
        self._grid_pts = {}
        self._mean = {}
        set_compute_dtype(self, self.compute_dtype)

    @torch.no_grad()
    def init_weights(self, generator):
        """flax's default initialisation, drawn on the CPU from
        `generator` so every device gets the same weights: lecun-normal
        kernels (truncated at 2 std), zero biases, identity BatchNorms
        and LayerNorms; with XFORMER_ZERO_INIT a zero token projection."""
        for mod in self.modules():
            if isinstance(mod, _INIT_LAYERS):
                w = mod.weight
                transposed = isinstance(mod, (nn.ConvTranspose2d,
                                              nn.ConvTranspose3d))
                if isinstance(mod, DenseGeneral):
                    fan_in = mod.fan_in
                elif transposed:
                    fan_in = w.shape[0] * math.prod(w.shape[2:])
                else:
                    fan_in = w[0].numel()
                std = (1.0 / fan_in) ** 0.5 / .87962566103423978
                t = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                w.copy_(t)
                mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        if self.transformer and self.config.XFORMER_ZERO_INIT:
            self.view_transformer.token_proj.weight.zero_()

    def _mean_pixel(self, device):
        if device not in self._mean:
            self._mean[device] = torch.as_tensor(
                np.asarray(self.config.MEAN_PIXEL, np.float32), device=device)
        return self._mean[device]

    def _grid_points(self, device):
        if device not in self._grid_pts:
            self._grid_pts[device] = torch.from_numpy(
                voxel_grid_points(self.config)).to(device)
        return self._grid_pts[device]

    def forward(self, batch, training=False, stats=None, mesh=None):
        """batch: images [B, V, H, W, 3] molded float, or resized uint8
        pixels (UINT8_IMAGE_TRANSFER), de-molded here; image_meta
        [B, META]; anchors [A, 4] normalized; Rcam [B, V, 3, 4] and Kmat
        [B, 3, 3] float32 (multi-view); depths [B, V, h5, w5] float32 at
        P5's resolution (TRANSFORMER). Training adds gt_class_ids [B, G],
        gt_boxes [B, G, 4] normalized, gt_masks [B, G, mh, mw], and the
        ROI sampling priorities pos_priority, neg_priority
        [B, POST_NMS_ROIS_TRAINING] uniform in [0, 1), and (TRANSFORMER
        with XFORMER_DROPOUT > 0) dropout_generator. All tensors on the
        model's device. Returns the JAX module's outputs for the mode
        (with EXPOSE_FUSED_PYRAMID also fused_p2..fused_p5 [B, h, w, C]).
        Inference computes no gradient.

        `stats`: the BatchStats that TRAIN_BN's batch statistics go to
        (its group makes them the global batch's); the caller commits
        them or not. With TRAIN_BN and none given, a fresh one, dropped.
        Ignored where the BatchNorms are frozen: without TRAIN_BN, and in
        inference without BN_EVAL_BATCH_STATS.

        `mesh` (`parallel/mesh.py`): where the images carry a 1/n block of
        the views on a mesh of n view ranks, the views are sharded: the
        levels are gathered over the view group after the FPN and the
        backbone's statistics summed over the data x view group. Rcam,
        Kmat and depths stay whole."""
        cfg = self.config
        train_bn = bool(cfg.TRAIN_BN) and (
            training or bool(getattr(cfg, "BN_EVAL_BATCH_STATS", False)))
        if not train_bn:
            stats = None
        elif stats is None:
            stats = BatchStats()
        with torch.set_grad_enabled(training and torch.is_grad_enabled()), \
                float32_arithmetic(self):
            return self._forward(batch, training, stats, mesh)

    def _forward(self, batch, training, stats, mesh):
        cfg = self.config
        images = batch["images"]
        b, v, h, w, _ = images.shape
        view_group = view_group_of(mesh, v, cfg.NUM_VIEWS)
        if view_group is not None and (cfg.VANILLA or not self.multiview):
            raise ValueError("view sharding needs a multi-view config "
                             "that fuses the views (not VANILLA)")
        x = images.reshape(b * v, h, w, -1)
        if x.dtype == torch.uint8:
            # UINT8_IMAGE_TRANSFER: raw resized pixels came to the device
            # (4x fewer bytes); de-mold here in float32, bit-identical to
            # the host's mold_image on the same uint8 pixels
            x = x.float() - self._mean_pixel(x.device)
        x = x.permute(0, 3, 1, 2)
        remat = bool(cfg.REMAT) and training
        upstream = stats
        if stats is not None and view_group is not None:
            upstream = stats.over(mesh.data_view_group)
        _, c2, c3, c4, c5 = self.backbone(x.to(self.compute_dtype),
                                          upstream, remat)
        levels = self.fpn(c2, c3, c4, c5)
        if self.multiview or self.transformer:
            levels = [p.reshape(b, v, *p.shape[1:]) for p in levels]
            if view_group is not None:
                levels = [p if li in self.zero_levels
                          else gather(p, 1, view_group)
                          for li, p in enumerate(levels)]
            fmaps, zero_levels = self._fuse_views(batch, levels, (h, w),
                                                  training, stats, remat)
        else:
            fmaps, zero_levels = levels, set()

        # RPN, zero levels constant-folded
        k = len(cfg.RPN_ANCHOR_RATIOS)
        astr = cfg.RPN_ANCHOR_STRIDE
        logits_l, probs_l, deltas_l = [], [], []
        for li, fmap in enumerate(fmaps):
            if li in zero_levels:
                lh, lw = fmap.shape[2], fmap.shape[3]
                outs = self.rpn(fmap.new_zeros(b, fmap.shape[1], 1, 1))
                reps = (-(-lh // astr)) * (-(-lw // astr))
                outs = [t.repeat(1, reps, 1) for t in outs]
            else:
                outs = self.rpn(fmap)
            logits_l.append(outs[0])
            probs_l.append(outs[1])
            deltas_l.append(outs[2])
        rpn_probs = torch.cat(probs_l, dim=1)
        rpn_bbox = torch.cat(deltas_l, dim=1)
        # proposals carry no gradient (model.py:409-410)
        proposals = generate_proposals(
            rpn_probs.detach(), rpn_bbox.detach(), batch["anchors"],
            proposal_count=(cfg.POST_NMS_ROIS_TRAINING if training
                            else cfg.POST_NMS_ROIS_INFERENCE),
            nms_threshold=cfg.RPN_NMS_THRESHOLD,
            pre_nms_limit=cfg.PRE_NMS_LIMIT,
            bbox_std_dev=np.asarray(cfg.RPN_BBOX_STD_DEV))
        outputs = {
            "rpn_class_logits": torch.cat(logits_l, dim=1),
            "rpn_probs": rpn_probs,
            "rpn_bbox": rpn_bbox,
            "proposals": proposals,
        }

        mrcnn_maps = [fm.permute(0, 2, 3, 1) for fm in fmaps[:4]]
        if cfg.EXPOSE_FUSED_PYRAMID:
            # the post-fusion pyramid (the reference's PG2..PG5), NHWC as
            # in the JAX package, for run_graph / ancestor
            outputs.update({f"fused_p{li + 2}": fm
                            for li, fm in enumerate(mrcnn_maps)})
        if training:
            rois, tcls, tdeltas, tmasks = detection_targets_batch(
                proposals, batch["gt_class_ids"], batch["gt_boxes"],
                batch["gt_masks"], batch["pos_priority"],
                batch["neg_priority"],
                train_rois_per_image=cfg.TRAIN_ROIS_PER_IMAGE,
                roi_positive_ratio=cfg.ROI_POSITIVE_RATIO,
                mask_shape=tuple(cfg.MASK_SHAPE),
                use_mini_mask=cfg.USE_MINI_MASK,
                bbox_std_dev=np.asarray(cfg.BBOX_STD_DEV))
            pooled = pyramid_roi_align(rois, mrcnn_maps, (h, w),
                                       cfg.POOL_SIZE)
            logits, probs, bbox = self.classifier_head(pooled, stats)
            pooled_m = pyramid_roi_align(rois, mrcnn_maps, (h, w),
                                         cfg.MASK_POOL_SIZE)
            outputs.update({
                "rois": rois,
                "target_class_ids": tcls,
                "target_deltas": tdeltas,
                "target_masks": tmasks,
                "mrcnn_class_logits": logits,
                "mrcnn_probs": probs,
                "mrcnn_bbox": bbox,
                "mrcnn_masks": self.mask_head(pooled_m, stats),
            })
            return outputs

        pooled = pyramid_roi_align(proposals, mrcnn_maps, (h, w),
                                   cfg.POOL_SIZE)
        logits, probs, bbox = self.classifier_head(pooled, stats)
        windows = norm_boxes(parse_image_meta(batch["image_meta"])["window"],
                             (h, w))
        detections = refine_detections(
            proposals, probs, bbox, windows,
            bbox_std_dev=np.asarray(cfg.BBOX_STD_DEV),
            detection_min_confidence=cfg.DETECTION_MIN_CONFIDENCE,
            detection_max_instances=cfg.DETECTION_MAX_INSTANCES,
            detection_nms_threshold=cfg.DETECTION_NMS_THRESHOLD)
        pooled_m = pyramid_roi_align(detections[..., :4], mrcnn_maps, (h, w),
                                     cfg.MASK_POOL_SIZE)
        outputs.update({
            "mrcnn_class_logits": logits,
            "mrcnn_probs": probs,
            "mrcnn_bbox": bbox,
            "detections": detections,
            "mrcnn_masks": self.mask_head(pooled_m, stats),
        })
        return outputs

    def _fuse_views(self, batch, levels, image_shape, training, stats,
                    remat):
        """levels: 5 maps [B, V, C, h, w] (a zeroed level may hold only
        this rank's views: only its shape is read). Returns ([P2..P6] as
        [B, C, h, w], zero level indices). Under `remat` each level's
        GridFusion and DepthCollapse is checkpointed; the unprojection
        and reprojection between them run once."""
        cfg = self.config
        out = []
        if not self.projected:                    # TRANSFORMER, VANILLA
            fused = (self._fuse_p5(batch, levels[3], image_shape, training)
                     if self.transformer else None)
            for li, p in enumerate(levels):
                main = p[:, 0]
                if li in self.zero_levels:
                    out.append(torch.zeros_like(main))
                elif li == 3 and fused is not None:
                    out.append(main + fused.to(main.dtype))
                else:
                    out.append(main)
            return out, set(self.zero_levels)

        grid_pts = self._grid_points(levels[0].device)
        grid_shape = (cfg.nvox, cfg.nvox, cfg.nvox_z)
        rcam = batch["Rcam"].float()
        kmat = batch["Kmat"].float()
        out = []
        for li, p in enumerate(levels):
            if li in self.zero_levels:            # PG2/PG3 memory cap
                out.append(torch.zeros_like(p[:, 0]))
                continue
            feats = p.permute(0, 1, 3, 4, 2).contiguous()   # [B,V,h,w,C]
            if cfg.GRID_REAS in PER_VIEW_FUSIONS:
                vox = unproject_features(feats, rcam, kmat, image_shape,
                                         grid_pts, grid_shape)
                grids = vox.permute(0, 1, 5, 2, 3, 4)       # [B,V,C,X,Y,Z]
            else:
                vox = unproject_features_fused(feats, rcam, kmat,
                                               image_shape, grid_pts,
                                               grid_shape, relu=True)
                grids = vox.permute(0, 4, 1, 2, 3)          # [B,V*C,X,Y,Z]
            fusion = getattr(self, f"grid_fusion_p{li + 2}")
            collapse = getattr(self, f"depth_collapse_p{li + 2}")
            fused = (checkpointed(fusion, grids, stats) if remat
                     else fusion(grids, stats))
            if cfg.TRILINEAR_REPROJECTION:
                # in float32, as the JAX _reproject_collapse casts it
                rays = project_grid_trilinear(
                    fused.permute(0, 2, 3, 4, 1).float(), kmat, image_shape,
                    p.shape[3], cfg.samples, cfg).to(self.compute_dtype)
            else:
                rays = project_grid_nearest(
                    fused.permute(0, 2, 3, 4, 1).contiguous(), kmat,
                    image_shape, p.shape[3], cfg.samples, cfg)
            out.append(checkpointed(collapse, rays, stats) if remat
                       else collapse(rays, stats))
        return out, set(self.zero_levels)

    def _fuse_p5(self, batch, p5, image_shape, training):
        """The transformer branch (detector.py:280-295): p5 [B, V, C, h, w]
        -> the fused map [B, C, h, w] to add to the main view's P5."""
        cfg = self.config
        generator = batch.get("dropout_generator") if training else None
        if generator is None and training and cfg.XFORMER_DROPOUT > 0:
            raise ValueError("training the transformer with dropout needs "
                             "batch['dropout_generator']")
        positions, tokens = unproject_rays(
            p5.permute(0, 1, 3, 4, 2).float(), batch["Rcam"].float(),
            batch["Kmat"].float(), batch["depths"].float(), image_shape,
            samples=cfg.samples,
            faithful_pairing=bool(cfg.XFORMER_FAITHFUL_PAIRING))
        fused = self.view_transformer(tokens.to(self.compute_dtype),
                                      positions, generator)
        return fused.permute(0, 3, 1, 2)


def make_dummy_batch(config, training=False, batch_size=None, num_views=None,
                     image_size=None):
    """Zero-filled inputs with the right static shapes, as numpy arrays
    (the JAX package's make_dummy_batch, detector.py:469-505): for shape
    checks and smoke runs. Training adds zero ground truth; the RPN
    targets and the ROI priorities are the caller's."""
    cfg = config
    b = batch_size or cfg.BATCH_SIZE
    v = num_views or cfg.NUM_VIEWS
    hw = image_size or int(cfg.IMAGE_SHAPE[0])
    anchors = get_anchors(cfg, [hw, hw, 3])
    img_dtype = (np.uint8 if getattr(cfg, "UINT8_IMAGE_TRANSFER", False)
                 else np.float32)
    batch = {
        "images": np.zeros((b, v, hw, hw, 3), img_dtype),
        "image_meta": np.zeros((b, cfg.IMAGE_META_SIZE), np.float32),
        "anchors": anchors.astype(np.float32),
        "Rcam": np.tile(np.eye(3, 4, dtype=np.float32), (b, v, 1, 1)),
        "Kmat": np.tile(np.array([[hw, 0, hw / 2], [0, hw, hw / 2],
                                  [0, 0, 1]], np.float32), (b, 1, 1)),
    }
    batch["image_meta"][:, 4:7] = [hw, hw, 3]
    batch["image_meta"][:, 7:11] = [0, 0, hw, hw]
    if cfg.TRANSFORMER:
        s5 = hw // cfg.BACKBONE_STRIDES[3]
        batch["depths"] = np.full((b, v, s5, s5), 2.0, np.float32)
    if training:
        g = cfg.MAX_GT_INSTANCES
        mh, mw = (cfg.MINI_MASK_SHAPE if cfg.USE_MINI_MASK
                  else (hw, hw))
        batch["gt_class_ids"] = np.zeros((b, g), np.int32)
        batch["gt_boxes"] = np.zeros((b, g, 4), np.float32)
        batch["gt_masks"] = np.zeros((b, g, mh, mw), np.float32)
    return batch
