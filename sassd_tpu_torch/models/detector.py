"""SA-SSD detector: VFE -> sparse backbone (host or device rulebook,
dense tail) -> BEV trunk -> SSD head -> guided anchors -> PSWarp
rescoring -> rotated NMS (forward_test); in training, the same spine plus
the auxiliary point branch, the head's losses, guided anchors with the GT
boxes prepended and the PSWarp loss (forward_train).

Batch layout (per-sample padding, B = batch), tensors on one device:
    voxels       [B, V, T, F]  zero-padded voxel point slots
    num_points   [B, V]        points per voxel (0 = padded voxel)
    coords       [B, V, 3]     zyx, -1 rows = padding
    anchors_mask [B, A]        bool BEV occupancy prefilter
    plan_*       host rulebook (data.kitti.build_host_plans), batched;
                 absent with model.host_plans=False, and then the
                 rulebook is built on the device (ops.sparse.device_rulebook)
    gt_boxes [B, G, 7], gt_classes [B, G] (1-based), gt_valid [B, G]:
                 training only; the plans then include strideT* and aux*

forward_test marks its stages (rulebook, vxnet, bevnet, head, pswarp,
nms) and forward_train its own (vxnet, bevnet, aux, head, targets_losses,
pswarp) with torch.profiler ranges (see sassd_tpu_torch/profile_slice.py).
A new Detector is in eval mode; training puts it in train mode, where
every BatchNorm takes batch statistics and updates its running buffers.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from sassd_tpu_torch.config import SASSDConfig, check_supported
from sassd_tpu_torch.core import boxes as box_ops
from sassd_tpu_torch.core import losses as loss_ops
from sassd_tpu_torch.core import targets as target_ops
from sassd_tpu_torch.ops import interpolate
from sassd_tpu_torch.ops import sparse as sp
from . import backbone, bev, pswarp, ssd_head

# voxel-size multiple of the aux branch's middle levels 1, 2, 3
_LEVEL_VOXEL_MULT = (2, 4, 8)


class SpineOut(NamedTuple):
    bev_map: torch.Tensor      # [B, H, W, F]
    conv6: torch.Tensor        # [B, H, W, F]
    middles: Optional[List[backbone.Middle]] = None   # training only
    points_mean: Optional[torch.Tensor] = None        # [B, V, 3] centroids
    points_valid: Optional[torch.Tensor] = None       # [B, V]


class Detector(nn.Module):
    """Parameters named and shaped as the JAX package's params/state trees
    (vxnet, bevnet, head, pswarp), so weights convert key by key."""

    def __init__(self, cfg: SASSDConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        gen = generator if generator is not None else torch.Generator()
        m = cfg.model
        self.vxnet = backbone.VxNet(gen, m.num_input_features,
                                    cfg.sparse_shape)
        bev_in = self.vxnet.shape3[0] * 64
        self.bevnet = bev.BEVNet(gen, bev_in, m.bev_channels)
        self.head = ssd_head.SSDHead(gen, m.bev_channels, m.num_class,
                                     m.num_anchor_per_loc, m.box_code_size)
        # rescoring is class-agnostic even for multi-class models
        self.pswarp = pswarp.PSWarpHead(gen, m.bev_channels, 1, m.num_parts)
        # aux point branch (training only), bias-free
        self.aux = nn.Module()
        self.aux.point_fc = backbone.Linear(gen, 160, 64)
        self.aux.point_cls = backbone.Linear(gen, 64, 1)
        self.aux.point_reg = backbone.Linear(gen, 64, 3)
        self.eval()

    def forward_spine(self, batch: Dict[str, torch.Tensor]) -> SpineOut:
        """VFE, backbone and BEV trunk; in train mode also the aux branch's
        middles and the voxel centroids."""
        plans = {k[len("plan_"):]: v for k, v in batch.items()
                 if k.startswith("plan_")}
        if "subm0" not in plans:           # no host rulebook: build it here
            with record_function("rulebook"):
                keys0 = sp.coords_to_keys(batch["coords"],
                                          self.cfg.sparse_shape)
                plans = sp.device_rulebook(keys0, self.vxnet.level_shapes,
                                           self.cfg.caps.level_caps[1:])
        keys0 = None
        with record_function("vxnet"):
            vfe = backbone.vfe_mean(batch["voxels"], batch["num_points"])
            if self.training:
                keys0 = sp.coords_to_keys(batch["coords"],
                                          self.cfg.sparse_shape)
                out_dense, middles = self.vxnet.forward_train(vfe, keys0,
                                                              plans)
            else:
                out_dense, middles = self.vxnet(vfe, plans), None
        b, d, h, w, c = out_dense.shape
        bev_in = out_dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)
        with record_function("bevnet"):
            bev_map, conv6 = self.bevnet(bev_in)
        if keys0 is None:
            return SpineOut(bev_map, conv6)
        return SpineOut(bev_map, conv6, middles, vfe[..., :3],
                        keys0 != sp.INVALID_KEY)

    def aux_forward(self, spine: SpineOut, batch: Dict[str, torch.Tensor]):
        """Middle features interpolated onto the voxel centroids (ring 3-NN
        over the host aux plans, K11) -> point_fc -> (point_cls [B, V],
        point_reg [B, V, 3])."""
        cfg = self.cfg
        pcr = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
        vs0 = np.asarray(cfg.voxel.voxel_size, np.float32)
        feats = []
        for lvl, (mid, mult) in enumerate(zip(spine.middles,
                                              _LEVEL_VOXEL_MULT), start=1):
            feats.append(interpolate.neighborhood_interpolate_cells(
                spine.points_mean, batch["coords"], lvl, mid.feats,
                batch[f"plan_aux{lvl}"], (vs0 * mult).tolist(),
                pcr.tolist()))
        pointwise = torch.cat(feats, dim=-1) @ self.aux.point_fc.w
        return ((pointwise @ self.aux.point_cls.w)[..., 0],
                pointwise @ self.aux.point_reg.w)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      anchors: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every loss of a training step (the keys with "loss", summed by
        parse_losses) and three metrics: guided_truncated (passing
        candidates per sample dropped by caps.guided_train), guided_valid
        (valid guided candidates, GTs included) and guided_pos (those the
        PSWarp 3D-IoU assigner labels positive). The model must be in train
        mode; BatchNorm buffers update."""
        cfg, tc = self.cfg, self.cfg.train
        spine = self.forward_spine(batch)
        with record_function("aux"):
            point_cls, point_reg = self.aux_forward(spine, batch)
        with record_function("head"):
            outs = self.head(spine.bev_map)
        with record_function("targets_losses"):
            losses = aux_loss(point_cls, point_reg, spine, batch)
            matched = tuple(a.matched_threshold for a in cfg.anchors.values())
            unmatched = tuple(a.unmatched_threshold
                              for a in cfg.anchors.values())
            losses.update(ssd_head.head_loss(
                outs, anchors, batch["anchors_mask"], batch["gt_boxes"],
                batch["gt_classes"], batch["gt_valid"],
                num_class=cfg.model.num_class, matched_thresholds=matched,
                unmatched_thresholds=unmatched,
                similarity_fn=target_ops.SIMILARITY_FNS[tc.rpn_similarity]))
            ga = ssd_head.get_guided_anchors(
                outs, anchors, batch["anchors_mask"],
                num_class=cfg.model.num_class, thr=tc.anchor_thr,
                cap=cfg.caps.guided_train, gt_boxes=batch["gt_boxes"],
                gt_labels=batch["gt_classes"], gt_valid=batch["gt_valid"])
        with record_function("pswarp"):
            scores = self.pswarp(spine.conv6, ga.boxes, ga.valid,
                                 window_size=cfg.model.window_size,
                                 grid_offsets=cfg.model.grid_offsets,
                                 featmap_stride=cfg.model.featmap_stride)
            labels = pswarp.pswarp_labels(
                ga.boxes, ga.valid, batch["gt_boxes"], batch["gt_valid"],
                pos_iou_thr=tc.extra_pos_iou, neg_iou_thr=tc.extra_neg_iou)
            losses.update(pswarp.pswarp_loss(scores, labels))
        losses["guided_truncated"] = torch.mean(
            ga.truncated.to(torch.float32))
        losses["guided_valid"] = torch.sum(ga.valid).to(torch.float32)
        losses["guided_pos"] = torch.sum(labels > 0).to(torch.float32)
        return losses

    def forward_test(self, batch: Dict[str, torch.Tensor],
                     anchors: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Detections: boxes [B,D,7], scores [B,D], labels [B,D],
        valid [B,D], guided_truncated [B]."""
        cfg = self.cfg
        spine = self.forward_spine(batch)
        with record_function("head"):
            outs = self.head(spine.bev_map)
            ga = ssd_head.get_guided_anchors(
                outs, anchors, batch["anchors_mask"],
                num_class=cfg.model.num_class, thr=cfg.test.anchor_thr,
                cap=cfg.caps.guided_test)
        with record_function("pswarp"):
            scores = self.pswarp(spine.conv6, ga.boxes, ga.valid,
                                 window_size=cfg.model.window_size,
                                 grid_offsets=cfg.model.grid_offsets,
                                 featmap_stride=cfg.model.featmap_stride)
        with record_function("nms"):
            db, ds, dl, dv = pswarp.rescore_and_nms(
                ga.boxes, scores, ga.labels, ga.valid,
                score_thr=cfg.test.score_thr,
                nms_iou_thr=cfg.test.nms_iou_thr,
                max_det=cfg.caps.max_det, nms_pre=cfg.test.nms_pre)
        return dict(boxes=db, scores=ds, labels=dl, valid=dv,
                    guided_truncated=ga.truncated)


def aux_loss(point_cls: torch.Tensor, point_reg: torch.Tensor,
             spine: SpineOut, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """Point segmentation (focal) + centre-offset regression (smooth-L1)
    of the aux branch; targets from points_in_boxes (K12)."""
    b = batch["gt_boxes"].shape[0]
    with torch.no_grad():
        labels, offsets = box_ops.aux_targets(
            spine.points_mean, spine.points_valid, batch["gt_boxes"],
            batch["gt_valid"])
    valid = spine.points_valid
    posf = (labels & valid).to(torch.float32)
    negf = (~labels & valid).to(torch.float32)
    pos_norm = torch.clamp(torch.sum(posf), min=1.0)
    cls = loss_ops.sigmoid_focal_loss(point_cls, labels.to(torch.float32),
                                      (posf + negf) / pos_norm) / b
    reg = loss_ops.smooth_l1_loss(point_reg, offsets,
                                  (posf / pos_norm)[..., None],
                                  beta=1 / 9.0) / b
    return dict(aux_loss_cls=cls, aux_loss_reg=reg)


def parse_losses(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The training objective: the sum of the entries whose key contains
    "loss" (metrics such as guided_truncated are left out)."""
    return sum(v for k, v in losses.items() if "loss" in k)
