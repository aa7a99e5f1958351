"""SA-SSD detector, inference path: VFE -> sparse backbone (host or
device rulebook, dense tail) -> BEV trunk -> SSD head -> guided anchors ->
PSWarp rescoring -> rotated NMS.

Batch layout (per-sample padding, B = batch), tensors on one device:
    voxels       [B, V, T, F]  zero-padded voxel point slots
    num_points   [B, V]        points per voxel (0 = padded voxel)
    coords       [B, V, 3]     zyx, -1 rows = padding
    anchors_mask [B, A]        bool BEV occupancy prefilter
    plan_*       host rulebook (data.kitti.build_host_plans), batched;
                 absent with model.host_plans=False, and then the
                 rulebook is built on the device (ops.sparse.device_rulebook)

forward_test marks its stages (rulebook, vxnet, bevnet, head, pswarp,
nms) with torch.profiler ranges (see sassd_tpu_torch/profile_slice.py).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.profiler import record_function

from sassd_tpu_torch.config import SASSDConfig, check_supported
from sassd_tpu_torch.ops import sparse as sp
from . import backbone, bev, pswarp, ssd_head


class SpineOut(NamedTuple):
    bev_map: torch.Tensor      # [B, H, W, F]
    conv6: torch.Tensor        # [B, H, W, F]


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
        self.requires_grad_(False)             # the port serves, not trains

    def forward_spine(self, batch: Dict[str, torch.Tensor]) -> SpineOut:
        plans = {k[len("plan_"):]: v for k, v in batch.items()
                 if k.startswith("plan_")}
        if "subm0" not in plans:           # no host rulebook: build it here
            with record_function("rulebook"):
                keys0 = sp.coords_to_keys(batch["coords"],
                                          self.cfg.sparse_shape)
                plans = sp.device_rulebook(keys0, self.vxnet.level_shapes,
                                           self.cfg.caps.level_caps[1:])
        with record_function("vxnet"):
            vfe = backbone.vfe_mean(batch["voxels"], batch["num_points"])
            out_dense = self.vxnet(vfe, plans)                 # [B,D,H,W,C]
        b, d, h, w, c = out_dense.shape
        bev_in = out_dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)
        with record_function("bevnet"):
            bev_map, conv6 = self.bevnet(bev_in)
        return SpineOut(bev_map, conv6)

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
