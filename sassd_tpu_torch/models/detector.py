"""SA-SSD detector: VFE (the points' mean, or the PointNet encoder) ->
sparse backbone (host or device rulebook, dense tail) -> BEV trunk -> SSD
head -> guided anchors -> PSWarp rescoring -> rotated NMS (forward_test);
in training, the same spine plus
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
                 training only; the plans (host or device) then include
                 strideT* and, for the ring aux interpolation, aux*

With ``parallel.strategy="banded"`` and ``spatial`` > 1 the spine is the
banded sparse stage (parallel/sparse_spatial.py): the level-0 rows are
split into S y-bands (K16), the S * B band rows go through the device
rulebook (with the global grid top as each row's downsample limit) and
VxNet as one batch (BatchNorm over band-owned rows), the owned level-3
rows make the [B, H, W, D*C] canvas, and BEVNet and the heads run as
replicated. The aux branch then interpolates with each band row's grid
origin and takes its loss over owned queries. Host plans are never read
there; device-resident serving stays replicated (``replicated=True``), as
in the JAX package.

forward_test marks its stages (partition, rulebook, vxnet, bevnet, head,
pswarp, nms) and forward_train its own (partition, rulebook, vxnet,
bevnet, aux, head, targets_losses, pswarp) with torch.profiler ranges
(see sassd_tpu_torch/profile_slice.py).
A new Detector is in eval mode; training puts it in train mode, where
every BatchNorm takes batch statistics and updates its running buffers.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from sassd_tpu_torch.config import SASSDConfig, banded, check_supported
from sassd_tpu_torch.core import boxes as box_ops
from sassd_tpu_torch.core import losses as loss_ops
from sassd_tpu_torch.core import targets as target_ops
from sassd_tpu_torch.ops import interpolate
from sassd_tpu_torch.ops import sparse as sp
from sassd_tpu_torch.parallel import dist
from sassd_tpu_torch.parallel import sparse_spatial as ss
from . import backbone, bev, pswarp, ssd_head

# voxel-size multiple of the aux branch's middle levels 1, 2, 3
_LEVEL_VOXEL_MULT = (2, 4, 8)


class SpineOut(NamedTuple):
    """The trunk's outputs; the aux branch's inputs in training. Banded,
    the aux rows are the S * B band rows (band-major) and B' = S * B."""
    bev_map: torch.Tensor      # [B, H, W, F]
    conv6: torch.Tensor        # [B, H, W, F]
    middles: Optional[List[backbone.Middle]] = None   # training only
    points_mean: Optional[torch.Tensor] = None        # [B', V, 3] centroids
    points_valid: Optional[torch.Tensor] = None       # [B', V] (owned)
    # the rulebook's aux1..3 ring plans (training with aux_interp="ring")
    aux_plans: Optional[Dict[str, torch.Tensor]] = None
    cell0: Optional[torch.Tensor] = None    # [B', V, 3] queries' L0 cells
    origins: Optional[torch.Tensor] = None  # [B', 3] grid origins (banded)
    bands: int = 1
    band_overflow: Optional[torch.Tensor] = None      # [S, B] (banded)


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
        # the PointNet VFE (model.vfe_type="pointnet"), made last so the
        # other modules draw the same seeded weights with either encoder
        if m.vfe_type == "pointnet":
            self.vfe = backbone.PointNetVFE(
                gen, m.num_input_features,
                out_features=m.num_input_features)
        self.band_spec = ss.config_band_spec(cfg) if banded(cfg) else None
        self.eval()

    def forward_spine(self, batch: Dict[str, torch.Tensor],
                      replicated: bool = False) -> SpineOut:
        """VFE, backbone and BEV trunk; in train mode also the aux branch's
        middles and the voxel centroids. A banded config runs the banded
        spine unless `replicated`."""
        if self.band_spec is not None and not replicated:
            return self._banded_spine(batch)
        plans = {k[len("plan_"):]: v for k, v in batch.items()
                 if k.startswith("plan_")}
        if "subm0" not in plans:           # no host rulebook: build it here
            with record_function("rulebook"):
                keys0 = sp.coords_to_keys(batch["coords"],
                                          self.cfg.sparse_shape)
                plans = sp.device_rulebook(
                    keys0, self.vxnet.level_shapes,
                    self.cfg.caps.level_caps[1:], train=self.training,
                    aux=self.cfg.model.aux_interp == "ring")
        keys0 = None
        with record_function("vxnet"):
            vfe = backbone.vfe_mean(batch["voxels"], batch["num_points"])
            # the PointNet VFE's features feed the ladder; the aux
            # branch's centroids stay the points' means
            feats = (self.vfe(batch["voxels"], batch["num_points"])
                     if self.cfg.model.vfe_type == "pointnet" else vfe)
            if self.training:
                keys0 = sp.coords_to_keys(batch["coords"],
                                          self.cfg.sparse_shape)
                out_dense, middles = self.vxnet.forward_train(feats, keys0,
                                                              plans)
            else:
                out_dense, middles = self.vxnet(feats, plans), None
        b, d, h, w, c = out_dense.shape
        bev_in = out_dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)
        with record_function("bevnet"):
            bev_map, conv6 = self.bevnet(bev_in)
        if keys0 is None:
            return SpineOut(bev_map, conv6)
        aux_plans = None
        if self.cfg.model.aux_interp == "ring":
            aux_plans = {k: plans[k] for k in ("aux1", "aux2", "aux3")}
        return SpineOut(bev_map, conv6, middles, vfe[..., :3],
                        keys0 != sp.INVALID_KEY, aux_plans, batch["coords"])

    def _banded_spine(self, batch: Dict[str, torch.Tensor]) -> SpineOut:
        """partition (K16) -> device rulebook at band shape with the
        global grid top -> VxNet with band-owned BatchNorm -> the owned
        level-3 rows as the BEV canvas -> BEVNet."""
        cfg, spec = self.cfg, self.band_spec
        if self.training:
            check_supported(cfg, train=True)
        shapes = backbone.level_shapes(ss.band_shape(cfg, spec))
        owned = (spec.halo, spec.halo + spec.band_h)
        with record_function("partition"):
            vfe = backbone.vfe_mean(batch["voxels"], batch["num_points"])
            bcoords, bvfe, overflow = ss.partition(batch["coords"], vfe,
                                                   spec)
            s, b = bcoords.shape[:2]
            cell0 = bcoords.reshape(s * b, -1, 3)
            feats0 = bvfe.reshape(s * b, -1, bvfe.shape[-1])
        with record_function("rulebook"):
            keys0 = sp.coords_to_keys(cell0, shapes[0])
            plans = sp.device_rulebook(
                keys0, shapes, spec.caps[1:], train=self.training,
                y_top=ss.y_top_rows(cfg, spec, b, keys0.device))
        with record_function("vxnet"):
            if self.training:
                out_dense, middles = self.vxnet.forward_train(
                    feats0, keys0, plans, shapes, owned)
            else:
                out_dense = self.vxnet(feats0, plans, shapes, owned)
            # owned rows [S*B, D, bh3, W, C] -> a contiguous NCHW canvas
            # [B, D*C, S*bh3, W] (channel z*C + c), seen as NHWC, as the
            # replicated spine hands BEVNet its canvas
            lo3, bh3 = spec.halo >> 3, spec.band_h >> 3
            od = out_dense[:, :, lo3:lo3 + bh3]
            d, w, c = od.shape[1], od.shape[3], od.shape[4]
            bev_in = od.reshape(s, b, d, bh3, w, c).permute(
                1, 2, 5, 0, 3, 4).reshape(b, d * c, s * bh3, w).permute(
                    0, 2, 3, 1)
        with record_function("bevnet"):
            bev_map, conv6 = self.bevnet(bev_in)
        if not self.training:
            return SpineOut(bev_map, conv6, bands=s, band_overflow=overflow)
        y = cell0[..., 1]
        owned0 = (cell0[..., 0] >= 0) & (y >= owned[0]) & (y < owned[1])
        aux_plans = {k: plans[k] for k in ("aux1", "aux2", "aux3")}
        return SpineOut(bev_map, conv6, middles, feats0[..., :3], owned0,
                        aux_plans, cell0,
                        ss.band_origins(cfg, spec, b, keys0.device), s,
                        overflow)

    def aux_forward(self, spine: SpineOut):
        """Middle features interpolated onto the voxel centroids -> point_fc
        -> (point_cls [B', V], point_reg [B', V, 3]). The 3-NN is the ring
        one over the rulebook's aux plans (K11; banded, with each row's
        grid origin), or with model.aux_interp="exact" the exact one over
        every active cell centre of the level (K15)."""
        cfg = self.cfg
        pcr = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
        vs0 = np.asarray(cfg.voxel.voxel_size, np.float32)
        origin = pcr.tolist() if spine.origins is None else spine.origins
        feats = []
        for lvl, (mid, mult) in enumerate(zip(spine.middles,
                                              _LEVEL_VOXEL_MULT), start=1):
            vs = vs0 * mult
            if spine.aux_plans is not None:
                feats.append(interpolate.neighborhood_interpolate_cells(
                    spine.points_mean, spine.cell0, lvl, mid.feats,
                    spine.aux_plans[f"aux{lvl}"], vs.tolist(), origin))
                continue
            centers = interpolate.cell_centers(
                sp.keys_to_coords(mid.keys, self.vxnet.level_shapes[lvl]),
                vs.tolist(), pcr.tolist())
            feats.append(interpolate.three_nn_interpolate(
                spine.points_mean, centers, mid.keys != sp.INVALID_KEY,
                mid.feats))
        pointwise = torch.cat(feats, dim=-1) @ self.aux.point_fc.w
        return ((pointwise @ self.aux.point_cls.w)[..., 0],
                pointwise @ self.aux.point_reg.w)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      anchors: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every loss of a training step (the keys with "loss", summed by
        parse_losses) and three metrics: guided_truncated (passing
        candidates per sample dropped by caps.guided_train), guided_valid
        (valid guided candidates, GTs included) and guided_pos (those the
        PSWarp 3D-IoU assigner labels positive); banded, also
        band_overflow (level-0 rows dropped by the per-band cap, which
        breaks banded == replicated when nonzero). The model must be in
        train mode; BatchNorm buffers update. Under a process group the
        losses are this rank's shares of the global batch's losses and the
        metrics this rank's own (train.loop's step reduces both)."""
        cfg, tc = self.cfg, self.cfg.train
        spine = self.forward_spine(batch)
        with record_function("aux"):
            point_cls, point_reg = self.aux_forward(spine)
        with record_function("head"):
            outs = self.head(spine.bev_map)
        with record_function("targets_losses"):
            # banded: the S * B band rows against the S-tiled GT boxes,
            # normalised by the true batch size
            gt = {k: torch.cat([batch[k]] * spine.bands)
                  for k in ("gt_boxes", "gt_valid")}
            losses = aux_loss(point_cls, point_reg, spine, gt,
                              denom=batch["gt_boxes"].shape[0])
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
        if spine.band_overflow is not None:
            losses["band_overflow"] = torch.sum(spine.band_overflow).to(
                torch.float32)
        return losses

    def forward_test(self, batch: Dict[str, torch.Tensor],
                     anchors: torch.Tensor,
                     replicated: bool = False) -> Dict[str, torch.Tensor]:
        """Detections: boxes [B,D,7], scores [B,D], labels [B,D],
        valid [B,D], guided_truncated [B]. `replicated`: run a banded
        config's spine replicated (device-resident serving)."""
        cfg = self.cfg
        spine = self.forward_spine(batch, replicated)
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
             spine: SpineOut, batch: Dict[str, torch.Tensor],
             denom: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Point segmentation (focal) + centre-offset regression (smooth-L1)
    of the aux branch; targets from points_in_boxes (K12). denom: this
    rank's batch size (default the GT batch; banded, the true batch size
    B of the S * B band rows). The losses divide by the global batch,
    denom times dist.process_count(), and normalise by the positive
    points of every rank, as the JAX step over the global batch does."""
    b = (denom if denom is not None
         else batch["gt_boxes"].shape[0]) * dist.process_count()
    with torch.no_grad():
        labels, offsets = box_ops.aux_targets(
            spine.points_mean, spine.points_valid, batch["gt_boxes"],
            batch["gt_valid"])
    valid = spine.points_valid
    posf = (labels & valid).to(torch.float32)
    negf = (~labels & valid).to(torch.float32)
    pos_norm = torch.clamp(dist.all_reduce_sum(torch.sum(posf)), min=1.0)
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
