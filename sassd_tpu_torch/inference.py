"""Inference steps and the dataset evaluation runner.

- :func:`make_test_step`: a host batch (voxels, anchors mask, host plans
  if built) in, detections out.
- :func:`run_inference`: the detector over a dataset, in either
  ``test.device_input`` mode, as KITTI annotations.
- :func:`evaluate`: run_inference plus the official KITTI AP table, in
  one process or over the ranks of a process group (each data row's
  shard once, parallel/mesh.py).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sassd_tpu_torch import serve
from sassd_tpu_torch.config import SASSDConfig, check_supported
from sassd_tpu_torch.data.loader import iterate_batches
from sassd_tpu_torch.eval import kitti_eval
from sassd_tpu_torch.eval.results import detections_to_kitti_anno
from sassd_tpu_torch.models.detector import Detector
from sassd_tpu_torch.parallel import dist, mesh


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on `device` (plans stay int16 on the wire)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_test_step(cfg: SASSDConfig, anchors: np.ndarray, device
                   ) -> Callable[[Detector, Dict[str, np.ndarray]],
                                 Dict[str, torch.Tensor]]:
    """Returns step(model, batch) -> detections on `device` (not synced).
    The step puts the model in eval mode and runs without autograd."""
    check_supported(cfg)
    anchors_t = torch.from_numpy(np.asarray(anchors, np.float32)).to(device)

    def step(model: Detector, batch: Dict[str, np.ndarray]):
        model.eval()
        with torch.inference_mode():
            return model.forward_test(to_device(batch, device), anchors_t)
    return step


def run_inference(cfg: SASSDConfig, dataset, model: Detector,
                  batch_size: int = 1, device="cuda", num_shards: int = 1,
                  shard_id: int = 0) -> Tuple[List[Dict], List[int]]:
    """Run the detector over a dataset, or over the strided shard
    `shard_id` of `num_shards` of it; returns (annos, sample_ids).

    `model` lives on `device`. With ``test.device_input="points"`` the
    loader only crops and pads raw points (serve.PointsView) and the device
    voxelizes, masks and builds the rulebook (serve.make_serving_step),
    at batch 1 with ``test.serve_persistent_plans`` through index maps
    carried from scan to scan for the run (serve.init_plan_carry; at a
    larger batch the flag is ignored, as in the JAX package); with
    "voxels" the dataset's samples are uploaded as they are. The
    samples are padded, by repeating them, to a multiple of num_shards x
    batch_size; the duplicates are kept, as the JAX runner keeps them, and
    :func:`evaluate` drops them.
    """
    check_supported(cfg)
    if cfg.test.device_input == "points":
        src = serve.PointsView(dataset, cfg)
        persistent = cfg.test.serve_persistent_plans and batch_size == 1
        step = serve.make_serving_step(cfg, dataset.anchors,
                                       dataset.anchors_bv, device,
                                       persistent_plans=persistent)
        if persistent:
            # one scan stream: the carry lives for the run (this rank's)
            carry = serve.init_plan_carry(cfg, device)

            def step(model, batch, _step=step):
                nonlocal carry
                dets, carry = _step(model, carry, batch)
                return dets
    else:
        src = dataset
        step = make_test_step(cfg, dataset.anchors, device)
    class_names = list(cfg.class_names)
    annos, ids = [], []
    for batch, metas in iterate_batches(src, batch_size, shuffle=False,
                                        num_shards=num_shards,
                                        shard_id=shard_id, num_workers=2):
        dets = {k: v.cpu().numpy() for k, v in step(model, batch).items()}
        for i, meta in enumerate(metas):
            annos.append(detections_to_kitti_anno(
                dets["boxes"][i], dets["scores"][i], dets["labels"][i],
                dets["valid"][i], meta, class_names))
            ids.append(meta["sample_idx"])
    return annos, ids


def _dedup_by_id(annos: List[Dict], ids: List[int]):
    seen, out_a, out_i = set(), [], []
    for a, sid in zip(annos, ids):
        if sid not in seen:
            seen.add(sid)
            out_a.append(a)
            out_i.append(sid)
    order = sorted(range(len(out_i)), key=lambda k: out_i[k])
    return [out_a[k] for k in order], [out_i[k] for k in order]


def evaluate(cfg: SASSDConfig, dataset, model: Optional[Detector],
             label_dir, batch_size: int = 1, device="cuda",
             precomputed: Optional[Tuple[List[Dict], List[int]]] = None,
             exchange_dir: Optional[str] = None):
    """Inference + the official KITTI AP over the dataset. Returns
    (results, text).

    Under a process group of N ranks laid out as D data rows of S
    spatial ranks (mesh.layout; S = 1 but for the spatial strategies)
    each data row runs its strided 1/D of the dataset, every rank of the
    row taking part, and the annotations of the rows' first ranks are
    gathered to rank 0 through `exchange_dir` (a directory every rank
    sees, dist.gather_objects): rank 0 alone computes the AP and returns
    it, the other ranks return (None, "").

    `precomputed`: (annos, ids) from an earlier run_inference over this
    rank's shard (for example one that also wrote result files), used
    instead of a second pass; `model` may then be None.
    """
    lay = mesh.layout(cfg)
    dt_annos, ids = (precomputed if precomputed is not None else
                     run_inference(cfg, dataset, model, batch_size, device,
                                   num_shards=lay.data,
                                   shard_id=lay.data_index))
    if dist.process_count() > 1:
        if exchange_dir is None:
            raise ValueError("evaluate across processes needs an "
                             "exchange_dir every rank can reach")
        # the other ranks of a data row hold copies of its detections
        mine = (dt_annos, ids) if lay.spatial_index == 0 else ([], [])
        parts = dist.gather_objects(mine, exchange_dir, tag="eval")
        if not dist.is_primary():
            return None, ""
        dt_annos = [a for p in parts for a in p[0]]
        ids = [i for p in parts for i in p[1]]
    dt_annos, ids = _dedup_by_id(dt_annos, ids)
    gt_annos = kitti_eval.get_label_annos(label_dir, ids)
    return kitti_eval.get_official_eval_result(
        gt_annos, dt_annos, list(cfg.class_names))
