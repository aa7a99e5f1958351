"""Configuration dataclasses read by the PyTorch port.

The fields and defaults are those of ``sassd_tpu.config`` (and of
``sassd_tpu.ops.voxelize.VoxelConfig``), restricted to what inference and
single-device training read. Layout knobs of the JAX package that do not
change numerics (``triple_gather``, ``flat_batch``, ``fold_head``,
``packed_warp``, ...) are not carried: the port implements one form of
each. Options the port does not run yet raise ``NotImplementedError`` in :func:`check_supported`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    """Voxel grid specification."""
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    point_cloud_range: Tuple[float, ...] = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    max_num_points: int = 5
    max_voxels: int = 20000

    @property
    def grid_size(self) -> np.ndarray:
        """[3] xyz voxel counts: round((max-min)/size)."""
        pcr = np.asarray(self.point_cloud_range, np.float64)
        vs = np.asarray(self.voxel_size, np.float64)
        return np.round((pcr[3:] - pcr[:3]) / vs).astype(np.int64)

    @property
    def sparse_shape(self) -> Tuple[int, int, int]:
        """(D, H, W) zyx grid shape for the sparse backbone."""
        gx, gy, gz = self.grid_size
        return int(gz), int(gy), int(gx)


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Per-class anchor grid."""
    sizes: Tuple[float, float, float] = (1.6, 3.9, 1.56)
    strides: Tuple[float, float, float] = (0.4, 0.4, 1.0)
    offsets: Tuple[float, float, float] = (0.2, -39.8, -1.78)
    rotations: Tuple[float, ...] = (0.0, 1.57)
    # anchor-GT assigner thresholds (head_loss)
    matched_threshold: float = 0.6
    unmatched_threshold: float = 0.45


@dataclasses.dataclass(frozen=True)
class Caps:
    """Static capacities: raw points per scan (device voxelizer input),
    per-level active-voxel caps and candidate budgets."""
    max_points_per_scan: int = 65536
    max_gt: int = 64
    level_caps: Tuple[int, int, int, int] = (20000, 18432, 14336, 10240)
    guided_train: int = 640
    guided_test: int = 2048
    max_det: int = 100


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_class: int = 1
    num_input_features: int = 4
    vfe_type: str = "mean"
    bev_channels: int = 256
    num_anchor_per_loc: int = 2
    box_code_size: int = 7
    grid_offsets: Tuple[float, float] = (0.0, 40.0)
    featmap_stride: float = 0.4
    num_parts: int = 28
    window_size: Tuple[int, int] = (4, 7)
    compute_dtype: str = "float32"
    dense_index: bool = True
    host_plans: bool = True
    dense_tail: bool = True
    sorted_device_levels: bool = True
    plan_lookup: str = "dense"
    # aux-branch 3-NN candidates: "ring" = the 3x3x3 neighbourhood of the
    # query's parent cell (the host rulebook's aux plans)
    aux_interp: str = "ring"


@dataclasses.dataclass(frozen=True)
class TestConfig:
    score_thr: float = 0.3
    nms_iou_thr: float = 0.1
    anchor_thr: float = 0.1
    nms_pre: int = 2000
    serve_persistent_plans: bool = False
    # "voxels": the loader voxelizes and masks on the host; "points": only
    # raw padded points are uploaded and the card voxelizes, masks and
    # builds the rulebook (serve.py)
    device_input: str = "voxels"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    class_names: Tuple[str, ...] = ("Car",)
    anchor_area_threshold: float = 1.0
    out_size_factor: int = 8
    # GT-sampling augmentation: runs only with a GT database configured
    gt_sampling: bool = True
    db_info_path: str = ""
    num_workers: int = 4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 2
    total_epochs: int = 80
    lr: float = 0.003
    weight_decay: float = 0.01
    # "exclude_bn_bias": decay only conv/linear kernels ("w" leaves)
    weight_decay_mode: str = "exclude_bn_bias"
    grad_clip_norm: float = 10.0
    # one-cycle schedule
    moms: Tuple[float, float] = (0.95, 0.85)
    div_factor: float = 10.0
    pct_start: float = 0.4
    anchor_thr: float = 0.1            # guided-anchor score threshold
    extra_pos_iou: float = 0.7         # PSWarp assigner (3D IoU)
    extra_neg_iou: float = 0.7
    rpn_similarity: str = "NearestIouSimilarity"
    checkpoint_interval: int = 2       # epochs
    checkpoint_every_steps: int = 0    # mid-epoch saves every N steps
    max_ckpt_keep: int = 10
    log_interval: int = 20
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh layout of the JAX package; the port runs "data" on one device
    (spatial and banded sharding raise in check_supported)."""
    strategy: str = "data"
    spatial: int = 1


@dataclasses.dataclass(frozen=True)
class SASSDConfig:
    model: ModelConfig = ModelConfig()
    voxel: VoxelConfig = VoxelConfig()
    caps: Caps = Caps()
    anchors: Dict[str, AnchorConfig] = dataclasses.field(
        default_factory=lambda: {"Car": AnchorConfig()})
    test: TestConfig = TestConfig()
    data: DataConfig = DataConfig()
    parallel: ParallelConfig = ParallelConfig()
    train: TrainConfig = TrainConfig()

    @property
    def class_names(self) -> Tuple[str, ...]:
        return tuple(self.anchors.keys())

    @property
    def sparse_shape(self) -> Tuple[int, int, int]:
        return self.voxel.sparse_shape

    @property
    def bev_map_size(self) -> Tuple[int, int]:
        """(H, W) of the BEV feature map (grid // out_size_factor)."""
        d, h, w = self.voxel.sparse_shape
        f = self.data.out_size_factor
        return h // f, w // f

    @property
    def num_anchors(self) -> int:
        h, w = self.bev_map_size
        return len(self.anchors) * h * w * self.model.num_anchor_per_loc


def check_supported(cfg: SASSDConfig, train: bool = False) -> None:
    """Raise NotImplementedError for options the port does not run.

    Without host plans, and always with ``test.device_input="points"``,
    the port builds the rulebook on the device the one way the JAX package
    does by default: dense index maps, key-sorted levels, windowed plan
    lookups. Training (`train=True`) runs on host plans, with the ring aux
    interpolation, the one-cycle AdamW and no GT-sampling database.
    """
    m, t, p, d = cfg.model, cfg.test, cfg.parallel, cfg.data
    unsupported = {
        "model.dense_index=False": not m.dense_index,
        "model.sorted_device_levels=False": not m.sorted_device_levels,
        f"model.plan_lookup={m.plan_lookup!r}": m.plan_lookup != "dense",
        "model.dense_tail=False": not m.dense_tail,
        f"model.vfe_type={m.vfe_type!r}": m.vfe_type != "mean",
        f"model.compute_dtype={m.compute_dtype!r}":
            m.compute_dtype != "float32",
        f"test.device_input={t.device_input!r}":
            t.device_input not in ("voxels", "points"),
        "test.serve_persistent_plans=True": t.serve_persistent_plans,
        f"parallel.strategy={p.strategy!r} with spatial={p.spatial}":
            p.strategy != "data" and p.spatial > 1,
    }
    if train:
        unsupported.update({
            f"model.aux_interp={m.aux_interp!r}": m.aux_interp != "ring",
            "training with model.host_plans=False": not m.host_plans,
            "data.gt_sampling with data.db_info_path":
                d.gt_sampling and bool(d.db_info_path),
            f"train.weight_decay_mode={cfg.train.weight_decay_mode!r}":
                cfg.train.weight_decay_mode != "exclude_bn_bias",
            f"train.rpn_similarity={cfg.train.rpn_similarity!r}":
                cfg.train.rpn_similarity not in (
                    "NearestIouSimilarity", "RotateIou3dSimilarity"),
        })
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            "sassd_tpu_torch does not run " + ", ".join(bad))


def car_config(**overrides) -> SASSDConfig:
    """The single-class KITTI Car configuration."""
    return SASSDConfig(**overrides)


def tiny_config(**overrides) -> SASSDConfig:
    """The full topology at toy shapes (tests)."""
    base = dict(
        model=ModelConfig(num_class=1, bev_channels=32, num_parts=28,
                          grid_offsets=(0.0, 3.2), featmap_stride=0.8),
        voxel=VoxelConfig(voxel_size=(0.1, 0.1, 0.5),
                          point_cloud_range=(0.0, -3.2, -2.5, 6.4, 3.2, 1.5),
                          max_num_points=5, max_voxels=512),
        caps=Caps(max_points_per_scan=2048, max_gt=8,
                  level_caps=(512, 512, 384, 256),
                  guided_train=40, guided_test=32, max_det=16),
        anchors={"Car": AnchorConfig(
            sizes=(1.6, 3.9, 1.56), strides=(0.8, 0.8, 1.0),
            offsets=(0.4, -2.8, -1.0))},
    )
    base.update(overrides)
    return SASSDConfig(**base)
