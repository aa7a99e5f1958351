"""Configuration dataclasses read by the PyTorch port, and the loader of
the repo's config files.

The fields and defaults are those of ``sassd_tpu.config`` (and of
``sassd_tpu.ops.voxelize.VoxelConfig``). Layout knobs of the JAX package
that do not change numerics (``triple_gather``, ``flat_batch``,
``fold_head``, ``packed_warp``, ...) are not carried: the port implements
one form of each. Options the port does not run raise
``NotImplementedError`` in :func:`check_supported`.

:func:`load_config` runs a config file of ``configs/`` (written against
``sassd_tpu.config``) and returns this module's :class:`SASSDConfig`.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys
import types
from typing import Dict, Optional, Tuple

import numpy as np

from sassd_tpu_torch.parallel import dist


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
    # declared by the JAX package and read by neither package
    use_direction_classifier: bool = True
    encode_rad_error_by_sin: bool = True
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
    # query's parent cell (the rulebook's aux plans); "exact" = every
    # active cell of the level (ops.interpolate.three_nn_interpolate)
    aux_interp: str = "ring"


@dataclasses.dataclass(frozen=True)
class TestConfig:
    score_thr: float = 0.3
    nms_iou_thr: float = 0.1
    max_per_img: int = 100             # not read (caps.max_det bounds it)
    anchor_thr: float = 0.1
    nms_pre: int = 2000
    serve_persistent_plans: bool = False
    # "voxels": the loader voxelizes and masks on the host; "points": only
    # raw padded points are uploaded and the card voxelizes, masks and
    # builds the rulebook (serve.py)
    device_input: str = "voxels"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    root: str = ""                     # KITTI root: training/, ImageSets/
    info_path: str = ""                # train split file (default
                                       # root/ImageSets/train.txt)
    class_names: Tuple[str, ...] = ("Car",)
    anchor_area_threshold: float = 1.0
    out_size_factor: int = 8
    # training augmentation (data.augment.PointAugmentor); it runs only
    # with a GT database configured (db_info_path, data.create_data)
    gt_sampling: bool = True
    db_info_path: str = ""
    sample_classes: Tuple[str, ...] = ("Car",)
    sample_max_num: Tuple[int, ...] = (15,)
    min_num_points: Tuple[int, ...] = (5,)
    removed_difficulties: Tuple[int, ...] = (-1,)
    global_rot_range: Tuple[float, float] = (-0.78539816, 0.78539816)
    gt_rot_range: Tuple[float, float] = (-0.78539816, 0.78539816)
    center_noise_std: Tuple[float, float, float] = (1.0, 1.0, 0.5)
    scale_range: Tuple[float, float] = (0.95, 1.05)
    flip_ratio: float = 0.5
    num_workers: int = 4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 2
    total_epochs: int = 80
    lr: float = 0.003
    weight_decay: float = 0.01
    # "exclude_bn_bias": decay only conv/linear kernels ("w" leaves);
    # "all": decay every parameter
    weight_decay_mode: str = "exclude_bn_bias"
    grad_clip_norm: float = 10.0
    # one-cycle schedule
    moms: Tuple[float, float] = (0.95, 0.85)
    div_factor: float = 10.0
    pct_start: float = 0.4
    # cosine warmup prefix of the non-onecycle optimizers: lr rises from
    # lr * warmup_ratio to lr over the first warmup_iters steps
    warmup_iters: int = 0
    warmup_ratio: float = 0.1
    anchor_thr: float = 0.1            # guided-anchor score threshold
    extra_pos_iou: float = 0.7         # PSWarp assigner (3D IoU)
    extra_neg_iou: float = 0.7
    extra_similarity: str = "RotateIou3dSimilarity"   # not read
    rpn_similarity: str = "NearestIouSimilarity"
    # the JAX loop's bound on steps in flight; accepted and not read: the
    # port's step reads its non-finite check back, once a step
    max_inflight_steps: int = 2
    checkpoint_interval: int = 2       # epochs
    checkpoint_every_steps: int = 0    # mid-epoch saves every N steps
    max_ckpt_keep: int = 10
    log_interval: int = 20
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh layout of the JAX package. The port runs on one device:
    "data", and "banded" with ``spatial`` > 1 y-bands of the sparse stage,
    every band a batch row (parallel/sparse_spatial.py); "spatial" raises
    in check_supported.

    band_halo: level-0 y halo cells on each side of a band ("banded").
    band_cap_margin: per-band cap safety factor over the band's covered
      fraction of the grid ("banded"; an undersized cap shows as the
      ``band_overflow`` train metric)."""
    strategy: str = "data"
    spatial: int = 1
    band_halo: int = 64
    band_cap_margin: float = 1.5


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
    work_dir: str = "./work_dir"
    resume_from: Optional[str] = None  # a checkpoint to resume (.pt or a
                                       # JAX .msgpack)
    load_from: Optional[str] = None    # parameters to start from

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


def banded(cfg: SASSDConfig) -> bool:
    """Whether the sparse stage runs in y-bands (strategy "banded" with
    more than one band); any other strategy with spatial <= 1 runs
    replicated, as in the JAX package's train loop."""
    return cfg.parallel.strategy == "banded" and cfg.parallel.spatial > 1


def check_supported(cfg: SASSDConfig, train: bool = False) -> None:
    """Raise NotImplementedError for options the port does not run.

    Without host plans, and always with ``test.device_input="points"``,
    the port builds the rulebook on the device the one way the JAX package
    does by default: dense index maps, key-sorted levels, windowed plan
    lookups; in training also the transpose and aux plans. Training
    (`train=True`) runs on either rulebook, with either aux interpolation,
    the GT-sampling augmentor and the one-cycle AdamW. The banded sparse
    stage always builds its rulebook on the device; its training takes
    the ring aux only (ValueError otherwise, as in the JAX package: the
    exact 3-NN is not band-local), and runs in one process: banded across
    the ranks of a process group is refused; the data strategy runs on
    any number of ranks. The PointNet VFE runs on the replicated spine
    only (the JAX package's banded stage ignores it and encodes by the
    mean).
    """
    m, t, p = cfg.model, cfg.test, cfg.parallel
    if train and banded(cfg) and m.aux_interp != "ring":
        raise ValueError("banded sharding requires aux_interp='ring' "
                         "(exact 3-NN is not band-local)")
    unsupported = {
        "model.dense_index=False": not m.dense_index,
        "model.sorted_device_levels=False": not m.sorted_device_levels,
        f"model.plan_lookup={m.plan_lookup!r}": m.plan_lookup != "dense",
        "model.dense_tail=False": not m.dense_tail,
        f"model.vfe_type={m.vfe_type!r}":
            m.vfe_type not in ("mean", "pointnet"),
        "model.vfe_type='pointnet' with the banded sparse stage":
            m.vfe_type == "pointnet" and banded(cfg),
        f"model.compute_dtype={m.compute_dtype!r}":
            m.compute_dtype != "float32",
        f"test.device_input={t.device_input!r}":
            t.device_input not in ("voxels", "points"),
        "test.serve_persistent_plans=True": t.serve_persistent_plans,
        f"parallel.strategy={p.strategy!r} with spatial={p.spatial}":
            p.strategy not in ("data", "banded") and p.spatial > 1,
        # the JAX package runs bands on a data x spatial mesh; the port
        # keeps every band on its own rank's device (ROADMAP A.3)
        "parallel.strategy='banded' across data-parallel ranks":
            banded(cfg) and dist.process_count() > 1,
    }
    if train:
        unsupported.update({
            f"model.aux_interp={m.aux_interp!r}":
                m.aux_interp not in ("ring", "exact"),
            f"train.weight_decay_mode={cfg.train.weight_decay_mode!r}":
                cfg.train.weight_decay_mode not in ("exclude_bn_bias", "all"),
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


def multi_config(**overrides) -> SASSDConfig:
    """The three-class Car/Pedestrian/Cyclist configuration: the car grid
    with one anchor set per class (class-major), per-class assigner
    thresholds, and GT sampling of all three classes."""
    anchors = {
        "Car": AnchorConfig(sizes=(1.6, 3.9, 1.56),
                            matched_threshold=0.6, unmatched_threshold=0.45),
        "Pedestrian": AnchorConfig(sizes=(0.6, 0.8, 1.73),
                                   matched_threshold=0.5,
                                   unmatched_threshold=0.35),
        "Cyclist": AnchorConfig(sizes=(0.6, 1.76, 1.73),
                                matched_threshold=0.5,
                                unmatched_threshold=0.35),
    }
    base = dict(
        model=ModelConfig(num_class=3),
        anchors=anchors,
        data=DataConfig(class_names=("Car", "Pedestrian", "Cyclist"),
                        sample_classes=("Car", "Pedestrian", "Cyclist"),
                        sample_max_num=(15, 10, 10),
                        min_num_points=(5, 5, 5)),
    )
    base.update(overrides)
    return SASSDConfig(**base)


def long_range_config(**overrides) -> SASSDConfig:
    """The long-range stress configuration: 0-102.4 m at the car voxel
    size (grid [40, 1600, 2048], ~4x the car voxel budget)."""
    base = dict(
        voxel=VoxelConfig(voxel_size=(0.05, 0.05, 0.1),
                          point_cloud_range=(0.0, -40.0, -3.0, 102.4, 40.0,
                                             1.0),
                          max_num_points=5, max_voxels=80000),
        caps=Caps(max_points_per_scan=262144, max_gt=64,
                  level_caps=(80000, 73728, 57344, 40960),
                  guided_train=640, guided_test=2048, max_det=100),
        anchors={"Car": AnchorConfig(
            sizes=(1.6, 3.9, 1.56), strides=(0.4, 0.4, 1.0),
            offsets=(0.2, -39.8, -1.78))},
    )
    base.update(overrides)
    return SASSDConfig(**base)


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


def load_config(path: str) -> SASSDConfig:
    """Run a python config file that defines ``config`` and return it.

    The repo's config files import ``sassd_tpu.config`` (``from
    sassd_tpu.config import car_config``, or ``import sassd_tpu.config``).
    While the file runs, ``sys.modules`` maps ``sassd_tpu.config`` to this
    module and ``sassd_tpu`` to a bare package holding only it, so both
    forms build the port's dataclasses and nothing of the JAX package is
    imported; afterwards both entries are restored to what they were (the
    JAX modules, when this process has them loaded), also when the file
    raises. The limit: a config file can reach only ``sassd_tpu.config``;
    any other ``sassd_tpu`` module (``from sassd_tpu.models import ...``)
    raises ImportError while the file runs.

    Raises TypeError when the file does not define a port SASSDConfig
    named ``config``.
    """
    this = sys.modules[__name__]
    parent = types.ModuleType("sassd_tpu")
    parent.__path__ = []                   # a package with no submodules
    parent.config = this
    bound = {"sassd_tpu": parent, "sassd_tpu.config": this}
    saved = {k: sys.modules.get(k) for k in bound}
    spec = importlib.util.spec_from_file_location("_sassd_torch_user_config",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.update(bound)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    cfg = getattr(mod, "config", None)
    if not isinstance(cfg, SASSDConfig):
        raise TypeError(f"{path} must define `config: SASSDConfig`")
    return cfg
