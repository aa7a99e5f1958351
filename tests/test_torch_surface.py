"""A guard against gaps between the JAX package and the port: every public
top-level function or class of each ``sassd_tpu/**/*.py`` (parsed with
ast, not imported) has a namesake in the matching ``sassd_tpu_torch``
module, or an entry in COUNTERPARTS below. An entry names the port's
counterpart (``module:attribute``, which must import and resolve) or
cites the "Not ported" list of ROADMAP.md (a phrase that must stand in
that list). One case per JAX module.
"""
import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "sassd_tpu"
PORT_PKG = REPO / "sassd_tpu_torch"
# JAX modules whose port module has another path
MOVED = {"ops/pallas/riou_kernel.py": "ops/riou_kernel.py"}


class NotPorted(str):
    """A phrase of ROADMAP.md's "Not ported" list."""


BINARY_SEARCH = NotPorted("`dense_index=False` (the binary-search path)")
WINDOW_TABLE = NotPorted("including `build_window_table`")
DENSE_LEVELS = NotPorted("`sorted_device_levels=False`")
TPU_HOSTS = NotPorted("`HostStager` and `batch_pack_layout`")
NO_CALL_SITE = NotPorted("helpers with no call site")

COUNTERPARTS = {
    "core/riou.py": {
        "rotate_overlap_bev": "ops.riou_kernel:rotate_overlap",
        "rotate_overlap_bev_np": "core.riou_np:rotate_overlap_bev_np",
        "rotate_iou_eval_np": "core.riou_np:rotate_iou_eval_np",
    },
    "models/backbone.py": {
        "vfe_pointnet_init": "models.backbone:PointNetVFE",
        "vfe_pointnet_apply": "models.backbone:PointNetVFE.forward",
        "vxnet_init": "models.backbone:VxNet",
        "vxnet_apply": "models.backbone:VxNet.forward",
        "densify_bev": "ops.sparse:densify_nchw",
    },
    "models/bev.py": {
        "bevnet_init": "models.bev:BEVNet",
        "bevnet_apply": "models.bev:BEVNet.forward",
    },
    "models/detector.py": {
        "detector_init": "models.detector:Detector",
        "forward_spine": "models.detector:Detector.forward_spine",
        "aux_forward": "models.detector:Detector.aux_forward",
        "forward_train": "models.detector:Detector.forward_train",
        "forward_test": "models.detector:Detector.forward_test",
    },
    "models/layers.py": {
        "linear_init": "models.backbone:Linear",
        "linear": "models.backbone:Linear.forward",
        "conv2d_init": "models.layers:Conv2d",
        "sparse_conv3_init": "models.layers:SparseConv3",
        "bn_init": "models.layers:BatchNorm",
        "conv3d": NO_CALL_SITE,
        "maxpool3d_stride2": NO_CALL_SITE,
    },
    "models/pswarp.py": {
        "pswarp_init": "models.pswarp:PSWarpHead",
        "pswarp_apply": "models.pswarp:PSWarpHead.forward",
    },
    "models/ssd_head.py": {
        "head_init": "models.ssd_head:SSDHead",
        "head_apply": "models.ssd_head:SSDHead.forward",
        "flat_anchors": "data.kitti:build_anchors",
    },
    "ops/native.py": {
        "build": "ops.native:load",
        "available": "ops.native:load",
    },
    "ops/pallas/riou_kernel.py": {
        "rotate_overlap_green": "ops.riou_kernel:rotate_overlap",
    },
    "ops/sparse.py": {
        "sort_by_key": NO_CALL_SITE,
        "valid_mask": NO_CALL_SITE,
        "stride_conv": NO_CALL_SITE,
        "lookup": BINARY_SEARCH,
        "lookup_dense": "ops.sparse:window_plans",
        "lookup_dense3": "ops.sparse:window_plans",
        "lookup_sorted3": "ops.sparse:lookup_sorted3_plain",
        "WindowTable": WINDOW_TABLE,
        "build_window_table": WINDOW_TABLE,
        "lookup_table3": WINDOW_TABLE,
        "build_subm_plan": "ops.sparse:window_plan",
        "build_stride_plan": "ops.sparse:window_plan",
        "build_stride_plan_T": "ops.sparse:stride_plans_T",
        "build_aux_plan": "ops.sparse:aux_plans",
        "gather_im2col_triple": "ops.sparse:gather_im2col",
        "gather_im2col_strideT3": "ops.sparse:stride_conv_hostT",
        "stride_conv_hostT_batched": "ops.sparse:stride_conv_hostT",
        "downsample_keys_with_map": DENSE_LEVELS,
        "downsample_keys_dense": DENSE_LEVELS,
        "conv1x1": "models.layers:conv2d_nchw",
    },
    "ops/voxelize.py": {
        "voxelize_jax": "ops.voxelize:voxelize",
        "points_to_bev_jax": "ops.voxelize:points_to_bev",
    },
    "ops/warp.py": {
        "bilinear_sample_per_part_packed": "ops.warp:bilinear_sample_per_part",
    },
    "parallel/mesh.py": {
        "make_mesh": "parallel.mesh:layout",
        "batch_spec": "parallel.mesh:host_shard_info",
        "shard_batch": "parallel.mesh:host_shard_info",
        "replicated": "parallel.dist:all_reduce_coalesced",
        "replicate": "parallel.dist:all_reduce_coalesced",
        "num_data_shards": "parallel.mesh:Layout",
    },
    "parallel/sparse_spatial.py": {
        "forward_train_banded": "models.detector:Detector.forward_train",
        "forward_test_banded": "models.detector:Detector.forward_test",
        "make_banded_test_step": "inference:make_test_step",
        "make_banded_train_step": "train.loop:make_train_step",
    },
    "parallel/spatial.py": {
        "bev_sharding": "parallel.spatial:canvas_slice",
        "make_spatial_test_step": "inference:make_test_step",
        "make_spatial_train_step": "train.loop:make_train_step",
    },
    "serve.py": {
        "separable_corners": "serve:anchor_lattice",
        "anchors_mask_jax": "serve:anchors_mask",
        "anchors_mask_jax_separable": "serve:anchors_mask",
    },
    "train/loop.py": {
        "batch_pack_layout": TPU_HOSTS,
        "pack_batch": TPU_HOSTS,
        "unpack_batch": TPU_HOSTS,
        "HostStager": TPU_HOSTS,
        "make_strategy_train_step": "train.loop:make_train_step",
    },
    "train/optim.py": {
        "current_hyperparams": "train.optim:AdamW.hyperparams",
    },
    "utils/cache.py": {
        "default_cache_dir": NotPorted("`utils/cache.py`"),
        "enable_compilation_cache": NotPorted("`utils/cache.py`"),
    },
}

JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                     for p in JAX_PKG.rglob("*.py"))


def public_names(path: pathlib.Path):
    return [n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def defined_names(path: pathlib.Path) -> set:
    """Top-level functions, classes, assigned and imported names of a
    module."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.ImportFrom):
            out.update(a.asname or a.name for a in n.names)
    return out


def not_ported_list() -> str:
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("**Not ported.**")
    return text[start:text.index("\n\n", text.index("\n- ", start))]


def resolve(target: str):
    module, attr = target.split(":")
    obj = importlib.import_module(f"sassd_tpu_torch.{module}")
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def test_counterparts_name_jax_modules():
    assert set(COUNTERPARTS) <= set(JAX_MODULES)
    assert set(MOVED) <= set(JAX_MODULES)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_public_names_have_port_counterparts(rel):
    names = public_names(JAX_PKG / rel)
    port = PORT_PKG / MOVED.get(rel, rel)
    have = defined_names(port) if port.exists() else set()
    mapped = COUNTERPARTS.get(rel, {})
    assert set(mapped) <= set(names), "a stale entry"
    roadmap = not_ported_list()
    for name in names:
        if name in mapped:
            assert name not in have, f"{name}: a namesake and an entry"
            target = mapped[name]
            if isinstance(target, NotPorted):
                assert target in roadmap, (name, target)
            else:
                assert resolve(target) is not None, (name, target)
        else:
            assert name in have, f"{rel}: {name} has no counterpart"
