"""Port parity for model.plan_lookup="sorted": the device rulebook's plans
resolved by binary search over each level's sorted keys, with no index
map (K18 sorted_window_plans, K19 sorted_stride_plans_T, K20
sorted_aux_plans; ops/sparse.py), and the level-0 producers the sorted
path meets, whose ascending keys every search assumes.

The plain versions run here (CPU tensors). Plans are integers and must be
equal bit for bit: to the JAX package's lookup_sorted3 and its
sorted_lookup=True, out_sorted_keys= and level_sorted_keys= builders
(taken as where(found, idx, -1)), and to the port's dense-map plans.
The forward, serving and train steps on the sorted path are held to the
JAX package beside their dense-map tests, on the same fixtures
(test_torch_device_plans.py, test_torch_serve.py,
test_torch_train_device_plans.py, test_torch_persistent_serving.py).
"""
import functools
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from sassd_tpu.ops import sparse as jsp  # noqa: E402
from sassd_tpu_torch import config  # noqa: E402
from sassd_tpu_torch.data import kitti  # noqa: E402
from sassd_tpu_torch.models import backbone  # noqa: E402
from sassd_tpu_torch.ops import sparse as sp  # noqa: E402
from sassd_tpu_torch.ops.voxelize import voxelize_plain  # noqa: E402
from sassd_tpu_torch.parallel import sparse_spatial as ss  # noqa: E402
from test_torch_banded import band_rows  # noqa: E402
from test_torch_cases import (FULL_GRIDS, K13_CASES,  # noqa: E402
                              full_grid_levels, k13_case)
from test_torch_device_plans import (SCAN_PLAN_CASES, SHAPE,  # noqa: E402
                                     batch_keys)
from test_torch_serve import padded, scene_points, uniform_points  # noqa: E402
from test_torch_train_device_plans import (AUX_CASES, aux_case,  # noqa: E402
                                           level_keys_and_maps, level_maps,
                                           level_shapes, tiny_scans)

INVALID = sp.INVALID_KEY


@functools.lru_cache(maxsize=None)
def jax_sorted_plans(kind, shapes):
    """One sample's plans of the JAX package's sorted builders, jitted
    (its eager searchsorted compiles an op at a time; cases whose samples
    share shapes share a compile), in the wire format: "scan" the six
    plans of the keys of levels 0-3, "strideT" the three transpose plans
    of the keys of levels 0-3, "aux" the three aux plans of level-0 cells
    and the keys of levels 1-3; shapes is the four level grids."""
    def scan(keys):
        out = []
        for lvl in range(3):
            out += [jsp.build_subm_plan(keys[lvl], shapes[lvl],
                                        sorted_lookup=True),
                    jsp.build_stride_plan(keys[lvl], keys[lvl + 1],
                                          shapes[lvl], sorted_lookup=True)]
        return [jnp.where(p.found, p.idx, -1) for p in out]

    def stride_t(keys):
        return [jnp.where(p.found, p.idx, -1) for p in (
            jsp.build_stride_plan_T(keys[lvl], shapes[lvl],
                                    out_sorted_keys=keys[lvl + 1])
            for lvl in range(3))]

    def aux(cell0, keys):
        return [jsp.build_aux_plan(cell0, lvl, None, shapes[lvl],
                                   level_sorted_keys=keys[lvl - 1])
                for lvl in (1, 2, 3)]
    return jax.jit({"scan": scan, "strideT": stride_t, "aux": aux}[kind])


def jax_plans(kind, shapes, *args):
    """jax_sorted_plans of each sample of the [B, ...] tensors in args
    (lists of tensors taken level by level), stacked: [plan][B, 27, M]."""
    shapes = tuple(tuple(int(v) for v in s) for s in shapes)
    fn = jax_sorted_plans(kind, shapes)
    b = (args[0][0] if isinstance(args[0], list) else args[0]).shape[0]
    out = []
    for i in range(b):
        sample = [[jnp.asarray(t[i].numpy()) for t in a]
                  if isinstance(a, list) else jnp.asarray(a[i].numpy())
                  for a in args]
        out.append([np.asarray(p) for p in fn(*sample)])
    return [np.stack(p) for p in zip(*out)]
# lookup_sorted3's cases: keys at the grid's first and last cells with
# queries whose window runs past the last; the padding query of a group
# off the grid (INVALID_KEY - 3); a row of no key; a row of one key
LOOKUP_CASES = ["grid_ends", "padding_queries", "all_invalid", "single_key"]


def lookup_case(case):
    """([B, cap] int32 ascending keys on SHAPE's grid, INVALID tail;
    [B, N] int32 window starts) of a lookup_sorted3 case."""
    rng = np.random.default_rng(LOOKUP_CASES.index(case))
    total = int(np.prod(SHAPE))
    keys = np.full((2, 64), INVALID, np.int32)
    for b, n in enumerate((40, 57)):
        lin = np.unique(np.concatenate([rng.choice(total, n), [0,
                                                               total - 1]]))
        keys[b, :len(lin)] = lin
    if case == "all_invalid":
        keys[1] = INVALID
    if case == "single_key":
        keys[0] = INVALID
        keys[0, 0] = 17
    starts = rng.integers(-1, total, (2, 200)).astype(np.int32)
    starts[:, :6] = [-1, 0, 1, total - 3, total - 2, total - 1]
    starts[:, 6:30] = keys[:, :24] - rng.integers(0, 3, (2, 24))
    if case == "single_key":
        starts[0, 30:33] = [15, 16, 17]
    if case == "padding_queries":
        starts[:, 1::3] = INVALID - 3
    return keys, starts


@pytest.mark.parametrize("case", LOOKUP_CASES)
def test_lookup_sorted3_matches_jax(case):
    """Rows (clipped, as JAX clips them) and found flags of
    lookup_sorted3_plain == JAX lookup_sorted3, sample by sample."""
    keys, starts = lookup_case(case)
    rows, found = sp.lookup_sorted3_plain(torch.from_numpy(keys),
                                          torch.from_numpy(starts))
    assert rows.shape == found.shape == starts.shape + (3,)
    for b in range(2):
        jr, jf = jsp.lookup_sorted3(jnp.asarray(keys[b]),
                                    jnp.asarray(starts[b]))
        np.testing.assert_array_equal(rows[b].numpy(), np.asarray(jr))
        np.testing.assert_array_equal(found[b].numpy(), np.asarray(jf))
    assert int(found[0].sum()) > 0
    if case == "padding_queries":
        assert not found[:, 1::3].any()
    if case == "all_invalid":
        assert not found[1].any()


@pytest.mark.parametrize("case", sorted(SCAN_PLAN_CASES))
def test_sorted_scan_plans_match_jax_and_dense(case):
    """The six plans of one sorted_window_plans call == the port's dense
    plans (rulebook_plans through K6's maps) == JAX build_subm_plan /
    build_stride_plan with sorted_lookup=True, bitwise."""
    rows, caps = SCAN_PLAN_CASES[case]
    keys = batch_keys(6)[list(rows)]
    shapes = [SHAPE]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    lk = [torch.from_numpy(keys)]
    for lvl in (1, 2, 3):
        lk.append(sp.downsample_keys(lk[-1], shapes[lvl - 1], caps[lvl - 1]))
    got = sp.sorted_rulebook_plans(lk, shapes)
    dense = sp.rulebook_plans(lk, shapes, [sp.build_index_map(k, s)
                                           for k, s in zip(lk[:3], shapes)])
    assert list(got) == list(sp.RULEBOOK_PLANS)
    for name in sp.RULEBOOK_PLANS:
        assert got[name].dtype == torch.int32
        assert torch.equal(got[name], dense[name]), name
    for name, ref in zip(sp.RULEBOOK_PLANS, jax_plans("scan", shapes, lk)):
        np.testing.assert_array_equal(got[name].numpy(), ref, err_msg=name)
    assert (got["subm0"] >= 0).sum() > 100 and (got["stride3"] >= 0).any()


@pytest.mark.parametrize("case", K13_CASES + list(FULL_GRIDS))
def test_sorted_stride_plans_T_match_jax_and_dense(case):
    """sorted_stride_plans_T on K13's cases (rows on every grid face with W
    odd and even, levels cut by their caps, band rows with a y limit,
    padding between valid rows, an all-padded sample) and on every cell of
    an odd and an even grid (every z, y and x parity) == stride_plans_T
    through the output levels' maps == JAX build_stride_plan_T with
    out_sorted_keys, bitwise. Only the output levels are searched, so
    padding between level-0 rows is allowed."""
    keys, shapes = (full_grid_levels(case) if case in FULL_GRIDS
                    else k13_case(case)[:2])
    got = sp.sorted_stride_plans_T(keys[:3], keys[1:], shapes)
    dense = sp.stride_plans_T(keys[:3], level_maps(keys, shapes), shapes)
    refs = jax_plans("strideT", shapes, keys)
    for lvl in (1, 2, 3):
        assert got[lvl - 1].dtype == torch.int32
        assert torch.equal(got[lvl - 1], dense[lvl - 1]), lvl
        np.testing.assert_array_equal(got[lvl - 1].numpy(), refs[lvl - 1])
    assert all(int((g >= 0).sum()) > 0 for g in got)


@pytest.mark.parametrize("case", AUX_CASES)
def test_sorted_aux_plans_match_jax_and_dense(case):
    """sorted_aux_plans on K14's cases == aux_plans through the levels'
    maps == JAX build_aux_plan with level_sorted_keys, bitwise; a padded
    query row is -1 on all 27 taps."""
    coords, cell0, shapes, caps = aux_case(case)
    keys, maps = level_keys_and_maps(coords, shapes, caps)
    got = sp.sorted_aux_plans(cell0, keys, shapes[1:])
    b, m0, _ = cell0.shape
    assert got.shape == (3, b, 27, m0) and got.dtype == torch.int32
    assert torch.equal(got, sp.aux_plans(cell0, maps, shapes[1:]))
    for lvl, ref in enumerate(jax_plans("aux", shapes, cell0, keys), 1):
        np.testing.assert_array_equal(got[lvl - 1].numpy(), ref)
    padded_rows = cell0[..., 0] < 0
    assert (got.permute(0, 1, 3, 2)[:, padded_rows] == -1).all()
    assert all(int((got[lvl] >= 0).sum()) > 100 for lvl in range(3))


def banded_keys():
    """The band rows of test_torch_banded's tall batch: level-0 keys on
    the band grid, the grids, the caps of levels 1-3 and the rows' y
    limits."""
    cfg, spec, bc, _, _, _ = band_rows(3)
    shapes = backbone.level_shapes(ss.band_shape(cfg, spec))
    cell0 = bc.reshape(-1, bc.shape[2], 3)
    return (sp.coords_to_keys(cell0, shapes[0]), shapes, spec.caps[1:],
            ss.y_top_rows(cfg, spec, bc.shape[1], "cpu"))


# device_rulebook's paths: the serving rulebook, the train rulebook with
# and without the aux plans, and the banded stage's (band rows, y limits)
RULEBOOK_MODES = ["serving", "train_ring", "train_exact", "banded_train"]


@pytest.mark.parametrize("mode", RULEBOOK_MODES)
def test_device_rulebook_sorted_matches_dense(mode, monkeypatch):
    """device_rulebook(plan_lookup="sorted") == "dense", key for key,
    without building an index map or calling K6's, K13's or K14's
    wrappers; the dense path calls none of K18-K20's."""
    if mode == "banded_train":
        keys0, shapes, caps, y_top = banded_keys()
    else:
        cfg, batch = tiny_scans(4)
        shapes = level_shapes(cfg)
        keys0 = sp.coords_to_keys(torch.from_numpy(batch["coords"]),
                                  shapes[0])
        caps, y_top = cfg.caps.level_caps[1:], None
    kw = dict(train=mode != "serving", aux=mode != "train_exact",
              y_top=y_top)
    calls = []

    def spy(name):
        fn = getattr(sp, name)

        def run(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(sp, name, run)
    dense_fns = ("build_index_map", "window_plans", "stride_plans_T",
                 "aux_plans")
    sorted_fns = ("sorted_window_plans", "sorted_stride_plans_T",
                  "sorted_aux_plans")
    for name in dense_fns + sorted_fns:
        spy(name)
    dense = sp.device_rulebook(keys0, shapes, caps, **kw)
    assert not set(calls) & set(sorted_fns)
    calls.clear()
    got = sp.device_rulebook(keys0, shapes, caps, plan_lookup="sorted", **kw)
    want = ["sorted_window_plans"]
    if mode != "serving":
        want.append("sorted_stride_plans_T")
    if mode in ("train_ring", "banded_train"):
        want.append("sorted_aux_plans")
    assert calls == want
    assert list(got) == list(dense)
    for k, v in dense.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert ("aux1" in got) == (mode in ("train_ring", "banded_train"))
    assert int((got["subm0"] >= 0).sum()) > 100
    with pytest.raises(ValueError, match="plan_lookup"):
        sp.device_rulebook(keys0, shapes, caps, plan_lookup="hashed")


def assert_ascending(keys, what):
    """Each row's valid keys ascend strictly, INVALID_KEY after them."""
    k = keys.to(torch.int64)
    valid = k != INVALID
    assert (valid[:, 1:] <= valid[:, :-1]).all(), f"{what}: padding between"
    step = k[:, 1:] - k[:, :-1]
    assert (step[valid[:, 1:]] > 0).all(), f"{what}: not ascending"


def test_host_voxelizer_keys_ascend():
    """The C++ host voxelizer through prepare_scan (the loaders' level 0)
    emits ascending keys: tiny scans under the cap and a scan over it."""
    cfg = config.tiny_config()
    _, anchors_bv = kitti.build_anchors(cfg)
    rng = np.random.default_rng(31)
    scans = [scene_points(cfg, rng) for _ in range(2)]
    scans.append(uniform_points(cfg, rng, 2000))
    n = []
    for raw in scans:
        c = kitti.prepare_scan(cfg, raw, anchors_bv)["coords"]
        assert_ascending(sp.coords_to_keys(torch.from_numpy(c[None]),
                                           cfg.sparse_shape), "host")
        n.append(int((c[:, 0] >= 0).sum()))
    assert min(n) > 50 and max(n) == cfg.voxel.max_voxels


def test_device_voxelizer_keys_ascend():
    """K8's plain version (the serving step's level 0) emits ascending
    keys: a batch with a scan over the voxel cap and an empty one."""
    cfg = config.tiny_config()
    rng = np.random.default_rng(32)
    scans = [scene_points(cfg, rng), np.zeros((0, 4), np.float32),
             uniform_points(cfg, rng, 2000)]
    pts, npts = padded(cfg, scans)
    _, coords, _ = voxelize_plain(torch.from_numpy(pts),
                                  torch.from_numpy(npts), cfg.voxel)
    keys = sp.coords_to_keys(coords, cfg.sparse_shape)
    assert_ascending(keys, "K8 plain")
    n = (keys != INVALID).sum(1).tolist()
    assert n[1] == 0 and n[0] > 50 and n[2] == cfg.voxel.max_voxels


def test_band_partition_keys_ascend():
    """K16's plain band partition keeps each band row's members in (z, y,
    x) order, so band keys ascend on the band grid."""
    keys0, _, _, _ = banded_keys()
    assert_ascending(keys0, "K16 plain")
    assert int((keys0 != INVALID).sum(1).min()) > 0


CONFIG_FILES = sorted(
    (pathlib.Path(__file__).resolve().parent.parent / "configs").glob("*.py"))


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.name)
def test_sorted_grids_fit_int32_keys(path):
    """Every grid a config in configs/ gives the sorted rulebook (its four
    levels and, when banded, its bands' four) passes the wrappers' grid
    check: K18-K20 compute a window's keys, up to the last cell + 2, in
    int32, below INVALID_KEY. A grid one cell over the limit is refused."""
    cfg = config.load_config(str(path))
    grids = [backbone.level_shapes(cfg.sparse_shape)]
    if cfg.parallel.strategy == "banded":
        grids.append(backbone.level_shapes(
            ss.band_shape(cfg, ss.config_band_spec(cfg))))
    for shapes in grids:
        for shape in shapes:
            sp._check_sorted_grid("level", shape)
            assert shape[0] * shape[1] * shape[2] + 2 < INVALID, shape
    with pytest.raises(ValueError, match="cells"):
        sp._check_sorted_grid("level", (1, 1, INVALID - 2))
