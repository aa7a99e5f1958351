"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: every test skips without a CUDA device. On the GPU
machine (which has no JAX, which tests/conftest.py imports) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 1e-4 m^2 (float32, -fmad=false, same op sequence as the
plain version) and exactly +0.0 on every pair its separation cull
rejects, K2 exact flags, K3 1e-5 (sum order of 28 samples), K4
1e-4 abs + 1e-4 rel (float32 sums of up to 27 * 64 products in another
order than cuBLAS), K5-K9 exact (integer results, a scatter of unique
keys, copies of points, float32 sums of integer counts). The training
kernels, relative to the largest magnitude of the plain result: K10 and
K4's input gradients 1e-5 (float32 sums over thousands of rows in another
order; K10 also bitwise equal over two calls), K11's forward, K12 and K5b exact (the same float32 operations,
copies), K11's backward 1e-5 (atomicAdd order), K3b 1e-5 (each d_map cell
summed in box order, where autograd sums each tap apart; bitwise equal over
two calls). The train-only rulebook
plans (K13, K14) are integers and exact; K15's selections, weights and
output are exact (the plain version's float32 operations in its order),
its backward (K11's) 1e-5. The banded stage's kernels: K16 (band
partition, integer coords and copied rows) and K7 with a y limit are
exact, K11 with per-row origins as K11; a banded train step card vs CPU
1e-4 (losses) and 1e-3 (grad norm), as the three-class one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sassd_tpu_torch.ops.cuda import same_bits  # noqa: E402
from test_torch_cases import (K9_CASES, K12_CASES, K13_CASES,  # noqa: E402
                              K16_TILE, PARTITION_CASES,
                              invert_stride_plan, k9_case, k12_case,
                              k13_case, partition_case, partition_rows)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def random_bev(rng, n, spread=8.0):
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2:4] = rng.uniform(0.5, 5.0, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


DEGENERATE = np.array([
    [0.0, 0.0, 2.0, 4.0, 0.0], [0.0, 0.0, 2.0, 4.0, 0.0],
    [2.0, 0.0, 2.0, 4.0, 0.0], [0.0, 0.0, 1.0, 2.0, 0.0],
    [10.0, 10.0, 2.0, 4.0, 0.0], [0.5, 0.0, 2.0, 4.0, 0.0],
    [0.0, 0.0, 2.0, 4.0, np.pi / 2], [0.0, 0.0, 2.0, 4.0, np.pi],
], np.float32)


@pytest.mark.parametrize("criterion", [2, -1, 0, 1])
def test_k1_matches_plain(dev, criterion):
    from sassd_tpu_torch.ops import riou_kernel
    rng = np.random.default_rng(0)
    a = torch.from_numpy(np.concatenate([random_bev(rng, 300), DEGENERATE]))
    b = torch.from_numpy(random_bev(rng, 77))
    for x, y in ((a, b), (a, a)):
        got = riou_kernel.rotate_overlap(x.to(dev), y.to(dev), criterion)
        torch.cuda.synchronize()
        ref = riou_kernel.rotate_overlap_plain(x, y, criterion)
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-4)
    deg = riou_kernel.rotate_overlap(a[-8:].to(dev), a[-8:].to(dev), 2).cpu()
    assert abs(deg[0, 1] - 8.0) < 1e-2 and abs(deg[0, 2]) < 1e-2
    assert abs(deg[0, 7] - 8.0) < 1e-2 and abs(deg[0, 6] - 4.0) < 1e-2


@pytest.mark.parametrize("n,m", [(1, 1), (63, 65), (64, 64), (65, 63),
                                 (2008, 2008), (2113, 130)])
def test_k1_cull_matches_plain(dev, n, m):
    """Around the kernel's 64-box tiles and at NMS's 2008 boxes: within
    1e-4 of the plain version in all four criteria, and exactly +0.0 on
    every pair the separation cull rejects (near_pairs_plain, the
    kernel's test in the same float32 operations)."""
    from sassd_tpu_torch.ops import riou_kernel
    rng = np.random.default_rng(n + m)
    a = random_bev(rng, n, spread=2.0 * np.sqrt(n) + 4.0)
    if n >= 8:
        a[-8:] = DEGENERATE
    a = torch.from_numpy(a)
    b = torch.from_numpy(random_bev(rng, m, spread=2.0 * np.sqrt(m) + 4.0))
    near = riou_kernel.near_pairs_plain(a, b)
    for crit in (2, -1, 0, 1):
        got = riou_kernel.rotate_overlap(a.to(dev), b.to(dev), crit)
        torch.cuda.synchronize()
        ref = riou_kernel.rotate_overlap_plain(a.to(dev), b.to(dev), crit)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   atol=1e-4)
        assert (got.cpu().view(torch.int32)[~near] == 0).all(), crit
    if n * m > 4096:
        assert near.any() and not near.all()


@pytest.mark.parametrize("n,thr", [(1, 0.1), (63, 0.1), (64, 0.3),
                                   (65, 0.1), (700, 0.1), (2000, 0.5)])
def test_k2_matches_plain_greedy(dev, n, thr):
    from sassd_tpu_torch.core import riou
    rng = np.random.default_rng(n)
    boxes = torch.from_numpy(random_bev(rng, n, spread=np.sqrt(n)))
    iou = riou.rotate_iou_bev(boxes, boxes)
    keep0 = torch.from_numpy(rng.uniform(size=n) < 0.9)
    got = riou.nms_keep(iou.to(dev), keep0.to(dev), thr)
    torch.cuda.synchronize()
    ref = riou.nms_keep_plain(iou, keep0, thr)
    assert torch.equal(got.cpu(), ref)


def k2_matrix(kind, n, thr, rng):
    """[N, N] IoU matrices that pin K2's greedy: "chain" (box i overlaps
    only box i + 1, so kept and dropped alternate down the chain), "ties"
    (many entries exactly at thr, which do not suppress), "random" (sparse
    random overlaps)."""
    if kind == "chain":
        iou = np.zeros((n, n), np.float32)
        i = np.arange(n - 1)
        iou[i + 1, i] = iou[i, i + 1] = 0.9
        return iou
    if kind == "ties":
        return rng.choice(np.float32([0.0, thr, 0.9]), (n, n),
                          p=[0.9, 0.08, 0.02])
    return (rng.uniform(0, 1, (n, n))
            * (rng.uniform(size=(n, n)) < 4.0 / max(n, 1))).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 2000, 2113, 4100])
@pytest.mark.parametrize("kind", ["chain", "ties", "random", "no_candidate"])
def test_k2_edge_cases_match_plain(dev, n, kind):
    """Bitwise against the plain greedy across the sweep's 64-box blocks
    and its register words (2113: two words a lane; 4100: four, and over
    48 KB of shared memory)."""
    from sassd_tpu_torch.core import riou
    rng = np.random.default_rng(n)
    thr = 0.5
    iou = torch.from_numpy(k2_matrix(
        "random" if kind == "no_candidate" else kind, n, thr, rng))
    keep0 = torch.from_numpy(rng.uniform(size=n) < 0.9)
    if kind == "no_candidate":
        keep0[:] = False
    before = riou._K2.launches
    got = riou.nms_keep(iou.to(dev), keep0.to(dev), thr)
    torch.cuda.synchronize()
    assert riou._K2.launches == before + 1
    # the plain greedy on the card: a chain takes N rounds
    ref = riou.nms_keep_plain(iou.to(dev), keep0.to(dev), thr).cpu()
    assert torch.equal(got.cpu(), ref)
    if kind == "chain" and n > 1:
        assert not ref.all() and ref.any()


def test_k2_refuses_too_many_boxes(dev):
    from sassd_tpu_torch.core import riou
    n = riou.K2_MAX_BOXES + 1
    with pytest.raises(ValueError, match="at most"):
        riou.nms_keep(torch.zeros((1, 1), device=dev),
                      torch.ones(n, dtype=torch.bool, device=dev), 0.1)


def test_k2_rotate_nms_matches_cpu(dev):
    from sassd_tpu_torch.core import riou
    rng = np.random.default_rng(3)
    boxes = torch.from_numpy(random_bev(rng, 500, spread=20.0))
    scores = torch.from_numpy(rng.uniform(size=500).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=500) < 0.9)
    o_ref, k_ref = riou.rotate_nms(boxes, scores, 0.1, valid=valid)
    o_got, k_got = riou.rotate_nms(boxes.to(dev), scores.to(dev), 0.1,
                                   valid=valid.to(dev))
    assert torch.equal(o_got.cpu(), o_ref) and torch.equal(k_got.cpu(), k_ref)


@pytest.mark.parametrize("layout", ["nchw", "nhwc_view"])
def test_k3_matches_plain(dev, layout):
    from sassd_tpu_torch.ops import warp
    rng = np.random.default_rng(4)
    b, k, h, w, n = 2, 28, 40, 36, 300
    img = torch.from_numpy(rng.normal(size=(b, h, w, k)).astype(np.float32))
    part_map = img.permute(0, 3, 1, 2)
    if layout == "nchw":
        part_map = part_map.contiguous()
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0] = rng.uniform(-1.0, 15.4, (b, n))
    bx[..., 1] = rng.uniform(-9.0, 9.0, (b, n))
    bx[..., 3:6] = [1.6, 3.9, 1.56]
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    boxes = torch.from_numpy(bx)
    valid = torch.from_numpy(rng.uniform(size=(b, n)) < 0.9)
    args = ((4, 7), (0.0, 8.0), 2.5)
    got = warp.pswarp_score(part_map.to(dev), boxes.to(dev), valid.to(dev),
                            *args)
    torch.cuda.synchronize()
    ref = warp.pswarp_score_plain(part_map, boxes, valid, *args)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-5)


def test_wrappers_reject_bad_inputs(dev):
    from sassd_tpu_torch.core import riou
    from sassd_tpu_torch.ops import riou_kernel, warp
    a = torch.zeros((4, 5), device=dev)
    with pytest.raises(TypeError):
        riou_kernel.rotate_overlap(a.double(), a.double())
    with pytest.raises(ValueError):
        riou_kernel.rotate_overlap(a, a.cpu())
    with pytest.raises(ValueError):
        riou_kernel.rotate_overlap(torch.zeros((5, 4), device=dev).T, a)
    with pytest.raises(ValueError):
        riou.nms_keep(torch.zeros((4, 3), device=dev),
                      torch.ones(4, dtype=torch.bool, device=dev), 0.1)
    with pytest.raises(ValueError):
        warp.pswarp_score(torch.zeros((1, 28, 4, 4), device=dev),
                          torch.zeros((1, 3, 7), device=dev),
                          torch.ones((1, 4), dtype=torch.bool, device=dev))


def tiny_rulebook(seed, batch_size=2):
    """Voxelized tiny scans: coords, host plans, level shapes."""
    from sassd_tpu_torch.config import tiny_config
    from sassd_tpu_torch.data import synthetic
    from sassd_tpu_torch.ops import sparse as sp
    cfg = tiny_config()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(seed),
                                        batch_size=batch_size, n_points=900)
    shapes = [cfg.sparse_shape]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    return cfg, batch, shapes


def edge_plan(plan, case):
    """A wire plan [B, 27, M] made into one of the edge cases of K4's and
    K10's tap skipping: a tap found for no row, a 64-row tile (rows
    64..127) with no found row, or sample 1 all padding."""
    p = plan.clone()
    if case == "tap_never_found":
        p[:, 13] = -1
    elif case == "empty_tile":
        p[..., 64:128] = -1
    elif case == "padded_sample":
        p[1] = -1
    return p


# the ladder's plans, the stride convs' transpose plans (K4 as the input
# gradient: [B, 27, M_in] into the output level's rows, Cin and Cout
# swapped) and the edge cases of tap skipping, on int16 and int32 plans
K4_CASES = [
    ("subm0", 0, 4, 16, torch.int16, None),
    ("subm0", 0, 16, 16, torch.int32, None),
    ("stride1", 0, 16, 32, torch.int16, None),
    ("subm1", 1, 32, 32, torch.int32, None),
    ("stride2", 1, 32, 64, torch.int16, None),
    ("subm2", 2, 64, 64, torch.int16, None),
    ("stride3", 2, 64, 64, torch.int32, None),
    ("strideT1", 1, 32, 16, torch.int32, None),
    ("strideT2", 2, 64, 32, torch.int16, None),
    ("strideT3", 3, 64, 64, torch.int32, "padded_sample"),
    ("subm0", 0, 4, 16, torch.int32, "tap_never_found"),
    ("subm2", 2, 64, 64, torch.int16, "tap_never_found"),
    ("subm1", 1, 32, 32, torch.int16, "empty_tile"),
    ("stride2", 1, 32, 64, torch.int32, "empty_tile"),
    ("subm0", 0, 16, 16, torch.int16, "padded_sample"),
    ("stride3", 2, 64, 64, torch.int32, "padded_sample"),
]


@pytest.mark.parametrize("kind,level_in,cin,cout,dtype,case", K4_CASES)
def test_k4_matches_plain(dev, kind, level_in, cin, cout, dtype, case):
    from sassd_tpu_torch.ops import sparse as sp
    cfg, batch, _ = tiny_rulebook(1)
    plan = edge_plan(torch.from_numpy(batch[f"plan_{kind}"]).to(dtype), case)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    rng = np.random.default_rng(cin + cout)
    feats = torch.from_numpy(
        rng.normal(size=(2, caps[level_in], cin)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, cin, cout))
                          / np.sqrt(27 * cin)).astype(np.float32))
    before = sp._K4.launches
    got = sp.subm_conv_batched(feats.to(dev), w.to(dev), plan.to(dev))
    torch.cuda.synchronize()
    assert sp._K4.launches == before + 1
    ref = sp.subm_conv_batched_plain(feats, w, plan)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    if case == "padded_sample":
        assert not got[1].any()
    if case == "empty_tile":
        assert not got[:, 64:128].any()
    assert (plan >= 0).any() and ref.abs().max() > 0.1


INVALID = np.iinfo(np.int32).max


def sorted_keys(rng, shape_zyx, counts, m):
    """[len(counts), m] int32 rows of distinct ascending random keys on the
    grid, counts[i] valid in row i, INVALID padded."""
    d, h, w = shape_zyx
    out = np.full((len(counts), m), INVALID, np.int32)
    for i, n in enumerate(counts):
        out[i, :n] = np.sort(rng.choice(d * h * w, n, replace=False))
    return out


def k5_edge_case(name, c):
    """(shape_zyx, [B, M] int32 keys, [B, M, c] float32 rows, zero on
    padding) of one of K5's edge cases: a grid whose W is not a multiple of
    4 ("w_not_4"), sample 1 all padding ("empty_row"), or keys off the grid
    (negative, D*H*W and above) among the rows ("out_of_range"; those keys
    must write nothing); and of K5b's: a key at the grid's last cell
    ("last_cell") and 100 rows, not a multiple of its 32-row tile
    ("ragged_rows")."""
    rng = np.random.default_rng(len(name) + c)
    shape = (3, 10, 13) if name == "w_not_4" else (2, 8, 12)
    counts = {"w_not_4": (120, 60), "empty_row": (50, 0),
              "out_of_range": (50, 40), "last_cell": (50, 40),
              "ragged_rows": (90, 37)}[name]
    m = {"w_not_4": 128, "ragged_rows": 100}.get(name, 64)
    keys = sorted_keys(rng, shape, counts, m)
    total = shape[0] * shape[1] * shape[2]
    if name == "out_of_range":
        keys[0, 50:53] = (-5, total, total + 3)
        keys[1, 0] = -1
    if name == "last_cell":
        keys[0, 49] = total - 1                 # the largest of 50 sorted
    feats = rng.normal(size=keys.shape + (c,)).astype(np.float32)
    feats[keys == INVALID] = 0.0
    return shape, keys, feats


@pytest.mark.parametrize("case,c", [("tiny", 64), ("w_not_4", 24),
                                    ("empty_row", 64), ("out_of_range", 64)])
def test_k5_matches_plain(dev, case, c):
    """K5 == its plain version bitwise, one launch a call: the tiny
    config's level 3 at batch 2 and the edge cases (W % 4 != 0 takes the
    scalar stores; C 24 a partial channel chunk; off-grid keys are held to
    the plain version with those keys made padding)."""
    from sassd_tpu_torch.ops import sparse as sp
    if case == "tiny":
        _, batch, shapes = tiny_rulebook(2)
        shape = shapes[3]
        keys = sp.coords_to_keys(torch.from_numpy(batch["plan_coords3"]),
                                 shape)
        feats = torch.from_numpy(np.random.default_rng(3).normal(
            size=tuple(keys.shape) + (c,)).astype(np.float32))
        feats[keys == sp.INVALID_KEY] = 0.0
    else:
        shape, keys, feats = k5_edge_case(case, c)
        keys, feats = torch.from_numpy(keys), torch.from_numpy(feats)
    total = shape[0] * shape[1] * shape[2]
    ref_keys = torch.where((keys >= 0) & (keys < total), keys, sp.INVALID_KEY)
    before = sp._K5.launches
    canvas, occ = sp.densify_nchw(keys.to(dev), feats.to(dev), shape)
    torch.cuda.synchronize()
    assert sp._K5.launches == before + 1
    ref_canvas, ref_occ = sp.densify_nchw_plain(ref_keys, feats, shape)
    assert torch.equal(canvas.cpu(), ref_canvas)
    assert torch.equal(occ.cpu(), ref_occ)
    assert occ.sum() == (ref_keys != sp.INVALID_KEY).sum() > 0


# K7's output grid in the edge cases: 10 x 50 x 80 = 40,000 cells, 1,250
# bitmap words, two tiles of 1,024 words, the second partial
K7_BIG = (20, 100, 160)


def k7_edge_case(name):
    """(shape_zyx, [B, M] int32 keys, cap, [B] int32 y limit or None) of
    one of K7's edge cases: a cap that cuts the second bitmap tile
    ("cap_in_tile") or equals row 0's unique count ("cap_at_count"), an
    all-padding row among rows of other counts ("padding_row"), a single
    key at the grid's last cell ("last_cell"), limits 0 ("y_limit_0") and
    at or above the output height ("y_limit_high"), and a 75-cell output
    grid of 3 words ("small_grid")."""
    from sassd_tpu_torch.ops import sparse as sp
    rng = np.random.default_rng(sum(map(ord, name)))
    shape, y_limit = K7_BIG, None
    if name == "last_cell":
        keys = np.full((1, 8), INVALID, np.int32)
        keys[0, 0] = shape[0] * shape[1] * shape[2] - 1
    elif name == "padding_row":
        keys = sorted_keys(rng, shape, (2000, 0, 900), 2048)
    elif name == "small_grid":
        shape = (6, 10, 9)
        keys = sorted_keys(rng, shape, (200, 37), 256)
        y_limit = np.array([3, 100], np.int32)
    else:
        keys = sorted_keys(rng, shape, (3000, 2500), 3072)
    oh = sp.out_shape_stride2(shape)[1]
    if name == "y_limit_0":
        y_limit = np.zeros(2, np.int32)
    elif name == "y_limit_high":
        y_limit = np.array([oh, oh + 7], np.int32)
    full = sp.downsample_keys_plain(torch.from_numpy(keys), shape,
                                    8 * keys.shape[1])
    n0 = int((full[0] != sp.INVALID_KEY).sum())
    cap = {"cap_in_tile": n0 - 300, "cap_at_count": n0}.get(name, n0 + 64)
    return shape, keys, cap, y_limit


K7_CASES = ["cap_in_tile", "cap_at_count", "padding_row", "last_cell",
            "y_limit_0", "y_limit_high", "small_grid"]


@pytest.mark.parametrize("case", K7_CASES)
def test_k7_edge_cases_match_plain(dev, case):
    """K7 == its plain version bitwise on its edge cases, one launch a
    call."""
    from sassd_tpu_torch.ops import sparse as sp
    shape, keys, cap, y_limit = k7_edge_case(case)
    keys = torch.from_numpy(keys)
    y_limit = None if y_limit is None else torch.from_numpy(y_limit)
    before = sp._K7.launches
    got = sp.downsample_keys(keys.to(dev), shape, cap,
                             None if y_limit is None else y_limit.to(dev))
    torch.cuda.synchronize()
    assert sp._K7.launches == before + 1
    ref = sp.downsample_keys_plain(keys, shape, cap, y_limit)
    assert torch.equal(got.cpu(), ref)
    n = (ref != sp.INVALID_KEY).sum(1)
    if case == "cap_in_tile":
        assert n[0] == cap and ref[0, -1] >= 32768      # cut in tile 1
    if case == "padding_row":
        assert n[1] == 0 and n[0] > n[2] > 0
    if case == "last_cell":
        od, oh, ow = sp.out_shape_stride2(shape)
        assert ref[0, 0] == od * oh * ow - 1 and n[0] == 1
    if case == "y_limit_0":
        assert n.sum() == 0


def test_k6_k7_rulebook_matches_plain_and_host(dev):
    """K6 maps and plans and K7 levels on the card == their plain versions
    == the C++ host rulebook, level by level."""
    from sassd_tpu_torch.ops import sparse as sp
    cfg, batch, shapes = tiny_rulebook(4)
    keys0 = sp.coords_to_keys(torch.from_numpy(batch["coords"]), shapes[0])
    imap = sp.build_index_map(keys0.to(dev), shapes[0])
    assert torch.equal(imap.cpu(), sp.build_index_map_plain(keys0, shapes[0]))
    got = sp.device_rulebook(keys0.to(dev), shapes, cfg.caps.level_caps[1:])
    torch.cuda.synchronize()
    ref = sp.device_rulebook(keys0, shapes, cfg.caps.level_caps[1:])
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert torch.equal(v.cpu(), ref[k]), k
        np.testing.assert_array_equal(
            v.cpu().numpy(), batch[f"plan_{k}"].astype(np.int32), err_msg=k)
    # a cap that truncates: the lowest keys win
    out = sp.downsample_keys(keys0.to(dev), shapes[0], 100)
    assert torch.equal(out.cpu(), sp.downsample_keys_plain(keys0, shapes[0],
                                                           100))


def test_new_wrappers_reject_bad_inputs(dev):
    from sassd_tpu_torch.ops import sparse as sp
    f = torch.zeros((1, 8, 16), device=dev)
    w = torch.zeros((27, 16, 16), device=dev)
    plan = torch.zeros((1, 27, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):                       # int64 plan
        sp.subm_conv_batched(f, w, plan.long())
    with pytest.raises(ValueError):                      # Cout 24
        sp.subm_conv_batched(f, torch.zeros((27, 16, 24), device=dev), plan)
    with pytest.raises(ValueError):                      # Cin 6
        sp.subm_conv_batched(torch.zeros((1, 8, 6), device=dev),
                             torch.zeros((27, 6, 16), device=dev), plan)
    with pytest.raises(ValueError):                      # plan on the host
        sp.subm_conv_batched(f, w, plan.cpu())
    with pytest.raises(ValueError):                      # batch mismatch
        sp.subm_conv_batched(f, w, plan.expand(2, 27, 8).contiguous())
    keys = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                      # keys [1, 7]
        sp.densify_nchw(keys[:, :7], f, (2, 3, 4))
    with pytest.raises(TypeError):                       # int64 keys
        sp.build_index_map(keys.long(), (2, 3, 4))
    with pytest.raises(ValueError):                      # map of another grid
        sp.window_plan(keys, (2, 3, 4),
                       torch.zeros((1, 10), dtype=torch.int32, device=dev),
                       (2, 3, 4), 1)
    with pytest.raises(TypeError):
        sp.downsample_keys(keys.float(), (2, 3, 4), 8)


@pytest.mark.parametrize("host_plans", [True, False])
def test_tiny_forward_card_matches_cpu(dev, host_plans):
    """forward_test on the card == on the CPU, with the host rulebook or
    the device rulebook, and the card run launches its kernels."""
    import dataclasses
    from sassd_tpu_torch.config import tiny_config
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.inference import make_test_step
    from sassd_tpu_torch.ops import cuda, sparse as sp
    from sassd_tpu_torch.weights import seeded_detector
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, host_plans=host_plans))
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(2),
                                        batch_size=2, n_points=900)
    assert any(k.startswith("plan_") for k in batch) == host_plans
    anchors = kitti.build_anchors(cfg)[0]
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    got = make_test_step(cfg, anchors, dev)(seeded_detector(cfg, 1, dev),
                                            batch)
    torch.cuda.synchronize()
    ran = {k for k, v in cuda.KERNELS.items() if v.launches > before[k]}
    path = {"sassd_riou_overlap", "sassd_nms_keep", "sassd_pswarp_score",
            *sp.KERNEL_SYMBOLS["K4"], *sp.KERNEL_SYMBOLS["K5"]}
    if not host_plans:
        path |= set(sp.KERNEL_SYMBOLS["K6"] + sp.KERNEL_SYMBOLS["K7"])
    assert ran == path, ran
    ref = make_test_step(cfg, anchors, "cpu")(seeded_detector(cfg, 1, "cpu"),
                                             batch)
    for i in range(2):
        gv, rv = got["valid"][i].cpu().numpy(), ref["valid"][i].numpy()
        assert gv.sum() == rv.sum() and gv.sum() > 0
        gb = got["boxes"][i].cpu().numpy()[gv]
        rb = ref["boxes"][i].numpy()[rv]
        for box in gb:
            assert (np.abs(rb - box).max(1) <= 1e-2).any()



def tiny_points(seed, batch_size, n_points):
    """[B, P, 4] padded raw scans over the tiny range with strays out of
    range and garbage past n_points."""
    from sassd_tpu_torch.config import tiny_config
    cfg = tiny_config()
    rng = np.random.default_rng(seed)
    pcr = np.asarray(cfg.voxel.point_cloud_range)
    p = cfg.caps.max_points_per_scan
    pts = np.zeros((batch_size, p, 4), np.float32)
    for i in range(3):
        pts[..., i] = rng.uniform(pcr[i] - 0.3, pcr[i + 3] + 0.3,
                                  (batch_size, p))
    pts[..., 3] = rng.uniform(0, 1, (batch_size, p))
    pts[:, 50:70, :3] = pts[:, 50:51, :3]               # slot overflow
    return cfg, pts, np.asarray(n_points, np.int32)


@pytest.mark.parametrize("n_points", [(300,), (300, 2048), (1500, 0)])
def test_k8_matches_plain(dev, n_points):
    """Below the cap, at the cap (2048 points over 512 voxels: the lowest
    keys win) and an empty scan."""
    from sassd_tpu_torch.ops import voxelize as vox
    cfg, pts, n = tiny_points(len(n_points), len(n_points), n_points)
    before = vox._K8.launches
    got = vox.voxelize(torch.from_numpy(pts).to(dev),
                       torch.from_numpy(n).to(dev), cfg.voxel)
    torch.cuda.synchronize()
    assert vox._K8.launches == before + 1
    ref = vox.voxelize_plain(torch.from_numpy(pts), torch.from_numpy(n),
                             cfg.voxel)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    n_vox = (ref[1][..., 0] >= 0).sum(1)
    assert n_vox.max() == cfg.voxel.max_voxels or len(n_points) == 1


def grid_top_points(vc, rng, n):
    """[n, 4] points over the grid, a quarter of them in the grid's top
    cells (keys near gx * gy * gz), a few just past its top edges."""
    pcr = np.asarray(vc.point_cloud_range, np.float32)
    vs = np.asarray(vc.voxel_size, np.float32)
    pts = np.zeros((n, 4), np.float32)
    for i in range(3):
        pts[:, i] = rng.uniform(pcr[i], pcr[i + 3], n)
    k = n // 4
    pts[:k, :3] = pcr[3:] - vs * rng.uniform(0.05, 2.5, (k, 3))
    pts[k:k + 8, :3] = pcr[3:] + vs * 0.25               # off the grid
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


@pytest.mark.parametrize("case", ["over_cap_interleaved", "empty_sample",
                                  "car_top", "long_range_top"])
def test_k8_edge_cases_match_plain(dev, case):
    """Bitwise against the plain version: a voxel with more than T points
    interleaved in scan order with other voxels' points, over the cap (the
    lowest keys win); a batch whose second sample is empty; keys near the
    top of the car and long-range grids (bitmaps of 2,750 and 4,000
    tiles)."""
    from sassd_tpu_torch import config
    from sassd_tpu_torch.ops import voxelize as vox
    rng = np.random.default_rng(7)
    if case in ("car_top", "long_range_top"):
        vc = (config.car_config() if case == "car_top"
              else config.long_range_config()).voxel
        pts = grid_top_points(vc, rng, 6000)[None]
        n = np.asarray([6000], np.int32)
    else:
        cfg, pts, n = tiny_points(11, 2, (2048, 2048))
        vc = cfg.voxel
        # 100 points in the grid's first cell, so under the cap
        pts[:, 100:1000:9, :3] = (np.float32(vc.point_cloud_range[:3])
                                  + np.float32(vc.voxel_size) / 2)
        if case == "empty_sample":
            n[1] = 0
    got = vox.voxelize(torch.from_numpy(pts).to(dev),
                       torch.from_numpy(n).to(dev), vc)
    torch.cuda.synchronize()
    ref = vox.voxelize_plain(torch.from_numpy(pts), torch.from_numpy(n), vc)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    n_vox = (ref[1][..., 0] >= 0).sum(1)
    if case == "over_cap_interleaved":
        assert (n_vox == vc.max_voxels).all()
        assert ref[2].max() == vc.max_num_points
    elif case == "empty_sample":
        assert n_vox[1] == 0 and n_vox[0] == vc.max_voxels
    else:
        d, h, w = vc.grid_size[2], vc.grid_size[1], vc.grid_size[0]
        top = (ref[1][0, :, 0].long() * h + ref[1][0, :, 1]) * w \
            + ref[1][0, :, 2]
        assert int(top.max()) > d * h * w - 3 * h * w


def test_k8_calls_no_library_sort(dev, monkeypatch):
    """The card's voxelize runs K8 alone: torch.sort (the parent design's
    central step) must not come back."""
    from sassd_tpu_torch.ops import voxelize as vox
    cfg, pts, n = tiny_points(3, 2, (300, 2048))
    ref = vox.voxelize_plain(torch.from_numpy(pts), torch.from_numpy(n),
                             cfg.voxel)
    p, k = torch.from_numpy(pts).to(dev), torch.from_numpy(n).to(dev)

    def refuse(*args, **kwargs):
        raise AssertionError("voxelize called torch.sort")
    for name in ("sort", "argsort", "unique", "unique_consecutive"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = vox.voxelize(p, k, cfg.voxel)
    torch.cuda.synchronize()
    monkeypatch.undo()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("case", list(K9_CASES))
def test_k9_matches_plain(dev, case):
    """Bitwise against the plain version on car scans at batch 1 (at the
    voxel cap) and 2, the three-class 211,200-anchor and the long-range
    corner tables, padding rows, grid-edge cells, an empty sample, cells
    past the last corner and a lattice of a row for each grid row
    (test_torch_cases.K9_CASES)."""
    from sassd_tpu_torch import serve
    cfg, corners, hw, coords = k9_case(case)
    thr = cfg.data.anchor_area_threshold
    lattice = serve.anchor_lattice(corners, hw)
    c = torch.from_numpy(coords)
    before = serve._K9.launches
    got = serve.anchors_mask(c.to(dev), lattice.to(dev), thr)
    torch.cuda.synchronize()
    assert serve._K9.launches == before + 1
    ref = serve.anchors_mask_plain(c, lattice.corners, hw, thr)
    assert torch.equal(got.cpu(), ref)
    assert ref.any() and not ref.all()


def test_serving_wrappers_reject_bad_inputs(dev):
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.config import tiny_config
    from sassd_tpu_torch.ops import voxelize as vox
    vc = tiny_config().voxel
    pts = torch.zeros((1, 16, 4), device=dev)
    n = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):                       # float64 points
        vox.voxelize(pts.double(), n, vc)
    with pytest.raises(TypeError):                       # int64 n_points
        vox.voxelize(pts, n.long(), vc)
    with pytest.raises(ValueError):                      # n_points [2]
        vox.voxelize(pts, torch.zeros((2,), dtype=torch.int32, device=dev),
                     vc)
    with pytest.raises(ValueError):                      # n_points on host
        vox.voxelize(pts, n.cpu(), vc)
    with pytest.raises(ValueError, match="int32"):       # 2^31 cells
        vox.voxelize(pts, n, dataclasses.replace(
            vc, voxel_size=(0.001, 0.001, 0.001)))
    coords = torch.zeros((1, 8, 3), dtype=torch.int32, device=dev)
    lattice = serve.anchor_lattice(np.zeros((4, 4), np.int32), (2, 2))
    on_card = lattice.to(dev)
    with pytest.raises(ValueError):                      # corners [4, 3]
        serve.anchors_mask(coords, on_card._replace(
            lattice_corners=on_card.lattice_corners[:, :3].contiguous()),
            1.0)
    with pytest.raises(ValueError):                      # tables on host
        serve.anchors_mask(coords, on_card._replace(xmap=lattice.xmap), 1.0)
    with pytest.raises(TypeError):
        serve.anchors_mask(coords.long(), on_card, 1.0)


def test_tiny_serving_card_matches_host_input(dev):
    """On the card: batch_from_points (K8, K9) == its CPU plain versions
    bitwise, and the serving step == make_test_step on the host-prepared
    batch of the same scans (device rulebook), which shares every later
    kernel; the serving run launches K1-K9. (Tiny-config scores sit
    within ~1e-4 of 0.5, so card-vs-CPU detections would compare
    near-ties; the car config's are compared in chip_smoke.py.)"""
    import dataclasses
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.config import tiny_config
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.inference import make_test_step
    from sassd_tpu_torch.ops import cuda
    from sassd_tpu_torch.weights import seeded_detector
    cfg = tiny_config()
    cfg_dev = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, host_plans=False))
    rng = np.random.default_rng(7)
    scans = [synthetic.make_scene(rng, n_cars=(2, 4), n_ground=800,
                                  x_range=(1.0, 6.0), y_range=(-3.0, 3.0))[0]
             for _ in range(2)]
    prepared = [serve.prepare_points(p, cfg) for p in scans]
    batch = dict(points=np.stack([p for p, _ in prepared]),
                 n_points=np.asarray([n for _, n in prepared], np.int32))
    anchors, anchors_bv = kitti.build_anchors(cfg)
    lattice = serve.serving_lattice(cfg, anchors_bv)
    pts, n = (torch.from_numpy(batch[k]) for k in ("points", "n_points"))
    got = serve.batch_from_points(pts.to(dev), n.to(dev), lattice.to(dev),
                                  cfg)
    ref = serve.batch_from_points(pts, n, lattice, cfg)
    for k in ref:
        assert torch.equal(got[k].cpu(), ref[k]), k

    from sassd_tpu_torch.ops import sparse as sp, voxelize as vox
    model = seeded_detector(cfg, 1, dev)
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    dets = serve.make_serving_step(cfg, anchors, anchors_bv, dev)(model,
                                                                  batch)
    torch.cuda.synchronize()
    path = {"sassd_riou_overlap", "sassd_nms_keep", "sassd_pswarp_score",
            *vox.KERNEL_SYMBOLS["K8"], *serve.KERNEL_SYMBOLS["K9"],
            *[s for k in ("K4", "K5", "K6", "K7")
              for s in sp.KERNEL_SYMBOLS[k]]}
    assert all(cuda.KERNELS[k].launches > before[k] for k in path)
    host_batch, _ = kitti.collate([kitti.prepare_scan(cfg_dev, p, anchors_bv)
                                   for p in scans])
    host = make_test_step(cfg_dev, anchors, dev)(model, host_batch)
    for k in ("valid", "boxes", "scores", "labels"):
        assert torch.equal(dets[k], host[k]), k
    assert int(dets["valid"].sum()) > 0


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    ref = ref.detach().cpu().double()
    return float((got.detach().cpu().double() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("kind,level_in,cin,cout", [
    ("subm0", 0, 4, 16), ("subm0", 0, 16, 16), ("stride1", 0, 16, 32),
    ("subm1", 1, 32, 32), ("stride2", 1, 32, 64), ("subm2", 2, 64, 64),
    ("stride3", 2, 64, 64)])
def test_k10_and_k4_backward_match_plain(dev, kind, level_in, cin, cout):
    """The conv Functions' gradients on the card (K4 for d_feats, K10 for
    d_weight) against autograd of the plain forward on the CPU; d_feats
    also at the 4-wide input (the PointNet VFE's gradient: K4 on weight
    columns zero-padded to 16)."""
    from sassd_tpu_torch.ops import sparse as sp
    cfg, batch, _ = tiny_rulebook(6)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    plan = torch.from_numpy(batch[f"plan_{kind}"])
    level = int(kind[-1])
    rng = np.random.default_rng(cin * cout)
    x = torch.from_numpy(rng.normal(
        size=(2, caps[level_in], cin)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, cin, cout))
                          / np.sqrt(27 * cin)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(
        size=(2, plan.shape[2], cout)).astype(np.float32))
    if kind.startswith("subm"):
        fn = lambda xx, ww, p: sp.subm_conv_sym(xx, ww, p)  # noqa: E731
        args = [plan]
    else:
        fn = sp.stride_conv_hostT
        args = [plan, torch.from_numpy(batch[f"plan_strideT{level}"])]
    xc, wc = x.clone().requires_grad_(), w.clone().requires_grad_()
    fn(xc, wc, *args).backward(cot)
    xd = x.to(dev).requires_grad_()
    wd = w.to(dev).requires_grad_()
    before = sp._K10.launches
    fn(xd, wd, *[a.to(dev) for a in args]).backward(cot.to(dev))
    torch.cuda.synchronize()
    assert sp._K10.launches == before + 1
    assert rel_err(wd.grad, wc.grad) <= 1e-5
    assert rel_err(xd.grad, xc.grad) <= 1e-5
    assert rel_err(sp.conv_weight_grad(x.to(dev), plan.to(dev), cot.to(dev)),
                   sp.conv_weight_grad_plain(x, plan, cot)) <= 1e-5


@pytest.mark.parametrize("kind,level_in,cin,cout,dtype,case", [
    ("subm0", 0, 4, 16, torch.int16, "tap_never_found"),
    ("subm2", 2, 64, 64, torch.int32, "tap_never_found"),
    ("subm1", 1, 32, 32, torch.int32, "empty_tile"),
    ("stride2", 1, 32, 64, torch.int16, "empty_tile"),
    ("subm0", 0, 16, 16, torch.int32, "padded_sample"),
    ("stride3", 2, 64, 64, torch.int16, "padded_sample")])
def test_k10_edge_plans_match_plain_and_repeat_bitwise(
        dev, kind, level_in, cin, cout, dtype, case):
    """K10 on the edge cases of tap skipping against its plain version
    (1e-5 of the largest magnitude), bitwise equal over two calls, one
    launch a call; a tap found for no row gets a zero gradient."""
    from sassd_tpu_torch.ops import sparse as sp
    cfg, batch, _ = tiny_rulebook(6)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    plan = edge_plan(torch.from_numpy(batch[f"plan_{kind}"]).to(dtype), case)
    rng = np.random.default_rng(cin * cout + 1)
    x = torch.from_numpy(rng.normal(
        size=(2, caps[level_in], cin)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(
        size=(2, plan.shape[2], cout)).astype(np.float32))
    args = [a.to(dev) for a in (x, plan, cot)]
    before = sp._K10.launches
    got = sp.conv_weight_grad(*args)
    again = sp.conv_weight_grad(*args)
    torch.cuda.synchronize()
    assert sp._K10.launches == before + 2
    assert torch.equal(got, again)
    ref = sp.conv_weight_grad_plain(x, plan, cot)
    assert rel_err(got, ref) <= 1e-5
    if case == "tap_never_found":
        assert not got[13].any()


@pytest.mark.parametrize("case,c", [
    ("tiny", 64), ("tiny", 16), ("ragged_rows", 64), ("empty_row", 64),
    ("w_not_4", 70), ("last_cell", 24), ("out_of_range", 64)])
def test_k5b_matches_plain(dev, case, c):
    """K5b (the backward of densify_nchw, and densify_grad) == its plain
    version bitwise, one launch a backward: the tiny config's level 3 at
    batch 2 (C 64 and 16) and the edge cases: rows not a multiple of the
    32-row tile, an all-padding sample, W % 4 != 0 with C 70 (two channel
    tiles, scalar stores), a key at the last cell with C 24, keys off the
    grid (held to the plain version with those keys made padding: 0)."""
    from sassd_tpu_torch.ops import sparse as sp
    if case == "tiny":
        _, batch, shapes = tiny_rulebook(7)
        shape = shapes[3]
        keys = sp.coords_to_keys(torch.from_numpy(batch["plan_coords3"]),
                                 shape)
    else:
        shape, keys, _ = k5_edge_case(case, c)
        keys = torch.from_numpy(keys)
    d, h, w = shape
    total = d * h * w
    ref_keys = torch.where((keys >= 0) & (keys < total), keys, sp.INVALID_KEY)
    rng = np.random.default_rng(8 + c)
    d_canvas = torch.from_numpy(rng.normal(
        size=(2, d * c, h, w)).astype(np.float32))
    before = sp._K5B.launches
    feats = torch.zeros(tuple(keys.shape) + (c,), device=dev,
                        requires_grad=True)
    canvas, _ = sp.densify_nchw(keys.to(dev), feats, shape)
    canvas.backward(d_canvas.to(dev))
    torch.cuda.synchronize()
    assert sp._K5B.launches == before + 1
    ref = sp.densify_grad_plain(ref_keys, d_canvas, shape)
    assert torch.equal(feats.grad.cpu(), ref)
    got = sp.densify_grad(keys.to(dev), d_canvas.to(dev), shape)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    assert ref.abs().max() > 1.0
    if case == "empty_row":
        assert not got[1].any()
    if case == "last_cell":
        assert torch.equal(got[0, 49].cpu(), d_canvas[0, :, h - 1, w - 1]
                           .reshape(d, c)[d - 1])


@pytest.mark.parametrize("level", [1, 2, 3])
def test_k11_matches_plain(dev, level):
    """Forward, selected rows and weights bitwise; feature gradients 1e-5."""
    from sassd_tpu_torch.ops import interpolate as itp
    cfg, batch, _ = tiny_rulebook(9)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    c = 32 if level == 1 else 64
    rng = np.random.default_rng(level)
    feats = torch.from_numpy(rng.normal(
        size=(2, caps[level], c)).astype(np.float32))
    npts = np.maximum(batch["num_points"], 1)[..., None].astype(np.float32)
    query = torch.from_numpy(
        (batch["voxels"][..., :3].sum(-2) / npts).astype(np.float32))
    cell0 = torch.from_numpy(batch["coords"])
    plan = torch.from_numpy(batch[f"plan_aux{level}"])
    vs = (np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** level).tolist()
    pc = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32).tolist()
    out, rows, w = itp.ring_interp_fwd(query.to(dev), cell0.to(dev), level,
                                       feats.to(dev), plan.to(dev), vs, pc)
    torch.cuda.synchronize()
    ref_rows, ref_w = itp.ring_select_plain(query, cell0, level, plan,
                                            caps[level], vs, pc)
    assert torch.equal(rows.cpu().long(), ref_rows)
    assert torch.equal(w.cpu(), ref_w)
    assert torch.equal(out.cpu(), itp.neighborhood_interpolate_cells_plain(
        query, cell0, level, feats, plan, vs, pc))
    cot = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
        np.float32))
    fc = feats.clone().requires_grad_()
    itp.neighborhood_interpolate_cells(query, cell0, level, fc, plan, vs,
                                       pc).backward(cot)
    fd = feats.to(dev).requires_grad_()
    itp.neighborhood_interpolate_cells(query.to(dev), cell0.to(dev), level,
                                       fd, plan.to(dev), vs, pc
                                       ).backward(cot.to(dev))
    assert rel_err(fd.grad, fc.grad) <= 1e-5



K11_CASES = ["c32_int16", "c64_int32", "c30", "misaligned", "padded_origins",
             "all_padded"]


def k11_case(case):
    """K11's inputs on the tiny train rulebook at batch 2: level 1 at 32
    channels, level 2 at 30 or 64. c32_int16 and c64_int32 the two plan
    types; c30 a width that is not a multiple of 4, and misaligned 32
    channels with features and d_out 4 bytes past a 16-byte boundary (both
    take the single-float gather and scalar adds); padded_origins the second sample's last half
    padded (cells and plan -1, as every plan maker writes them) with a
    grid origin per row; all_padded the second sample all padding.
    Returns (level, query, cell0, plan, feats, cot, vs, pc) as numpy, pc a
    [2, 3] float32 tensor of origins or a list."""
    cfg, batch, _ = tiny_rulebook(11)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    c = {"c30": 30, "c64_int32": 64}.get(case, 32)
    level = 1 if c == 32 else 2
    rng = np.random.default_rng(len(case))
    npts = np.maximum(batch["num_points"], 1)[..., None].astype(np.float32)
    query = (batch["voxels"][..., :3].sum(-2) / npts).astype(np.float32)
    cell0 = batch["coords"].copy()
    plan = batch[f"plan_aux{level}"].astype(
        np.int32 if case == "c64_int32" else np.int16)
    if case in ("padded_origins", "all_padded"):
        cut = 0 if case == "all_padded" else (cell0[1, :, 0] >= 0).sum() // 2
        cell0[1, cut:] = -1
        plan[1, :, cut:] = -1
    pc = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    pc = (torch.from_numpy(np.stack([pc, pc + np.float32([0.0, 0.8, 0.0])]))
          if case == "padded_origins" else pc.tolist())
    feats = rng.normal(size=(2, caps[level], c)).astype(np.float32)
    cot = rng.normal(size=(2, cell0.shape[1], c)).astype(np.float32)
    vs = (np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** level).tolist()
    return level, query, cell0, plan, feats, cot, vs, pc


@pytest.mark.parametrize("case", K11_CASES)
def test_k11_cases_match_plain(dev, case):
    """K11 on its edge cases: rows, weights and output bitwise the plain
    version's (the signs of zeros included), the feature gradient within
    1e-5 of autograd through it; a padded query weighs nothing."""
    from sassd_tpu_torch.ops import interpolate as itp
    level, query, cell0, plan, feats, cot, vs, pc = k11_case(case)
    q, c0, pl, f, co = (torch.from_numpy(a)
                        for a in (query, cell0, plan, feats, cot))

    def on_dev(a):
        if case != "misaligned":
            return a.to(dev)
        flat = torch.zeros(a.numel() + 1, device=dev)
        flat[1:] = a.reshape(-1).to(dev)
        return flat[1:].view(a.shape)
    fd, cod = on_dev(f), on_dev(co)
    assert (fd.data_ptr() % 16 != 0) == (case == "misaligned")
    pcd = pc.to(dev) if torch.is_tensor(pc) else pc
    out, rows, w = itp.ring_interp_fwd(q.to(dev), c0.to(dev), level, fd,
                                       pl.to(dev), vs, pcd)
    d_feats = itp.ring_interp_bwd(cod, rows, w, tuple(f.shape))
    torch.cuda.synchronize()
    ref_rows, ref_w = itp.ring_select_plain(q, c0, level, pl, f.shape[1], vs,
                                            pc)
    assert torch.equal(rows.cpu().long(), ref_rows)
    assert same_bits(w, ref_w)
    assert same_bits(out, itp.neighborhood_interpolate_cells_plain(
        q, c0, level, f, pl, vs, pc))
    fp = f.clone().requires_grad_()
    ref_g = torch.autograd.grad(itp.neighborhood_interpolate_cells_plain(
        q, c0, level, fp, pl, vs, pc), fp, co)[0]
    assert rel_err(d_feats, ref_g) <= 1e-5
    padded = c0[..., 0].reshape(-1) < 0
    assert padded.any() == (case in ("padded_origins", "all_padded"))
    assert (w.cpu()[padded] == 0).all() and (w.cpu()[~padded] > 0).any()


def k14_inputs(cfg, coords, shapes):
    """Levels 1-3's index maps of tiny level-0 coords [B, M0, 3], built on
    the CPU by the plain versions."""
    from sassd_tpu_torch.ops import sparse as sp
    keys = sp.coords_to_keys(torch.from_numpy(coords), shapes[0])
    maps = []
    for level in (1, 2, 3):
        keys = sp.downsample_keys_plain(keys, shapes[level - 1],
                                        cfg.caps.level_caps[level])
        maps.append(sp.build_index_map(keys, shapes[level]))
    return maps


def test_k14_padded_rows_are_missing(dev):
    """K14 writes -1 for all 27 taps of a padded level-0 row, wherever it
    lies (K11 reads no plan for one), at every level, as its plain version
    does."""
    from sassd_tpu_torch.ops import sparse as sp
    cfg, batch, shapes = tiny_rulebook(12)
    maps = k14_inputs(cfg, batch["coords"], shapes)
    cell0 = torch.from_numpy(batch["coords"].copy())
    cell0[:, ::3] = -1                                # padding in between
    padded = cell0[..., 0] < 0
    got = sp.aux_plans(cell0.to(dev), [m.to(dev) for m in maps], shapes[1:])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sp.aux_plans_plain(cell0, maps, shapes[1:]))
    taps = got.cpu().permute(0, 1, 3, 2)              # [3, B, M0, 27]
    assert (taps[:, padded] == -1).all()
    assert all((taps[lvl][~padded] >= 0).any() for lvl in range(3))


def test_k14_three_levels_in_one_launch(dev):
    """One aux_plans call launches K14 once and writes the three levels'
    plans, each a contiguous [B, 27, M0] view, equal to the plain
    version's and to the C++ train rulebook's aux plans."""
    from sassd_tpu_torch.ops import sparse as sp
    cfg, batch, shapes = tiny_rulebook(13)
    maps = k14_inputs(cfg, batch["coords"], shapes)
    cell0 = torch.from_numpy(batch["coords"])
    before = sp._K14.launches
    got = sp.aux_plans(cell0.to(dev), [m.to(dev) for m in maps], shapes[1:])
    torch.cuda.synchronize()
    assert sp._K14.launches == before + 1
    ref = sp.aux_plans_plain(cell0, maps, shapes[1:])
    b, m0, _ = cell0.shape
    assert got.shape == (3, b, 27, m0)
    for lvl in (1, 2, 3):
        assert got[lvl - 1].is_contiguous()
        assert torch.equal(got[lvl - 1].cpu(), ref[lvl - 1])
        np.testing.assert_array_equal(got[lvl - 1].cpu().numpy(),
                                      batch[f"plan_aux{lvl}"].astype(np.int32))


def test_k12_matches_plain(dev):
    from sassd_tpu_torch.core import boxes
    rng = np.random.default_rng(10)
    b, n, g = 2, 3000, 16
    gt = np.zeros((b, g, 7), np.float32)
    gt[..., :2] = rng.uniform(-5, 5, (b, g, 2))
    gt[..., 2] = -1.7
    gt[..., 3:6] = [1.6, 3.9, 1.56]
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    pts = np.concatenate([rng.uniform(-6, 6, (b, n, 2)),
                          rng.uniform(-2, 0.5, (b, n, 1))], -1)
    args = [torch.from_numpy(a) for a in (
        pts.astype(np.float32), rng.uniform(size=(b, n)) < 0.9, gt,
        rng.uniform(size=(b, g)) < 0.8)]
    label, off = boxes.aux_targets(*[a.to(dev) for a in args])
    torch.cuda.synchronize()
    ref_label, ref_off = boxes.aux_targets_plain(*[a.to(dev) for a in args])
    assert torch.equal(label, ref_label) and torch.equal(off, ref_off)
    cpu_label, _ = boxes.aux_targets_plain(*args)
    assert torch.equal(label.cpu(), cpu_label)
    assert 0 < int(label.sum()) < b * n


@pytest.mark.parametrize("case", K12_CASES)
def test_k12_edge_cases_bitwise(dev, case):
    """K12 bitwise its plain version on the card (labels and offsets) on
    points exactly on and one float32 step past the faces, overlapping
    boxes, invalid slots before the winner, a sample with no valid box, an
    all-padded sample, 64 valid slots and 64 slots every other one
    invalid; the placed points take the slot the case names."""
    from sassd_tpu_torch.core import boxes
    pts, pv, gt, gv, want = k12_case(case)
    args = [torch.from_numpy(a).to(dev) for a in (pts, pv, gt, gv)]
    label, off = boxes.aux_targets(*args)
    torch.cuda.synchronize()
    ref_label, ref_off = boxes.aux_targets_plain(*args)
    assert torch.equal(label, ref_label) and same_bits(off, ref_off)
    known = torch.from_numpy(want >= 0)
    assert torch.equal(label.cpu()[known],
                       torch.from_numpy(want < gt.shape[1])[known])
    if case in ("no_valid_box", "all_padded"):
        assert not label[0].any() and label[1].any()


def test_k3b_matches_autograd_of_plain(dev):
    from sassd_tpu_torch.ops import warp
    rng = np.random.default_rng(11)
    b, k, h, w, n = 2, 28, 40, 36, 300
    img = torch.from_numpy(rng.normal(size=(b, k, h, w)).astype(np.float32))
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0] = rng.uniform(-1.0, 15.4, (b, n))
    bx[..., 1] = rng.uniform(-9.0, 9.0, (b, n))
    bx[..., 3:6] = [1.6, 3.9, 1.56]
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    boxes = torch.from_numpy(bx)
    valid = torch.from_numpy(rng.uniform(size=(b, n)) < 0.9)
    cot = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32))
    args = ((4, 7), (0.0, 8.0), 2.5)
    ic, bc = img.clone().requires_grad_(), boxes.clone().requires_grad_()
    warp.pswarp_score(ic, bc, valid, *args).backward(cot)
    idv, bdv = img.to(dev).requires_grad_(), boxes.to(dev).requires_grad_()
    before = warp._K3B.launches
    warp.pswarp_score(idv, bdv, valid.to(dev), *args).backward(cot.to(dev))
    torch.cuda.synchronize()
    assert warp._K3B.launches == before + 1
    assert rel_err(idv.grad, ic.grad) <= 1e-5
    assert rel_err(bdv.grad, bc.grad) <= 1e-5


def k3_inputs(rng, b, n, h, w, extent_pad=1.0):
    """A [b, 28, h, w] part map and n boxes a sample whose lattices cover
    the map and its edges (scale 2.5, offsets (0, h / 5))."""
    img = torch.from_numpy(rng.normal(size=(b, 28, h, w)).astype(np.float32))
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0] = rng.uniform(-extent_pad, w / 2.5 + extent_pad, (b, n))
    bx[..., 1] = rng.uniform(-h / 5 - extent_pad, h / 5 + extent_pad, (b, n))
    bx[..., 3:6] = rng.uniform([1.4, 3.2, 1.4], [1.9, 4.5, 1.8], (b, n, 3))
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    valid = torch.from_numpy(rng.uniform(size=(b, n)) < 0.9)
    d_score = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32))
    return img, torch.from_numpy(bx), valid, d_score, ((4, 7),
                                                       (0.0, h / 5), 2.5)


def test_k3b_repeats_bitwise(dev):
    """K3b writes each d_map cell once, in box order: two calls on the car
    train shape (2 x 640 boxes on [2, 28, 200, 176]) give the same bits,
    and so do two backwards through pswarp_score."""
    from sassd_tpu_torch.ops import warp
    img, boxes, valid, d_score, args = k3_inputs(np.random.default_rng(12),
                                                 2, 640, 200, 176)
    ins = [t.to(dev) for t in (img, boxes, valid, d_score)]
    first = warp.pswarp_score_grad(*ins, *args)
    second = warp.pswarp_score_grad(*ins, *args)
    assert all(same_bits(a, b) for a, b in zip(first, second))
    grads = []
    for _ in range(2):
        pm, bx = ins[0].clone().requires_grad_(), ins[1].clone(
            ).requires_grad_()
        warp.pswarp_score(pm, bx, ins[2], *args).backward(ins[3])
        grads.append((pm.grad, bx.grad))
    assert all(same_bits(a, b) for a, b in zip(*grads))
    assert same_bits(grads[0][0], first[0])
    assert same_bits(grads[0][1], first[1])


def test_k3_no_grad_route_matches_autograd_route(dev):
    """Under inference_mode K3 launches without the autograd Function; the
    scores are bitwise those of the autograd route."""
    from sassd_tpu_torch.ops import warp
    img, boxes, valid, _, args = k3_inputs(np.random.default_rng(13), 2,
                                           700, 60, 50)
    pm, bx, vd = img.to(dev), boxes.to(dev), valid.to(dev)
    before = warp._K3.launches
    with torch.inference_mode():
        served = warp.pswarp_score(pm, bx, vd, *args)
    trained = warp.pswarp_score(pm.clone().requires_grad_(), bx, vd, *args)
    torch.cuda.synchronize()
    assert warp._K3.launches == before + 2
    assert served.grad_fn is None and trained.grad_fn is not None
    assert same_bits(served, trained)


def grid_aligned(boxes):
    """Boxes with yaw 0 and centres on the pixel grid (scale 2.5): lattice
    points fall on pixel edges, where one ulp of a linspace value moves a
    point to other taps."""
    boxes[..., 0] = torch.round(boxes[..., 0] * 2.5) / 2.5
    boxes[..., 1] = torch.round(boxes[..., 1] * 2.5) / 2.5
    boxes[..., 6] = 0.0


def test_k3_grid_aligned_boxes_match_plain(dev):
    """K3 against its plain version on the card where lattice points lie on
    pixel edges (the middle of a 7-point lattice row is linspace's
    -1.49e-8, not 0)."""
    from sassd_tpu_torch.ops import warp
    img, boxes, valid, _, args = k3_inputs(np.random.default_rng(21), 2, 400,
                                           60, 50)
    grid_aligned(boxes)
    pm, bx, vd = img.to(dev), boxes.to(dev), valid.to(dev)
    got = warp.pswarp_score(pm, bx, vd, *args)
    ref = warp.pswarp_score_plain(pm, bx, vd, *args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-5)


K3B_CASES = ("band_edges", "off_map", "ragged_chunk", "single_band",
             "all_invalid", "no_boxes", "wide_map", "grid_aligned")


@pytest.mark.parametrize("case", K3B_CASES)
def test_k3b_edge_cases_match_autograd_of_plain(dev, case, monkeypatch):
    """K3b's records and bands at their edges against autograd of the plain
    version on the card (1e-5 relative; the card's sin and cos, as K3b's:
    at 300 columns a lattice point's pixel x reaches 300, where the CPU's
    sin and cos move a tap weight by ~1e-5), reproducible over two calls:
    tiles of 4 rows
    (taps on every tile's first and last row, a last tile of 2 rows), boxes
    off the map, N not a multiple of pass B's chunk (8 x 64 = 512 records
    at 40 columns: 513, the second chunk one record; 1,100 at 300 columns,
    chunks of 768), one band of rows, no valid box, no box, a map of 300
    columns (tiles of 96 columns and one of 12), and lattice points on pixel
    edges (grid_aligned)."""
    from sassd_tpu_torch.ops import warp
    b, n, h, w = 2, 300, 26, 40
    if case == "band_edges":
        monkeypatch.setattr(warp, "K3B_TILE_ROWS", 4)
    n = {"ragged_chunk": 513, "no_boxes": 0, "wide_map": 1100}.get(case, n)
    h = 10 if case == "single_band" else h
    w = 300 if case == "wide_map" else w
    img, boxes, valid, d_score, args = k3_inputs(
        np.random.default_rng(14 + K3B_CASES.index(case)), b, n, h, w)
    if case == "off_map":
        boxes[..., 0] -= 50.0
    if case == "all_invalid":
        valid[:] = False
    if case == "grid_aligned":
        grid_aligned(boxes)
    ins = [t.to(dev) for t in (img, boxes, valid, d_score)]
    ic, bc = ins[0].clone().requires_grad_(), ins[1].clone().requires_grad_()
    warp.pswarp_score_plain(ic, bc, ins[2], *args).backward(ins[3])
    d_map, d_boxes = warp.pswarp_score_grad(*ins, *args)
    again = warp.pswarp_score_grad(*ins, *args)
    torch.cuda.synchronize()
    assert rel_err(d_map, ic.grad) <= 1e-5
    assert d_boxes.shape == (b, n, 7)
    assert n == 0 or rel_err(d_boxes, bc.grad) <= 1e-5
    assert same_bits(again[0], d_map) and same_bits(again[1], d_boxes)
    if case in ("off_map", "all_invalid", "no_boxes"):
        assert same_bits(d_map, torch.zeros_like(d_map))
    else:
        assert int((d_map != 0).sum()) > 0


def test_tiny_train_step_card_matches_cpu(dev):
    """forward_train + backward on the card == on the CPU (losses 1e-4,
    grad norm 1e-3), launching every training kernel."""
    from sassd_tpu_torch.config import tiny_config
    from sassd_tpu_torch.core import boxes
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.inference import to_device
    from sassd_tpu_torch.models.detector import parse_losses
    from sassd_tpu_torch.ops import cuda, interpolate, sparse as sp, warp
    from sassd_tpu_torch.weights import seeded_detector
    cfg = tiny_config()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(3),
                                        batch_size=2, n_points=900)
    anchors = torch.from_numpy(kitti.build_anchors(cfg)[0])
    out = {}
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    for where in ("cpu", dev):
        model = seeded_detector(cfg, 2, where)
        model.train()
        losses = model.forward_train(to_device(batch, where),
                                     anchors.to(where))
        parse_losses(losses).backward()
        gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum()
                               for p in model.parameters()))
        out[str(where)] = ({k: float(v) for k, v in losses.items()},
                           float(gnorm))
    torch.cuda.synchronize()
    ran = {k for k, v in cuda.KERNELS.items() if v.launches > before[k]}
    path = {"sassd_riou_overlap", "sassd_pswarp_score",
            *warp.KERNEL_SYMBOLS["K3b"], *interpolate.KERNEL_SYMBOLS["K11"],
            *boxes.KERNEL_SYMBOLS["K12"],
            *[s for k in ("K4", "K5", "K5b", "K10")
              for s in sp.KERNEL_SYMBOLS[k]]}
    assert ran == path, ran
    (cl, cg), (gl, gg) = out["cpu"], out[str(dev)]
    for k, v in cl.items():
        assert abs(gl[k] - v) <= 1e-4 * max(abs(v), 1e-6), (k, gl[k], v)
    assert abs(gg - cg) <= 1e-3 * cg


def test_k13_k14_train_rulebook_matches_plain_and_host(dev):
    """device_rulebook(train=True) on the card (K6, K7, K13, K14) == its
    plain versions == the C++ train rulebook; without aux, no aux plans."""
    from sassd_tpu_torch.ops import sparse as sp
    cfg, batch, shapes = tiny_rulebook(10)
    keys0 = sp.coords_to_keys(torch.from_numpy(batch["coords"]), shapes[0])
    before = (sp._K13.launches, sp._K14.launches)
    got = sp.device_rulebook(keys0.to(dev), shapes, cfg.caps.level_caps[1:],
                             train=True)
    torch.cuda.synchronize()
    # K13 and K14 once each for the three levels
    assert (sp._K13.launches, sp._K14.launches) == (before[0] + 1,
                                                    before[1] + 1)
    ref = sp.device_rulebook(keys0, shapes, cfg.caps.level_caps[1:],
                             train=True)
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert torch.equal(v.cpu(), ref[k]), k
        np.testing.assert_array_equal(
            v.cpu().numpy(), batch[f"plan_{k}"].astype(np.int32), err_msg=k)
    before = (sp._K13.launches, sp._K14.launches)
    exact = sp.device_rulebook(keys0.to(dev), shapes,
                               cfg.caps.level_caps[1:], train=True,
                               aux=False)
    assert (sp._K13.launches, sp._K14.launches) == (before[0] + 1,
                                                    before[1])
    assert sorted(exact) == sorted(k for k in got if not k.startswith("aux"))
    for lvl in (1, 2, 3):
        assert torch.equal(exact[f"strideT{lvl}"].cpu(), ref[f"strideT{lvl}"])


@pytest.mark.parametrize("case", K13_CASES)
def test_k13_edge_cases_bitwise(dev, case):
    """K13 on test_torch_cases.K13_CASES (rows on every grid face with W
    odd and even, levels cut by their caps, band rows with a y limit,
    padding between valid rows, an all-padded sample): one launch for the
    three levels, bitwise equal to its plain version, to the forward plan
    inverted and to itself over two calls."""
    from sassd_tpu_torch.ops import sparse as sp
    keys, shapes, _ = k13_case(case)
    maps = [sp.build_index_map(k, s) for k, s in zip(keys[1:], shapes[1:])]
    ref = sp.stride_plans_T_plain(keys[:3], maps, shapes)
    kd, md = [k.to(dev) for k in keys[:3]], [m.to(dev) for m in maps]
    before = sp._K13.launches
    got = sp.stride_plans_T(kd, md, shapes)
    again = sp.stride_plans_T(kd, md, shapes)
    torch.cuda.synchronize()
    assert sp._K13.launches == before + 2
    for lvl in (1, 2, 3):
        g = got[lvl - 1]
        assert g.shape == ref[lvl - 1].shape and g.is_contiguous()
        assert torch.equal(g.cpu(), ref[lvl - 1])
        assert torch.equal(again[lvl - 1], g)
        fwd = sp.window_plan(keys[lvl], shapes[lvl], sp.build_index_map(
            keys[lvl - 1], shapes[lvl - 1]), shapes[lvl - 1], 2)
        assert torch.equal(g.cpu(), invert_stride_plan(
            fwd, keys[lvl - 1].shape[1]))


def three_nn_inputs(seed, level, dev):
    """Voxel centroids of tiny scans (queries), a level's cell centres,
    validity and random features, on `dev`."""
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops import sparse as sp
    cfg, batch, shapes = tiny_rulebook(seed)
    keys = sp.coords_to_keys(torch.from_numpy(batch["coords"]), shapes[0])
    for lvl in range(1, level + 1):
        keys = sp.downsample_keys(keys, shapes[lvl - 1],
                                  cfg.caps.level_caps[lvl])
    vs = np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** level
    centers = itp.cell_centers(sp.keys_to_coords(keys, shapes[level]),
                               vs.tolist(), cfg.voxel.point_cloud_range[:3])
    npts = np.maximum(batch["num_points"], 1)[..., None].astype(np.float32)
    query = torch.from_numpy(
        (batch["voxels"][..., :3].sum(-2) / npts).astype(np.float32))
    feats = torch.from_numpy(np.random.default_rng(level).normal(
        size=tuple(keys.shape) + (32,)).astype(np.float32))
    return [t.to(dev) for t in (query, centers, keys != sp.INVALID_KEY,
                                feats)]


# K15's edge cases (three_nn_edge_case): N and M off the tile and slice
# sizes, fewer known rows than slices, fewer than 3 valid known rows, equal
# known points across slice boundaries, queries on known points, and two
# samples of different valid counts
K15_CASES = ["ragged", "m_below_slices", "few_valid", "ties", "coincident",
             "batch_counts"]


def three_nn_edge_case(name):
    """(query [2, N, 3], known [2, M, 3], valid [2, M], feats [2, M, 16],
    slices or None) of one of K15's edge cases, numpy float32 points in the
    car range; padding known rows (a valid prefix of each sample's rows)
    all sit at one point off the range, as padded cells do. `slices`, where
    set, is the slice count the case needs (ties straddle its boundaries;
    m_below_slices has 5 known rows in 8 slices; few_valid's padding
    winners lie in the second of 20)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, m, counts, slices = {
        "ragged": (700, 1001, (1001, 800), None),
        "m_below_slices": (300, 5, (5, 3), 8),
        "few_valid": (300, 40, (2, 0), 20),
        "ties": (400, 64, (64, 60), 4),
        "coincident": (300, 200, (200, 150), 3),
        "batch_counts": (1000, 1500, (1500, 611), None)}[name]
    lo = np.array([0.0, -40.0, -3.0], np.float32)
    hi = np.array([70.4, 40.0, 1.0], np.float32)
    known = rng.uniform(lo, hi, (2, m, 3)).astype(np.float32)
    valid = np.arange(m)[None] < np.asarray(counts)[:, None]
    known[~valid] = (-1.0, -41.0, -4.0)
    query = rng.uniform(lo, hi, (2, n, 3)).astype(np.float32)
    if name == "ties":
        per = -(-m // slices)
        for bnd in range(per, m, per):                 # rows bnd - 1, bnd
            known[:, bnd] = known[:, bnd - 1]
        known[:, per + 1] = known[:, per - 1]          # three at one point
        dup = known[:, per - 1::per][:, :3]            # [2, 3, 3]
        pick = rng.integers(0, 3, (2, n // 2))
        query[:, :n // 2] = (np.take_along_axis(dup, pick[..., None], 1)
                             + rng.normal(0, 0.05, (2, n // 2, 3)))
        query[:, :n // 8] = np.take_along_axis(dup, pick[:, :n // 8, None], 1)
    if name == "coincident":
        for b in range(2):
            query[b, ::3] = known[b, rng.integers(0, counts[b],
                                                  len(query[b, ::3]))]
    feats = rng.normal(size=(2, m, 16)).astype(np.float32)
    return query, known, valid, feats, slices


@pytest.mark.parametrize("case", [1, 2, 3] + K15_CASES)
def test_k15_matches_plain(dev, case, monkeypatch):
    """Rows, weights and output bitwise (also the CPU's selections), one
    launch a call; feature gradients (K11's backward) 1e-5. The tiny
    config's levels 1-3 and K15's edge cases."""
    from sassd_tpu_torch.ops import interpolate as itp
    if isinstance(case, int):
        query, centers, valid, feats = three_nn_inputs(11, case, dev)
    else:
        *arrays, slices = three_nn_edge_case(case)
        query, centers, valid, feats = [torch.from_numpy(a).to(dev)
                                        for a in arrays]
        if slices:
            monkeypatch.setattr(itp, "three_nn_slices",
                                lambda b, n, m, device: slices)
    before = itp._K15.launches
    out, rows, w = itp.three_nn_fwd(query, centers, valid, feats)
    torch.cuda.synchronize()
    assert itp._K15.launches == before + 1
    ref_rows, ref_w = itp.three_nn_select_plain(query, centers, valid)
    assert torch.equal(rows.long(), ref_rows)
    assert torch.equal(w, ref_w)
    assert torch.equal(out, itp.three_nn_interpolate_plain(
        query, centers, valid, feats))
    cpu_rows, _ = itp.three_nn_select_plain(*[t.cpu() for t in (
        query, centers, valid)])
    assert torch.equal(rows.cpu().long(), cpu_rows)
    seed = case if isinstance(case, int) else 10 + K15_CASES.index(case)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed)).to(dev)
    fd = feats.clone().requires_grad_()
    itp.three_nn_interpolate(query, centers, valid, fd).backward(cot)
    fp = feats.clone().requires_grad_()
    itp.three_nn_interpolate_plain(query, centers, valid, fp).backward(cot)
    assert rel_err(fd.grad, fp.grad) <= 1e-5


def test_train_plan_wrappers_reject_bad_inputs(dev):
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops import sparse as sp
    grids = [(4, 6, 8), (2, 3, 4), (1, 2, 2), (1, 1, 1)]
    keys = [torch.zeros((1, 8), dtype=torch.int32, device=dev)] * 3
    maps = [torch.full((1, d * h * w), -1, dtype=torch.int32, device=dev)
            for d, h, w in grids[1:]]
    sp.stride_plans_T(keys, maps, grids)                 # fits
    with pytest.raises(TypeError):                       # int16 keys
        sp.stride_plans_T([keys[0].short()] + keys[1:], maps, grids)
    with pytest.raises(ValueError):                      # a wrong grid
        sp.stride_plans_T(keys, maps, grids[:2] + [(1, 2, 3), (1, 1, 2)])
    with pytest.raises(ValueError):                      # map on the host
        sp.stride_plans_T(keys, [maps[0], maps[1].cpu(), maps[2]], grids)
    with pytest.raises(ValueError):                      # a missing level
        sp.stride_plans_T(keys, maps[:2], grids)
    cell0 = torch.zeros((1, 8, 3), dtype=torch.int32, device=dev)
    imap = torch.zeros((1, 24), dtype=torch.int32, device=dev)
    shapes = [(2, 3, 4)] * 3
    with pytest.raises(ValueError):                      # map of another grid
        sp.aux_plans(cell0, [imap] * 3, shapes[:2] + [(2, 3, 5)])
    with pytest.raises(ValueError):                      # map on the host
        sp.aux_plans(cell0, [imap, imap.cpu(), imap], shapes)
    q = torch.zeros((1, 8, 3), device=dev)
    k = torch.zeros((1, 6, 3), device=dev)
    f = torch.zeros((1, 6, 16), device=dev)
    v = torch.ones((1, 6), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):                       # float validity
        itp.three_nn_fwd(q, k, v.float(), f)
    with pytest.raises(ValueError):                      # 5 known rows
        itp.three_nn_fwd(q, k[:, :5].contiguous(), v, f)


@pytest.mark.parametrize("aux", ["ring", "exact"])
def test_tiny_three_class_device_plans_step_card_matches_cpu(dev, aux):
    """A three-class forward_train + backward on device plans, on the card
    and on the CPU: losses 1e-4, grad norm 1e-3; the rulebook's kernels
    (K6, K7, K13) launched, and K14 (ring) or K15 (exact)."""
    import dataclasses
    from sassd_tpu_torch.config import AnchorConfig, tiny_config
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.inference import to_device
    from sassd_tpu_torch.models.detector import parse_losses
    from sassd_tpu_torch.ops import cuda, interpolate, sparse as sp
    from sassd_tpu_torch.weights import seeded_detector
    base = tiny_config()
    kw = dict(strides=(0.8, 0.8, 1.0), offsets=(0.4, -2.8, -1.0))
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, num_class=3,
                                        host_plans=False, aux_interp=aux),
        anchors={"Car": AnchorConfig(sizes=(1.6, 3.9, 1.56), **kw),
                 "Pedestrian": AnchorConfig(sizes=(0.6, 0.8, 1.73), **kw),
                 "Cyclist": AnchorConfig(sizes=(0.6, 1.76, 1.73), **kw)})
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(3),
                                        batch_size=2, n_points=900)
    g = batch["gt_classes"].shape[1]
    batch["gt_classes"] = np.where(batch["gt_valid"], 1 + np.arange(g) % 3,
                                   0).astype(np.int32)
    anchors = torch.from_numpy(kitti.build_anchors(cfg)[0])
    out = {}
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    for where in ("cpu", dev):
        model = seeded_detector(cfg, 2, where)
        model.train()
        losses = model.forward_train(to_device(batch, where),
                                     anchors.to(where))
        parse_losses(losses).backward()
        gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum()
                               for p in model.parameters()))
        out[str(where)] = ({k: float(v) for k, v in losses.items()},
                           float(gnorm))
    torch.cuda.synchronize()
    ran = {k for k, v in cuda.KERNELS.items() if v.launches > before[k]}
    need = [s for k in ("K6", "K7", "K13") for s in sp.KERNEL_SYMBOLS[k]]
    need += (list(sp.KERNEL_SYMBOLS["K14"]) if aux == "ring"
             else list(interpolate.KERNEL_SYMBOLS["K15"]))
    assert set(need) <= ran, ran
    assert (aux == "ring") == bool(ran & set(sp.KERNEL_SYMBOLS["K14"]))
    (cl, cg), (gl, gg) = out["cpu"], out[str(dev)]
    for k, v in cl.items():
        assert abs(gl[k] - v) <= 1e-4 * max(abs(v), 1e-6), (k, gl[k], v)
    assert abs(gg - cg) <= 1e-3 * cg


def tall_banded():
    """The tall tiny config of tests/test_torch_banded.py (H = 256), banded
    over 2 y-bands."""
    import dataclasses
    from sassd_tpu_torch import config
    cfg = config.tiny_config()
    return dataclasses.replace(
        cfg,
        voxel=config.VoxelConfig(voxel_size=(0.1, 0.1, 0.5),
                                 point_cloud_range=(0.0, -12.8, -2.5, 6.4,
                                                    12.8, 1.5),
                                 max_num_points=5, max_voxels=1024),
        caps=dataclasses.replace(cfg.caps,
                                 level_caps=(1024, 4096, 4096, 4096)),
        parallel=config.ParallelConfig(strategy="banded", spatial=2))


def band_inputs(seed):
    """A tall banded batch and its level-0 coords and VFE rows."""
    from sassd_tpu_torch.data import synthetic
    from sassd_tpu_torch.models import backbone
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    cfg = tall_banded()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(seed),
                                        batch_size=2, n_points=900)
    coords = torch.from_numpy(batch["coords"])
    vfe = backbone.vfe_mean(torch.from_numpy(batch["voxels"]),
                            torch.from_numpy(batch["num_points"]))
    return cfg, ss.config_band_spec(cfg), batch, coords, vfe


K16_CASES = (["tall", "tall_cap150"] + PARTITION_CASES
             + [f"m{m}_s{bands}{cut}"
                for m in (1, K16_TILE - 1, K16_TILE, K16_TILE + 1, 80000)
                for bands in (1, 2, 5, 9) for cut in ("", "_cut")])


def k16_case(case):
    """A K16 case: (coords, rows, spec, whether the cap drops members).
    "tall" is the tall banded batch, "tall_cap150" the same at cap0 150;
    the names of PARTITION_CASES are the band edges, uneven and empty
    samples, a ragged tile and a cap cut; "m{M}_s{S}" is batch 2 (the
    second sample with M // 2 rows) over S bands (9: two passes of 8),
    around the tile size and at the long-range size, with "_cut" a cap
    that drops members."""
    if case.startswith("tall"):
        _, spec, _, coords, vfe = band_inputs(3)
        if case == "tall_cap150":
            spec = spec._replace(caps=(150,) + spec.caps[1:])
        return coords, vfe, spec, case == "tall_cap150"
    if case in PARTITION_CASES:
        coords, rows, spec = partition_case(case)
        cut = case == "cap_cut"
    else:
        m_id, s_id = case.split("_")[:2]
        m, bands = int(m_id[1:]), int(s_id[1:])
        coords, rows, spec = partition_rows(np.random.default_rng(m + bands),
                                            [m, m // 2], m, bands)
        cut = case.endswith("_cut")
        if cut:
            spec = spec._replace(caps=(max(1, m // (2 * bands)),)
                                 + spec.caps[1:])
            cut = m > 1
    return torch.from_numpy(coords), torch.from_numpy(rows), spec, cut


@pytest.mark.parametrize("case", K16_CASES)
def test_k16_matches_plain(dev, case):
    """The band partition on the card == its plain version, bitwise (see
    k16_case); a case whose cap drops members counts them."""
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    coords, rows, spec, cut = k16_case(case)
    before = ss._K16.launches
    got = ss.partition(coords.to(dev), rows.to(dev), spec)
    torch.cuda.synchronize()
    assert ss._K16.launches == before + 1
    ref = ss.partition_plain(coords, rows, spec)
    assert all(same_bits(g, r) for g, r in zip(got, ref))
    assert bool((ref[2] > 0).any()) == cut



@pytest.mark.parametrize("level", [1, 2, 3])
def test_k7_y_limit_matches_plain(dev, level):
    """K7 with each band row's limit y_top >> level == the plain version,
    bitwise; the limit clips the top band and no limit is the unlimited
    kernel."""
    from sassd_tpu_torch.models import backbone
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    cfg, spec, _, coords, vfe = band_inputs(4)
    bc = ss.partition_plain(coords, vfe, spec)[0]
    shapes = backbone.level_shapes(ss.band_shape(cfg, spec))
    y_top = ss.y_top_rows(cfg, spec, 2, "cpu")
    keys = sp.coords_to_keys(bc.reshape(4, -1, 3), shapes[0])
    for lvl in range(1, level):
        keys = sp.downsample_keys_plain(keys, shapes[lvl - 1],
                                        spec.caps[lvl], y_top >> lvl)
    args = (shapes[level - 1], spec.caps[level])
    got = sp.downsample_keys(keys.to(dev), *args, (y_top >> level).to(dev))
    free = sp.downsample_keys(keys.to(dev), *args)
    torch.cuda.synchronize()
    ref = sp.downsample_keys_plain(keys, *args, y_top >> level)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(free.cpu(), sp.downsample_keys_plain(keys, *args))
    assert not torch.equal(got[2:], free[2:])


@pytest.mark.parametrize("level", [1, 2, 3])
def test_k11_origins_match_plain(dev, level):
    """K11 with a grid origin per band row: forward, rows and weights
    bitwise its plain version's, feature gradients 1e-5; the one-origin
    call with every row's origin set to it is bitwise the scalar call."""
    from sassd_tpu_torch.models import backbone
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    cfg, spec, _, coords, vfe = band_inputs(5)
    bc, br, _ = ss.partition_plain(coords, vfe, spec)
    shapes = backbone.level_shapes(ss.band_shape(cfg, spec))
    cell0 = bc.reshape(4, -1, 3)
    query = br.reshape(4, -1, 4)[..., :3].contiguous()
    plans = sp.device_rulebook(sp.coords_to_keys(cell0, shapes[0]), shapes,
                               spec.caps[1:], train=True,
                               y_top=ss.y_top_rows(cfg, spec, 2, "cpu"))
    plan = plans[f"aux{level}"]
    m = spec.caps[level]
    c = 32 if level == 1 else 64
    rng = np.random.default_rng(level)
    feats = torch.from_numpy(rng.normal(size=(4, m, c)).astype(np.float32))
    vs = (np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** level).tolist()
    origins = ss.band_origins(cfg, spec, 2, "cpu")
    out, rows, w = itp.ring_interp_fwd(query.to(dev), cell0.to(dev), level,
                                       feats.to(dev), plan.to(dev), vs,
                                       origins.to(dev))
    torch.cuda.synchronize()
    ref_rows, ref_w = itp.ring_select_plain(query, cell0, level, plan, m, vs,
                                            origins)
    assert torch.equal(rows.cpu().long(), ref_rows)
    assert torch.equal(w.cpu(), ref_w)
    assert torch.equal(out.cpu(), itp.neighborhood_interpolate_cells_plain(
        query, cell0, level, feats, plan, vs, origins))
    assert (w.cpu() > 0).any()
    cot = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
        np.float32))
    fc = feats.clone().requires_grad_()
    itp.neighborhood_interpolate_cells(query, cell0, level, fc, plan, vs,
                                       origins).backward(cot)
    fd = feats.to(dev).requires_grad_()
    itp.neighborhood_interpolate_cells(query.to(dev), cell0.to(dev), level,
                                       fd, plan.to(dev), vs, origins.to(dev)
                                       ).backward(cot.to(dev))
    assert rel_err(fd.grad, fc.grad) <= 1e-5
    pc = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    one = torch.from_numpy(np.repeat(pc[None], 4, 0)).to(dev)
    a = itp.ring_interp_fwd(query.to(dev), cell0.to(dev), level,
                            feats.to(dev), plan.to(dev), vs, one)
    b = itp.ring_interp_fwd(query.to(dev), cell0.to(dev), level,
                            feats.to(dev), plan.to(dev), vs, pc.tolist())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_banded_wrappers_reject_bad_inputs(dev):
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    spec = ss.BandSpec(2, 8, 8, (16, 16, 16, 16))
    coords = torch.zeros((1, 8, 3), dtype=torch.int32, device=dev)
    rows = torch.zeros((1, 8, 4), device=dev)
    with pytest.raises(TypeError):                       # int64 coords
        ss.partition(coords.long(), rows, spec)
    with pytest.raises(ValueError):                      # 7 feature rows
        ss.partition(coords, rows[:, :7].contiguous(), spec)
    keys = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                      # one limit, 2 rows
        sp.downsample_keys(keys, (2, 4, 4), 8,
                           torch.zeros(1, dtype=torch.int32, device=dev))
    q = torch.zeros((2, 8, 3), device=dev)
    plan = torch.full((2, 27, 8), -1, dtype=torch.int32, device=dev)
    f = torch.zeros((2, 6, 16), device=dev)
    with pytest.raises(ValueError):                      # [1, 3] origins
        itp.ring_interp_fwd(q, coords.expand(2, 8, 3).contiguous(), 1, f,
                            plan, (0.1, 0.1, 0.1),
                            torch.zeros((1, 3), device=dev))


def test_tiny_banded_step_card_matches_cpu(dev):
    """A banded forward_train + backward and forward_test on the card and
    on the CPU: losses 1e-4, grad norm 1e-3, detections matched; K16, K7
    and K11 launched, no band overflow."""
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.inference import make_test_step, to_device
    from sassd_tpu_torch.models.detector import parse_losses
    from sassd_tpu_torch.ops import cuda, interpolate, sparse as sp
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    from sassd_tpu_torch.weights import seeded_detector
    cfg, _, batch, _, _ = band_inputs(3)
    anchors = torch.from_numpy(kitti.build_anchors(cfg)[0])
    out = {}
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    for where in ("cpu", dev):
        model = seeded_detector(cfg, 2, where)
        model.train()
        losses = model.forward_train(to_device(batch, where),
                                     anchors.to(where))
        parse_losses(losses).backward()
        gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum()
                               for p in model.parameters()))
        dets = make_test_step(cfg, anchors.numpy(), where)(model, batch)
        out[str(where)] = ({k: float(v) for k, v in losses.items()},
                           float(gnorm), {k: v.cpu().numpy()
                                          for k, v in dets.items()})
    torch.cuda.synchronize()
    ran = {k for k, v in cuda.KERNELS.items() if v.launches > before[k]}
    need = [s for ids in (ss.KERNEL_SYMBOLS["K16"], sp.KERNEL_SYMBOLS["K7"],
                          interpolate.KERNEL_SYMBOLS["K11"]) for s in ids]
    assert set(need) <= ran, ran
    (cl, cg, cd), (gl, gg, gd) = out["cpu"], out[str(dev)]
    assert cl["band_overflow"] == gl["band_overflow"] == 0.0
    for k, v in cl.items():
        assert abs(gl[k] - v) <= 1e-4 * max(abs(v), 1e-6), (k, gl[k], v)
    assert abs(gg - cg) <= 1e-3 * cg
    for i in range(2):
        gv, rv = gd["valid"][i], cd["valid"][i]
        assert gv.sum() == rv.sum() and gv.sum() > 0
        for box in gd["boxes"][i][gv]:
            assert (np.abs(cd["boxes"][i][rv] - box).max(1) <= 1e-2).any()
