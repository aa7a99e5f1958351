"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: every test skips without a CUDA device. On the GPU
machine (which has no JAX, which tests/conftest.py imports) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 1e-4 m^2 (float32, -fmad=false, same op sequence as the
plain version), K2 exact flags, K3 1e-5 (sum order of 28 samples), K4
1e-4 abs + 1e-4 rel (float32 sums of up to 27 * 64 products in another
order than cuBLAS), K5-K9 exact (integer results, a scatter of unique
keys, copies of points, float32 sums of integer counts). The training
kernels, relative to the largest magnitude of the plain result: K10 and
K4's input gradients 1e-5 (float32 sums over thousands of rows in another
order), K11's forward, K12 and K5b exact (the same float32 operations,
copies), K11's backward and K3b 1e-5 (atomicAdd order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


@pytest.mark.parametrize("kind,level_in,cin,cout,dtype", [
    ("subm0", 0, 4, 16, torch.int16), ("subm0", 0, 16, 16, torch.int32),
    ("stride1", 0, 16, 32, torch.int16), ("subm1", 1, 32, 32, torch.int32),
    ("stride2", 1, 32, 64, torch.int16), ("subm2", 2, 64, 64, torch.int16),
    ("stride3", 2, 64, 64, torch.int32)])
def test_k4_matches_plain(dev, kind, level_in, cin, cout, dtype):
    from sassd_tpu_torch.ops import sparse as sp
    cfg, batch, _ = tiny_rulebook(1)
    plan = torch.from_numpy(batch[f"plan_{kind}"]).to(dtype)
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


def test_k5_matches_plain(dev):
    from sassd_tpu_torch.ops import sparse as sp
    _, batch, shapes = tiny_rulebook(2)
    keys = sp.coords_to_keys(torch.from_numpy(batch["plan_coords3"]),
                             shapes[3])
    feats = torch.from_numpy(np.random.default_rng(3).normal(
        size=tuple(keys.shape) + (64,)).astype(np.float32))
    feats[keys == sp.INVALID_KEY] = 0.0
    canvas, occ = sp.densify_nchw(keys.to(dev), feats.to(dev), shapes[3])
    torch.cuda.synchronize()
    ref_canvas, ref_occ = sp.densify_nchw_plain(keys, feats, shapes[3])
    assert torch.equal(canvas.cpu(), ref_canvas)
    assert torch.equal(occ.cpu(), ref_occ)


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
    before = vox._K8_WRITE.launches
    got = vox.voxelize(torch.from_numpy(pts).to(dev),
                       torch.from_numpy(n).to(dev), cfg.voxel)
    torch.cuda.synchronize()
    assert vox._K8_WRITE.launches == before + 1
    ref = vox.voxelize_plain(torch.from_numpy(pts), torch.from_numpy(n),
                             cfg.voxel)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    n_vox = (ref[1][..., 0] >= 0).sum(1)
    assert n_vox.max() == cfg.voxel.max_voxels or len(n_points) == 1


@pytest.mark.parametrize("name", ["tiny_config", "car_config"])
def test_k9_matches_plain(dev, name):
    from sassd_tpu_torch import config, serve
    from sassd_tpu_torch.data import kitti
    cfg = getattr(config, name)()
    _, anchors_bv = kitti.build_anchors(cfg)
    corners = torch.from_numpy(serve.anchor_corner_indices(
        anchors_bv, cfg.voxel.voxel_size, cfg.voxel.point_cloud_range,
        cfg.voxel.grid_size))
    d, h, w = cfg.sparse_shape
    cap = cfg.voxel.max_voxels
    rng = np.random.default_rng(5)
    coords = np.full((2, cap, 3), -1, np.int32)
    for b, n in enumerate((cap // 3, cap)):
        coords[b, :n] = np.stack([rng.integers(0, d, n),
                                  rng.integers(0, h // 2, n),
                                  rng.integers(0, w, n)], 1)
    c = torch.from_numpy(coords)
    got = serve.anchors_mask(c.to(dev), corners.to(dev), (h, w), 1.0)
    torch.cuda.synchronize()
    ref = serve.anchors_mask_plain(c, corners, (h, w), 1.0)
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
    coords = torch.zeros((1, 8, 3), dtype=torch.int32, device=dev)
    corners = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                      # corners [4, 3]
        serve.anchors_mask(coords, corners[:, :3].contiguous(), (2, 2), 1.0)
    with pytest.raises(ValueError):                      # corners on host
        serve.anchors_mask(coords, corners.cpu(), (2, 2), 1.0)
    with pytest.raises(TypeError):
        serve.anchors_mask(coords.long(), corners, (2, 2), 1.0)


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
    corners = torch.from_numpy(serve.anchor_corner_indices(
        anchors_bv, cfg.voxel.voxel_size, cfg.voxel.point_cloud_range,
        cfg.voxel.grid_size))
    pts, n = (torch.from_numpy(batch[k]) for k in ("points", "n_points"))
    got = serve.batch_from_points(pts.to(dev), n.to(dev), corners.to(dev),
                                  cfg)
    ref = serve.batch_from_points(pts, n, corners, cfg)
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
    d_weight) against autograd of the plain forward on the CPU."""
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
    needs_dx = cin != 4
    xc, wc = x.clone().requires_grad_(needs_dx), w.clone().requires_grad_()
    fn(xc, wc, *args).backward(cot)
    xd = x.to(dev).requires_grad_(needs_dx)
    wd = w.to(dev).requires_grad_()
    before = sp._K10.launches
    fn(xd, wd, *[a.to(dev) for a in args]).backward(cot.to(dev))
    torch.cuda.synchronize()
    assert sp._K10.launches == before + 1
    assert rel_err(wd.grad, wc.grad) <= 1e-5
    if needs_dx:
        assert rel_err(xd.grad, xc.grad) <= 1e-5
    assert rel_err(sp.conv_weight_grad(x.to(dev), plan.to(dev), cot.to(dev)),
                   sp.conv_weight_grad_plain(x, plan, cot)) <= 1e-5


def test_k5b_matches_plain(dev):
    from sassd_tpu_torch.ops import sparse as sp
    _, batch, shapes = tiny_rulebook(7)
    keys = sp.coords_to_keys(torch.from_numpy(batch["plan_coords3"]),
                             shapes[3])
    d, h, w = shapes[3]
    rng = np.random.default_rng(8)
    d_canvas = torch.from_numpy(rng.normal(
        size=(2, d * 64, h, w)).astype(np.float32))
    before = sp._K5B.launches
    feats = torch.zeros(tuple(keys.shape) + (64,), device=dev,
                        requires_grad=True)
    canvas, _ = sp.densify_nchw(keys.to(dev), feats, shapes[3])
    canvas.backward(d_canvas.to(dev))
    torch.cuda.synchronize()
    assert sp._K5B.launches == before + 1
    assert torch.equal(feats.grad.cpu(),
                       sp.densify_grad_plain(keys, d_canvas, shapes[3]))


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
