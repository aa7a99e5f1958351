"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: every test skips without a CUDA device. On the GPU
machine (which has no JAX, which tests/conftest.py imports) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 1e-4 m^2 (float32, -fmad=false, same op sequence as the
plain version), K2 exact flags, K3 1e-5 (sum order of 28 samples).
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


def test_tiny_forward_card_matches_cpu(dev):
    from sassd_tpu_torch.config import tiny_config
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.inference import make_test_step
    from sassd_tpu_torch.ops import cuda
    from sassd_tpu_torch.weights import seeded_detector
    cfg = tiny_config()
    model = seeded_detector(cfg, 1)
    anchors = kitti.build_anchors(cfg)[0]
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(2),
                                        batch_size=2, n_points=900)
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    got = make_test_step(cfg, anchors, dev)(seeded_detector(cfg, 1, dev),
                                            batch)
    torch.cuda.synchronize()
    after = {k: v.launches for k, v in cuda.KERNELS.items()}
    assert all(after[k] > before[k] for k in after), (before, after)
    ref = make_test_step(cfg, anchors, "cpu")(model, batch)
    for i in range(2):
        gv, rv = got["valid"][i].cpu().numpy(), ref["valid"][i].numpy()
        assert gv.sum() == rv.sum() and gv.sum() > 0
        gb = got["boxes"][i].cpu().numpy()[gv]
        rb = ref["boxes"][i].numpy()[rv]
        for box in gb:
            assert (np.abs(rb - box).max(1) <= 1e-2).any()

