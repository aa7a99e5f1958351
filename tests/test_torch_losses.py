"""Port parity of the training targets and losses on small inputs: the
rotated 3D IoU, the box coder and nearest-BEV IoU, target assignment, the
four weighted losses, and head_loss, pswarp_loss and aux_loss on the same
head outputs as the JAX package.

Tolerances: the port's rotated 3D IoU rests on K1's Green's-theorem
overlap, which widens or narrows each face by 1e-5 m to settle coincident
edges; on the CPU the JAX package computes the overlap with its
polygon-clip oracle instead (core/riou.py:150), so the two IoUs differ by
up to ~perimeter x 1e-5 / area, 2e-5 on car boxes: held within 1e-4 of
the oracle, and within 1e-5 of the JAX IoU on the JAX package's own
Green's overlap (the one it runs on the accelerator). 1e-5 relative for
the losses (float32 sums in another order); exact for labels.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from sassd_tpu.core import boxes as jboxes  # noqa: E402
from sassd_tpu.core import losses as jlosses  # noqa: E402
from sassd_tpu.core import riou as jriou  # noqa: E402
from sassd_tpu.core import targets as jtargets  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.models import pswarp as jpswarp  # noqa: E402
from sassd_tpu.models import ssd_head as jhead  # noqa: E402
from sassd_tpu.ops.pallas.riou_kernel import rotate_overlap_green  # noqa: E402
from sassd_tpu_torch import config  # noqa: E402
from sassd_tpu_torch.core import boxes, losses, riou, targets  # noqa: E402
from sassd_tpu_torch.data import kitti  # noqa: E402
from sassd_tpu_torch.models import detector, pswarp, ssd_head  # noqa: E402

RTOL = 1e-5


def t(x):
    return torch.from_numpy(np.asarray(x))


def random_boxes(rng, n, spread=4.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1.9, -1.4, n)
    b[:, 3:6] = rng.uniform([1.4, 3.2, 1.4], [1.9, 4.5, 1.8], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.fixture
def green_overlap(monkeypatch):
    """The JAX package's rotated IoUs on its Green's-theorem overlap."""
    monkeypatch.setattr(jriou, "rotate_overlap_bev",
                        lambda a, b: rotate_overlap_green(a, b, criterion=2))


@pytest.mark.parametrize("overlap,atol", [("oracle", 1e-4),
                                          ("green", 1e-5)])
def test_rotate_iou_3d_matches_jax(request, overlap, atol):
    if overlap == "green":
        request.getfixturevalue("green_overlap")
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 60), random_boxes(rng, 9)
    b[:3] = a[:3]                                   # identical pairs
    b[3, :] = a[4] + [0.3, -0.2, 0.1, 0, 0, 0, 0.1]  # near pairs
    got = riou.rotate_iou_3d(t(a), t(b)).numpy()
    ref = np.asarray(jriou.rotate_iou_3d(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, atol=atol)
    assert got.max() > 0.99 and (got > 0.3).sum() > 3


def test_box_encode_and_nearest_iou_match_jax():
    rng = np.random.default_rng(1)
    a, g = random_boxes(rng, 50), random_boxes(rng, 50)
    np.testing.assert_allclose(
        boxes.second_box_encode(t(g), t(a)).numpy(),
        np.asarray(jboxes.second_box_encode(jnp.asarray(g), jnp.asarray(a))),
        rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        boxes.nearest_iou_similarity(t(a), t(g[:7])).numpy(),
        np.asarray(jboxes.nearest_iou_similarity(jnp.asarray(a),
                                                 jnp.asarray(g[:7]))),
        atol=1e-6)


@pytest.mark.parametrize("sim", ["NearestIouSimilarity",
                                 "RotateIou3dSimilarity",
                                 "RotateIou2dSimilarity",
                                 "DistanceSimilarity"])
def test_create_targets_matches_jax(green_overlap, sim):
    """Labels exactly (force matches, negatives, ignored anchors) and the
    residual targets of the positives. The rotated IoUs run on both
    packages' Green's-theorem overlap (the green_overlap fixture)."""
    cfg = config.tiny_config()
    anchors = kitti.build_anchors(cfg)[0]
    rng = np.random.default_rng(2)
    gt = np.zeros((8, 7), np.float32)
    gt[:4] = anchors[rng.choice(len(anchors), 4)] + rng.normal(
        0, 0.2, (4, 7)).astype(np.float32) * [1, 1, 0, 0, 0, 0, 1]
    gv = np.arange(8) < 4
    mask = rng.uniform(size=len(anchors)) < 0.9
    cls = np.where(gv, 1, 0).astype(np.int32)
    got = targets.create_targets(t(anchors), t(gt), t(gv),
                                 targets.SIMILARITY_FNS[sim], 0.6, 0.45,
                                 anchors_mask=t(mask), gt_classes=t(cls))
    ref = jtargets.create_targets(jnp.asarray(anchors), jnp.asarray(gt),
                                  jnp.asarray(gv), jtargets.SIMILARITY_FNS[sim],
                                  0.6, 0.45, anchors_mask=jnp.asarray(mask),
                                  gt_classes=jnp.asarray(cls))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(ref.bbox_targets), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(got.max_overlap.numpy(),
                               np.asarray(ref.max_overlap), atol=1e-5)
    assert (np.asarray(ref.labels) > 0).sum() >= 4
    assert (np.asarray(ref.labels) == -1).sum() > 0


@pytest.mark.parametrize("name", ["sigmoid_focal_loss", "smooth_l1_loss",
                                  "softmax_cross_entropy",
                                  "binary_cross_entropy"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(3)
    pred = rng.normal(0, 3, (4, 50, 2)).astype(np.float32)
    weight = rng.uniform(0, 1, (4, 50, 2)).astype(np.float32)
    if name == "softmax_cross_entropy":
        target = rng.integers(0, 2, (4, 50))
        args = (pred, target, weight[..., 0])
    else:
        target = (rng.uniform(size=(4, 50, 2)) < 0.3).astype(np.float32)
        if name == "smooth_l1_loss":
            target = rng.normal(0, 1, (4, 50, 2)).astype(np.float32)
        args = (pred, target, weight)
    got = getattr(losses, name)(*[t(a) for a in args])
    ref = getattr(jlosses, name)(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


@pytest.fixture(scope="module")
def head_case():
    """Random head outputs over the tiny anchors and padded GTs."""
    cfg = config.tiny_config()
    anchors = kitti.build_anchors(cfg)[0]
    a = len(anchors)
    rng = np.random.default_rng(4)
    outs = [rng.normal(0, 0.5, (2, a, d)).astype(np.float32)
            for d in (7, 1, 2)]
    gt = np.zeros((2, 8, 7), np.float32)
    gv = np.zeros((2, 8), bool)
    for i in range(2):
        gt[i, :3] = anchors[rng.choice(a, 3)] + rng.normal(
            0, 0.15, (3, 7)).astype(np.float32) * [1, 1, 0, 0, 0, 0, 1]
        gv[i, :3] = True
    mask = rng.uniform(size=(2, a)) < 0.9
    return cfg, anchors, outs, gt, gv.astype(np.int32), gv, mask


def test_head_loss_matches_jax(head_case):
    cfg, anchors, outs, gt, gc, gv, mask = head_case
    got = ssd_head.head_loss(ssd_head.HeadOutputs(*map(t, outs)), t(anchors),
                             t(mask), t(gt), t(gc), t(gv), num_class=1,
                             matched_thresholds=(0.6,),
                             unmatched_thresholds=(0.45,))
    ref = jhead.head_loss(jhead.HeadOutputs(*map(jnp.asarray, outs)),
                          jnp.asarray(anchors), jnp.asarray(mask),
                          jnp.asarray(gt), jnp.asarray(gc), jnp.asarray(gv),
                          num_class=1, matched_thresholds=(0.6,),
                          unmatched_thresholds=(0.45,))
    assert got.keys() == ref.keys()
    for k in ref:
        assert float(ref[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL,
                                   err_msg=k)


def test_pswarp_loss_matches_jax(head_case):
    """Guided candidates (GTs prepended) scored and assigned by 3D IoU."""
    cfg, anchors, outs, gt, gc, gv, mask = head_case
    got_ga = ssd_head.get_guided_anchors(
        ssd_head.HeadOutputs(*map(t, outs)), t(anchors), t(mask),
        num_class=1, thr=0.1, cap=40, gt_boxes=t(gt), gt_labels=t(gc),
        gt_valid=t(gv))
    ref_ga = jhead.get_guided_anchors(
        jhead.HeadOutputs(*map(jnp.asarray, outs)), jnp.asarray(anchors),
        jnp.asarray(mask), num_class=1, thr=0.1, cap=40,
        gt_boxes=jnp.asarray(gt), gt_labels=jnp.asarray(gc),
        gt_valid=jnp.asarray(gv))
    np.testing.assert_allclose(got_ga.boxes.numpy(), np.asarray(ref_ga.boxes),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_ga.valid.numpy(),
                                  np.asarray(ref_ga.valid))
    np.testing.assert_array_equal(got_ga.truncated.numpy(),
                                  np.asarray(ref_ga.truncated))
    scores = np.random.default_rng(5).normal(size=(2, 40)).astype(np.float32)
    labels = pswarp.pswarp_labels(got_ga.boxes, got_ga.valid, t(gt), t(gv))
    got = pswarp.pswarp_loss(t(scores), labels)
    ref = jpswarp.pswarp_loss(jnp.asarray(scores), ref_ga.boxes, ref_ga.valid,
                              jnp.asarray(gt), jnp.asarray(gv))
    assert int((labels > 0).sum()) >= 6       # the prepended GTs at least
    np.testing.assert_allclose(float(got["loss_cls"]),
                               float(ref["loss_cls"]), rtol=RTOL)


def test_aux_loss_matches_jax(head_case):
    _, _, _, gt, _, gv, _ = head_case
    rng = np.random.default_rng(6)
    n = 400
    pts = np.concatenate([gt[:, :3, None, :3] + rng.normal(
        0, 0.8, (2, 3, n // 4, 3)).astype(np.float32) + [0, 0, 0.8],
        rng.uniform(-3, 6, (2, 1, n // 4, 3)).astype(np.float32)],
        1).reshape(2, n, 3)
    valid = rng.uniform(size=(2, n)) < 0.9
    point_cls = rng.normal(size=(2, n)).astype(np.float32)
    point_reg = rng.normal(size=(2, n, 3)).astype(np.float32)
    spine = detector.SpineOut(None, None, None, t(pts), t(valid))
    got = detector.aux_loss(t(point_cls), t(point_reg), spine,
                            dict(gt_boxes=t(gt), gt_valid=t(gv)))
    jspine = jdetector.SpineOut(None, None, None, jnp.asarray(pts),
                                jnp.asarray(valid), None, None, None)
    ref = jdetector.aux_loss(jnp.asarray(point_cls), jnp.asarray(point_reg),
                             jspine, dict(gt_boxes=jnp.asarray(gt),
                                          gt_valid=jnp.asarray(gv)))
    label, _ = boxes.aux_targets(t(pts), t(valid), t(gt), t(gv))
    assert 20 < int(label.sum()) < 2 * n
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL,
                                   err_msg=k)
