"""Port parity: K1 (rotated overlap) and K2 (rotated NMS) plain versions
against the JAX package, plus the wrapper's CPU routing.

K1's plain version is held against the JAX device kernel
``rotate_overlap_green`` itself (on the CPU the JAX package's
``rotate_overlap_bev`` takes its Sutherland-Hodgman oracle instead), with
the tolerances of tests/test_pallas_riou.py.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from sassd_tpu.core import riou as jriou  # noqa: E402
from sassd_tpu.ops.pallas.riou_kernel import rotate_overlap_green  # noqa: E402
from sassd_tpu_torch.core import riou  # noqa: E402
from sassd_tpu_torch.ops import cuda, riou_kernel  # noqa: E402
from test_torch_cuda import k2_matrix  # noqa: E402


def random_bev(rng, n):
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(-8, 8, (n, 2))
    b[:, 2:4] = rng.uniform(0.5, 5.0, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


def both(a, b, criterion):
    got = riou_kernel.rotate_overlap(torch.from_numpy(a), torch.from_numpy(b),
                                     criterion).numpy()
    ref = np.asarray(rotate_overlap_green(jnp.asarray(a), jnp.asarray(b),
                                          criterion))
    return got, ref


def test_overlap_random_matches_green():
    rng = np.random.default_rng(0)
    got, ref = both(random_bev(rng, 37), random_bev(rng, 131), 2)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.count_nonzero(ref) > 50          # the set has real overlaps


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_overlap_criteria_match_green(criterion):
    rng = np.random.default_rng(1)
    got, ref = both(random_bev(rng, 16), random_bev(rng, 16), criterion)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_overlap_zero_padding():
    rng = np.random.default_rng(2)
    a = np.concatenate([random_bev(rng, 4), np.zeros((4, 5), np.float32)])
    got, ref = both(a, random_bev(rng, 8), 2)
    assert np.all(got[4:] == 0.0)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_overlap_degenerate_pairs():
    boxes = np.array([
        [0.0, 0.0, 2.0, 4.0, 0.0],        # base
        [0.0, 0.0, 2.0, 4.0, 0.0],        # identical
        [2.0, 0.0, 2.0, 4.0, 0.0],        # touching (shares edge x=1)
        [0.0, 0.0, 1.0, 2.0, 0.0],        # contained
        [10.0, 10.0, 2.0, 4.0, 0.0],      # disjoint
        [0.5, 0.0, 2.0, 4.0, 0.0],        # overlap, collinear edges
        [0.0, 0.0, 2.0, 4.0, np.pi / 2],  # rotated 90 deg
        [0.0, 0.0, 2.0, 4.0, np.pi],      # rotated 180 = identical shape
    ], np.float32)
    got, ref = both(boxes, boxes, 2)
    np.testing.assert_allclose(got, ref, atol=5e-3)
    assert abs(got[0, 1] - 8.0) < 1e-2
    assert abs(got[0, 2]) < 1e-2
    assert abs(got[0, 3] - 2.0) < 1e-2
    assert got[0, 4] == 0.0
    assert abs(got[0, 7] - 8.0) < 1e-2
    assert abs(got[0, 6] - 4.0) < 1e-2


def clustered(rng, n, n_obj):
    centers = rng.uniform(-30, 30, (n_obj, 2))
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = centers[rng.integers(0, n_obj, n)] + rng.normal(0, 0.7, (n, 2))
    b[:, 2] = rng.uniform(1.4, 1.9, n)
    b[:, 3] = rng.uniform(3.2, 4.6, n)
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize("n,thr,max_det", [
    (200, 0.1, None),        # JAX unblocked path
    (200, 0.5, None),
    (600, 0.1, 40),          # JAX blocked path (n > block_size, max_det)
    (600, 0.3, 80),
])
def test_rotate_nms_matches_jax(n, thr, max_det):
    rng = np.random.default_rng(n + int(thr * 10))
    boxes = clustered(rng, n, n // 10)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    order, keep = riou.rotate_nms(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), thr,
                                  valid=torch.from_numpy(valid))
    jorder, jkeep = jriou.rotate_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                     thr, valid=jnp.asarray(valid),
                                     max_det=max_det)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    kept = order.numpy()[keep.numpy()]
    jkept = np.asarray(jorder)[np.asarray(jkeep)]
    m = len(jkept) if max_det is None else max_det
    assert len(kept) >= min(m, len(jkept)) and len(kept) > 10
    np.testing.assert_array_equal(kept[:m], jkept[:m])
    assert not keep.numpy()[~valid[order.numpy()]].any()


def test_nms_keep_plain_is_exact_greedy():
    rng = np.random.default_rng(5)
    n = 300
    iou = rng.uniform(0, 0.3, (n, n)).astype(np.float32)
    keep0 = rng.uniform(size=n) < 0.8
    got = riou.nms_keep(torch.from_numpy(iou), torch.from_numpy(keep0),
                        0.2).numpy()
    ref = np.zeros(n, bool)
    for i in range(n):                       # the textbook serial loop
        ref[i] = keep0[i] and not any(ref[j] and iou[i, j] > 0.2
                                      for j in range(i))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,kind", [
    (1, "chain"), (63, "chain"), (64, "chain"), (65, "chain"),
    (130, "chain"), (63, "ties"), (64, "ties"), (65, "ties"),
    (130, "ties"), (2113, "random")])
def test_nms_keep_plain_matches_jax_fixpoint(n, kind):
    """K2's plain version == the JAX package's _fixpoint_keep on the same
    matrix, with the suppression relation built as its rotate_nms builds
    it (strict iou > thr, j < i): suppression chains (kept and dropped
    alternate), entries exactly at thr (no suppression) and a sparse
    random matrix across several 64-box blocks."""
    rng = np.random.default_rng(n)
    thr = 0.5
    iou = k2_matrix(kind, n, thr, rng)
    keep0 = rng.uniform(size=n) < 0.9
    got = riou.nms_keep_plain(torch.from_numpy(iou), torch.from_numpy(keep0),
                              thr).numpy()
    tri = jnp.tril(jnp.ones((n, n), bool), k=-1)
    sup = tri & (jnp.asarray(iou) > thr)
    ref = np.asarray(jriou._fixpoint_keep(jnp.asarray(keep0), sup))
    np.testing.assert_array_equal(got, ref)
    if kind == "chain" and n > 2:
        assert got.any() and not got[keep0].all()
    if kind == "ties":
        assert (iou == thr).sum() > n                 # ties are present


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions: no kernel build,
    no launch counted, and the module imports without nvcc or triton."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(random_bev(rng, 12))
    before = {k: v.launches for k, v in cuda.KERNELS.items()}
    out = riou_kernel.rotate_overlap(a, a, -1)
    torch.testing.assert_close(out, riou_kernel.rotate_overlap_plain(a, a, -1),
                               rtol=0, atol=0)
    keep0 = torch.ones(12, dtype=torch.bool)
    torch.testing.assert_close(riou.nms_keep(out, keep0, 0.1),
                               riou.nms_keep_plain(out, keep0, 0.1))
    assert {k: v.launches for k, v in cuda.KERNELS.items()} == before
    assert cuda._lib is None


def far_pairs(rng, n, scale, align):
    """[N, 5] a and b boxes, pair i at centre distance scale x (r_a + r_b +
    CULL_MARGIN), r the circumradius: sizes 0.1-20 m, centres up to
    +-110 m, random directions. align=True turns a corner of each box onto
    the centre line, towards the other box (the closest two rectangles at
    that distance can come); else random yaws."""
    a = np.zeros((n, 5), np.float32)
    b = np.zeros((n, 5), np.float32)
    a[:, :2] = rng.uniform(-110, 110, (n, 2))
    a[:, 2:4] = rng.uniform(0.1, 20, (n, 2))
    b[:, 2:4] = rng.uniform(0.1, 20, (n, 2))
    th = rng.uniform(-np.pi, np.pi, n)
    r = [0.5 * np.hypot(x[:, 2].astype(np.float64), x[:, 3]) for x in (a, b)]
    d = (r[0] + r[1] + riou_kernel.CULL_MARGIN) * scale
    b[:, 0] = a[:, 0] + d * np.cos(th)
    b[:, 1] = a[:, 1] + d * np.sin(th)
    if align:
        # corner k in the box frame points at atan2(sy l, sx w); the yaw
        # turns it clockwise
        sx = np.array([0.5, -0.5, -0.5, 0.5])
        sy = np.array([0.5, 0.5, -0.5, -0.5])
        k = rng.integers(0, 4, (2, n))
        for x, kk, to in ((a, k[0], th), (b, k[1], th + np.pi)):
            phi = np.arctan2(sy[kk] * x[:, 3], sx[kk] * x[:, 2])
            x[:, 4] = np.angle(np.exp(1j * (phi - to)))
    else:
        a[:, 4] = rng.uniform(-np.pi, np.pi, n)
        b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return torch.from_numpy(a), torch.from_numpy(b)


def cull_case(case, rng):
    """(a, b, pairs that must be near) of a separation-cull case."""
    if case == "random":
        boxes = []
        for n in (300, 200):
            x = np.zeros((n, 5), np.float32)
            x[:, :2] = rng.uniform(-110, 110, (n, 2))
            x[:, 2:4] = rng.uniform(0.1, 20, (n, 2))
            x[:, 4] = rng.uniform(-np.pi, np.pi, n)
            boxes.append(torch.from_numpy(x))
        return boxes[0], boxes[1], None
    if case.startswith("outside"):
        return (*far_pairs(rng, 400, 1 + 1e-5, case.endswith("aligned")),
                None)
    if case == "inside_aligned":
        a, b = far_pairs(rng, 400, 1 - 1e-3, True)
        return a, b, torch.eye(400, dtype=torch.bool)
    if case == "degenerate_and_padding":
        # the degenerate set and zero-size padding boxes on the base box's
        # corner and edge, 5 mm off its edge, at its centre and far away
        zero = np.array([[1.0, 2.0, 0, 0, 0], [1.0, 0.0, 0, 0, 0],
                         [1.005, 0.0, 0, 0, 0], [0.0, 0.0, 0, 0, 0],
                         [50.0, 50.0, 0, 0, 0]], np.float32)
        boxes = torch.from_numpy(np.concatenate([DEGENERATE, zero]))
        must = torch.zeros((13, 13), dtype=torch.bool)
        must[0, [1, 2, 3, 5, 6, 7, 8, 9, 10, 11]] = True
        return boxes, boxes, must | must.T
    # boxes the cull never rejects: a non-finite field, or a centre or a
    # size beyond CULL_LIMIT
    x = np.zeros((8, 5), np.float32)
    x[:, :2] = rng.uniform(-30, 30, (8, 2))
    x[:, 2:4] = 2.0
    x[0, 4] = np.nan
    x[1, 0] = np.inf
    x[2, 2] = np.nan
    x[3, 1] = -2000.0
    x[4, 3] = 1500.0
    x[5, 2] = -np.inf
    must = torch.zeros((8, 8), dtype=torch.bool)
    must[:6] = True
    return torch.from_numpy(x), torch.from_numpy(x), must | must.T


DEGENERATE = np.array([
    [0.0, 0.0, 2.0, 4.0, 0.0], [0.0, 0.0, 2.0, 4.0, 0.0],
    [2.0, 0.0, 2.0, 4.0, 0.0], [0.0, 0.0, 1.0, 2.0, 0.0],
    [10.0, 10.0, 2.0, 4.0, 0.0], [0.5, 0.0, 2.0, 4.0, 0.0],
    [0.0, 0.0, 2.0, 4.0, np.pi / 2], [0.0, 0.0, 2.0, 4.0, np.pi],
], np.float32)


@pytest.mark.parametrize("case", [
    "random", "outside_aligned", "outside_random_yaw", "inside_aligned",
    "degenerate_and_padding", "never_culled"])
def test_cull_rejects_only_pairs_of_zero_overlap(case):
    """K1's separation cull (near_pairs_plain): every pair it rejects has
    exactly +0.0 (the sign bit clear) from the plain version in all four
    criteria, which is what the kernel writes for it. Pairs just outside
    r_a + r_b + CULL_MARGIN with a corner of each box facing the other are
    rejected; pairs 0.1% inside it, touching boxes, zero-size boxes on an
    edge and boxes with a non-finite field or beyond CULL_LIMIT are not."""
    rng = np.random.default_rng(len(case))
    a, b, must_near = cull_case(case, rng)
    near = riou_kernel.near_pairs_plain(a, b)
    assert near.shape == (a.shape[0], b.shape[0])
    for crit in (2, -1, 0, 1):
        out = riou_kernel.rotate_overlap_plain(a, b, crit)
        assert (out.view(torch.int32)[~near] == 0).all(), crit
    if must_near is not None:
        assert near[must_near].all()
    if case.startswith("outside"):
        assert not near.diagonal().any()
    if case == "random":
        assert near.any() and (~near).sum() > 0.9 * near.numel()
    if case == "inside_aligned":
        inter = riou_kernel.rotate_overlap_plain(a, b, 2).diagonal()
        assert (inter > 0).sum() > 100          # corners overlap
