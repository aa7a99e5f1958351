"""Port parity for K9's compressed corner lattice: the lattice tables of
serve.anchor_lattice and anchors_mask_lattice_plain (K9's steps in plain
PyTorch) against the JAX package's anchors_mask_jax and
anchors_mask_jax_separable (sassd_tpu/serve.py), run eagerly on the CPU,
and against the port's anchors_mask_plain, on the car, three-class,
long-range and tiny corner tables, and the car table with a corner row at
every grid row (tests/test_torch_cases.py K9_CASES).

Masks are booleans of integer counts: equal bit for bit.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu import serve as jserve  # noqa: E402
from sassd_tpu.data.kitti import build_anchors as jbuild_anchors  # noqa: E402
from sassd_tpu_torch import serve  # noqa: E402
from test_torch_cases import K9_CASES, k9_case  # noqa: E402


def check_tables(lattice, corners, h, w):
    """Each grid row (column) maps to the first corner row (column) at or
    past it, -1 past the last; the lattice corners index the corner
    values."""
    xs = np.unique(corners[:, [0, 2]])
    ys = np.unique(corners[:, [1, 3]])
    assert lattice.shape == (len(ys), len(xs))
    assert lattice.grid_hw == (h, w)
    for values, table, n in ((ys, lattice.ymap.numpy(), h),
                             (xs, lattice.xmap.numpy(), w)):
        g = np.arange(n)
        past = g > values[-1]
        assert (table[past] == -1).all()
        k = table[~past]
        assert (values[k] >= g[~past]).all()
        assert ((k == 0) | (values[np.maximum(k - 1, 0)] < g[~past])).all()
    lc = lattice.lattice_corners.numpy()
    np.testing.assert_array_equal(xs[lc[:, [0, 2]]], corners[:, [0, 2]])
    np.testing.assert_array_equal(ys[lc[:, [1, 3]]], corners[:, [1, 3]])


@pytest.mark.parametrize("case", list(K9_CASES))
def test_lattice_mask_matches_jax(case):
    cfg, corners, (h, w), coords = k9_case(case)
    jcfg = getattr(jconfig, K9_CASES[case][0])()
    thr = cfg.data.anchor_area_threshold
    lattice = serve.anchor_lattice(corners, (h, w))
    check_tables(lattice, corners, h, w)
    if case == "car_past_last_corner":
        assert (lattice.ymap == -1).any() and (lattice.xmap == -1).any()
    if case == "car_tall_lattice":
        assert lattice.shape[0] == h
    c = torch.from_numpy(coords)
    got = serve.anchors_mask_lattice_plain(c, lattice, thr)
    assert torch.equal(got, serve.anchors_mask_plain(
        c, torch.from_numpy(corners), (h, w), thr))
    assert torch.equal(serve.anchors_mask(c, lattice, thr), got)
    sep = None
    if K9_CASES[case][1] not in ("past_last_corner", "tall_lattice"):
        sep = jserve.separable_corners(jbuild_anchors(jcfg)[1], jcfg)
        assert sep is not None
    for b in range(coords.shape[0]):
        jc = jnp.asarray(coords[b])
        ref = jserve.anchors_mask_jax(jc, jnp.asarray(corners), (h, w), thr)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))
        if sep is not None:
            ref_sep = jserve.anchors_mask_jax_separable(
                jc, sep, jcfg.model.num_anchor_per_loc, (h, w), thr)
            np.testing.assert_array_equal(got[b].numpy(),
                                          np.asarray(ref_sep))
    kept = got.sum(1)
    assert 0 < kept[0] < corners.shape[0]
    if K9_CASES[case][1] == "empty_sample":
        assert kept[1] == 0
