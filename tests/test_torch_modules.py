"""Port parity, module by module, on tiny_config(): the sparse gather-GEMM
over host plans (batched and strided), the dense z-banded L3 tail against a
dense 3D convolution, box decoding, the folded head, guided anchors (with
exact score ties) and the BEV trunk.

Tolerances: float32 sums in another order, 1e-4 on O(1) features; exact
where no arithmetic differs (indices, tie order, scatter).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.core import boxes as jboxes  # noqa: E402
from sassd_tpu.models import bev as jbev  # noqa: E402
from sassd_tpu.models import ssd_head as jhead  # noqa: E402
from sassd_tpu.ops import sparse as jsp  # noqa: E402
from sassd_tpu_torch import config  # noqa: E402
from sassd_tpu_torch.core import boxes  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models import backbone, bev, ssd_head  # noqa: E402
from sassd_tpu_torch.ops import sparse as sp  # noqa: E402

ATOL = 1e-4


def tiny_batch(seed, batch_size=2):
    cfg = config.tiny_config()
    return cfg, synthetic.make_random_batch(
        cfg, np.random.default_rng(seed), batch_size=batch_size, n_points=900)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_subm_conv_batched_matches_jax(level):
    """Gather-GEMM over a flat batch with b * rows_in plan offsets, for a
    subm plan (level 0) and the stride plans into the previous level."""
    cfg, batch = tiny_batch(level)
    rng = np.random.default_rng(10 + level)
    kind = "subm0" if level == 0 else f"stride{level}"
    plan = batch[f"plan_{kind}"]                         # [B, 27, M_out]
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    m_in = caps[max(level - 1, 0)]
    cin, cout = 8, 5
    feats = rng.normal(size=(2, m_in, cin)).astype(np.float32)
    w = rng.normal(size=(27, cin, cout)).astype(np.float32)
    got = sp.subm_conv_batched(t(feats), t(w), t(plan))
    jplan = jsp.SubmPlan(jnp.maximum(jnp.asarray(plan), 0).astype(jnp.int32),
                         jnp.asarray(plan) >= 0)
    ref = jsp.subm_conv_batched(jnp.asarray(feats), jnp.asarray(w), jplan,
                                symmetric=False, triple=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert (plan >= 0).sum() > 0


def test_flatten_plan_matches_jax():
    _, batch = tiny_batch(4)
    plan = batch["plan_stride2"]
    got = sp.flatten_plan(sp.host_plan(t(plan)), 512)
    ref = jsp.flatten_plan(jsp.SubmPlan(
        jnp.maximum(jnp.asarray(plan), 0).astype(jnp.int32),
        jnp.asarray(plan) >= 0), 512)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(ref.found))


def test_to_dense_and_keys_match_jax():
    cfg, batch = tiny_batch(5)
    coords = batch["plan_coords2"]                       # [B, cap2, 3]
    shape2 = sp.out_shape_stride2(sp.out_shape_stride2(cfg.sparse_shape))
    keys = sp.coords_to_keys(t(coords), shape2)
    jkeys = np.stack([np.asarray(jsp.coords_to_keys(jnp.asarray(c), shape2))
                      for c in coords])
    np.testing.assert_array_equal(keys.numpy(), jkeys)
    feats = np.random.default_rng(5).normal(
        size=coords.shape[:2] + (6,)).astype(np.float32)
    got = sp.to_dense(keys, t(feats), shape2)
    ref = np.stack([np.asarray(jsp.to_dense(jnp.asarray(k), jnp.asarray(f),
                                            shape2))
                    for k, f in zip(jkeys, feats)])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_zbanded_tail_conv_equals_conv3d():
    """The z-banded 2D conv over [B, D*C, H, W] is the 3D conv with
    padding 1 and the (dz, dy, dx) tap order of the sparse weights."""
    rng = np.random.default_rng(6)
    b, d, h, w, c = 2, 5, 6, 7, 4
    x = rng.normal(size=(b, d, c, h, w)).astype(np.float32)
    w27 = rng.normal(size=(27, c, c)).astype(np.float32)
    got = F.conv2d(t(x).reshape(b, d * c, h, w),
                   backbone.zbanded_oihw(t(w27), d), padding=1)
    w3d = t(w27).reshape(3, 3, 3, c, c).permute(4, 3, 0, 1, 2)  # O,I,D,H,W
    ref = F.conv3d(t(x).permute(0, 2, 1, 3, 4), w3d, padding=1)
    np.testing.assert_allclose(got.reshape(b, d, c, h, w).numpy(),
                               ref.permute(0, 2, 1, 3, 4).numpy(), atol=ATOL)


def test_second_box_decode_matches_jax():
    rng = np.random.default_rng(7)
    enc = rng.normal(size=(3, 50, 7)).astype(np.float32)
    enc[0, :5, 3:6] = 40.0                              # clamped sizes
    anchors = kitti.build_anchors(config.tiny_config())[0][:50]
    got = boxes.second_box_decode(t(enc), t(anchors)[None])
    ref = jboxes.second_box_decode(jnp.asarray(enc),
                                   jnp.asarray(anchors)[None])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-5)
    assert np.isfinite(got.numpy()).all()


def test_head_and_guided_anchors_match_jax_with_ties():
    """Folded head + guided anchors. Half of the BEV map is zero, so those
    anchors share their scores exactly and the cap falls inside the tie:
    the port's stable top-k must pick lax.top_k's lower-index-first set."""
    cfg = config.tiny_config()
    rng = np.random.default_rng(8)
    params = jhead.head_init(jax.random.PRNGKey(8), 32, 1, 2, 7)
    params = jax.tree_util.tree_map(np.asarray, params)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    x[:, :, 4:] = 0.0
    anchors = kitti.build_anchors(cfg)[0]
    mask = rng.uniform(size=(2, anchors.shape[0])) < 0.9
    ref_outs = jhead.head_apply(params, jnp.asarray(x), 1, 7, 2, fold=True)
    ref = jhead.get_guided_anchors(ref_outs, jnp.asarray(anchors),
                                   jnp.asarray(mask), num_class=1, thr=0.1,
                                   cap=40)
    head = ssd_head.SSDHead(torch.Generator(), 32, 1, 2, 7)
    head.load_state_dict({f"{k}.{p}": t(v) for k, d in params.items()
                          for p, v in d.items()})
    outs = head(t(x))
    for g, r in zip(outs, ref_outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=ATOL)
    got = ssd_head.get_guided_anchors(outs, t(anchors), t(mask), num_class=1,
                                      thr=0.1, cap=40)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.boxes.detach().numpy(),
                               np.asarray(ref.boxes), atol=ATOL)
    np.testing.assert_array_equal(got.truncated.numpy(),
                                  np.asarray(ref.truncated))


def test_bevnet_matches_jax():
    rng = np.random.default_rng(9)
    params, state = jbev.bevnet_init(jax.random.PRNGKey(9), 12, 16)
    state = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.8, 1.2, v.shape).astype(np.float32), state)
    params = jax.tree_util.tree_map(lambda v: np.asarray(v) * 6 ** 0.5,
                                    params)
    x = rng.normal(size=(2, 9, 11, 12)).astype(np.float32)
    ref_final, ref_conv6, _ = jbev.bevnet_apply(params, state, jnp.asarray(x),
                                                train=False)
    net = bev.BEVNet(torch.Generator(), 12, 16)
    sd = {f"{k}.{p}": t(v) for tree in (params, state)
          for k, d in tree.items() for p, v in d.items()}
    net.load_state_dict(sd)
    final, conv6 = net(t(x))
    # 8 convs of O(10) activations: float32 sums in another order, relative
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(ref_final),
                               rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(conv6.detach().numpy(), np.asarray(ref_conv6),
                               rtol=1e-4, atol=ATOL)
    assert np.abs(np.asarray(ref_final)).max() > 0.1


def test_config_car_shapes():
    """The car config's derived shapes, which the kernels are sized for."""
    cfg = config.car_config()
    assert cfg.sparse_shape == (40, 1600, 1408)
    assert cfg.bev_map_size == (200, 176)
    assert cfg.num_anchors == 70400
    assert jconfig.car_config().num_anchors == cfg.num_anchors
    assert backbone.VxNet(torch.Generator(), 4, cfg.sparse_shape
                          ).level_shapes[3] == (5, 200, 176)
