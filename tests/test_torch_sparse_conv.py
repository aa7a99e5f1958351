"""Port parity for the sparse gather-GEMM (K4) and the dense-tail scatter
(K5), through their plain versions (CPU tensors), against the JAX
package: _subm_conv_raw with the packed triple gather on submanifold and
stride plans of the device rulebook, and to_dense + the d-major transpose
of densify_bev.

Tolerances: 1e-5 on O(1) conv outputs (float32 sums of 27 * Cin products
in another order); the scatter moves values and must be exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from sassd_tpu.models import backbone as jbackbone  # noqa: E402
from sassd_tpu.ops import sparse as jsp  # noqa: E402
from sassd_tpu_torch import config  # noqa: E402
from sassd_tpu_torch.data import synthetic  # noqa: E402
from sassd_tpu_torch.ops import sparse as sp  # noqa: E402
from test_torch_cuda import k5_edge_case  # noqa: E402


def tiny_rulebook(seed):
    """Device rulebook (plain) of two voxelized tiny scans, with the
    level shapes and per-level keys."""
    cfg = config.tiny_config()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(seed),
                                        batch_size=2, n_points=900)
    shapes = [cfg.sparse_shape]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    keys = [sp.coords_to_keys(torch.from_numpy(batch["coords"]), shapes[0])]
    plans = sp.device_rulebook(keys[0], shapes, cfg.caps.level_caps[1:])
    for lvl in (1, 2, 3):
        keys.append(sp.coords_to_keys(plans[f"coords{lvl}"], shapes[lvl]))
    return plans, shapes, keys


@pytest.mark.parametrize("kind,level_in,cin,cout,dtype", [
    ("subm0", 0, 4, 16, torch.int32), ("subm0", 0, 16, 16, torch.int16),
    ("stride1", 0, 16, 32, torch.int32), ("subm1", 1, 32, 32, torch.int16),
    ("stride2", 1, 32, 64, torch.int16), ("subm2", 2, 64, 64, torch.int32),
    ("stride3", 2, 64, 64, torch.int32)])
def test_subm_conv_batched_matches_jax_triple(kind, level_in, cin, cout,
                                              dtype):
    """The plain K4 path (int16 or int32 wire plan, flat batch) == JAX
    _subm_conv_raw(triple=True) per sample."""
    plans, _, keys = tiny_rulebook(1)
    plan = plans[kind]
    m_in = keys[level_in].shape[1]
    rng = np.random.default_rng(cin + cout)
    feats = rng.normal(size=(2, m_in, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    got = sp.subm_conv_batched(torch.from_numpy(feats), torch.from_numpy(w),
                               plan.to(dtype)).numpy()
    for b in range(2):
        p = jnp.asarray(plan[b].numpy())
        ref = jsp._subm_conv_raw(jnp.asarray(feats[b]), jnp.asarray(w),
                                 jsp.SubmPlan(jnp.maximum(p, 0), p >= 0),
                                 jnp.float32, triple=True)
        np.testing.assert_allclose(got[b], np.asarray(ref), atol=1e-5)
    assert (plan >= 0).sum() > 0 and np.abs(got).max() > 0.5


def edge_plan(plan, case):
    """A wire plan [B, 27, M] made into one of the edge cases of the card
    kernels' tap skipping: a tap found for no row, a 64-row tile (rows
    64..127) with no found row, or sample 1 all padding."""
    p = plan.clone()
    if case == "tap_never_found":
        p[:, 13] = -1
    elif case == "empty_tile":
        p[..., 64:128] = -1
    elif case == "padded_sample":
        p[1] = -1
    return p


@pytest.mark.parametrize("kind,level_in,cin,cout,dtype,case", [
    ("subm0", 0, 4, 16, torch.int32, "tap_never_found"),
    ("subm2", 2, 64, 64, torch.int16, "tap_never_found"),
    ("subm1", 1, 32, 32, torch.int32, "empty_tile"),
    ("stride2", 1, 32, 64, torch.int16, "empty_tile"),
    ("subm0", 0, 16, 16, torch.int16, "padded_sample"),
    ("stride3", 2, 64, 64, torch.int32, "padded_sample"),
    ("strideT2", 2, 64, 32, torch.int16, None),
    ("strideT1", 1, 32, 16, torch.int32, "padded_sample")])
def test_subm_conv_batched_edge_plans_match_jax(kind, level_in, cin, cout,
                                                dtype, case):
    """The plain K4 path on the edge-case plans of tap skipping and on the
    stride convs' transpose plans (the input gradient's plan into the
    output level) == JAX _subm_conv_raw per sample, with the unpacked
    gather (a masked tap breaks the packed gather's adjacency)."""
    plans, shapes, keys = tiny_rulebook(1)
    if kind.startswith("strideT"):
        plans = sp.device_rulebook(keys[0], shapes,
                                   config.tiny_config().caps.level_caps[1:],
                                   train=True, aux=False)
    plan = edge_plan(plans[kind].to(dtype), case)
    m_in = keys[level_in].shape[1]
    rng = np.random.default_rng(cin + cout + 1)
    feats = rng.normal(size=(2, m_in, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    got = sp.subm_conv_batched(torch.from_numpy(feats), torch.from_numpy(w),
                               plan).numpy()
    for b in range(2):
        p = jnp.asarray(plan[b].to(torch.int32).numpy())
        ref = jsp._subm_conv_raw(jnp.asarray(feats[b]), jnp.asarray(w),
                                 jsp.SubmPlan(jnp.maximum(p, 0), p >= 0),
                                 jnp.float32, triple=False)
        np.testing.assert_allclose(got[b], np.asarray(ref), atol=1e-5)
    if case == "padded_sample":
        assert not got[1].any()
    if case == "empty_tile":
        assert not got[:, 64:128].any()
    assert (plan >= 0).sum() > 0 and np.abs(got).max() > 0.5


@pytest.mark.parametrize("case", ["tiny", "w_not_4", "empty_row"])
def test_densify_matches_jax_to_dense(case):
    """Plain K5: canvas == JAX densify_bev's [B,H,W,D*C] (d-major channel
    z*C + c) transposed to NCHW, occupancy == to_dense of ones; exact. On
    the tiny config's level 3, a grid whose W is not a multiple of 4 and a
    batch whose sample 1 is all padding."""
    if case == "tiny":
        _, shapes, keys = tiny_rulebook(2)
        k3, shape3 = keys[3], shapes[3]
        feats = np.random.default_rng(3).normal(
            size=tuple(k3.shape) + (8,)).astype(np.float32)
        feats[(k3 == sp.INVALID_KEY).numpy()] = 0.0  # padding rows are zero
    else:
        shape3, k3, feats = k5_edge_case(case, 8)
        k3 = torch.from_numpy(k3)
    canvas, occ = sp.densify_nchw(k3, torch.from_numpy(feats), shape3)
    ref = np.asarray(jbackbone.densify_bev(jnp.asarray(k3.numpy()),
                                           jnp.asarray(feats), shape3))
    np.testing.assert_array_equal(canvas.permute(0, 2, 3, 1).numpy(), ref)
    for b in range(2):
        ones = jsp.to_dense(jnp.asarray(k3[b].numpy()),
                            jnp.ones((k3.shape[1], 1), jnp.float32), shape3)
        np.testing.assert_array_equal(occ[b, :, 0].numpy(),
                                      np.asarray(ones)[..., 0])
    assert occ.sum() == (k3 != sp.INVALID_KEY).sum() > 0
    if case == "empty_row":
        assert not canvas[1].any() and not occ[1].any()
