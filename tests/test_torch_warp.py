"""Port parity: K3 (PSWarp score) plain version and the PSWarp head against
the JAX package's warp primitives and ``pswarp_apply``, atol 1e-5 (float32
sums of 28 samples taken in another order)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from sassd_tpu.models import pswarp as jpswarp  # noqa: E402
from sassd_tpu.ops import warp as jwarp  # noqa: E402
from sassd_tpu_torch.models.pswarp import PSWarpHead  # noqa: E402
from sassd_tpu_torch.ops import warp  # noqa: E402

ATOL = 1e-5


def random_boxes(rng, b, n, extent):
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0] = rng.uniform(-0.5, extent[0] + 0.5, (b, n))   # some off-map
    bx[..., 1] = rng.uniform(-extent[1] - 0.5, extent[1] + 0.5, (b, n))
    bx[..., 2] = -1.0
    bx[..., 3] = rng.uniform(1.4, 1.9, (b, n))
    bx[..., 4] = rng.uniform(3.2, 4.6, (b, n))
    bx[..., 5] = 1.5
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    return bx


def test_gen_sample_grid_matches_jax():
    rng = np.random.default_rng(0)
    boxes = random_boxes(rng, 1, 50, (70.0, 40.0))[0][:, [0, 1, 3, 4, 6]]
    got = warp.gen_sample_grid(torch.from_numpy(boxes), (4, 7), (0.0, 40.0),
                               2.5)
    ref = jwarp.gen_sample_grid(jnp.asarray(boxes), (4, 7), (0.0, 40.0), 2.5)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_bilinear_matches_jax_packed():
    rng = np.random.default_rng(1)
    h, w, k, n = 17, 23, 28, 300
    img = rng.normal(size=(h, w, k)).astype(np.float32)
    xs = rng.uniform(-4, w + 4, (k, n)).astype(np.float32)
    ys = rng.uniform(-4, h + 4, (k, n)).astype(np.float32)
    xs[:, :40] = np.round(xs[:, :40])                 # integer-exact taps
    got = warp.bilinear_sample_per_part(torch.from_numpy(img),
                                        torch.from_numpy(xs),
                                        torch.from_numpy(ys))
    ref = jwarp.bilinear_sample_per_part_packed(
        jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_pswarp_score_plain_matches_jax():
    """K3's contract: lattice + per-part sampling + mean + valid mask, on an
    NCHW map read through a strided view."""
    rng = np.random.default_rng(2)
    b, h, w, k, n = 2, 20, 18, 28, 64
    img = rng.normal(size=(b, h, w, k)).astype(np.float32)
    boxes = random_boxes(rng, b, n, (7.2, 4.0))
    valid = rng.uniform(size=(b, n)) < 0.8
    args = ((4, 7), (0.0, 4.0), 2.5)
    part_map = torch.from_numpy(img).permute(0, 3, 1, 2)     # strided NCHW
    got = warp.pswarp_score(part_map, torch.from_numpy(boxes),
                            torch.from_numpy(valid), *args)

    def score_one(im, bx):
        xs, ys = jwarp.gen_sample_grid(bx[:, [0, 1, 3, 4, 6]], *args)
        return jnp.mean(jwarp.bilinear_sample_per_part_packed(im, xs, ys), 0)
    ref = jnp.where(valid, jax.vmap(score_one)(jnp.asarray(img),
                                               jnp.asarray(boxes)), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert np.all(got.numpy()[~valid] == 0.0)
    assert np.abs(got.numpy()[valid]).max() > 1e-2         # non-trivial


def test_pswarp_head_matches_pswarp_apply():
    rng = np.random.default_rng(3)
    b, h, w, c, n = 2, 10, 9, 16, 48
    params, state = jpswarp.pswarp_init(jax.random.PRNGKey(3), c, 1, 28)
    state = {"bn0": {"mean": rng.normal(0, 0.1, 28).astype(np.float32),
                     "var": rng.uniform(0.5, 1.5, 28).astype(np.float32)}}
    conv6 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    boxes = random_boxes(rng, b, n, (7.2, 4.0))
    valid = rng.uniform(size=(b, n)) < 0.85
    kw = dict(window_size=(4, 7), grid_offsets=(0.0, 4.0),
              featmap_stride=0.8)
    ref, _ = jpswarp.pswarp_apply(params, state, jnp.asarray(conv6),
                                  jnp.asarray(boxes), jnp.asarray(valid),
                                  train=False, **kw)
    head = PSWarpHead(torch.Generator(), c, 1, 28)
    sd = {"conv0.w": params["conv0"]["w"], "conv1.w": params["conv1"]["w"],
          "bn0.scale": params["bn0"]["scale"],
          "bn0.bias": params["bn0"]["bias"],
          "bn0.mean": state["bn0"]["mean"], "bn0.var": state["bn0"]["var"]}
    head.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    with torch.no_grad():
        got = head(torch.from_numpy(conv6), torch.from_numpy(boxes),
                   torch.from_numpy(valid), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
