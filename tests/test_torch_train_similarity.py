"""Port parity of a tiny_config() train step with
``train.rpn_similarity="RotateIou2dSimilarity"``: the RPN targets by
rotated BEV IoU (K1's plain version at criterion -1), forward_train's
losses, every gradient leaf and the BatchNorm state against jax.grad of
the JAX package's forward_train + parse_losses on the same batch and
weights, at the train-step gates of tests/test_torch_train.py (losses
1e-4 relative, gradients 1e-3 relative L2 a leaf). The JAX package's CPU
overlap is its polygon-clip oracle; both packages run Green's-theorem
overlap here, as tests/test_torch_losses.py's green_overlap fixture sets
it, so the anchors' assignments compare like with like.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.core import riou as jriou  # noqa: E402
from sassd_tpu.data.synthetic import make_random_batch as jax_random_batch  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.ops.pallas.riou_kernel import rotate_overlap_green  # noqa: E402
from sassd_tpu_torch import config, inference, weights  # noqa: E402
from sassd_tpu_torch.core import targets  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models.detector import parse_losses  # noqa: E402
from test_torch_train import (GRAD_RTOL, LOSS_RTOL, jax_weights,  # noqa: E402
                              leaves)

SIMILARITY = "RotateIou2dSimilarity"


def with_similarity(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, rpn_similarity=SIMILARITY))


@pytest.fixture(scope="module")
def riou2d_step():
    """One forward_train + backward in both packages with the rotated BEV
    IoU similarity; the port's RPN similarity calls counted."""
    cfg = with_similarity(config.tiny_config())
    jcfg = with_similarity(jconfig.tiny_config())
    params, state = jax_weights()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(5),
                                        batch_size=2, n_points=900)
    jbatch = {k: jnp.asarray(v) for k, v in jax_random_batch(
        jcfg, np.random.default_rng(5), batch_size=2, n_points=900).items()}
    anchors = kitti.build_anchors(cfg)[0]

    def loss_fn(p):
        losses, new_state = jdetector.forward_train(p, state, jbatch,
                                                    jnp.asarray(anchors),
                                                    jcfg)
        return jdetector.parse_losses(losses)[0], (losses, new_state)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jriou, "rotate_overlap_bev",
                   lambda a, b: rotate_overlap_green(a, b, criterion=2))
        grads, (jlosses, jstate) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            params)
        jlosses = {k: float(v) for k, v in jlosses.items()}

    calls = []
    sim = targets.SIMILARITY_FNS[SIMILARITY]
    model = weights.from_jax(cfg, params, state, "cpu")
    model.train()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(targets.SIMILARITY_FNS, SIMILARITY,
                   lambda a, g: calls.append(len(g)) or sim(a, g))
        losses = model.forward_train(inference.to_device(batch, "cpu"),
                                     torch.from_numpy(anchors))
    parse_losses(losses).backward()
    return dict(jlosses=jlosses, jgrads=leaves(grads), jstate=leaves(jstate),
                losses={k: float(v) for k, v in losses.items()},
                grads=leaves(weights.grads_to_jax(model)),
                state=leaves(weights.to_jax(model)[1]), calls=calls)


def test_rotate_iou2d_train_step_matches_jax(riou2d_step):
    """Losses within 1e-4, every gradient leaf within 1e-3 relative L2,
    BatchNorm state within 1e-4; the similarity ran once a sample."""
    s = riou2d_step
    assert s["calls"] == [config.tiny_config().caps.max_gt] * 2
    assert set(s["jlosses"]) <= set(s["losses"])
    for k, v in s["jlosses"].items():
        assert np.isfinite(v) and v != 0.0, k
        np.testing.assert_allclose(s["losses"][k], v, rtol=LOSS_RTOL,
                                   err_msg=k)
    assert s["jgrads"] and set(s["jgrads"]) <= set(s["grads"])
    for k, r in s["jgrads"].items():
        norm = np.linalg.norm(r)
        assert norm > 0, k
        err = np.linalg.norm(s["grads"][k] - r) / norm
        assert err <= GRAD_RTOL, (k, err)
    assert s["jstate"].keys() == s["state"].keys()
    for k, v in s["jstate"].items():
        np.testing.assert_allclose(s["state"][k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
