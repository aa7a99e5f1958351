"""Port parity of the training options beyond the one-cycle AdamW on the
car recipe: the optimizer kinds adam, adam_cosine and sgd (each with and
without the cosine warmup) and weight_decay_mode="all" against optax's
make_optimizer of the JAX package; the PointNet VFE through from_jax on
tiny_config(): forward_test detections against JAX's, forward_train's
losses and every gradient leaf against jax.grad.

Tolerances: optimizer updates 1e-6 (the same float32 update rule, as
tests/test_torch_train.py holds the one-cycle AdamW); detections as sets,
boxes 1e-2 and scores 1e-3; losses 1e-4 relative and gradients 1e-3
relative L2 per leaf (tests/test_torch_train.py's).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.data.synthetic import make_random_batch as jax_random_batch  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.train import optim as joptim  # noqa: E402
from sassd_tpu_torch import config, inference, weights  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models.detector import parse_losses  # noqa: E402
from sassd_tpu_torch.train import optim  # noqa: E402

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
TOTAL = 8


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("kind,warmup,mode", [
    ("adam", 0, "exclude_bn_bias"), ("adam", 3, "exclude_bn_bias"),
    ("adam", 0, "all"),
    ("adam_cosine", 0, "exclude_bn_bias"), ("adam_cosine", 3, "all"),
    ("sgd", 0, "exclude_bn_bias"), ("sgd", 3, "exclude_bn_bias"),
    ("adam_onecycle", 0, "all"),
])
def test_optimizer_kind_matches_optax(kind, warmup, mode):
    """3 updates (the first one clipped) of the port's optimizer against
    optax's chain of the same kind on the same gradients: parameters
    within 1e-6, and the lr and momentum the port's schedules give at
    each count equal to the hyperparameters optax injected."""
    cfg = config.tiny_config()
    tc = dataclasses.replace(cfg.train, lr=0.01, warmup_iters=warmup,
                             weight_decay_mode=mode)
    jtc = dataclasses.replace(jconfig.tiny_config().train, lr=0.01,
                              warmup_iters=warmup, weight_decay_mode=mode)
    model = weights.seeded_detector(cfg, 3, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, weights.to_jax(model)[0])
    tx = joptim.make_optimizer(jtc, TOTAL, kind)
    state = tx.init(jp)
    opt = optim.make_optimizer(model, tc, TOTAL, kind)
    momentum = opt.b1 if kind != "sgd" else (lambda c: opt.momentum)
    rng = np.random.default_rng(0)
    for i in range(3):
        scale = 50.0 if i == 0 else 0.01        # the first step clips
        g = {k: (rng.normal(size=p.shape) * scale).astype(np.float32)
             for k, p in model.named_parameters()}
        upd, state = tx.update(jax.tree_util.tree_map(
            jnp.asarray, weights._unflatten(g)), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        ref = leaves(jp)
        got = leaves(weights.to_jax(model)[0])
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        hp = state[1].hyperparams
        np.testing.assert_allclose(opt.lr(i), float(hp["learning_rate"]),
                                   rtol=1e-6, err_msg="lr")
        mom = hp["momentum"] if kind == "sgd" else hp["b1"]
        np.testing.assert_allclose(momentum(i), float(mom), rtol=1e-6,
                                   err_msg="momentum")
    assert opt.count == 3
    if warmup:           # the warmup rises towards cfg.lr
        assert opt.lr(0) < opt.lr(1) < opt.lr(2) < tc.lr


def test_weight_decay_all_decays_every_parameter():
    cfg = config.tiny_config()
    model = weights.seeded_detector(cfg, 0, "cpu")
    opt = optim.make_optimizer(model, dataclasses.replace(
        cfg.train, weight_decay_mode="all"), 10)
    assert all(opt.decay.values())
    opt = optim.make_optimizer(model, cfg.train, 10)
    assert not all(opt.decay.values()) and any(opt.decay.values())
    with pytest.raises(ValueError):
        optim.make_optimizer(model, dataclasses.replace(
            cfg.train, weight_decay_mode="bn_only"), 10)


def pointnet_configs():
    port, ref = config.tiny_config(), jconfig.tiny_config()
    return (dataclasses.replace(port, model=dataclasses.replace(
                port.model, vfe_type="pointnet")),
            dataclasses.replace(ref, model=dataclasses.replace(
                ref.model, vfe_type="pointnet")))


@pytest.fixture(scope="module")
def pointnet_pair():
    """The PointNet-VFE tiny detector in both packages on the same weights
    and batch: forward_test detections, and forward_train's losses,
    BatchNorm state and gradients (jax.grad of forward_train +
    parse_losses, one jitted call)."""
    cfg, jcfg = pointnet_configs()
    params, state = jdetector.detector_init(jax.random.PRNGKey(7), jcfg)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) * (weights.RELU_GAIN
                                      if p[-1].key == "w" else 1.0), params)
    state = jax.tree_util.tree_map(np.asarray, state)
    assert "vfe" in params and "vfe" in state
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(5),
                                        batch_size=2, n_points=900)
    jbatch = {k: jnp.asarray(v) for k, v in jax_random_batch(
        jcfg, np.random.default_rng(5), batch_size=2, n_points=900).items()}
    anchors = kitti.build_anchors(cfg)[0]
    janchors = jnp.asarray(anchors)

    jdets = {k: np.asarray(v) for k, v in jdetector.forward_test(
        params, state, jbatch, janchors, jcfg).items()}
    model = weights.from_jax(cfg, params, state, "cpu")
    dets = {k: v.numpy() for k, v in inference.make_test_step(
        cfg, anchors, "cpu")(model, batch).items()}

    def loss_fn(p):
        losses, new_state = jdetector.forward_train(p, state, jbatch,
                                                    janchors, jcfg)
        return jdetector.parse_losses(losses)[0], (losses, new_state)

    grads, (jlosses, jstate) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params)
    model = weights.from_jax(cfg, params, state, "cpu")
    model.train()
    losses = model.forward_train(inference.to_device(batch, "cpu"),
                                 torch.from_numpy(anchors))
    parse_losses(losses).backward()
    return dict(dets=dets, jdets=jdets,
                jlosses={k: float(v) for k, v in jlosses.items()},
                losses={k: float(v.detach()) for k, v in losses.items()},
                jgrads=leaves(grads),
                grads=leaves(weights.grads_to_jax(model)), jstate=leaves(jstate), state=leaves(weights.to_jax(model)[1]))


def test_pointnet_forward_test_matches_jax(pointnet_pair):
    got, ref = pointnet_pair["dets"], pointnet_pair["jdets"]
    for i in range(2):
        gv, rv = got["valid"][i], ref["valid"][i]
        assert gv.sum() == rv.sum() > 0
        rb, rs = ref["boxes"][i][rv], ref["scores"][i][rv]
        used = np.zeros(len(rb), bool)
        for b, s in zip(got["boxes"][i][gv], got["scores"][i][gv]):
            ok = ((np.abs(rb - b).max(1) <= 1e-2)
                  & (np.abs(rs - s) <= 1e-3) & ~used)
            assert ok.any(), (i, b, s)
            used[np.argmax(ok)] = True


def test_pointnet_forward_train_losses_match_jax(pointnet_pair):
    ref, got = pointnet_pair["jlosses"], pointnet_pair["losses"]
    assert set(ref) <= set(got)
    for k, v in ref.items():
        assert np.isfinite(v) and v != 0.0, k
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    ref, got = pointnet_pair["jstate"], pointnet_pair["state"]
    assert ref.keys() == got.keys() and any("vfe" in k for k in ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# a linear's bias right before a train-mode BatchNorm is cancelled by the
# batch mean: its true gradient is 0 and both packages give float32 noise
# (~1e-5 against ~1e2 for the module's other leaves)
ZERO_GRAD = ("['vfe']['fc0']['b']", "['vfe']['fc1']['b']")


@pytest.mark.parametrize("module", ["vfe", "vxnet", "bevnet", "head",
                                    "pswarp", "aux"])
def test_pointnet_grads_match_jax(pointnet_pair, module):
    """Every gradient leaf of the module within 1e-3 relative L2; the two
    analytically zero ones under 1e-6 of the module's largest leaf norm
    in both packages."""
    ref = {k: v for k, v in pointnet_pair["jgrads"].items()
           if k.startswith(f"['{module}']")}
    got = pointnet_pair["grads"]
    assert ref and set(ref) <= set(got)
    scale = max(np.linalg.norm(r) for r in ref.values())
    for k, r in ref.items():
        if k in ZERO_GRAD:
            assert max(np.linalg.norm(r),
                       np.linalg.norm(got[k])) <= 1e-6 * scale, k
            continue
        norm = np.linalg.norm(r)
        assert norm > 0, k
        err = np.linalg.norm(got[k] - r) / norm
        assert err <= GRAD_RTOL, (k, err)


def test_pointnet_empty_voxel_and_banded_refusal():
    """A voxel with no points encodes to the final linear's bias (its
    masked max is 0, not -inf), in train and eval mode; the banded
    sparse stage refuses the PointNet VFE."""
    cfg, _ = pointnet_configs()
    model = weights.seeded_detector(cfg, 0, "cpu")
    vox = torch.zeros(1, 2, 5, 4)
    vox[0, 0, :2] = torch.tensor([[1.0, 0.5, 0.2, 0.3], [1.2, 0.4, 0.1, 0.5]])
    npts = torch.tensor([[2, 0]])
    for train in (False, True):
        model.vfe.train(train)
        out = model.vfe(vox, npts).detach()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out[0, 1], model.vfe.out.b.detach())
    bad = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, strategy="banded", spatial=2))
    with pytest.raises(NotImplementedError):
        config.check_supported(bad)
