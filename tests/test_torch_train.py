"""Port parity of single-device training on tiny_config(): forward_train's
losses, BatchNorm state and every gradient leaf against jax.grad of the
JAX package's forward_train + parse_losses; the one-cycle AdamW against
optax; the non-finite guard; checkpoints; the train loop.

Weights: the JAX initialisation with every conv weight scaled by sqrt(6)
(weights.RELU_GAIN), so the activations do not collapse. Tolerances:
losses 1e-4 relative (float32 sums in another order), gradients 1e-3
relative L2 per leaf (the same through a deep backward), optimizer updates
1e-6 (the same float32 update rule).
"""
import dataclasses
import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.data.synthetic import make_random_batch as jax_random_batch  # noqa: E402
from sassd_tpu.core import targets as jtargets  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.models import ssd_head as jhead  # noqa: E402
from sassd_tpu.train import optim as joptim  # noqa: E402
from sassd_tpu_torch import config, inference, weights  # noqa: E402
from sassd_tpu_torch.core import targets  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models import pswarp, ssd_head  # noqa: E402
from sassd_tpu_torch.models.detector import parse_losses  # noqa: E402
from sassd_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from sassd_tpu_torch.train import loop, optim  # noqa: E402

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
MODULES = ("vxnet", "bevnet", "head", "pswarp", "aux")


def jax_weights(seed=7, gain=weights.RELU_GAIN):
    params, state = jdetector.detector_init(jax.random.PRNGKey(seed),
                                            jconfig.tiny_config())
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(v) * (gain if p[-1].key == "w" else 1.0),
        params)
    return params, jax.tree_util.tree_map(np.asarray, state)


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def step_pair():
    """One forward_train + backward in both packages on the same batch and
    weights, plus both packages' assignments."""
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    params, state = jax_weights()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(5),
                                        batch_size=2, n_points=900)
    jbatch = {k: jnp.asarray(v) for k, v in jax_random_batch(
        jcfg, np.random.default_rng(5), batch_size=2, n_points=900).items()}
    anchors = kitti.build_anchors(cfg)[0]
    janchors = jnp.asarray(anchors)

    def loss_fn(p):
        losses, new_state = jdetector.forward_train(p, state, jbatch,
                                                    janchors, jcfg)
        return jdetector.parse_losses(losses)[0], (losses, new_state)

    grads, (jlosses, jstate) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params)

    @jax.jit
    def assign(p):
        spine = jdetector.forward_spine(p, state, jbatch, jcfg, train=True)
        outs = jhead.head_apply(p["head"], spine.bev_map, 1, 7, 2)
        rpn = jax.vmap(lambda m, g, v, c: jtargets.create_targets(
            janchors, g, v, jtargets.nearest_iou_similarity, 0.6, 0.45,
            anchors_mask=m, gt_classes=c).labels)(
            jbatch["anchors_mask"], jbatch["gt_boxes"], jbatch["gt_valid"],
            jbatch["gt_classes"])
        ga = jhead.get_guided_anchors(
            outs, janchors, jbatch["anchors_mask"], num_class=1, thr=0.1,
            cap=jcfg.caps.guided_train, gt_boxes=jbatch["gt_boxes"],
            gt_labels=jbatch["gt_classes"], gt_valid=jbatch["gt_valid"])
        warp = jax.vmap(lambda bx, v, g, gv: jtargets.create_targets(
            bx, g, gv, jtargets.rotate_iou3d_similarity, 0.7, 0.7,
            anchors_mask=v).labels)(ga.boxes, ga.valid, jbatch["gt_boxes"],
                                    jbatch["gt_valid"])
        return rpn, ga.valid, warp

    jassign = [np.asarray(x) for x in assign(params)]

    model = weights.from_jax(cfg, params, state, "cpu")
    model.train()
    tb = inference.to_device(batch, "cpu")
    at = torch.from_numpy(anchors)
    with torch.no_grad():
        spine = model.forward_spine(tb)
        outs = model.head(spine.bev_map)
        rpn = torch.stack([targets.create_targets(
            at, tb["gt_boxes"][i], tb["gt_valid"][i],
            targets.nearest_iou_similarity, 0.6, 0.45,
            anchors_mask=tb["anchors_mask"][i],
            gt_classes=tb["gt_classes"][i]).labels for i in range(2)])
        ga = ssd_head.get_guided_anchors(
            outs, at, tb["anchors_mask"], num_class=1, thr=0.1,
            cap=cfg.caps.guided_train, gt_boxes=tb["gt_boxes"],
            gt_labels=tb["gt_classes"], gt_valid=tb["gt_valid"])
        warp = pswarp.pswarp_labels(ga.boxes, ga.valid, tb["gt_boxes"],
                                    tb["gt_valid"])
    model = weights.from_jax(cfg, params, state, "cpu")   # fresh BN state
    model.train()
    losses = model.forward_train(tb, at)
    parse_losses(losses).backward()
    return dict(jlosses={k: float(v) for k, v in jlosses.items()},
                jgrads=leaves(grads), jstate=leaves(jstate),
                jassign=jassign,
                assign=[rpn.numpy(), ga.valid.numpy(), warp.numpy()],
                losses={k: float(v) for k, v in losses.items()},
                grads=leaves(weights.grads_to_jax(model)),
                state=leaves(weights.to_jax(model)[1]))


def test_forward_train_assignments_match_jax(step_pair):
    """Anchor labels, guided-candidate validity and the PSWarp 3D-IoU
    labels are equal: the losses below compare like with like."""
    for name, got, ref in zip(("rpn", "guided valid", "pswarp"),
                              step_pair["assign"], step_pair["jassign"]):
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert (step_pair["jassign"][0] > 0).sum() > 0
    assert (step_pair["jassign"][2] > 0).sum() > 0


def test_forward_train_losses_match_jax(step_pair):
    ref, got = step_pair["jlosses"], step_pair["losses"]
    assert set(ref) <= set(got)
    for k, v in ref.items():
        assert np.isfinite(v) and v != 0.0, k
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("module", MODULES)
def test_forward_train_grads_match_jax(step_pair, module):
    """Every gradient leaf of the module within 1e-3 relative L2."""
    ref = {k: v for k, v in step_pair["jgrads"].items()
           if k.startswith(f"['{module}']")}
    got = step_pair["grads"]
    assert ref and set(ref) <= set(got)
    for k, r in ref.items():
        norm = np.linalg.norm(r)
        assert norm > 0, k
        err = np.linalg.norm(got[k] - r) / norm
        assert err <= GRAD_RTOL, (k, err)


def test_forward_train_bn_state_matches_jax(step_pair):
    ref, got = step_pair["jstate"], step_pair["state"]
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("total,at", [(1000, [0, 1, 200, 399, 400, 401,
                                              999, 1000, 1200]),
                                      (6, [0, 1, 2, 3, 5, 6])])
def test_one_cycle_schedules_match_jax(total, at):
    lr = optim.one_cycle_lr(0.003, 10.0, 0.4, total)
    mom = optim.one_cycle_momentum((0.95, 0.85), 0.4, total)
    jlr = joptim.one_cycle_lr(0.003, 10.0, 0.4, total)
    jmom = joptim.one_cycle_momentum((0.95, 0.85), 0.4, total)
    for c in at:
        np.testing.assert_allclose(lr(c), float(jlr(c)), rtol=1e-6)
        np.testing.assert_allclose(mom(c), float(jmom(c)), rtol=1e-6)


def test_optimizer_matches_optax():
    """3 updates of the port's AdamW against optax's chain on the same
    gradients: the decoupled decay on "w" leaves only, the bias correction
    under the changing b1, and a clipped first step."""
    cfg = config.tiny_config()
    tc = dataclasses.replace(cfg.train, lr=0.01)
    total = 5
    model = weights.seeded_detector(cfg, 3, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, weights.to_jax(model)[0])
    assert {k: bool(v) for k, v in leaves(joptim.weight_decay_mask(
        jp)).items()} == {jax.tree_util.keystr(tuple(
            jax.tree_util.DictKey(p) for p in k.split("."))): v
            for k, v in optim.weight_decay_mask(model).items()}
    tx = joptim.make_optimizer(tc, total)
    state = tx.init(jp)
    opt = optim.make_optimizer(model, tc, total)
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
    lr, b1 = joptim.current_hyperparams(state)
    assert opt.count == 3
    np.testing.assert_allclose(optim.one_cycle_lr(0.01, 10.0, 0.4, 5)(2),
                               lr, rtol=1e-6)
    np.testing.assert_allclose(optim.one_cycle_momentum(
        (0.95, 0.85), 0.4, 5)(2), b1, rtol=1e-6)
    with pytest.raises(ValueError):
        optim.make_optimizer(model, tc, total, kind="adam_onecycle_typo")


@pytest.fixture(scope="module")
def tiny_train():
    cfg = config.tiny_config()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(1),
                                        batch_size=2, n_points=900)
    return cfg, batch, kitti.build_anchors(cfg)[0]


def test_train_step_reduces_loss(tiny_train):
    cfg, batch, anchors = tiny_train
    model = weights.seeded_detector(cfg, 0, "cpu")
    opt = optim.make_optimizer(model, cfg.train, 100)
    step = loop.make_train_step(cfg, anchors, opt, "cpu")
    losses = []
    for _ in range(12):
        m = step(model, batch)
        losses.append(float(m["loss"]))
        assert float(m["nonfinite_skips"]) == 0.0
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert float(m["grad_norm"]) > 0


def test_nonfinite_guard_skips_the_whole_update(tiny_train):
    cfg, batch, anchors = tiny_train
    model = weights.seeded_detector(cfg, 0, "cpu")
    opt = optim.make_optimizer(model, cfg.train, 100)
    step = loop.make_train_step(cfg, anchors, opt, "cpu")
    step(model, batch)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {k: v.clone() for k, v in opt.mu.items()}
    bad = dict(batch)
    bad["voxels"] = batch["voxels"].copy()
    bad["voxels"][:, 0, 0, 0] = np.inf
    m = step(model, bad)
    assert float(m["nonfinite_skips"]) == 1.0
    assert opt.count == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in opt.mu.items():
        assert torch.equal(v, moments[k]), k
    m = step(model, batch)
    assert float(m["nonfinite_skips"]) == 0.0 and opt.count == 2


def test_checkpoint_round_trip(tmp_path, tiny_train):
    """Restored parameters, buffers and moments are equal, and the next
    step from the restored state matches the next step of the original."""
    cfg, batch, anchors = tiny_train
    model = weights.seeded_detector(cfg, 0, "cpu")
    opt = optim.make_optimizer(model, cfg.train, 100)
    step = loop.make_train_step(cfg, anchors, opt, "cpu")
    for _ in range(2):
        step(model, batch)
    path = ckpt.save(str(tmp_path), 1, 2, model, opt)
    model2 = weights.seeded_detector(cfg, 9, "cpu")
    opt2 = optim.make_optimizer(model2, cfg.train, 100)
    assert ckpt.restore(path, model2, opt2) == (1, 2, -1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), k
    assert opt2.count == 2
    a = step(model, batch)
    b = loop.make_train_step(cfg, anchors, opt2, "cpu")(model2, batch)
    assert float(a["loss"]) == float(b["loss"])
    # the CPU backward's scatter-adds are not bitwise repeatable
    for (k, v), v2 in zip(model.named_parameters(), model2.parameters()):
        torch.testing.assert_close(v, v2, rtol=1e-4, atol=1e-5, msg=k)


def test_checkpoint_rolling_window(tmp_path, tiny_train):
    cfg = tiny_train[0]
    model = weights.seeded_detector(cfg, 0, "cpu")
    opt = optim.make_optimizer(model, cfg.train, 100)
    for e in range(6):
        ckpt.save(str(tmp_path), e, e * 10, model, opt, max_keep=3)
    assert [p.rsplit("/", 1)[-1] for p in ckpt.list_checkpoints(
        str(tmp_path))] == [f"checkpoint_epoch_{e}.pt" for e in (3, 4, 5)]
    # a mid-epoch save is kept until a later checkpoint supersedes it
    ckpt.save(str(tmp_path), 6, 61, model, opt, max_keep=3, batch_idx=1)
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith(
        "checkpoint_epoch_6_step_1.pt")
    ckpt.save(str(tmp_path), 6, 62, model, opt, max_keep=3)
    names = [p.rsplit("/", 1)[-1] for p in ckpt.list_checkpoints(
        str(tmp_path))]
    assert names == [f"checkpoint_epoch_{e}.pt" for e in (4, 5, 6)]


def test_train_model_on_a_synthetic_split(tmp_path, caplog):
    """Two epochs over a 2-scan split at batch 2 write the checkpoints;
    a second call resumes after them and trains nothing more."""
    cfg = config.tiny_config()
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, log_interval=1,
                                       checkpoint_interval=1),
        data=dataclasses.replace(cfg.data, num_workers=0))
    root = tmp_path / "kitti"
    synthetic.write_synthetic_kitti(
        str(root), n_train=2, n_val=0, seed=0,
        point_cloud_range=cfg.voxel.point_cloud_range, n_cars=(1, 3),
        n_ground=1200)
    ds = kitti.KittiDataset(cfg, str(root / "training"),
                            str(root / "ImageSets" / "train.txt"),
                            train=True)
    sample = ds[0]
    assert sample["gt_valid"].any()
    assert {"plan_strideT1", "plan_aux3"} <= set(sample)
    seen = []
    with caplog.at_level(logging.INFO, logger="sassd"):
        model, opt, step = loop.train_model(
            cfg, ds, str(tmp_path / "work"), total_epochs=2, device="cpu",
            epoch_callback=lambda e, m: seen.append(e))
    assert step == 2 and opt.count == 2 and seen == [0, 1]
    assert [p.rsplit("/", 1)[-1] for p in ckpt.list_checkpoints(
        str(tmp_path / "work"))] == ["checkpoint_epoch_0.pt",
                                     "checkpoint_epoch_1.pt"]
    assert "epoch 1 step 2" in caplog.text
    _, opt2, step2 = loop.train_model(cfg, ds, str(tmp_path / "work"),
                                      total_epochs=2, device="cpu")
    assert step2 == 2 and opt2.count == 2


def test_train_checks_the_config():
    """Options training does not run raise; device plans, the exact aux
    3-NN, the GT database, the PointNet VFE, weight decay on every
    parameter and compute_dtype="bfloat16" pass, alone and together, and
    so does the three-class config."""
    cfg = config.tiny_config()

    def with_(section, **override):
        return dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **override)})
    for bad in (with_("model", compute_dtype="float16"),
                with_("model", aux_interp="nearest")):
        with pytest.raises(NotImplementedError):
            config.check_supported(bad, train=True)
    for good in (cfg, with_("model", aux_interp="exact"),
                 with_("model", host_plans=False),
                 with_("data", db_info_path="db.pkl"),
                 with_("model", host_plans=False, aux_interp="exact"),
                 with_("model", vfe_type="pointnet"),
                 with_("train", weight_decay_mode="all"),
                 with_("model", compute_dtype="bfloat16"),
                 with_("model", compute_dtype="bfloat16", host_plans=False,
                       aux_interp="exact")):
        config.check_supported(good, train=True)
    multi = config.multi_config()
    for aux in ("ring", "exact"):
        config.check_supported(dataclasses.replace(
            multi, model=dataclasses.replace(multi.model, host_plans=False,
                                             aux_interp=aux)), train=True)


def test_entry_points_default_to_the_card():
    """run_inference, evaluate, from_jax and seeded_detector put the model
    on the card unless the caller asks for the CPU."""
    import inspect
    for fn in (inference.run_inference, inference.evaluate,
               weights.from_jax, weights.seeded_detector,
               loop.train_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
