"""Port parity of the banded sparse stage (parallel.strategy="banded"):
the band partition (K16 plain), the y-limited downsample (K7 plain with a
limit), the ring 3-NN with per-row grid origins (K11 plain), the band
specs and the long-range config against the JAX package, and the banded
forward_train / forward_test against JAX's forward_train_banded /
forward_test_banded and against the port's own replicated run.

The plain versions run here (CPU tensors), on the tall tiny config of
tests/test_spatial.py (H = 256, S = 2 bands of 128 rows, halo 64), whose
caps keep both runs untruncated. Tolerances: partitions, levels and band
specs are integers and equal; the interpolated aux features 1e-6 (the
same float32 operations; the band origins rounded as JAX rounds them);
against JAX, losses 1e-4 relative, BN state rtol 2e-3 / atol 1e-5,
detections 2e-3 and gradients 1e-3 relative L2 per leaf (as
tests/test_torch_train.py) but 2e-2 for the vxnet and bevnet leaves: on
this config JAX's own float32 gradients of those modules lie up to 1.3e-2
(per leaf) from a float64 step's, where the port's lie within 1e-4, so the
port's float32 gradients are also held to its float64 step at 1e-3;
banded against replicated, tests/test_spatial.py's tolerances (losses
2e-4 relative, BN state 2e-3 / 1e-5, boxes 2e-3) and gradients 1e-3.
"""
import dataclasses
import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.data.synthetic import make_random_batch as jax_random_batch  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.ops import sparse as jsp  # noqa: E402
from sassd_tpu.parallel import sparse_spatial as jss  # noqa: E402
from sassd_tpu_torch import config, inference, weights  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models import backbone  # noqa: E402
from sassd_tpu_torch.models.backbone import Middle  # noqa: E402
from sassd_tpu_torch.models.detector import SpineOut, parse_losses  # noqa: E402
from sassd_tpu_torch.ops import interpolate as itp  # noqa: E402
from sassd_tpu_torch.ops import sparse as sp  # noqa: E402
from sassd_tpu_torch.parallel import sparse_spatial as ss  # noqa: E402
from sassd_tpu_torch.train import loop  # noqa: E402
from test_spatial import _tall_config  # noqa: E402
from test_torch_train_device_plans import jax_weights, leaves  # noqa: E402
from test_torch_cases import PARTITION_CASES, partition_case  # noqa: E402

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
# JAX's float32 rounding on the tall config (see the module docstring)
JAX_F32_GRAD_RTOL = {"vxnet": 2e-2, "bevnet": 2e-2}
AUX_TOL = 1e-6
MODULES = ("vxnet", "bevnet", "head", "pswarp", "aux")
S = 2


def tall(banded=True, **model):
    """The port's twin of test_spatial._tall_config(), banded over S = 2."""
    cfg = config.tiny_config()
    cfg = dataclasses.replace(
        cfg,
        voxel=config.VoxelConfig(voxel_size=(0.1, 0.1, 0.5),
                                 point_cloud_range=(0.0, -12.8, -2.5, 6.4,
                                                    12.8, 1.5),
                                 max_num_points=5, max_voxels=1024),
        caps=dataclasses.replace(cfg.caps,
                                 level_caps=(1024, 4096, 4096, 4096)),
        model=dataclasses.replace(cfg.model, **model))
    if banded:
        cfg = dataclasses.replace(cfg, parallel=config.ParallelConfig(
            strategy="banded", spatial=S))
    return cfg


def tall_batch(seed, make=synthetic.make_random_batch, cfg=None):
    return make(cfg or tall(), np.random.default_rng(seed), batch_size=2,
                n_points=900)


def band_rows(seed=3):
    """The partitioned band rows of a tall batch: (cfg, spec, band-local
    coords [S, B, cap0, 3], VFE rows [S, B, cap0, 4], overflow, batch)."""
    cfg = tall()
    spec = ss.config_band_spec(cfg)
    batch = tall_batch(seed)
    vfe = backbone.vfe_mean(torch.from_numpy(batch["voxels"]),
                            torch.from_numpy(batch["num_points"]))
    return (cfg, spec, *ss.partition(torch.from_numpy(batch["coords"]), vfe,
                                     spec), batch)


@pytest.mark.parametrize("cap0", [None, 150])
def test_partition_plain_matches_jax(cap0):
    """K16's plain version == JAX partition, bitwise; cap0 150 truncates
    (the overflow counts the dropped members)."""
    cfg = tall()
    spec = ss.config_band_spec(cfg)
    if cap0 is not None:
        spec = spec._replace(caps=(cap0,) + spec.caps[1:])
    batch = tall_batch(3)
    vfe = backbone.vfe_mean(torch.from_numpy(batch["voxels"]),
                            torch.from_numpy(batch["num_points"]))
    bc, br, over = ss.partition(torch.from_numpy(batch["coords"]), vfe, spec)
    jspec = jss.BandSpec(*spec)
    jc, (jr,), jover = jss.partition(jnp.asarray(batch["coords"]),
                                     [jnp.asarray(vfe.numpy())], jspec)
    np.testing.assert_array_equal(bc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(br.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jover))
    assert bc.shape == (S, 2, spec.caps[0], 3) and over.dtype == torch.int32
    n_valid = (batch["coords"][..., 0] >= 0).sum(1)
    members = (bc[..., 0] >= 0).sum(-1) + over
    assert (members.sum(0) > torch.from_numpy(n_valid)).all()  # the halos
    assert (over > 0).any() == (cap0 is not None)



@pytest.mark.parametrize("case", PARTITION_CASES)
def test_partition_plain_matches_jax_edges(case):
    """K16's plain version == JAX partition, bitwise, on the card tests'
    edge cases: rows on every band's lo - 1, lo, hi - 1 and hi with padding
    between them, samples of different counts and an empty one, M one past
    the kernel's tile, a cap that drops members."""
    coords, rows, spec = partition_case(case)
    bc, br, over = ss.partition(torch.from_numpy(coords),
                                torch.from_numpy(rows), spec)
    jc, (jr,), jover = jss.partition(jnp.asarray(coords),
                                     [jnp.asarray(rows)], jss.BandSpec(*spec))
    np.testing.assert_array_equal(bc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(br.numpy().view(np.int32),
                                  np.asarray(jr).view(np.int32))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jover))
    valid = coords[..., 0] >= 0
    members = (bc[..., 0] >= 0).sum(-1) + over                    # [S, B]
    assert (over > 0).any() == (case == "cap_cut")
    assert (members.sum(0) >= torch.from_numpy(valid.sum(1))).all()
    if case == "uneven_samples":
        assert (members[:, 2] == 0).all() and (bc[:, 2] == -1).all()
    if case == "band_edges":
        for s in range(spec.s):
            lo = s * spec.band_h - spec.halo
            hi = lo + spec.band_h + 2 * spec.halo
            y = coords[..., 1][valid]
            kept = bc[s, ..., 1][bc[s, ..., 0] >= 0] + lo
            assert (kept >= lo).all() and (kept < hi).all()
            assert int(((y >= lo) & (y < hi)).sum()) == int(
                (bc[s, ..., 0] >= 0).sum())
            assert {lo, hi - 1} & set(range(256)) <= set(kept.tolist())

@pytest.mark.parametrize("level", [1, 2, 3])
def test_downsample_with_y_limit_matches_jax(level):
    """The plain downsample of the band rows with each row's limit
    y_top >> level == JAX downsample_keys(y_limit_out=), bitwise, and the
    limit clips the top band."""
    cfg, spec, bc, _, _, _ = band_rows()
    shapes = backbone.level_shapes(ss.band_shape(cfg, spec))
    y_top = ss.y_top_rows(cfg, spec, 2, "cpu")
    keys = sp.coords_to_keys(bc.reshape(S * 2, -1, 3), shapes[0])
    for lvl in range(1, level):
        keys = sp.downsample_keys(keys, shapes[lvl - 1], spec.caps[lvl],
                                  y_top >> lvl)
    cap = spec.caps[level]
    got = sp.downsample_keys(keys, shapes[level - 1], cap, y_top >> level)
    free = sp.downsample_keys(keys, shapes[level - 1], cap)
    for r in range(S * 2):
        ref = jsp.downsample_keys(jnp.asarray(keys[r].numpy()),
                                  shapes[level - 1], cap,
                                  y_limit_out=int(y_top[r]) >> level)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(ref))
    assert (got[:2] == free[:2]).all()                # band 0: no clipping
    assert (got[2:] != free[2:]).any()                # top band clipped
    np.testing.assert_array_equal(
        y_top.numpy(), np.asarray(jss._y_top_rows(
            _tall_config(), jss.BandSpec(*spec), 2)))


def band_middles(seed=4):
    """Band rows, their device train rulebook and random level features:
    the aux branch's inputs at band shape."""
    cfg, spec, bc, br, _, _ = band_rows(seed)
    shapes = backbone.level_shapes(ss.band_shape(cfg, spec))
    cell0 = bc.reshape(S * 2, -1, 3)
    keys0 = sp.coords_to_keys(cell0, shapes[0])
    plans = sp.device_rulebook(keys0, shapes, spec.caps[1:], train=True,
                               y_top=ss.y_top_rows(cfg, spec, 2, "cpu"))
    rng = np.random.default_rng(seed)
    middles = []
    for lvl, c in ((1, 32), (2, 64), (3, 64)):
        keys = sp.coords_to_keys(plans[f"coords{lvl}"], shapes[lvl])
        f = rng.normal(size=tuple(keys.shape) + (c,)).astype(np.float32)
        middles.append(Middle(keys, torch.from_numpy(
            f * (keys != sp.INVALID_KEY).numpy()[..., None])))
    return cfg, spec, shapes, cell0, br.reshape(S * 2, -1, 4), plans, middles


def test_banded_aux_matches_jax(monkeypatch):
    """The ring 3-NN with each band row's grid origin: the interpolated
    features == JAX _banded_aux's within 1e-6, and the aux heads' outputs
    agree; the origins differ by band."""
    cfg, spec, shapes, cell0, feats0, plans, middles = band_middles()
    origins = ss.band_origins(cfg, spec, 2, "cpu")
    assert origins.shape == (S * 2, 3) and origins[0, 1] != origins[2, 1]
    params, state = jax_weights(_tall_config())
    model = weights.from_jax(tall(), params, state, "cpu")
    points = feats0[..., :3]
    spine = SpineOut(None, None, middles, points, None,
                     {k: plans[k] for k in ("aux1", "aux2", "aux3")},
                     cell0, origins, S)
    with torch.no_grad():
        got_cls, got_reg = model.aux_forward(spine)
        got = torch.cat([itp.neighborhood_interpolate_cells(
            points, cell0, lvl, m.feats, plans[f"aux{lvl}"],
            (np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** lvl
             ).tolist(), origins) for lvl, m in enumerate(middles, 1)], -1)

    seen = []
    linear = jss.L.linear

    def spy(p, x):
        seen.append(np.asarray(x))
        return linear(p, x)
    monkeypatch.setattr(jss.L, "linear", spy)
    jmid = [(jnp.asarray(m.keys.numpy()), jnp.asarray(m.feats.numpy()),
             shapes[lvl]) for lvl, m in enumerate(middles, 1)]
    jcfg = _tall_config()
    ref_cls, ref_reg = jss._banded_aux(
        params, jmid, jnp.asarray(points.numpy()), jnp.asarray(cell0.numpy()),
        {k: jnp.asarray(plans[k].numpy()) for k in ("aux1", "aux2", "aux3")},
        jcfg, jss.make_band_spec(jcfg, S))
    ref = seen[0]
    assert np.abs(ref).max() > 0.1
    assert np.abs(got.numpy() - ref).max() <= AUX_TOL
    scale = max(np.abs(np.asarray(ref_reg)).max(), 1.0)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(ref_cls),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got_reg.numpy(), np.asarray(ref_reg),
                               atol=1e-5 * scale)


@pytest.mark.parametrize("name,s", [("tall", 2), ("long_range", 4)])
def test_band_spec_matches_jax(name, s):
    if name == "tall":
        cfg, jcfg = tall(), _tall_config()
    else:
        cfg, jcfg = config.long_range_config(), jconfig.long_range_config()
    got = ss.make_band_spec(cfg, s)
    ref = jss.make_band_spec(jcfg, s)
    assert tuple(got) == tuple(ref)
    assert ss.band_shape(cfg, got) == jss.band_shape(jcfg, ref)
    if name == "long_range":
        assert got == (4, 400, 64, (39608, 36504, 28400, 20288))
        assert backbone.level_shapes(ss.band_shape(cfg, got)) == [
            (40, 528, 2048), (20, 264, 1024), (10, 132, 512), (5, 66, 256)]


def test_long_range_config_matches_jax():
    port, ref = config.long_range_config(), jconfig.long_range_config()
    for section in ("model", "voxel", "caps", "test", "data", "parallel"):
        p, r = getattr(port, section), getattr(ref, section)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), (section, f.name)
    assert port.anchors == {k: config.AnchorConfig(**dataclasses.asdict(v))
                            for k, v in ref.anchors.items()}
    assert port.sparse_shape == (40, 1600, 2048)
    assert port.bev_map_size == (200, 256) and port.num_anchors == 102400


def jax_tall_batch(seed):
    return {k: jnp.asarray(v) for k, v in tall_batch(
        seed, jax_random_batch, _tall_config()).items()
        if not k.startswith("plan_")}


@pytest.fixture(scope="module")
def banded_step():
    """One banded forward_train + backward in both packages on the same
    batch (test_spatial's seed 3, 900 points) and weights, and the port's
    replicated step; the port's in float32 and in float64."""
    jcfg = _tall_config()
    params, state = jax_weights(jcfg)
    jspec = jss.make_band_spec(jcfg, S)
    jbatch = jax_tall_batch(3)
    janchors = jnp.asarray(kitti.build_anchors(tall())[0])

    def loss_fn(p):
        losses, new_state = jss.forward_train_banded(p, state, jbatch,
                                                     janchors, jcfg, jspec)
        return jdetector.parse_losses(losses)[0], (losses, new_state)

    grads, (jlosses, jstate) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params)
    out = dict(jlosses={k: float(v) for k, v in jlosses.items()},
               jgrads=leaves(grads), jstate=leaves(jstate))
    anchors = torch.from_numpy(kitti.build_anchors(tall())[0])
    batch = tall_batch(3)
    assert not any(k.startswith("plan_") for k in batch)
    for name, cfg, dtype in (("", tall(), torch.float32),
                             ("rep_", tall(banded=False), torch.float32),
                             ("f64_", tall(), torch.float64),
                             ("rep_f64_", tall(banded=False), torch.float64)):
        model = weights.from_jax(cfg, params, state, "cpu").to(dtype)
        model.train()
        tb = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in inference.to_device(batch, "cpu").items()}
        losses = model.forward_train(tb, anchors.to(dtype))
        parse_losses(losses).backward()
        out.update({
            f"{name}losses": {k: float(v.detach()) for k, v in losses.items()},
            f"{name}grads": leaves(weights.grads_to_jax(model)),
            f"{name}state": leaves(weights.to_jax(model)[1])})
    return out


def test_banded_losses_match_jax(banded_step):
    ref, got = banded_step["jlosses"], banded_step["losses"]
    assert set(ref) <= set(got)
    assert ref["band_overflow"] == got["band_overflow"] == 0.0
    for k, v in ref.items():
        if "loss" in k:
            assert np.isfinite(v) and v != 0.0, k
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


def rel_l2(got, ref) -> float:
    return float(np.linalg.norm(got.astype(np.float64) - ref)
                 / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("module", MODULES)
def test_banded_grads_match_jax(banded_step, module):
    """Every gradient leaf of the module against jax.grad of the banded
    forward + parse_losses: 1e-3 relative L2, 2e-2 for vxnet and bevnet
    (JAX's float32 rounding there)."""
    ref = {k: v for k, v in banded_step["jgrads"].items()
           if k.startswith(f"['{module}']")}
    got = banded_step["grads"]
    assert ref and set(ref) <= set(got)
    tol = JAX_F32_GRAD_RTOL.get(module, GRAD_RTOL)
    for k, r in ref.items():
        assert np.linalg.norm(r) > 0, k
        err = rel_l2(got[k], r)
        assert err <= tol, (k, err)


def test_banded_grads_match_float64(banded_step):
    """The port's float32 banded gradients within 1e-3 of its float64
    banded step, leaf by leaf; banded == replicated in float64 to 1e-6
    (the aux ring's cell centres are float32 arithmetic on each band's
    own origin, so they round differently)."""
    f64, rep64 = banded_step["f64_grads"], banded_step["rep_f64_grads"]
    for k, v in banded_step["grads"].items():
        assert rel_l2(v, f64[k]) <= GRAD_RTOL, k
        assert rel_l2(f64[k], rep64[k]) <= 1e-6, k


def test_banded_bn_state_matches_jax(banded_step):
    """Owned-row BatchNorm: the running buffers equal JAX's."""
    ref, got = banded_step["jstate"], banded_step["state"]
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-3, atol=1e-5,
                                   err_msg=k)


def test_banded_train_matches_replicated(banded_step):
    """The port's banded step == its replicated step (halo cells counted
    once by BatchNorm; the aux loss over owned queries): losses, BN state,
    and every gradient leaf within 1e-3 relative L2."""
    ref, got = banded_step["rep_losses"], banded_step["losses"]
    assert set(got) == set(ref) | {"band_overflow"}
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, err_msg=k)
    for k, v in banded_step["rep_state"].items():
        np.testing.assert_allclose(banded_step["state"][k], v, rtol=2e-3,
                                   atol=1e-5, err_msg=k)
    for k, r in banded_step["rep_grads"].items():
        err = rel_l2(banded_step["grads"][k], r)
        assert err <= GRAD_RTOL, (k, err)


@pytest.fixture(scope="module")
def banded_dets():
    """forward_test banded in both packages and replicated in the port, on
    test_spatial's inference batch (seed 5)."""
    jcfg = _tall_config()
    params, state = jax_weights(jcfg)
    janchors = jnp.asarray(kitti.build_anchors(tall())[0])
    ref = jax.jit(lambda p, s, b: jss.forward_test_banded(
        p, s, b, janchors, jcfg, jss.make_band_spec(jcfg, S)))(
            params, state, jax_tall_batch(5))
    out = dict(jax={k: np.asarray(v) for k, v in ref.items()})
    anchors = kitti.build_anchors(tall())[0]
    batch = tall_batch(5)
    for name, cfg in (("banded", tall()), ("replicated", tall(banded=False))):
        model = weights.from_jax(cfg, params, state, "cpu")
        got = inference.make_test_step(cfg, anchors, "cpu")(model, batch)
        out[name] = {k: v.numpy() for k, v in got.items()}
    return out


@pytest.mark.parametrize("ref", ["jax", "replicated"])
def test_banded_detections_match(banded_dets, ref):
    """Banded forward_test == JAX forward_test_banded, and == the port's
    replicated run: valid flags equal, boxes and scores within 2e-3."""
    got, want = banded_dets["banded"], banded_dets[ref]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.sum() > 0
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=2e-3)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v],
                               atol=2e-3)


def test_serving_ignores_the_band_strategy():
    """forward_test(replicated=True) of a banded model is the replicated
    model's forward_test, bitwise, as device-resident serving runs it."""
    params, state = jax_weights(_tall_config())
    batch = inference.to_device(tall_batch(6), "cpu")
    anchors = torch.from_numpy(kitti.build_anchors(tall())[0])
    with torch.no_grad():
        got = weights.from_jax(tall(), params, state, "cpu").forward_test(
            batch, anchors, replicated=True)
        ref = weights.from_jax(tall(banded=False), params, state,
                               "cpu").forward_test(batch, anchors)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("case", ["spatial", "banded_exact", "accepted"])
def test_check_supported_banded(case, monkeypatch):
    """"spatial" is accepted on one rank and on a world that its
    `spatial` divides, and refused with ValueError on one it does not;
    banded training refuses the exact aux 3-NN with ValueError (as the
    JAX package does); banded ring training, banded inference with any
    aux, and a banded strategy over one band (run replicated) pass."""
    cfg = tall()
    if case == "spatial":
        from sassd_tpu_torch.parallel import dist
        sp = dataclasses.replace(cfg, parallel=config.ParallelConfig(
            strategy="spatial", spatial=2))
        for world, ok in ((1, True), (2, True), (4, True), (3, False)):
            monkeypatch.setattr(dist, "process_count", lambda: world)
            for train in (False, True):
                if ok:
                    config.check_supported(sp, train=train)
                else:
                    with pytest.raises(ValueError,
                                       match="3 ranks.*spatial=2"):
                        config.check_supported(sp, train=train)
    elif case == "banded_exact":
        with pytest.raises(ValueError, match="ring"):
            config.check_supported(tall(aux_interp="exact"), train=True)
        config.check_supported(tall(aux_interp="exact"))
    else:
        config.check_supported(cfg, train=True)
        one = dataclasses.replace(cfg, parallel=config.ParallelConfig(
            strategy="banded", spatial=1))
        config.check_supported(dataclasses.replace(
            one, model=dataclasses.replace(one.model, aux_interp="exact")),
            train=True)
        assert config.banded(cfg) and not config.banded(one)
        assert kitti.build_host_plans(cfg, tall_batch(1)["coords"][0]) == {}


def test_train_model_banded(tmp_path, caplog):
    """train_model on a tiny tall split, banded: 2 steps at batch 2 (4 band
    rows), finite losses, band_overflow logged as 0."""
    cfg = tall()
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, log_interval=1,
                                       checkpoint_interval=1),
        data=dataclasses.replace(cfg.data, num_workers=0))
    root = tmp_path / "kitti"
    synthetic.write_synthetic_kitti(
        str(root), n_train=4, n_val=0, seed=0,
        point_cloud_range=cfg.voxel.point_cloud_range, n_cars=(1, 3),
        n_ground=1200)
    ds = kitti.KittiDataset(cfg, str(root / "training"),
                            str(root / "ImageSets" / "train.txt"),
                            train=True)
    assert not any(k.startswith("plan_") for k in ds[0])
    with caplog.at_level(logging.INFO, logger="sassd"):
        _, opt, step = loop.train_model(cfg, ds, str(tmp_path / "work"),
                                        total_epochs=1, device="cpu")
    assert step == 2 and opt.count == 2
    lines = [m for m in caplog.messages if " step " in m]
    assert len(lines) == 2
    for m in lines:
        vals = dict(kv.split("=") for kv in m.split() if "=" in kv)
        assert vals["band_overflow"] == "0.0000"
        assert vals["nonfinite_skips"] == "0.0000"
        assert all(np.isfinite(float(v)) for v in vals.values())
