"""Port parity for persistent-plan serving (test.serve_persistent_plans):
the carried index maps (K17's plain version, ops/sparse.py
update_index_maps_plain, the three levels in one call),
serve.plans_from_carry, the persistent serving
step and run_inference with the flag, against the JAX package's
sassd_tpu/serve.py init_plan_carry / _plans_from_carry / make_serving_step
(persistent_plans=True) and against the port's per-scan path.

Tolerances: maps, keys and plans are integers and must be equal bit for
bit; the persistent step's detections equal the per-scan step's bit for
bit (the same plans, the same operations), and match JAX's as sets
within the golden-test tolerances (tests/test_golden.py), as the
per-scan serving parity test does (tests/test_torch_serve.py).
"""
import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu import serve as jserve  # noqa: E402
from sassd_tpu_torch import config, inference, serve, weights  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models.backbone import level_shapes  # noqa: E402
from sassd_tpu_torch.ops import sparse as sp  # noqa: E402
from test_torch_cases import K17_CASES, K17_SHAPE, k17_case  # noqa: E402
from test_torch_detector import jax_weights, matched  # noqa: E402
from test_torch_eval import split_config  # noqa: E402
from test_torch_serve import scene_points  # noqa: E402


def scan_stream(cfg):
    """Three raw scans of one stream: the second is the first with each
    point moved by about a millimetre, so the two share most voxels, and
    the third another scene (no point on a voxel boundary: the JAX step
    is jitted)."""
    rng = np.random.default_rng(21)
    a = scene_points(cfg, rng, n=480, boundary=False)
    b = scene_points(cfg, rng, n=360, boundary=False)
    c = a.copy()
    c[:, :3] += rng.normal(0, 0.001, (len(a), 3)).astype(np.float32)
    return [a, c, b]


def batch_of(cfg, raw):
    p, n = serve.prepare_points(raw, cfg)
    return dict(points=p[None], n_points=np.asarray([n], np.int32))


@pytest.fixture(scope="module")
def stream():
    """The three scans through the port's per-scan and persistent steps
    and JAX's persistent step (one jit), with the same sqrt(6)-scaled JAX
    weights."""
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    params, state = jax_weights(weights.RELU_GAIN)
    anchors, anchors_bv = kitti.build_anchors(cfg)
    model = weights.from_jax(cfg, params, state, "cpu")
    step = serve.make_serving_step(cfg, anchors, anchors_bv, "cpu")
    step_p = serve.make_serving_step(cfg, anchors, anchors_bv, "cpu",
                                     persistent_plans=True)
    jstep_p = jserve.make_serving_step(jcfg, anchors, anchors_bv,
                                       persistent_plans=True)
    carry, jcarry = serve.init_plan_carry(cfg, "cpu"), jserve.init_plan_carry(
        jcfg)
    out = []
    for raw in scan_stream(cfg):
        batch = batch_of(cfg, raw)
        per = step(model, batch)
        got, carry = step_p(model, carry, batch)
        ref, jcarry = jstep_p(params, state, jcarry,
                              {k: jnp.asarray(v) for k, v in batch.items()})
        out.append(({k: v.numpy() for k, v in per.items()},
                    {k: v.numpy() for k, v in got.items()},
                    {k: np.asarray(v) for k, v in ref.items()}))
    return cfg, model, anchors, anchors_bv, step_p, out


def test_carried_maps_match_jax(stream):
    """After each of three scans the port's carried maps and keys are
    JAX's (eager _plans_from_carry) bit for bit, each map is the fresh
    index map of its level's keys, and the plans are JAX's and the
    per-scan device rulebook's."""
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    _, anchors_bv = kitti.build_anchors(cfg)
    lattice = serve.serving_lattice(cfg, anchors_bv)
    shapes = level_shapes(cfg.sparse_shape)
    carry, jcarry = serve.init_plan_carry(cfg, "cpu"), jserve.init_plan_carry(
        jcfg)
    shared = 0
    prev = None
    for raw in scan_stream(cfg):
        b = batch_of(cfg, raw)
        coords = serve.batch_from_points(
            torch.from_numpy(b["points"]), torch.from_numpy(b["n_points"]),
            lattice, cfg)["coords"]
        plans, carry = serve.plans_from_carry(coords[0], carry, cfg)
        jplans, jcarry = jserve._plans_from_carry(jnp.asarray(coords[0]),
                                                  jcarry, jcfg)
        for lvl in range(3):
            keys = carry[f"keys{lvl}"]
            np.testing.assert_array_equal(keys[0].numpy(),
                                          np.asarray(jcarry[f"keys{lvl}"]))
            np.testing.assert_array_equal(carry[f"map{lvl}"][0].numpy(),
                                          np.asarray(jcarry[f"map{lvl}"]))
            assert torch.equal(carry[f"map{lvl}"],
                               sp.build_index_map_plain(keys, shapes[lvl]))
        keys0 = sp.coords_to_keys(coords, shapes[0])
        ref = sp.device_rulebook(keys0, shapes, cfg.caps.level_caps[1:])
        assert sorted(plans) == sorted(ref) == sorted(jplans)
        for k, v in plans.items():
            assert torch.equal(v, ref[k]), k
            np.testing.assert_array_equal(v.numpy(), np.asarray(jplans[k]),
                                          err_msg=k)
        valid = set(keys0[keys0 != sp.INVALID_KEY].tolist())
        if prev is not None:
            shared = max(shared, len(valid & prev))
        prev = valid
    assert shared > 50          # the stream's scans share level-0 voxels


def test_persistent_step_matches_per_scan_and_jax(stream):
    *_, out = stream
    counts = []
    for per, got, ref in out:
        assert per.keys() == got.keys()
        for k in per:
            np.testing.assert_array_equal(got[k], per[k], err_msg=k)
        counts.append(matched(got, ref, 0))
        np.testing.assert_array_equal(got["guided_truncated"],
                                      ref["guided_truncated"])
    assert min(counts) >= 1


def test_persistent_serving_ignores_plan_lookup(stream, monkeypatch):
    """With model.plan_lookup="sorted" persistent-plan serving still
    resolves its plans through the carried index maps (K17's and K6's
    plain versions), as the JAX package's _plans_from_carry does whatever
    plan_lookup says: the three scans' detections equal the dense
    persistent run's bit for bit. The per-scan step of the same config
    takes the sorted path (K18's plain version, no index map) and equals
    the dense per-scan step."""
    from sassd_tpu_torch.models.detector import Detector
    cfg, model, anchors, anchors_bv, _, out = stream
    cfg_s = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, plan_lookup="sorted"))
    model_s = Detector(cfg_s)
    model_s.load_state_dict(model.state_dict())
    calls = []
    for name in ("build_index_map", "update_index_maps", "window_plans",
                 "sorted_window_plans"):
        def spy(*args, _fn=getattr(sp, name), _name=name, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(sp, name, spy)
    step = serve.make_serving_step(cfg_s, anchors, anchors_bv, "cpu")
    step_p = serve.make_serving_step(cfg_s, anchors, anchors_bv, "cpu",
                                     persistent_plans=True)
    carry = serve.init_plan_carry(cfg_s, "cpu")
    for raw, (per, got, _) in zip(scan_stream(cfg), out):
        batch = batch_of(cfg, raw)
        calls.clear()
        res, carry = step_p(model_s, carry, batch)
        assert calls == ["update_index_maps", "window_plans"], calls
        for k in got:
            np.testing.assert_array_equal(res[k].numpy(), got[k], err_msg=k)
        calls.clear()
        res = step(model_s, batch)
        assert calls == ["sorted_window_plans"], calls
        for k in per:
            np.testing.assert_array_equal(res[k].numpy(), per[k], err_msg=k)


def test_persistent_step_refuses_batch_two(stream):
    cfg, model, _, _, step_p, _ = stream
    raws = scan_stream(cfg)[:2]
    scans = [serve.prepare_points(r, cfg) for r in raws]
    batch = dict(points=np.stack([p for p, _ in scans]),
                 n_points=np.asarray([n for _, n in scans], np.int32))
    with pytest.raises(ValueError, match="batch_size=1"):
        step_p(model, serve.init_plan_carry(cfg, "cpu"), batch)


def test_run_inference_with_the_flag_matches_without(tmp_path):
    """run_inference at batch 1 with test.serve_persistent_plans (one
    carry threaded through three scans) gives the annotations of the
    per-scan run, bit for bit; at batch 2 the flag is ignored."""
    cfg = split_config(config)
    synthetic.write_synthetic_kitti(
        str(tmp_path), n_train=0, n_val=3, seed=4, n_cars=(2, 4),
        n_ground=3000, point_cloud_range=cfg.voxel.point_cloud_range)
    ds = kitti.KittiDataset(cfg, str(tmp_path / "training"),
                            str(tmp_path / "ImageSets" / "val.txt"))
    params, state = jax_weights(weights.RELU_GAIN)
    model = weights.from_jax(cfg, params, state, "cpu")
    cfg_p = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, serve_persistent_plans=True))
    calls = []
    orig = serve.plans_from_carry

    def spy(*args):
        calls.append(1)
        return orig(*args)
    serve.plans_from_carry = spy
    try:
        got = inference.run_inference(cfg_p, ds, model, 1, "cpu")
        assert len(calls) == 3
        got2 = inference.run_inference(cfg_p, ds, model, 2, "cpu")
        assert len(calls) == 3
    finally:
        serve.plans_from_carry = orig
    ref = inference.run_inference(cfg, ds, model, 1, "cpu")
    assert got[1] == ref[1] == [0, 1, 2]
    assert sum(len(a["name"]) for a in ref[0]) > 0
    for a, b in zip(got[0], ref[0]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got2[1][:3] == [0, 1, 2]


@pytest.mark.parametrize("case", K17_CASES)
def test_update_index_map_plain_cases(case):
    """One map carried through each case's scans equals the fresh index
    map of every scan's keys, updated in place."""
    shape, seq = k17_case(case)
    b = seq[0].shape[0]
    imap = torch.full((b, int(np.prod(shape))), -1, dtype=torch.int32)
    prev = torch.full((b, seq[0].shape[1]), sp.INVALID_KEY,
                      dtype=torch.int32)
    for keys in map(torch.from_numpy, seq):
        out = sp.update_index_map(imap, prev, keys, shape)
        assert out is imap
        assert torch.equal(imap, sp.build_index_map_plain(keys, shape))
        prev = keys


def k17_config(m):
    """The fields of a config that both packages' init_plan_carry and
    _plans_from_carry / plans_from_carry read: K17_SHAPE's grid, every
    level capped at m rows."""
    return types.SimpleNamespace(sparse_shape=K17_SHAPE,
                                 caps=types.SimpleNamespace(
                                     level_caps=(m,) * 4))


@pytest.mark.parametrize("case", K17_CASES)
def test_three_level_updates_match_jax(case):
    """Each case's scans as level-0 keys of a stream: the three levels'
    maps carried by update_index_maps_plain (the whole batch, one call a
    scan) and by serve.plans_from_carry (a sample at a time) equal JAX's
    _plans_from_carry maps of each sample and the fresh map of each
    level's keys after every scan, and plans_from_carry's plans equal
    JAX's, bit for bit."""
    shape, seq = k17_case(case)
    b, m = seq[0].shape
    cfg = k17_config(m)
    shapes = level_shapes(shape)[:3]
    inv = torch.full((b, m), sp.INVALID_KEY, dtype=torch.int32)
    maps = [torch.full((b, int(np.prod(s))), -1, dtype=torch.int32)
            for s in shapes]
    prev = [inv] * 3
    carries = [serve.init_plan_carry(cfg, "cpu") for _ in range(b)]
    jcarries = [jserve.init_plan_carry(cfg) for _ in range(b)]
    for keys in map(torch.from_numpy, seq):
        lk = [keys]
        for lvl in (1, 2):
            lk.append(sp.downsample_keys(lk[-1], shapes[lvl - 1], m))
        out = sp.update_index_maps_plain(maps, prev, lk)
        assert all(o is g for o, g in zip(out, maps))
        for lvl in range(3):
            assert torch.equal(maps[lvl], sp.build_index_map_plain(
                lk[lvl], shapes[lvl])), lvl
        for i in range(b):
            coords = sp.keys_to_coords(keys[i], shape)
            plans, carries[i] = serve.plans_from_carry(coords, carries[i],
                                                       cfg)
            jplans, jcarries[i] = jserve._plans_from_carry(
                jnp.asarray(coords.numpy()), jcarries[i], cfg)
            for lvl in range(3):
                jmap = np.asarray(jcarries[i][f"map{lvl}"])
                np.testing.assert_array_equal(maps[lvl][i].numpy(), jmap)
                np.testing.assert_array_equal(
                    carries[i][f"map{lvl}"][0].numpy(), jmap)
                np.testing.assert_array_equal(
                    carries[i][f"keys{lvl}"][0].numpy(),
                    np.asarray(jcarries[i][f"keys{lvl}"]))
            assert sorted(plans) == sorted(jplans)
            for k, v in plans.items():
                np.testing.assert_array_equal(v.numpy(),
                                              np.asarray(jplans[k]),
                                              err_msg=k)
        prev = lk


def test_update_index_map_rejects_bad_shapes():
    imap = torch.full((1, 10), -1, dtype=torch.int32)
    keys = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        sp.update_index_map(imap, keys, keys, (1, 2, 4))
    with pytest.raises(ValueError):
        sp.update_index_map(imap, keys, keys.repeat(2, 1), (1, 2, 5))
    with pytest.raises(ValueError):                  # four levels
        sp.update_index_maps([imap] * 4, [keys] * 4, [keys] * 4,
                             [(1, 2, 5)] * 4)
    with pytest.raises(ValueError):                  # a grid missing
        sp.update_index_maps([imap] * 2, [keys] * 2, [keys] * 2, [(1, 2, 5)])
