"""The port's guided_train cap probe (sassd_tpu_torch/tools/sweep_guided.py)
on the CPU: its rows over a two-scene tiny synthetic corpus against rows
built from the JAX functions the JAX tool calls (forward_spine, head_apply,
second_box_decode, rotate_iou_3d) in one jitted call, with the JAX tool's
row arithmetic; and main()'s printed rows and summary in the JAX tool's
format. The checkpoint holds BatchNorm statistics moved off their initial
values, so a probe that loaded parameters only would differ.

Rows are compared exactly; the scores the rows rest on within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.core import boxes as jboxes  # noqa: E402
from sassd_tpu.core import riou as jriou  # noqa: E402
from sassd_tpu.data import kitti as jkitti  # noqa: E402
from sassd_tpu.data.loader import collate as jcollate  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.models import ssd_head as jssd_head  # noqa: E402
from sassd_tpu.train import checkpoint as jckpt  # noqa: E402
from sassd_tpu_torch import config, weights  # noqa: E402
from sassd_tpu_torch.data import kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models.detector import Detector  # noqa: E402
from sassd_tpu_torch.tools import sweep_guided  # noqa: E402
from sassd_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from test_torch_detector import jax_weights  # noqa: E402

# caps whose candidate budgets (cap - max_gt) cut, nearly cut and keep
# every candidate of the tiny grid's 128 anchors
CAPS = (24, 72, 200)
# a PSWarp IoU threshold the seeded weights' boxes reach
POS_IOU = 0.3


def probe_config(pkg, root):
    base = pkg.tiny_config()
    return dataclasses.replace(
        base, data=dataclasses.replace(base.data, root=str(root)),
        train=dataclasses.replace(base.train, extra_pos_iou=POS_IOU))


def moved_stats(state, seed=3):
    """BatchNorm means and variances moved off 0 and 1."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(v) * rng.uniform(0.5, 2.0, v.shape)
                      if p[-1].key == "var" else
                      np.asarray(v) + rng.normal(0, 0.1, v.shape)
                      ).astype(np.float32), state)


def jax_rows(cfg, params, state, n_scenes):
    """The JAX tool's rows: its jitted head_outs and per-scene arithmetic
    (descending score order taken stable)."""
    ds = jkitti.KittiDataset(cfg, f"{cfg.data.root}/training",
                             f"{cfg.data.root}/ImageSets/train.txt")
    anchors = jnp.asarray(jkitti.build_anchors(cfg)[0])

    @jax.jit
    def head_outs(params, state, batch):
        spine = jdetector.forward_spine(params, state, batch, cfg,
                                        train=False)
        outs = jssd_head.head_apply(
            params["head"], spine.bev_map, cfg.model.num_class,
            cfg.model.box_code_size, cfg.model.num_anchor_per_loc)
        decoded = jboxes.second_box_decode(outs.box_preds, anchors[None])
        return jnp.max(jax.nn.sigmoid(outs.cls_preds), axis=-1), decoded

    rows, scores = [], []
    for i in range(n_scenes):
        batch, _ = jcollate([ds[i]])
        ts, dec = head_outs(params, state,
                            {k: jnp.asarray(v) for k, v in batch.items()})
        ts, dec = np.asarray(ts)[0], np.asarray(dec)[0]
        gtb, gtv = batch["gt_boxes"][0], batch["gt_valid"][0]
        g = int(gtv.sum())
        idx = np.nonzero((ts > cfg.train.anchor_thr)
                         & batch["anchors_mask"][0])[0]
        pos = np.zeros(len(idx), bool)
        if len(idx) and g:
            iou = np.asarray(jriou.rotate_iou_3d(jnp.asarray(dec[idx]),
                                                 jnp.asarray(gtb[gtv])))
            pos = iou.max(1) >= cfg.train.extra_pos_iou
        order = np.argsort(-ts[idx], kind="stable")
        r = dict(i=i, G=g, n_pass=len(idx), n_pos=int(pos.sum()))
        for cap in CAPS:
            k = cap - gtb.shape[0]
            r[f"kept_pos_{cap}"] = int(pos[order[:k]].sum())
            r[f"trunc_{cap}"] = max(0, len(idx) - k)
        rows.append(r)
        scores.append(ts)
    return rows, scores


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two tiny-range training scans, a .msgpack of scaled seeded weights
    with moved BatchNorm statistics, a config file, and the JAX rows."""
    root = tmp_path_factory.mktemp("corpus")
    cfg = probe_config(config, root)
    synthetic.write_synthetic_kitti(
        str(root), n_train=2, n_val=0, seed=1, n_cars=(2, 4),
        n_ground=1200, point_cloud_range=cfg.voxel.point_cloud_range)
    params, state = jax_weights(weights.RELU_GAIN)
    state = moved_stats(state)
    path = jckpt.save(str(root / "work"), 0, 0, params, state, {})
    cfg_file = root / "probe.py"
    cfg_file.write_text(
        "import dataclasses\n"
        "from sassd_tpu.config import tiny_config\n"
        "_c = tiny_config()\n"
        f"config = dataclasses.replace(_c, data=dataclasses.replace("
        f"_c.data, root={str(root)!r}), train=dataclasses.replace("
        f"_c.train, extra_pos_iou={POS_IOU}))\n")
    rows, scores = jax_rows(probe_config(jconfig, root), params, state, 2)
    return dict(cfg=cfg, ckpt=str(path), cfg_file=str(cfg_file), rows=rows,
                scores=scores)


def test_probe_rows_match_jax(corpus):
    cfg = corpus["cfg"]
    ds = kitti.KittiDataset(cfg, f"{cfg.data.root}/training",
                            f"{cfg.data.root}/ImageSets/train.txt",
                            train=True)
    model = Detector(cfg)
    ckpt.restore(corpus["ckpt"], model)
    res = sweep_guided.probe(cfg, model, ds, CAPS, 2, "cpu")
    rows = [r for r, _, _ in res]
    assert rows == corpus["rows"]
    for (_, ts, best), ref in zip(res, corpus["scores"]):
        np.testing.assert_allclose(ts, ref, rtol=0, atol=1e-5)
        assert best.dtype == np.float32
    # the rows exercise every branch: GTs, positives, cut and uncut caps
    assert all(r["G"] > 0 for r in rows)
    assert sum(r["n_pos"] for r in rows) > 0
    assert any(r[f"trunc_{CAPS[0]}"] > 0 for r in rows)
    assert all(r[f"trunc_{CAPS[-1]}"] == 0 for r in rows)
    # BatchNorm statistics come from the checkpoint
    params_only = Detector(cfg)
    ckpt.load_params_only(corpus["ckpt"], params_only)
    other = sweep_guided.probe(cfg, params_only, ds, CAPS, 1, "cpu")
    assert np.abs(other[0][1] - res[0][1]).max() > 1e-5


def test_main_prints_the_jax_tools_lines(corpus, capsys):
    assert sweep_guided.main([corpus["cfg_file"], corpus["ckpt"], "--caps",
                              ",".join(map(str, CAPS)), "--scenes", "2",
                              "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = corpus["rows"]
    assert lines[:2] == [str(r) for r in rows]
    assert lines[2].startswith("elapsed ") and lines[2].endswith(
        f"s over 2 scenes; mean candidates "
        f"{np.mean([r['n_pass'] for r in rows]):.1f} "
        f"(max {max(r['n_pass'] for r in rows)}), "
        f"mean GTs {np.mean([r['G'] for r in rows]):.1f}")
    tot = sum(r["n_pos"] for r in rows)
    for line, cap in zip(lines[3:], CAPS):
        kept = sum(r[f"kept_pos_{cap}"] for r in rows)
        trunc = sum(1 for r in rows if r[f"trunc_{cap}"] > 0)
        assert line == (f"cap={cap}: scenes truncated {trunc}/2, "
                        f"positive-pool recall {kept}/{tot} = "
                        f"{kept / max(tot, 1):.3f} (appended GTs always "
                        "kept)")
    assert len(lines) == 3 + len(CAPS)
