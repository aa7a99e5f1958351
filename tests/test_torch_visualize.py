"""The port's BEV visualizer (sassd_tpu_torch/tools/visualize.py) on the
CPU at tiny_config(), with sqrt(6)-scaled JAX weights: the scene, its
detections and the drawn polylines against the JAX package's
forward_test and corners_2d (the data drawn, not PNG bytes), and main()
writing bev.png from a JAX .msgpack and from a .pt checkpoint.

Tolerances: the golden-test ones for detections (boxes 1e-2, scores
1e-3, matched as sets); scan points and GT rings bitwise; detection rings
1e-2 m.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.data import augment as jaugment  # noqa: E402
from sassd_tpu.data import kitti as jkitti  # noqa: E402
from sassd_tpu.data import synthetic as jsynthetic  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.ops.voxelize import voxelize_np as jvoxelize_np  # noqa: E402
from sassd_tpu.train import checkpoint as jckpt  # noqa: E402
from sassd_tpu_torch import config, weights  # noqa: E402
from sassd_tpu_torch.data import calib  # noqa: E402
from sassd_tpu_torch.tools import visualize  # noqa: E402
from sassd_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from test_torch_detector import jax_weights  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_scene_dets(cfg, params, state, points):
    """The JAX tool's detector pass (tools/visualize.py) on `points`:
    host voxels and plans, all anchors unmasked, no GT slots."""
    v, c, n = jvoxelize_np(points, cfg.voxel, pad=True)
    g = cfg.caps.max_gt
    batch = {"voxels": jnp.asarray(v[None]),
             "num_points": jnp.asarray(n[None]),
             "coords": jnp.asarray(c[None]),
             "anchors_mask": jnp.ones((1, cfg.num_anchors), bool),
             "gt_boxes": jnp.zeros((1, g, 7)),
             "gt_classes": jnp.zeros((1, g), jnp.int32),
             "gt_valid": jnp.zeros((1, g), bool)}
    for k, arr in jkitti.build_host_plans(cfg, c).items():
        batch[k] = jnp.asarray(arr[None])
    anchors = jnp.asarray(jkitti.build_anchors(cfg)[0])
    out = jdetector.forward_test(params, state, batch, anchors, cfg)
    keep = np.asarray(out["valid"])[0]
    return {k: np.asarray(out[k])[0][keep] for k in ("boxes", "scores")}


@pytest.fixture(scope="module")
def viz(tmp_path_factory):
    """Checkpoints of the scaled JAX weights in both formats, a config
    file, and the port's and JAX's scene of seed 0 with detections."""
    root = tmp_path_factory.mktemp("viz")
    params, state = jax_weights(weights.RELU_GAIN)
    cfg = config.tiny_config()
    pt = str(root / "model.pt")
    ckpt.write(pt, weights.from_jax(cfg, params, state, "cpu"), None, 0, 0)
    msgpack = jckpt.save(str(root / "jax"), 0, 0, params, state, {})
    cfg_file = root / "tiny.py"
    cfg_file.write_text("from sassd_tpu.config import tiny_config\n"
                        "config = tiny_config()\n")
    got = visualize.scene(cfg, None, pt, "cpu")
    points, boxes, _ = jsynthetic.make_scene(np.random.default_rng(0))
    ref = jax_scene_dets(jconfig.tiny_config(), params, state, points)
    return dict(root=root, cfg=cfg, pt=pt, msgpack=str(msgpack),
                cfg_file=str(cfg_file), got=got,
                ref=(points, boxes, ref))


def match_sets(got, ref):
    """Index pairs (got, ref) of detections equal within the golden
    tolerances, every detection matched once."""
    assert len(got["boxes"]) == len(ref["boxes"])
    used = np.zeros(len(ref["boxes"]), bool)
    pairs = []
    for i, (b, s) in enumerate(zip(got["boxes"], got["scores"])):
        ok = ((np.abs(ref["boxes"] - b).max(1) <= 1e-2)
              & (np.abs(ref["scores"] - s) <= 1e-3) & ~used)
        assert ok.any(), (b, s)
        j = int(np.argmax(ok))
        used[j] = True
        pairs.append((i, j))
    return pairs


def test_scene_matches_jax(viz):
    (points, boxes, dets), (rpoints, rboxes, rdets) = viz["got"], viz["ref"]
    np.testing.assert_array_equal(points, rpoints)
    np.testing.assert_array_equal(boxes, rboxes)
    assert set(dets) == {"boxes", "scores", "labels"}
    assert len(match_sets(dets, rdets)) >= 1


def jax_rings(boxes):
    """tools/visualize.py draw_bev's rings: JAX corners_2d, corner 0
    appended."""
    cs = jaugment.corners_2d(boxes[:, :2], boxes[:, 3:5], boxes[:, 6])
    return [np.stack([list(c[:, 0]) + [c[0, 0]], list(c[:, 1]) + [c[0, 1]]],
                     -1) for c in cs]


def test_polylines_match_jax(viz):
    (_, boxes, dets), (_, rboxes, rdets) = viz["got"], viz["ref"]
    lines = visualize.bev_polylines(viz["cfg"], boxes, dets["boxes"])
    ref_gt = jax_rings(rboxes)
    assert len(lines["gt"]) == len(ref_gt) >= 1
    for a, b in zip(lines["gt"], ref_gt):
        assert a.shape == (5, 2)
        np.testing.assert_array_equal(a, b)
    ref_det = jax_rings(rdets["boxes"])
    for i, j in match_sets(dets, rdets):
        np.testing.assert_allclose(lines["dets"][i], ref_det[j], rtol=0,
                                   atol=1e-2)
    pcr = jconfig.tiny_config().voxel.point_cloud_range
    assert lines["xlim"] == (pcr[0], pcr[3])
    assert lines["ylim"] == (pcr[1], pcr[4])
    empty = visualize.bev_polylines(viz["cfg"], None, np.zeros((0, 7)))
    assert empty["gt"] == [] and empty["dets"] == []


def test_scan_file_and_msgpack_checkpoint(viz, tmp_path):
    """A raw .bin scan has no GT; a JAX .msgpack gives the .pt's
    detections bitwise (the same weights)."""
    points = viz["got"][0]
    scan = tmp_path / "000000.bin"
    points.astype(np.float32).tofile(scan)
    p, b, d = visualize.scene(viz["cfg"], str(scan), viz["msgpack"], "cpu")
    np.testing.assert_array_equal(p, calib.read_lidar(scan))
    assert b is None
    for k, v in viz["got"][2].items():
        np.testing.assert_array_equal(d[k], v)
    p, b, d = visualize.scene(viz["cfg"], str(scan), None, "cpu")
    assert b is None and d is None


@pytest.mark.parametrize("fmt", ["pt", "msgpack"])
def test_main_writes_png(viz, tmp_path, fmt, capsys):
    out = tmp_path / "viz"
    assert visualize.main([viz["cfg_file"], "--synthetic", "--ckpt",
                           viz[fmt], "--device", "cpu", "--out",
                           str(out)]) == 0
    png = out / "bev.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"wrote {png}" in capsys.readouterr().out


def test_main_needs_matplotlib(viz, tmp_path, monkeypatch):
    """Without matplotlib main raises its ImportError (no picture is
    skipped quietly); importing the tool and making the scene and its
    polylines import no matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        visualize.main([viz["cfg_file"], "--device", "cpu", "--out",
                        str(tmp_path)])
    code = ("import sys\n"
            "from sassd_tpu_torch.config import tiny_config\n"
            "from sassd_tpu_torch.tools import visualize as v\n"
            "c = tiny_config()\n"
            "p, b, _ = v.scene(c, device='cpu')\n"
            "v.bev_polylines(c, b, None)\n"
            "assert 'matplotlib' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
