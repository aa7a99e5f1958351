"""The port's CLIs and what they stand on, on the CPU: config files
through sassd_tpu_torch.config.load_config (field by field against the
JAX package's load_config, with sys.modules restored and no JAX imported),
JAX .msgpack checkpoints read by the port (every leaf bitwise; one
resumed AdamW step against optax within 1e-6), the reference-checkpoint
converter against the JAX tool's, train_model's resume, load_from,
epochs_per_run and eval_interval on tiny_config() (resume bitwise), the
train and test CLIs as subprocesses (exit 75, then 0; the resumed run
bitwise equal to an uninterrupted one; the AP table), and the
data-preparation writers byte for byte against the JAX package's.

Bitwise comparisons of train steps run with one intra-op thread: the CPU
backward's parallel scatter-adds are not repeatable across threads.
"""
import dataclasses
import glob
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

import sassd_tpu.config as jconfig  # noqa: E402
from sassd_tpu.data import create_data as jcreate  # noqa: E402
from sassd_tpu.models import detector as jdetector  # noqa: E402
from sassd_tpu.train import checkpoint as jckpt  # noqa: E402
from sassd_tpu.train import optim as joptim  # noqa: E402
from sassd_tpu_torch import config, weights  # noqa: E402
from sassd_tpu_torch.data import create_data, kitti, synthetic  # noqa: E402
from sassd_tpu_torch.models.detector import Detector  # noqa: E402
from sassd_tpu_torch.tools import import_reference_checkpoint as imp  # noqa: E402
from sassd_tpu_torch.tools import make_synth_corpus  # noqa: E402
from sassd_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from sassd_tpu_torch.train import jax_checkpoint, loop, optim  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.py")))


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_fields(port, ref, where=""):
    """Every field both dataclasses declare is equal (recursively)."""
    names = ({f.name for f in dataclasses.fields(port)}
             & {f.name for f in dataclasses.fields(ref)})
    assert names, where
    for n in names:
        p, r = getattr(port, n), getattr(ref, n)
        if dataclasses.is_dataclass(p):
            same_fields(p, r, f"{where}.{n}")
        elif isinstance(p, dict):
            assert p.keys() == r.keys(), (where, n)
            for k in p:
                same_fields(p[k], r[k], f"{where}.{n}[{k}]")
        else:
            assert p == r, (f"{where}.{n}", p, r)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path):
    """The file loads into the port's dataclasses, equal field for field
    to the JAX load_config's over the fields both declare, passes
    check_supported(train=True), and leaves sys.modules as it was."""
    before = {k: sys.modules.get(k) for k in ("sassd_tpu", "sassd_tpu.config")}
    cfg = config.load_config(path)
    assert isinstance(cfg, config.SASSDConfig)
    assert {k: sys.modules.get(k) for k in before} == before
    assert sys.modules["sassd_tpu.config"] is jconfig
    same_fields(cfg, jconfig.load_config(path))
    config.check_supported(cfg, train=True)


def test_load_config_binding_is_restored(tmp_path):
    """`import sassd_tpu.config` resolves to the port too; a file that
    raises, or defines no port config, leaves sys.modules as it was."""
    before = {k: sys.modules.get(k) for k in ("sassd_tpu", "sassd_tpu.config")}
    good = tmp_path / "plain_import.py"
    good.write_text("import sassd_tpu.config\n"
                    "config = sassd_tpu.config.tiny_config()\n")
    assert config.load_config(str(good)).voxel.max_voxels == 512
    bad = tmp_path / "raises.py"
    bad.write_text("from sassd_tpu.config import car_config\n"
                   "raise RuntimeError('boom')\n")
    with pytest.raises(RuntimeError):
        config.load_config(str(bad))
    other = tmp_path / "not_a_config.py"
    other.write_text("config = dict(a=1)\n")
    with pytest.raises(TypeError):
        config.load_config(str(other))
    assert {k: sys.modules.get(k) for k in before} == before


def test_load_config_imports_no_jax():
    """A process that loads every config file imports neither jax nor
    sassd_tpu."""
    code = ("import glob, sys\n"
            "from sassd_tpu_torch.config import load_config\n"
            "for p in sorted(glob.glob('configs/*.py')):\n"
            "    load_config(p)\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'sassd_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def jax_tiny_params(seed=5):
    params, state = jdetector.detector_init(jax.random.PRNGKey(seed),
                                            jconfig.tiny_config())
    rng = np.random.default_rng(seed)
    state = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), state)
    return params, state


def bn_stats(model):
    return {k: v.clone() for k, v in model.named_buffers()
            if k.rsplit(".", 1)[-1] in ("mean", "var")}


def random_grads(params, rng, scale):
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray((rng.normal(size=p.shape) * scale)
                              .astype(np.float32)), params)


@pytest.fixture(scope="module")
def jax_checkpoint_file(tmp_path_factory):
    """A JAX checkpoint.save of the tiny config after 2 optax steps (a
    mid-epoch save), and the optax state it holds."""
    params, state = jax_tiny_params()
    tc = dataclasses.replace(jconfig.tiny_config().train, lr=0.01)
    tx = joptim.make_optimizer(tc, 10)
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    for scale in (50.0, 0.01):
        upd, opt_state = tx.update(random_grads(params, rng, scale),
                                   opt_state, params)
        params = optax.apply_updates(params, upd)
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    path = jckpt.save(d, 3, 17, params, state, opt_state, batch_idx=2)
    return dict(path=path, params=params, state=state, opt_state=opt_state,
                tx=tx, tc=tc)


def test_jax_checkpoint_loads_bitwise(jax_checkpoint_file):
    """Every leaf of params, state, mu and nu bitwise; epoch, step, batch
    index and the update count equal."""
    f = jax_checkpoint_file
    cfg = dataclasses.replace(config.tiny_config(), train=dataclasses.replace(
        config.tiny_config().train, lr=0.01))
    model = Detector(cfg)
    opt = optim.make_optimizer(model, cfg.train, 10)
    assert ckpt.restore(f["path"], model, opt) == (3, 17, 2)
    sd = model.state_dict()
    for tree in (f["params"], f["state"]):
        for k, v in weights._flatten(
                {m: tree[m] for m in weights.MODULES if m in tree}).items():
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    adam = f["opt_state"][1].inner_state[0]
    assert opt.count == int(adam.count) == 2
    for name in ("mu", "nu"):
        ref = weights._flatten(jax.tree_util.tree_map(
            np.asarray, getattr(adam, name)))
        got = getattr(opt, name)
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), ref[k],
                                          err_msg=f"{name} {k}")
    # load_from semantics: the parameters only, the BatchNorm statistics
    # untouched
    fresh = Detector(cfg)
    stats = bn_stats(fresh)
    ckpt.load_params_only(f["path"], fresh)
    for k, v in fresh.named_parameters():
        assert torch.equal(v, sd[k]), k
    for k, v in bn_stats(fresh).items():
        assert torch.equal(v, stats[k]), k


def test_step_resumed_from_jax_checkpoint_matches_optax(jax_checkpoint_file):
    """One port AdamW update from the restored state against one optax
    update from the JAX state, on the same gradients, within 1e-6."""
    f = jax_checkpoint_file
    cfg = dataclasses.replace(config.tiny_config(), train=f["tc"])
    model = Detector(cfg)
    opt = optim.make_optimizer(model, cfg.train, 10)
    ckpt.restore(f["path"], model, opt)
    grads = random_grads(f["params"], np.random.default_rng(1), 0.01)
    upd, _ = f["tx"].update(grads, f["opt_state"], f["params"])
    ref = weights._flatten(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(f["params"], upd)))
    opt.step({k: torch.from_numpy(np.array(v)) for k, v in
              weights._flatten(jax.tree_util.tree_map(np.asarray,
                                                      grads)).items()})
    got = dict(model.named_parameters())
    assert opt.count == 3 and ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].detach().numpy(), ref[k],
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_jax_checkpoint_reader_refuses_what_it_cannot_read(tmp_path):
    from flax import serialization
    good = serialization.msgpack_serialize(
        {"a": np.arange(3, dtype=np.int16), "b": np.float32(2.5), "c": -3})
    out = jax_checkpoint.loads(good)
    np.testing.assert_array_equal(out["a"], np.arange(3, dtype=np.int16))
    assert out["b"] == np.float32(2.5) and out["c"] == -3
    for bad in ({"x": jnp.ones(3, jnp.bfloat16)}, {"x": 1 + 2j}):
        with pytest.raises(ValueError):
            jax_checkpoint.loads(serialization.msgpack_serialize(bad))
    chunked = dict(x=serialization._chunk(np.ones(8, np.float32)))
    with pytest.raises(ValueError):
        jax_checkpoint.loads(serialization.msgpack_serialize(chunked,
                                                             in_place=True))
    with pytest.raises(ValueError):
        jax_checkpoint.loads(good[:-3])
    with pytest.raises(ValueError):                 # no optimizer state
        jax_checkpoint.optimizer_state({})


def reference_state_dict(params, state):
    """A reference SA-SSD state dict with the given weights: the inverse
    of the converter's mapping, plus entries it ignores."""
    sd = {}

    def bn(prefix, p, s):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]
        sd[f"{prefix}.running_mean"] = s["mean"]
        sd[f"{prefix}.running_var"] = s["var"]
        sd[f"{prefix}.num_batches_tracked"] = np.array(7)

    def conv2d(w):
        return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))

    vx, vs = params["vxnet"], state["vxnet"]
    for ref, idxs, ours in imp._vxnet_entries():
        for i, j in enumerate(idxs):
            w = np.asarray(vx[ours][f"conv{i}"]["w"])
            sd[f"{ref}.{j}.weight"] = w.reshape(3, 3, 3, *w.shape[1:])
            bn(f"{ref}.{j + 1}", vx[ours][f"bn{i}"], vs[ours][f"bn{i}"])
    sd["neck.backbone.extra_conv.0.weight"] = np.asarray(
        vx["extra"]["conv0"]["w"]).reshape(1, 1, 1, 64, 64)
    bn("neck.backbone.extra_conv.1", vx["extra"]["bn0"], vs["extra"]["bn0"])
    for i in range(8):
        sd[f"neck.fcn.conv{i}.weight"] = conv2d(
            params["bevnet"][f"conv{i}"]["w"])
        bn(f"neck.fcn.bn{i}", params["bevnet"][f"bn{i}"],
           state["bevnet"][f"bn{i}"])
    for ours, theirs in (("conv_cls", "conv_cls"), ("conv_box", "conv_box"),
                         ("conv_dir", "conv_dir_cls")):
        sd[f"bbox_head.{theirs}.weight"] = conv2d(params["head"][ours]["w"])
        sd[f"bbox_head.{theirs}.bias"] = np.asarray(params["head"][ours]["b"])
    psw = params["pswarp"]
    sd["extra_head.convs.0.weight"] = conv2d(psw["conv0"]["w"])
    sd["extra_head.convs.3.weight"] = conv2d(psw["conv1"]["w"])
    bn("extra_head.convs.1", psw["bn0"], state["pswarp"]["bn0"])
    for k in ("point_fc", "point_cls", "point_reg"):
        sd[f"neck.{k}.weight"] = np.ascontiguousarray(
            np.asarray(params["aux"][k]["w"]).T)
    sd["neck.legacy_seg.weight"] = np.zeros(3, np.float32)
    return {"module." + k: np.asarray(v) for k, v in sd.items()}


def test_reference_converter_matches_jax_tool(tmp_path):
    """The port's convert against the JAX tool's on a reference-layout
    state dict of seeded weights: identical trees, the same ignored
    entries; the CLI writes a .pt that restores to those weights."""
    params, state = jax_tiny_params(seed=9)
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = reference_state_dict(params, state)
    got = imp.convert(dict(sd))
    ref = load_jax_tool("import_reference_checkpoint").convert(dict(sd))
    assert got[2] == ref[2] and "neck.legacy_seg.weight" in got[2]
    for g, r in zip(got[:2], ref[:2]):
        fg, fr = weights._flatten(g), weights._flatten(r)
        assert fg.keys() == fr.keys()
        for k in fr:
            assert fg[k].dtype == fr[k].dtype, k
            np.testing.assert_array_equal(fg[k], fr[k], err_msg=k)
    pth, cfg_file, out = (tmp_path / "ref.pth", tmp_path / "cfg.py",
                          tmp_path / "imported.pt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "epoch": 80}, str(pth))
    cfg_file.write_text("from sassd_tpu.config import tiny_config\n"
                        "config = tiny_config()\n")
    assert imp.main([str(pth), str(cfg_file), str(out)]) == 0
    model = Detector(config.tiny_config())
    assert ckpt.restore(str(out), model) == (80, 0, -1)
    with pytest.raises(ValueError):            # no optimizer state
        ckpt.restore(str(out), model, optim.make_optimizer(
            model, config.tiny_config().train, 10))
    sd_port = model.state_dict()
    for tree in (params, state):
        for k, v in weights._flatten(
                {m: tree[m] for m in weights.MODULES if m in tree}).items():
            np.testing.assert_array_equal(sd_port[k].numpy(), v, err_msg=k)


@pytest.fixture(scope="module")
def tiny_split(tmp_path_factory):
    """A 4-scan tiny-range train split (2 steps an epoch at batch 2)."""
    root = tmp_path_factory.mktemp("split")
    synthetic.write_synthetic_kitti(
        str(root), n_train=4, n_val=0, seed=0,
        point_cloud_range=config.tiny_config().voxel.point_cloud_range,
        n_cars=(1, 3), n_ground=1200)
    return str(root)


def tiny_train_cfg(work_dir, **over):
    cfg = config.tiny_config()
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, checkpoint_interval=1,
                                       log_interval=1),
        data=dataclasses.replace(cfg.data, num_workers=0),
        work_dir=str(work_dir), **over)


def dataset(cfg, root):
    return kitti.KittiDataset(cfg, os.path.join(root, "training"),
                              os.path.join(root, "ImageSets", "train.txt"),
                              train=True)


@pytest.fixture()
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_state(a, b):
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k


def test_train_model_resume_is_bitwise(tmp_path, tiny_split, one_thread):
    """2 epochs in one call equal 1 epoch (epochs_per_run=1, the schedule
    still over 2), a resume and 1 more, bit for bit; cfg.resume_from
    takes precedence over the newest checkpoint in work_dir;
    eval_interval gates the callback."""
    cfg_a = tiny_train_cfg(tmp_path / "a")
    seen = []
    model_a, opt_a, step = loop.train_model(
        cfg_a, dataset(cfg_a, tiny_split), total_epochs=2, device="cpu",
        epoch_callback=lambda e, m: seen.append(e), eval_interval=2)
    assert step == 4 and seen == [1]
    cfg_b = tiny_train_cfg(tmp_path / "b")
    _, opt_b, step = loop.train_model(cfg_b, dataset(cfg_b, tiny_split),
                                      total_epochs=2, device="cpu",
                                      epochs_per_run=1)
    assert step == 2 and opt_b.count == 2
    assert [os.path.basename(p) for p in ckpt.list_checkpoints(
        cfg_b.work_dir)] == ["checkpoint_epoch_0.pt"]
    model_b, opt_b, step = loop.train_model(cfg_b, dataset(cfg_b, tiny_split),
                                            total_epochs=2, device="cpu",
                                            epochs_per_run=1)
    assert step == 4 and opt_b.count == 4
    assert_same_state(model_a, model_b)
    for k in opt_a.mu:
        assert torch.equal(opt_a.mu[k], opt_b.mu[k]), k
        assert torch.equal(opt_a.nu[k], opt_b.nu[k]), k
    # resume_from an older checkpoint: epoch 1 again, the same bits
    cfg_c = dataclasses.replace(cfg_b, resume_from=os.path.join(
        cfg_b.work_dir, "checkpoint_epoch_0.pt"))
    model_c, _, step = loop.train_model(cfg_c, dataset(cfg_c, tiny_split),
                                        total_epochs=2, device="cpu")
    assert step == 4
    assert_same_state(model_a, model_c)


def test_train_model_load_from(tmp_path, tiny_split):
    """cfg.load_from copies the parameters, not the BatchNorm buffers,
    and the run starts at step 0 with a fresh schedule."""
    cfg = tiny_train_cfg(tmp_path / "src")
    trained, _, _ = loop.train_model(cfg, dataset(cfg, tiny_split),
                                     total_epochs=1, device="cpu")
    src = ckpt.latest_checkpoint(cfg.work_dir)
    cfg2 = tiny_train_cfg(tmp_path / "dst", load_from=src)
    model, opt, step = loop.train_model(cfg2, dataset(cfg2, tiny_split),
                                        total_epochs=1, device="cpu",
                                        epochs_per_run=0)
    assert step == 0 and opt.count == 0
    fresh, trained_stats = bn_stats(Detector(cfg2)), bn_stats(trained)
    for k, v in model.named_parameters():
        assert torch.equal(v, dict(trained.named_parameters())[k]), k
    for k, v in bn_stats(model).items():
        assert torch.equal(v, fresh[k]), k
        if k.endswith(".mean"):
            assert not torch.equal(v, trained_stats[k]), k


def test_train_and_test_cli(tmp_path):
    """tools.train --epochs 2 --epochs_per_run 1 exits 75, its relaunch
    0, and its final checkpoint equals an uninterrupted run's bit for
    bit; tools.test then prints the AP table and writes result files."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cfgs = {}
    for name in ("split", "whole"):
        work = tmp_path / name
        data = str(work / "synthetic_kitti")
        cfgs[name] = tmp_path / f"{name}.py"
        cfgs[name].write_text(
            "import dataclasses\n"
            "from sassd_tpu.config import tiny_config\n"
            "_c = tiny_config()\n"
            "config = dataclasses.replace(\n"
            "    _c, data=dataclasses.replace(\n"
            f"        _c.data, num_workers=0, root={data!r}),\n"
            f"    work_dir={str(work)!r})\n")

    def start(*args):
        return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def run(*args):
        proc = start(*args)
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        return subprocess.CompletedProcess(args, proc.returncode, out, err)
    train = ["sassd_tpu_torch.tools.train"]
    flags = ["--device", "cpu", "--synthetic", "--epochs", "2"]
    whole = start(*train, str(cfgs["whole"]), *flags)
    try:
        res = run(*train, str(cfgs["split"]), *flags, "--epochs_per_run", "1")
        assert res.returncode == 75, res.stderr[-3000:]
        assert "epoch 1" not in res.stderr
        res = run(*train, str(cfgs["split"]), *flags, "--epochs_per_run", "1")
        assert res.returncode == 0, res.stderr[-3000:]
        assert "resumed from" in res.stderr
        _, err = whole.communicate(timeout=300)
    finally:
        whole.kill()
    assert whole.returncode == 0, err[-3000:]
    a = torch.load(str(tmp_path / "split" / "checkpoint_epoch_1.pt"))
    b = torch.load(str(tmp_path / "whole" / "checkpoint_epoch_1.pt"))
    assert a["step"] == b["step"] == 16
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 16
    for k in b["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in b["optimizer"]["mu"]:
        assert torch.equal(a["optimizer"]["mu"][k], b["optimizer"]["mu"][k])
    out = tmp_path / "results"
    res = run("sassd_tpu_torch.tools.test", str(cfgs["split"]),
              str(tmp_path / "split" / "checkpoint_epoch_1.pt"),
              "--device", "cpu", "--out", str(out))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Car AP@0.70, 0.70, 0.70" in res.stdout
    assert "3d   AP R11" in res.stdout
    assert sorted(os.listdir(out)) == [f"{i:06d}.txt" for i in range(16, 20)]


def tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_data_writers_match_jax(tmp_path, monkeypatch, capsys):
    """make_synth_corpus (scans, info files, GT database) and
    create_reduced_point_cloud write the JAX package's bytes."""
    roots = {k: str(tmp_path / k) for k in ("port", "jax")}
    argv = ["--n_train", "3", "--n_val", "1", "--seed", "4"]
    assert make_synth_corpus.main([roots["port"], *argv]) == 0
    monkeypatch.setattr(sys, "argv", ["make_synth_corpus.py", roots["jax"],
                                      *argv])
    load_jax_tool("make_synth_corpus").main()
    for root in roots.values():         # a raw scan per split sample
        t = os.path.join(root, "training")
        os.makedirs(os.path.join(t, "velodyne"))
        for f in os.listdir(os.path.join(t, "velodyne_reduced")):
            pts = np.fromfile(os.path.join(t, "velodyne_reduced", f),
                              np.float32).reshape(-1, 4)
            far = pts.copy()
            far[:, 0] *= -1.0            # behind the camera: cropped
            np.concatenate([pts, far]).tofile(os.path.join(t, "velodyne", f))
    create_data.create_reduced_point_cloud(roots["port"])
    jcreate.create_reduced_point_cloud(roots["jax"])
    got, ref = tree_bytes(roots["port"]), tree_bytes(roots["jax"])
    assert got.keys() == ref.keys()
    assert any(k.startswith("gt_database") for k in ref)
    for k in ref:
        assert got[k] == ref[k], k
