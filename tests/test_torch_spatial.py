"""Port parity of the spatial strategies across ranks (parallel/spatial.py,
parallel/mesh.py, the banded stage on ranks): gloo rank processes on the
CPU, on the tall tiny config of tests/test_spatial.py (H = 256, S = 2).

Four processes run this file as a script (`worker` at the bottom). One
launch runs every job, in two rounds:

1. two groups of two ranks side by side, each a 1 x 2 layout (one data
   row of two spatial ranks): ranks 0 and 1 run ``strategy="spatial"``,
   ranks 2 and 3 ``"banded"``, each forward_test at batch 2 and one train
   step at global batch 2 from the JAX weights of test_torch_banded.py.
   The spatial run is held to the JAX package's unsharded forward_test
   and to jax.grad of its forward_train (the spatial strategy is the
   replicated model by definition, tests/test_spatial.py:16-36), the
   banded run to forward_test_banded and jax.grad of
   forward_train_banded(mesh=None): detections at tests/test_spatial.py's
   tolerances (boxes 2e-3, valid equal), losses at test_torch_train.py's
   1e-4, BatchNorm state at test_torch_multiprocess.py's (1e-4 / 1e-5)
   and at test_torch_banded.py's for the banded run (2e-3 / 1e-5).
   Gradients at test_torch_train.py's 1e-3 relative L2 per leaf, through
   the port's single-process float64 step: this batch puts one
   pre-activation of BEVNet's sixth BatchNorm within 1e-6 of 0, and
   float32 rounding sends it to either side of its ReLU (JAX's step and
   the banded pair cross it, the port's single process and the spatial
   pair do not), which moves the vxnet and bevnet gradients by 1.2e-2.
   So the ranks' gradients are held at 1e-3 to the float64 step with the
   pre-activations they crossed moved to their side (and the spatial
   pair's also to the single-process float32 step), JAX's to the float64
   step with some choice of its near-zero pre-activations crossed, and
   the ranks' directly to JAX's at 1e-3 but 2e-2 for vxnet and bevnet
   (test_torch_banded.py's tolerances). Then two ranks run tools.test
   with a "spatial" config file, against evaluate in one process. The
   spatial pair also runs forward_test and one train step with
   model.compute_dtype="bfloat16", held to the same in one process
   (detections as sets, boxes 1e-2 and scores 1e-3; losses 1e-2);
2. one group of four ranks, a 2 x 2 banded layout: one float64 train
   step on a global batch of 2 whose samples have different positive
   counts, held to the port's single-process banded step within 1e-6
   relative (losses, gradients, BatchNorm buffers, parameters after
   AdamW) with the four replicas bitwise equal; the collectives
   (halo_exchange over the four ranks, gather_rows over the world and
   over a data row) against one tensor's padding and autograd;
   train_model for 2 steps (replicas bitwise equal, rank 0 alone writes
   checkpoints); evaluate against one process.

Every worker and process group has a timeout (WORKER_TIMEOUT_S,
GROUP_TIMEOUT_S); the workers run one intra-op thread, as the replicas
are compared bitwise.
"""
import contextlib
import dataclasses
import itertools
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_multiprocess import (  # noqa: E402
    ADDR_IN_USE, _flat, _free_port, _numpy, drop_first_gt, float64_training)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# hang guards, sized for a loaded machine (under the six-worker tier-1
# run the module's fixture took ~290 s where it takes ~40 s alone); round
# 2's rendezvous waits for the slower pair of round 1
WORKER_TIMEOUT_S = 600      # each worker process, every job included
GROUP_TIMEOUT_S = 300       # every collective of a process group
S = 2
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3
JAX_F32_GRAD_RTOL = {"vxnet": 2e-2, "bevnet": 2e-2}
BN_TOL = {"spatial": (1e-4, 1e-5), "banded": (2e-3, 1e-5)}
BOX_ATOL = 2e-3
F64_RTOL = 1e-6
KINK_ATOL = 1e-5    # a float64 pre-activation float32 rounding may cross
MODULES = ("vxnet", "bevnet", "head", "pswarp", "aux")
TALL_RANGE = (0.0, -12.8, -2.5, 6.4, 12.8, 1.5)


def tall(strategy="banded", spatial=S):
    """test_torch_banded.tall() under `strategy` over `spatial` ranks."""
    from sassd_tpu_torch import config
    cfg = config.tiny_config()
    return dataclasses.replace(
        cfg,
        voxel=config.VoxelConfig(voxel_size=(0.1, 0.1, 0.5),
                                 point_cloud_range=TALL_RANGE,
                                 max_num_points=5, max_voxels=1024),
        caps=dataclasses.replace(cfg.caps,
                                 level_caps=(1024, 4096, 4096, 4096)),
        parallel=config.ParallelConfig(strategy=strategy, spatial=spatial),
        train=dataclasses.replace(cfg.train, batch_size=2, log_interval=1,
                                  checkpoint_interval=1),
        data=dataclasses.replace(cfg.data, num_workers=0))


def tall_batch(seed, make=None, cfg=None):
    from sassd_tpu_torch.data import synthetic
    make = make or synthetic.make_random_batch
    return {k: v for k, v in make(cfg or tall(), np.random.default_rng(seed),
                                  batch_size=2, n_points=900).items()
            if not k.startswith("plan_")}


def collective_case(rank: int, world: int, h: int):
    """A float64 [2, 3, world * h, 5] tensor, rank `rank`'s rows of it,
    and that rank's cotangents of its halo-padded slice and of the
    gathered whole."""
    rng = np.random.default_rng(h)
    full = rng.normal(size=(2, 3, world * h, 5))
    rng = np.random.default_rng(100 * h + rank)
    return (full, full[:, :, rank * h:(rank + 1) * h],
            rng.normal(size=(2, 3, h + 2, 5)),
            rng.normal(size=full.shape))


def write_split(root):
    from sassd_tpu_torch.data import synthetic
    synthetic.write_synthetic_kitti(root, n_train=4, n_val=3, seed=0,
                                    point_cloud_range=TALL_RANGE,
                                    n_cars=(1, 3), n_ground=1200)


def datasets(root):
    from sassd_tpu_torch.data import kitti
    cfg = tall()
    train = kitti.KittiDataset(cfg, os.path.join(root, "training"),
                               os.path.join(root, "ImageSets", "train.txt"),
                               train=True)
    val = kitti.KittiDataset(cfg, os.path.join(root, "training"),
                             os.path.join(root, "ImageSets", "val.txt"))
    return train, val


def bev_hooks(model, pre=None, cross=()):
    """Forward hooks on BEVNet's BatchNorms, the inputs of its ReLUs:
    record each output into `pre` (NCHW numpy, this rank's rows), and
    move each pre-activation that `cross` names ((BatchNorm, index)
    pairs) to the other side of 0 by twice its value, its derivative
    kept."""
    from sassd_tpu_torch.models import bev

    def hook(name):
        def run(module, args, out):
            for n, idx in cross:
                if n == name:
                    shift = torch.zeros_like(out)
                    shift[idx] = -2 * out[idx].detach()
                    out = out + shift
            if pre is not None:
                pre[name] = out.detach().numpy().copy()
            return out
        return run
    for i in range(bev.N_CONV + 1):
        getattr(model.bevnet, f"bn{i}").register_forward_hook(
            hook(f"bn{i}"))


def port_step(cfg, params, state, batch, pre=None, cross=(), f64=True):
    """One float64 (`f64` False: float32) make_train_step from the JAX
    weights: (metrics, the gradients, the BatchNorm state, the parameters
    after the update). `pre`, `cross`: bev_hooks."""
    from sassd_tpu_torch import weights
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.train import loop, optim
    with float64_training() if f64 else contextlib.nullcontext():
        model = weights.from_jax(cfg, params, state, "cpu")
        model = model.double() if f64 else model
        bev_hooks(model, pre, cross)
        opt = optim.make_optimizer(model, cfg.train, 100)
        metrics = loop.make_train_step(cfg, kitti.build_anchors(cfg)[0],
                                       opt, "cpu")(model, batch)
    return ({k: float(v) for k, v in metrics.items()},
            _flat(weights.grads_to_jax(model)),
            _flat(weights.to_jax(model)[1]),
            _numpy(dict(model.named_parameters())))


# ---------------------------------------------------------------- worker

def bf16_jobs(cfg, params, state, test_batch, train_batch):
    """forward_test and the metrics of one train step of `cfg` with
    model.compute_dtype="bfloat16" (the spatial pair runs it on two
    ranks, the fixture in one process)."""
    from sassd_tpu_torch import inference, weights
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.train import loop, optim
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    anchors = kitti.build_anchors(cfg)[0]
    model = weights.from_jax(cfg, params, state, "cpu")
    dets = inference.make_test_step(cfg, anchors, "cpu")(model, test_batch)
    model = weights.from_jax(cfg, params, state, "cpu")
    opt = optim.make_optimizer(model, cfg.train, 100)
    metrics = loop.make_train_step(cfg, anchors, opt, "cpu")(model,
                                                             train_batch)
    return dict(dets={k: v.numpy() for k, v in dets.items()},
                metrics={k: float(v) for k, v in metrics.items()})


def pair_jobs(strategy, job):
    """forward_test and one float32 train step of a 1 x 2 layout (the
    spatial pair also in bfloat16, bf16_jobs)."""
    from sassd_tpu_torch import inference, weights
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.parallel import mesh
    from sassd_tpu_torch.train import loop, optim
    cfg = tall(strategy)
    lay = mesh.layout(cfg)
    assert (lay.data, lay.spatial) == (1, S)
    anchors = kitti.build_anchors(cfg)[0]
    model = weights.from_jax(cfg, job["params"], job["state"], "cpu")
    dets = inference.make_test_step(cfg, anchors, "cpu")(model,
                                                         job["test_batch"])
    model = weights.from_jax(cfg, job["params"], job["state"], "cpu")
    pre = {}
    bev_hooks(model, pre)
    opt = optim.make_optimizer(model, cfg.train, 100)
    metrics = loop.make_train_step(cfg, anchors, opt, "cpu")(
        model, job["train_batch"])
    out = dict(dets={k: v.numpy() for k, v in dets.items()},
               metrics={k: float(v) for k, v in metrics.items()},
               grads=weights.grads_to_jax(model),
               state=weights.to_jax(model)[1], pre=pre,
               f64=port_step(cfg, job["params"], job["state"],
                             job["train_batch"]))
    if strategy == "spatial":
        out["bf16"] = bf16_jobs(cfg, job["params"], job["state"],
                                job["test_batch"], job["train_batch"])
    return out


def collective_jobs(rank: int):
    """halo_exchange over the four ranks, gather_rows over the world and
    over this rank's data row (2 x 2 layout): outputs and input
    gradients."""
    from sassd_tpu_torch.parallel import dist, mesh
    out = {}
    lay = mesh.layout(tall())
    for h in (1, 3):
        _, x, c_halo, _ = collective_case(rank, 4, h)
        x = torch.from_numpy(x).requires_grad_()
        y = dist.halo_exchange(x, 2, None)
        (y * torch.from_numpy(c_halo)).sum().backward()
        out[("halo", h)] = (y.detach().numpy(), x.grad.numpy())
        for name, group, n, r in (("world", None, 4, rank),
                                  ("row", lay.spatial_group, S,
                                   lay.spatial_index)):
            _, x, _, c_full = collective_case(r, n, h)
            x = torch.from_numpy(x).requires_grad_()
            y = dist.gather_rows(x, 2, group)
            (y * torch.from_numpy(c_full)).sum().backward()
            out[(name, h)] = (y.detach().numpy(), x.grad.numpy())
    return out


def worker(rank: int, ports, job_path: str, out: str):
    """One of four ranks: round 1 in a pair, round 2 in the 2 x 2 group
    (see the module docstring); writes out/rank{r}.pkl."""
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from sassd_tpu_torch import inference
    from sassd_tpu_torch.parallel import dist, mesh
    from sassd_tpu_torch.train import loop

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    res = {}
    pair, prank = divmod(rank, 2)
    strategy = ("spatial", "banded")[pair]
    dist.initialize(f"localhost:{ports[pair]}", 2, prank, device="cpu",
                    timeout_s=GROUP_TIMEOUT_S)
    res["pair"] = dict(strategy=strategy, **pair_jobs(strategy, job))
    dist.shutdown()

    dist.initialize(f"localhost:{ports[2]}", 4, rank, device="cpu",
                    timeout_s=GROUP_TIMEOUT_S)
    cfg = tall()
    lay = mesh.layout(cfg)
    assert lay[:4] == (2, S, rank // S, rank % S), lay
    res["collectives"] = collective_jobs(rank)
    d = lay.data_index
    local = {k: v[d:d + 1] for k, v in job["f64_batch"].items()}
    res["f64"] = port_step(cfg, job["params"], job["state"], local)

    train_ds, val_ds = datasets(job["root"])
    steps = []
    make_step = loop.make_train_step

    def recording(cfg, anchors, opt, device):
        step = make_step(cfg, anchors, opt, device)

        def run(model, batch):
            m = step(model, batch)
            steps.append(dict(metrics={k: float(v) for k, v in m.items()},
                              model=_numpy(model.state_dict()),
                              batch=batch))
            return m
        return run
    loop.make_train_step = recording
    try:
        model, _, n = loop.train_model(cfg, train_ds,
                                       os.path.join(out, f"w{rank}"),
                                       total_epochs=1, device="cpu",
                                       resume=False)
    finally:
        loop.make_train_step = make_step
    res["train"] = dict(step=n, steps=steps)

    gathered = []
    gather = dist.gather_objects

    def keep(obj, *args, **kw):
        parts = gather(obj, *args, **kw)
        gathered.append(parts)
        return parts
    dist.gather_objects = keep
    from sassd_tpu_torch import weights
    model = weights.from_jax(cfg, job["params"], job["state"], "cpu")
    results, text = inference.evaluate(
        cfg, val_ds, model, os.path.join(job["root"], "training", "label_2"),
        1, "cpu", exchange_dir=os.path.join(out, "exchange"))
    res["eval"] = dict(results=results, text=text, parts=gathered[0])

    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.shutdown()
    print(f"rank {rank}: done", flush=True)


CLI_CONFIG = """import dataclasses
from sassd_tpu.config import ParallelConfig, VoxelConfig, tiny_config
_c = tiny_config()
config = dataclasses.replace(
    _c,
    voxel=VoxelConfig(voxel_size=(0.1, 0.1, 0.5),
                      point_cloud_range={range!r},
                      max_num_points=5, max_voxels=1024),
    caps=dataclasses.replace(_c.caps, level_caps=(1024, 4096, 4096, 4096)),
    parallel=ParallelConfig(strategy="spatial", spatial={spatial}),
    data=dataclasses.replace(_c.data, num_workers=0, root={root!r}),
    work_dir={work!r})
"""


def start(job: dict, tmp_path, attempt: int):
    """Start the four workers and, beside them, tools.test over two gloo
    ranks with a "spatial" config file (out/cli.py; each rank's --out
    is out/results{r}); returns (procs, out directory)."""
    job_path = str(tmp_path / "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    out = tmp_path / f"out{attempt}"
    out.mkdir()
    (out / "cli.py").write_text(CLI_CONFIG.format(
        range=TALL_RANGE, spatial=S, root=job["root"],
        work=str(out / "cli_work")))
    ports = [str(_free_port()) for _ in range(4)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    workers = [[sys.executable, os.path.abspath(__file__), str(r),
                *ports[:3], job_path, str(out)] for r in range(4)]
    cli = [[sys.executable, "-m", "sassd_tpu_torch.tools.test",
            str(out / "cli.py"), job["checkpoint"], "--device", "cpu",
            "--coordinator", f"localhost:{ports[3]}", "--num_processes",
            str(S), "--process_id", str(r), "--out",
            str(out / f"results{r}")] for r in range(S)]
    return [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd in workers + cli], out


def finish(procs, deadline):
    """Wait for the workers until `deadline`; returns their logs (killing
    all at the deadline fails the test)."""
    try:
        return [p.communicate(timeout=max(deadline - time.time(), 1))[0]
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[0] for p in procs]
        pytest.fail("a worker outlived its timeout:\n"
                    + "\n".join(log[-3000:] for log in logs))


# ----------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four-rank launch, and meanwhile the JAX references of round 1
    and the port's single-process references of round 2."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from sassd_tpu.data.synthetic import make_random_batch as jax_batch
    from sassd_tpu.models import detector as jdetector
    from sassd_tpu.parallel import sparse_spatial as jss
    from sassd_tpu_torch import inference, weights
    from sassd_tpu_torch.core import boxes as box_ops
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.models import pswarp, ssd_head
    from sassd_tpu_torch.models.detector import Detector
    from test_spatial import _tall_config
    from test_torch_train_device_plans import jax_weights, leaves

    from sassd_tpu_torch import config
    from sassd_tpu_torch.train import checkpoint as ckpt

    tmp = tmp_path_factory.mktemp("spatial")
    root = str(tmp / "kitti")
    write_split(root)
    jcfg = _tall_config()
    params, state = jax_weights(jcfg)
    f64_batch = drop_first_gt(tall_batch(3))
    checkpoint = str(tmp / "cli.pt")
    ckpt.write(checkpoint, weights.from_jax(tall("spatial"), params, state,
                                            "cpu"), None, 0, 0)
    job = dict(params=params, state=state, root=root,
               test_batch=tall_batch(5), train_batch=tall_batch(3),
               f64_batch=f64_batch, checkpoint=checkpoint)
    for attempt in range(3):
        procs, out = start(job, tmp, attempt)
        deadline = time.time() + WORKER_TIMEOUT_S
        if attempt == 0:
            ref = jax_references(jax, jnp, jdetector, jss, jcfg, params,
                                 state, jax_batch, leaves)
        logs = finish(procs, deadline)
        if all(p.returncode == 0 for p in procs):
            break
        taken = any(s in log.lower() for log in logs for s in ADDR_IN_USE)
        if not taken or attempt == 2:
            bad = next(log for p, log in zip(procs, logs) if p.returncode)
            pytest.fail(f"worker failed:\n{bad[-4000:]}")
    got = []
    for r in range(4):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))

    # the port's single-process steps of round 1's batch: float64, with
    # the BEVNet pre-activations the ranks crossed moved to their side,
    # with each choice of the near-zero ones crossed (for JAX's), and
    # float32 replicated
    for strategy in ("spatial", "banded"):
        r, cfg, pre = ref[strategy], tall(strategy), {}
        step = lambda **kw: port_step(cfg, params, state,  # noqa: E731
                                      job["train_batch"], **kw)
        r["f64"] = step(pre=pre)
        pair = [g["pair"] for g in got if g["pair"]["strategy"] == strategy]
        theirs = {n: np.concatenate([g["pre"][n] for g in pair], 2)
                  for n in pre}
        r["crossed"] = [(n, tuple(int(i) for i in idx))
                        for n in pre for idx in np.argwhere(
                            (theirs[n] > 0) != (pre[n] > 0))]
        r["crossed_values"] = [(pre[n][i], theirs[n][i])
                               for n, i in r["crossed"]]
        near = [(n, tuple(int(i) for i in idx)) for n in pre
                for idx in np.argwhere(np.abs(pre[n]) < KINK_ATOL)]
        assert len(near) <= 3, near
        r["kink_steps"] = {
            cross: step(cross=cross)[1] if cross else r["f64"][1]
            for k in range(len(near) + 1)
            for cross in itertools.combinations(near, k)}
        r["aligned"] = r["kink_steps"].get(tuple(r["crossed"])) or step(
            cross=r["crossed"])[1]
    ref["spatial"]["f32"] = port_step(tall("spatial"), params, state,
                                      job["train_batch"], f64=False)[1]
    ref["spatial"]["bf16"] = bf16_jobs(tall("spatial"), params, state,
                                       job["test_batch"],
                                       job["train_batch"])

    # tools.test over two ranks against evaluate in one process
    cli = config.load_config(str(out / "cli.py"))
    for field in ("voxel", "caps", "parallel", "model"):
        assert getattr(cli, field) == getattr(tall("spatial"), field), field
    model = Detector(cli)
    ckpt.restore(checkpoint, model)
    ref["cli"] = inference.evaluate(
        cli, kitti.KittiDataset(cli, os.path.join(root, "training"),
                                os.path.join(root, "ImageSets", "val.txt")),
        model, os.path.join(root, "training", "label_2"), 1, "cpu")

    # round 2's references: the banded float64 step, the samples'
    # positive counts, and evaluate
    cfg = tall()
    ref["f64"] = port_step(cfg, params, state, f64_batch)
    model = weights.from_jax(cfg, params, state, "cpu")
    model.train()
    tb = inference.to_device(f64_batch, "cpu")
    at = torch.from_numpy(kitti.build_anchors(cfg)[0])
    with torch.no_grad():
        spine = model.forward_spine(tb)
        labels, _ = box_ops.aux_targets(spine.points_mean,
                                        spine.points_valid,
                                        torch.cat([tb["gt_boxes"]] * S),
                                        torch.cat([tb["gt_valid"]] * S))
        own = (labels & spine.points_valid).sum(1).reshape(S, 2).sum(0)
        ga = ssd_head.get_guided_anchors(
            model.head(spine.bev_map), at, tb["anchors_mask"], num_class=1,
            thr=cfg.train.anchor_thr, cap=cfg.caps.guided_train,
            gt_boxes=tb["gt_boxes"], gt_labels=tb["gt_classes"],
            gt_valid=tb["gt_valid"])
        warp = (pswarp.pswarp_labels(ga.boxes, ga.valid, tb["gt_boxes"],
                                     tb["gt_valid"]) > 0).sum(1)
    ref["positives"] = (own.tolist(), warp.tolist())
    train_ds, val_ds = datasets(root)
    ref["global_batches"] = [b for b, _ in kitti_batches(train_ds)]
    model = weights.from_jax(cfg, params, state, "cpu")
    annos, ids = inference.run_inference(cfg, val_ds, model, 1, "cpu")
    ref["eval"] = inference.evaluate(
        cfg, val_ds, None, os.path.join(root, "training", "label_2"),
        precomputed=(annos, ids))
    ref["annos"] = inference._dedup_by_id(annos, ids)
    return dict(ranks=got, ref=ref, out=out, leaves=leaves, cli=logs[4:])


def kitti_batches(ds):
    from sassd_tpu_torch.data import loader
    cfg = tall()
    return list(loader.iterate_batches(ds, cfg.train.batch_size, epoch=0,
                                       seed=cfg.train.seed, shuffle=True,
                                       num_workers=0))


def jax_references(jax, jnp, jdetector, jss, jcfg, params, state,
                   jax_batch, leaves):
    """Round 1's references: the JAX package's unsharded forward_test and
    jax.grad of forward_train (the spatial strategy's), and its
    forward_test_banded and jax.grad of forward_train_banded."""
    from sassd_tpu_torch.data import kitti
    anchors = jnp.asarray(kitti.build_anchors(tall())[0])
    spec = jss.make_band_spec(jcfg, S)

    def batch(seed):
        return {k: jnp.asarray(v) for k, v in tall_batch(
            seed, jax_batch, jcfg).items()}
    out = {}
    for strategy, fwd_train, fwd_test in (
            ("spatial", lambda p, b: jdetector.forward_train(
                p, state, b, anchors, jcfg),
             lambda b: jdetector.forward_test(params, state, b, anchors,
                                              jcfg)),
            ("banded", lambda p, b: jss.forward_train_banded(
                p, state, b, anchors, jcfg, spec),
             lambda b: jss.forward_test_banded(params, state, b, anchors,
                                               jcfg, spec))):
        dets = jax.jit(fwd_test)(batch(5))
        tb = batch(3)

        def loss_fn(p):
            losses, new_state = fwd_train(p, tb)
            return jdetector.parse_losses(losses)[0], (losses, new_state)
        grads, (losses, new_state) = jax.jit(
            jax.grad(loss_fn, has_aux=True))(params)
        out[strategy] = dict(
            dets={k: np.asarray(v) for k, v in dets.items()},
            losses={k: float(v) for k, v in losses.items()},
            grads=leaves(grads), state=leaves(new_state))
    return out


def pair_results(ranks, strategy):
    got = [r["pair"] for r in ranks["ranks"] if r["pair"]["strategy"]
           == strategy]
    assert len(got) == 2
    return got


def rel_l2(got, ref) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref)
                 / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("strategy", ["spatial", "banded"])
def test_pair_detections_match_jax(ranks, strategy):
    """forward_test over one data row of two spatial ranks == the JAX
    package's (unsharded for "spatial", forward_test_banded for
    "banded"): valid flags equal, boxes within 2e-3; the two ranks'
    detections bitwise equal."""
    ref = ranks["ref"][strategy]["dets"]
    a, b = (r["dets"] for r in pair_results(ranks, strategy))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["valid"], ref["valid"])
    v = ref["valid"]
    assert v.sum() > 0
    np.testing.assert_allclose(a["boxes"][v], ref["boxes"][v],
                               atol=BOX_ATOL)
    np.testing.assert_allclose(a["scores"][v], ref["scores"][v],
                               atol=BOX_ATOL)


@pytest.mark.parametrize("strategy", ["spatial", "banded"])
def test_pair_step_losses_and_bn_match_jax(ranks, strategy):
    """The reduced losses of one train step on two spatial ranks == JAX's
    over the whole batch (1e-4 relative), and the BatchNorm state after
    it; band_overflow 0."""
    ref = ranks["ref"][strategy]
    rtol, atol = BN_TOL[strategy]
    for r in pair_results(ranks, strategy):
        for k, v in ref["losses"].items():
            if "loss" in k:
                assert np.isfinite(v) and v != 0.0, k
            np.testing.assert_allclose(r["metrics"][k], v, rtol=LOSS_RTOL,
                                       err_msg=k)
        assert r["metrics"]["nonfinite_skips"] == 0.0
        got = ranks["leaves"](r["state"])
        assert got.keys() == ref["state"].keys()
        for k, v in ref["state"].items():
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("strategy", ["spatial", "banded"])
@pytest.mark.parametrize("module", MODULES)
def test_pair_step_grads_match_jax(ranks, strategy, module):
    """The step's reduced gradient of every leaf of the module against
    jax.grad over the whole batch: 1e-3 relative L2, 2e-2 for vxnet and
    bevnet (test_torch_banded.py's: JAX's float32 step crosses a ReLU
    kink the spatial pair does not, see the two tests below); the ranks'
    gradients bitwise equal."""
    ref = {k: v for k, v in ranks["ref"][strategy]["grads"].items()
           if k.startswith(f"['{module}']")}
    assert ref
    a, b = (ranks["leaves"](r["grads"])
            for r in pair_results(ranks, strategy))
    tol = JAX_F32_GRAD_RTOL.get(module, GRAD_RTOL)
    for k, v in ref.items():
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.linalg.norm(v) > 0, k
        err = rel_l2(a[k], v)
        assert err <= tol, (k, err)


def test_spatial_pair_bf16_matches_single_process(ranks):
    """model.compute_dtype="bfloat16" over one data row of two spatial
    ranks against one process: forward_test's detections as sets (boxes
    1e-2, scores 1e-3, tests/test_torch_detector.py's), and the reduced
    losses of one train step within 1e-2 relative (two bfloat16 steps
    that differ only in their float32 sums' order; see
    tests/test_torch_bf16.py); the two ranks bitwise equal."""
    ref = ranks["ref"]["spatial"]["bf16"]
    a, b = (r["bf16"] for r in pair_results(ranks, "spatial"))
    for k in a["dets"]:
        np.testing.assert_array_equal(a["dets"][k], b["dets"][k], err_msg=k)
    assert a["metrics"] == b["metrics"]
    got, want = a["dets"], ref["dets"]
    for i in range(2):
        gv, rv = got["valid"][i], want["valid"][i]
        assert gv.sum() == rv.sum() > 0
        rb, rs = want["boxes"][i][rv], want["scores"][i][rv]
        used = np.zeros(len(rb), bool)
        for bx, sc in zip(got["boxes"][i][gv], got["scores"][i][gv]):
            ok = ((np.abs(rb - bx).max(1) <= 1e-2)
                  & (np.abs(rs - sc) <= 1e-3) & ~used)
            assert ok.any(), (bx, sc)
            used[np.argmax(ok)] = True
    for k, v in ref["metrics"].items():
        if "loss" in k:
            assert np.isfinite(v) and v != 0.0, k
            np.testing.assert_allclose(a["metrics"][k], v, rtol=1e-2,
                                       err_msg=k)
    assert a["metrics"]["nonfinite_skips"] == 0.0


def dotted(key: str) -> str:
    """A JAX key path "['a']['b']" as the port's flat name "a.b"."""
    return key.replace("']['", ".").strip("[]'")


@pytest.mark.parametrize("strategy", ["spatial", "banded"])
def test_pair_relu_crossings_lie_at_zero(ranks, strategy):
    """Where the ranks' float32 step and the single-process float64 step
    put a BEVNet pre-activation on opposite sides of its ReLU, both values
    lie within KINK_ATOL of 0: float32 rounding at a kink, not a wrong
    sum or a misplaced halo row."""
    ref = ranks["ref"][strategy]
    assert len(ref["crossed"]) <= 3, ref["crossed"]
    for (n, i), (f64, f32) in zip(ref["crossed"], ref["crossed_values"]):
        assert abs(f64) < KINK_ATOL and abs(f32) < KINK_ATOL, (n, i, f64, f32)


@pytest.mark.parametrize("strategy", ["spatial", "banded"])
@pytest.mark.parametrize("module", MODULES)
def test_pair_step_grads_match_single_process(ranks, strategy, module):
    """The ranks' float32 gradients of every leaf of the module within
    test_torch_train.py's 1e-3 relative L2 of the port's single-process
    float64 step with the BEVNet pre-activations the ranks crossed (test
    above) moved to their side, and under "spatial" also of its float32
    replicated step."""
    ref = ranks["ref"][strategy]
    refs = [ref["aligned"]] + ([ref["f32"]] if strategy == "spatial" else [])
    got = _flat(pair_results(ranks, strategy)[0]["grads"])
    keys = [k for k in refs[0] if k.startswith(f"{module}.")]
    assert keys
    for want in refs:
        for k in keys:
            assert np.linalg.norm(want[k]) > 0, k
            err = rel_l2(got[k], want[k])
            assert err <= GRAD_RTOL, (k, err)


@pytest.mark.parametrize("strategy", ["spatial", "banded"])
def test_jax_step_grads_match_single_process_at_a_kink(ranks, strategy):
    """JAX's float32 gradients (jax.grad of the strategy's forward_train)
    within 1e-3 relative L2 per leaf of the port's single-process float64
    step with some choice of its BEVNet pre-activations within KINK_ATOL
    of 0 crossed: the float32 kink behind the 2e-2 of
    test_pair_step_grads_match_jax, in JAX's step as in the ranks'."""
    ref = ranks["ref"][strategy]
    jax_grads = {dotted(k): v for k, v in ref["grads"].items()}

    def worst(grads):
        assert grads.keys() == jax_grads.keys()
        return max(rel_l2(v, grads[k]) for k, v in jax_grads.items())
    errs = {cross: worst(g) for cross, g in ref["kink_steps"].items()}
    assert min(errs.values()) <= GRAD_RTOL, errs


def test_cli_evaluates_over_spatial_ranks(ranks):
    """tools.test over two gloo ranks with a "spatial" config file (one
    data row): both exit 0, rank 0 prints the AP tables of evaluate in one
    process, rank 1 prints none, and only rank 0 (spatial index 0) writes
    result files, one per val scan."""
    _, text = ranks["ref"]["cli"]
    assert "Car AP@" in text
    r0, r1 = ranks["cli"]
    assert text in r0, r0[-3000:]
    assert "AP@" not in r1, r1[-3000:]
    out = ranks["out"]
    assert sorted(os.listdir(out / "results0")) == [
        f"{i:06d}.txt" for i in ranks["ref"]["annos"][1]]
    assert not (out / "results1").exists()


def test_f64_batch_samples_have_different_positive_counts(ranks):
    """Per-row normalisers would differ from the global ones here."""
    aux, warp = ranks["ref"]["positives"]
    assert min(aux) > 0 and aux[0] != aux[1], aux
    assert min(warp) > 0 and warp[0] != warp[1], warp


PARTS = ("metrics", "grads", "state", "params")


@pytest.mark.parametrize("strategy", ["spatial", "banded"])
@pytest.mark.parametrize("part", PARTS)
def test_pair_float64_step_matches_single_process(ranks, strategy, part):
    """One data row of two spatial ranks, one float64 step: the reduced
    losses and metrics, the gradients, the BatchNorm buffers and the
    parameters after AdamW within 1e-6 relative of the single-process
    step of the same strategy; the two replicas bitwise equal. (In
    float32 this batch sits at a ReLU kink: one pre-activation of
    BEVNet's sixth conv lies within 1e-5 of 0, and float32 rounding, JAX's
    and the banded pair's alike, sends it to the other side, which moves
    the vxnet and bevnet gradients by up to 1.3e-2.)"""
    check_f64_step(ranks["ref"][strategy]["f64"][PARTS.index(part)],
                   [r["f64"][PARTS.index(part)]
                    for r in pair_results(ranks, strategy)], part)


@pytest.mark.parametrize("part", PARTS)
def test_2x2_banded_step_matches_single_process(ranks, part):
    """Four ranks in a 2 x 2 banded layout, one float64 step: the reduced
    losses and metrics, the gradients, the BatchNorm buffers and the
    parameters after AdamW within 1e-6 relative of the single-process
    banded step; the four replicas bitwise equal."""
    check_f64_step(ranks["ref"]["f64"][PARTS.index(part)],
                   [r["f64"][PARTS.index(part)] for r in ranks["ranks"]],
                   part)


def check_f64_step(ref, got, part):
    """The ranks' `part` of port_step (dicts) bitwise equal, and rank 0's
    within 1e-6 of the single-process `ref` (relative L2 per gradient
    leaf)."""
    for g in got[1:]:
        assert g.keys() == got[0].keys()
        for k in g:
            np.testing.assert_array_equal(g[k], got[0][k], err_msg=k)
    assert got[0].keys() == ref.keys()
    for k, v in ref.items():
        if part == "metrics":
            assert got[0][k] == pytest.approx(v, rel=F64_RTOL, abs=1e-12), k
            continue
        assert got[0][k].dtype == np.float64, k
        if part == "grads":
            assert rel_l2(got[0][k], v) <= F64_RTOL, k
        else:
            np.testing.assert_allclose(got[0][k], v, rtol=F64_RTOL,
                                       atol=1e-12, err_msg=k)
    if part == "metrics":
        assert ref.get("band_overflow", 0.0) == 0.0
        assert ref["nonfinite_skips"] == 0.0


@pytest.mark.parametrize("h", [1, 3])
def test_halo_exchange_matches_padding(ranks, h):
    """halo_exchange over four ranks == each rank's rows of the zero-padded
    whole (forward, bitwise); its backward == autograd of that slicing
    (each boundary row gets its own and the neighbours' halo gradients)."""
    full = torch.from_numpy(collective_case(0, 4, h)[0]).requires_grad_()
    padded = torch.nn.functional.pad(full, (0, 0, 1, 1))
    loss = 0
    for r, res in enumerate(ranks["ranks"]):
        y, _ = res["collectives"][("halo", h)]
        want = padded[:, :, r * h:r * h + h + 2]
        np.testing.assert_array_equal(y, want.detach().numpy())
        loss = loss + (want * torch.from_numpy(
            collective_case(r, 4, h)[2])).sum()
    loss.backward()
    for r, res in enumerate(ranks["ranks"]):
        _, g = res["collectives"][("halo", h)]
        np.testing.assert_allclose(
            g, full.grad[:, :, r * h:(r + 1) * h].numpy(), rtol=1e-14,
            atol=1e-14)


@pytest.mark.parametrize("group", ["world", "row"])
@pytest.mark.parametrize("h", [1, 3])
def test_gather_rows_matches_whole(ranks, group, h):
    """gather_rows over the world (4 ranks) or a data row (2 ranks of the
    2 x 2 layout) == the whole tensor on every rank (bitwise); its
    backward == the sum of every rank's cotangent over this rank's
    rows."""
    n = 4 if group == "world" else S
    for rank, res in enumerate(ranks["ranks"]):
        r = rank if group == "world" else rank % S
        members = range(4) if group == "world" else (
            range(rank - r, rank - r + S))
        y, g = res["collectives"][(group, h)]
        full = collective_case(r, n, h)[0]
        np.testing.assert_array_equal(y, full)
        cot = sum(collective_case(m if group == "world" else m % S, n,
                                  h)[3] for m in members)
        np.testing.assert_allclose(g, cot[:, :, r * h:(r + 1) * h],
                                   rtol=1e-14, atol=1e-14)


def test_2x2_train_model_replicas_and_checkpoints(ranks):
    """train_model over the 2 x 2 banded layout: 2 steps, every rank's
    replica bitwise equal before every step, each data row loads its
    sample of the single-process loader's global batch (the ranks of a
    row the same one), finite losses, no band overflow or skipped update,
    and only rank 0 writes checkpoints."""
    runs = [r["train"] for r in ranks["ranks"]]
    assert all(t["step"] == 2 and len(t["steps"]) == 2 for t in runs)
    for i in range(2):
        a = runs[0]["steps"][i]
        for t in runs[1:]:
            b = t["steps"][i]
            assert b["metrics"] == a["metrics"]
            for k, v in a["model"].items():
                np.testing.assert_array_equal(b["model"][k], v,
                                              err_msg=f"step {i} {k}")
        m = a["metrics"]
        assert all(np.isfinite(v) for v in m.values())
        assert m["band_overflow"] == 0.0 and m["nonfinite_skips"] == 0.0
        ref = ranks["ref"]["global_batches"][i]
        for rank, t in enumerate(runs):
            d = rank // S
            for k, v in ref.items():
                np.testing.assert_array_equal(t["steps"][i]["batch"][k],
                                              v[d:d + 1], err_msg=k)
    out = ranks["out"]
    assert [p.name for p in sorted((out / "w0").glob("*.pt"))] == [
        "checkpoint_epoch_0.pt"]
    for r in (1, 2, 3):
        assert not list((out / f"w{r}").glob("*.pt"))


def test_2x2_evaluate_matches_single_process(ranks):
    """evaluate over the 2 x 2 banded layout: rank 0 returns the
    single-process AP table over one copy of each data row's detections
    (the second rank of each row sends none); the other ranks return
    (None, "")."""
    from sassd_tpu_torch.inference import _dedup_by_id
    results, text = ranks["ref"]["eval"]
    r0 = ranks["ranks"][0]["eval"]
    for r in ranks["ranks"][1:]:
        assert (r["eval"]["results"], r["eval"]["text"],
                r["eval"]["parts"]) == (None, "", None)
    assert r0["text"] == text and "Car AP@" in text
    for k in results:
        np.testing.assert_array_equal(r0["results"][k], results[k],
                                      err_msg=k)
    parts = r0["parts"]
    assert [len(p[1]) for p in parts] == [2, 0, 2, 0]
    annos, ids = _dedup_by_id([a for p in parts for a in p[0]],
                              [i for p in parts for i in p[1]])
    ref_annos, ref_ids = ranks["ref"]["annos"]
    assert ids == ref_ids and len(ids) == 3
    assert sum(len(a["name"]) for a in annos) > 0
    for a, b in zip(annos, ref_annos):
        assert a.keys() == b.keys()
        for k in a:
            if a[k].dtype.kind == "f":
                np.testing.assert_allclose(a[k], b[k], atol=BOX_ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("strategy", ["spatial", "banded"])
def test_indivisible_world_is_refused(monkeypatch, strategy):
    """A world that parallel.spatial does not divide raises ValueError
    naming both numbers (check_supported, the layout, the entry points);
    a divisible one is accepted, and world size 1 runs as before."""
    from sassd_tpu_torch import config
    from sassd_tpu_torch.models.detector import Detector
    from sassd_tpu_torch.parallel import dist, mesh
    cfg = tall(strategy)
    for train in (False, True):
        config.check_supported(cfg, train=train)
    assert mesh.spatial_ranks(cfg) == 1
    monkeypatch.setattr(dist, "process_count", lambda: 3)
    for train in (False, True):
        with pytest.raises(ValueError, match="3 ranks.*spatial=2"):
            config.check_supported(cfg, train=train)
    with pytest.raises(ValueError, match="3 ranks.*spatial=2"):
        mesh.spatial_ranks(cfg)
    with pytest.raises(ValueError, match="3 ranks.*spatial=2"):
        Detector(cfg)
    monkeypatch.setattr(dist, "process_count", lambda: 4)
    config.check_supported(cfg, train=True)
    assert mesh.spatial_ranks(cfg) == S
    assert mesh.spatial_ranks(tall("data")) == 1


if __name__ == "__main__":
    worker(int(sys.argv[1]), [int(p) for p in sys.argv[2:5]], sys.argv[5],
           sys.argv[6])
