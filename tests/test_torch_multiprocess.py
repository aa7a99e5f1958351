"""Port parity of data-parallel training and evaluation over gloo process
groups on the CPU (the port's counterpart of tests/test_multihost.py).

Two ranks are two processes running this file as a script (`worker` at
the bottom). One launch of the pair runs three jobs in turn:

- one global train step on tiny_config() from the JAX weights of
  test_torch_train.py, its batch of two split 1 + 1 over the ranks: the
  all-reduced losses, the reduced gradients and the BatchNorm state
  against jax.grad of the JAX step over the whole batch (the tolerances
  of test_torch_train.py), and against the port's single-process step
  (1e-5 relative on the losses and the gradient norm). The two samples
  have different positive counts, both the PSWarp labels and the aux
  points, so a per-rank normaliser or a per-rank BatchNorm would fail;
- train_model, 2 epochs of 2 steps, over a synthetic KITTI split with
  the tiny config widened as tests/_mh_worker.py widens it: the ranks'
  replicas are bitwise equal before every step and at the end, the
  ranks' slices of each step make the single-process loader's global
  batch of 2, only rank 0 writes checkpoints, and the run ends within
  rtol 1e-6 / atol 1e-9 of the single-process batch-2 run (the JAX test
  holds its runs to rtol 1e-2 / atol 1.5e-3). Both runs are in float64
  (float64_training): in float32 the comparison measures the model's
  conditioning, not the reduction. Moving the parameters after the first
  step by 1e-7 (relative, random) moves some draws' next-step gradients
  by 0.6-1.8% relative L2, in this package and in the JAX package alike
  (tests/torch_dp_conditioning.py), and Adam turns such a jump into
  updates up to the learning rate (3e-3) apart: float32 sums in another
  order (the two ranks') can send the runs apart by more than the JAX
  test's tolerance. The float32 two-rank step is held to JAX and to the
  single-process step by the step job above;
- evaluate over a three-scan val split at batch 1 (padded to four, so a
  duplicate is dropped): rank 0 returns the single-process result and
  detections, rank 1 (None, "").

Every worker and process group has a timeout (WORKER_TIMEOUT_S,
GROUP_TIMEOUT_S). The workers run one intra-op thread, as does the
world-size-1 test: the CPU backward's parallel scatter-adds are not
bitwise repeatable from run to run, and the ranks' replicas and the
world-size-1 step are compared bitwise.
"""
import contextlib
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
WORKER_TIMEOUT_S = 120      # each worker process, every job included
GROUP_TIMEOUT_S = 60        # every collective of a process group
ADDR_IN_USE = ("address already in use", "eaddrinuse")
SINGLE_RTOL = 1e-5          # two ranks vs the single-process step
# two-rank vs single-process float64 runs, far inside the JAX test's
# rtol 1e-2 / atol 1.5e-3 (tests/test_multihost.py:135)
TRAIN_RTOL, TRAIN_ATOL = 1e-6, 1e-9


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mh_config():
    """tiny_config() widened to the synthetic KITTI scene extent, as
    tests/_mh_worker.py:mh_config widens the JAX one (the loader on the
    calling thread)."""
    from sassd_tpu_torch import config
    c = config.tiny_config()
    return dataclasses.replace(
        c,
        voxel=config.VoxelConfig(
            voxel_size=(0.4, 0.4, 0.5),
            point_cloud_range=(0, -40.0, -3.0, 70.4, 40.0, 1.0),
            max_num_points=5, max_voxels=4000),
        anchors={"Car": dataclasses.replace(
            c.anchors["Car"], strides=(3.2, 3.2, 1.0),
            offsets=(1.6, -38.4, -1.78))},
        train=dataclasses.replace(c.train, batch_size=2, seed=7,
                                  log_interval=1, checkpoint_interval=1),
        data=dataclasses.replace(c.data, num_workers=0),
    )


def eval_config():
    """mh_config() with a score threshold the briefly trained model's
    candidates pass, so evaluate has detections to compare."""
    c = mh_config()
    return dataclasses.replace(c, test=dataclasses.replace(c.test,
                                                           score_thr=0.05))


def _datasets(root):
    from sassd_tpu_torch.data import kitti
    train = kitti.KittiDataset(mh_config(), os.path.join(root, "training"),
                               os.path.join(root, "ImageSets", "train.txt"),
                               train=True)
    val = kitti.KittiDataset(eval_config(), os.path.join(root, "training"),
                             os.path.join(root, "ImageSets", "val.txt"))
    return train, val


def drop_first_gt(batch: dict) -> dict:
    """test_torch_train.py's batch with the second sample's first GT box
    invalid: each sample then has its own positive counts (the PSWarp
    positives are the prepended GT boxes, 3 in each sample otherwise)."""
    batch = dict(batch)
    for k in ("gt_valid", "gt_classes"):
        batch[k] = batch[k].copy()
        batch[k][1, 0] = 0
    return batch


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy() if torch.is_tensor(tree) else tree


@contextlib.contextmanager
def float64_training():
    """train_model's model and batches in float64 (the port's ops run in
    float64 on the CPU, as the float64 reference step of chip_smoke.py's
    phase 7 does)."""
    from sassd_tpu_torch import inference
    from sassd_tpu_torch.models.detector import Detector
    from sassd_tpu_torch.train import loop
    saved = loop.Detector, loop.to_device

    def to_device(batch, device):
        return {k: v.double() if v.is_floating_point() else v
                for k, v in inference.to_device(batch, device).items()}
    loop.Detector = lambda cfg, gen=None: Detector(cfg, gen).double()
    loop.to_device = to_device
    try:
        yield
    finally:
        loop.Detector, loop.to_device = saved


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    return {prefix.rstrip("."): np.asarray(tree)}


# ---------------------------------------------------------------- worker

def worker(rank: int, world: int, port: int, job_path: str, out: str):
    """One rank: join the gloo group, run the step, train and evaluate
    jobs of `job_path` and write what the tests read to out/rank{r}.pkl.
    """
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from sassd_tpu_torch import config, inference, weights
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.parallel import dist
    from sassd_tpu_torch.train import loop, optim

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dist.initialize(f"localhost:{port}", world, rank, device="cpu",
                    timeout_s=GROUP_TIMEOUT_S)
    assert dist.process_count() == world and dist.process_index() == rank
    res = {}

    # one global step, this rank's slice of the batch
    cfg = config.tiny_config()
    batch = job["batch"]
    lb = batch["voxels"].shape[0] // world
    local = {k: v[rank * lb:(rank + 1) * lb] for k, v in batch.items()}
    model = weights.from_jax(cfg, job["params"], job["state"], "cpu")
    opt = optim.make_optimizer(model, cfg.train, 100)
    metrics = loop.make_train_step(cfg, kitti.build_anchors(cfg)[0], opt,
                                   "cpu")(model, local)
    res["step"] = dict(metrics={k: float(v) for k, v in metrics.items()},
                       grads=weights.grads_to_jax(model),
                       state=weights.to_jax(model)[1])

    # train_model in float64, each rank with its own work_dir to see who
    # writes; the state and the local batch before every step are kept
    train_ds, val_ds = _datasets(job["root"])
    work = os.path.join(out, f"w{rank}")
    steps = []
    make_step = loop.make_train_step

    def recording(cfg, anchors, opt, device):
        step = make_step(cfg, anchors, opt, device)

        def run(model, batch):
            steps.append(dict(model=_numpy(model.state_dict()),
                              opt=_numpy(opt.state_dict()), batch=batch))
            return step(model, batch)
        return run
    loop.make_train_step = recording
    try:
        with float64_training():
            model, _, step = loop.train_model(mh_config(), train_ds, work,
                                              total_epochs=2, device="cpu",
                                              resume=False)
    finally:
        loop.make_train_step = make_step
    res["train"] = dict(step=step, steps=steps,
                        state=_numpy(model.state_dict()))
    model.float()

    # evaluate; what rank 0 gathers is kept for the detection check
    gathered = []
    gather = dist.gather_objects

    def keep(obj, *args, **kw):
        parts = gather(obj, *args, **kw)
        gathered.append(parts)
        return parts
    dist.gather_objects = keep
    results, text = inference.evaluate(
        eval_config(), val_ds, model,
        os.path.join(job["root"], "training", "label_2"), 1, "cpu",
        exchange_dir=os.path.join(out, "exchange"))
    res["eval"] = dict(results=results, text=text, parts=gathered[0])

    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.shutdown()
    print(f"rank {rank}: done", flush=True)


def launch(job: dict, tmp_path, world: int = 2):
    """Run `world` workers on `job`; returns their output directory. A
    rendezvous port taken meanwhile by another process is retried on a
    fresh one; any other failure fails the test with the worker's log."""
    job_path = str(tmp_path / "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for attempt in range(3):
        out = tmp_path / f"out{attempt}"
        out.mkdir()
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             str(port), job_path, str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        deadline = time.time() + WORKER_TIMEOUT_S
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(deadline - time.time(), 1))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            logs = [p.communicate()[0] for p in procs]
            pytest.fail("a worker outlived its timeout:\n"
                        + "\n".join(log[-3000:] for log in logs))
        if all(p.returncode == 0 for p in procs):
            return out
        taken = any(s in log.lower() for log in logs for s in ADDR_IN_USE)
        if not taken or attempt == 2:
            bad = next(log for p, log in zip(procs, logs) if p.returncode)
            pytest.fail(f"worker failed:\n{bad[-4000:]}")
    raise AssertionError("unreachable")


# ----------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The JAX batch-2 step, the port's single-process batch-2 step and
    train_model / evaluate runs, and the two-rank launch on the same
    inputs."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import sassd_tpu.config as jconfig
    from sassd_tpu.data.synthetic import make_random_batch as jax_batch
    from sassd_tpu.models import detector as jdetector
    from sassd_tpu_torch import config, inference, weights
    from sassd_tpu_torch.core import boxes as box_ops
    from sassd_tpu_torch.data import kitti, loader, synthetic
    from sassd_tpu_torch.models import pswarp, ssd_head
    from sassd_tpu_torch.train import loop, optim
    from test_torch_train import jax_weights, leaves

    tmp = tmp_path_factory.mktemp("mp")
    root = str(tmp / "kitti")
    synthetic.write_synthetic_kitti(root, n_train=4, n_val=3, seed=0)
    cfg, jcfg = config.tiny_config(), jconfig.tiny_config()
    params, state = jax_weights()
    batch = drop_first_gt(synthetic.make_random_batch(
        cfg, np.random.default_rng(5), batch_size=2, n_points=900))
    out = launch(dict(batch=batch, params=params, state=state, root=root),
                 tmp)
    ranks = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    jbatch = {k: jnp.asarray(v) for k, v in drop_first_gt(jax_batch(
        jcfg, np.random.default_rng(5), batch_size=2, n_points=900)).items()}
    anchors = kitti.build_anchors(cfg)[0]

    def loss_fn(p):
        losses, new_state = jdetector.forward_train(
            p, state, jbatch, jnp.asarray(anchors), jcfg)
        return jdetector.parse_losses(losses)[0], (losses, new_state)
    grads, (jlosses, jstate) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params)

    # the port's single-process step, and each sample's positive counts
    model = weights.from_jax(cfg, params, state, "cpu")
    opt = optim.make_optimizer(model, cfg.train, 100)
    single = loop.make_train_step(cfg, anchors, opt, "cpu")(model, batch)
    model = weights.from_jax(cfg, params, state, "cpu")
    model.train()
    tb, at = inference.to_device(batch, "cpu"), torch.from_numpy(anchors)
    with torch.no_grad():
        spine = model.forward_spine(tb)
        labels, _ = box_ops.aux_targets(spine.points_mean,
                                        spine.points_valid, tb["gt_boxes"],
                                        tb["gt_valid"])
        aux_pos = (labels & spine.points_valid).sum(1).tolist()
        ga = ssd_head.get_guided_anchors(
            model.head(spine.bev_map), at, tb["anchors_mask"], num_class=1,
            thr=cfg.train.anchor_thr, cap=cfg.caps.guided_train,
            gt_boxes=tb["gt_boxes"], gt_labels=tb["gt_classes"],
            gt_valid=tb["gt_valid"])
        warp_pos = (pswarp.pswarp_labels(
            ga.boxes, ga.valid, tb["gt_boxes"], tb["gt_valid"]) > 0
        ).sum(1).tolist()

    # the single-process run, and its global batches
    train_ds, val_ds = _datasets(root)
    cfg_mh = mh_config()
    global_batches = [b for e in range(2) for b, _ in loader.iterate_batches(
        train_ds, 2, epoch=e, seed=cfg_mh.train.seed, shuffle=True,
        num_workers=0)]
    with float64_training():
        single_model, _, single_step = loop.train_model(
            cfg_mh, train_ds, str(tmp / "single"), total_epochs=2,
            device="cpu", resume=False)
    label_dir = os.path.join(root, "training", "label_2")
    eval_model = weights.seeded_detector(eval_config(), 0, "cpu")
    eval_model.load_state_dict({k: torch.from_numpy(v).float() for k, v in
                                ranks[0]["train"]["state"].items()})
    annos, ids = inference.run_inference(eval_config(), val_ds, eval_model,
                                         1, "cpu")
    single_eval = inference.evaluate(eval_config(), val_ds, None, label_dir,
                                     precomputed=(annos, ids))
    return dict(
        ranks=ranks, out=out, leaves=leaves,
        jlosses={k: float(v) for k, v in jlosses.items()},
        jgrads=leaves(grads), jstate=leaves(jstate),
        single={k: float(v) for k, v in single.items()},
        aux_pos=aux_pos, warp_pos=warp_pos,
        global_batches=global_batches,
        single_train=(single_step, _numpy(dict(
            single_model.named_parameters()))),
        single_annos=inference._dedup_by_id(annos, ids),
        single_eval=single_eval)


def test_samples_have_different_positive_counts(two_ranks):
    """Per-rank normalisers would differ from the global ones here."""
    aux, warp = two_ranks["aux_pos"], two_ranks["warp_pos"]
    assert min(aux) > 0 and aux[0] != aux[1], aux
    assert min(warp) > 0 and warp[0] != warp[1], warp


def test_two_rank_step_losses_match_jax(two_ranks):
    from test_torch_train import LOSS_RTOL
    ref = two_ranks["jlosses"]
    for r in two_ranks["ranks"]:
        got = r["step"]["metrics"]
        for k, v in ref.items():
            assert np.isfinite(v) and v != 0.0, k
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("module", ("vxnet", "bevnet", "head", "pswarp",
                                    "aux"))
def test_two_rank_step_grads_match_jax(two_ranks, module):
    """The reduced gradient of every leaf within test_torch_train's
    relative L2 of JAX's batch-2 gradient, on both ranks."""
    from test_torch_train import GRAD_RTOL
    ref = {k: v for k, v in two_ranks["jgrads"].items()
           if k.startswith(f"['{module}']")}
    assert ref
    for r in two_ranks["ranks"]:
        got = two_ranks["leaves"](r["step"]["grads"])
        for k, v in ref.items():
            norm = np.linalg.norm(v)
            assert norm > 0, k
            err = np.linalg.norm(got[k] - v) / norm
            assert err <= GRAD_RTOL, (k, err)


def test_two_rank_step_bn_state_matches_jax(two_ranks):
    """SyncBN: the running statistics are the global batch's, on both
    ranks."""
    ref = two_ranks["jstate"]
    for r in two_ranks["ranks"]:
        got = two_ranks["leaves"](r["step"]["state"])
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_two_rank_step_matches_single_process(two_ranks):
    """The losses, metrics and gradient norm of the two-rank step equal
    the single-process batch-2 step's within 1e-5 relative; the ranks'
    metrics and gradients are bitwise equal."""
    ref = two_ranks["single"]
    r0, r1 = (r["step"] for r in two_ranks["ranks"])
    assert r0["metrics"] == r1["metrics"]
    g0, g1 = (two_ranks["leaves"](r["grads"]) for r in (r0, r1))
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    for k, v in ref.items():
        if "loss" in k or k == "grad_norm":
            np.testing.assert_allclose(r0["metrics"][k], v,
                                       rtol=SINGLE_RTOL, err_msg=k)
        elif k != "nonfinite_skips":
            assert r0["metrics"][k] == v, k       # counts and their mean


def test_two_process_training_params_identical(two_ranks):
    """The replicas are bitwise equal before every step and at the end."""
    r0, r1 = (r["train"] for r in two_ranks["ranks"])
    assert r0["step"] == r1["step"] == 4
    assert len(r0["steps"]) == len(r1["steps"]) == 4
    for t, (a, b) in enumerate(zip(r0["steps"] + [r0], r1["steps"] + [r1])):
        for tree in ("model", "opt") if t < 4 else ("state",):
            for k, v in _flat(a[tree]).items():
                np.testing.assert_array_equal(v, _flat(b[tree])[k],
                                              err_msg=f"step {t} {k}")


def test_two_process_loads_the_global_batches(two_ranks):
    """Each step's two local batches are the single-process loader's
    global batch of that step, rank 0's sample first."""
    r0, r1 = (r["train"]["steps"] for r in two_ranks["ranks"])
    for t, ref in enumerate(two_ranks["global_batches"]):
        for k, v in ref.items():
            np.testing.assert_array_equal(
                np.concatenate([r0[t]["batch"][k], r1[t]["batch"][k]]), v,
                err_msg=f"step {t} {k}")


def test_two_process_matches_single_process(two_ranks):
    """Same seed, same global batches: the two-rank run reproduces the
    single-process batch-2 run (both in float64)."""
    step, ref = two_ranks["single_train"]
    got = two_ranks["ranks"][0]["train"]
    assert got["step"] == step == 4
    for k, v in ref.items():
        assert got["state"][k].dtype == np.float64, k
        np.testing.assert_allclose(got["state"][k], v, rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=k)


def test_primary_only_checkpoints(two_ranks):
    out = two_ranks["out"]
    assert [p.name for p in sorted((out / "w0").glob("*.pt"))] == [
        "checkpoint_epoch_0.pt", "checkpoint_epoch_1.pt"]
    assert not list((out / "w1").glob("*.pt"))


def test_two_rank_evaluate_matches_single_process(two_ranks):
    """Rank 0 returns the single-process AP table over the gathered,
    deduplicated detections; rank 1 returns (None, "")."""
    from sassd_tpu_torch.inference import _dedup_by_id
    r0, r1 = (r["eval"] for r in two_ranks["ranks"])
    assert (r1["results"], r1["text"]) == (None, "")
    assert r1["parts"] is None
    results, text = two_ranks["single_eval"]
    assert r0["text"] == text and "Car AP@" in text
    assert r0["results"].keys() == results.keys()
    for k in results:
        np.testing.assert_array_equal(r0["results"][k], results[k], err_msg=k)
    ids = [i for p in r0["parts"] for i in p[1]]
    assert len(ids) == 4 and len(set(ids)) == 3
    annos, ids = _dedup_by_id([a for p in r0["parts"] for a in p[0]], ids)
    ref_annos, ref_ids = two_ranks["single_annos"]
    assert ids == ref_ids
    assert sum(len(a["name"]) for a in annos) > 0
    for a, b in zip(annos, ref_annos):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_gather_objects_times_out(tmp_path, monkeypatch):
    """A rank that never arrives makes the gather raise at its deadline
    instead of hanging."""
    from sassd_tpu_torch.parallel import dist
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    for rank in (0, 1):
        monkeypatch.setattr(dist, "process_index", lambda: rank)
        t = time.time()
        with pytest.raises(TimeoutError, match="never arrived"):
            dist.gather_objects({"rank": rank}, tmp_path / str(rank),
                                timeout=1.0)
        assert time.time() - t < 10


@pytest.mark.parametrize("n,shards,bs", [(10, 2, 2), (7, 2, 2), (16, 4, 1),
                                         (5, 3, 2)])
def test_epoch_indices_match_jax(n, shards, bs):
    pytest.importorskip("jax")
    from sassd_tpu.data.loader import epoch_indices as jax_epoch_indices
    from sassd_tpu_torch.data.loader import epoch_indices
    for shuffle in (True, False):
        for h in range(shards):
            kw = dict(num_shards=shards, shard_id=h, batch_size=bs)
            np.testing.assert_array_equal(
                epoch_indices(n, 3, 0, shuffle, **kw),
                jax_epoch_indices(n, epoch=3, seed=0, shuffle=shuffle, **kw))


def test_world_size_one_group_equals_no_group():
    """Two tiny-config train steps in a one-rank gloo group equal the
    same steps with no group bitwise: losses, gradient norms, every
    parameter and buffer. The collectives at world size 1 are copies, so
    this holds only where both take one code path (SyncBN, the global
    normalizers, the coalesced gradient reduction)."""
    from sassd_tpu_torch import config, weights
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.parallel import dist
    from sassd_tpu_torch.train import loop, optim

    cfg = config.tiny_config()
    batch = synthetic.make_random_batch(cfg, np.random.default_rng(1),
                                        batch_size=2, n_points=900)
    anchors = kitti.build_anchors(cfg)[0]

    def run():
        model = weights.seeded_detector(cfg, 0, "cpu")
        opt = optim.make_optimizer(model, cfg.train, 100)
        step = loop.make_train_step(cfg, anchors, opt, "cpu")
        metrics = [step(model, batch) for _ in range(2)]
        return metrics, model.state_dict()

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = run()
        for attempt in range(3):
            try:
                dist.initialize(f"localhost:{_free_port()}", 1, 0,
                                device="cpu", timeout_s=GROUP_TIMEOUT_S)
                break
            except RuntimeError as e:
                if (attempt == 2 or not any(
                        s in str(e).lower() for s in ADDR_IN_USE)):
                    raise
        assert dist.process_count() == 1 and dist.is_initialized()
        got = run()
    finally:
        dist.shutdown()
        torch.set_num_threads(threads)
    for m_ref, m_got in zip(ref[0], got[0]):
        assert m_ref.keys() == m_got.keys()
        for k in m_ref:
            assert torch.equal(m_ref[k], m_got[k]), k
    for k, v in ref[1].items():
        assert torch.equal(v, got[1][k]), k


def test_banded_is_refused_across_ranks(monkeypatch):
    """Bands on a data x spatial layout (ROADMAP A.3): the long-range
    banded config over 4 bands is accepted on one rank and on 4 or 8
    ranks (data rows of 4 spatial ranks), and refused with ValueError on
    a world that 4 does not divide; the data strategy runs on any number
    of ranks."""
    from sassd_tpu_torch import config
    from sassd_tpu_torch.parallel import dist
    lr = config.long_range_config(parallel=config.ParallelConfig(
        strategy="banded", spatial=4))
    assert config.banded(lr)
    config.check_supported(lr, train=True)
    for world in (4, 8):
        monkeypatch.setattr(dist, "process_count", lambda: world)
        config.check_supported(lr, train=True)
    for world in (2, 6):
        monkeypatch.setattr(dist, "process_count", lambda: world)
        with pytest.raises(ValueError, match=f"{world} ranks.*spatial=4"):
            config.check_supported(lr, train=True)
        for cfg in (config.car_config(), config.multi_config(),
                    config.tiny_config()):
            config.check_supported(cfg, train=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
           sys.argv[4], sys.argv[5])
