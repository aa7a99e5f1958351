"""How well a second train step of test_torch_multiprocess.py's run is
conditioned, in the port and in the JAX package (a diagnostic, not a test).

    JAX_PLATFORMS=cpu python tests/torch_dp_conditioning.py

On that test's synthetic split and widened tiny config it takes one
float32 train step at batch 2 from the seeded weights (the first global
batch's two samples in both orders: two states a rounding apart), then,
from each state, the gradient of the second global batch, and again with
the parameters moved by 1e-7 (relative, random, SEEDS seeds) and, in the
port, with that batch's two samples swapped. It prints the largest
relative L2 change of a parameter's gradient and the worst parameter, for
each perturbation. Large changes from perturbations at float32 rounding
mean that two runs which sum in another order (two ranks against one
process) part ways at that step, whatever the reduction.
"""
import os
import sys
import tempfile

import numpy as np

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
SEEDS = 6


def worst(ref: dict, got: dict):
    errs = {k: float(np.linalg.norm(got[k] - v)
                     / max(np.linalg.norm(v), 1e-30)) for k, v in ref.items()}
    k = max(errs, key=errs.get)
    return errs[k], k


def main():
    sys.path.insert(0, os.path.dirname(TESTS_DIR))
    sys.path.insert(0, TESTS_DIR)
    import torch
    from sassd_tpu_torch.data import loader, synthetic
    from test_torch_multiprocess import _datasets, mh_config

    torch.set_num_threads(1)
    root = tempfile.mkdtemp()
    synthetic.write_synthetic_kitti(root, n_train=4, n_val=3, seed=0)
    cfg = mh_config()
    ds, _ = _datasets(root)
    batches = [b for b, _ in loader.iterate_batches(
        ds, 2, epoch=0, seed=cfg.train.seed, shuffle=True, num_workers=0)]
    for order in ("as loaded", "swapped"):
        first = batches[0]
        if order == "swapped":
            first = {k: v[::-1].copy() for k, v in first.items()}
        print(f"state after step 1, its batch {order}:")
        conditioning(cfg, ds, first, batches[1], root)


def conditioning(cfg, ds, first, second, root):
    import torch
    from sassd_tpu_torch import weights
    from sassd_tpu_torch.models.detector import Detector
    from sassd_tpu_torch.train import loop, optim
    model = Detector(cfg, torch.Generator().manual_seed(cfg.train.seed))
    opt = optim.make_optimizer(model, cfg.train, 4)
    loop.make_train_step(cfg, ds.anchors, opt, "cpu")(model, first)
    state, opt_state = model.state_dict(), opt.state_dict()

    def port_grads(batch, noise=0.0, seed=0):
        m = Detector(cfg)
        m.load_state_dict(state)
        if noise:
            g = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in m.parameters():
                    p.mul_(1 + noise * torch.randn(p.shape, generator=g))
        o = optim.make_optimizer(m, cfg.train, 4)
        o.load_state_dict(opt_state)
        loop.make_train_step(cfg, ds.anchors, o, "cpu")(m, batch)
        return {k: p.grad.numpy().copy() for k, p in m.named_parameters()}

    b = second
    ref = port_grads(b)
    swapped = {k: v[::-1].copy() for k, v in b.items()}
    print("  port, samples swapped: worst gradient rel L2 %.3g (%s)"
          % worst(ref, port_grads(swapped)))
    for seed in range(1, SEEDS + 1):
        print(f"  port, noise 1e-7 seed {seed}: worst gradient rel L2 %.3g "
              "(%s)" % worst(ref, port_grads(b, 1e-7, seed)))

    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from _mh_worker import mh_config as jax_mh_config
    from sassd_tpu.models import detector as jdetector
    params, jstate = weights.to_jax(model)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    jcfg = jax_mh_config(root)

    def loss_fn(p):
        losses, _ = jdetector.forward_train(p, jstate, jbatch,
                                            jnp.asarray(ds.anchors), jcfg)
        return jdetector.parse_losses(losses)[0]
    grad = jax.jit(jax.grad(loss_fn))

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    def moved(seed):
        leaves, tree = jax.tree_util.tree_flatten(params)
        rng = np.random.default_rng(seed)
        return jax.tree_util.tree_unflatten(tree, [
            x * (1 + 1e-7 * rng.standard_normal(x.shape)).astype(np.float32)
            for x in leaves])
    jref = flat(grad(params))
    for seed in range(1, SEEDS + 1):
        print(f"  JAX, noise 1e-7 seed {seed}: worst gradient rel L2 %.3g "
              "(%s)" % worst(jref, flat(grad(moved(seed)))))


if __name__ == "__main__":
    main()
