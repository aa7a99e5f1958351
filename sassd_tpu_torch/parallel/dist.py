"""Multi-process runtime: the process group, rank helpers, barriers, the
two reductions of the data-parallel step, and the file-based object
gather (the JAX package's ``parallel/dist.py``).

The JAX package joins its hosts with ``jax.distributed`` and lets XLA put
the gradient psum into the jitted step over the global batch. The port
uses ``torch.distributed`` with explicit collectives instead: NCCL across
cards, gloo on the CPU. Every place where the reference's step reads the
whole global batch reduces over the ranks:

- BatchNorm statistics (``models/layers.masked_moments``) all-reduce their
  sums and row counts through :func:`all_reduce_sum`, whose backward
  all-reduces the incoming gradient (SyncBN);
- the losses' positive counts and their batch divisor span every rank;
- the train step all-reduces the gradients and the losses in one call
  (:func:`all_reduce_coalesced`) before the global-norm clip and the
  non-finite guard.

With no process group every helper is the identity and the rank helpers
answer 1 / 0 / True. With a group, the collectives are always called, at
world size 1 too, so a one-rank run takes the same code path as a run of
N ranks (its collectives are copies).

Under a data x spatial layout (parallel/mesh.py) the reductions take a
group: the ranks of one spatial index (the data axis) or of one data row
(the spatial axis), made by :func:`spatial_subgroups`. The spatial
strategies also move rows between the ranks of a data row:
:func:`gather_rows` (a differentiable all-gather of row slices) and
:func:`halo_exchange` (one boundary row from each neighbour, with the
backward that sends each halo row's gradient back to its owner). Both are
all-gathers and all-reduces, which NCCL and gloo both run on CUDA tensors
where they lie (gloo's on the card: ``chip_smoke.py --gloo-probe``); the
halo exchange is not point-to-point, since gloo's send and recv refuse
CUDA tensors.

Non-tensor results (evaluation annotations) go through a shared
directory with deadline-protected file barriers (:func:`gather_objects`):
a rank that died makes the others raise TimeoutError instead of hanging.
"""
from __future__ import annotations

import datetime
import os
import pickle
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

DEFAULT_TIMEOUT_S = 600.0

_DEVICE: Optional[torch.device] = None     # where barrier() puts its tensor
# spatial ranks S -> (spatial groups by data index, data groups by
# spatial index); see spatial_subgroups
_SUBGROUPS: Dict[int, Tuple[list, list]] = {}


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the job's process group (once; later calls
    return).

    coordinator_address: ``host:port`` (or ``tcp://host:port``) of rank
    0's TCP store; without it the group reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` from the environment, as
    ``torchrun`` sets them. num_processes / process_id default to
    ``WORLD_SIZE`` / ``RANK``. backend: "nccl" when `device` is a CUDA
    device, "gloo" otherwise, unless given (gloo also runs CUDA tensors,
    which is how two ranks share one card). Every collective of the group
    raises after `timeout_s` seconds without its peers. One collective
    runs before the call returns, so the rendezvous happens here.
    """
    global _DEVICE
    if is_initialized():
        return
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev if backend == "nccl" else torch.device("cpu")
    barrier("sassd_dist_init")


def shutdown() -> None:
    """Leave the process group (nothing when there is none)."""
    global _DEVICE
    if is_initialized():
        tdist.destroy_process_group()
    _DEVICE = None
    _SUBGROUPS.clear()


def process_count() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def barrier(name: str = "") -> None:
    """Block until every rank reaches this point (a one-element
    all-reduce on the group's device); nothing without a group. `name`
    labels the call site only."""
    if not is_initialized():
        return
    tdist.all_reduce(torch.zeros(1, device=_DEVICE or "cpu"))


def spatial_subgroups(spatial: int) -> Tuple[list, list]:
    """The subgroups of a world of W ranks laid out as W / spatial data
    rows x `spatial` spatial ranks (rank r at data index r // spatial,
    spatial index r % spatial): the spatial groups, one per data row
    (ranks [d * spatial, (d + 1) * spatial)), and the data groups, one per
    spatial index (ranks s, s + spatial, ...). Made once per `spatial`
    while the group lives; every rank creates every group in the same
    order, as torch.distributed.new_group requires."""
    if spatial not in _SUBGROUPS:
        w = process_count()
        rows = [tdist.new_group(list(range(d * spatial, (d + 1) * spatial)))
                for d in range(w // spatial)]
        cols = [tdist.new_group(list(range(s, w, spatial)))
                for s in range(spatial)]
        _SUBGROUPS[spatial] = (rows, cols)
    return _SUBGROUPS[spatial]


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks of `group`; the gradient of every rank's input
    is the SUM of every rank's output gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable SUM all-reduce over `group` (None: every rank), a
    new tensor; `t` itself without a process group."""
    if not is_initialized():
        return t
    return _AllReduceSum.apply(t, group)


@torch.no_grad()
def all_reduce_coalesced(tensors: Sequence[torch.Tensor],
                         group=None) -> None:
    """In-place SUM all-reduce over `group` (None: every rank) of tensors
    of one dtype and device, packed into one flat buffer for one
    collective; nothing without a group. The results are written back
    into the given tensors, so what reads them afterwards reads the same
    storage with or without a group."""
    if not is_initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `t` (one shape on every rank) concatenated along `dim`
    in group-rank order, on `t`'s device."""
    src = t.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


class _GatherRows(torch.autograd.Function):
    """All-gather of equal row slices along `dim`. The backward sums the
    output gradient over the group and keeps this rank's slice: every
    rank of the group reads the whole output, so each slice's gradient
    is the sum of what every rank sends back."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rows = x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        tdist.all_reduce(grad, group=ctx.group)
        r = tdist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, r * ctx.rows, ctx.rows), None, None


def gather_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's row slices of one tensor, each rank holding rows
    [r * h, (r + 1) * h) along `dim` (h = x.shape[dim]), put together on
    every rank; differentiable (see _GatherRows)."""
    return _GatherRows.apply(x, dim, group)


class _HaloExchange(torch.autograd.Function):
    """x padded along `dim` with the previous rank's last row before and
    the next rank's first row after (zeros past the group's first and last
    rank). The backward returns the gradient of the own rows plus the
    gradients of the neighbours' halo rows that are copies of this rank's
    boundary rows."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        h = x.shape[dim]
        edges = all_gather_cat(torch.cat([x.narrow(dim, 0, 1),
                                          x.narrow(dim, h - 1, 1)], dim),
                               dim, group)   # rank k: first 2k, last 2k + 1
        n, r = tdist.get_world_size(group), tdist.get_rank(group)
        zero = torch.zeros_like(x.narrow(dim, 0, 1))
        top = edges.narrow(dim, 2 * r - 1, 1) if r > 0 else zero
        bottom = edges.narrow(dim, 2 * r + 2, 1) if r < n - 1 else zero
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, grad):
        dim, group = ctx.dim, ctx.group
        h = grad.shape[dim] - 2
        halos = all_gather_cat(torch.cat([grad.narrow(dim, 0, 1),
                                          grad.narrow(dim, h + 1, 1)], dim),
                               dim, group)   # rank k: top 2k, bottom 2k + 1
        n, r = tdist.get_world_size(group), tdist.get_rank(group)
        out = grad.narrow(dim, 1, h).clone()
        if r > 0:            # the previous rank's bottom halo: my first row
            out.narrow(dim, 0, 1).add_(halos.narrow(dim, 2 * r - 1, 1))
        if r < n - 1:        # the next rank's top halo: my last row
            out.narrow(dim, h - 1, 1).add_(halos.narrow(dim, 2 * r + 2, 1))
        return out, None, None


def halo_exchange(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """x [.., h, ..] -> [.., h + 2, ..] along `dim`: one halo row from each
    neighbour in the group's rank order, zeros at the first and last
    rank's outer edge (a SAME conv's zero padding of the whole); every
    rank of the group calls it. Differentiable (see _HaloExchange)."""
    return _HaloExchange.apply(x, dim, group)


_GATHER_ROUND = 0
_DEFERRED_CLEANUP: List[Path] = []


def _file_barrier(d: Path, name: str, n: int, pid: int,
                  deadline: float) -> None:
    """Barrier over a shared directory with a hard deadline: a rank that
    died before reaching it makes every other rank raise TimeoutError
    (a dead rank never writes its marker; the deadline bounds the wait)."""
    mine = d / f"{name}_rank{pid}.done"
    mine.touch()
    missing = [d / f"{name}_rank{i}.done" for i in range(n) if i != pid]
    while missing:
        missing = [p for p in missing if not p.exists()]
        if missing and time.time() > deadline:
            raise TimeoutError(
                f"barrier {name}: ranks "
                f"{[str(p) for p in missing]} never arrived")
        if missing:
            time.sleep(0.1)


def gather_objects(obj, exchange_dir, tag: str = "gather",
                   timeout: float = 600.0) -> Optional[List]:
    """All-to-rank-0 gather of picklable objects through a shared
    directory.

    Every rank writes its part; rank 0 reads them back in rank order and
    returns the list, the other ranks return None. `exchange_dir` must be
    visible to every rank. If a rank dies mid-gather, every surviving rank
    raises TimeoutError after `timeout` seconds.
    """
    global _GATHER_ROUND
    n, pid = process_count(), process_index()
    if n == 1:
        return [obj]
    # every rank calls gather_objects in the same program order, so a
    # local counter names each round alike on every rank (markers of an
    # earlier round cannot satisfy this one's barriers)
    rnd = _GATHER_ROUND
    _GATHER_ROUND += 1
    tag = f"{tag}_r{rnd}"
    deadline = time.time() + timeout
    d = Path(exchange_dir)
    d.mkdir(parents=True, exist_ok=True)
    part = d / f"{tag}_part{pid}.pkl"
    tmp = str(part) + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, part)
    _file_barrier(d, f"{tag}_written", n, pid, deadline)
    out = None
    if pid == 0:
        out = []
        for i in range(n):
            with open(d / f"{tag}_part{i}.pkl", "rb") as f:
                out.append(pickle.load(f))
    _file_barrier(d, f"{tag}_read", n, pid, deadline)
    if pid == 0:
        # every rank has passed the written barrier (the read barrier
        # proves it), so the parts and written-markers can go; this
        # round's read-markers may still be polled by a slow rank and go
        # at the next gather
        for i in range(n):
            (d / f"{tag}_part{i}.pkl").unlink(missing_ok=True)
            (d / f"{tag}_written_rank{i}.done").unlink(missing_ok=True)
        for p in _DEFERRED_CLEANUP:
            p.unlink(missing_ok=True)
        _DEFERRED_CLEANUP.clear()
        _DEFERRED_CLEANUP.extend(
            d / f"{tag}_read_rank{i}.done" for i in range(n))
    return out
