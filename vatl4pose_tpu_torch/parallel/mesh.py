"""Process mesh, shardings and collectives (counterpart of
vatl4pose_tpu/parallel/mesh.py).

The process model.  The JAX package drives every local device from one
process; the port runs one process per rank (SPMD at the process level),
launched by `torchrun --standalone --nproc_per_node N` (env://) or
`init_multihost` (tcp://):

  * every rank runs the same host code: the same seeds, the same
    selection and the same evaluation;
  * only the sharded work is split: the stage-1 forward of a scoring pass
    (al/scoring.py) and each resident retrain step's batch
    (train/retrain.py, parallel/steps.py);
  * every rank ends each step with identical parameters: the gradients
    are summed over the ranks and every replica applies the same update;
    what runs unsharded on every rank (the streamed retrain, the AE
    fine-tune) is followed by a broadcast of rank 0's state;
  * rank 0 alone writes files (`is_primary`).

Backend: nccl when every rank has a card of its own (world size <=
torch.cuda.device_count()), gloo when ranks share a card or run on the
CPU.  A rank's device is cuda:(LOCAL_RANK % device_count), or the CPU when
the caller asks for it.  gloo refuses all_gather on CUDA tensors, so this
module hands gloo host copies of CUDA tensors in every collective (gloo
copies through host memory for the others anyway); nccl gets them as
they are.

`Mesh` is the port's own: `torch.distributed.device_mesh.DeviceMesh`
assumes one rank per card, and two gloo ranks sharing one card is how a
one-card machine checks this path.  A mesh's axes are process groups
(subgroups from dist.new_group when the mesh has more than one axis);
`with mesh:` makes its `data` group the one that train-mode BatchNorm
reduces its batch statistics over (models/layers.BatchNorm2d), as JAX's
`with mesh:` makes jit's BatchNorm reduction global.
"""

from __future__ import annotations

import contextvars
import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "Sharding", "make_mesh", "data_sharding", "replicated",
           "shard_batch", "init_multihost", "init_distributed", "world_size",
           "is_primary", "active_mesh", "all_gather", "all_reduce_",
           "all_reduce_sum", "all_reduce_grads", "broadcast_module",
           "broadcast_object"]

_ACTIVE = contextvars.ContextVar("vatl4pose_active_mesh", default=None)


def world_size() -> int:
    """The process group's size, or WORLD_SIZE (torchrun's) before it is
    initialised; 1 without either."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_primary() -> bool:
    """True on rank 0, and in a process without a process group."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _rank_device(device=None) -> torch.device:
    """cuda:(LOCAL_RANK % device_count) for CUDA without an index (None
    means CUDA), else `device` as given."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _backend_for(device, n_ranks: int) -> str:
    """nccl when each of the n_ranks ranks has a card of its own, else
    gloo."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device=None, init_method: str = "env://",
                     n_ranks: Optional[int] = None,
                     rank: Optional[int] = None) -> str:
    """init_process_group with the backend rule above (n_ranks and rank
    default to torchrun's WORLD_SIZE and RANK); on CUDA, this rank's card
    becomes the current device.  Returns the backend."""
    n = int(n_ranks if n_ranks is not None
            else os.environ.get("WORLD_SIZE", "1"))
    backend = _backend_for(device, n)
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=-1 if rank is None else rank)
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.get_rank() == 0:
        why = "a card a rank" if backend == "nccl" \
            else "ranks share a card or run on the CPU"
        print(f"[DP] process group: {n} ranks, backend {backend} ({why})",
              flush=True)
    return backend


class Mesh:
    """The ranks of the process group laid out as an array of `shape`
    with named axes (JAX's Mesh: `shape` maps each axis name to its size,
    `axis_names` keeps their order).  Holds this rank's coordinates, the
    process group of each axis that this rank belongs to (None in a
    one-rank world) and this rank's device."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "differ in length")
        init = dist.is_available() and dist.is_initialized()
        self.size = dist.get_world_size() if init else 1
        self.rank = dist.get_rank() if init else 0
        if math.prod(shape) != self.size:
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{math.prod(shape)} ranks; the process group "
                             f"has {self.size} (one rank is one device)")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self.device = _rank_device(device)
        self._groups = {a: self._axis_group(i)
                        for i, a in enumerate(axis_names)}
        self._token = []

    def _axis_group(self, i):
        """The group of the ranks that differ from this one in axis i
        only.  dist.new_group is collective: every rank creates every
        group, in the same order."""
        if self.size == 1:
            return None
        if len(self.axis_names) == 1:
            return dist.group.WORLD
        ranks = np.arange(self.size).reshape(tuple(self.shape.values()))
        mine = None
        for row in np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i]):
            group = dist.new_group(row.tolist())
            if self.rank in row:
                mine = group
        return mine

    def group(self, axis: str = "data"):
        return self._groups[axis]

    def __enter__(self):
        self._token.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token.pop())


def active_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `with mesh:`, or None."""
    return _ACTIVE.get()


@dataclasses.dataclass(frozen=True)
class Sharding:
    """JAX's NamedSharding(mesh, PartitionSpec(*spec)): dimension i of an
    array is split into contiguous blocks over mesh axis spec[i] (None:
    not split); the dimensions past the spec are replicated."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def local(self, x):
        """This rank's block of x, in JAX's device order.  A split
        dimension must divide evenly, as JAX requires."""
        index = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                index.append(slice(None))
                continue
            n, c = self.mesh.shape[axis], self.mesh.coords[axis]
            size = x.shape[dim]
            if size % n:
                raise ValueError(
                    f"a sharding over mesh axis {axis!r} ({n} ranks) "
                    f"implies that the global size of dimension {dim} "
                    f"should be divisible by {n}, but it is equal to "
                    f"{size} (full shape {tuple(x.shape)})")
            b = size // n
            index.append(slice(c * b, (c + 1) * b))
        return x[tuple(index)]


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Shard the leading (batch) dim, replicate the rest."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    """Every rank holds the whole array."""
    return Sharding(mesh, ())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """This rank's contiguous block of the leading dim of every array
    (tensor or numpy) in `tree` (dicts, lists, tuples)."""
    return _tree_map(data_sharding(mesh, axis).local, tree)


def make_mesh(n_devices: Optional[int] = None, axes=("data",),
              shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A mesh over the whole process group (a one-rank mesh without
    one); n_devices, if given, must be its size.  device: as for
    `_rank_device` (None means CUDA)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{n} ranks, one a device")
    return Mesh(shape or (n,), axes, device)


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device=None) -> Mesh:
    """Multi-host bring-up (replaces env.py:11-20 NCCL/MPI init):
    init_process_group over tcp://coordinator when one is given (with
    num_processes and process_id), else env://, then one mesh over every
    rank."""
    method = "env://"
    if coordinator:
        method = coordinator if "://" in coordinator \
            else f"tcp://{coordinator}"
    init_distributed(device, method, num_processes, process_id)
    return make_mesh(device=device)


# ---- collectives -----------------------------------------------------------
# `group` is a mesh axis's group (Mesh.group); None is a one-rank mesh's,
# over which every collective is the identity.
def _comm_device(group) -> torch.device:
    """Where the group's backend takes its tensors: gloo the host (it
    refuses all_gather on CUDA tensors), nccl this rank's card."""
    if dist.get_backend(group) == dist.Backend.GLOO:
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _in_place(t, group, op):
    """op(t) on the backend's device: t itself there, else a copy that
    is copied back into t."""
    dev = _comm_device(group)
    if t.device == dev:
        op(t)
    else:
        c = t.to(dev)
        op(c)
        t.copy_(c)
    return t


def all_reduce_(t, group=None):
    """In-place sum of t over the group's ranks."""
    if group is None:
        return t
    return _in_place(t, group, lambda c: dist.all_reduce(c, group=group))


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; its backward sums the output's
    gradients over the ranks, which is the gradient of a loss that is
    itself the sum of the ranks' terms."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x, group=None):
    """Differentiable sum of x over the group's ranks."""
    return _AllReduceSum.apply(x, group)


def _flat_groups(tensors):
    """The tensors grouped by (device, dtype), each group flattened."""
    by = {}
    for t in tensors:
        by.setdefault((t.device, t.dtype), []).append(t)
    return [(ts, torch.cat([t.reshape(-1) for t in ts]))
            for ts in by.values()]


def _unflatten_into(ts, flat):
    o = 0
    for t in ts:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()


def all_reduce_grads(params, group=None):
    """Sum every parameter's gradient over the ranks, coalesced into one
    all-reduce a dtype: the exact gradient of the global loss when each
    rank's loss is its term of the global sum (parallel/steps.py)."""
    for ts, flat in _flat_groups([p.grad for p in params
                                  if p.grad is not None]):
        _unflatten_into(ts, all_reduce_(flat, group))


def _src(group):
    return 0 if group is dist.group.WORLD else dist.get_global_rank(group, 0)


def _broadcast_tensors(tensors, group=None):
    """Overwrite the tensors with the group's rank 0's, in place."""
    if group is None:
        return
    src = _src(group)
    for ts, flat in _flat_groups(list(tensors)):
        _in_place(flat, group,
                  lambda c: dist.broadcast(c, src, group=group))
        _unflatten_into(ts, flat)


@torch.no_grad()
def broadcast_module(module, group=None, optimizer=None):
    """Rank 0's parameters and buffers (and, if given, the optimizer's
    state tensors) on every rank of the group."""
    tensors = [t for t in (*module.parameters(), *module.buffers())]
    if optimizer is not None:
        for p in module.parameters():
            st = optimizer.state.get(p, {})
            tensors += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    _broadcast_tensors(tensors, group)


def all_gather(x, group=None):
    """Every rank's x concatenated along axis 0 in rank order; the ranks'
    leading sizes may differ (padded for the collective, trimmed after).
    Gathered as bytes, so any dtype goes through unchanged."""
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        return x
    dev = _comm_device(group)
    size = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(size) for _ in range(n)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s) for s in sizes]
    rows = x.contiguous().reshape(x.shape[0], math.prod(x.shape[1:]))
    rows = rows.view(torch.uint8).to(dev)
    buf = torch.zeros((max(sizes), rows.shape[1]), dtype=torch.uint8,
                      device=dev)
    buf[:rows.shape[0]] = rows
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)]).to(x.device)
    return out.view(x.dtype).reshape(sum(sizes), *x.shape[1:])


def broadcast_object(obj, group=None):
    """Rank 0's picklable `obj` on every rank; `obj` itself without a
    process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return obj
    group = group or dist.group.WORLD
    box = [obj]
    dist.broadcast_object_list(box, _src(group), group=group)
    return box[0]
