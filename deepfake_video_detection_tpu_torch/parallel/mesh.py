"""Process group, device mesh and batch sharding: the port's parallelism
substrate over ``torch.distributed``.

Counterpart of ``deepfake_video_detection_tpu/parallel/mesh.py``. JAX runs
one process that sees every device and lets XLA insert the collectives;
torch runs one process per device, so the port spells the collectives out:

* :func:`init_world` joins the default process group: ``torchrun``'s
  environment when it is there, else a world of one over an in-process
  store (no network, no port). The card's backend is NCCL on
  ``cuda:{LOCAL_RANK}``; gloo serves only a caller that asks for the CPU.
  A CUDA group that fails to start raises: nothing carries on over gloo.
* :func:`make_mesh` builds a ``DeviceMesh`` over the whole world with the
  JAX mesh's axis names, ``("data", "model")`` by default.
* :func:`shard_batch` gives this rank its rows of a global batch (and its
  frames, under a ``seq`` spec); :func:`replicate` makes a tree equal on
  every rank (rank 0's values).
* :func:`reducing` names the groups over which the batch statistics of one
  train step reduce: the loss's denominators over the ranks that hold other
  rows (``rows``), batch norm's moments and the MoE router's means over the
  ranks that hold other frames (``tokens``). :func:`rows_sum` and
  :func:`tokens_sum` are those reductions; outside the context they return
  their input, so one device computes what it always did.

A partition spec is a tuple of axis names (or ``None``) per dimension, the
entries of the JAX ``PartitionSpec``; ``()`` is replicated.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``data`` × ``model`` must cover all devices used."""

    data: int = -1     # -1: all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, n_devices // model)
        return MeshSpec(data=data, model=model)


def _launched() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def local_device(device: Any = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for a CUDA request, else
    ``device`` as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def init_world(device: Any = "cuda") -> None:
    """Join the default process group once: ``env://`` under ``torchrun``,
    else a world of one over a ``HashStore``. NCCL for a CUDA device (bound
    to it, so a failure raises here), gloo for the CPU."""
    if dist.is_initialized():
        return
    dev = local_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} was asked for but CUDA is not available")
        torch.cuda.set_device(dev)
        kw = {"backend": "nccl", "device_id": dev}
    else:
        kw = {"backend": "gloo"}
    if _launched():
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1, **kw)


def world_size() -> int:
    """Ranks in the default group, or those ``torchrun`` will start (1
    without either): where the JAX package reads ``len(jax.devices())``."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1)) if _launched() else 1


def is_main_process() -> bool:
    """Rank 0, or no process group: the process that writes files and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(spec: Optional[MeshSpec] = None, device: Any = "cuda",
              axis_names: Sequence[str] = ("data", "model")):
    """The global ``DeviceMesh`` (``init_world`` first). Default: all ranks
    on the ``data`` axis. The mesh must cover the world: a rank outside it
    would have no work."""
    from torch.distributed.device_mesh import init_device_mesh

    init_world(device)
    n = dist.get_world_size()
    spec = (spec or MeshSpec()).resolve(n)
    if spec.data * spec.model != n:
        raise ValueError(f"mesh data={spec.data} x model={spec.model} does not "
                         f"cover the {n} ranks of this run")
    return init_device_mesh(local_device(device).type, (spec.data, spec.model),
                            mesh_dim_names=tuple(axis_names))


# ---------------------------------------------------------------------------
# mesh axes
# ---------------------------------------------------------------------------


def axis_size(mesh, axis: Optional[str]) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh, axis: Optional[str]) -> int:
    return mesh.get_local_rank(axis) if axis in (mesh.mesh_dim_names or ()) else 0


def axis_group(mesh, axis: Optional[str]):
    """The process group of this rank's line along ``axis`` (None when the
    mesh has no such axis)."""
    return mesh.get_group(axis) if axis in (mesh.mesh_dim_names or ()) else None


def group_ranks(group) -> list:
    """Global ranks of ``group`` in group-rank order."""
    return dist.get_process_group_ranks(group)


def batch_sharding(mesh, axis: str = "data") -> tuple:
    """Placements of a batch: dim 0 sharded over ``axis``, replicated on
    the other mesh axes."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if n == axis else Replicate() for n in mesh.mesh_dim_names)


def replicated_sharding(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def _shard(x: Any, spec: Spec, mesh) -> Any:
    """This rank's block of ``x`` under ``spec``."""
    for dim, axis in enumerate(spec):
        n = axis_size(mesh, axis)
        if axis is None or n == 1:
            continue
        size = len(x) if isinstance(x, list) else x.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split over "
                             f"{axis}={n}")
        lo = axis_rank(mesh, axis) * (size // n)
        if isinstance(x, list):
            x = x[lo:lo + size // n]
        else:
            x = x[(slice(None),) * dim + (slice(lo, lo + size // n),)]
    return x


def shard_batch(batch: Any, mesh, axis: str = "data",
                specs: Optional[Callable[[str], Spec]] = None) -> Any:
    """This rank's part of a global batch (a dict, or one array/tensor):
    dim 0 split over ``axis``; ``specs(key)`` gives a dict leaf its own spec
    (``("data", "seq")`` splits a clip's frames over ``seq`` too). The split
    dims must divide evenly (the loader pads)."""
    if isinstance(batch, dict):
        return {k: _shard(v, specs(k) if specs is not None else (axis,), mesh)
                for k, v in batch.items()}
    return _shard(batch, (axis,), mesh)


def replicate(tree: Any, mesh=None) -> Any:
    """Rank 0's values of every tensor in ``tree`` (a tensor, a dict or a
    list of them, or a module's parameters and buffers), in place on every
    rank."""
    if isinstance(tree, torch.nn.Module):
        tensors = [t.data for t in list(tree.parameters()) + list(tree.buffers())]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        tensors = list(tree)
    else:
        tensors = [tree]
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                dist.broadcast(t, src=0)
    return tree


# ---------------------------------------------------------------------------
# differentiable collectives (each one's backward is its adjoint)
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group),) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        out = x.clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        if dist.get_rank() != ctx.src:
            g.zero_()
        return g, None, None


def solo(group) -> bool:
    """Whether ``group`` holds one rank (or is None): every collective over
    it is the identity, and is skipped, since a call costs host time."""
    return group is None or dist.get_world_size(group) == 1


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the backward sums the cotangents."""
    return x if solo(group) else _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated on dim 0, in group order; the backward
    reduce-scatters."""
    return x if solo(group) else _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 in equal chunks, chunk j to rank j; chunk j of the result came
    from rank j. Its own adjoint."""
    return x if solo(group) else _AllToAll.apply(x, group)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank; the backward sums the
    cotangents onto ``src``."""
    return x if solo(group) else _Broadcast.apply(x, src, group)


# ---------------------------------------------------------------------------
# batch statistics over the ranks of one step
# ---------------------------------------------------------------------------

_GROUPS: contextvars.ContextVar = contextvars.ContextVar("dfdt_reduce_groups",
                                                       default=None)


@contextlib.contextmanager
def reducing(rows, tokens) -> Iterator[None]:
    """Within this context :func:`rows_sum` reduces over ``rows`` and
    :func:`tokens_sum` over ``tokens`` (process groups)."""
    token = _GROUPS.set((rows, tokens))
    try:
        yield
    finally:
        _GROUPS.reset(token)


def rows_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the ranks holding other rows of the batch, carrying
    no gradient (the loss's weight sums)."""
    groups = _GROUPS.get()
    if groups is None or solo(groups[0]):
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=groups[0])
    return out


def tokens_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the ranks holding other frames of the batch; its
    backward sums the cotangents over them (batch norm's moments, the
    router's mean probabilities)."""
    groups = _GROUPS.get()
    return t if groups is None else all_reduce(t, groups[1])


def tokens_reduced() -> bool:
    groups = _GROUPS.get()
    return groups is not None and groups[1] is not None


def tokens_count(n: int) -> int:
    """The global count of ``n`` frames (tokens) a rank: every rank of the
    group holds an equal share (the loader pads), so no collective and no
    host sync is needed."""
    groups = _GROUPS.get()
    if groups is None or groups[1] is None:
        return n
    return n * dist.get_world_size(groups[1])

