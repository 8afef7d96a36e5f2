"""Parallelism strategy: CLI flags → plan → placed model and step-side
collectives.

Counterpart of ``deepfake_video_detection_tpu/parallel/strategy.py``, with
the same rules (:func:`tp_param_pspec`, :func:`pp_param_pspec`,
:func:`make_fsdp_spec_fn`), the same flags (:func:`add_parallel_args`) and
the same plans and ``ValueError`` messages (:func:`build_plan`). A spec is
a tuple of mesh-axis names per dimension of a leaf's JAX-layout shape (a
4-D conv kernel is HWIO there, OIHW here: :func:`jax_shape`).

Where JAX places a leaf with a ``NamedSharding`` and lets XLA insert the
collectives, the port (:func:`place_model`) does this:

* FSDP (a spec naming ``data``): the model goes under FSDP2's
  ``fully_shard`` over the mesh's ``data`` axis, each sharded leaf split on
  the dim the rule picked (``Shard(d)``), the leaves the rule replicates
  left out of FSDP (``ignored_params``); FSDP2 all-gathers the weights for
  the forward and reduce-scatters their gradients, and the optimizer state
  is built on the shards.
* TP (``model``): ``BackboneDetector.tensor_parallel`` makes each rank
  compute its slice of ``conv_head``'s output channels, with one
  all-reduce where the head contracts them (``ta0``, ``fc1``).
* PP (``stage``): the temporal model's ``keep_stage_blocks`` frees the
  blocks the other stages apply, so stage s holds, updates and
  checkpoints only its depth/S blocks, as JAX's :func:`pp_param_pspec`
  places the stacked blocks over ``stage``.
* SP, PP and EP run in the model (``models/temporal_transformer.py``, the
  ``mesh`` kwargs :func:`build_plan` returns).

Under TP and EP every rank keeps every parameter and computes only its
share; the gradients are summed over the world, where the other ranks'
share is zero. For EP that is JAX's placement too (its plan gives every
leaf ``P()``, and the expert buffer is replicated over ``expert``, so the
dispatch is a slice).

:class:`ParallelRuntime` is what a train step does across the ranks: the
loss's and batch norm's reductions (``parallel/mesh.py::reducing``), the
backward of each rank's share of the objective, the gradient sums, the
gradient's global norm, the metrics' sums, and the gathering of the
stages' blocks for a checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from deepfake_video_detection_tpu_torch.parallel.mesh import (
    Spec, axis_group, axis_rank, axis_size, init_world, reducing, solo)
from deepfake_video_detection_tpu_torch.train.optim import global_norm


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def tp_param_pspec(path: str, shape=None) -> Spec:
    """Tensor-parallel rules for ``BackboneDetector``: fc1.weight (256, F)
    on its F input features, conv_head.weight (HWIO) on its output
    channels; everything else replicates."""
    if path.endswith("fc1.weight"):
        return (None, "model")
    if path.endswith("conv_head.weight"):
        return (None, None, None, "model")
    return ()


def pp_param_pspec(path: str, shape=None, stage_axis: str = "stage") -> Spec:
    """GPipe rule: every ``blocks.*`` leaf is the stage axis's."""
    return (stage_axis,) if path.startswith("blocks.") else ()


def make_fsdp_spec_fn(data_size: int, axis: str = "data",
                      min_size: int = 2 ** 14,
                      base: Optional[Callable[..., Spec]] = None
                      ) -> Callable[[str, Any], Spec]:
    """FSDP / ZeRO-3 rule: shard the LARGEST dim divisible by ``data_size``
    (ties → the last such dim) over ``axis``; leaves below ``min_size``
    elements or with no divisible dim replicate. ``base`` (e.g.
    :func:`tp_param_pspec`) keeps the dims it assigns; FSDP takes the
    largest remaining free dim."""

    def spec(path: str, shape=None) -> Spec:
        base_spec = tuple(base(path, shape)) if base is not None else ()
        if shape is None:
            return base_spec
        shape = tuple(int(d) for d in shape)
        n_elems = 1
        for d in shape:
            n_elems *= d
        if n_elems < min_size:
            return base_spec
        entries = list(base_spec) + [None] * (len(shape) - len(base_spec))
        pick, pick_sz = -1, 0
        for i, d in enumerate(shape):
            if entries[i] is None and d % data_size == 0 and d >= pick_sz:
                pick, pick_sz = i, d
        if pick < 0:
            return base_spec
        entries[pick] = axis
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    return spec


def jax_shape(shape) -> Tuple[int, ...]:
    """A parameter's shape in the JAX layout: OIHW conv kernels are HWIO."""
    shape = tuple(int(d) for d in shape)
    return (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape


def torch_dim(jax_dim: int, ndim: int) -> int:
    """The dim of a torch-layout parameter that is ``jax_dim`` in JAX's."""
    return (2, 3, 1, 0)[jax_dim] if ndim == 4 else jax_dim


def sharding_summary(model: torch.nn.Module,
                     spec_fn: Callable[..., Spec]) -> Tuple[int, int, float]:
    """``(sharded_leaves, total_leaves, fraction_of_param_bytes_sharded)``
    of ``spec_fn`` over the model's parameters."""
    n_sh, total_b, sh_b, n = 0, 0, 0, 0
    for name, p in model.named_parameters():
        b = p.numel() * p.element_size()
        total_b += b
        n += 1
        if any(a is not None for a in spec_fn(name, jax_shape(p.shape))):
            n_sh += 1
            sh_b += b
    return n_sh, n, (sh_b / total_b if total_b else 0.0)


def place_model(model: torch.nn.Module, mesh, spec_fn: Callable[..., Spec]
                ) -> Tuple[int, int, float]:
    """Apply the plan's placement to ``model`` (FSDP2 for ``data`` specs,
    ``tensor_parallel`` for ``model`` specs, ``keep_stage_blocks`` for
    ``stage`` specs) and return its :func:`sharding_summary`."""
    from torch.distributed.tensor import Shard

    summary = sharding_summary(model, spec_fn)
    specs = {p: spec_fn(n, jax_shape(p.shape)) for n, p in model.named_parameters()}
    if any("model" in s for s in specs.values()):
        model.tensor_parallel(mesh, "model")
    if any("stage" in s for s in specs.values()):
        model.keep_stage_blocks()
    sharded = {p: torch_dim(s.index("data"), p.ndim)
               for p, s in specs.items() if "data" in s}
    if sharded:
        from torch.distributed.fsdp import fully_shard

        # FSDP2 reduce-scatters the mean over data; ParallelRuntime takes
        # the sum back (gloo has no pre-multiplied sum to ask for)
        fully_shard(model, mesh=mesh["data"],
                    shard_placement_fn=lambda p: Shard(sharded[p]),
                    ignored_params=set(specs) - set(sharded))
    return summary


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclass
class ParallelPlan:
    """Everything the Trainer needs to run one parallelism configuration."""

    mesh: Any                       # DeviceMesh, or None for a world not this one
    # dotted param path (+ JAX-layout shape) -> spec (() = replicated)
    param_spec_fn: Callable[..., Spec] = lambda path, shape=None: ()
    # batch leaf name -> spec; leaves not listed shard ("data",)
    batch_specs: Dict[str, Spec] = field(default_factory=dict)
    pure_dp: bool = True
    description: str = "dp"
    # the loader pads every batch to this multiple: the data-axis size, or
    # data * pp_microbatches under GPipe
    batch_multiple: int = 1
    scan_of_steps_ok: bool = True
    mesh_shape: Dict[str, int] = field(default_factory=dict)

    def batch_spec(self, key: str) -> Spec:
        return self.batch_specs.get(key, ("data",))

    @property
    def n_devices(self) -> int:
        n = 1
        for v in self.mesh_shape.values():
            n *= v
        return n


def parse_mesh_arg(mesh_arg: str) -> Dict[str, int]:
    """``"data=2,model=2"`` → ``{"data": 2, "model": 2}`` (ordered)."""
    out: Dict[str, int] = {}
    for part in (mesh_arg or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad --mesh entry {part!r} (want axis=N)")
        k, v = part.split("=", 1)
        out[k.strip()] = int(v)
    return out


def add_parallel_args(ap: argparse.ArgumentParser, temporal: bool = True) -> None:
    g = ap.add_argument_group(
        "parallelism", "multi-device sharding over a torch DeviceMesh, one "
        "process per device under torchrun (axes: data / model / seq / stage "
        "/ expert)")
    g.add_argument("--mesh", default=None,
                   help="mesh axes, e.g. 'data=4,model=2' (TP for the detector "
                        "head) — 'data=-1' means all remaining devices; default: "
                        "all devices on data")
    g.add_argument("--fsdp", action="store_true",
                   help="FSDP/ZeRO-3: shard params + optimizer state over the "
                        "data axis (FSDP2 all-gathers weights and "
                        "reduce-scatters grads); composes with --mesh model=N")
    if temporal:
        g.add_argument("--seq", default="none", choices=["none", "ring", "ulysses"],
                       help="sequence parallelism over the FRAME axis (temporal "
                            "model): KV ring or all-to-all head sharding")
        g.add_argument("--seq_par", type=int, default=1,
                       help="seq-parallel degree (mesh 'seq' axis size)")
        g.add_argument("--pp_stages", type=int, default=1,
                       help="GPipe pipeline stages (mesh 'stage' axis; temporal "
                            "depth must divide)")
        g.add_argument("--pp_microbatches", type=int, default=2)
        g.add_argument("--moe_experts", type=int, default=0,
                       help="experts per block MLP (temporal); shards over the "
                            "mesh 'expert' axis")
        g.add_argument("--expert_par", type=int, default=0,
                       help="expert-parallel degree (default: min(moe_experts, "
                            "devices))")


def build_plan(args: argparse.Namespace, model_name: str, num_frames: int,
               depth: Optional[int] = None, n_devices: Optional[int] = None,
               device: Any = "cuda") -> Tuple[Optional[ParallelPlan], Dict[str, Any]]:
    """Resolve CLI flags into a (plan, temporal-model-kwargs) pair, as the
    JAX ``build_plan`` does over ``n_devices`` (default: this run's world
    size, and then the plan's ``DeviceMesh`` is built on ``device``).
    Returns ``(None, {})`` when nothing beyond the default is asked for.
    Raises ``ValueError`` on inconsistent requests, with JAX's messages."""
    live = n_devices is None
    if live:
        from deepfake_video_detection_tpu_torch.parallel.mesh import world_size
        n = world_size()
    else:
        n = n_devices
    axes = parse_mesh_arg(getattr(args, "mesh", None) or "")
    seq = getattr(args, "seq", "none")
    seq_par = int(getattr(args, "seq_par", 1) or 1)
    pp_stages = int(getattr(args, "pp_stages", 1) or 1)
    moe_experts = int(getattr(args, "moe_experts", 0) or 0)
    expert_par = int(getattr(args, "expert_par", 0) or 0)

    is_temporal = model_name.lower() in ("temporal", "temporal_transformer")
    wants_sp = seq != "none" or seq_par > 1
    wants_pp = pp_stages > 1
    wants_ep = moe_experts > 0 and (expert_par > 1 or expert_par == 0
                                    and moe_experts > 1 and n > 1)
    tp = int(axes.get("model", 1))
    fsdp = bool(getattr(args, "fsdp", False))

    if not axes and not wants_sp and not wants_pp and not moe_experts and not fsdp:
        return None, {}

    # ---- validation ----
    if tp > 1 and model_name.lower() not in ("pretrained", "backbone"):
        raise ValueError(
            "--mesh model=N (tensor parallelism) is wired for the "
            "pretrained BackboneDetector head; use --seq/--pp_stages/"
            "--moe_experts for the temporal family")
    for flag, ok in (("--seq/--seq_par", wants_sp), ("--pp_stages", wants_pp),
                     ("--moe_experts", moe_experts > 0)):
        if ok and not is_temporal:
            raise ValueError(f"{flag} requires --model temporal")
    if sum(map(bool, (tp > 1, wants_sp, wants_pp, wants_ep))) > 1:
        raise ValueError("combine at most one of model=N / seq / pp_stages / "
                         "expert parallelism per training run (3-axis "
                         "composition is exercised by dryrun_multichip "
                         "phase 5); pass --expert_par 1 to run MoE densely "
                         "alongside seq/pp")
    if fsdp and (wants_sp or wants_pp or wants_ep):
        raise ValueError("--fsdp shards params over the data axis and "
                         "currently composes with pure DP or --mesh model=N "
                         "only; drop --seq/--pp_stages/--moe_experts")
    if wants_sp:
        if seq == "none":
            seq = "ring"
        if seq_par <= 1:
            seq_par = min(n, 2)
        if num_frames % seq_par:
            raise ValueError(f"--num_frames {num_frames} must be divisible "
                             f"by --seq_par {seq_par}")
    if wants_pp:
        if depth is not None and depth % pp_stages:
            raise ValueError(f"temporal depth {depth} must be divisible by "
                             f"--pp_stages {pp_stages}")
    if wants_ep and expert_par == 0:
        expert_par = min(moe_experts, max(1, n // max(1, axes.get("data", 1))
                                          if "data" in axes else n))
        while expert_par > 1 and (n % expert_par or moe_experts % expert_par):
            expert_par -= 1
    if wants_ep and moe_experts % max(1, expert_par):
        raise ValueError(f"--moe_experts {moe_experts} must be divisible by "
                         f"--expert_par {expert_par}")

    # ---- mesh axes (data first, the second axis innermost) ----
    second: Optional[Tuple[str, int]] = None
    if tp > 1:
        second = ("model", tp)
    elif wants_sp:
        second = ("seq", seq_par)
    elif wants_pp:
        second = ("stage", pp_stages)
    elif wants_ep and expert_par > 1:
        second = ("expert", expert_par)
    inner = second[1] if second else 1
    if n % inner:
        raise ValueError(f"{n} devices not divisible by the "
                         f"{second[0] if second else 'model'}-parallel "
                         f"degree {inner}")
    data = axes.get("data", -1)
    data = n // inner if data in (-1, 0) else data
    if data * inner > n:
        raise ValueError(f"mesh data={data} x {inner} exceeds {n} devices")
    mesh_shape = {"data": data}
    if second:
        mesh_shape[second[0]] = second[1]

    mesh = None
    if live:
        from torch.distributed.device_mesh import init_device_mesh

        from deepfake_video_detection_tpu_torch.parallel.mesh import local_device

        if data * inner != n:
            raise ValueError(f"mesh data={data} x {inner} does not cover the {n} "
                             f"ranks of this run")
        init_world(device)
        mesh = init_device_mesh(local_device(device).type, tuple(mesh_shape.values()),
                                mesh_dim_names=tuple(mesh_shape))

    # ---- plan + model kwargs ----
    model_kwargs: Dict[str, Any] = {}
    param_spec_fn: Callable[..., Spec] = lambda path, shape=None: ()
    batch_specs: Dict[str, Spec] = {}
    pure_dp = second is None
    desc = f"dp={data}"
    if tp > 1:
        param_spec_fn = tp_param_pspec
        desc += f",tp={tp}"
    if fsdp:
        if data < 2:
            raise ValueError("--fsdp needs a data axis of at least 2 "
                             f"(got data={data})")
        param_spec_fn = make_fsdp_spec_fn(data, base=tp_param_pspec if tp > 1 else None)
        pure_dp = False
        desc += ",fsdp"
    if wants_sp:
        model_kwargs.update(mesh=mesh, seq_axis="seq", seq_strategy=seq, use_cls=False)
        batch_specs["frames"] = ("data", "seq")
        desc += f",sp={seq_par}({seq})"
    if wants_pp:
        model_kwargs.update(mesh=mesh, stage_axis="stage",
                            pp_microbatches=int(getattr(args, "pp_microbatches", 2)))
        param_spec_fn = pp_param_pspec
        desc += f",pp={pp_stages}"
    if moe_experts > 0:
        model_kwargs["moe_experts"] = moe_experts
        if wants_ep and expert_par > 1:
            model_kwargs.update(mesh=mesh, expert_axis="expert")
            desc += f",ep={expert_par}x{moe_experts}e"
        else:
            desc += f",moe={moe_experts}e(dense)"

    batch_multiple = data
    if wants_pp:
        batch_multiple = data * int(getattr(args, "pp_microbatches", 2))
    plan = ParallelPlan(mesh=mesh, param_spec_fn=param_spec_fn,
                        batch_specs=batch_specs, pure_dp=pure_dp,
                        description=desc, batch_multiple=batch_multiple,
                        scan_of_steps_ok=second is None or second[0] == "model",
                        mesh_shape=mesh_shape)
    return plan, model_kwargs


def dp_plan(mesh) -> ParallelPlan:
    """The pure data-parallel plan over ``mesh`` (its ``data`` axis)."""
    data = axis_size(mesh, "data")
    return ParallelPlan(mesh=mesh, description=f"dp={data}", batch_multiple=data,
                        mesh_shape={n: mesh.size(i)
                                    for i, n in enumerate(mesh.mesh_dim_names)})


# ---------------------------------------------------------------------------
# the step across ranks
# ---------------------------------------------------------------------------


def _is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


class ParallelRuntime:
    """The collectives of one train or eval step under ``mesh``.

    Each rank differentiates its share of the objective: its rows' loss
    numerator over the global weight sum, divided by the ``replicas`` ranks
    that hold the same rows (the mesh's second axis), plus the aux losses
    (global on every rank) over the world. Then the sum over the world of
    every rank's gradient is the gradient of the global objective: plain
    parameters are all-reduced over the world (one flat buffer); FSDP2's
    shards arrive reduce-scattered over ``data`` as a mean, are scaled back
    to the sum and summed over the second axis.

    Without a mesh it is one device's step: a world of one, no reductions,
    each collective the identity."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.stage_group = None
        if mesh is None:
            self.world = self.data = self.replicas = 1
            self.data_rank, self.second = 0, None
            self.data_group = self.tokens_group = None
            return
        names = tuple(mesh.mesh_dim_names)
        self.world = dist.get_world_size()
        self.data = axis_size(mesh, "data")
        self.data_rank = axis_rank(mesh, "data")
        self.data_group = axis_group(mesh, "data")
        self.second = names[1] if len(names) > 1 else None
        self.replicas = self.world // self.data
        # frames are split over data (and seq): batch norm's and the router's
        # statistics reduce over those ranks
        self.tokens_group = mesh.get_group() if len(names) == 1 else (
            dist.group.WORLD if self.second == "seq" else self.data_group)
        if self.second == "stage":        # each stage holds its own blocks
            self.stage_group = axis_group(mesh, "stage")

    def stage_local(self, name: str) -> bool:
        """Whether parameter ``name`` is held by one pipeline stage alone
        (:func:`pp_param_pspec`'s ``blocks.*`` under a ``stage`` axis)."""
        return self.stage_group is not None and pp_param_pspec(name) == ("stage",)

    def context(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return reducing(self.data_group, self.tokens_group)

    def backward(self, task: torch.Tensor, aux: Optional[torch.Tensor] = None,
                 aux_weight: float = 0.0) -> None:
        obj = task / self.replicas
        if aux is not None:
            obj = obj + aux_weight * aux / self.world
        obj.backward()

    def reduce_grads(self, params: Dict[str, torch.Tensor]
                     ) -> Dict[str, Optional[torch.Tensor]]:
        """Sum the gradients: plain parameters over the world, a stage's
        own blocks over its ``data`` group, FSDP2's shards over the second
        axis."""
        plain = {n: p for n, p in params.items() if p.requires_grad and not _is_dtensor(p)}
        for p in plain.values():  # leaves the forward did not use: zero
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        shared = [p for n, p in plain.items() if not self.stage_local(n)]
        own = [p for n, p in plain.items() if self.stage_local(n)]
        if self.world > 1:
            _all_reduce_grads(shared, None)
        if own and not solo(self.data_group):
            _all_reduce_grads(own, self.data_group)
        if self.mesh is None:
            return {n: p.grad for n, p in params.items()}
        group = axis_group(self.mesh, self.second)
        for p in params.values():
            if p.grad is not None and _is_dtensor(p.grad):
                local = p.grad.to_local()
                local.mul_(self.data)        # FSDP2's mean over data → sum
                if not solo(group):
                    dist.all_reduce(local, group=group)
        return {n: p.grad for n, p in params.items()}

    def grad_norm(self, grads: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """The global norm of the summed gradients (f32): under the
        pipeline the stages' blocks' squares are summed over ``stage``."""
        live = {n: g for n, g in grads.items() if g is not None}
        if self.stage_group is None:
            return global_norm(live.values())
        shared = global_norm(g for n, g in live.items() if not self.stage_local(n))
        local = shared.new_zeros(())
        for n, g in live.items():
            if self.stage_local(n):
                local = local + torch.sum(torch.square(g.to(torch.float32)))
        if not solo(self.stage_group):
            dist.all_reduce(local, group=self.stage_group)
        return torch.sqrt(torch.square(shared) + local)

    def gather_stages(self, tensors: Dict[str, Any]) -> Dict[str, Any]:
        """``tensors`` (by parameter name) with every stage's blocks, the
        other stages' on the host, in the no-plan order: what a checkpoint
        writes. A collective over ``stage`` (every rank calls it); the
        identity without a pipeline."""
        if self.stage_group is None:
            return tensors
        mine = {n: t.detach().cpu() for n, t in tensors.items() if self.stage_local(n)}
        parts = [None] * axis_size(self.mesh, "stage")
        dist.all_gather_object(parts, mine, group=self.stage_group)
        blocks = {n: t for part in parts for n, t in part.items()}
        out = {}
        for n, t in tensors.items():      # the blocks where this stage's were
            if not self.stage_local(n):
                out[n] = t
            elif blocks:
                out.update(blocks)
                blocks = {}
        out.update(blocks)
        return out

    def reduce_metrics(self, loss: torch.Tensor, correct: torch.Tensor,
                       count: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The global loss (the sum of the rows' shares) and hit counts."""
        if solo(self.data_group):
            return loss.detach(), correct, count
        buf = torch.stack([loss.detach().to(torch.float64), correct.to(torch.float64),
                           count.to(torch.float64)])
        dist.all_reduce(buf, group=self.data_group)
        return buf[0].to(torch.float32), buf[1].to(torch.int64), buf[2].to(torch.int64)

    def gather_rows(self, arrays):
        """Every data rank's list of host arrays/lists, in data-rank order."""
        out = [None] * self.data
        dist.all_gather_object(out, arrays, group=self.data_group)
        return out


def _all_reduce_grads(params, group) -> None:
    """Sum the parameters' gradients over ``group`` (the world: None) as
    one flat f32 buffer."""
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1).to(torch.float32) for p in params])
    dist.all_reduce(flat, group=group)
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n


def placement_line(plan: ParallelPlan, summary: Tuple[int, int, float]) -> str:
    n_sh, n_tot, frac = summary
    return (f"placement [{plan.description}]: {n_sh}/{n_tot} param leaves "
            f"sharded ({frac:.0%} of param bytes)")


def warn_if_unsharded(plan: ParallelPlan, summary: Tuple[int, int, float]) -> None:
    if "fsdp" in plan.description and summary[0] == 0:
        warnings.warn(
            "--fsdp: no param leaf has a dimension divisible by the "
            "data-axis size — params and optimizer state are FULLY "
            "REPLICATED (no ZeRO-3 memory saving). Pick a data-axis "
            "size that divides the model's channel dims.")
