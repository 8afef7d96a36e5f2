"""Train and eval steps.

Counterpart of ``deepfake_video_detection_tpu/train/steps.py``: forward,
loss, backward and optimizer update in one call, with the metrics the
trainer reads (loss, correct, count, grad_norm). The JAX package compiles
each step into one XLA program; here a step runs eagerly, and its metrics
stay tensors on the device until the caller reads them.
:func:`make_multi_step` runs k such steps in one call over a stacked group
of batches (the JAX package's ``lax.scan`` of steps).

``remat=True`` recomputes the forward in the backward
(``torch.utils.checkpoint``) as ``jax.checkpoint`` does; dropout draws are
replayed by restoring the generator's state at the start of the forward,
and batch norm's running stats, which the JAX step threads through as new
model state computed once, are left alone by the recomputation
(``nn.layers.frozen_running_stats``). A batch with ``adjacency`` (the graph
models) passes it as the model's second argument.

A model that reports auxiliary losses (the temporal transformer's MoE
router, whose training forward returns a dict after its outputs, as the
JAX model reports ``aux_losses`` in its new state) adds each, weighted by
``aux_loss_weight`` (0.01), to the loss it differentiates: in the plain step
the reported loss includes them; in the accumulating step each microbatch
adds ``weight · aux / accum`` and the reported loss stays the weighted mean
of the microbatches' task losses, as in the JAX package. Under ``remat``
the aux comes out of ``torch.utils.checkpoint`` with the logits.

Every step runs through a ``runtime`` (``parallel/strategy.py::
ParallelRuntime``). Under a plan's mesh, with ranks each holding their part
of the batch, a step computes what JAX's step computes over the global
batch: the forward runs within the runtime's reductions (the loss's global
weight sums, batch norm's global moments), each rank backpropagates its
share of the objective into ``.grad`` (the way FSDP2's hooks take
gradients), the runtime sums the gradients over the ranks, and the metrics
are the global batch's. Without a plan the runtime is one device's, and
each of those reductions is the identity.

While something records (``utils/profiling.py``), a step of
:func:`make_train_step` (and so each step of :func:`make_multi_step`) is
the span ``train.step`` over ``train.forward`` (forward and loss),
``train.backward`` and ``train.update`` (the optimizer over the leaves):
host time, the launches included.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from deepfake_video_detection_tpu_torch.nn.layers import frozen_running_stats
from deepfake_video_detection_tpu_torch.parallel.mesh import rows_sum
from deepfake_video_detection_tpu_torch.parallel.strategy import ParallelRuntime
from deepfake_video_detection_tpu_torch.train.optim import Optimizer, global_norm  # noqa: F401 (re-exported)
from deepfake_video_detection_tpu_torch.train.state import TrainState
from deepfake_video_detection_tpu_torch.utils.profiling import annotate

Metrics = Dict[str, torch.Tensor]


def _forward(model, batch: dict, train: bool,
             generator: Optional[torch.Generator], remat: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The model's logits (the first output of a ``(logits, ...)`` tuple)
    on ``batch["frames"]`` (and ``batch["adjacency"]`` when present), and
    the sum of the aux losses it reports (a dict as its last output), or
    None."""
    inputs = (batch["frames"],) + ((batch["adjacency"],) if "adjacency" in batch else ())
    if not remat:
        out = model(*inputs, train=train, generator=generator)
    else:
        gen_state = generator.get_state() if generator is not None else None
        runs = []

        def run(*xs):
            if gen_state is not None:
                generator.set_state(gen_state)
            runs.append(None)
            # the forward updates batch norm's running stats; its
            # recomputation in the backward must not update them again
            with frozen_running_stats(len(runs) > 1):
                return model(*xs, train=train, generator=generator)

        out = checkpoint(run, *inputs, use_reentrant=False)
    if not isinstance(out, tuple):
        return out, None
    aux = None
    if isinstance(out[-1], dict):
        for v in out[-1].values():
            aux = v if aux is None else aux + v
    return out[0], aux


def _hits(logits: torch.Tensor, labels: torch.Tensor,
          valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    hit = logits.argmax(dim=-1) == labels
    if valid is None:
        return hit.sum(), torch.tensor(labels.shape[0], device=labels.device)
    return (hit & valid).sum(), valid.sum()


def _update(runtime: ParallelRuntime, tx: Optimizer, params: Dict[str, torch.Tensor],
            state: TrainState) -> torch.Tensor:
    """The step after the backward: sum the gradients over the ranks, take
    their global norm, update the parameters and the optimizer state, clear
    ``.grad``, count the step. Returns the norm. The clip reads the same
    norm; under a freeze mask it reads the trainable gradients' alone, as
    optax's ``multi_transform`` clips only its trainable part."""
    grads = runtime.reduce_grads(params)
    grad_norm = runtime.grad_norm(grads)
    clip_norm = grad_norm if tx.trainable_mask is None else runtime.grad_norm(
        {n: g for n, g in grads.items() if tx.trainable(n)})
    tx.step(params, grads, state.opt_state, norm=clip_norm)
    for p in params.values():
        p.grad = None
    state.step += 1
    return grad_norm


def make_train_step(model: Any, tx: Optimizer, loss_fn: Callable[..., torch.Tensor],
                    remat: bool = False, aux_loss_weight: float = 0.01,
                    runtime: Optional[ParallelRuntime] = None
                    ) -> Callable[[TrainState, dict, Optional[torch.Generator]],
                                  Tuple[TrainState, Metrics]]:
    """``step(state, batch, generator) -> (state, metrics)``. ``batch``:
    ``frames`` (B, T, H, W, C) normalised, ``labels`` (B,), optionally
    ``valid`` (B,) bool and ``adjacency`` (B, T, T), all on the model's
    device. ``generator`` drives dropout. The state is updated in place
    and returned; the loss includes ``aux_loss_weight`` × the model's aux
    losses. ``runtime``: the plan's, or one device's (None)."""
    runtime = runtime or ParallelRuntime()

    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None):
        with annotate("train.step"):
            params = state.params
            for p in params.values():
                p.grad = None
            with runtime.context():
                with annotate("train.forward"):
                    logits, aux = _forward(model, batch, True, generator, remat)
                    valid = batch.get("valid")
                    task = loss_fn(logits, batch["labels"], sample_mask=valid)
                with annotate("train.backward"):
                    runtime.backward(task, aux, aux_loss_weight)
            with annotate("train.update"):
                grad_norm = _update(runtime, tx, params, state)
            correct, count = _hits(logits.detach(), batch["labels"], valid)
            loss, correct, count = runtime.reduce_metrics(task, correct, count)
            if aux is not None:
                loss = loss + aux_loss_weight * aux.detach()
            return state, {"loss": loss, "correct": correct, "count": count,
                           "grad_norm": grad_norm}

    return step


def make_multi_step(model: Any, tx: Optimizer, loss_fn: Callable[..., torch.Tensor],
                    k: int, remat: bool = False, aux_loss_weight: float = 0.01,
                    prep: Optional[Callable[[dict, Optional[torch.Generator]], dict]] = None,
                    runtime: Optional[ParallelRuntime] = None):
    """``k`` optimizer steps in one call: ``multi(state, batches, generator,
    dropout_generator=None) -> (state, metrics)``. ``batches``: the single
    step's batch dict with every leaf stacked on a leading axis of length
    ``k``, already on the device (one transfer for the group). Each step is
    :func:`make_train_step`'s, after ``prep(batch_i, generator)`` (the
    trainer's augment + normalise) when given; dropout draws from
    ``dropout_generator`` (default ``generator``). ``state.step`` and the
    optimizer's count advance by ``k``. The metrics are the JAX package's
    reduction of the k steps': the count-weighted mean loss, the summed
    ``correct`` and ``count``, the last step's ``grad_norm``.
    ``runtime``: the plan's, or one device's (None)."""
    step = make_train_step(model, tx, loss_fn, remat=remat,
                           aux_loss_weight=aux_loss_weight, runtime=runtime)

    def multi(state: TrainState, batches: dict,
              generator: Optional[torch.Generator] = None,
              dropout_generator: Optional[torch.Generator] = None):
        if batches["labels"].shape[0] != k:
            raise ValueError(f"a group of {batches['labels'].shape[0]} batches for "
                             f"{k} steps")
        dropout_generator = generator if dropout_generator is None else dropout_generator
        ms = []
        for i in range(k):
            b = {key: v[i] for key, v in batches.items()}
            if prep is not None:
                b = prep(b, generator)
            state, m = step(state, b, dropout_generator)
            ms.append(m)
        count = sum(m["count"] for m in ms)
        loss = sum(m["loss"] * m["count"] for m in ms) / torch.clamp(count, min=1)
        return state, {"loss": loss, "correct": sum(m["correct"] for m in ms),
                       "count": count, "grad_norm": ms[-1]["grad_norm"]}

    return multi


def make_accum_step(model: Any, tx: Optimizer, loss_fn: Callable[..., torch.Tensor],
                    accum: int, remat: bool = False,
                    prep: Optional[Callable[[dict, Optional[torch.Generator]], dict]] = None,
                    sample_weight_fn: Optional[Callable[..., torch.Tensor]] = None,
                    aux_loss_weight: float = 0.01,
                    runtime: Optional[ParallelRuntime] = None):
    """One optimizer step whose gradient is accumulated over ``accum``
    microbatches. ``batches``: every leaf shaped ``(accum, B/accum, ...)``.
    Microbatch gradients are combined by their weight sums
    (``sample_weight_fn(labels, valid)``, the loss's class weight × validity),
    so the result equals the full-batch gradient up to float addition order.
    ``prep(batch, generator)`` (the trainer's augment + normalise) runs per
    microbatch. A model's aux losses add ``aux_loss_weight · aux / accum``
    each microbatch to the differentiated loss, not to the reported one.
    ``runtime``: the plan's, or one device's (None)."""
    runtime = runtime or ParallelRuntime()
    if sample_weight_fn is None:
        def sample_weight_fn(labels, valid):  # noqa: F811 — default: mask only
            w = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
            return w if valid is None else w * valid.to(torch.float32)

    def accum_step(state: TrainState, batches: dict,
                   generator: Optional[torch.Generator] = None):
        params = state.params
        for p in params.values():
            p.grad = None
        with runtime.context():
            den = rows_sum(torch.sum(sample_weight_fn(batches["labels"],
                                                      batches.get("valid")), dim=1))
        scale = den / torch.clamp(torch.sum(den), min=1e-8)
        loss = torch.zeros((), dtype=torch.float32, device=scale.device)
        correct = torch.zeros((), dtype=torch.int64, device=scale.device)
        count = torch.zeros((), dtype=torch.int64, device=scale.device)
        for i in range(accum):
            b = {k: v[i] for k, v in batches.items()}
            if prep is not None:
                b = prep(b, generator)
            with runtime.context():
                logits, aux = _forward(model, b, True, generator, remat)
                mean_k = loss_fn(logits, b["labels"], sample_mask=b.get("valid"))
                runtime.backward(mean_k * scale[i], None if aux is None else aux / accum,
                                 aux_loss_weight)
            loss = loss + mean_k.detach() * scale[i]
            c, k = _hits(logits.detach(), b["labels"], b.get("valid"))
            correct, count = correct + c, count + k
        grad_norm = _update(runtime, tx, params, state)
        loss, correct, count = runtime.reduce_metrics(loss, correct, count)
        return state, {"loss": loss, "correct": correct, "count": count,
                       "grad_norm": grad_norm}

    return accum_step


def make_eval_step(model: Any) -> Callable[[dict], Metrics]:
    """``step(batch) -> {"logits", "probs"}``, softmax in f32, no grad."""

    @torch.inference_mode()
    def step(batch: dict):
        logits, _ = _forward(model, batch, False, None, False)
        return {"logits": logits,
                "probs": torch.softmax(logits.to(torch.float32), dim=-1)}

    return step
