"""Optimizers, LR schedules and host-side training callbacks.

Counterpart of ``deepfake_video_detection_tpu/train/optim.py``. The JAX
package builds an optax chain; this module is a small optimizer of the
port's own over a dict of named parameters that computes the same update:

    clip by global norm → adam | adamw | sgd → × (−lr(step) · plateau factor)
    → freeze mask → params EMA

with optax's semantics where they differ from ``torch.optim``:

* the clip scales by ``max_norm / norm`` when ``norm ≥ max_norm``
  (``clip_grad_norm_`` divides by ``norm + 1e-6``), and under a freeze mask
  the norm covers the trainable parameters only;
* ``"adam"`` ignores ``weight_decay``; ``"adamw"`` adds ``wd · p`` to the
  Adam direction before the −lr scale (decoupled decay scaled by lr);
* ``"sgd"`` is momentum 0.9 without dampening (``optax.trace``);
* the schedule is read at the step count before the increment.

Schedules are functions of the step evaluated on the host, so a step needs
no device sync for them. Parameters and state are updated in place under
``torch.no_grad`` (the JAX package returns new arrays). Under FSDP2 the
parameters, their gradients and the state slots built on them are
DTensors: the arithmetic runs on their local shards, and the clip's global
norm sums the shards' squares over their mesh (:func:`global_norm`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Union

import torch

Schedule = Union[Callable[[int], float], float]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8      # optax.scale_by_adam defaults
_MOMENTUM = 0.9                         # optax.trace(decay=0.9)


# ---------------------------------------------------------------------------
# schedules (epoch-granular, like the reference's torch schedulers)
# ---------------------------------------------------------------------------


def step_lr_schedule(base_lr: float, step_size: int, gamma: float = 0.5,
                     steps_per_epoch: int = 1) -> Callable[[int], float]:
    """torch StepLR semantics: ``lr · gamma^(epoch // step_size)``."""

    def fn(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        return base_lr * gamma ** (epoch // step_size)

    return fn


def cosine_schedule(base_lr: float, total_epochs: int, eta_min: float = 0.0,
                    steps_per_epoch: int = 1) -> Callable[[int], float]:
    """torch CosineAnnealingLR(T_max=total_epochs)."""

    def fn(step: int) -> float:
        epoch = min(int(step) // steps_per_epoch, total_epochs)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * epoch / max(total_epochs, 1)))

    return fn


def cosine_warm_restarts(base_lr: float, t_0: int = 10, t_mult: int = 2,
                         eta_min: float = 0.0,
                         steps_per_epoch: int = 1) -> Callable[[int], float]:
    """torch CosineAnnealingWarmRestarts(T_0, T_mult), with the restart index
    computed by logs as the JAX schedule does."""

    def fn(step: int) -> float:
        e = float(int(step) // steps_per_epoch)
        if t_mult == 1:
            t_cur, t_i = math.fmod(e, t_0), float(t_0)
        else:
            n = math.floor(math.log1p(e * (t_mult - 1) / t_0) / math.log(t_mult))
            start = t_0 * (float(t_mult) ** n - 1.0) / (t_mult - 1)
            t_i = t_0 * float(t_mult) ** n
            t_cur = e - start
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * t_cur / t_i))

    return fn


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(Σ ‖t‖²)`` in f32 (``optax.global_norm``); a DTensor's square
    sum is taken over its shards on every rank of its mesh."""
    from torch.distributed.tensor import DTensor

    tensors = list(tensors)
    sharded = [t for t in tensors if isinstance(t, DTensor)]
    total = sum(torch.sum(torch.square(t.to(torch.float32)))
                for t in tensors if not isinstance(t, DTensor))
    if sharded:
        from deepfake_video_detection_tpu_torch.parallel.mesh import all_reduce

        part = sum(torch.sum(torch.square(t.to_local().to(torch.float32)))
                   for t in sharded)
        total = total + all_reduce(part, sharded[0].device_mesh.get_group())
    return torch.sqrt(total)


class Optimizer:
    """The update of the JAX ``build_optimizer`` over named parameters.

    State (a plain dict, checkpointed under ``opt.*``): ``count`` (int),
    ``plateau_factor`` (float, set by the trainer after validation), and per
    parameter name the slots ``mu``/``nu`` (adam, adamw), ``trace`` (sgd)
    and ``ema`` (with ``ema_decay``)."""

    def __init__(self, name: str = "adamw", schedule: Schedule = 1e-3,
                 weight_decay: float = 1e-4, grad_clip: Optional[float] = 1.0,
                 trainable_mask: Optional[Mapping[str, bool]] = None,
                 ema_decay: Optional[float] = None):
        self.name = name.lower()
        if self.name not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {name!r}")
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema decay must be in (0, 1), got {ema_decay}")
        self.schedule = schedule if callable(schedule) else (lambda _, s=schedule: s)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip if grad_clip is not None and grad_clip > 0 else None
        self.trainable_mask = dict(trainable_mask) if trainable_mask is not None else None
        self.ema_decay = ema_decay

    def trainable(self, name: str) -> bool:
        return self.trainable_mask is None or bool(self.trainable_mask.get(name, True))

    def slots(self):
        """The per-parameter state slots, in checkpoint order."""
        out = ["mu", "nu"] if self.name in ("adam", "adamw") else ["trace"]
        return out + (["ema"] if self.ema_decay is not None else [])

    @torch.no_grad()
    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": 0, "plateau_factor": 1.0}
        train = [n for n in params if self.trainable(n)]
        for slot in self.slots():
            names = list(params) if slot == "ema" else train
            state[slot] = {n: (params[n].detach().clone() if slot == "ema"
                               else torch.zeros_like(params[n])) for n in names}
        return state

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, Optional[torch.Tensor]],
             state: Dict[str, Any], norm: Optional[torch.Tensor] = None) -> None:
        """One update: ``params`` and ``state`` change in place. ``norm``:
        the trainable gradients' global norm for the clip when the caller
        has it (the train steps: under a pipeline a stage holds only its
        blocks' gradients); else it is computed here."""
        names = [n for n in params if self.trainable(n)]
        p = [_local(params[n]) for n in names]
        g_full = [grads[n] if grads.get(n) is not None else torch.zeros_like(params[n])
                  for n in names]
        g = [_local(t) for t in g_full]
        if self.grad_clip is not None and g:
            if norm is None and any(a is not b for a, b in zip(g, g_full)):
                norm = global_norm(g_full)
            elif norm is None:
                norm = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(g)).to(torch.float32))
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            g = torch._foreach_mul(g, factor)
        count = int(state["count"])
        if self.name in ("adam", "adamw"):
            mu = [_local(state["mu"][n]) for n in names]
            nu = [_local(state["nu"][n]) for n in names]
            torch._foreach_mul_(mu, _B1)
            torch._foreach_add_(mu, g, alpha=1.0 - _B1)
            torch._foreach_mul_(nu, _B2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - _B2)
            t = count + 1
            u = torch._foreach_div(mu, 1.0 - _B1 ** t)
            den = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - _B2 ** t))
            torch._foreach_add_(den, _EPS)
            torch._foreach_div_(u, den)
            if self.name == "adamw":
                torch._foreach_add_(u, p, alpha=self.weight_decay)
        else:
            tr = [_local(state["trace"][n]) for n in names]
            torch._foreach_mul_(tr, _MOMENTUM)
            torch._foreach_add_(tr, g)
            u = [t.clone() for t in tr]
        torch._foreach_mul_(u, -float(self.schedule(count))
                            * float(state["plateau_factor"]))
        if self.ema_decay is not None:
            ema, upd = state["ema"], dict(zip(names, u))
            for n, pn in params.items():
                pn, en = _local(pn), _local(ema[n])
                new = pn + upd[n] if n in upd else pn
                en.add_(new - en, alpha=1.0 - self.ema_decay)
        torch._foreach_add_(p, u)
        state["count"] = count + 1


def build_optimizer(name: str = "adamw", schedule: Schedule = 1e-3,
                    weight_decay: float = 1e-4, grad_clip: Optional[float] = 1.0,
                    trainable_mask: Optional[Mapping[str, bool]] = None,
                    ema_decay: Optional[float] = None) -> Optimizer:
    """clip → adam(w)/sgd → schedule → plateau factor → freeze mask [→ EMA]."""
    return Optimizer(name, schedule, weight_decay, grad_clip, trainable_mask,
                     ema_decay)


def get_ema_params(opt_state: Mapping[str, Any]) -> Optional[Dict[str, torch.Tensor]]:
    """The params EMA held in an optimizer state, or None."""
    return opt_state.get("ema")


# ---------------------------------------------------------------------------
# host-side callbacks
# ---------------------------------------------------------------------------


class ReduceLROnPlateau:
    """torch-semantics plateau scheduler producing a multiplicative factor,
    fed into the optimizer state's ``plateau_factor``."""

    def __init__(self, mode: str = "min", factor: float = 0.5, patience: int = 10,
                 min_factor: float = 1e-3):
        self.mode = mode
        self.factor_step = factor
        self.patience = patience
        self.min_factor = min_factor
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.factor = 1.0

    def update(self, metric: float) -> float:
        better = (self.best is None
                  or (self.mode == "min" and metric < self.best - 1e-12)
                  or (self.mode == "max" and metric > self.best + 1e-12))
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.factor = max(self.factor * self.factor_step, self.min_factor)
                self.bad_epochs = 0
        return self.factor


class EarlyStopping:
    """Stop after ``patience`` epochs without improvement."""

    def __init__(self, patience: int = 20, mode: str = "max", min_delta: float = 0.0):
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def update(self, metric: float) -> bool:
        better = (self.best is None
                  or (self.mode == "max" and metric > self.best + self.min_delta)
                  or (self.mode == "min" and metric < self.best - self.min_delta))
        if better:
            self.best = metric
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop
