"""Unified trainer on one CUDA card.

Counterpart of ``deepfake_video_detection_tpu/train/trainer.py`` with the
same config, loop and artefacts: class-weighted CE or focal loss, step /
cosine / warm-restart schedules, ReduceLROnPlateau, early stopping, params
EMA (validation and the best checkpoint use the EMA weights), gradient
accumulation, ``preds_epoch_N.csv``, ``training_history.csv`` rewritten each
epoch, ``calibration_best.json`` from the bounded threshold sweep, per-epoch
/ best / interrupt checkpoints in the JAX package's native ``.npz`` layout,
``resume`` and ``warm_start`` from such a file, and SIGTERM turned into the
interrupt checkpoint. With ``keep_torch_export`` each checkpoint also gets a
``<name>.pt`` in the reference's ``{model_state, model_config}`` layout;
``resume`` and ``warm_start`` also read a reference ``.pt``/``.pth``
(shape-filtered, non-strict, at least half the model matched).

Per step: the loader's uint8 batch goes to the card through pinned memory,
is augmented and normalised there (``data/augment.py``), and one train step
(``train/steps.py``) runs forward, loss, backward (the flash backward kernel
in every ViT block) and the optimizer update. Graph models get the
normalised chain (or full) adjacency over the clip's frames with every
batch (``adjacency``); batch-norm models (EfficientNet, ResNet, the
CNN+LSTM) update their running stats once a forward (each microbatch
under ``grad_accum``), ``remat`` or not.

Differences from the JAX trainer: the model arrives with its weights
(initialised from a generator when it was built), so :meth:`init_state`
builds the optimizer state around them instead of re-initialising from
``seed``; random draws (augment, dropout) come from a ``torch.Generator``
seeded per epoch as the JAX keys are, so they are seeded but not the same
numbers.

``steps_per_call = k > 1`` runs the full-size batches in groups of k
(``train/steps.py::make_multi_step``): each group is stacked on the host
and goes to the card in one transfer, through the same two-deep prefetch
as single batches; the odd-shaped tail batch takes the single step. The
k steps draw augmentation and dropout in the order k single steps draw
them, so the epoch trains as the plain loop does.

Multi-device training (``mesh``, a ``DeviceMesh``, for pure data
parallelism, or ``plan``, ``parallel/strategy.py::build_plan``'s): one
process per device. The plan's placement is applied once, here
(``place_model``: FSDP2, the detector's tensor parallelism; the
``placement [...]`` line and JAX's FSDP warning), or under pure DP every
rank takes rank 0's weights. Each rank's loader draws the epoch's order
and loads only its rows of each batch (padded to ``batch_multiple``), and
its frames under a ``seq`` spec; augmentation draws for the global batch
and keeps its rows (a world of N augments as a world of one), dropout
draws from a generator seeded per data rank. The steps run with the
plan's ``ParallelRuntime``; validation gathers every data rank's rows, so
every rank scores the whole split. Rank 0 alone writes checkpoints (the
whole tensors, FSDP shards and the pipeline stages' blocks and their
optimizer slots gathered, in JAX's layout), the history, the predictions
and the logs; a resume gives each rank its share.

While something records (``utils/profiling.py``), the batch transform runs
inside the span ``train.prep`` (augment and normalise) and each step inside
``train.step`` (``train/steps.py``).
"""

from __future__ import annotations

import contextlib
import csv
import functools
import json
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    load_checkpoint, opt_state_from_leaves, save_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.checkpoint.store import load_any, save_torch_checkpoint
from deepfake_video_detection_tpu_torch.checkpoint.torch_bridge import match_state_dict
from deepfake_video_detection_tpu_torch.data.augment import AugmentConfig, augment_batch
from deepfake_video_detection_tpu_torch.data.dataset import SubsetDataset
from deepfake_video_detection_tpu_torch.data.loader import Loader, prefetch_to_device
from deepfake_video_detection_tpu_torch.data.normalize import (
    clip_normalize, imagenet_normalize)
from deepfake_video_detection_tpu_torch.data.augment import apply_params, draw_params
from deepfake_video_detection_tpu_torch.evals.metrics import (
    binary_metrics, confusion_matrix, real_score_quantiles, roc_auc,
    threshold_sweep)
from deepfake_video_detection_tpu_torch.parallel.mesh import (
    is_main_process, local_device, replicate)
from deepfake_video_detection_tpu_torch.train import losses as losses_mod
from deepfake_video_detection_tpu_torch.train import optim as optim_mod
from deepfake_video_detection_tpu_torch.train.state import TrainState
from deepfake_video_detection_tpu_torch.train.steps import (
    make_accum_step, make_eval_step, make_multi_step, make_train_step)
from deepfake_video_detection_tpu_torch.utils.device import resolve_device
from deepfake_video_detection_tpu_torch.utils.graph import chain_adjacency, normalize_adjacency
from deepfake_video_detection_tpu_torch.utils.profiling import annotate

_METRIC_ALIASES = {
    "acc": "accuracy", "accuracy": "accuracy", "val_acc": "accuracy",
    "val_accuracy": "accuracy",
    "f1": "f1", "f1_score": "f1", "val_f1": "f1",
    "auc": "auc", "roc_auc": "auc",
    "precision": "precision", "recall": "recall",
    "loss": "val_loss", "val_loss": "val_loss",
}


@dataclass
class TrainerConfig:
    out_dir: str = "checkpoints"
    epochs: int = 10
    batch_size: int = 8
    num_frames: int = 16
    lr: float = 1e-3
    weight_decay: float = 1e-4
    optimizer: str = "adamw"
    schedule: str = "step"            # step | cosine | warm_restarts | const
    step_size: int = 5
    step_gamma: float = 0.5
    warm_t0: int = 10
    warm_tmult: int = 2
    loss: str = "ce"                  # ce | focal
    label_smoothing: float = 0.0
    focal_alpha: float = 1.0
    focal_gamma: float = 2.0
    balance: str = "weights"          # weights | sampler | none
    grad_clip: Optional[float] = 1.0
    remat: bool = False               # recompute the forward in the backward
    plateau: bool = False
    plateau_patience: int = 10
    early_stopping_patience: Optional[int] = None
    best_metric: str = "f1"
    threshold_sweep: bool = False
    save_every: int = 1               # per-epoch checkpoint cadence
    keep_torch_export: bool = False   # also write <name>.pt (model_config layout)
    seed: int = 42
    smoke: bool = False
    adjacency: Optional[str] = None   # None | chain | full: for graph models
    augment: bool = True
    normalize: str = "imagenet"       # imagenet | clip | unit (x/255 only)
    compute_dtype: str = "float32"
    steps_per_call: int = 1           # optimizer steps per call (groups of k batches)
    grad_accum: int = 1               # microbatches per optimizer step
    ema_decay: Optional[float] = None  # params EMA, validated and served
    model_config: Dict[str, Any] = field(default_factory=dict)


def _full(t: Any) -> Any:
    """A DTensor's whole tensor (a collective: every rank calls it), else
    ``t``; dicts of them recursively."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, dict):
        return {k: _full(v) for k, v in t.items()}
    return t.full_tensor() if isinstance(t, DTensor) else t


def _shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` placed as ``like``: this rank's shard of it when ``like`` is
    a DTensor (FSDP2's even ``Shard(d)`` chunks)."""
    from torch.distributed.tensor import DTensor, Shard

    out = full.to(like.device, like.dtype)
    if not isinstance(like, DTensor):
        return out
    mesh = like.device_mesh
    for i, pl in enumerate(like.placements):
        if isinstance(pl, Shard):
            out = torch.chunk(out, mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
    return DTensor.from_local(out.contiguous(), mesh, like.placements)


def _unit(x: torch.Tensor, scaled: bool = False) -> torch.Tensor:
    x = x.to(torch.float32)
    return x if scaled else x / 255.0


def _groups(batches, k: int):
    """The loader's batches in groups of ``k`` full-shape batches, each
    leaf stacked on a leading axis of ``k`` (``paths`` dropped); a batch of
    another shape (the tail), and what precedes it short of a group, pass
    singly in their order."""
    group = []
    for batch in batches:
        if group and batch["frames"].shape != group[0]["frames"].shape:
            yield from group
            group = []
        group.append(batch)
        if len(group) == k:
            yield {key: np.stack([b[key] for b in group]) for key in group[0]
                   if key != "paths"}
            group = []
    yield from group


def _quiet(_msg: str) -> None:
    """The log of a rank other than 0."""


class Trainer:
    def __init__(self, model: torch.nn.Module, train_ds: Any, val_ds: Any,
                 config: TrainerConfig, mesh: Optional[Any] = None,
                 fake_index: int = 1, plan: Optional[Any] = None,
                 tx: Optional[optim_mod.Optimizer] = None, device: Any = "cuda"):
        """``tx``: an optimizer overriding the one the config would build.
        ``device``: the card unless the caller names another; the model is
        moved there."""
        from deepfake_video_detection_tpu_torch.parallel import strategy

        if plan is None and mesh is not None:
            plan = strategy.dp_plan(mesh)
        if plan is not None and not plan.pure_dp and config.steps_per_call > 1 \
                and not plan.scan_of_steps_ok:
            raise ValueError(
                "steps_per_call > 1 (scan-of-steps) composes with dp / tp / "
                "fsdp plans only — drop --steps_per_call or the "
                "--seq/--pp_stages/--moe_experts flags")
        self.plan = plan
        self.runtime = None
        self.device = resolve_device(device)
        if plan is not None:
            if plan.mesh is None:
                raise ValueError("the plan was built for another device count "
                                 "(n_devices); build it for this run's world")
            self.device = resolve_device(local_device(self.device))
            self.runtime = strategy.ParallelRuntime(plan.mesh)
        self.model = model.to(self.device)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.cfg = config
        self.fake_index = fake_index
        self.history: List[Dict[str, Any]] = []
        self.best_value: Optional[float] = None
        self.best_epoch = -1
        self.calibration: Dict[str, float] = {}
        self.start_epoch = 0
        if plan is not None and not plan.pure_dp:
            summary = strategy.place_model(self.model, plan.mesh, plan.param_spec_fn)
            if is_main_process():
                print(strategy.placement_line(plan, summary))
            strategy.warn_if_unsharded(plan, summary)
        elif plan is not None:
            replicate(self.model)

        if is_main_process():
            os.makedirs(config.out_dir, exist_ok=True)

        # ---- loss ----
        cw = None
        if config.balance == "weights":
            cw = torch.as_tensor(
                losses_mod.inverse_frequency_class_weights(train_ds.labels()),
                device=self.device)
        if config.loss == "focal":
            self.loss_fn = functools.partial(
                losses_mod.focal_loss, alpha=config.focal_alpha,
                gamma=config.focal_gamma, label_smoothing=config.label_smoothing,
                class_weights=cw)
        else:
            self.loss_fn = functools.partial(
                losses_mod.cross_entropy_loss,
                label_smoothing=config.label_smoothing, class_weights=cw)

        # ---- optimizer / schedule ----
        steps_per_epoch = max(1, len(train_ds) // config.batch_size)
        if config.schedule == "step":
            sched = optim_mod.step_lr_schedule(config.lr, config.step_size,
                                               config.step_gamma, steps_per_epoch)
        elif config.schedule == "cosine":
            sched = optim_mod.cosine_schedule(config.lr, config.epochs,
                                              steps_per_epoch=steps_per_epoch)
        elif config.schedule == "warm_restarts":
            sched = optim_mod.cosine_warm_restarts(config.lr, config.warm_t0,
                                                   config.warm_tmult,
                                                   steps_per_epoch=steps_per_epoch)
        else:
            sched = config.lr
        self.tx = tx if tx is not None else optim_mod.build_optimizer(
            config.optimizer, sched, config.weight_decay, config.grad_clip,
            ema_decay=config.ema_decay)
        self.plateau = optim_mod.ReduceLROnPlateau(
            mode="min", patience=config.plateau_patience) if config.plateau else None
        self.early = optim_mod.EarlyStopping(config.early_stopping_patience) \
            if config.early_stopping_patience else None

        # ---- steps ----
        self.train_step = make_train_step(model, self.tx, self.loss_fn,
                                          remat=config.remat, runtime=self.runtime)
        self.eval_step = make_eval_step(model)

        # ---- adjacency (graph models): a fixed graph over the T frames ----
        self._adjacency = None
        if config.adjacency:
            T = config.num_frames
            A = chain_adjacency(T) if config.adjacency == "chain" else \
                np.ones((T, T), np.float32)
            self._adjacency = normalize_adjacency(A).to(self.device)

        # ---- device-side batch transform: augment (train) + normalise,
        # and the adjacency of each clip ----
        aug_cfg = AugmentConfig()
        norm = {"clip": clip_normalize, "unit": _unit}.get(config.normalize,
                                                           imagenet_normalize)

        def _with_adjacency(batch):
            if self._adjacency is None:
                return batch
            B, T = batch["frames"].shape[:2]
            return dict(batch, adjacency=self._adjacency.expand(B, T, T))

        def _augment(generator, frames):
            if self.runtime is None:
                return augment_batch(generator, frames, aug_cfg)
            # the global batch's draws, this rank's rows of them
            rt, B = self.runtime, frames.shape[0]
            p = draw_params(generator, B * rt.data, (frames.shape[2], frames.shape[3]),
                            aug_cfg, device=frames.device)
            lo = rt.data_rank * B
            return apply_params(frames, {k: v[lo:lo + B] for k, v in p.items()})

        def _prep_train(batch, generator):
            with annotate("train.prep"):
                if config.augment:
                    frames = norm(_augment(generator, batch["frames"]) / 255.0, scaled=True)
                else:
                    frames = norm(batch["frames"])
                return _with_adjacency(dict(batch, frames=frames))

        self._prep_train = _prep_train
        self._prep_eval = lambda batch: _with_adjacency(
            dict(batch, frames=norm(batch["frames"])))

        # ---- k optimizer steps per call over one stacked group ----
        self.multi_step = None
        if config.steps_per_call > 1:
            self.multi_step = make_multi_step(
                model, self.tx, self.loss_fn, config.steps_per_call,
                remat=config.remat, prep=_prep_train, runtime=self.runtime)

        # ---- gradient accumulation: exact big-batch steps, 1/a the memory --
        self.accum_step = None
        if config.grad_accum > 1:
            if config.steps_per_call > 1:
                raise ValueError(
                    "--grad_accum and --steps_per_call are mutually "
                    "exclusive: one fuses k optimizer steps per dispatch, "
                    "the other splits one step into microbatches")
            if config.batch_size % config.grad_accum:
                raise ValueError(
                    f"batch_size ({config.batch_size}) must be divisible by "
                    f"grad_accum ({config.grad_accum})")
            if plan is not None and not plan.pure_dp and not plan.scan_of_steps_ok:
                raise ValueError(
                    "--grad_accum composes with dp / tp / fsdp plans only — "
                    "drop --grad_accum or the --seq/--pp_stages/"
                    "--moe_experts flags")
            n_data = self.runtime.data if self.runtime is not None else 1
            if (config.batch_size // config.grad_accum) % max(n_data, 1):
                raise ValueError(
                    f"microbatch size ({config.batch_size} / "
                    f"{config.grad_accum}) must be divisible by the data-axis "
                    f"size ({n_data})")

            def _sample_weight(labels, valid):
                # the loss's weights (class weight × validity), so microbatch
                # gradients recombine to the full-batch gradient
                w = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
                if cw is not None:
                    w = w * cw[labels]
                if valid is not None:
                    w = w * valid.to(torch.float32)
                return w

            self.accum_step = make_accum_step(
                model, self.tx, self.loss_fn, config.grad_accum,
                remat=config.remat, prep=_prep_train,
                sample_weight_fn=_sample_weight, runtime=self.runtime)

    # ------------------------------------------------------------------
    # state init / resume
    # ------------------------------------------------------------------

    def init_state(self) -> TrainState:
        """The optimizer state around the model's current weights."""
        return TrainState.create(self.model, self.tx)

    def _load_params(self, path: str) -> Dict[str, Any]:
        """Load a checkpoint's weights into the model and return its meta: a
        native ``.npz`` strictly, a reference ``.pt``/``.pth`` through a
        shape-filtered non-strict import that must match at least half the
        model (else ``ValueError``, the model untouched)."""
        if path.endswith((".pt", ".pth")):
            sd, meta = load_any(path)
            load, report = match_state_dict(self.model, sd)
            if report["match_ratio"] < 0.5:
                raise ValueError(f"checkpoint {path} matches only "
                                 f"{report['match_ratio']:.0%} of the model")
            self.model.load_state_dict(load, strict=False)
            return meta
        variables, meta = load_checkpoint(path)
        self._load_state_dict(state_dict_from_jax(variables))
        return meta

    def _held_elsewhere(self, name: str, own) -> bool:
        """Whether ``name`` is a block another pipeline stage holds."""
        return name not in own and self.runtime is not None and \
            self.runtime.stage_local(name)

    def _load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Strict load; FSDP2's DTensor entries take their shard, and a
        pipeline stage its blocks."""
        own = self.model.state_dict()
        missing = sorted(set(own) - set(sd))
        extra = sorted(k for k in set(sd) - set(own) if not self._held_elsewhere(k, own))
        if missing or extra:
            raise RuntimeError(f"state_dict mismatch: missing {missing[:5]}, "
                               f"unexpected {extra[:5]}")
        with torch.no_grad():
            for k, t in own.items():
                t.copy_(_shard_like(sd[k], t))

    def resume(self, path: str, state: Optional[TrainState] = None) -> TrainState:
        """Restore params, optimizer state, step and epoch from a checkpoint
        this trainer wrote (a ``.pt`` restores params, and epoch and step
        where its meta has them, with a fresh optimizer state)."""
        state = state if state is not None else self.init_state()
        meta = self._load_params(path)
        if meta.get("_opt_leaves") is not None and meta.get("opt_names"):
            opt = opt_state_from_leaves(meta["opt_names"], meta["_opt_leaves"],
                                        self.device)
            params = state.params
            state.opt_state = {k: ({n: _shard_like(t, params[n]) for n, t in v.items()
                                    if not self._held_elsewhere(n, params)}
                                   if isinstance(v, dict) else v) for k, v in opt.items()}
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_value = meta.get("best_value")
        state.step = int(meta.get("step", 0))
        return state

    def warm_start(self, path: str, state: Optional[TrainState] = None) -> TrainState:
        """Params-only init from a native ``.npz`` or a reference ``.pt``
        (``--init-from``); the optimizer state stays fresh."""
        state = state if state is not None else self.init_state()
        self._load_params(path)
        return state

    # ------------------------------------------------------------------
    # epoch loops
    # ------------------------------------------------------------------

    def _make_loader(self, ds, train: bool, epoch: int = 0) -> Loader:
        if self.cfg.smoke:
            base = getattr(ds, "base", ds)
            idx = getattr(ds, "indices", list(range(len(ds))))[:16]
            ds = SubsetDataset(base, idx)
        shard, mult = (0, 1), 1
        if self.runtime is not None:
            shard = (self.runtime.data_rank, self.runtime.data)
            mult = int(self.plan.batch_multiple)
        loader = Loader(ds, self.cfg.batch_size, shuffle=train,
                        weighted=train and self.cfg.balance == "sampler",
                        seed=self.cfg.seed, num_workers=4,
                        pad_to_multiple=mult, shard=shard)
        # indices come from rng(seed + epoch): a fresh order per epoch, and a
        # resumed run at epoch k draws the order an uninterrupted run would
        loader.epoch = epoch
        return loader

    def _generator(self, epoch: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.seed * 9973 + epoch)

    def _model_generator(self, epoch: int) -> torch.Generator:
        """Dropout's draws under a mesh: a stream for each data rank (the
        ranks of one data row draw alike)."""
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.seed * 9973 + epoch + 1_000_003 * (self.runtime.data_rank + 1))

    def _frames_shard(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's frames under a plan whose ``frames`` spec splits the
        clip axis (the loader already took the rows)."""
        spec = self.plan.batch_spec("frames") if self.plan is not None else ()
        if len(spec) < 2 or spec[1] is None:
            return batch
        from deepfake_video_detection_tpu_torch.parallel.mesh import axis_rank, axis_size

        n, r = axis_size(self.plan.mesh, spec[1]), axis_rank(self.plan.mesh, spec[1])
        T = batch["frames"].shape[1] // n
        return dict(batch, frames=batch["frames"][:, r * T:(r + 1) * T])

    def _device_batches(self, ds, train: bool, epoch: int = 0):
        return prefetch_to_device(self._make_loader(ds, train, epoch), self.device,
                                  transform=self._frames_shard)

    def train_epoch(self, state: TrainState, epoch: int) -> tuple:
        if self.accum_step is not None:
            return self._train_epoch_accum(state, epoch)
        gen = self._generator(epoch)
        model_gen = gen if self.runtime is None else self._model_generator(epoch)
        tot_loss, tot_correct, tot_count = 0.0, 0, 0
        t0 = time.time()
        if self.multi_step is None:
            batches = self._device_batches(self.train_ds, True, epoch)
        else:   # one transfer a group of k
            batches = prefetch_to_device(_groups(self._make_loader(self.train_ds, True, epoch),
                                                 self.cfg.steps_per_call), self.device)
        for batch in batches:
            batch.pop("paths", None)
            if batch["labels"].dim() == 2:      # a stacked group
                state, metrics = self.multi_step(state, batch, gen, model_gen)
            else:
                state, metrics = self.train_step(state, self._prep_train(batch, gen),
                                                 model_gen)
            n = int(metrics["count"])
            tot_loss += float(metrics["loss"]) * n
            tot_correct += int(metrics["correct"])
            tot_count += n
        return state, {
            "train_loss": tot_loss / max(tot_count, 1),
            "train_acc": tot_correct / max(tot_count, 1),
            "epoch_time_s": time.time() - t0,
        }

    def _train_epoch_accum(self, state: TrainState, epoch: int) -> tuple:
        """``grad_accum > 1``: each batch (the tail padded to full size with
        ``valid=False`` rows) is split into ``(a, B/a, ...)`` microbatches and
        run as one optimizer step."""
        gen = self._generator(epoch)
        a, B = self.cfg.grad_accum, self.cfg.batch_size
        if self.runtime is not None:      # this rank's rows of each batch
            B //= self.runtime.data
        tot_loss, tot_correct, tot_count = 0.0, 0, 0
        t0 = time.time()
        for batch in self._device_batches(self.train_ds, True, epoch):
            batch.pop("paths", None)
            n = batch["frames"].shape[0]
            micro = {}
            for key, v in batch.items():
                if n < B:  # tail: pad to full size; zeros => valid False
                    v = torch.cat([v, v.new_zeros((B - n,) + tuple(v.shape[1:]))])
                micro[key] = v.reshape((a, B // a) + tuple(v.shape[1:]))
            state, metrics = self.accum_step(state, micro, gen)
            n = int(metrics["count"])
            tot_loss += float(metrics["loss"]) * n
            tot_correct += int(metrics["correct"])
            tot_count += n
        return state, {
            "train_loss": tot_loss / max(tot_count, 1),
            "train_acc": tot_correct / max(tot_count, 1),
            "epoch_time_s": time.time() - t0,
        }

    @contextlib.contextmanager
    def _eval_weights(self, state: TrainState):
        """What validation scores: the EMA weights when ``ema_decay`` is set
        (swapped into the model for the duration), else the live params."""
        ema = optim_mod.get_ema_params(state.opt_state) if self.cfg.ema_decay else None
        if ema is None:
            yield
            return
        params = state.params
        live = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(ema[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(live[n])

    def validate(self, state: TrainState, epoch: int,
                 write_preds: bool = True) -> Dict[str, Any]:
        probs_all, labels_all, paths_all, losses = [], [], [], []
        with self._eval_weights(state):
            for batch in self._device_batches(self.val_ds, False):
                paths = batch.pop("paths", [])
                valid = batch.pop("valid").cpu().numpy()
                batch = self._prep_eval(batch)
                out = self.eval_step(batch)
                probs = out["probs"].cpu().numpy()[valid]
                labels = batch["labels"].cpu().numpy()[valid]
                logits = out["logits"].float().cpu().numpy()[valid]
                if labels.size:
                    lp = logits - logits.max(-1, keepdims=True)
                    lse = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
                    losses.append(float(-lse[np.arange(labels.size), labels].mean()))
                probs_all.append(probs)
                labels_all.append(labels)
                paths_all.extend([p for p, v in zip(paths, valid) if v])
        if self.runtime is not None:      # every data rank's rows, in order
            parts = self.runtime.gather_rows((probs_all, labels_all, paths_all, losses))
            probs_all = [a for p in parts for a in p[0]]
            labels_all = [a for p in parts for a in p[1]]
            paths_all = [a for p in parts for a in p[2]]
            losses = [a for p in parts for a in p[3]]
        probs = np.concatenate(probs_all) if probs_all else np.zeros((0, 2))
        labels = np.concatenate(labels_all) if labels_all else np.zeros((0,), np.int64)
        prob_fake = probs[:, self.fake_index] if probs.size else np.zeros((0,))
        preds = np.argmax(probs, axis=-1) if probs.size else np.zeros((0,), np.int64)

        m = binary_metrics(labels, preds, positive=self.fake_index)
        m["auc"] = roc_auc((labels == self.fake_index).astype(np.int64), prob_fake)
        m["val_loss"] = float(np.mean(losses)) if losses else 0.0
        m["confusion"] = confusion_matrix(labels, preds).tolist()
        if self.cfg.threshold_sweep and labels.size:
            m.update(threshold_sweep(labels, prob_fake, fake_index=self.fake_index))
            rq = real_score_quantiles(labels, prob_fake, fake_index=self.fake_index)
            if rq is not None:
                m["real_score_quantiles"] = rq
        if write_preds and is_main_process():
            self._write_preds_csv(epoch, paths_all, labels, preds, prob_fake)
        return m

    # ------------------------------------------------------------------
    # artefacts (CSV / calibration / checkpoints)
    # ------------------------------------------------------------------

    def _write_preds_csv(self, epoch, paths, labels, preds, prob_fake):
        path = os.path.join(self.cfg.out_dir, f"preds_epoch_{epoch}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["path", "label", "pred", "prob_fake"])
            for row in zip(paths, labels.tolist(), preds.tolist(), prob_fake.tolist()):
                w.writerow(row)

    def _write_history(self):
        """Rewrite ``training_history.csv`` each epoch."""
        if not self.history or not is_main_process():
            return
        path = os.path.join(self.cfg.out_dir, "training_history.csv")
        keys = sorted({k for row in self.history for k in row
                       if not isinstance(row[k], (list, dict))})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
            w.writeheader()
            for row in self.history:
                w.writerow({k: row.get(k, "") for k in keys})

    def _write_calibration(self, metrics: Dict[str, Any], epoch: int):
        """``calibration_best.json``: the sweep's best thresholds and the
        real-class score quantiles serving's windowed threshold reads."""
        self.calibration = {
            "best_thr_accuracy": metrics.get("best_thr_accuracy", 0.5),
            "best_accuracy": metrics.get("best_accuracy", metrics.get("accuracy", 0.0)),
            "best_thr_f1": metrics.get("best_thr_f1", 0.5),
            "best_f1": metrics.get("best_f1", metrics.get("f1", 0.0)),
            "epoch": epoch,
        }
        if metrics.get("real_score_quantiles") is not None:
            self.calibration["real_score_quantiles"] = metrics["real_score_quantiles"]
        if not is_main_process():
            return
        with open(os.path.join(self.cfg.out_dir, "calibration_best.json"), "w") as f:
            json.dump(self.calibration, f, indent=2)

    def _ckpt_meta(self, epoch: int, metrics: Dict[str, Any]) -> Dict[str, Any]:
        return {"epoch": epoch,
                "metrics": {k: v for k, v in metrics.items()
                            if isinstance(v, (int, float))},
                "best_value": self.best_value,
                "model_config": self.cfg.model_config}

    def save(self, state: TrainState, name: str, epoch: int,
             metrics: Dict[str, Any], with_opt: bool = True):
        path = os.path.join(self.cfg.out_dir, f"{name}.npz")
        meta = self._ckpt_meta(epoch, metrics)
        ema = optim_mod.get_ema_params(state.opt_state) if self.cfg.ema_decay else None
        if ema is not None:
            # the metrics were scored on the EMA weights: tag both files
            meta = dict(meta, metrics_scored_on="ema")
        # whole tensors on every rank (FSDP2 gathers its shards, the stages
        # their blocks), rank 0 writes
        gather = self.runtime.gather_stages if self.runtime is not None else (lambda d: d)
        sd = gather(_full(self.model.state_dict()))
        opt_state = ({k: gather(v) if isinstance(v, dict) else v
                      for k, v in _full(state.opt_state).items()} if with_opt else None)
        ema = gather(_full(ema)) if ema is not None else None
        if not is_main_process():
            return
        save_checkpoint(path, sd, meta, opt_state=opt_state, step=state.step)
        if ema is not None:
            # the EMA params with the live batch-norm statistics, as served
            save_checkpoint(os.path.join(self.cfg.out_dir, f"{name}_ema.npz"),
                            {k: ema.get(k, v) for k, v in sd.items()},
                            meta, step=state.step)
        if self.cfg.keep_torch_export:
            save_torch_checkpoint(os.path.join(self.cfg.out_dir, f"{name}.pt"),
                                  sd, layout="model_config",
                                  meta={"model_config": self.cfg.model_config})

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def _metric_value(self, metrics: Dict[str, Any]) -> tuple:
        key = _METRIC_ALIASES.get(self.cfg.best_metric.lower(), "f1")
        if key == "val_loss":
            return -float(metrics.get("val_loss", np.inf)), key
        return float(metrics.get(key, 0.0)), key

    @staticmethod
    @contextlib.contextmanager
    def _sigterm_as_interrupt():
        """SIGTERM (a preempted job) becomes ``KeyboardInterrupt``, so the
        interrupt checkpoint is written. Main thread only."""
        if threading.current_thread() is not threading.main_thread():
            yield
            return
        prev = signal.getsignal(signal.SIGTERM)

        def _raise(signum, frame):
            raise KeyboardInterrupt("SIGTERM (preemption)")

        signal.signal(signal.SIGTERM, _raise)
        try:
            yield
        finally:
            signal.signal(signal.SIGTERM, prev)

    def train(self, state: Optional[TrainState] = None,
              log: Callable[[str], None] = print) -> TrainState:
        state = state if state is not None else self.init_state()
        if not is_main_process():
            log = _quiet
        epoch = self.start_epoch
        with self._sigterm_as_interrupt():
            try:
                for epoch in range(self.start_epoch, self.cfg.epochs):
                    state, train_m = self.train_epoch(state, epoch)
                    val_m = self.validate(state, epoch)
                    value, key = self._metric_value(val_m)

                    row = {"epoch": epoch, **train_m,
                           **{k: v for k, v in val_m.items() if k != "confusion"}}
                    self.history.append(row)
                    self._write_history()
                    if self.cfg.threshold_sweep and (
                            self.best_value is None or value > self.best_value):
                        self._write_calibration(val_m, epoch)

                    if self.plateau is not None:
                        state.opt_state["plateau_factor"] = self.plateau.update(
                            val_m["val_loss"])

                    if self.cfg.save_every and (epoch + 1) % self.cfg.save_every == 0:
                        self.save(state, f"checkpoint_epoch_{epoch}", epoch, val_m)
                    if self.best_value is None or value > self.best_value:
                        self.best_value = value
                        self.best_epoch = epoch
                        self.save(state, "checkpoint_best", epoch, val_m)
                        self.save(state, f"checkpoint_best_epoch_{epoch}", epoch,
                                  val_m, with_opt=False)

                    log(f"epoch {epoch}: loss={train_m['train_loss']:.4f} "
                        f"acc={train_m['train_acc']:.4f} val_acc={val_m['accuracy']:.4f} "
                        f"val_f1={val_m['f1']:.4f} val_auc={val_m['auc']:.4f} "
                        f"({key}={value:.4f}, best={self.best_value:.4f}@{self.best_epoch}) "
                        f"[{train_m['epoch_time_s']:.1f}s]")

                    if self.early is not None and self.early.update(value):
                        log(f"early stopping at epoch {epoch} "
                            f"(no improvement for {self.early.patience})")
                        break
            except KeyboardInterrupt:
                # epoch - 1 in the meta makes resume() restart at the
                # interrupted epoch
                self.save(state, "checkpoint_interrupt", epoch - 1, {})
                log("interrupted — wrote checkpoint_interrupt.npz "
                    "(resume with --resume)")
                raise
        return state
