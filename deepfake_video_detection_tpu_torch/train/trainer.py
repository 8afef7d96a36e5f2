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
numbers. Not ported (each raises ``NotImplementedError``): meshes and
parallel plans, and ``steps_per_call > 1``.
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
from deepfake_video_detection_tpu_torch.evals.metrics import (
    binary_metrics, confusion_matrix, real_score_quantiles, roc_auc,
    threshold_sweep)
from deepfake_video_detection_tpu_torch.train import losses as losses_mod
from deepfake_video_detection_tpu_torch.train import optim as optim_mod
from deepfake_video_detection_tpu_torch.train.state import TrainState
from deepfake_video_detection_tpu_torch.train.steps import (
    make_accum_step, make_eval_step, make_train_step)
from deepfake_video_detection_tpu_torch.utils.device import resolve_device
from deepfake_video_detection_tpu_torch.utils.graph import chain_adjacency, normalize_adjacency

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1)"

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
    steps_per_call: int = 1           # only 1 is ported
    grad_accum: int = 1               # microbatches per optimizer step
    ema_decay: Optional[float] = None  # params EMA, validated and served
    model_config: Dict[str, Any] = field(default_factory=dict)


def _unit(x: torch.Tensor, scaled: bool = False) -> torch.Tensor:
    x = x.to(torch.float32)
    return x if scaled else x / 255.0


class Trainer:
    def __init__(self, model: torch.nn.Module, train_ds: Any, val_ds: Any,
                 config: TrainerConfig, mesh: Optional[Any] = None,
                 fake_index: int = 1, plan: Optional[Any] = None,
                 tx: Optional[optim_mod.Optimizer] = None, device: Any = "cuda"):
        """``tx``: an optimizer overriding the one the config would build.
        ``device``: the card unless the caller names another; the model is
        moved there."""
        if mesh is not None or plan is not None:
            raise NotImplementedError(f"meshes and parallel plans {_NOT_PORTED} (item 18)")
        if config.steps_per_call > 1:
            raise NotImplementedError(f"steps_per_call > 1 {_NOT_PORTED} (item 21)")
        self.device = resolve_device(device)
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
                                          remat=config.remat)
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

        def _prep_train(batch, generator):
            if config.augment:
                frames = norm(augment_batch(generator, batch["frames"], aug_cfg)
                              / 255.0, scaled=True)
            else:
                frames = norm(batch["frames"])
            return _with_adjacency(dict(batch, frames=frames))

        self._prep_train = _prep_train
        self._prep_eval = lambda batch: _with_adjacency(
            dict(batch, frames=norm(batch["frames"])))

        # ---- gradient accumulation: exact big-batch steps, 1/a the memory --
        self.accum_step = None
        if config.grad_accum > 1:
            if config.batch_size % config.grad_accum:
                raise ValueError(
                    f"batch_size ({config.batch_size}) must be divisible by "
                    f"grad_accum ({config.grad_accum})")

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
                sample_weight_fn=_sample_weight)

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
        self.model.load_state_dict(state_dict_from_jax(variables), strict=True)
        return meta

    def resume(self, path: str, state: Optional[TrainState] = None) -> TrainState:
        """Restore params, optimizer state, step and epoch from a checkpoint
        this trainer wrote (a ``.pt`` restores params, and epoch and step
        where its meta has them, with a fresh optimizer state)."""
        state = state if state is not None else self.init_state()
        meta = self._load_params(path)
        if meta.get("_opt_leaves") is not None and meta.get("opt_names"):
            state.opt_state = opt_state_from_leaves(
                meta["opt_names"], meta["_opt_leaves"], self.device)
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
        loader = Loader(ds, self.cfg.batch_size, shuffle=train,
                        weighted=train and self.cfg.balance == "sampler",
                        seed=self.cfg.seed, num_workers=4)
        # indices come from rng(seed + epoch): a fresh order per epoch, and a
        # resumed run at epoch k draws the order an uninterrupted run would
        loader.epoch = epoch
        return loader

    def _generator(self, epoch: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.seed * 9973 + epoch)

    def _device_batches(self, ds, train: bool, epoch: int = 0):
        return prefetch_to_device(self._make_loader(ds, train, epoch), self.device)

    def train_epoch(self, state: TrainState, epoch: int) -> tuple:
        if self.accum_step is not None:
            return self._train_epoch_accum(state, epoch)
        gen = self._generator(epoch)
        tot_loss, tot_correct, tot_count = 0.0, 0, 0
        t0 = time.time()
        for batch in self._device_batches(self.train_ds, True, epoch):
            batch.pop("paths", None)
            batch = self._prep_train(batch, gen)
            state, metrics = self.train_step(state, batch, gen)
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
        if write_preds:
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
        if not self.history:
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
        save_checkpoint(path, self.model.state_dict(), meta,
                        opt_state=state.opt_state if with_opt else None,
                        step=state.step)
        if ema is not None:
            # the EMA params with the live batch-norm statistics, as served
            save_checkpoint(os.path.join(self.cfg.out_dir, f"{name}_ema.npz"),
                            {k: ema.get(k, v) for k, v in self.model.state_dict().items()},
                            meta, step=state.step)
        if self.cfg.keep_torch_export:
            save_torch_checkpoint(os.path.join(self.cfg.out_dir, f"{name}.pt"),
                                  self.model.state_dict(), layout="model_config",
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
