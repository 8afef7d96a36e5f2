"""Ensemble training CLI on one CUDA card.

Counterpart of ``deepfake_video_detection_tpu/train/cli_ensemble.py``, the
command line of the reference's ``EnsembleTrainer``:

    python -m deepfake_video_detection_tpu_torch.train.cli_ensemble --data_dir faces/

trains an ``EnsembleDetector`` (members ``efficientnet_b0,resnet18`` and
``average`` by default) with AdamW + CosineWarmRestarts(10, 2),
inverse-frequency class weights, a gradient clip of 1.0 and the bounded
threshold sweep each epoch, so the best epoch's ``calibration_best.json``
is written beside ``checkpoint_best.npz`` (``--torch-export`` adds
``checkpoint_best.pt``), with ``training_history.csv``, best-by-
``--best_metric`` and the interrupt checkpoint. ``--resume`` reads a native
``.npz`` or a reference ``.pt``. The parallelism flags are the JAX CLI's
(``--mesh``, ``--fsdp``; ``--mesh model=N`` shards every member's head),
one process per device under ``torchrun``; ``--steps_per_call k`` runs k
optimizer steps a call.
"""

from __future__ import annotations

import argparse

import torch

from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.models.backbone_detector import EnsembleDetector
from deepfake_video_detection_tpu_torch.parallel.strategy import add_parallel_args, build_plan
from deepfake_video_detection_tpu_torch.train.cli import make_trainer
from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train an ensemble of backbone detectors (CUDA)")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--backbones", default="efficientnet_b0,resnet18",
                    help="comma-separated member backbones")
    ap.add_argument("--ensemble_method", default="average",
                    choices=["average", "weighted", "voting"])
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_frames", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=1e-4)
    ap.add_argument("--best_metric", default="f1",
                    help="accuracy|f1|auc|loss (aliases accepted)")
    ap.add_argument("--out_dir", default="checkpoints_ensemble")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--recursive", action="store_true")
    ap.add_argument("--torch-export", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 activations (params stay f32)")
    ap.add_argument("--no-augment", dest="no_augment", action="store_true")
    ap.add_argument("--steps_per_call", type=int, default=1,
                    help="optimizer steps a call, over one stacked transfer of "
                         "their batches")
    ap.add_argument("--grad_accum", type=int, default=1,
                    help="microbatches accumulated per optimizer step")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (the card by default; "
                         "cuda:LOCAL_RANK under torchrun)")
    add_parallel_args(ap, temporal=False)
    args = ap.parse_args(argv)
    # members keep BackboneDetector's leaf names (models.i.fc1.weight), so
    # the detector's TP rules apply to every member
    plan, _ = build_plan(args, "pretrained", args.num_frames, device=args.device)

    backbones = [b.strip() for b in args.backbones.split(",") if b.strip()]
    ds = VideoFacesDataset(args.data_dir, num_frames=args.num_frames,
                           recursive=args.recursive)
    train_ds, val_ds = ds.split(0.2)
    model = EnsembleDetector(backbones, ensemble_method=args.ensemble_method,
                             compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                             device=args.device, generator=torch.Generator().manual_seed(0))
    cfg = TrainerConfig(
        out_dir=args.out_dir, epochs=args.epochs, batch_size=args.batch_size,
        num_frames=args.num_frames, lr=args.lr, weight_decay=args.weight_decay,
        optimizer="adamw", schedule="warm_restarts", warm_t0=10, warm_tmult=2,
        loss="ce", balance="weights", grad_clip=1.0,
        best_metric=args.best_metric, threshold_sweep=True,
        smoke=args.smoke, keep_torch_export=args.torch_export,
        augment=not args.no_augment, steps_per_call=args.steps_per_call,
        grad_accum=args.grad_accum,
        model_config={"model_type": "ensemble", "backbones": backbones,
                      "ensemble_method": args.ensemble_method})
    trainer = make_trainer(model, train_ds, val_ds, cfg, plan, args.device, Trainer)
    state = trainer.resume(args.resume) if args.resume else None
    trainer.train(state)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
