"""Improved training CLI on one CUDA card.

Counterpart of ``deepfake_video_detection_tpu/train/cli_improved.py``: the
frame-graph detector (ViT + GCN over the chain graph of a clip's frames)
trained with AdamW, cosine annealing with ReduceLROnPlateau, focal loss
with label smoothing, a class-balanced sampler, a gradient clip of 1.0,
early stopping (``--patience``) and best-by-accuracy checkpoints:

    python -m deepfake_video_detection_tpu_torch.train.cli_improved \\
        --data_dir faces/ --backbone clip
    python -m deepfake_video_detection_tpu_torch.train.cli_improved \\
        --data_dir faces/ --backbone dinov2 --bf16

``--backbone`` is a ViT variant (the ``timm`` flavour; default ViT-Tiny)
or ``clip`` / ``dinov2``, optionally ``clip:<variant>`` (default
ViT-B/16); ``clip`` normalises the frames with the CLIP statistics, the
others with ImageNet's. Every ViT block's attention runs the flash kernels
on the card, forward and backward. ``--init-from`` warm-starts (params
only) and ``--resume`` resumes from a native ``.npz`` or a reference
``.pt``. ``training_history.csv`` is also copied to
``training_metrics_improved.csv``, the reference's name. The parallelism
flags are the JAX CLI's (``--mesh``, ``--fsdp``), one process per device
under ``torchrun``.
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch

from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.models.gcn import FrameGraphDetector
from deepfake_video_detection_tpu_torch.parallel.strategy import add_parallel_args, build_plan
from deepfake_video_detection_tpu_torch.train.cli import make_trainer
from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig


def build_trainer(argv=None):
    """The CLI's ``(trainer, args)`` before training: the model built on
    ``--device`` and the ``Trainer`` around it, with the CLI's config."""
    ap = argparse.ArgumentParser(
        description="Improved trainer (focal, cosine, early stop) (CUDA)")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--backbone", default="vit_tiny_patch16_224",
                    help="vit variant, or 'clip'/'dinov2' (optionally 'clip:<variant>')")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_frames", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=1e-4)
    ap.add_argument("--label_smoothing", type=float, default=0.1)
    ap.add_argument("--patience", type=int, default=20)
    ap.add_argument("--out_dir", default="checkpoints_improved")
    ap.add_argument("--init-from", dest="init_from", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--recursive", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 activations (params stay f32)")
    ap.add_argument("--ema_decay", type=float, default=None,
                    help="params-EMA decay (e.g. 0.999): validation and the "
                         "best checkpoint use the EMA weights")
    ap.add_argument("--grad_accum", type=int, default=1,
                    help="microbatches accumulated per optimizer step")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (the card by default; "
                         "cuda:LOCAL_RANK under torchrun)")
    add_parallel_args(ap, temporal=False)
    args = ap.parse_args(argv)
    plan, _ = build_plan(args, "vit_gcn", args.num_frames, device=args.device)

    ds = VideoFacesDataset(args.data_dir, num_frames=args.num_frames,
                           recursive=args.recursive)
    train_ds, val_ds = ds.split(0.2)
    flavor, variant = "timm", args.backbone
    parts = args.backbone.split(":", 1)
    if parts[0] in ("clip", "dinov2"):
        flavor, variant = parts[0], parts[1] if len(parts) > 1 else "vit_base_patch16_224"
    model = FrameGraphDetector(vit_variant=variant, backbone=flavor,
                               compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                               device=args.device, generator=torch.Generator().manual_seed(0))
    cfg = TrainerConfig(
        out_dir=args.out_dir, epochs=args.epochs, batch_size=args.batch_size,
        num_frames=args.num_frames, lr=args.lr, weight_decay=args.weight_decay,
        optimizer="adamw", schedule="cosine", plateau=True,
        loss="focal", label_smoothing=args.label_smoothing,
        balance="sampler", grad_clip=1.0,
        early_stopping_patience=args.patience, best_metric="accuracy",
        save_every=10, smoke=args.smoke, adjacency="chain",
        normalize="clip" if flavor == "clip" else "imagenet",
        ema_decay=args.ema_decay, grad_accum=args.grad_accum,
        model_config={"model_type": "vit_gcn", "vit_variant": variant,
                      "backbone": flavor},
    )
    return make_trainer(model, train_ds, val_ds, cfg, plan, args.device, Trainer), args


def main(argv=None) -> int:
    trainer, args = build_trainer(argv)
    state = None
    if args.resume:
        state = trainer.resume(args.resume)
    elif args.init_from:
        state = trainer.warm_start(args.init_from)
    trainer.train(state)
    # the reference's name for the history CSV
    src = os.path.join(args.out_dir, "training_history.csv")
    if os.path.exists(src):
        shutil.copyfile(src, os.path.join(args.out_dir, "training_metrics_improved.csv"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
