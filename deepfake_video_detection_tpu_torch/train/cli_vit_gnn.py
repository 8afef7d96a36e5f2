"""ViT-GNN smoke trainer on one CUDA card.

Counterpart of ``deepfake_video_detection_tpu/train/cli_vit_gnn.py``:

    python -m deepfake_video_detection_tpu_torch.train.cli_vit_gnn --epochs 3

trains the patch-graph classifier (``models/vit_gnn.py``, ViT-S/16 by
default; the small conv net with ``--fallback``) on ``--samples``
synthetic images (class 1 bright, class 0 dark, from seed 0), one full
batch per epoch with AdamW, and saves ``checkpoints/vit_gnn_ckpt.npz`` in
the JAX package's native layout, which the JAX package reads. Weights from
a generator seeded 0; f32 throughout, so every ViT block runs the f32
flash kernels forward and backward.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.checkpoint.bridge import save_checkpoint
from deepfake_video_detection_tpu_torch.models.vit_gnn import FallbackModel, ViTGNNModel
from deepfake_video_detection_tpu_torch.train.losses import cross_entropy_loss
from deepfake_video_detection_tpu_torch.train.optim import build_optimizer
from deepfake_video_detection_tpu_torch.utils.device import resolve_device


def synthetic_images(samples: int, img_size: int):
    """``(images (S, H, W, 3) f32 in [0, 1], labels (S,))``, seed 0."""
    rng = np.random.default_rng(0)
    labels = np.arange(samples) % 2
    images = np.stack([
        rng.normal(0.7 if lab else 0.3, 0.1, (img_size, img_size, 3)).clip(0, 1)
        for lab in labels]).astype(np.float32)
    return images, labels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke-train the ViT-GNN model (CUDA)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--img_size", type=int, default=224)
    ap.add_argument("--vit", default="vit_small_patch16_224")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--fallback", action="store_true")
    ap.add_argument("--out", default="checkpoints/vit_gnn_ckpt.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (the card by default)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = FallbackModel(device=dev) if args.fallback else \
        ViTGNNModel(vit_variant=args.vit, img_size=args.img_size, device=dev)
    images, labels = synthetic_images(args.samples, args.img_size)
    images = torch.from_numpy(images).to(dev)
    labels = torch.from_numpy(labels).to(dev)

    # optax.adamw's defaults: weight decay 1e-4, no clipping
    tx = build_optimizer("adamw", args.lr, weight_decay=1e-4, grad_clip=None)
    params = dict(model.named_parameters())
    opt_state = tx.init(params)
    for epoch in range(args.epochs):
        t0 = time.time()
        logits = model(images, train=True)
        loss = cross_entropy_loss(logits, labels)
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.step(params, dict(zip(params, grads)), opt_state)
        acc = (logits.argmax(-1) == labels).float().mean()
        print(f"epoch {epoch}: loss={float(loss.detach()):.4f} acc={float(acc):.3f} "
              f"[{time.time() - t0:.1f}s]")

    save_checkpoint(args.out, model.state_dict(),
                    meta={"model_config": {"model_type": "vit_gnn",
                                           "vit_variant": args.vit,
                                           "img_size": args.img_size,
                                           "fallback": bool(args.fallback)}})
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
