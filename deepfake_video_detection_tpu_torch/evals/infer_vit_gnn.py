"""Single-video ViT-GNN inference CLI on one CUDA card.

Counterpart of ``deepfake_video_detection_tpu/evals/infer_vit_gnn.py``:

    python -m deepfake_video_detection_tpu_torch.evals.infer_vit_gnn clip.npz \\
        --checkpoint checkpoints/vit_gnn_ckpt.npz

loads an ``.npz`` face stack, takes its middle frame scaled to [0, 1]
(resized bilinearly to the ViT's input size where it differs), rebuilds the
ViT-GNN (or the conv fallback) from the checkpoint's ``model_config`` and
keys, and prints the predicted class with the probabilities.
"""

from __future__ import annotations

import argparse
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    load_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.models.vit_gnn import FallbackModel, ViTGNNModel


def build_from_checkpoint(path: str, device: Any = "cuda") -> torch.nn.Module:
    """The model of a ViT-GNN checkpoint with its weights, on ``device``."""
    variables, meta = load_checkpoint(path)
    cfg = meta.get("model_config") or {}
    if cfg.get("fallback") or "conv1" in variables["params"]:
        model = FallbackModel(device=device)
    else:
        model = ViTGNNModel(vit_variant=cfg.get("vit_variant", "vit_small_patch16_224"),
                            img_size=int(cfg.get("img_size", 224)), device=device)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


@torch.inference_mode()
def classify(npz_path: str, checkpoint: str, device: Any = "cuda") -> np.ndarray:
    """Class probabilities (2,) of the middle frame of ``npz_path``."""
    with np.load(npz_path) as z:
        faces = z["faces"]
    model = build_from_checkpoint(checkpoint, device)
    dev = next(model.parameters()).device
    frame = torch.from_numpy(faces[len(faces) // 2]).to(dev).to(torch.float32) / 255.0
    if isinstance(model, ViTGNNModel) and frame.shape[0] != model.vit.img_size:
        s = model.vit.img_size
        frame = F.interpolate(frame.permute(2, 0, 1)[None], size=(s, s), mode="bilinear",
                              align_corners=False, antialias=True)[0].permute(1, 2, 0)
    logits = model(frame[None])
    return torch.softmax(logits, dim=-1)[0].cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Classify one .npz face stack (CUDA)")
    ap.add_argument("npz_path")
    ap.add_argument("--checkpoint", default="checkpoints/vit_gnn_ckpt.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (the card by default)")
    args = ap.parse_args(argv)
    probs = classify(args.npz_path, args.checkpoint, args.device)
    pred = int(probs.argmax())
    print(f"predicted class: {pred} ({'fake' if pred == 1 else 'real'})")
    print(f"probabilities: real={probs[0]:.4f} fake={probs[1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
