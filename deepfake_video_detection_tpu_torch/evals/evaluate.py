"""Evaluation CLI on one CUDA card.

Counterpart of ``deepfake_video_detection_tpu/evals/evaluate.py`` for the
pretrained detector and the temporal transformer:

    python -m deepfake_video_detection_tpu_torch.evals.evaluate --data_dir faces/ \\
        --checkpoint ckpt/checkpoint_best.npz --num_frames 1024 --batch_size 2 --bf16

Loads a native ``.npz`` or a reference ``.pt`` checkpoint
(``checkpoint/store.py::load_any``), rebuilds the model from its embedded
``model_config`` with the JAX evaluator's architecture inference (the
temporal ``d_model`` from ``cls_token`` or ``proj.weight``, the depth from
the ``blocks.*`` keys, pipeline-layout checkpoints renumbered to the loop
layout), loads the weights shape-filtered, runs batched inference over a
``VideoFacesDataset`` and prints the metric set (accuracy, precision,
recall, F1, report, confusion matrix, AUC; ``--sweep`` for the threshold
sweep), writing ``path,label,prob_fake,pred`` rows to a CSV.

On the card each batch is normalised by the fused-normalize kernel (K1)
into the compute dtype, as serving does, and the whole forward runs under
``torch.inference_mode()``; a long clip's temporal blocks run the flash
kernel in its streaming regime (N > 512). Not ported, each raising
``NotImplementedError`` with its ROADMAP item: the other model families
(ensembles, rnn, vit_gcn, cnn_lstm: item 16), ``--from-videos`` and
``--quantize int8``.
"""

from __future__ import annotations

import argparse
import csv
import os
import re
from typing import Any, Mapping, Optional

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.checkpoint.store import load_any
from deepfake_video_detection_tpu_torch.checkpoint.torch_bridge import import_into_model
from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.data.loader import Loader, prefetch_to_device
from deepfake_video_detection_tpu_torch.evals.metrics import full_metrics, threshold_sweep
from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
    TemporalTransformerDetector, infer_mlp_kwargs, normalize_state_dict)
from deepfake_video_detection_tpu_torch.ops.preprocess import fused_normalize

def build_model_from_checkpoint(sd: Mapping[str, Any], meta: Mapping[str, Any],
                                model_type: str,
                                compute_dtype: Optional[torch.dtype] = None,
                                device: Any = "cuda"):
    """``(model, report, model_type)``: the model rebuilt from a
    checkpoint's flat torch-layout state dict and meta, its weights loaded
    (``report`` from :func:`import_into_model`). ``compute_dtype``: the
    activations' dtype (params stay f32)."""
    cfg = meta.get("model_config") or {}
    kw = {"compute_dtype": compute_dtype or torch.float32, "device": device}
    mt = model_type or cfg.get("model_type", "")
    if not mt:
        # the keys by which the JAX evaluator tells the ensemble, rnn,
        # vit_gcn and cnn_lstm families from a plain detector
        other = re.compile(r"(models\.\d+|logic_cells|vit|gcn|cnn)\.")
        mt = ("ensemble, rnn, vit_gcn or cnn_lstm" if any(other.match(k) for k in sd)
              else "pretrained")
    if mt not in ("pretrained", "temporal", "temporal_transformer"):
        raise NotImplementedError(f"model type {mt!r} is not ported to the evaluator "
                                  f"yet (ROADMAP Queue 1 item 16)")
    if mt in ("temporal", "temporal_transformer"):
        sd = normalize_state_dict(dict(sd))
        use_cls = "cls_token" in sd
        if use_cls:
            d_model = int(np.shape(sd["cls_token"])[-1])
        elif "proj.weight" in sd:
            d_model = int(np.shape(sd["proj.weight"])[0])
        else:
            d_model = cfg.get("d_model", 256)
        depth = cfg.get("depth") or 1 + max(
            (int(k.split(".")[1]) for k in sd if k.startswith("blocks.")),
            default=3)
        model = TemporalTransformerDetector(
            cfg.get("backbone", "efficientnet_b0"), d_model=d_model, depth=depth,
            num_heads=cfg.get("num_heads", 4), use_cls=use_cls,
            **infer_mlp_kwargs(sd, d_model, cfg), **kw)
    else:
        model = BackboneDetector(cfg.get("backbone", "efficientnet_b0"), **kw)
    return model, import_into_model(model, sd), mt


def evaluate_dataset(model: torch.nn.Module, ds: Any, batch_size: int = 8,
                     fake_index: int = 1):
    """Inference over the dataset on the model's device; returns
    ``(paths, labels, prob_fake)`` for the valid rows."""
    device = next(model.parameters()).device
    compute_dtype = getattr(model, "compute_dtype", torch.float32)

    @torch.inference_mode()
    def forward(frames_u8: torch.Tensor) -> torch.Tensor:
        logits, _ = model(fused_normalize(frames_u8, out_dtype=compute_dtype))
        return torch.softmax(logits.to(torch.float32), dim=-1)

    paths_all, labels_all, probs_all = [], [], []
    for batch in prefetch_to_device(Loader(ds, batch_size, shuffle=False), device):
        probs = forward(batch["frames"]).cpu().numpy()
        valid = batch["valid"].cpu().numpy()
        probs_all.append(probs[valid])
        labels_all.append(batch["labels"].cpu().numpy()[valid])
        paths_all.extend(p for p, v in zip(batch["paths"], valid) if v)
    probs = np.concatenate(probs_all)
    return paths_all, np.concatenate(labels_all), probs[:, fake_index]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Evaluate a checkpoint on a faces dataset (CUDA)")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--model", default="", help="pretrained|temporal "
                                                "(default: infer from checkpoint)")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_frames", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--recursive", action="store_true")
    ap.add_argument("--out_csv", default=None)
    ap.add_argument("--fake_index", type=int, default=1)
    ap.add_argument("--from-videos", dest="from_videos", action="store_true")
    ap.add_argument("--labels_csv", default=None)
    ap.add_argument("--face_size", type=int, default=224)
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 activations (params stay f32)")
    ap.add_argument("--quantize", default="none", choices=["none", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to evaluate on (the card by default)")
    args = ap.parse_args(argv)

    if args.from_videos:
        raise NotImplementedError(
            "--from-videos is not ported yet (ROADMAP Queue 1 item 7: the "
            "port's bindings to libvideodec.so)")
    if args.quantize != "none":
        raise NotImplementedError(
            "--quantize int8 is not ported yet (ROADMAP Queue 1 item 13: nn/quant.py)")
    sd, meta = load_any(args.checkpoint)
    model, report, mt = build_model_from_checkpoint(
        sd, meta, args.model, torch.bfloat16 if args.bf16 else None, args.device)
    print(f"model={mt} matched={len(report['matched'])} missing={len(report['missing'])} "
          f"match_ratio={report['match_ratio']:.3f}")

    ds = VideoFacesDataset(args.data_dir, num_frames=args.num_frames,
                           recursive=args.recursive)
    paths, labels, prob_fake = evaluate_dataset(model, ds, args.batch_size,
                                                args.fake_index)

    m = full_metrics(labels, prob_fake, args.threshold, args.fake_index)
    print(m.pop("report"))
    print({k: v for k, v in m.items() if k != "confusion_matrix"})
    print("confusion:", m["confusion_matrix"])
    if args.sweep:
        print("sweep:", threshold_sweep(labels, prob_fake, fake_index=args.fake_index))

    out_csv = args.out_csv or os.path.join(
        os.path.dirname(args.checkpoint) or ".", "evaluation_summary.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "label", "prob_fake", "pred"])
        for p, lab, pf in zip(paths, labels.tolist(), prob_fake.tolist()):
            w.writerow([p, lab, pf, int(pf >= args.threshold)])
    print(f"wrote {out_csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
