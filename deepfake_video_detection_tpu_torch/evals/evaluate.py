"""Evaluation CLI on one CUDA card.

Counterpart of ``deepfake_video_detection_tpu/evals/evaluate.py``:

    python -m deepfake_video_detection_tpu_torch.evals.evaluate --data_dir faces/ \\
        --checkpoint ckpt/checkpoint_best.npz --num_frames 1024 --batch_size 2 --bf16

Loads a native ``.npz`` or a reference ``.pt`` checkpoint
(``checkpoint/store.py::load_any``), rebuilds the model from its embedded
``model_config`` or, without one, by the JAX evaluator's key patterns
(ensemble members, ``logic_cells.``, ``vit.``/``gcn.``, ``cnn.``, else the
pretrained detector) and architecture inference: the ViT variant from the
embedding width, the logic RNN's sizes from its gates, the temporal
``d_model`` from ``cls_token`` or ``proj.weight`` and its depth from the
``blocks.*`` keys (pipeline-layout checkpoints renumbered to the loop
layout). It loads the weights shape-filtered, runs batched inference over a
``VideoFacesDataset`` (the frame-graph detector with the normalised chain
adjacency over the clip's frames) and prints the metric set (accuracy,
precision, recall, F1, report, confusion matrix, AUC; ``--sweep`` for the
threshold sweep), writing ``path,label,prob_fake,pred`` rows to a CSV.

On the card each batch is normalised by the fused-normalize kernel (K1)
into the compute dtype, as serving does, and the whole forward runs under
``torch.inference_mode()``; every ViT block runs the flash kernel, a long
clip's temporal blocks in its streaming regime (N > 512). The ``rnn``
family's checkpoint holds only the logic RNN: its ViT-Tiny frame encoder is
freshly initialised (from a generator seeded 0; the JAX package draws it
from ``PRNGKey(0)``, so the two packages' numbers differ), as in the
reference. ``--quantize int8`` holds the matmul and conv weights in int8
with per-output-channel scales (``nn/quant.py``), to measure what
``QUANTIZE=int8`` serving costs in quality. ``--from-videos`` scores the
video files in ``--data_dir`` (``data/video_dataset.py`` at its default
detector, center, as the JAX evaluator; ``VIDEO_BACKEND=cv2`` on a host
without libav).
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from deepfake_video_detection_tpu_torch.checkpoint.store import load_any
from deepfake_video_detection_tpu_torch.checkpoint.torch_bridge import (
    import_into_model, infer_ensemble_count)
from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.data.loader import Loader, prefetch_to_device
from deepfake_video_detection_tpu_torch.data.video_dataset import VideoClipsDataset
from deepfake_video_detection_tpu_torch.evals.metrics import full_metrics, threshold_sweep
from deepfake_video_detection_tpu_torch.models.backbone_detector import (
    BackboneDetector, EnsembleDetector)
from deepfake_video_detection_tpu_torch.models.cnn_lstm import CNNLSTMHybrid
from deepfake_video_detection_tpu_torch.models.gcn import FrameGraphDetector
from deepfake_video_detection_tpu_torch.models.logic_rnn import LogicRNNLSTM
from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
    TemporalTransformerDetector, infer_mlp_kwargs, normalize_state_dict)
from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn import layers as L
from deepfake_video_detection_tpu_torch.nn.quant import quantize_module
from deepfake_video_detection_tpu_torch.ops.preprocess import fused_normalize
from deepfake_video_detection_tpu_torch.utils.device import resolve_device
from deepfake_video_detection_tpu_torch.utils.graph import chain_adjacency, normalize_adjacency

# embed-dim → timm ViT variant
_EMBED_TO_VIT = {192: "vit_tiny_patch16_224", 384: "vit_small_patch16_224",
                 768: "vit_base_patch16_224", 1024: "vit_large_patch16_224"}


def infer_vit_variant_from_state_dict(sd: Mapping[str, Any]) -> str:
    """The ViT variant told by the width of ``cls_token``/``pos_embed``,
    else of the patch embedding; ViT-B/16 when neither is there."""
    for key in sd:
        if key.endswith("cls_token") or key.endswith("pos_embed"):
            return _EMBED_TO_VIT.get(int(np.shape(sd[key])[-1]), "vit_base_patch16_224")
    for key in sd:
        if "patch_embed.proj.weight" in key:
            return _EMBED_TO_VIT.get(int(np.shape(sd[key])[0]), "vit_base_patch16_224")
    return "vit_base_patch16_224"


def infer_logic_rnn_dims(sd: Mapping[str, Any]) -> Tuple[int, int, int]:
    """``(input_size, hidden_size, num_layers)`` from ``logic_cells.*``
    shapes."""
    layers = set()
    input_size = hidden_size = None
    for k, v in sd.items():
        if ".and_gate.weight" in k and k.startswith("logic_cells."):
            idx = int(k.split(".")[1])
            layers.add(idx)
            if idx == 0:
                hidden_size = int(np.shape(v)[0])
                input_size = int(np.shape(v)[1]) - hidden_size
    if hidden_size is None:
        raise ValueError("not a LogicRNN checkpoint")
    return input_size, hidden_size, max(layers) + 1


class RNNVideoPipeline(nn.Module):
    """ViT per-frame CLS features (a linear projection where its width is
    not the RNN's input size) → ``LogicRNNLSTM``; the sigmoid probability
    comes back as 2-class log-probabilities, so that a softmax downstream
    returns it. f32 throughout, as in the JAX pipeline."""

    def __init__(self, rnn: LogicRNNLSTM, vit_variant: str = "vit_tiny_patch16_224",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        dev = resolve_device(device)
        self.compute_dtype = torch.float32
        self.rnn = rnn.to(dev)
        self.vit = VisionTransformer(variant=vit_variant, num_classes=0, device=dev,
                                     generator=g)
        self.needs_proj = self.vit.feature_dim != rnn.input_size
        if self.needs_proj:
            self.proj = torch.nn.utils.skip_init(nn.Linear, self.vit.feature_dim,
                                                 rnn.input_size, device=dev,
                                                 dtype=torch.float32)
            with torch.no_grad():
                self.proj.weight.copy_(I.kaiming_uniform(self.proj.weight.shape, g))
                self.proj.bias.zero_()

    def forward(self, frames: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T = frames.shape[0], frames.shape[1]
        feats = self.vit(frames.reshape((B * T,) + tuple(frames.shape[2:])))
        if self.needs_proj:
            feats = L.linear(feats, self.proj.weight, self.proj.bias)
        prob_fake = self.rnn(feats.reshape(B, T, -1))
        probs2 = torch.cat([1.0 - prob_fake, prob_fake], dim=-1)
        return torch.log(torch.clamp(probs2, 1e-8, 1.0))


def _model_type_from_keys(sd: Mapping[str, Any]) -> str:
    """The JAX evaluator's key patterns."""
    if infer_ensemble_count(sd) > 0:
        return "ensemble"
    if any(k.startswith("logic_cells.") for k in sd):
        return "rnn"
    if any(k.startswith(("vit.", "gcn.")) for k in sd):
        return "vit_gcn"
    if any(k.startswith("cnn.") for k in sd):
        return "cnn_lstm"
    return "pretrained"


def build_model_from_checkpoint(sd: Mapping[str, Any], meta: Mapping[str, Any],
                                model_type: str,
                                compute_dtype: Optional[torch.dtype] = None,
                                device: Any = "cuda"):
    """``(model, report, model_type)``: the model rebuilt from a
    checkpoint's flat torch-layout state dict and meta, its weights loaded
    (``report`` from :func:`import_into_model`). ``compute_dtype``: the
    activations' dtype (params stay f32; the rnn pipeline stays f32)."""
    cfg = meta.get("model_config") or {}
    kw = {"compute_dtype": compute_dtype or torch.float32, "device": device}
    sd = dict(sd)
    mt = model_type or cfg.get("model_type", "") or _model_type_from_keys(sd)
    if mt in ("vit_gcn", "gcn"):
        variant = cfg.get("vit_variant") or infer_vit_variant_from_state_dict(sd)
        model = FrameGraphDetector(vit_variant=variant, **kw)
    elif mt == "cnn_lstm":
        model = CNNLSTMHybrid(**kw)
    elif mt in ("rnn", "logic_rnn"):
        i, h, n = infer_logic_rnn_dims(sd)
        model = RNNVideoPipeline(LogicRNNLSTM(input_size=i, hidden_size=h, num_layers=n,
                                              device=device), device=device)
        # the checkpoint holds only the RNN: its keys go under ``rnn.``
        sd = {f"rnn.{k}": v for k, v in sd.items()}
    elif mt == "ensemble":
        backbones = cfg.get("backbones") or ["efficientnet_b0"] * infer_ensemble_count(sd)
        model = EnsembleDetector(backbones, **kw)
    elif mt in ("temporal", "temporal_transformer"):
        sd = normalize_state_dict(sd)
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
                     fake_index: int = 1, model_type: str = ""):
    """Inference over the dataset on the model's device; returns
    ``(paths, labels, prob_fake)`` for the valid rows. ``model_type``
    ``vit_gcn`` (or ``gcn``) passes the normalised chain adjacency over
    ``ds.num_frames`` frames."""
    device = next(model.parameters()).device
    compute_dtype = getattr(model, "compute_dtype", torch.float32)
    adjacency = None
    if model_type in ("vit_gcn", "gcn"):
        adjacency = normalize_adjacency(chain_adjacency(ds.num_frames)).to(device)

    @torch.inference_mode()
    def forward(frames_u8: torch.Tensor) -> torch.Tensor:
        x = fused_normalize(frames_u8, out_dtype=compute_dtype)
        if adjacency is not None:
            out = model(x, adjacency.expand(x.shape[0], -1, -1))
        else:
            out = model(x)
        logits = out[0] if isinstance(out, tuple) else out
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
    ap.add_argument("--model", default="",
                    help="vit_gcn|cnn_lstm|rnn|pretrained|ensemble|temporal "
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

    sd, meta = load_any(args.checkpoint)
    model, report, mt = build_model_from_checkpoint(
        sd, meta, args.model, torch.bfloat16 if args.bf16 else None, args.device)
    n_quant = quantize_module(model) if args.quantize == "int8" else 0
    print(f"model={mt} matched={len(report['matched'])} missing={len(report['missing'])} "
          f"match_ratio={report['match_ratio']:.3f}"
          + (f" quantized_weights={n_quant}" if n_quant else ""))

    if args.from_videos:
        ds = VideoClipsDataset(args.data_dir, num_frames=args.num_frames,
                               face_size=args.face_size, labels_csv=args.labels_csv,
                               recursive=args.recursive, device=args.device)
    else:
        ds = VideoFacesDataset(args.data_dir, num_frames=args.num_frames,
                               recursive=args.recursive)
    paths, labels, prob_fake = evaluate_dataset(model, ds, args.batch_size,
                                                args.fake_index, mt)

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
