"""Ensemble-improvement validation demo on one CUDA card.

Counterpart of ``deepfake_video_detection_tpu/evals/validate_improvements.py``,
in two parts:

1. a simulated baseline-vs-ensemble metric comparison on synthetic labels
   (numpy over ``evals/metrics.py``: the same numbers as the JAX module's;
   the comparison is simulated, and the output says so);
2. a forward-pass sanity check of ``BackboneDetector("resnet18")`` and
   ``EnsembleDetector(("resnet18", "resnet18"))`` on random input on
   ``--device`` (the card by default): output shapes and the member count.

    python -m deepfake_video_detection_tpu_torch.evals.validate_improvements
"""

from __future__ import annotations

import argparse
from typing import Any

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.evals.metrics import binary_metrics, roc_auc
from deepfake_video_detection_tpu_torch.models.backbone_detector import (
    BackboneDetector, EnsembleDetector)
from deepfake_video_detection_tpu_torch.utils.device import resolve_device


def simulate_comparison(n: int = 200, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    # baseline: coin-flip scores; ensemble: moderately separable scores
    base_scores = rng.random(n)
    ens_scores = np.clip(labels * 0.5 + rng.normal(0.25, 0.2, n), 0, 1)
    out = {}
    for name, scores in (("baseline", base_scores), ("ensemble", ens_scores)):
        preds = (scores >= 0.5).astype(np.int64)
        m = binary_metrics(labels, preds)
        m["auc"] = roc_auc(labels, scores)
        out[name] = m
    return out


@torch.inference_mode()
def test_real_models(device: Any = "cuda") -> dict:
    """One forward of a resnet18 detector and a two-member resnet18
    ensemble (weights from seeded generators) on a (1, 2, 64, 64, 3)
    input on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.random.default_rng(0).random((1, 2, 64, 64, 3)),
                        dtype=torch.float32, device=dev)
    single = BackboneDetector("resnet18", device=dev,
                              generator=torch.Generator().manual_seed(0))
    logits, scores = single(x)
    assert logits.shape == (1, 2) and scores.shape == (1, 2)

    ens = EnsembleDetector(("resnet18", "resnet18"), device=dev,
                           generator=torch.Generator().manual_seed(1))
    elogits, _, member = ens(x, return_member_logits=True)
    assert elogits.shape == (1, 2) and member.shape == (2, 1, 2)
    return {"single_logits": logits.cpu().numpy().tolist(),
            "ensemble_logits": elogits.cpu().numpy().tolist(),
            "members": int(member.shape[0])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Ensemble-improvement validation demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the forward-pass check (the card by default)")
    args = ap.parse_args(argv)
    print("— simulated comparison (synthetic labels; illustrative only) —")
    sim = simulate_comparison()
    for name, m in sim.items():
        print(f"{name:>9}: acc={m['accuracy']:.2f} prec={m['precision']:.2f} "
              f"rec={m['recall']:.2f} f1={m['f1']:.2f} auc={m['auc']:.2f}")
    print("— real forward-pass sanity check —")
    info = test_real_models(args.device)
    print(f"single + {info['members']}-member ensemble forwards OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
