"""Learning-rate range test on one CUDA card.

Counterpart of ``deepfake_video_detection_tpu/train/lr_finder.py``: an
exponential LR sweep over ``num_steps`` batches of plain SGD
(``p ← p − lr·g``), tracking the bias-corrected smoothed loss; it stops on
NaN/inf or once the smoothed loss exceeds 4× its best after step 10, and
reports the steepest-descent LR and the min-loss LR / 10. The curve goes to
a CSV and a standalone SVG (the same bytes as the JAX package's for the
same history).

    python -m deepfake_video_detection_tpu_torch.train.lr_finder --data_dir faces/

Each step updates the model's parameters in place under ``no_grad``, each
in its own dtype; batch norm's running stats move with every training
forward, as the JAX step threads its model state. Dropout draws from a
``torch.Generator`` (seeded, but not ``jax.random``'s numbers).
"""

from __future__ import annotations

import argparse
import csv
import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.data.loader import Loader, prefetch_to_device
from deepfake_video_detection_tpu_torch.data.normalize import imagenet_normalize
from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
from deepfake_video_detection_tpu_torch.train.losses import cross_entropy_loss
from deepfake_video_detection_tpu_torch.utils.device import resolve_device


class LRFinder:
    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 start_lr: float = 1e-4, end_lr: float = 10.0,
                 num_steps: int = 100, beta: float = 0.98):
        self.model = model
        self.loss_fn = loss_fn
        self.start_lr = start_lr
        self.end_lr = end_lr
        self.num_steps = num_steps
        self.beta = beta
        self.history: List[Tuple[float, float]] = []  # (lr, smoothed loss)

    def _step(self, batch: Dict[str, torch.Tensor], lr: float,
              generator: Optional[torch.Generator]) -> float:
        params = [p for p in self.model.parameters() if p.requires_grad]
        out = self.model(batch["frames"], train=True, generator=generator)
        logits = out[0] if isinstance(out, tuple) else out
        loss = self.loss_fn(logits, batch["labels"])
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        used = [(p, g) for p, g in zip(params, grads) if g is not None]
        with torch.no_grad():   # lr·g rounded in the parameter's dtype, then subtracted
            torch._foreach_sub_([p for p, _ in used],
                                torch._foreach_mul([g.to(p.dtype) for p, g in used], lr))
        return float(loss.detach())

    def find(self, batches: Iterable[Dict[str, torch.Tensor]],
             generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        """Sweep over ``batches`` (restarted when it runs out, so pass a
        re-iterable); ``generator`` drives dropout."""
        mult = (self.end_lr / self.start_lr) ** (1.0 / max(self.num_steps - 1, 1))
        lr = self.start_lr
        avg_loss, best_loss = 0.0, float("inf")
        it = iter(batches)
        for i in range(self.num_steps):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(batches)
                batch = next(it)
            loss = self._step(batch, lr, generator)
            if math.isnan(loss) or math.isinf(loss):
                break
            avg_loss = self.beta * avg_loss + (1 - self.beta) * loss
            smoothed = avg_loss / (1 - self.beta ** (i + 1))
            self.history.append((lr, smoothed))
            if smoothed < best_loss:
                best_loss = smoothed
            if smoothed > 4.0 * best_loss and i > 10:
                break
            lr *= mult
        return self.report()

    def report(self) -> Dict[str, float]:
        if len(self.history) < 2:
            return {"best_lr": self.start_lr, "min_loss_lr": self.start_lr}
        lrs = np.array([h[0] for h in self.history])
        losses = np.array([h[1] for h in self.history])
        min_idx = int(losses.argmin())
        # steepest descent on the log-lr curve
        grads = np.gradient(losses, np.log(lrs))
        steep_idx = int(grads[: max(min_idx, 1)].argmin()) if min_idx > 0 else 0
        return {"best_lr": float(lrs[steep_idx]),
                "min_loss_lr": float(lrs[min_idx] / 10.0)}

    def save_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["lr", "smoothed_loss"])
            w.writerows(self.history)

    def save_plot(self, path: str) -> None:
        """Loss-vs-LR curve as a standalone SVG: log-x, smoothed loss, the
        suggested LRs as dashed markers."""
        if len(self.history) < 2:
            return
        W, H, pad = 640, 400, 56
        lrs = np.array([h[0] for h in self.history])
        losses = np.array([h[1] for h in self.history])
        x0, x1 = math.log10(lrs[0]), math.log10(lrs[-1])
        y0, y1 = float(losses.min()), float(losses.max())
        yr = (y1 - y0) or 1.0

        def X(lr):
            return pad + (math.log10(lr) - x0) / max(x1 - x0, 1e-9) * (W - 2 * pad)

        def Y(v):
            return H - pad - (v - y0) / yr * (H - 2 * pad)

        pts = " ".join(f"{X(lr):.1f},{Y(v):.1f}" for lr, v in self.history)
        rep = self.report()
        parts = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" '
            f'viewBox="0 0 {W} {H}" font-family="sans-serif" font-size="12">',
            f'<rect width="{W}" height="{H}" fill="white"/>',
            f'<text x="{W / 2}" y="20" text-anchor="middle" font-size="14">'
            f'LR range test (smoothed loss)</text>',
        ]
        # axes and log-decade gridlines
        parts.append(f'<line x1="{pad}" y1="{H - pad}" x2="{W - pad}" '
                     f'y2="{H - pad}" stroke="#444"/>')
        parts.append(f'<line x1="{pad}" y1="{pad}" x2="{pad}" '
                     f'y2="{H - pad}" stroke="#444"/>')
        for d in range(math.ceil(x0), math.floor(x1) + 1):
            x = X(10.0 ** d)
            parts.append(f'<line x1="{x:.1f}" y1="{pad}" x2="{x:.1f}" '
                         f'y2="{H - pad}" stroke="#ddd"/>')
            parts.append(f'<text x="{x:.1f}" y="{H - pad + 16}" '
                         f'text-anchor="middle">1e{d}</text>')
        for frac in (0.0, 0.5, 1.0):
            v = y0 + frac * yr
            parts.append(f'<text x="{pad - 6}" y="{Y(v) + 4:.1f}" '
                         f'text-anchor="end">{v:.3g}</text>')
        for lr, color, label in ((rep["best_lr"], "#2a7", "steepest"),
                                 (rep["min_loss_lr"] * 10.0, "#d55", "min loss")):
            if lrs[0] <= lr <= lrs[-1]:
                parts.append(f'<line x1="{X(lr):.1f}" y1="{pad}" '
                             f'x2="{X(lr):.1f}" y2="{H - pad}" '
                             f'stroke="{color}" stroke-dasharray="4 3"/>')
                parts.append(f'<text x="{X(lr) + 4:.1f}" y="{pad + 14}" '
                             f'fill="{color}">{label} {lr:.1e}</text>')
        parts.append(f'<polyline points="{pts}" fill="none" stroke="#36c" '
                     f'stroke-width="1.5"/>')
        parts.append(f'<text x="{W / 2}" y="{H - 12}" text-anchor="middle">'
                     f'learning rate (log)</text>')
        parts.append("</svg>")
        with open(path, "w") as f:
            f.write("\n".join(parts))


class _Batches:
    """Normalised batches of a fresh loader pass each time it is iterated,
    so the sweep can restart it (the JAX CLI hands ``find`` a one-shot
    generator, which stops the sweep after one pass), prefetched to the
    device as the Trainer's are."""

    def __init__(self, ds: Any, batch_size: int, device: torch.device):
        self.loader = Loader(ds, batch_size, shuffle=True)
        self.device = device

    def __iter__(self):
        for b in prefetch_to_device(self.loader, self.device):
            yield {"frames": imagenet_normalize(b["frames"]), "labels": b["labels"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="LR range test (CUDA)")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--backbone", default="efficientnet_b0")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_frames", type=int, default=8)
    ap.add_argument("--num_steps", type=int, default=100)
    ap.add_argument("--start_lr", type=float, default=1e-4)
    ap.add_argument("--end_lr", type=float, default=10.0)
    ap.add_argument("--out_csv", default="lr_finder.csv")
    ap.add_argument("--out_plot", default=None,
                    help="loss-vs-LR SVG (default: out_csv with .svg)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (the card by default)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ds = VideoFacesDataset(args.data_dir, num_frames=args.num_frames)
    model = BackboneDetector(args.backbone, device=device,
                             generator=torch.Generator().manual_seed(0))
    finder = LRFinder(model, cross_entropy_loss, args.start_lr, args.end_lr,
                      args.num_steps)
    out = finder.find(_Batches(ds, args.batch_size, device),
                      torch.Generator(device=device).manual_seed(0))
    finder.save_csv(args.out_csv)
    plot = args.out_plot or (args.out_csv.rsplit(".", 1)[0] + ".svg")
    finder.save_plot(plot)
    print(f"suggested lr (steepest descent): {out['best_lr']:.2e}")
    print(f"suggested lr (min loss / 10):    {out['min_loss_lr']:.2e}")
    print(f"curve written to {args.out_csv}; plot to {plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
