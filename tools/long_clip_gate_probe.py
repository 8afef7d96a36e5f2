#!/usr/bin/env python3
"""Probe ``chip_smoke.py``'s long-clip training gate on one CUDA card.

    python3 tools/long_clip_gate_probe.py

The gate (``chip_smoke.py::train_long``) trains the temporal transformer
one epoch at T = 640 and holds one step of its temporal blocks through the
kernels against the plain versions: loss within ``STEP_TOL_LOSS``, grad
norm within ``LONG_TOL_NORM``. Its loss is saturated and its logits are
bf16, so one bf16 ulp of a logit decides it. This trains as the gate does,
once for each backward split count of ``TRAIN_BWD_SPLITS`` (the only
difference between the runs: the f32 sum order of the gradients), and
prints for each the gate's loss, grad norm and logits on both paths. After
the run with the policy's split counts it also prints the kernel path at
each forward split count of ``FWD_SPLITS``, and with the plain backward
under the kernel forward (the backward's own share of the grad-norm gap).
One JSON object a line.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

TRAIN_BWD_SPLITS = (None, 2, 3, 5)   # None: the policy's
FWD_SPLITS = (1, 2, 3, 4, 5, 6)


def main() -> int:
    import torch

    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.ops import attention as A
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train.steps import global_norm
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    if not torch.cuda.is_available():
        print("long_clip_gate_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"nvidia_smi": cs._smi()}), flush=True)
    long, policy = cs.LONG, A._long_splits
    T, device = long["train_frames"], "cuda"
    root = tempfile.mkdtemp(prefix="dfdt_gate_")
    try:
        data = os.path.join(root, "faces")
        os.makedirs(data)
        cs._write_faces(data, long["clips"], long["frames"], long["size"])
        for s_train in TRAIN_BWD_SPLITS:
            ds = VideoFacesDataset(data, num_frames=T)
            train_ds, val_ds = ds.split(0.2)
            model, _, model_config = cli.build_model(
                "temporal", T, backbone=long["backbone"], bf16=True, device=device,
                temporal_kwargs={k: long[k] for k in ("d_model", "depth", "num_heads")})
            cfg = TrainerConfig(out_dir=os.path.join(root, f"run{s_train}"), epochs=1,
                                batch_size=1, num_frames=T, lr=1e-4, optimizer="adam",
                                schedule="step", loss="ce", balance="weights", grad_clip=None,
                                best_metric="f1", threshold_sweep=True, augment=True,
                                model_config=model_config)
            trainer = Trainer(model, train_ds, val_ds, cfg, device=device)

            def splits(B, H, N, d, bf16=True, s=s_train):
                s_fwd, s_bwd = policy(B, H, N, d, bf16)
                return s_fwd, s_bwd if s is None or N <= A._SHORT_MAX else s

            with mock.patch.object(A, "_long_splits", splits):
                trainer.train(log=lambda msg: None)
            # the gate's batch, backbone features and dropout draws
            batch = next(iter(trainer._device_batches(train_ds, True)))
            batch.pop("paths", None)
            batch = trainer._prep_train(batch, torch.Generator(device=device).manual_seed(1))
            frames = batch["frames"]
            with torch.no_grad():
                feats = model.backbone(frames.reshape((-1,) + tuple(frames.shape[2:])))
            feats = feats.reshape(frames.shape[0], frames.shape[1], -1)
            params = [p for n, p in model.named_parameters() if not n.startswith("backbone.")]

            def step():
                logits, _ = model.forward_temporal(
                    feats, train=True, generator=torch.Generator(device=device).manual_seed(2))
                loss = trainer.loss_fn(logits, batch["labels"], sample_mask=batch["valid"])
                norm = global_norm(torch.autograd.grad(loss, params))
                return {"loss": float(loss.detach()), "grad_norm": float(norm),
                        "logits": logits.detach().float().cpu().tolist()}

            kern = step()
            with cs._plain_attention(A):
                plain = step()
            d_loss = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
            d_norm = abs(kern["grad_norm"] - plain["grad_norm"]) / plain["grad_norm"]
            print(json.dumps({"train_bwd_splits": s_train or "policy", "kernels": kern,
                              "plain": plain, "loss_rel_diff": d_loss, "norm_rel_diff": d_norm,
                              "gate_holds": d_loss <= cs.STEP_TOL_LOSS
                              and d_norm <= cs.LONG_TOL_NORM}), flush=True)
            if s_train is None:
                for s_fwd in FWD_SPLITS:
                    with mock.patch.object(A, "_long_splits", lambda B, H, N, d, bf16=True, s=s_fwd:
                                           (s, policy(B, H, N, d, bf16)[1])):
                        print(json.dumps({"fwd_splits": s_fwd, "kernels": step()}), flush=True)
                with mock.patch.object(A, "flash_attention_bwd", A.flash_attention_bwd_plain):
                    print(json.dumps({"plain_backward": step()}), flush=True)
            del model, trainer
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
