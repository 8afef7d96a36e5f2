#!/usr/bin/env python3
"""Probe ``chip_smoke.py``'s long-clip training gate on one CUDA card.

    python3 tools/long_clip_gate_probe.py [--gate]

The gate (``chip_smoke.py::long_step_gate``, run by ``train_long``) trains
the temporal transformer one epoch at T = 640 and holds one step of its
temporal blocks through the kernels against the plain versions. Its loss
is saturated and its logits are bf16, so one bf16 ulp of a logit moved the
old gate (loss within ``STEP_TOL_LOSS``, grad norm within
``LONG_TOL_NORM`` of the plain path's). This trains as the gate does, once
for each backward split count of ``TRAIN_BWD_SPLITS`` (the only difference
between the runs: the f32 sum order of the gradients), and prints for each
the gate's record: the logits on both paths and their gap in bf16 ulps,
the loss and grad norm of the kernel path, of the plain path and of the
plain path at the kernel path's logits, and whether the old and the
repaired gate hold. After the run with the policy's split counts it also
prints the kernel path at each forward split count of ``FWD_SPLITS``, and
with the plain backward under the kernel forward (the backward's own share
of the grad-norm gap). ``--gate`` trains once at the policy's split counts,
prints the gate's record and exits 1 if the repaired gate fails: run from a
copy whose kernel is broken on purpose, it shows that the gate catches the
fault. One JSON object a line.
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


def _train(torch, A, root, data, s_train, device="cuda"):
    """The model and Trainer after one epoch at T = 640, as ``train_long``
    trains them, with the backward's split count at N > 512 forced to
    ``s_train`` (None: the policy's)."""
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    long, policy = cs.LONG, A._long_splits
    T = long["train_frames"]
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

    def splits(B, H, N, d, bf16=True):
        s_fwd, s_bwd = policy(B, H, N, d, bf16)
        return s_fwd, s_bwd if s_train is None or N <= A._SHORT_MAX else s_train

    with mock.patch.object(A, "_long_splits", splits):
        trainer.train(log=lambda msg: None)
    return model, trainer, train_ds


def main(argv) -> int:
    import torch

    from deepfake_video_detection_tpu_torch.ops import attention as A
    from deepfake_video_detection_tpu_torch.ops import preprocess as P

    if not torch.cuda.is_available():
        print("long_clip_gate_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"nvidia_smi": cs._smi()}), flush=True)
    long, policy = cs.LONG, A._long_splits
    root = tempfile.mkdtemp(prefix="dfdt_gate_")
    try:
        data = os.path.join(root, "faces")
        os.makedirs(data)
        cs._write_faces(data, long["clips"], long["frames"], long["size"])
        for s_train in (None,) if "--gate" in argv else TRAIN_BWD_SPLITS:
            model, trainer, train_ds = _train(torch, A, root, data, s_train)
            gate, batch = cs.long_step_gate(torch, A, P, model, trainer, train_ds)
            old = (gate["loss_rel_diff_vs_plain"] <= cs.STEP_TOL_LOSS
                   and gate["grad_norm_rel_diff_vs_plain"] <= cs.LONG_TOL_NORM)
            print(json.dumps({"train_bwd_splits": s_train or "policy", **gate,
                              "old_gate_holds": old}), flush=True)
            if "--gate" in argv:
                return 0 if gate["holds"] else 1
            if s_train is None:
                frames = batch["frames"]
                with torch.no_grad():
                    feats = model.backbone(frames.reshape((-1,) + tuple(frames.shape[2:])))
                feats = feats.reshape(frames.shape[0], frames.shape[1], -1)

                def logits():
                    out, _ = model.forward_temporal(
                        feats, train=True,
                        generator=torch.Generator(device="cuda").manual_seed(2))
                    return out.detach().float().cpu().tolist()

                for s_fwd in FWD_SPLITS:
                    with mock.patch.object(A, "_long_splits", lambda B, H, N, d, bf16=True, s=s_fwd:
                                           (s, policy(B, H, N, d, bf16)[1])):
                        print(json.dumps({"fwd_splits": s_fwd, "logits_kernels": logits()}),
                              flush=True)
                with mock.patch.object(A, "flash_attention_bwd", A.flash_attention_bwd_plain):
                    rec, _ = cs.long_step_gate(torch, A, P, model, trainer, train_ds)
                    print(json.dumps({"plain_backward": rec}), flush=True)
            del model, trainer
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
