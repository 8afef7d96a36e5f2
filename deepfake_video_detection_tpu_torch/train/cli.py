"""Training CLI on one CUDA card.

Counterpart of ``deepfake_video_detection_tpu/train/cli.py`` for the
frame-graph detector (``vit_gcn``, the default: ViT-Tiny + GCN over the
normalised chain graph of a clip's frames), the CNN+LSTM (``cnn_lstm``),
and the pretrained detector and the temporal transformer over any backbone
the port builds (EfficientNet b0-b4, the default ``efficientnet_b0``;
ResNet-18/34/50; the ViTs; ``tinyconv``):

    python -m deepfake_video_detection_tpu_torch.train.cli --data_dir faces/
    python -m deepfake_video_detection_tpu_torch.train.cli --data_dir faces/ \\
        --model pretrained
    python -m deepfake_video_detection_tpu_torch.train.cli --data_dir faces/ \\
        --model pretrained --backbone vit_base_patch16_224 --bf16
    python -m deepfake_video_detection_tpu_torch.train.cli --data_dir faces/ \\
        --model temporal --backbone vit_base_patch16_224 --num_frames 640 \\
        --batch_size 1 --bf16

80/20 split of the ``.npz`` face stacks in ``--data_dir``, class balancing
(``--balance``), Adam + StepLR(5, 0.5), per-epoch and best-by-F1
checkpoints, ``preds_epoch_N.csv``, ``--resume``, ``--smoke``. ``--bf16``
means bf16 activations with f32 params; ``--torch-export`` writes a
``.pt`` beside each checkpoint and ``--resume`` also reads a reference
``.pt``. ``--progressive`` (with ``--model pretrained``) runs the
three-stage fine-tune of ``train/progressive.py``, ``--epochs_per_stage``
epochs a stage, each stage in ``<out_dir>/stage<i>_<name>`` and the last
stage's best checkpoint copied to ``<out_dir>/checkpoint_best.npz``.
``--from-videos`` trains on the video files in ``--data_dir``
(``data/video_dataset.py``: decoding and face extraction in the loader's
threads, ``--detector center|mtcnn|none``, ``--face_size``,
``--labels_csv``, ``--cache-clips``); on a host without libav set
``VIDEO_BACKEND=cv2``. ``--steps_per_call k`` runs k optimizer steps a
call over one stacked transfer (``Trainer``'s multi-step epoch). The
temporal model takes
``--d_model``, ``--depth`` and ``--heads``.

The JAX CLI's parallelism flags (``parallel/strategy.py::add_parallel_args``:
``--mesh``, ``--fsdp``, ``--seq``/``--seq_par``, ``--pp_stages``/
``--pp_microbatches``, ``--moe_experts``/``--expert_par``) resolve through
``build_plan`` at this run's world size, one process per device:

    torchrun --nproc_per_node 4 -m deepfake_video_detection_tpu_torch.train.cli \
        --data_dir faces/ --model pretrained --mesh data=2,model=2

(``--device cpu`` runs the ranks over gloo). With more than one rank and no
parallel flag the run is pure data parallelism over all ranks, as JAX's
``make_mesh()`` over all devices. Rank 0 writes the checkpoints and logs.
"""

from __future__ import annotations

import argparse
import os
import shutil
from dataclasses import replace

import torch

from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
from deepfake_video_detection_tpu_torch.data.video_dataset import VideoClipsDataset
from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
from deepfake_video_detection_tpu_torch.models.cnn_lstm import CNNLSTMHybrid
from deepfake_video_detection_tpu_torch.models.gcn import FrameGraphDetector
from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
    TemporalTransformerDetector)
from deepfake_video_detection_tpu_torch.parallel.mesh import (
    is_main_process, make_mesh, world_size)
from deepfake_video_detection_tpu_torch.parallel.strategy import (
    add_parallel_args, build_plan)
from deepfake_video_detection_tpu_torch.train.progressive import ProgressiveFineTuner
from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig


def build_model(name: str, num_frames: int, vit_variant: str = "vit_tiny_patch16_224",
                backbone: str = "efficientnet_b0", temporal_kwargs: dict = None,
                bf16: bool = False, device="cuda", seed: int = 0):
    """``(model, adjacency, model_config)`` as in the JAX CLI: ``vit_gcn``
    (a ``vit_variant`` ViT, the chain adjacency), ``cnn_lstm``, and
    ``pretrained`` and ``temporal`` over ``backbone``; ``temporal_kwargs``:
    the temporal model's sizes (``d_model``, ``depth``, ``num_heads``).
    Weights from a generator seeded ``seed``."""
    name = name.lower()
    kw = {"compute_dtype": torch.bfloat16 if bf16 else torch.float32,
          "device": device, "generator": torch.Generator().manual_seed(seed)}
    if name in ("vit_gcn", "gcn"):
        return (FrameGraphDetector(vit_variant=vit_variant, **kw), "chain",
                {"model_type": "vit_gcn", "vit_variant": vit_variant})
    if name in ("cnn_lstm", "cnnlstm"):
        return CNNLSTMHybrid(**kw), None, {"model_type": "cnn_lstm"}
    if name not in ("pretrained", "backbone", "temporal", "temporal_transformer"):
        raise ValueError(f"unknown model {name!r}")
    if name in ("pretrained", "backbone"):
        return (BackboneDetector(backbone, **kw), None,
                {"model_type": "pretrained", "backbone": backbone})
    tkw = dict(temporal_kwargs or {})
    return (TemporalTransformerDetector(backbone, **tkw, **kw), None,
            {"model_type": "temporal", "backbone": backbone,
             **{k: tkw[k] for k in ("d_model", "depth", "num_heads", "moe_experts",
                                    "mlp_ratio", "mlp_hidden", "use_cls") if k in tkw}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train a deepfake video detector (CUDA)")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--model", default="vit_gcn",
                    choices=["vit_gcn", "cnn_lstm", "pretrained", "temporal"])
    ap.add_argument("--vit_variant", default="vit_tiny_patch16_224")
    ap.add_argument("--backbone", default="efficientnet_b0",
                    help="backbone for pretrained/temporal models")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_frames", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--balance", default="weights", choices=["weights", "sampler", "none"])
    ap.add_argument("--out_dir", default="checkpoints")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--checkpoint", default=None, help="alias of --resume")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--recursive", action="store_true")
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--steps_per_call", type=int, default=1,
                    help="optimizer steps a call, over one stacked transfer of "
                         "their batches")
    ap.add_argument("--grad_accum", type=int, default=1,
                    help="microbatches accumulated per optimizer step")
    ap.add_argument("--torch-export", action="store_true")
    ap.add_argument("--ema_decay", type=float, default=None,
                    help="params-EMA decay (e.g. 0.999): validation and the "
                         "best checkpoint use the EMA weights")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 activations (params stay f32)")
    ap.add_argument("--from-videos", dest="from_videos", action="store_true",
                    help="train directly from the raw video files in --data_dir "
                         "(decoding in the loader; no .npz prep stage)")
    ap.add_argument("--labels_csv", default=None,
                    help="with --from-videos: labels CSV (else path tokens)")
    ap.add_argument("--face_size", type=int, default=224)
    ap.add_argument("--detector", default="center", choices=["center", "mtcnn", "none"])
    ap.add_argument("--cache-clips", dest="cache_clips", action="store_true",
                    help="with --from-videos: decode each clip once and keep its "
                         "faces in host memory across epochs")
    ap.add_argument("--progressive", action="store_true",
                    help="3-stage progressive fine-tune for --model pretrained "
                         "(head-only lr 1e-3, last 2 blocks lr 1e-4, all lr 1e-5)")
    ap.add_argument("--epochs_per_stage", type=int, default=5,
                    help="epochs per progressive stage (with --progressive)")
    ap.add_argument("--d_model", type=int, default=256, help="temporal model width")
    ap.add_argument("--depth", type=int, default=4, help="temporal transformer blocks")
    ap.add_argument("--heads", type=int, default=4, help="temporal attention heads")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (the card by default; "
                         "cuda:LOCAL_RANK under torchrun)")
    add_parallel_args(ap)
    args = ap.parse_args(argv)
    plan, par_kwargs = build_plan(args, args.model, args.num_frames,
                                  depth=args.depth, device=args.device)

    if args.from_videos:
        ds = VideoClipsDataset(args.data_dir, num_frames=args.num_frames,
                               face_size=args.face_size, detector=args.detector,
                               labels_csv=args.labels_csv, recursive=args.recursive,
                               cache_clips=args.cache_clips, device=args.device)
    else:
        ds = VideoFacesDataset(args.data_dir, num_frames=args.num_frames,
                               recursive=args.recursive)
    train_ds, val_ds = ds.split(0.2)
    temporal_kwargs = dict(d_model=args.d_model, depth=args.depth,
                           num_heads=args.heads, **par_kwargs)
    model, adjacency, model_config = build_model(
        args.model, args.num_frames, args.vit_variant, args.backbone,
        temporal_kwargs, bf16=args.bf16, device=args.device)
    cfg = TrainerConfig(
        out_dir=args.out_dir, epochs=args.epochs, batch_size=args.batch_size,
        num_frames=args.num_frames, lr=args.lr, optimizer="adam",
        schedule="step", loss="ce", balance=args.balance, grad_clip=None,
        best_metric="f1", smoke=args.smoke, adjacency=adjacency,
        augment=not args.no_augment, keep_torch_export=args.torch_export,
        steps_per_call=args.steps_per_call, grad_accum=args.grad_accum,
        ema_decay=args.ema_decay, model_config=model_config,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    if args.progressive:
        if args.model != "pretrained":
            ap.error("--progressive requires --model pretrained")
        if plan is not None and not plan.pure_dp:
            ap.error("--progressive composes with data parallelism only; "
                     "drop the model-parallel flags")
        if args.ema_decay:
            ap.error("--progressive rebuilds the optimizer per stage and "
                     "does not carry the EMA slot; drop --ema_decay")
        return _run_progressive(args, model, train_ds, val_ds, cfg,
                                plan.mesh if plan is not None else default_mesh(args.device))

    trainer = make_trainer(model, train_ds, val_ds, cfg, plan, args.device, Trainer)
    state = None
    resume = args.resume or args.checkpoint
    if resume:
        state = trainer.resume(resume)
    trainer.train(state)
    return 0


def default_mesh(device):
    """JAX's ``make_mesh() if len(jax.devices()) > 1 else None``: all ranks
    on ``data`` when this run has more than one."""
    return make_mesh(device=device) if world_size() > 1 else None


def make_trainer(model, train_ds, val_ds, cfg, plan, device, trainer_cls=Trainer):
    """The CLIs' ``trainer_cls``: under ``plan`` (printing its line), else
    pure DP over every rank of a multi-rank run, else one device."""
    if plan is not None:
        if is_main_process():
            print(f"parallelism plan: {plan.description} over "
                  f"{plan.n_devices} devices")
        return trainer_cls(model, train_ds, val_ds, cfg, plan=plan, device=device)
    return trainer_cls(model, train_ds, val_ds, cfg, mesh=default_mesh(device),
                       device=device)


def _run_progressive(args, model, train_ds, val_ds, cfg, mesh=None) -> int:
    """The three stages through the standard Trainer: each stage gets a
    fresh masked AdamW at its lr (constant, no EMA), warm-starts from the
    previous stage's best checkpoint (stage 0 from ``--resume`` or
    ``--checkpoint`` when given, else the model as built) and writes to
    ``<out_dir>/stage<i>_<name>``. The last best is copied to
    ``<out_dir>/checkpoint_best.npz`` for the serving loader's glob."""
    ft = ProgressiveFineTuner(model, epochs_per_stage=args.epochs_per_stage)
    prev_best = args.resume or args.checkpoint
    while True:
        sc = ft.get_stage_config()
        stage_cfg = replace(cfg, lr=sc["lr"], epochs=sc["epochs"], schedule="const",
                            ema_decay=None,
                            out_dir=os.path.join(cfg.out_dir,
                                                 f"stage{sc['stage']}_{sc['name']}"))
        trainer = Trainer(model, train_ds, val_ds, stage_cfg, mesh=mesh,
                          tx=ft.make_optimizer(), device=args.device)
        state = trainer.warm_start(prev_best) if prev_best else None
        print(f"progressive stage {sc['stage']} ({sc['name']}): lr={sc['lr']:g}, "
              f"epochs={sc['epochs']}, unfreeze_blocks={sc['unfreeze_blocks']}")
        trainer.train(state)
        prev_best = os.path.join(stage_cfg.out_dir, "checkpoint_best.npz")
        if not ft.advance_stage():
            break
    shutil.copyfile(prev_best, os.path.join(cfg.out_dir, "checkpoint_best.npz"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
