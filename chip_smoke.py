#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Imports only the port (``deepfake_video_detection_tpu_torch``), never JAX.

1. Device: the card's name and power limit (``nvidia-smi``), torch/CUDA;
   then ``decoder_probe``, what the machine offers a video decoder (printed
   only, nothing installed): ``libavformat`` in ``ldconfig -p``, the libav
   headers, ``g++``, cv2 and its FFMPEG line, imageio-ffmpeg, the Haar XMLs.
2. Build: every CUDA kernel of the port, from the sources in the checkout,
   one ``nvcc`` per source, all started together; the fused-normalize
   library is waited for at once and the conv-net phases (3-6) run while the
   flash libraries compile. The tensor-core flash kernels at d = 64 (every
   main path): bf16 unsplit and split, f32 (3xTF32), and the split route's
   combine and reduce kernels must spill nothing (``-Xptxas -v``); the bf16
   Hopper kernels at d = 64 (the forward's two, the backward's four) must
   hold wgmma products (HGMMA) and TMA loads (UTMALDG) in the built
   libraries' SASS (``cuobjdump -sass``), and ptxas must not have
   serialized their products in either source (notes C7514, C7515, C7520).
   The ``build`` line gives their registers, dynamic shared memory, spills
   and both counts.
3. K1: the fused-normalize kernel's RGB and packed-YUV420 entries against
   their plain versions at the serving shapes, timed by events and by
   device, beside their bound and the plain versions' times.
4. EfficientNet-B0 serving: a ``BackboneDetector`` (random weights from
   seed 0, BN statistics drawn from U(0.5, 1.5), f32 params, bf16
   activations) behind a ``Predictor`` with micro-batching and warmup:
   sequential, concurrent (8 clients) and packed-YUV420 requests, launch
   counts, one request's ``prob_fake`` against the plain versions, forward
   ms at 1 and 16 clips, and the device time by kernel of one 16-clip YUV
   and one RGB forward under ``torch.profiler``.
5. Ensemble serving: B0 + resnet18 (``average``) with the enhanced decision
   agent, the same requests and measurements; the agent's payload checked.
6. The loader: the B0 detector saved with ``save_checkpoint`` (``.npz``)
   and the ensemble as a reference ``{"model_state", "model_config"}`` ``.pt``;
   ``serve/loader.py::load_model`` must pick each architecture at match
   ratio 1.0 and the Predictor must serve it with phase 4's or 5's
   ``prob_fake``.
7. Kernel checks: each flash kernel against its plain PyTorch version on the card,
   at the main paths' shapes and a few edge shapes, with the stated
   tolerance; times by CUDA events after warm-up (kernel, plain version,
   and the one PyTorch call that computes the same function, if any), and
   for the flash kernels their device time under ``torch.profiler`` (held
   against CUDA events over calls queued back to back; null where the two
   disagree; those events are ``kernel_queued_ms``, ``library_queued_ms``),
   every kernel of the call summed and each named
   (``kernel_device_ms_by_kernel``),
   beside the library call's (``library_device_ms``) on every row. Each flash source routes by dtype (``route``), both on the
   tensor cores: bf16 to its bf16 kernels, f32 to its 3xTF32 ones (bound by
   3 x operations at the TF32 rate, ``bound_ms``, beside the CUDA-core
   f32 figure, ``bound_ms_cuda_core``); bf16 at N > 512 takes the split
   route (``splits`` > 1: split kernels, then the combine or reduce
   kernel; both bf16 routes are the Hopper ones, ``ROUTES``);
   every main-path case is bf16. Then the split sweep: the long-N calls'
   device time at every split count, beside the policy's.
8. Serving: a ViT-B/16 ``BackboneDetector`` (random weights from a seeded
   generator, f32 params, bf16 activations) behind a ``Predictor`` with
   micro-batching and warmup: sequential, concurrent, packed-YUV420 and
   windowed requests. Checks the result dicts, that the kernels' launch
   counts rose as the path requires, and one request's ``prob_fake``
   against the plain versions. Then explain and int8 serving
   (``explain_int8_serving``): (a) ``predict_faces(explain=True)`` on 8
   crops of 224 px for ViT-B/16, B0 and the B0 + resnet18 ``voting``
   ensemble (bf16 activations; the conv nets' weights drawn so that their
   input gradient is not 0, ``_input_sensitive``): the ``saliency`` key,
   ``explain_error`` None, the launches of the request and of its
   explanation alone (ViT: K1 1 with f32 output, K2 12, K4 12), the
   explanation's ms (median of 10) and peak memory, and its grids through
   the kernels against the plain versions (``SAL_TOL``). (b) ViT-B/16 and
   B0 saved as ``.npz`` and ``.pt`` and served through the loader in f32
   and with ``QUANTIZE=int8``: ``quantized_weights`` (``INT8_WEIGHTS``),
   bytes at rest, memory after load, ``prob_fake`` against f32, forward ms
   at 1 and 16 clips, clips/s with 8 clients, launches per forward, and
   the int8 model against its own weights dequantized to f32. (c) The
   evaluator with ``--quantize int8`` on 4 clips. Then ``video_serving``:
   video files through ``Predictor.predict_video``, as on a host without
   the libav libraries the native decoder needs (``VIDEO_BACKEND=cv2``,
   ``SERVE_YUV_TRANSFER=0``, ``FACE_DETECTOR`` at auto, which must resolve
   to haar with the native engine): 4 clips of 1280 x 720, 25 fps, 48
   frames, written by ``cv2.VideoWriter`` (mp4v) with a ~440 px synthetic
   face, and one clip without a face (the center fallback answers). B0
   (random weights from seed 0, BN stats from U(0.5, 1.5)) with
   micro-batching and warmup: sequential requests, their median ms by stage
   (decode, Haar, host-to-device with the crop and resize, forward and
   policy: timed around the package's calls), clips/s with 8 clients
   (median of 3 rounds), K1 launches (one per sequential request), 8 faces
   a clip, ``prob_fake`` against the plain versions, the forward's device
   time by kernel and idle share, and the crops on the card against the
   CPU (``CROP_TOL``). ViT-B/16: one request (K1 1, K2 12) and one
   ``explain=True`` request (K4 12, the ``saliency`` key). Then ``web_app``:
   the web app (``serve/app.py``) behind its ``ThreadingWSGIServer`` on
   127.0.0.1, driven by ``urllib`` with the same clips and setting. A B0
   checkpoint (seed 0, BN stats from U(0.5, 1.5)) is autoloaded: predictor
   on the card, ``warmup_error`` None; the pages, signup, login and the
   dashboard with its cookie; ``/api/model-info`` says ``cuda``. Five
   sequential multipart uploads to ``/api/predict`` (K1 one a request; ms
   beside the same clip through ``predict_video``: the HTTP overhead), 8
   concurrent clients (clips/s, K1 one a batcher step), the first clip's
   ``prob_fake`` against the plain versions, the no-face clip against
   ``predict_video``; a background job (``POST /results``, polled to done,
   the page and the verdict of a synchronous request). Then a ViT-B/16
   checkpoint swapped in over ``/api/load-model`` (the B0 predictor
   closed): three uploads (K1 1, K2 12 each), one with ``?explain=1`` (K1
   2, K2 24, K4 12, a saliency grid), a path outside the checkpoints root
   refused (403); chat, public chat and the report give the offline
   fallbacks. No response may carry ``error``. The app's server holds the 8
   clients in its listen backlog (32; the JAX package's server keeps 5).
9. Training: a synthetic ``.npz`` face-stack set from seed 0 (24 clips of
   16 frames at 224 px) trains ViT-B/16 for one epoch through ``Trainer``
   (f32 params, bf16 activations, augment and threshold sweep on, batch 8),
   checks the launch counts of the forward and backward kernels, the
   artefacts, one step through the kernels against the plain versions, and
   serves the checkpoint it wrote; then times a train step. Then an f32
   step, the training CLI's default dtype (no ``--bf16``) on the
   ``pretrained`` ViT-B/16 model (``f32_training``): ViT-B/16 from
   ``train/cli.py::build_model``, one ``Trainer`` step at 8 clips x 16
   frames, 12 f32 forward and 12 f32 backward flash launches required, the
   step time, frames per second, peak memory, its device time by kernel,
   and its loss and grad norm through the kernels against the plain
   versions.
10. The legacy families (``legacy``), on 10 synthetic clips of 16 frames
   at 224 px from seed 0. (a) The training CLI's default invocation,
   ``train/cli.py main(["--data_dir", D, "--epochs", "1"])``: the
   frame-graph detector over ViT-Tiny (192 wide, 12 blocks, 3 heads), f32,
   batch 8 x 16 frames, lr 1e-3, one epoch; its launch counts (all f32);
   then one ``Trainer`` step of that model: 12 f32 forward and 12 f32
   backward flash launches, step ms, frames/s, peak memory, device time by
   kernel, loss and grad norm against the plain versions. (b) The loader
   serves that checkpoint through ``Predictor(model_type="vit_gcn")`` in
   bf16: K2-bf16 launches, ``prob_fake`` against the plain versions.
   (c) A full-size CNN+LSTM (random weights, BN stats from U(0.5, 1.5))
   saved as a reference ``.pt``, picked by the loader at match ratio 1.0
   and served. (d) The evaluator CLI scores the vit_gcn checkpoint and a
   logic-RNN ``.npz``: K1 and K2 launches, CSV rows. (e) ``cli_vit_gnn``
   trains ViT-S/16 + GNN (K2 and K4 f32 at (16, 6, 197, 64)) and
   ``infer_vit_gnn`` classifies one face stack, against the plain versions.
11. Conv-net training (``convnet_training``), on 10 synthetic clips of 16
   frames at 224 px from seed 0, at torch's own TF32 flags (what the
   training CLIs run with; both flags on each line). (a) ``--model
   pretrained`` at its default backbone, EfficientNet-B0, f32 and
   ``--bf16``: one ``Trainer`` step of 8 clips x 16 frames timed (mean of
   10), frames/s, peak memory, device time by kernel; ResNet-50 timed over
   3 steps. (b) One B0 step of 2 clips x 4 frames on the card and on the
   CPU from the same weights and batch: loss, grad norm and BN running
   stats within the tolerance the TF32 flags set, at the CLI's flags and
   with TF32 off. (c) ``cli_ensemble.main`` at its defaults (B0 +
   resnet18) with ``--torch-export`` for one epoch: the loader reads its
   ``.npz`` and ``.pt`` at match ratio 1.0, and a ``Predictor`` serves two
   packed-YUV420 clips (K1-YUV) at the calibration file's threshold. (d)
   ``--model temporal`` at the CLI's defaults over B0 (N = 17): a timed
   step, its 4 + 4 f32 flash launches, device time by kernel, loss and
   grad norm against the plain versions. (e) A ``.pt`` resume through the
   CLI and a ``.pt`` warm start through ``Trainer``, one epoch each. (f)
   ``moe_temporal``: ``--model temporal --moe_experts 4`` at the CLI's
   defaults for one epoch (its plan line ``dp=1,moe=4e(dense)``, launches
   all f32); a timed step of that model (4 f32 flash forward and 4 f32
   backward launches at (8, 4, 17, 64), peak memory, idle share, loss with
   the 0.01 aux term and grad norm against the plain versions, the aux in
   ``MOE["aux_range"]``); ``use_flash=False`` on the same weights (logits
   within ``DENSE_TOL``, no flash launch); a ``--bf16`` step (1 bf16 + 3
   f32 flash launches each way: the MoE's f32 output promotes the residual
   stream, as in the JAX package); the CLI's checkpoint through
   ``load_model`` (4 experts, match ratio 1.0), a ``Predictor`` (K1 1, K2
   4, ``prob_fake`` kernels vs plain) and the evaluator CLI.
12. The improved trainer and the other training CLIs (``improved``), on
   10 synthetic clips of 16 frames at 224 px from seed 0, at torch's own
   TF32 flags. (a) ``cli_improved.main`` for one epoch twice: ``--backbone
   clip`` at the CLI's defaults (the frame graph over ViT-B/16, f32, batch
   8) and ``--backbone dinov2 --bf16``: its launches against the counts the
   model gives (12 forward and 12 backward flash calls a step, 12 a
   validation batch), ``training_metrics_improved.csv``, the best
   checkpoint read by ``serve/loader.py``; one step of the CLI's trainer:
   ms (CUDA events), frames/s, peak memory, device time by kernel and the
   idle share, loss and grad norm through the kernels against the plain
   versions (f32 1e-4 / 1e-3, bf16 1e-2 / 5e-2). (b) ``train/cli.py
   --model pretrained --progressive --epochs_per_stage 1`` (B0): the three
   stage directories, stage 0's stem equal to the init with the head
   moved, the copied best checkpoint, and a timed step of each stage.
   (c) ``train/lr_finder.py`` at its defaults (B0, 8 x 8 frames, 100
   steps): more than 10 finite points, finite suggestions, CSV and SVG, ms
   a step. (d) ``evals/validate_improvements.py main(["--device", "cuda"])``.
13. Training and evaluation from raw videos (``from_videos``), at torch's
   own TF32 flags: 20 clips (10 ``*_fake``, 10 ``*_real``) of 1280 x 720 at
   25 fps, 80 frames, written by ``cv2.VideoWriter`` with the synthetic
   face, decoded through cv2 (``VIDEO_BACKEND=cv2``), the mtcnn cascade
   from ``mtcnn_weights`` (seed 0, face-class biases raised; a
   facenet-layout ``.pt`` in ``MTCNN_WEIGHTS``). (a) The cascade on 16
   frames of a clip: the frames with a kept box after each stage (at least
   one each); on 4 textured frames against the CPU, cuDNN's TF32 off
   (``MTCNN_MATCH``, ``MTCNN_SCORE_TOL``) and on. (b) ``data/prepare.py
   main --detector mtcnn --batch-clips 8``: one ``.npz`` a clip, no
   ``skipping`` line, ms a clip by stage (decode, cascade, crop) and one
   batch's cascade under the profiler (launches, idle share). (c)
   ``train/cli.py main --from-videos --detector mtcnn --epochs 1`` at the
   CLI's default model (vit_gcn, f32, batch 8 x 16 frames): artefacts,
   finite losses, no decode failure on stderr, no zero clip in a pass over
   the dataset, 12 f32 K2 and K4 launches a step; step ms, epoch s, the
   loader's wait share, peak memory. (d) ``evals/evaluate.py main
   --from-videos`` on that checkpoint (center, the cv2 route): 20 rows, K1
   once and K2 12 times a batch, the first batch's ``prob_fake`` against
   the plain versions.
14. The conditional GAN (``gan``), at ``create_image_conditioned_gan``'s
   defaults (latent 256, cond 128, base 64 channels, 224 px, ViT-Tiny
   condition), batch 8: ``extract_image_condition`` (12 f32 flash launches
   at (8, 3, 197, 64), the cond vector against the plain versions); one
   ``d_step`` on the card against the CPU from the same weights with TF32
   off and SGD at lr 1 (loss, D's running stats after their two moves, the
   updated parameters p − g: ``GAN_GRAD_TOL``); three ``d_step``/``g_step`` pairs with
   Adam at torch's TF32 flags (ms a pair, peak memory, device time and idle
   share, no flash launch); ``save_gan_checkpoint`` →
   ``load_gan_checkpoint`` byte-equal.
15. Long clips: a synthetic set from seed 0 (8 clips of 1024 frames at
   224 px, ~1.2 GB in a temp dir) and the temporal transformer over
   ViT-B/16 features (``d_model`` 256, 4 blocks, 4 heads: the training
   CLI's defaults). (a) ``Trainer`` trains it one epoch at T = 640, batch
   1 (N = 641 tokens: the flash kernels run in the regime of the TPU's
   streaming kernels K3, K5 and K6), checks the launch counts of that
   regime and that each took the split route, the artefacts and one step
   of the temporal blocks through the
   kernels against the plain versions, and times a step. (b) The evaluator
   CLI scores the checkpoint at T = 1024 (N = 1025), batch 2: launch
   counts, CSV rows, one clip's ``prob_fake`` and frame scores against the
   plain versions, ms per clip. (c) ``Predictor(model_type="temporal")``
   warms up its buckets and serves it.
16. The multi-device modes (``parallel``), each at a world of one over
   NCCL (the card's machine holds one H100; worlds of 2 and 4 are held to
   the JAX package on the CPU), each plan's step against the no-plan step
   from the same weights, batch and dropout draws (``PAR_TOL``: the first
   step's loss, grad norm, Adam moment and parameter update, the second
   step's loss),
   with its step ms, idle share and peak memory beside the no-plan step's,
   its flash launches and the calls that show its mode ran (the step's
   gradient reduction under the mesh; the ring's fold and block gradients,
   Ulysses' all-to-alls, ``apply_expert_parallel``, ``pipeline_blocks``;
   none in the no-plan step): (a) ViT-B/16 (bf16, 8 clips x 16 frames, one padded)
   under ``build_plan``'s ``--mesh data=1`` plan; (b) the same under FSDP2
   (``make_fsdp_spec_fn(1)``: ``build_plan`` refuses ``--fsdp`` at data <
   2, as JAX does), its placement line, the model an ``FSDPModule`` and
   every leaf the rule shards a DTensor; (c) in the long-clip phase, the
   temporal model over ViT-B/16 at T = 640, batch 1, one ``Trainer`` step
   under the plans for ``--seq ring`` and ``--seq ulysses`` (seq_par 1, no
   cls token: N = 640) against the no-plan step of the same model (K3 and
   K5/K6 inside the ring's Function and after the all-to-alls); (d) the
   ring's fold at a virtual S = 2 and 4 over one (1, 4, 2048, 64) call in
   bf16 and f32, O and dq/dk/dv against one flash call over the whole N
   and against the plain versions (``RING_TOL``); (e) the temporal model
   over B0 (f32, the CLI's defaults) with 4 experts through
   ``apply_expert_parallel`` at G = 1 (capacity at every token) against
   the dense MoE, and as a pipeline at S = 1, M = 2 against the loop.
17. ``steps_per_call > 1`` (``multi_step``): ViT-B/16 (bf16) and B0 (f32)
   at the CLI's batch (8 clips x 16 frames of 224 px, the last batch with
   a padded clip), ``make_multi_step`` at k = 4 over one stacked transfer
   against four ``make_train_step`` calls on the same batches from the
   same weights (Adam, augment and dropout off): the group's loss, the
   last grad norm and the update within ``PAR_TOL``, ms per optimizer step
   and peak memory of both, K2 and K4 12 a ViT step; then ``train/cli.py
   --steps_per_call 4`` for one epoch (B0, 19 training clips in batches of
   4: a group and the tail of 3).
18. Serving data parallelism (``serve_dp``): B0 and ViT-B/16 Predictors
   (bf16) over two replicas on the card against one replica: the same
   clips under 8 clients (median clips/s of ``ROUNDS``) and a request of
   3 windows padded to 4; ``prob_fake`` within ``PROB_TOL``, every bucket
   a multiple of 2, each replica's shards one K1 launch each.
19. Summary: the ``{"kernels": [...]}`` line (K1, K1's YUV entry, K2-K6,
   each with its launches on every path and, for K2-K6, by route beside
   its f32 row; K2 and K4 with their cases at the legacy phase's shapes
   and at the conv-net training phase's, (8, 4, 17, 64) f32 and bf16; K4
   with its case at an explain request's shape, (8, 12, 197, 64) bf16),
   then the last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Without a CUDA device it
exits 2 and prints no result.

``python3 chip_smoke.py serve_dp`` (a machine with several cards, one
process): phase 18 with the Predictors over every visible card
(``device="cuda"`` with ``SERVE_DP=1``) against card 0 alone, under 8 and
32 clients, with K1 and K2 launches by card; exits 2 with fewer than two
cards.
``torchrun --nproc_per_node 4 chip_smoke.py multi``: see ``multi_card``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback
from unittest import mock

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12,        # dense tensor-core bf16
            "f32": 67e12,          # f32 on the CUDA cores
            "tf32x3": 495e12 / 3}  # f32-accurate products as 3xTF32 on the tensor cores
# a profiler reading of device time is held against CUDA events over calls
# queued back to back (_device_reading): the events add the card's gap
# between two queued launches, at most LAUNCH_GAP_MS (an H100's is
# kernel_queued_ms - kernel_device_ms a launch, PERF.md §6), and a reading
# under DEVICE_FLOOR of what remains is taken as time the profiler lost (a
# lost session reads about half)
LAUNCH_GAP_MS = 0.002
DEVICE_FLOOR = 0.75

K1_SOURCE = "deepfake_video_detection_tpu_torch/csrc/normalize.cu"
K2_SOURCE = "deepfake_video_detection_tpu_torch/csrc/flash_fwd.cu"
K4_SOURCE = "deepfake_video_detection_tpu_torch/csrc/flash_bwd.cu"
K1_REPLACES = "deepfake_video_detection_tpu/ops/preprocess.py:38"
K2_REPLACES = "deepfake_video_detection_tpu/ops/attention.py:180"
K3_REPLACES = "deepfake_video_detection_tpu/ops/attention.py:46"
K4_REPLACES = "deepfake_video_detection_tpu/ops/attention.py:209"
K5_REPLACES = "deepfake_video_detection_tpu/ops/attention.py:85"
K6_REPLACES = "deepfake_video_detection_tpu/ops/attention.py:119"

# each flash source routes by dtype between two hand-written kernels: bf16
# to the Hopper kernels (TMA loads, mbarriers, wgmma), f32 to 3xTF32
ROUTES = {"bf16": "Hopper bf16: TMA, mbarriers, wgmma", "f32": "tensor-core 3xTF32"}
# the flash kernels' bound by dtype: f32 is bound by the tensor cores' rate
# for 3xTF32, the old CUDA-core figure is kept beside it (bound_ms_cuda_core)
FLASH_PEAK = {"bf16": "bf16", "f32": "tf32x3"}
MAIN_NOTES = ("main", "K3 main", "K5/K6 main")
# f32 cases at the main paths' shapes: the training CLI's default dtype
# (no --bf16) runs the 3xTF32 kernels there (PERF.md's f32 rows; the
# f32_training phase, ViT-B/16, is their path at N <= 512)
F32_ROW = "f32 row: "

# tolerances, with their reasons
K1_TOL = {"f32": 1e-6,    # same IEEE steps in the same order: a few f32 ulp
          "bf16": 1.6e-2}  # one bf16 ulp for |y| in [2, 4), at a rounding tie
K1_YUV_TOL = {"f32": 1e-4,     # the same steps; the plain version's division by
                               # a scalar may run as a multiply by its reciprocal
              "bf16": 2e-2}    # of max |ref|: bf16 rounding of the output
BF16_TOL_REL = 2e-2         # bf16 outputs: max error over the reference's max |value|
K2_TOL_F32 = 1e-4           # f32 O, absolute: sums taken in another order
K2_TOL_LSE = 1e-3           # f32 logsumexp, sum order
PROB_TOL = 2e-2             # served prob_fake, kernels vs plain versions, bf16
K4_TOL_F32 = 1e-3           # atol = rtol, the JAX suite's gradient tolerance (sum order)
K4_TOL_FLOOR = 1e-4         # absolute floor: at N = 1 dQ, dK are 0 up to f32 residue
STEP_TOL_LOSS = 1e-2        # one train step, kernels vs plain, relative: bf16
STEP_TOL_NORM = 5e-2        # activations through 12 blocks round at other places
# the f32 step, kernels vs plain, relative: f32 end to end, so only the
# attention differs, its products 3xTF32 and its sums in another order
# (~1e-5 of max |ref| a kernel call, PERF.md); a wrong kernel moves these by
# whole percents
F32_STEP_TOL_LOSS = 1e-4
F32_STEP_TOL_NORM = 1e-3
# the long-clip paths, kernels vs plain on the same backbone features: only
# the 4 temporal blocks' attention differs, by bf16 rounding; each limit is
# 5-15x the reading on an H100 (PERF.md), and a wrong kernel moves these
# quantities by tens of percent
LONG_TOL_NORM = 1e-3        # temporal parameters' grad norm, relative
LONG_TOL_SCORES = 5e-2      # f32 frame scores: max error over max |ref|

# the long-clip phase: the temporal transformer at the training CLI's
# defaults over ViT-B/16 features; one synthetic set of 1024-frame clips
# serves both paths (the dataset subsamples uniformly to T)
# the conv-net serving phases: T = 8 face crops of 224 px, buckets 1-16
CONV = {"frames": 8, "size": 224, "clients": 8, "bn_seed": 0,
        "ensemble": ("efficientnet_b0", "resnet18")}
ROUNDS = 3    # rounds of each concurrent measurement
# the agent's payload keys (JAX serve/predict.py:569-576)
AGENT_KEYS = ("is_fake", "ensemble_prob", "confidence", "alert_level", "uncertainty",
              "explanation")

# the legacy phase: the training CLI's default model (vit_gcn over
# ViT-Tiny, f32, batch 8 x 16 frames, lr 1e-3) on 10 synthetic clips (8
# train, 2 validation) of 16 frames at 224 px; its checkpoint served in
# bf16 and evaluated; a full-size CNN+LSTM served; the ViT-GNN CLIs
LEGACY = {"vit": "vit_tiny_patch16_224", "depth": 12, "clips": 10, "frames": 16,
          "size": 224, "batch": 8, "lr": 1e-3, "bn_seed": 0, "gnn_epochs": 2}
# the legacy Predictor path's result keys (JAX serve/predict.py:690-700)
LEGACY_KEYS = ("prediction", "verdict_yes_no", "description", "pred_class", "confidence",
               "prob_real", "prob_fake", "num_faces", "threshold")
# the kernel cases at the legacy phase's shapes (3 or 6 heads)
LEGACY_ROW = "legacy: "

# the conv-net training phase: 10 synthetic clips x 16 frames at 224 px (8
# train, 2 validation); the training CLI's defaults (batch 8 x 16 frames; the
# temporal model d_model 256, 4 blocks, 4 heads: N = 17); one B0 step of 2
# clips x 4 frames on the card and on the CPU; two clips served
CONVTRAIN = {"clips": 10, "frames": 16, "size": 224, "batch": 8, "cmp_clips": 2,
             "cmp_frames": 4, "serve_clips": 2, "d_model": 256, "depth": 4, "num_heads": 4}
# the kernel cases at the temporal model's shape over B0 (N = 17, 4 heads)
CONV_ROW = "convnet: "
# one B0 train step, card vs CPU, by the card's TF32 flags: relative
# differences of the loss, the grad norm and the BN running stats
# (bn_stats_rel_diff: a mean by the channel's std, a variance by itself).
# f32: cuDNN's and the CPU's conv sums in other orders, through 16 blocks
# of train-mode BN; TF32 (cuDNN's default for convolutions): 10-bit
# products in every conv
CPU_TOL = {"f32": {"loss": 1e-4, "grad_norm": 1e-3, "bn_stats": 1e-3},
           "tf32": {"loss": 1e-2, "grad_norm": 5e-2, "bn_stats": 5e-2}}

# the explain and int8 phase: explain=True on 8 face crops of 224 px, int8
# serving of 2 clips and 8 concurrent clients, the evaluator on 4 clips
EXPLAIN = {"frames": 8, "size": 224, "iters": 10, "clients": 8, "eval_clips": 4}
# the weights that QUANTIZE=int8 holds in int8, by backbone of the detector
# (every matmul and conv weight of 4096 elements or more);
# tests/test_torch_port_quant.py holds these counts against the JAX package's
INT8_WEIGHTS = {"vit_base_patch16_224": 51, "efficientnet_b0": 59}
# saliency grids in [0, 1], kernels vs plain versions on the card, absolute:
# a bf16 model's backward rounds at other places through 12 blocks
SAL_TOL = {"bf16": 5e-2, "f32": 1e-3}
# the kernel case at an explain request's shape
EXPLAIN_ROW = "explain: "

# the video-serving phase: clips written by cv2 (mp4v; the card's machine
# has cv2 with FFMPEG but no libav for the native decoder), 1280 x 720 at
# 25 fps, 48 frames; a ~440 px synthetic face (~110 px at HAAR_MAX_SIDE =
# 320) drifting through 4 clips, and one clip without a face; requests of
# MAX_FRAMES = 8 crops of 224 px (every 5th frame)
VIDEO = {"clips": 4, "width": 1280, "height": 720, "fps": 25, "frames": 48, "face": 440,
         "max_frames": 8, "size": 224, "clients": 8, "crop_iters": 10}
# decode through cv2, crop RGB on the card: the packed-YUV path and the
# center detector's in-decoder crop need the native decoder (libav)
VIDEO_ENV = {"VIDEO_BACKEND": "cv2", "SERVE_YUV_TRANSFER": "0"}
CROP_TOL = 1   # crops on the card vs the CPU, uint8 levels: f32 sums in another order

# the from-videos phase: 20 mp4v clips (10 *_fake, 10 *_real) of 1280 x 720
# at 25 fps, 80 frames, the synthetic face drifting 2 px a frame; the mtcnn
# cascade from mtcnn_weights (seed 0, face-class biases raised); prep with
# --batch-clips 8 (16 frames a clip at VIDEO_SAMPLE_RATE 5), the training
# CLI's default model from videos (batch 8 x 16 frames), the evaluator
FROM_VIDEOS = {"clips": 20, "frames": 80, "batch_clips": 8, "num_frames": 16, "batch": 8,
               "cmp_frames": 4, "face_bias": (2.0, 1.7, 1.7)}
# the cascade on the card vs the CPU with cuDNN's TF32 off: the share of
# valid boxes matched at IoU > 0.5, and the largest score gap over them (f32
# sums in other orders: ~1e-6; TF32 convolutions move scores by ~1e-3)
MTCNN_MATCH = 0.9
MTCNN_SCORE_TOL = 1e-3

# the MoE temporal phase: the training CLI's --model temporal --moe_experts 4
# at its defaults (EfficientNet-B0, d_model 256, 4 blocks, 4 heads, batch 8 x
# 16 frames, f32) on the conv-net training phase's synthetic set; the
# load-balance loss E * sum(fraction * mean prob) is 1 at a balanced router
# and at most E (rounding can take a balanced one a hair under 1)
MOE = {"experts": 4, "serve_frames": 8, "aux_weight": 0.01, "aux_range": (1.0 - 1e-3, 4.0)}
# the dense attention (use_flash=False) against the flash route on the card,
# the same weights, f32 logits: sums in another order through 4 blocks
DENSE_TOL = 1e-4

# the GAN phase: create_image_conditioned_gan's defaults (latent 256, cond
# 128, base 64 channels, 224 px, a ViT-Tiny condition), batch 8, Adam 1e-3
GAN = {"batch": 8, "pairs": 3, "lr": 1e-3}
# the D step's updated parameters p - g (SGD, lr 1), card vs CPU with TF32
# off: their distance over the step's length, ||g_card - g_cpu|| / ||g_cpu||.
# Sums in other orders move a few of D's ~3M leaky-ReLU inputs across the
# kink (slope 1 against 0.2), which moves whole rows of the gradient: on the
# CPU, inputs moved by 1e-6 of themselves move this distance by 3.9e-4
GAN_GRAD_TOL = CPU_TOL["f32"]["grad_norm"]

LONG = {"backbone": "vit_base_patch16_224", "d_model": 256, "depth": 4,
        "num_heads": 4, "clips": 8, "frames": 1024, "train_frames": 640,
        "eval_batch": 2, "size": 224, "serve_frames": 8}

# the parallel phase: every multi-device mode on a world of one over NCCL.
# (a)/(b) ViT-B/16, bf16, the training phase's batch (8 clips x 16 frames of
# 224 px, one padded); (d) the ring's fold at a virtual S over one
# (1, 4, 2048, 64) call; (e) the temporal model over B0 at the training CLI's
# defaults (f32, 8 clips x 16 frames): MoE with 4 experts, the pipeline with
# 2 microbatches
PARALLEL = {"clips": 8, "frames": 16, "size": 224, "ring_shape": (1, 4, 2048, 64),
            "ring_s": (2, 4), "experts": 4, "pp_microbatches": 2}
# a plan's step against the no-plan step from the same weights, batch and
# dropout draws, relative. A world of one runs the same arithmetic save for
# f32 sums taken in another order (the pipeline's microbatches, the clip's
# norm over FSDP2's shards, batch norm's moments from global sums): the
# first step's loss and grad norm read 0 or ~2e-7 on an H100 (PERF.md,
# PR 17). ``moment``: Adam's first moment after the first step (linear in
# the clipped gradient the optimizer consumed), ‖m_plan − m‖ / ‖m‖ (a B0
# step on the CPU, batch norm's moments from global sums: 1.4e-6).
# ``update``: the parameters' change in that step, ‖Δ_plan − Δ‖ / ‖Δ‖;
# Adam's first step divides each gradient by its own size, so an element
# whose gradient is near 0 moves by up to its rounding over eps (a B0 step
# on the CPU reads 4e-4), hence the looser gate; a skipped or doubled
# update reads 0.5 or more. ``loss2``: the second step's loss, which reads
# the updated parameters.
PAR_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "moment": 1e-4, "update": 1e-2, "loss2": 1e-4}
# the ring's fold against one flash call over the whole N and against the
# plain versions: bf16 of max |ref| (PERF.md §2), f32 absolute
RING_TOL = {"bf16": {"fwd": BF16_TOL_REL, "bwd": BF16_TOL_REL},
            "f32": {"fwd": K2_TOL_F32, "bwd": K4_TOL_F32}}
# the multi-step phase: k optimizer steps a call against k single steps at
# the CLI's batch (the flash calls a step by model), then the CLI flag on a
# training split of 19 clips (batches 4, 4, 4, 4 and a tail of 3)
MULTI_STEP = {"k": 4, "clips": 8, "frames": 16, "size": 224, "timed_calls": 2,
              "flash": {"vit": 12, "b0": 0}, "cli_clips": 23, "cli_batch": 4}
# serving data parallelism: two replicas on the one card (the serve_dp
# phase), every card with ``chip_smoke.py serve_dp``
SERVE_DP = {"frames": 8, "size": 224, "windows": 3, "clients_cards": (8, 32)}


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _queued_ms(torch, fn, iters: int = 20):
    """Mean ms per call by CUDA events with the host out of the way: the
    card spins (``torch.cuda._sleep``) while the host queues all ``iters``
    calls, so the events take them back to back: the device time of their
    kernels plus the gaps between launches. None if the spin ended before
    the host had queued them (``fn`` waits on the card), even at 16 times
    the first spin."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * host_s * 2e9) + 1_000_000  # 4x the host's time at <= 2 GHz
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()  # the card still spun when the last call was queued
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 4
    return None


def _profile(torch, fn, iters: int) -> dict:
    """One ``torch.profiler`` session (CUDA activity only) of ``iters``
    calls: each kernel's name -> (its records, its mean device ms a record)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {ev.key: (ev.count, ev.self_device_time_total / ev.count / 1e3)
            for ev in prof.key_averages() if ev.self_device_time_total > 0}


def _device_reading(torch, fn, iters: int, accept):
    """``fn``'s kernels under ``torch.profiler``, held against
    ``_queued_ms`` of the same calls. The profiler can drop records, and a
    session may read every kernel at about half its time (PERF.md §6). So a
    kernel's time a call is its mean over the records held times its
    launches a call (its records per call, rounded, at least 1), and the
    session's sum must agree with the queued events: at most their time
    (plus 5 % and 1 µs of event resolution), at least ``DEVICE_FLOOR`` of
    it less ``LAUNCH_GAP_MS`` a launch. Up to three sessions; returns the
    first that agrees and that ``accept`` takes, as (``_profile``'s dict,
    launches a call by kernel), else None."""
    queued = _queued_ms(torch, fn, iters)
    if queued is None:
        return None
    for _ in range(3):
        recs = _profile(torch, fn, iters)
        per_call = {k: max(1, round(n / iters)) for k, (n, _) in recs.items()}
        total = sum(ms * per_call[k] for k, (_, ms) in recs.items())
        floor = DEVICE_FLOOR * (queued - LAUNCH_GAP_MS * sum(per_call.values()))
        if recs and accept(recs) and floor <= total <= 1.05 * queued + 1e-3:
            return recs, per_call
    return None


def _device_ms(torch, fn, kernels, iters: int = 20, parts=None):
    """Mean device ms per call of the named ``kernels`` (substrings of the
    kernel names) over ``iters`` calls, checked as ``_device_reading`` says,
    each named kernel with at least half its records (one a call); None
    otherwise. ``parts``, a dict, receives each kernel's share. Beside
    ``_time_ms`` it tells the device's share from the host's: where the host
    enqueues slower than the card runs, the events time the host."""
    def held(recs):
        return all(2 * sum(n for key, (n, _) in recs.items() if k in key) >= iters
                   for k in kernels)

    got = _device_reading(torch, fn, iters, held)
    if got is None:
        return None
    recs, per_call = got
    ms = {k: sum(m * per_call[key] for key, (_, m) in recs.items() if k in key)
          for k in kernels}
    if parts is not None:
        parts.update(ms)
    return sum(ms.values())


def _session_device_ms(torch, fn, iters: int = 20):
    """Mean device ms per call of every kernel ``fn`` launches, checked as
    ``_device_reading`` says (None otherwise): for a library call, whose
    kernels are not ours to name."""
    got = _device_reading(torch, fn, iters, bool)
    if got is None:
        return None
    recs, per_call = got
    return sum(ms * per_call[k] for k, (_, ms) in recs.items())


def _flash_kernels(direction: str, dtype: str, splits: int) -> list:
    """The kernels one flash call launches, by name: f32 runs the 3xTF32
    kernels, bf16 the Hopper ones (TMA and wgmma), unsplit (S = 1) or split
    with the combine (forward) or reduce (backward) kernel."""
    if direction == "fwd":
        if dtype == "f32":
            return ["flash_fwd_tf32_kernel"]
        if splits == 1:
            return ["flash_fwd_bf16_wgmma_kernel"]
        return ["flash_fwd_split_bf16_wgmma_kernel", "flash_fwd_combine_kernel"]
    if dtype == "f32":
        return ["flash_bwd_dq_tf32_kernel", "flash_bwd_dkv_tf32_kernel"]
    if splits == 1:
        return ["flash_bwd_dq_bf16_wgmma_kernel", "flash_bwd_dkv_bf16_wgmma_kernel"]
    return ["flash_bwd_dq_split_bf16_wgmma_kernel", "flash_bwd_dkv_split_bf16_wgmma_kernel",
            "flash_bwd_reduce_kernel"]


def _bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _ptxas_stats(log: str) -> list:
    """Registers and spill bytes of each kernel in one ``nvcc -Xptxas -v``
    log: a "Function properties for NAME" line, then its stack and spill
    line, then its "Used N registers" line."""
    stats, cur = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            cur = {"function": line.split()[-1]}
        elif cur is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            stats.append(cur)
            cur = None
    return stats


# the tensor-core flash kernels, bf16 unsplit and split and f32 (templates
# on the padded head dim), and the split route's combine and reduce kernels
TC_KERNEL = re.compile(r"flash_(fwd|bwd_dq|bwd_dkv)(_split)?_(bf16|tf32)(_wgmma)?_kernel"
                       r"|flash_(fwd_combine|bwd_reduce)_kernel")
TC_KERNELS_D64 = 11
# the bf16 Hopper kernels (forward 2, backward 4), whose SASS must hold
# wgmma products (HGMMA) and TMA loads (UTMALDG)
HOPPER_KERNEL = re.compile(r"flash_(fwd|bwd_dq|bwd_dkv)(_split)?_bf16_wgmma_kernel")
HOPPER_KERNELS_D64 = 6
HOPPER_OPCODES = ("HGMMA", "UTMALDG")


def sass_counts(lib_path, opcodes=HOPPER_OPCODES) -> dict:
    """Each kernel's count of each opcode in a built library's SASS
    (``cuobjdump -sass``, the toolkit's beside ``nvcc``), by mangled name."""
    from deepfake_video_detection_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            cur = counts.setdefault(line.split("Function :")[1].strip(), dict.fromkeys(opcodes, 0))
        elif cur is not None:
            for op in opcodes:
                cur[op] += op in line
    return counts


def check_build(build_log: dict) -> list:
    """The tensor-core flash kernels at d = 64 (every main path: bf16 and
    the f32 training step) and the split route's combine and reduce kernels
    spill nothing, the bf16 Hopper kernels at d = 64 (forward and backward)
    hold HGMMA and UTMALDG instructions, and ptxas serialized the products
    of neither source; returns their ptxas records (with their dynamic
    shared memory and SASS counts for the Hopper kernels)."""
    from deepfake_video_detection_tpu_torch.ops import _build
    from deepfake_video_detection_tpu_torch.ops import attention as A

    logs = [build_log.get(os.path.basename(src), "") for src in (K2_SOURCE, K4_SOURCE)]
    if not all(logs):
        print("  ptxas: flash libraries built by an earlier run, no stats", flush=True)
        return []
    tc = []
    for src, log in zip(("flash_fwd.cu", "flash_bwd.cu"), logs):
        for st in _ptxas_stats(log):
            m = TC_KERNEL.search(st["function"])
            if m and ("Li64E" in st["function"] or m.group(5)):
                tc.append(dict(st, source=src, kernel=m.group(0)))
    sass = {src: sass_counts(_build.library_path(src)) for src in ("flash_fwd.cu", "flash_bwd.cu")}
    for st in tc:
        m = HOPPER_KERNEL.search(st["kernel"])
        if m:
            st["dynamic_smem_bytes"] = (A._fwd_smem(64) if m.group(1) == "fwd"
                                        else A._bwd_smem(64)[m.group(1) == "bwd_dkv"])
            st["sass"] = sass[st["source"]].get(st["function"], dict.fromkeys(HOPPER_OPCODES, 0))
        print(f"  ptxas[{st['source']}] {st['kernel']}: {st['registers']} registers, "
              f"{st['spill_stores']} bytes spill stores"
              + (f", {st['dynamic_smem_bytes']} bytes dynamic shared memory, SASS {st['sass']}"
                 if "sass" in st else ""), flush=True)
    # ptxas's notes on the products (C75xx); C7514, C7515 and C7520 say it
    # serialized them
    notes = [(src, line.strip()) for src, log in zip(("flash_fwd.cu", "flash_bwd.cu"), logs)
             for line in log.splitlines() if "wgmma" in line]
    for src, line in notes:
        print(f"  ptxas[{src}] {line}", flush=True)
    _require(len(tc) == TC_KERNELS_D64,
             f"expected {TC_KERNELS_D64} flash kernels at d = 64 in the ptxas logs, got {tc}")
    _require(all(st["spill_stores"] == 0 for st in tc),
             f"a tensor-core flash kernel spills at d = 64: {tc}")
    hopper = [st for st in tc if "sass" in st]
    _require(len(hopper) == HOPPER_KERNELS_D64 and all(st["sass"][op] > 0 for st in hopper
                                                       for op in HOPPER_OPCODES),
             f"the bf16 Hopper kernels at d = 64 lack HGMMA or UTMALDG: {hopper}")
    _require(not any("serialized" in line for _, line in notes),
             f"ptxas serialized the bf16 kernels' wgmma products: {notes}")
    return tc


def check_k1(torch, P, gen):
    """fused_normalize vs its plain version. Returns the case records."""
    cases = []
    specs = [((16, 8, 224, 224, 3), torch.bfloat16, "main"),
             ((16, 8, 224, 224, 3), torch.float32, ""),
             ((3, 37, 41, 3), torch.bfloat16, "size not a multiple of 128"),
             ((5, 7, 3), torch.float32, "input not 16-byte aligned")]
    for shape, dt, note in specs:
        n = int(np.prod(shape))
        if "aligned" in note:
            buf = torch.randint(0, 256, (n + 1,), dtype=torch.uint8,
                                device="cuda", generator=gen)
            x = buf[1:].view(shape)
        else:
            x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                              generator=gen)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        got = P.fused_normalize(x, dt)
        ref = P.fused_normalize_plain(x, dt)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        tol = K1_TOL[name]
        itemsize = torch.empty((), dtype=dt).element_size()
        bound, by = _bound_ms(n * (1 + itemsize), 3 * n, "f32")
        rec = {"kernel": "fused_normalize", "shape": list(shape), "out": name,
               "note": note, "max_abs_err": err, "tol": tol,
               "kernel_ms": _time_ms(torch, lambda: P.fused_normalize(x, dt)),
               "kernel_device_ms": _device_ms(torch, lambda: P.fused_normalize(x, dt),
                                              ["normalize_kernel"]),
               "plain_ms": _time_ms(torch, lambda: P.fused_normalize_plain(x, dt)),
               "library_ms": None, "bound_ms": bound, "bound_by": by}
        _emit(rec)
        _require(err <= tol, f"fused_normalize {shape} -> {name}: err {err} > {tol}")
        cases.append(rec)
    return cases


def check_k1_yuv(torch, P, gen):
    """fused_normalize_yuv vs its plain version. Returns the case records."""
    cases = []
    specs = [((16, 8, 224, 224), torch.bfloat16, "main: the 16-clip serving bucket"),
             ((16, 8, 224, 224), torch.float32, ""),
             ((3, 5, 224, 224), torch.bfloat16, "an odd-sized batch")]
    for (B, T, H, W), dt, note in specs:
        x = torch.randint(0, 256, (B, T, H * W * 3 // 2), dtype=torch.uint8,
                          device="cuda", generator=gen)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        got = P.fused_normalize_yuv(x, H, W, dt)
        ref = P.fused_normalize_yuv_plain(x, H, W, dt)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        ref_max = float(ref.float().abs().max())
        tol = K1_YUV_TOL[name] * (ref_max if name == "bf16" else 1.0)
        pixels = B * T * H * W
        itemsize = got.element_size()
        # 1.5 bytes in and 3 outputs a pixel; ~13 f32 operations an output
        bound, by = _bound_ms(pixels * (1.5 + 3 * itemsize), 39.0 * pixels, "f32")
        rec = {"kernel": "fused_normalize_yuv", "shape": [B, T, H, W], "out": name,
               "note": note, "max_abs_err": err, "ref_max_abs": ref_max,
               "tol": K1_YUV_TOL[name],
               "tol_kind": "relative to max |ref|" if name == "bf16" else "absolute",
               "kernel_ms": _time_ms(torch, lambda: P.fused_normalize_yuv(x, H, W, dt)),
               "kernel_device_ms": _device_ms(
                   torch, lambda: P.fused_normalize_yuv(x, H, W, dt), ["yuv420_normalize"]),
               "plain_ms": _time_ms(torch, lambda: P.fused_normalize_yuv_plain(x, H, W, dt)),
               "plain_device_ms": _session_device_ms(
                   torch, lambda: P.fused_normalize_yuv_plain(x, H, W, dt)),
               "library_ms": None, "bound_ms": bound, "bound_by": by}
        _emit(rec)
        _require(err <= tol, f"fused_normalize_yuv {rec['shape']} -> {name}: err {err} > {tol}")
        cases.append(rec)
    return cases


def check_k2(torch, A, gen):
    """flash_attention_fwd vs its plain version. Returns the case records."""
    import torch.nn.functional as F

    cases = []
    # (B, H, N, d, dtype, q/k/v as strided views of one QKV buffer, note)
    specs = [(8, 12, 197, 64, torch.bfloat16, True, "main: one request"),
             (128, 12, 197, 64, torch.bfloat16, True, "largest bucket"),
             (8, 12, 197, 64, torch.float32, False, ""),
             (2, 12, 640, 64, torch.bfloat16, False, "K3 regime, n_pad > 512"),
             (2, 4, 1025, 64, torch.bfloat16, True,
              "K3 main: long-clip evaluation, 2 clips x 1024 frames + cls"),
             (1, 4, 641, 64, torch.bfloat16, True,
              "K3 main: long-clip training, 1 clip x 640 frames + cls"),
             (2, 4, 513, 64, torch.bfloat16, False, "N = 513: the first split shape"),
             (1, 4, 4097, 64, torch.bfloat16, True, "a clip of minutes: 4096 frames + cls"),
             (4, 6, 197, 32, torch.float32, False, "d = 32"),
             (16, 12, 1, 64, torch.bfloat16, False, "N = 1"),
             (2, 4, 130, 256, torch.float32, False, "d = 256"),
             (2, 4, 100, 80, torch.bfloat16, True, "d = 80"),
             (2, 3, 77, 36, torch.bfloat16, False, "d = 36: zero-padded copy to 40"),
             (2, 3, 77, 30, torch.float32, False, "d = 30: zero-padded copy to 32"),
             (4, 12, 256, 64, torch.bfloat16, False, "N a multiple of the tile"),
             (128, 12, 197, 64, torch.float32, True, F32_ROW + "ViT training shape"),
             (1, 4, 641, 64, torch.float32, True, F32_ROW + "long-clip training shape"),
             (128, 3, 197, 64, torch.float32, True,
              LEGACY_ROW + "the training CLI's default step (vit_gcn, ViT-Tiny)"),
             (16, 3, 197, 64, torch.bfloat16, True, LEGACY_ROW + "vit_gcn serving, one clip"),
             (16, 6, 197, 64, torch.float32, True, LEGACY_ROW + "the ViT-GNN trainer"),
             (8, 4, 17, 64, torch.float32, True,
              CONV_ROW + "the training CLI's --model temporal step over B0"),
             (8, 4, 17, 64, torch.bfloat16, True, CONV_ROW + "the same with --bf16"),
             (2, 4, 300, 128, torch.bfloat16, True, "d = 128: two 64-column boxes a tile"),
             (1, 2, 700, 256, torch.bfloat16, False, "d = 256: 32-key tiles, split")]
    for B, H, N, d, dt, strided, note in specs:
        if strided:
            qkv = torch.randn((B, N, 3, H, d), device="cuda", generator=gen).to(dt)
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        else:
            q, k, v = (torch.randn((B, H, N, d), device="cuda", generator=gen).to(dt)
                       for _ in range(3))
        name = "bf16" if dt == torch.bfloat16 else "f32"
        splits = A._long_splits(B, H, N, d, name == "bf16")[0]
        out, lse = A.flash_attention_fwd(q, k, v)
        ref, ref_lse = A.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        ref_max = float(ref.float().abs().max())
        err_lse = float((lse - ref_lse).abs().max())
        _require(bool(torch.isfinite(out.float()).all()), f"flash {note}: non-finite O")
        tol = BF16_TOL_REL * ref_max if name == "bf16" else K2_TOL_F32
        parts = {}
        itemsize = q.element_size()
        nbytes, ops = 4 * B * H * N * d * itemsize + 4 * B * H * N, 4.0 * B * H * N * N * d
        bound, by = _bound_ms(nbytes, ops, FLASH_PEAK[name])
        rec = {"kernel": "flash_attention_fwd", "shape": [B, H, N, d],
               "dtype": name, "route": ROUTES[name], "splits": splits,
               "strided_qkv": strided, "note": note,
               "max_abs_err": err, "ref_max_abs": ref_max, "rel_err": err / ref_max,
               "tol": BF16_TOL_REL if name == "bf16" else K2_TOL_F32,
               "tol_kind": "relative to max |ref|" if name == "bf16" else "absolute",
               "lse_max_abs_err": err_lse, "lse_tol": K2_TOL_LSE,
               "kernel_ms": _time_ms(torch, lambda: A.flash_attention_fwd(q, k, v)),
               "kernel_device_ms": _device_ms(
                   torch, lambda: A.flash_attention_fwd(q, k, v),
                   _flash_kernels("fwd", name, splits), parts=parts),
               "kernel_device_ms_by_kernel": parts,
               "kernel_queued_ms": _queued_ms(torch, lambda: A.flash_attention_fwd(q, k, v)),
               "plain_ms": _time_ms(torch, lambda: A.flash_attention_plain(q, k, v)),
               "library_ms": _time_ms(
                   torch, lambda: F.scaled_dot_product_attention(q, k, v)),
               "bound_ms": bound, "bound_by": by}
        if name == "f32":
            rec["bound_ms_cuda_core"] = _bound_ms(nbytes, ops, "f32")[0]
        rec["library_device_ms"] = _session_device_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v))
        rec["library_queued_ms"] = _queued_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v))
        _emit(rec)
        _require(err <= tol, f"flash {rec['shape']} {name}: O err {err} > {tol}")
        _require(err_lse <= K2_TOL_LSE, f"flash {rec['shape']} {name}: lse err {err_lse}")
        cases.append(rec)
    return cases


def _bwd_inputs(torch, A, gen, B, H, N, d, dt, strided):
    """q, k, v (views of one QKV buffer when ``strided``), the forward's out
    and lse, and dO as the (B, H, N, d) view of a (B, N, H*d) gradient, as
    the head merge of ``multi_head_attention`` hands it back."""
    if strided:
        qkv = torch.randn((B, N, 3, H, d), device="cuda", generator=gen).to(dt)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (torch.randn((B, H, N, d), device="cuda", generator=gen).to(dt)
                   for _ in range(3))
    out, lse = A.flash_attention_fwd(q, k, v)
    dout = torch.randn((B, N, H * d), device="cuda", generator=gen).to(dt)
    return q, k, v, out, lse, dout.view(B, N, H, d).transpose(1, 2)


def check_k4(torch, A, gen):
    """flash_attention_bwd vs its plain version. Returns the case records."""
    import torch.nn.functional as F

    cases = []
    # (B, H, N, d, dtype, strided q/k/v and dO, note)
    specs = [(128, 12, 197, 64, torch.bfloat16, True,
              "main: one train step of ViT-B/16 (8 clips x 16 frames)"),
             (8, 12, 197, 64, torch.float32, True, ""),
             (2, 12, 640, 64, torch.bfloat16, False, "K5/K6 regime, n_pad > 512"),
             (1, 4, 641, 64, torch.bfloat16, True,
              "K5/K6 main: long-clip training, 1 clip x 640 frames + cls"),
             (2, 4, 513, 64, torch.bfloat16, False, "N = 513: the first split shape"),
             (1, 4, 4097, 64, torch.bfloat16, True, "a clip of minutes: 4096 frames + cls"),
             (16, 12, 1, 64, torch.bfloat16, False, "N = 1"),
             (4, 6, 197, 32, torch.float32, False, "d = 32"),
             (2, 4, 130, 256, torch.float32, False, "d = 256"),
             (2, 3, 77, 36, torch.bfloat16, False, "d = 36: zero-padded copy to 40"),
             (2, 3, 77, 30, torch.float32, False, "d = 30: zero-padded copy to 32"),
             (4, 12, 256, 64, torch.bfloat16, False, "N a multiple of the tile"),
             (128, 12, 197, 64, torch.float32, True, F32_ROW + "ViT training shape"),
             (1, 4, 641, 64, torch.float32, True, F32_ROW + "long-clip training shape"),
             (128, 3, 197, 64, torch.float32, True,
              LEGACY_ROW + "the training CLI's default step (vit_gcn, ViT-Tiny)"),
             (16, 6, 197, 64, torch.float32, True, LEGACY_ROW + "the ViT-GNN trainer"),
             (8, 4, 17, 64, torch.float32, True,
              CONV_ROW + "the training CLI's --model temporal step over B0"),
             (8, 4, 17, 64, torch.bfloat16, True, CONV_ROW + "the same with --bf16"),
             (8, 12, 197, 64, torch.bfloat16, True,
              EXPLAIN_ROW + "one explain request's input gradient (ViT-B/16, 8 frames)")]
    for B, H, N, d, dt, strided, note in specs:
        q, k, v, out, lse, dout = _bwd_inputs(torch, A, gen, B, H, N, d, dt, strided)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        splits = A._long_splits(B, H, N, d, name == "bf16")[1]
        got = A.flash_attention_bwd(q, k, v, out, lse, dout)
        ref = A.flash_attention_bwd_plain(q, k, v, out, lse, dout)
        again = A.flash_attention_bwd(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        errs, rel_errs, ok = {}, {}, True
        for label, g, r in zip(("dq", "dk", "dv"), got, ref):
            _require(bool(torch.isfinite(g.float()).all()), f"flash bwd {note}: non-finite {label}")
            err = float((g.float() - r.float()).abs().max())
            ref_max = float(r.float().abs().max())
            errs[label], rel_errs[label] = err, err / max(ref_max, 1e-30)
            if name == "bf16":
                ok &= err <= max(BF16_TOL_REL * ref_max, K4_TOL_FLOOR)
            else:
                ok &= bool(torch.allclose(g, r, atol=K4_TOL_F32, rtol=K4_TOL_F32))
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))

        # the library yardstick: autograd through scaled_dot_product_attention
        # on the same inputs, minus that call's forward
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(ql, kl, vl)
            torch.autograd.grad(o, (ql, kl, vl), dout)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(ql, kl, vl)

        library_ms = _time_ms(torch, sdpa_fwd_bwd) - _time_ms(torch, sdpa_fwd)

        def bwd():
            return A.flash_attention_bwd(q, k, v, out, lse, dout)

        parts = {}
        itemsize = q.element_size()
        nbytes, ops = 8 * B * H * N * d * itemsize + 4 * B * H * N, 10.0 * B * H * N * N * d
        bound, by = _bound_ms(nbytes, ops, FLASH_PEAK[name])
        rec = {"kernel": "flash_attention_bwd", "shape": [B, H, N, d],
               "dtype": name, "route": ROUTES[name], "splits": splits,
               "strided": strided, "note": note,
               "max_abs_err": max(errs.values()), "errs": errs, "rel_errs": rel_errs,
               "tol": BF16_TOL_REL if name == "bf16" else K4_TOL_F32,
               "tol_kind": "relative to max |ref|" if name == "bf16" else "atol=rtol",
               "deterministic": deterministic,
               "kernel_ms": _time_ms(torch, bwd),
               "kernel_device_ms": _device_ms(torch, bwd, _flash_kernels("bwd", name, splits),
                                              parts=parts),
               "kernel_device_ms_by_kernel": parts,
               "kernel_queued_ms": _queued_ms(torch, bwd),
               "plain_ms": _time_ms(torch, lambda: A.flash_attention_bwd_plain(
                   q, k, v, out, lse, dout)),
               "library_ms": library_ms,
               "bound_ms": bound, "bound_by": by}
        if name == "f32":
            rec["bound_ms_cuda_core"] = _bound_ms(nbytes, ops, "f32")[0]
        fb, fo = _session_device_ms(torch, sdpa_fwd_bwd), _session_device_ms(torch, sdpa_fwd)
        rec["library_device_ms"] = None if fb is None or fo is None else fb - fo
        qb, qo = _queued_ms(torch, sdpa_fwd_bwd), _queued_ms(torch, sdpa_fwd)
        rec["library_queued_ms"] = None if qb is None or qo is None else qb - qo
        _emit(rec)
        _require(ok, f"flash bwd {rec['shape']} {name}: errors {errs}")
        _require(deterministic, f"flash bwd {rec['shape']} {name}: runs differ")
        cases.append(rec)
    return cases


# the long-N calls whose split counts the sweep measures: the main paths'
# (evaluation forward, training forward and backward), a clip of minutes and
# the K5/K6 regime's row of 12 heads
SWEEP = (("fwd", (2, 4, 1025, 64)), ("fwd", (1, 4, 641, 64)), ("bwd", (1, 4, 641, 64)),
         ("fwd", (1, 4, 4097, 64)), ("bwd", (1, 4, 4097, 64)), ("bwd", (2, 12, 640, 64)))
SWEEP_MAX_SPLITS = 16


def sweep_splits(torch, A, gen):
    """Device time of each long-N call of ``SWEEP`` at every split count S
    that keeps 2 streamed tiles a split (up to 16), beside the S that
    ``ops/attention.py::_long_splits`` picks: the measurement behind its
    constants. Returns the records."""
    recs = []
    for direction, (B, H, N, d) in SWEEP:
        q, k, v, out, lse, dout = _bwd_inputs(torch, A, gen, B, H, N, d, torch.bfloat16, True)
        if direction == "fwd":
            tiles, policy = -(-N // A._fwd_key_tile(d)), A._long_splits(B, H, N, d)[0]

            def call():
                return A.flash_attention_fwd(q, k, v)
        else:
            tiles, policy = -(-N // A._bwd_tile(d)), A._long_splits(B, H, N, d)[1]

            def call():
                return A.flash_attention_bwd(q, k, v, out, lse, dout)
        times = {}
        for S in range(1, min(SWEEP_MAX_SPLITS, tiles // 2) + 1):
            with mock.patch.object(A, "_long_splits", lambda *_, S=S: (S, S)):
                times[S] = _device_ms(torch, call, _flash_kernels(direction, "bf16", S))
        measured = {S: t for S, t in times.items() if t is not None}
        rec = {"phase": "split_sweep", "pass": direction, "shape": [B, H, N, d],
               "policy_splits": policy, "device_ms": times,
               "best_splits": min(measured, key=measured.get) if measured else None}
        _emit(rec)
        recs.append(rec)
    return recs


def _require_split_route(A, what: str) -> None:
    """Every flash call at N > 512 since the last reset took the split
    route."""
    for f in (A.flash_attention_fwd, A.flash_attention_bwd):
        _require(f.launches_split == f.launches_long,
                 f"{what}: {f.__name__} launched {f.launches_long} times at N > 512, "
                 f"{f.launches_split} of them split")


def _plain_attention(A):
    return mock.patch.object(A, "flash_attention",
                             lambda q, k, v: A.flash_attention_plain(q, k, v)[0])


RESULT_KEYS = ("prediction", "verdict_yes_no", "description", "pred_class",
               "confidence", "prob_real", "prob_fake", "num_faces", "threshold",
               "frame_scores")


def _check_result(res: dict, n_frames: int, what: str) -> None:
    _require(isinstance(res, dict) and "error" not in res, f"{what}: {res}")
    missing = [k for k in RESULT_KEYS if k not in res]
    _require(not missing, f"{what}: result lacks {missing}")
    p = res["prob_fake"]
    _require(isinstance(p, float) and 0.0 <= p <= 1.0, f"{what}: prob_fake {p}")
    fs = res["frame_scores"]
    _require(len(fs) == n_frames and abs(sum(fs) - 1.0) < 0.02,
             f"{what}: frame_scores {fs}")


def serve(torch, A, P, smi: str):
    """Drive the Predictor; returns (launch counts, records)."""
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.serve import predict as predict_mod
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor, serving_dtype

    T, size, windows = 8, 224, 2
    os.environ.update({"MAX_FRAMES": str(T), "SERVE_WINDOWS": str(windows),
                       "FACE_SIZE": str(size)})
    t0 = time.perf_counter()
    dtype = serving_dtype("cuda")
    _require(dtype == torch.bfloat16, f"serving dtype on the card is {dtype}")
    model = BackboneDetector("vit_base_patch16_224", compute_dtype=dtype,
                             device="cuda",
                             generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, None, "pretrained", device="cuda")
    _require(pred.warmup_done.wait(timeout=600), "warmup did not finish in 600 s")
    _require(pred.warmup_error is None, f"warmup failed: {pred.warmup_error!r}")
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    faces = [rng.integers(0, 256, (T, size, size, 3), dtype=np.uint8)
             for _ in range(8)]
    packed = [rng.integers(0, 256, (T, size * size * 3 // 2), dtype=np.uint8)
              for _ in range(2)]
    long_clip = rng.integers(0, 256, (windows * T, size, size, 3), dtype=np.uint8)

    _reset_counts(A, P)
    batches0 = pred._batcher.batches_run

    seq_s, seq = [], []
    for i in range(4):
        t = time.perf_counter()
        seq.append(pred.predict_faces(faces[i], video_id=f"seq{i}"))
        seq_s.append(time.perf_counter() - t)

    conc = [None] * 8
    barrier = threading.Barrier(8)

    def client(i):
        barrier.wait()
        conc[i] = pred.predict_faces(faces[i], video_id=f"conc{i}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    conc_s = time.perf_counter() - t
    _require(not any(th.is_alive() for th in threads), "a concurrent request hung")

    yuv = [pred._predict_pretrained(p, f"yuv{i}", packed_yuv=True)
           for i, p in enumerate(packed)]
    win = pred._predict_pretrained(long_clip, "windows", windows=windows)

    k1 = P.fused_normalize.launches
    k1y = P.fused_normalize_yuv.launches
    k2 = A.flash_attention_fwd.launches
    batches = pred._batcher.batches_run - batches0

    for i, r in enumerate(seq):
        _check_result(r, T, f"sequential request {i}")
    for i, r in enumerate(conc):
        _check_result(r, T, f"concurrent request {i}")
    for i, r in enumerate(yuv):
        _check_result(r, T, f"packed-YUV request {i}")
    _check_result(win, T, "windowed request")
    _require(win.get("windows", {}).get("count") == windows,
             f"windowed request: {win.get('windows')}")

    # every RGB forward runs K1 once; every forward runs K2 once per block
    forwards = batches + 1                    # batcher steps + the windowed scan
    rgb_forwards = forwards - len(packed)     # the two YUV requests ran alone
    depth = len(model.backbone.blocks)
    _require(k1 == rgb_forwards, f"fused_normalize launches {k1} != {rgb_forwards}")
    _require(k1y == len(packed), f"fused_normalize_yuv launches {k1y} != {len(packed)}")
    _require(k2 == depth * forwards, f"flash launches {k2} != {depth} x {forwards}")

    # the same request through the plain versions, on the card
    x = torch.from_numpy(faces[0][None]).cuda()
    with mock.patch.object(predict_mod, "fused_normalize", P.fused_normalize_plain), \
            _plain_attention(A):
        probs_plain = pred._forward(x)[0].float().cpu().numpy()[0]
    fake_idx = 1
    diff = abs(float(probs_plain[fake_idx]) - seq[0]["prob_fake"])
    _require(diff <= PROB_TOL, f"prob_fake kernels vs plain differ by {diff}")

    # forward times at one request and at the largest bucket (CUDA events)
    fwd_ms = {}
    for b in (1, 16):
        xb = torch.from_numpy(np.stack([faces[i % 8] for i in range(b)])).cuda()
        fwd_ms[b] = _time_ms(torch, lambda: pred._forward(xb), iters=5, warmup=2)
    pred.close()

    rec = {"phase": "serving", "card": smi, "model": "vit_base_patch16_224",
           "dtype": "bf16", "frames_per_clip": T, "setup_s": setup_s,
           "sequential_latency_s": seq_s,
           "concurrent_clients": 8, "concurrent_wall_s": conc_s,
           "concurrent_clips_per_s": 8 / conc_s,
           "sequential_clips_per_s": len(seq_s) / sum(seq_s),
           "forward_ms_1clip": fwd_ms[1], "forward_ms_16clips": fwd_ms[16],
           "batcher_steps": batches, "forwards": forwards,
           "launches": {"fused_normalize": k1, "fused_normalize_yuv": k1y,
                        "flash_attention_fwd": k2},
           "prob_fake_kernels": seq[0]["prob_fake"],
           "prob_fake_plain": float(probs_plain[fake_idx]),
           "prob_fake_abs_diff": diff, "prob_tol": PROB_TOL,
           "verdicts": [r["prediction"] for r in seq + conc + yuv + [win]]}
    _emit(rec)
    return {"fused_normalize": k1, "fused_normalize_yuv": k1y, "flash_attention_fwd": k2}, rec


def _randomize_bn(torch, model, seed: int) -> None:
    """BN running means and variances from U(0.5, 1.5) (as the JAX suite's
    torch re-execution does), so that eval-mode normalisation does work and
    the random-weight activations keep their scale through 16 blocks."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5, generator=gen)


def _kernel_breakdown(torch, fn, top: int = 10) -> dict:
    """Device time by kernel of one call of ``fn`` under ``torch.profiler``
    (mean of 3 calls, after one warm call): the ``top`` kernels by device
    time, their share, the call's total device time, its time by CUDA
    events and the device's idle share of that time."""
    fn()
    torch.cuda.synchronize()
    iters = 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.self_device_time_total > 0]
    total = sum(ev.self_device_time_total for ev in evs) / iters / 1e3
    evs.sort(key=lambda ev: -ev.self_device_time_total)
    wall = _time_ms(torch, fn, iters=iters, warmup=1)
    return {"device_ms": total, "events_ms": wall,
            "idle_share": max(0.0, 1.0 - total / wall) if wall > 0 else None,
            "kernels": len(evs),
            "launches": sum(ev.count for ev in evs) / iters,
            "top": [{"kernel": ev.key[:120], "ms": ev.self_device_time_total / iters / 1e3,
                     "share": ev.self_device_time_total / iters / 1e3 / total,
                     "calls": ev.count / iters} for ev in evs[:top]]}


def serve_convnet(torch, A, P, smi: str, ensemble: bool):
    """Serve EfficientNet-B0 (or the B0 + resnet18 ensemble with the
    enhanced agent) through the Predictor at full width and depth. Returns
    (launches by kernel, record, the model, the first request's crops and
    RGB and YUV results)."""
    from deepfake_video_detection_tpu_torch.agents.enhanced import EnhancedDecisionAgent
    from deepfake_video_detection_tpu_torch.models.backbone_detector import (
        BackboneDetector, EnsembleDetector)
    from deepfake_video_detection_tpu_torch.serve import predict as predict_mod
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor, serving_dtype

    T, size, n = CONV["frames"], CONV["size"], CONV["clients"]
    os.environ.update({"MAX_FRAMES": str(T), "SERVE_WINDOWS": "1", "FACE_SIZE": str(size)})
    what = "ensemble" if ensemble else "B0"
    t0 = time.perf_counter()
    dtype = serving_dtype("cuda")
    _require(dtype == torch.bfloat16, f"serving dtype on the card is {dtype}")
    gen = torch.Generator().manual_seed(0)
    if ensemble:
        model = EnsembleDetector(CONV["ensemble"], ensemble_method="average",
                                 compute_dtype=dtype, device="cuda", generator=gen)
        model_type, agent = "ensemble_pretrained", EnhancedDecisionAgent()
    else:
        model = BackboneDetector("efficientnet_b0", compute_dtype=dtype, device="cuda",
                                 generator=gen)
        model_type, agent = "pretrained", None
    _randomize_bn(torch, model, CONV["bn_seed"])
    _require(all(p.dtype == torch.float32 for p in model.parameters()), "params are not f32")
    pred = Predictor(model, None, model_type, enhanced_agent=agent, device="cuda")
    _require(pred.warmup_done.wait(timeout=600), f"{what} warmup did not finish in 600 s")
    _require(pred.warmup_error is None, f"{what} warmup failed: {pred.warmup_error!r}")
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(1)
    faces = [rng.integers(0, 256, (T, size, size, 3), dtype=np.uint8) for _ in range(n)]
    packed = [rng.integers(0, 256, (T, size * size * 3 // 2), dtype=np.uint8)
              for _ in range(n)]

    def concurrent(fn):
        return _concurrent(fn, n, what)

    # the first requests of a process pay one-time host costs (the first
    # host-to-device copies of each size): every measurement is taken in
    # rounds, and the median round is the one reported
    _reset_counts(A, P)
    batches0 = pred._batcher.batches_run
    seq_s, seq = [], []
    for i in range(6):
        t = time.perf_counter()
        seq.append(pred.predict_faces(faces[i], video_id=f"seq{i}"))
        seq_s.append(time.perf_counter() - t)
    yuv_seq = [pred._predict_pretrained(packed[i], f"yuv{i}", packed_yuv=True)
               for i in range(2)]
    conc, conc_yuv, conc_s, conc_yuv_s = [], [], [], []
    for _ in range(ROUNDS):
        res, sec = concurrent(lambda i: pred.predict_faces(faces[i], video_id=f"c{i}"))
        conc += res
        conc_s.append(sec)
        res, sec = concurrent(lambda i: pred._predict_pretrained(
            packed[i], f"cy{i}", packed_yuv=True))
        conc_yuv += res
        conc_yuv_s.append(sec)
    torch.cuda.synchronize()
    launches = {"fused_normalize": P.fused_normalize.launches,
                "fused_normalize_yuv": P.fused_normalize_yuv.launches,
                "flash_attention_fwd": A.flash_attention_fwd.launches}
    batches = pred._batcher.batches_run - batches0

    for i, r in enumerate(seq + conc + yuv_seq + conc_yuv):
        _check_result(r, T, f"{what} request {i}")
        if ensemble:
            a = r.get("enhanced_agent")
            _require(isinstance(a, dict) and sorted(a) == sorted(AGENT_KEYS),
                     f"{what} request {i}: enhanced_agent {a}")
            _require(a["explanation"] in r["description"],
                     f"{what} request {i}: description is not the agent's")
        else:
            _require(r["enhanced_agent"] is None, f"B0 request {i}: an agent answered")
    _require(launches["fused_normalize"] + launches["fused_normalize_yuv"] == batches,
             f"{what}: K1 launches {launches} != {batches} batcher steps")
    _require(launches["fused_normalize"] > 0 and launches["fused_normalize_yuv"] > 0,
             f"{what}: a K1 entry was not launched: {launches}")
    _require(launches["flash_attention_fwd"] == 0, f"{what}: attention launched {launches}")

    # the first request through the plain versions, on the card
    x = torch.from_numpy(faces[0][None]).cuda()
    xp = torch.from_numpy(packed[0][None]).cuda()
    with mock.patch.object(predict_mod, "fused_normalize", P.fused_normalize_plain), \
            mock.patch.object(predict_mod, "fused_normalize_yuv", P.fused_normalize_yuv_plain):
        p_plain = float(pred._forward(x)[0].float().cpu()[0, 1])
        p_plain_yuv = float(pred._forward_yuv(xp)[0].float().cpu()[0, 1])
    diff = abs(p_plain - seq[0]["prob_fake"])
    diff_yuv = abs(p_plain_yuv - yuv_seq[0]["prob_fake"])
    _require(max(diff, diff_yuv) <= PROB_TOL,
             f"{what} prob_fake kernels vs plain differ by {diff} (RGB), {diff_yuv} (YUV)")

    # forward times at one request and at the largest bucket (CUDA events),
    # and the device time by kernel of one 16-clip forward of each kind
    fwd_ms, breakdown = {}, {}
    for b in (1, 16):
        xb = torch.from_numpy(np.stack([faces[i % n] for i in range(b)])).cuda()
        pb = torch.from_numpy(np.stack([packed[i % n] for i in range(b)])).cuda()
        fwd_ms[f"rgb_{b}"] = _time_ms(torch, lambda: pred._forward(xb), iters=5, warmup=2)
        fwd_ms[f"yuv_{b}"] = _time_ms(torch, lambda: pred._forward_yuv(pb), iters=5, warmup=2)
    breakdown["yuv_16"] = _kernel_breakdown(torch, lambda: pred._forward_yuv(pb))
    breakdown["rgb_16"] = _kernel_breakdown(torch, lambda: pred._forward(xb))
    pred.close()

    rec = {"phase": "ensemble_serving" if ensemble else "b0_serving", "card": smi,
           "model": "+".join(CONV["ensemble"]) if ensemble else "efficientnet_b0",
           "params": "f32", "activations": "bf16", "frames_per_clip": T,
           "setup_s": setup_s, "sequential_latency_s": seq_s,
           "sequential_latency_median_s": float(np.median(seq_s)),
           "concurrent_clients": n, "concurrent_wall_s": conc_s,
           "concurrent_clips_per_s": n / float(np.median(conc_s)),
           "concurrent_yuv_wall_s": conc_yuv_s,
           "concurrent_yuv_clips_per_s": n / float(np.median(conc_yuv_s)),
           "forward_ms": fwd_ms, "batcher_steps": batches, "launches": launches,
           "prob_fake_kernels": seq[0]["prob_fake"], "prob_fake_plain": p_plain,
           "prob_fake_yuv_kernels": yuv_seq[0]["prob_fake"],
           "prob_fake_yuv_plain": p_plain_yuv, "prob_tol": PROB_TOL,
           "verdicts": [r["prediction"] for r in seq + yuv_seq + conc + conc_yuv]}
    if ensemble:
        rec["enhanced_agent"] = seq[0]["enhanced_agent"]
    _emit(rec)
    for kind, b in breakdown.items():
        _emit({"phase": f"{rec['phase']}_device_time", "forward": kind, "card": smi, **b})
    print(f"{what} serving: forward {fwd_ms['yuv_16']:.2f} ms at 16 clips (YUV), "
          f"{fwd_ms['rgb_1']:.2f} ms at 1 clip; {rec['concurrent_yuv_clips_per_s']:.1f} "
          f"clips/s with {n} clients (YUV) on {smi}", flush=True)
    return launches, rec, model, (faces[0], seq[0], packed[0], yuv_seq[0])


def serve_loaded(torch, A, P, b0_model, ens_model, b0_req, ens_req):
    """Save the B0 detector with ``save_checkpoint`` and the ensemble as a
    reference ``{"model_state", "model_config"}`` ``.pt``; load each with
    ``serve/loader.py::load_model`` and serve the first request again.
    Returns (launches by kernel, record)."""
    import shutil
    import tempfile

    from deepfake_video_detection_tpu_torch.agents.enhanced import EnhancedDecisionAgent
    from deepfake_video_detection_tpu_torch.checkpoint.bridge import save_checkpoint
    from deepfake_video_detection_tpu_torch.serve.loader import load_model
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor

    root = tempfile.mkdtemp(prefix="dfdt_loader_")
    try:
        b0_path = os.path.join(root, "b0", "checkpoint_best.npz")
        save_checkpoint(b0_path, b0_model.state_dict(), meta={"model_config": {
            "model_type": "pretrained", "backbone": "efficientnet_b0"}})
        ens_path = os.path.join(root, "ensemble", "checkpoint_best.pt")
        os.makedirs(os.path.dirname(ens_path))
        torch.save({"model_state": {k: v.cpu() for k, v in ens_model.state_dict().items()},
                    "model_config": {"model_type": "ensemble_pretrained",
                                     "backbones": list(CONV["ensemble"]),
                                     "ensemble_method": "average"}}, ens_path)
        cases = [("pretrained", "efficientnet_b0", b0_path, b0_req, None),
                 ("ensemble_pretrained", CONV["ensemble"], ens_path, ens_req,
                  EnhancedDecisionAgent())]
        _reset_counts(A, P)
        out = {}
        for model_type, backbones, path, (faces, res, packed, res_yuv), agent in cases:
            t = time.perf_counter()
            model, variables, stats = load_model(path, device="cuda")
            load_s = time.perf_counter() - t
            _require(stats["model_type"] == model_type and stats["backbones"] == backbones
                     and stats["match_ratio"] == 1.0,
                     f"load_model({os.path.basename(path)}) chose {stats}")
            with mock.patch.dict(os.environ, {"SERVE_WARMUP": "0"}):
                pred = Predictor(model, variables, stats["model_type"], checkpoint_path=path,
                                 enhanced_agent=agent, device="cuda")
            got = pred.predict_faces(faces, video_id="loaded")
            got_yuv = pred._predict_pretrained(packed, "loaded_yuv", packed_yuv=True)
            pred.close()
            _check_result(got, len(faces), f"the loaded {model_type} checkpoint")
            diff = max(abs(got["prob_fake"] - res["prob_fake"]),
                       abs(got_yuv["prob_fake"] - res_yuv["prob_fake"]))
            _require(diff <= PROB_TOL, f"loaded {model_type}: prob_fake differs by {diff}")
            out[model_type] = {"file": os.path.basename(path), "load_s": load_s,
                               "stats": {k: stats[k] for k in ("model_type", "backbones",
                                                                "match_ratio", "matched")},
                               "prob_fake": got["prob_fake"], "prob_fake_abs_diff": diff}
        torch.cuda.synchronize()
        launches = {"fused_normalize": P.fused_normalize.launches,
                    "fused_normalize_yuv": P.fused_normalize_yuv.launches}
        _require(launches == {"fused_normalize": 2, "fused_normalize_yuv": 2},
                 f"loaded serving launches {launches}")
        rec = {"phase": "loader_serving", "cases": out, "launches": launches}
        _emit(rec)
        return launches, rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _write_faces(root: str, n_clips: int, T: int, size: int) -> None:
    """Synthetic ``.npz`` face stacks from seed 0, half labelled fake (the
    fake clips a little brighter)."""
    rng = np.random.default_rng(0)
    for i in range(n_clips):
        label = i % 2
        faces = rng.integers(0, 200, (T, size, size, 3), dtype=np.uint8) + 40 * label
        np.savez(os.path.join(root, f"clip_{i:02d}_{'fake' if label else 'real'}.npz"),
                 faces=faces.astype(np.uint8), label=np.int64(label))


def train(torch, A, P, smi: str):
    """Train ViT-B/16 one epoch through Trainer, check it, serve its
    checkpoint, time a step. Returns (launch counts, record)."""
    import shutil
    import tempfile

    from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
        load_checkpoint, state_dict_from_jax)
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor
    from deepfake_video_detection_tpu_torch.train.steps import global_norm
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    n_clips, T, size, B = 24, 16, 224, 8
    root = tempfile.mkdtemp(prefix="dfdt_train_")
    try:
        data, out = os.path.join(root, "faces"), os.path.join(root, "run")
        os.makedirs(data)
        t0 = time.perf_counter()
        _write_faces(data, n_clips, T, size)
        ds = VideoFacesDataset(data, num_frames=T)
        train_ds, val_ds = ds.split(0.2)
        model = BackboneDetector("vit_base_patch16_224", compute_dtype=torch.bfloat16,
                                 device="cuda", generator=torch.Generator().manual_seed(0))
        _require(all(p.dtype == torch.float32 for p in model.parameters()),
                 "training params are not f32")
        cfg = TrainerConfig(out_dir=out, epochs=1, batch_size=B, num_frames=T,
                            lr=1e-4, optimizer="adam", schedule="step", loss="ce",
                            balance="weights", grad_clip=None, best_metric="f1",
                            threshold_sweep=True, augment=True,
                            model_config={"model_type": "pretrained",
                                          "backbone": "vit_base_patch16_224"})
        trainer = Trainer(model, train_ds, val_ds, cfg, device="cuda")
        step_metrics = []
        step_fn = trainer.train_step

        def recording_step(state, batch, gen):
            state, m = step_fn(state, batch, gen)
            step_metrics.append({k: float(v) for k, v in m.items()})
            return state, m

        trainer.train_step = recording_step
        setup_s = time.perf_counter() - t0

        gc.collect()    # no garbage of an earlier phase in this one's peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(A, P)
        t = time.perf_counter()
        state = trainer.train(log=lambda msg: print(f"  trainer: {msg}", flush=True))
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t
        launches = {"flash_attention_fwd": A.flash_attention_fwd.launches,
                    "flash_attention_bwd": A.flash_attention_bwd.launches,
                    "fused_normalize": P.fused_normalize.launches}
        peak_bytes = torch.cuda.max_memory_allocated()

        depth = len(model.backbone.blocks)
        steps = state.step
        val_batches = -(-len(val_ds) // B)
        _require(steps == -(-len(train_ds) // B), f"{steps} train steps")
        _require(launches["flash_attention_fwd"] == depth * (steps + val_batches),
                 f"flash fwd launches {launches} != {depth} x ({steps} + {val_batches})")
        _require(launches["flash_attention_bwd"] == depth * steps,
                 f"flash bwd launches {launches} != {depth} x {steps}")
        _require(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                     for m in step_metrics), f"non-finite step metrics {step_metrics}")
        for name in ("checkpoint_best.npz", "training_history.csv",
                     "calibration_best.json", "preds_epoch_0.csv"):
            _require(os.path.exists(os.path.join(out, name)), f"no {name}")

        # one step's loss and grad norm, kernels vs plain versions, on one
        # augmented batch with the same dropout draws (no optimizer update)
        batch = next(iter(trainer._device_batches(train_ds, True)))
        batch.pop("paths", None)
        batch = trainer._prep_train(batch, torch.Generator(device="cuda").manual_seed(1))
        params = list(model.parameters())

        def loss_and_norm():
            logits, _ = model(batch["frames"], train=True,
                              generator=torch.Generator(device="cuda").manual_seed(2))
            loss = trainer.loss_fn(logits, batch["labels"], sample_mask=batch["valid"])
            grads = torch.autograd.grad(loss, params)
            return float(loss.detach()), float(global_norm(grads))

        loss_k, norm_k = loss_and_norm()
        with _plain_attention(A):
            loss_p, norm_p = loss_and_norm()
        d_loss = abs(loss_k - loss_p) / abs(loss_p)
        d_norm = abs(norm_k - norm_p) / norm_p
        _require(d_loss <= STEP_TOL_LOSS and d_norm <= STEP_TOL_NORM,
                 f"step kernels vs plain: loss {loss_k} vs {loss_p}, "
                 f"grad norm {norm_k} vs {norm_p}")

        # serve the checkpoint the run wrote
        best = os.path.join(out, "checkpoint_best.npz")
        variables, meta = load_checkpoint(best)
        served = BackboneDetector("vit_base_patch16_224", compute_dtype=torch.bfloat16,
                                  device="cuda")
        with mock.patch.dict(os.environ, {"SERVE_WARMUP": "0"}):
            pred = Predictor(served, state_dict_from_jax(variables), "pretrained",
                             checkpoint_path=best, device="cuda")
        faces = np.load(train_ds.files[0])["faces"]
        res = pred.predict_faces(faces, video_id="trained")
        pred.close()
        _check_result(res, T, "request to the trained checkpoint")

        # a train step at the full shape, by CUDA events
        step_ms = _time_ms(torch, lambda: step_fn(state, batch, None),
                           iters=5, warmup=1)
        rec = {"phase": "training", "card": smi, "model": "vit_base_patch16_224",
               "params": "f32", "activations": "bf16", "clips": n_clips,
               "batch_clips": B, "frames_per_clip": T, "setup_s": setup_s,
               "epoch_s": epoch_s, "train_steps": steps, "val_batches": val_batches,
               "step_metrics": step_metrics,
               "epoch_train_loss": trainer.history[-1]["train_loss"],
               "epoch_val_accuracy": trainer.history[-1]["accuracy"],
               "launches": launches,
               "step_loss_kernels": loss_k, "step_loss_plain": loss_p,
               "step_grad_norm_kernels": norm_k, "step_grad_norm_plain": norm_p,
               "step_loss_rel_diff": d_loss, "step_grad_norm_rel_diff": d_norm,
               "step_tol": {"loss": STEP_TOL_LOSS, "grad_norm": STEP_TOL_NORM},
               "checkpoint_meta_epoch": meta.get("epoch"),
               "served_prediction": res["prediction"], "served_prob_fake": res["prob_fake"],
               "step_ms": step_ms, "frames_per_s": B * T / step_ms * 1e3,
               "max_memory_allocated_bytes": peak_bytes}
        _emit(rec)
        print(f"training step {step_ms:.2f} ms ({B * T / step_ms * 1e3:.1f} frames/s), "
              f"peak {peak_bytes / 2**30:.2f} GiB allocated on {smi}", flush=True)
        return launches, rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_f32(torch, A, P, smi: str):
    """The training CLI's default dtype on the ``pretrained`` model (the
    CLI's default model, vit_gcn, is the legacy phase's): ViT-B/16 from
    ``train/cli.py::build_model`` without ``--bf16`` (f32 params and
    activations), one ``Trainer`` step at 8 clips x 16 frames of 224 px (Adam, lr 1e-4,
    augment on) on synthetic faces. Requires 12 f32 forward and 12 f32
    backward flash launches a step (the 3xTF32 kernels), times the step
    (CUDA events, 1 warm-up and 5 timed), takes one step's device time by
    kernel, and holds one step's loss and grad norm through the kernels
    against the plain versions. Returns (launches by kernel id, record)."""
    import shutil
    import tempfile

    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train.steps import global_norm
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    n_clips, T, size, B = 8, 16, 224, 8
    root = tempfile.mkdtemp(prefix="dfdt_f32_")
    try:
        data = os.path.join(root, "faces")
        os.makedirs(data)
        t0 = time.perf_counter()
        _write_faces(data, n_clips, T, size)
        ds = VideoFacesDataset(data, num_frames=T)
        model, _, model_config = cli.build_model("pretrained", T,
                                                 backbone="vit_base_patch16_224", bf16=False)
        _require(model.compute_dtype == torch.float32
                 and all(p.dtype == torch.float32 for p in model.parameters()),
                 "the CLI's default model is not f32")
        cfg = TrainerConfig(out_dir=os.path.join(root, "run"), epochs=1, batch_size=B,
                            num_frames=T, lr=1e-4, optimizer="adam", schedule="step",
                            loss="ce", balance="weights", grad_clip=None, augment=True,
                            model_config=model_config)
        trainer = Trainer(model, ds, ds, cfg, device="cuda")
        state = trainer.init_state()
        batch = next(iter(trainer._device_batches(ds, True)))
        batch.pop("paths", None)
        batch = trainer._prep_train(batch, torch.Generator(device="cuda").manual_seed(1))
        _require(batch["frames"].dtype == torch.float32, f"frames {batch['frames'].dtype}")
        step = trainer.train_step
        setup_s = time.perf_counter() - t0

        # one step (the warm-up): the launches of the path and peak memory
        gc.collect()    # no garbage of an earlier phase in this one's peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(A, P)
        state, metrics = step(state, batch, None)
        torch.cuda.synchronize()
        launches = _counts(A, P)
        f32 = {"fwd": A.flash_attention_fwd.launches_f32,
               "bwd": A.flash_attention_bwd.launches_f32}
        peak_bytes = torch.cuda.max_memory_allocated()
        depth = len(model.backbone.blocks)
        want = {"K1": 0, "K1-YUV": 0, "K2": depth, "K3": 0, "K4": depth, "K5": 0, "K6": 0}
        _require(launches == want and f32 == {"fwd": depth, "bwd": depth},
                 f"f32 step launches {launches} ({f32} f32) != {want}, all f32")
        _require(math.isfinite(float(metrics["loss"])), f"f32 step metrics {metrics}")

        step_ms = _time_ms(torch, lambda: step(state, batch, None), iters=5, warmup=0)
        breakdown = _kernel_breakdown(torch, lambda: step(state, batch, None), top=12)

        # one step's loss and grad norm, kernels vs plain versions, on the
        # same batch with the same dropout draws (no optimizer update)
        params = list(model.parameters())

        def loss_and_norm():
            logits, _ = model(batch["frames"], train=True,
                              generator=torch.Generator(device="cuda").manual_seed(2))
            loss = trainer.loss_fn(logits, batch["labels"], sample_mask=batch["valid"])
            grads = torch.autograd.grad(loss, params)
            return float(loss.detach()), float(global_norm(grads))

        loss_k, norm_k = loss_and_norm()
        _reset_counts(A, P)
        with _plain_attention(A):
            loss_p, norm_p = loss_and_norm()
        _require(not any(_counts(A, P).values()), f"the plain step launched {_counts(A, P)}")
        d_loss = abs(loss_k - loss_p) / abs(loss_p)
        d_norm = abs(norm_k - norm_p) / norm_p
        rec = {"phase": "f32_training", "card": smi, "model": "vit_base_patch16_224",
               "built_by": "train/cli.py::build_model, bf16=False", "params": "f32",
               "activations": "f32", "batch_clips": B, "frames_per_clip": T,
               "setup_s": setup_s, "launches": launches, "launches_f32": f32,
               "step_ms": step_ms, "frames_per_s": B * T / step_ms * 1e3,
               "max_memory_allocated_bytes": peak_bytes,
               "step_loss_kernels": loss_k, "step_loss_plain": loss_p,
               "step_grad_norm_kernels": norm_k, "step_grad_norm_plain": norm_p,
               "step_loss_rel_diff": d_loss, "step_grad_norm_rel_diff": d_norm,
               "step_tol": {"loss": F32_STEP_TOL_LOSS, "grad_norm": F32_STEP_TOL_NORM}}
        _emit(rec)
        _emit({"phase": "f32_training_device_time", "card": smi, **breakdown})
        _require(d_loss <= F32_STEP_TOL_LOSS and d_norm <= F32_STEP_TOL_NORM,
                 f"f32 step kernels vs plain: loss {loss_k} vs {loss_p}, "
                 f"grad norm {norm_k} vs {norm_p}")
        print(f"f32 training step {step_ms:.2f} ms ({B * T / step_ms * 1e3:.1f} frames/s), "
              f"peak {peak_bytes / 2**30:.2f} GiB allocated, {breakdown['device_ms']:.2f} ms "
              f"of device time on {smi}", flush=True)
        return launches, rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _f32_counts(A) -> dict:
    """f32 launches since the last reset at N <= 512 (K2, K4); every f32
    call on the legacy paths is at N = 197."""
    fwd, bwd = A.flash_attention_fwd, A.flash_attention_bwd
    return {"K2": fwd.launches_f32, "K4": bwd.launches_f32}


def _want(**kw) -> dict:
    return {k: kw.get(k.replace("-", "_"), 0)
            for k in ("K1", "K1-YUV", "K2", "K3", "K4", "K5", "K6")}


def legacy_train(torch, A, P, smi: str, root: str, data: str):
    """(a) The training CLI's default invocation over ``data``: vit_gcn,
    ViT-Tiny at full width and depth, f32, batch 8 x 16 frames, lr 1e-3,
    one epoch (run from ``root``, so its ``checkpoints/`` lands there).
    Then one ``Trainer`` step of the same model: its launches (12 f32
    forward and 12 f32 backward flash calls), time, frames/s, peak memory,
    device time by kernel, and its loss and grad norm through the kernels
    against the plain versions. Returns (path launches, f32 launches,
    record, the best checkpoint's path)."""
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train.steps import global_norm
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    T, B = LEGACY["frames"], LEGACY["batch"]
    cwd = os.getcwd()
    gc.collect()
    torch.cuda.synchronize()
    _reset_counts(A, P)
    t = time.perf_counter()
    os.chdir(root)
    try:
        _require(cli.main(["--data_dir", data, "--epochs", "1"]) == 0,
                 "the training CLI exited non-zero")
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    launches, f32 = _counts(A, P), _f32_counts(A)
    out = os.path.join(root, "checkpoints")
    for name in ("checkpoint_best.npz", "training_history.csv", "preds_epoch_0.csv"):
        _require(os.path.exists(os.path.join(out, name)), f"the CLI wrote no {name}")
    ds = VideoFacesDataset(data, num_frames=T)
    train_ds, val_ds = ds.split(0.2)
    steps, val_batches = -(-len(train_ds) // B), -(-len(val_ds) // B)
    depth = LEGACY["depth"]
    want = _want(K2=depth * (steps + val_batches), K4=depth * steps)
    _require(launches == want and f32 == {"K2": want["K2"], "K4": want["K4"]},
             f"CLI launches {launches} ({f32} f32) != {want}, all f32")

    # one step of the CLI's model and trainer settings
    model, adjacency, model_config = cli.build_model("vit_gcn", T)
    _require(model.compute_dtype == torch.float32 and adjacency == "chain"
             and model.vit.embed_dim == 192 and len(model.vit.blocks) == depth
             and model.vit.num_heads == 3, "the CLI's default model is not ViT-Tiny + GCN, f32")
    cfg = TrainerConfig(out_dir=os.path.join(root, "step"), epochs=1, batch_size=B,
                        num_frames=T, lr=LEGACY["lr"], optimizer="adam", schedule="step",
                        loss="ce", balance="weights", grad_clip=None, adjacency=adjacency,
                        model_config=model_config)
    trainer = Trainer(model, train_ds, val_ds, cfg, device="cuda")
    state = trainer.init_state()
    batch = next(iter(trainer._device_batches(train_ds, True)))
    batch.pop("paths", None)
    batch = trainer._prep_train(batch, torch.Generator(device="cuda").manual_seed(1))
    _require(tuple(batch["adjacency"].shape) == (B, T, T), "no adjacency in the batch")
    step = trainer.train_step
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(A, P)
    state, metrics = step(state, batch, None)
    torch.cuda.synchronize()
    step_launches, step_f32 = _counts(A, P), _f32_counts(A)
    peak_bytes = torch.cuda.max_memory_allocated()
    _require(step_launches == _want(K2=depth, K4=depth)
             and step_f32 == {"K2": depth, "K4": depth},
             f"vit_gcn step launches {step_launches} ({step_f32} f32)")
    _require(math.isfinite(float(metrics["loss"])), f"vit_gcn step metrics {metrics}")
    step_ms = _time_ms(torch, lambda: step(state, batch, None), iters=5, warmup=1)
    breakdown = _kernel_breakdown(torch, lambda: step(state, batch, None), top=12)

    params = list(model.parameters())

    def loss_and_norm():
        logits = model(batch["frames"], batch["adjacency"], train=True,
                       generator=torch.Generator(device="cuda").manual_seed(2))
        loss = trainer.loss_fn(logits, batch["labels"], sample_mask=batch["valid"])
        return float(loss.detach()), float(global_norm(torch.autograd.grad(loss, params)))

    loss_k, norm_k = loss_and_norm()
    _reset_counts(A, P)
    with _plain_attention(A):
        loss_p, norm_p = loss_and_norm()
    _require(not any(_counts(A, P).values()), f"the plain step launched {_counts(A, P)}")
    d_loss = abs(loss_k - loss_p) / abs(loss_p)
    d_norm = abs(norm_k - norm_p) / norm_p
    rec = {"phase": "legacy_training", "card": smi, "model": "vit_gcn",
           "vit_variant": LEGACY["vit"], "built_by": "train/cli.py main, default flags",
           "params": "f32", "activations": "f32", "batch_clips": B, "frames_per_clip": T,
           "cli_wall_s": cli_s, "train_steps": steps, "val_batches": val_batches,
           "launches": launches, "launches_f32": f32, "step_launches": step_launches,
           "step_ms": step_ms, "frames_per_s": B * T / step_ms * 1e3,
           "max_memory_allocated_bytes": peak_bytes,
           "step_loss_kernels": loss_k, "step_loss_plain": loss_p,
           "step_grad_norm_kernels": norm_k, "step_grad_norm_plain": norm_p,
           "step_loss_rel_diff": d_loss, "step_grad_norm_rel_diff": d_norm,
           "step_tol": {"loss": F32_STEP_TOL_LOSS, "grad_norm": F32_STEP_TOL_NORM}}
    _emit(rec)
    _emit({"phase": "legacy_training_device_time", "card": smi, **breakdown})
    _require(d_loss <= F32_STEP_TOL_LOSS and d_norm <= F32_STEP_TOL_NORM,
             f"vit_gcn step kernels vs plain: loss {loss_k} vs {loss_p}, "
             f"grad norm {norm_k} vs {norm_p}")
    print(f"vit_gcn training step {step_ms:.2f} ms ({B * T / step_ms * 1e3:.1f} frames/s), "
          f"peak {peak_bytes / 2**30:.2f} GiB allocated, {breakdown['device_ms']:.2f} ms of "
          f"device time on {smi}", flush=True)
    return launches, f32, rec, os.path.join(out, "checkpoint_best.npz")


def _legacy_result(res: dict, what: str) -> None:
    _require(isinstance(res, dict) and not res.get("abstained")
             and sorted(res) == sorted(LEGACY_KEYS), f"{what}: {res}")
    _require(isinstance(res["prob_fake"], float) and 0.0 <= res["prob_fake"] <= 1.0,
             f"{what}: prob_fake {res['prob_fake']}")


def legacy_serve(torch, A, P, smi: str, root: str, data: str, ckpt: str):
    """(b) The loader serves the CLI's checkpoint through
    ``Predictor(model_type="vit_gcn")`` in bf16: K2-bf16 launches and
    ``prob_fake`` against the plain versions. (c) A full-size CNN+LSTM
    (random weights, BN stats from U(0.5, 1.5)) saved as a reference
    ``.pt``, picked by the loader at match ratio 1.0 and served. Returns
    (path launches, f32 launches, record)."""
    from deepfake_video_detection_tpu_torch.models.cnn_lstm import CNNLSTMHybrid
    from deepfake_video_detection_tpu_torch.serve.loader import load_model
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor

    T, size = LEGACY["frames"], LEGACY["size"]
    faces = [np.load(os.path.join(data, f))["faces"] for f in sorted(os.listdir(data))[:4]]
    os.environ.update({"FACE_SIZE": str(size), "DETECT_ABSTAIN_CONF": "0"})
    pt = os.path.join(root, "cnn_lstm", "checkpoint_best.pt")
    os.makedirs(os.path.dirname(pt))
    ref_model = CNNLSTMHybrid(device="cuda", generator=torch.Generator().manual_seed(0))
    _randomize_bn(torch, ref_model, LEGACY["bn_seed"])
    torch.save({"model_state": {k: v.cpu() for k, v in ref_model.state_dict().items()},
                "model_config": {"model_type": "cnn_lstm"}}, pt)
    del ref_model
    out, launches, f32 = {}, {}, {}
    try:
        for family, path in (("vit_gcn", ckpt), ("cnn_lstm", pt)):
            t = time.perf_counter()
            model, variables, stats = load_model(path, device="cuda")
            load_s = time.perf_counter() - t
            _require(stats["model_type"] == family and stats["match_ratio"] == 1.0,
                     f"load_model({path}) chose {stats}")
            _require(model.compute_dtype == torch.bfloat16,
                     f"{family} serves {model.compute_dtype}")
            pred = Predictor(model, variables, family, checkpoint_path=path, device="cuda")
            _require(pred.warmup_done.wait(timeout=300), f"{family} warmup did not finish")
            _require(pred.warmup_error is None, f"{family} warmup failed: {pred.warmup_error!r}")
            torch.cuda.synchronize()
            _reset_counts(A, P)
            res = [pred.predict_faces(f, video_id=f"{family}{i}") for i, f in enumerate(faces)]
            torch.cuda.synchronize()
            launches[family], f32[family] = _counts(A, P), _f32_counts(A)
            for i, r in enumerate(res):
                _legacy_result(r, f"{family} request {i}")
            depth = LEGACY["depth"] if family == "vit_gcn" else 0
            _require(launches[family] == _want(K2=depth * len(faces))
                     and f32[family] == {"K2": 0, "K4": 0},
                     f"{family} serving launches {launches[family]} ({f32[family]} f32)")
            x = torch.from_numpy(faces[0][None]).cuda()
            with _plain_attention(A):
                p_plain = float(pred._forward_legacy(x)[0, 1])
            diff = abs(p_plain - res[0]["prob_fake"])
            _require(diff <= PROB_TOL, f"{family} prob_fake kernels vs plain differ by {diff}")
            fwd_ms = _time_ms(torch, lambda: pred._forward_legacy(x), iters=5, warmup=1)
            pred.close()
            out[family] = {"file": os.path.basename(path), "load_s": load_s,
                           "stats": {k: stats[k] for k in ("model_type", "match_ratio",
                                                            "matched")},
                           "launches": launches[family],
                           "prob_fake_kernels": res[0]["prob_fake"],
                           "prob_fake_plain": p_plain, "prob_fake_abs_diff": diff,
                           "prob_tol": PROB_TOL, "forward_ms_1clip": fwd_ms,
                           "verdicts": [r["prediction"] for r in res]}
            del model, variables, pred
    finally:
        os.environ.pop("DETECT_ABSTAIN_CONF", None)
    rec = {"phase": "legacy_serving", "card": smi, "activations": "bf16",
           "frames_per_clip": T, "cases": out}
    _emit(rec)
    total = {k: launches["vit_gcn"][k] + launches["cnn_lstm"][k] for k in launches["vit_gcn"]}
    return total, {"K2": 0, "K4": 0}, rec


def legacy_evaluate(torch, A, P, smi: str, root: str, data: str, ckpt: str):
    """(d) The evaluator CLI over the vit_gcn checkpoint and over a logic
    RNN ``.npz`` (``create_model``'s sizes, random weights; the pipeline's
    ViT-Tiny extractor is fresh): K1 and K2 launches and the CSV rows.
    Returns (path launches, f32 launches, record)."""
    import csv

    from deepfake_video_detection_tpu_torch.checkpoint.bridge import save_checkpoint
    from deepfake_video_detection_tpu_torch.evals import evaluate as E
    from deepfake_video_detection_tpu_torch.models.logic_rnn import create_model

    T, B = LEGACY["frames"], LEGACY["batch"]
    rnn_path = os.path.join(root, "logic_rnn.npz")
    save_checkpoint(rnn_path, create_model(device="cuda").state_dict())
    n_clips = len(os.listdir(data))
    forwards = -(-n_clips // B)
    depth = LEGACY["depth"]
    out, total, total_f32 = {}, None, {"K2": 0, "K4": 0}
    for family, path in (("vit_gcn", ckpt), ("rnn", rnn_path)):
        out_csv = os.path.join(root, f"evaluation_{family}.csv")
        _reset_counts(A, P)
        t = time.perf_counter()
        _require(E.main(["--data_dir", data, "--checkpoint", path, "--num_frames", str(T),
                         "--batch_size", str(B), "--out_csv", out_csv]) == 0,
                 f"the evaluator exited non-zero on {family}")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launches, f32 = _counts(A, P), _f32_counts(A)
        want = _want(K1=forwards, K2=depth * forwards)
        _require(launches == want and f32 == {"K2": want["K2"], "K4": 0},
                 f"{family} evaluation launches {launches} ({f32} f32) != {want}")
        with open(out_csv) as f:
            rows = list(csv.DictReader(f))
        _require(len(rows) == n_clips and all(0.0 <= float(r["prob_fake"]) <= 1.0
                                              for r in rows), f"{family} CSV rows {rows}")
        out[family] = {"wall_s": wall_s, "launches": launches, "csv_rows": len(rows),
                       "prob_fake": [float(r["prob_fake"]) for r in rows]}
        total = launches if total is None else {k: total[k] + launches[k] for k in total}
        total_f32 = {k: total_f32[k] + f32[k] for k in total_f32}
    rec = {"phase": "legacy_evaluation", "card": smi, "activations": "f32", "clips": n_clips,
           "batch_clips": B, "frames_per_clip": T, "cases": out}
    _emit(rec)
    return total, total_f32, rec


def legacy_vit_gnn(torch, A, P, smi: str, root: str, data: str):
    """(e) ``cli_vit_gnn`` trains ViT-S/16 + GNN (16 synthetic images,
    AdamW, 2 epochs) and ``infer_vit_gnn`` classifies one face stack: K2
    and K4 f32 launches at (16, 6, 197, 64), the checkpoint's class
    probabilities against the plain versions. Returns (path launches, f32
    launches, record)."""
    from deepfake_video_detection_tpu_torch.evals import infer_vit_gnn
    from deepfake_video_detection_tpu_torch.train import cli_vit_gnn

    epochs, depth = LEGACY["gnn_epochs"], 12
    ckpt = os.path.join(root, "vit_gnn_ckpt.npz")
    _reset_counts(A, P)
    t = time.perf_counter()
    _require(cli_vit_gnn.main(["--epochs", str(epochs), "--out", ckpt]) == 0,
             "cli_vit_gnn exited non-zero")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    train_launches, train_f32 = _counts(A, P), _f32_counts(A)
    want = _want(K2=depth * epochs, K4=depth * epochs)
    _require(train_launches == want and train_f32 == {"K2": want["K2"], "K4": want["K4"]},
             f"cli_vit_gnn launches {train_launches} ({train_f32} f32) != {want}")
    clip = os.path.join(data, sorted(os.listdir(data))[0])
    _reset_counts(A, P)
    probs = infer_vit_gnn.classify(clip, ckpt)
    torch.cuda.synchronize()
    infer_launches, infer_f32 = _counts(A, P), _f32_counts(A)
    _require(infer_launches == _want(K2=depth) and infer_f32 == {"K2": depth, "K4": 0},
             f"infer_vit_gnn launches {infer_launches} ({infer_f32} f32)")
    _require(infer_vit_gnn.main([clip, "--checkpoint", ckpt]) == 0, "infer_vit_gnn failed")
    with _plain_attention(A):
        probs_plain = infer_vit_gnn.classify(clip, ckpt)
    diff = float(np.abs(probs - probs_plain).max())
    _require(np.isfinite(probs).all() and diff <= PROB_TOL,
             f"ViT-GNN probabilities kernels {probs} vs plain {probs_plain}")
    rec = {"phase": "legacy_vit_gnn", "card": smi, "model": "vit_small_patch16_224 + GNN",
           "samples": 16, "epochs": epochs, "train_wall_s": train_s,
           "launches": {"train": train_launches, "infer": infer_launches},
           "probs_kernels": probs.tolist(), "probs_plain": probs_plain.tolist(),
           "probs_abs_diff": diff, "prob_tol": PROB_TOL}
    _emit(rec)
    launches = {k: train_launches[k] + infer_launches[k] for k in train_launches}
    return launches, {k: train_f32[k] + infer_f32[k] for k in train_f32}, rec


def legacy(torch, A, P, smi: str):
    """The legacy phase, (a)-(e), on one synthetic set of 10 clips x 16
    frames at 224 px from seed 0 (8 train, 2 validation). Returns
    (launches by path, f32 launches by path)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="dfdt_legacy_")
    try:
        data = os.path.join(root, "faces")
        os.makedirs(data)
        _write_faces(data, LEGACY["clips"], LEGACY["frames"], LEGACY["size"])
        paths, f32 = {}, {}
        t = time.perf_counter()
        paths["legacy_training"], f32["legacy_training"], _, ckpt = legacy_train(
            torch, A, P, smi, root, data)
        seconds = {"training": time.perf_counter() - t}
        for name, fn, args in (("legacy_serving", legacy_serve, (ckpt,)),
                               ("legacy_evaluation", legacy_evaluate, (ckpt,)),
                               ("legacy_vit_gnn", legacy_vit_gnn, ())):
            t = time.perf_counter()
            paths[name], f32[name], _ = fn(torch, A, P, smi, root, data, *args)
            seconds[name] = time.perf_counter() - t
            gc.collect()
        _emit({"phase": "legacy_seconds", **seconds})
        return paths, f32
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _convnet_step_setup(torch, data: str, out: str, model_name: str, backbone: str,
                        bf16: bool, temporal_kwargs=None):
    """A ``Trainer`` with the training CLI's settings (Adam, lr 1e-3, step
    schedule, class weights, no clip, augment on) around
    ``train/cli.py::build_model(model_name, backbone=...)``, its initial
    state and one augmented batch of ``CONVTRAIN["batch"]`` clips."""
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    T, B = CONVTRAIN["frames"], CONVTRAIN["batch"]
    ds = VideoFacesDataset(data, num_frames=T)
    model, _, model_config = cli.build_model(model_name, T, backbone=backbone, bf16=bf16,
                                             temporal_kwargs=temporal_kwargs)
    _require(all(p.dtype == torch.float32 for p in model.parameters()), "params are not f32")
    cfg = TrainerConfig(out_dir=out, epochs=1, batch_size=B, num_frames=T, lr=1e-3,
                        optimizer="adam", schedule="step", loss="ce", balance="weights",
                        grad_clip=None, augment=True, model_config=model_config)
    trainer = Trainer(model, ds, ds, cfg, device="cuda")
    batch = next(iter(trainer._device_batches(ds, True)))
    batch.pop("paths", None)
    batch = trainer._prep_train(batch, torch.Generator(device="cuda").manual_seed(1))
    return model, model_config, trainer, trainer.init_state(), batch


def _timed_step(torch, A, P, trainer, state, batch, iters: int, breakdown: bool):
    """One warm-up step (its launches and peak memory), then the mean of
    ``iters`` steps by CUDA events and, with ``breakdown``, one step's
    device time by kernel (``_kernel_breakdown``)."""
    step = trainer.train_step
    gen = torch.Generator(device="cuda").manual_seed(3)
    gc.collect()    # no garbage of an earlier phase in this one's peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(A, P)
    state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    launches, f32 = _counts(A, P), _f32_counts(A)
    peak = torch.cuda.max_memory_allocated()
    _require(math.isfinite(float(metrics["loss"])) and math.isfinite(
        float(metrics["grad_norm"])), f"step metrics {metrics}")
    ms = _time_ms(torch, lambda: step(state, batch, gen), iters=iters, warmup=1)
    rec = {"launches": launches, "launches_f32": f32, "step_ms": ms,
           "frames_per_s": batch["frames"].shape[0] * batch["frames"].shape[1] / ms * 1e3,
           "max_memory_allocated_bytes": peak, "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"])}
    if breakdown:
        rec["device_time"] = _kernel_breakdown(torch, lambda: step(state, batch, gen), top=12)
    return state, rec


def convnet_steps(torch, A, P, smi: str, root: str, data: str, flags: dict):
    """(a) The training CLI's ``--model pretrained`` at its default backbone,
    EfficientNet-B0, f32 and ``--bf16``: one ``Trainer`` step of 8 clips x
    16 frames at 224 px, timed (mean of 10 after a warm-up), frames/s, peak
    memory, device time by kernel; ResNet-50 the same, timed over 3 steps.
    No flash kernel may launch. Returns the records."""
    recs = {}
    for name, backbone, bf16, iters in (("b0_f32", "efficientnet_b0", False, 10),
                                        ("b0_bf16", "efficientnet_b0", True, 10),
                                        ("resnet50_f32", "resnet50", False, 3)):
        model, cfg, trainer, state, batch = _convnet_step_setup(
            torch, data, os.path.join(root, name), "pretrained", backbone, bf16)
        state, rec = _timed_step(torch, A, P, trainer, state, batch, iters,
                                 breakdown=name != "resnet50_f32")
        _require(not any(rec["launches"].values()), f"{name} launched {rec['launches']}")
        breakdown = rec.pop("device_time", None)
        rec = {"phase": "convnet_training", "case": name, "card": smi,
               "built_by": "train/cli.py::build_model('pretrained', backbone="
                           f"{backbone!r}, bf16={bf16})",
               "model_config": cfg, "params": "f32", "activations": "bf16" if bf16 else "f32",
               "batch_clips": batch["frames"].shape[0],
               "frames_per_clip": batch["frames"].shape[1], "timed_steps": iters,
               **flags, **rec}
        _emit(rec)
        if breakdown is not None:
            _emit({"phase": "convnet_training_device_time", "case": name, "card": smi,
                   **breakdown})
        recs[name] = rec
        print(f"{name} training step {rec['step_ms']:.2f} ms "
              f"({rec['frames_per_s']:.1f} frames/s), peak "
              f"{rec['max_memory_allocated_bytes'] / 2**30:.2f} GiB allocated on {smi}",
              flush=True)
        del model, trainer, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    return recs


def bn_stats_rel_diff(got: dict, ref: dict) -> float:
    """The largest difference of two sets of BN running stats, per channel
    in the reference's own scale: |d mean| / sqrt(var) and |d var| / var.
    (A mean that is 0 in exact arithmetic, as after a bias-free 1x1 conv of
    zero-mean channels, is only rounding residue: its own scale says
    nothing.)"""
    worst = 0.0
    for k, mean in ref.items():
        if not k.endswith("running_mean"):
            continue
        vk = k[:-len("mean")] + "var"
        var = ref[vk]
        worst = max(worst, float(((got[k] - mean).abs() / var.sqrt()).max()),
                    float(((got[vk] - var).abs() / var).max()))
    return worst


def convnet_vs_cpu(torch, smi: str, flags: dict):
    """(b) One B0 step (2 clips x 4 frames at 224 px; SGD with the ensemble
    trainer's clip, 1.0, which the step exceeds; no dropout or drop-path
    draws) on the same weights and batch on the card and on the CPU: loss,
    grad norm and BN running stats within the tolerance the card's TF32
    flags set (``CPU_TOL``), once at the CLI's flags and once with TF32
    off. Returns the records."""
    import copy

    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.train import losses, optim, steps
    from deepfake_video_detection_tpu_torch.train.state import TrainState

    B, T, size = CONVTRAIN["cmp_clips"], CONVTRAIN["cmp_frames"], CONVTRAIN["size"]
    cpu = BackboneDetector("efficientnet_b0", dropout_rate=0.0, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    cpu.backbone.drop_path_rate = 0.0
    rng = np.random.default_rng(4)
    batch = {"frames": torch.from_numpy(rng.normal(size=(B, T, size, size, 3))
                                        .astype(np.float32)),
             "labels": torch.tensor([0, 1]), "valid": torch.ones(B, dtype=torch.bool)}
    models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).cuda()}

    def run(model, dev):
        opt = optim.build_optimizer("sgd", 0.5, grad_clip=1.0)
        step = steps.make_train_step(model, opt, losses.cross_entropy_loss)
        _, m = step(TrainState.create(model, opt), {k: v.to(dev) for k, v in batch.items()})
        stats = {k: v.detach().cpu().double() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return float(m["loss"]), float(m["grad_norm"]), stats

    t = time.perf_counter()
    loss_c, norm_c, stats_c = run(models["cpu"], "cpu")
    cpu_s = time.perf_counter() - t
    recs = []
    for label, cudnn_tf32, matmul_tf32 in (("cli_flags", flags["cudnn_allow_tf32"],
                                            flags["matmul_allow_tf32"]),
                                           ("tf32_off", False, False)):
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
            cudnn_tf32, matmul_tf32
        try:
            loss_g, norm_g, stats_g = run(copy.deepcopy(models["cuda"]), "cuda")
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        tol = CPU_TOL["tf32" if cudnn_tf32 or matmul_tf32 else "f32"]
        d_stats = bn_stats_rel_diff(stats_g, stats_c)
        rec = {"phase": "convnet_training_vs_cpu", "case": label, "card": smi,
               "cudnn_allow_tf32": cudnn_tf32, "matmul_allow_tf32": matmul_tf32,
               "model": "efficientnet_b0", "batch_clips": B, "frames_per_clip": T,
               "loss_card": loss_g, "loss_cpu": loss_c,
               "loss_rel_diff": abs(loss_g - loss_c) / abs(loss_c),
               "grad_norm_card": norm_g, "grad_norm_cpu": norm_c,
               "grad_norm_rel_diff": abs(norm_g - norm_c) / norm_c,
               "bn_stats": len(stats_c), "bn_stats_rel_diff": d_stats,
               "tol": tol, "cpu_step_s": cpu_s}
        _emit(rec)
        _require(norm_c > 1.0, f"the clip did not bite: grad norm {norm_c}")
        _require(rec["loss_rel_diff"] <= tol["loss"]
                 and rec["grad_norm_rel_diff"] <= tol["grad_norm"]
                 and d_stats <= tol["bn_stats"], f"B0 step card vs CPU ({label}): {rec}")
        recs.append(rec)
    return recs


def convnet_ensemble(torch, A, P, smi: str, root: str, data: str):
    """(c) ``cli_ensemble.main`` at its defaults (B0 + resnet18, ``average``,
    AdamW, warm restarts, clip 1.0, threshold sweep) with ``--torch-export``
    for one epoch; the loader reads its ``.npz`` and ``.pt`` at match ratio
    1.0; a ``Predictor`` serves two packed-YUV420 clips from the ``.npz``
    (K1-YUV) at the calibrated threshold. (e) A ``.pt`` resume through the
    CLI and a ``.pt`` warm start through ``Trainer``, one epoch each.
    Returns (serving launches, record)."""
    from deepfake_video_detection_tpu_torch.checkpoint.store import load_any
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.models.backbone_detector import EnsembleDetector
    from deepfake_video_detection_tpu_torch.serve.loader import load_model
    from deepfake_video_detection_tpu_torch.serve.predict import (
        Predictor, load_calibration_threshold)
    from deepfake_video_detection_tpu_torch.train import cli_ensemble
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    out = os.path.join(root, "ensemble")
    t = time.perf_counter()
    _require(cli_ensemble.main(["--data_dir", data, "--epochs", "1", "--torch-export",
                                "--out_dir", out]) == 0, "cli_ensemble exited non-zero")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    npz, pt = (os.path.join(out, f"checkpoint_best.{x}") for x in ("npz", "pt"))
    cal_path = os.path.join(out, "calibration_best.json")
    for path in (npz, pt, cal_path):
        _require(os.path.exists(path), f"cli_ensemble wrote no {os.path.basename(path)}")
    with open(cal_path) as f:
        cal = json.load(f)
    loaded = {}
    for path in (npz, pt):
        model, variables, stats = load_model(path, device="cuda")
        _require(stats["model_type"] == "ensemble_pretrained"
                 and stats["backbones"] == ("efficientnet_b0", "resnet18")
                 and stats["match_ratio"] == 1.0, f"load_model({path}): {stats}")
        loaded[os.path.basename(path)] = {k: stats[k] for k in
                                          ("model_type", "backbones", "match_ratio")}

    # serve two packed-YUV420 clips at the calibrated threshold
    T, size = int(os.environ.get("MAX_FRAMES", CONV["frames"])), CONV["size"]
    rng = np.random.default_rng(5)
    packed = [rng.integers(0, 256, (T, size * size * 3 // 2), dtype=np.uint8)
              for _ in range(CONVTRAIN["serve_clips"])]
    _reset_counts(A, P)
    with mock.patch.dict(os.environ, {"SERVE_WARMUP": "0", "SERVE_WINDOWS": "1"}):
        pred = Predictor(model, variables, stats["model_type"], checkpoint_path=pt,
                         device="cuda")
        served = [pred._predict_pretrained(p, f"trained{i}", packed_yuv=True)
                  for i, p in enumerate(packed)]
        pred.close()
    torch.cuda.synchronize()
    launches = _counts(A, P)
    _require(launches == _want(K1_YUV=len(packed)), f"ensemble serving launches {launches}")
    thr = cal["best_thr_accuracy"]
    for r in served:
        _check_result(r, T, "the trained ensemble")
        _require(r["threshold"] == load_calibration_threshold(pt) == thr
                 and f"thr={thr:.2f}" in r["description"],
                 f"served threshold {r['threshold']} ({r['description']!r}) != the "
                 f"calibration file's {thr}")

    # (e) resume through the CLI, warm start through Trainer, from the .pt
    t = time.perf_counter()
    _require(cli_ensemble.main(["--data_dir", data, "--epochs", "1", "--resume", pt,
                                "--out_dir", os.path.join(root, "resumed")]) == 0,
             "the .pt resume exited non-zero")
    resume_s = time.perf_counter() - t
    ds = VideoFacesDataset(data, num_frames=CONVTRAIN["frames"])
    train_ds, val_ds = ds.split(0.2)
    model = EnsembleDetector(CONV["ensemble"], device="cuda",
                             generator=torch.Generator().manual_seed(6))
    trainer = Trainer(model, train_ds, val_ds, TrainerConfig(
        out_dir=os.path.join(root, "warm"), epochs=1, lr=1e-4, optimizer="adamw",
        schedule="warm_restarts", grad_clip=1.0, threshold_sweep=True), device="cuda")
    state = trainer.warm_start(pt)
    sd, _ = load_any(pt)
    _require(all(np.array_equal(v.cpu().numpy(), sd[k]) for k, v in model.state_dict().items())
             and state.step == 0, "the .pt warm start did not load the exported weights")
    t = time.perf_counter()
    state = trainer.train(state)
    warm_s = time.perf_counter() - t
    _require(state.step > 0 and os.path.exists(os.path.join(root, "warm", "checkpoint_best.npz")),
             "the warm-started epoch wrote no checkpoint")
    rec = {"phase": "convnet_ensemble", "card": smi, "cli": "train/cli_ensemble.py main, "
           "defaults, --epochs 1 --torch-export", "cli_s": cli_s, "loaded": loaded,
           "calibration_best_thr_accuracy": thr, "served_threshold": served[0]["threshold"],
           "served_prob_fake": [r["prob_fake"] for r in served], "launches": launches,
           "resume_epoch_s": resume_s, "warm_start_epoch_s": warm_s}
    _emit(rec)
    return launches, rec


def convnet_temporal(torch, A, P, smi: str, root: str, data: str, flags: dict):
    """(d) ``--model temporal`` at the CLI's defaults: the temporal
    transformer (``d_model`` 256, 4 blocks, 4 heads) over EfficientNet-B0,
    f32, 8 clips x 16 frames (N = 17): one ``Trainer`` step timed (mean of
    5), 4 f32 flash forward and 4 f32 flash backward launches required,
    device time by kernel, and its loss and grad norm through the kernels
    against the plain versions. Returns (launches, f32 launches, record)."""
    from deepfake_video_detection_tpu_torch.train.steps import global_norm

    tkw = {k: CONVTRAIN[k] for k in ("d_model", "depth", "num_heads")}
    model, cfg, trainer, state, batch = _convnet_step_setup(
        torch, data, os.path.join(root, "temporal"), "temporal", "efficientnet_b0", False,
        tkw)
    _require(cfg == {"model_type": "temporal", "backbone": "efficientnet_b0", **tkw},
             f"temporal model_config {cfg}")
    state, rec = _timed_step(torch, A, P, trainer, state, batch, 5, breakdown=True)
    depth = CONVTRAIN["depth"]
    _require(rec["launches"] == _want(K2=depth, K4=depth)
             and rec["launches_f32"] == {"K2": depth, "K4": depth},
             f"temporal step launches {rec['launches']} ({rec['launches_f32']} f32)")
    params = list(model.parameters())

    def loss_and_norm():
        logits, _ = model(batch["frames"], train=True,
                          generator=torch.Generator(device="cuda").manual_seed(2))
        loss = trainer.loss_fn(logits, batch["labels"], sample_mask=batch["valid"])
        return float(loss.detach()), float(global_norm(torch.autograd.grad(loss, params)))

    loss_k, norm_k = loss_and_norm()
    with _plain_attention(A):
        loss_p, norm_p = loss_and_norm()
    d_loss, d_norm = abs(loss_k - loss_p) / abs(loss_p), abs(norm_k - norm_p) / norm_p
    breakdown = rec.pop("device_time")
    rec = {"phase": "convnet_temporal_training", "card": smi, "model_config": cfg,
           "built_by": "train/cli.py::build_model('temporal'), the CLI's defaults",
           "params": "f32", "activations": "f32", "tokens": batch["frames"].shape[1] + 1,
           **flags, **rec, "step_loss_kernels": loss_k, "step_loss_plain": loss_p,
           "step_grad_norm_kernels": norm_k, "step_grad_norm_plain": norm_p,
           "step_loss_rel_diff": d_loss, "step_grad_norm_rel_diff": d_norm,
           "step_tol": {"loss": F32_STEP_TOL_LOSS, "grad_norm": F32_STEP_TOL_NORM}}
    _emit(rec)
    _emit({"phase": "convnet_temporal_training_device_time", "card": smi, **breakdown})
    _require(d_loss <= F32_STEP_TOL_LOSS and d_norm <= F32_STEP_TOL_NORM,
             f"temporal step kernels vs plain: loss {loss_k} vs {loss_p}, "
             f"grad norm {norm_k} vs {norm_p}")
    print(f"temporal (B0) training step {rec['step_ms']:.2f} ms "
          f"({rec['frames_per_s']:.1f} frames/s) on {smi}", flush=True)
    return rec["launches"], rec["launches_f32"], rec


def moe_temporal(torch, A, P, smi: str, root: str, data: str, flags: dict, dense_rec: dict):
    """The temporal transformer's one-card MoE and dense-attention modes,
    at torch's TF32 flags. (a) ``train/cli.py main --model temporal
    --moe_experts 4 --epochs 1`` at the CLI's defaults (B0, ``d_model``
    256, 4 blocks, 4 heads, batch 8 x 16 frames, f32): its plan line, its
    launches (all f32); one ``Trainer`` step of that model timed (mean of
    5), 4 f32 flash forward and 4 f32 backward launches at (8, 4, 17, 64),
    peak memory, device time by kernel and idle share, and its loss (with
    0.01 x aux) and grad norm through the kernels against the plain
    versions, the aux in ``MOE["aux_range"]``. (b) ``--bf16``: block 0 in
    bf16, blocks 1-3 in f32 (the MoE promotes, as in the JAX package): 1
    bf16 + 3 f32 flash launches a forward, the same a backward. (c) The
    CLI's checkpoint through ``serve/loader.py::load_model`` (temporal,
    4 experts, match ratio 1.0), served by a ``Predictor`` (bf16: K1 1, K2
    4), ``prob_fake`` kernels vs plain, and scored by the evaluator CLI.
    (d) ``use_flash=False`` on the same weights: logits within
    ``DENSE_TOL`` of the flash route's, no flash launch. Returns (launches
    by path, f32 launches by path)."""
    import contextlib
    import csv

    from deepfake_video_detection_tpu_torch.evals import evaluate as E
    from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
        TemporalTransformerDetector)
    from deepfake_video_detection_tpu_torch.nn.moe import MoEMLP
    from deepfake_video_detection_tpu_torch.serve.loader import load_model
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train.steps import global_norm

    n_exp, depth = MOE["experts"], CONVTRAIN["depth"]
    tkw = {**{k: CONVTRAIN[k] for k in ("d_model", "depth", "num_heads")}, "moe_experts": n_exp}
    out = os.path.join(root, "moe")
    # (a) the CLI
    _reset_counts(A, P)
    tee = _Tee(sys.stdout)
    t = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(["--data_dir", data, "--model", "temporal", "--moe_experts", str(n_exp),
                       "--epochs", "1", "--out_dir", out])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    cli_launches, cli_f32 = _counts(A, P), _f32_counts(A)
    plan = f"parallelism plan: dp=1,moe={n_exp}e(dense) over 1 devices"
    ckpt = os.path.join(out, "checkpoint_best.npz")
    _require(rc == 0 and os.path.exists(ckpt), f"the MoE CLI exited {rc}")
    _require(plan in tee.text(), f"the MoE CLI printed no {plan!r}")
    _require(cli_launches["K2"] > 0 and cli_launches["K4"] > 0
             and cli_launches["K2"] % depth == 0 and cli_launches["K4"] % depth == 0
             and cli_f32 == {"K2": cli_launches["K2"], "K4": cli_launches["K4"]}
             and cli_launches == _want(K2=cli_launches["K2"], K4=cli_launches["K4"]),
             f"MoE CLI launches {cli_launches} ({cli_f32} f32)")

    # the CLI's model, one timed step, kernels vs plain
    model, cfg, trainer, state, batch = _convnet_step_setup(
        torch, data, os.path.join(root, "moe_step"), "temporal", "efficientnet_b0", False, tkw)
    _require(cfg == {"model_type": "temporal", "backbone": "efficientnet_b0", **tkw},
             f"MoE model_config {cfg}")
    _require(all(isinstance(b.mlp, MoEMLP) and b.mlp.num_experts == n_exp
                 for b in model.blocks), "the CLI's model has no MoE blocks")
    state, rec = _timed_step(torch, A, P, trainer, state, batch, 5, breakdown=True)
    _require(rec["launches"] == _want(K2=depth, K4=depth)
             and rec["launches_f32"] == {"K2": depth, "K4": depth},
             f"MoE step launches {rec['launches']} ({rec['launches_f32']} f32)")
    breakdown = rec.pop("device_time")
    params = list(model.parameters())

    def loss_and_norm():
        logits, _, aux = model(batch["frames"], train=True,
                               generator=torch.Generator(device="cuda").manual_seed(2))
        aux = aux["moe_load_balance"]
        loss = trainer.loss_fn(logits, batch["labels"], sample_mask=batch["valid"]) \
            + MOE["aux_weight"] * aux
        return (float(loss.detach()), float(global_norm(torch.autograd.grad(loss, params))),
                float(aux.detach()))

    loss_k, norm_k, aux_k = loss_and_norm()
    with _plain_attention(A):
        loss_p, norm_p, aux_p = loss_and_norm()
    d_loss, d_norm = abs(loss_k - loss_p) / abs(loss_p), abs(norm_k - norm_p) / norm_p
    _require(d_loss <= F32_STEP_TOL_LOSS and d_norm <= F32_STEP_TOL_NORM,
             f"MoE step kernels vs plain: loss {loss_k} vs {loss_p}, "
             f"grad norm {norm_k} vs {norm_p}")
    lo, hi = MOE["aux_range"]
    _require(lo <= aux_k <= hi, f"MoE load-balance loss {aux_k} outside [{lo}, {hi}]")

    # (d) the dense attention on the same weights
    dense = TemporalTransformerDetector("efficientnet_b0", use_flash=False, device="cuda",
                                        **tkw)
    dense.load_state_dict(model.state_dict())
    with torch.inference_mode():
        _reset_counts(A, P)
        logits_dense, _ = dense(batch["frames"])
        torch.cuda.synchronize()
        dense_counts = _counts(A, P)
        logits_flash, _ = model(batch["frames"])
    dense_diff = float((logits_dense - logits_flash).abs().max())
    _require(not any(dense_counts.values()), f"use_flash=False launched {dense_counts}")
    _require(dense_diff <= DENSE_TOL, f"use_flash=False vs flash logits differ by {dense_diff}")
    del model, trainer, state, batch, dense
    gc.collect()
    torch.cuda.empty_cache()

    # (b) --bf16: one bf16 block, then f32
    model, _, trainer, state, batch = _convnet_step_setup(
        torch, data, os.path.join(root, "moe_bf16"), "temporal", "efficientnet_b0", True, tkw)
    state, rec_bf16 = _timed_step(torch, A, P, trainer, state, batch, 5, breakdown=False)
    _require(rec_bf16["launches"] == _want(K2=depth, K4=depth)
             and rec_bf16["launches_f32"] == {"K2": depth - 1, "K4": depth - 1},
             f"MoE --bf16 step launches {rec_bf16['launches']} "
             f"({rec_bf16['launches_f32']} f32)")
    del model, trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the checkpoint through the loader, a Predictor and the evaluator
    model, variables, stats = load_model(ckpt, device="cuda")
    _require(stats["model_type"] == "temporal" and stats["match_ratio"] == 1.0
             and model.moe_experts == n_exp, f"load_model({ckpt}): {stats}")
    T, size = MOE["serve_frames"], CONVTRAIN["size"]
    faces = np.random.default_rng(7).integers(0, 256, (T, size, size, 3), dtype=np.uint8)
    with mock.patch.dict(os.environ, {"SERVE_WARMUP": "0", "SERVE_WINDOWS": "1"}):
        pred = Predictor(model, variables, "temporal", checkpoint_path=ckpt, device="cuda")
        _reset_counts(A, P)
        res = pred.predict_faces(faces, video_id="moe")
        torch.cuda.synchronize()
        serve_counts, serve_f32 = _counts(A, P), _f32_counts(A)
        pred.close()
    _check_result(res, T, "a request to the MoE checkpoint")
    _require(serve_counts == _want(K1=1, K2=depth) and serve_f32["K2"] == depth - 1,
             f"MoE serving launches {serve_counts} ({serve_f32} f32)")
    x = torch.from_numpy(faces[None]).cuda()

    def prob(normalize):
        with torch.inference_mode():
            logits, _ = model(normalize(x, model.compute_dtype))
        return float(torch.softmax(logits.float(), dim=-1)[0, 1])

    p_kernels = prob(P.fused_normalize)
    with _plain_attention(A):
        p_plain = prob(P.fused_normalize_plain)
    p_diff = abs(p_kernels - p_plain)
    _require(p_diff <= PROB_TOL, f"MoE prob_fake kernels {p_kernels} vs plain {p_plain}")
    del model, variables, pred
    out_csv = os.path.join(out, "evaluation.csv")
    _reset_counts(A, P)
    t = time.perf_counter()
    _require(E.main(["--data_dir", data, "--checkpoint", ckpt, "--num_frames",
                     str(CONVTRAIN["frames"]), "--batch_size", str(CONVTRAIN["batch"]),
                     "--out_csv", out_csv, "--device", "cuda"]) == 0,
             "the evaluator exited non-zero on the MoE checkpoint")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_counts, eval_f32 = _counts(A, P), _f32_counts(A)
    with open(out_csv) as f:
        rows = list(csv.DictReader(f))
    forwards = -(-CONVTRAIN["clips"] // CONVTRAIN["batch"])
    _require(len(rows) == CONVTRAIN["clips"]
             and eval_counts == _want(K1=forwards, K2=depth * forwards)
             and eval_f32["K2"] == depth * forwards,
             f"MoE evaluation: {len(rows)} rows, launches {eval_counts} ({eval_f32} f32)")

    rec = {"phase": "moe_temporal", "card": smi, "model_config": cfg,
           "cli": f"train/cli.py main --model temporal --moe_experts {n_exp} --epochs 1",
           "plan_line": plan, "cli_s": cli_s, "cli_launches": cli_launches,
           "params": "f32", "activations": "f32", "tokens": CONVTRAIN["frames"] + 1,
           "flash_shape": [CONVTRAIN["batch"], CONVTRAIN["num_heads"], CONVTRAIN["frames"] + 1,
                           CONVTRAIN["d_model"] // CONVTRAIN["num_heads"]],
           **flags, **rec, "idle_share": breakdown["idle_share"],
           "dense_temporal_step_ms": dense_rec["step_ms"],
           "step_ms_over_dense": rec["step_ms"] / dense_rec["step_ms"],
           "aux_kernels": aux_k, "aux_plain": aux_p, "aux_range": list(MOE["aux_range"]),
           "step_loss_kernels": loss_k, "step_loss_plain": loss_p,
           "step_grad_norm_kernels": norm_k, "step_grad_norm_plain": norm_p,
           "step_loss_rel_diff": d_loss, "step_grad_norm_rel_diff": d_norm,
           "step_tol": {"loss": F32_STEP_TOL_LOSS, "grad_norm": F32_STEP_TOL_NORM},
           "bf16": {k: rec_bf16[k] for k in ("step_ms", "frames_per_s",
                                            "max_memory_allocated_bytes", "launches",
                                            "launches_f32")},
           "loaded": {k: stats[k] for k in ("model_type", "match_ratio", "compat_score")},
           "served": {"launches": serve_counts, "launches_f32": serve_f32,
                      "prediction": res["prediction"], "prob_fake": res["prob_fake"],
                      "prob_fake_kernels": p_kernels, "prob_fake_plain": p_plain,
                      "prob_fake_abs_diff": p_diff, "prob_tol": PROB_TOL},
           "evaluation": {"wall_s": eval_s, "rows": len(rows), "launches": eval_counts,
                          "launches_f32": eval_f32},
           "dense_attention": {"launches": dense_counts, "logits_max_abs_diff": dense_diff,
                               "tol": DENSE_TOL}}
    _emit(rec)
    _emit({"phase": "moe_temporal_device_time", "card": smi, **breakdown})
    print(f"MoE temporal (B0, {n_exp} experts) training step {rec['step_ms']:.2f} ms "
          f"({rec['step_ms_over_dense']:.2f}x the dense one), --bf16 "
          f"{rec_bf16['step_ms']:.2f} ms, peak "
          f"{rec['max_memory_allocated_bytes'] / 2**30:.2f} GiB on {smi}", flush=True)
    paths = {"moe_temporal_cli": cli_launches, "moe_temporal_step": rec["launches"],
             "moe_temporal_bf16_step": rec_bf16["launches"],
             "moe_temporal_serving": serve_counts, "moe_temporal_evaluation": eval_counts}
    f32 = {"moe_temporal_cli": cli_f32, "moe_temporal_step": rec["launches_f32"],
           "moe_temporal_bf16_step": rec_bf16["launches_f32"],
           "moe_temporal_serving": serve_f32, "moe_temporal_evaluation": eval_f32}
    return paths, f32


def convnet_training(torch, A, P, smi: str, tf32_defaults: dict):
    """The conv-net training phase, (a)-(e), on one synthetic set of 10
    clips x 16 frames at 224 px from seed 0, at torch's default TF32 flags
    (what the training CLIs run with; restored afterwards). Returns
    (launches by path, f32 launches by path)."""
    import shutil
    import tempfile

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32_defaults["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = tf32_defaults["matmul_allow_tf32"]
    root = tempfile.mkdtemp(prefix="dfdt_convtrain_")
    try:
        data = os.path.join(root, "faces")
        os.makedirs(data)
        _write_faces(data, CONVTRAIN["clips"], CONVTRAIN["frames"], CONVTRAIN["size"])
        seconds = {}

        def part(name, fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            seconds[name] = time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()
            return out

        part("steps", convnet_steps, torch, A, P, smi, root, data, tf32_defaults)
        part("vs_cpu", convnet_vs_cpu, torch, smi, tf32_defaults)
        served, _ = part("ensemble", convnet_ensemble, torch, A, P, smi, root, data)
        temporal, temporal_f32, temporal_rec = part("temporal", convnet_temporal, torch, A, P,
                                                    smi, root, data, tf32_defaults)
        moe_paths, moe_f32 = part("moe_temporal", moe_temporal, torch, A, P, smi, root, data,
                                  tf32_defaults, temporal_rec)
        _emit({"phase": "convnet_training_seconds", **seconds})
        return ({"convnet_serving": served, "convnet_temporal_training": temporal,
                 **moe_paths},
                {"convnet_temporal_training": temporal_f32, **moe_f32})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        shutil.rmtree(root, ignore_errors=True)


def _gan_d_step_vs_cpu(torch, VG, G, D, real, z, cond) -> dict:
    """One ``d_step`` on the card and on the CPU from the same weights and
    batch, TF32 off, with SGD at lr 1 so that the updated parameters are
    p − g: the loss, D's running stats after their two moves, the grad norm
    and the distance of the updated parameters (``GAN_GRAD_TOL``); the conv
    biases that feed a training-mode batch norm have a gradient of 0 up to
    rounding."""
    import copy

    from deepfake_video_detection_tpu_torch.train.optim import Optimizer

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        before = {k: v.detach().cpu().clone() for k, v in D.state_dict().items()}
        for dev in ("cuda", "cpu"):
            g, d = copy.deepcopy(G).to(dev), copy.deepcopy(D).to(dev)
            opt = Optimizer("sgd", 1.0, weight_decay=0, grad_clip=None)
            d_step, _ = VG.make_gan_steps(g, d, Optimizer("sgd", 1.0, weight_decay=0,
                                                          grad_clip=None), opt)
            _, loss = d_step(opt.init(dict(d.named_parameters())), real.to(dev), z.to(dev),
                             cond.to(dev))
            out[dev] = (float(loss), {k: v.detach().cpu() for k, v in d.state_dict().items()})
            del g, d
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    (loss_card, sd_card), (loss_cpu, sd_cpu) = out["cuda"], out["cpu"]
    stats = {k: v for k, v in sd_cpu.items() if k.endswith(("running_mean", "running_var"))}
    moved = {k: v for k, v in before.items() if k in stats}
    d_stats = bn_stats_rel_diff(sd_card, stats)
    cancelled = tuple(f"net.{i}.conv.bias" for i in range(1, len(D.net)))
    grads = {k: (before[k].double() - sd_card[k].double(), before[k].double() - ref.double())
             for k, ref in sd_cpu.items() if k not in stats}
    norm_card, norm_cpu, dist = (math.sqrt(sum(float(f(c, r).square().sum())
                                               for c, r in grads.values()))
                                 for f in (lambda c, r: c, lambda c, r: r,
                                           lambda c, r: c - r))
    scale = max(float(r.abs().max()) for _, r in grads.values())
    cancelled_max = max(float(grads[k][0].abs().max()) for k in cancelled) / scale
    by_tensor = {k: float((c - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                 for k, (c, r) in grads.items() if k not in cancelled}
    rec = {"batch": int(real.shape[0]), "optimizer": "sgd lr 1 (the updated params are p - g)",
           "cudnn_allow_tf32": False, "loss_card": loss_card, "loss_cpu": loss_cpu,
           "loss_rel_diff": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "bn_stats_rel_diff": d_stats,
           "bn_stats_moved": bn_stats_rel_diff(stats, moved) > 0,
           "grad_norm_card": norm_card, "grad_norm_cpu": norm_cpu,
           "grad_norm_rel_diff": abs(norm_card - norm_cpu) / norm_cpu,
           "params_distance_over_step": dist / norm_cpu,
           "cancelled_bias_grad_over_largest": cancelled_max,
           "worst_tensors_max_diff_over_own_largest": dict(
               sorted(by_tensor.items(), key=lambda kv: -kv[1])[:3]),
           "tol": {"loss": CPU_TOL["f32"]["loss"], "bn_stats": CPU_TOL["f32"]["bn_stats"],
                   "grad_norm": CPU_TOL["f32"]["grad_norm"], "params": GAN_GRAD_TOL}}
    _require(rec["loss_rel_diff"] <= CPU_TOL["f32"]["loss"]
             and d_stats <= CPU_TOL["f32"]["bn_stats"] and rec["bn_stats_moved"]
             and rec["grad_norm_rel_diff"] <= CPU_TOL["f32"]["grad_norm"]
             and rec["params_distance_over_step"] <= GAN_GRAD_TOL,
             f"GAN d_step card vs CPU: {rec}")
    return rec


def gan_phase(torch, A, P, smi: str, tf32_defaults: dict):
    """The conditional GAN (``models/vlm_gan.py``) at
    ``create_image_conditioned_gan``'s defaults: G (latent 256 + cond 128 →
    224 px), the PatchGAN D, a ViT-Tiny condition through the projector,
    batch 8, f32. (a) ``extract_image_condition``: 12 f32 flash launches at
    (8, 3, 197, 64), the cond vector against the plain versions (f32
    ``K2_TOL_F32`` of max |ref|). (b) One ``d_step`` card vs CPU
    (``_gan_d_step_vs_cpu``). (c) ``GAN["pairs"]`` ``d_step``/``g_step``
    pairs with Adam (lr 1e-3, no decay, no clip) at torch's TF32 flags: ms
    a pair by CUDA events, peak memory, device time and idle share of a
    pair; no flash launch. (d) ``save_gan_checkpoint`` →
    ``load_gan_checkpoint`` byte-equal. Returns (launches by path, f32
    launches by path)."""
    import shutil
    import tempfile

    from deepfake_video_detection_tpu_torch.models import vlm_gan as VG
    from deepfake_video_detection_tpu_torch.train.optim import Optimizer

    B = GAN["batch"]
    G, D, vit, proj = VG.create_image_conditioned_gan(
        device="cuda", generator=torch.Generator().manual_seed(0))
    size = G.img_size
    rng = np.random.default_rng(8)
    vs = vit.img_size
    imgs = torch.from_numpy(rng.normal(size=(B, vs, vs, 3)).astype(np.float32)).cuda()
    real = torch.from_numpy(rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)).cuda()
    z = torch.from_numpy(rng.normal(size=(B, G.latent_dim)).astype(np.float32)).cuda()

    # (a) the condition: ViT-Tiny through the flash kernels
    _reset_counts(A, P)
    with torch.no_grad():
        cond = VG.extract_image_condition(vit, imgs, proj)
        torch.cuda.synchronize()
        cond_counts, cond_f32 = _counts(A, P), _f32_counts(A)
        with _plain_attention(A):
            cond_plain = VG.extract_image_condition(vit, imgs, proj)
    depth = len(vit.blocks)
    _require(cond.shape == (B, proj.cond_dim), f"cond shape {tuple(cond.shape)}")
    _require(cond_counts == _want(K2=depth) and cond_f32["K2"] == depth,
             f"GAN condition launches {cond_counts} ({cond_f32} f32)")
    cond_err = float((cond - cond_plain).abs().max())
    cond_rel = cond_err / float(cond_plain.abs().max())
    _require(cond_rel <= K2_TOL_F32, f"GAN condition kernels vs plain: {cond_rel} of max |ref|")

    # (b) one D step, card vs CPU
    vs_cpu = _gan_d_step_vs_cpu(torch, VG, G, D, real, z, cond)

    # (c) the pairs, at torch's TF32 flags
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32_defaults["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = tf32_defaults["matmul_allow_tf32"]
    root = tempfile.mkdtemp(prefix="dfdt_gan_")
    try:
        opt_g, opt_d = (Optimizer("adam", GAN["lr"], weight_decay=0, grad_clip=None)
                        for _ in range(2))
        d_step, g_step = VG.make_gan_steps(G, D, opt_g, opt_d)
        gs = opt_g.init(dict(G.named_parameters()))
        ds = opt_d.init(dict(D.named_parameters()))
        losses = []

        def pair():
            _, d_loss = d_step(ds, real, z, cond)
            _, g_loss = g_step(gs, z, cond, real)
            losses.append((d_loss, g_loss))

        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(A, P)
        pair_ms = []
        for _ in range(GAN["pairs"]):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            pair()
            stop.record()
            torch.cuda.synchronize()
            pair_ms.append(start.elapsed_time(stop))
        peak = torch.cuda.max_memory_allocated()
        pair_counts = _counts(A, P)
        _require(not any(pair_counts.values()), f"a GAN step launched {pair_counts}")
        breakdown = _kernel_breakdown(torch, pair, top=8)
        _require(all(math.isfinite(float(a)) and math.isfinite(float(b)) for a, b in losses),
                 f"GAN losses {losses}")

        # (d) the checkpoint round trip
        path = os.path.join(root, "gan.npz")
        VG.save_gan_checkpoint(path, G, D, extra={"step": len(losses)})
        gsd, dsd, meta = VG.load_gan_checkpoint(path)
        for name, net, sd in (("G", G, gsd), ("D", D, dsd)):
            mine = net.state_dict()
            _require(sorted(sd) == sorted(mine) and all(
                sd[k].numpy().tobytes() == v.detach().cpu().numpy().tobytes()
                for k, v in mine.items()), f"the GAN checkpoint's {name} did not read back")
        _require(meta == {"step": len(losses), "kind": "vlm_gan"}, f"GAN meta {meta}")
        ckpt_bytes = os.path.getsize(path)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        shutil.rmtree(root, ignore_errors=True)
    warm = pair_ms[1:]
    rec = {"phase": "gan", "card": smi,
           "built_by": "models/vlm_gan.py::create_image_conditioned_gan(), its defaults",
           "latent_dim": G.latent_dim, "cond_dim": G.cond_dim, "img_size": size,
           "base_channels": G.base_channels, "batch": B, "params": "f32",
           "activations": "f32", "optimizer": "adam 1e-3, no decay, no clip",
           "loss_type": "hinge", **tf32_defaults,
           "condition": {"flash_shape": [B, vit.num_heads, vit.num_patches + 1,
                                         vit.embed_dim // vit.num_heads],
                         "launches": cond_counts, "launches_f32": cond_f32,
                         "max_abs_err": cond_err, "rel_err": cond_rel, "tol": K2_TOL_F32},
           "d_step_vs_cpu": vs_cpu,
           "pair_ms": pair_ms, "pair_ms_warm_mean": float(np.mean(warm)),
           "max_memory_allocated_bytes": peak, "idle_share": breakdown["idle_share"],
           "pair_device_ms": breakdown["device_ms"], "launches_pairs": pair_counts,
           "losses": [[float(a), float(b)] for a, b in losses],
           "checkpoint_bytes": ckpt_bytes, "checkpoint_round_trip": "byte-equal"}
    _emit(rec)
    _emit({"phase": "gan_device_time", "card": smi, **breakdown})
    print(f"GAN ({size} px, batch {B}): a d_step + g_step pair {rec['pair_ms_warm_mean']:.2f} ms, "
          f"peak {peak / 2**30:.2f} GiB, idle {breakdown['idle_share']:.3f} on {smi}",
          flush=True)
    return {"gan_condition": cond_counts}, {"gan_condition": cond_f32}


def decoder_probe() -> dict:
    """What the card's machine offers a video decoder, printed and nothing
    installed: ``libavformat`` in the loader cache, the libav headers,
    ``g++``, cv2 and its FFMPEG video I/O line, imageio-ffmpeg and the Haar
    cascade XMLs."""
    import glob
    import shutil

    def run(cmd):
        try:
            return subprocess.run(cmd, capture_output=True, text=True, timeout=20).stdout
        except (OSError, subprocess.SubprocessError) as e:
            return f"error: {e}"

    rec = {"phase": "decoder_probe",
           "libavformat": [ln.strip() for ln in run(["ldconfig", "-p"]).splitlines()
                           if "libavformat.so" in ln],
           "libav_headers": sorted(glob.glob("/usr/include/**/libavformat/avformat.h",
                                             recursive=True)
                                   + glob.glob("/usr/local/include/libavformat/avformat.h")),
           "gxx": shutil.which("g++"),
           "gxx_version": (run(["g++", "--version"]).splitlines() or [None])[0]
           if shutil.which("g++") else None}
    haar_dirs = ["/usr/share/opencv4/haarcascades", "/usr/share/opencv/haarcascades",
                 "/usr/local/share/opencv4/haarcascades"]
    try:
        import cv2
        info = cv2.getBuildInformation()
        video = [ln.strip() for ln in info.splitlines() if "FFMPEG" in ln]
        rec["cv2"] = {"version": cv2.__version__, "ffmpeg": video}
        if getattr(cv2, "data", None) is not None:
            haar_dirs.append(cv2.data.haarcascades)
    except ImportError:
        rec["cv2"] = None
    try:
        import imageio_ffmpeg
        exe = imageio_ffmpeg.get_ffmpeg_exe()
        rec["imageio_ffmpeg"] = {"version": imageio_ffmpeg.__version__, "ffmpeg": exe}
    except Exception as e:  # not installed, or no ffmpeg binary beside it
        rec["imageio_ffmpeg"] = None if isinstance(e, ImportError) else f"error: {e}"
    xmls = {p for d in haar_dirs for p in glob.glob(os.path.join(d, "*.xml"))}
    rec["haar_cascades"] = {"count": len(xmls),
                            "dirs": sorted({os.path.dirname(p) for p in xmls})}
    _emit(rec)
    return rec


def _improved_run(torch, A, P, smi: str, root: str, data: str, flags: list, name: str):
    """``cli_improved.main`` over ``data`` for one epoch with ``flags``
    (CLIP at the CLI's defaults, or DINOv2 in bf16): its launches against
    the counts the model and the split give, ``training_metrics_improved.csv``
    and the best checkpoint read back through ``serve/loader.py``; then one
    step of the CLI's own trainer (``cli_improved.build_trainer``): its
    launches (12 forward, 12 backward flash calls, f32 as 3xTF32 without
    ``--bf16``), time (CUDA events, mean of 5 after a warm-up), frames/s,
    peak memory, device time by kernel and the idle share, and its loss and
    grad norm through the kernels against the plain versions. Returns
    (launches, f32 launches, record)."""
    from deepfake_video_detection_tpu_torch.serve import loader
    from deepfake_video_detection_tpu_torch.train import cli_improved
    from deepfake_video_detection_tpu_torch.train.steps import global_norm

    out = os.path.join(root, name)
    argv = ["--data_dir", data, "--epochs", "1", "--out_dir", out, *flags]
    gc.collect()
    torch.cuda.synchronize()
    _reset_counts(A, P)
    t = time.perf_counter()
    _require(cli_improved.main(argv) == 0, f"cli_improved {flags} exited non-zero")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    launches, f32 = _counts(A, P), _f32_counts(A)
    for f in ("checkpoint_best.npz", "training_history.csv", "training_metrics_improved.csv"):
        _require(os.path.exists(os.path.join(out, f)), f"cli_improved wrote no {f}")
    model, _, stats = loader.load_model(os.path.join(out, "checkpoint_best.npz"))
    _require(stats["model_type"] == "vit_gcn" and stats["match_ratio"] == 1.0,
             f"the loader read the improved checkpoint as {stats}")
    del model

    trainer, args = cli_improved.build_trainer(argv)
    model, cfg = trainer.model, trainer.cfg
    bf16 = args.bf16
    depth, B, T = len(model.vit.blocks), cfg.batch_size, cfg.num_frames
    _require(model.vit.embed_dim == 768 and model.vit.num_heads == 12 and depth == 12
             and model.compute_dtype == (torch.bfloat16 if bf16 else torch.float32),
             f"cli_improved {flags} did not build ViT-B/16 in the asked dtype")
    steps = -(-len(trainer.train_ds) // B)
    val_batches = -(-len(trainer.val_ds) // B)
    want = _want(K2=depth * (steps + val_batches), K4=depth * steps)
    want_f32 = {"K2": 0, "K4": 0} if bf16 else {"K2": want["K2"], "K4": want["K4"]}
    _require(launches == want and f32 == want_f32,
             f"cli_improved {flags} launches {launches} ({f32} f32) != {want} ({want_f32})")

    state = trainer.init_state()
    batch = next(iter(trainer._device_batches(trainer.train_ds, True)))
    batch.pop("paths", None)
    batch = trainer._prep_train(batch, torch.Generator(device="cuda").manual_seed(1))
    state, rec = _timed_step(torch, A, P, trainer, state, batch, iters=5, breakdown=True)
    step_f32 = {"K2": 0, "K4": 0} if bf16 else {"K2": depth, "K4": depth}
    _require(rec["launches"] == _want(K2=depth, K4=depth) and rec["launches_f32"] == step_f32,
             f"improved step launches {rec['launches']} ({rec['launches_f32']} f32)")

    params = list(model.parameters())

    def loss_and_norm():
        logits = model(batch["frames"], batch["adjacency"], train=True,
                       generator=torch.Generator(device="cuda").manual_seed(2))
        loss = trainer.loss_fn(logits, batch["labels"], sample_mask=batch["valid"])
        return float(loss.detach()), float(global_norm(torch.autograd.grad(loss, params)))

    loss_k, norm_k = loss_and_norm()
    _reset_counts(A, P)
    with _plain_attention(A):
        loss_p, norm_p = loss_and_norm()
    _require(not any(_counts(A, P).values()), f"the plain step launched {_counts(A, P)}")
    d_loss, d_norm = abs(loss_k - loss_p) / abs(loss_p), abs(norm_k - norm_p) / norm_p
    tol = (STEP_TOL_LOSS, STEP_TOL_NORM) if bf16 else (F32_STEP_TOL_LOSS, F32_STEP_TOL_NORM)
    device_time = rec.pop("device_time")
    rec = {"phase": "improved_training", "card": smi, "run": name,
           "built_by": "train/cli_improved.py " + " ".join(flags),
           "flavour": args.backbone, "normalize": cfg.normalize, "loss": cfg.loss,
           "optimizer": cfg.optimizer, "params": "f32", "activations": "bf16" if bf16 else "f32",
           "batch_clips": B, "frames_per_clip": T, "cli_wall_s": cli_s, "train_steps": steps,
           "val_batches": val_batches, "cli_launches": launches, "cli_launches_f32": f32,
           "step_launches": rec["launches"], "step_launches_f32": rec["launches_f32"],
           "step_ms": rec["step_ms"], "frames_per_s": rec["frames_per_s"],
           "max_memory_allocated_bytes": rec["max_memory_allocated_bytes"],
           "device_ms": device_time["device_ms"], "idle_share": device_time["idle_share"],
           "step_loss_kernels": loss_k, "step_loss_plain": loss_p,
           "step_grad_norm_kernels": norm_k, "step_grad_norm_plain": norm_p,
           "step_loss_rel_diff": d_loss, "step_grad_norm_rel_diff": d_norm,
           "step_tol": {"loss": tol[0], "grad_norm": tol[1]},
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    _emit(rec)
    _emit({"phase": "improved_training_device_time", "card": smi, "run": name, **device_time})
    _require(d_loss <= tol[0] and d_norm <= tol[1],
             f"improved step {flags} kernels vs plain: loss {loss_k} vs {loss_p}, "
             f"grad norm {norm_k} vs {norm_p}")
    print(f"improved training step ({name}) {rec['step_ms']:.2f} ms "
          f"({rec['frames_per_s']:.1f} frames/s), peak "
          f"{rec['max_memory_allocated_bytes'] / 2**30:.2f} GiB allocated, idle "
          f"{device_time['idle_share']:.3f} on {smi}", flush=True)
    return launches, f32, rec


def progressive_training(torch, A, P, smi: str, root: str, data: str):
    """``train/cli.py --model pretrained --progressive --epochs_per_stage 1``
    at the CLI's defaults (B0, batch 8 x 16 frames): the three stage
    directories, stage 0's ``conv_stem.weight`` equal to the model's init
    bit for bit with the head moved, and the copied ``checkpoint_best.npz``;
    then one masked-AdamW step of each stage, timed (mean of 5)."""
    import filecmp

    from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
        load_checkpoint, state_dict_from_jax)
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train.progressive import ProgressiveFineTuner
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    out = os.path.join(root, "progressive")
    T, B = CONVTRAIN["frames"], CONVTRAIN["batch"]
    _reset_counts(A, P)
    t = time.perf_counter()
    _require(cli.main(["--data_dir", data, "--model", "pretrained", "--progressive",
                       "--epochs_per_stage", "1", "--out_dir", out]) == 0,
             "the progressive CLI exited non-zero")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    launches = _counts(A, P)
    stages = sorted(d for d in os.listdir(out) if d.startswith("stage"))
    _require(stages == ["stage0_head_only", "stage1_partial_unfreeze",
                        "stage2_full_finetune"], f"progressive stage directories {stages}")
    model, _, model_config = cli.build_model("pretrained", T)
    init = {k: t.cpu() for k, t in model.state_dict().items()}
    best0 = state_dict_from_jax(load_checkpoint(
        os.path.join(out, stages[0], "checkpoint_best.npz"))[0])
    _require(torch.equal(best0["backbone.conv_stem.weight"], init["backbone.conv_stem.weight"]),
             "stage 0 moved the frozen stem")
    _require(not torch.equal(best0["fc1.weight"], init["fc1.weight"]),
             "stage 0 left the head where it was")
    _require(filecmp.cmp(os.path.join(out, "checkpoint_best.npz"),
                         os.path.join(out, stages[-1], "checkpoint_best.npz"), shallow=False),
             "the last stage's best checkpoint was not copied to out_dir")

    ds = VideoFacesDataset(data, num_frames=T)
    ft = ProgressiveFineTuner(model)
    stage_ms = {}
    while True:
        sc = ft.get_stage_config()
        cfg = TrainerConfig(out_dir=os.path.join(root, "progressive_steps"), epochs=1,
                            batch_size=B, num_frames=T, lr=sc["lr"], schedule="const",
                            loss="ce", balance="weights", grad_clip=None, augment=True,
                            model_config=model_config)
        trainer = Trainer(model, ds, ds, cfg, tx=ft.make_optimizer(), device="cuda")
        batch = next(iter(trainer._device_batches(ds, True)))
        batch.pop("paths", None)
        batch = trainer._prep_train(batch, torch.Generator(device="cuda").manual_seed(1))
        _, rec = _timed_step(torch, A, P, trainer, trainer.init_state(), batch, iters=5,
                             breakdown=False)
        stage_ms[sc["name"]] = {"step_ms": rec["step_ms"], "frames_per_s": rec["frames_per_s"],
                                "max_memory_allocated_bytes": rec["max_memory_allocated_bytes"],
                                "trainable": sum(ft.trainable_mask().values())}
        if not ft.advance_stage():
            break
    rec = {"phase": "progressive_training", "card": smi, "backbone": "efficientnet_b0",
           "built_by": "train/cli.py --model pretrained --progressive --epochs_per_stage 1",
           "batch_clips": B, "frames_per_clip": T, "cli_wall_s": cli_s, "stages": stages,
           "cli_launches": launches, "stage_steps": stage_ms,
           "parameters": len(init) - sum(k.endswith(("running_mean", "running_var"))
                                         for k in init),
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    _emit(rec)
    print("progressive stages " + ", ".join(f"{k} {v['step_ms']:.2f} ms"
                                            for k, v in stage_ms.items())
          + f" a step on {smi}", flush=True)
    return rec


def lr_finder_run(torch, smi: str, root: str, data: str):
    """``train/lr_finder.py main`` at its defaults (B0, batch 8 x 8
    frames, 100 steps from 1e-4 to 10): more than 10 finite history points,
    finite suggestions, the CSV and the SVG written; the sweep's ms a step
    (the ``find`` call alone, by the host clock after a sync)."""
    import contextlib
    import io

    from deepfake_video_detection_tpu_torch.train import lr_finder

    out_csv = os.path.join(root, "lr_finder.csv")
    real_find, sweep = lr_finder.LRFinder.find, {}

    def timed_find(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_find(self, *args, **kwargs)
        torch.cuda.synchronize()
        sweep["s"], sweep["steps"] = time.perf_counter() - t, len(self.history)
        return res

    buf = io.StringIO()
    with mock.patch.object(lr_finder.LRFinder, "find", timed_find), \
            contextlib.redirect_stdout(buf):
        rc = lr_finder.main(["--data_dir", data, "--out_csv", out_csv])
    _require(rc == 0, "the LR finder exited non-zero")
    printed = buf.getvalue()
    suggested = [float(ln.rsplit(":", 1)[1]) for ln in printed.splitlines()
                 if ln.startswith("suggested lr")]
    with open(out_csv) as f:
        rows = [ln.split(",") for ln in f.read().splitlines()[1:]]
    losses = [float(r[1]) for r in rows]
    svg = out_csv[:-4] + ".svg"
    rec = {"phase": "lr_finder", "card": smi, "backbone": "efficientnet_b0",
           "built_by": "train/lr_finder.py main, default flags", "batch_clips": 8,
           "frames_per_clip": 8, "steps": sweep.get("steps"), "history_points": len(rows),
           "sweep_s": sweep.get("s"),
           "ms_per_step": sweep["s"] * 1e3 / max(sweep["steps"], 1) if sweep else None,
           "suggested": suggested, "first": rows[0] if rows else None,
           "last": rows[-1] if rows else None, "svg_bytes": os.path.getsize(svg)
           if os.path.exists(svg) else None,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    _emit(rec)
    _require(len(rows) > 10 and all(math.isfinite(v) for v in losses),
             f"LR finder history: {len(rows)} points, finite {all(map(math.isfinite, losses))}")
    _require(len(suggested) == 2 and all(math.isfinite(v) for v in suggested),
             f"LR finder suggestions {suggested}")
    _require(rec["svg_bytes"], "the LR finder wrote no SVG")
    print(f"LR finder {rec['ms_per_step']:.2f} ms a step over {rec['steps']} steps, "
          f"suggested {suggested} on {smi}", flush=True)
    return rec


def improved_paths(torch, A, P, smi: str, tf32_defaults: dict):
    """The improved trainer, progressive fine-tuning, the LR finder and the
    validation demo on one synthetic set of 10 clips x 16 frames at 224 px
    from seed 0, at torch's default TF32 flags (the training CLIs' own;
    restored afterwards). Returns (launches by path, f32 launches by path)."""
    import shutil
    import tempfile

    from deepfake_video_detection_tpu_torch.evals import validate_improvements

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32_defaults["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = tf32_defaults["matmul_allow_tf32"]
    root = tempfile.mkdtemp(prefix="dfdt_improved_")
    try:
        data = os.path.join(root, "faces")
        os.makedirs(data)
        _write_faces(data, CONVTRAIN["clips"], CONVTRAIN["frames"], CONVTRAIN["size"])
        seconds, paths, f32_paths = {}, {}, {}
        for name, flags in (("clip", ["--backbone", "clip"]),
                            ("dinov2_bf16", ["--backbone", "dinov2", "--bf16"])):
            t = time.perf_counter()
            paths[f"improved_{name}"], f32_paths[f"improved_{name}"], _ = _improved_run(
                torch, A, P, smi, root, data, flags, name)
            seconds[name] = time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()
        for name, fn, args in (("progressive", progressive_training, (torch, A, P, smi)),
                               ("lr_finder", lr_finder_run, (torch, smi))):
            t = time.perf_counter()
            fn(*args, root, data)
            seconds[name] = time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()
        t = time.perf_counter()
        _require(validate_improvements.main(["--device", "cuda"]) == 0,
                 "validate_improvements exited non-zero")
        seconds["validate_improvements"] = time.perf_counter() - t
        _emit({"phase": "validate_improvements", "card": smi, "rc": 0,
               "seconds": seconds["validate_improvements"]})
        _emit({"phase": "improved_seconds", **seconds})
        return paths, f32_paths
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        shutil.rmtree(root, ignore_errors=True)


def _launches_per_call(torch, fn, sessions: int = 3) -> int:
    """Kernel launches of one call of ``fn`` under ``torch.profiler``: the
    most over ``sessions`` sessions of one call each (a session can drop
    records, never add them)."""
    return max(sum(n for n, _ in _profile(torch, fn, 1).values()) for _ in range(sessions))


def _input_sensitive(torch, model, seed: int) -> None:
    """Conv weights drawn He fan-in and BN running means from N(0, 0.2),
    variances from U(0.5, 1.5), as the CPU suite's ``random_variables``
    draws them. At its init (kaiming fan-out: a depthwise kernel's std is
    sqrt(2 / (C k²))) with ``_randomize_bn``'s means a random B0 passes
    almost nothing of its input to its logits: its input gradient is
    ~1e-22 on an H100 (PERF.md), under the saliency map's 1e-12 floor, so
    its map is blank in both packages. These draws give gradients of ~1e-3
    and an unsaturated ``prob_fake``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if t.ndim == 4:
                t.normal_(0.0, math.sqrt(2.0 / t[0].numel()), generator=gen)
            elif name.endswith("running_mean"):
                t.normal_(0.0, 0.2, generator=gen)
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)


def _explain_case(torch, A, P, smi: str, name: str, model, model_type: str, faces):
    """(a) One model's ``predict_faces(explain=True)``: the result's
    ``saliency`` key, the launches of the request and of its explanation
    alone, the explanation's ms (median of ``EXPLAIN["iters"]``) and peak
    memory, and its grids through the kernels against the plain versions
    on the card. Returns (the request's launches, record)."""
    from deepfake_video_detection_tpu_torch.serve import saliency as saliency_mod
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor

    T = len(faces)
    with mock.patch.dict(os.environ, {"SERVE_WARMUP": "0"}):
        pred = Predictor(model, None, model_type, device="cuda")
    try:
        plain = pred.predict_faces(faces, video_id=f"{name}_plain")
        pred.explain_faces(faces)          # cuDNN picks its backward algorithms
        torch.cuda.synchronize()
        _reset_counts(A, P)
        res = pred.predict_faces(faces, video_id=f"{name}_explain", explain=True)
        torch.cuda.synchronize()
        request = _counts(A, P)
        _reset_counts(A, P)
        pred.explain_faces(faces)
        torch.cuda.synchronize()
        alone = _counts(A, P)

        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = []
        for _ in range(EXPLAIN["iters"]):
            t = time.perf_counter()
            pred.explain_faces(faces)      # returns host values: synchronised
            ms.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated()

        x = torch.from_numpy(np.ascontiguousarray(faces[None])).cuda()
        fn = saliency_mod.make_saliency_fn(model, fake_idx=1)
        with_kernels = fn(x)
        with mock.patch.object(saliency_mod, "fused_normalize", P.fused_normalize_plain), \
                _plain_attention(A):
            with_plain = fn(x)
        gap = float((with_kernels - with_plain).abs().max())
    finally:
        pred.close()

    dtype = "bf16" if model.compute_dtype == torch.bfloat16 else "f32"
    _check_result(res, T, f"{name} explain request")
    _require(pred.explain_error is None, f"{name} explain failed: {pred.explain_error!r}")
    sal = res.get("saliency")
    _require(isinstance(sal, dict) and sal.get("grid") == [14, 14]
             and len(sal["frames"]) == T and all(len(f) == 196 for f in sal["frames"]),
             f"{name}: result without a saliency grid: {sorted(res)}")
    flat = np.asarray(sal["frames"], np.float64)
    _require(flat.min() >= 0.0 and np.allclose(flat.max(axis=1), 1.0, atol=1e-3),
             f"{name}: saliency frames are not max-normalised")
    diff = abs(res["prob_fake"] - plain["prob_fake"])
    _require(res["prediction"] == plain["prediction"] and diff <= PROB_TOL,
             f"{name}: the explain request's verdict moved by {diff}")
    _require(math.isfinite(gap) and gap <= SAL_TOL[dtype],
             f"{name}: saliency kernels vs plain differ by {gap} > {SAL_TOL[dtype]}")
    # the verdict's forward (bf16) and the explanation's (f32 out of K1)
    # each normalise once; every ViT block runs K2 in each forward and K4 in
    # the explanation's backward
    depth = len(model.backbone.blocks) if name.startswith("vit") else 0
    want_alone = _want(K1=1, K2=depth, K4=depth)
    want_request = _want(K1=2, K2=2 * depth, K4=depth)
    _require(alone == want_alone and request == want_request,
             f"{name}: explain launches {alone}, request {request}; want {want_alone}, "
             f"{want_request}")
    rec = {"phase": "explain_serving", "card": smi, "model": name, "model_type": model_type,
           "activations": dtype, "frames": T, "explain_ms": float(np.median(ms)),
           "explain_ms_all": ms, "peak_gib": peak / 2**30,
           "peak_over_resident_gib": (peak - base) / 2**30,
           "launches_request": request, "launches_explain_alone": alone,
           "grid_kernels_vs_plain_max_abs": gap, "grid_tol": SAL_TOL[dtype],
           "prob_fake": res["prob_fake"], "prob_fake_without_explain": plain["prob_fake"],
           "explain_error": None, "saliency_grid": sal["grid"]}
    _emit(rec)
    return request, rec


def _int8_serving(torch, A, P, smi: str, name: str, model, root: str, faces):
    """(b) ``model`` saved as a native ``.npz`` and a reference ``.pt``,
    served through ``serve/loader.py::load_model`` in f32 and with
    ``QUANTIZE=int8``: ``quantized_weights``, bytes at rest, memory after
    load, ``prob_fake`` against f32, the forward's ms at 1 and 16 clips,
    clips/s with 8 clients and launches per forward; the int8 model against
    its own weights dequantized to f32 parameters. Returns (the int8
    serving's launches, record, the ``.npz`` path)."""
    from deepfake_video_detection_tpu_torch.checkpoint.bridge import save_checkpoint
    from deepfake_video_detection_tpu_torch.checkpoint.store import save_torch_checkpoint
    from deepfake_video_detection_tpu_torch.nn.quant import dequantize, quantized_bytes
    from deepfake_video_detection_tpu_torch.serve.loader import load_model
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor

    meta = {"model_config": {"model_type": "pretrained", "backbone": name}}
    paths = {"npz": os.path.join(root, name, "checkpoint_best.npz"),
             "pt": os.path.join(root, name, "model.pt")}
    save_checkpoint(paths["npz"], model.state_dict(), meta=meta)
    save_torch_checkpoint(paths["pt"], model.state_dict(), layout="model_config", meta=meta)
    n = EXPLAIN["clients"]
    xs = {b: torch.from_numpy(np.stack([faces[i % len(faces)] for i in range(b)])).cuda()
          for b in (1, 16)}
    out, launches = {}, None
    for label, kind, mode in (("f32", "npz", "none"), ("int8", "npz", "int8"),
                              ("int8_pt", "pt", "int8")):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        with mock.patch.dict(os.environ, {"QUANTIZE": mode}):
            m, variables, stats = load_model(paths[kind], device="cuda")
        load_s = time.perf_counter() - t
        resident = torch.cuda.memory_allocated() - before
        want_q = INT8_WEIGHTS[name] if mode == "int8" else 0
        _require(stats["match_ratio"] == 1.0 and stats["quantized_weights"] == want_q,
                 f"{name} {label}: load stats {stats}")
        with mock.patch.dict(os.environ, {"SERVE_WARMUP": "0"}):
            pred = Predictor(m, variables, "pretrained", device="cuda")
        rec = {"load_s": load_s, "quantized_weights": stats["quantized_weights"],
               "resident_mib": resident / 2**20}
        try:
            pred._forward(xs[16])          # cuDNN picks its algorithms
            torch.cuda.synchronize()
            _reset_counts(A, P)
            res = [pred.predict_faces(f, video_id=f"{label}{i}") for i, f in enumerate(faces)]
            torch.cuda.synchronize()
            if label == "int8":
                launches = _counts(A, P)
            for i, r in enumerate(res):
                _check_result(r, len(faces[i]), f"{name} {label} request {i}")
            rec["prob_fake"] = [r["prob_fake"] for r in res]
            if label != "int8_pt":
                rec["forward_ms"] = {b: _time_ms(torch, lambda: pred._forward(xs[b]),
                                                 iters=5, warmup=2) for b in (1, 16)}
                rec["launches_per_forward"] = _launches_per_call(
                    torch, lambda: pred._forward(xs[1]))
                rounds = []
                for _ in range(ROUNDS):
                    got, barrier = [None] * n, threading.Barrier(n)

                    def client(i):
                        barrier.wait()
                        got[i] = pred.predict_faces(faces[i % len(faces)], video_id=f"c{i}")

                    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
                    t = time.perf_counter()
                    for th in threads:
                        th.start()
                    for th in threads:
                        th.join(timeout=300)
                    _require(not any(th.is_alive() for th in threads),
                             f"a concurrent {name} {label} request hung")
                    rounds.append(time.perf_counter() - t)
                rec["concurrent_clips_per_s"] = n / float(np.median(rounds))
            if label == "int8":
                now, f32 = quantized_bytes(m)
                rec.update(bytes_at_rest=now, bytes_if_f32=f32, bytes_ratio=now / f32)
            if label == "int8_pt":
                # the int8 read path against the same values held as f32
                # parameters: only a wrong dequantization moves this
                probs_int8 = pred._forward(xs[16])[0].float()
                _require(dequantize(m) == INT8_WEIGHTS[name], f"{name}: dequantize count")
                probs_deq = pred._forward(xs[16])[0].float()
                rec["int8_vs_dequantized_prob_max_abs"] = float(
                    (probs_int8 - probs_deq).abs().max())
                _require(rec["int8_vs_dequantized_prob_max_abs"] <= PROB_TOL,
                         f"{name}: int8 vs its dequantized weights {rec}")
        finally:
            pred.close()
        out[label] = rec
        del m, variables, pred
    f32, q = out["f32"], out["int8"]
    pt_diff = max(abs(a - b) for a, b in zip(out["int8_pt"]["prob_fake"], q["prob_fake"]))
    _require(pt_diff <= PROB_TOL, f"{name}: int8 from .pt and .npz differ by {pt_diff}")
    rec = {"phase": "int8_serving", "card": smi, "model": name, "activations": "bf16",
           "cases": out, "prob_fake_int8_pt_vs_npz_max_abs": pt_diff,
           "prob_fake_int8_vs_f32_max_abs": max(abs(a - b) for a, b in
                                                zip(q["prob_fake"], f32["prob_fake"])),
           "resident_ratio": q["resident_mib"] / f32["resident_mib"],
           "dequant_launches_per_forward": q["launches_per_forward"]
           - f32["launches_per_forward"]}
    _emit(rec)
    return launches, rec, paths["npz"]


def _int8_evaluation(torch, A, P, smi: str, root: str, ckpt: str):
    """(c) The evaluator CLI with ``--quantize int8`` over a few synthetic
    clips: ``quantized_weights``, K1 launches, CSV rows. Returns (launches,
    record)."""
    import contextlib
    import csv
    import io

    from deepfake_video_detection_tpu_torch.evals import evaluate as E

    data = os.path.join(root, "eval_clips")
    os.makedirs(data)
    n_clips, T, B = EXPLAIN["eval_clips"], EXPLAIN["frames"], 2
    _write_faces(data, n_clips, T, EXPLAIN["size"])
    out_csv = os.path.join(root, "evaluation_int8.csv")
    _reset_counts(A, P)
    log = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = E.main(["--data_dir", data, "--checkpoint", ckpt, "--num_frames", str(T),
                     "--batch_size", str(B), "--quantize", "int8", "--out_csv", out_csv])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = _counts(A, P)
    first = log.getvalue().splitlines()[0]
    _require(rc == 0 and first.endswith(f"quantized_weights={INT8_WEIGHTS['efficientnet_b0']}"),
             f"the int8 evaluator: rc {rc}, {first!r}")
    _require(launches == _want(K1=-(-n_clips // B)), f"int8 evaluation launches {launches}")
    with open(out_csv) as f:
        rows = list(csv.DictReader(f))
    _require(len(rows) == n_clips and all(0.0 <= float(r["prob_fake"]) <= 1.0 for r in rows),
             f"int8 evaluation CSV rows {rows}")
    rec = {"phase": "int8_evaluation", "card": smi, "model": "efficientnet_b0",
           "activations": "f32", "clips": n_clips, "frames_per_clip": T, "wall_s": wall_s,
           "first_line": first, "launches": launches,
           "prob_fake": [float(r["prob_fake"]) for r in rows]}
    _emit(rec)
    return launches, rec


def explain_int8_serving(torch, A, P, smi: str):
    """The explain and int8 phase: (a) ``predict_faces(explain=True)`` on 8
    crops of 224 px for ViT-B/16, B0 and the B0 + resnet18 ``voting``
    ensemble (random weights from seed 0, the conv nets' drawn by
    ``_input_sensitive``, bf16 activations); (b) ViT-B/16 and B0 served
    with ``QUANTIZE=int8`` through the loader from ``.npz`` and ``.pt``,
    beside f32; (c) the evaluator with ``--quantize int8``. Returns
    launches by path; the serving environment it sets is restored."""
    T, size = EXPLAIN["frames"], EXPLAIN["size"]
    with mock.patch.dict(os.environ, {"MAX_FRAMES": str(T), "SERVE_WINDOWS": "1",
                                      "FACE_SIZE": str(size)}):
        return _explain_int8_paths(torch, A, P, smi, T, size)


def _explain_int8_paths(torch, A, P, smi: str, T: int, size: int):
    import shutil
    import tempfile

    from deepfake_video_detection_tpu_torch.models.backbone_detector import (
        BackboneDetector, EnsembleDetector)
    from deepfake_video_detection_tpu_torch.serve.predict import serving_dtype

    dtype = serving_dtype("cuda")
    rng = np.random.default_rng(2)
    faces = [rng.integers(0, 256, (T, size, size, 3), dtype=np.uint8) for _ in range(2)]
    models = {}
    for name in ("vit_base_patch16_224", "efficientnet_b0"):
        models[name] = BackboneDetector(name, compute_dtype=dtype, device="cuda",
                                        generator=torch.Generator().manual_seed(0))
    models["ensemble_voting"] = EnsembleDetector(
        CONV["ensemble"], ensemble_method="voting", compute_dtype=dtype, device="cuda",
        generator=torch.Generator().manual_seed(0))
    for name in ("efficientnet_b0", "ensemble_voting"):
        _input_sensitive(torch, models[name], CONV["bn_seed"])
    paths, seconds = {}, {}
    for name, m in models.items():
        t = time.perf_counter()
        model_type = "ensemble_pretrained" if name == "ensemble_voting" else "pretrained"
        paths[f"explain_{name}"], _ = _explain_case(torch, A, P, smi, name, m, model_type,
                                                    faces[0])
        seconds[f"explain_{name}"] = time.perf_counter() - t
    del models["ensemble_voting"], m
    root = tempfile.mkdtemp(prefix="dfdt_int8_")
    try:
        npz = {}
        for name, m in models.items():
            t = time.perf_counter()
            paths[f"int8_serving_{name}"], _, npz[name] = _int8_serving(
                torch, A, P, smi, name, m, root, faces)
            seconds[f"int8_serving_{name}"] = time.perf_counter() - t
        t = time.perf_counter()
        paths["int8_evaluation"], _ = _int8_evaluation(torch, A, P, smi, root,
                                                       npz["efficientnet_b0"])
        seconds["int8_evaluation"] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _emit({"phase": "explain_int8_serving_seconds", **seconds})
    return paths


def synth_face(size: int) -> np.ndarray:
    """A face-like gray patch that passes every stage of the frontal-face
    cascade: a bright oval, dark eyes under a brow shadow, a lighter nose
    bridge, a dark mouth (``tests/test_haar.py`` draws the same)."""
    img = np.full((size, size), 120.0)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1.0)
    face = ((yy - 0.52) / 0.48) ** 2 + ((xx - 0.5) / 0.40) ** 2 <= 1.0
    img[face] = 200.0
    for cy, cx, ry, rx, val in ((0.38, 0.32, 0.055, 0.10, 60), (0.38, 0.68, 0.055, 0.10, 60),
                                (0.30, 0.32, 0.035, 0.11, 150), (0.30, 0.68, 0.035, 0.11, 150),
                                (0.55, 0.5, 0.10, 0.05, 180), (0.72, 0.5, 0.045, 0.16, 80)):
        img[(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0) & face] = val
    return img


def write_clip(path: str, index: int, face: bool = True, frames: int = 0,
               step: int = 4, background: int = 120) -> None:
    """One ``VIDEO`` clip through ``cv2.VideoWriter`` (mp4v): gray frames with
    the synthetic face drifting right and down, ``step`` px a frame, further
    along in a later clip ``index``; no face with ``face=False``;
    ``frames`` frames (``VIDEO``'s by default), on a ``background`` level."""
    import cv2

    W, H, s = VIDEO["width"], VIDEO["height"], VIDEO["face"]
    patch = synth_face(s).astype(np.uint8)[..., None]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), VIDEO["fps"], (W, H))
    _require(writer.isOpened(), f"cv2 cannot write {path}")
    try:
        for t in range(frames or VIDEO["frames"]):
            frame = np.full((H, W, 3), background, np.uint8)
            if face:
                oy, ox = 80 + 3 * (t % 8) + 20 * index, 100 + step * t + 150 * index
                frame[oy:oy + s, ox:ox + s] = patch
            writer.write(frame)
    finally:
        writer.release()


def _stage_timer(stages: dict, name: str, fn):
    """``fn`` wrapped to append its wall ms to ``stages[name]``: the phase
    times a request's stages around the package's calls."""
    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            stages.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
    return timed


def _level_gap(a: np.ndarray, b: np.ndarray):
    _require(a.shape == b.shape and a.dtype == b.dtype == np.uint8,
             f"crops {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def video_serving(torch, A, P, smi: str):
    """Serve video files end to end through ``Predictor.predict_video``:
    cv2 decoding, Haar detection on the host (native engine, tracking on),
    the margin-expanded boxes cropped and resized on the card, K1 and the
    detector. Returns launches by path; the environment is restored."""
    import shutil
    import tempfile

    env = {"MAX_FRAMES": str(VIDEO["max_frames"]), "FACE_SIZE": str(VIDEO["size"]),
           "SERVE_WINDOWS": "1", **VIDEO_ENV}
    root = tempfile.mkdtemp(prefix="dfdt_video_")
    try:
        with mock.patch.dict(os.environ, env):
            for k in ("FACE_DETECTOR", "HAAR_CASCADE", "HAAR_MAX_SIDE", "HAAR_TRACK",
                      "MTCNN_WEIGHTS", "KEEP_ALL_FACES", "VIDEO_SAMPLE_RATE"):
                os.environ.pop(k, None)
            t = time.perf_counter()
            clips = [os.path.join(root, f"face{i}.mp4") for i in range(VIDEO["clips"])]
            for i, path in enumerate(clips):
                write_clip(path, i)
            noface = os.path.join(root, "noface.mp4")
            write_clip(noface, 0, face=False)
            write_s = time.perf_counter() - t
            b0 = _video_b0(torch, A, P, smi, clips, noface, write_s)
            vit = _video_vit(torch, A, P, smi, clips)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"video_serving": {k: b0.get(k, 0) + vit.get(k, 0) for k in ("K1", "K2", "K4")}}


def _video_request_check(res: dict, what: str) -> None:
    _check_result(res, VIDEO["max_frames"], what)
    _require(res["num_faces"] == VIDEO["max_frames"],
             f"{what}: num_faces {res['num_faces']} != {VIDEO['max_frames']}")


def _video_b0(torch, A, P, smi: str, clips: list, noface: str, write_s: float) -> dict:
    """B0 (full size, random weights from seed 0, BN stats from U(0.5, 1.5))
    behind a Predictor with micro-batching and warmup: sequential requests
    timed by stage, 8 concurrent clients, launch counts, ``prob_fake``
    against the plain versions, crops on the card against the CPU."""
    import cv2

    from deepfake_video_detection_tpu_torch.data import faces as faces_mod
    from deepfake_video_detection_tpu_torch.data import haar_native
    from deepfake_video_detection_tpu_torch.data.haar import get_default_cascade
    from deepfake_video_detection_tpu_torch.data.video import sample_video_frames
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.serve import predict as predict_mod
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor, serving_dtype

    T, size, n = VIDEO["max_frames"], VIDEO["size"], VIDEO["clients"]
    t0 = time.perf_counter()
    model = BackboneDetector("efficientnet_b0", compute_dtype=serving_dtype("cuda"),
                             device="cuda", generator=torch.Generator().manual_seed(0))
    _randomize_bn(torch, model, CONV["bn_seed"])
    pred = Predictor(model, None, "pretrained", device="cuda")
    _require(pred.warmup_done.wait(timeout=600), "video B0 warmup did not finish in 600 s")
    _require(pred.warmup_error is None, f"video B0 warmup failed: {pred.warmup_error!r}")
    setup_s = time.perf_counter() - t0
    ex = pred.extractor
    cascade = get_default_cascade()
    setting = {"detector": ex.detector, "cascade": cascade.path if cascade else None,
               "haar_engine": haar_native.engine(), "cv2": cv2.__version__,
               "VIDEO_BACKEND": os.environ.get("VIDEO_BACKEND"),
               "SERVE_YUV_TRANSFER": os.environ.get("SERVE_YUV_TRANSFER"),
               "FACE_DETECTOR": os.environ.get("FACE_DETECTOR", "auto"),
               "extract_concurrency": pred._extract_sem._value if pred._extract_sem else 0,
               "extractor_device": str(ex.device)}
    print(f"video serving: {setting}", flush=True)
    _require(ex.detector == "haar", f"FACE_DETECTOR=auto resolved to {ex.detector!r}")
    _require(setting["haar_engine"] == "native", "the native Haar engine did not load")

    try:
        # sequential requests, each stage timed around the package's calls
        stages, seq, seq_ms = {}, [], []
        with mock.patch.object(faces_mod, "sample_video_frames",
                               _stage_timer(stages, "decode", faces_mod.sample_video_frames)), \
                mock.patch.object(ex, "_detect_haar",
                                  _stage_timer(stages, "haar", ex._detect_haar)), \
                mock.patch.object(faces_mod, "crop_and_resize_batch",
                                  _stage_timer(stages, "h2d_crop_resize",
                                               faces_mod.crop_and_resize_batch)), \
                mock.patch.object(pred, "_predict_pretrained",
                                  _stage_timer(stages, "forward_and_policy",
                                               pred._predict_pretrained)):
            pred.predict_video(clips[0])          # the first request's one-time host costs
            stages.clear()
            torch.cuda.synchronize()
            _reset_counts(A, P)
            batches0 = pred._batcher.batches_run
            for path in clips + [noface]:
                t = time.perf_counter()
                seq.append(pred.predict_video(path))
                seq_ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            seq_counts = _counts(A, P)
            seq_batches = pred._batcher.batches_run - batches0
        for i, r in enumerate(seq):
            _video_request_check(r, f"video request {i}")
        _require(seq_counts == _want(K1=len(seq)) and seq_batches == len(seq),
                 f"sequential video requests: launches {seq_counts}, {seq_batches} batcher "
                 f"steps; want K1 {len(seq)}")
        stage_ms = {k: float(np.median(v)) for k, v in stages.items()}
        _require(len(stages.get("haar", [])) == len(seq)
                 and len(stages.get("forward_and_policy", [])) == len(seq),
                 f"a request skipped a stage: {stages}")

        # concurrent clients, the extraction semaphore at its default
        def client_round():
            out, barrier = [None] * n, threading.Barrier(n)

            def client(i):
                barrier.wait()
                out[i] = pred.predict_video(clips[i % len(clips)])

            threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            _require(not any(th.is_alive() for th in threads), "a video request hung")
            return out, time.perf_counter() - t

        _reset_counts(A, P)
        batches0 = pred._batcher.batches_run
        conc, conc_s = [], []
        for _ in range(ROUNDS):
            res, sec = client_round()
            conc += res
            conc_s.append(sec)
        torch.cuda.synchronize()
        conc_counts = _counts(A, P)
        conc_batches = pred._batcher.batches_run - batches0
        for i, r in enumerate(conc):
            _video_request_check(r, f"concurrent video request {i}")
        _require(conc_counts == _want(K1=conc_batches) and conc_counts["K1"] >= 1,
                 f"concurrent video requests: launches {conc_counts}, {conc_batches} steps")

        # the first clip's crops through the plain versions
        faces = ex.extract_from_video(clips[0], max_frames=T)
        x = torch.from_numpy(faces[None]).cuda()
        with mock.patch.object(predict_mod, "fused_normalize", P.fused_normalize_plain):
            p_plain = float(pred._forward(x)[0].float().cpu()[0, 1])
        diff = abs(p_plain - seq[0]["prob_fake"])
        _require(diff <= PROB_TOL, f"video prob_fake kernels vs plain differ by {diff}")
        breakdown = _kernel_breakdown(torch, lambda: pred._forward(x))

        # crops on the card against the CPU: the request's boxes, and edge
        # boxes (fractional, partly off the frame, one pixel)
        frames = sample_video_frames(clips[0], max_frames=T)
        cpu_ex = faces_mod.FaceExtractor(detector="haar", face_size=size, device="cpu")
        gap, share = _level_gap(ex.extract_from_frames(frames),
                                cpu_ex.extract_from_frames(frames))
        W, H = VIDEO["width"], VIDEO["height"]
        edge = np.array([[10.3, 5.7, 500.2, 455.9], [-120.5, -80.25, 380.75, 395.5],
                         [640.0, 360.0, 641.0, 361.0], [0, 0, W, H],
                         [1000.6, 500.1, 1400.2, 900.3], [300.25, 100.75, 777.5, 577.5],
                         [-10.0, -10.0, 20.0, 20.0], [W - 5.5, H - 5.5, W + 100.0, H + 100.0]],
                        np.float32)
        e_gap, e_share = _level_gap(faces_mod.crop_and_resize_batch(frames, edge, size, "cuda"),
                                    faces_mod.crop_and_resize_batch(frames, edge, size, "cpu"))
        _require(max(gap, e_gap) <= CROP_TOL,
                 f"crops on the card vs the CPU differ by {gap} / {e_gap} levels")
        crop_ms = []
        for _ in range(VIDEO["crop_iters"]):
            t = time.perf_counter()
            faces_mod.crop_and_resize_batch(frames, edge, size, "cuda")
            crop_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        pred.close()

    rec = {"phase": "video_serving", "card": smi, "model": "efficientnet_b0",
           "activations": "bf16", "setting": setting, "clips": len(clips) + 1,
           "clip": {k: VIDEO[k] for k in ("width", "height", "fps", "frames", "face")},
           "frames_per_request": T, "face_size": size, "write_clips_s": write_s,
           "setup_s": setup_s, "sequential_ms": seq_ms,
           "sequential_ms_median": float(np.median(seq_ms)),
           "stage_ms_median": stage_ms,
           "stage_ms_other": float(np.median(seq_ms)) - sum(stage_ms.values()),
           "stage_ms_all": stages,
           "concurrent_clients": n, "concurrent_wall_s": conc_s,
           "concurrent_clips_per_s": n / float(np.median(conc_s)),
           "launches_sequential": seq_counts, "launches_concurrent": conc_counts,
           "batcher_steps_concurrent": conc_batches,
           "k1_per_request_sequential": seq_counts["K1"] / len(seq),
           "prob_fake_kernels": seq[0]["prob_fake"], "prob_fake_plain": p_plain,
           "prob_fake_abs_diff": diff, "prob_tol": PROB_TOL,
           "crop_card_vs_cpu": {"max_levels": gap, "share_differing": share,
                                "edge_boxes_max_levels": e_gap,
                                "edge_boxes_share_differing": e_share, "tol": CROP_TOL},
           "crop_ms_8_boxes_1280x720": float(np.median(crop_ms)),
           "noface_clip": {k: seq[-1][k] for k in ("prediction", "num_faces", "prob_fake")},
           "verdicts": [r["prediction"] for r in seq + conc]}
    _emit(rec)
    _emit({"phase": "video_serving_device_time", "forward": "rgb_1", "card": smi, **breakdown})
    print(f"video serving (B0): {rec['sequential_ms_median']:.1f} ms a request "
          f"({', '.join(f'{k} {v:.1f}' for k, v in stage_ms.items())}), "
          f"{rec['concurrent_clips_per_s']:.1f} clips/s with {n} clients on {smi}", flush=True)
    return {k: seq_counts[k] + conc_counts[k] for k in ("K1", "K2", "K4")}


def _video_vit(torch, A, P, smi: str, clips: list) -> dict:
    """ViT-B/16 (random weights from seed 0, bf16): one sequential request
    (K1 1, K2 12) and one ``explain=True`` request (K4 12, and the
    ``saliency`` key) through ``predict_video``."""
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor, serving_dtype

    model = BackboneDetector("vit_base_patch16_224", compute_dtype=serving_dtype("cuda"),
                             device="cuda", generator=torch.Generator().manual_seed(0))
    depth = len(model.backbone.blocks)
    with mock.patch.dict(os.environ, {"SERVE_WARMUP": "0"}):
        pred = Predictor(model, None, "pretrained", device="cuda")
    try:
        pred.predict_video(clips[0], explain=True)   # builds cuDNN's plans, unmeasured
        torch.cuda.synchronize()
        _reset_counts(A, P)
        t = time.perf_counter()
        res = pred.predict_video(clips[1])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        plain = _counts(A, P)
        _reset_counts(A, P)
        t = time.perf_counter()
        res_e = pred.predict_video(clips[2], explain=True)
        torch.cuda.synchronize()
        explain_ms = (time.perf_counter() - t) * 1e3
        explained = _counts(A, P)
    finally:
        pred.close()
    _video_request_check(res, "ViT video request")
    _video_request_check(res_e, "ViT explain video request")
    _require(pred.explain_error is None, f"ViT explain failed: {pred.explain_error!r}")
    sal = res_e.get("saliency")
    _require(isinstance(sal, dict) and sal.get("grid") == [14, 14]
             and len(sal["frames"]) == VIDEO["max_frames"],
             f"ViT explain video request without a saliency grid: {sorted(res_e)}")
    _require(plain == _want(K1=1, K2=depth),
             f"ViT video request launches {plain}; want K1 1, K2 {depth}")
    _require(explained == _want(K1=2, K2=2 * depth, K4=depth),
             f"ViT explain video request launches {explained}; want K1 2, K2 {2 * depth}, "
             f"K4 {depth}")
    _emit({"phase": "video_serving_vit", "card": smi, "model": "vit_base_patch16_224",
           "activations": "bf16", "request_ms": ms, "explain_request_ms": explain_ms,
           "launches_request": plain, "launches_explain_request": explained,
           "prob_fake": res["prob_fake"], "explain_prob_fake": res_e["prob_fake"],
           "saliency_grid": sal["grid"]})
    return {k: plain[k] + explained[k] for k in ("K1", "K2", "K4")}


class _HttpClient:
    """``urllib.request`` against the app on loopback: redirects are
    returned, not followed (the session cookie rides on a 302), and an HTTP
    error status is returned with its body."""

    def __init__(self, base: str):
        import urllib.request

        class NoRedirect(urllib.request.HTTPRedirectHandler):
            def redirect_request(self, *args, **kwargs):
                return None

        self.base = base
        self.opener = urllib.request.build_opener(NoRedirect)

    def __call__(self, method: str, path: str, body: bytes = None, ctype: str = None,
                 cookie: str = None):
        import urllib.error
        import urllib.request

        headers = {"Content-Type": ctype} if ctype else {}
        if cookie:
            headers["Cookie"] = f"session={cookie}"
        req = urllib.request.Request(self.base + path, data=body, method=method,
                                     headers=headers)
        try:
            with self.opener.open(req, timeout=300) as r:
                return r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read()

    def json(self, method: str, path: str, data=None, cookie: str = None):
        body = None if data is None else json.dumps(data).encode()
        status, _, out = self(method, path, body, "application/json" if body else None,
                              cookie)
        return status, json.loads(out)

    def upload(self, path: str, clip: str, field: str = "video", cookie: str = None):
        boundary = "dfdtsmokeboundary"
        with open(clip, "rb") as f:
            content = f.read()
        body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{field}\"; "
                f"filename=\"{os.path.basename(clip)}\"\r\nContent-Type: video/mp4\r\n\r\n"
                ).encode() + content + f"\r\n--{boundary}--\r\n".encode()
        return self("POST", path, body, f"multipart/form-data; boundary={boundary}", cookie)


def _cookie(headers) -> str:
    return headers["Set-Cookie"].split(";")[0].split("=", 1)[1]


def web_app(torch, A, P, smi: str):
    """The web app on loopback HTTP (``serve/app.py``): an autoloaded B0
    checkpoint, then a ViT-B/16 one swapped in over ``/api/load-model``,
    with ``VIDEO_BACKEND=cv2``, ``SERVE_YUV_TRANSFER=0`` and the
    ``video_serving`` clips. Returns launches by path; the environment is
    restored and the server, the jobs and the predictors are stopped."""
    import shutil
    import tempfile
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from deepfake_video_detection_tpu_torch.checkpoint.bridge import save_checkpoint
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.serve import chat as chat_mod
    from deepfake_video_detection_tpu_torch.serve import loader as loader_mod
    from deepfake_video_detection_tpu_torch.serve import predict as predict_mod
    from deepfake_video_detection_tpu_torch.serve.app import ThreadingWSGIServer, create_app
    from deepfake_video_detection_tpu_torch.serve.predict import (
        serving_dtype, simple_english_justification_200_words)

    class Quiet(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    T, n = VIDEO["max_frames"], VIDEO["clients"]
    env = {"MAX_FRAMES": str(T), "FACE_SIZE": str(VIDEO["size"]), "SERVE_WINDOWS": "1",
           **VIDEO_ENV}
    root = tempfile.mkdtemp(prefix="dfdt_web_")
    app = httpd = server = None
    launches = {"K1": 0, "K2": 0, "K4": 0}

    def counted(fn):
        """Run ``fn`` with the counts set to 0 just before it; add what it
        launched to the phase's launches and return (its result, counts)."""
        torch.cuda.synchronize()
        _reset_counts(A, P)
        out = fn()
        torch.cuda.synchronize()
        c = _counts(A, P)
        for k in launches:
            launches[k] += c[k]
        return out, c

    try:
        with mock.patch.dict(os.environ, env):
            for k in ("FACE_DETECTOR", "HAAR_CASCADE", "HAAR_MAX_SIDE", "HAAR_TRACK",
                      "MTCNN_WEIGHTS", "KEEP_ALL_FACES", "VIDEO_SAMPLE_RATE", "SERVE_WARMUP",
                      "NO_AUTOLOAD", "MODEL_URL", "CHECKPOINT_URL", "MODEL_PATH",
                      "CHECKPOINT_PATH", "MODEL_TYPE", "QUANTIZE", "ALLOW_ANY_MODEL_PATH",
                      "GEMINI_API_KEY", "GOOGLE_API_KEY", "FIREBASE_API_KEY",
                      "FIREBASE_DATABASE_URL", "MAX_UPLOAD_MB"):
                os.environ.pop(k, None)
            t0 = time.perf_counter()
            clips = [os.path.join(root, f"face{i}.mp4") for i in range(VIDEO["clips"])]
            for i, path in enumerate(clips):
                write_clip(path, i)
            noface = os.path.join(root, "noface.mp4")
            write_clip(noface, 0, face=False)
            ckroot = os.path.join(root, "checkpoints")

            # (1) autoload of a B0 checkpoint
            b0 = BackboneDetector("efficientnet_b0", compute_dtype=serving_dtype("cuda"),
                                  device="cuda", generator=torch.Generator().manual_seed(0))
            _randomize_bn(torch, b0, CONV["bn_seed"])
            b0_path = os.path.join(ckroot, "b0", "checkpoint_best.npz")
            save_checkpoint(b0_path, b0.state_dict(), meta={"model_config": {
                "model_type": "pretrained", "backbone": "efficientnet_b0"}})
            del b0
            app = create_app(autoload=True, device="cuda", upload_dir=os.path.join(root, "up"),
                             data_dir=os.path.join(root, "data"),
                             log_root=os.path.join(root, "logs"), checkpoints_root=ckroot)
            pred = app.predictor
            _require(pred is not None, "the app autoloaded no model")
            _require(pred.model_type == "pretrained" and pred.checkpoint_path == b0_path
                     and loader_mod.LAST_LOAD_STATS.get("backbones") == "efficientnet_b0",
                     f"autoload picked {pred.model_type} {pred.checkpoint_path} "
                     f"{loader_mod.LAST_LOAD_STATS}")
            _require(pred.device.type == "cuda", f"autoloaded predictor on {pred.device}")
            _require(pred.warmup_done.wait(timeout=600), "web B0 warmup did not finish")
            _require(pred.warmup_error is None, f"web B0 warmup failed: {pred.warmup_error!r}")
            setup_s = time.perf_counter() - t0

            # (2) a real server on loopback
            httpd = make_server("127.0.0.1", 0, app, server_class=ThreadingWSGIServer,
                                handler_class=Quiet)
            server = threading.Thread(target=httpd.serve_forever, name="web-app",
                                      daemon=True)
            server.start()
            http = _HttpClient(f"http://127.0.0.1:{httpd.server_address[1]}")
            for path in ("/health", "/", "/ui", "/about"):
                status, _, body = http("GET", path)
                _require(status == 200, f"GET {path}: {status} {body[:200]!r}")
            form = "application/x-www-form-urlencoded"
            status, headers, _ = http("POST", "/signup", b"email=smoke%40x.com&password=pw1",
                                      form)
            _require(status == 302 and "session=" in headers.get("Set-Cookie", ""),
                     f"signup: {status}")
            status, headers, _ = http("POST", "/login", b"email=smoke%40x.com&password=pw1",
                                      form)
            _require(status == 302, f"login: {status}")
            cookie = _cookie(headers)
            status, _, body = http("GET", "/dashboard", cookie=cookie)
            _require(status == 200 and b"smoke@x.com" in body, f"dashboard: {status}")
            status, info = http.json("GET", "/api/model-info")
            _require(status == 200 and info["device"] == "cuda" and info["loaded"] is True
                     and info["model_type"] == "pretrained", f"model-info: {info}")

            # (3) B0 uploads: sequential, then concurrent clients
            def post(clip, query=""):
                status, _, body = http.upload("/api/predict" + query, clip)
                _require(status == 200, f"predict {os.path.basename(clip)}: {status}")
                return json.loads(body)

            def timed_posts(clip, k, query=""):
                out, ms = [], []
                for _ in range(k):
                    t = time.perf_counter()
                    out.append(post(clip, query))
                    ms.append((time.perf_counter() - t) * 1e3)
                return out, ms

            (seq, seq_ms), seq_counts = counted(lambda: timed_posts(clips[0], 5))
            for i, r in enumerate(seq):
                _video_request_check(r, f"web B0 request {i}")
            _require(seq_counts == _want(K1=len(seq)),
                     f"sequential web requests launched {seq_counts}; want K1 {len(seq)}")

            def direct(p, clip, k):
                ms = []
                for _ in range(k):
                    t = time.perf_counter()
                    r = p.predict_video(clip)
                    ms.append((time.perf_counter() - t) * 1e3)
                    _video_request_check(r, "direct predict_video")
                return ms

            direct_ms = direct(pred, clips[0], 5)

            def client_round(client=http):
                out, barrier = [None] * n, threading.Barrier(n)

                def client_fn(i):
                    barrier.wait()
                    status, _, body = client.upload("/api/predict", clips[i % len(clips)])
                    _require(status == 200, f"concurrent predict: {status}")
                    out[i] = json.loads(body)

                threads = [threading.Thread(target=client_fn, args=(i,)) for i in range(n)]
                t = time.perf_counter()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=300)
                _require(not any(th.is_alive() for th in threads), "a web request hung")
                return out, time.perf_counter() - t

            def concurrent(client):
                batches0 = pred._batcher.batches_run
                rounds, c = counted(lambda: [client_round(client) for _ in range(ROUNDS)])
                steps = pred._batcher.batches_run - batches0
                for i, r in enumerate(r for res, _ in rounds for r in res):
                    _video_request_check(r, f"concurrent web request {i}")
                _require(c == _want(K1=steps) and c["K1"] >= 1,
                         f"concurrent web requests: launches {c}, {steps} steps")
                return [sec for _, sec in rounds], c, steps

            # the app's server holds all n connections in its listen backlog
            # (the JAX package's keeps the stdlib's 5: the overflow waited out
            # TCP's one-second retransmission, ROADMAP Queue 3)
            _require(ThreadingWSGIServer.request_queue_size >= n,
                     f"listen backlog {ThreadingWSGIServer.request_queue_size} < {n} clients")
            conc_s, conc_counts, conc_batches = concurrent(http)

            # the first clip through the plain versions
            faces = pred.extractor.extract_from_video(clips[0], max_frames=T)
            x = torch.from_numpy(faces[None]).cuda()
            with mock.patch.object(predict_mod, "fused_normalize", P.fused_normalize_plain):
                p_plain = float(pred._forward(x)[0].float().cpu()[0, 1])
            diff = abs(p_plain - seq[0]["prob_fake"])
            _require(diff <= PROB_TOL, f"web prob_fake kernels vs plain differ by {diff}")
            (nf,), nf_counts = counted(lambda: [post(noface)])
            nf_ref = pred.predict_video(noface)
            _video_request_check(nf, "web no-face request")
            _require(nf_counts == _want(K1=1), f"the no-face request launched {nf_counts}")
            _require(nf["prediction"] == nf_ref["prediction"]
                     and nf["num_faces"] == nf_ref["num_faces"]
                     and abs(nf["prob_fake"] - nf_ref["prob_fake"]) <= PROB_TOL,
                     f"no-face clip over HTTP {nf} vs direct {nf_ref}")

            # (4) a background job through the JobManager
            (sync,), sync_counts = counted(lambda: [post(clips[1])])
            _require(sync_counts == _want(K1=1), f"a web request launched {sync_counts}")

            def job():
                t = time.perf_counter()
                status, headers, _ = http.upload("/results", clips[1], field="videos",
                                                 cookie=cookie)
                _require(status == 302 and "/results?job=" in headers.get("Location", ""),
                         f"POST /results: {status}")
                job_id = headers["Location"].split("job=")[1]
                deadline = time.perf_counter() + 30
                while True:
                    status, st = http.json("GET", f"/api/ui-job/{job_id}")
                    if st["status"] not in ("queued", "running") \
                            or time.perf_counter() > deadline:
                        break
                    time.sleep(0.01)
                ms = (time.perf_counter() - t) * 1e3
                _require(st["status"] == "done", f"job {job_id}: {st}")
                return job_id, ms

            (job_id, job_ms), job_counts = counted(job)
            _require(job_counts == _want(K1=1), f"the job launched {job_counts}")
            (item,) = app.cache.get(app.jobs.status(job_id)["result"])
            _video_request_check(item["result"], "the job's result")
            status, _, page = http("GET", f"/results?job={job_id}", cookie=cookie)
            verdict = item["result"]["prediction"]
            _require(verdict == sync["prediction"],
                     f"the job's verdict {verdict} != the synchronous {sync['prediction']}")
            _require(status == 200 and verdict.encode() in page and b"face1.mp4" in page,
                     f"GET /results?job=: {status}")

            # (5) swap in ViT-B/16; a request, an explain request
            vit = BackboneDetector("vit_base_patch16_224", compute_dtype=serving_dtype("cuda"),
                                   device="cuda", generator=torch.Generator().manual_seed(0))
            depth = len(vit.backbone.blocks)
            vit_path = os.path.join(ckroot, "vit", "checkpoint_best.npz")
            save_checkpoint(vit_path, vit.state_dict(), meta={"model_config": {
                "model_type": "pretrained", "backbone": "vit_base_patch16_224"}})
            del vit
            t = time.perf_counter()
            status, loaded = http.json("POST", "/api/load-model", {"path": vit_path})
            load_s = time.perf_counter() - t
            _require(status == 200 and loaded.get("ok")
                     and loaded["stats"]["backbones"] == "vit_base_patch16_224",
                     f"load-model ViT-B/16: {status} {loaded}")
            _require(pred._batcher._closed, "the replaced B0 predictor was not closed")
            vpred = app.predictor
            _require(vpred is not pred and vpred.device.type == "cuda",
                     f"ViT predictor on {vpred.device}")
            _require(vpred.warmup_done.wait(timeout=600), "web ViT warmup did not finish")
            _require(vpred.warmup_error is None, f"web ViT warmup: {vpred.warmup_error!r}")
            pred = vpred
            post(clips[3], "?explain=1")   # the backward's plans, unmeasured (video_serving)
            vit_res, vit_ms, vit_counts = [], [], []
            for clip in clips[:3]:
                (res, ms), c = counted(lambda: timed_posts(clip, 1))
                _require(c == _want(K1=1, K2=depth),
                         f"ViT web request launched {c}; want K1 1, K2 {depth}")
                _video_request_check(res[0], "ViT web request")
                vit_res += res
                vit_ms += ms
                vit_counts.append(c)
            vit_direct_ms = direct(pred, clips[0], 3)
            ((res_e,), (explain_ms,)), explained = counted(
                lambda: timed_posts(clips[2], 1, "?explain=1"))
            _require(explained == _want(K1=2, K2=2 * depth, K4=depth),
                     f"ViT explain web request launched {explained}; want K1 2, "
                     f"K2 {2 * depth}, K4 {depth}")
            _video_request_check(res_e, "ViT explain web request")
            sal = res_e.get("saliency")
            _require(pred.explain_error is None and isinstance(sal, dict)
                     and sal.get("grid") == [14, 14] and len(sal["frames"]) == T,
                     f"ViT explain web request without a saliency grid: {sorted(res_e)}")
            outside = os.path.join(root, "outside.npz")
            np.savez(outside, x=np.zeros(3))
            status, out = http.json("POST", "/api/load-model", {"path": outside})
            _require(status == 403, f"load-model outside the root: {status} {out}")
            _require(app.predictor is pred, "a refused load replaced the predictor")

            # (6) chat and the report, offline (no key): the local fallbacks
            msg = "why was this video flagged?"
            status, out = http.json("POST", "/api/chat", {"message": msg}, cookie=cookie)
            _require(status == 200 and out["reply"] == chat_mod.generate_chat_reply(
                msg, app.last_results.get("smoke@x.com")), f"chat: {status} {out}")
            status, out = http.json("POST", "/api/chat-public", {"message": "how does it work?"})
            _require(status == 200 and out["reply"] == chat_mod.generate_chat_reply(
                "how does it work?", app.last_results.get("__public__"),
                loader_mod.LAST_LOAD_STATS or None), f"chat-public: {status} {out}")
            status, out = http.json("POST", "/api/gemini-report-public", {})
            last = app.last_results["__public__"]
            _require(status == 200 and last["prob_fake"] == res_e["prob_fake"]
                     and out["report"] == simple_english_justification_200_words(last, "")
                     and len(out["report"].split()) == 200, f"report: {status} {out}")
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=30)
        if app is not None:
            app.jobs.shutdown()
            if app.predictor is not None:
                app.predictor.close()
        shutil.rmtree(root, ignore_errors=True)

    med = float(np.median(seq_ms))
    rec = {"phase": "web_app", "card": smi, "server": "ThreadingWSGIServer on 127.0.0.1",
           "setting": dict(VIDEO_ENV, detector="haar"), "setup_s": setup_s,
           "frames_per_request": T, "face_size": VIDEO["size"],
           "b0": {"request_ms": seq_ms, "request_ms_median": med,
                  "predict_video_ms": direct_ms,
                  "predict_video_ms_median": float(np.median(direct_ms)),
                  "http_overhead_ms": med - float(np.median(direct_ms)),
                  "concurrent_clients": n, "listen_backlog": ThreadingWSGIServer.request_queue_size,
                  "concurrent_wall_s": conc_s,
                  "concurrent_clips_per_s": n / float(np.median(conc_s)),
                  "batcher_steps_concurrent": conc_batches,
                  "launches_sequential": seq_counts, "launches_concurrent": conc_counts,
                  "launches_noface": nf_counts, "launches_sync": sync_counts,
                  "prob_fake_kernels": seq[0]["prob_fake"], "prob_fake_plain": p_plain,
                  "prob_fake_abs_diff": diff, "prob_tol": PROB_TOL,
                  "noface": {k: nf[k] for k in ("prediction", "num_faces", "prob_fake")}},
           "job": {"ms": job_ms, "launches": job_counts, "verdict": verdict,
                   "sync_verdict": sync["prediction"]},
           "vit": {"load_model_s": load_s, "request_ms": vit_ms,
                   "request_ms_median": float(np.median(vit_ms)),
                   "predict_video_ms": vit_direct_ms,
                   "predict_video_ms_median": float(np.median(vit_direct_ms)),
                   "explain_request_ms": explain_ms,
                   "launches_requests": vit_counts, "launches_explain": explained,
                   "prob_fake": [r["prob_fake"] for r in vit_res],
                   "saliency_grid": sal["grid"]},
           "launches": launches}
    _emit(rec)
    print(f"web app: B0 {med:.1f} ms a request over HTTP, "
          f"{rec['b0']['predict_video_ms_median']:.1f} ms through predict_video, "
          f"{rec['b0']['concurrent_clips_per_s']:.1f} clips/s with {n} clients, job "
          f"{job_ms:.1f} ms; ViT-B/16 {rec['vit']['request_ms_median']:.1f} ms, explain "
          f"{explain_ms:.1f} ms on {smi}", flush=True)
    return {"web_app": launches}


def _reset_counts(A, P) -> None:
    P.fused_normalize.launches = P.fused_normalize_yuv.launches = 0
    for f in (P.fused_normalize, P.fused_normalize_yuv, A.flash_attention_fwd,
              A.flash_attention_bwd):
        f.launches_by_device.clear()
    for f in (A.flash_attention_fwd, A.flash_attention_bwd):
        f.launches = f.launches_long = f.launches_split = f.launches_f32 = 0


def _counts(A, P) -> dict:
    """Launches since the last reset, by TPU kernel: the flash kernels at
    N ≤ 512 stand for K2 (forward) and K4 (backward), at N > 512 for K3 and
    K5/K6 (one backward call runs both passes)."""
    fwd, bwd = A.flash_attention_fwd, A.flash_attention_bwd
    return {"K1": P.fused_normalize.launches, "K1-YUV": P.fused_normalize_yuv.launches,
            "K2": fwd.launches - fwd.launches_long, "K3": fwd.launches_long,
            "K4": bwd.launches - bwd.launches_long,
            "K5": bwd.launches_long, "K6": bwd.launches_long}


def train_long(torch, A, P, smi: str, data: str, out: str, device: str = "cuda"):
    """Train the temporal transformer one epoch at T = 640 through Trainer,
    check it, time a step. Returns (launches by kernel, record, model)."""
    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train.steps import global_norm
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    T, B = LONG["train_frames"], 1
    t0 = time.perf_counter()
    ds = VideoFacesDataset(data, num_frames=T)
    train_ds, val_ds = ds.split(0.2)
    model, _, model_config = cli.build_model(
        "temporal", T, backbone=LONG["backbone"], bf16=True, device=device,
        temporal_kwargs={k: LONG[k] for k in ("d_model", "depth", "num_heads")})
    _require(all(p.dtype == torch.float32 for p in model.parameters()),
             "training params are not f32")
    cfg = TrainerConfig(out_dir=out, epochs=1, batch_size=B, num_frames=T,
                        lr=1e-4, optimizer="adam", schedule="step", loss="ce",
                        balance="weights", grad_clip=None, best_metric="f1",
                        threshold_sweep=True, augment=True, model_config=model_config)
    trainer = Trainer(model, train_ds, val_ds, cfg, device=device)
    step_metrics = []
    step_fn = trainer.train_step

    def recording_step(state, batch, gen):
        state, m = step_fn(state, batch, gen)
        step_metrics.append({k: float(v) for k, v in m.items()})
        return state, m

    trainer.train_step = recording_step
    setup_s = time.perf_counter() - t0

    gc.collect()    # no garbage of an earlier phase in this one's peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(A, P)
    t = time.perf_counter()
    state = trainer.train(log=lambda msg: print(f"  trainer: {msg}", flush=True))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t
    launches = _counts(A, P)
    _require_split_route(A, "long-clip training")
    peak_bytes = torch.cuda.max_memory_allocated()

    depth_bb, depth_t = len(model.backbone.blocks), model.depth
    steps, val_batches = state.step, -(-len(val_ds) // B)
    _require(steps == len(train_ds), f"{steps} train steps")
    want = {"K1": 0, "K1-YUV": 0, "K2": depth_bb * (steps + val_batches),
            "K3": depth_t * (steps + val_batches), "K4": depth_bb * steps,
            "K5": depth_t * steps, "K6": depth_t * steps}
    _require(launches == want, f"long-clip training launches {launches} != {want}")
    _require(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                 for m in step_metrics), f"non-finite step metrics {step_metrics}")
    for name in ("checkpoint_best.npz", "training_history.csv",
                 "calibration_best.json", "preds_epoch_0.csv"):
        _require(os.path.exists(os.path.join(out, name)), f"no {name}")

    # one step of the temporal blocks, kernels vs plain versions: loss and
    # the temporal parameters' grad norm on the backbone features of one
    # augmented batch, with the same dropout draws (swapping the backbone's
    # attention too would hold 12 f32 score slabs of 640 x 12 x 197^2)
    batch = next(iter(trainer._device_batches(train_ds, True)))
    batch.pop("paths", None)
    batch = trainer._prep_train(batch, torch.Generator(device=device).manual_seed(1))
    frames = batch["frames"]
    with torch.no_grad():
        feats = model.backbone(frames.reshape((-1,) + tuple(frames.shape[2:])))
    feats = feats.reshape(frames.shape[0], frames.shape[1], -1)
    params = [p for n, p in model.named_parameters() if not n.startswith("backbone.")]

    def loss_and_norm():
        logits, _ = model.forward_temporal(
            feats, train=True, generator=torch.Generator(device=device).manual_seed(2))
        loss = trainer.loss_fn(logits, batch["labels"], sample_mask=batch["valid"])
        return float(loss.detach()), float(global_norm(torch.autograd.grad(loss, params)))

    loss_k, norm_k = loss_and_norm()
    _reset_counts(A, P)
    with _plain_attention(A):
        loss_p, norm_p = loss_and_norm()
    _require(not any(_counts(A, P).values()), f"the plain step launched {_counts(A, P)}")
    d_loss = abs(loss_k - loss_p) / abs(loss_p)
    d_norm = abs(norm_k - norm_p) / norm_p
    _require(d_loss <= STEP_TOL_LOSS and d_norm <= LONG_TOL_NORM,
             f"temporal step kernels vs plain: loss {loss_k} vs {loss_p}, "
             f"grad norm {norm_k} vs {norm_p}")

    step_ms = _time_ms(torch, lambda: step_fn(state, batch, None), iters=3, warmup=1)
    rec = {"phase": "long_clip_training", "card": smi, "model": "temporal",
           **{k: LONG[k] for k in ("backbone", "d_model", "depth", "num_heads")},
           "params": "f32", "activations": "bf16", "clips": len(ds),
           "batch_clips": B, "frames_per_clip": T, "tokens": T + 1,
           "setup_s": setup_s, "epoch_s": epoch_s, "train_steps": steps,
           "val_batches": val_batches, "step_metrics": step_metrics,
           "epoch_train_loss": trainer.history[-1]["train_loss"],
           "launches": launches,
           "step_loss_kernels": loss_k, "step_loss_plain": loss_p,
           "step_grad_norm_kernels": norm_k, "step_grad_norm_plain": norm_p,
           "step_loss_rel_diff": d_loss, "step_grad_norm_rel_diff": d_norm,
           "step_tol": {"loss": STEP_TOL_LOSS, "grad_norm": LONG_TOL_NORM},
           "step_ms": step_ms, "frames_per_s": B * T / step_ms * 1e3,
           "max_memory_allocated_bytes": peak_bytes}
    _emit(rec)
    print(f"long-clip training step {step_ms:.1f} ms at {T} frames "
          f"({B * T / step_ms * 1e3:.1f} frames/s), peak {peak_bytes / 2**30:.2f} GiB "
          f"allocated on {smi}", flush=True)
    return launches, rec


def evaluate_long(torch, A, P, smi: str, data: str, ckpt: str, device: str = "cuda"):
    """The evaluator CLI on the checkpoint at T = 1024; one clip against the
    plain versions; ms per clip. Returns (launches by kernel, record, the
    rebuilt model)."""
    import csv

    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.evals import evaluate as E

    T, B = LONG["frames"], LONG["eval_batch"]
    out_csv = os.path.join(os.path.dirname(ckpt), "evaluation_long.csv")
    _reset_counts(A, P)
    t = time.perf_counter()
    _require(E.main(["--data_dir", data, "--checkpoint", ckpt, "--num_frames", str(T),
                     "--batch_size", str(B), "--bf16", "--out_csv", out_csv,
                     "--device", device]) == 0, "evaluator exited non-zero")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = _counts(A, P)
    _require_split_route(A, "long-clip evaluation")

    with open(out_csv) as f:
        rows = list(csv.DictReader(f))
    n_clips = LONG["clips"]
    _require(len(rows) == n_clips and all(0.0 <= float(r["prob_fake"]) <= 1.0
                                          for r in rows), f"evaluation CSV rows {rows}")
    sd, meta = E.load_any(ckpt)
    model, report, mt = E.build_model_from_checkpoint(sd, meta, "", torch.bfloat16, device)
    _require(mt == "temporal" and report["match_ratio"] == 1.0,
             f"rebuilt {mt} with match_ratio {report['match_ratio']}")
    forwards = -(-n_clips // B)
    depth_bb, depth_t = len(model.backbone.blocks), model.depth
    want = {"K1": forwards, "K1-YUV": 0, "K2": depth_bb * forwards,
            "K3": depth_t * forwards,
            "K4": 0, "K5": 0, "K6": 0}
    _require(launches == want, f"long-clip evaluation launches {launches} != {want}")

    # one clip through the kernels and through the plain versions
    ds = VideoFacesDataset(data, num_frames=T)
    clip = torch.from_numpy(ds[0][0][None]).to(device)

    def run(normalize):
        with torch.inference_mode():
            logits, scores = model(normalize(clip, torch.bfloat16))
        return float(torch.softmax(logits.float(), dim=-1)[0, 1]), scores

    p_kernels, s_kernels = run(P.fused_normalize)
    _reset_counts(A, P)
    with _plain_attention(A):
        p_plain, s_plain = run(P.fused_normalize_plain)
    _require(not any(_counts(A, P).values()), f"the plain run launched {_counts(A, P)}")
    scores_diff = float((s_kernels - s_plain).abs().max())
    scores_rel = scores_diff / float(s_plain.abs().max())
    p_csv = float(next(r["prob_fake"] for r in rows if r["path"] == ds.files[0]))
    diff = abs(p_kernels - p_plain)
    _require(diff <= PROB_TOL, f"long-clip prob_fake kernels {p_kernels} vs plain {p_plain}")
    _require(scores_rel <= LONG_TOL_SCORES,
             f"long-clip frame scores kernels vs plain: {scores_rel} of max |ref|")

    # ms per clip: the evaluator's batched forward (normalise + model) by CUDA events
    batch = torch.from_numpy(np.stack([ds[i][0] for i in range(B)])).to(device)

    @torch.inference_mode()
    def forward():
        return model(P.fused_normalize(batch, torch.bfloat16))

    batch_ms = _time_ms(torch, forward, iters=3, warmup=1)
    rec = {"phase": "long_clip_evaluation", "card": smi, "model": "temporal",
           "backbone": LONG["backbone"], "activations": "bf16", "clips": n_clips,
           "batch_clips": B, "frames_per_clip": T, "tokens": T + 1,
           "evaluator_wall_s": main_s, "launches": launches, "csv_rows": len(rows),
           "prob_fake_kernels": p_kernels, "prob_fake_plain": p_plain,
           "prob_fake_csv": p_csv, "prob_fake_abs_diff": diff, "prob_tol": PROB_TOL,
           "frame_scores_max_abs_diff": scores_diff, "frame_scores_rel_diff": scores_rel,
           "frame_scores_tol": LONG_TOL_SCORES,
           "batch_forward_ms": batch_ms, "ms_per_clip": batch_ms / B,
           "frames_per_s": B * T / batch_ms * 1e3}
    _emit(rec)
    print(f"long-clip evaluation {batch_ms / B:.1f} ms per {T}-frame clip on {smi}",
          flush=True)
    return launches, rec, model


def serve_long(torch, A, P, model, ckpt: str, faces, device: str = "cuda"):
    """Serve the temporal checkpoint through the Predictor, after its
    bucket warmup: one request. Returns (launches by kernel, the result dict)."""
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor

    pred = Predictor(model, None, "temporal", checkpoint_path=ckpt, device=device)
    _require(pred.warmup_done.wait(timeout=600), "temporal warmup did not finish in 600 s")
    _require(pred.warmup_error is None, f"temporal warmup failed: {pred.warmup_error!r}")
    _reset_counts(A, P)
    res = pred.predict_faces(faces, video_id="temporal")
    torch.cuda.synchronize()
    launches = _counts(A, P)
    pred.close()
    _check_result(res, len(faces), "request to the temporal checkpoint")
    want = {"K1": 1, "K1-YUV": 0, "K2": len(model.backbone.blocks) + model.depth,
            "K3": 0, "K4": 0, "K5": 0, "K6": 0}
    _require(launches == want, f"temporal serving launches {launches} != {want}")
    _emit({"phase": "long_clip_serving", "frames": len(faces), "launches": launches,
           "prediction": res["prediction"], "prob_fake": res["prob_fake"]})
    return launches, res


def mtcnn_weights(torch, seed: int = 0) -> dict:
    """The port's cascade drawn from a generator seeded ``seed`` as a
    facenet-layout state dict (CPU tensors), each net's face-class bias
    raised by ``FROM_VIDEOS["face_bias"]``: random nets score near 0.5, so
    without it nothing passes the default thresholds (0.6, 0.7, 0.7)."""
    from deepfake_video_detection_tpu_torch.models.mtcnn import MTCNN

    det = MTCNN((48, 48), device="cpu", generator=torch.Generator().manual_seed(seed))
    sd = {k: t.detach().clone() for k, t in det.state_dict().items()}
    for key, d in zip(("pnet.conv4_1.bias", "rnet.dense5_1.bias", "onet.dense6_1.bias"),
                      FROM_VIDEOS["face_bias"]):
        sd[key][1] += d
    return sd


def mtcnn_frames(n: int, H: int, W: int) -> np.ndarray:
    """``n`` textured (H, W) frames from seed 0, (n, H, W, 3) uint8: a smooth
    random pattern, noise, the synthetic face. No two cells of P-Net's grid
    see the same pixels, so no candidate ties another on score."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for _ in range(n):
        fx, fy, ph = rng.uniform(20, 80), rng.uniform(20, 80), rng.uniform(0, 6)
        img = 120 + 50 * np.sin(xx / fx + ph) * np.cos(yy / fy) + rng.normal(0, 6, (H, W))
        s = min(H, W) // 2
        oy, ox = int(rng.integers(0, H - s)), int(rng.integers(0, W - s))
        img[oy:oy + s, ox:ox + s] = synth_face(s) + rng.normal(0, 6, (s, s))
        rgb = np.stack([img, img * 0.95 + 8, img * 1.05 - 8], -1)
        out.append(np.clip(rgb, 0, 255).astype(np.uint8))
    return np.stack(out)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    iw = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def match_detections(gb, gs, gv, rb, rs, rv):
    """Detections ``g`` against reference ones ``r`` ((N, F, 4) boxes, (N, F)
    scores and valid masks, CPU tensors): the share of valid boxes (of the
    larger of the two counts) whose reference box has a valid match at
    IoU > 0.5, and the largest score gap over the matched."""
    gb, gs, gv, rb, rs, rv = (t.numpy() for t in (gb, gs, gv, rb, rs, rv))
    matched, gap = 0, 0.0
    for n in range(rv.shape[0]):
        a, sa, b, sb = rb[n][rv[n]], rs[n][rv[n]], gb[n][gv[n]], gs[n][gv[n]]
        if len(a) == 0 or len(b) == 0:
            continue
        iou = _iou_matrix(a, b)
        ok, best = iou.max(1) > 0.5, iou.argmax(1)
        matched += int(ok.sum())
        if ok.any():
            gap = max(gap, float(np.abs(sa[ok] - sb[best[ok]]).max()))
    total = max(int(rv.sum()), int(gv.sum()))
    return (matched / total if total else 0.0), gap


class _Tee:
    """A text stream that keeps what is written and passes it on."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _fv_cascade(torch, smi: str, clip: str, sd: dict, tf32_defaults: dict) -> dict:
    """(a) The cascade on the card: on 16 cv2 frames of ``clip`` the frames
    with a kept box after each stage (at least one each), and on 4 textured
    frames of the clip's size against the same cascade on the CPU, with
    cuDNN's TF32 off (``MTCNN_MATCH``, ``MTCNN_SCORE_TOL``) and on."""
    from deepfake_video_detection_tpu_torch.data.video import sample_video_frames
    from deepfake_video_detection_tpu_torch.models import mtcnn as M

    frames = sample_video_frames(clip, max_frames=FROM_VIDEOS["num_frames"])
    H, W = frames.shape[1:3]
    det = M.MTCNN((H, W), device="cuda")
    det.load_state_dict(sd, strict=True)
    kept, real_nms = [], M.masked_nms

    def recording(*args):
        keep = real_nms(*args)
        kept.append(int(keep.any(dim=-1).sum()))
        return keep

    with mock.patch.object(M, "masked_nms", recording):
        _, _, valid = det.detect(frames)
    stages = dict(zip(("pnet", "rnet", "onet"), kept))
    _require(len(kept) == 3 and min(kept) >= 1 and int(valid.any(-1).sum()) == kept[2],
             f"the cascade kept no box at some stage: frames with a box {stages}")

    cmp = mtcnn_frames(FROM_VIDEOS["cmp_frames"], H, W)
    cpu = M.MTCNN((H, W), device="cpu")
    cpu.load_state_dict(sd, strict=True)
    ref = cpu.detect(cmp)
    prev = torch.backends.cudnn.allow_tf32
    out = {}
    try:
        for name, flag in (("tf32_off", False), ("tf32_torch_default",
                                                 tf32_defaults["cudnn_allow_tf32"])):
            torch.backends.cudnn.allow_tf32 = flag
            got = [t.cpu() for t in det.detect(torch.from_numpy(cmp).cuda())]
            share, gap = match_detections(*got, *ref)
            out[name] = {"cudnn_allow_tf32": flag, "match_share": share, "score_gap": gap,
                         "valid_card": int(got[2].sum()), "valid_cpu": int(ref[2].sum())}
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    rec = {"phase": "from_videos_cascade", "card": smi, "frames": len(frames),
           "frame_size": [H, W], "scales": len(det.scales),
           "frames_with_a_box_by_stage": stages, "card_vs_cpu": out,
           "tol": {"match_share": MTCNN_MATCH, "score_gap": MTCNN_SCORE_TOL}}
    _emit(rec)
    off = out["tf32_off"]
    _require(off["valid_cpu"] > 0 and off["match_share"] >= MTCNN_MATCH
             and off["score_gap"] < MTCNN_SCORE_TOL,
             f"the cascade on the card vs the CPU (TF32 off): {off}")
    return rec


def _fv_prepare(torch, smi: str, root: str, clipdir: str, sd: dict) -> dict:
    """(b) ``data/prepare.py main --detector mtcnn --batch-clips 8``: one
    ``.npz`` a clip, no clip skipped; ms a clip by stage (decode on the
    thread pool, the cascade, the crop; timed around the package's calls),
    and one batch's cascade under the profiler (launches, idle share)."""
    import contextlib

    from deepfake_video_detection_tpu_torch.data import faces as faces_mod
    from deepfake_video_detection_tpu_torch.data import prepare
    from deepfake_video_detection_tpu_torch.data.video import sample_video_frames
    from deepfake_video_detection_tpu_torch.models.mtcnn import MTCNN

    out = os.path.join(root, "faces")
    stages, n = {}, FROM_VIDEOS["clips"]
    tee = _Tee(sys.stdout)
    with mock.patch.object(prepare, "sample_video_frames",
                           _stage_timer(stages, "decode", prepare.sample_video_frames)), \
            mock.patch.object(faces_mod.FaceExtractor, "_detect_mtcnn",
                              _stage_timer(stages, "cascade",
                                           faces_mod.FaceExtractor._detect_mtcnn)), \
            mock.patch.object(faces_mod, "crop_and_resize_batch",
                              _stage_timer(stages, "crop", faces_mod.crop_and_resize_batch)), \
            contextlib.redirect_stdout(tee):
        t = time.perf_counter()
        rc = prepare.main(["--data_dir", clipdir, "--out_dir", out, "--detector", "mtcnn",
                           "--batch-clips", str(FROM_VIDEOS["batch_clips"])])
        wall_s = time.perf_counter() - t
    _require(rc == 0, "the prep CLI exited non-zero")
    _require("skipping" not in tee.text(), f"the prep CLI skipped a clip: {tee.text()}")
    files = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
    _require(len(files) == n, f"the prep CLI wrote {len(files)} files for {n} clips")
    shapes = set()
    for f in files:
        with np.load(os.path.join(out, f)) as z:
            faces = z["faces"]
        _require(faces.dtype == np.uint8 and faces.ndim == 4 and 1 <= len(faces) <= 32
                 and faces.shape[1:] == (224, 224, 3) and faces.any(),
                 f"{f}: faces {faces.shape} {faces.dtype}")
        shapes.add(faces.shape)

    # one batch's cascade on the card: the frames of --batch-clips clips
    clips = sorted(os.listdir(clipdir))[:FROM_VIDEOS["batch_clips"]]
    batch = torch.from_numpy(np.concatenate(
        [sample_video_frames(os.path.join(clipdir, c), 5, 32) for c in clips])).cuda()
    det = MTCNN(tuple(batch.shape[1:3]), device="cuda")
    det.load_state_dict(sd, strict=True)
    breakdown = _kernel_breakdown(torch, lambda: det.detect(batch), top=8)
    rec = {"phase": "from_videos_prepare", "card": smi, "clips": n, "files": len(files),
           "face_shapes": sorted(shapes), "batch_clips": FROM_VIDEOS["batch_clips"],
           "wall_s": wall_s, "ms_per_clip_wall": wall_s / n * 1e3,
           "ms_per_clip_by_stage": {k: sum(v) / n for k, v in stages.items()},
           "stage_calls": {k: len(v) for k, v in stages.items()},
           "cascade_batch_frames": int(batch.shape[0]),
           "cascade_batch": {k: breakdown[k] for k in ("events_ms", "device_ms", "idle_share",
                                                       "launches", "kernels")},
           "cascade_batch_top": breakdown["top"]}
    _emit(rec)
    return rec


def _fv_train(torch, A, P, smi: str, root: str, clipdir: str):
    """(c) ``train/cli.py main --from-videos --detector mtcnn`` at the CLI's
    default model (vit_gcn, f32) for one epoch: artefacts, finite losses,
    no decode failure (stderr captured) and no zero clip in a pass over the
    dataset, 12 f32 K2 and K4 launches a step; step ms, epoch s, the
    share of the epoch spent waiting on the loader, peak memory. Returns
    (launches, f32 launches, the best checkpoint's path)."""
    import concurrent.futures as fut
    import contextlib
    import csv

    from deepfake_video_detection_tpu_torch.data.video_dataset import VideoClipsDataset
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer

    T, B, n = FROM_VIDEOS["num_frames"], FROM_VIDEOS["batch"], FROM_VIDEOS["clips"]
    out = os.path.join(root, "checkpoints")
    waits, consumer, epochs = {"train": [], "val": []}, {"train": [], "val": []}, {}
    batches = Trainer._device_batches

    def timed_batches(self, ds, train, epoch=0):
        kind = "train" if train else "val"
        it = iter(batches(self, ds, train, epoch))
        while True:
            t = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            waits[kind].append(time.perf_counter() - t)
            t = time.perf_counter()
            yield b
            consumer[kind].append(time.perf_counter() - t)

    tee = _Tee(sys.stderr)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(A, P)
    with mock.patch.object(Trainer, "_device_batches", timed_batches), \
            mock.patch.object(Trainer, "train_epoch",
                              _stage_timer(epochs, "train_epoch", Trainer.train_epoch)), \
            contextlib.redirect_stderr(tee):
        t = time.perf_counter()
        rc = cli.main(["--data_dir", clipdir, "--from-videos", "--detector", "mtcnn",
                       "--epochs", "1", "--batch_size", str(B), "--num_frames", str(T),
                       "--out_dir", out])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    launches, f32 = _counts(A, P), _f32_counts(A)
    _require(rc == 0, "the training CLI exited non-zero from videos")
    _require("decode failed" not in tee.text(), f"a clip failed to decode: {tee.text()}")
    for name in ("checkpoint_best.npz", "training_history.csv"):
        _require(os.path.exists(os.path.join(out, name)), f"the CLI wrote no {name}")
    with open(os.path.join(out, "training_history.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["train_loss"]) for r in rows] + [float(r["val_loss"]) for r in rows
                                                       if "val_loss" in r]
    _require(len(rows) == 1 and all(math.isfinite(x) for x in losses),
             f"training history {rows}")
    steps, val_batches = len(waits["train"]), len(waits["val"])
    n_val = max(1, int(n * 0.2))
    _require(steps == -(-(n - n_val) // B) and val_batches == -(-n_val // B),
             f"{steps} steps and {val_batches} validation batches for {n} clips")
    depth = LEGACY["depth"]
    want = _want(K2=depth * (steps + val_batches), K4=depth * steps)
    _require(launches == want and f32 == {"K2": want["K2"], "K4": want["K4"]},
             f"from-videos training launches {launches} ({f32} f32) != {want}")

    # one pass over the dataset: no clip zero-filled, no failure printed
    ds = VideoClipsDataset(clipdir, num_frames=T, detector="mtcnn", device="cuda")
    with fut.ThreadPoolExecutor(4) as pool:
        nonzero = list(pool.map(lambda i: bool(ds[i][0].reshape(T, -1).any(1).all()),
                                range(len(ds))))
    _require(all(nonzero) and not ds._warned,
             f"a clip came out zero-filled: {[ds.files[i] for i, ok in enumerate(nonzero) if not ok]}")

    epoch_s = epochs["train_epoch"][0] / 1e3
    rec = {"phase": "from_videos_training", "card": smi, "model": "vit_gcn",
           "vit_variant": LEGACY["vit"], "built_by": "train/cli.py main --from-videos "
           "--detector mtcnn --epochs 1", "params": "f32", "activations": "f32",
           "clips": n, "batch_clips": B, "frames_per_clip": T, "cli_wall_s": cli_s,
           "train_steps": steps, "val_batches": val_batches, "launches": launches,
           "launches_f32": f32, "k2_per_step": launches["K2"] / (steps + val_batches),
           "k4_per_step": launches["K4"] / steps,
           "step_ms": [x * 1e3 for x in consumer["train"]],
           "loader_wait_ms": {k: [x * 1e3 for x in v] for k, v in waits.items()},
           "epoch_s": epoch_s,
           "loader_wait_share_of_epoch": sum(waits["train"]) / epoch_s,
           "max_memory_allocated_bytes": peak, "train_loss": float(rows[0]["train_loss"]),
           "no_zero_clip": True}
    _emit(rec)
    return launches, f32, os.path.join(out, "checkpoint_best.npz")


def _fv_evaluate(torch, A, P, smi: str, root: str, clipdir: str, ckpt: str):
    """(d) ``evals/evaluate.py main --from-videos`` on the trained checkpoint,
    at its default detector (center: decoded by cv2, the center prior's
    crops resized on the card): 20 rows, K1 once and K2 12 times a batch, no
    decode failure; the first batch's ``prob_fake`` through the plain
    versions within ``PROB_TOL``. Returns (launches, f32 launches)."""
    import contextlib
    import csv

    from deepfake_video_detection_tpu_torch.checkpoint.store import load_any
    from deepfake_video_detection_tpu_torch.data.dataset import SubsetDataset
    from deepfake_video_detection_tpu_torch.data.video_dataset import VideoClipsDataset
    from deepfake_video_detection_tpu_torch.evals import evaluate as E

    T, B, n = FROM_VIDEOS["num_frames"], FROM_VIDEOS["batch"], FROM_VIDEOS["clips"]
    out_csv = os.path.join(root, "evaluation_from_videos.csv")
    tee = _Tee(sys.stderr)
    _reset_counts(A, P)
    with contextlib.redirect_stderr(tee):
        t = time.perf_counter()
        rc = E.main(["--data_dir", clipdir, "--from-videos", "--checkpoint", ckpt,
                     "--out_csv", out_csv])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    launches, f32 = _counts(A, P), _f32_counts(A)
    _require(rc == 0, "the evaluator exited non-zero from videos")
    _require("decode failed" not in tee.text(), f"a clip failed to decode: {tee.text()}")
    with open(out_csv) as f:
        rows = list(csv.DictReader(f))
    _require(len(rows) == n and all(0.0 <= float(r["prob_fake"]) <= 1.0 for r in rows),
             f"evaluation CSV rows {rows}")
    forwards, depth = -(-n // B), LEGACY["depth"]
    want = _want(K1=forwards, K2=depth * forwards)
    _require(launches == want and f32 == {"K2": want["K2"], "K4": 0},
             f"from-videos evaluation launches {launches} ({f32} f32) != {want}")

    # the first batch through the plain versions
    sd, meta = load_any(ckpt)
    model, _, mt = E.build_model_from_checkpoint(sd, meta, "", None, "cuda")
    ds = VideoClipsDataset(clipdir, num_frames=T, device="cuda")
    _reset_counts(A, P)
    with mock.patch.object(E, "fused_normalize", P.fused_normalize_plain), \
            _plain_attention(A):
        _, _, p_plain = E.evaluate_dataset(model, SubsetDataset(ds, range(B)), B, 1, mt)
    _require(not any(_counts(A, P).values()) and not ds._warned,
             f"the plain evaluation launched {_counts(A, P)}")
    p_kernels = np.array([float(r["prob_fake"]) for r in rows[:B]])
    diff = float(np.abs(p_kernels - p_plain).max())
    rec = {"phase": "from_videos_evaluation", "card": smi, "model": mt,
           "detector": "center (cv2 decode, VIDEO_BACKEND=cv2)", "activations": "f32",
           "clips": n, "batch_clips": B, "frames_per_clip": T, "wall_s": wall_s,
           "ms_per_clip": wall_s / n * 1e3, "launches": launches, "csv_rows": len(rows),
           "prob_fake_kernels_vs_plain": diff, "prob_tol": PROB_TOL}
    _emit(rec)
    _require(diff <= PROB_TOL, f"from-videos prob_fake kernels vs plain differ by {diff}")
    return launches, f32


def from_videos(torch, A, P, smi: str, tf32_defaults: dict):
    """Training and evaluation from raw videos (``from_videos``): 20 clips
    written by cv2, decoded through cv2 (``VIDEO_BACKEND=cv2``), the mtcnn
    cascade from ``mtcnn_weights`` (``MTCNN_WEIGHTS``); (a)-(d), at torch's
    default TF32 flags (the CLIs' own; restored afterwards). Returns
    (launches by path, f32 launches by path)."""
    import concurrent.futures as fut
    import shutil
    import tempfile

    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32_defaults["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = tf32_defaults["matmul_allow_tf32"]
    root = tempfile.mkdtemp(prefix="dfdt_fromvideos_")
    try:
        clipdir = os.path.join(root, "clips")
        os.makedirs(clipdir)
        wpath = os.path.join(root, "mtcnn_weights.pt")
        sd = mtcnn_weights(torch, 0)
        torch.save(sd, wpath)
        env = {"VIDEO_BACKEND": "cv2", "MTCNN_WEIGHTS": wpath}
        seconds = {}
        with mock.patch.dict(os.environ, env):
            for k in ("FACE_DETECTOR", "VIDEO_SAMPLE_RATE", "VIDEO_KEYFRAMES_ONLY",
                      "KEEP_ALL_FACES", "MAX_FRAMES", "FACE_SIZE", "HAAR_CASCADE"):
                os.environ.pop(k, None)
            t = time.perf_counter()
            n = FROM_VIDEOS["clips"]
            paths = [os.path.join(clipdir, f"clip{i:02d}_{'fake' if i % 2 else 'real'}.mp4")
                     for i in range(n)]
            with fut.ThreadPoolExecutor(4) as pool:
                list(pool.map(lambda i: write_clip(paths[i], i % 4, frames=FROM_VIDEOS["frames"],
                                                   step=2, background=140 if i % 2 else 100),
                              range(n)))
            seconds["write_clips"] = time.perf_counter() - t

            def part(name, fn, *args):
                t = time.perf_counter()
                res = fn(*args)
                seconds[name] = time.perf_counter() - t
                gc.collect()
                torch.cuda.empty_cache()
                return res

            part("cascade", _fv_cascade, torch, smi, paths[0], sd, tf32_defaults)
            part("prepare", _fv_prepare, torch, smi, root, clipdir, sd)
            trained, trained_f32, ckpt = part("training", _fv_train, torch, A, P, smi, root,
                                              clipdir)
            evaluated, evaluated_f32 = part("evaluation", _fv_evaluate, torch, A, P, smi, root,
                                            clipdir, ckpt)
        _emit({"phase": "from_videos_seconds", **seconds})
        launches = {k: trained[k] + evaluated[k] for k in ("K1", "K2", "K4")}
        f32 = {k: trained_f32[k] + evaluated_f32[k] for k in ("K2", "K4")}
        return {"from_videos": launches}, {"from_videos": f32}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        shutil.rmtree(root, ignore_errors=True)


def _mode_hooks():
    """``(owner, attribute, key, counts_call)``: functions that only a mode's
    own code calls, so their calls in a step show which modes it ran: the
    ring's fold and its backward's block gradients, Ulysses' all-to-alls,
    the expert-parallel MoE, the pipeline, and a step's gradient reduction
    under a mesh."""
    from deepfake_video_detection_tpu_torch.models import temporal_transformer as TT
    from deepfake_video_detection_tpu_torch.nn.moe import MoEMLP
    from deepfake_video_detection_tpu_torch.ops import ring_attention as R
    from deepfake_video_detection_tpu_torch.ops import ulysses_attention as U
    from deepfake_video_detection_tpu_torch.parallel.strategy import ParallelRuntime

    every = lambda *a: True  # noqa: E731
    return [(R, "fold_forward", "ring_fold", every),
            (R, "block_grads", "ring_block_grads", every),
            (U, "all_to_all", "ulysses_all_to_all", every),
            (MoEMLP, "apply_expert_parallel", "expert_parallel", every),
            (TT, "pipeline_blocks", "pipeline", every),
            (ParallelRuntime, "reduce_grads", "mesh_reduce_grads",
             lambda self, *a: self.mesh is not None)]


class _ModeCalls:
    """Within the block, count the calls of :func:`_mode_hooks`' functions
    into ``self.counts``; the functions are restored on exit."""

    def __enter__(self):
        self.counts, self.saved = {}, []
        for owner, attr, key, pred in _mode_hooks():
            orig = getattr(owner, attr)
            self.counts[key] = 0

            def wrap(*a, _orig=orig, _key=key, _pred=pred, **k):
                if _pred(*a):
                    self.counts[_key] += 1
                return _orig(*a, **k)

            setattr(owner, attr, wrap)
            self.saved.append((owner, attr, orig))
        return self.counts

    def __exit__(self, *exc):
        for owner, attr, orig in self.saved:
            setattr(owner, attr, orig)
        return False


def _full_params(params) -> dict:
    """Every parameter whole and f32 (an FSDP2 DTensor gathered)."""
    from torch.distributed.tensor import DTensor

    return {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach().float().clone()
            for n, p in params.items()}


def _first_steps(torch, A, P, step, state, batch, gen, rec: dict) -> None:
    """Two steps of ``step`` from ``state`` into ``rec``: the first's loss,
    grad norm, launches, mode calls (:class:`_ModeCalls`), peak memory,
    the parameters' change (``update``) and Adam's first moment
    (``moment``), both kept on the card for :func:`_par_compare`, then the
    second's loss."""
    from torch.distributed.tensor import DTensor

    before = _full_params(state.params)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(A, P)
    with _ModeCalls() as modes:
        state, m = step(state, batch, gen())
        torch.cuda.synchronize()
    rec.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               launches=_counts(A, P), launches_f32=_f32_counts(A), mode_calls=dict(modes),
               dtensor_params=sum(isinstance(p, DTensor) for p in state.params.values()),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    after = _full_params(state.params)
    rec["update"] = {n: after[n] - before[n] for n in before}
    rec["moment"] = _full_params(state.opt_state["mu"])
    del before, after
    state, m = step(state, batch, gen())
    rec["loss2"] = float(m["loss"])


def _par_step(torch, A, P, build, batch, loss_fn, opt_fn, plan=None):
    """Steps of ``build()`` (under ``plan``: placed, with its
    ``ParallelRuntime``) on ``batch`` with dropout from a generator seeded 2:
    :func:`_first_steps`, then the step's time, device time and idle share
    (``_kernel_breakdown``) over later steps."""
    from torch.distributed.fsdp import FSDPModule

    from deepfake_video_detection_tpu_torch.parallel.strategy import (
        ParallelRuntime, place_model, placement_line)
    from deepfake_video_detection_tpu_torch.train.state import TrainState
    from deepfake_video_detection_tpu_torch.train.steps import make_train_step

    model, opt, rec = build(), opt_fn(), {}
    runtime = None
    if plan is not None:
        rec["placement_summary"] = place_model(model, plan.mesh, plan.param_spec_fn)
        rec["placement"] = placement_line(plan, rec["placement_summary"])
        runtime = ParallelRuntime(plan.mesh)
    rec["fsdp_module"] = isinstance(model, FSDPModule)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, loss_fn, runtime=runtime)

    def gen():
        return torch.Generator(device="cuda").manual_seed(2)

    _first_steps(torch, A, P, step, state, batch, gen, rec)
    bd = _kernel_breakdown(torch, lambda: step(state, batch, gen()), top=5)
    rec.update(step_ms=bd["events_ms"], device_ms=bd["device_ms"],
               idle_share=bd["idle_share"], kernel_launches=bd["launches"])
    return rec


def _par_compare(smi: str, name: str, plan_rec: dict, plain_rec: dict, dtype: str,
                 flash: dict, modes: dict) -> dict:
    """Hold a plan's step to the no-plan step (``PAR_TOL``: the first step's
    loss and grad norm, Adam's first moment and the update after it, the
    second step's loss),
    require the same flash launches and those ``flash`` lists, and the mode
    calls ``modes`` (every other hook's count 0, and 0 for each in the
    no-plan step); emit and return the plan's launches by kernel."""
    import torch

    def rel(key):
        return abs(plan_rec[key] - plain_rec[key]) / abs(plain_rec[key])

    def rel_l2(key):
        a, b = plan_rec.pop(key), plain_rec[key]
        _require(set(a) == set(b), f"{name}: {key} names differ from the no-plan model's")
        num = math.sqrt(sum(float(torch.sum(torch.square(a[n] - b[n]))) for n in b))
        den = math.sqrt(sum(float(torch.sum(torch.square(b[n]))) for n in b))
        return num / den if den > 0 else math.inf

    diffs = {"loss": rel("loss"), "grad_norm": rel("grad_norm"), "moment": rel_l2("moment"),
             "update": rel_l2("update"), "loss2": rel("loss2")}
    for key, d in diffs.items():
        _require(d <= PAR_TOL[key], f"{name}: {key} differs by {d} > {PAR_TOL[key]} "
                 f"(plan {plan_rec.get(key)}, no plan {plain_rec.get(key)})")
    got = {k: plan_rec["launches"][k] for k in flash}
    _require(got == flash, f"{name}: flash launches {got} != {flash}")
    want = {k: modes.get(k, 0) for k in plan_rec["mode_calls"]}
    _require(plan_rec["mode_calls"] == want, f"{name}: mode calls {plan_rec['mode_calls']} "
             f"!= {want}")
    _require(not any(plain_rec["mode_calls"].values()),
             f"{name}: the no-plan step ran a mode: {plain_rec['mode_calls']}")
    import torch.distributed as dist

    _emit({"phase": name, "card": smi, "world": dist.get_world_size(),
           "backend": dist.get_backend(), "dtype": dtype,
           **{f"{k}_rel_diff": v for k, v in diffs.items()}, "tol": PAR_TOL,
           "plan": plan_rec,
           "no_plan": {k: v for k, v in plain_rec.items() if k not in ("update", "moment")}})
    print(f"{name}: step {plan_rec['step_ms']:.2f} ms (no plan "
          f"{plain_rec['step_ms']:.2f}), idle {plan_rec['idle_share']:.3f} "
          f"({plain_rec['idle_share']:.3f}), peak {plan_rec['max_memory_allocated_bytes'] / 2**30:.2f} "
          f"GiB ({plain_rec['max_memory_allocated_bytes'] / 2**30:.2f}) on {smi}", flush=True)
    return plan_rec["launches"]


def _ring_fold_check(torch, A, P, smi: str):
    """(d) The ring's fold at a virtual S = 2 and 4 over one (1, 4, 2048, 64)
    call, bf16 and f32: each virtual rank folds the blocks it would receive,
    its own first; O, dq, dk, dv against one flash call over the whole N
    and against the plain versions. Returns the fold's launches."""
    from deepfake_video_detection_tpu_torch.ops.ring_attention import (
        fold_backward, fold_forward)

    g = torch.Generator(device="cuda").manual_seed(5)
    launches = {"K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0}
    f32_launches = dict(launches)
    for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q, k, v, dout = (torch.randn(PARALLEL["ring_shape"], generator=g, device="cuda")
                         .to(dt) for _ in range(4))
        ref_o = A.flash_attention(q.requires_grad_(), k.requires_grad_(), v.requires_grad_())
        ref = [ref_o.detach()] + list(torch.autograd.grad(ref_o, (q, k, v), dout))
        q, k, v = (t.detach() for t in (q, k, v))
        p_o, p_lse = A.flash_attention_plain(q, k, v)
        plain = [p_o] + list(A.flash_attention_bwd_plain(q, k, v, p_o, p_lse, dout))
        for S in PARALLEL["ring_s"]:
            n = q.shape[2] // S
            blk = [(k[:, :, i * n:(i + 1) * n], v[:, :, i * n:(i + 1) * n]) for i in range(S)]
            outs, dqs = [], []
            dks = [torch.zeros_like(blk[0][0], dtype=torch.float32) for _ in range(S)]
            dvs = [torch.zeros_like(d) for d in dks]
            _reset_counts(A, P)
            for r in range(S):
                order = [(r - i) % S for i in range(S)]      # the ring's arrivals
                qr, dr = q[:, :, r * n:(r + 1) * n], dout[:, :, r * n:(r + 1) * n]
                o, lse = fold_forward(qr, [blk[b] for b in order])
                dq, dkv = fold_backward(qr, o, lse, dr, [blk[b] for b in order])
                outs.append(o)
                dqs.append(dq)
                for b, (dk_i, dv_i) in zip(order, dkv):
                    dks[b] += dk_i.float()
                    dvs[b] += dv_i.float()
            torch.cuda.synchronize()
            c = _counts(A, P)
            for key in launches:
                launches[key] += c[key]
                f32_launches[key] += c[key] if dt_name == "f32" else 0
            got = [torch.cat(outs, 2), torch.cat(dqs, 2), torch.cat(dks, 2), torch.cat(dvs, 2)]
            errs = {}
            for against, refs in (("kernel", ref), ("plain", plain)):
                for nm, a, b in zip(("o", "dq", "dk", "dv"), got, refs):
                    err = float((a.float() - b.float()).abs().max())
                    scale = float(b.float().abs().max()) if dt_name == "bf16" else 1.0
                    tol = RING_TOL[dt_name]["fwd" if nm == "o" else "bwd"]
                    errs[f"{against}_{nm}"] = err / scale
                    _require(err <= tol * scale, f"ring fold S={S} {dt_name} {nm} vs "
                             f"{against}: {err} > {tol * scale}")
            fwd, bwd = ("K3", "K5") if n > A._SHORT_MAX else ("K2", "K4")
            want = _want(**{fwd: S * S, bwd: S * S, **({"K6": S * S} if bwd == "K5" else {})})
            _require(c == want, f"ring fold S={S}: launches {c} != {want}")
            _emit({"phase": "parallel_ring_fold", "card": smi, "dtype": dt_name, "S": S,
                   "shape": list(PARALLEL["ring_shape"]), "block_rows": n,
                   "launches": c, "errors": errs, "tol": RING_TOL[dt_name]})
    return launches, f32_launches


def parallel(torch, A, P, smi: str):
    """The multi-device modes on a world of one over NCCL: (a) DP, (b)
    FSDP2, (d) the ring's fold, (e) expert parallelism and the pipeline.
    Returns (launches by path, f32 launches by path)."""
    import argparse

    import torch.distributed as dist

    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
        TemporalTransformerDetector)
    from deepfake_video_detection_tpu_torch.parallel.mesh import init_world, make_mesh
    from deepfake_video_detection_tpu_torch.parallel.strategy import (
        ParallelPlan, build_plan, make_fsdp_spec_fn)
    from deepfake_video_detection_tpu_torch.train import losses as Loss
    from deepfake_video_detection_tpu_torch.train import optim as O

    init_world("cuda")
    _require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
             f"world: {dist.get_backend()} x {dist.get_world_size()}")
    flags = argparse.Namespace(mesh="data=1", fsdp=False, seq="none", seq_par=1,
                               pp_stages=1, pp_microbatches=2, moe_experts=0, expert_par=0)
    B, T, size = PARALLEL["clips"], PARALLEL["frames"], PARALLEL["size"]
    g = torch.Generator(device="cuda").manual_seed(7)
    batch = {"frames": torch.randn((B, T, size, size, 3), generator=g, device="cuda"),
             "labels": torch.arange(B, device="cuda") % 2,
             "valid": torch.arange(B, device="cuda") < B - 1}      # one padded clip
    cw = torch.tensor([0.8, 1.2], device="cuda")

    def loss_fn(logits, labels, sample_mask=None):
        return Loss.cross_entropy_loss(logits, labels, class_weights=cw,
                                       sample_mask=sample_mask)

    def adam():
        return O.build_optimizer("adam", 1e-4, grad_clip=1.0)

    def vit():
        return BackboneDetector("vit_base_patch16_224", compute_dtype=torch.bfloat16,
                                device="cuda", generator=torch.Generator().manual_seed(0))

    paths, f32_paths = {}, {}
    plain = _par_step(torch, A, P, vit, batch, loss_fn, adam)
    gc.collect()
    torch.cuda.empty_cache()
    dp_plan, _ = build_plan(flags, "pretrained", T, device="cuda")
    _require(dp_plan.description == "dp=1", dp_plan.description)
    rec = _par_step(torch, A, P, vit, batch, loss_fn, adam, dp_plan)
    vit_flash = {"K2": 12, "K4": 12}
    _require(rec["dtensor_params"] == 0 and not rec["fsdp_module"],
             f"dp: {rec['dtensor_params']} DTensor parameters")
    paths["parallel_dp"] = _par_compare(smi, "parallel_dp", rec, plain, "bf16", vit_flash,
                                        {"mesh_reduce_grads": 1})
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(device="cuda")
    fsdp_plan = ParallelPlan(mesh=mesh, param_spec_fn=make_fsdp_spec_fn(1), pure_dp=False,
                             description="dp=1,fsdp", batch_multiple=1,
                             mesh_shape={"data": 1, "model": 1})
    rec = _par_step(torch, A, P, vit, batch, loss_fn, adam, fsdp_plan)
    _require(rec["placement_summary"][0] > 0, f"nothing sharded: {rec['placement']}")
    # fully_shard ran: the model is an FSDPModule and each leaf the rule
    # shards is a DTensor through both steps
    _require(rec["fsdp_module"] and rec["dtensor_params"] == rec["placement_summary"][0],
             f"fsdp: FSDPModule {rec['fsdp_module']}, {rec['dtensor_params']} DTensor "
             f"parameters for {rec['placement']}")
    paths["parallel_fsdp"] = _par_compare(smi, "parallel_fsdp", rec, plain, "bf16", vit_flash,
                                          {"mesh_reduce_grads": 1})
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    paths["parallel_ring_fold"], f32_paths["parallel_ring_fold"] = _ring_fold_check(
        torch, A, P, smi)

    # (e) the temporal model over B0, f32: MoE through apply_expert_parallel
    # at G = 1 against the dense MoE, the pipeline at S = 1 against the loop
    tkw = {"d_model": 256, "depth": 4, "num_heads": 4}
    ep_mesh = make_mesh(device="cuda", axis_names=("data", "expert"))
    pp_mesh = make_mesh(device="cuda", axis_names=("data", "stage"))

    def temporal(**kw):
        def build():
            m = TemporalTransformerDetector(
                "efficientnet_b0", device="cuda", generator=torch.Generator().manual_seed(0),
                **tkw, **kw)
            for blk in m.blocks if m.moe_experts else ():
                # capacity = every token: no token overflows, so expert
                # parallelism computes the dense path's function (the drops
                # are held to JAX's in tests/test_torch_port_sp.py)
                blk.mlp.capacity_factor = float(m.moe_experts)
            return m
        return build

    t_flash = {"K2": 4, "K4": 4}
    moe_kw = {"moe_experts": PARALLEL["experts"]}
    dense = _par_step(torch, A, P, temporal(**moe_kw), batch, loss_fn, adam)
    ep_plan = ParallelPlan(mesh=ep_mesh, pure_dp=False, description="dp=1,ep=1x4e",
                           mesh_shape={"data": 1, "expert": 1})
    rec = _par_step(torch, A, P, temporal(**moe_kw, mesh=ep_mesh, expert_axis="expert"),
                    batch, loss_fn, adam, ep_plan)
    paths["parallel_ep"] = _par_compare(smi, "parallel_ep", rec, dense, "f32", t_flash,
                                        {"mesh_reduce_grads": 1,
                                         "expert_parallel": tkw["depth"]})
    del dense
    f32_paths["parallel_ep"] = rec["launches_f32"]
    gc.collect()
    torch.cuda.empty_cache()
    loop = _par_step(torch, A, P, temporal(), batch, loss_fn, adam)
    pp_plan = ParallelPlan(mesh=pp_mesh, pure_dp=False, description="dp=1,pp=1",
                           mesh_shape={"data": 1, "stage": 1},
                           batch_multiple=PARALLEL["pp_microbatches"])
    M = PARALLEL["pp_microbatches"]
    rec = _par_step(torch, A, P, temporal(mesh=pp_mesh, stage_axis="stage",
                                          pp_microbatches=M),
                    batch, loss_fn, adam, pp_plan)
    paths["parallel_pp"] = _par_compare(smi, "parallel_pp", rec, loop, "f32",
                                        {"K2": 4 * M, "K4": 4 * M},
                                        {"mesh_reduce_grads": 1, "pipeline": 1})
    del loop
    f32_paths["parallel_pp"] = rec["launches_f32"]
    gc.collect()
    torch.cuda.empty_cache()
    return paths, f32_paths


def parallel_seq(torch, A, P, smi: str, data: str) -> dict:
    """(c) The temporal model over ViT-B/16 at T = 640, batch 1, on the long
    clips: ``Trainer`` steps under ``build_plan``'s plan for ``--seq ring``
    and ``--seq ulysses`` (a world of one: seq_par 1, no cls token) against
    the no-plan steps of the same model and weights (:func:`_first_steps`),
    the ring's fold and block gradients or Ulysses' all-to-alls counted in
    each block. Returns the launches by path."""
    import argparse

    from deepfake_video_detection_tpu_torch.data.dataset import VideoFacesDataset
    from deepfake_video_detection_tpu_torch.parallel.strategy import build_plan
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train.trainer import Trainer, TrainerConfig

    T = LONG["train_frames"]
    ds = VideoFacesDataset(data, num_frames=T)
    tkw = {k: LONG[k] for k in ("d_model", "depth", "num_heads")}
    cfg = TrainerConfig(out_dir=os.path.join(os.path.dirname(data), "sp"), epochs=1,
                        batch_size=1, num_frames=T, lr=1e-4, optimizer="adam",
                        grad_clip=1.0, augment=False)
    batch, recs, paths = None, {}, {}
    for name in ("plain", "ring", "ulysses"):
        plan, kw = None, {"use_cls": False}
        if name != "plain":
            plan, kw = build_plan(argparse.Namespace(
                mesh=None, fsdp=False, seq=name, seq_par=1, pp_stages=1, pp_microbatches=2,
                moe_experts=0, expert_par=0), "temporal", T, depth=LONG["depth"],
                device="cuda")
            _require(plan.description == f"dp=1,sp=1({name})" and kw["use_cls"] is False,
                     f"{name} plan: {plan.description} {kw}")
        model, _, _ = cli.build_model("temporal", T, backbone=LONG["backbone"], bf16=True,
                                      device="cuda", temporal_kwargs={**tkw, **kw})
        trainer = Trainer(model, ds, ds, cfg, plan=plan, device="cuda")
        if batch is None:
            batch = next(iter(trainer._device_batches(ds, True)))
            batch.pop("paths", None)
            batch = trainer._prep_train(batch, None)
        state = trainer.init_state()
        step = trainer.train_step

        def gen():
            return torch.Generator(device="cuda").manual_seed(2)

        rec = {}
        _first_steps(torch, A, P, step, state, batch, gen, rec)
        _require_split_route(A, f"sequence-parallel {name}")
        bd = _kernel_breakdown(torch, lambda: step(state, batch, gen()), top=5)
        rec.update(step_ms=bd["events_ms"], device_ms=bd["device_ms"],
                   idle_share=bd["idle_share"], kernel_launches=bd["launches"])
        recs[name] = rec
        if name != "plain":
            paths[f"parallel_{name}"] = _par_compare(
                smi, f"parallel_sp_{name}", rec, recs["plain"], "bf16",
                {"K2": 12, "K3": LONG["depth"], "K4": 12, "K5": LONG["depth"],
                 "K6": LONG["depth"]},
                {"mesh_reduce_grads": 1,
                 **({"ring_fold": LONG["depth"], "ring_block_grads": LONG["depth"]}
                    if name == "ring" else {"ulysses_all_to_all": 4 * LONG["depth"]})})
        del model, trainer, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def _group_metrics(ms: list) -> dict:
    """k steps' metrics reduced as ``make_multi_step`` reduces them."""
    count = sum(int(m["count"]) for m in ms)
    return {"loss": sum(float(m["loss"]) * int(m["count"]) for m in ms) / max(count, 1),
            "grad_norm": float(ms[-1]["grad_norm"]), "count": count}


def _multi_step_case(torch, A, P, smi: str, name: str, build, dtype: str) -> dict:
    """``make_multi_step`` at k over one stacked group against k
    ``make_train_step`` calls on the same k batches from the same weights
    (augment and dropout off; the batches sent to the card as the trainer
    sends them: one transfer a group, or one a batch): the group's loss,
    the last grad norm and the update (``PAR_TOL``), ms per optimizer step,
    peak memory and launches per step of each path. Returns the multi-step
    path's launches."""
    from deepfake_video_detection_tpu_torch.data.loader import batch_to_device
    from deepfake_video_detection_tpu_torch.data.normalize import imagenet_normalize
    from deepfake_video_detection_tpu_torch.train import losses as Loss
    from deepfake_video_detection_tpu_torch.train import optim as O
    from deepfake_video_detection_tpu_torch.train.state import TrainState
    from deepfake_video_detection_tpu_torch.train.steps import make_multi_step, make_train_step

    k, B, T, size = (MULTI_STEP[key] for key in ("k", "clips", "frames", "size"))
    rng = np.random.default_rng(3)
    batches = [{"frames": rng.integers(0, 256, (B, T, size, size, 3), dtype=np.uint8),
                "labels": (np.arange(B) + i) % 2,
                "valid": np.arange(B) < B - int(i == k - 1)} for i in range(k)]
    group = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
    cw = torch.tensor([0.8, 1.2], device="cuda")

    def loss_fn(logits, labels, sample_mask=None):
        return Loss.cross_entropy_loss(logits, labels, class_weights=cw,
                                       sample_mask=sample_mask)

    def prep(b, _gen):
        return dict(b, frames=imagenet_normalize(b["frames"]))

    recs = {}
    for path in ("single", "multi"):
        model = build()
        opt = O.build_optimizer("adam", 1e-4, grad_clip=1.0)
        state = TrainState.create(model, opt)
        step = make_train_step(model, opt, loss_fn)
        multi = make_multi_step(model, opt, loss_fn, k, prep=prep)

        def call(state):
            if path == "multi":
                return multi(state, batch_to_device(group, "cuda"))
            ms = []
            for b in batches:
                state, m = step(state, prep(batch_to_device(b, "cuda"), None))
                ms.append(m)
            return state, _group_metrics(ms)

        before = _full_params(state.params)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(A, P)
        state, m = call(state)
        torch.cuda.synchronize()
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "count": int(m["count"]), "steps": state.step,
               "optimizer_count": state.opt_state["count"],
               "launches": _counts(A, P),
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        after = _full_params(state.params)
        # on the host: the other path's peak must not count this one's update
        rec["update"] = {n: (after[n] - before[n]).cpu() for n in before}
        del before, after
        t = time.perf_counter()
        for _ in range(MULTI_STEP["timed_calls"]):
            state, m = call(state)
        float(m["loss"])
        rec["ms_per_step"] = (time.perf_counter() - t) / (MULTI_STEP["timed_calls"] * k) * 1e3
        recs[path] = rec
        del model, opt, state, step, multi
        gc.collect()
        torch.cuda.empty_cache()
    single, mult = recs["single"], recs["multi"]
    a, b = mult.pop("update"), single.pop("update")
    diffs = {"loss": abs(mult["loss"] - single["loss"]) / abs(single["loss"]),
             "grad_norm": abs(mult["grad_norm"] - single["grad_norm"]) / single["grad_norm"],
             "update": math.sqrt(sum(float(torch.sum(torch.square(a[n] - b[n]))) for n in b))
             / math.sqrt(sum(float(torch.sum(torch.square(b[n]))) for n in b))}
    for key, d in diffs.items():
        _require(d <= PAR_TOL[key], f"multi_step {name}: {key} differs by {d} > "
                 f"{PAR_TOL[key]} (multi {mult.get(key)}, single {single.get(key)})")
    _require(mult["steps"] == mult["optimizer_count"] == k,
             f"multi_step {name}: {mult['steps']} steps, optimizer count "
             f"{mult['optimizer_count']}, not {k}")
    _require(mult["count"] == single["count"] == k * B - 1,
             f"multi_step {name}: counted {mult['count']} and {single['count']} clips")
    flash = MULTI_STEP["flash"][name]
    for path, rec in recs.items():
        got = {key: rec["launches"][key] for key in ("K2", "K4")}
        _require(got == {key: flash * k for key in got},
                 f"multi_step {name} {path}: flash launches {got}, not {flash} a step")
    per_step = {key: mult["launches"][key] / k for key in ("K2", "K4")}
    _emit({"phase": f"multi_step_{name}", "card": smi, "dtype": dtype, "k": k,
           "batch": [B, T, size], **{f"{key}_rel_diff": v for key, v in diffs.items()},
           "tol": {key: PAR_TOL[key] for key in diffs},
           "ms_per_step": {"multi": mult["ms_per_step"], "single": single["ms_per_step"]},
           "max_memory_allocated_bytes": {"multi": mult["max_memory_allocated_bytes"],
                                          "single": single["max_memory_allocated_bytes"]},
           "group_bytes": int(group["frames"].nbytes), "launches_per_step": per_step,
           "multi": mult, "single": single})
    print(f"multi_step {name}: {mult['ms_per_step']:.2f} ms a step (single "
          f"{single['ms_per_step']:.2f}), peak "
          f"{mult['max_memory_allocated_bytes'] / 2**30:.2f} GiB "
          f"({single['max_memory_allocated_bytes'] / 2**30:.2f}) on {smi}", flush=True)
    return mult["launches"]


def _multi_step_cli(torch, smi: str) -> dict:
    """``train/cli.py --steps_per_call k`` for one epoch (B0, the CLI's
    ``pretrained`` default): a training split of 19 clips in batches of 4,
    one group of 4 and the tail of 3 alone; exit 0, one multi-step call,
    the checkpoint's step is 5."""
    import shutil
    import tempfile

    from deepfake_video_detection_tpu_torch.checkpoint.bridge import load_checkpoint
    from deepfake_video_detection_tpu_torch.train import cli
    from deepfake_video_detection_tpu_torch.train import trainer as trainer_mod

    root = tempfile.mkdtemp(prefix="dfdt_multistep_")
    try:
        data, out = os.path.join(root, "faces"), os.path.join(root, "run")
        os.makedirs(data)
        _write_faces(data, MULTI_STEP["cli_clips"], MULTI_STEP["frames"], MULTI_STEP["size"])
        calls = []
        orig = trainer_mod.make_multi_step

        def counted(*args, **kwargs):
            multi = orig(*args, **kwargs)

            def call(*a, **kw):
                calls.append(1)
                return multi(*a, **kw)
            return call

        t = time.perf_counter()
        with mock.patch.object(trainer_mod, "make_multi_step", counted):
            rc = cli.main(["--data_dir", data, "--model", "pretrained", "--epochs", "1",
                           "--batch_size", str(MULTI_STEP["cli_batch"]),
                           "--num_frames", str(MULTI_STEP["frames"]),
                           "--steps_per_call", str(MULTI_STEP["k"]), "--out_dir", out])
        wall = time.perf_counter() - t
        _require(rc == 0, f"cli --steps_per_call: exit {rc}")
        _require(len(calls) == 1, f"cli --steps_per_call: {len(calls)} multi-step calls")
        _, meta = load_checkpoint(os.path.join(out, "checkpoint_best.npz"))
        _require(meta["step"] == 5, f"cli --steps_per_call: step {meta['step']}, not 5")
        rec = {"phase": "multi_step_cli", "card": smi, "model": "efficientnet_b0",
               "steps_per_call": MULTI_STEP["k"], "train_clips": 19,
               "batch": MULTI_STEP["cli_batch"], "steps": meta["step"], "wall_s": wall}
        _emit(rec)
        return rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def multi_step(torch, A, P, smi: str):
    """The multi-step phase: ViT-B/16 (bf16) and B0 (f32, no flash call)
    at the CLI's batch, then the CLI flag. Returns launches by path."""
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector

    def vit():
        return BackboneDetector("vit_base_patch16_224", dropout_rate=0.0,
                                compute_dtype=torch.bfloat16, device="cuda",
                                generator=torch.Generator().manual_seed(0))

    def b0():
        m = BackboneDetector("efficientnet_b0", dropout_rate=0.0, device="cuda",
                             generator=torch.Generator().manual_seed(0))
        m.backbone.drop_path_rate = 0.0
        return m

    paths = {"multi_step_vit": _multi_step_case(torch, A, P, smi, "vit", vit, "bf16"),
             "multi_step_b0": _multi_step_case(torch, A, P, smi, "b0", b0, "f32")}
    _multi_step_cli(torch, smi)
    return paths


def _concurrent(fn, n: int, what: str):
    """``fn(i)`` on ``n`` threads released together: (results, wall s)."""
    out, barrier = [None] * n, threading.Barrier(n)

    def client(i):
        barrier.wait()
        out[i] = fn(i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    _require(not any(th.is_alive() for th in threads), f"a concurrent {what} request hung")
    return out, time.perf_counter() - t


def _serve_dp_model(torch, A, P, smi: str, name: str, build, devices, clients) -> dict:
    """One model served by a Predictor over ``devices`` (None: every
    visible card, as ``device="cuda"`` with ``SERVE_DP=1`` gives) against a
    Predictor on card 0 alone: the same clips from each client count
    (median clips/s of ``ROUNDS`` rounds) and a windowed request of
    ``SERVE_DP["windows"]`` windows. Gates: ``prob_fake`` of every request and window within
    ``PROB_TOL`` of the one-card Predictor's, every bucket a multiple of
    the replicas, each replica's shards each one K1 launch, K1 on every
    card. Returns the launches of both Predictors' requests."""
    from deepfake_video_detection_tpu_torch.serve.predict import Predictor

    T, size, W = SERVE_DP["frames"], SERVE_DP["size"], SERVE_DP["windows"]
    os.environ.update({"MAX_FRAMES": str(T), "SERVE_WINDOWS": "1", "FACE_SIZE": str(size),
                       "SERVE_MICROBATCH": "1", "SERVE_DP": "1"})
    rng = np.random.default_rng(4)
    faces = [rng.integers(0, 256, (T, size, size, 3), dtype=np.uint8)
             for _ in range(max(clients))]
    long_clip = rng.integers(0, 256, (W * T, size, size, 3), dtype=np.uint8)
    depth = {"vit": 12, "b0": 0}[name]
    recs, total = {}, {k: 0 for k in ("K1", "K1-YUV", "K2", "K3", "K4", "K5", "K6")}
    for label in ("one_card", "replicas"):
        t0 = time.perf_counter()
        if label == "one_card":
            pred = Predictor(build(), None, "pretrained", device="cuda:0")
        else:
            pred = Predictor(build(), None, "pretrained", devices=devices)
        _require(pred.warmup_done.wait(timeout=600), f"serve_dp {name} {label}: no warmup")
        _require(pred.warmup_error is None,
                 f"serve_dp {name} {label}: warmup failed: {pred.warmup_error!r}")
        n_dp = max(1, len(pred._replicas))
        buckets = pred._batcher.bucket_sizes()
        _require(all(b % n_dp == 0 for b in buckets),
                 f"serve_dp {name}: buckets {buckets} over {n_dp} replicas")
        if label == "replicas":
            _require(n_dp == (len(devices) if devices else torch.cuda.device_count()) > 1,
                     f"serve_dp {name}: {n_dp} replicas")
        rec = {"replicas": n_dp, "devices": [str(r.device) for r in pred._replicas]
               or [str(pred.device)], "buckets": buckets,
               "setup_s": time.perf_counter() - t0, "clips_per_s": {}, "prob_fake": {}}
        _reset_counts(A, P)
        shards0 = [r.batches for r in pred._replicas]
        steps0 = pred._batcher.batches_run
        for n in clients:
            walls = []
            for _ in range(ROUNDS):
                res, sec = _concurrent(
                    lambda i: pred.predict_faces(faces[i], video_id=f"c{i}"), n,
                    f"serve_dp {name}")
                walls.append(sec)
                for i, r in enumerate(res):
                    _check_result(r, T, f"serve_dp {name} {label} client {i}")
            rec["clips_per_s"][n] = n / float(np.median(walls))
            rec["prob_fake"][n] = [r["prob_fake"] for r in res]
        win = pred._predict_pretrained(long_clip, "windows", windows=W)
        _check_result(win, T, f"serve_dp {name} {label} windowed request")
        _require(win.get("windows", {}).get("count") == W,
                 f"serve_dp {name}: windows {win.get('windows')}")
        rec["windows_prob_fake"] = win["windows"]["prob_fake"]
        torch.cuda.synchronize()
        c = _counts(A, P)
        for key in total:
            total[key] += c[key]
        rec["launches"] = c
        rec["k1_by_card"] = dict(P.fused_normalize.launches_by_device)
        rec["k2_by_card"] = dict(A.flash_attention_fwd.launches_by_device)
        steps = pred._batcher.batches_run - steps0
        if label == "replicas":
            shards = [r.batches - s for r, s in zip(pred._replicas, shards0)]
            rec["shards_by_replica"] = shards
            # each batcher step and the windowed scan give each replica a shard
            _require(shards == [steps + 1] * n_dp,
                     f"serve_dp {name}: shards {shards} for {steps} batcher steps")
            _require(c["K1"] == sum(shards) and c["K2"] == depth * sum(shards),
                     f"serve_dp {name}: launches {c} for shards {shards}")
            cards = {r.device.index for r in pred._replicas}
            _require(all(rec["k1_by_card"].get(i, 0) > 0 for i in cards),
                     f"serve_dp {name}: K1 by card {rec['k1_by_card']}")
        else:
            _require(c["K1"] == steps + 1 and c["K2"] == depth * (steps + 1),
                     f"serve_dp {name} one card: launches {c} for {steps} steps")
        rec["batcher_steps"] = steps
        pred.close()
        del pred
        gc.collect()
        torch.cuda.empty_cache()
        recs[label] = rec
    one, dp = recs["one_card"], recs["replicas"]
    diffs = [abs(a - b) for n in clients for a, b in zip(dp["prob_fake"][n], one["prob_fake"][n])]
    diffs += [abs(a - b) for a, b in zip(dp["windows_prob_fake"], one["windows_prob_fake"])]
    _require(max(diffs) <= PROB_TOL,
             f"serve_dp {name}: prob_fake differs by {max(diffs)} from one card")
    _emit({"phase": f"serve_dp_{name}", "card": smi, "frames_per_clip": T, "clients": clients,
           "windows": W, "prob_fake_max_abs_diff": max(diffs), "prob_tol": PROB_TOL,
           "replicas": dp, "one_card": one})
    for n in clients:
        print(f"serve_dp {name}: {n} clients {dp['clips_per_s'][n]:.1f} clips/s over "
              f"{dp['replicas']} replicas ({one['clips_per_s'][n]:.1f} on one card), K1 by "
              f"card {dp['k1_by_card']}", flush=True)
    return total


def serve_dp(torch, A, P, smi: str, devices=None, clients=(8,)):
    """Serving data parallelism for B0 and ViT-B/16 (bf16, random weights,
    B0's BN statistics from U(0.5, 1.5)): :func:`_serve_dp_model` for each.
    Returns launches by path."""
    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.serve.predict import serving_dtype

    dtype = serving_dtype("cuda")

    def b0():
        m = BackboneDetector("efficientnet_b0", compute_dtype=dtype, device="cuda",
                             generator=torch.Generator().manual_seed(0))
        _randomize_bn(torch, m, CONV["bn_seed"])
        return m

    def vit():
        return BackboneDetector("vit_base_patch16_224", compute_dtype=dtype, device="cuda",
                                generator=torch.Generator().manual_seed(0))

    return {f"serve_dp_{name}": _serve_dp_model(torch, A, P, smi, name, build, devices,
                                                clients)
            for name, build in (("b0", b0), ("vit", vit))}


def serve_dp_cards() -> int:
    """``python3 chip_smoke.py serve_dp``: the Predictors over every visible
    card (``device="cuda"`` with ``SERVE_DP=1``) against card 0 alone,
    under 8 and 32 clients. Exits 2 with fewer than two cards."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_smoke serve_dp: needs at least two cards, found {n}", file=sys.stderr)
        return 2
    from deepfake_video_detection_tpu_torch.ops import _build
    from deepfake_video_detection_tpu_torch.ops import attention as A
    from deepfake_video_detection_tpu_torch.ops import preprocess as P

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    print(smi, flush=True)
    t = time.perf_counter()
    _build.build_all()
    paths = serve_dp(torch, A, P, smi, devices=None, clients=SERVE_DP["clients_cards"])
    _emit({"phase": "serve_dp_cards", "cards": n, "seconds": time.perf_counter() - t,
           "launches": paths})
    print(_smi(), flush=True)
    _emit({"ok": True, "serve_dp": True,
           "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}})
    return 0


def long_clips(torch, A, P, smi: str, device: str = "cuda"):
    """The long-clip phases on one synthetic set; returns launches by path."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="dfdt_long_")
    try:
        data, out = os.path.join(root, "faces"), os.path.join(root, "run")
        os.makedirs(data)
        t = time.perf_counter()
        _write_faces(data, LONG["clips"], LONG["frames"], LONG["size"])
        print(f"  wrote {LONG['clips']} clips of {LONG['frames']} frames in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        trained, _ = train_long(torch, A, P, smi, data, out, device)
        gc.collect()
        torch.cuda.empty_cache()
        ckpt = os.path.join(out, "checkpoint_best.npz")
        evaluated, _, model = evaluate_long(torch, A, P, smi, data, ckpt, device)
        first = os.path.join(data, sorted(os.listdir(data))[0])
        faces = np.load(first)["faces"][:LONG["serve_frames"]]
        served, _ = serve_long(torch, A, P, model, ckpt, faces, device)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return {"long_training": trained, "long_evaluation": evaluated,
                "long_serving": served, **parallel_seq(torch, A, P, smi, data)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _summary_entry(name, source, replaces, main, launches, tol):
    return {"name": name, "route": "cuda", "kernel_route": main.get("route", "cuda-core"),
            "splits": main.get("splits", 1),
            "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": main["max_abs_err"], "tol": tol,
            "ms": main["kernel_ms"], "device_ms": main.get("kernel_device_ms"),
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_device_ms": main.get("library_device_ms"), "shape": main["shape"]}


# ``python chip_smoke.py multi`` under ``torchrun --nproc_per_node 4``: every
# multi-device mode across four cards over NCCL, each step against the
# no-plan step on the whole global batch, which every rank also computes on
# its own card. SGD (linear in the gradient), dropout and drop-path off, so
# the two compute one function; the batch is split at other places, so the
# gates are the kernel-vs-plain step gates of its dtype (``MULTI_TOL``).
# ``--device cpu --small``: the same over gloo at the CPU tests' sizes.
MULTI_TOL = {"bf16": {"loss": STEP_TOL_LOSS, "grad_norm": STEP_TOL_NORM},
             "f32": {"loss": F32_STEP_TOL_LOSS, "grad_norm": F32_STEP_TOL_NORM}}
MULTI_MODES = (
    # (name, model, flags, dtype)
    ("dp", "vit", {"mesh": "data=4"}, "bf16"),
    ("fsdp", "vit", {"fsdp": True}, "bf16"),
    ("tp", "b0", {"mesh": "data=2,model=2"}, "f32"),
    ("fsdp_tp", "b0", {"mesh": "data=2,model=2", "fsdp": True}, "f32"),
    ("ring", "seq", {"seq": "ring", "seq_par": 4}, "f32"),
    ("ulysses", "seq", {"seq": "ulysses", "seq_par": 4}, "f32"),
    ("ep4", "moe", {"moe_experts": 4, "expert_par": 4}, "f32"),
    ("ep2", "moe", {"moe_experts": 4, "expert_par": 2}, "f32"),
    ("pp2", "temporal", {"pp_stages": 2, "pp_microbatches": 2}, "f32"),
    ("pp4", "temporal", {"pp_stages": 4, "pp_microbatches": 2}, "f32"),
)


def multi_card(argv) -> int:
    """Each of ``MULTI_MODES`` at this run's world (four ranks) against the
    no-plan step: the first step's loss, grad norm and update (‖Δ_plan −
    Δ‖ / ‖Δ‖ over every parameter, FSDP2's shards and the pipeline stages'
    blocks gathered), batch norm's running statistics, the second step's
    loss, and on the card the flash launches and the step's time beside the
    no-plan step's on the whole batch. Each rank's parameter count before
    and after the placement; under the pipelines also the step with every
    block kept on every stage (the placement before stage-local blocks:
    its parameters and peak memory). Then ``dp_k2``: ``make_multi_step`` at
    k = 2 under the ViT-B/16 DP plan against two whole-batch steps."""
    import argparse

    import torch
    import torch.distributed as dist

    from deepfake_video_detection_tpu_torch.models.backbone_detector import BackboneDetector
    from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
        TemporalTransformerDetector)
    from deepfake_video_detection_tpu_torch.models.vit import VisionTransformer
    from deepfake_video_detection_tpu_torch.ops import attention as A
    from deepfake_video_detection_tpu_torch.parallel.mesh import init_world, shard_batch
    from deepfake_video_detection_tpu_torch.parallel.strategy import (
        ParallelRuntime, build_plan, place_model, placement_line)
    from deepfake_video_detection_tpu_torch.train import losses as Loss
    from deepfake_video_detection_tpu_torch.train import optim as O
    from deepfake_video_detection_tpu_torch.train.state import TrainState
    from deepfake_video_detection_tpu_torch.train.steps import make_multi_step, make_train_step

    ap = argparse.ArgumentParser(prog="chip_smoke.py multi")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--modes", default=",".join([m[0] for m in MULTI_MODES] + ["dp_k2"]))
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    init_world(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    _require(world == 4, f"the multi-card check runs four ranks, not {world}")
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    smi = _smi() if cuda else "cpu"
    if rank == 0:
        print(smi, flush=True)
    small = args.small
    # full width on the card: ViT-B/16 (bf16), B0 (f32), the temporal model
    # (d_model 256, 4 blocks, 4 heads) over B0; the CPU tests' sizes with --small
    px = {"vit": 32 if small else 224, "b0": 48 if small else 224,
          "temporal": 16 if small else 224}
    tkw = {"d_model": 16, "depth": 4, "num_heads": 4} if small else \
        {"d_model": 256, "depth": 4, "num_heads": 4}
    tkw["dropout_rate"] = 0.0
    t_backbone = "tinyconv" if small else "efficientnet_b0"
    # clips x frames of each family's global batch; the last clip padded
    shapes = {"vit": (8, 2 if small else 16), "b0": (8, 2 if small else 4),
              "seq": (2, 16 if small else 64), "moe": (8, 4 if small else 16),
              "temporal": (8, 4 if small else 16)}

    def build(family, kw, dtype):
        g = torch.Generator().manual_seed(0)
        if family == "vit":
            m = BackboneDetector("vit_tiny_patch16_224" if small else "vit_base_patch16_224",
                                 dropout_rate=0.0, device=dev, generator=g,
                                 compute_dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
            if small:
                m.backbone = VisionTransformer("vit_tiny_patch16_224", img_size=32, depth=2,
                                               device=dev)
            return m
        if family == "b0":
            m = BackboneDetector("efficientnet_b0", dropout_rate=0.0, device=dev, generator=g)
            m.backbone.drop_path_rate = 0.0
            return m
        m = TemporalTransformerDetector(t_backbone, device=dev, generator=g, **tkw, **kw)
        if hasattr(m.backbone, "drop_path_rate"):
            m.backbone.drop_path_rate = 0.0
        for blk in m.blocks if m.moe_experts else ():
            blk.mlp.capacity_factor = float(m.moe_experts)   # no token overflows
        return m

    def run(model, batch, runtime):
        """Two SGD steps: (loss, grad norm, update, BN stats, loss2, launches, ms)."""
        opt = O.build_optimizer("sgd", 1e-2, grad_clip=1.0)
        cw = torch.tensor([0.8, 1.2], device=dev)
        step = make_train_step(model, opt, lambda lg, lb, sample_mask=None:
                               Loss.cross_entropy_loss(lg, lb, class_weights=cw,
                                                       sample_mask=sample_mask),
                               runtime=runtime)
        state = TrainState.create(model, opt)
        before = whole(state.params, runtime)
        _reset_flash(A)
        state, m = step(state, batch)
        launches = {"fwd": A.flash_attention_fwd.launches, "bwd": A.flash_attention_bwd.launches}
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "launches": launches}
        after = whole(state.params, runtime)
        update = {n: after[n] - before[n] for n in before}
        stats = {n: b.detach().float().clone() for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
        del before, after
        state, m = step(state, batch)
        rec["loss2"] = float(m["loss"])
        if cuda:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(3):
                state, m = step(state, batch)
            float(m["loss"])
            rec["step_ms"] = (time.perf_counter() - t) / 3 * 1e3
            rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        return rec, update, stats

    def whole(params, runtime):
        """Every parameter whole: FSDP2's shards and the stages' blocks."""
        full = _full_params(params)
        return runtime.gather_stages(full) if runtime is not None else full

    def rel_l2(a, b):
        num = math.sqrt(sum(float(torch.sum(torch.square(a[n].to(b[n].device) - b[n])))
                            for n in b))
        den = math.sqrt(sum(float(torch.sum(torch.square(b[n]))) for n in b))
        return num / den if den > 0 else 0.0

    def held(model):
        """(parameters, block parameters) this rank holds."""
        return (sum(p.numel() for p in model.parameters()),
                sum(p.numel() for n, p in model.named_parameters() if n.startswith("blocks.")))

    wanted = set(args.modes.split(","))
    for name, family, flags, dtype in MULTI_MODES:
        if name not in wanted:
            continue
        B, T = shapes[family]
        size = px["temporal" if family in ("seq", "moe", "temporal") else family]
        g = torch.Generator().manual_seed(7)
        batch = {"frames": torch.randn((B, T, size, size, 3), generator=g).to(dev),
                 "labels": (torch.arange(B) % 2).to(dev),
                 "valid": (torch.arange(B) < B - 1).to(dev)}
        model_type = "pretrained" if family in ("vit", "b0") else "temporal"
        plan, kw = build_plan(argparse.Namespace(**{**dict(
            mesh=None, fsdp=False, seq="none", seq_par=1, pp_stages=1, pp_microbatches=2,
            moe_experts=0, expert_par=0), **flags}), model_type, T,
            depth=tkw["depth"] if model_type == "temporal" else None, device=args.device)
        # the reference: no plan, the whole batch, this rank's card
        ref_kw = {k: v for k, v in kw.items()
                  if k in ("moe_experts", "use_cls", "pp_microbatches")}
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ref, ref_update, ref_stats = run(build(family, ref_kw, dtype), batch, None)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model = build(family, kw, dtype)
        # before the placement every rank holds the whole model; after it,
        # a pipeline stage holds its own blocks (FSDP2 counts whole tensors)
        n_params, n_blocks = held(model)
        summary = place_model(model, plan.mesh, plan.param_spec_fn)
        n_held, n_blocks_held = held(model)
        stages = plan.mesh_shape.get("stage", 1)
        rt = ParallelRuntime(plan.mesh)
        local = shard_batch(batch, plan.mesh, specs=plan.batch_spec)
        rec, update, stats = run(model, local, rt)
        diffs = {"loss": abs(rec["loss"] - ref["loss"]) / abs(ref["loss"]),
                 "grad_norm": abs(rec["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                 "update": rel_l2(update, ref_update),
                 "loss2": abs(rec["loss2"] - ref["loss2"]) / abs(ref["loss2"])}
        if ref_stats:
            diffs["bn_stats"] = rel_l2(stats, ref_stats)
        tol = MULTI_TOL[dtype]
        gate = {"loss": tol["loss"], "grad_norm": tol["grad_norm"], "update": tol["grad_norm"],
                "loss2": tol["loss"], "bn_stats": tol["loss"]}
        line = {"phase": f"multi_{name}", "card": smi, "world": world,
                "backend": dist.get_backend(), "rank": rank, "plan": plan.description,
                "placement": placement_line(plan, summary), "dtype": dtype,
                "batch": [B, T, size], "params": n_params, "block_params": n_blocks,
                "params_held": n_held, "block_params_held": n_blocks_held,
                **{f"{k}_rel_diff": v for k, v in diffs.items()},
                "tol": {k: gate[k] for k in diffs}, "plan_step": rec, "no_plan_step": ref}
        bad = [k for k, v in diffs.items() if not v <= gate[k]]
        if n_blocks_held != n_blocks // stages or n_held != n_params - n_blocks + n_blocks_held:
            bad.append(f"holds {n_held} parameters, {n_blocks_held} in blocks")
        if cuda and family != "b0" and not (rec["launches"]["fwd"] and rec["launches"]["bwd"]):
            bad.append("no flash launch")
        del model, rt, update
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        if stages > 1:
            # the placement before stage-local blocks, for its memory: every
            # stage holds, updates and all-reduces every block
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            with mock.patch.object(TemporalTransformerDetector, "keep_stage_blocks",
                                   lambda self: None), \
                    mock.patch.object(ParallelRuntime, "stage_local", lambda self, n: False):
                kept = build(family, kw, dtype)
                place_model(kept, plan.mesh, plan.param_spec_fn)
                kept_rec, _, _ = run(kept, local, ParallelRuntime(plan.mesh))
            line["all_blocks_kept"] = {"params_held": held(kept)[0], **{
                k: kept_rec.get(k) for k in ("loss", "grad_norm", "loss2", "step_ms",
                                             "max_memory_allocated_bytes")}}
            if abs(kept_rec["loss2"] - rec["loss2"]) > tol["loss"] * abs(rec["loss2"]):
                bad.append("the step with every block kept differs")
            del kept, kept_rec
        flags_ok = torch.tensor([float(bool(bad))], device=dev)
        dist.all_reduce(flags_ok)
        if rank == 0 or bad:
            _emit(line)
        _require(float(flags_ok) == 0, f"multi {name}: {bad or 'another rank failed'}")
        del ref_update
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    if "dp_k2" in wanted:
        _multi_dp_steps_per_call(torch, args, dev, smi, build, shapes["vit"], px["vit"])
    dist.barrier()
    if rank == 0:
        _emit({"ok": True, "multi": True, "world": world, "backend": dist.get_backend(),
               "device": {"platform": "gpu" if cuda else "cpu",
                          "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                          "count": torch.cuda.device_count() if cuda else 0}})
    dist.destroy_process_group()
    return 0


def _multi_dp_steps_per_call(torch, args, dev, smi: str, build, shape, size) -> None:
    """``--steps_per_call 2`` under the ViT-B/16 DP plan (``--mesh
    data=4``): one ``make_multi_step`` call over this rank's rows of two
    batches (each with a padded clip) against two steps on the whole
    batches on this rank's card, SGD: the group's loss, the last grad
    norm and the update within ``MULTI_TOL``, 12 forward and 12 backward
    flash launches a step, ms per optimizer step of each."""
    import argparse

    import torch.distributed as dist

    from deepfake_video_detection_tpu_torch.ops import attention as A
    from deepfake_video_detection_tpu_torch.parallel.mesh import shard_batch
    from deepfake_video_detection_tpu_torch.parallel.strategy import (
        ParallelRuntime, build_plan, place_model)
    from deepfake_video_detection_tpu_torch.train import losses as Loss
    from deepfake_video_detection_tpu_torch.train import optim as O
    from deepfake_video_detection_tpu_torch.train.state import TrainState
    from deepfake_video_detection_tpu_torch.train.steps import make_multi_step, make_train_step

    cuda = dev.type == "cuda"
    B, T = shape
    g = torch.Generator().manual_seed(11)
    batches = [{"frames": torch.randn((B, T, size, size, 3), generator=g).to(dev),
                "labels": ((torch.arange(B) + i) % 2).to(dev),
                "valid": (torch.arange(B) < B - 1).to(dev)} for i in range(2)]
    plan, _ = build_plan(argparse.Namespace(
        mesh="data=4", fsdp=False, seq="none", seq_par=1, pp_stages=1, pp_microbatches=2,
        moe_experts=0, expert_par=0), "pretrained", T, device=args.device)
    cw = torch.tensor([0.8, 1.2], device=dev)

    def loss_fn(lg, lb, sample_mask=None):
        return Loss.cross_entropy_loss(lg, lb, class_weights=cw, sample_mask=sample_mask)

    recs = {}
    for path in ("whole", "plan"):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model = build("vit", {}, "bf16")
        opt = O.build_optimizer("sgd", 1e-2, grad_clip=1.0)
        if path == "plan":
            place_model(model, plan.mesh, plan.param_spec_fn)
            multi = make_multi_step(model, opt, loss_fn, 2, runtime=ParallelRuntime(plan.mesh))
            local = [shard_batch(b, plan.mesh) for b in batches]
            group = {k: torch.stack([part[k] for part in local]) for k in local[0]}

            def call(st):
                return multi(st, group)
        else:
            step = make_train_step(model, opt, loss_fn)

            def call(st):
                ms = []
                for b in batches:
                    st, m = step(st, b)
                    ms.append(m)
                return st, _group_metrics(ms)

        state = TrainState.create(model, opt)
        before = _full_params(state.params)
        _reset_flash(A)
        state, m = call(state)
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "count": int(m["count"]), "steps": state.step,
               "launches": {"fwd": A.flash_attention_fwd.launches,
                            "bwd": A.flash_attention_bwd.launches}}
        after = _full_params(state.params)
        update = {n: after[n] - before[n] for n in before}
        if cuda:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(2):
                state, m = call(state)
            float(m["loss"])
            rec["ms_per_step"] = (time.perf_counter() - t) / 4 * 1e3
            rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        recs[path] = (rec, update)
        del model, opt, state, before, after
    (rec, update), (ref, ref_update) = recs["plan"], recs["whole"]
    num = math.sqrt(sum(float(torch.sum(torch.square(update[n] - ref_update[n])))
                        for n in ref_update))
    den = math.sqrt(sum(float(torch.sum(torch.square(t))) for t in ref_update.values()))
    diffs = {"loss": abs(rec["loss"] - ref["loss"]) / abs(ref["loss"]),
             "grad_norm": abs(rec["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
             "update": num / den}
    tol = MULTI_TOL["bf16"]
    gate = {"loss": tol["loss"], "grad_norm": tol["grad_norm"], "update": tol["grad_norm"]}
    bad = [k for k, v in diffs.items() if not v <= gate[k]]
    if rec["count"] != ref["count"] or rec["steps"] != 2:
        bad.append(f"counted {rec['count']} clips in {rec['steps']} steps")
    if cuda and rec["launches"] != {"fwd": 24, "bwd": 24}:
        bad.append(f"flash launches {rec['launches']}")
    flag = torch.tensor([float(bool(bad))], device=dev)
    dist.all_reduce(flag)
    if dist.get_rank() == 0 or bad:
        _emit({"phase": "multi_dp_k2", "card": smi, "world": dist.get_world_size(),
               "rank": dist.get_rank(), "plan": plan.description, "steps_per_call": 2,
               "batch": [B, T, size], **{f"{k}_rel_diff": v for k, v in diffs.items()},
               "tol": gate, "plan_step": rec, "no_plan_step": ref})
    _require(float(flag) == 0, f"multi dp_k2: {bad or 'another rank failed'}")


def _reset_flash(A) -> None:
    for f in (A.flash_attention_fwd, A.flash_attention_bwd):
        f.launches = f.launches_long = f.launches_split = f.launches_f32 = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from deepfake_video_detection_tpu_torch.ops import _build
    from deepfake_video_detection_tpu_torch.ops import attention as A
    from deepfake_video_detection_tpu_torch.ops import preprocess as P

    # torch's own TF32 flags, which the training CLIs run with (the
    # convnet_training phase restores them while it runs)
    tf32_defaults = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                     "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    print(smi, flush=True)
    _emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()})
    decoder_probe()

    # one nvcc per source, all started together: the flash libraries compile
    # in a thread while the conv-net phases, which need only K1, run
    t_start = time.perf_counter()
    flash_sources = [s for s in _build.SOURCES if s != "normalize.cu"]
    flash_build = {}

    def build_flash():
        try:
            flash_build["seconds"] = _build.build_all(flash_sources)
        except BaseException as e:  # re-raised in the main thread
            flash_build["error"] = e
        flash_build["done_s"] = time.perf_counter() - t_start

    flash_thread = threading.Thread(target=build_flash, name="flash-build")
    flash_thread.start()
    per_source = _build.build_all(["normalize.cu"])
    phase_s = {"k1_build": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_cases = timed("k1_checks", check_k1, torch, P, gen)
    k1y_cases = timed("k1_yuv_checks", check_k1_yuv, torch, P, gen)
    b0_served, _, b0_model, b0_req = timed("b0_serving", serve_convnet, torch, A, P, smi, False)
    ens_served, _, ens_model, ens_req = timed("ensemble_serving", serve_convnet,
                                              torch, A, P, smi, True)
    loaded, _ = timed("loader_serving", serve_loaded, torch, A, P, b0_model, ens_model,
                      b0_req, ens_req)
    del b0_model, ens_model
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    flash_thread.join()
    phase_s["waited_for_flash_build"] = time.perf_counter() - t
    if "error" in flash_build:
        raise flash_build["error"]
    per_source.update(flash_build["seconds"])
    tc_stats = check_build(_build.build_log)
    _emit({"phase": "build", "seconds": flash_build["done_s"], "per_source": per_source,
           "tensor_core_d64": tc_stats})

    k2_cases = check_k2(torch, A, gen)
    k4_cases = check_k4(torch, A, gen)
    for c in k2_cases + k4_cases:
        if c["note"].startswith(MAIN_NOTES):
            _require(c["dtype"] == "bf16", f"main-path case {c['note']!r} is {c['dtype']}")
        if c["shape"][2] > A._SHORT_MAX and c["dtype"] == "bf16":
            _require(c["splits"] > 1, f"flash {c['shape']} bf16 was not split")
    timed("split_sweep", sweep_splits, torch, A, gen)

    served, _ = timed("vit_serving", serve, torch, A, P, smi)
    _require(all(v > 0 for v in served.values()),
             f"a kernel was not launched on the serving path: {served}")
    explained = timed("explain_int8_serving", explain_int8_serving, torch, A, P, smi)
    gc.collect()
    torch.cuda.empty_cache()
    video_paths = timed("video_serving", video_serving, torch, A, P, smi)
    gc.collect()
    torch.cuda.empty_cache()
    web_paths = timed("web_app", web_app, torch, A, P, smi)
    gc.collect()
    torch.cuda.empty_cache()
    trained, _ = timed("vit_training", train, torch, A, P, smi)
    _require(trained["flash_attention_fwd"] > 0 and trained["flash_attention_bwd"] > 0,
             f"a kernel was not launched on the training path: {trained}")
    gc.collect()
    torch.cuda.empty_cache()
    trained_f32, _ = timed("f32_training", train_f32, torch, A, P, smi)
    gc.collect()
    torch.cuda.empty_cache()
    legacy_paths, legacy_f32 = timed("legacy", legacy, torch, A, P, smi)
    gc.collect()
    torch.cuda.empty_cache()
    convnet_paths, convnet_f32 = timed("convnet_training", convnet_training, torch, A, P,
                                       smi, tf32_defaults)
    gc.collect()
    torch.cuda.empty_cache()
    improved_launches, improved_f32 = timed("improved", improved_paths, torch, A, P, smi,
                                            tf32_defaults)
    gc.collect()
    torch.cuda.empty_cache()
    video_launches, video_f32 = timed("from_videos", from_videos, torch, A, P, smi,
                                      tf32_defaults)
    gc.collect()
    torch.cuda.empty_cache()
    gan_launches, gan_f32 = timed("gan", gan_phase, torch, A, P, smi, tf32_defaults)
    gc.collect()
    torch.cuda.empty_cache()
    par_launches, par_f32 = timed("parallel", parallel, torch, A, P, smi)
    gc.collect()
    torch.cuda.empty_cache()
    multi_launches = timed("multi_step", multi_step, torch, A, P, smi)
    gc.collect()
    torch.cuda.empty_cache()
    dp_launches = timed("serve_dp", serve_dp, torch, A, P, smi,
                        [torch.device("cuda", 0)] * 2)
    gc.collect()
    torch.cuda.empty_cache()
    # f32 launches by path (every other launch is bf16)
    f32_paths = {"f32_training": {"K2": trained_f32["K2"], "K4": trained_f32["K4"]},
                 **legacy_f32, **convnet_f32, **improved_f32, **video_f32, **gan_f32,
                 **par_f32}

    def conv_path(launches):
        return {"K1": launches["fused_normalize"], "K1-YUV": launches["fused_normalize_yuv"]}

    paths = {"b0_serving": conv_path(b0_served),
             "ensemble_serving": conv_path(ens_served),
             "loader_serving": conv_path(loaded),
             "serving": {"K1": served["fused_normalize"],
                         "K1-YUV": served["fused_normalize_yuv"],
                         "K2": served["flash_attention_fwd"]},
             "training": {"K2": trained["flash_attention_fwd"],
                          "K4": trained["flash_attention_bwd"]},
             "f32_training": trained_f32,
             **explained, **video_paths, **web_paths, **legacy_paths, **convnet_paths,
             **improved_launches,
             **video_launches, **gan_launches, **par_launches, **multi_launches,
             **dp_launches, **timed("long_clips", long_clips, torch, A, P, smi)}
    phase_s["total"] = time.perf_counter() - t_start
    _emit({"phase": "seconds", **phase_s})

    case_keys = ("shape", "max_abs_err", "tol", "kernel_ms", "kernel_device_ms", "plain_ms",
                 "library_ms", "library_device_ms", "bound_ms", "bound_by",
                 "bound_ms_cuda_core")

    def entry(kid, name, source, replaces, case, note=None, f32_case=None, legacy_cases=(),
              convnet_cases=(), explain_cases=()):
        by_path = {p: c.get(kid, 0) for p, c in paths.items()}
        e = _summary_entry(name, source, replaces, case, sum(by_path.values()), case["tol"])
        e["id"], e["launches_by_path"] = kid, by_path
        e["tol_kind"] = case.get("tol_kind", "absolute")
        if f32_case is not None:
            # the f32 route's launches beside the bf16 route's
            f32 = sum(c.get(kid, 0) for c in f32_paths.values())
            e["launches_by_route"] = {ROUTES["bf16"]: e["launches"] - f32, ROUTES["f32"]: f32}
            e["f32"] = {k: f32_case.get(k) for k in case_keys}
        # the legacy phase's shapes (3 or 6 heads), the conv-net training
        # phase's (the temporal model over B0: 4 heads, N = 17) and an
        # explain request's backward (ViT-B/16, 8 frames)
        for key, rows in (("legacy", legacy_cases), ("convnet", convnet_cases),
                          ("explain", explain_cases)):
            if rows:
                e[key] = [{"dtype": c["dtype"], "note": c["note"],
                           **{k: c.get(k) for k in case_keys}} for c in rows]
        if note:
            e["note"] = note
        _require(e["launches"] > 0, f"{kid} was launched on no path: {by_path}")
        return e

    k3_case = next(c for c in k2_cases if c["note"].startswith("K3 main"))
    k56_case = next(c for c in k4_cases if c["note"].startswith("K5/K6 main"))

    def f32_row(cases, n):
        return next(c for c in cases if c["note"].startswith(F32_ROW) and c["shape"][2] == n)

    def rows(cases, prefix):
        return [c for c in cases if c["note"].startswith(prefix)]

    both = ("ms is one backward call, both passes; the JAX package trains dense "
            "below N = 4096")
    kernels = [
        entry("K1", "fused_normalize", K1_SOURCE, K1_REPLACES, k1_cases[0]),
        entry("K1-YUV", "fused_normalize_yuv", K1_SOURCE, K1_REPLACES, k1y_cases[0],
              "K1's packed-YUV420 entry: the JAX package has no kernel there (XLA fuses "
              "ops/yuv.py's colour matrix into K1's normalisation)"),
        entry("K2", "flash_attention_fwd", K2_SOURCE, K2_REPLACES, k2_cases[0],
              f32_case=f32_row(k2_cases, 197), legacy_cases=rows(k2_cases, LEGACY_ROW),
              convnet_cases=rows(k2_cases, CONV_ROW)),
        entry("K3", "flash_attention_fwd", K2_SOURCE, K3_REPLACES, k3_case,
              "N > 512: the streaming regime", f32_case=f32_row(k2_cases, 641)),
        entry("K4", "flash_attention_bwd", K4_SOURCE, K4_REPLACES, k4_cases[0],
              f32_case=f32_row(k4_cases, 197), legacy_cases=rows(k4_cases, LEGACY_ROW),
              convnet_cases=rows(k4_cases, CONV_ROW),
              explain_cases=rows(k4_cases, EXPLAIN_ROW)),
        entry("K5", "flash_attention_bwd", K4_SOURCE, K5_REPLACES, k56_case,
              f"dQ pass, N > 512; {both}", f32_case=f32_row(k4_cases, 641)),
        entry("K6", "flash_attention_bwd", K4_SOURCE, K6_REPLACES, k56_case,
              f"dK/dV pass, N > 512; {both}", f32_case=f32_row(k4_cases, 641)),
    ]
    print(_smi(), flush=True)
    _emit({"kernels": kernels})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["multi"]:
            sys.exit(multi_card(sys.argv[2:]))
        if sys.argv[1:] == ["serve_dp"]:
            sys.exit(serve_dp_cards())
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
