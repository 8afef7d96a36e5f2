"""PyTorch / CUDA port of the deepfake video detection framework.

Counterpart of ``deepfake_video_detection_tpu`` (the JAX package, which stays
the reference) for one NVIDIA Hopper card. The module tree and names mirror
the JAX package so each port module sits where its reference does. The port
imports ``torch`` and ``numpy``, never ``jax`` nor the JAX package.

Every Pallas kernel on a ported path has a hand-written CUDA kernel for
``sm_90a`` under ``csrc/``, built by ``nvcc`` at first use (``ops/_build.py``)
and bound with ``ctypes``. Beside each kernel its module keeps a plain
PyTorch version, taken only for tensors that lie on the CPU.

Sub-packages
------------
``utils``       env parsing, dotted-path helpers, device choice
``data``        normalisation, ``.npz`` face-stack dataset, loader with
                device prefetch, on-device augmentation, video decoding,
                face extraction (Haar, MTCNN), dataset preparation and
                the direct-from-video dataset
``ops``         the kernels' wrappers (fused normalize, flash forward and
                backward as one autograd Function), YUV420
``nn``          initialisers on a ``torch.Generator``, functional layers
``models``      the detectors' backbones and heads, the MTCNN cascade
``checkpoint``  JAX trees / native ``.npz`` checkpoints ↔ ``state_dict``
``train``       losses, optimizer, train/eval steps, ``Trainer``, CLI
``evals``       classification metrics and the threshold sweep
``serve``       ``Predictor`` and the request micro-batcher
"""

__version__ = "0.1.0"
