"""Multi-process data feeding: each process feeds only its own rows.

Counterpart of ``deepfake_video_detection_tpu/parallel/multihost.py``. JAX
stitches the processes' local arrays into one global array
(``jax.make_array_from_process_local_data``); in torch every process
already holds just its part of the global batch, so the local batch is the
shard and only moves to this rank's device. A world of one is the same call.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.parallel.mesh import local_device, world_size


def global_batch_from_local(batch: Dict[str, Any], mesh=None,
                            axis: str = "data", device: Any = None) -> Dict[str, Any]:
    """This process's slice of the global batch (dim 0) as tensors on its
    device (the mesh's device type when ``device`` is not given); lists
    (paths) pass through."""
    dev = local_device(device if device is not None else
                       (mesh.device_type if mesh is not None else "cuda"))

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    return {k: put(v) for k, v in batch.items()}


def local_batch_size(global_batch_size: int) -> int:
    """Per-process share of the global batch (must divide evenly)."""
    n = world_size()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{n} processes")
    return global_batch_size // n
