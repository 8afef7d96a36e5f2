"""One reader for every checkpoint the port serves, and the ``.pt`` writer.

Counterpart of ``deepfake_video_detection_tpu/checkpoint/store.py``'s
``load_any`` and ``save_torch_checkpoint``. :func:`load_any`: a native
``.npz`` (the JAX package's store, read by ``checkpoint.bridge``) or any of
the reference's three ``.pt`` layouts (``checkpoint.torch_bridge``) becomes
``(flat torch-layout state dict of numpy arrays, meta)``, the common
currency of ``serve/loader.py``. The ``.npz`` is told by its name or by its
content (a zip that holds the meta blob). :func:`save_torch_checkpoint`
writes a port model's ``state_dict`` in one of those layouts.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.checkpoint.bridge import (
    _META_KEY, load_checkpoint, state_dict_from_jax)
from deepfake_video_detection_tpu_torch.checkpoint.torch_bridge import (
    extract_state_dict, load_torch_file, normalize_state_dict_keys)


def load_any(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """``(flat torch-layout state dict, meta)`` of a native ``.npz`` or a
    reference ``.pt``; a ``.pt``'s wrapper prefixes are stripped."""
    if path.endswith(".npz") or _is_zip_npz(path):
        variables, meta = load_checkpoint(path)
        return {k: t.numpy() for k, t in state_dict_from_jax(variables).items()}, meta
    ckpt = load_torch_file(path)
    if not isinstance(ckpt, Mapping):
        raise ValueError(f"unsupported checkpoint object in {path}")
    sd, meta = extract_state_dict(ckpt)
    return normalize_state_dict_keys(sd), meta


def save_torch_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                          layout: str = "raw",
                          meta: Optional[Mapping[str, Any]] = None) -> None:
    """Write ``state_dict`` (the port's keys and torch layout, batch norm's
    running stats included) to ``.pt`` in one of the reference's layouts:
    ``raw`` (the state dict), ``model_config`` (``{model_state,
    model_config}``) or ``rich`` (``{epoch, model_state, optimizer_state,
    scheduler_state, metrics, best_f1}``), the values of the wrapper taken
    from ``meta``. The tensors are CPU copies; the JAX package writes the
    same keys and arrays for the same weights."""
    sd = {k: t.detach().to("cpu", copy=True).contiguous() for k, t in state_dict.items()}
    meta = dict(meta or {})
    if layout == "raw":
        obj: Any = sd
    elif layout == "model_config":
        obj = {"model_state": sd, "model_config": meta.get("model_config", {})}
    elif layout == "rich":
        obj = {"epoch": meta.get("epoch", 0), "model_state": sd,
               "optimizer_state": meta.get("optimizer_state", {}),
               "scheduler_state": meta.get("scheduler_state", {}),
               "metrics": meta.get("metrics", {}), "best_f1": meta.get("best_f1", 0.0)}
    else:
        raise ValueError(f"unknown layout {layout!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(obj, path)


def _is_zip_npz(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            if f.read(2) != b"PK":
                return False
        with np.load(path, allow_pickle=False) as z:
            return _META_KEY in z.files
    except Exception:
        return False
