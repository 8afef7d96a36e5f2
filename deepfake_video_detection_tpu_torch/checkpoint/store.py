"""One reader for every checkpoint the port serves.

Counterpart of ``deepfake_video_detection_tpu/checkpoint/store.py::load_any``:
a native ``.npz`` (the JAX package's store, read by ``checkpoint.bridge``)
or any of the reference's three ``.pt`` layouts (``checkpoint.torch_bridge``)
becomes ``(flat torch-layout state dict of numpy arrays, meta)``, the common
currency of ``serve/loader.py``. The ``.npz`` is told by its name or by its
content (a zip that holds the meta blob).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

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


def _is_zip_npz(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            if f.read(2) != b"PK":
                return False
        with np.load(path, allow_pickle=False) as z:
            return _META_KEY in z.files
    except Exception:
        return False
