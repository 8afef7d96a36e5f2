"""Carry the JAX package's weights into the port.

The JAX param trees already use torch ``state_dict`` key paths, so the
bridge is a flatten plus the conv transpose HWIO → OIHW (as
``deepfake_video_detection_tpu/checkpoint/torch_bridge.py::_to_torch``
does). :func:`load_checkpoint` reads the JAX package's native ``.npz``
(``checkpoint/store.py::load_checkpoint``: ``params.``/``state.`` prefixes
plus a ``__meta_json__`` blob) with numpy alone.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.utils.tree import flatten_dotted, unflatten_dotted

_META_KEY = "__meta_json__"


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:  # conv HWIO → OIHW
        return np.transpose(arr, (3, 2, 0, 1))
    return arr


def state_dict_from_jax(variables_or_flat: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """A JAX ``{"params", "state"}`` tree of arrays, or a flat dotted map
    of them (JAX layout), → the port's ``state_dict`` (CPU tensors, the
    leaves' dtype). Load it with ``load_state_dict(strict=True)``."""
    v = variables_or_flat
    if isinstance(v.get("params"), Mapping):
        flat = flatten_dotted(v["params"])
        flat.update(flatten_dotted(v.get("state", {})))
    else:
        flat = flatten_dotted(v)
    return {k: torch.from_numpy(np.array(_to_torch_layout(np.asarray(a))))
            for k, a in flat.items()}


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read a native ``.npz`` checkpoint → ``(variables, meta)``, variables a
    ``{"params", "state"}`` tree of numpy arrays (JAX layout). ``meta``
    carries ``_opt_leaves`` when an optimizer state was saved."""
    params_flat, state_flat, opt = {}, {}, {}
    meta: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            if k == _META_KEY:
                meta.update(json.loads(bytes(z[k]).decode()))
            elif k.startswith("params."):
                params_flat[k[len("params."):]] = z[k]
            elif k.startswith("state."):
                state_flat[k[len("state."):]] = z[k]
            elif k.startswith("opt."):
                opt[int(k[len("opt."):])] = z[k]
    if opt:
        meta["_opt_leaves"] = [opt[i] for i in sorted(opt)]
    variables = {"params": unflatten_dotted(params_flat),
                 "state": unflatten_dotted(state_flat)}
    return variables, meta
