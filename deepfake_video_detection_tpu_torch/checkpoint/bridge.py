"""Carry weights between the JAX package and the port, both ways.

The JAX param trees already use torch ``state_dict`` key paths, so the
bridge is a flatten plus the conv transpose HWIO → OIHW (as
``deepfake_video_detection_tpu/checkpoint/torch_bridge.py::_to_torch``
does), and OIHW → HWIO on the way back (``::_to_ours``).
:func:`load_checkpoint` reads the JAX package's native ``.npz``
(``checkpoint/store.py::load_checkpoint``: ``params.``/``state.`` prefixes
plus a ``__meta_json__`` blob) with numpy alone, and
:func:`save_checkpoint` writes that layout (``store.py::save_checkpoint``,
atomic rename), so the JAX package loads the port's parameters.

The optimizer state does not cross: the port writes its own state under
``opt.0``, ``opt.1``, … in its own order, and names each entry in the
meta's ``opt_names`` (see :func:`opt_state_leaves`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.utils.tree import flatten_dotted, unflatten_dotted

_META_KEY = "__meta_json__"
_STATE_LEAVES = ("running_mean", "running_var")


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:  # conv HWIO → OIHW
        return np.transpose(arr, (3, 2, 0, 1))
    return arr


def _to_jax_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:  # conv OIHW → HWIO
        return np.transpose(arr, (2, 3, 1, 0))
    return arr


def jax_params_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                               ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_dict_from_jax` for parameters: a flat
    dotted map of f32 numpy arrays in the JAX layout."""
    return {k: np.ascontiguousarray(_to_jax_layout(
        t.detach().to("cpu", torch.float32).numpy()))
        for k, t in state_dict.items()}


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


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def opt_state_leaves(opt_state: Mapping[str, Any]
                     ) -> Tuple[List[str], List[np.ndarray]]:
    """An optimizer state of ``train.optim`` as ``(names, arrays)``:
    ``count``, ``plateau_factor``, then ``<slot>/<param name>`` for each
    per-parameter slot, in the state's own order."""
    names, leaves = [], []
    for key, val in opt_state.items():
        if isinstance(val, Mapping):
            for n, t in val.items():
                names.append(f"{key}/{n}")
                leaves.append(t.detach().cpu().numpy())
        else:
            names.append(key)
            leaves.append(np.asarray(val))
    return names, leaves


def opt_state_from_leaves(names: List[str], leaves: List[np.ndarray],
                          device: Any) -> Dict[str, Any]:
    """Inverse of :func:`opt_state_leaves`, tensors on ``device``."""
    state: Dict[str, Any] = {}
    for name, arr in zip(names, leaves):
        if "/" in name:
            slot, n = name.split("/", 1)
            state.setdefault(slot, {})[n] = torch.from_numpy(
                np.array(arr)).to(device)
        else:
            state[name] = arr.item()
    return state


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    meta: Optional[Mapping[str, Any]] = None,
                    opt_state: Optional[Mapping[str, Any]] = None,
                    step: Optional[int] = None) -> None:
    """Write the JAX package's native ``.npz`` checkpoint: ``params.<key>``
    in the JAX layout, batch norm's ``running_mean``/``running_var`` under
    ``state.<key>`` (where the JAX package keeps its model state),
    ``opt.<i>`` for the optimizer state (named in the meta's ``opt_names``)
    and the ``__meta_json__`` blob; atomic rename."""
    flat = {f"{'state' if k.endswith(_STATE_LEAVES) else 'params'}.{k}": v
            for k, v in jax_params_from_state_dict(state_dict).items()}
    m = dict(meta or {})
    if opt_state is not None:
        names, leaves = opt_state_leaves(opt_state)
        flat.update({f"opt.{i}": a for i, a in enumerate(leaves)})
        m["opt_names"] = names
    if step is not None:
        m["step"] = int(step)
    flat[_META_KEY] = np.frombuffer(
        json.dumps(m, default=_json_default).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
