"""Read the reference's ``.pt`` checkpoints and import any flat state dict
into a port model.

Counterpart of ``deepfake_video_detection_tpu/checkpoint/torch_bridge.py``,
in numpy plus ``torch.load``. The reference writes three layouts:

1. rich dict ``{epoch, model_state, optimizer_state, scheduler_state,
   metrics, best_f1}``,
2. ``{model_state, model_config}``,
3. a raw ``state_dict``,

with ``module.``/``model.``/``net.`` wrapper prefixes, ensemble members
under ``models.<i>.`` and the fake-class index somewhere in its metadata.
Backbones that the reference wrapped in ``nn.Sequential`` are numbered
(``backbone.0`` = ``conv_stem`` …) and renamed back to timm's and
torchvision's names. The port's modules already use torch's layout (OIHW
convs), so nothing is transposed here: :func:`import_into_model` is a
shape-filtered, non-strict ``load_state_dict`` that reports what it
matched, as the JAX ``import_into_variables`` does, and drops BN's
``num_batches_tracked``, which the port's batch norm does not keep.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def load_torch_file(path: str) -> Any:
    """A ``.pt`` file as plain numpy (CPU). ``weights_only=True`` unless
    ``ALLOW_UNSAFE_TORCH_LOAD=1``: full unpickling runs arbitrary code, and
    this loader is reachable from the serving autoload scan."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:
        if os.environ.get("ALLOW_UNSAFE_TORCH_LOAD", "0").lower() in ("1", "true", "yes"):
            obj = torch.load(path, map_location="cpu", weights_only=False)
        else:
            raise ValueError(
                f"{path}: not loadable with weights_only=True ({exc}). "
                "If this checkpoint is trusted, set ALLOW_UNSAFE_TORCH_LOAD=1 "
                "to permit full pickle deserialisation.") from exc
    return _to_numpy(obj)


def _to_numpy(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, Mapping):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def extract_state_dict(ckpt: Mapping[str, Any]
                       ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Split a checkpoint of any of the three layouts into ``(flat state
    dict, metadata)``; the metadata is everything that is not the tensors."""
    for key in ("model_state", "state_dict", "model"):
        inner = ckpt.get(key)
        if isinstance(inner, Mapping) and any(
                isinstance(v, np.ndarray) for v in inner.values()):
            return dict(inner), {k: v for k, v in ckpt.items() if k != key}
    if any(isinstance(v, np.ndarray) for v in ckpt.values()):
        return ({k: v for k, v in ckpt.items() if isinstance(v, np.ndarray)},
                {k: v for k, v in ckpt.items() if not isinstance(v, np.ndarray)})
    raise ValueError("checkpoint contains no recognizable state dict")


def normalize_state_dict_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip the ``module.``/``model.``/``net.`` wrapper prefixes."""
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        for prefix in ("module.", "model.", "net."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out


def infer_ensemble_count(sd: Mapping[str, Any]) -> int:
    """Members of an ensemble from its ``models.<i>.`` keys (0: none)."""
    idxs = {int(m.group(1)) for k in sd for m in [re.match(r"models\.(\d+)\.", k)] if m}
    return max(idxs) + 1 if idxs else 0


def detect_fake_index(meta: Mapping[str, Any]) -> Optional[int]:
    """The fake class's index from a checkpoint's metadata (index fields,
    then class maps and class lists), or None."""
    for key in ("fake_class_index", "fake_idx", "fake_index"):
        v = meta.get(key)
        if isinstance(v, (int, np.integer)) and v in (0, 1):
            return int(v)
    for key in ("class_to_idx", "classes", "class_map", "label_map", "idx_to_class"):
        v = meta.get(key)
        if isinstance(v, Mapping):
            for name, idx in v.items():
                # either {"fake": 1} or {1: "fake"}
                if isinstance(name, str) and name.strip().lower().startswith("fake") \
                        and isinstance(idx, (int, np.integer)):
                    return int(idx)
                if isinstance(idx, str) and idx.strip().lower().startswith("fake") \
                        and isinstance(name, (int, np.integer)):
                    return int(name)
        elif isinstance(v, (list, tuple)):
            for i, name in enumerate(v):
                if isinstance(name, str) and name.strip().lower().startswith("fake"):
                    return i
    return None


# timm EfficientNet's children inside nn.Sequential(*children[:-1])
_EFFNET_SEQ = {"0": "conv_stem", "1": "bn1", "2": "blocks", "3": "conv_head", "4": "bn2"}
# torchvision ResNet's children (2 = relu and 3 = maxpool hold nothing)
_RESNET_SEQ = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
               "6": "layer3", "7": "layer4"}


def _rename_sequential_backbone(key: str, kind: str) -> Optional[str]:
    """``backbone.2.3.1.conv_pw.weight`` → ``backbone.blocks.3.1.conv_pw.weight``;
    None for a child that holds nothing."""
    parts = key.split(".")
    if len(parts) < 3 or parts[0] != "backbone" or not parts[1].isdigit():
        return key
    name = (_EFFNET_SEQ if kind == "efficientnet" else _RESNET_SEQ).get(parts[1])
    return None if name is None else ".".join(["backbone", name] + parts[2:])


def canonicalize_detector_keys(sd: Mapping[str, Any], backbone_name: str
                               ) -> Dict[str, Any]:
    """A single detector's state dict with Sequential-numbered backbone
    keys renamed to timm's or torchvision's names."""
    kind = next((k for k in ("efficientnet", "resnet") if backbone_name.startswith(k)), None)
    if kind is None:
        return dict(sd)
    out = {}
    for k, v in sd.items():
        nk = _rename_sequential_backbone(k, kind)
        if nk is not None:
            out[nk] = v
    return out


_DROP_LEAVES = ("num_batches_tracked",)


def match_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The entries of a flat torch-layout ``sd`` that fit ``model`` (key
    and shape, cast to the model's dtypes), and the report
    :func:`import_into_model` returns; loads nothing."""
    own = model.state_dict()
    load, missing, mismatched = {}, [], []
    for key, cur in own.items():
        if key not in sd:
            missing.append(key)
            continue
        src = torch.as_tensor(np.asarray(sd[key]))
        if tuple(src.shape) != tuple(cur.shape):
            mismatched.append((key, tuple(src.shape), tuple(cur.shape)))
            continue
        load[key] = src.to(cur.dtype)
    return load, {"matched": list(load), "missing": missing,
                  "unexpected": [k for k in sd if k not in load
                                 and not k.endswith(_DROP_LEAVES)],
                  "shape_mismatch": mismatched,
                  "match_ratio": len(load) / max(len(own), 1)}


def import_into_model(model: torch.nn.Module, sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Shape-filtered non-strict load of a flat torch-layout ``sd`` into
    ``model``: missing and mismatched keys keep the model's values and are
    reported. Returns ``matched``, ``missing``, ``unexpected`` (not counting
    ``num_batches_tracked``), ``shape_mismatch`` and ``match_ratio`` over
    the model's ``state_dict``."""
    load, report = match_state_dict(model, sd)
    model.load_state_dict(load, strict=False)
    return report
