"""Dotted-path helpers over plain nested dicts.

Counterpart of ``deepfake_video_detection_tpu/utils/tree.py``: parameter
trees are nested dicts whose dotted paths are torch ``state_dict`` keys
(``blocks.0.attn.qkv.weight``), so the JAX tree and the port's
``state_dict`` meet in one flat map.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping


def flatten_dotted(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested dict into ``{"a.b.c": leaf}`` form."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_dotted(v, prefix=path + "."))
        else:
            out[path] = v
    return out


def unflatten_dotted(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_dotted`."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out
