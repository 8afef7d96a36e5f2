"""Environment-variable parsing with the reference's tolerant semantics.

Copy of the env helpers of ``deepfake_video_detection_tpu/utils/config.py``
(``env_str``/``env_int``/``env_float``/``env_bool``), so deployments keep the
reference's variable names without importing the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    v = os.environ.get(name)
    if v is None:
        return default
    v = v.strip()
    return v if v else default


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or not str(v).strip():
        return default
    try:
        return int(str(v).strip())
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or not str(v).strip():
        return default
    try:
        return float(str(v).strip())
    except ValueError:
        return default


def env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return str(v).strip().lower() in ("1", "true", "yes", "on", "y")
