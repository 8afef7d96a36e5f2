"""What every run checks about its process: the cards it was given, and,
once the window has closed, that nothing of JAX or of the JAX package is
loaded. Module names are compared by their top-level name, whole: the port
``deepfake_video_detection_tpu_torch`` passes, ``deepfake_video_detection_tpu``
does not.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "deepfake_video_detection_tpu")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def require_cards(n: int) -> None:
    """Exit 2 unless CUDA is there with at least ``n`` cards."""
    import torch

    if not torch.cuda.is_available():
        why = "CUDA is not available"
    elif torch.cuda.device_count() < n:
        why = f"the cell needs {n} cards, {torch.cuda.device_count()} visible"
    else:
        return
    print(f"bench_port: {why}; no result", file=sys.stderr)
    raise SystemExit(2)


def card_description() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"
