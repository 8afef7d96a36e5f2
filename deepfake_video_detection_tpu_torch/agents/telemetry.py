"""JSONL telemetry event logger (≙ ``src/telemetry.py:13-29``).

A copy of ``deepfake_video_detection_tpu/agents/telemetry.py`` kept in the
port, so that the port imports nothing of the JAX package; the log lines
are the same bytes for the same events.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class TelemetryLogger:
    def __init__(self, path: str = "logs/agent_actions/telemetry.log"):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def log_event(self, event: Dict[str, Any]) -> None:
        record = dict(event)
        record.setdefault("ts", time.time())
        try:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record, ensure_ascii=False, default=str) + "\n")
        except OSError:
            pass  # telemetry must never take down the pipeline
