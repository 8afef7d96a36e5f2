"""Multi-agent decision pipeline.

A copy of ``deepfake_video_detection_tpu/agents/system.py`` kept in the
port, with ``InferenceAgent`` rebased onto the port's ``BackboneDetector``,
its checkpoint loader and the fused-normalize kernel. As there, it
reproduces ``src/agent_system.py`` (SURVEY.md §2.4): four agents chained by
an orchestrator —

* ``InferenceAgent``  — loads a detector checkpoint, runs the forward on the
  card (bf16 activations);
* ``DecisionAgent``   — verdict + alert level (thresholds 0.7 / 0.95) and a
  human-readable explanation; honours the app's thresholded ``pred_class``
  so agent alerts never contradict ``DETECT_FAKE_THRESHOLD``
  (``src/agent_system.py:155-163``);
* ``MonitoringAgent`` — counters + ``predictions.jsonl`` under
  ``logs/agent_monitoring`` (``:232-311``);
* ``ActionAgent``     — per-level actions: log / file JSON report / notify
  admin (``:314-426``).

Pure numpy — agents consume logits/probs, never device arrays.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from datetime import datetime
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class AlertLevel(Enum):
    SAFE = 0
    WARNING = 1
    DANGER = 2
    CRITICAL = 3


@dataclass
class PredictionResult:
    video_id: str
    is_fake: Optional[bool]
    confidence: float
    alert_level: AlertLevel
    frame_scores: np.ndarray
    timestamp: datetime
    explanation: str


class Agent:
    """Base agent with a bounded action history."""

    def __init__(self, name: str, history_limit: int = 1000):
        self.name = name
        self.action_history: List[Dict[str, Any]] = []
        self._history_limit = history_limit

    def log_action(self, action: str, details: Dict[str, Any]) -> None:
        self.action_history.append({
            "agent": self.name,
            "action": action,
            "details": details,
            "timestamp": datetime.now().isoformat(),
        })
        if len(self.action_history) > self._history_limit:
            del self.action_history[: len(self.action_history) // 2]


class InferenceAgent(Agent):
    """Loads a detector and runs its forward (≙ ``:66-117``)."""

    def __init__(self, model_path: Optional[str] = None,
                 backbone_name: str = "efficientnet_b0",
                 forward_fn: Optional[Callable] = None, device: Any = "cuda"):
        super().__init__("InferenceAgent")
        if forward_fn is not None:
            self._forward = forward_fn
            return
        import torch

        from deepfake_video_detection_tpu_torch.checkpoint.store import load_any
        from deepfake_video_detection_tpu_torch.checkpoint.torch_bridge import (
            import_into_model)
        from deepfake_video_detection_tpu_torch.models.backbone_detector import (
            BackboneDetector)
        from deepfake_video_detection_tpu_torch.ops.preprocess import fused_normalize

        model = BackboneDetector(backbone_name, compute_dtype=torch.bfloat16,
                                 device=device).eval()
        if model_path:
            import_into_model(model, load_any(model_path)[0])

        @torch.inference_mode()
        def fwd(frames):
            x = torch.as_tensor(np.ascontiguousarray(frames)).to(
                next(model.parameters()).device)
            logits, scores = model(fused_normalize(x, torch.bfloat16))
            return logits.float().cpu().numpy(), scores.float().cpu().numpy()

        self._forward = fwd

    def process(self, frames) -> tuple:
        """``frames``: (B, T, H, W, 3) uint8. Returns numpy (logits, scores)."""
        logits, scores = self._forward(frames)
        out = (np.asarray(logits, np.float32), np.asarray(scores, np.float32))
        self.log_action("inference", {"batch": int(out[0].shape[0])})
        return out

class DecisionAgent(Agent):
    def __init__(self, confidence_threshold: float = 0.7,
                 high_confidence_threshold: float = 0.95,
                 fake_class_index: int = 1):
        super().__init__("DecisionAgent")
        self.confidence_threshold = confidence_threshold
        self.high_confidence_threshold = high_confidence_threshold
        self.fake_class_index = fake_class_index if fake_class_index in (0, 1) else 1

    def process(self, prediction: Dict[str, Any]) -> PredictionResult:
        video_id = prediction["video_id"]
        probs = prediction.get("probs")
        frame_scores = prediction.get("frame_scores")

        pred_class = prediction.get("pred_class")
        if pred_class in (0, 1):
            # trust the app's calibrated verdict (threshold may differ from 0.5)
            is_fake = int(pred_class) == 1
            try:
                confidence = float(prediction.get("confidence", 0.0))
            except (TypeError, ValueError):
                confidence = 0.0
        else:
            if probs is None:
                raise ValueError("Missing 'probs' for DecisionAgent")
            probs = np.asarray(probs, np.float64)
            fake_idx = self.fake_class_index
            is_fake = bool(probs[fake_idx] > probs[1 - fake_idx])
            confidence = float(probs.max())

        if frame_scores is None:
            frame_scores = np.zeros(8, np.float32)
        frame_scores = np.asarray(frame_scores, np.float32)

        alert_level = self._alert_level(is_fake, confidence)
        explanation = self._explanation(is_fake, confidence, frame_scores)
        result = PredictionResult(video_id, is_fake, confidence, alert_level,
                                  frame_scores, datetime.now(), explanation)
        self.log_action("decision", {"is_fake": is_fake, "confidence": confidence,
                                     "alert_level": alert_level.name})
        return result

    def _alert_level(self, is_fake: bool, confidence: float) -> AlertLevel:
        if not is_fake:
            return AlertLevel.SAFE
        if confidence > self.high_confidence_threshold:
            return AlertLevel.CRITICAL
        if confidence > self.confidence_threshold:
            return AlertLevel.DANGER
        return AlertLevel.WARNING

    def _explanation(self, is_fake: bool, confidence: float,
                     frame_scores: np.ndarray) -> str:
        if not is_fake:
            return f"Video appears authentic (confidence: {confidence:.1%})"
        k = min(3, frame_scores.size)
        top = np.argsort(frame_scores)[::-1][:k].tolist()
        if confidence > self.high_confidence_threshold:
            return (f"CRITICAL: High-confidence deepfake detected "
                    f"({confidence:.1%}). Suspicious activity in frames {top}")
        if confidence > self.confidence_threshold:
            return f"WARNING: Deepfake likely ({confidence:.1%}). Detected in frames {top}"
        return (f"UNCERTAIN: Possible deepfake ({confidence:.1%}). "
                f"Low confidence - manual review recommended.")


class MonitoringAgent(Agent):
    def __init__(self, output_dir: str = "logs/agent_monitoring"):
        super().__init__("MonitoringAgent")
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.predictions: List[PredictionResult] = []
        self.metrics: Dict[str, Any] = {
            "total_processed": 0,
            "total_fake_detected": 0,
            "total_authentic": 0,
            "alerts_by_level": {level.name: 0 for level in AlertLevel},
        }

    def process(self, result: PredictionResult) -> Dict[str, Any]:
        self.predictions.append(result)
        self.metrics["total_processed"] += 1
        if result.is_fake:
            self.metrics["total_fake_detected"] += 1
        else:
            self.metrics["total_authentic"] += 1
        self.metrics["alerts_by_level"][result.alert_level.name] += 1
        self._append_jsonl(result)
        self.log_action("monitoring", dict(self.metrics))
        return self.metrics

    def _append_jsonl(self, result: PredictionResult) -> None:
        entry = {
            "timestamp": result.timestamp.isoformat(),
            "video_id": result.video_id,
            "is_fake": result.is_fake,
            "confidence": result.confidence,
            "alert_level": result.alert_level.name,
            "explanation": result.explanation,
        }
        with open(os.path.join(self.output_dir, "predictions.jsonl"), "a") as f:
            f.write(json.dumps(entry) + "\n")

    def get_report(self) -> Dict[str, Any]:
        total = max(1, self.metrics["total_processed"])
        return {
            "timestamp": datetime.now().isoformat(),
            "total_predictions": self.metrics["total_processed"],
            "fake_percentage": self.metrics["total_fake_detected"] / total * 100,
            "alerts": self.metrics["alerts_by_level"],
            "recent_predictions": [
                {"video_id": p.video_id, "is_fake": p.is_fake,
                 "confidence": p.confidence}
                for p in self.predictions[-10:]
            ],
        }


class ActionAgent(Agent):
    def __init__(self, output_dir: str = "logs/agent_actions",
                 notify_fn: Optional[Callable[[PredictionResult], str]] = None):
        super().__init__("ActionAgent")
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.actions_taken: List[Dict[str, Any]] = []
        self._notify_fn = notify_fn

    def process(self, result: PredictionResult) -> Dict[str, Any]:
        actions: List[str] = []
        level = result.alert_level
        msg = f"[{level.name}] {result.video_id} - {result.explanation}"
        if level == AlertLevel.SAFE:
            logger.info(msg)
            actions.append(msg)
        elif level == AlertLevel.WARNING:
            logger.warning(msg)
            actions.append(msg)
        elif level == AlertLevel.DANGER:
            logger.error(msg)
            actions.append(msg)
            actions.append(self._file_report(result))
        else:  # CRITICAL
            logger.critical(msg)
            actions.append(msg)
            actions.append(self._file_report(result))
            actions.append(self._notify_admin(result))

        summary = {
            "video_id": result.video_id,
            "alert_level": level.name,
            "actions_taken": actions,
            "timestamp": datetime.now().isoformat(),
        }
        self.actions_taken.append(summary)
        self.log_action("action", summary)
        return summary

    def _file_report(self, result: PredictionResult) -> str:
        report_dir = os.path.join(self.output_dir, "reports")
        os.makedirs(report_dir, exist_ok=True)
        stamp = result.timestamp.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(report_dir, f"{result.video_id}_{stamp}.json")
        data = {
            "video_id": result.video_id,
            "timestamp": result.timestamp.isoformat(),
            "is_fake": result.is_fake,
            "confidence": float(result.confidence),
            "alert_level": result.alert_level.name,
            "explanation": result.explanation,
            "top_suspicious_frames":
                np.argsort(result.frame_scores)[-3:].tolist(),
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
        return f"report filed: {path}"

    def _notify_admin(self, result: PredictionResult) -> str:
        if self._notify_fn is not None:
            # injectable hook (≙ WebActionAgent._notify_admin,
            # ``app.py:1121-1133``): a None return means "not handled" —
            # fall through to the default admin log, like the reference's
            # super()._notify_admin() fallback when no phone is configured
            note = self._notify_fn(result)
            if note is not None:
                return note
        note = os.path.join(self.output_dir, "admin_notifications.jsonl")
        with open(note, "a") as f:
            f.write(json.dumps({"video_id": result.video_id,
                                "confidence": result.confidence,
                                "timestamp": result.timestamp.isoformat()}) + "\n")
        return "admin notified (logged)"


class MultiAgentOrchestrator:
    """Chains Inference → Decision → Monitoring → Action (≙ ``:429-553``)."""

    def __init__(self, model_path: Optional[str] = None,
                 backbone_name: str = "efficientnet_b0",
                 forward_fn: Optional[Callable] = None,
                 log_root: str = "logs", device: Any = "cuda"):
        self.inference_agent = InferenceAgent(model_path, backbone_name, forward_fn,
                                              device)
        self.decision_agent = DecisionAgent()
        self.monitoring_agent = MonitoringAgent(
            os.path.join(log_root, "agent_monitoring"))
        self.action_agent = ActionAgent(os.path.join(log_root, "agent_actions"))
        self.agents = [self.inference_agent, self.decision_agent,
                       self.monitoring_agent, self.action_agent]

    def process_video(self, frames, video_id: str) -> Dict[str, Any]:
        logits, frame_scores = self.inference_agent.process(frames)
        x = logits[0] - logits[0].max()
        probs = np.exp(x) / np.exp(x).sum()
        decision = self.decision_agent.process({
            "video_id": video_id,
            "logits": logits[0],
            "frame_scores": frame_scores[0],
            "probs": probs,
        })
        metrics = self.monitoring_agent.process(decision)
        action = self.action_agent.process(decision)
        return {
            "video_id": video_id,
            "inference": {
                "is_fake": decision.is_fake,
                "confidence": float(decision.confidence),
                "alert_level": decision.alert_level.name,
            },
            "explanation": decision.explanation,
            "monitoring": metrics,
            "actions": action,
        }
