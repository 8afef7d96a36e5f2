"""Uncertainty-aware ensemble decision agent.

A copy of ``deepfake_video_detection_tpu/agents/enhanced.py`` (pure numpy),
kept in the port so that the port imports nothing of the JAX package. As
there, it reproduces ``src/enhanced_decision_agent.py`` (SURVEY.md §2.4):
temperature-scaled ensemble probabilities, per-member fake probabilities,
agreement = 1 − std, adjusted probability
``(0.7·ensemble + 0.3·mean-individual)·(1 − penalty·uncertainty)``
(``:150-152``), abstention when uncertainty > 0.6 and agreement < 0.6
(``:155-201``), confidence ``|p − thr|·2·agreement·(1 − penalty·u)``
(``:207-208``), alert thresholds 0.30/0.70/0.95 scaled by ``1 − 0.2·u``
(``:257-279``), telemetry + active-learning hooks, batch processing, and the
``DecisionAggregator`` strategies (``:349-438``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from deepfake_video_detection_tpu_torch.agents.system import AlertLevel


@dataclass
class EnsemblePrediction:
    video_id: str
    is_fake: Optional[bool]
    confidence: float
    alert_level: AlertLevel
    ensemble_prob: float
    individual_probs: List[float]
    frame_scores: np.ndarray
    uncertainty: float
    explanation: str


def _softmax(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


class EnhancedDecisionAgent:
    def __init__(
        self,
        temperature: float = 1.0,
        confidence_thresholds: Optional[Dict[str, float]] = None,
        uncertainty_penalty: float = 0.1,
        fake_class_index: int = 1,
        abstain_on_high_uncertainty: bool = True,
        abstain_uncertainty_threshold: float = 0.6,
        min_agreement_to_act: float = 0.6,
        decision_threshold: float = 0.5,
    ):
        self.temperature = temperature
        self.uncertainty_penalty = uncertainty_penalty
        self.fake_class_index = fake_class_index if fake_class_index in (0, 1) else 1
        self.abstain_on_high_uncertainty = abstain_on_high_uncertainty
        self.abstain_uncertainty_threshold = abstain_uncertainty_threshold
        self.min_agreement_to_act = min_agreement_to_act
        self.decision_threshold = decision_threshold
        self.telemetry = None            # injected TelemetryLogger
        self.active_learner = None       # injected ActiveLearner
        self.queue_low_confidence_below = 0.05
        self.thresholds = confidence_thresholds or {
            "safe_max": 0.30, "warning_max": 0.70,
            "danger_max": 0.95, "critical_min": 0.95,
        }

    # -- core ---------------------------------------------------------------

    def process_ensemble_output(
        self,
        ensemble_logits,
        individual_logits: List[Any],
        frame_scores,
        video_id: str,
        uncertainty: float = 0.0,
        decision_threshold: Optional[float] = None,
        fake_class_index: Optional[int] = None,
    ) -> EnsemblePrediction:
        """Per-call ``decision_threshold``/``fake_class_index`` overrides let
        concurrent serving requests use their own calibration without mutating
        this shared agent (the instance attributes stay the defaults)."""
        threshold = (self.decision_threshold if decision_threshold is None
                     else float(decision_threshold))
        ensemble_logits = np.atleast_2d(np.asarray(ensemble_logits, np.float64))
        frame_scores = np.squeeze(np.asarray(frame_scores, np.float32))
        idx = (self.fake_class_index if fake_class_index is None
               else int(fake_class_index))

        ensemble_probs = _softmax(ensemble_logits / self.temperature)[0]
        fake_prob = float(ensemble_probs[idx])

        individual_probs = [
            float(_softmax(np.atleast_2d(np.asarray(lg, np.float64))
                           / self.temperature)[0][idx])
            for lg in individual_logits
        ]
        if individual_probs:
            arr = np.asarray(individual_probs, np.float64)
            agreement = float(1.0 - arr.std())
            mean_individual = float(arr.mean())
        else:
            agreement, mean_individual = 1.0, fake_prob

        adjusted_prob = (0.7 * fake_prob + 0.3 * mean_individual) * (
            1.0 - self.uncertainty_penalty * uncertainty)

        if (self.abstain_on_high_uncertainty
                and uncertainty > self.abstain_uncertainty_threshold
                and agreement < self.min_agreement_to_act):
            confidence = max(0.0, (1.0 - uncertainty) * agreement)
            result = EnsemblePrediction(
                video_id=video_id, is_fake=None, confidence=confidence,
                alert_level=AlertLevel.WARNING, ensemble_prob=adjusted_prob,
                individual_probs=individual_probs, frame_scores=frame_scores,
                uncertainty=uncertainty,
                explanation=(f"Abstained: high uncertainty ({uncertainty:.2f}) "
                             f"and low model agreement ({agreement:.2f})."))
            self._emit("abstain", video_id, adjusted_prob, confidence, uncertainty)
            self._queue(video_id, adjusted_prob, confidence, uncertainty)
            return result

        is_fake = adjusted_prob > threshold
        # |p − thr|·2 is only a [0,1] scale when thr = 0.5; with calibrated
        # thresholds it can exceed 1 (the reference reports >100% confidences
        # here — we clamp instead)
        confidence = min(1.0, abs(adjusted_prob - threshold) * 2.0)
        confidence *= max(0.0, agreement) * (1.0 - self.uncertainty_penalty * uncertainty)

        alert_level = self._alert_level(adjusted_prob, uncertainty)
        explanation = self._explanation(fake_prob, confidence, uncertainty,
                                        alert_level, individual_probs)
        self._emit("decision", video_id, adjusted_prob, confidence, uncertainty,
                   is_fake=bool(is_fake), alert_level=alert_level.name)
        if confidence < self.queue_low_confidence_below:
            self._queue(video_id, adjusted_prob, confidence, uncertainty)

        return EnsemblePrediction(
            video_id=video_id, is_fake=bool(is_fake), confidence=confidence,
            alert_level=alert_level, ensemble_prob=fake_prob,
            individual_probs=individual_probs, frame_scores=frame_scores,
            uncertainty=uncertainty, explanation=explanation)

    def batch_process(self, ensemble_logits, individual_logits_list,
                      frame_scores, video_ids: List[str],
                      uncertainties=None) -> List[EnsemblePrediction]:
        ensemble_logits = np.asarray(ensemble_logits)
        frame_scores = np.asarray(frame_scores)
        n = ensemble_logits.shape[0]
        uncertainties = (np.zeros(n) if uncertainties is None
                         else np.asarray(uncertainties))
        out = []
        for i in range(n):
            member_i = [np.asarray(m)[i] for m in individual_logits_list]
            out.append(self.process_ensemble_output(
                ensemble_logits[i], member_i, frame_scores[i],
                video_ids[i], float(uncertainties[i])))
        return out

    # -- helpers ------------------------------------------------------------

    def _alert_level(self, fake_prob: float, uncertainty: float) -> AlertLevel:
        factor = 1.0 - 0.2 * uncertainty
        if fake_prob < self.thresholds["safe_max"] * factor:
            return AlertLevel.SAFE
        if fake_prob < self.thresholds["warning_max"] * factor:
            return AlertLevel.WARNING
        if fake_prob < self.thresholds["danger_max"] * factor:
            return AlertLevel.DANGER
        return AlertLevel.CRITICAL

    def _explanation(self, fake_prob, confidence, uncertainty, alert_level,
                     individual_probs) -> str:
        names = {AlertLevel.SAFE: "AUTHENTIC", AlertLevel.WARNING: "UNCERTAIN",
                 AlertLevel.DANGER: "LIKELY DEEPFAKE",
                 AlertLevel.CRITICAL: "VERY LIKELY DEEPFAKE"}
        parts = [f"Classification: {names[alert_level]}",
                 f"Fake probability: {fake_prob * 100:.1f}%",
                 f"Confidence: {confidence * 100:.1f}%"]
        if uncertainty > 0.5:
            parts.append(f"High uncertainty detected ({uncertainty * 100:.1f}%)")
        if individual_probs:
            disagreement = float(np.std(individual_probs))
            parts.append(f"Model agreement: {(1 - disagreement) * 100:.1f}%")
        if confidence < 0.05 and uncertainty > 0.5:
            parts.append("Action: Abstain and request human review or collect more data")
        return " | ".join(parts)

    def _emit(self, event: str, video_id: str, prob, confidence, uncertainty,
              **extra) -> None:
        if self.telemetry:
            try:
                self.telemetry.log_event({"event": event, "video_id": video_id,
                                          "ensemble_prob": prob,
                                          "confidence": confidence,
                                          "uncertainty": uncertainty, **extra})
            except Exception:
                pass

    def _queue(self, video_id: str, prob, confidence, uncertainty) -> None:
        if self.active_learner:
            try:
                self.active_learner.queue_for_label({
                    "video_id": video_id, "ensemble_prob": prob,
                    "confidence": confidence, "uncertainty": uncertainty})
            except Exception:
                pass


class DecisionAggregator:
    """Aggregate many EnsemblePredictions (≙ ``:349-438``)."""

    def __init__(self):
        self.decision_history: List[Dict[str, Any]] = []

    def aggregate_predictions(self, predictions: List[EnsemblePrediction],
                              strategy: str = "confidence_weighted") -> Dict[str, Any]:
        if strategy == "confidence_weighted":
            out = self._weighted(predictions)
        elif strategy == "majority_voting":
            out = self._voting(predictions)
        elif strategy == "unanimous":
            out = self._unanimous(predictions)
        else:
            raise ValueError(f"Unknown strategy: {strategy}")
        self.decision_history.append(out)
        return out

    def _weighted(self, preds) -> Dict[str, Any]:
        total_conf = sum(p.confidence for p in preds) or len(preds)
        weighted = sum(p.ensemble_prob * p.confidence for p in preds) / total_conf
        return {"weighted_prob": weighted, "is_fake": weighted > 0.5,
                "uncertainty": float(np.mean([p.uncertainty for p in preds])),
                "num_predictions": len(preds),
                "avg_confidence": total_conf / len(preds)}

    def _voting(self, preds) -> Dict[str, Any]:
        votes = sum(1 for p in preds if p.is_fake)
        total = len(preds)
        return {"fake_votes": votes, "total_votes": total,
                "is_fake": votes > total / 2,
                "agreement": votes / total if total else 0.5}

    def _unanimous(self, preds) -> Dict[str, Any]:
        all_fake = all(p.is_fake for p in preds)
        all_real = all(not p.is_fake for p in preds)
        if all_fake:
            decision, level = True, "HIGH"
        elif all_real:
            decision, level = False, "HIGH"
        else:
            decision = float(np.mean([p.ensemble_prob for p in preds])) > 0.5
            level = "LOW"
        return {"is_fake": decision, "confidence_level": level,
                "unanimity": all_fake or all_real, "num_predictions": len(preds)}
