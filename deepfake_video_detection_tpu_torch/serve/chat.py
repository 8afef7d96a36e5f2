"""Chat assistant for the web UI.

A copy of ``deepfake_video_detection_tpu/serve/chat.py`` kept in the port;
the report's local fallback is the port's ``serve/predict.py``. The replies
and the Gemini request bodies are the JAX package's, byte for byte.

Capability parity with the reference's chat stack (``app.py:704-1285``):
local rule-based reply (``generate_chat_reply:837``), context-aware result
explainer (``:939-1005``), deterministic model-info answers from load stats
(``_model_info_reply:927``), metrics answers recomputed from training CSVs
(``_try_repo_metrics_reply:704-772``), and a Gemini REST path with a keyword
guardrail (``generate_chat_reply_gemini:1190-1212``) plus the English report
generator (``:1215-1285``) — both gated on ``GEMINI_API_KEY``/
``GOOGLE_API_KEY`` and degrading to the local replies when unset (this image
has zero egress, so the REST path is effectively dormant).
"""

from __future__ import annotations

import csv
import glob as _glob
import json
import os
import urllib.request
from typing import Any, Dict, List, Optional

from deepfake_video_detection_tpu_torch.utils.config import env_str

_TOPIC_KEYWORDS = ("deepfake", "fake", "real", "video", "model", "detect",
                   "accuracy", "confidence", "result", "upload", "train",
                   "threshold", "face", "frame", "ensemble", "ai", "verdict")


def is_on_topic(message: str) -> bool:
    low = message.lower()
    return any(k in low for k in _TOPIC_KEYWORDS)


def model_info_reply(load_stats: Optional[Dict[str, Any]]) -> str:
    """≙ ``_model_info_reply`` (``app.py:927``)."""
    if not load_stats:
        return ("No model is currently loaded. Upload a checkpoint or set "
                "MODEL_PATH and restart.")
    backbones = load_stats.get("backbones")
    mt = load_stats.get("model_type", "unknown")
    parts = [f"The loaded model is a '{mt}' detector"]
    if backbones:
        parts.append(f"using backbone(s): {backbones}")
    mr = load_stats.get("match_ratio")
    if mr is not None:
        parts.append(f"(checkpoint match ratio {mr:.2f})")
    return " ".join(str(p) for p in parts) + "."


def try_repo_metrics_reply(message: str,
                           search_dirs: List[str] = ("checkpoints",)) -> Optional[str]:
    """Answer accuracy/F1 questions from training CSVs
    (≙ ``_try_repo_metrics_reply``, ``app.py:704-772``)."""
    low = message.lower()
    if not any(k in low for k in ("accuracy", "f1", "auc", "metric", "score",
                                  "performance", "how good")):
        return None
    rows: List[Dict[str, str]] = []
    for d in search_dirs:
        for path in _glob.glob(os.path.join(d, "**", "training_history.csv"),
                               recursive=True):
            try:
                with open(path, newline="") as f:
                    rows.extend(csv.DictReader(f))
            except OSError:
                continue
    if not rows:
        return None
    best = {}
    for key in ("accuracy", "f1", "auc"):
        vals = []
        for r in rows:
            for col in (key, f"val_{key}"):
                try:
                    vals.append(float(r.get(col, "") or "nan"))
                except ValueError:
                    pass
        vals = [v for v in vals if v == v]
        if vals:
            best[key] = max(vals)
    if not best:
        return None
    parts = [f"best {k}: {v:.3f}" for k, v in best.items()]
    return ("From the latest training history on this server — "
            + ", ".join(parts) + ".")


def explain_result_reply(result: Optional[Dict[str, Any]]) -> str:
    """Context-aware explanation of the latest result (≙ ``app.py:939-1005``)."""
    if not result:
        return ("I don't have a recent analysis to explain. Upload a video "
                "first and I'll walk you through the verdict.")
    if result.get("error"):
        return f"The last analysis failed: {result['error']}"
    verdict = result.get("prediction", "Uncertain")
    conf = result.get("confidence")
    pf = result.get("prob_fake")
    n = result.get("num_faces", 0)
    parts = [f"The last video was classified as **{verdict}**."]
    if isinstance(conf, float):
        parts.append(f"Confidence: {conf * 100:.1f}%.")
    if isinstance(pf, float):
        parts.append(f"Fake probability: {pf * 100:.1f}%.")
    parts.append(f"The detector examined {n} face crops sampled across the "
                 f"clip, scoring each for manipulation artifacts and fusing "
                 f"them with temporal attention.")
    if result.get("abstained"):
        parts.append("The system abstained because the signal was too weak "
                     "for a reliable call — try a clearer or longer clip.")
    return " ".join(parts)


def generate_chat_reply(message: str,
                        last_result: Optional[Dict[str, Any]] = None,
                        load_stats: Optional[Dict[str, Any]] = None) -> str:
    """Local rule-based reply (≙ ``generate_chat_reply``, ``app.py:837``)."""
    low = message.lower().strip()
    if not low:
        return "Ask me about your video result, the model, or deepfakes in general."
    if any(g in low for g in ("hello", "hi ", "hey")) or low in ("hi", "hey"):
        return ("Hi! Upload a video and I'll tell you whether it looks real "
                "or fake — then ask me anything about the verdict.")
    metrics = try_repo_metrics_reply(message)
    if metrics:
        return metrics
    if "model" in low and any(k in low for k in ("what", "which", "info",
                                                 "backbone", "architecture")):
        return model_info_reply(load_stats)
    if any(k in low for k in ("why", "explain", "result", "verdict", "last")):
        return explain_result_reply(last_result)
    if "how" in low and any(k in low for k in ("work", "detect")):
        return ("The detector samples frames from your video, crops the "
                "faces, and runs them through a convolutional backbone on "
                "TPU. A temporal attention head weighs the most informative "
                "frames and outputs the probability the video is fake. A "
                "calibrated threshold turns that probability into the final "
                "verdict, and the system abstains when confidence is low.")
    if "threshold" in low:
        return ("The decision threshold comes from calibration_best.json "
                "written during training (best-accuracy sweep), can be "
                "overridden with DETECT_FAKE_THRESHOLD, and is clamped away "
                "from extreme values by default.")
    if not is_on_topic(low):
        return ("I can only help with deepfake detection topics — ask me "
                "about your video result, the model, or how detection works.")
    return ("I'm a deepfake-detection assistant. Ask about your latest "
            "result, model details, accuracy metrics, or how the detector "
            "works.")


# ---------------------------------------------------------------------------
# Gemini REST path (gated; dormant without a key / network)
# ---------------------------------------------------------------------------

_GEMINI_URL = ("https://generativelanguage.googleapis.com/v1beta/models/"
               "gemini-1.5-flash:generateContent?key={key}")


def _gemini_call(prompt: str, api_key: str, timeout: float = 20.0) -> Optional[str]:
    body = json.dumps({
        "contents": [{"parts": [{"text": prompt}]}]
    }).encode()
    req = urllib.request.Request(
        _GEMINI_URL.format(key=api_key), data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            data = json.loads(r.read().decode())
        return data["candidates"][0]["content"]["parts"][0]["text"]
    except Exception:
        return None


def generate_chat_reply_gemini(message: str,
                               last_result: Optional[Dict[str, Any]] = None,
                               api_key: Optional[str] = None) -> str:
    """Gemini-backed reply with keyword guardrail
    (≙ ``generate_chat_reply_gemini``, ``app.py:1190-1212``)."""
    api_key = api_key or env_str("GEMINI_API_KEY") or env_str("GOOGLE_API_KEY")
    if not is_on_topic(message):
        return ("I can only help with deepfake detection topics — ask me "
                "about your video result or how detection works.")
    if api_key:
        context = json.dumps(last_result or {}, default=str)
        out = _gemini_call(
            "You are a deepfake-detection assistant. Context (latest "
            f"analysis): {context}\nUser: {message}\nAnswer briefly.", api_key)
        if out:
            return out
    return generate_chat_reply(message, last_result)


def gemini_generate_english_report(result: Dict[str, Any],
                                   filename: str = "",
                                   api_key: Optional[str] = None) -> str:
    """English report (Gemini when available, local 200-word fallback)
    (≙ ``_gemini_generate_english_report``, ``app.py:1215-1285``)."""
    from deepfake_video_detection_tpu_torch.serve.predict import (
        simple_english_justification_200_words)

    api_key = api_key or env_str("GEMINI_API_KEY") or env_str("GOOGLE_API_KEY")
    if api_key:
        out = _gemini_call(
            "Write a simple 200-word English report explaining this deepfake "
            f"detection result for a non-technical person: "
            f"{json.dumps(result, default=str)}", api_key)
        if out:
            return out
    return simple_english_justification_200_words(result, filename)
