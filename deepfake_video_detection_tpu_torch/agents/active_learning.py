"""Active-learning queue for abstained / low-confidence samples.

A copy of ``deepfake_video_detection_tpu/agents/active_learning.py`` kept
in the port: the queue, label and export files are the same bytes for
the same events. The export extracts faces with the port's
``FaceExtractor`` (on the card unless the caller passes one on the CPU).

Capability parity with ``src/active_learning.py:15-112``: JSONL queue of
abstained predictions (``queue_for_label``), a label-provider drain that moves
labelled records to the labelled file, and a retrain trigger at
``retrain_threshold`` labels.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)


class ActiveLearner:
    def __init__(self, queue_path: str = "data/active_queue.jsonl",
                 labeled_path: str = "data/active_labels.jsonl",
                 retrain_threshold: int = 10,
                 telemetry: Optional[object] = None):
        self.queue_path = queue_path
        self.labeled_path = labeled_path
        self.retrain_threshold = retrain_threshold
        self.telemetry = telemetry
        for p in (queue_path, labeled_path):
            d = os.path.dirname(p)
            if d:
                os.makedirs(d, exist_ok=True)

    def queue_for_label(self, prediction: Dict) -> None:
        try:
            with open(self.queue_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(prediction, ensure_ascii=False, default=str) + "\n")
            if self.telemetry:
                self.telemetry.log_event({
                    "event": "queued_for_label",
                    "video_id": prediction.get("video_id"),
                    "ensemble_prob": prediction.get("ensemble_prob"),
                    "confidence": prediction.get("confidence"),
                    "uncertainty": prediction.get("uncertainty"),
                })
            logger.info("Queued for labeling: %s", prediction.get("video_id"))
        except OSError:
            logger.exception("Failed to queue for label")

    def process_queue_with_label_provider(
            self, label_provider: Callable[[str], Optional[int]]) -> int:
        """Drain the queue; records the provider labels go to ``labeled_path``,
        unlabelled ones stay queued. Returns the number labelled."""
        if not os.path.exists(self.queue_path):
            return 0
        with open(self.queue_path, "r", encoding="utf-8") as f:
            lines = f.readlines()
        labeled = 0
        remaining = []
        with open(self.labeled_path, "a", encoding="utf-8") as out:
            for line in lines:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                label = label_provider(rec.get("video_id"))
                if label is None:
                    remaining.append(line)
                    continue
                rec["label"] = int(label)
                out.write(json.dumps(rec, ensure_ascii=False) + "\n")
                labeled += 1
        with open(self.queue_path, "w", encoding="utf-8") as f:
            f.writelines(remaining)
        if self.telemetry and labeled:
            self.telemetry.log_event({"event": "labels_collected", "count": labeled})
        return labeled

    def labeled_count(self) -> int:
        if not os.path.exists(self.labeled_path):
            return 0
        with open(self.labeled_path, "r", encoding="utf-8") as f:
            return sum(1 for line in f if line.strip())

    def should_retrain(self) -> bool:
        """≙ retrain trigger at ≥ threshold labels (``:111``)."""
        return self.labeled_count() >= self.retrain_threshold

    def export_labeled_dataset(self, out_dir: str,
                               videos_dir: Optional[str] = None,
                               extractor: Optional[object] = None,
                               num_frames: int = 16) -> Dict[str, int]:
        """Close the loop the reference leaves open: materialize the
        labelled queue into per-video ``.npz`` face stacks (the framework's
        dataset format, ``data/dataset.py``) so the serving model can be
        fine-tuned on them directly::

            python -m deepfake_video_detection_tpu_torch.train.cli_improved \\
                --data_dir <out_dir> --init-from <serving checkpoint>

        The reference stops at the retrain *recommendation*
        (``src/active_learning.py:111``); this produces the training set.

        Each labelled record resolves to its source video as: an existing
        path in ``video_path``/``video_id``, else ``videos_dir/<video_id>``
        (serving queues the upload's basename). Faces are extracted with
        ``extractor`` (default: a fresh ``FaceExtractor`` honouring the
        ``FACE_DETECTOR`` fallback chain). Returns
        ``{"exported": n, "skipped": m}`` — skipped = source video gone or
        no faces found.
        """
        import numpy as np

        if extractor is None:
            from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
            extractor = FaceExtractor()
        os.makedirs(out_dir, exist_ok=True)
        exported = skipped = 0
        if not os.path.exists(self.labeled_path):
            return {"exported": 0, "skipped": 0}
        with open(self.labeled_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "label" not in rec:
                    continue
                vid = str(rec.get("video_path") or rec.get("video_id") or "")
                path = vid if os.path.exists(vid) else (
                    os.path.join(videos_dir, vid) if videos_dir else vid)
                if not vid or not os.path.exists(path):
                    skipped += 1
                    continue
                try:
                    faces = extractor.extract_from_video(
                        path, max_frames=num_frames)
                except Exception:
                    logger.exception("active-learning export: decode failed "
                                     "for %s", path)
                    faces = None
                if faces is None or faces.shape[0] == 0:
                    skipped += 1
                    continue
                label = int(rec["label"])
                stem = os.path.splitext(os.path.basename(path))[0]
                np.savez_compressed(
                    os.path.join(
                        out_dir,
                        f"{stem}_al{i}_{'fake' if label else 'real'}.npz"),
                    faces=faces, label=np.int64(label))
                exported += 1
        if self.telemetry and exported:
            self.telemetry.log_event({"event": "active_dataset_exported",
                                      "exported": exported,
                                      "skipped": skipped})
        return {"exported": exported, "skipped": skipped}
