"""Legacy detector wrapper (≙ ``src/detector.py:9-167`` — unused by the
reference's app but part of its public surface).

Counterpart of ``deepfake_video_detection_tpu/serve/detector.py``: wraps an
``nn.Module`` on an explicit device with weight-free face extraction (the
first-party Haar detector, matching the reference's Haar-only path),
preprocessing, the rnn/gcn dispatch, and the canned markdown explanation.
The forward runs in eval mode under ``torch.no_grad()``; the frame-graph
detectors get the normalised chain adjacency; softmax in f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.data.dataset import pad_or_sample_frames
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.utils.device import resolve_device
from deepfake_video_detection_tpu_torch.utils.graph import chain_adjacency, normalize_adjacency


class DeepfakeDetector:
    """Model wrapper with extraction + explanation (legacy API)."""

    def __init__(self, model: torch.nn.Module,
                 variables: Optional[Dict[str, torch.Tensor]] = None,
                 model_type: str = "gcn",
                 extractor: Optional[FaceExtractor] = None,
                 device: Any = "cuda"):
        """``variables``: a ``state_dict`` loaded strictly into ``model``, or
        None to use the weights the model holds. ``device``: where the model
        runs (CUDA unless the caller names another device; raises without a
        card)."""
        self.device = resolve_device(device)
        if variables is not None:
            model.load_state_dict(variables, strict=True)
        self.model = model.to(self.device).eval()
        self.model_type = model_type
        # the reference's legacy wrapper is Haar-only (src/detector.py:9);
        # resolution degrades to 'center' when no cascade XML is installed
        self.extractor = extractor or FaceExtractor(detector="haar", device=self.device)

    def extract_faces(self, video_path: str, max_frames: int = 10) -> np.ndarray:
        try:
            return self.extractor.extract_from_video(video_path,
                                                     max_frames=max_frames)
        except Exception as e:
            print(f"Error extracting faces: {e}")
            return np.zeros((0, self.extractor.face_size,
                             self.extractor.face_size, 3), np.uint8)

    def preprocess_faces(self, faces: np.ndarray, num_frames: int = 16) -> np.ndarray:
        if faces.shape[0] == 0:
            return np.zeros((num_frames, self.extractor.face_size,
                             self.extractor.face_size, 3), np.float32)
        return pad_or_sample_frames(faces, num_frames).astype(np.float32) / 255.0

    @torch.no_grad()
    def detect(self, video_path: str) -> Dict[str, Any]:
        faces = self.extract_faces(video_path)
        num_faces = int(faces.shape[0])
        x = torch.from_numpy(self.preprocess_faces(faces))[None].to(self.device)
        if self.model_type in ("gcn", "vit_gcn"):
            A = normalize_adjacency(chain_adjacency(x.shape[1]))[None].to(self.device)
            out = self.model(x, A)
        else:
            out = self.model(x)
        logits = out[0] if isinstance(out, tuple) else out
        probs = torch.softmax(logits.to(torch.float32), -1)[0].cpu().numpy()
        is_fake = int(probs[1] >= 0.5)
        confidence = float(probs[1])
        return {"is_fake": is_fake, "confidence": confidence,
                "num_faces": num_faces,
                "explanation": generate_explanation(is_fake, confidence,
                                                    num_faces)}


def generate_explanation(is_fake: int, confidence: float,
                         num_faces: int) -> str:
    """Canned markdown explanation (≙ ``src/detector.py:143-167``)."""
    if is_fake == 1:
        return (
            f"**LIKELY DEEPFAKE DETECTED** (confidence: {confidence * 100:.1f}%)\n\n"
            f"The model detected {num_faces} face(s) in the video with "
            f"synthetic manipulation patterns. Key indicators:\n"
            f"- Facial feature artifacts and inconsistencies\n"
            f"- Unnatural motion or blending boundaries\n"
            f"- Texture and lighting inconsistencies across frames\n\n"
            f"This is a probabilistic assessment. Manual review recommended "
            f"for critical decisions."
        )
    confidence_real = 1.0 - confidence
    return (
        f"**LIKELY AUTHENTIC** (confidence: {confidence_real * 100:.1f}%)\n\n"
        f"The model detected {num_faces} face(s) in the video with natural "
        f"characteristics. Key indicators:\n"
        f"- Natural facial features and expressions\n"
        f"- Temporally consistent appearance\n"
        f"- Realistic lighting and shadows\n\n"
        f"Video appears authentic based on analyzed characteristics."
    )
