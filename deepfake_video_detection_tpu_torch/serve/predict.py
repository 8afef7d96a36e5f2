"""Serving inference engine for the pretrained detector, its ensemble, the
temporal transformer and the legacy CNN+LSTM and frame-graph detectors, on
the CUDA cards.

Counterpart of ``deepfake_video_detection_tpu/serve/predict.py`` for
``model_type="pretrained"`` (a single ``BackboneDetector``: EfficientNet,
ResNet or ViT), ``"ensemble_pretrained"`` (an ``EnsembleDetector``, with the
optional ``EnhancedDecisionAgent`` over its members' logits) and
``"temporal"`` (a ``TemporalTransformerDetector``), which the JAX package
serves through the same forward functions, warmup, windows and policy: the
same decision policy and result-dict schema. ``serve/loader.py::load_model``
builds any of them from a checkpoint. :meth:`Predictor.predict_video` serves
a video file: the extractor (``data/faces.py::FaceExtractor``, on the
Predictor's device) decodes and crops up to ``MAX_FRAMES`` × ``SERVE_WINDOWS``
faces, as packed YUV420 from inside the native decoder (half the
host→device bytes) for the center and haar detectors, or as RGB crops
resized on the device otherwise (explain requests, ``KEEP_ALL_FACES``,
``SERVE_YUV_TRANSFER=0``); any failure comes back as ``{"error": ...}``.
Extraction runs in the request's thread under a semaphore
(``SERVE_EXTRACT_CONCURRENCY``). :meth:`Predictor.predict_faces` takes
crops directly. The policy: optional windowed scan
(``SERVE_WINDOWS``) with the order-statistics threshold correction,
calibrated threshold from ``calibration_best.json`` /
``DETECT_FAKE_THRESHOLD`` / 0.5 with the extreme-threshold guard, and the
``MIN_FACES``, borderline-margin and low-confidence abstains.

Result keys: prediction, verdict_yes_no, description, pred_class,
confidence, prob_real, prob_fake, num_faces, threshold, enhanced_agent,
frame_scores (+ windows, abstained).

``model_type="cnn_lstm"`` and ``"vit_gcn"`` (``models/cnn_lstm.py``,
``models/gcn.py``) take the JAX package's legacy path
(:meth:`Predictor._predict_legacy`): the crops padded or sampled to 16
frames and scaled by 1/255 (these models trained on [0, 1] frames, without
ImageNet statistics), the frame graph the normalised chain over the 16
frames, one forward a request (no micro-batching), the threshold from
``DETECT_FAKE_THRESHOLD`` (0.5) and the borderline and low-confidence
abstains, with the JAX package's result keys for that path.

On CUDA the RGB forward runs the fused-normalize kernel (K1), the
packed-YUV forward K1's YUV420 entry (colour matrix and normalisation in one
pass), and every ViT and temporal block the flash-attention kernel (K2; a
window holds at most 64 frames, so the temporal blocks attend over N ≤ 65
tokens here); the conv nets run cuDNN convolutions, channels-last. Video
decoding and Haar detection run on the host; the RGB path's crop and resize
runs on the device as two batched products.

``predict_faces(..., explain=True)`` adds the ``saliency`` key: per-frame
input-gradient grids of the deciding window (``serve/saliency.py``), taken
outside ``torch.inference_mode()`` through K1 with f32 output and, on a ViT
or temporal model, the flash forward (K2) and backward (K4). ``SERVE_EXPLAIN``
(default on) gates it; ``SERVE_EXPLAIN_WARMUP`` explains a blank clip in the
warmup. A failed explanation leaves the verdict as it is, is logged and is
kept in ``explain_error``.

Serving data parallelism, opt-in: with ``device="cuda"`` (no index),
``SERVE_DP=1``, ``SERVE_MICROBATCH`` on (the default), a pretrained,
ensemble or temporal model and more than one visible card, or with an
explicit ``devices=`` list, the Predictor holds one replica of the model on
each of those devices (``"cuda:i"`` serves on card i alone). The JAX
package turns it on by default (``SERVE_DP`` unset); here it stays off
unless asked for, since replicas driven by threads of one process serve
fewer clips a second than one card does. Every micro-batch
bucket is then a multiple of the replica count; each coalesced batch is
split into equal row shards, each shard runs its forward (K1 or its YUV
entry, then the model) on its replica's card in that replica's own thread,
under that card as the thread's current device, and the outputs are
gathered in row order. The windowed scan pads its W windows up to a
multiple of the replica count with the last window. Explanations run on the
first replica. A replica that fails is an error of the request or of the
warmup: nothing falls back to fewer cards.

Spans (``utils/profiling.py``), while something records: ``serve.request``,
all of :meth:`Predictor._predict_pretrained` (its id is the request's id
in the batcher's spans); ``serve.policy``, the host work after the
probabilities are back (threshold, calibration, agent, the result dict);
``serve.h2d``, a batch's host→device copy; ``serve.forward``, the
forward's host enqueue on one device.
"""

from __future__ import annotations

import concurrent.futures as _fut
import contextlib
import copy
import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.data.dataset import pad_or_sample_frames
from deepfake_video_detection_tpu_torch.data.faces import FaceExtractor
from deepfake_video_detection_tpu_torch.ops.preprocess import (
    fused_normalize, fused_normalize_yuv)
from deepfake_video_detection_tpu_torch.serve.batcher import MicroBatcher, to_host
from deepfake_video_detection_tpu_torch.serve.saliency import (
    make_saliency_fn, saliency_payload)
from deepfake_video_detection_tpu_torch.utils.config import env_bool, env_float, env_int
from deepfake_video_detection_tpu_torch.utils.device import (  # noqa: F401
    resolve_device, serving_dtype)
from deepfake_video_detection_tpu_torch.utils.graph import chain_adjacency, normalize_adjacency
from deepfake_video_detection_tpu_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

# `with self._extract_sem or _NULL_CTX:`, a no-op when admission control is
# off (SERVE_EXTRACT_CONCURRENCY=0)
_NULL_CTX = contextlib.nullcontext()
_PRETRAINED_TYPES = ("pretrained", "ensemble_pretrained", "temporal")
_LEGACY_TYPES = ("cnn_lstm", "vit_gcn")
LEGACY_FRAMES = 16     # the legacy models' clip length


def _get_fake_class_index(num_classes: int = 2) -> int:
    idx = env_int("FAKE_CLASS_INDEX", 1)
    return idx if idx in (0, 1) and num_classes == 2 else (1 if num_classes == 2 else 0)


def load_calibration(checkpoint_path: Optional[str]) -> Optional[dict]:
    """The full ``calibration_best.json`` next to the checkpoint, if any."""
    if not checkpoint_path:
        return None
    cal = os.path.join(os.path.dirname(checkpoint_path), "calibration_best.json")
    if not os.path.exists(cal):
        return None
    try:
        with open(cal) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_calibration_threshold(checkpoint_path: Optional[str]) -> Optional[float]:
    """The calibrated threshold (``best_thr_accuracy``, else
    ``best_thr_f1``) next to the checkpoint, if any."""
    data = load_calibration(checkpoint_path)
    if not data:
        return None
    try:
        thr = data.get("best_thr_accuracy", data.get("best_thr_f1"))
        return float(thr) if thr is not None else None
    except (TypeError, ValueError):
        return None


def windowed_threshold(thr: float, windows: int, quantiles) -> float:
    """Order-statistics (Šidák) correction for max-of-W scan verdicts.

    ``thr`` was calibrated on single-span scores; a windowed scan thresholds
    the max of ``windows`` scores. With the empirical CDF F of real-class
    scores (``real_score_quantiles``), the single-span FPR is α = 1 − F(thr);
    keeping the per-video FPR at α under W independent windows needs
    per-window α' = 1 − (1−α)^(1/W), i.e. threshold F⁻¹(1 − α'). Returns
    max(thr, corrected); ``thr`` unchanged without quantiles."""
    if windows <= 1 or not quantiles:
        return thr
    q = np.maximum.accumulate(np.asarray(quantiles, np.float64))
    if q.size < 2:
        return thr
    ps = np.linspace(0.0, 1.0, q.size)
    alpha = 1.0 - float(np.interp(thr, q, ps))
    if alpha <= 0.0:
        return thr  # thr already above every real score seen in validation
    alpha_w = 1.0 - (1.0 - alpha) ** (1.0 / windows)
    return max(thr, float(np.interp(1.0 - alpha_w, ps, q)))


def _detection_threshold(default: float) -> float:
    return env_float("DETECT_FAKE_THRESHOLD", default)


def make_forward_fns(model: torch.nn.Module, is_ensemble: bool, face_size: int):
    """The serving forward as two functions of a device tensor, each
    returning ``(probs f32, logits, frame_scores, member_logits)``
    (``member_logits`` (M, B, C) for an ensemble, else None): ``fwd`` takes
    uint8 RGB frames (B, T, H, W, 3), ``fwd_yuv`` packed YUV420 crops
    (B, T, face_size*face_size*3//2). Each normalises into the model's
    compute dtype with one K1 launch."""
    compute_dtype = getattr(model, "compute_dtype", torch.float32)

    def head(x):
        if is_ensemble:
            logits, scores, member_logits = model(x, return_member_logits=True)
        else:
            (logits, scores), member_logits = model(x), None
        return (torch.softmax(logits.to(torch.float32), dim=-1), logits, scores,
                member_logits)

    @torch.inference_mode()
    def fwd(frames_u8: torch.Tensor):
        return head(fused_normalize(frames_u8, out_dtype=compute_dtype))

    @torch.inference_mode()
    def fwd_yuv(packed_u8: torch.Tensor):
        return head(fused_normalize_yuv(packed_u8, face_size, face_size,
                                        out_dtype=compute_dtype))

    return fwd, fwd_yuv


def make_legacy_forward(model: torch.nn.Module, model_type: str, device: Any):
    """The legacy serving forward: uint8 RGB clips (B, 16, H, W, 3) on the
    device → f32 class probabilities (B, C). Frames scaled by 1/255; the
    frame-graph detector gets the normalised chain adjacency over the 16
    frames."""
    adjacency = None
    if model_type == "vit_gcn":
        adjacency = normalize_adjacency(chain_adjacency(LEGACY_FRAMES)).to(device)

    @torch.inference_mode()
    def fwd(frames_u8: torch.Tensor) -> torch.Tensor:
        x = frames_u8.to(torch.float32) / 255.0
        logits = model(x) if adjacency is None else \
            model(x, adjacency.expand(x.shape[0], -1, -1))
        return torch.softmax(logits.to(torch.float32), dim=-1)

    return fwd


def serving_devices(model_type: str, device: Any = "cuda",
                    devices: Optional[Sequence[Any]] = None) -> List[torch.device]:
    """The devices a Predictor serves on: ``devices`` when given, else every
    visible card for ``device="cuda"`` (no index) when ``SERVE_DP=1`` and
    serving data parallelism applies (a pretrained, ensemble or temporal
    model, ``SERVE_MICROBATCH`` on, more than one card), else ``device``
    alone. More than one device where data parallelism does not apply
    raises."""
    dp = model_type in _PRETRAINED_TYPES and env_bool("SERVE_MICROBATCH", True)
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices= names no device")
        if len(devs) > 1 and not dp:
            raise ValueError(
                f"serving over {len(devs)} devices needs a pretrained, ensemble or "
                f"temporal model with SERVE_MICROBATCH on")
        return devs
    dev = resolve_device(device)
    if dp and env_bool("SERVE_DP", False) and dev.type == "cuda" and dev.index is None \
            and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


class _Replica:
    """One copy of the served model on one device, with the persistent
    thread that runs its shards of each batch there: the card is the
    thread's current device, so the kernels launch into its streams."""

    def __init__(self, model: torch.nn.Module, device: torch.device, is_ensemble: bool,
                 face_size: int):
        self.model, self.device = model, device
        self.forward, self.forward_yuv = make_forward_fns(model, is_ensemble, face_size)
        self.batches = 0      # shards run, counted on the replica's thread
        # never shut down: a request that reaches the Predictor after close()
        # still runs here; the idle thread ends when the pool is collected
        self._pool = _fut.ThreadPoolExecutor(1, thread_name_prefix=f"replica-{device}")

    def submit(self, rows: np.ndarray, yuv: bool) -> _fut.Future:
        return self._pool.submit(self._run, rows, yuv)

    def _run(self, rows: np.ndarray, yuv: bool) -> tuple:
        with torch.cuda.device(self.device) if self.device.type == "cuda" else _NULL_CTX:
            with annotate("serve.h2d"):
                x = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
            out = tuple(to_host(o) for o in (self.forward_yuv if yuv else self.forward)(x))
        self.batches += 1
        return out


class Predictor:
    """Holds the model on its device (or a replica on each of its devices)
    and the serving forwards; thread-safe for requests."""

    def __init__(self, model: torch.nn.Module,
                 variables: Optional[Dict[str, torch.Tensor]],
                 model_type: str, checkpoint_path: Optional[str] = None,
                 enhanced_agent: Optional[Any] = None,
                 extractor: Optional[Any] = None, device: Any = "cuda",
                 devices: Optional[Sequence[Any]] = None):
        """``variables``: a ``state_dict`` loaded strictly into ``model``,
        or None to serve the weights the model holds. ``enhanced_agent``:
        an ``agents.enhanced.EnhancedDecisionAgent``, consulted for
        ensembles. ``extractor``: a ``FaceExtractor`` (by default one on
        the first device, configured from the environment). ``devices``:
        the replicas' devices (:func:`serving_devices` picks them from
        ``device`` when None)."""
        if model_type not in _PRETRAINED_TYPES + _LEGACY_TYPES:
            raise ValueError(f"unknown model_type {model_type!r}")
        devs = serving_devices(model_type, device, devices)
        self.device = devs[0]
        if variables is not None:
            model.load_state_dict(variables, strict=True)
        self.model = model.to(self.device).eval()
        self.model_type = model_type
        self.checkpoint_path = checkpoint_path
        self.enhanced_agent = enhanced_agent
        self.extractor = extractor or FaceExtractor(device=self.device)

        self._batcher = None
        self._replicas: List[_Replica] = []
        self._n_dp = len(devs)
        if model_type in _LEGACY_TYPES:
            self._forward_legacy = make_legacy_forward(self.model, model_type, self.device)
        else:
            is_ensemble = model_type == "ensemble_pretrained" or hasattr(model, "members")
            size = self.extractor.face_size
            self._forward, self._forward_yuv = make_forward_fns(self.model, is_ensemble,
                                                                size)
            if self._n_dp > 1:
                # the model as it is served (int8 weights included), copied
                self._replicas = [_Replica(self.model, self.device, is_ensemble, size)] + [
                    _Replica(copy.deepcopy(self.model).to(d), d, is_ensemble, size)
                    for d in devs[1:]]

        # dynamic micro-batching: concurrent requests coalesce into one
        # batched device step. The item functions are bound once so the
        # batcher can group calls by function identity. The legacy path
        # runs one forward a request, as in the JAX package.
        if model_type not in _LEGACY_TYPES and env_bool("SERVE_MICROBATCH", True):
            self._batcher = MicroBatcher(
                max_batch=max(1, env_int("SERVE_MICROBATCH_MAX", 16)),
                max_wait_s=env_float("SERVE_MICROBATCH_WAIT_MS", 4.0) / 1e3,
                bucket_multiple=self._n_dp)
            self._fwd_item = lambda stacked: self._run(stacked, yuv=False)
            self._fwd_yuv_item = lambda stacked: self._run(stacked, yuv=True)

        # admission control for the host-bound extraction stage (decode and
        # face detection): without it, many concurrent requests each run
        # their GIL-free extraction at once and thrash a small host instead
        # of queueing. SERVE_EXTRACT_CONCURRENCY overrides (0 = off).
        n_ex = env_int("SERVE_EXTRACT_CONCURRENCY", max(2, os.cpu_count() or 1))
        self._extract_sem = threading.BoundedSemaphore(n_ex) if n_ex > 0 else None

        # startup warmup (default on) in a background thread: builds the
        # kernels and runs every batch shape once, so the first requests do
        # not pay for it. A failure does not take the server down; it is
        # logged and kept in ``warmup_error`` (an explain failure in
        # ``explain_error``).
        self.warmup_error: Optional[BaseException] = None
        self.explain_error: Optional[BaseException] = None
        self.warmup_done = threading.Event()
        if env_bool("SERVE_WARMUP", True):
            threading.Thread(target=self.warmup, name="predictor-warmup",
                             daemon=True).start()
        else:
            self.warmup_done.set()

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        with annotate("serve.h2d"):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _run(self, rows: np.ndarray, yuv: bool) -> tuple:
        """The serving forward (RGB or packed YUV) on a host batch: on the
        one device, or split into equal row shards, one a replica, and
        gathered on the host in row order."""
        if not self._replicas:
            x = self._to_device(rows)
            with annotate("serve.forward"):
                return (self._forward_yuv if yuv else self._forward)(x)
        n, r = divmod(rows.shape[0], self._n_dp)
        if r:
            raise ValueError(f"a batch of {rows.shape[0]} does not split over "
                             f"{self._n_dp} replicas")
        futures = [rep.submit(rows[i * n:(i + 1) * n], yuv)
                   for i, rep in enumerate(self._replicas)]
        _fut.wait(futures)
        parts = [f.result() for f in futures]
        # (probs, logits, frame_scores, member_logits): member logits are
        # (M, B, C), batch axis 1
        return tuple(None if parts[0][j] is None else
                     np.concatenate([p[j] for p in parts], axis=ax)
                     for j, ax in enumerate((0, 0, 0, 1)))

    def warmup(self) -> None:
        """Run the RGB and the packed-YUV forward once at every batch shape
        serving can produce, on every replica: the replica count (1 on one
        device), the windowed scan's W padded to a multiple of it, and
        every micro-batch bucket (the legacy path: its one shape, a
        16-frame clip)."""
        try:
            T = max(1, min(64, env_int("MAX_FRAMES", 8)))
            size = self.extractor.face_size
            if self.model_type in _LEGACY_TYPES:
                frames = torch.zeros((1, LEGACY_FRAMES, size, size, 3), dtype=torch.uint8,
                                     device=self.device)
                to_host(self._forward_legacy(frames))
                return
            windows = max(1, min(64, env_int("SERVE_WINDOWS", 1)))
            n_dp = self._n_dp
            batch_sizes = [n_dp]
            if windows > 1:
                batch_sizes.append(-(-windows // n_dp) * n_dp)
            if self._batcher is not None:
                batch_sizes.extend(self._batcher.bucket_sizes())
            for b in dict.fromkeys(batch_sizes):  # dedupe, keep order
                to_host(self._run(np.zeros((b, T, size * size * 3 // 2), np.uint8),
                                  yuv=True)[0])
                to_host(self._run(np.zeros((b, T, size, size, 3), np.uint8),
                                  yuv=False)[0])
            if env_bool("SERVE_EXPLAIN", True) and env_bool("SERVE_EXPLAIN_WARMUP", False):
                # off by default: most deployments never explain
                self.explain_faces(np.zeros((T, size, size, 3), np.uint8))
        except Exception as e:  # warmup must never take the server down
            logger.exception("serving warmup failed")
            self.warmup_error = e
        finally:
            self.warmup_done.set()

    def close(self) -> None:
        """Close the batcher. Requests in flight and later ones still get
        their verdicts: the batcher drains what it holds and runs a later
        request alone, on the same device or replicas."""
        if self._batcher is not None:
            self._batcher.close()

    # ------------------------------------------------------------------

    def predict_video(self, video_path: str, explain: bool = False) -> Dict[str, Any]:
        """The verdict on a video file; any exception comes back as
        ``{"error": str(e)}``, so the caller always gets a dict."""
        try:
            return self._predict(video_path, explain=explain)
        except Exception as e:
            return {"error": str(e)}

    def predict_faces(self, faces: np.ndarray, video_id: str = "video",
                      explain: bool = False) -> Dict[str, Any]:
        """Run the decision policy on pre-extracted face crops
        (T, H, W, 3) uint8 RGB. ``explain`` adds the ``saliency`` key
        unless ``SERVE_EXPLAIN`` is off, as in :meth:`predict_video`; the
        legacy types ignore it."""
        if self.model_type in _LEGACY_TYPES:
            return self._predict_legacy(faces)
        return self._predict_pretrained(faces, video_id,
                                        explain=explain and env_bool("SERVE_EXPLAIN", True))

    def explain_faces(self, faces: np.ndarray) -> Optional[Dict[str, Any]]:
        """Per-frame spatial saliency for ``faces`` (T, H, W, 3) uint8 RGB:
        the ``saliency`` result key. None for the legacy types.
        ``FAKE_CLASS_INDEX`` is read at every call."""
        if self.model_type not in _PRETRAINED_TYPES:
            return None
        fake_idx = _get_fake_class_index(int(getattr(self.model, "num_classes", 2)))
        grids = make_saliency_fn(self.model, fake_idx=fake_idx)(
            self._to_device(np.asarray(faces)[None]))
        return saliency_payload(to_host(grids)[0])

    @staticmethod
    def _pad_to_fixed_scan_shape(faces: np.ndarray, windows: int,
                                 total: int) -> np.ndarray:
        """Cycle-pad an under-length windowed extraction up to ``total``
        frames, so the windowed forward always sees (windows, MAX_FRAMES,
        ...). Clips below ``MIN_FACES`` pass unpadded, so the abstain gate
        sees the true count."""
        n = int(faces.shape[0])
        if windows <= 1 or n >= total or n < max(1, env_int("MIN_FACES", 2)):
            return faces
        return faces[np.arange(total) % n]

    def _predict(self, video_path: str, explain: bool = False) -> Dict[str, Any]:
        # SERVE_EXPLAIN (default on) gates explain here too, so a disabled
        # explain does not force the RGB path
        explain = explain and env_bool("SERVE_EXPLAIN", True)
        if self.model_type in _LEGACY_TYPES:
            with self._extract_sem or _NULL_CTX:
                faces = self.extractor.extract_from_video(video_path)
            if faces.shape[0] == 0:
                return {"error": "No faces detected in video"}
            return self._predict_legacy(faces)
        max_frames = max(1, min(64, env_int("MAX_FRAMES", 8)))
        # long-video scanning: SERVE_WINDOWS = W > 1 samples W·T frames over
        # the whole clip, and the most suspicious window decides
        windows = max(1, min(64, env_int("SERVE_WINDOWS", 1)))
        total = max_frames * windows
        video_id = os.path.basename(video_path)
        if (self.extractor.detector in ("center", "haar") and not explain
                and not self.extractor.keep_all
                and env_bool("SERVE_YUV_TRANSFER", True)):
            # packed YUV420 crops from inside the native decoder (haar
            # detects there too, on the luma plane); explain requests take
            # the RGB path, since saliency differentiates the RGB forward
            with self._extract_sem or _NULL_CTX:
                packed = self.extractor.extract_from_video_yuv(video_path, max_frames=total)
            if packed.shape[0] == 0:
                return {"error": "No faces detected in video"}
            n_extracted = int(packed.shape[0])
            packed = self._pad_to_fixed_scan_shape(packed, windows, total)
            return self._predict_pretrained(packed, video_id, packed_yuv=True,
                                            windows=windows, n_extracted=n_extracted)
        with self._extract_sem or _NULL_CTX:
            faces = self.extractor.extract_from_video(video_path, max_frames=total,
                                                      spread=windows > 1)
        if faces.shape[0] == 0:
            return {"error": "No faces detected in video"}
        n_extracted = int(faces.shape[0])
        faces = self._pad_to_fixed_scan_shape(faces, windows, total)
        return self._predict_pretrained(faces, video_id, windows=windows,
                                        n_extracted=n_extracted, explain=explain)

    def _predict_legacy(self, faces: np.ndarray) -> Dict[str, Any]:
        """The JAX package's legacy policy over the CNN+LSTM or frame-graph
        detector's 16-frame probabilities."""
        abstain_conf = env_float("DETECT_ABSTAIN_CONF", 0.60)
        abstain_margin = max(0.0, min(0.5, env_float("DETECT_ABSTAIN_MARGIN", 0.0)))
        num_faces = int(faces.shape[0])
        faces = pad_or_sample_frames(np.asarray(faces), LEGACY_FRAMES)
        probs = to_host(self._forward_legacy(self._to_device(faces[None])))[0]
        fake_idx = _get_fake_class_index(probs.shape[0])
        real_idx = 1 - fake_idx if probs.shape[0] == 2 else 0
        prob_fake = float(probs[fake_idx])
        prob_real = float(probs[real_idx])
        thr = float(_detection_threshold(0.5))
        is_fake = prob_fake >= thr
        pred_class = 1 if is_fake else 0
        confidence = prob_fake if is_fake else prob_real

        if abstain_margin > 0.0 and abs(prob_fake - thr) <= abstain_margin:
            return {"prediction": "Uncertain", "verdict_yes_no": "Unsure",
                    "description": (
                        f"Borderline score (prob_fake={prob_fake * 100:.1f}%, "
                        f"thr={thr:.2f} ± {abstain_margin:.2f}). Manual review "
                        f"recommended."),
                    "pred_class": None, "confidence": float(confidence),
                    "prob_real": prob_real, "prob_fake": prob_fake,
                    "num_faces": num_faces, "threshold": thr, "abstained": True}
        if confidence < abstain_conf:
            # as in the JAX package, this branch carries no threshold
            return {"prediction": "Uncertain", "verdict_yes_no": "Unsure",
                    "description": (
                        f"Low confidence ({confidence * 100:.1f}%). This video "
                        f"may be out-of-domain. Manual review recommended."),
                    "pred_class": None, "confidence": float(confidence),
                    "prob_real": prob_real, "prob_fake": prob_fake,
                    "num_faces": num_faces, "abstained": True}
        return {
            "prediction": "Deepfake" if pred_class == 1 else "Real",
            "verdict_yes_no": "Yes" if pred_class == 1 else "No",
            "description": ("Detected indicators of synthetic manipulation in "
                            "facial frames." if pred_class == 1 else
                            "No strong signs of manipulation detected; appears "
                            "authentic."),
            "pred_class": pred_class, "confidence": float(confidence),
            "prob_real": prob_real, "prob_fake": prob_fake,
            "num_faces": num_faces, "threshold": thr,
        }

    def _predict_pretrained(self, faces: np.ndarray, video_id: str,
                            packed_yuv: bool = False, windows: int = 1,
                            n_extracted: Optional[int] = None,
                            explain: bool = False) -> Dict[str, Any]:
        with annotate("serve.request"):
            abstain_conf = env_float("DETECT_ABSTAIN_CONF", 0.60)
            abstain_margin = max(0.0, min(0.5, env_float("DETECT_ABSTAIN_MARGIN", 0.0)))
            # the number of faces actually extracted, not a padded count
            num_faces = int(faces.shape[0]) if n_extracted is None else n_extracted
            min_faces = max(1, env_int("MIN_FACES", 2))
            if num_faces < min_faces:
                return {
                    "prediction": "Uncertain", "verdict_yes_no": "Unsure",
                    "description": (
                        f"Not enough faces/frames detected for a stable decision "
                        f"(num_faces={num_faces}, min_faces={min_faces}). Try a "
                        f"clearer face shot, better lighting, or a longer clip."),
                    "pred_class": None, "confidence": None, "prob_real": None,
                    "prob_fake": None, "num_faces": num_faces, "abstained": True,
                }

            win_payload = None
            if windows > 1:
                # windowed scan: one batched forward over (W, T, ...) — the
                # windows are the batch, so this bypasses the request batcher
                T = max(1, -(-faces.shape[0] // windows))  # ceil: keep the tail
                need = windows * T
                if faces.shape[0] < need:  # repeat-pad short clips
                    pad = np.repeat(faces[-1:], need - faces.shape[0], axis=0)
                    faces = np.concatenate([faces, pad])
                faces_w = np.asarray(faces[:need]).reshape(
                    (windows, T) + faces.shape[1:])
                # over several replicas the windows must split evenly: repeat
                # the last, and slice the outputs back
                w_pad = -(-windows // self._n_dp) * self._n_dp
                if w_pad > windows:
                    faces_w = np.concatenate(
                        [faces_w, np.repeat(faces_w[-1:], w_pad - windows, axis=0)])
                probs, logits, frame_scores, member_logits = (
                    to_host(o) for o in self._run(faces_w, packed_yuv))
                probs, logits, frame_scores = probs[:windows], logits[:windows], \
                    frame_scores[:windows]
                if member_logits is not None:
                    member_logits = member_logits[:, :windows]
            elif self._batcher is not None:
                # coalesce with concurrent requests into one device step; each
                # output comes back as this request's length-1 slice
                item_fn = self._fwd_yuv_item if packed_yuv else self._fwd_item
                probs, logits, frame_scores, member_logits = self._batcher.call(
                    item_fn, np.asarray(faces), out_axes=(0, 0, 0, 1))
            else:
                fwd = self._forward_yuv if packed_yuv else self._forward
                probs, logits, frame_scores, member_logits = (
                    to_host(o) for o in fwd(self._to_device(np.asarray(faces)[None])))
            with annotate("serve.policy"):
                probs_all = np.asarray(probs)          # (W or 1, C)
                fake_idx = _get_fake_class_index(probs_all.shape[1])
                # verdict from the most-suspicious window (max prob_fake)
                widx = int(np.argmax(probs_all[:, fake_idx])) \
                    if probs_all.shape[0] > 1 else 0
                if windows > 1:
                    win_payload = {
                        "policy": "max", "count": int(probs_all.shape[0]),
                        "deciding_window": widx,
                        "prob_fake": [round(float(p), 6)
                                      for p in probs_all[:, fake_idx]],
                    }
                    if num_faces < need:
                        # frames without a detected face were dropped and the rest
                        # cycle-padded: window i is no longer the i-th time segment
                        win_payload["temporal_alignment"] = "cycled"
                        win_payload["note"] = (
                            "some sampled frames had no detected face and were "
                            "dropped before cycle-padding; window indices are "
                            "approximate, not uniform time segments")
                    else:
                        win_payload["temporal_alignment"] = "exact"
                probs = probs_all[widx]
                real_idx = 1 - fake_idx if probs.shape[0] == 2 else 0
                prob_fake = float(probs[fake_idx])
                prob_real = float(probs[real_idx])

                thr = load_calibration_threshold(self.checkpoint_path)
                thr = 0.5 if thr is None else float(thr)
                thr = float(_detection_threshold(thr))
                if not env_bool("ALLOW_EXTREME_CALIBRATION_THRESHOLD") and \
                        (thr < 0.05 or thr > 0.95):
                    thr = 0.5
                if windows > 1 and env_bool("SERVE_WINDOW_CAL", True):
                    # max-of-W inflates real-video FPR at the single-span threshold;
                    # correct via the calibration artifact's real-score CDF
                    cal = load_calibration(self.checkpoint_path) or {}
                    thr_w = windowed_threshold(thr, int(probs_all.shape[0]),
                                               cal.get("real_score_quantiles"))
                    win_payload["threshold_correction"] = {
                        "method": ("order-statistics over the calibration "
                                   "real-score quantiles"
                                   if thr_w != thr else "unavailable"),
                        "base": round(float(thr), 6),
                        "effective": round(float(thr_w), 6),
                    }
                    thr = thr_w
                is_fake = prob_fake >= thr
                pred_class = 1 if is_fake else 0
                confidence = prob_fake if is_fake else prob_real
                description = (f"Ensemble pretrained detector (thr={thr:.2f})"
                               if self.model_type == "ensemble_pretrained"
                               else f"Pretrained detector (thr={thr:.2f})")

                agent_payload = None
                if (not env_bool("DISABLE_ENHANCED_AGENT")
                        and self.enhanced_agent is not None
                        and member_logits is not None):
                    member_np = np.asarray(member_logits)[:, widx]  # (M, C)
                    x = member_np - member_np.max(-1, keepdims=True)
                    member_probs = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
                    ind = member_probs[:, fake_idx]
                    uncertainty = float(np.std(ind)) if ind.shape[0] >= 2 else 0.0
                    try:
                        # per-call overrides, not attribute writes: the agent is
                        # shared by the request threads
                        pred = self.enhanced_agent.process_ensemble_output(
                            np.asarray(logits)[widx], list(member_np),
                            np.asarray(frame_scores)[widx], video_id, uncertainty,
                            decision_threshold=thr, fake_class_index=fake_idx)
                        agent_payload = {
                            "is_fake": bool(pred.is_fake) if pred.is_fake is not None else None,
                            "ensemble_prob": float(pred.ensemble_prob),
                            "confidence": float(pred.confidence),
                            "alert_level": pred.alert_level.name,
                            "uncertainty": float(pred.uncertainty),
                            "explanation": pred.explanation,
                        }
                        description = agent_payload["explanation"] or description
                        if pred.is_fake is not None:
                            pred_class = int(pred.is_fake)
                        confidence = float(agent_payload["confidence"])
                    except Exception:
                        # as in the JAX package, a failing agent leaves the verdict to
                        # the detector; the failure is logged here
                        logger.exception("enhanced agent failed for %s", video_id)
                        agent_payload = None

                base = {"prob_real": prob_real, "prob_fake": prob_fake,
                        "num_faces": num_faces, "threshold": thr,
                        "enhanced_agent": agent_payload,
                        # the temporal attention weights of the deciding window
                        "frame_scores": [round(float(s), 4)
                                         for s in np.asarray(frame_scores)[widx]]}
                if win_payload is not None:
                    base["windows"] = win_payload
                if explain and not packed_yuv:
                    # the deciding window's spatial explanation; it rides through
                    # the abstain returns below, so an uncertain verdict still
                    # shows where the detector looked
                    try:
                        sal = self.explain_faces(
                            faces_w[widx] if windows > 1 else np.asarray(faces))
                        if sal is not None:
                            if self.extractor.detector in ("center", "haar"):
                                # these detectors' non-explain verdicts ride the
                                # packed-YUV420 path, the explanation the RGB one
                                sal["pipeline_note"] = (
                                    "saliency explains the RGB extraction pipeline; "
                                    "non-explain verdicts use the packed-YUV420 "
                                    "path, which may differ marginally near the "
                                    "decision threshold")
                            base["saliency"] = sal
                    except Exception as e:
                        # as in the JAX package the verdict stands without the key;
                        # the failure is logged and kept
                        logger.exception("saliency explain failed for %s", video_id)
                        self.explain_error = e
                if abstain_margin > 0.0 and abs(prob_fake - thr) <= abstain_margin:
                    return {
                        "prediction": "Uncertain", "verdict_yes_no": "Unsure",
                        "description": (
                            f"Borderline score (prob_fake={prob_fake * 100:.1f}%, "
                            f"thr={thr:.2f} ± {abstain_margin:.2f}). Manual review "
                            f"recommended.\n\n" + description),
                        "pred_class": None, "confidence": float(confidence),
                        "abstained": True, **base,
                    }
                if confidence < abstain_conf:
                    return {
                        "prediction": "Uncertain", "verdict_yes_no": "Unsure",
                        "description": (
                            f"Low confidence ({confidence * 100:.1f}%). This video may "
                            f"be out-of-domain (different compression, face quality, "
                            f"lighting, or manipulation type). Manual review "
                            f"recommended.\n\n" + description),
                        "pred_class": None, "confidence": float(confidence),
                        "abstained": True, **base,
                    }
                return {
                    "prediction": "Deepfake" if pred_class == 1 else "Real",
                    "verdict_yes_no": "Yes" if pred_class == 1 else "No",
                    "description": description, "pred_class": pred_class,
                    "confidence": float(confidence), **base,
                }


# ---------------------------------------------------------------------------
# human-readable messaging (≙ the JAX package's serve/predict.py helpers)
# ---------------------------------------------------------------------------


def simple_english_message(result: Optional[Dict[str, Any]],
                           filename: Optional[str] = None) -> str:
    if not isinstance(result, dict):
        return "Sorry, I could not check this video."
    if result.get("error"):
        return f"Sorry, I could not check this video. Error: {result['error']}"
    name = f" for {filename}" if filename else ""
    if result.get("abstained"):
        return (f"I am not sure about this video{name}. "
                f"Please try a clearer or longer clip.")
    conf = result.get("confidence")
    pct = f" I am {conf * 100:.0f}% sure." if isinstance(conf, float) else ""
    if result.get("pred_class") == 1:
        return f"This video{name} looks FAKE.{pct}"
    return f"This video{name} looks REAL.{pct}"


def ensure_exact_word_count(text: str, target: int = 200) -> str:
    """Pad/trim to exactly ``target`` words."""
    words = text.split()
    if len(words) > target:
        return " ".join(words[:target])
    filler = ("Please review the result carefully and use your own judgment "
              "when sharing this video with other people online.").split()
    i = 0
    while len(words) < target:
        words.append(filler[i % len(filler)])
        i += 1
    return " ".join(words)


def simple_english_justification_200_words(result: Dict[str, Any],
                                           filename: str = "") -> str:
    verdict = result.get("prediction", "Uncertain")
    conf = result.get("confidence")
    prob_fake = result.get("prob_fake")
    num_faces = result.get("num_faces", 0)
    parts = [
        f"We checked the video {filename} with our deepfake detector.",
        f"The final verdict is: {verdict}.",
    ]
    if isinstance(conf, float):
        parts.append(f"The system is about {conf * 100:.0f} percent confident "
                     f"in this verdict.")
    if isinstance(prob_fake, float):
        parts.append(f"The model gave a fake probability of "
                     f"{prob_fake * 100:.0f} percent.")
    parts.append(f"We looked at {num_faces} face pictures taken from different "
                 f"moments of the video.")
    parts.append("The detector studies each face for small signs that editing "
                 "tools leave behind, like strange skin texture, blurry edges "
                 "around the face, odd lighting, or eyes and teeth that do not "
                 "look natural.")
    parts.append("It also compares the faces across time, because fake videos "
                 "often flicker or change in ways real videos do not.")
    if result.get("abstained"):
        parts.append("This time the system was not sure enough to give a firm "
                     "answer, so it chose to say it is uncertain instead of "
                     "guessing.")
        parts.append("A clearer video with a bigger, brighter face would help "
                     "it decide.")
    elif result.get("pred_class") == 1:
        parts.append("The signs of editing were strong enough for the system "
                     "to call this video fake.")
        parts.append("Be careful before trusting or sharing it.")
    else:
        parts.append("The system did not find strong signs of editing, so the "
                     "video looks real to it.")
        parts.append("Remember that no detector is perfect, so stay careful "
                     "online.")
    return ensure_exact_word_count(" ".join(parts), 200)
