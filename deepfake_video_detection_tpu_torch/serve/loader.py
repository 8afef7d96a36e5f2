"""Checkpoint resolver and model loader for serving on the card.

Counterpart of ``deepfake_video_detection_tpu/serve/loader.py``:

* :func:`load_model` reads a native ``.npz`` or any of the reference's three
  ``.pt`` layouts (``checkpoint/store.py::load_any``), serves the EMA
  sibling ``*_ema.npz`` when the checkpoint was selected on EMA metrics,
  detects the fake-class index and the ensemble size, and searches the
  candidate architectures by shape compatibility (:func:`compat_score`,
  templates built on the ``meta`` device, no memory), best first. The first
  candidate whose shape-filtered non-strict import reaches a match ratio of
  0.80 is built on the device and returned with its ``state_dict`` and the
  load stats (also in ``LAST_LOAD_STATS``), ready for
  ``Predictor(model, variables, stats["model_type"])``. With
  ``QUANTIZE=int8`` its matmul and conv weights are then held in int8 with
  per-output-channel scales (``nn/quant.py``), whatever the family;
  ``stats["quantized_weights"]`` counts them.
* :func:`rank_checkpoints_for_autoload`, :func:`pick_best_checkpoint_for_autoload`,
  :func:`build_autoload_candidates` and :func:`attempt_autoload`: the scored
  local search (dfdc200 > dfdc > ensemble folder priors, the
  ``training_history.csv`` metric as tiebreak, a penalty for an extreme
  calibrated threshold), ``MODEL_URL`` download and ``MODEL_PATH``.

The candidates by family: the temporal transformer, the CNN+LSTM (keys
``cnn.``), the frame-graph detector (keys ``gcn.``; its ViT variant told by
the embedding width), ensembles (``models.<i>.``) and the single-backbone
detector. A temporal checkpoint's block MLP (dense, or an MoE's experts) is
read from its leaves (``models/temporal_transformer.py::infer_mlp_kwargs``).
"""

from __future__ import annotations

import csv
import glob as _glob
import json
import logging
import os
import re
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepfake_video_detection_tpu_torch.checkpoint.store import load_any
from deepfake_video_detection_tpu_torch.checkpoint.torch_bridge import (
    canonicalize_detector_keys, detect_fake_index, import_into_model,
    infer_ensemble_count)
from deepfake_video_detection_tpu_torch.evals.evaluate import (
    infer_vit_variant_from_state_dict)
from deepfake_video_detection_tpu_torch.models.backbone_detector import (
    BackboneDetector, EnsembleDetector)
from deepfake_video_detection_tpu_torch.models.cnn_lstm import CNNLSTMHybrid
from deepfake_video_detection_tpu_torch.models.gcn import FrameGraphDetector
from deepfake_video_detection_tpu_torch.models.temporal_transformer import (
    TemporalTransformerDetector, infer_mlp_kwargs, normalize_state_dict)
from deepfake_video_detection_tpu_torch.nn import init as I
from deepfake_video_detection_tpu_torch.nn.quant import quantize_module
from deepfake_video_detection_tpu_torch.utils.config import env_int, env_str
from deepfake_video_detection_tpu_torch.utils.device import resolve_device, serving_dtype

logger = logging.getLogger(__name__)

LAST_LOAD_STATS: Dict[str, Any] = {}

# candidate backbone presets by ensemble size
_ENSEMBLE_PRESETS: Dict[int, List[List[str]]] = {
    2: [["efficientnet_b0", "resnet18"],
        ["efficientnet_b0", "efficientnet_b0"],
        ["resnet18", "resnet18"],
        ["efficientnet_b0", "resnet34"]],
    3: [["efficientnet_b0", "resnet18", "resnet34"],
        ["efficientnet_b0", "efficientnet_b0", "resnet18"]],
}
_SINGLE_CANDIDATES = ["efficientnet_b0", "resnet18", "resnet34", "resnet50",
                      "vit_base_patch16_224"]


def infer_backbone_from_keys(sd: Dict[str, Any], filename: str = "") -> Optional[str]:
    """The backbone told by its key signature, else by the file name."""
    keys = list(sd)
    if any(".conv_pwl." in k or "conv_stem" in k for k in keys):
        return "efficientnet_b0"
    if any("patch_embed" in k or "cls_token" in k for k in keys):
        return "vit_base_patch16_224"
    if any(re.search(r"layer4\.\d+\.conv3\.", k) for k in keys):
        return "resnet50"
    if any(re.search(r"layer4\.\d+\.conv1\.", k) for k in keys):
        # basic-block resnets: 18 and 34 differ in layer3's depth
        depths = {int(m.group(1)) for k in keys
                  for m in [re.search(r"layer3\.(\d+)\.", k)] if m}
        return "resnet34" if depths and max(depths) >= 2 else "resnet18"
    low = filename.lower()
    for name in _SINGLE_CANDIDATES:
        if name.split("_")[0] in low:
            return name
    return None


def compat_score(sd: Dict[str, Any], build) -> float:
    """Fraction of the template's ``state_dict`` entries whose checkpoint
    entry has the same shape. ``build(device)`` makes the template; it is
    built on the ``meta`` device, which allocates and draws nothing."""
    with I.shapes_only():
        template = build(torch.device("meta")).state_dict()
    if not template:
        return 0.0
    hits = sum(1 for k, t in template.items()
               if k in sd and tuple(np.shape(sd[k])) == tuple(t.shape))
    return hits / len(template)


def _strip_member(sd: Dict[str, Any], i: int) -> Dict[str, Any]:
    prefix = f"models.{i}."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _quantize_mode() -> str:
    """``QUANTIZE`` (weights at rest): ``int8`` or ``none``; unknown values
    warn and serve unquantized, as in the JAX loader."""
    mode = (env_str("QUANTIZE", "none") or "none").lower()
    if mode in ("", "none", "0", "false", "off"):
        return "none"
    if mode != "int8":
        logger.warning("QUANTIZE=%r not supported (int8|none); serving unquantized", mode)
        return "none"
    return mode


def load_model(path: str, model_type: Optional[str] = None, device: Any = "cuda"
               ) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor], Dict[str, Any]]:
    """Resolve and load a serving model: ``(model on device, its
    state_dict, stats)``. Activations in ``serving_dtype(device)``.

    Raises ``ValueError`` when no candidate reaches match ratio 0.80."""
    quantize = _quantize_mode() == "int8"
    dev = resolve_device(device)
    sd, meta = load_any(path)
    if (meta.get("metrics_scored_on") == "ema"
            and path.endswith(".npz") and not path.endswith("_ema.npz")):
        # the best checkpoint was selected on its EMA weights' metrics:
        # serve those, from the sibling *_ema.npz
        ema_path = path[:-len(".npz")] + "_ema.npz"
        if os.path.exists(ema_path):
            logger.info("checkpoint %s was selected on EMA metrics; serving the "
                        "EMA weights from %s", path, ema_path)
            path = ema_path
            sd, meta = load_any(ema_path)
        else:
            logger.warning("checkpoint %s records EMA-scored metrics but no sibling "
                           "_ema.npz exists; serving RAW weights whose quality may "
                           "differ from the recorded metrics", path)
    cfg = meta.get("model_config") or {}
    fake_idx = detect_fake_index(meta)
    n_members = infer_ensemble_count(sd)
    fname = os.path.basename(path)
    requested = (model_type or "").strip().lower() or cfg.get("model_type") or None
    cdt = serving_dtype(dev)

    # (model type, function making the model on a device, canonical state dict)
    candidates: List[Tuple[str, Any, Dict[str, Any]]] = []
    if requested in ("temporal", "temporal_transformer") or (
            requested is None and "cls_token" in sd
            and any(k.startswith("backbone.") for k in sd)):
        sd = normalize_state_dict(sd)
        name = cfg.get("backbone") or infer_backbone_from_keys(
            {k[len("backbone."):]: v for k, v in sd.items()
             if k.startswith("backbone.")}, fname) or "efficientnet_b0"
        use_cls = "cls_token" in sd
        if use_cls:
            d_model = int(np.shape(sd["cls_token"])[-1])
        elif "proj.weight" in sd:  # use_cls=False: mean pool
            d_model = int(np.shape(sd["proj.weight"])[0])
        else:
            raise ValueError(f"{fname}: temporal checkpoint lacks both cls_token and "
                             "proj.weight — cannot infer d_model")
        depth = 1 + max((int(k.split(".")[1]) for k in sd if k.startswith("blocks.")),
                        default=3)
        kw = dict(d_model=d_model, depth=depth, num_heads=cfg.get("num_heads", 4),
                  use_cls=use_cls, compute_dtype=cdt, **infer_mlp_kwargs(sd, d_model, cfg))
        with I.shapes_only():  # an unknown backbone raises here
            TemporalTransformerDetector(name, device="meta", **kw)
        candidates.append(("temporal", lambda d, name=name, kw=kw:
                           TemporalTransformerDetector(name, device=d, **kw), sd))
    elif requested == "cnn_lstm" or (requested is None
                                     and any(k.startswith("cnn.") for k in sd)):
        candidates.append(("cnn_lstm", lambda d: CNNLSTMHybrid(compute_dtype=cdt, device=d),
                           sd))
    elif requested in ("vit_gcn", "gcn") or (requested is None
                                             and any(k.startswith("gcn.") for k in sd)):
        variant = cfg.get("vit_variant") or infer_vit_variant_from_state_dict(sd)
        candidates.append(("vit_gcn", lambda d: FrameGraphDetector(
            vit_variant=variant, compute_dtype=cdt, device=d), sd))
    elif n_members > 0:
        combos = []
        if cfg.get("backbones"):
            combos.append(list(cfg["backbones"]))
        inferred = infer_backbone_from_keys(_strip_member(sd, 0), fname)
        if inferred:
            combos.append([inferred] * n_members)
        combos += _ENSEMBLE_PRESETS.get(n_members, [["efficientnet_b0"] * n_members])
        method = cfg.get("ensemble_method", "average")
        seen = set()
        for combo in combos:
            if tuple(combo) in seen or len(combo) != n_members:
                continue
            seen.add(tuple(combo))
            # canonicalize each member's Sequential indices
            fixed = {}
            for i in range(n_members):
                member = canonicalize_detector_keys(_strip_member(sd, i), combo[i])
                fixed.update({f"models.{i}.{k}": v for k, v in member.items()})
            fixed.update({k: v for k, v in sd.items() if not k.startswith("models.")})
            candidates.append(("ensemble_pretrained", lambda d, combo=combo:
                               EnsembleDetector(combo, ensemble_method=method,
                                                compute_dtype=cdt, device=d), fixed))
    else:
        names = []
        cfg_backbone = cfg.get("backbone") or cfg.get("backbone_name")
        if cfg_backbone:
            names.append(cfg_backbone)
        inferred = infer_backbone_from_keys(sd, fname)
        if inferred:
            names.append(inferred)
        names += [n for n in _SINGLE_CANDIDATES if n not in names]
        for name in names:
            candidates.append(("pretrained", lambda d, name=name:
                               BackboneDetector(name, compute_dtype=cdt, device=d),
                               canonicalize_detector_keys(sd, name)))

    # score the candidates by shape compatibility, best first
    scored = []
    for mtype, build, csd in candidates:
        try:
            scored.append((compat_score(csd, build), mtype, build, csd))
        except Exception:
            continue
    scored.sort(key=lambda t: -t[0])

    for score, mtype, build, csd in scored:
        if score < 0.5:  # don't bother instantiating hopeless candidates
            continue
        model = build(dev)
        report = import_into_model(model, csd)
        if report["match_ratio"] >= 0.80:
            n_quant = 0
            if quantize:
                # after the import, so that every checkpoint format gets it
                n_quant = quantize_module(model)
                logger.info("QUANTIZE=int8: %d weight tensors quantized", n_quant)
            stats = {
                "path": path, "model_type": mtype,
                "match_ratio": report["match_ratio"],
                "matched": len(report["matched"]),
                "missing": len(report["missing"]),
                "unexpected": len(report["unexpected"]),
                "shape_mismatch": len(report["shape_mismatch"]),
                "fake_class_index": fake_idx,
                "compat_score": score,
                "backbones": getattr(model, "backbone_names",
                                     getattr(model, "backbone_name", None)),
                "quantized_weights": n_quant,
            }
            LAST_LOAD_STATS.clear()
            LAST_LOAD_STATS.update(stats)
            return model.eval(), model.state_dict(), stats
        del model
    best = scored[0][0] if scored else 0.0
    raise ValueError(f"no candidate architecture matched checkpoint {path} "
                     f"(best match ratio {best:.2f} < 0.80)")


# ---------------------------------------------------------------------------
# autoload candidate scoring
# ---------------------------------------------------------------------------


def _history_best_metric(folder: str) -> float:
    """The best F1 or accuracy in ``training_history.csv`` (tiebreak)."""
    path = os.path.join(folder, "training_history.csv")
    if not os.path.exists(path):
        return 0.0
    best = 0.0
    try:
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                for key in ("f1", "val_f1", "accuracy", "val_acc"):
                    try:
                        best = max(best, float(row.get(key, 0) or 0))
                    except ValueError:
                        pass
    except OSError:
        return 0.0
    return best


def calibration_penalty(folder: str) -> float:
    """5 for a calibrated threshold below 0.05 or above 0.95, else 0."""
    path = os.path.join(folder, "calibration_best.json")
    if not os.path.exists(path):
        return 0.0
    try:
        with open(path) as f:
            thr = float(json.load(f).get("best_thr_accuracy", 0.5))
        if thr < 0.05 or thr > 0.95:
            return 5.0
    except (OSError, ValueError):
        return 0.0
    return 0.0


def rank_checkpoints_for_autoload(root: str = "checkpoints") -> List[str]:
    """Every checkpoint under ``root``, best score first: the folder prior,
    the best pattern class of each folder, the history tiebreak, minus the
    calibration penalty. Autoload walks the list until one loads."""
    patterns = ["checkpoint_best*.npz", "checkpoint_best*.pt",
                "checkpoint_epoch_*.npz", "*.pt", "*.npz"]
    found: List[Tuple[float, str]] = []
    for dirpath, _, _files in os.walk(root):
        low = dirpath.lower()
        prior = 0.0
        if "dfdc200" in low:
            prior = 30.0
        elif "dfdc" in low:
            prior = 20.0
        elif "ensemble" in low:
            prior = 10.0
        for rank, pat in enumerate(patterns):
            hits = sorted(_glob.glob(os.path.join(dirpath, pat)))
            for p in hits:
                score = prior + (10 - rank) + _history_best_metric(dirpath) \
                    - calibration_penalty(dirpath)
                found.append((score, p))
            if hits:
                break  # the best pattern class of each folder only
    found.sort(key=lambda t: (-t[0], t[1]))
    return [p for _, p in found]


def pick_best_checkpoint_for_autoload(root: str = "checkpoints") -> Optional[str]:
    ranked = rank_checkpoints_for_autoload(root)
    return ranked[0] if ranked else None


def download_checkpoint(url: str, dest_dir: str = "checkpoints") -> Optional[str]:
    """Fetch ``url`` into ``dest_dir`` once (``MODEL_FILENAME`` names it);
    None when the fetch fails."""
    os.makedirs(dest_dir, exist_ok=True)
    fname = env_str("MODEL_FILENAME") or os.path.basename(url.split("?")[0]) \
        or "model.pt"
    dest = os.path.join(dest_dir, fname)
    if os.path.exists(dest):
        return dest
    timeout = env_int("MODEL_DOWNLOAD_TIMEOUT", 60)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, \
                open(dest + ".part", "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(dest + ".part", dest)
        return dest
    except Exception:
        try:
            os.remove(dest + ".part")
        except OSError:
            pass
        return None


def build_autoload_candidates(root: str = "checkpoints"
                              ) -> List[Tuple[str, Optional[str]]]:
    """Ordered ``(path, model_type)`` candidates: ``MODEL_URL`` download,
    ``MODEL_PATH``, the eight best of the scored search, legacy names."""
    out: List[Tuple[str, Optional[str]]] = []
    url = env_str("MODEL_URL") or env_str("CHECKPOINT_URL")
    if url:
        p = download_checkpoint(url, root)
        if p:
            out.append((p, env_str("MODEL_TYPE")))
    explicit = env_str("MODEL_PATH") or env_str("CHECKPOINT_PATH")
    if explicit and os.path.exists(explicit):
        out.append((explicit, env_str("MODEL_TYPE")))
    for path in rank_checkpoints_for_autoload(root)[:8]:
        out.append((path, None))
    for legacy in ("checkpoints/checkpoint_best.pt",
                   "checkpoints/checkpoint_best.npz",
                   "checkpoints/vit_gnn_ckpt.pt"):
        if os.path.exists(legacy):
            out.append((legacy, None))
    return out


def attempt_autoload(root: str = "checkpoints", device: Any = "cuda"):
    """Try the candidates until one loads: ``(model, variables, stats)`` or
    None."""
    for path, mtype in build_autoload_candidates(root):
        try:
            return load_model(path, mtype, device)
        except Exception:
            continue
    return None
