"""Pure-numpy classification metrics.

Copy of ``deepfake_video_detection_tpu/evals/metrics.py``: confusion
matrix, binary metrics, Mann-Whitney AUC, a text report, the bounded
threshold sweep (0.05–0.95 × 19) and the real-class score quantiles that
``calibration_best.json`` carries for the windowed serving threshold.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int = 2) -> np.ndarray:
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def binary_metrics(y_true, y_pred, positive: int = 1) -> Dict[str, float]:
    """accuracy / precision / recall / f1 for the positive (fake) class."""
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    acc = float(np.mean(y_true == y_pred)) if y_true.size else 0.0
    tp = int(np.sum((y_pred == positive) & (y_true == positive)))
    fp = int(np.sum((y_pred == positive) & (y_true != positive)))
    fn = int(np.sum((y_pred != positive) & (y_true == positive)))
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    rec = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    return {"accuracy": acc, "precision": prec, "recall": rec, "f1": f1}


def roc_auc(y_true, scores) -> float:
    """AUC via the Mann-Whitney U statistic (ties get half-credit)."""
    y_true = np.asarray(y_true, np.int64)
    scores = np.asarray(scores, np.float64)
    pos = scores[y_true == 1]
    neg = scores[y_true == 0]
    if pos.size == 0 or neg.size == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty(order.size, np.float64)
    ranks[order] = np.arange(1, order.size + 1)
    # average ranks over ties
    allv = np.concatenate([pos, neg])
    sv = allv[order]
    i = 0
    while i < sv.size:
        j = i
        while j + 1 < sv.size and sv[j + 1] == sv[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = ranks[order[i:j + 1]].mean()
        i = j + 1
    r_pos = ranks[: pos.size].sum()
    u = r_pos - pos.size * (pos.size + 1) / 2.0
    return float(u / (pos.size * neg.size))


def classification_report(y_true, y_pred,
                          target_names: Sequence[str] = ("real", "fake")) -> str:
    """sklearn-style text report (per-class P/R/F1/support + accuracy)."""
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    lines = [f"{'':>12} {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}"]
    for ci, name in enumerate(target_names):
        tp = int(np.sum((y_pred == ci) & (y_true == ci)))
        fp = int(np.sum((y_pred == ci) & (y_true != ci)))
        fn = int(np.sum((y_pred != ci) & (y_true == ci)))
        prec = tp / (tp + fp) if (tp + fp) else 0.0
        rec = tp / (tp + fn) if (tp + fn) else 0.0
        f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
        sup = int(np.sum(y_true == ci))
        lines.append(f"{name:>12} {prec:9.4f} {rec:9.4f} {f1:9.4f} {sup:9d}")
    acc = float(np.mean(y_true == y_pred)) if y_true.size else 0.0
    lines.append(f"{'accuracy':>12} {'':>9} {'':>9} {acc:9.4f} {y_true.size:9d}")
    return "\n".join(lines)


def threshold_sweep(
    y_true,
    prob_fake,
    thresholds: Optional[np.ndarray] = None,
    fake_index: int = 1,
) -> Dict[str, float]:
    """Bounded sweep ≙ ``src/ensemble_trainer.py:294-329``: evaluate acc and
    F1 at each threshold in [0.05, 0.95], return the argmax of each."""
    y_true = np.asarray(y_true, np.int64)
    prob_fake = np.asarray(prob_fake, np.float64)
    if thresholds is None:
        thresholds = np.linspace(0.05, 0.95, 19)
    best = {"best_thr_accuracy": 0.5, "best_accuracy": -1.0,
            "best_thr_f1": 0.5, "best_f1": -1.0}
    for thr in thresholds:
        pred = (prob_fake >= thr).astype(np.int64)
        if fake_index == 0:
            pred = 1 - pred
        m = binary_metrics(y_true, pred, positive=fake_index)
        if m["accuracy"] > best["best_accuracy"]:
            best["best_accuracy"], best["best_thr_accuracy"] = m["accuracy"], float(thr)
        if m["f1"] > best["best_f1"]:
            best["best_f1"], best["best_thr_f1"] = m["f1"], float(thr)
    return best


def real_score_quantiles(y_true, prob_fake, fake_index: int = 1,
                         n: int = 101):
    """Empirical quantiles (``n`` points, p = 0..1) of ``prob_fake`` over
    the REAL-class validation clips — written into ``calibration_best.json``
    so serving can apply the order-statistics (Šidák) threshold correction
    when a long-video scan thresholds the MAX of W window scores
    (``serve/predict.py::windowed_threshold``). Returns None when the
    validation split has no real-class samples."""
    y = np.asarray(y_true, np.int64)
    s = np.asarray(prob_fake, np.float64)
    real = s[y != fake_index]
    if real.size == 0:
        return None
    return [float(v) for v in np.quantile(real, np.linspace(0.0, 1.0, n))]


def full_metrics(y_true, prob_fake, threshold: float = 0.5,
                 fake_index: int = 1) -> Dict[str, object]:
    """The evaluator's metric bundle (≙ ``src/evaluate.py:195-284``)."""
    y_true = np.asarray(y_true, np.int64)
    prob_fake = np.asarray(prob_fake, np.float64)
    y_pred = np.where(prob_fake >= threshold, fake_index, 1 - fake_index)
    out: Dict[str, object] = dict(binary_metrics(y_true, y_pred, positive=fake_index))
    out["auc"] = roc_auc((y_true == fake_index).astype(np.int64), prob_fake)
    out["confusion_matrix"] = confusion_matrix(y_true, y_pred).tolist()
    out["threshold"] = float(threshold)
    out["report"] = classification_report(y_true, y_pred)
    return out
