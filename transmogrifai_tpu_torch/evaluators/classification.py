"""The binary and multiclass classification evaluators (host float64 numpy).

The port's copy of ``OpBinaryClassificationEvaluator`` and its metric
helpers from ``transmogrifai_tpu/evaluators/classification.py`` (reference:
evaluators/OpBinaryClassificationEvaluator.scala:56): AuROC, AuPR,
Precision, Recall, F1, Error, TP/TN/FP/FN and the threshold curves; and of
``OpMultiClassificationEvaluator`` (OpMultiClassificationEvaluator.scala:59):
Spark MulticlassMetrics' class-frequency-weighted Precision, Recall and F1
(the default), the Error, and the ``ThresholdMetrics`` of the top-N classes
(correct, incorrect and no-prediction counts at each confidence
threshold).  The calibration and log-loss evaluators are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .base import OpBinaryClassificationEvaluatorBase, OpMultiClassificationEvaluatorBase


def roc_auc(y: np.ndarray, score: np.ndarray) -> float:
    """AuROC via rank statistic (equivalent to trapezoid over the full curve)."""
    pos = score[y == 1]
    neg = score[y == 0]
    if len(pos) == 0 or len(neg) == 0:
        return 0.0
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty(len(order), dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # midrank correction for ties
    allv = np.concatenate([pos, neg])
    sorted_v = allv[order]
    i = 0
    sr = ranks[order]
    while i < len(sorted_v):
        j = i
        while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
            j += 1
        if j > i:
            sr[i:j + 1] = (i + j) / 2.0 + 1.0
        i = j + 1
    ranks[order] = sr
    r_pos = ranks[: len(pos)].sum()
    n_pos, n_neg = len(pos), len(neg)
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def pr_auc(y: np.ndarray, score: np.ndarray) -> float:
    """Area under precision-recall (step-wise, Spark BinaryClassificationMetrics
    style: first point (0, p0) then one point per distinct threshold)."""
    n_pos = int((y == 1).sum())
    if n_pos == 0:
        return 0.0
    order = np.argsort(-score, kind="mergesort")
    ys = y[order]
    ss = score[order]
    tp = np.cumsum(ys)
    fp = np.cumsum(1 - ys)
    # keep last index of each distinct score (threshold boundaries)
    distinct = np.append(ss[1:] != ss[:-1], True)
    tp_d, fp_d = tp[distinct], fp[distinct]
    precision = tp_d / np.maximum(tp_d + fp_d, 1)
    recall = tp_d / n_pos
    prev_r = 0.0
    area = 0.0
    for p, r in zip(precision, recall):
        area += p * (r - prev_r)
        prev_r = r
    return float(area)


def binary_counts(y: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    tp = float(((y == 1) & (pred == 1)).sum())
    tn = float(((y == 0) & (pred == 0)).sum())
    fp = float(((y == 0) & (pred == 1)).sum())
    fn = float(((y == 1) & (pred == 0)).sum())
    return {"TP": tp, "TN": tn, "FP": fp, "FN": fn}


class OpBinaryClassificationEvaluator(OpBinaryClassificationEvaluatorBase):
    name = "binEval"
    default_metric = "AuROC"
    is_larger_better = True

    def __init__(self, label_col: Optional[str] = None, prediction_col: Optional[str] = None,
                 num_thresholds: int = 100):
        super().__init__(label_col, prediction_col)
        self.num_thresholds = num_thresholds

    def evaluate_arrays(self, y, prediction, probability=None) -> Dict[str, Any]:
        y = np.asarray(y, dtype=np.float64)
        pred = np.asarray(prediction, dtype=np.float64)
        score = np.asarray(probability[:, 1] if probability is not None and probability.ndim == 2
                           else (probability if probability is not None else pred),
                           dtype=np.float64)
        c = binary_counts(y, pred)
        tp, tn, fp, fn = c["TP"], c["TN"], c["FP"], c["FN"]
        n = max(len(y), 1)
        precision = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
        out: Dict[str, Any] = {
            "AuROC": roc_auc(y, score),
            "AuPR": pr_auc(y, score),
            "Precision": precision,
            "Recall": recall,
            "F1": f1,
            "Error": (fp + fn) / n,
            **c,
        }
        # threshold curves (thresholds / precisionByThreshold / recallByThreshold
        # / falsePositiveRateByThreshold — OpBinaryClassificationEvaluator)
        thresholds = np.linspace(0.0, 1.0, self.num_thresholds + 1)
        p_list, r_list, fpr_list = [], [], []
        n_pos = max((y == 1).sum(), 1)
        n_neg = max((y == 0).sum(), 1)
        for t in thresholds:
            ph = (score >= t).astype(np.float64)
            tp_t = float(((y == 1) & (ph == 1)).sum())
            fp_t = float(((y == 0) & (ph == 1)).sum())
            p_list.append(tp_t / (tp_t + fp_t) if tp_t + fp_t > 0 else 1.0)
            r_list.append(tp_t / n_pos)
            fpr_list.append(fp_t / n_neg)
        out["thresholds"] = thresholds.tolist()
        out["precisionByThreshold"] = p_list
        out["recallByThreshold"] = r_list
        out["falsePositiveRateByThreshold"] = fpr_list
        return out

    def evaluate_all(self, ds, label_col=None, prediction_col=None) -> Dict[str, Any]:
        y, pred = self._extract(ds, label_col, prediction_col)
        return self.evaluate_arrays(y, pred.prediction, pred.probability)


class OpMultiClassificationEvaluator(OpMultiClassificationEvaluatorBase):
    """Multiclass metrics incl. top-K thresholded metrics
    (OpMultiClassificationEvaluator.scala:59)."""

    name = "multiEval"
    default_metric = "F1"
    is_larger_better = True

    def __init__(self, label_col: Optional[str] = None, prediction_col: Optional[str] = None,
                 top_ns: List[int] = (1, 3), thresholds: Optional[np.ndarray] = None):
        super().__init__(label_col, prediction_col)
        self.top_ns = list(top_ns)
        self.thresholds = np.linspace(0.0, 1.0, 11) if thresholds is None else thresholds

    def evaluate_arrays(self, y, prediction, probability=None) -> Dict[str, Any]:
        y = np.asarray(y, dtype=np.int64)
        pred = np.asarray(prediction, dtype=np.int64)
        n = max(len(y), 1)
        classes = np.unique(np.concatenate([y, pred]))
        # weighted precision/recall/f1 (Spark MulticlassMetrics semantics)
        precisions, recalls, f1s, weights = [], [], [], []
        for c in classes:
            tp = float(((y == c) & (pred == c)).sum())
            fp = float(((y != c) & (pred == c)).sum())
            fn = float(((y == c) & (pred != c)).sum())
            p = tp / (tp + fp) if tp + fp > 0 else 0.0
            r = tp / (tp + fn) if tp + fn > 0 else 0.0
            f = 2 * p * r / (p + r) if p + r > 0 else 0.0
            precisions.append(p)
            recalls.append(r)
            f1s.append(f)
            weights.append(float((y == c).sum()) / n)
        out: Dict[str, Any] = {
            "Precision": float(np.dot(precisions, weights)),
            "Recall": float(np.dot(recalls, weights)),
            "F1": float(np.dot(f1s, weights)),
            "Error": float((y != pred).sum()) / n,
        }
        if probability is not None and probability.ndim == 2:
            out["ThresholdMetrics"] = self._threshold_metrics(y, np.asarray(probability))
        return out

    def _threshold_metrics(self, y: np.ndarray, probability: np.ndarray) -> Dict[str, Any]:
        """Per top-N and threshold: rows whose top probability reaches the
        threshold and whose label is among the N most probable classes
        (correct), the other rows reaching it (incorrect), and per threshold
        the rows below it (no prediction)."""
        conf = probability.max(axis=1)
        order = np.argsort(-probability, axis=1)
        found = order == y[:, None]
        # labels outside the model's class range never rank (rank = n_classes)
        correct_rank = np.where(found.any(axis=1), np.argmax(found, axis=1),
                                probability.shape[1])
        no_pred_counts = [int((conf < t).sum()) for t in self.thresholds]
        correct_counts: Dict[str, Any] = {}
        incorrect_counts: Dict[str, Any] = {}
        for k in self.top_ns:
            cc, ic = [], []
            for t in self.thresholds:
                m = conf >= t
                correct = int(((correct_rank < k) & m).sum())
                cc.append(correct)
                ic.append(int(m.sum()) - correct)
            correct_counts[str(k)] = cc
            incorrect_counts[str(k)] = ic
        return {"topNs": self.top_ns, "thresholds": self.thresholds.tolist(),
                "correctCounts": correct_counts, "incorrectCounts": incorrect_counts,
                "noPredictionCounts": no_pred_counts}

    def evaluate_all(self, ds, label_col=None, prediction_col=None) -> Dict[str, Any]:
        y, pred = self._extract(ds, label_col, prediction_col)
        return self.evaluate_arrays(y, pred.prediction, pred.probability)
