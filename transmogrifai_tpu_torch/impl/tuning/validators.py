"""Validators — cross-validation / train-validation-split over a model grid.

The port's counterpart of ``transmogrifai_tpu/impl/tuning/validators.py``
(reference: OpValidator.scala:94, OpCrossValidation.scala:42); the
train-validation split is not ported.  Folds are weight masks over one dataset
(``train_w`` zeroes the held-out rows), so every fold trains on the same
rows.  The sweep routes as the JAX package's does by default: the fused
sweep (``_fused_sweep``: ``impl/sweep_fragments.build_sweep_plan`` then
``ops/sweep.run_sweep``, metrics on the device) whenever the candidates
build a plan, else the per-family path (``_family_sweep``: an estimator's
``fit_grid_folds`` trains its whole fold x grid block, or, where it has no
batched fit, each candidate is fitted fold by fold; the metrics come from
the evaluator's ``evaluate_arrays`` on the host in float64).  The mesh is
not ported.  On the per-family path a candidate whose fit, prediction or
evaluation raises is recorded with its error and the worst metric, and the
sweep goes on (OpValidator.scala:323-353), except for a kernel fault
(``ops/cuda_build.KernelError``, a CUDA error) and an unported branch
(``NotImplementedError``), which end the sweep: no fallback hides a kernel
or a branch the port lacks.  The JAX package's fallback from a failed
batched fit to the candidate loop is not ported: a batched fit that raises
``NotImplementedError`` declines to the loop, any other error of it ends the
sweep.  On
the fused path a candidate whose metric is not finite is recorded as
failed, and any error ends the sweep.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import logging
import time

import numpy as np
import torch

from ...evaluators.base import OpEvaluatorBase, OpMultiClassificationEvaluatorBase
from ...ops.cuda_build import KernelError

log = logging.getLogger(__name__)

#: exceptions a candidate's fit may not absorb: a kernel fault and an
#: unported branch surface instead of becoming a lost candidate
_SURFACING = (NotImplementedError,
              *((torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ()))

#: reference ValidatorParamDefaults (OpValidator.scala:373-380)
DEFAULT_NUM_FOLDS = 3
#: the fused sweep's bound on one launch's score bytes (F x C x n float32),
#: the JAX package's default: larger candidate lists run as several plans
FUSED_SCORES_BYTES = 3e8


@dataclass
class ModelEvaluation:
    """Per-candidate validation record (reference ModelEvaluation in
    ModelSelectorSummary.scala)."""

    model_uid: str
    model_name: str
    model_type: str
    grid: Dict[str, Any]
    metric_name: str
    fold_metrics: List[float]
    metric_value: float  # mean over folds
    error: Optional[str] = None


@dataclass
class ValidationSummary:
    """All candidates' results + the winner."""

    validation_type: str
    evaluator_name: str
    metric_name: str
    is_larger_better: bool
    results: List[ModelEvaluation] = field(default_factory=list)
    best_index: int = -1

    @property
    def best(self) -> ModelEvaluation:
        return self.results[self.best_index]

    def to_json(self) -> Dict[str, Any]:
        return {
            "validationType": self.validation_type,
            "evaluator": self.evaluator_name,
            "metric": self.metric_name,
            "isLargerBetter": self.is_larger_better,
            "bestModelUID": self.best.model_uid if self.results else None,
            "bestModelName": self.best.model_name if self.results else None,
            "bestGrid": self.best.grid if self.results else None,
            "results": [
                {"modelUID": r.model_uid, "modelName": r.model_name,
                 "modelType": r.model_type, "grid": {k: _j(v) for k, v in r.grid.items()},
                 "metric": r.metric_name, "foldMetrics": r.fold_metrics,
                 "metricValue": r.metric_value, "error": r.error}
                for r in self.results
            ],
        }


def _j(v):
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        return v.item()
    return v


def make_fold_weights(n: int, n_folds: int, seed: int = 42,
                      stratify_labels: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(train_w [n_folds, n], val_w [n_folds, n]) 0/1 mask pairs; stratified,
    each label class's rows are dealt round-robin across folds
    (``transmogrifai_tpu/parallel/sweep.py::make_fold_weights``)."""
    rng = np.random.default_rng(seed)
    assign = np.empty(n, dtype=np.int64)
    if stratify_labels is not None:
        labels = np.asarray(stratify_labels)
        for cls in np.unique(labels):
            idx = np.where(labels == cls)[0]
            rng.shuffle(idx)
            assign[idx] = np.arange(idx.size) % n_folds
    else:
        assign = rng.permutation(n) % n_folds
    val = np.stack([(assign == k).astype(np.float32) for k in range(n_folds)])
    return 1.0 - val, val


class OpValidator:
    """Base validator (OpValidator.scala:94)."""

    validation_type = "validator"

    def __init__(self, evaluator: OpEvaluatorBase, seed: int = 42,
                 stratify: bool = False):
        self.evaluator = evaluator
        self.seed = seed
        self.stratify = stratify
        #: host seconds of the fused sweeps by part (fista, forest, gbt,
        #: metrics), added up over calls; the caller resets it
        self.sweep_timings: Dict[str, float] = {}

    # ---- folds -------------------------------------------------------------
    def make_folds(self, n: int, y: Optional[np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(train_w f32[F, n], val_mask bool[F, n])."""
        raise NotImplementedError

    # ---- the sweep ---------------------------------------------------------
    def validate(self, candidates: Sequence[Tuple[Any, Sequence[Dict[str, Any]]]],
                 X, y: np.ndarray, prep_w: Optional[np.ndarray] = None) -> ValidationSummary:
        """Validate every (estimator, param-grid) candidate on X (a float32
        tensor on the training device).  ``prep_w`` is the splitter's
        preparation weight vector, folded into every fold's training
        weights."""
        n = len(y)
        train_w, val_mask = self.make_folds(n, y if self.stratify else None)
        if prep_w is not None:
            train_w = train_w * prep_w[None, :].astype(np.float32)
            # rows the splitter dropped (weight 0) must not score either
            val_mask = val_mask & (prep_w > 0)[None, :]
        summary = ValidationSummary(
            validation_type=self.validation_type,
            evaluator_name=self.evaluator.name,
            metric_name=self.evaluator.default_metric,
            is_larger_better=self.evaluator.is_larger_better)
        self._sweep(candidates, X, y, train_w, val_mask, summary)
        if not summary.results or all(r.error for r in summary.results):
            raise RuntimeError("All models in the selector grid failed to fit")
        vals = [r.metric_value for r in summary.results]
        summary.best_index = int(np.argmax(vals) if self.evaluator.is_larger_better
                                 else np.argmin(vals))
        return summary

    def _sweep(self, candidates, X, y, train_w, val_mask, summary) -> None:
        """The fused sweep where the candidates build a plan, else the
        per-family sweep."""
        if not self._fused_sweep(candidates, X, y, train_w, val_mask, summary):
            self._family_sweep(candidates, X, y, train_w, val_mask, summary)

    def _fused_sweep(self, candidates, X, y, train_w, val_mask, summary) -> bool:
        """Every candidate's fold metrics from fused sweep plans (one per
        chunk of candidates whose [F, C, n] scores, [F, C, n, k] for a
        multiclass evaluator, fit ``FUSED_SCORES_BYTES``);
        False, with the summary untouched, when a chunk builds no plan."""
        from ..sweep_fragments import build_sweep_plan

        per_cand = train_w.shape[0] * len(y) * 4.0
        if isinstance(getattr(self.evaluator, "inner", self.evaluator),
                      OpMultiClassificationEvaluatorBase):  # [F, C, n, k] probabilities
            per_cand *= max(int(np.max(np.asarray(y))) + 1, 2)
        chunks = _chunk_candidates(candidates,
                                   max(int(FUSED_SCORES_BYTES // max(per_cand, 1.0)), 1))
        plans, xb_cache = [], {}
        for chunk in chunks:
            plan = build_sweep_plan(chunk, X, y, train_w, self.evaluator, xb_cache)
            if plan is None:
                return False
            plans.append(plan)
        metrics = np.concatenate([p.run(train_w, val_mask, timings=self.sweep_timings)
                                  for p in plans], axis=1)
        mi = plans[0].metric_names.index(self.evaluator.default_metric)
        bad = -np.inf if self.evaluator.is_larger_better else np.inf
        ci = 0
        for est, grids in candidates:
            for grid in (list(grids) or [{}]):
                fm = [float(v) for v in metrics[:, ci, mi]]
                value = float(np.mean(fm))
                err = None
                if not np.isfinite(value):  # a failed candidate, never selected
                    value = bad
                    err = f"non-finite {self.evaluator.default_metric} on device"
                summary.results.append(ModelEvaluation(
                    model_uid=est.uid, model_name=type(est).__name__,
                    model_type=type(est).__name__, grid=dict(grid),
                    metric_name=self.evaluator.default_metric,
                    fold_metrics=fm, metric_value=value, error=err))
                ci += 1
        return True

    def _family_sweep(self, candidates, X, y, train_w, val_mask, summary) -> None:
        """The per-family sweep: one ``fit_grid_folds`` per family (a family
        without one fits candidate by candidate), metrics on the validation
        rows of every fold; a failed candidate is recorded and skipped.  Each
        family's host seconds (synchronized with the device) go to
        ``sweep_timings`` under its class name."""
        bad = -np.inf if self.evaluator.is_larger_better else np.inf
        for est, grids in candidates:
            grids = list(grids) or [{}]
            t0 = time.perf_counter()
            try:
                preds = est.fit_grid_folds(X, y, train_w, grids)
            except NotImplementedError:  # no batched fit for these grids
                preds = None
            for ci, grid in enumerate(grids):
                fold_metrics: List[float] = []
                err: Optional[str] = None
                try:
                    for f in range(train_w.shape[0]):
                        if preds is not None:
                            pred, raw, prob = preds[f][ci]
                        else:
                            cand = est.copy_with_params(grid)
                            params = cand.fit_arrays(X, y, w=train_w[f])
                            pred, raw, prob = cand.predict_arrays(params, X)
                        vm = val_mask[f]
                        m = self.evaluator.evaluate_arrays(
                            y[vm], np.asarray(pred)[vm],
                            None if prob is None else np.asarray(prob)[vm])
                        fold_metrics.append(float(m[self.evaluator.default_metric]))
                    value = float(np.mean(fold_metrics))
                except (KernelError, *_SURFACING):
                    raise
                except Exception as e:  # the candidate failed; the sweep goes on
                    log.warning("Candidate %s%s failed: %s", type(est).__name__, grid, e)
                    err = f"{type(e).__name__}: {e}"
                    value = bad
                if err is None and not np.isfinite(value):  # never selected
                    value = bad
                    err = f"non-finite {self.evaluator.default_metric}"
                summary.results.append(ModelEvaluation(
                    model_uid=est.uid, model_name=type(est).__name__,
                    model_type=type(est).__name__, grid=dict(grid),
                    metric_name=self.evaluator.default_metric,
                    fold_metrics=fold_metrics, metric_value=value, error=err))
            if isinstance(X, torch.Tensor) and X.is_cuda:
                torch.cuda.synchronize(X.device)
            name = type(est).__name__
            self.sweep_timings[name] = (self.sweep_timings.get(name, 0.0)
                                        + time.perf_counter() - t0)


def _chunk_candidates(candidates, max_cands: int):
    """Partition (estimator, grids) pairs into chunks of at most
    ``max_cands`` candidates, splitting a family's grid list where needed;
    the chunks keep the global candidate order."""
    chunks, cur, cur_n = [], [], 0
    for est, grids in candidates:
        grids = list(grids) or [{}]
        lo = 0
        while lo < len(grids):
            take = min(len(grids) - lo, max(max_cands - cur_n, 1))
            cur.append((est, grids[lo:lo + take]))
            cur_n += take
            lo += take
            if cur_n >= max_cands:
                chunks.append(cur)
                cur, cur_n = [], 0
    if cur:
        chunks.append(cur)
    return chunks


class OpCrossValidation(OpValidator):
    """k-fold CV (OpCrossValidation.scala:42); the stratified option deals
    each label class round-robin across folds."""

    validation_type = "OpCrossValidation"

    def __init__(self, evaluator: OpEvaluatorBase, num_folds: int = DEFAULT_NUM_FOLDS,
                 seed: int = 42, stratify: bool = False):
        super().__init__(evaluator, seed=seed, stratify=stratify)
        if num_folds < 2:
            raise ValueError("num_folds must be >= 2")
        self.num_folds = num_folds

    def make_folds(self, n, y):
        train_w, val_w = make_fold_weights(n, self.num_folds, seed=self.seed,
                                           stratify_labels=y)
        return train_w, val_w.astype(bool)
