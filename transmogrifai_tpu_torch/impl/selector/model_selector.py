"""ModelSelector — validate a model grid, pick the best, refit it.

The port's counterpart of ``transmogrifai_tpu/impl/selector/model_selector.py``
(reference: ModelSelector.scala:72, ``fit`` :145, ``SelectedModel`` :224,
ModelSelectorSummary.scala:61): reserve the holdout, prepare the training
split (DataBalancer), sweep the grid with the validator (or take the winner
of the workflow-level CV, ``find_best_estimator_cv``), refit the winner on
the prepared training rows, evaluate it on them and on the holdout.  The
feature matrix stays a float32 tensor on the training device; labels,
weights and metrics are host numpy.  The ASHA search and warm-start
pruning are not ported.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import types as T
from ...columns import Column, Dataset, NumericColumn, VectorColumn
from ...evaluators.base import OpEvaluatorBase
from ...stages.base import AllowLabelAsInput, BinaryEstimator
from ..feature._util import stage_device
from ..tuning.splitters import Splitter, SplitterSummary
from ..tuning.validators import OpValidator, ValidationSummary
from .predictor import PredictorEstimator, PredictorModel

#: Prediction/label column keys in summaries (reference ModelSelectorNames)
HOLDOUT_EVAL = "holdoutEvaluation"
TRAIN_EVAL = "trainEvaluation"


def _scrub(obj: Any) -> Any:
    """Plain-JSON scrub: numpy scalars/arrays -> python values."""
    if isinstance(obj, dict):
        return {str(k): _scrub(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    return obj


@dataclass
class ModelSelectorSummary:
    """Serializable selection report (ModelSelectorSummary.scala:61)."""

    validation_type: str
    validation_parameters: Dict[str, Any]
    data_prep_parameters: Dict[str, Any]
    data_prep_results: Optional[Dict[str, Any]]
    evaluation_metric: str
    problem_type: str
    best_model_uid: str
    best_model_name: str
    best_model_type: str
    best_grid: Dict[str, Any]
    validation_results: List[Dict[str, Any]] = field(default_factory=list)
    train_evaluation: Dict[str, Any] = field(default_factory=dict)
    holdout_evaluation: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return _scrub({
            "validationType": self.validation_type,
            "validationParameters": self.validation_parameters,
            "dataPrepParameters": self.data_prep_parameters,
            "dataPrepResults": self.data_prep_results,
            "evaluationMetric": self.evaluation_metric,
            "problemType": self.problem_type,
            "bestModelUID": self.best_model_uid,
            "bestModelName": self.best_model_name,
            "bestModelType": self.best_model_type,
            "bestGrid": self.best_grid,
            "validationResults": self.validation_results,
            "trainEvaluation": self.train_evaluation,
            "holdoutEvaluation": self.holdout_evaluation,
        })

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ModelSelectorSummary":
        return ModelSelectorSummary(
            validation_type=d["validationType"],
            validation_parameters=d.get("validationParameters", {}),
            data_prep_parameters=d.get("dataPrepParameters", {}),
            data_prep_results=d.get("dataPrepResults"),
            evaluation_metric=d.get("evaluationMetric", ""),
            problem_type=d.get("problemType", "Unknown"),
            best_model_uid=d.get("bestModelUID", ""),
            best_model_name=d.get("bestModelName", ""),
            best_model_type=d.get("bestModelType", ""),
            best_grid=d.get("bestGrid", {}),
            validation_results=d.get("validationResults", []),
            train_evaluation=d.get("trainEvaluation", {}),
            holdout_evaluation=d.get("holdoutEvaluation"),
        )


def _rows(X: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return X.index_select(0, torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                             device=X.device))


class ModelSelector(BinaryEstimator, AllowLabelAsInput):
    """(RealNN label, OPVector features) -> Prediction, selecting the best of
    a model grid (ModelSelector.scala:72)."""

    is_model_selector = True
    problem_type = "Unknown"

    def __init__(self, validator: OpValidator, splitter: Optional[Splitter],
                 models: Sequence[Tuple[PredictorEstimator, Sequence[Dict[str, Any]]]],
                 evaluators: Sequence[OpEvaluatorBase] = (), uid: Optional[str] = None):
        super().__init__(operation_name="modelSelector", output_type=T.Prediction, uid=uid)
        self.validator = validator
        self.splitter = splitter
        self.models = [(est, list(grids) or [{}]) for est, grids in models]
        if not self.models:
            raise ValueError("ModelSelector needs at least one candidate model")
        self.evaluators = list(evaluators)
        self.validation_summary: Optional[ValidationSummary] = None
        #: the winner of the workflow-level CV; when set, ``fit`` skips its
        #: own sweep and refits it (reference ``bestEstimator``)
        self.best_estimator: Optional[Tuple[PredictorEstimator, Dict[str, Any],
                                            ValidationSummary]] = None
        #: host seconds of the last fit by phase: the workflow-level CV's
        #: per-fold feature refits and sweeps, the refit, the evaluation
        self.fit_timings: Dict[str, float] = {}

    def to(self, device) -> "ModelSelector":
        super().to(device)
        for est, _ in self.models:
            est.to(self.device)
        return self

    def check_input_types(self, features) -> None:
        super().check_input_types(features)
        label, vec = features
        if not label.is_response:
            raise ValueError("First ModelSelector input (label) must be a response "
                             "feature (CheckIsResponseValues analog)")
        if not issubclass(vec.ftype, T.OPVector):
            raise ValueError("Second ModelSelector input must be OPVector, got "
                             f"{vec.ftype.__name__}")

    # ---- the sweep on arrays (findBestEstimator analog) --------------------
    def find_best_estimator(self, X: torch.Tensor, y: np.ndarray,
                            prep_w: Optional[np.ndarray] = None
                            ) -> Tuple[PredictorEstimator, Dict[str, Any], ValidationSummary]:
        summary = self.validator.validate(self.models, X, y, prep_w)
        best = summary.best
        est = next(e for e, _ in self.models if e.uid == best.model_uid)
        return est, best.grid, summary

    # ---- workflow-level CV (OpWorkflow.scala:403-453) ----------------------
    def find_best_estimator_cv(self, during_layers, ds: Dataset
                               ) -> Tuple[PredictorEstimator, Dict[str, Any], ValidationSummary]:
        """Leakage-free sweep: per CV fold, refit the selector's upstream
        feature estimators (``during_layers``) on the fold's training rows
        only, transform the fold's validation rows with them, and sweep the
        grid on the fold-local features (OpValidator.scala:250)."""
        from ...workflow import dag as dag_util

        label_f, vec_f = self.inputs
        lab = ds[label_f.name]
        if not lab.mask.all():  # unlabeled rows never train or validate
            ds = ds.take(np.where(lab.mask)[0])
        y_all = ds[label_f.name].values.astype(np.float32)
        n = len(y_all)
        v = self.validator
        train_w, val_mask = v.make_folds(n, y_all if v.stratify else None)
        dev = stage_device(self)
        fold_summaries = []
        clock = {"cv_feature_refits": 0.0, "cv_sweep_fits": 0.0}
        v.sweep_timings = {}
        for f in range(train_w.shape[0]):
            t0 = time.perf_counter()
            tr_idx = np.where(train_w[f] > 0)[0]
            va_idx = np.where(val_mask[f])[0]
            fitted = dag_util.fit_and_transform_dag(during_layers, ds.take(tr_idx))
            by_uid = {s.uid: s for s in fitted.fitted_stages}
            models_dag = [[by_uid[s.uid] for s in layer] for layer in during_layers]
            ds_va = dag_util.apply_transformations_dag(ds.take(va_idx), models_dag)
            Xtr = fitted.train[vec_f.name].tensor(dev)
            Xva = ds_va[vec_f.name].tensor(dev)
            ytr, yva = y_all[tr_idx], y_all[va_idx]
            prep_w = (self.splitter.prepare_weights(ytr) if self.splitter is not None
                      else np.ones(len(ytr), np.float32))
            X = torch.cat([Xtr, Xva])
            y = np.concatenate([ytr, yva])
            t1 = time.perf_counter()
            clock["cv_feature_refits"] += t1 - t0
            w_row = np.concatenate([prep_w, np.zeros(len(yva), np.float32)])
            vm = np.zeros(len(y), dtype=bool)
            vm[len(ytr):] = True
            s = ValidationSummary(validation_type=f"workflow-{v.validation_type}",
                                  evaluator_name=v.evaluator.name,
                                  metric_name=v.evaluator.default_metric,
                                  is_larger_better=v.evaluator.is_larger_better)
            v._sweep(self.models, X, y, w_row[None, :], vm[None, :], s)
            fold_summaries.append(s)
            clock["cv_sweep_fits"] += time.perf_counter() - t1
        # the fused sweeps' parts, within cv_sweep_fits
        clock.update({f"cv_sweep_{k}": t for k, t in v.sweep_timings.items()})
        self.fit_timings = dict(clock)

        merged = fold_summaries[0]
        for s in fold_summaries[1:]:
            for acc, r in zip(merged.results, s.results):
                acc.fold_metrics.extend(r.fold_metrics)
                if r.error and not acc.error:
                    acc.error = r.error
        for acc in merged.results:
            if acc.fold_metrics and not acc.error:
                acc.metric_value = float(np.mean(acc.fold_metrics))
            else:
                acc.metric_value = -np.inf if v.evaluator.is_larger_better else np.inf
        if all(r.error for r in merged.results):
            raise RuntimeError("All models in the workflow-CV grid failed to fit")
        vals = [r.metric_value for r in merged.results]
        merged.best_index = int(np.argmax(vals) if v.evaluator.is_larger_better
                                else np.argmin(vals))
        best = merged.best
        est = next(e for e, _ in self.models if e.uid == best.model_uid)
        self.best_estimator = (est, best.grid, merged)
        return self.best_estimator

    # ---- fit (ModelSelector.scala:145) -------------------------------------
    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "SelectedModel":
        label_col, vec_col = cols
        assert isinstance(label_col, NumericColumn) and isinstance(vec_col, VectorColumn)
        keep = label_col.mask
        X = vec_col.tensor(stage_device(self))
        if not keep.all():
            X = _rows(X, np.flatnonzero(keep))
        y = label_col.values[keep].astype(np.float32)
        n = len(y)

        # 1. holdout reservation (splitter.split, Splitter.scala:58)
        if self.splitter is not None and self.splitter.reserve_test_fraction > 0.0:
            train_idx, hold_idx = self.splitter.split(n, y)
        else:
            train_idx, hold_idx = np.arange(n), np.array([], dtype=np.int64)
        ytr = y[train_idx]

        # 2. preValidationPrepare (DataBalancer.estimate etc.)
        prep_summary: Optional[SplitterSummary] = None
        prep_w = None
        if self.splitter is not None:
            prep_summary = self.splitter.pre_validation_prepare(ytr)
            prep_w = self.splitter.prepare_weights(ytr)

        # 2b. maxTrainingSample cap: a uniform draw without replacement,
        # keeping the preparation weights of the rows drawn
        cap = getattr(self.splitter, "max_training_sample", None) \
            if self.splitter is not None else None
        if cap and len(train_idx) > cap:
            rng = np.random.default_rng(self.validator.seed)
            sub = np.sort(rng.choice(len(train_idx), size=int(cap), replace=False))
            train_idx = train_idx[sub]
            ytr = y[train_idx]
            if prep_w is not None:
                prep_w = prep_w[sub]
        Xtr = _rows(X, train_idx)

        # 3. the sweep (skipped when workflow-level CV already chose a winner)
        t0 = time.perf_counter()
        if self.best_estimator is not None:
            best_est, best_grid, vsummary = self.best_estimator
        else:
            self.validator.sweep_timings = {}
            best_est, best_grid, vsummary = self.find_best_estimator(Xtr, ytr, prep_w)
            # the sweep and, for a fused one, its parts
            self.fit_timings = {"sweep": time.perf_counter() - t0,
                                **{f"cv_sweep_{k}": t
                                   for k, t in self.validator.sweep_timings.items()}}
        self.validation_summary = vsummary

        # 4. final refit on the full prepared train (ModelSelector.scala:181)
        refit = best_est.copy_with_params(best_grid)
        ridx = (self.splitter.prepare_indices(ytr) if self.splitter is not None
                else np.arange(len(ytr)))
        Xfit = _rows(Xtr, ridx)
        t0 = time.perf_counter()
        params = refit.fit_arrays(Xfit, ytr[ridx])
        t1 = time.perf_counter()
        self.fit_timings["refit"] = t1 - t0

        # 5. evaluate train (prepared rows) + holdout with every evaluator
        evaluators = self.evaluators or [self.validator.evaluator]
        pred_tr, _, prob_tr = refit.predict_arrays(params, Xfit)
        train_eval: Dict[str, Any] = {}
        for ev in evaluators:
            train_eval.update(ev.evaluate_arrays(ytr[ridx], np.asarray(pred_tr),
                                                 None if prob_tr is None else np.asarray(prob_tr)))
        holdout_eval = None
        if len(hold_idx):
            pred_ho, _, prob_ho = refit.predict_arrays(params, _rows(X, hold_idx))
            holdout_eval = {}
            for ev in evaluators:
                holdout_eval.update(ev.evaluate_arrays(y[hold_idx], np.asarray(pred_ho),
                                                       None if prob_ho is None
                                                       else np.asarray(prob_ho)))

        self.fit_timings["train_and_holdout_evaluation"] = time.perf_counter() - t1
        summary = ModelSelectorSummary(
            validation_type=vsummary.validation_type,
            validation_parameters={"seed": self.validator.seed,
                                   "stratify": self.validator.stratify,
                                   **({"numFolds": getattr(self.validator, "num_folds")}
                                      if hasattr(self.validator, "num_folds") else {}),
                                   **({"trainRatio": getattr(self.validator, "train_ratio")}
                                      if hasattr(self.validator, "train_ratio") else {})},
            data_prep_parameters=(prep_summary.params if prep_summary else {}),
            data_prep_results=(prep_summary.prepared if prep_summary else None),
            evaluation_metric=vsummary.metric_name,
            problem_type=self.problem_type,
            best_model_uid=vsummary.best.model_uid,
            best_model_name=vsummary.best.model_name,
            best_model_type=vsummary.best.model_type,
            best_grid=dict(best_grid),
            validation_results=vsummary.to_json()["results"],
            train_evaluation=train_eval,
            holdout_evaluation=holdout_eval)
        model = SelectedModel(predictor_class=type(refit), model_params=params,
                              operation_name=self.operation_name)
        model.summary = summary
        model.metadata = dict(self.metadata)
        model.metadata["model_selector_summary"] = summary.to_json()
        return model


class SelectedModel(PredictorModel):
    """The winning candidate wrapped as a transformer (ModelSelector.scala:224)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.summary: Optional[ModelSelectorSummary] = None

    def transform_columns(self, cols):
        out = super().transform_columns(cols)
        # summary travels on the output column (reference: summary metadata in
        # the output column schema) so SelectedModelCombiner can read it
        if self.summary is not None:
            out.metadata = {"model_selector_summary": self.summary.to_json()}
        return out
