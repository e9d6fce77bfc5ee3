"""SanityChecker — label-aware feature QA, and its column gather.

The port's copy of ``transmogrifai_tpu/impl/preparators/sanity_checker.py``
(reference: SanityChecker.scala:232, DerivedFeatureFilterUtils.scala).  The
fit samples the rows (checkSample, 100k cap), computes column moments,
label correlations (Pearson, or Spearman over the columns' ranks), the
feature-feature correlation matrix and the categorical groups'
contingency statistics on the device that holds the vector column (only
d-sized results come to the host), and drops columns by the reference's
rules.  A sample of at most 2^18 rows takes one float64 pass in memory
(``utils/stats.py``: the K-I / K-J kernels, K-Y's ranks for Spearman); a
larger one, or ``sharded_stats=True``, streams in chunks of 2^18 rows
(``parallel/stats.py``: K-X's chunk moments, K-I's centered Gram, K-Y's
ranks), as the reference's branch does on one device.  The fitted model
gathers the kept columns on the device (K-Z's ``column_gather``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import types as T
from ...columns import Column, Dataset, NumericColumn, VectorColumn
from ...features.metadata import VectorColumnMetadata, VectorMetadata
from ...ops import layer as L
from ...stages.base import AllowLabelAsInput, BinaryEstimator, Model
from ...utils import stats as S
from ..feature._util import run_on_device




# ---------------------------------------------------------------------------
# Per-column statistics record (ColumnStatistics analog)
# ---------------------------------------------------------------------------
@dataclass
class ColumnStatistics:
    """DerivedFeatureFilterUtils.ColumnStatistics analog (:310)."""

    name: str
    column: Optional[VectorColumnMetadata]
    is_label: bool
    count: int
    mean: float
    min: float
    max: float
    variance: float
    corr_label: Optional[float] = None
    cramers_v: Optional[float] = None
    parent_corr: Optional[float] = None
    parent_cramers_v: Optional[float] = None
    feature_corrs: Sequence[float] = ()
    max_rule_confidences: Sequence[float] = ()
    supports: Sequence[float] = ()

    def reasons_to_remove(self, *, min_variance: float, min_correlation: float,
                          max_correlation: float, max_feature_corr: float,
                          max_cramers_v: float, max_rule_confidence: float,
                          min_required_rule_support: float, remove_feature_group: bool,
                          protect_text_shared_hash: bool,
                          removed_groups: Sequence[str]) -> List[str]:
        """Exact rule set of ColumnStatistics.reasonsToRemove
        (DerivedFeatureFilterUtils.scala:351-406)."""
        if self.is_label:
            return []
        reasons: List[str] = []
        if self.variance <= min_variance:
            reasons.append(f"variance {self.variance} lower than min variance {min_variance}")
        if self.corr_label is not None and not np.isnan(self.corr_label):
            if abs(self.corr_label) < min_correlation:
                reasons.append(f"correlation {self.corr_label} lower than min correlation "
                               f"{min_correlation}")
            if abs(self.corr_label) > max_correlation:
                reasons.append(f"correlation {self.corr_label} higher than max correlation "
                               f"{max_correlation}")
        if self.column is not None:
            # only correlations with EARLIER columns count => the later column
            # of a redundant pair is the one dropped (reference :377)
            earlier = list(self.feature_corrs)[: self.column.index]
            bad = next((c for c in earlier if not np.isnan(c) and abs(c) > max_feature_corr), None)
            if bad is not None:
                reasons.append(
                    f"this feature has correlations {bad} with another feature higher than "
                    f"max feature-feature correlation {max_feature_corr}")
        if self.cramers_v is not None and not np.isnan(self.cramers_v) \
                and self.cramers_v > max_cramers_v:
            reasons.append(f"Cramer's V {self.cramers_v} higher than max Cramer's V "
                           f"{max_cramers_v}")
        for conf, sup in zip(self.max_rule_confidences, self.supports):
            if conf > max_rule_confidence and sup > min_required_rule_support:
                reasons.append(
                    f"Max association rule confidence {conf} is above threshold of "
                    f"{max_rule_confidence} and support {sup} is above the required support "
                    f"threshold of {min_required_rule_support}")
                break
        group = self.column.feature_group() if self.column is not None else None
        if group is not None and group in removed_groups:
            reasons.append(f"other feature in indicator group {group} flagged for removal "
                           f"via rule confidence checks")
        if remove_feature_group and not (protect_text_shared_hash and self._is_text_shared_hash()):
            if self.parent_cramers_v is not None and not np.isnan(self.parent_cramers_v) \
                    and self.parent_cramers_v > max_cramers_v:
                reasons.append(f"Cramer's V {self.parent_cramers_v} for something in parent "
                               f"feature set higher than max Cramer's V {max_cramers_v}")
            if self.parent_corr is not None and not np.isnan(self.parent_corr) \
                    and self.parent_corr > max_correlation:
                reasons.append(f"correlation {self.parent_corr} for something in parent "
                               f"feature set higher than max correlation {max_correlation}")
        return reasons

    def _is_text_shared_hash(self) -> bool:
        """DerivedFeatureFilterUtils.isTextSharedHash:412."""
        if self.column is None:
            return False
        text_types = {"Text", "TextArea", "TextMap", "TextAreaMap"}
        derived_from_text = any(t in text_types for t in self.column.parent_feature_type)
        return derived_from_text and self.column.grouping is None \
            and self.column.indicator_value is None

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "isLabel": self.is_label, "count": self.count,
            "mean": self.mean, "min": self.min, "max": self.max, "variance": self.variance,
            "corrLabel": self.corr_label, "cramersV": self.cramers_v,
            "parentCorr": self.parent_corr, "parentCramersV": self.parent_cramers_v,
            "maxRuleConfidences": list(self.max_rule_confidences),
            "supports": list(self.supports),
        }


@dataclass
class CategoricalGroupStats:
    """Per categorical group contingency statistics
    (preparators/CategoricalGroupStats in SanityCheckerMetadata.scala)."""

    group: str
    categorical_features: List[str]
    contingency: np.ndarray
    stats: S.ContingencyStats

    def to_json(self) -> Dict[str, Any]:
        return {
            "group": self.group,
            "categoricalFeatures": self.categorical_features,
            "contingencyMatrix": self.contingency.tolist(),
            **self.stats.to_json(),
        }


# ---------------------------------------------------------------------------
# SanityChecker
# ---------------------------------------------------------------------------
class SanityChecker(BinaryEstimator, AllowLabelAsInput):
    """(label RealNN, features OPVector) -> cleaned OPVector
    (SanityChecker.scala:232)."""

    is_sanity_checker = True

    def __init__(self,
                 check_sample: float = 1.0,
                 sample_seed: int = 42,
                 sample_upper_limit: int = 100_000,
                 max_correlation: float = 0.95,
                 min_correlation: float = 0.0,
                 max_feature_corr: float = 0.99,
                 correlation_type: str = "pearson",
                 min_variance: float = 1e-5,
                 max_cramers_v: float = 0.95,
                 remove_bad_features: bool = True,
                 remove_feature_group: bool = True,
                 protect_text_shared_hash: bool = True,
                 max_rule_confidence: float = 1.0,
                 min_required_rule_support: float = 1.0,
                 feature_label_corr_only: bool = False,
                 correlation_exclusion: str = "none",
                 categorical_label: Optional[bool] = None,
                 max_categorical_cardinality: int = 100,
                 sharded_stats: Any = "auto",
                 uid: Optional[str] = None):
        super().__init__(operation_name="sanityChecker", output_type=T.OPVector, uid=uid,
                         check_sample=check_sample, sample_seed=sample_seed,
                         sample_upper_limit=sample_upper_limit,
                         max_correlation=max_correlation, min_correlation=min_correlation,
                         max_feature_corr=max_feature_corr, correlation_type=correlation_type,
                         min_variance=min_variance, max_cramers_v=max_cramers_v,
                         remove_bad_features=remove_bad_features,
                         remove_feature_group=remove_feature_group,
                         protect_text_shared_hash=protect_text_shared_hash,
                         max_rule_confidence=max_rule_confidence,
                         min_required_rule_support=min_required_rule_support,
                         feature_label_corr_only=feature_label_corr_only,
                         correlation_exclusion=correlation_exclusion,
                         categorical_label=categorical_label,
                         max_categorical_cardinality=max_categorical_cardinality,
                         sharded_stats=sharded_stats)

    def check_input_types(self, features) -> None:
        super().check_input_types(features)
        label, vec = features
        if not label.is_response:
            raise ValueError("SanityChecker first input must be the response "
                             "(CheckIsResponseValues, SanityChecker.scala:239)")

    # -- fitting --------------------------------------------------------------
    def fit_columns(self, cols: Sequence[Column], dataset: Dataset) -> "SanityCheckerModel":
        label_col, vec_col = cols
        assert isinstance(label_col, NumericColumn) and isinstance(vec_col, VectorColumn)
        y = np.asarray(label_col.values, dtype=np.float64)
        X = vec_col.values  # float32 on the training device; stays there
        meta = vec_col.metadata or VectorMetadata(
            self.inputs[1].name,
            tuple(VectorColumnMetadata((self.inputs[1].name,), ("OPVector",), index=i)
                  for i in range(X.shape[1])))

        # 1. sampling (checkSample + 100k cap, SanityChecker.scala:58-92)
        n = X.shape[0]
        frac = float(self.get_param("check_sample", 1.0))
        cap = int(self.get_param("sample_upper_limit", 100_000))
        target = min(int(n * frac) if frac < 1.0 else n, cap)
        if target < n:
            rng = np.random.default_rng(int(self.get_param("sample_seed", 42)))
            idx = rng.choice(n, size=target, replace=False)
            X = X.index_select(0, torch.as_tensor(idx, device=X.device))
            y = y[idx]
            n = target

        # 2. moments + correlations on the device.  Large samples stream in
        # row chunks (the reference's treeAggregates under
        # Statistics.colStats/corr, SanityChecker.scala:406-470); smaller ones
        # take one float64 pass in memory
        method = str(self.get_param("correlation_type", "pearson"))
        with_corr = not bool(self.get_param("feature_label_corr_only", False))
        corr_cols = self._correlation_columns(meta)
        sharded = self.get_param("sharded_stats", "auto")
        stream = (sharded is True) or (sharded == "auto" and n > (1 << 18))
        if stream and method in ("pearson", "spearman"):
            full_stats, corr_label_sub, corr_matrix_sub = self._streamed_stats(
                X, y, corr_cols, method, with_corr)
        else:
            X64 = X.to(torch.float64)
            _, corr_label_sub, corr_matrix_sub = S.correlations_with_label(
                X64[:, corr_cols], torch.from_numpy(y).to(X.device), method=method,
                with_corr_matrix=with_corr)
            full_stats = S.col_stats(X64)
            del X64
        d = X.shape[1]
        corr_label = np.full(d, np.nan)
        corr_label[corr_cols] = corr_label_sub
        corr_matrix = None
        if corr_matrix_sub is not None:
            corr_matrix = np.full((d, d), np.nan)
            corr_matrix[np.ix_(corr_cols, corr_cols)] = corr_matrix_sub

        # 3. categorical group stats via one contingency matmul
        cat_stats, col_cramers, col_conf, col_support = self._categorical_stats(X, y, meta)

        # 4. assemble per-column records + label record
        col_names = meta.column_names()
        parent_corr = self._max_by_parent(meta, np.abs(corr_label))
        parent_cv = self._max_by_parent(
            meta, np.array([col_cramers.get(i, np.nan) for i in range(d)]))
        records: List[ColumnStatistics] = []
        for i, cm in enumerate(meta.columns):
            records.append(ColumnStatistics(
                name=col_names[i], column=cm, is_label=False, count=n,
                mean=float(full_stats.mean[i]), min=float(full_stats.min[i]),
                max=float(full_stats.max[i]), variance=float(full_stats.variance[i]),
                corr_label=float(corr_label[i]) if not np.isnan(corr_label[i]) else None,
                cramers_v=col_cramers.get(i),
                parent_corr=parent_corr.get(self._parent_of(cm)),
                parent_cramers_v=parent_cv.get(self._parent_of(cm)),
                feature_corrs=corr_matrix[i] if corr_matrix is not None else (),
                max_rule_confidences=col_conf.get(i, ()),
                supports=col_support.get(i, ()),
            ))
        label_stats = ColumnStatistics(
            name=self.inputs[0].name, column=None, is_label=True, count=n,
            mean=float(y.mean()) if n else 0.0, min=float(y.min()) if n else 0.0,
            max=float(y.max()) if n else 0.0,
            variance=float(y.var(ddof=1)) if n > 1 else 0.0)

        # 5. drop decisions (getFeaturesToDrop:234)
        dropped, reasons = self._features_to_drop(records)
        keep = np.array([i for i in range(d) if col_names[i] not in dropped], dtype=int)
        if not bool(self.get_param("remove_bad_features", True)):
            keep = np.arange(d)

        new_meta = meta.select(list(keep))
        summary = {
            "name": self.get_outputs()[0].name,
            "correlationsWLabel": {"values": [None if np.isnan(c) else float(c)
                                              for c in corr_label],
                                   "featuresIn": col_names},
            "correlationType": self.get_param("correlation_type", "pearson"),
            "dropped": sorted(dropped),
            "reasons": reasons,
            "featuresStatistics": [r.to_json() for r in [label_stats] + records],
            "names": col_names,
            "categoricalStats": [g.to_json() for g in cat_stats],
            "sampleSize": n,
        }
        self.metadata["sanity_checker_summary"] = summary
        self.metadata["vector_metadata"] = new_meta
        model = SanityCheckerModel(indices_to_keep=keep, out_metadata=new_meta,
                                   operation_name=self.operation_name,
                                   output_type=self.output_type)
        model.metadata = dict(self.metadata)
        return model

    # -- helpers --------------------------------------------------------------
    @staticmethod
    def _streamed_stats(X: torch.Tensor, y: np.ndarray, corr_cols: List[int], method: str,
                        with_corr: bool):
        """(column stats, label correlations, correlation matrix | None) of
        the sample X f32[n, d] streamed in chunks of 2^18 rows on its device
        (``parallel/stats.py``).  One pass (K-X Chan mode, K-I centered mode)
        when every column is correlated under Pearson; otherwise the moments
        pass (K-X raw mode), then the Gram pass (K-I centered mode) over the
        correlated columns, or over their ranks (K-Y) for Spearman."""
        from ...parallel.stats import (chunked, fused_moments_and_correlations,
                                       sharded_correlations)

        ch = 1 << 18
        if method == "pearson" and len(corr_cols) == X.shape[1]:
            yt = torch.from_numpy(y).to(X.device, torch.float32)
            return fused_moments_and_correlations(chunked(X, yt, chunk_rows=ch), X.shape[1],
                                                  with_corr_matrix=with_corr)
        return sharded_correlations(X, y, with_corr_matrix=with_corr, chunk_rows=ch,
                                    method=method, device=X.device, cols=corr_cols)

    @staticmethod
    def _parent_of(cm: VectorColumnMetadata) -> str:
        return cm.parent_feature_name[0] if cm.parent_feature_name else ""

    def _correlation_columns(self, meta: VectorMetadata) -> List[int]:
        """Columns participating in correlation computations; hashed-text
        columns excluded under correlationExclusion=HashedText
        (SanityChecker CorrelationExclusion)."""
        if str(self.get_param("correlation_exclusion", "none")).lower() not in (
                "hashed_text", "hashedtext"):
            return list(range(meta.size))
        out = []
        for i, cm in enumerate(meta.columns):
            hashed_text = (cm.descriptor_value or "").startswith("hash_")
            if not hashed_text:
                out.append(i)
        return out

    def _label_classes(self, y: np.ndarray) -> Optional[np.ndarray]:
        """Categorical-label detection: explicit param, else integral values
        with cardinality ≤ maxCategoricalCardinality (SanityChecker's
        categoricalLabel auto-detection)."""
        forced = self.get_param("categorical_label")
        uniq = np.unique(y)
        is_integral = np.allclose(uniq, np.round(uniq))
        auto = is_integral and len(uniq) <= int(
            self.get_param("max_categorical_cardinality", 100))
        if forced is False or (forced is None and not auto):
            return None
        return uniq

    def _categorical_stats(self, X: torch.Tensor, y: np.ndarray, meta: VectorMetadata
                           ) -> Tuple[List[CategoricalGroupStats], Dict[int, float],
                                      Dict[int, List[float]], Dict[int, List[float]]]:
        classes = self._label_classes(y)
        if classes is None:
            return [], {}, {}, {}
        y_idx = np.searchsorted(classes, y)
        # group categorical columns (indicator or grouping set) by feature group
        groups: Dict[str, List[int]] = {}
        for i, cm in enumerate(meta.columns):
            g = cm.feature_group()
            if g is not None:
                groups.setdefault(g, []).append(i)
        if not groups:
            return [], {}, {}, {}
        all_cols = [i for cols in groups.values() for i in cols]
        cont_all = S.contingency_all_columns(
            X.index_select(1, torch.as_tensor(all_cols, device=X.device)),
            torch.from_numpy(y_idx.astype(np.int32)), len(classes))
        label_counts = np.bincount(y_idx, minlength=len(classes)).astype(np.float64)
        by_col = {c: cont_all[j] for j, c in enumerate(all_cols)}

        col_names = meta.column_names()
        out_stats: List[CategoricalGroupStats] = []
        col_cramers: Dict[int, float] = {}
        col_conf: Dict[int, List[float]] = {}
        col_support: Dict[int, List[float]] = {}
        for g, cols in sorted(groups.items()):
            cont = np.stack([by_col[c] for c in cols])
            if len(cols) == 1:
                # lone null-indicator: 2xk with complement row
                # (DerivedFeatureFilterUtils note on nullIndicator columns)
                cont = np.vstack([cont, label_counts - cont[0]])
            st = S.contingency_stats(cont)
            out_stats.append(CategoricalGroupStats(
                group=g, categorical_features=[col_names[c] for c in cols],
                contingency=cont, stats=st))
            for row, c in enumerate(cols):
                col_cramers[c] = st.cramers_v
                if len(cols) == 1:
                    col_conf[c] = list(st.max_rule_confidences)
                    col_support[c] = list(st.supports)
                else:
                    col_conf[c] = [float(st.max_rule_confidences[row])]
                    col_support[c] = [float(st.supports[row])]
        return out_stats, col_cramers, col_conf, col_support

    @staticmethod
    def _max_by_parent(meta: VectorMetadata, values: np.ndarray) -> Dict[str, float]:
        """maxByParent (DerivedFeatureFilterUtils.scala:115)."""
        out: Dict[str, float] = {}
        for i, cm in enumerate(meta.columns):
            v = values[i]
            if np.isnan(v):
                continue
            p = cm.parent_feature_name[0] if cm.parent_feature_name else ""
            out[p] = max(out.get(p, -np.inf), float(v))
        return out

    def _features_to_drop(self, records: List[ColumnStatistics]
                          ) -> Tuple[set, Dict[str, List[str]]]:
        p = self._params
        # group-level rule-confidence removals (getFeaturesToDrop:250-260)
        removed_groups: List[str] = []
        by_group: Dict[str, List[ColumnStatistics]] = {}
        for r in records:
            if r.column is not None:
                g = r.column.feature_group()
                if g is not None:
                    by_group.setdefault(g, []).append(r)
        for g, rs in by_group.items():
            for r in rs:
                if any(conf > p["max_rule_confidence"] and sup > p["min_required_rule_support"]
                       for conf, sup in zip(r.max_rule_confidences, r.supports)):
                    removed_groups.append(g)
                    break
        dropped: set = set()
        reasons: Dict[str, List[str]] = {}
        for r in records:
            rs = r.reasons_to_remove(
                min_variance=p["min_variance"], min_correlation=p["min_correlation"],
                max_correlation=p["max_correlation"], max_feature_corr=p["max_feature_corr"],
                max_cramers_v=p["max_cramers_v"], max_rule_confidence=p["max_rule_confidence"],
                min_required_rule_support=p["min_required_rule_support"],
                remove_feature_group=p["remove_feature_group"],
                protect_text_shared_hash=p["protect_text_shared_hash"],
                removed_groups=removed_groups)
            if rs:
                dropped.add(r.name)
                reasons[r.name] = rs
        return dropped, reasons


class SanityCheckerModel(Model):
    """Pure column gather (DerivedFeatureFilterUtils.removeFeatures:289)."""

    def __init__(self, indices_to_keep: np.ndarray, out_metadata: Optional[VectorMetadata],
                 operation_name: str = "sanityChecker", output_type=T.OPVector,
                 uid: Optional[str] = None, **kw):
        super().__init__(operation_name, output_type, uid=uid, **kw)
        self.indices_to_keep = np.asarray(indices_to_keep, dtype=int)
        self.out_metadata = out_metadata

    def transform_columns(self, cols: Sequence[Column]) -> VectorColumn:
        assert isinstance(cols[-1], VectorColumn)
        return run_on_device(self, cols)

    # ---- fused-layer protocol (workflow/dag._apply_layer_transforms and the
    # streaming executor): a column gather of the last input, the vector, on
    # the device (K-Z); row-wise, so it streams on the combiner's chunks ----
    def torch_transform(self, *args):
        keep = self.indices_to_keep
        return L.column_gather([args[-1]], [0] * len(keep), keep)

    def torch_out_metadata(self, cols) -> Optional[VectorMetadata]:
        return self.out_metadata
