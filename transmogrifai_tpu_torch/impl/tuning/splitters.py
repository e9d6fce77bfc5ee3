"""Splitters — holdout reservation + pre-modeling data preparation.

Reference parity: core/.../impl/tuning/{Splitter,DataSplitter,DataBalancer}.scala —

- ``Splitter`` (:47): reserve a test holdout (``reserveTestFraction``), plus
  ``preValidationPrepare`` / ``validationPrepare`` hooks,
- ``DataSplitter`` (:65): regression — caps the training set at
  ``maxTrainingSample`` rows,
- ``DataBalancer`` (:73): binary — up/down-samples so the positive class
  reaches ``sampleFraction`` of the data (``getProportions``,
  DataBalancer.scala:84),
- ``DataCutter`` (DataCutter.scala:78): multiclass — keeps at most
  ``maxLabelCategories`` labels, each with at least ``minLabelFraction``
  support; rows of dropped labels get weight 0 / are removed,
- each emits a ``SplitterSummary`` into stage metadata.

The port's copy of ``transmogrifai_tpu/impl/tuning/splitters.py`` (host
numpy, the same draws from the same seeds, so holdouts and weights are
bit-equal).  Every prepare has two forms:

- ``prepare_weights(y) -> w[n]`` — a per-row weight vector equivalent in
  expectation to the reference's resampling (balancing = class reweighting,
  capping = scaled weight).  Used inside the sweep.
- ``prepare_indices(y, rng) -> idx`` — exact index resampling matching the
  reference's row-level semantics.  Used for the final refit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class SplitterSummary:
    """Serializable preparation summary (reference SplitterSummary)."""

    splitter_type: str
    params: Dict[str, Any] = field(default_factory=dict)
    #: e.g. up/down-sample fractions, dropped labels
    prepared: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"splitterType": self.splitter_type, "params": self.params,
                "prepared": self.prepared}


class Splitter:
    """Base splitter: holdout reservation only (Splitter.scala:47)."""

    def __init__(self, reserve_test_fraction: float = 0.1, seed: int = 42):
        if not 0.0 <= reserve_test_fraction < 1.0:
            raise ValueError("reserve_test_fraction must be in [0, 1)")
        self.reserve_test_fraction = reserve_test_fraction
        self.seed = seed
        self.summary: Optional[SplitterSummary] = None

    # ---- holdout ----------------------------------------------------------
    def split(self, n: int, y: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(train_idx, holdout_idx); stratified by label when y is given."""
        rng = np.random.default_rng(self.seed)
        if self.reserve_test_fraction <= 0.0:
            return np.arange(n), np.array([], dtype=np.int64)
        hold = np.zeros(n, dtype=bool)
        if y is not None and len(np.unique(y)) > max(0.05 * n, 50):
            y = None  # continuous label (regression): plain random holdout
        if y is not None:
            yv = np.asarray(y)
            for cls in np.unique(yv):
                idx = np.where(yv == cls)[0]
                rng.shuffle(idx)
                k = int(round(len(idx) * self.reserve_test_fraction))
                hold[idx[:k]] = True
        else:
            idx = rng.permutation(n)
            k = int(round(n * self.reserve_test_fraction))
            hold[idx[:k]] = True
        if not hold.any():  # tiny data: reserve at least one row
            hold[rng.integers(n)] = True
        return np.where(~hold)[0], np.where(hold)[0]

    # ---- preparation hooks -------------------------------------------------
    def pre_validation_prepare(self, y: np.ndarray) -> SplitterSummary:
        """Estimate preparation parameters on the full training split
        (preValidationPrepare analog — DataBalancer.estimate etc.)."""
        self.summary = SplitterSummary(type(self).__name__, self._params())
        return self.summary

    def prepare_weights(self, y: np.ndarray) -> np.ndarray:
        """Static-shape preparation: per-row training weights."""
        return np.ones(len(y), dtype=np.float32)

    def prepare_indices(self, y: np.ndarray,
                        rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Exact-resampling preparation (reference row semantics)."""
        return np.arange(len(y))

    def _params(self) -> Dict[str, Any]:
        return {"reserveTestFraction": self.reserve_test_fraction, "seed": self.seed}


class DataSplitter(Splitter):
    """Regression splitter: downsample to maxTrainingSample
    (DataSplitter.scala:65)."""

    def __init__(self, reserve_test_fraction: float = 0.1, seed: int = 42,
                 max_training_sample: int = 1_000_000):
        super().__init__(reserve_test_fraction, seed)
        self.max_training_sample = max_training_sample

    def pre_validation_prepare(self, y: np.ndarray) -> SplitterSummary:
        n = len(y)
        frac = min(1.0, self.max_training_sample / max(n, 1))
        self.summary = SplitterSummary(type(self).__name__, self._params(),
                                       prepared={"downSampleFraction": frac})
        return self.summary

    def _fraction(self, n: int) -> float:
        return min(1.0, self.max_training_sample / max(n, 1))

    def prepare_weights(self, y: np.ndarray) -> np.ndarray:
        # capping is a uniform subsample; in weight form it is a no-op for
        # the optimum (uniform scaling), so keep all rows at weight 1
        return np.ones(len(y), dtype=np.float32)

    def prepare_indices(self, y, rng=None) -> np.ndarray:
        n = len(y)
        frac = self._fraction(n)
        if frac >= 1.0:
            return np.arange(n)
        rng = rng or np.random.default_rng(self.seed)
        k = int(n * frac)
        return np.sort(rng.choice(n, size=k, replace=False))

    def _params(self):
        return {**super()._params(), "maxTrainingSample": self.max_training_sample}


class DataBalancer(Splitter):
    """Binary-classification balancer (DataBalancer.scala:73).

    If the positive class is rarer than ``sample_fraction``, rebalance so it
    makes up ``sample_fraction`` of the (weighted) training mass — the
    reference computes up/down-sample fractions (``getProportions``,
    DataBalancer.scala:84); weight form multiplies each class by the same
    fractions.
    """

    def __init__(self, sample_fraction: float = 0.1, reserve_test_fraction: float = 0.1,
                 max_training_sample: int = 1_000_000, seed: int = 42,
                 already_balanced: Optional[bool] = None):
        super().__init__(reserve_test_fraction, seed)
        if not 0.0 < sample_fraction < 0.5:
            raise ValueError("sample_fraction must be in (0, 0.5)")
        self.sample_fraction = sample_fraction
        self.max_training_sample = max_training_sample
        self.already_balanced = already_balanced
        self._up = 1.0
        self._down = 1.0
        self._minority_is_positive = True

    @staticmethod
    def get_proportions(small: float, big: float, sample_f: float,
                        max_training_sample: int) -> Tuple[float, float]:
        """(down_sample, up_sample) — exact port of
        DataBalancer.getProportions (DataBalancer.scala:84-114): the minority
        is upsampled by the largest multiplier from {100,50,10,5,4,3,2}
        that keeps it under the target fraction and under the training cap,
        then the majority is downsampled to hit the fraction exactly; if the
        minority alone already exceeds ``maxTrainingSample * sampleF``, both
        classes are downsampled to the capped size."""
        def up_ok(m: int) -> bool:
            return (m * small * (1 - sample_f) < sample_f * big
                    and max_training_sample * sample_f > small * m)

        if small < max_training_sample * sample_f:
            up = next((float(m) for m in (100, 50, 10, 5, 4, 3, 2) if up_ok(m)), 1.0)
            down = (small * up / sample_f - small * up) / big if big > 0 else 1.0
            return down, up
        up = (max_training_sample * sample_f) / small
        down = (1 - sample_f) * max_training_sample / big if big > 0 else 1.0
        return down, up

    def pre_validation_prepare(self, y: np.ndarray) -> SplitterSummary:
        y = np.asarray(y)
        n = max(len(y), 1)
        pos = float((y == 1.0).sum())
        neg = float(n - pos)
        small, big = (pos, neg) if pos <= neg else (neg, pos)
        self._minority_is_positive = pos <= neg
        frac = small / n
        p = self.sample_fraction
        # an explicit already_balanced=True (isDataBalanced) skips rebalancing
        balanced = self.already_balanced is True or frac >= p or small == 0
        self.already_balanced = balanced
        if balanced:
            self._up, self._down = 1.0, 1.0
        else:
            self._down, self._up = self.get_proportions(
                small, big, p, self.max_training_sample)
        self.summary = SplitterSummary(
            type(self).__name__, self._params(),
            prepared={"positiveFraction": pos / n, "upSample": self._up,
                      "downSample": self._down, "alreadyBalanced": balanced})
        return self.summary

    def prepare_weights(self, y: np.ndarray) -> np.ndarray:
        if self.summary is None:
            self.pre_validation_prepare(y)
        y = np.asarray(y)
        minority = (y == 1.0) if self._minority_is_positive else (y != 1.0)
        w = np.where(minority, self._up, self._down)
        return w.astype(np.float32)

    def prepare_indices(self, y, rng=None) -> np.ndarray:
        if self.summary is None:
            self.pre_validation_prepare(y)
        rng = rng or np.random.default_rng(self.seed)
        y = np.asarray(y)
        minority = np.where((y == 1.0) if self._minority_is_positive else (y != 1.0))[0]
        majority = np.setdiff1d(np.arange(len(y)), minority)
        out = []
        if self._up >= 1.0:
            out.append(minority)
            extra = int(round((self._up - 1.0) * len(minority)))
            if extra > 0 and len(minority):
                out.append(rng.choice(minority, size=extra, replace=True))
        elif len(minority):  # capped branch: both classes downsample
            k = int(round(self._up * len(minority)))
            out.append(rng.choice(minority, size=k, replace=False))
        if self._down < 1.0:
            k = int(round(self._down * len(majority)))
            out.append(rng.choice(majority, size=k, replace=False))
        else:
            out.append(majority)
        return np.sort(np.concatenate(out))

    def _params(self):
        return {**super()._params(), "sampleFraction": self.sample_fraction,
                "maxTrainingSample": self.max_training_sample}


class DataCutter(Splitter):
    """Multiclass label cutter (DataCutter.scala:78): keep at most
    ``max_label_categories`` labels each with at least ``min_label_fraction``
    support; rows with dropped labels get zero weight / are removed."""

    def __init__(self, max_label_categories: int = 100, min_label_fraction: float = 0.0,
                 reserve_test_fraction: float = 0.1, seed: int = 42):
        super().__init__(reserve_test_fraction, seed)
        if min_label_fraction >= 0.5:
            raise ValueError("min_label_fraction must be < 0.5")
        self.max_label_categories = max_label_categories
        self.min_label_fraction = min_label_fraction
        self.labels_kept: Optional[List[float]] = None

    def pre_validation_prepare(self, y: np.ndarray) -> SplitterSummary:
        y = np.asarray(y)
        n = max(len(y), 1)
        vals, counts = np.unique(y, return_counts=True)
        order = np.argsort(-counts)
        kept = []
        for i in order[: self.max_label_categories]:
            if counts[i] / n >= self.min_label_fraction:
                kept.append(float(vals[i]))
        dropped = [float(v) for v in vals if float(v) not in set(kept)]
        self.labels_kept = sorted(kept)
        self.summary = SplitterSummary(
            type(self).__name__, self._params(),
            prepared={"labelsKept": self.labels_kept, "labelsDropped": dropped})
        return self.summary

    def prepare_weights(self, y: np.ndarray) -> np.ndarray:
        if self.labels_kept is None:
            self.pre_validation_prepare(y)
        keep = np.isin(np.asarray(y), np.asarray(self.labels_kept))
        return keep.astype(np.float32)

    def prepare_indices(self, y, rng=None) -> np.ndarray:
        if self.labels_kept is None:
            self.pre_validation_prepare(y)
        return np.where(np.isin(np.asarray(y), np.asarray(self.labels_kept)))[0]

    def _params(self):
        return {**super()._params(), "maxLabelCategories": self.max_label_categories,
                "minLabelFraction": self.min_label_fraction}
