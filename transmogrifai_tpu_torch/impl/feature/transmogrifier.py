"""Transmogrifier — automatic per-type default vectorization.

The port's counterpart of ``transmogrifai_tpu/impl/feature/transmogrifier.py``
(reference: Transmogrifier.scala:92; dispatch :102-300; defaults :52-88):
groups features by type, applies each type's default vectorizer and
combines the outputs into one OPVector.  The port dispatches the types
whose vectorizers it has: vectors, predictions, categorical text (pivot),
free text (smart text), binary, integral, non-nullable real and real
numerics (with the label-aware decision-tree buckets beside the reals).  Dates, geolocations, lists and
maps raise, naming the type.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Type

from ... import types as T
from ...features.feature import Feature
from .bucketizers import DecisionTreeNumericBucketizer
from .smart_text import SmartTextVectorizer
from .vectorizers import (BinaryVectorizer, IntegralVectorizer, OneHotVectorizer,
                          RealNNVectorizer, RealVectorizer, VectorsCombiner)


class TransmogrifierDefaults:
    """Transmogrifier.scala:52-88."""

    DefaultNumOfFeatures = 512
    MaxNumOfFeatures = 2 ** 17
    TopK = 20
    MinSupport = 10
    FillValue = 0
    BinaryFillValue = False
    FillWithMean = True
    FillWithMode = True
    TrackNulls = True
    TrackInvalid = False
    MinInfoGain = 0.01
    MaxCategoricalCardinality = 30


_CATEGORICAL_TEXT = (T.PickList, T.ComboBox, T.Country, T.State, T.City,
                     T.PostalCode, T.Street, T.ID)
_FREE_TEXT = (T.TextArea, T.Email, T.URL, T.Phone, T.Base64, T.Text)
#: types the JAX package vectorizes with stages the port does not have yet;
#: dispatched ahead of their bases (Date < Integral, Geolocation < OPList)
_UNPORTED = (T.Geolocation, T.DateList, T.TextList, T.MultiPickList, T.OPMap, T.Date)


def transmogrify(features: Sequence[Feature], label: Optional[Feature] = None,
                 defaults: Type[TransmogrifierDefaults] = TransmogrifierDefaults) -> Feature:
    """Vectorize a heterogeneous feature set with per-type defaults and
    combine into one OPVector feature (Transmogrifier.scala:92).  ``label``
    adds the decision-tree buckets of each real feature."""
    if not features:
        raise ValueError("transmogrify requires at least one feature")
    d = defaults
    dispatch = [
        (T.OPVector, lambda fs: list(fs)),
        (T.Prediction, lambda fs: []),  # predictions are not predictors
        *[(t, None) for t in _UNPORTED],
        *[(t, lambda fs: [OneHotVectorizer(top_k=d.TopK, min_support=d.MinSupport,
                                           track_nulls=d.TrackNulls)
                          .set_input(*fs).get_output()]) for t in _CATEGORICAL_TEXT],
        *[(t, lambda fs: [SmartTextVectorizer(max_cardinality=d.MaxCategoricalCardinality,
                                              top_k=d.TopK, min_support=d.MinSupport,
                                              num_hashes=d.DefaultNumOfFeatures,
                                              track_nulls=d.TrackNulls)
                          .set_input(*fs).get_output()]) for t in _FREE_TEXT],
        (T.Binary, lambda fs: [BinaryVectorizer(track_nulls=d.TrackNulls)
                               .set_input(*fs).get_output()]),
        (T.Integral, lambda fs: [IntegralVectorizer(track_nulls=d.TrackNulls)
                                 .set_input(*fs).get_output()]),
        (T.RealNN, lambda fs: [RealNNVectorizer().set_input(*fs).get_output()]),
        (T.Real, lambda fs: _real_outputs(fs, label, d)),
    ]
    groups: Dict[type, List[Feature]] = {}
    for f in features:
        t = next((t for t, _ in dispatch if issubclass(f.ftype, t)), None)
        if t is None:
            raise ValueError(f"No default vectorizer for feature {f.name} "
                             f"({f.ftype.__name__})")
        groups.setdefault(t, []).append(f)
    vectors: List[Feature] = []
    for t, make in dispatch:
        fs = groups.get(t)
        if not fs:
            continue
        if make is None:
            raise NotImplementedError(
                f"the default vectorizer of {t.__name__} features "
                f"({[f.name for f in fs]}) is not ported yet")
        vectors.extend(make(fs))
    if len(vectors) == 1:
        return vectors[0]
    return VectorsCombiner().set_input(*vectors).get_output()


def _real_outputs(fs: Sequence[Feature], label: Optional[Feature],
                  d: Type[TransmogrifierDefaults]) -> List[Feature]:
    outs = [RealVectorizer(fill_with_mean=d.FillWithMean, track_nulls=d.TrackNulls)
            .set_input(*fs).get_output()]
    if label is not None:
        for f in fs:
            outs.append(DecisionTreeNumericBucketizer(min_info_gain=d.MinInfoGain,
                                                      track_nulls=d.TrackNulls,
                                                      track_invalid=True)
                        .set_input(label, f).get_output())
    return outs
