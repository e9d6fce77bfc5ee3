"""Typed feature values — the port's host copy of ``transmogrifai_tpu.types``.

Reference parity: features/src/main/scala/com/salesforce/op/features/types/
(~45 nominal types).  See module docstrings for per-file pointers.
"""
from .base import (
    Categorical,
    FeatureType,
    Location,
    MultiResponse,
    NonNullable,
    OPCollection,
    OPList,
    OPMap,
    OPNumeric,
    OPSet,
    SingleResponse,
)
from .numerics import Binary, Currency, Date, DateTime, Integral, Percent, Real, RealNN
from .text import (
    Base64,
    City,
    ComboBox,
    Country,
    Email,
    ID,
    Phone,
    PickList,
    PostalCode,
    State,
    Street,
    Text,
    TextArea,
    URL,
)
from .collections import (
    DateList,
    DateTimeList,
    Geolocation,
    MultiPickList,
    OPVector,
    TextList,
)
from .maps import (
    Base64Map,
    BinaryMap,
    CityMap,
    ComboBoxMap,
    CountryMap,
    CurrencyMap,
    DateMap,
    DateTimeMap,
    EmailMap,
    GeolocationMap,
    IDMap,
    IntegralMap,
    MultiPickListMap,
    NameStats,
    PercentMap,
    PhoneMap,
    PickListMap,
    PostalCodeMap,
    Prediction,
    RealMap,
    StateMap,
    StreetMap,
    TextAreaMap,
    TextMap,
    URLMap,
)
from .factory import FEATURE_TYPES, default_of, feature_type_by_name, is_nullable, make

__all__ = [n for n in dir() if not n.startswith("_")]
