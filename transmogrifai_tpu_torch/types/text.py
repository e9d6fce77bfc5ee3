"""Text feature types.

Reference parity: features/.../types/Text.scala — ``Text`` plus 13 subtypes:
Email, Base64, Phone, ID, URL, TextArea, PickList, ComboBox, Country, State,
PostalCode, City, Street.  ``PickList`` is SingleResponse/Categorical.
"""
from __future__ import annotations

import base64 as _b64
from typing import Optional

from .base import Categorical, FeatureType, Location, SingleResponse


class Text(FeatureType):
    __slots__ = ()
    kind = "text"

    @classmethod
    def _convert(cls, value):
        if value is None:
            return None
        return str(value)

    @property
    def v(self) -> Optional[str]:
        return self._value

    @property
    def is_empty(self) -> bool:
        return self._value is None


class Email(Text):
    __slots__ = ()

    def prefix(self) -> Optional[str]:
        if self.is_empty or "@" not in self._value:
            return None
        p = self._value.split("@", 1)[0]
        return p or None

    def domain(self) -> Optional[str]:
        if self.is_empty or "@" not in self._value:
            return None
        d = self._value.split("@", 1)[1]
        return d or None


class Base64(Text):
    __slots__ = ()

    def as_bytes(self) -> Optional[bytes]:
        if self.is_empty:
            return None
        try:
            return _b64.b64decode(self._value)
        except Exception:
            return None

    def as_string(self) -> Optional[str]:
        b = self.as_bytes()
        if b is None:
            return None
        try:
            return b.decode("utf-8")
        except Exception:
            return None


class Phone(Text):
    __slots__ = ()


class ID(Text):
    __slots__ = ()


class URL(Text):
    __slots__ = ()

    def is_valid(self) -> bool:
        if self.is_empty:
            return False
        v = self._value
        if "://" not in v:
            return False
        scheme, _, rest = v.partition("://")
        return scheme.lower() in ("http", "https", "ftp") and "." in rest.split("/")[0]

    def domain(self) -> Optional[str]:
        if not self.is_valid():
            return None
        return self._value.split("://", 1)[1].split("/")[0]

    def protocol(self) -> Optional[str]:
        if not self.is_valid():
            return None
        return self._value.split("://", 1)[0]


class TextArea(Text):
    __slots__ = ()


class PickList(Text, SingleResponse, Categorical):
    __slots__ = ()


class ComboBox(Text):
    __slots__ = ()


class Country(Text, Location):
    __slots__ = ()


class State(Text, Location):
    __slots__ = ()


class PostalCode(Text, Location):
    __slots__ = ()


class City(Text, Location):
    __slots__ = ()


class Street(Text, Location):
    __slots__ = ()
