"""Typed parameter declaration, the dmlc::Parameter equivalent.

Counterpart of ``mxnet_tpu/params.py``: an op declares

    params = {name: (type, default_or_REQUIRED, doc), ...}

where ``type`` is a callable coercer (int/float/str/bool), a tuple of strings
(enum), :class:`TupleParam` or :class:`Range`. :func:`apply_params` validates
and normalises keyword arguments against the spec.
"""

from __future__ import annotations

import ast

from .base import MXNetError

__all__ = ["REQUIRED", "TupleParam", "Range", "apply_params", "autodoc"]

REQUIRED = object()


class TupleParam:
    """Int-tuple params like kernel/stride/pad ('(2,2)', [2, 2], or 2 ok)."""

    def __init__(self, length=None):
        self.length = length

    def __call__(self, value):
        if isinstance(value, str):
            value = ast.literal_eval(value)
        if isinstance(value, int):
            value = (value,) * (self.length or 1)
        value = tuple(int(v) for v in value)
        if self.length is not None and len(value) != self.length:
            raise MXNetError(f"expected tuple of length {self.length}, got {value}")
        return value

    @property
    def __name__(self):
        return "tuple of int"


class Range:
    """Numeric param with inclusive bounds, or an exclusive upper bound with
    ``hi_exclusive`` (Dropout p < 1)."""

    def __init__(self, typ, lo=None, hi=None, hi_exclusive=False):
        self.typ, self.lo, self.hi = typ, lo, hi
        self.hi_exclusive = hi_exclusive

    def __call__(self, value):
        value = self.typ(value)
        if self.lo is not None and value < self.lo:
            raise MXNetError(f"expected value >= {self.lo}, got {value}")
        if self.hi is not None:
            if self.hi_exclusive and value >= self.hi:
                raise MXNetError(f"expected value < {self.hi}, got {value}")
            if not self.hi_exclusive and value > self.hi:
                raise MXNetError(f"expected value <= {self.hi}, got {value}")
        return value

    @property
    def __name__(self):
        bounds = []
        if self.lo is not None:
            bounds.append(f">= {self.lo}")
        if self.hi is not None:
            bounds.append(("< " if self.hi_exclusive else "<= ") + str(self.hi))
        return f"{self.typ.__name__} ({', '.join(bounds)})" if bounds else \
            self.typ.__name__


def coerce(typ, value):
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(typ, (TupleParam, Range)):
        return typ(value)
    if isinstance(typ, tuple):  # enum of strings
        if value not in typ:
            raise MXNetError(f"expected one of {typ}, got {value!r}")
        return value
    return typ(value)


def apply_params(owner_name: str, spec: dict, kwargs: dict,
                 tolerated=()) -> dict:
    """Validate ``kwargs`` against ``spec``; return the full normalised dict.

    Unknown keys, missing required keys and unparseable values raise
    :class:`MXNetError` naming the owner and the field. An explicit None means
    "use the default". The key order (given keys first, then defaults in spec
    order) matches the JAX package, so serialised graphs are identical. Keys
    in ``tolerated`` (reference flags with no effect here) are dropped with a
    warning.
    """
    out = {}
    for key, value in kwargs.items():
        if key not in spec:
            if key in tolerated:
                import warnings

                warnings.warn(
                    f"{owner_name}: parameter {key!r} is a reference-only "
                    f"flag with no effect here; ignored", stacklevel=3)
                continue
            raise MXNetError(
                f"{owner_name}: unknown parameter {key!r}; "
                f"accepts {sorted(spec)}")
        if value is None:
            if spec[key][1] is REQUIRED:
                raise MXNetError(
                    f"{owner_name}: parameter {key!r} is required (got None)")
            continue
        try:
            out[key] = coerce(spec[key][0], value)
        except MXNetError as e:
            raise MXNetError(f"{owner_name}: parameter {key!r}: {e}") from None
        except (TypeError, ValueError) as e:
            raise MXNetError(
                f"{owner_name}: parameter {key!r}: cannot parse {value!r} "
                f"({e})") from None
    for key, (_typ, default, _doc) in spec.items():
        if key not in out:
            if default is REQUIRED:
                raise MXNetError(f"{owner_name}: parameter {key!r} is required")
            out[key] = default
    return out


def _type_name(typ):
    name = getattr(typ, "__name__", None)
    if name:
        return name
    if isinstance(typ, tuple):
        return f"one of {typ}"
    return str(typ)


def autodoc(cls):
    """Append a generated Parameters section to ``cls.__doc__`` from
    ``cls.params``."""
    if not getattr(cls, "params", None):
        return cls
    lines = [cls.__doc__ or "", "", "Parameters", "----------"]
    for key, (typ, default, doc) in cls.params.items():
        req = "required" if default is REQUIRED else f"default={default!r}"
        lines.append(f"{key} : {_type_name(typ)}, {req}")
        lines.append(f"    {doc}")
    cls.__doc__ = "\n".join(lines)
    return cls
