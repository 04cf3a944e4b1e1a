"""Operator library: importing this package registers every ported operator.

See registry.py for the OpProp contract.
"""

from .registry import OPS, OpProp, REQUIRED, TupleParam, register_op
from . import tensor  # noqa: F401  (registration side effects)
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import native  # noqa: F401

__all__ = ["OPS", "OpProp", "REQUIRED", "TupleParam", "register_op"]
