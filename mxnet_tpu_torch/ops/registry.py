"""Operator registry and the OpProp contract.

Counterpart of ``mxnet_tpu/ops/registry.py``. One class per op: metadata
(arguments, outputs, auxiliary states, shape inference) and a forward
``fwd(ins, aux, is_train, rng) -> (outs, new_aux)`` on torch tensors, the JAX
package's signature. Gradients come from autograd; ops whose reference
backward is not the derivative of their forward (the loss heads, BlockGrad)
or that save fewer residuals than autograd would (the fused BatchNorm
forms) wrap a ``torch.autograd.Function``. ``rng`` is a ``torch.Generator``
on the tensors' device, or None where no node draws.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..base import MXNetError, Registry
from ..params import REQUIRED, Range, TupleParam, apply_params, autodoc

__all__ = ["OpProp", "OPS", "register_op", "REQUIRED", "Range", "TupleParam",
           "draw", "DrawTape", "as_dtype"]

OPS = Registry("operator")


_NUMPY_OF = {}  # torch dtype -> its numpy dtype


def as_dtype(dtype):
    """A dtype as the port names it, NDArray's ``dtype`` rule:
    ``torch.bfloat16`` for bfloat16 (numpy has none; a numpy bfloat16
    dtype or the name ``"bfloat16"`` too), else the numpy dtype of a torch
    dtype or of anything ``numpy.dtype`` takes. Graph verification calls
    it for every node on every bind, so each case is a lookup."""
    if isinstance(dtype, np.dtype):
        return torch.bfloat16 if dtype.type.__name__ == "bfloat16" \
            else dtype
    if dtype is torch.bfloat16 or dtype == "bfloat16":
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        if dtype not in _NUMPY_OF:
            _NUMPY_OF[dtype] = torch.empty(0, dtype=dtype).numpy().dtype
        return _NUMPY_OF[dtype]
    return as_dtype(np.dtype(dtype))


_TAPE = threading.local()


def draw(shape, rng, device, derive) -> torch.Tensor:
    """``derive(torch.rand(shape, generator=rng, device=device))``: every
    draw a graph node makes, turned at once into what the node keeps
    (Dropout's bool mask, rrelu's slopes in the input's dtype). While a
    :class:`DrawTape` is active on this thread, the draw goes through it."""
    tape = getattr(_TAPE, "tape", None)
    if tape is None:
        return derive(torch.rand(shape, generator=rng, device=device))
    return tape.draw(shape, rng, device, derive)


class DrawTape:
    """The draws of one rematerialised block: its forward draws from the
    generator and keeps what each node derived from its draw, no more than
    the plain step's autograd keeps (a bool mask, not the f32 uniforms);
    its recompute gets them back in order instead of drawing again. The
    recompute so repeats the forward's bits without reading or restoring
    the generator's state, which a CUDA graph could not hold (the JAX
    package re-derives them from the key)."""

    def __init__(self):
        self.kept = []
        self._replay_at = None  # None: the forward, recording

    @contextlib.contextmanager
    def active(self, replay: bool):
        prev = getattr(_TAPE, "tape", None)
        _TAPE.tape = self
        self._replay_at = 0 if replay else None
        try:
            yield
        finally:
            _TAPE.tape = prev

    def draw(self, shape, rng, device, derive):
        if self._replay_at is None:
            t = derive(torch.rand(shape, generator=rng, device=device))
            self.kept.append(t)
            return t
        i = self._replay_at
        kept = tuple(self.kept[i].shape) if i < len(self.kept) else None
        if kept != tuple(shape):
            raise MXNetError(f"a recompute drew {tuple(shape)} where its "
                             f"forward's draw {i} was {kept}")
        self._replay_at = i + 1
        return self.kept[i]


class OpProp:
    """Base class for operator properties (metadata + forward).

    Subclasses define:
      params       : dict name -> (type, default|REQUIRED, doc)
      list_arguments / list_outputs / list_auxiliary_states
      infer_shape(in_shapes) -> (in_shapes, out_shapes, aux_shapes)
      infer_dtype(in_dtypes) -> (in_dtypes, out_dtypes, aux_dtypes)
      fwd(ins, aux, is_train, rng) -> (outs, new_aux)
      need_rng     : True if fwd draws random numbers in training mode
      is_loss      : the op is a loss head whose backward injects its own
                     gradient and ignores the incoming one
    """

    params: dict = {}
    need_rng = False
    is_loss = False
    # loss heads that can zero padded rows' injected gradients implement
    # fwd_masked: forward identical to fwd, backward times a (batch,) mask
    supports_loss_mask = False

    def __init__(self, **kwargs):
        self.attr = apply_params(type(self).__name__, type(self).params, kwargs)

    def __getattr__(self, item):
        try:
            return self.__dict__["attr"][item]
        except KeyError:
            raise AttributeError(item) from None

    @property
    def name(self):
        return type(self).op_name

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def num_inputs(self):
        return len(self.list_arguments())

    def num_outputs(self):
        return len(self.list_outputs())

    def infer_shape(self, in_shapes):
        """Complete partial input shapes; return (in, out, aux) shape lists.

        ``in_shapes`` entries are tuples or None (unknown). The default
        requires the first input and propagates it elementwise.
        """
        d = self._known(in_shapes, 0)
        return [d] * len(in_shapes), [d], []

    def _known(self, in_shapes, idx):
        s = in_shapes[idx]
        if s is None:
            raise MXNetError(
                f"{self.name}: shape of input '{self.list_arguments()[idx]}' unknown"
            )
        return tuple(s)

    # -- dtype inference ------------------------------------------------------
    def infer_dtype(self, in_dtypes):
        """Complete partial input dtypes; return (in, out, aux) dtype lists
        (mxnet_tpu/ops/registry.py:99-129), dtypes as :func:`as_dtype`
        names them. The default propagates the first known input dtype
        everywhere and requires the known inputs to agree, except a loss
        head's ``label``, whose dtype is independent of the data path.
        Ops with heterogeneous inputs (Embedding) override."""
        args = self.list_arguments()
        known = [(i, as_dtype(d)) for i, d in enumerate(in_dtypes)
                 if d is not None]
        if not known:
            raise MXNetError(f"{self.name}: no input dtype known")
        d = known[0][1]
        for i, dt in known:
            if self.is_loss and args[i] == "label":
                continue
            if dt != d:
                raise MXNetError(
                    f"{self.name}: input '{args[i]}' has dtype {dt} but "
                    f"'{args[known[0][0]]}' has dtype {d}")
        completed = [as_dtype(in_dtypes[i]) if in_dtypes[i] is not None
                     else d for i in range(len(in_dtypes))]
        return (completed, [d] * self.num_outputs(),
                [d] * len(self.list_auxiliary_states()))

    def fwd(self, ins, aux, is_train, rng):
        raise NotImplementedError

    def fwd_masked(self, ins, aux, is_train, rng, mask):
        raise MXNetError(
            f"{type(self).__name__} does not support loss masking")

    def loss_value(self, out, label, mask=None):
        """The scalar loss whose gradient this head injects, from its
        already-computed output; None where the op prices no loss."""
        del out, label, mask
        return None

    def serialize_params(self) -> dict:
        """JSON-able param dict for Symbol save/load."""
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in self.attr.items()}

    def __repr__(self):
        return f"{type(self).__name__}({self.attr})"


def register_op(op_name, aliases=()):
    """Register an OpProp subclass under ``op_name`` (+ optional aliases)."""

    def _reg(cls):
        cls.op_name = op_name
        cls.op_aliases = tuple(aliases)
        OPS.register(op_name)(cls)
        for alias in aliases:
            OPS._entries[alias.lower()] = cls
        autodoc(cls)
        return cls

    return _reg
