"""Custom operators in Python and numpy.

Counterpart of ``mxnet_tpu/operator.py`` (reference:
python/mxnet/operator.py NumpyOp): a subclass's instance is called like a
symbol constructor and puts a ``_Native`` node into the graph, which runs
the instance's numpy ``forward`` and ``backward`` on host copies
(``ops/native.py``).
"""

from __future__ import annotations

from . import symbol as sym_mod

__all__ = ["NumpyOp"]


class NumpyOp:
    """Base class for user ops written with numpy. Override ``forward``,
    ``backward``, ``list_arguments``, ``list_outputs`` and ``infer_shape``,
    then call the instance like a symbol constructor::

        class MySoftmax(NumpyOp):
            def forward(self, in_data, out_data): ...
            def backward(self, out_grad, in_data, out_data, in_grad): ...

        net = MySoftmax()(data=prev_sym, name="softmax")
    """

    def __init__(self, need_top_grad=True):
        self.need_top_grad = need_top_grad

    def forward(self, in_data, out_data):
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def __call__(self, *args, name=None, **kwargs):
        return sym_mod._create("_Native", *args, name=name, info=self,
                               need_top_grad=self.need_top_grad, **kwargs)
