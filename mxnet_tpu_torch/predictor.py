"""Standalone inference predictor.

Counterpart of ``mxnet_tpu/predictor.py``: load a symbol and its parameters,
then ``set_input`` / ``forward`` / ``get_output``, and ``export`` / ``load``
one zip bundle (``symbol.json``, ``manifest.json``, ``params/<name>.npy``,
``aux/<name>.npy``) in the JAX package's layout, so that each package reads
the other's bundle.

Differences from the JAX package: the default context is
:func:`current_context`, ``gpu(0)`` outside any ``with`` block, which raises
where there is no CUDA (pass ``ctx=cpu()`` to run on the CPU); and
``quantize="int8"`` quantizes each FullyConnected weight once, here, rather
than at every call.

On a card each input shape's forward is captured into a CUDA graph at its
second request (the first runs eager on a side stream) and replayed after
that: a request copies its inputs into the graph's static buffers, replays
and copies the outputs out. ``MXTPU_CUDA_GRAPHS=0`` and a ``_Native`` node
keep it eager (as does the CPU), and each program's first request counts
that reason in ``utils.compile.compile_stats()["eager"]``.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from . import symbol as sym_mod
from .base import MXNetError
from .context import current_context
from .convert import to_tensor
from .executor import _build_graph_fn, has_native
from .kernels.int8_matmul import int8_predict_scope, quantize_channels
from .utils import compile as compile_mod

__all__ = ["Predictor"]


def _as_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype if isinstance(dtype, str) else np.dtype(dtype).name)


class Predictor:
    """Forward-only bound model (reference: MXPredCreate/Forward/GetOutput)."""

    def __init__(self, symbol, arg_params, aux_params=None, ctx=None,
                 input_names=("data",), compute_dtype=None, quantize=None):
        if isinstance(symbol, str):
            symbol = sym_mod.load_json(symbol) if symbol.lstrip().startswith("{") \
                else sym_mod.load(symbol)
        self.symbol = symbol
        self.ctx = ctx or current_context()
        self.input_names = list(input_names)
        self.compute_dtype = _as_dtype(compute_dtype)
        if quantize not in (None, False, "int8"):
            raise MXNetError(f"Predictor quantize= must be None or 'int8', "
                             f"got {quantize!r}")
        self.quantize = quantize or None
        dev = self.ctx.torch_device
        self._params = {k: to_tensor(v, dev) for k, v in arg_params.items()}
        self._aux = {k: to_tensor(v, dev) for k, v in (aux_params or {}).items()}
        self._inputs = {}
        self._outputs = None
        self._label_cache = {}
        self._programs = {}  # input signature -> (static inputs, program)
        self._seen = set()  # program keys counted in utils.compile
        self._fp = compile_mod.graph_fingerprint(symbol)
        self._graph_fn = _build_graph_fn(symbol)
        self._run_params = {k: self._cast(v) for k, v in self._params.items()}
        if self.quantize == "int8":
            # quantize_channels of the same weight gives the same bits at
            # every call, so quantizing once here serves exactly what the
            # JAX package, which quantizes inside each call, serves
            for node in symbol._topo():
                if node.is_variable or node.op.name != "FullyConnected":
                    continue
                w_name = node.inputs[1][0].name
                if w_name in self._params:
                    self._run_params[w_name] = quantize_channels(
                        self._cast(self._params[w_name]))

    @staticmethod
    def create(prefix: str, epoch: int, ctx=None, **kwargs) -> "Predictor":
        """From a training checkpoint pair ``prefix-symbol.json`` and
        ``prefix-%04d.params``, as either package's ``save_checkpoint``
        writes it (reference: MXPredCreate)."""
        from .model import load_checkpoint

        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return Predictor(symbol, arg_params, aux_params, ctx=ctx, **kwargs)

    def _cast(self, v):
        cdt = self.compute_dtype
        if cdt is not None and v.is_floating_point():
            return v.to(cdt)
        return v

    def set_input(self, name, value):
        if hasattr(value, "asnumpy"):
            value = value.asnumpy()
        if isinstance(value, torch.Tensor):
            value = value.to(self.ctx.torch_device, torch.float32)
        else:
            value = torch.from_numpy(np.array(value, np.float32)).to(
                self.ctx.torch_device)
        self._inputs[name] = value

    def forward(self, **inputs):
        for k, v in inputs.items():
            self.set_input(k, v)
        inputs = {k: self._cast(v) for k, v in self._inputs.items()}
        inputs.update(self._fill_labels())
        key = compile_mod.program_key(self._fp, None, inputs,
                                      self.compute_dtype, None, False)
        label = f"predict:{self._fp}" + (":int8" if self.quantize else "")
        first = compile_mod.registry().see(label, key, self._seen)
        dev = self.ctx.torch_device
        reason = compile_mod.eager_reason(dev, has_native(self.symbol))
        if reason is not None:
            if first:
                compile_mod.note_eager(reason)
            with torch.inference_mode(), \
                    int8_predict_scope(self.quantize == "int8"):
                outs, _ = self._graph_fn({**self._run_params, **inputs},
                                         self._aux)
                self._outputs = tuple(o.float() for o in outs)
            return self
        held = self._programs.get(key)
        if held is None:
            static = {k: torch.empty_like(v) for k, v in inputs.items()}

            def run():
                with torch.no_grad(), \
                        int8_predict_scope(self.quantize == "int8"):
                    outs, _ = self._graph_fn({**self._run_params, **static},
                                             self._aux)
                    return tuple(o.float() for o in outs)

            held = self._programs[key] = (static, compile_mod.CapturedProgram(
                run, dev, label, warmup=1))
        static, program = held
        for k, v in inputs.items():
            static[k].copy_(v, non_blocking=True)
        self._outputs = tuple(o.clone() for o in program())
        return self

    def _fill_labels(self):
        # cached per input-shape signature: shape inference walks the whole
        # graph, too heavy for a per-request serving loop
        sig = tuple(sorted((k, tuple(v.shape)) for k, v in self._inputs.items()))
        if sig in self._label_cache:
            return self._label_cache[sig]
        arg_names = self.symbol.list_arguments()
        provided = set(self._params) | set(self._inputs)
        missing = [n for n in arg_names if n not in provided]
        if not missing:
            self._label_cache[sig] = {}
            return {}
        known = {k: tuple(v.shape) for k, v in self._inputs.items()}
        known.update({k: tuple(v.shape) for k, v in self._params.items()
                      if k in arg_names})
        arg_shapes, _, _ = self.symbol.infer_shape(**known)
        shape_of = dict(zip(arg_names, arg_shapes))
        result = {n: self._cast(torch.zeros(shape_of[n], dtype=torch.float32,
                                            device=self.ctx.torch_device))
                  for n in missing}
        self._label_cache[sig] = result
        return result

    def get_output(self, index=0) -> np.ndarray:
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs[index].cpu().numpy()

    def export(self, path: str):
        """Write one self-contained bundle: symbol JSON + all params."""
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("symbol.json", self.symbol.tojson())
            manifest = {"inputs": self.input_names,
                        "params": sorted(self._params),
                        "aux": sorted(self._aux)}
            z.writestr("manifest.json", json.dumps(manifest))
            for k, v in self._params.items():
                z.writestr(f"params/{k}.npy", _npy_bytes(v))
            for k, v in self._aux.items():
                z.writestr(f"aux/{k}.npy", _npy_bytes(v))

    @staticmethod
    def load(path: str, ctx=None, **kwargs) -> "Predictor":
        with zipfile.ZipFile(path) as z:
            symbol = sym_mod.load_json(z.read("symbol.json").decode())
            manifest = json.loads(z.read("manifest.json"))
            params = {k: np.load(io.BytesIO(z.read(f"params/{k}.npy")))
                      for k in manifest["params"]}
            aux = {k: np.load(io.BytesIO(z.read(f"aux/{k}.npy")))
                   for k in manifest["aux"]}
        return Predictor(symbol, params, aux, ctx=ctx,
                         input_names=manifest["inputs"], **kwargs)


def _npy_bytes(t: torch.Tensor) -> bytes:
    buf = io.BytesIO()
    np.save(buf, t.cpu().numpy())
    return buf.getvalue()
