"""Memory-plan introspection, the port's counterpart of
``examples/memcost/memcost.py`` (reference: example/memcost — prints 'Total
N MB allocated' for inception-bn b32 under different memory strategies via
GraphExecutor::Print).

The JAX script reads XLA's buffer assignment; the port has no compiler
plan, so each strategy is measured on the pass itself, on the CPU and on
the card alike:

  no_optimization  -> the sum of every intermediate of ``get_internals()``
                      by shape inference, 4 bytes an element (an upper
                      bound; the JAX script's number, the same arithmetic)
  forward_only     -> the peak of the bytes held by tensors that a forward
                      under ``torch.no_grad()`` makes (a dispatch mode
                      counts each storage from its first tensor to the
                      death of its last; the graph function drops each
                      intermediate after its last reader)
  inplace+sharing  -> a training forward and backward: the bytes autograd
                      saves for the backward (``saved_tensors_hooks``, each
                      storage once, arguments and auxiliary states left
                      out), what a training pass must hold beyond its
                      working set
  + remat          -> the same count with the port's own remat
                      (``MXNET_TPU_REMAT``: each Inception block, up to its
                      ``_concat``, recomputed in the backward by
                      ``executor._checkpointed``), which saves only the
                      blocks' inputs and the head's tensors

On the card each line also gives the allocator's peak over the pass
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``,
less what was allocated before it).

    python -m mxnet_tpu_torch.examples.memcost.memcost [--cpu]
"""

import os
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import cpu_parser, example_context

BATCH = 32
REMAT_PATTERN = r"_concat$"


def mb(x):
    return x / (1 << 20)


def no_optimization_bytes(sym, shapes):
    """Every intermediate held live: the internals' shapes, f32."""
    _, out_shapes, _ = sym.get_internals().infer_shape(**shapes)
    return sum(int(np.prod(s)) * 4 for s in out_shapes)


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that the ops under it make, counted from
    the first tensor on a storage to the death of the last; ``peak`` is
    the most held at once. Storages in ``skip`` (the inputs) never count."""

    def __init__(self, skip=()):
        super().__init__()
        self.skip = set(skip)
        self.tensors, self.nbytes = {}, {}
        self.live = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _track(self, t):
        storage = t.untyped_storage()
        key = storage.data_ptr()
        if key in self.skip or storage.nbytes() == 0:
            return
        if key not in self.tensors:
            self.tensors[key] = 0
            self.nbytes[key] = storage.nbytes()
            self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
        self.tensors[key] += 1
        weakref.finalize(t, self._gone, key)

    def _gone(self, key):
        self.tensors[key] -= 1
        if self.tensors[key] == 0:
            del self.tensors[key]
            self.live -= self.nbytes.pop(key)


def storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


class CardPeak:
    """The allocator's peak over a block, less what it held before (None
    off the card)."""

    def __init__(self, device):
        self.on = device.type == "cuda"
        self.bytes = None

    def __enter__(self):
        if self.on:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.base = torch.cuda.memory_allocated()
        return self

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.synchronize()
            self.bytes = torch.cuda.max_memory_allocated() - self.base


def forward_only(sym, args, aux):
    from mxnet_tpu_torch.executor import _build_graph_fn

    fwd = _build_graph_fn(sym, is_train=False)
    dev = next(iter(args.values())).device
    with CardPeak(dev) as card, torch.no_grad(), \
            LiveBytes(storages([*args.values(), *aux.values()])) as live:
        outs, _ = fwd(args, aux)
        del outs
    return live.peak, card.bytes


def saved_for_backward(sym, args, aux, remat=None):
    """A training forward of ``sum(outputs[0])`` and its gradient with
    respect to every argument: the bytes autograd saved, and the card's
    peak. ``remat`` is an ``MXNET_TPU_REMAT`` pattern."""
    from mxnet_tpu_torch.executor import _build_graph_fn

    prior = os.environ.get("MXNET_TPU_REMAT")
    if remat is None:
        os.environ.pop("MXNET_TPU_REMAT", None)
    else:
        os.environ["MXNET_TPU_REMAT"] = remat
    try:
        fn = _build_graph_fn(sym, is_train=True)
    finally:
        if prior is None:
            os.environ.pop("MXNET_TPU_REMAT", None)
        else:
            os.environ["MXNET_TPU_REMAT"] = prior
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in args.items()}
    inputs = storages([*leaves.values(), *aux.values()])
    saved = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in inputs:
            saved[storage.data_ptr()] = storage.nbytes()
        return t

    gen = torch.Generator(device=next(iter(args.values())).device)
    with CardPeak(gen.device) as card:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            outs, _ = fn(leaves, aux, gen)
            loss = outs[0].sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        del outs, loss, grads
    return sum(saved.values()), card.bytes


def report(ctx):
    """The four lines; returns ``{tag: bytes}`` and the card's peaks."""
    from mxnet_tpu_torch.models import inception_bn_cifar

    sym = inception_bn_cifar()
    shapes = {"data": (BATCH, 3, 28, 28), "softmax_label": (BATCH,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    dev = ctx.torch_device
    args = {n: torch.zeros(s, device=dev)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: torch.zeros(s, device=dev)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}

    # upper bound: every intermediate held live (≙ no_optimization)
    naive = no_optimization_bytes(sym, shapes)
    print(f"no_optimization (sum of all intermediates): {mb(naive):8.2f} MB")
    out = {"no_optimization": naive}
    card = {}

    def line(tag, key, total, peak):
        out[key], card[key] = total, peak
        extra = "" if peak is None else \
            f" (card allocator peak {mb(peak):.2f})"
        print(f"{tag:45s}: {mb(total):8.2f} MB{extra}")

    line("forward_only (live tensors under no_grad)", "forward_only",
         *forward_only(sym, args, aux))
    line("inplace+sharing train fwd+bwd (saved tensors)", "train",
         *saved_for_backward(sym, args, aux))
    line("train fwd+bwd with remat (saved tensors)", "remat",
         *saved_for_backward(sym, args, aux, REMAT_PATTERN))
    return out, card


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        return report(ctx)


if __name__ == "__main__":
    main()
