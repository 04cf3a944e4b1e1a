"""Graph execution: the Symbol as a function of tensors, and the bound
Executor.

Counterpart of ``mxnet_tpu/executor.py``: ``_fusion_plan``,
``_remat_segments``, ``_build_graph_fn(symbol, is_train)`` and ``Executor``
with ``bind``, ``simple_bind`` and ``debug_str``. The Symbol is walked once
into a plain function of
(arguments, auxiliary states, generator, loss mask) that runs each node's
forward on torch tensors in topological order and returns the heads and the
updated auxiliary states. PyTorch runs eagerly, so there is no counterpart
of ``jit``; gradients come from autograd over that function. Remat
(``MXNET_TPU_REMAT``) runs its segments under ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import re
import time

import torch
import torch.utils.checkpoint

from . import random as _random
from .base import MXNetError, env_int, env_str
from .context import Context, current_context
from .convert import to_tensor
from .ops.registry import DrawTape
from .utils import compile as compile_mod

__all__ = ["Executor", "simple_bind", "_fusion_plan", "_remat_segments",
           "_build_graph_fn", "has_native"]


def has_native(symbol) -> bool:
    """Does the graph hold a ``_Native`` node (user numpy on the host)?
    Such a graph cannot be captured into a CUDA graph."""
    return any(not n.is_variable and n.op.name == "_Native"
               for n in symbol._topo())


def _fusion_plan(symbol):
    """The JAX package's graph-level fusion plan (mxnet_tpu/executor.py:49).

    Two patterns:
      - BatchNorm -> Activation(relu)            => BatchNorm.fwd_fused_relu
      - BatchNorm -> _Plus(bn, z) -> Activation(relu)
                                                 => BatchNorm.fwd_fused_add_relu
        (the ResNet bottleneck tail)
    It applies in eval too, and the port follows it so that both packages run
    the same arithmetic.

    Returns (fused_bn, passthrough, skip_bn, fused_add):
      fused_bn    : BN node ids to run with fwd_fused_relu
      passthrough : Activation node ids that become identity
      skip_bn     : BN node ids deferred into a fused add (not executed)
      fused_add   : add node id -> (bn_node, z_operand_index)
    Disabled by MXNET_TPU_FUSE=0, as in the JAX package.
    """
    if not env_int("MXNET_TPU_FUSE", 1):
        return frozenset(), frozenset(), frozenset(), {}
    nodes = symbol._topo()
    consumers: dict = {}
    for node in nodes:
        if node.is_variable:
            continue
        for s, k in node.inputs:
            consumers.setdefault((id(s), k), []).append(node)
    head_ids = {(id(n), i) for n, i in symbol._heads}

    def _sole_private_output(node):
        return len(consumers.get((id(node), 0), [])) == 1 and \
            (id(node), 0) not in head_ids

    fused_bn, passthrough = set(), set()
    skip_bn, fused_add = set(), {}
    for node in nodes:
        if node.is_variable or node.op.name != "Activation" \
                or node.op.act_type != "relu":
            continue
        src, k = node.inputs[0]
        if k != 0 or src.is_variable:
            continue
        if src.op.name == "BatchNorm":
            if _sole_private_output(src):
                fused_bn.add(id(src))
                passthrough.add(id(node))
        elif src.op.name == "_Plus" and _sole_private_output(src):
            add_node = src
            for z_idx in (1, 0):
                bn, bn_k = add_node.inputs[1 - z_idx]
                if bn_k == 0 and not bn.is_variable \
                        and bn.op.name == "BatchNorm" \
                        and _sole_private_output(bn):
                    skip_bn.add(id(bn))
                    fused_add[id(add_node)] = (bn, z_idx)
                    passthrough.add(id(node))
                    break
    return frozenset(fused_bn), frozenset(passthrough), frozenset(skip_bn), \
        fused_add


def _remat_segments(nodes):
    """Partition the topological order into rematerialisation segments
    (mxnet_tpu/executor.py:114-162).

    ``MXNET_TPU_REMAT`` is a regex; every compute node whose name matches
    closes a segment (the node is the segment's last member). Each closed
    segment runs under activation checkpointing: its interior activations
    are recomputed in the backward pass instead of being kept. For the
    ResNet zoo the unit outputs are the natural boundaries:
    ``MXNET_TPU_REMAT='unit\\d+_out$'``. The run after the last boundary
    (the head) stays inline.

    Returns None when the variable is unset or empty, else a list of
    ``('inline', topo_idx, node) | ('blk', [(topo_idx, node), ...])``.
    Variables never join blocks.
    """
    pat = env_str("MXNET_TPU_REMAT", "")
    if not pat:
        return None
    rx = re.compile(pat)
    runs, cur = [], []
    for i, node in enumerate(nodes):
        if node.is_variable:
            runs.append(("inline", i, node))
            continue
        cur.append((i, node))
        if rx.search(node.name):
            runs.append(("blk", cur))
            cur = []
    for i, node in cur:  # tail after the last boundary: head ops, inline
        runs.append(("inline", i, node))
    return runs


def _checkpointed(block_fn, ext_vals, aux_vals, rng, mask):
    """``block_fn(ext_vals, aux_vals, rng, mask)`` under activation
    checkpointing (``torch.utils.checkpoint``, non-reentrant: the autograd
    graph is the plain one, only its saved tensors are recomputed).

    The recompute must see what the forward drew: Dropout and rrelu draw
    from ``rng``, an explicit ``torch.Generator`` that checkpoint's own RNG
    preservation does not cover. Their draws go through a
    :class:`~.ops.registry.DrawTape`: the forward keeps them and the
    recompute reads them back, so the step draws what the plain step draws
    and touches no generator state on the host (a CUDA graph captures it
    whole). Auxiliary states come out of the forward only: a recompute's
    are dropped, so BatchNorm's moving statistics move once a step."""
    if not torch.is_grad_enabled():
        return block_fn(ext_vals, aux_vals, rng, mask)
    tape = DrawTape()
    calls = [0]

    def body(*ext):
        calls[0] += 1
        with tape.active(replay=calls[0] > 1):
            return block_fn(ext, aux_vals, rng, mask)

    return torch.utils.checkpoint.checkpoint(
        body, *ext_vals, use_reentrant=False, preserve_rng_state=False)


def _build_graph_fn(symbol, is_train: bool = False):
    """Compile the symbol DAG into ``fn(arg_values, aux_values, rng=None,
    mask=None) -> (outputs, new_aux)``: a tuple with one tensor per head and
    the auxiliary states after the pass (BatchNorm's running stats move in
    training mode). ``rng`` is the ``torch.Generator`` that nodes with
    ``need_rng`` draw from; ``mask`` is an optional (batch,) row mask that
    loss heads apply to their injected gradients (``fwd_masked``). With
    ``MXNET_TPU_REMAT`` set, the segments of :func:`_remat_segments` run
    checkpointed, as the JAX package runs them under ``jax.checkpoint``."""
    nodes = symbol._topo()
    fused_bn, passthrough, skip_bn, fused_add = _fusion_plan(symbol)

    def node_aux_names(node):
        if id(node) in fused_add:
            bn = fused_add[id(node)][0]
            return [f"{bn.name}_{a}" for a in bn.op.list_auxiliary_states()]
        if node.is_variable or id(node) in skip_bn or id(node) in passthrough:
            return []
        return [f"{node.name}_{a}" for a in node.op.list_auxiliary_states()]

    def node_input_refs(node):
        """The env refs exec_node reads for this node (fusion-aware), the
        one source the remat blocks' external inputs are resolved from."""
        if node.is_variable or id(node) in skip_bn:
            return []
        if id(node) in passthrough:
            src, k = node.inputs[0]
            return [(id(src), k)]
        if id(node) in fused_add:
            bn, z_idx = fused_add[id(node)]
            z_src, z_k = node.inputs[z_idx]
            return [(id(s), k) for s, k in bn.inputs] + [(id(z_src), z_k)]
        return [(id(s), k) for s, k in node.inputs]

    def exec_node(node, env, aux_values, new_aux, rng, mask):
        if id(node) in skip_bn:  # runs inside its fused add below
            return
        ins = [env[r] for r in node_input_refs(node)]
        if id(node) in passthrough:  # relu folded into the producer
            env[(id(node), 0)] = ins[0]
            return
        names = node_aux_names(node)
        aux = [aux_values[a] for a in names]
        if id(node) in fused_add:  # ins: bn.inputs..., then z
            outs, updated = fused_add[id(node)][0].op.fwd_fused_add_relu(
                ins, aux, is_train, None)
        else:
            key = rng if node.op.need_rng else None
            if id(node) in fused_bn:
                outs, updated = node.op.fwd_fused_relu(ins, aux, is_train, key)
            elif mask is not None and node.op.is_loss:
                outs, updated = node.op.fwd_masked(ins, aux, is_train, key,
                                                   mask)
            else:
                outs, updated = node.op.fwd(ins, aux, is_train, key)
        for k, o in enumerate(outs):
            env[(id(node), k)] = o
        new_aux.update(zip(names, updated))

    segments = _remat_segments(nodes)
    if segments is None:
        def fn(arg_values: dict, aux_values: dict, rng=None, mask=None):
            env = {}
            new_aux = dict(aux_values)
            for node in nodes:
                if node.is_variable:
                    env[(id(node), 0)] = arg_values[node.name]
                else:
                    exec_node(node, env, aux_values, new_aux, rng, mask)
            return tuple(env[(id(n), i)] for n, i in symbol._heads), new_aux

        return fn

    # -- remat: each block's external inputs, exports and aux states -------
    blocks = []  # ('inline', idx, node) | ['blk', members, exts, outs, auxs]
    for seg in segments:
        if seg[0] == "inline":
            blocks.append(seg)
            continue
        members = [n for _, n in seg[1]]
        member_ids = {id(n) for n in members}
        exts = []
        for node in members:
            for ref in node_input_refs(node):
                if ref[0] not in member_ids and ref not in exts:
                    exts.append(ref)
        aux_names = [a for node in members for a in node_aux_names(node)]
        blocks.append(["blk", members, exts, [], aux_names])
    # an export is a block's output read by a later block, an inline node
    # or a head
    producer = {id(n): bi for bi, seg in enumerate(blocks)
                if seg[0] == "blk" for n in seg[1]}

    def note_consumption(ref, consumer_bi):
        pbi = producer.get(ref[0])
        if pbi is not None and pbi != consumer_bi \
                and ref not in blocks[pbi][3]:
            blocks[pbi][3].append(ref)

    for bi, seg in enumerate(blocks):
        members = [seg[2]] if seg[0] == "inline" else seg[1]
        for node in members:
            for ref in node_input_refs(node):
                note_consumption(ref, bi)
    for n, i in symbol._heads:
        note_consumption((id(n), i), -1)

    def make_block_fn(members, exts, out_refs, aux_names):
        def block_fn(ext_vals, aux_vals, rng, mask):
            env = dict(zip(exts, ext_vals))
            aux_in = dict(zip(aux_names, aux_vals))
            new_aux = {}
            for node in members:
                exec_node(node, env, aux_in, new_aux, rng, mask)
            return (tuple(env[r] for r in out_refs),
                    tuple(new_aux.get(a, aux_in[a]) for a in aux_names))

        return block_fn

    runs = [seg if seg[0] == "inline" else
            ("blk", make_block_fn(*seg[1:]), seg[2], seg[3], seg[4])
            for seg in blocks]

    def fn(arg_values: dict, aux_values: dict, rng=None, mask=None):
        env = {}
        new_aux = dict(aux_values)
        for seg in runs:
            if seg[0] == "inline":
                node = seg[2]
                if node.is_variable:
                    env[(id(node), 0)] = arg_values[node.name]
                else:
                    exec_node(node, env, aux_values, new_aux, rng, mask)
                continue
            _, block_fn, exts, out_refs, aux_names = seg
            outs, updated = _checkpointed(
                block_fn, tuple(env[r] for r in exts),
                tuple(aux_values[a] for a in aux_names), rng, mask)
            env.update(zip(out_refs, outs))
            new_aux.update(zip(aux_names, updated))
        return tuple(env[(id(n), i)] for n, i in symbol._heads), new_aux

    return fn


def _normalize(names, values, what):
    if values is None:
        return {}
    if isinstance(values, dict):
        return dict(values)
    values = list(values)
    if len(values) != len(names):
        raise MXNetError(f"{what}: expected {len(names)} entries, got {len(values)}")
    return dict(zip(names, values))


class Executor:
    """A bound computation (reference: include/mxnet/symbolic.h Executor).

    ``arg_dict``, ``grad_dict`` and ``aux_dict`` hold torch tensors on the
    context's device; arrays of another kind are copied there at bind.
    ``forward(is_train=True)`` keeps the autograd graph of the pass, and
    ``backward`` writes (``grad_req="write"``) or adds (``"add"``) the
    gradients into the bound grad tensors. Missing head gradients are seeded
    with ones; loss heads ignore the seed by construction (ops/loss.py). The
    graph stays until the next forward, so ``backward`` may run twice.
    """

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else current_context()
        dev = self._ctx.torch_device
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        def on_device(values, names, what):
            return {k: to_tensor(v, dev)
                    for k, v in _normalize(names, values, what).items()}

        self.arg_dict = on_device(args, arg_names, "args")
        missing = [n for n in arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")
        self.grad_dict = on_device(args_grad, arg_names, "args_grad")
        self.aux_dict = on_device(aux_states, aux_names, "aux_states")
        if set(aux_names) - set(self.aux_dict):
            raise MXNetError(
                f"bind: missing aux states {sorted(set(aux_names) - set(self.aux_dict))}")
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in arg_names}
        else:
            self.grad_req = dict(_normalize(arg_names, grad_req, "grad_req"))
        for n in arg_names:
            self.grad_req.setdefault(n, "null")
        self._fwd_fns = {}  # is_train -> graph function
        self._eval_program = None  # the captured eval forward (precompile)
        self._eval_label = None
        self._seen = set()  # program keys counted in utils.compile
        self._outputs = None
        self._graph = None  # (heads, leaves) of the last training forward
        self._needs_rng = any(not n.is_variable and n.op.need_rng
                              for n in symbol._topo())

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._symbol.list_arguments()]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._symbol.list_arguments()]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._symbol.list_auxiliary_states()]

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("call forward() before reading outputs")
        return self._outputs

    def _diff_names(self):
        return sorted(n for n, r in self.grad_req.items() if r != "null")

    def _fn(self, is_train):
        if is_train not in self._fwd_fns:
            self._fwd_fns[is_train] = _build_graph_fn(self._symbol, is_train)
        return self._fwd_fns[is_train]

    def forward(self, is_train=False, **kwargs):
        dev = self._ctx.torch_device
        with torch.no_grad():
            for k, v in kwargs.items():
                if k not in self.arg_dict:
                    raise MXNetError(f"forward: unknown argument {k!r}")
                self.arg_dict[k].copy_(to_tensor(v, dev))
        rng = _random.generator(dev) if self._needs_rng else None
        is_train = bool(is_train)
        diff_names = self._diff_names()
        self._graph = None
        if not is_train:
            compile_mod.registry().see(*self._eval_key(), self._seen)
        if not is_train and self._eval_program is not None:
            self._outputs = [o.clone() for o in self._eval_program()]
            return self._outputs
        if is_train and diff_names:
            leaves = {n: self.arg_dict[n].detach().requires_grad_(True)
                      for n in diff_names}
            with torch.enable_grad():
                outs, new_aux = self._fn(True)({**self.arg_dict, **leaves},
                                               self.aux_dict, rng)
            self._graph = (outs, leaves)
        else:
            with torch.no_grad():
                outs, new_aux = self._fn(is_train)(self.arg_dict,
                                                   self.aux_dict, rng)
        if is_train:
            with torch.no_grad():
                for n, a in self.aux_dict.items():
                    a.copy_(new_aux[n])
        self._outputs = [o.detach() for o in outs]
        return self._outputs

    def backward(self, out_grads=None):
        """Compute gradients into the bound grad tensors (reference:
        GraphExecutor::Backward)."""
        if self._graph is None:
            raise MXNetError("backward() requires a prior forward(is_train=True)")
        outs, leaves = self._graph
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, torch.Tensor):
                out_grads = [out_grads]
            cots = [to_tensor(g, o.device) for g, o in zip(out_grads, outs)]
        pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                [c for _, c in pairs], retain_graph=True, allow_unused=True)
        with torch.no_grad():
            for n, g in zip(names, grads):
                holder = self.grad_dict.get(n)
                if holder is None:
                    continue
                if g is None:  # no path from the heads: a zero gradient
                    g = torch.zeros_like(holder)
                if self.grad_req[n] == "add":
                    holder.add_(g.to(holder.dtype))
                else:
                    holder.copy_(g)

    def _eval_key(self):
        """(label, program key) of the eval forward: the bound shapes'."""
        if self._eval_label is None:
            fp = compile_mod.graph_fingerprint(self._symbol)
            arrays = {**self.arg_dict, **self.aux_dict}
            self._eval_label = (
                f"fwd_eval:{fp}",
                compile_mod.program_key(fp, None, arrays, None, None, False))
        return self._eval_label

    def precompile(self, is_train=False):
        """Capture the eval forward of the bound shapes into a CUDA graph
        (on a card, unless ``MXTPU_CUDA_GRAPHS=0`` or the graph holds a
        ``_Native`` node): one eager warm-up, then the capture. Later
        ``forward(is_train=False)`` calls replay it, reading the bound
        argument and auxiliary tensors (``forward``'s keyword inputs are
        copied into them). Training through an Executor stays eager (ROADMAP
        A6). Returns the seconds spent (0.0 where nothing is captured: the
        CPU, or either case above; the program is counted and the reason
        goes to ``compile_stats()["eager"]``)."""
        if is_train:
            raise NotImplementedError(
                "Executor.precompile(is_train=True) is not ported yet: "
                "ROADMAP A6 (a captured forward and backward pair)")
        label, key = self._eval_key()
        compile_mod.registry().see(label, key, self._seen, precompile=True)
        dev = self._ctx.torch_device
        reason = compile_mod.eager_reason(dev, has_native(self._symbol))
        if reason is not None:
            compile_mod.note_eager(reason)
        if reason is not None or self._eval_program is not None:
            return 0.0
        t0 = time.perf_counter()
        fn = self._fn(False)
        rng = _random.generator(dev) if self._needs_rng else None

        def run():
            with torch.no_grad():
                return fn(self.arg_dict, self.aux_dict, rng)[0]

        program = compile_mod.CapturedProgram(run, dev, label, warmup=1)
        program()  # the warm-up
        program.capture()
        self._eval_program = program
        return time.perf_counter() - t0

    def debug_str(self) -> str:
        """The graph, one node a line (``Symbol.debug_str``), then the bytes
        the executor holds: ``Total <MB> MB allocated`` over its bound
        arguments, gradients, auxiliary states and last outputs (the JAX
        package reads the compiled program's memory plan; there is no
        compiled program here), and on a card the allocator's current and
        peak bytes."""
        held = {id(t): t for d in (self.arg_dict, self.grad_dict,
                                   self.aux_dict) for t in d.values()}
        held.update((id(t), t) for t in self._outputs or ())
        total = sum(t.numel() * t.element_size() for t in held.values())
        mb = 1 << 20
        lines = [self._symbol.debug_str(),
                 f"Total {total / mb:.4f} MB allocated"]
        dev = self._ctx.torch_device
        if dev.type == "cuda":
            lines.append(
                f"Device {torch.cuda.memory_allocated(dev) / mb:.4f} MB "
                f"allocated, peak {torch.cuda.max_memory_allocated(dev) / mb:.4f} MB")
        return "\n".join(lines)

    def copy_params_from(self, arg_params, aux_params=None):
        """Copy parameter dicts into the bound tensors (reference:
        Executor::CopyParamsFrom)."""
        with torch.no_grad():
            for name, arr in arg_params.items():
                if name in self.arg_dict:
                    self.arg_dict[name].copy_(
                        to_tensor(arr, self.arg_dict[name].device))
            for name, arr in (aux_params or {}).items():
                if name in self.aux_dict:
                    self.aux_dict[name].copy_(
                        to_tensor(arr, self.aux_dict[name].device))


def simple_bind(symbol, ctx, grad_req="write", **input_shapes) -> Executor:
    """Allocate every buffer as zeros from the inferred shapes and bind
    (reference: symbol.py simple_bind -> MXExecutorBind)."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    dev = (ctx if isinstance(ctx, Context) else current_context()).torch_device

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    if isinstance(grad_req, str):
        reqs = {n: grad_req for n in arg_names}
    elif isinstance(grad_req, dict):
        reqs = {n: grad_req.get(n, "null") for n in arg_names}
    else:
        reqs = dict(zip(arg_names, grad_req))
    args = {n: zeros(s) for n, s in zip(arg_names, arg_shapes)}
    grads = {n: zeros(s) for n, s in zip(arg_names, arg_shapes)
             if reqs.get(n, "null") != "null"}
    aux = {n: zeros(s) for n, s in zip(aux_names, aux_shapes)}
    return Executor(symbol, ctx, args, grads, reqs, aux)
