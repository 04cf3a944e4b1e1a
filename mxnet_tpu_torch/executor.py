"""Graph execution: the Symbol as a function of tensors, and the bound
Executor.

Counterpart of ``mxnet_tpu/executor.py``: ``_fusion_plan``,
``_remat_segments``, ``_build_graph_fn(symbol, is_train)`` and ``Executor``
with ``bind``, ``simple_bind`` and ``debug_str``. The Symbol is walked once
into a plain function of
(arguments, auxiliary states, generator, loss mask) that runs each node's
forward on torch tensors in topological order and returns the heads and the
updated auxiliary states. Gradients come from autograd over that function.
Remat (``MXNET_TPU_REMAT``) runs its segments under
``torch.utils.checkpoint``. The counterpart of ``jit`` is a CUDA graph: an
Executor's ``precompile`` captures its eval forward, or its training
forward and backward as a pair (``utils.compile.CapturedPair``, the JAX
package's ``fwd_res`` and ``bwd`` programs), and the calls after it replay.
"""

from __future__ import annotations

import re
import time

import torch
import torch.utils.checkpoint

from . import random as _random
from .base import MXNetError, env_bool, env_int, env_str
from .context import Context, current_context
from .convert import to_tensor
from .ops.registry import DrawTape, as_dtype
from .telemetry import profiling as _profiling
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


class _NodeRunner:
    """How the graph functions run one node: the fusion plan's rewrites
    (:func:`_fusion_plan`), each node's input refs and auxiliary state
    names, and ``exec_node``."""

    def __init__(self, symbol, is_train):
        self.nodes = symbol._topo()
        self.is_train = is_train
        (self.fused_bn, self.passthrough, self.skip_bn,
         self.fused_add) = _fusion_plan(symbol)

    def batch_coupled(self, node) -> bool:
        """Does a training pass of ``node`` reduce over the batch's rows
        (BatchNorm's statistics, fused or not)?"""
        if not self.is_train or node.is_variable or \
                id(node) in self.skip_bn:
            return False
        if id(node) in self.fused_add:
            return True
        return id(node) not in self.passthrough and \
            node.op.name == "BatchNorm"

    def batch_inputs(self, node) -> list:
        """The positions of :meth:`node_input_refs` that hold rows of the
        batch for a :meth:`batch_coupled` node: BatchNorm's data, and the
        shortcut operand of a fused add."""
        if id(node) in self.fused_add:
            return [0, 3]
        return [0]

    def node_aux_names(self, node):
        if id(node) in self.fused_add:
            bn = self.fused_add[id(node)][0]
            return [f"{bn.name}_{a}" for a in bn.op.list_auxiliary_states()]
        if node.is_variable or id(node) in self.skip_bn or \
                id(node) in self.passthrough:
            return []
        return [f"{node.name}_{a}" for a in node.op.list_auxiliary_states()]

    def node_input_refs(self, node):
        """The env refs exec_node reads for this node (fusion-aware), the
        one source the remat blocks' external inputs are resolved from."""
        if node.is_variable or id(node) in self.skip_bn:
            return []
        if id(node) in self.passthrough:
            src, k = node.inputs[0]
            return [(id(src), k)]
        if id(node) in self.fused_add:
            bn, z_idx = self.fused_add[id(node)]
            z_src, z_k = node.inputs[z_idx]
            return [(id(s), k) for s, k in bn.inputs] + [(id(z_src), z_k)]
        return [(id(s), k) for s, k in node.inputs]

    def run(self, node, ins, aux, rng, mask):
        """``node``'s forward on its inputs and auxiliary states: ``(outs,
        updated aux)``."""
        is_train = self.is_train
        if id(node) in self.passthrough:  # relu folded into the producer
            return [ins[0]], []
        if id(node) in self.fused_add:  # ins: bn.inputs..., then z
            return self.fused_add[id(node)][0].op.fwd_fused_add_relu(
                ins, aux, is_train, None)
        key = rng if node.op.need_rng else None
        if id(node) in self.fused_bn:
            return node.op.fwd_fused_relu(ins, aux, is_train, key)
        if mask is not None and node.op.is_loss:
            return node.op.fwd_masked(ins, aux, is_train, key, mask)
        return node.op.fwd(ins, aux, is_train, key)

    def exec_node(self, node, env, aux_values, new_aux, rng, mask):
        """Run one node. While a profile capture is active the node runs
        in the range ``<layer>/<op>`` (the JAX package's
        ``jax.named_scope``), which the device-time profiler joins the
        node's kernels to."""
        if id(node) in self.skip_bn:  # runs inside its fused add below
            return
        ins = [env[r] for r in self.node_input_refs(node)]
        names = self.node_aux_names(node)
        with _profiling.scope(f"{node.name}/{node.op.name}"):
            outs, updated = self.run(node, ins,
                                     [aux_values[a] for a in names], rng,
                                     mask)
        for k, o in enumerate(outs):
            env[(id(node), k)] = o
        new_aux.update(zip(names, updated))


def _build_replica_graph_fn(symbol, is_train: bool = True):
    """The graph over the row blocks of several replicas in one pass:
    ``fn(arg_values, aux_values, rngs, masks) -> (outputs, new_aux)``, each
    argument and result a list with one entry a replica. Nodes run in
    lockstep, one node for every replica before the next; a node that
    reduces over the batch (:meth:`_NodeRunner.batch_coupled`: training
    BatchNorm) runs once on the replicas' rows joined on the first
    replica's device, with the first replica's parameters, and its outputs
    go back to each replica's rows, so its statistics are the global
    batch's and every replica gets the same auxiliary states. This is the
    single-device graph on the global batch, as the JAX package's
    partitioned step computes it (mxnet_tpu/model.py:879-903); the joined
    node's gradients flow back to every replica's rows through autograd,
    its parameters' to the first replica's. ``MXNET_TPU_REMAT`` is not
    applied here (it changes memory, not results)."""
    runner = _NodeRunner(symbol, is_train)

    def fn(arg_values, aux_values, rngs, masks):
        n = len(arg_values)
        envs = [{} for _ in range(n)]
        new_aux = [dict(a) for a in aux_values]
        for node in runner.nodes:
            if node.is_variable:
                for env, args in zip(envs, arg_values):
                    env[(id(node), 0)] = args[node.name]
                continue
            if not runner.batch_coupled(node):
                for r in range(n):
                    runner.exec_node(node, envs[r], aux_values[r],
                                     new_aux[r], rngs[r], masks[r])
                continue
            refs = runner.node_input_refs(node)
            joined = set(runner.batch_inputs(node))
            dev = envs[0][refs[0]].device
            rows = [env[refs[0]].shape[0] for env in envs]
            ins = [torch.cat([env[r].to(dev) for env in envs])
                   if i in joined else envs[0][r]
                   for i, r in enumerate(refs)]
            names = runner.node_aux_names(node)
            outs, updated = runner.run(
                node, ins, [aux_values[0][a] for a in names], None, None)
            for k, o in enumerate(outs):
                for env, part in zip(envs, torch.split(o, rows)):
                    dst = env[refs[0]].device
                    env[(id(node), k)] = part.to(dst) if dst != dev else part
            for r in range(n):
                dst = envs[r][refs[0]].device
                new_aux[r].update((a, u.to(dst) if u.device != dst else u)
                                  for a, u in zip(names, updated))
        heads = [tuple(env[(id(h), i)] for h, i in symbol._heads)
                 for env in envs]
        return heads, new_aux

    return fn


def _build_graph_fn(symbol, is_train: bool = False):
    """Compile the symbol DAG into ``fn(arg_values, aux_values, rng=None,
    mask=None) -> (outputs, new_aux)``: a tuple with one tensor per head and
    the auxiliary states after the pass (BatchNorm's running stats move in
    training mode). ``rng`` is the ``torch.Generator`` that nodes with
    ``need_rng`` draw from; ``mask`` is an optional (batch,) row mask that
    loss heads apply to their injected gradients (``fwd_masked``). With
    ``MXNET_TPU_REMAT`` set, the segments of :func:`_remat_segments` run
    checkpointed, as the JAX package runs them under ``jax.checkpoint``."""
    runner = _NodeRunner(symbol, is_train)
    nodes = runner.nodes
    node_aux_names = runner.node_aux_names
    node_input_refs = runner.node_input_refs
    exec_node = runner.exec_node

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
        # graph verification before the bind (mxnet_tpu/executor.py:
        # 388-400): shape and dtype inference against the bound tensors,
        # so a conflict fails here with its op named; host work over
        # shapes and dtypes only. MXNET_TPU_VERIFY=0 turns it off.
        if env_bool("MXNET_TPU_VERIFY", True):
            symbol.verify(
                arg_shapes={n: tuple(t.shape)
                            for n, t in self.arg_dict.items()},
                arg_dtypes={n: as_dtype(t.dtype)
                            for n, t in self.arg_dict.items()})
        self._fwd_fns = {}  # is_train -> graph function
        self._eval_program = None  # the captured eval forward (precompile)
        self._eval_label = None
        self._train_labels = None
        # the captured training pair (precompile(is_train=True)): the
        # CapturedPair, its leaves and its head-gradient buffers
        self._pair = None
        self._pair_leaves = None
        self._cots = None
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
        from . import telemetry

        telemetry.counter("executor_forward_total")
        with telemetry.phase("executor_forward"):
            return self._forward_impl(is_train, **kwargs)

    def _forward_impl(self, is_train=False, **kwargs):
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
        else:
            label, key = self._train_keys()[0]
            compile_mod.registry().see(label, key, self._seen)
        if not is_train and self._eval_program is not None:
            self._outputs = [o.clone() for o in self._eval_program()]
            return self._outputs
        if is_train and self._pair is not None:
            self._outputs = [o.clone() for o in self._pair.run_forward()]
            self._graph = self._pair
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

    def _write_grads(self, names, grads):
        """Each gradient into its bound tensor (``write`` copies, ``add``
        adds); a parameter no head reaches gets zero."""
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

    @staticmethod
    def _head_grads(outs, cots):
        """autograd's (outputs, grad_outputs) over the heads that carry a
        graph (loss heads inject their own gradient)."""
        pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        return [o for o, _ in pairs], [c for _, c in pairs]

    def backward(self, out_grads=None):
        """Compute gradients into the bound grad tensors (reference:
        GraphExecutor::Backward). After ``precompile(is_train=True)`` on a
        card, the head gradients are copied into the pair's buffers and the
        backward graph replays."""
        from . import telemetry

        telemetry.counter("executor_backward_total")
        with telemetry.phase("executor_backward"):
            return self._backward_impl(out_grads)

    def _backward_impl(self, out_grads=None):
        if self._graph is None:
            raise MXNetError("backward() requires a prior forward(is_train=True)")
        label, key = self._train_keys()[1]
        compile_mod.registry().see(label, key, self._seen)
        if self._graph is self._pair:
            for i, buf in enumerate(self._cots):
                if out_grads is None:
                    buf.fill_(1.0)
                else:
                    grads = [out_grads] if isinstance(
                        out_grads, torch.Tensor) else out_grads
                    buf.copy_(to_tensor(grads[i], buf.device))
            self._pair.run_backward()
            return
        outs, leaves = self._graph
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, torch.Tensor):
                out_grads = [out_grads]
            cots = [to_tensor(g, o.device) for g, o in zip(out_grads, outs)]
        heads, seeds = self._head_grads(outs, cots)
        names = list(leaves)
        grads = [None] * len(names)
        if heads:
            grads = torch.autograd.grad(
                heads, [leaves[n] for n in names], seeds, retain_graph=True,
                allow_unused=True)
        self._write_grads(names, grads)

    def _eval_key(self):
        """(label, program key) of the eval forward: the bound shapes'."""
        if self._eval_label is None:
            fp = compile_mod.graph_fingerprint(self._symbol)
            arrays = {**self.arg_dict, **self.aux_dict}
            self._eval_label = (
                f"fwd_eval:{fp}",
                compile_mod.program_key(fp, None, arrays, None, None, False))
        return self._eval_label

    def _train_keys(self):
        """((label, key) of the training forward, (label, key) of the
        backward), named as the JAX package names its programs
        (``fwd_train_res`` with gradients to take, else ``fwd_train``;
        ``bwd_apply``)."""
        if self._train_labels is None:
            fp = compile_mod.graph_fingerprint(self._symbol)
            arrays = {**self.arg_dict, **self.aux_dict}
            key = compile_mod.program_key(fp, None, arrays, None, None, True)
            kind = "fwd_train_res" if self._diff_names() else "fwd_train"
            self._train_labels = ((f"{kind}:{fp}", key),
                                  (f"bwd_apply:{fp}", key))
        return self._train_labels

    def _capture_train(self):
        """Capture the training pair over the bound tensors: one eager
        forward and backward (on a side stream), then the two graphs,
        after which every auxiliary state, gradient and generator is put
        back as it was. Returns the seconds spent."""
        dev = self._ctx.torch_device
        t0 = time.perf_counter()
        fn = self._fn(True)
        rng = _random.generator(dev) if self._needs_rng else None
        names = self._diff_names()
        leaves = self._pair_leaves = {
            n: self.arg_dict[n].detach().requires_grad_(True) for n in names}

        def forward():
            with torch.enable_grad():
                outs, new_aux = fn({**self.arg_dict, **leaves},
                                   self.aux_dict, rng)
            with torch.no_grad():
                for n, a in self.aux_dict.items():
                    a.copy_(new_aux[n])
            return list(outs)

        def backward(outs):
            heads, seeds = self._head_grads(outs, self._cots)
            grads = [None] * len(names)
            if heads:
                grads = torch.autograd.grad(
                    heads, [leaves[n] for n in names], seeds,
                    retain_graph=True, allow_unused=True)
            self._write_grads(names, grads)

        labels = [label for label, _ in self._train_keys()]
        saved = {"aux": {k: v.clone() for k, v in self.aux_dict.items()},
                 "grad": {k: v.clone() for k, v in self.grad_dict.items()},
                 "rng": _random.get_state()}
        pair = compile_mod.CapturedPair(
            forward, backward, dev, labels, warmup=1,
            generators=[rng] if rng is not None else [],
            inputs=lambda: [self.arg_dict, self.aux_dict, self.grad_dict])
        outs = pair.run_forward()  # the warm-up pair, eager
        self._cots = [torch.ones_like(o) for o in outs]
        pair.run_backward()
        pair.capture()
        torch.cuda.synchronize(dev)
        with torch.no_grad():
            for group in ("aux", "grad"):
                held = self.aux_dict if group == "aux" else self.grad_dict
                for k, v in saved[group].items():
                    held[k].copy_(v)
        _random.set_state(saved["rng"])
        self._pair = pair
        return time.perf_counter() - t0

    def train_reason(self):
        """Why this executor's training runs eager, or None when
        ``precompile(is_train=True)`` captures it: the cases of
        ``utils.compile.eager_reason``, or no gradient to take."""
        reason = compile_mod.eager_reason(self._ctx.torch_device,
                                          has_native(self._symbol))
        if reason is None and not self._diff_names():
            reason = "no gradient to take (grad_req null)"
        return reason

    def precompile(self, is_train=False):
        """Capture the program ``forward(is_train=...)`` runs into CUDA
        graphs (on a card, unless ``MXTPU_CUDA_GRAPHS=0`` or the graph
        holds a ``_Native`` node). Eval: one eager warm-up, then the
        capture; later ``forward(is_train=False)`` calls replay it, reading
        the bound argument and auxiliary tensors (``forward``'s keyword
        inputs are copied into them). Training: the forward and backward
        pair (``utils.compile.CapturedPair``), warmed up and captured with
        every auxiliary state, gradient and generator put back; later
        ``forward(is_train=True)`` and ``backward(out_grads)`` replay it.
        The program is counted as a precompile under the JAX package's
        label (``fwd_eval``, ``fwd_train_res``). Returns the seconds spent
        (0.0 where nothing is captured: the CPU, either case above, or a
        training program with no gradient; the reason goes to
        ``compile_stats()["eager"]``)."""
        is_train = bool(is_train)
        label, key = self._train_keys()[0] if is_train else self._eval_key()
        compile_mod.registry().see(label, key, self._seen, precompile=True)
        reason = self.train_reason() if is_train else \
            compile_mod.eager_reason(self._ctx.torch_device,
                                     has_native(self._symbol))
        if reason is not None:
            compile_mod.note_eager(reason)
            return 0.0
        if is_train:
            return 0.0 if self._pair is not None else self._capture_train()
        if self._eval_program is not None:
            return 0.0
        dev = self._ctx.torch_device
        t0 = time.perf_counter()
        fn = self._fn(False)
        rng = _random.generator(dev) if self._needs_rng else None

        def run():
            with torch.no_grad():
                return fn(self.arg_dict, self.aux_dict, rng)[0]

        program = compile_mod.CapturedProgram(
            run, dev, label, warmup=1,
            inputs=lambda: [self.arg_dict, self.aux_dict])
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
