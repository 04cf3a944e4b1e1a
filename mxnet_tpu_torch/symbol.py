"""Symbolic graph construction.

Counterpart of ``mxnet_tpu/symbol.py``: a Symbol is an immutable DAG of op
nodes composed by call, with graph-wide shape inference and JSON
serialisation. The JSON format is the JAX package's, so a graph saved by
either package loads in the other. Op constructors (``symbol.Convolution``)
are generated from the operator registry at import time.
"""

from __future__ import annotations

import json

from . import name as _name_mod
from .base import MXNetError
from .ops import OPS
from .ops.registry import OpProp

__all__ = ["Symbol", "Variable", "Group", "load", "load_json"]


class _Node:
    __slots__ = ("op", "name", "inputs", "declared_shape", "declared_dtype")

    def __init__(self, op: OpProp | None, name: str, inputs,
                 declared_shape=None, declared_dtype=None):
        self.op = op  # None => variable node
        self.name = name
        self.inputs = inputs  # list of (Node, out_index)
        self.declared_shape = declared_shape  # optional, for variables
        self.declared_dtype = declared_dtype  # optional, for variables

    @property
    def is_variable(self):
        return self.op is None

    def output_names(self):
        if self.is_variable:
            return [self.name]
        outs = self.op.list_outputs()
        if len(outs) == 1:
            return [f"{self.name}_output"]
        return [f"{self.name}_{o}" for o in outs]


class Symbol:
    """An immutable symbolic graph with one or more output heads."""

    def __init__(self, heads):
        self._heads = list(heads)  # list of (Node, out_index)

    def _topo(self):
        """Post-order DFS over nodes."""
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for src, _ in node.inputs:
                visit(src)
            order.append(node)

        for node, _ in self._heads:
            visit(node)
        return order

    def list_arguments(self):
        return [n.name for n in self._topo() if n.is_variable]

    def list_outputs(self):
        return [node.output_names()[idx] for node, idx in self._heads]

    def list_auxiliary_states(self):
        names = []
        for n in self._topo():
            if not n.is_variable:
                names.extend(f"{n.name}_{a}" for a in n.op.list_auxiliary_states())
        return names

    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def get_internals(self):
        """A Symbol whose outputs are every variable and every output of
        every node, in topological order (reference:
        Symbol::GetInternals): ``net.get_internals()["fc1_output"]``."""
        heads = []
        for node in self._topo():
            if node.is_variable:
                heads.append((node, 0))
            else:
                heads.extend((node, i) for i in range(node.op.num_outputs()))
        return Symbol(heads)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError(f"no output named {index!r}; outputs: {names}")
            index = names.index(index)
        return Symbol([self._heads[index]])

    def __len__(self):
        return len(self._heads)

    def __iter__(self):
        return (self[i] for i in range(len(self._heads)))

    def _binop(self, other, opname):
        if not isinstance(other, Symbol):
            raise TypeError(f"Symbol {opname} requires a Symbol operand")
        return _create(opname, lhs=self, rhs=other)

    def __add__(self, other):
        return self._binop(other, "_Plus")

    def __sub__(self, other):
        return self._binop(other, "_Minus")

    def __mul__(self, other):
        return self._binop(other, "_Mul")

    def __truediv__(self, other):
        return self._binop(other, "_Div")

    def infer_shape(self, *args, **kwargs):
        """Graph-wide shape inference from known argument shapes, given
        positionally (argument order) or by name. Returns (arg_shapes,
        out_shapes, aux_shapes); raises on conflicts or unknowns."""
        arg_names = self.list_arguments()
        known: dict[str, tuple] = {}
        if len(args) > len(arg_names):
            raise MXNetError("too many positional shapes")
        for nm, s in zip(arg_names, args):
            if s is not None:
                known[nm] = tuple(s)
        for nm, s in kwargs.items():
            if nm not in arg_names:
                raise MXNetError(f"unknown argument {nm!r} in infer_shape")
            known[nm] = tuple(s)

        shapes: dict[tuple[int, int], tuple] = {}  # (node_id, out_idx) -> shape
        node_list = self._topo()
        for node in node_list:
            if node.is_variable:
                if node.name in known:
                    shapes[(id(node), 0)] = known[node.name]
                elif node.declared_shape is not None:
                    shapes[(id(node), 0)] = tuple(node.declared_shape)
        for node in node_list:
            if node.is_variable:
                continue
            in_shapes = [shapes.get((id(src), idx)) for src, idx in node.inputs]
            try:
                completed, out_shapes, _aux = node.op.infer_shape(in_shapes)
            except MXNetError as e:
                raise MXNetError(f"in node {node.name!r}: {e}") from None
            for (src, idx), s_new, s_old in zip(node.inputs, completed, in_shapes):
                if s_old is not None and tuple(s_old) != tuple(s_new):
                    raise MXNetError(
                        f"shape mismatch at {node.name!r} input {src.name!r}: "
                        f"inferred {tuple(s_new)} but have {tuple(s_old)}")
                shapes[(id(src), idx)] = tuple(s_new)
            for i, s in enumerate(out_shapes):
                key = (id(node), i)
                if key in shapes and shapes[key] != tuple(s):
                    raise MXNetError(f"inconsistent output shape at {node.name!r}")
                shapes[key] = tuple(s)

        arg_shapes = [shapes.get((id(n), 0)) for n in node_list if n.is_variable]
        out_shapes = [shapes.get((id(n), i)) for n, i in self._heads]
        aux_shapes = []
        for node in node_list:  # from the final shapes, as in the JAX package
            if not node.is_variable:
                in_shapes = [shapes.get((id(src), idx)) for src, idx in node.inputs]
                aux_shapes.extend(node.op.infer_shape(in_shapes)[2])
        if any(s is None for s in arg_shapes + out_shapes):
            missing = [nm for nm, s in zip(arg_names, arg_shapes) if s is None]
            raise MXNetError(f"infer_shape incomplete; unknown: {missing}")
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        """:meth:`infer_shape`, or ``(None, None, None)`` where the known
        shapes do not determine every shape (the JAX package's form)."""
        try:
            return self.infer_shape(*args, **kwargs)
        except MXNetError:
            return None, None, None

    # -- pre-bind verification (reference: StaticGraph::InferShape) -----------
    def verify(self, arg_shapes=None, arg_dtypes=None, raise_on_error=True,
               **shape_kwargs):
        """Static verification of the whole graph before a bind
        (mxnet_tpu/symbol.py:216-246; :mod:`.analysis.graph`): shape and
        dtype inference over the node DAG plus structural checks
        (duplicate argument names, unused outputs), each problem named
        with its op and input chain. ``bind`` runs it with the bound
        tensors' shapes and dtypes unless ``MXNET_TPU_VERIFY=0``.

        ``arg_shapes``/``arg_dtypes``: dicts name -> shape/dtype for (a
        subset of) the arguments; shapes may also come as keywords, as to
        ``infer_shape``. Variable-declared shapes and dtypes fill the rest.
        Returns every finding (warnings included); raises MXNetError
        listing the error-grade ones unless ``raise_on_error=False``."""
        from .analysis.graph import verify_symbol

        shapes = dict(arg_shapes or {})
        shapes.update(shape_kwargs)
        findings = verify_symbol(self, shapes or None, arg_dtypes)
        errors = [f for f in findings if f.is_error]
        if errors and raise_on_error:
            raise MXNetError(
                "Symbol.verify failed with "
                f"{len(errors)} error(s):\n  "
                + "\n  ".join(f.format() for f in errors))
        return findings

    def tojson(self) -> str:
        nodes = self._topo()
        nid = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            entry = {
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "inputs": [[nid[id(s)], i] for s, i in n.inputs],
            }
            if not n.is_variable:
                entry["param"] = n.op.serialize_params()
            out_nodes.append(entry)
        graph = {
            "nodes": out_nodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "heads": [[nid[id(n)], i] for n, i in self._heads],
        }
        return json.dumps(graph, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def __getstate__(self):
        return {"json": self.tojson()}

    def __setstate__(self, state):
        self._heads = load_json(state["json"])._heads

    def __repr__(self):
        return f"<Symbol {' '.join(self.list_outputs())}>"

    def debug_str(self):
        """One line per node in topological order: ``Variable:<name>`` or
        ``Op:<op>, Name=<name>, Inputs: <src>[<k>], ...``."""
        lines = []
        for n in self._topo():
            if n.is_variable:
                lines.append(f"Variable:{n.name}")
            else:
                ins = ", ".join(f"{s.name}[{i}]" for s, i in n.inputs)
                lines.append(f"Op:{n.op.name}, Name={n.name}, Inputs: {ins}")
        return "\n".join(lines)

    def bind(self, ctx, args, args_grad=None, grad_req="write", aux_states=None):
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx, grad_req="write", **input_shapes):
        from .executor import simple_bind

        return simple_bind(self, ctx, grad_req, **input_shapes)


def Variable(name, shape=None, dtype=None) -> Symbol:
    """A named input/parameter placeholder; ``shape`` and ``dtype`` declare
    its shape and dtype for graph-wide ``infer_shape`` and ``verify``."""
    if not isinstance(name, str):
        raise TypeError("Variable name must be str")
    return Symbol([(_Node(None, name, [],
                          declared_shape=tuple(shape) if shape else None,
                          declared_dtype=dtype), 0)])


def Group(symbols) -> Symbol:
    """Group symbols into a multi-output symbol."""
    heads = []
    for s in symbols:
        if not isinstance(s, Symbol):
            raise TypeError("Group expects Symbols")
        heads.extend(s._heads)
    return Symbol(heads)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str: str) -> Symbol:
    graph = json.loads(json_str)
    nodes = []
    for entry in graph["nodes"]:
        if entry["op"] == "null":
            node = _Node(None, entry["name"], [])
        else:
            op = OPS.create(entry["op"], **entry.get("param", {}))
            node = _Node(op, entry["name"],
                         [(nodes[src], idx) for src, idx in entry["inputs"]])
        nodes.append(node)
    return Symbol([(nodes[i], idx) for i, idx in graph["heads"]])


def _create(op_name, *pos_args, name=None, **kwargs) -> Symbol:
    cls = OPS.get(op_name)
    sym_kwargs = {}
    params = {}
    for k, v in kwargs.items():
        if isinstance(v, Symbol):
            sym_kwargs[k] = v
        else:
            params[k] = v
    if pos_args:
        if sym_kwargs:
            raise MXNetError(f"{op_name}: mix of positional and keyword symbol inputs")
        if any(not isinstance(a, Symbol) for a in pos_args):
            raise MXNetError(f"{op_name}: positional args must be Symbols")
    # variable-arity ops get num_args filled automatically
    if "num_args" in cls.params and "num_args" not in params:
        params["num_args"] = len(pos_args) or len(sym_kwargs)
    op = cls(**params)
    node_name = _name_mod.current().get(name, op_name)
    arg_names = op.list_arguments()

    if pos_args:
        if len(pos_args) > len(arg_names):
            raise MXNetError(f"{op_name}: too many inputs")
        provided = dict(zip(arg_names, pos_args))
    else:
        for k in sym_kwargs:
            if k not in arg_names:
                raise MXNetError(f"{op_name}: unknown input {k!r}; expects {arg_names}")
        provided = sym_kwargs
    inputs = []
    for arg in arg_names:
        if arg in provided:
            s = provided[arg]
            if len(s._heads) != 1:
                raise MXNetError(
                    f"{op_name}: input {arg!r} must be single-output, got group")
            inputs.append(s._heads[0])
        else:
            # auto-create the parameter variable, named f"{node}_{arg}"
            inputs.append((_Node(None, f"{node_name}_{arg}", []), 0))
    node = _Node(op, node_name, inputs)
    return Symbol([(node, i) for i in range(op.num_outputs())])


def _make_constructor(op_name, cls):
    def ctor(*args, name=None, **kwargs):
        return _create(op_name, *args, name=name, **kwargs)

    ctor.__name__ = op_name
    ctor.__qualname__ = op_name
    ctor.__doc__ = cls.__doc__
    return ctor


def _init_symbol_module():
    g = globals()
    for key, cls in list(OPS._entries.items()):
        op_name = cls.op_name
        names = {op_name, key, cls.__name__.replace("Op", "")}
        names.update(getattr(cls, "op_aliases", ()))
        for exposed in names:
            if exposed and exposed not in g:
                g[exposed] = _make_constructor(op_name, cls)


_init_symbol_module()
