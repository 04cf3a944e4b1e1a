"""Graph verification before a bind (``Symbol.verify``).

Counterpart of ``mxnet_tpu/analysis/graph.py``. Reference:
``StaticGraph::InferShape`` (src/symbol/static_graph.cc) ran static shape
inference over the node DAG before binding and failed with the offending
node named. This pass extends that to dtypes and structural checks:

  MX401  duplicate argument / node names (binding maps arrays by name)
  MX402  shape conflicts, with the op name + input chain in the message
  MX403  dtype conflicts (f32 leaking into a bf16 graph, int data into
         float-only ops), same naming contract
  MX404  computed-but-unused op outputs
  MX405  unreachable nodes (serialized JSON graphs only: a live Symbol
         can only reach nodes on a head path)
  MX406  underdetermined shapes/dtypes (inference incomplete before bind)

The walk collects every finding instead of raising on the first;
``Symbol.verify`` turns the error-grade ones into one MXNetError.
``Executor`` runs it on every bind with the bound tensors' shapes and
dtypes (``MXNET_TPU_VERIFY=0`` turns it off). Dtypes are the port's
(``ops.registry.as_dtype``): numpy dtypes, and ``torch.bfloat16``.

Pure graph walking over OpProp metadata: it reads shapes and dtypes,
never a tensor's values, so a bind on the card never waits for it.
"""

from __future__ import annotations

import json

from ..base import MXNetError
from ..ops.registry import as_dtype
from .rules import Finding, get_rule

__all__ = ["verify_symbol", "verify_json", "verify_json_file"]


def _chain(node, limit=6):
    """First-input producer chain, e.g. 'loss <- fc2 <- act1 <- fc1 <- data'."""
    parts, cur = [], node
    while cur is not None and len(parts) < limit:
        parts.append(cur.name)
        cur = cur.inputs[0][0] if cur.inputs else None
    if cur is not None:
        parts.append("...")
    return " <- ".join(parts)


def _node_finding(rule_id, node, message):
    return Finding(get_rule(rule_id),
                   f"at node '{node.name}'"
                   + (f" (op {node.op.name})" if not node.is_variable else "")
                   + f": {message}; input chain: {_chain(node)}",
                   node=node.name)


def _check_names(nodes, findings):
    var_names, op_names = {}, {}
    for node in nodes:
        table = var_names if node.is_variable else op_names
        if node.name in table and table[node.name] is not node:
            kind = "argument" if node.is_variable else "node"
            findings.append(_node_finding(
                "MX401", node,
                f"duplicate {kind} name '{node.name}' — two distinct graph "
                f"nodes share it, so bind would alias one buffer onto both"))
        else:
            table[node.name] = node
    # an argument name colliding with an op node name corrupts aux/param
    # auto-naming (f"{node}_{arg}"), flag that too
    for name in set(var_names) & set(op_names):
        findings.append(_node_finding(
            "MX401", op_names[name],
            f"name '{name}' used by both an argument and an op node"))


def _infer_pass(nodes, heads, findings, known, kind):
    """Shared forward walk for shapes ('shape', MX402) and dtypes
    ('dtype', MX403). ``known``: (node_id, out_idx) -> value. Mutates
    ``known`` to completion; appends conflict findings."""
    rule_id = "MX402" if kind == "shape" else "MX403"

    def norm(v):
        return tuple(v) if kind == "shape" else as_dtype(v)

    for node in nodes:
        if node.is_variable:
            continue
        in_vals = [known.get((id(src), idx)) for src, idx in node.inputs]
        try:
            if kind == "shape":
                completed, out_vals, _aux = node.op.infer_shape(in_vals)
            else:
                completed, out_vals, _aux = node.op.infer_dtype(in_vals)
        except MXNetError as e:
            # underdetermined inputs are MX406 (inference can't finish);
            # everything else is a real conflict the op itself detected
            rid = "MX406" if any(v is None for v in in_vals) else rule_id
            findings.append(_node_finding(rid, node, str(e)))
            continue
        for (src, idx), new, old in zip(node.inputs, completed, in_vals):
            if new is None:
                continue
            if old is not None and norm(old) != norm(new):
                findings.append(_node_finding(
                    rule_id, node,
                    f"input '{src.name}' has {kind} {norm(old)} but the op "
                    f"requires {norm(new)}"))
            else:
                known[(id(src), idx)] = norm(new)
        for i, v in enumerate(out_vals):
            key = (id(node), i)
            if v is None:
                continue
            if key in known and norm(known[key]) != norm(v):
                findings.append(_node_finding(
                    rule_id, node,
                    f"output {i} already has {kind} {norm(known[key])} but "
                    f"inference produced {norm(v)}"))
            else:
                known[key] = norm(v)
    missing = [n.name for n, i in heads if (id(n), i) not in known]
    if missing:
        findings.append(Finding(
            get_rule("MX406"),
            f"{kind} inference incomplete: head(s) {missing} "
            f"underdetermined — declare Variable {kind}s or pass them to "
            f"verify()"))


def _check_unused_outputs(nodes, heads, findings):
    consumed = set()
    for node in nodes:
        for src, idx in node.inputs:
            consumed.add((id(src), idx))
    consumed.update((id(n), i) for n, i in heads)
    for node in nodes:
        if node.is_variable:
            continue
        for i in range(node.op.num_outputs()):
            if (id(node), i) not in consumed:
                out_name = node.output_names()[i]
                findings.append(_node_finding(
                    "MX404", node,
                    f"output {i} ('{out_name}') is never consumed and is "
                    f"not a graph head"))


def verify_symbol(symbol, arg_shapes=None, arg_dtypes=None) -> list[Finding]:
    """Run the full pre-bind verification over a Symbol.

    ``arg_shapes``/``arg_dtypes``: optional dicts name -> shape/dtype for
    (a subset of) the graph arguments; Variable-declared shapes/dtypes
    fill the rest. Returns all findings, errors first.
    """
    findings: list[Finding] = []
    nodes = symbol._topo()
    heads = symbol._heads

    _check_names(nodes, findings)

    shapes, dtypes = {}, {}
    arg_shapes = arg_shapes or {}
    arg_dtypes = arg_dtypes or {}
    any_dtype_known = bool(arg_dtypes)
    for node in nodes:
        if not node.is_variable:
            continue
        s = arg_shapes.get(node.name, node.declared_shape)
        if s is not None:
            shapes[(id(node), 0)] = tuple(s)
        d = arg_dtypes.get(node.name, getattr(node, "declared_dtype", None))
        if d is not None:
            dtypes[(id(node), 0)] = as_dtype(d)
            any_dtype_known = True

    _infer_pass(nodes, heads, findings, shapes, "shape")
    if any_dtype_known:
        # without a single known dtype the pass would only emit noise
        _infer_pass(nodes, heads, findings, dtypes, "dtype")
    _check_unused_outputs(nodes, heads, findings)

    findings.sort(key=lambda f: (not f.is_error,))
    return findings


def verify_json(json_str: str, path: str = "<json>") -> list[Finding]:
    """Verify a serialized symbol graph (Symbol.tojson format).

    Beyond ``verify_symbol`` on the loaded graph, this checks for
    unreachable nodes (MX405): a live Symbol can only hold reachable
    nodes, but hand-edited or tool-generated JSON can carry dead ones.
    """
    from ..symbol import load_json

    graph = json.loads(json_str)
    findings: list[Finding] = []

    reachable = set()
    stack = [nid for nid, _ in graph.get("heads", [])]
    nodes = graph.get("nodes", [])
    while stack:
        nid = stack.pop()
        if nid in reachable:
            continue
        reachable.add(nid)
        stack.extend(src for src, _ in nodes[nid].get("inputs", []))
    for nid, entry in enumerate(nodes):
        if nid not in reachable:
            findings.append(Finding(
                get_rule("MX405"),
                f"node {nid} ('{entry.get('name')}', op "
                f"{entry.get('op')}) is unreachable from the graph heads",
                path=path, node=str(entry.get("name"))))

    try:
        sym = load_json(json_str)
    except (MXNetError, KeyError, IndexError) as e:
        findings.append(Finding(
            get_rule("MX402"), f"graph does not load: {e}", path=path))
        return findings
    for f in verify_symbol(sym):
        f.path = path
        findings.append(f)
    return findings


def verify_json_file(path: str) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        return verify_json(f.read(), path)
