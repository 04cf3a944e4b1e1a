"""Pass 4 of the analysis passes: whole-package concurrency analysis
(MX701-MX705).

Counterpart of ``mxnet_tpu/analysis/concurrency.py``, the same model over
the port's threads: kvstore servers run condition-variable collective
rounds, the async kvstore serves each connection on a thread, the
overlapped exchange sends its buckets from a comm thread, the telemetry
hub is written from every thread and scraped by an HTTP server thread,
and the checkpoint writer and the elastic heartbeats run on threads of
their own.

Per module it builds a model of

  **thread entry points** — ``threading.Thread(target=...)`` targets
  (named functions, ``self.method``\\ s, nested worker defs, lambdas),
  weakref/GC callbacks (``weakref.ref(obj, cb)``), signal handlers,
  ``atexit``/``add_done_callback``/``pool.submit`` registrations, hub
  ``on_hub_create`` hooks and ``add_sink`` sink protocols
  (``write_event``), ``sys.excepthook`` chains, and handler classes given
  to a threading socket server — everything that runs code off the
  registering thread; and

  **lock scopes** — ``with self._lock:`` / ``with self.cv:`` regions,
  where lock identities come from the constructor assignments
  (``threading.Lock/RLock/Condition`` or the :mod:`.lockwatch` factories
  ``named_lock``, ``named_rlock`` and ``named_condition``) and
  ``cv = Condition(self.lock)`` aliases collapse the cv onto its lock.
  Private methods whose every intra-class call site holds a lock inherit
  that lock as *guaranteed-held* (the ``_helper_called_under_lock`` idiom
  does not need pragmas).

and flags:

  MX701  a shared ``self`` attribute or module global mutated from >= 2
         distinct entry points (the main thread counts as one) with no
         common lock across all mutation sites,
  MX702  a cycle in the static lock-acquisition-order graph (lexical
         ``with`` nesting plus one call hop, merged across the whole
         linted file set; the runtime watchdog in :mod:`.lockwatch`
         confirms dynamically what this sees statically),
  MX703  ``cv.wait()`` outside a predicate loop (a bare wait wakes
         spuriously and on any notify; use ``wait_for(pred)`` or loop),
  MX704  a non-daemon thread that is never ``join``\\ ed (leaks at
         shutdown and can hang interpreter exit),
  MX705  locking a freshly-constructed lock — ``with threading.Lock():``
         or the ``with getattr(self, "_lock", threading.Lock()):``
         pattern — which guards nothing: every caller locks its own lock.

Like Pass 1 the analysis is pure AST (nothing is imported or executed,
neither torch nor JAX) and zero-FP-biased: entry-point discovery is
per-module and closures escaping through variables are not chased, so
single-module truths can be incomplete — the runtime lock-order watchdog
(:mod:`.lockwatch`, ``MXNET_TPU_LOCKWATCH``) is the dynamic complement
that observes whatever the static model cannot prove. Suppression uses the
standard pragmas (``# mxlint: disable=MX701`` with a justification comment
is an audit record, not a silencing).

CLI: ``python -m mxnet_tpu_torch.analysis --concurrency [paths]``; the
tier-1 self-lint keeps the port's tree MX701-MX705 clean.
"""

from __future__ import annotations

import ast
import os

from .rules import Finding, get_rule
from .source_lint import _dotted, _suppressed, iter_python_files

__all__ = ["lint_source", "lint_file", "lint_paths", "module_model"]

# receiver methods that mutate the receiver container in place
_MUTATORS = frozenset({
    "append", "appendleft", "add", "discard", "remove", "pop", "popleft",
    "popitem", "clear", "update", "extend", "insert", "setdefault",
})

# attribute/variable names that denote synchronization primitives even
# without a visible constructor (closures, cross-object locks)
_LOCKISH_EXACT = frozenset({"cv", "_cv", "cond", "_cond", "condition",
                            "_condition"})


def _lockish(name: str) -> bool:
    low = name.lower()
    return "lock" in low or "mutex" in low or low in _LOCKISH_EXACT


def _is_lock_ctor(call: ast.Call, imports) -> str | None:
    """'lock'|'rlock'|'condition' when ``call`` constructs a primitive
    (threading.* or the lockwatch factory), else None."""
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
    if name in ("named_lock",):
        return "lock"
    if name in ("named_rlock",):
        return "rlock"
    if name in ("named_condition",):
        return "condition"
    dotted = _dotted(f, imports)
    if dotted is not None:
        for kind, suffix in (("lock", "threading.Lock"),
                             ("rlock", "threading.RLock"),
                             ("condition", "threading.Condition")):
            if dotted == suffix or dotted.endswith("." + suffix):
                return kind
    # direct `Lock()` / `RLock()` / `Condition()` from `from threading
    # import Lock`: the import map resolves those through _dotted above;
    # a bare unresolvable name is not claimed (zero-FP bias)
    return None


def _is_thread_ctor(call: ast.Call, imports) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "Thread":
        return True
    dotted = _dotted(f, imports)
    return dotted is not None and (dotted == "threading.Thread"
                                   or dotted.endswith(".threading.Thread"))


def _is_threading_local_ctor(call: ast.Call, imports) -> bool:
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
    if name != "local":
        return False
    dotted = _dotted(f, imports)
    return dotted is None or dotted.endswith("threading.local") \
        or dotted == "threading.local"


def _self_attr(node) -> str | None:
    """X for an `self.X` expression, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _target_key(node) -> str | None:
    """Context-insensitive dotted text of a Name/Attribute chain, the
    join/daemon bookkeeping key (`self._t` == `self._t`)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _mod_base(path: str) -> str:
    """Module identity for lock qualification: the trailing dotted path
    (up to 3 components, `__init__` collapsed onto its package). A bare
    basename would unify distinct locks across same-named modules —
    the tree has telemetry/memory.py AND utils/memory.py — and a merged
    MX702 graph over colliding ids could report cycles that span two
    unrelated modules (or mask a real one)."""
    parts = os.path.normpath(path).split(os.sep)
    parts = [p for p in parts if p not in ("", os.curdir, os.pardir)]
    if not parts:
        return "<module>"
    parts[-1] = os.path.splitext(parts[-1])[0]
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts[-3:]) if parts else "<module>"


# known cross-module lock summaries: calling these acquires the named
# global lock (the hub's — the one singleton every layer reports into),
# so "holding my lock while emitting telemetry" shows up as a real edge
# in the package graph instead of vanishing at the module boundary.
_HUB_LOCK_ID = "mxnet_tpu_torch.telemetry.hub.MetricsHub._lock"
_KNOWN_ACQUIRES = {
    "telemetry.emit": _HUB_LOCK_ID,
    "telemetry.counter": _HUB_LOCK_ID,
    "telemetry.gauge": _HUB_LOCK_ID,
    "telemetry.observe": _HUB_LOCK_ID,
}


class _Unit:
    """One function-like scope: a module function, a method, or a nested
    def/lambda (its own unit — a nested worker's body runs on another
    thread with an EMPTY lock stack, not the stack at its definition)."""

    __slots__ = ("node", "cls", "owner", "name", "parent", "is_entry",
                 "entry_label", "mutations", "edges", "acquired",
                 "calls_self", "calls_mod", "local_locks", "roots")

    def __init__(self, node, cls, owner, name, parent=None):
        self.node = node
        self.cls = cls              # class name or None
        self.owner = owner          # defining method name (nested) or own
        self.name = name            # display name
        self.parent = parent        # enclosing _Unit for nested defs
        self.is_entry = False
        self.entry_label = None
        self.mutations = []         # (kind, target, locks, line, col)
        self.edges = []             # (lock_a, lock_b, line, col)
        self.acquired = set()       # lock ids acquired lexically
        self.calls_self = []        # (method, locks, line)
        self.calls_mod = []         # (func-or-dotted, locks, line)
        self.local_locks = {}       # local name -> lock id
        self.roots = set()

    def find_local_lock(self, name):
        u = self
        while u is not None:
            if name in u.local_locks:
                return u.local_locks[name]
            u = u.parent
        return None


class _ClassInfo:
    __slots__ = ("name", "node", "methods", "lock_attrs", "cond_attrs",
                 "alias", "local_attrs", "entries")

    def __init__(self, name, node):
        self.name = name
        self.node = node
        self.methods = {}       # method name -> FunctionDef
        self.lock_attrs = set()
        self.cond_attrs = set()
        self.alias = {}         # cv attr -> underlying lock attr
        self.local_attrs = set()  # threading.local() attrs (thread-private)
        self.entries = set()    # method names that are thread entry points


class _Model:
    """Everything the rules need about one module."""

    def __init__(self, path, modq):
        self.path = path
        self.modq = modq
        self.imports = {}
        self.classes = {}       # name -> _ClassInfo
        self.mod_funcs = {}     # name -> FunctionDef
        self.mod_locks = {}     # module-level name -> lock id
        self.mod_conds = set()
        self.mod_entries = set()  # module function names that are entries
        self.units = []
        self.threads = []       # (call node, daemon_ok, bound_to, line, col)
        self.joined = set()     # names/attrs .join()ed anywhere
        self.daemon_set = set()  # names/attrs with `.daemon = True` set
        self.findings = []


class _Imports(ast.NodeVisitor):
    def __init__(self, model):
        self.m = model

    def visit_Import(self, node):
        for alias in node.names:
            if alias.asname:
                self.m.imports[alias.asname] = alias.name
            else:
                root = alias.name.split(".")[0]
                self.m.imports[root] = root

    def visit_ImportFrom(self, node):
        mod = ("." * node.level) + (node.module or "")
        for alias in node.names:
            full = f"{mod}.{alias.name}" if mod else alias.name
            self.m.imports[alias.asname or alias.name] = full.lstrip(".")


def _callable_operands(call: ast.Call, imports):
    """Candidate thread-entry operands of a registration call:
    (kind, node) pairs where kind in {'name','selfattr','lambda','def'}."""
    out = []

    def classify(arg):
        if isinstance(arg, ast.Lambda):
            out.append(("lambda", arg))
        elif isinstance(arg, ast.Name):
            out.append(("name", arg.id))
        else:
            attr = _self_attr(arg)
            if attr is not None:
                out.append(("selfattr", attr))
            elif isinstance(arg, ast.Call):
                # self._make_callback(...) — the factory method whose
                # nested defs are the real callbacks
                inner = _self_attr(arg.func)
                if inner is not None:
                    out.append(("selfattr", inner))
                elif isinstance(arg.func, ast.Name):
                    out.append(("name", arg.func.id))

    f = call.func
    fname = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
    dotted = _dotted(f, imports)
    if _is_thread_ctor(call, imports):
        for kw in call.keywords:
            if kw.arg == "target":
                classify(kw.value)
        if len(call.args) >= 2:       # Thread(group, target, ...)
            classify(call.args[1])
    elif dotted is not None and (dotted == "weakref.ref"
                                 or dotted.endswith(".weakref.ref")):
        if len(call.args) >= 2:
            classify(call.args[1])
    elif dotted is not None and dotted.endswith("signal.signal"):
        if len(call.args) >= 2:
            classify(call.args[1])
    elif dotted is not None and dotted.endswith("atexit.register"):
        if call.args:
            classify(call.args[0])
    elif fname in ("add_done_callback", "submit", "on_hub_create",
                   "call_soon_threadsafe"):
        if call.args:
            classify(call.args[0])
    return out


class _UnitWalk(ast.NodeVisitor):
    """Walk one unit's local body: lock stack, mutations, calls, direct
    findings. Nested defs/lambdas spawn child units (fresh lock stack)."""

    def __init__(self, model: _Model, unit: _Unit, cls: _ClassInfo | None):
        self.m = model
        self.u = unit
        self.cls = cls
        self.stack = []          # lock ids currently held (lexical)
        self.while_depth = 0
        self.globals = set()     # names declared `global` in this unit

    # -- scope boundaries ------------------------------------------------------
    def _child(self, node, label):
        child = _Unit(node, self.u.cls, self.u.owner,
                      f"{self.u.name}.{label}", parent=self.u)
        self.m.units.append(child)
        _walk_unit(self.m, child, self.cls)
        return child

    def visit_FunctionDef(self, node):
        self._child(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._child(node, f"<lambda@{node.lineno}>")

    def visit_ClassDef(self, node):
        pass  # nested classes: out of model (documented limitation)

    def visit_Global(self, node):
        self.globals.update(node.names)

    # -- lock resolution -------------------------------------------------------
    def _resolve_lock(self, expr) -> str | None:
        attr = _self_attr(expr)
        if attr is not None and self.cls is not None:
            attr = self.cls.alias.get(attr, attr)
            if attr in self.cls.lock_attrs or attr in self.cls.cond_attrs \
                    or _lockish(attr):
                return f"{self.m.modq}.{self.cls.name}.{attr}"
            return None
        if isinstance(expr, ast.Name):
            local = self.u.find_local_lock(expr.id)
            if local is not None:
                return local
            if expr.id in self.m.mod_locks:
                return self.m.mod_locks[expr.id]
            if _lockish(expr.id):
                return f"{self.m.modq}.{expr.id}"
            return None
        if isinstance(expr, ast.Attribute) and _lockish(expr.attr):
            # cross-object lock (self._server.lock): name it by its full
            # dotted text so repeat uses in this module unify
            parts = []
            node = expr
            while isinstance(node, ast.Attribute):
                parts.append(node.attr)
                node = node.value
            if isinstance(node, ast.Name):
                parts.append(node.id)
                return f"{self.m.modq}." + ".".join(reversed(parts))
        return None

    # -- with: lock scopes + MX705 ---------------------------------------------
    def visit_With(self, node):
        pushed = []
        for item in node.items:
            expr = item.context_expr
            for sub in ast.walk(expr):
                if isinstance(sub, ast.Call) and \
                        _is_lock_ctor(sub, self.m.imports):
                    self.m.findings.append(Finding(
                        get_rule("MX705"),
                        "locking a freshly-constructed lock guards "
                        "nothing: every caller locks its own private "
                        "instance (construct the lock once in __init__ "
                        "and reuse it)",
                        path=self.m.path, line=sub.lineno,
                        col=sub.col_offset))
                    break
            lock = self._resolve_lock(expr)
            if lock is not None:
                if self.stack and self.stack[-1] != lock and \
                        lock not in self.stack:
                    self.u.edges.append((self.stack[-1], lock,
                                         expr.lineno, expr.col_offset))
                self.stack.append(lock)
                self.u.acquired.add(lock)
                pushed.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for _ in pushed:
            self.stack.pop()

    visit_AsyncWith = visit_With

    # -- loops (MX703 context) -------------------------------------------------
    def visit_While(self, node):
        self.while_depth += 1
        self.generic_visit(node)
        self.while_depth -= 1

    def visit_For(self, node):
        self.while_depth += 1   # a for loop re-checking state also counts
        self.generic_visit(node)
        self.while_depth -= 1

    visit_AsyncFor = visit_For

    # -- mutations -------------------------------------------------------------
    def _record_mut(self, kind, target, node):
        self.u.mutations.append((kind, target, frozenset(self.stack),
                                 node.lineno, node.col_offset))

    def _mut_target(self, tgt, node):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._mut_target(el, node)
            return
        if isinstance(tgt, ast.Subscript):
            tgt = tgt.value
        attr = _self_attr(tgt)
        if attr is not None:
            self._record_mut("attr", attr, node)
        elif isinstance(tgt, ast.Name) and tgt.id in self.globals:
            self._record_mut("global", tgt.id, node)

    def visit_Assign(self, node):
        # local lock bindings (engine-style `lock = threading.Lock()`)
        if isinstance(node.value, ast.Call) and \
                _is_lock_ctor(node.value, self.m.imports):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.u.local_locks[tgt.id] = \
                        f"{self.m.modq}.{self.u.name}.{tgt.id}"
        for tgt in node.targets:
            self._mut_target(tgt, node)
        # `t.daemon = True` before start() counts as daemonizing
        for tgt in node.targets:
            if isinstance(tgt, ast.Attribute) and tgt.attr == "daemon" \
                    and isinstance(node.value, ast.Constant) \
                    and node.value.value is True:
                key = _target_key(tgt.value)
                if key is not None:
                    self.m.daemon_set.add(key)
        self.visit(node.value)

    def visit_AugAssign(self, node):
        self._mut_target(node.target, node)
        self.visit(node.value)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._mut_target(node.target, node)
            self.visit(node.value)

    def visit_Delete(self, node):
        for tgt in node.targets:
            self._mut_target(tgt, node)

    # -- calls: mutators, registrations, MX703/704, call graph -----------------
    def visit_Call(self, node):
        f = node.func
        # container mutators on self.X
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = _self_attr(f.value)
            if attr is not None:
                self._record_mut("attr", attr, node)
        # `.join()` bookkeeping (MX704)
        if isinstance(f, ast.Attribute) and f.attr == "join":
            key = _target_key(f.value)
            if key is not None:
                self.m.joined.add(key)
        # MX703: bare cv.wait() outside a predicate loop
        if isinstance(f, ast.Attribute) and f.attr == "wait":
            recv = f.value
            recv_attr = _self_attr(recv)
            is_cv = False
            if recv_attr is not None and self.cls is not None:
                is_cv = recv_attr in self.cls.cond_attrs or \
                    recv_attr.lower() in _LOCKISH_EXACT
            elif isinstance(recv, ast.Name):
                is_cv = recv.id in self.m.mod_conds or \
                    recv.id.lower() in _LOCKISH_EXACT
            elif isinstance(recv, ast.Attribute):
                is_cv = recv.attr.lower() in _LOCKISH_EXACT
            if is_cv and self.while_depth == 0:
                self.m.findings.append(Finding(
                    get_rule("MX703"),
                    "`.wait()` without a predicate loop: condition waits "
                    "wake spuriously and on any notify — re-check the "
                    "predicate in a loop or use `.wait_for(predicate)`",
                    path=self.m.path, line=node.lineno,
                    col=node.col_offset))
        # MX704 candidates: Thread constructions
        if _is_thread_ctor(node, self.m.imports):
            daemon_ok = any(
                kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True for kw in node.keywords)
            self.m.threads.append([node, daemon_ok, None,
                                   node.lineno, node.col_offset])
        # thread-entry registrations
        for kind, operand in _callable_operands(node, self.m.imports):
            self._mark_entry(kind, operand, node)
        # sink protocol: an add_sink() in this module marks every local
        # class's write_event as running on foreign threads
        fname = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", "")
        if fname == "add_sink":
            for info in self.m.classes.values():
                if "write_event" in info.methods:
                    info.entries.add("write_event")
        # threading socket servers: handler classes run on server threads
        if fname.endswith(("HTTPServer", "TCPServer", "UDPServer")):
            for arg in node.args:
                if isinstance(arg, ast.Name) and arg.id in self.m.classes:
                    info = self.m.classes[arg.id]
                    info.entries.update(info.methods)
        # call graph
        attr = _self_attr(f)
        if attr is not None:
            self.u.calls_self.append((attr, frozenset(self.stack),
                                      node.lineno))
        elif isinstance(f, ast.Name):
            self.u.calls_mod.append((f.id, frozenset(self.stack),
                                     node.lineno))
        else:
            dotted = _dotted(f, self.m.imports)
            if dotted is not None:
                self.u.calls_mod.append((dotted, frozenset(self.stack),
                                         node.lineno))
        self.generic_visit(node)

    def _mark_entry(self, kind, operand, node):
        if kind == "selfattr" and self.cls is not None:
            self.cls.entries.add(operand)
        elif kind == "name":
            if operand in self.m.mod_funcs:
                self.m.mod_entries.add(operand)
            else:
                # a local nested def already walked (or about to be):
                # mark by name; resolved when roots are assigned
                self.u.calls_mod.append((f"<entry>{operand}",
                                         frozenset(), node.lineno))
        elif kind == "lambda":
            for sub in ast.walk(operand):
                if isinstance(sub, ast.Call):
                    inner = _self_attr(sub.func)
                    if inner is not None and self.cls is not None:
                        self.cls.entries.add(inner)
                    elif isinstance(sub.func, ast.Name) and \
                            sub.func.id in self.m.mod_funcs:
                        self.m.mod_entries.add(sub.func.id)


def _walk_unit(model, unit, cls):
    walk = _UnitWalk(model, unit, cls)
    node = unit.node
    body = [node.body] if isinstance(node, ast.Lambda) else node.body
    for stmt in body:
        walk.visit(stmt)


def _collect_class(model, node: ast.ClassDef):
    info = _ClassInfo(node.name, node)
    model.classes[node.name] = info
    for stmt in node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.methods[stmt.name] = stmt
    # lock/cond/threading.local attribute discovery: any `self.X = ctor`
    # anywhere in the class (usually __init__, sometimes reset/lazy-init)
    for meth in info.methods.values():
        for sub in ast.walk(meth):
            if not isinstance(sub, ast.Assign) or \
                    not isinstance(sub.value, ast.Call):
                continue
            kind = _is_lock_ctor(sub.value, model.imports)
            is_tl = kind is None and \
                _is_threading_local_ctor(sub.value, model.imports)
            if kind is None and not is_tl:
                continue
            for tgt in sub.targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if is_tl:
                    info.local_attrs.add(attr)
                elif kind == "condition":
                    info.cond_attrs.add(attr)
                    for arg in ast.walk(sub.value):
                        inner = _self_attr(arg)
                        if inner is not None and inner != attr:
                            info.alias[attr] = inner
                            break
                else:
                    info.lock_attrs.add(attr)


def module_model(tree: ast.AST, path: str) -> _Model:
    """Build the per-module concurrency model (public for tooling/tests)."""
    model = _Model(path, _mod_base(path))
    _Imports(model).visit(tree)
    for stmt in tree.body:
        if isinstance(stmt, ast.ClassDef):
            _collect_class(model, stmt)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            model.mod_funcs[stmt.name] = stmt
        elif isinstance(stmt, ast.Assign) and \
                isinstance(stmt.value, ast.Call):
            kind = _is_lock_ctor(stmt.value, model.imports)
            if kind is not None:
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        lock_id = f"{model.modq}.{tgt.id}"
                        if kind == "condition":
                            model.mod_conds.add(tgt.id)
                        model.mod_locks[tgt.id] = lock_id
    # sys.excepthook = fn  (module or function level)
    for sub in ast.walk(tree):
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
            tgt = sub.targets[0]
            if isinstance(tgt, ast.Attribute) and tgt.attr == "excepthook" \
                    and isinstance(sub.value, ast.Name) \
                    and sub.value.id in model.mod_funcs:
                model.mod_entries.add(sub.value.id)
    # units: module functions, methods (class units), then nested defs
    # spawn child units during the walk
    for cname, info in model.classes.items():
        for mname, mnode in info.methods.items():
            unit = _Unit(mnode, cname, mname, f"{cname}.{mname}")
            model.units.append(unit)
            _walk_unit(model, unit, info)
    for fname, fnode in model.mod_funcs.items():
        unit = _Unit(fnode, None, fname, fname)
        model.units.append(unit)
        _walk_unit(model, unit, None)
    # thread target binding for MX704: `self.t = Thread(...)` / `t = ...`
    for sub in ast.walk(tree):
        if isinstance(sub, ast.Assign) and \
                isinstance(sub.value, ast.Call) and \
                _is_thread_ctor(sub.value, model.imports):
            for rec in model.threads:
                if rec[0] is sub.value:
                    rec[2] = _target_key(sub.targets[0])
    return model


# -- roots + guaranteed-held-lock inference ------------------------------------

def _assign_roots(model: _Model):
    """roots(unit): entry labels reaching it through the intra-class /
    intra-module call graph; {'main'} when nothing threaded reaches it."""
    # class-level BFS from entry methods
    for cname, info in model.classes.items():
        method_units = {u.owner: u for u in model.units
                        if u.cls == cname and u.parent is None}
        reach = {m: set() for m in method_units}
        frontier = []
        for entry in info.entries:
            if entry in reach:
                reach[entry].add(f"{cname}.{entry}")
                frontier.append(entry)
        while frontier:
            cur = frontier.pop()
            for callee, _, _ in method_units[cur].calls_self:
                if callee in reach and not reach[cur] <= reach[callee]:
                    reach[callee] |= reach[cur]
                    frontier.append(callee)
        for mname, unit in method_units.items():
            unit.roots = set(reach[mname]) or {"main"}
    # module functions
    mod_units = {u.owner: u for u in model.units
                 if u.cls is None and u.parent is None}
    reach = {f: set() for f in mod_units}
    frontier = []
    for entry in model.mod_entries:
        if entry in reach:
            reach[entry].add(entry)
            frontier.append(entry)
    while frontier:
        cur = frontier.pop()
        for callee, _, _ in mod_units[cur].calls_mod:
            callee = callee.split(".")[-1]
            if callee in reach and not reach[cur] <= reach[callee]:
                reach[callee] |= reach[cur]
                frontier.append(callee)
    for fname, unit in mod_units.items():
        unit.roots = set(reach[fname]) or {"main"}
    # nested units: explicit entry registrations (`Thread(target=worker)`
    # where worker is a local def) make the nested def its own root;
    # otherwise it inherits the parent's roots (runs on the same thread).
    for unit in model.units:
        if unit.parent is None:
            continue
        parent = unit.parent
        label = unit.name.rsplit(".", 1)[-1]
        registered = any(c[0] == f"<entry>{label}"
                         for c in parent.calls_mod)
        # weakref-callback factories: nested defs of an entry method ARE
        # the callback bodies, so they keep the entry root
        if registered:
            unit.is_entry = True
            unit.roots = {unit.name}
        else:
            unit.roots = set(parent.roots) or {"main"}


def _guaranteed_locks(model: _Model):
    """For private methods, locks held at EVERY intra-class call site
    propagate into the method's mutation contexts (the helper-under-lock
    idiom). Two passes reach the fixpoint for one level of nesting."""
    for cname in model.classes:
        method_units = {u.owner: u for u in model.units
                        if u.cls == cname and u.parent is None}
        guaranteed = {m: frozenset() for m in method_units}
        for _ in range(3):
            changed = False
            sites = {m: [] for m in method_units}
            for mname, unit in method_units.items():
                held = guaranteed[mname]
                for callee, locks, _ in unit.calls_self:
                    if callee in sites:
                        sites[callee].append(locks | held)
            for mname, unit in method_units.items():
                if not mname.startswith("_") or mname.startswith("__") or \
                        not sites[mname]:
                    continue
                new = frozenset.intersection(*map(frozenset, sites[mname]))
                if new != guaranteed[mname]:
                    guaranteed[mname] = new
                    changed = True
            if not changed:
                break
        for mname, unit in method_units.items():
            g = guaranteed[mname]
            if g:
                unit.mutations = [(k, t, locks | g, ln, col)
                                  for k, t, locks, ln, col in unit.mutations]
                unit.calls_self = [(c, locks | g, ln)
                                   for c, locks, ln in unit.calls_self]
                unit.calls_mod = [(c, locks | g, ln)
                                  for c, locks, ln in unit.calls_mod]
                unit.edges = [(a, b, ln, col)
                              for a, b, ln, col in unit.edges]
                # a held lock at entry also orders against locks acquired
                # inside (caller edge: G -> first acquired)
                for lock in unit.acquired:
                    for g_lock in g:
                        if g_lock != lock:
                            unit.edges.append(
                                (g_lock, lock, unit.node.lineno,
                                 unit.node.col_offset))


# -- rule evaluation -----------------------------------------------------------

_MX701_EXEMPT_SUFFIXES = ("_tls",)


def _check_mx701(model: _Model):
    # class attributes
    for cname, info in model.classes.items():
        units = [u for u in model.units if u.cls == cname]
        sites = {}   # attr -> [(roots, locks, line, col)]
        for unit in units:
            # constructor-time mutations run before the object escapes —
            # unless the unit is a nested worker the constructor spawned
            if unit.owner in ("__init__", "__new__", "__del__") and \
                    not unit.is_entry:
                continue
            for kind, target, locks, line, col in unit.mutations:
                if kind != "attr":
                    continue
                if target in info.lock_attrs or target in info.cond_attrs \
                        or target in info.local_attrs \
                        or target.startswith("__") \
                        or target.endswith(_MX701_EXEMPT_SUFFIXES):
                    continue
                sites.setdefault(target, []).append(
                    (frozenset(unit.roots), locks, line, col))
        for attr, rows in sorted(sites.items()):
            all_roots = set().union(*(r for r, _, _, _ in rows))
            if len(all_roots) < 2:
                continue
            common = frozenset.intersection(*(l for _, l, _, _ in rows))
            if common:
                continue
            rows.sort(key=lambda r: (len(r[1]), r[2]))
            _, _, line, col = rows[0]
            model.findings.append(Finding(
                get_rule("MX701"),
                f"`self.{attr}` is mutated from {len(all_roots)} thread "
                f"entry points ({', '.join(sorted(all_roots))}) with no "
                "common lock across the mutation sites",
                path=model.path, line=line, col=col,
                extra={"attr": attr, "roots": sorted(all_roots)}))
    # module globals
    sites = {}
    for unit in model.units:
        if unit.cls is not None:
            continue
        for kind, target, locks, line, col in unit.mutations:
            if kind != "global" or target in model.mod_locks:
                continue
            sites.setdefault(target, []).append(
                (frozenset(unit.roots), locks, line, col))
    for name, rows in sorted(sites.items()):
        all_roots = set().union(*(r for r, _, _, _ in rows))
        if len(all_roots) < 2:
            continue
        common = frozenset.intersection(*(l for _, l, _, _ in rows))
        if common:
            continue
        rows.sort(key=lambda r: (len(r[1]), r[2]))
        _, _, line, col = rows[0]
        model.findings.append(Finding(
            get_rule("MX701"),
            f"global `{name}` is mutated from {len(all_roots)} thread "
            f"entry points ({', '.join(sorted(all_roots))}) with no "
            "common lock across the mutation sites",
            path=model.path, line=line, col=col,
            extra={"attr": name, "roots": sorted(all_roots)}))


def _check_mx704(model: _Model):
    for node, daemon_ok, bound, line, col in model.threads:
        if daemon_ok:
            continue
        if bound is not None and (bound in model.joined
                                  or bound in model.daemon_set):
            continue
        model.findings.append(Finding(
            get_rule("MX704"),
            "non-daemon thread is never joined: it outlives shutdown "
            "paths and can hang interpreter exit (pass daemon=True, or "
            "keep a handle and join it on every shutdown path)",
            path=model.path, line=line, col=col))


def _collect_edges(model: _Model):
    """(a, b, path, line) edges: lexical nesting + one call hop (into
    same-class methods and the known cross-module summaries)."""
    edges = []
    method_units = {}
    for unit in model.units:
        if unit.cls is not None and unit.parent is None:
            method_units.setdefault(unit.cls, {})[unit.owner] = unit
    for unit in model.units:
        for a, b, line, _ in unit.edges:
            edges.append((a, b, model.path, line))
        for callee, locks, line in unit.calls_self:
            if not locks or unit.cls is None:
                continue
            target = method_units.get(unit.cls, {}).get(callee)
            if target is None:
                continue
            for b in target.acquired:
                for a in locks:
                    if a != b and b not in locks:
                        edges.append((a, b, model.path, line))
        for callee, locks, line in unit.calls_mod:
            if not locks:
                continue
            for suffix, lock_id in _KNOWN_ACQUIRES.items():
                if callee == suffix or callee.endswith("." + suffix):
                    for a in locks:
                        if a != lock_id:
                            edges.append((a, lock_id, model.path, line))
    return edges


def _find_cycles(edges):
    """Strongly-connected components of size > 1 over the merged edge
    set; each SCC is reported once, anchored at its first edge site."""
    adj = {}
    sites = {}
    for a, b, path, line in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
        sites.setdefault((a, b), (path, line))
    index = {}
    low = {}
    on_stack = set()
    stack = []
    sccs = []
    counter = [0]

    def strongconnect(v):
        work = [(v, iter(sorted(adj[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    out = []
    for comp in sccs:
        comp_set = set(comp)
        internal = sorted((p, ln, a, b) for (a, b), (p, ln) in sites.items()
                          if a in comp_set and b in comp_set)
        path, line = (internal[0][0], internal[0][1]) if internal \
            else ("<merged>", 0)
        out.append((comp, internal, path, line))
    return out


def _mx702_findings(edges):
    findings = []
    for comp, internal, path, line in _find_cycles(edges):
        sites = ", ".join(f"{os.path.basename(p)}:{ln} {a}->{b}"
                          for p, ln, a, b in internal[:6])
        findings.append(Finding(
            get_rule("MX702"),
            "inconsistent lock-acquisition order: cycle in the static "
            f"lock graph over {{{', '.join(comp)}}} — two threads "
            "interleaving these orders deadlock (edges: " + sites + ")",
            path=path, line=line, col=0,
            extra={"cycle": comp,
                   "edges": [(a, b) for _, _, a, b in internal]}))
    return findings


# -- entry points --------------------------------------------------------------

def _analyze_source(text, path):
    """(direct findings, edges) for one module; MX100 on syntax error."""
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as e:
        return [Finding(get_rule("MX100"),
                        f"file does not parse: {e.msg}", path=path,
                        line=e.lineno or 0, col=e.offset or 0)], []
    model = module_model(tree, path)
    _assign_roots(model)
    _guaranteed_locks(model)
    _check_mx701(model)
    _check_mx704(model)
    return model.findings, _collect_edges(model)


def _filter(findings, lines_by_path):
    out = []
    for f in findings:
        lines = lines_by_path.get(f.path)
        if lines is not None and _suppressed(f, lines):
            continue
        out.append(f)
    return out


def lint_source(text: str, path: str = "<string>") -> list:
    """Concurrency-lint one module in isolation (fixture entry point):
    MX701/703/704/705 plus MX702 over this module's own lock graph."""
    lines = text.splitlines()
    if any("# mxlint: skip-file" in ln for ln in lines[:5]):
        return []
    findings, edges = _analyze_source(text, path)
    findings = findings + _mx702_findings(edges)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule.id))
    return _filter(findings, {path: lines})


def lint_file(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


def lint_paths(paths) -> list:
    """The whole-package pass: per-module rules plus MX702 over the edge
    set merged across every linted file (cross-module summaries included,
    so a hub-lock inversion spanning two modules is one cycle)."""
    findings = []
    edges = []
    lines_by_path = {}
    for fpath in iter_python_files(paths):
        if not fpath.endswith(".py"):
            continue
        with open(fpath, encoding="utf-8") as f:
            text = f.read()
        lines = text.splitlines()
        if any("# mxlint: skip-file" in ln for ln in lines[:5]):
            continue
        lines_by_path[fpath] = lines
        found, mod_edges = _analyze_source(text, fpath)
        findings.extend(found)
        edges.extend(mod_edges)
    findings.extend(_mx702_findings(edges))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule.id))
    return _filter(findings, lines_by_path)
