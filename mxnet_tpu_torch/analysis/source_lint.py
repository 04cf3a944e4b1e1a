"""Pass 1 of the analysis passes: the AST source lint of the port.

Counterpart of ``mxnet_tpu/analysis/source_lint.py``, with what its rules
say of JAX and Pallas said of torch and CUDA. It catches, before anything
is imported or run:
  MX101        any import of JAX or of the JAX package (``jax``,
               ``jaxlib``, ``mxnet_tpu``): the port imports torch only, so
               its first rule is a static gate,
  MX201-203    hazards inside captured code (numpy calls, which run once at
               capture and freeze their values into the graph; ``.item()``,
               ``.tolist()``, ``.cpu()``, ``.numpy()`` and float()/int() on
               a captured value, which sync, and a CUDA-graph capture
               forbids a sync; Python branches on tensors, which sync and
               freeze the branch taken),
  MX302-303    string formatting inside captured code, and a CUDA graph
               (``CapturedProgram``, ``CapturedPair``, ``CUDAGraph``) built
               per call or per loop iteration,
  MX304        raw ``torch.distributed`` collectives over gradients outside
               comm/ and parallel/,
  MX306        un-barriered wall-clock deltas around device work (timing
               the enqueue instead of the execution; telemetry/ and
               utils/profiler are the sanctioned timing homes),
  MX307        leaked StepTimeline spans and un-entered phase()/timed(),
  MX309        implicit host syncs (``.item()``/``.cpu()``/``.numpy()``/
               ``.asnumpy()``/``np.asarray``) inside a loop that dispatches
               the train/eval/predict step (intentional per-step syncs
               carry a disable pragma),
  MX310        world-size/axis-size integer literals captured in closures
               outside the mesh/coordinator providers,
  MX311        direct fleet actuation (ElasticCoordinator.kill/
               request_world, set_gradient_compression) outside
               resilience/controller.py,
  MX312        CUDA or Triton kernels outside kernels/, and kernel modules
               there that launch without registering a cost model,
  MX313        per-leaf Python loops over gradients inside captured
               functions that materialize per-leaf host statistics,
  MX314        raw torch profiler captures (``torch.profiler.profile``,
               ``torch.autograd.profiler.profile``,
               ``torch.cuda.profiler.start``) outside utils/profiler.py /
               telemetry/profiling.py, and any start_trace/start_capture
               without a finally-guarded stop,
  MX315        direct sharded-checkpoint writes outside utils/checkpoint.py
               / resilience/ckpt_async.py,
  MX316        hand-rolled run-summary emission or direct
               MXNET_TPU_LEDGER_DIR consultation outside
               telemetry/ledger.py,
  MX601-602    bare ``except:``; ``while True`` retry loops that swallow
               exceptions with no backoff/deadline,
  MX805        raw placement (``torch.distributed.tensor``'s
               distribute_tensor / DTensor.from_local, a ``Sharding(...)``
               ``.shard(...)``) outside parallel/ and comm/.
MX102, MX301 and MX308 speak of JAX import paths, jit static arguments and
XLA's commuting of casts across a collective; they have no meaning over
torch code and never fire here (ROADMAP C.2).

Captured-context detection is intentionally heuristic: a function counts
as captured when it is *visibly* captured into a CUDA graph — given to
``utils.compile.CapturedProgram`` / ``CapturedPair`` or
``torch.cuda.make_graphed_callables`` (a lambda, or a name that resolves
to a def in the calling scope or one enclosing it), or run in the body of
``with torch.cuda.graph(...)``, or nested inside such code. Closures that
escape through variables or attributes are not chased; the lint favors
zero false positives on error-severity rules over recall, since the
self-lint gates the tier-1 suite.

This module imports neither torch nor JAX, nor the linted files:
everything is AST-level.
"""

from __future__ import annotations

import ast
import os

from .rules import Finding, get_rule

__all__ = ["lint_source", "lint_file", "lint_paths", "iter_python_files"]

# import root -> why the port may not import it (MX101)
FORBIDDEN_IMPORTS = {
    "jax": "the port runs on torch and never imports JAX",
    "jaxlib": "the port runs on torch and never imports JAX",
    "mxnet_tpu": "the port keeps its own copy of what it needs from the "
                 "JAX package and imports nothing of it",
}
_IMPORT_CALLS = ("importlib.import_module", "__import__")

# capture entry point -> positions of function-valued operands
CAPTURE_CALLS = {
    "mxnet_tpu_torch.utils.compile.CapturedProgram": (0,),
    "mxnet_tpu_torch.utils.compile.CapturedPair": (0, 1),
    "torch.cuda.make_graphed_callables": (0,),
    "torch.cuda.graphs.make_graphed_callables": (0,),
}
# context managers whose `with` body is captured
CAPTURE_BLOCKS = ("torch.cuda.graph", "torch.cuda.graphs.graph")

# graph factories: building one of these per call/iteration re-captures
# and rebuilds the graph's memory pool every time (MX303)
_CAPTURE_FAMILY = ("torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph",
                   "torch.cuda.make_graphed_callables",
                   "mxnet_tpu_torch.utils.compile.CapturedProgram",
                   "mxnet_tpu_torch.utils.compile.CapturedPair")

# raw torch.distributed collectives (MX304)
_RAW_COLLECTIVES = ("all_reduce", "all_reduce_coalesced", "reduce_scatter",
                    "reduce_scatter_tensor", "all_gather",
                    "all_gather_into_tensor", "all_gather_coalesced")


def _suffix_match(path, key):
    """'compile.CapturedProgram' matches
    'mxnet_tpu_torch.utils.compile.CapturedProgram' and the reverse."""
    return path == key or path.endswith("." + key) or \
        key.endswith("." + path)


def _is_capture_family(path):
    return path is not None and any(_suffix_match(path, key)
                                    for key in _CAPTURE_FAMILY)


_HOST_SYNC_ATTRS = ("item", "tolist", "cpu", "numpy")
_HOST_CAST_FUNCS = ("float", "int", "bool", "complex")
_SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "node_modules"}


def _mentions_grad(node) -> bool:
    """Does an expression name something gradient-shaped? (MX304 heuristic:
    identifiers/attributes containing 'grad' — zero-FP over recall.)"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "grad" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "grad" in sub.attr.lower():
            return True
    return False


def _in_comm_package(path: str) -> bool:
    """comm/ and parallel/ are the sanctioned homes for raw gradient
    collectives."""
    p = path.replace(os.sep, "/")
    return "mxnet_tpu_torch/comm/" in p or "mxnet_tpu_torch/parallel/" in p


def _dotted(expr, imports):
    """Resolve an expression to a dotted path via the module's import map.
    Returns None when the root name is not an imported module/symbol."""
    parts = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = imports.get(node.id)
    if root is None:
        return None
    parts.append(root)
    return ".".join(reversed(parts))


def _match_capture(path):
    """Return function-operand positions when ``path`` names a capture
    entry point (suffix-tolerant)."""
    if path is None:
        return None
    for key, pos in CAPTURE_CALLS.items():
        if _suffix_match(path, key):
            return pos
    return None


def _is_capture_block(expr, imports):
    return isinstance(expr, ast.Call) and any(
        _suffix_match(_dotted(expr.func, imports) or "\0", key)
        for key in CAPTURE_BLOCKS)


def _raw_collective(dotted):
    if dotted is None or not dotted.startswith("torch.distributed."):
        return False
    return dotted.rsplit(".", 1)[1] in _RAW_COLLECTIVES


def _fn_params(fn):
    if fn is None:
        return set()
    a = fn.args
    params = {p.arg for p in a.posonlyargs + a.args
              if p.arg not in ("self", "cls")}
    params.update(p.arg for p in a.kwonlyargs)
    return params


class _ModuleScan(ast.NodeVisitor):
    """One pass over the module: imports, import findings, captured
    roots."""

    def __init__(self, path):
        self.path = path
        self.imports: dict[str, str] = {}
        self.findings: list[Finding] = []
        # (name, ids of the scopes the operand was seen in, innermost
        # first): resolved to a def after the walk
        self.captured_names: list[tuple[str, tuple]] = []
        self.captured_lambdas: list[ast.Lambda] = []
        self.captured_blocks: list[tuple[ast.AST, set]] = []
        self.defs: list[ast.FunctionDef] = []
        self.def_scope: dict[int, int] = {}   # id(def) -> id(its scope)
        self._scopes: list[ast.AST] = []
        self._loop_depth = 0
        self._mapped: set[int] = set()   # collectives reported in a loop

    def _scope_chain(self):
        """The scopes a name seen here resolves in, innermost first: the
        enclosing functions and the module (None); a class body only when
        it is the innermost, as Python resolves names."""
        chain = [id(s) for i, s in enumerate(reversed(self._scopes))
                 if i == 0 or not isinstance(s, ast.ClassDef)]
        return tuple(chain) + (None,)

    def _enclosing_fn(self):
        for s in reversed(self._scopes):
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return s
        return None

    # -- loop tracking (MX303: a graph built inside a loop) -------------------
    def visit_For(self, node):
        # MX304(c): `for g in grads: dist.all_reduce(g)` — the loop
        # variable hides the gradient name that the iterable carries
        if not _in_comm_package(self.path) and _mentions_grad(node.iter):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and _raw_collective(
                        _dotted(sub.func, self.imports)) and \
                        not any(_mentions_grad(a) for a in sub.args) and \
                        id(sub) not in self._mapped:
                    self._mapped.add(id(sub))  # nested loops: report once
                    self.findings.append(Finding(
                        get_rule("MX304"),
                        f"`{_dotted(sub.func, self.imports)}` over each "
                        "gradient bypasses the comm subsystem",
                        path=self.path, line=sub.lineno, col=sub.col_offset))
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_AsyncFor = visit_For

    def visit_While(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    # -- imports (MX101) ------------------------------------------------------
    def _check_import_path(self, full, node):
        root = full.split(".")[0]
        why = FORBIDDEN_IMPORTS.get(root)
        if why is not None:
            self.findings.append(Finding(
                get_rule("MX101"), f"`{full}`: {why}",
                path=self.path, line=node.lineno, col=node.col_offset))

    def visit_Import(self, node):
        for alias in node.names:
            if alias.asname:  # `import a.b as x` binds x to the full path
                self.imports[alias.asname] = alias.name
            else:  # `import a.b.c` binds only the root name `a`
                root = alias.name.split(".")[0]
                self.imports[root] = root
            self._check_import_path(alias.name, node)

    def visit_ImportFrom(self, node):
        mod = ("." * node.level) + (node.module or "")
        for alias in node.names:
            full = f"{mod}.{alias.name}" if mod else alias.name
            self.imports[alias.asname or alias.name] = full.lstrip(".")
            if node.level == 0:  # a relative import stays in the package
                self._check_import_path(full, node)

    # -- captured-root discovery ----------------------------------------------
    def _mark_fn_operand(self, arg):
        if isinstance(arg, ast.Lambda):
            self.captured_lambdas.append(arg)
        elif isinstance(arg, ast.Name):
            self.captured_names.append((arg.id, self._scope_chain()))
        elif isinstance(arg, (ast.Tuple, ast.List)):
            # make_graphed_callables((f, g), ...)
            for el in arg.elts:
                self._mark_fn_operand(el)
        elif isinstance(arg, ast.Call):
            # functools.partial(fn, ...) wrapping
            for inner in arg.args:
                self._mark_fn_operand(inner)

    def visit_Call(self, node):
        dotted = _dotted(node.func, self.imports)
        # MX101: importlib.import_module("jax") / __import__("jax")
        name = node.func.id if isinstance(node.func, ast.Name) else None
        if (dotted in _IMPORT_CALLS or name == "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and not node.args[0].value.startswith("."):
            self._check_import_path(node.args[0].value, node)
        # MX303(a): `CapturedProgram(fn, ...)(...)` — the program (and its
        # graph) dies with the expression; every call captures afresh
        if isinstance(node.func, ast.Call):
            inner = _dotted(node.func.func, self.imports)
            if _is_capture_family(inner):
                self.findings.append(Finding(
                    get_rule("MX303"),
                    f"`{inner}(...)(...)` builds a fresh CUDA graph and "
                    "discards it after one call",
                    path=self.path, line=node.lineno, col=node.col_offset))
        # MX304: a raw torch.distributed collective over gradient-named
        # values — uncompressed, unbucketed gradient sync outside the comm
        # subsystem. Shapes: (a) dist.all_reduce(grads/p.grad/...)
        # directly; (b) tree_map(lambda g: dist.all_reduce(g), grads),
        # where the lambda's parameter hides the gradient name but a
        # sibling argument carries it; (c) the for loop (visit_For)
        if not _in_comm_package(self.path):
            if _raw_collective(dotted) and \
                    any(_mentions_grad(a) for a in node.args):
                self.findings.append(Finding(
                    get_rule("MX304"),
                    f"`{dotted}` over gradients bypasses the comm "
                    "subsystem (fp32, no bucketing, no wire accounting)",
                    path=self.path, line=node.lineno, col=node.col_offset))
            elif dotted is not None and dotted.endswith("tree_map") and \
                    any(_mentions_grad(a) for a in node.args[1:]):
                fn_arg = node.args[0] if node.args else None
                if fn_arg is not None:
                    for sub in ast.walk(fn_arg):
                        if isinstance(sub, ast.Call):
                            inner = _dotted(sub.func, self.imports)
                            if _raw_collective(inner):
                                self.findings.append(Finding(
                                    get_rule("MX304"),
                                    f"`{inner}` mapped over gradients "
                                    "bypasses the comm subsystem",
                                    path=self.path, line=sub.lineno,
                                    col=sub.col_offset))
                                break
        # MX303(b): a graph built inside a loop body is captured afresh
        # (its pool rebuilt) on every iteration
        if _is_capture_family(dotted) and self._loop_depth > 0:
            self.findings.append(Finding(
                get_rule("MX303"),
                f"`{dotted}` called inside a loop: a CUDA graph is "
                "captured afresh every iteration",
                path=self.path, line=node.lineno, col=node.col_offset))
        pos = _match_capture(dotted)
        if pos is not None:
            for i in pos:
                if i < len(node.args):
                    self._mark_fn_operand(node.args[i])
        self.generic_visit(node)

    def visit_With(self, node):
        # `with torch.cuda.graph(g):` — the body is captured, with the
        # enclosing function's arguments as the possibly-captured values
        if any(_is_capture_block(item.context_expr, self.imports)
               for item in node.items):
            self.captured_blocks.append(
                (node, _fn_params(self._enclosing_fn())))
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node):
        self.defs.append(node)
        self.def_scope[id(node)] = id(self._scopes[-1]) \
            if self._scopes else None
        for dec in node.decorator_list:
            candidates = [dec]
            if isinstance(dec, ast.Call):
                candidates = [dec.func] + list(dec.args)
            for target in candidates:
                if _match_capture(_dotted(target, self.imports)) is not None:
                    self.captured_names.append(
                        (node.name, self._scope_chain()))
                    break
        self._scopes.append(node)
        self.generic_visit(node)
        self._scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._scopes.append(node)
        self.generic_visit(node)
        self._scopes.pop()

    visit_ClassDef = visit_Lambda

    def captured_defs(self):
        """The defs the captured names resolve to: the def of that name in
        the innermost scope, of the chain the operand was seen in, that
        defines one (Python's own lookup, minus rebinding)."""
        by_scope: dict = {}
        for d in self.defs:
            by_scope.setdefault((self.def_scope[id(d)], d.name), d)
        out = []
        for name, chain in self.captured_names:
            for scope in chain:
                d = by_scope.get((scope, name))
                if d is not None:
                    out.append(d)
                    break
        return out


class _CapturedWalk(ast.NodeVisitor):
    """Hazard scan inside one captured root (nested defs included)."""

    def __init__(self, scan: _ModuleScan, params: set[str]):
        self.scan = scan
        self.params = params

    def _flag(self, rule_id, msg, node):
        self.scan.findings.append(Finding(
            get_rule(rule_id), msg, path=self.scan.path,
            line=node.lineno, col=node.col_offset))

    def visit_FunctionDef(self, node):
        self.params.update(a.arg for a in node.args.args
                           if a.arg not in ("self", "cls"))
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self.params.update(a.arg for a in node.args.args)
        self.generic_visit(node)

    def visit_Call(self, node):
        dotted = _dotted(node.func, self.scan.imports)
        if dotted is not None and (dotted == "numpy"
                                   or dotted.startswith("numpy.")):
            self._flag("MX201",
                       f"`{dotted}(...)` runs once, on the host, at capture",
                       node)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _HOST_SYNC_ATTRS and not node.args:
            self._flag("MX202",
                       f"`.{node.func.attr}()` blocks on a device-to-host "
                       "transfer inside captured code", node)
        if isinstance(node.func, ast.Name) and \
                node.func.id in _HOST_CAST_FUNCS and len(node.args) == 1 \
                and isinstance(node.args[0], ast.Name) \
                and node.args[0].id in self.params:
            self._flag("MX202",
                       f"`{node.func.id}({node.args[0].id})` forces a host "
                       "sync on a captured value", node)
        self.generic_visit(node)

    def _test_touches_param(self, test):
        if isinstance(test, ast.Name):
            return test.id in self.params
        if isinstance(test, ast.Compare):
            sides = [test.left] + list(test.comparators)
            return any(isinstance(s, ast.Name) and s.id in self.params
                       for s in sides)
        if isinstance(test, ast.BoolOp):
            return any(self._test_touches_param(v) for v in test.values)
        return False

    def visit_If(self, node):
        if self._test_touches_param(node.test):
            self._flag("MX203", "Python `if` on a function argument that "
                       "may be a captured tensor", node)
        self.generic_visit(node)

    def visit_While(self, node):
        if self._test_touches_param(node.test):
            self._flag("MX203", "Python `while` on a function argument "
                       "that may be a captured tensor", node)
        self.generic_visit(node)

    def visit_For(self, node):
        # MX313: a per-leaf loop over gradients whose body pulls host
        # values (float()/int(), .item()/.tolist()/.cpu()/.numpy()/
        # .asnumpy(), numpy.*) — a sync per parameter per step, the shape
        # the in-graph health stats engine replaces. One finding per loop;
        # pure-torch per-leaf loops stay clean.
        if _mentions_grad(node.iter):
            hit = None
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    f = sub.func
                    dotted = _dotted(f, self.scan.imports)
                    if dotted is not None and (
                            dotted == "numpy"
                            or dotted.startswith("numpy.")):
                        hit = sub
                    elif isinstance(f, ast.Attribute) and not sub.args \
                            and f.attr in _HOST_SYNC_ATTRS + ("asnumpy",):
                        hit = sub
                    elif isinstance(f, ast.Name) and sub.args \
                            and f.id in ("float", "int"):
                        hit = sub
                    if hit is not None:
                        break
                if hit is not None:
                    break
            if hit is not None:
                self._flag(
                    "MX313",
                    "per-leaf loop over gradients materializes host "
                    "statistics inside captured code (one device "
                    "round-trip per parameter per step); the in-graph "
                    "health stats engine computes these fused on device",
                    hit)
        self.generic_visit(node)

    def visit_JoinedStr(self, node):
        self._flag("MX302", "f-string inside captured code", node)
        # no generic_visit: one finding per f-string


# -- MX306: un-barriered wall-clock deltas around device work -----------------
# The timing footgun: `t0 = time.time(); out = step(x); dt = time.time()-t0`
# measures the ENQUEUE under asynchronous kernel launches, not execution.
# The scan is function-local and zero-FP-biased: it only fires when a
# time.time()/perf_counter() start is subtracted later in the same
# function, actual work (a non-trivial call) happens between, and nothing
# in between is barrier-shaped (a synchronize, a wait or join, a host read
# of a tensor, an event's elapsed_time). time.monotonic() is exempt
# (deadline/backoff bookkeeping, never a measurement), as are telemetry/
# and utils/profiler — the two sanctioned homes for timing.

_WALL_CLOCK_CALLS = ("time.time", "time.perf_counter")
# call-name fragments treated as blocking before the clock is read (a
# CUDA-graph capture synchronizes the card before it records, as an XLA
# compile blocks the host)
_TIMING_BARRIER_PARTS = ("block", "barrier", "wait", "sync", "join",
                         "result", "asnumpy", "compile", "capture",
                         "ready", "elapsed_time")
# calls that block by name alone: the host reads of a tensor
_TIMING_BARRIER_EXACT = ("item", "cpu", "numpy", "tolist")
# calls that are not "work being timed" on their own
_TIMING_TRIVIAL_CALLS = {
    "len", "min", "max", "int", "float", "str", "abs", "round", "sorted",
    "sum", "isinstance", "getattr", "setattr", "hasattr", "repr", "next",
    "iter", "enumerate", "zip", "range", "list", "dict", "tuple", "set",
    "print", "format", "debug", "info", "warning", "error", "exception",
    "log", "append", "items", "keys", "values", "get", "pop", "update",
}


def _exempt_timing_path(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return "/telemetry/" in p or p.endswith("utils/profiler.py") or \
        p.endswith("telemetry/__init__.py")


def _is_wall_clock_call(node, imports):
    if not isinstance(node, ast.Call):
        return False
    dotted = _dotted(node.func, imports)
    return dotted in _WALL_CLOCK_CALLS


class _FnTimingScan(ast.NodeVisitor):
    """One function body: clock-start assignments, barrier/work call lines,
    and clock-delta expressions. Nested defs/lambdas are their own scope
    and are skipped (the scan visits them separately)."""

    def __init__(self, imports):
        self.imports = imports
        self.assigns = {}        # name -> latest assignment lineno
        self.barrier_lines = []
        self.work_lines = []
        self.deltas = []         # (lineno, col, start_name)

    def visit_FunctionDef(self, node):  # separate scope
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Assign(self, node):
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name) \
                and _is_wall_clock_call(node.value, self.imports):
            self.assigns[node.targets[0].id] = node.lineno
        else:
            self.generic_visit(node)

    def visit_Call(self, node):
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", "")
        lname = name.lower()
        if _is_wall_clock_call(node, self.imports):
            pass  # reading the clock is not the work being timed
        elif any(part in lname for part in _TIMING_BARRIER_PARTS) or \
                (name in _TIMING_BARRIER_EXACT and not node.args):
            self.barrier_lines.append(node.lineno)
        elif name and name not in _TIMING_TRIVIAL_CALLS:
            self.work_lines.append(node.lineno)
        self.generic_visit(node)

    def visit_BinOp(self, node):
        if isinstance(node.op, ast.Sub) and isinstance(node.right, ast.Name):
            left_ok = _is_wall_clock_call(node.left, self.imports) or (
                isinstance(node.left, ast.Name)
                and node.left.id in self.assigns)
            if left_ok and node.right.id in self.assigns:
                self.deltas.append((node.lineno, node.col_offset,
                                    node.right.id))
        self.generic_visit(node)


def _scan_unbarriered_timing(nodes, path, imports, findings):
    if _exempt_timing_path(path):
        return
    for fn in nodes:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        scan = _FnTimingScan(imports)
        for stmt in fn.body:
            scan.visit(stmt)
        for lineno, col, start in scan.deltas:
            l0 = scan.assigns.get(start)
            if l0 is None or l0 >= lineno:
                continue
            worked = any(l0 < l < lineno for l in scan.work_lines)
            barriered = any(l0 < l < lineno for l in scan.barrier_lines)
            if worked and not barriered:
                findings.append(Finding(
                    get_rule("MX306"),
                    f"wall-clock delta `... - {start}` times dispatched "
                    "work with no barrier between start and read",
                    path=path, line=lineno, col=col))


# -- MX307: leaked StepTimeline spans / phases --------------------------------
# A span that is opened but not closed on every path poisons the trace:
# later phase() calls attach to the dead step and the cross-rank merge
# sees unterminated/overlapping spans. The scan is function-local and
# zero-FP-biased: it flags (a) a `<x>.begin_step(...)` result bound to a
# name on which `.end()` is never called anywhere in the same function
# (spans used as `with` context managers are fine — __exit__ ends them),
# (b) a bare-expression `begin_step(...)` whose span can never be ended,
# and (c) a bare-expression `telemetry.phase(...)`/`timed(...)` call —
# those return context managers; calling without `with` records nothing
# and is always a bug. telemetry/ itself (the primitives' home) is exempt.

_SPAN_OPENERS = ("begin_step",)
_CM_TIMERS = ("phase", "timed")


def _expr_name(expr):
    """The last name of a Name/Attribute expression, else None."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return getattr(expr, "id", None)


def _call_attr_name(node):
    if not isinstance(node, ast.Call):
        return None
    return _expr_name(node.func)


class _FnSpanScan(ast.NodeVisitor):
    """One function body: span-opening assignments, .end() calls, with-
    managed opens, and bare context-manager-returning calls. Nested defs
    are their own scope (the scan visits them separately)."""

    def __init__(self):
        self.opened = {}       # name -> lineno of `x = ....begin_step(...)`
        self.ended = set()     # names with `.end(` called on them
        self.bare = []         # (lineno, col, what) immediate findings

    def visit_FunctionDef(self, node):  # separate scope
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _record_open(self, target, value):
        """Bind span-opening call results (looking through ternaries:
        `span = tl.begin_step(...) if tl else None`)."""
        for v in ([value.body, value.orelse]
                  if isinstance(value, ast.IfExp) else [value]):
            if _call_attr_name(v) in _SPAN_OPENERS and \
                    isinstance(target, ast.Name):
                self.opened[target.id] = (v.lineno, v.col_offset)

    def visit_Assign(self, node):
        if len(node.targets) == 1:
            self._record_open(node.targets[0], node.value)
        self.generic_visit(node)

    def visit_Expr(self, node):
        name = _call_attr_name(node.value)
        if name in _SPAN_OPENERS:
            self.bare.append((node.lineno, node.col_offset,
                              "span from bare `begin_step(...)` call is "
                              "discarded and can never be ended"))
        elif name in _CM_TIMERS:
            self.bare.append((node.lineno, node.col_offset,
                              f"`{name}(...)` returns a context manager; "
                              "calling it without `with` records nothing"))
        self.generic_visit(node)

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "end" and \
                isinstance(f.value, ast.Name):
            self.ended.add(f.value.id)
        self.generic_visit(node)


def _with_bound_names(fn):
    """Names bound by `with ... as <name>` anywhere in the function —
    `with tl.begin_step(...) as span:` closes span via __exit__, and an
    extra span.end() is not required."""
    names = set()
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                if isinstance(item.optional_vars, ast.Name):
                    names.add(item.optional_vars.id)
    return names


def _scan_leaked_spans(nodes, path, findings):
    if _exempt_timing_path(path):
        return
    for fn in nodes:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        scan = _FnSpanScan()
        for stmt in fn.body:
            scan.visit(stmt)
        for lineno, col, what in scan.bare:
            findings.append(Finding(get_rule("MX307"), what,
                                    path=path, line=lineno, col=col))
        with_names = None
        for name, (lineno, col) in scan.opened.items():
            if name in scan.ended:
                continue
            if with_names is None:
                with_names = _with_bound_names(fn)
            if name in with_names:
                continue
            findings.append(Finding(
                get_rule("MX307"),
                f"span `{name}` opened with begin_step() but `.end()` is "
                "never called in this function (leaked spans poison the "
                "cross-rank merge)",
                path=path, line=lineno, col=col))


# -- MX309: implicit host syncs inside step loops -----------------------------
# A loop that dispatches the step AND pulls values to the host every
# iteration (`.item()`, `.cpu()`, `.numpy()`, `.asnumpy()`,
# `np.asarray(...)`) blocks the host until the card drains the queue, so
# the launch queue never runs ahead of the host and the overlapped comm
# schedule degenerates to lockstep. The scan is loop-local and
# zero-FP-biased: it only fires inside a for/while loop that visibly
# dispatches a step (a call whose name contains "step", or
# forward()/backward()), and only on the unambiguous sync shapes.
# Intentional per-step syncs carry `# mxlint: disable=MX309` with a
# justification. telemetry/ and utils/profiler are exempt, as for MX306.

_STEP_DISPATCH_PARTS = ("step",)
_STEP_DISPATCH_EXACT = ("forward", "backward")
_HOST_PULL_ATTRS = ("asnumpy", "item", "cpu", "numpy", "tolist")
_HOST_PULL_NUMPY = ("numpy.asarray", "numpy.array", "numpy.ascontiguousarray")


def _is_step_dispatch(node):
    name = _call_attr_name(node)
    if not name:
        return False
    lname = name.lower()
    return lname in _STEP_DISPATCH_EXACT or \
        any(part in lname for part in _STEP_DISPATCH_PARTS)


def _iter_loop_body_nodes(loop):
    """Walk a loop's immediate body: nested defs/lambdas are their own
    scope and nested loops are their own *step loop* (each is judged on
    its own dispatch) — so a once-per-epoch pull after an inner batch
    loop is not blamed on the steps inside it."""
    stack = list(loop.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.For, ast.AsyncFor, ast.While)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _scan_step_loop_syncs(nodes, path, imports, findings):
    if _exempt_timing_path(path):
        return
    seen = set()  # (line, col): overlapping scopes must not double-report
    for loop in nodes:
        if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
            continue
        calls = [n for n in _iter_loop_body_nodes(loop)
                 if isinstance(n, ast.Call)]
        if not any(_is_step_dispatch(c) for c in calls):
            continue
        for call in calls:
            loc = (call.lineno, call.col_offset)
            if loc in seen:
                continue
            f = call.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in _HOST_PULL_ATTRS and not call.args:
                seen.add(loc)
                findings.append(Finding(
                    get_rule("MX309"),
                    f"`.{f.attr}()` inside a step-dispatching loop blocks "
                    "the host on a device transfer every iteration",
                    path=path, line=call.lineno, col=call.col_offset))
                continue
            dotted = _dotted(f, imports)
            if dotted in _HOST_PULL_NUMPY:
                seen.add(loc)
                findings.append(Finding(
                    get_rule("MX309"),
                    f"`{dotted}(...)` inside a step-dispatching loop "
                    "forces a device-to-host copy every iteration",
                    path=path, line=call.lineno, col=call.col_offset))
                continue
            # float(x)/int(x) on a bare name: the classic scalar pull
            # (loss = float(out)); attribute/subscript args stay exempt —
            # shapes/pads etc. are host metadata, not device values
            if isinstance(f, ast.Name) and f.id in ("float", "int") and \
                    len(call.args) == 1 and \
                    isinstance(call.args[0], ast.Name):
                seen.add(loc)
                findings.append(Finding(
                    get_rule("MX309"),
                    f"`{f.id}({call.args[0].id})` inside a "
                    "step-dispatching loop forces a scalar device-to-host "
                    "sync every iteration",
                    path=path, line=call.lineno, col=call.col_offset))


# -- MX310: world-size literals frozen into closures --------------------------
# The elastic-staleness bug class: `ndev = 8` in an outer scope, captured
# by a nested step/placement function — after a mid-run resize the closure
# keeps computing with the dead world's size. The scan is function-local
# and zero-FP-biased: it fires only when (a) an enclosing function binds a
# world/axis-size-NAMED variable to an INTEGER LITERAL and (b) a nested
# def/lambda reads that name as a free variable. Sizes derived from live
# objects (`mesh.shape["dp"]`, `kv.num_workers`, `coordinator.world_size`)
# are not literals, so the healthy idiom never flags. The mesh/coordinator
# providers themselves (parallel/mesh.py, resilience/elastic.py) are
# exempt — defining the world is their job.

_WORLD_SIZE_NAMES = frozenset({
    "world_size", "num_workers", "axis_size", "ndev", "num_devices",
    "n_workers", "n_devices", "nproc"})
_MX310_EXEMPT_FILES = ("mesh.py", "elastic.py")


def _scan_world_literal_closures(nodes, path, findings):
    base = os.path.basename(os.path.normpath(path))
    if base in _MX310_EXEMPT_FILES:
        return
    for fn in nodes:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # world-size names this scope binds to plain integer literals
        # (only statements local to fn — nested defs are their own scope)
        literal_bound = {}
        for node in _iter_local_nodes(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets = [t for t in node.targets if isinstance(t, ast.Name)]
                value = node.value
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                targets = [node.target]
                value = node.value
            else:
                continue
            if not (isinstance(value, ast.Constant)
                    and type(value.value) is int):
                continue
            for t in targets:
                if t.id.lower() in _WORLD_SIZE_NAMES:
                    literal_bound[t.id] = node.lineno
        if not literal_bound:
            continue
        for nested in ast.walk(fn):
            if nested is fn or not isinstance(
                    nested, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
                continue
            a = nested.args
            bound_inner = {p.arg for p in a.args + a.posonlyargs
                           + a.kwonlyargs}
            if a.vararg is not None:
                bound_inner.add(a.vararg.arg)
            if a.kwarg is not None:
                bound_inner.add(a.kwarg.arg)
            for sub in ast.walk(nested):
                if isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, ast.Store):
                    bound_inner.add(sub.id)
            for sub in ast.walk(nested):
                if isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, ast.Load) and \
                        sub.id in literal_bound and \
                        sub.id not in bound_inner:
                    findings.append(Finding(
                        get_rule("MX310"),
                        f"closure captures `{sub.id}` bound to an integer "
                        f"literal at line {literal_bound[sub.id]} — a "
                        f"world/axis size frozen at build time goes stale "
                        f"when the elastic world resizes",
                        path=path, line=sub.lineno, col=sub.col_offset))
                    break  # one finding per closure is enough


def _iter_local_nodes(fn):
    """Walk a scope's body without descending into nested defs/lambdas."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# -- MX312: kernel-layer discipline -------------------------------------------
# Two shapes of the same drift: a CUDA or Triton kernel built outside
# mxnet_tpu_torch/kernels/ (torch.utils.cpp_extension.load/load_inline,
# @triton.jit), or a launch counted there (count_launch), escapes the
# kernel layer's route by device, its launch counts and the registry; a
# kernel module inside the layer that launches but never calls
# registry.register_kernel leaves its kernel unpriced — the MFU count and
# every bound silently under-count it. Zero-FP-biased: only those literal
# call sites fire, and in-layer modules are excused by ANY register_kernel
# call (the name<->model pairing is enforced by the tests, not the lint).

_CPP_EXTENSION_BUILDS = ("torch.utils.cpp_extension.load",
                         "torch.utils.cpp_extension.load_inline")
_TRITON_JIT = "triton.jit"
# the kernel layer's own launch and build sites (kernels/_common.py)
_LAYER_LAUNCHES = ("count_launch",)
_LAYER_BUILDS = ("load_library",)


def _kernels_scoped(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return "kernels" in parts[:-1]


def _scan_kernel_discipline(nodes, path, imports, findings):
    emitted, registers = [], False   # (node, what, outside-layer kind)
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if _dotted(target, imports) == _TRITON_JIT:
                    emitted.append((dec, "@triton.jit kernel", True))
        if not isinstance(node, ast.Call):
            continue
        name = _call_attr_name(node)
        dotted = _dotted(node.func, imports)
        if name == "register_kernel":
            registers = True
        elif dotted in _CPP_EXTENSION_BUILDS:
            emitted.append((node, f"`{dotted}` build", True))
        elif dotted == _TRITON_JIT:
            emitted.append((node, "`triton.jit` kernel", True))
        elif name in _LAYER_LAUNCHES:
            emitted.append((node, f"`{name}` launch", True))
        elif name in _LAYER_BUILDS:
            emitted.append((node, f"`{name}` build", False))
    if not emitted:
        return
    emitted.sort(key=lambda e: (e[0].lineno, e[0].col_offset))
    if not _kernels_scoped(path):
        for node, what, outside in emitted:
            if not outside:
                continue  # the layer's loader, called from outside it
            findings.append(Finding(
                get_rule("MX312"),
                f"{what} outside mxnet_tpu_torch/kernels/ — kernels live "
                "in the kernel layer (route by device, launch counts, "
                "registry cost model, bounds)",
                path=path, line=node.lineno, col=node.col_offset))
        return
    if not registers:
        node, what, _ = emitted[0]
        findings.append(Finding(
            get_rule("MX312"),
            f"kernel module has a {what} but never registers a FLOP/byte "
            "model (registry.register_kernel) — the MFU count and the "
            "bounds will under-count it",
            path=path, line=node.lineno, col=node.col_offset))


# -- MX311: fleet actuation outside the policy loop ---------------------------
# Actuation must flow through resilience/controller.py so every
# membership/tier change carries the controller's safety rails
# (hysteresis, cooldowns, dry-run, breaker) and lands in the decision log.
# The scan is zero-FP-biased: `.request_world(` and
# `.set_gradient_compression(` are distinctive enough to flag anywhere in
# scope; `.kill(` only fires when the receiver's name says coordinator
# (`co`, `*coord*`, `*elastic*` — `os.kill` / `proc.kill` never match).
# Definition sites are exempt (controller.py IS the policy loop,
# elastic.py OWNS the lever), as are tests, examples, and lint fixtures;
# intentional out-of-loop sites carry `# mxlint: disable=MX311` with a
# justification.

_MX311_METHODS = frozenset({"kill", "request_world",
                            "set_gradient_compression"})
_MX311_EXEMPT_FILES = ("controller.py", "elastic.py")


def _owner_exempt(path: str, owners=()) -> bool:
    """Tests, examples and lint fixtures, and the rule's owner files."""
    norm = os.path.normpath(path)
    parts = norm.split(os.sep)
    if any(p in ("tests", "examples", "fixtures") for p in parts):
        return True
    base = os.path.basename(norm)
    return base in owners or base.startswith("test_")


def _mx311_receiver_is_coordinator(func: ast.Attribute) -> bool:
    recv = func.value
    name = None
    if isinstance(recv, ast.Name):
        name = recv.id
    elif isinstance(recv, ast.Attribute):
        name = recv.attr
    if name is None:
        return False
    low = name.lower()
    return low == "co" or "coord" in low or "elastic" in low


def _scan_fleet_actuation(nodes, path, findings):
    if _owner_exempt(path, _MX311_EXEMPT_FILES):
        return
    for node in nodes:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        name = node.func.attr
        if name not in _MX311_METHODS:
            continue
        if name == "kill" and \
                not _mx311_receiver_is_coordinator(node.func):
            continue  # os.kill / process.kill are not fleet actuation
        recv = node.func.value
        if isinstance(recv, ast.Call) and \
                getattr(recv.func, "id", None) == "super":
            continue  # an override delegating to its base is not a site
        findings.append(Finding(
            get_rule("MX311"),
            f"direct fleet actuation `.{name}(...)` outside "
            "resilience/controller.py — membership/compression-tier "
            "changes must flow through the FleetController policy loop "
            "(hysteresis, cooldowns, dry-run, breaker, decision log)",
            path=path, line=node.lineno, col=node.col_offset))


# -- MX314: raw torch profiler captures outside the profiling layer -----------
# Every capture flows through telemetry/profiling.py (hub events for the
# JSONL stream, soft failure on concurrent windows, `profile` badput
# pricing) or the utils/profiler wrappers over it. Two shapes of drift:
# (a) a literal torch profiler entry point — torch.profiler.profile,
# torch.autograd.profiler.profile / emit_nvtx, torch.cuda.profiler.start /
# stop / profile — outside the two owner modules; (b) ANY
# `start_trace(...)`/`start_capture(...)` call — the sanctioned wrappers
# included — in a function with no finally-guarded stop, which leaks a
# running process-global trace past the first exception. Zero-FP-biased:
# (a) only fires when the call resolves through the module's imports to
# one of those torch paths; tests, examples, and fixtures are exempt.

_MX314_OWNER_FILES = ("profiler.py", "profiling.py")
_RAW_PROFILER_CALLS = frozenset({
    "torch.profiler.profile", "torch.profiler.profiler.profile",
    "torch.profiler._KinetoProfile",
    "torch.autograd.profiler.profile", "torch.autograd.profiler.emit_nvtx",
    "torch.autograd.profiler.emit_itt",
    "torch.autograd.profiler_legacy.profile",
    "torch.cuda.profiler.start", "torch.cuda.profiler.stop",
    "torch.cuda.profiler.profile"})


def _scan_profiler_discipline(tree, nodes, path, imports, findings):
    if _owner_exempt(path, _MX314_OWNER_FILES):
        return
    flagged: set = set()
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func, imports)
        if dotted not in _RAW_PROFILER_CALLS:
            continue
        flagged.add(id(node))
        findings.append(Finding(
            get_rule("MX314"),
            f"raw `{dotted}` outside utils/profiler.py / "
            "telemetry/profiling.py — captures flow through "
            "telemetry.profiling (hub events, `profile` badput pricing, "
            "safe behavior under concurrent windows)",
            path=path, line=node.lineno, col=node.col_offset))

    # (b) start_trace/start_capture calls owned by their INNERMOST
    # function scope; a scope is clean when any finally block in IT stops
    # the trace. Nested defs always open a fresh scope — including defs
    # that sit inside a try/finally body, whose deferred bodies run long
    # after the outer finally fired.
    scope_starts: dict = {}
    scope_guarded: dict = {}

    def child_walk(child, scope, in_finally):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            walk(child, id(child), False)
        else:
            walk(child, scope, in_finally)

    def walk(node, scope, in_finally):
        if isinstance(node, ast.Call):
            name = _call_attr_name(node)
            if name in ("start_trace", "start_capture"):
                scope_starts.setdefault(scope, []).append((node, name))
            elif name in ("stop_trace", "stop_capture") and in_finally:
                scope_guarded[scope] = True
        if isinstance(node, ast.Try):
            for child in node.body + node.orelse + node.handlers:
                child_walk(child, scope, in_finally)
            for child in node.finalbody:
                child_walk(child, scope, True)
            return
        for child in ast.iter_child_nodes(node):
            child_walk(child, scope, in_finally)

    walk(tree, id(tree), False)
    for scope, calls in scope_starts.items():
        if scope_guarded.get(scope):
            continue
        for call, name in calls:
            if id(call) in flagged:
                continue  # already reported as a raw capture above
            findings.append(Finding(
                get_rule("MX314"),
                f"`{name}` without a finally-guarded stop in the same "
                "function — an exception leaks the process-global running "
                "trace and every later capture fails (use "
                "telemetry.profiling.capture(), or stop in a `finally`)",
                path=path, line=call.lineno, col=call.col_offset))


# -- MX315: direct sharded-checkpoint writes outside the checkpoint plane -----
# Every durable write flows through utils/checkpoint.py (tmp-dir staging +
# CRC manifest + atomic rename) driven by resilience/ckpt_async.py (writer
# thread, flush barriers, keep-last-k GC, `checkpoint` badput pricing). A
# `save_sharded(...)` call anywhere else can interleave with an in-flight
# async write of the same step id and never shows up in the telemetry
# gauges. Zero-FP-biased: fires on the bare call names only (Name or
# Attribute receiver — `ckpt.save_sharded(...)` included); loads, reads
# and `load_resharded` never match; tests/examples/fixtures exempt.

_MX315_OWNER_FILES = ("checkpoint.py", "ckpt_async.py")
_MX315_WRITE_NAMES = ("save_sharded", "_save_sharded", "_write_manifest")


def _scan_checkpoint_discipline(nodes, path, findings):
    if _owner_exempt(path, _MX315_OWNER_FILES):
        return
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        name = _call_attr_name(node)
        if name not in _MX315_WRITE_NAMES:
            continue
        findings.append(Finding(
            get_rule("MX315"),
            f"direct `{name}` outside utils/checkpoint.py / "
            "resilience/ckpt_async.py — the checkpoint plane owns "
            "durability ordering (tmp staging, CRC commit, retention GC, "
            "writer flush barriers) and the `checkpoint` badput pricing; "
            "route through ckpt_async.save_now or "
            "AsyncCheckpointWriter.submit",
            path=path, line=node.lineno, col=node.col_offset))


# -- MX316: run-ledger discipline ---------------------------------------------
# Every RunRecord flows through telemetry/ledger.py: distill() owns the
# schema, append_record() the atomic one-file-per-record write (tmp +
# rename + CRC sidecar via utils.checkpoint.atomic_write) and the
# `run_summary` announcement event. A module that reads
# MXNET_TPU_LEDGER_DIR itself (to write its own files there) or emits its
# own `run_summary` events produces history the trend/compare gates cannot
# read. Zero-FP-biased: fires only on (a) an `emit`/`.emit` call whose
# first positional argument is the literal "run_summary", and (b) an
# os.environ get/[] whose key is the literal "MXNET_TPU_LEDGER_DIR" —
# `monkeypatch.setenv` and docstrings never match; owner + tests exempt.

_MX316_OWNER_FILES = ("ledger.py",)
_MX316_ENV_KEY = "MXNET_TPU_LEDGER_DIR"
_MX316_ENV_GETTERS = ("get", "getenv", "pop", "setdefault")


def _const_eq(node, value) -> bool:
    return isinstance(node, ast.Constant) and node.value == value


def _scan_ledger_discipline(nodes, path, findings):
    if _owner_exempt(path, _MX316_OWNER_FILES):
        return
    for node in nodes:
        if isinstance(node, ast.Subscript):
            # os.environ["MXNET_TPU_LEDGER_DIR"] in any read/write position
            if _const_eq(getattr(node, "slice", None), _MX316_ENV_KEY):
                findings.append(Finding(
                    get_rule("MX316"),
                    f"direct `{_MX316_ENV_KEY}` subscript outside "
                    "telemetry/ledger.py — resolve the store through "
                    "telemetry.ledger.ledger_dir() so every record lands "
                    "via the atomic CRC'd writer",
                    path=path, line=node.lineno, col=node.col_offset))
            continue
        if not isinstance(node, ast.Call):
            continue
        name = _call_attr_name(node)
        if name == "emit" and node.args and \
                _const_eq(node.args[0], "run_summary"):
            findings.append(Finding(
                get_rule("MX316"),
                "hand-rolled `run_summary` emission outside "
                "telemetry/ledger.py — the ledger announces each append "
                "itself (append_record); a duplicate summary event skews "
                "the golden-key stream and incident counts",
                path=path, line=node.lineno, col=node.col_offset))
        elif name in _MX316_ENV_GETTERS and node.args and \
                _const_eq(node.args[0], _MX316_ENV_KEY):
            findings.append(Finding(
                get_rule("MX316"),
                f"direct `{_MX316_ENV_KEY}` consultation outside "
                "telemetry/ledger.py — resolve the store through "
                "telemetry.ledger.ledger_dir() (one writer, one reader "
                "discipline; see telemetry/ledger.py)",
                path=path, line=node.lineno, col=node.col_offset))


# calls whose presence inside a retry loop counts as bounding it: anything
# sleep/backoff/wait-shaped (time.sleep, policy backoff, cv.wait_for, ...)
_BOUNDING_CALL_PARTS = ("sleep", "backoff", "wait", "delay", "retry_call",
                        "monotonic", "deadline")


def _is_bounding_call(node: ast.Call) -> bool:
    name = _call_attr_name(node)
    return name is not None and \
        any(part in name.lower() for part in _BOUNDING_CALL_PARTS)


def _handler_escapes(handler: ast.ExceptHandler) -> bool:
    """True when the handler leaves the loop (raise/return/break at its
    top level) — that's failure propagation, not a retry."""
    return any(isinstance(s, (ast.Raise, ast.Return, ast.Break))
               for s in handler.body)


def _handler_is_swallow(handler: ast.ExceptHandler) -> bool:
    """True when the handler does nothing but spin: only pass/continue/
    logging — the shape of a blind retry. Handlers doing real work (e.g.
    replying on a socket) are an event loop, not a retry loop."""
    for s in handler.body:
        if isinstance(s, (ast.Pass, ast.Continue)):
            continue
        if isinstance(s, ast.Expr) and isinstance(s.value, ast.Call):
            if _call_attr_name(s.value) in ("debug", "info", "warning",
                                            "error", "exception", "print",
                                            "log"):
                continue
        return False
    return True


def _scan_robustness(nodes, path: str, findings: list):
    """MX601 bare excepts; MX602 unbounded retry loops (while True +
    exception-swallowing handler + no sleep/backoff/deadline in the loop)."""
    for node in nodes:
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            findings.append(Finding(
                get_rule("MX601"), "bare `except:` clause",
                path=path, line=node.lineno, col=node.col_offset))
        if isinstance(node, ast.While) and \
                isinstance(node.test, ast.Constant) and node.test.value is True:
            bounded = any(isinstance(sub, ast.Call) and _is_bounding_call(sub)
                          for sub in ast.walk(node))
            if bounded:
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Try):
                    retrying = [h for h in sub.handlers
                                if not _handler_escapes(h)
                                and _handler_is_swallow(h)]
                    if retrying:
                        findings.append(Finding(
                            get_rule("MX602"),
                            "`while True` retry loop swallows exceptions "
                            "with no backoff/deadline/attempt bound",
                            path=path, line=node.lineno,
                            col=node.col_offset))
                        break


# -- MX805: sharding placement outside the parallel/comm owner layers ---------
# Placement decisions — torch.distributed.tensor's distribute_tensor /
# DTensor.from_local, and cutting a rank's block with a
# parallel.mesh.Sharding built on the spot (`Sharding(...).shard(x)`) —
# must live in parallel/ or comm/, where the mesh and the comm plan can
# account for them. A stray placement elsewhere silently changes the
# collectives a step runs out from under the MX802 reconciliation.
# Shardings a model declares (`param_shardings`) and the owners' helpers
# (`shard_batch`, `replicate_params`) never match. Intentional sites carry
# `# mxlint: disable=MX805` with a reason.

_MX805_OWNER_DIRS = ("parallel", "comm")
_MX805_RAW_PLACEMENT = ("distribute_tensor", "distribute_module")
_MX805_SHARDING_CTORS = ("Sharding", "data_sharding")


def _mx805_exempt(path: str) -> bool:
    norm = os.path.normpath(path)
    parts = norm.split(os.sep)
    if any(p in _MX805_OWNER_DIRS for p in parts[:-1]):
        return True
    return _owner_exempt(path)


def _contains_sharding_ctor(node) -> bool:
    return any(isinstance(sub, ast.Call)
               and _call_attr_name(sub) in _MX805_SHARDING_CTORS
               for sub in ast.walk(node))


def _scan_placement_discipline(nodes, path, findings):
    if _mx805_exempt(path):
        return
    # names assigned from any expression that builds a Sharding — covers
    # `sh = Sharding(...)`, dict/list comprehensions of them, and
    # `shardings = {k: Sharding(...) for ...}` later subscripted
    sharding_names: set = set()
    for node in nodes:
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                node.value is not None and \
                _contains_sharding_ctor(node.value):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    sharding_names.add(t.id)
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        name = _call_attr_name(node)
        f = node.func
        if name in _MX805_RAW_PLACEMENT or (
                name == "from_local" and _expr_name(f.value) == "DTensor"):
            findings.append(Finding(
                get_rule("MX805"),
                f"raw `{name}` outside parallel//comm/ — placement belongs "
                "to the mesh layer so the comm plan (and the MX802 "
                "reconciliation) can account for it",
                path=path, line=node.lineno, col=node.col_offset))
            continue
        if name != "shard" or not isinstance(f, ast.Attribute):
            continue
        recv = f.value
        placed = _contains_sharding_ctor(recv)
        if isinstance(recv, ast.Name) and recv.id in sharding_names:
            placed = True
        if isinstance(recv, ast.Subscript) and \
                isinstance(recv.value, ast.Name) and \
                recv.value.id in sharding_names:
            placed = True
        if placed:
            findings.append(Finding(
                get_rule("MX805"),
                "`.shard(...)` through a Sharding built outside "
                "parallel//comm/ — sharded placement belongs to the owner "
                "layers the comm plan audits",
                path=path, line=node.lineno, col=node.col_offset))


def _suppressed(finding: Finding, lines: list[str]) -> bool:
    if not 1 <= finding.line <= len(lines):
        return False
    line = lines[finding.line - 1]
    if "# mxlint:" not in line:
        return False
    pragma = line.split("# mxlint:", 1)[1].strip()
    if pragma.startswith("disable"):
        _, _, ids = pragma.partition("=")
        if not ids.strip():
            return True
        # `disable=MX704 - justification` / `disable=MX701,MX704 reason`:
        # an id token ends at the first whitespace, so an inline
        # justification (the MX70x audit-record discipline) parses clean
        tokens = set()
        for part in ids.split(","):
            part = part.strip()
            if part:
                tokens.add(part.split()[0])
        return finding.rule.id in tokens
    return False


def lint_source(text: str, path: str = "<string>") -> list[Finding]:
    """Lint one Python source string; returns findings (pragma-filtered)."""
    lines = text.splitlines()
    if any("# mxlint: skip-file" in ln for ln in lines[:5]):
        return []
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as e:
        f = Finding(get_rule("MX100"),
                    f"file does not parse: {e.msg}", path=path,
                    line=e.lineno or 0, col=e.offset or 0)
        return [f]

    scan = _ModuleScan(path)
    scan.visit(tree)
    nodes = list(ast.walk(tree))  # one walk, shared by the scans
    _scan_robustness(nodes, path, scan.findings)
    _scan_unbarriered_timing(nodes, path, scan.imports, scan.findings)
    _scan_leaked_spans(nodes, path, scan.findings)
    _scan_step_loop_syncs(nodes, path, scan.imports, scan.findings)
    _scan_world_literal_closures(nodes, path, scan.findings)
    _scan_fleet_actuation(nodes, path, scan.findings)
    _scan_kernel_discipline(nodes, path, scan.imports, scan.findings)
    _scan_profiler_discipline(tree, nodes, path, scan.imports, scan.findings)
    _scan_checkpoint_discipline(nodes, path, scan.findings)
    _scan_ledger_discipline(nodes, path, scan.findings)
    _scan_placement_discipline(nodes, path, scan.findings)

    # captured roots: lambdas and defs given to a capture entry point,
    # then `with torch.cuda.graph(...)` bodies
    roots = [(r, None) for r in scan.captured_lambdas]
    roots += [(d, None) for d in scan.captured_defs()]
    roots += scan.captured_blocks
    visited: set[int] = set()
    for root, params in roots:
        if id(root) in visited:
            continue
        for sub in ast.walk(root):
            visited.add(id(sub))
        if params is None:
            params = _fn_params(root)
        if isinstance(root, ast.Lambda):
            _CapturedWalk(scan, params).visit(root)
        else:
            _CapturedWalk(scan, params).visit(
                ast.Module(body=root.body, type_ignores=[]))

    return [f for f in scan.findings if not _suppressed(f, lines)]


def lint_file(path: str) -> list[Finding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


def iter_python_files(paths):
    """Expand files/directories into .py files, deterministic order."""
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS)
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)
        else:
            yield p


def lint_paths(paths) -> list[Finding]:
    findings = []
    for f in iter_python_files(paths):
        if f.endswith(".py"):
            findings.extend(lint_file(f))
    return findings
