"""The port's concurrency lint (``mxnet_tpu_torch/analysis/concurrency.py``,
MX701-MX705) against the JAX package's.

- Fixture parity: the JAX package's MX70x fixtures (``tests/test_mxlint.py``
  and ``tests/test_concurrency.py``) through both packages'
  ``concurrency.lint_source`` give the same ``(rule, line, col)`` list, and
  the cycle the same locks; the port's lockwatch factories count as lock
  constructors, as the JAX package's do.
- Tree parity: over the JAX package's tree and the port's, with every
  pragma switched off, both passes give the same findings (id, path,
  line), the cross-module lock-order graph merged over the tree.
- The self-lint: the port's tree lints MX701-MX705 clean; each handoff the
  model cannot see carries a justified pragma.
"""

import os

import pytest

from mxnet_tpu.analysis import concurrency as jc
from mxnet_tpu_torch.analysis import concurrency as tc
from mxnet_tpu_torch.analysis import concurrency_lint_paths
from mxnet_tpu_torch.analysis import concurrency_lint_source
from mxnet_tpu_torch.analysis.source_lint import iter_python_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rlc(findings):
    return [(f.rule.id, f.line, f.col) for f in findings]


_COUNTER = (
    "import threading\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self.count = 0\n"
    "        self._t = threading.Thread(target=self._work,\n"
    "                                   daemon=True)\n")

# name -> (source, the expected rule ids)
FIXTURES = {
    "mx701_unlocked_shared_attr": (
        _COUNTER +
        "    def _work(self):\n"
        "        self.count += 1\n"
        "    def bump(self):\n"
        "        self.count += 1\n", ["MX701"]),
    "mx701_common_lock": (
        _COUNTER +
        "    def _work(self):\n"
        "        with self._lock:\n"
        "            self.count += 1\n"
        "    def bump(self):\n"
        "        with self._lock:\n"
        "            self.count += 1\n", []),
    "mx701_weakref_callback_mutator": (
        "import threading\n"
        "import weakref\n"
        "class Ledger:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.rows = []\n"
        "    def add(self, arr):\n"
        "        ref = weakref.ref(arr, self._on_dead)\n"
        "        self.rows.append(ref)\n"
        "    def _on_dead(self, ref):\n"
        "        self.rows.remove(ref)\n", ["MX701"]),
    "mx701_private_helper_under_lock": (
        _COUNTER.replace("count", "n") +
        "    def _bump_locked(self):\n"
        "        self.n += 1\n"
        "    def _work(self):\n"
        "        with self._lock:\n"
        "            self._bump_locked()\n"
        "    def bump(self):\n"
        "        with self._lock:\n"
        "            self._bump_locked()\n", []),
    "mx701_pool_submit_method": (
        "import threading\n"
        "from concurrent.futures import ThreadPoolExecutor\n"
        "class K:\n"
        "    def __init__(self):\n"
        "        self._pool = ThreadPoolExecutor(1)\n"
        "        self._codec = None\n"
        "    def push(self, kvs):\n"
        "        self._codec = encode(kvs)\n"
        "    def push_async(self, kvs):\n"
        "        return self._pool.submit(self.push, kvs)\n"
        "    def reset(self):\n"
        "        self._codec = None\n", ["MX701"]),
    "mx701_global": (
        "import threading\n"
        "STATE = 0\n"
        "def work():\n"
        "    global STATE\n"
        "    STATE += 1\n"
        "def main():\n"
        "    global STATE\n"
        "    threading.Thread(target=work, daemon=True).start()\n"
        "    STATE = 0\n", ["MX701"]),
    "mx702_inversion": (
        "import threading\n"
        "A = threading.Lock()\n"
        "B = threading.Lock()\n"
        "def f():\n"
        "    with A:\n"
        "        with B:\n"
        "            pass\n"
        "def g():\n"
        "    with B:\n"
        "        with A:\n"
        "            pass\n", ["MX702"]),
    "mx702_consistent_order": (
        "import threading\n"
        "A = threading.Lock()\n"
        "B = threading.Lock()\n"
        "def f():\n"
        "    with A:\n"
        "        with B:\n"
        "            pass\n"
        "def g():\n"
        "    with A:\n"
        "        with B:\n"
        "            pass\n", []),
    "mx702_call_hop": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._a = threading.Lock()\n"
        "        self._b = threading.Lock()\n"
        "    def _take_b(self):\n"
        "        with self._b:\n"
        "            pass\n"
        "    def f(self):\n"
        "        with self._a:\n"
        "            self._take_b()\n"
        "    def g(self):\n"
        "        with self._b:\n"
        "            with self._a:\n"
        "                pass\n", ["MX702"]),
    "mx703_bare_wait": (
        "import threading\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self.lock = threading.Lock()\n"
        "        self.cv = threading.Condition(self.lock)\n"
        "    def bad(self):\n"
        "        with self.cv:\n"
        "            self.cv.wait()\n", ["MX703"]),
    "mx703_wait_for_and_loop": (
        "import threading\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self.lock = threading.Lock()\n"
        "        self.cv = threading.Condition(self.lock)\n"
        "        self.ready = False\n"
        "    def ok1(self):\n"
        "        with self.cv:\n"
        "            self.cv.wait_for(lambda: self.ready)\n"
        "    def ok2(self):\n"
        "        with self.cv:\n"
        "            while not self.ready:\n"
        "                self.cv.wait()\n", []),
    "mx704_unjoined": (
        "import threading\n"
        "def spawn():\n"
        "    t = threading.Thread(target=print)\n"
        "    t.start()\n", ["MX704"]),
    "mx704_daemon_or_joined": (
        "import threading\n"
        "def ok1():\n"
        "    threading.Thread(target=print, daemon=True).start()\n"
        "def ok2():\n"
        "    t = threading.Thread(target=print)\n"
        "    t.start()\n"
        "    t.join()\n"
        "class C:\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=print)\n"
        "        self._t.start()\n"
        "    def stop(self):\n"
        "        self._t.join()\n", []),
    "mx705_fresh_lock": (
        "import threading\n"
        "class R:\n"
        "    def reset(self):\n"
        "        with getattr(self, '_lock', threading.Lock()):\n"
        "            self.x = 1\n"
        "def direct():\n"
        "    with threading.Lock():\n"
        "        pass\n", ["MX705", "MX705"]),
    "mx705_reused_lock": (
        "import threading\n"
        "class R:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def reset(self):\n"
        "        with self._lock:\n"
        "            self.x = 1\n", []),
    "mx70x_pragma": (
        "import threading\n"
        "def spawn():\n"
        "    t = threading.Thread(target=print)  "
        "# mxlint: disable=MX704 - joined by the caller\n"
        "    t.start()\n", []),
    "mx70x_skip_file": (
        "# mxlint: skip-file\n"
        "import threading\n"
        "def spawn():\n"
        "    t = threading.Thread(target=print)\n"
        "    t.start()\n", []),
    "lockwatch_factory_is_a_lock": (
        "from mxnet_tpu_torch.analysis.lockwatch import named_condition, "
        "named_lock\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self.lock = named_lock('s')\n"
        "        self.cv = named_condition('s.cv', self.lock)\n"
        "    def bad(self):\n"
        "        with self.cv:\n"
        "            self.cv.wait()\n", ["MX703"]),
    "lockwatch_rlock_factory": (
        "from mxnet_tpu_torch.analysis.lockwatch import named_rlock\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._m = named_rlock('s')\n"
        "        self.n = 0\n"
        "        self._t = threading.Thread(target=self._work,\n"
        "                                   daemon=True)\n"
        "    def _work(self):\n"
        "        with self._m:\n"
        "            self.n += 1\n"
        "    def bump(self):\n"
        "        with self._m:\n"
        "            self.n += 1\n", []),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_parity(name):
    src, want = FIXTURES[name]
    j = jc.lint_source(src, "fx.py")
    t = tc.lint_source(src, "fx.py")
    assert [f.rule.id for f in j] == want
    assert _rlc(t) == _rlc(j)
    assert [f.extra for f in t] == [f.extra for f in j]
    assert _rlc(concurrency_lint_source(src, "fx.py")) == _rlc(t)


def test_static_inversion_names_its_locks():
    src, _ = FIXTURES["mx702_inversion"]
    (f,) = tc.lint_source(src, "fx.py")
    assert "fx.A" in f.extra["cycle"] and "fx.B" in f.extra["cycle"]


def test_hub_lock_summary_names_the_ports_hub():
    """Emitting telemetry while holding a lock orders that lock before the
    port's hub lock, the lock the hub's own module builds."""
    assert tc._HUB_LOCK_ID == "mxnet_tpu_torch.telemetry.hub.MetricsHub._lock"
    hub = os.path.join(REPO, "mxnet_tpu_torch", "telemetry", "hub.py")
    with open(hub, encoding="utf-8") as fh:
        text = fh.read()
    model = tc.module_model(__import__("ast").parse(text), hub)
    assert model.modq + ".MetricsHub._lock" == tc._HUB_LOCK_ID
    assert "_lock" in model.classes["MetricsHub"].lock_attrs
    src = (
        "import threading\n"
        "from mxnet_tpu_torch import telemetry\n"
        "L = threading.Lock()\n"
        "def f():\n"
        "    with L:\n"
        "        telemetry.emit('x')\n")
    _, edges = tc._analyze_source(src, "fx.py")
    assert [(a, b) for a, b, _, _ in edges] == [("fx.L", tc._HUB_LOCK_ID)]


# -- tree parity: both passes over both trees, every pragma switched off ------

def _raw(conc, root):
    """The pass over every file under ``root``, pragmas off: (rule, path
    relative to the repo, line), MX702 over the merged edge set."""
    findings, edges = [], []
    for path in iter_python_files([root]):
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        if any("# mxlint: skip-file" in ln for ln in text.splitlines()[:5]):
            continue
        found, mod_edges = conc._analyze_source(text, path)
        findings += found
        edges += mod_edges
    findings += conc._mx702_findings(edges)
    return sorted((f.rule.id, os.path.relpath(f.path, REPO), f.line)
                  for f in findings)


@pytest.fixture(scope="module", params=["mxnet_tpu", "mxnet_tpu_torch"])
def tree(request):
    root = os.path.join(REPO, request.param)
    return request.param, _raw(jc, root), _raw(tc, root)


def test_tree_parity(tree):
    name, j, t = tree
    assert t == j, name


def test_tree_parity_sees_the_handoffs(tree):
    """Pragmas off, the port's tree shows the two overlap-schedule
    handoffs its pragmas justify; the JAX package's tree has none."""
    name, j, _ = tree
    if name == "mxnet_tpu":
        assert j == []
    else:
        assert [(r, os.path.basename(p)) for r, p, _ in j] == [
            ("MX701", "overlap.py"), ("MX701", "overlap.py")]


# -- the self-lint -------------------------------------------------------------

def test_self_lint_concurrency_clean():
    """The port's tree lints MX701-MX705 clean (fixed or pragma'd with a
    justification), as tests/test_mxlint.py holds the JAX package's."""
    findings = [f for f in concurrency_lint_paths(
        [os.path.join(REPO, "mxnet_tpu_torch")])
        if f.rule.id.startswith("MX70")]
    assert not findings, "\n".join(f.format() for f in findings)


def test_handoff_pragmas_carry_a_justification():
    path = os.path.join(REPO, "mxnet_tpu_torch", "comm", "overlap.py")
    with open(path, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    sites = [i for i, ln in enumerate(lines) if "disable=MX701" in ln]
    assert len(sites) == 2
    # the comment above them says why
    assert "handoffs, not races" in lines[sites[0] - 2] + lines[sites[0] - 1]
