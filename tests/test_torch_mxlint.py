"""The port's source lint (``mxnet_tpu_torch/analysis/source_lint.py``)
against the JAX package's (``mxnet_tpu/analysis/source_lint.py``).

Four ways:
- fixture parity, rules of unchanged meaning: the same fixture text
  through both packages' ``lint_source`` gives the same ``(rule, line,
  col)`` list, pragma and skip-file cases included;
- fixture parity, rules given a torch meaning: the JAX form of a fixture
  through the JAX package and its torch form through the port give the
  same ``(rule, line)`` list; the JAX-only rules (MX102, MX301, MX308)
  never fire in the port;
- tree parity: over the JAX package's tree and the port's, with every
  pragma switched off, both lints give the same MX307, MX310, MX311,
  MX315, MX316, MX601 and MX602 findings (id, path, line);
- the self-lint: the port's tree has no error and none of the findings
  the JAX package's tier-1 keeps out of its own tree
  (``tests/test_mxlint.py``'s ``test_tree_has_no_*``), and no import of
  JAX or the JAX package (MX101). The tree is linted once a module.
"""

import os

import pytest

from mxnet_tpu.analysis import lint_source as jlint
from mxnet_tpu_torch.analysis import lint_source as tlint
from mxnet_tpu_torch.analysis import rules as trules
from mxnet_tpu_torch.analysis import source_lint as tsl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rlc(findings):
    return [(f.rule.id, f.line, f.col) for f in findings]


def _rl(findings):
    return [(f.rule.id, f.line) for f in findings]


def _ids(findings):
    return [f.rule.id for f in findings]


def _port_path(path):
    """The port's file at the JAX package's relative path."""
    return path.replace("mxnet_tpu/", "mxnet_tpu_torch/", 1) \
        if path.startswith("mxnet_tpu/") else path


# -- rules of unchanged meaning: the same text, the same findings -------------

# name -> (source, path in the JAX package, the expected rule ids)
SAME = {
    "mx100_syntax_error": ("def broken(:\n", "fx.py", ["MX100"]),
    "mx601_bare_except": (
        "try:\n    risky()\nexcept:\n    pass\n", "fx.py", ["MX601"]),
    "mx602_unbounded_retry": (
        "def send(op):\n"
        "    while True:\n"
        "        try:\n"
        "            return op()\n"
        "        except ConnectionError:\n"
        "            continue\n", "fx.py", ["MX602"]),
    "mx602_backoff_bounds_it": (
        "import time\n"
        "def send(op):\n"
        "    while True:\n"
        "        try:\n"
        "            return op()\n"
        "        except ConnectionError:\n"
        "            time.sleep(0.1)\n", "fx.py", []),
    "mx602_escaping_handler": (
        "def serve(op):\n"
        "    while True:\n"
        "        try:\n"
        "            op()\n"
        "        except OSError:\n"
        "            return\n", "fx.py", []),
    "mx602_event_loop_handler": (
        "def serve(conn, op):\n"
        "    while True:\n"
        "        try:\n"
        "            op()\n"
        "        except ValueError as e:\n"
        "            reply(conn, e)\n", "fx.py", []),
    "mx306_unbarriered_delta": (
        "import time\n"
        "def bench(step, x):\n"
        "    t0 = time.time()\n"
        "    out = step(x)\n"
        "    return time.time() - t0\n", "fx.py", ["MX306"]),
    "mx306_perf_counter_pair": (
        "from time import perf_counter\n"
        "def bench(step, x):\n"
        "    t0 = perf_counter()\n"
        "    out = step(x)\n"
        "    t1 = perf_counter()\n"
        "    return t1 - t0\n", "fx.py", ["MX306"]),
    "mx306_monotonic_is_bookkeeping": (
        "import time\n"
        "def poll(op):\n"
        "    start = time.monotonic()\n"
        "    op()\n"
        "    return time.monotonic() - start\n", "fx.py", []),
    "mx306_no_work_between": (
        "import time\n"
        "def stamp():\n"
        "    t0 = time.time()\n"
        "    return time.time() - t0\n", "fx.py", []),
    "mx306_future_result_barrier": (
        "import time\n"
        "def bench(pool, job):\n"
        "    t0 = time.time()\n"
        "    fut = pool.submit(job)\n"
        "    fut.result()\n"
        "    return time.time() - t0\n", "fx.py", []),
    "mx306_pragma": (
        "import time\n"
        "def bench(step, x):\n"
        "    t0 = time.time()\n"
        "    out = step(x)\n"
        "    return time.time() - t0  # mxlint: disable=MX306\n",
        "fx.py", []),
    "mx306_exempt_timeline": (
        "import time\n"
        "def bench(step, x):\n"
        "    t0 = time.time()\n"
        "    out = step(x)\n"
        "    return time.time() - t0\n",
        "mxnet_tpu/telemetry/timeline.py", []),
    "mx306_exempt_profiler": (
        "import time\n"
        "def bench(step, x):\n"
        "    t0 = time.time()\n"
        "    out = step(x)\n"
        "    return time.time() - t0\n",
        "mxnet_tpu/utils/profiler.py", []),
    "mx307_leaked_span": (
        "def loop(tl, batches):\n"
        "    for i, b in enumerate(batches):\n"
        "        span = tl.begin_step(0, i)\n"
        "        span.mark('device')\n"
        "        step(b)\n", "fx.py", ["MX307"]),
    "mx307_bare_begin_step": (
        "def loop(tl):\n    tl.begin_step(0, 0)\n", "fx.py", ["MX307"]),
    "mx307_bare_phase": (
        "from mxnet_tpu_torch import telemetry\n"
        "def push(kv, grads):\n"
        "    telemetry.phase('kvstore_push')\n"
        "    kv.push_many(grads)\n", "fx.py", ["MX307"]),
    "mx307_bare_timed": (
        "from mxnet_tpu_torch.telemetry import timed\n"
        "def stage(x):\n"
        "    timed('stage')\n"
        "    return work(x)\n", "fx.py", ["MX307"]),
    "mx307_with_span": (
        "def loop(tl, batches):\n"
        "    for i, b in enumerate(batches):\n"
        "        with tl.begin_step(0, i) as span:\n"
        "            span.mark('device')\n"
        "            step(b)\n", "fx.py", []),
    "mx307_finally_end": (
        "def loop(tl, batches):\n"
        "    for i, b in enumerate(batches):\n"
        "        span = tl.begin_step(0, i)\n"
        "        try:\n"
        "            step(b)\n"
        "        finally:\n"
        "            span.end()\n", "fx.py", []),
    "mx307_conditional_open_and_end": (
        "def loop(tl, batches):\n"
        "    for i, b in enumerate(batches):\n"
        "        span = tl.begin_step(0, i) if tl is not None else None\n"
        "        step(b)\n"
        "        if span is not None:\n"
        "            span.end()\n", "fx.py", []),
    "mx307_pragma": (
        "def loop(tl):\n"
        "    span = tl.begin_step(0, 0)  # mxlint: disable=MX307\n"
        "    step()\n", "fx.py", []),
    "mx307_exempt_timeline": (
        "def loop(tl):\n"
        "    span = tl.begin_step(0, 0)\n"
        "    step()\n", "mxnet_tpu/telemetry/timeline.py", []),
    "mx309_scalar_pull": (
        "def loop(batches, train_step, state, loss):\n"
        "    for b in batches:\n"
        "        state, loss = train_step(state, b)\n"
        "        print(float(loss))\n", "fx.py", ["MX309"]),
    "mx309_host_metadata_exempt": (
        "def loop(batches, train_step, state):\n"
        "    for b in batches:\n"
        "        state = train_step(state, b)\n"
        "        n = int(b.shape[0])\n", "fx.py", []),
    "mx309_numpy_pull": (
        "import numpy as np\n"
        "def loop(batches, train_step, state):\n"
        "    for b in batches:\n"
        "        state = train_step(state, b)\n"
        "        loss = np.asarray(state[1])\n", "fx.py", ["MX309"]),
    "mx309_no_step_in_loop": (
        "import numpy as np\n"
        "def save_all(arrays):\n"
        "    out = []\n"
        "    for a in arrays:\n"
        "        out.append(np.asarray(a))\n"
        "    return out\n", "fx.py", []),
    "mx309_pull_after_inner_loop": (
        "import numpy as np\n"
        "def fit(epochs, batches, train_step, state, gstate):\n"
        "    for e in range(epochs):\n"
        "        for b in batches:\n"
        "            state = train_step(state, b)\n"
        "        stats = np.asarray(gstate)\n", "fx.py", []),
    "mx309_pragma": (
        "import numpy as np\n"
        "def loop(batches, train_step, state):\n"
        "    for b in batches:\n"
        "        state = train_step(state, b)\n"
        "        loss = np.asarray(state[1])  # mxlint: disable=MX309\n",
        "fx.py", []),
    "mx310_world_literal": (
        "def build(mesh):\n"
        "    ndev = 8\n"
        "    def step(x):\n"
        "        return x / ndev\n"
        "    return step\n", "fx.py", ["MX310"]),
    "mx310_world_size_name": (
        "def build(mesh):\n"
        "    world_size = 8\n"
        "    def step(x):\n"
        "        return x / world_size\n"
        "    return step\n", "fx.py", ["MX310"]),
    "mx310_live_mesh": (
        "def build(mesh):\n"
        "    ndev = int(mesh.shape['dp'])\n"
        "    def step(x):\n"
        "        return x / ndev\n"
        "    return step\n", "fx.py", []),
    "mx310_argument": (
        "def build():\n"
        "    ndev = 8\n"
        "    def step(x, ndev):\n"
        "        return x / ndev\n"
        "    return step\n", "fx.py", []),
    "mx310_rebound": (
        "def build():\n"
        "    ndev = 8\n"
        "    def step(x):\n"
        "        ndev = len(x)\n"
        "        return x / ndev\n"
        "    return step\n", "fx.py", []),
    "mx310_provider_exempt": (
        "def build():\n"
        "    ndev = 8\n"
        "    def step(x):\n"
        "        return x / ndev\n"
        "    return step\n", "mxnet_tpu/parallel/mesh.py", []),
    "mx311_direct_actuation": (
        "def rebalance(co, kv):\n"
        "    co.kill(3, reason='slow')\n"
        "    co.request_world(4)\n"
        "    kv.set_gradient_compression('int8')\n",
        "mxnet_tpu/somewhere.py", ["MX311", "MX311", "MX311"]),
    "mx311_coordinator_receivers": (
        "def f(elastic_co, my_coordinator):\n"
        "    elastic_co.kill()\n"
        "    my_coordinator.kill(1)\n", "mxnet_tpu/x.py",
        ["MX311", "MX311"]),
    "mx311_non_actuation_kills": (
        "import os\n"
        "def f(proc):\n"
        "    os.kill(123, 9)\n"
        "    proc.kill()\n"
        "class S(Base):\n"
        "    def set_gradient_compression(self, c):\n"
        "        return super().set_gradient_compression(c)\n",
        "mxnet_tpu/x.py", []),
    "mx311_controller_exempt": (
        "def f(co):\n    co.request_world(4)\n",
        "mxnet_tpu/resilience/controller.py", []),
    "mx311_tests_exempt": (
        "def f(co):\n    co.request_world(4)\n", "tests/test_x.py", []),
    "mx311_pragma": (
        "def f(co):\n"
        "    co.request_world(4)  "
        "# mxlint: disable=MX311 - recovery runbook tool\n",
        "mxnet_tpu/x.py", []),
    "mx314_unguarded_wrapper": (
        "from mxnet_tpu_torch.utils import profiler\n"
        "def cap(d):\n"
        "    profiler.start_trace(d)\n"
        "    run()\n"
        "    profiler.stop_trace()\n",
        "mxnet_tpu/models/fastnet.py", ["MX314"]),
    "mx314_unguarded_capture": (
        "from mxnet_tpu_torch.telemetry import profiling\n"
        "def cap(d):\n"
        "    profiling.start_capture(d)\n"
        "    run()\n"
        "    profiling.stop_capture()\n",
        "mxnet_tpu/models/fastnet.py", ["MX314"]),
    "mx314_nested_def_owns_its_start": (
        "from mxnet_tpu_torch.utils import profiler\n"
        "def f(d):\n"
        "    try:\n"
        "        def helper():\n"
        "            profiler.start_trace(d)\n"
        "        register(helper)\n"
        "    finally:\n"
        "        profiler.stop_trace()\n",
        "mxnet_tpu/models/fastnet.py", ["MX314"]),
    "mx314_finally_guarded": (
        "from mxnet_tpu_torch.utils import profiler\n"
        "def cap(d):\n"
        "    profiler.start_trace(d)\n"
        "    try:\n"
        "        run()\n"
        "    finally:\n"
        "        profiler.stop_trace()\n",
        "mxnet_tpu/models/fastnet.py", []),
    "mx314_capture_window": (
        "from mxnet_tpu_torch.telemetry import profiling\n"
        "def cap(d):\n"
        "    with profiling.capture(d):\n"
        "        run()\n", "mxnet_tpu/models/fastnet.py", []),
    "mx315_direct_save_sharded": (
        "from mxnet_tpu_torch.utils import checkpoint as ck\n"
        "def snapshot(d, step, params):\n"
        "    ck.save_sharded(d, step, params)\n",
        "mxnet_tpu/models/fastnet.py", ["MX315"]),
    "mx315_write_manifest": (
        "from mxnet_tpu_torch.utils.checkpoint import _write_manifest\n"
        "def stage(d, shards):\n"
        "    _write_manifest(d, shards)\n",
        "mxnet_tpu/models/fastnet.py", ["MX315"]),
    "mx315_reads_clean": (
        "from mxnet_tpu_torch.utils import checkpoint as ck\n"
        "from mxnet_tpu_torch.resilience import ckpt_async\n"
        "def resume(d, w):\n"
        "    step = ck.latest_step(d)\n"
        "    state = ck.load_sharded(d, step)\n"
        "    ckpt_async.save_now(d, step, state[0], symbol=None)\n"
        "    w.submit(None)\n"
        "    return state\n", "mxnet_tpu/models/fastnet.py", []),
    "mx315_owner_exempt": (
        "def save_now(d, step, params):\n"
        "    return save_sharded(d, step, params)\n",
        "mxnet_tpu/resilience/ckpt_async.py", []),
    "mx315_pragma": (
        "from mxnet_tpu_torch.utils import checkpoint as ck\n"
        "def snapshot(d, step, params):\n"
        "    ck.save_sharded(d, step, params)"
        "  # mxlint: disable=MX315 - migration shim\n",
        "mxnet_tpu/models/fastnet.py", []),
    "mx316_env_and_summary": (
        "import os, json\n"
        "def summarize(hub, outcomes):\n"
        "    d = os.environ.get('MXNET_TPU_LEDGER_DIR')\n"
        "    with open(os.path.join(d, 'summary.json'), 'w') as f:\n"
        "        json.dump(outcomes, f)\n"
        "    hub.emit('run_summary', run_id='abc')\n",
        "mxnet_tpu/models/fastnet.py", ["MX316", "MX316"]),
    "mx316_env_write": (
        "import os\n"
        "def redirect(d):\n"
        "    os.environ['MXNET_TPU_LEDGER_DIR'] = d\n",
        "mxnet_tpu/models/fastnet.py", ["MX316"]),
    "mx316_sanctioned": (
        "import os\n"
        "def ok(hub, monkeypatch):\n"
        "    from mxnet_tpu_torch.telemetry import ledger\n"
        "    monkeypatch.setenv('MXNET_TPU_LEDGER_DIR', '/tmp/x')\n"
        "    d = ledger.ledger_dir()\n"
        "    ledger.record_run('fit', fingerprint='fp')\n"
        "    flight = os.environ.get('MXNET_TPU_FLIGHT_DIR')\n"
        "    hub.emit('epoch_summary', mfu_pct=1.0)\n",
        "mxnet_tpu/models/fastnet.py", []),
    "mx316_owner_exempt": (
        "import os\n"
        "def ledger_dir():\n"
        "    return os.environ.get('MXNET_TPU_LEDGER_DIR') or None\n"
        "def announce(hub, rec):\n"
        "    hub.emit('run_summary', run_id=rec['run_id'])\n",
        "mxnet_tpu/telemetry/ledger.py", []),
    "mx316_pragma": (
        "import os\n"
        "def probe(hub):\n"
        "    d = os.environ.get('MXNET_TPU_LEDGER_DIR')"
        "  # mxlint: disable=MX316 - launcher probe, read-only\n",
        "mxnet_tpu/models/fastnet.py", []),
    "skip_file": (
        "# mxlint: skip-file\n"
        "try:\n    risky()\nexcept:\n    pass\n", "fx.py", []),
    "pragma_other_rule_does_not_suppress": (
        "try:\n    risky()\nexcept:  # mxlint: disable=MX602\n    pass\n",
        "fx.py", ["MX601"]),
    "pragma_bare_disable": (
        "try:\n    risky()\nexcept:  # mxlint: disable\n    pass\n",
        "fx.py", []),
}


@pytest.mark.parametrize("name", sorted(SAME))
def test_same_text_same_findings(name):
    src, path, want = SAME[name]
    j = jlint(src, path)
    t = tlint(src, _port_path(path))
    assert _ids(j) == want
    assert _rlc(t) == _rlc(j)


# -- rules given a torch meaning: the JAX form against the torch form ---------

# name -> (JAX form, JAX path, torch form, torch path, expected rule ids)
PAIRS = {
    "mx101_fragile_import": (
        "from jax import shard_map\n", "fx.py",
        "import jax\n", "fx.py", ["MX101"]),
    "mx101_experimental_path": (
        "from jax.experimental.shard_map import shard_map\n", "fx.py",
        "from mxnet_tpu.ops import nn\n", "fx.py", ["MX101"]),
    "mx101_pragma": (
        "from jax import shard_map  # mxlint: disable=MX101\n", "fx.py",
        "import jaxlib  # mxlint: disable=MX101\n", "fx.py", []),
    "mx101_pragma_other_rule": (
        "from jax import shard_map  # mxlint: disable=MX202\n", "fx.py",
        "import jax.numpy as jnp  # mxlint: disable=MX202\n", "fx.py",
        ["MX101"]),
    "mx101_skip_file": (
        "# mxlint: skip-file\nfrom jax import shard_map\n", "fx.py",
        "# mxlint: skip-file\nimport mxnet_tpu\n", "fx.py", []),
    "mx201_numpy_in_captured_fn": (
        "import numpy as np\n"
        "from mxnet_tpu.compat import shard_map\n"
        "def block(x):\n"
        "    return np.sum(x)\n"
        "def run(mesh, spec, x):\n"
        "    return shard_map(block, mesh=mesh, in_specs=spec,\n"
        "                     out_specs=spec)(x)\n", "fx.py",
        "import numpy as np\n"
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "def block():\n"
        "    return np.sum(X)\n"
        "def run(x):\n"
        "    return compile_mod.CapturedProgram(block, x.device,\n"
        "                                       'block')\n", "fx.py",
        ["MX201"]),
    "mx202_item": (
        "import jax\n"
        "\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    return x.item()\n", "fx.py",
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "def make(x):\n"
        "    def f():\n"
        "        y = x * 2\n"
        "        return y.item()\n"
        "    return compile_mod.CapturedProgram(f, x.device, 'f')\n",
        "fx.py", ["MX202"]),
    "mx202_float_of_argument": (
        "import jax\n"
        "from jax import lax\n"
        "def body(c, x):\n"
        "    return c + float(x), None\n"
        "def run(xs):\n"
        "    return lax.scan(body, 0.0, xs)\n", "fx.py",
        "import torch\n"
        "from mxnet_tpu_torch.utils.compile import CapturedPair\n"
        "def fwd(x):\n"
        "    return x * 2 + float(x)\n"
        "def run(x, bwd):\n"
        "    return CapturedPair(fwd, bwd, x.device, ('f', 'b'))\n",
        "fx.py", ["MX202"]),
    "mx202_graph_block": (
        "import jax\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    y = x * 2\n"
        "    n = float(x)\n", "fx.py",
        "import torch\n"
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        y = x * 2\n"
        "        n = float(x)\n", "fx.py", ["MX202"]),
    "mx202_cpu_and_numpy": (
        "import jax\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    a = x.tolist()\n"
        "    b = x.item()\n", "fx.py",
        "import torch\n"
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        a = x.cpu()\n"
        "        b = x.numpy()\n", "fx.py", ["MX202", "MX202"]),
    "mx202_graphed_callables": (
        "import jax\n"
        "def f(x):\n"
        "    return x.item()\n"
        "g = jax.vmap(f)\n", "fx.py",
        "import torch\n"
        "def f(x):\n"
        "    return x.item()\n"
        "g = torch.cuda.make_graphed_callables(f, (X,))\n", "fx.py",
        ["MX202"]),
    "mx202_pragma": (
        "import jax\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    return x.item()  # mxlint: disable=MX202\n", "fx.py",
        "import torch\n"
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        y = x.item()  # mxlint: disable=MX202\n", "fx.py", []),
    "mx203_branch_on_tensor": (
        "import jax\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    if x > 0:\n"
        "        return x\n"
        "    return -x\n", "fx.py",
        "import torch\n"
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        if x > 0:\n"
        "            y = x\n", "fx.py", ["MX203"]),
    "mx302_fstring": (
        "import jax\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    name = f'shape={x.shape}'\n"
        "    return x\n", "fx.py",
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "def make(x):\n"
        "    def f():\n"
        "        name = f'sum={x.sum()}'\n"
        "        return x\n"
        "    return compile_mod.CapturedProgram(f, x.device, 'f')\n",
        "fx.py", ["MX302"]),
    "mx303_built_and_called_once": (
        "import jax\n"
        "def f(g, x):\n"
        "    return jax.jit(g)(x)\n", "fx.py",
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "def f(g, x):\n"
        "    return compile_mod.CapturedProgram(g, x.device, 'g')()\n",
        "fx.py", ["MX303"]),
    "mx303_inside_loop": (
        "import jax\n"
        "def train(batches):\n"
        "    for b in batches:\n"
        "        step = jax.jit(lambda x: x * 2)\n"
        "        step(b)\n", "fx.py",
        "import torch\n"
        "def train(batches):\n"
        "    for b in batches:\n"
        "        g = torch.cuda.CUDAGraph()\n"
        "        run(g, b)\n", "fx.py", ["MX303"]),
    "mx303_cached_clean": (
        "import jax\n"
        "def g(x, n):\n"
        "    return x\n"
        "step = jax.jit(g, static_argnums=(1,))\n"
        "def train(batches):\n"
        "    for b in batches:\n"
        "        step(b, 2)\n", "fx.py",
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "def g():\n"
        "    return X\n"
        "step = compile_mod.CapturedProgram(g, 'cuda', 'g')\n"
        "def train(batches):\n"
        "    for b in batches:\n"
        "        step()\n", "fx.py", []),
    "mx303_pragma": (
        "import jax\n"
        "def f(g, x):\n"
        "    return jax.jit(g)(x)  # mxlint: disable=MX303\n", "fx.py",
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "def f(g, x):\n"
        "    return compile_mod.CapturedProgram(g, 'cuda', 'g')()"
        "  # mxlint: disable=MX303\n", "fx.py", []),
    "mx304_direct": (
        "import jax\n"
        "from jax import lax\n"
        "def sync(grads, ax):\n"
        "    return lax.psum(grads, ax)\n", "fx.py",
        "import torch\n"
        "import torch.distributed as dist\n"
        "def sync(grads, group):\n"
        "    return dist.all_reduce(grads, group=group)\n", "fx.py",
        ["MX304"]),
    "mx304_mapped": (
        "import jax\n"
        "from jax import lax\n"
        "def sync(grads, ax):\n"
        "    return jax.tree_util.tree_map(\n"
        "        lambda g: lax.psum(g, ax), grads)\n", "fx.py",
        "import torch\n"
        "import torch.distributed as dist\n"
        "def sync(grads, group):\n"
        "    return torch.utils._pytree.tree_map(\n"
        "        lambda g: dist.all_reduce(g, group=group), grads)\n",
        "fx.py", ["MX304"]),
    "mx304_not_gradients": (
        "from jax import lax\n"
        "def axis_size(ax):\n"
        "    return lax.psum(1, ax)\n", "fx.py",
        "import torch\n"
        "import torch.distributed as dist\n"
        "def count(group):\n"
        "    return dist.all_reduce(torch.ones(1), group=group)\n",
        "fx.py", []),
    "mx304_comm_owns_the_wire": (
        "import jax\n"
        "from jax import lax\n"
        "def sync(grads, ax):\n"
        "    return lax.psum(grads, ax)\n", "mxnet_tpu/comm/allreduce.py",
        "import torch\n"
        "import torch.distributed as dist\n"
        "def sync(grads, group):\n"
        "    return dist.all_reduce(grads, group=group)\n",
        "mxnet_tpu_torch/comm/allreduce.py", []),
    "mx304_pragma": (
        "import jax\n"
        "from jax import lax\n"
        "def sync(grads, ax):\n"
        "    return lax.psum(grads, ax)  # mxlint: disable=MX304\n",
        "fx.py",
        "import torch\n"
        "import torch.distributed as dist\n"
        "def sync(grads, group):\n"
        "    return dist.all_reduce(grads)  # mxlint: disable=MX304\n",
        "fx.py", []),
    "mx306_barrier": (
        "import time\n"
        "import jax\n"
        "def bench(step, x):\n"
        "    t0 = time.perf_counter()\n"
        "    out = step(x)\n"
        "    jax.block_until_ready(out)\n"
        "    return time.perf_counter() - t0\n", "fx.py",
        "import time\n"
        "import torch\n"
        "def bench(step, x):\n"
        "    t0 = time.perf_counter()\n"
        "    out = step(x)\n"
        "    torch.cuda.synchronize()\n"
        "    return time.perf_counter() - t0\n", "fx.py", []),
    "mx309_host_pulls": (
        "import numpy as np\n"
        "def loop(batches, train_step, state):\n"
        "    for b in batches:\n"
        "        state = train_step(state, b)\n"
        "        loss = np.asarray(state[1])\n"
        "        acc = state[2].asnumpy()\n", "fx.py",
        "import numpy as np\n"
        "def loop(batches, train_step, state):\n"
        "    for b in batches:\n"
        "        state = train_step(state, b)\n"
        "        loss = state[1].item()\n"
        "        acc = state[2].cpu()\n", "fx.py", ["MX309", "MX309"]),
    "mx312_kernel_outside_layer": (
        "from jax.experimental import pallas as pl\n"
        "def hot(x):\n"
        "    return pl.pallas_call(k, out_shape=o)(x)\n"
        "def hotter(x):\n"
        "    return pl.pallas_call(k2, out_shape=o)(x)\n",
        "mxnet_tpu/models/fastnet.py",
        "import torch.utils.cpp_extension as cpp\n"
        "def hot(src):\n"
        "    return cpp.load_inline('hot', src)\n"
        "def hotter(src):\n"
        "    return cpp.load_inline('hotter', src)\n",
        "mxnet_tpu_torch/models/fastnet.py", ["MX312", "MX312"]),
    "mx312_unpriced_kernel_module": (
        "from jax.experimental import pallas as pl\n"
        "def my_kernel(x):\n"
        "    return pl.pallas_call(k, out_shape=o, name='my_kernel')(x)\n"
        "def my_kernel2(x):\n"
        "    return pl.pallas_call(k2, out_shape=o, name='my_kernel2')(x)\n",
        "mxnet_tpu/ops/pallas/newkern.py",
        "from ._common import count_launch, load_library\n"
        "def my_kernel(x):\n"
        "    return count_launch(my_kernel)\n"
        "def my_kernel2(x):\n"
        "    return count_launch(my_kernel2)\n",
        "mxnet_tpu_torch/kernels/newkern.py", ["MX312"]),
    "mx312_registered_kernel_module": (
        "from jax.experimental import pallas as pl\n"
        "from .registry import register_kernel\n"
        "def my_kernel(x):\n"
        "    return pl.pallas_call(k, out_shape=o, name='my_kernel')(x)\n"
        "register_kernel('my_kernel', cost_fn)\n",
        "mxnet_tpu/ops/pallas/newkern.py",
        "from ._common import count_launch, load_library\n"
        "from .registry import register_kernel\n"
        "def my_kernel(x):\n"
        "    return count_launch(my_kernel)\n"
        "register_kernel('my_kernel', cost_fn, source='x.cu')\n",
        "mxnet_tpu_torch/kernels/newkern.py", []),
    "mx312_pragma": (
        "from jax.experimental import pallas as pl\n"
        "def hot(x):\n"
        "    return pl.pallas_call(k, out_shape=o)(x)"
        "  # mxlint: disable=MX312 - vendored prototype\n",
        "mxnet_tpu/models/fastnet.py",
        "import torch.utils.cpp_extension as cpp\n"
        "def hot(src):\n"
        "    return cpp.load_inline('hot', src)"
        "  # mxlint: disable=MX312 - vendored prototype\n",
        "mxnet_tpu_torch/models/fastnet.py", []),
    "mx313_per_leaf_host_stats": (
        "import jax\n"
        "import jax.numpy as jnp\n"
        "@jax.jit\n"
        "def step(params, grads):\n"
        "    stats = {}\n"
        "    for name, g in grads.items():\n"
        "        stats[name] = float(jnp.sum(jnp.abs(g)))\n"
        "    return stats\n", "fx.py",
        "import torch\n"
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "def make(params, grads):\n"
        "    def step():\n"
        "        stats = {}\n"
        "        for name, g in grads.items():\n"
        "            stats[name] = float(torch.sum(torch.abs(g)))\n"
        "        return stats\n"
        "    return compile_mod.CapturedProgram(step, 'cuda', 'step')\n",
        "fx.py", ["MX313"]),
    "mx313_item_shape": (
        "import jax\n"
        "import jax.numpy as jnp\n"
        "@jax.jit\n"
        "def step(params, grads):\n"
        "    stats = {}\n"
        "    for name, g in grads.items():\n"
        "        stats[name] = jnp.sum(g).item()\n"
        "    return stats\n", "fx.py",
        "import torch\n"
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "def make(params, grads):\n"
        "    def step():\n"
        "        stats = {}\n"
        "        for name, g in grads.items():\n"
        "            stats[name] = torch.sum(g).item()\n"
        "        return stats\n"
        "    return compile_mod.CapturedProgram(step, 'cuda', 'step')\n",
        "fx.py", ["MX202", "MX313"]),
    "mx313_pure_loop_clean": (
        "import jax\n"
        "import jax.numpy as jnp\n"
        "@jax.jit\n"
        "def step(params, grads):\n"
        "    stats = {}\n"
        "    for name, g in grads.items():\n"
        "        stats[name] = jnp.sum(jnp.abs(g))\n"
        "    return stats\n", "fx.py",
        "import torch\n"
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "def make(params, grads):\n"
        "    def step():\n"
        "        stats = {}\n"
        "        for name, g in grads.items():\n"
        "            stats[name] = torch.sum(torch.abs(g))\n"
        "        return stats\n"
        "    return compile_mod.CapturedProgram(step, 'cuda', 'step')\n",
        "fx.py", []),
    "mx314_raw_start_stop": (
        "import jax\n"
        "def cap(d):\n"
        "    jax.profiler.start_trace(d)\n"
        "    run()\n"
        "    jax.profiler.stop_trace()\n", "mxnet_tpu/models/fastnet.py",
        "import torch\n"
        "def cap(d):\n"
        "    torch.cuda.profiler.start()\n"
        "    run()\n"
        "    torch.cuda.profiler.stop()\n",
        "mxnet_tpu_torch/models/fastnet.py", ["MX314", "MX314"]),
    "mx314_raw_context_manager": (
        "import jax\n"
        "def cap(d):\n"
        "    with jax.profiler.trace(d):\n"
        "        run()\n", "mxnet_tpu/models/fastnet.py",
        "import torch\n"
        "def cap(d):\n"
        "    with torch.profiler.profile() as prof:\n"
        "        run()\n", "mxnet_tpu_torch/models/fastnet.py", ["MX314"]),
    "mx314_imported_profiler_name": (
        "from jax import profiler\n"
        "def cap(d):\n"
        "    profiler.start_trace(d)\n", "mxnet_tpu/models/fastnet.py",
        "from torch import profiler\n"
        "def cap(d):\n"
        "    profiler.profile().start()\n",
        "mxnet_tpu_torch/models/fastnet.py", ["MX314"]),
    "mx314_owner_exempt": (
        "import jax\n"
        "def start_capture(d):\n"
        "    jax.profiler.start_trace(d)\n",
        "mxnet_tpu/telemetry/profiling.py",
        "import torch\n"
        "def start_capture(d):\n"
        "    torch.profiler.profile().start()\n",
        "mxnet_tpu_torch/telemetry/profiling.py", []),
    "mx314_pragma": (
        "import jax\n"
        "def cap(d):\n"
        "    jax.profiler.start_trace(d)"
        "  # mxlint: disable=MX314 - raw capture for the xprof UI\n",
        "mxnet_tpu/models/fastnet.py",
        "import torch\n"
        "def cap(d):\n"
        "    torch.cuda.profiler.start()"
        "  # mxlint: disable=MX314 - raw capture for an external tool\n",
        "mxnet_tpu_torch/models/fastnet.py", []),
    "mx805_placements": (
        "import jax\n"
        "from jax.sharding import NamedSharding, PartitionSpec as P\n"
        "def place(x, mesh):\n"
        "    sh = NamedSharding(mesh, P())\n"
        "    a = jax.device_put(x, sh)\n"
        "    b = jax.device_put(x, NamedSharding(mesh, P('dp')))\n"
        "    shards = {k: NamedSharding(mesh, P()) for k in ('w', 'b')}\n"
        "    c = jax.device_put(x, shards['w'])\n"
        "    d = jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P()))\n"
        "    return a, b, c, d\n", "mxnet_tpu/models/foo.py",
        "from torch.distributed.tensor import distribute_tensor\n"
        "from mxnet_tpu_torch.parallel.mesh import Sharding, P\n"
        "def place(x, mesh):\n"
        "    sh = Sharding(mesh, P())\n"
        "    a = sh.shard(x)\n"
        "    b = Sharding(mesh, P('dp')).shard(x)\n"
        "    shards = {k: Sharding(mesh, P()) for k in ('w', 'b')}\n"
        "    c = shards['w'].shard(x)\n"
        "    d = distribute_tensor(x, mesh, placements)\n"
        "    return a, b, c, d\n", "mxnet_tpu_torch/models/foo.py",
        ["MX805"] * 4),
    "mx805_owner_layer": (
        "import jax\n"
        "from jax.sharding import NamedSharding, PartitionSpec as P\n"
        "def place(x, mesh):\n"
        "    return jax.device_put(x, NamedSharding(mesh, P()))\n",
        "mxnet_tpu/parallel/foo.py",
        "from mxnet_tpu_torch.parallel.mesh import Sharding, P\n"
        "def place(x, mesh):\n"
        "    return Sharding(mesh, P()).shard(x)\n",
        "mxnet_tpu_torch/parallel/foo.py", []),
    "mx805_device_placement": (
        "import jax\n"
        "def place(x, dev):\n"
        "    return jax.device_put(x, dev)\n", "mxnet_tpu/models/foo.py",
        "import torch\n"
        "def place(x, model, mesh):\n"
        "    return model.param_shardings(mesh)['w'].shard(x)\n",
        "mxnet_tpu_torch/models/foo.py", []),
    "mx805_pragma": (
        "import jax\n"
        "from jax.sharding import NamedSharding, PartitionSpec as P\n"
        "def restore(x, mesh):\n"
        "    return jax.device_put(x, NamedSharding(mesh, P()))"
        "  # mxlint: disable=MX805 - checkpoint restore\n",
        "mxnet_tpu/models/foo.py",
        "from mxnet_tpu_torch.parallel.mesh import Sharding, P\n"
        "def restore(x, mesh):\n"
        "    return Sharding(mesh, P()).shard(x)"
        "  # mxlint: disable=MX805 - checkpoint restore\n",
        "mxnet_tpu_torch/models/foo.py", []),
}


def _drop_imports(findings):
    """The JAX forms import JAX, which the port's MX101 would flag; the
    JAX package's own findings carry no MX101 for these imports."""
    return [f for f in findings if f.rule.id != "MX101"]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_torch_form_matches_jax_form(name):
    jsrc, jpath, tsrc, tpath, want = PAIRS[name]
    j = jlint(jsrc, jpath)
    t = tlint(tsrc, tpath)
    assert sorted(_ids(t)) == sorted(want), [f.format() for f in t]
    if not name.startswith("mx101"):
        j = _drop_imports(j)
        t = _drop_imports(t)
    assert _rl(t) == _rl(j)


# -- JAX-only rules: registered, never fired ----------------------------------

JAX_ONLY_FIXTURES = {
    "MX102": ("from jax.experimental.pjit import pjit\n", "fx.py"),
    "MX301": ("import jax\n"
              "def g(x, n):\n"
              "    return x\n"
              "h = jax.jit(g, static_argnums=[1])\n", "fx.py"),
    "MX308": ("import jax.lax as lax\n"
              "def exchange(q, axis):\n"
              "    s = lax.all_to_all(q, axis, 0, 0)\n"
              "    return lax.all_gather(s, axis)\n",
              "mxnet_tpu/comm/fx.py"),
}


@pytest.mark.parametrize("rule_id", sorted(JAX_ONLY_FIXTURES))
def test_jax_only_rule_never_fires(rule_id):
    src, path = JAX_ONLY_FIXTURES[rule_id]
    assert rule_id in _ids(jlint(src, path))
    t = tlint(src, _port_path(path))
    assert rule_id not in _ids(t)
    # what the port sees there: an import of JAX, nothing else
    assert set(_ids(t)) == {"MX101"}
    assert rule_id in trules.JAX_ONLY and rule_id in trules.RULES


# -- what only the port checks ------------------------------------------------

@pytest.mark.parametrize("src,want", [
    ("import jax\n", ["MX101"]),
    ("import jax.numpy as jnp\n", ["MX101"]),
    ("import jaxlib.xla_client as xc\n", ["MX101"]),
    ("from mxnet_tpu import nd\n", ["MX101"]),
    ("import mxnet_tpu.analysis\n", ["MX101"]),
    ("import importlib\nm = importlib.import_module('jax.numpy')\n",
     ["MX101"]),
    ("m = __import__('mxnet_tpu')\n", ["MX101"]),
    ("import jax, torch\n", ["MX101"]),
    ("import mxnet_tpu_torch\nfrom mxnet_tpu_torch import nd\n", []),
    ("from . import jax_like\nfrom .jax import probe\n", []),
    ("import importlib\nm = importlib.import_module('.jax', 'pkg')\n", []),
    ("import torch\nimport numpy as np\n", []),
])
def test_mx101_any_import_of_jax(src, want):
    assert _ids(tlint(src, "mxnet_tpu_torch/fx.py")) == want


def test_mx101_is_an_error():
    (f,) = tlint("import jax\n", "fx.py")
    assert f.is_error and f.line == 1 and "never imports" in f.message


def test_captured_name_resolves_in_scope():
    """A name given to CapturedProgram is the def in the calling scope or
    one enclosing it: a def of the same name elsewhere (another method's
    ``run``) is not captured, and a method is never one."""
    src = (
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "class A:\n"
        "    def run(self):\n"
        "        return self.x.item()\n"
        "    def eager(self):\n"
        "        def run():\n"
        "            return X.item()\n"
        "        return run()\n"
        "    def captured(self):\n"
        "        def run():\n"
        "            return X.sum()\n"
        "        return compile_mod.CapturedProgram(run, 'cuda', 'r')\n")
    assert tlint(src, "fx.py") == []
    # the enclosing scope's def is found
    src2 = (
        "from mxnet_tpu_torch.utils import compile as compile_mod\n"
        "def outer():\n"
        "    def run():\n"
        "        return X.item()\n"
        "    def build():\n"
        "        return compile_mod.CapturedProgram(run, 'cuda', 'r')\n"
        "    return build\n")
    assert _rl(tlint(src2, "fx.py")) == [("MX202", 4)]


def test_captured_nested_def_and_lambda():
    src = (
        "from mxnet_tpu_torch.utils.compile import CapturedProgram\n"
        "def make(x):\n"
        "    def step():\n"
        "        def inner(v):\n"
        "            return v.tolist()\n"
        "        return inner(x)\n"
        "    a = CapturedProgram(step, 'cuda', 's')\n"
        "    b = CapturedProgram(lambda: x.cpu(), 'cuda', 'l')\n"
        "    return a, b\n")
    assert sorted(_rl(tlint(src, "fx.py"))) == [("MX202", 5), ("MX202", 8)]


def test_mx304_for_loop_over_gradients():
    src = (
        "import torch.distributed as dist\n"
        "def sync(model, group):\n"
        "    for g in model.grads():\n"
        "        dist.all_reduce(g, group=group)\n"
        "    for p in model.params():\n"
        "        dist.all_reduce(p.grad)\n"
        "    for t in model.buffers():\n"
        "        dist.all_reduce(t)\n")
    assert _rl(tlint(src, "mxnet_tpu_torch/model.py")) == [
        ("MX304", 4), ("MX304", 6)]
    assert tlint(src, "mxnet_tpu_torch/parallel/mesh.py") == []
    nested = (
        "import torch.distributed as dist\n"
        "def sync(grads, more_grads):\n"
        "    for g in grads:\n"
        "        for h in more_grads:\n"
        "            dist.all_reduce(h)\n")
    assert _rl(tlint(nested, "fx.py")) == [("MX304", 5)]


@pytest.mark.parametrize("barrier", [
    "torch.cuda.synchronize()", "done.synchronize()",
    "torch.cuda.current_stream().synchronize()",
    "ms = start.elapsed_time(end)", "loss = out.item()",
    "host = out.cpu()", "arr = out.numpy()", "t.block(out)",
    "prog.capture()", "ex.precompile()"])
def test_mx306_torch_barriers(barrier):
    src = (
        "import time\n"
        "import torch\n"
        "def bench(step, x, start, end, done, t, prog, ex):\n"
        "    t0 = time.perf_counter()\n"
        "    out = step(x)\n"
        f"    {barrier}\n"
        "    return time.perf_counter() - t0\n")
    assert tlint(src, "fx.py") == []
    flagged = src.replace(f"    {barrier}\n", "")
    assert _ids(tlint(flagged, "fx.py")) == ["MX306"]


def test_mx309_torch_pulls():
    src = (
        "def loop(batches, model):\n"
        "    for b in batches:\n"
        "        out = model.forward(b)\n"
        "        a = out.numpy()\n"
        "        c = out.tolist()\n"
        "        d = out.to(torch.float16)\n")
    assert sorted(_rl(tlint(src, "fx.py"))) == [("MX309", 4), ("MX309", 5)]


def test_mx312_triton_and_launch_outside_layer():
    src = (
        "import triton\n"
        "from mxnet_tpu_torch.kernels._common import count_launch\n"
        "@triton.jit\n"
        "def k(x_ptr):\n"
        "    pass\n"
        "def hot(w):\n"
        "    count_launch(w)\n")
    assert _rl(tlint(src, "mxnet_tpu_torch/models/fast.py")) == [
        ("MX312", 3), ("MX312", 7)]
    # inside the layer, a registered module is clean, and the loader
    # called from outside it is not a kernel
    assert tlint(src + "register_kernel('k', cost, source='k.cu')\n",
                 "mxnet_tpu_torch/kernels/fast.py") == []
    assert tlint("from .kernels import _common\n"
                 "lib = _common.load_library('fused_adam')\n",
                 "mxnet_tpu_torch/fx.py") == []


def test_mx805_dtensor_from_local():
    src = (
        "from torch.distributed.tensor import DTensor\n"
        "def place(x, mesh, pl):\n"
        "    return DTensor.from_local(x, mesh, pl)\n")
    assert _rl(tlint(src, "mxnet_tpu_torch/models/foo.py")) == [
        ("MX805", 3)]
    assert tlint(src, "mxnet_tpu_torch/comm/foo.py") == []


def test_rule_texts_speak_of_torch():
    for rid in trules.TORCH_MEANING:
        rule = trules.RULES[rid]
        text = (rule.summary + " " + rule.fixit).replace(
            "mxnet_tpu_torch", "").lower()
        if rid != "MX101":
            assert "jax" not in text and "pallas" not in text, rid
    # the port has publish_bench, so MX316's fixit names it as the JAX one
    assert "publish_bench" in trules.RULES["MX316"].fixit
    assert not set(trules.TORCH_MEANING) & set(trules.JAX_ONLY)


# -- tree parity: both lints over both trees, every pragma switched off -------

TREE_RULES = ("MX307", "MX310", "MX311", "MX315", "MX316", "MX601", "MX602")


def _raw_tree_findings(lint, root, rules):
    """``lint`` over every file under ``root`` with its pragmas switched
    off: (rule, path relative to the repo, line)."""
    out = []
    for path in tsl.iter_python_files([root]):
        with open(path, encoding="utf-8") as fh:
            text = fh.read().replace("# mxlint:", "# mxlint-off:")
        out += [(f.rule.id, os.path.relpath(f.path, REPO), f.line)
                for f in lint(text, path) if f.rule.id in rules]
    return sorted(out)


@pytest.fixture(scope="module", params=["mxnet_tpu", "mxnet_tpu_torch"])
def tree_parity(request):
    root = os.path.join(REPO, request.param)
    return (request.param,
            _raw_tree_findings(jlint, root, TREE_RULES),
            _raw_tree_findings(tlint, root, TREE_RULES))


@pytest.mark.parametrize("rule_id", TREE_RULES)
def test_tree_parity(tree_parity, rule_id):
    tree, j, t = tree_parity
    assert [r for r in t if r[0] == rule_id] == \
        [r for r in j if r[0] == rule_id], tree


# the MX311 sites each tree suppresses: both packages' launch-config
# compression sites, and in the port the subsystem benches' planted
# failures (two kills of bench_ckpt's and bench_elastic's resize, one of
# bench_lockwatch's, bench_controller's flaky rank) and bench_overlap's
# store setup
SUPPRESSED_MX311 = {
    "mxnet_tpu": ["kvstore.py", "model.py"],
    "mxnet_tpu_torch": ["bench_ckpt.py", "bench_ckpt.py",
                        "bench_controller.py", "bench_elastic.py",
                        "bench_elastic.py", "bench_lockwatch.py",
                        "bench_overlap.py", "kvstore.py", "model.py"],
}


def test_tree_parity_sees_the_suppressed_sites(tree_parity):
    """With the pragmas off both lints see the sites each tree suppresses
    (MX311)."""
    tree, j, _ = tree_parity
    sites = [r for r in j if r[0] == "MX311"]
    assert sorted(os.path.basename(p) for _, p, _ in sites) == \
        SUPPRESSED_MX311[tree], (tree, sites)


# -- the self-lint: the port's tree -------------------------------------------

@pytest.fixture(scope="module")
def port_findings():
    return tsl.lint_paths([os.path.join(REPO, "mxnet_tpu_torch")])


def test_self_lint_package_clean(port_findings):
    """The port's tree: zero errors (MX101 among them)."""
    errors = [f for f in port_findings if f.is_error]
    assert not errors, "\n".join(f.format() for f in errors)


# the rules tests/test_mxlint.py keeps out of the JAX package's tree
# (test_tree_has_no_mxNNN_findings and test_self_lint_mxNNN_clean), and
# MX101 and MX805 (tests/test_shardcheck.py's test_self_lint_mx805_clean)
@pytest.mark.parametrize("rule_id", [
    "MX101", "MX306", "MX307", "MX308", "MX309", "MX310", "MX311",
    "MX312", "MX313", "MX314", "MX315", "MX316", "MX805"])
def test_tree_has_no_findings(port_findings, rule_id):
    findings = [f for f in port_findings if f.rule.id == rule_id]
    assert not findings, "\n".join(f.format() for f in findings)


def test_tree_lints_clean_of_warnings_too(port_findings):
    assert not port_findings, "\n".join(f.format() for f in port_findings)


def test_every_pragma_in_the_port_carries_a_rule_id():
    """A bare ``# mxlint: disable`` silences every rule on its line; the
    port's pragmas name theirs."""
    bare = []
    for path in tsl.iter_python_files([os.path.join(REPO,
                                                    "mxnet_tpu_torch")]):
        with open(path, encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                if "# mxlint: disable" in line and \
                        "# mxlint: disable=MX" not in line:
                    bare.append(f"{path}:{i}")
    assert not bare, bare


# -- the card phase's fixtures (chip_smoke.py, phase mxlint) ------------------

def _chip_smoke():
    import importlib
    import sys

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return importlib.import_module("chip_smoke")


def test_card_fixtures_lint_as_the_phase_requires():
    """The flagged copies give exactly MX306 and MX202, the clean ones
    nothing; each is the same text but for the barrier or the host read."""
    timed_bad, timed_ok, cap_bad, cap_ok = _chip_smoke().mxlint_fixtures()
    assert _rl(tlint(timed_bad, "fx.py")) == [("MX306", 10)]
    assert _rl(tlint(cap_bad, "fx.py")) == [("MX202", 7)]
    assert tlint(timed_ok, "fx.py") == [] and tlint(cap_ok, "fx.py") == []
    assert timed_ok.replace("    torch.cuda.synchronize()\n", "") == \
        timed_bad
    assert cap_bad.replace(".item()", "") == cap_ok
