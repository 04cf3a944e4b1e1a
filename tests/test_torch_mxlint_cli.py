"""The port's analysis CLI, ``python -m mxnet_tpu_torch.analysis``
(``mxnet_tpu_torch/analysis/__main__.py``), against the JAX package's
``python -m mxnet_tpu.analysis``: the same flags and exit codes (0 clean, 1
on errors, 2 on a bad path, 3 on new findings against a baseline, the
seeding run of ``--baseline`` 0), ``--ci`` rows, ``--select`` /
``--ignore``, JSON symbol files through the port's ``verify_json_file``,
``--list-rules`` with the JAX package's ids and severities, and
``--shardcheck`` over eight CPU replicas with 0 findings. Most cases call
``main(argv)`` in process; the self-lint and the import check run the
module in subprocesses, started together.
"""

import json
import os
import subprocess
import sys

import pytest

from mxnet_tpu.analysis import main as jmain
from mxnet_tpu_torch.analysis import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLEAN = "def f(x):\n    return x + 1\n"
ERROR = "import jax\n"                      # MX101, an error
WARNING = ("import time\n"                  # MX306, a warning
           "def bench(step, x):\n"
           "    t0 = time.time()\n"
           "    out = step(x)\n"
           "    return time.time() - t0\n")
THREAD = ("import threading\n"              # MX704, concurrency pass
          "def spawn():\n"
          "    t = threading.Thread(target=print)\n"
          "    t.start()\n")


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _run(capsys, argv):
    rc = tmain(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("text,flags,rc_want,rule", [
    (CLEAN, [], 0, None),
    (ERROR, [], 1, "MX101"),
    (WARNING, [], 0, "MX306"),
    (WARNING, ["--warnings-as-errors"], 1, "MX306"),
    (THREAD, [], 0, None),
    (THREAD, ["--concurrency"], 0, "MX704"),
    (THREAD, ["--concurrency", "--warnings-as-errors"], 1, "MX704"),
    (ERROR, ["--ignore", "MX101"], 0, None),
    (ERROR + WARNING, ["--select", "MX306"], 0, "MX306"),
], ids=["clean", "error", "warning", "warnings-as-errors", "thread",
        "concurrency", "concurrency-warnings-as-errors", "ignore",
        "select"])
def test_exit_codes(tmp_path, capsys, text, flags, rc_want, rule):
    path = _write(tmp_path, "seeded.py", text)
    rc, out, _ = _run(capsys, flags + [path])
    assert rc == rc_want, out
    rows = out.splitlines()[:-1]
    assert [r.split(": ")[1].split()[0] for r in rows] == \
        ([rule] if rule else [])
    assert out.splitlines()[-1].startswith("mxlint: checked 1 file(s)")


def test_select_and_ignore_filter(tmp_path, capsys):
    path = _write(tmp_path, "both.py", ERROR + WARNING)
    rc, out, _ = _run(capsys, [path])
    assert rc == 1 and "MX101" in out and "MX306" in out
    rc, out, _ = _run(capsys, ["--select", "MX306", path])
    assert rc == 0 and "MX101" not in out and "MX306" in out
    rc, out, _ = _run(capsys, ["--ignore", "MX306", path])
    assert rc == 1 and "MX101" in out and "MX306" not in out


def test_bad_path_is_exit_2(tmp_path, capsys):
    rc, out, err = _run(capsys, [str(tmp_path / "missing.py")])
    assert rc == 2 and "no such path" in err
    assert jmain([str(tmp_path / "missing.py")]) == 2


def test_ci_rows(tmp_path, capsys):
    path = _write(tmp_path, "seeded.py", ERROR)
    rc, out, _ = _run(capsys, ["--ci", path])
    assert rc == 1
    rows = [ln.split("\t") for ln in out.splitlines()[:-1]]
    assert rows == [["MX101", "error", path, "1", "0",
                     "`jax`: the port runs on torch and never imports JAX"]]


def test_quiet_prints_the_summary_only(tmp_path, capsys):
    path = _write(tmp_path, "seeded.py", ERROR)
    rc, out, _ = _run(capsys, ["--quiet", path])
    assert rc == 1 and out.splitlines() == [
        "mxlint: checked 1 file(s): 1 error(s), 0 warning(s)"]


def test_baseline_seeds_then_gates_new_findings(tmp_path, capsys):
    path = _write(tmp_path, "seeded.py", WARNING)
    baseline = str(tmp_path / "baseline.json")
    # the seeding run writes the current findings and exits clean
    rc, out, _ = _run(capsys, ["--baseline", baseline, path])
    assert rc == 0 and "baseline written" in out
    with open(baseline, encoding="utf-8") as fh:
        keys = json.load(fh)
    assert len(keys) == 1 and keys[0].startswith("MX306|")
    # unchanged: nothing new
    rc, out, _ = _run(capsys, ["--baseline", baseline, path])
    assert rc == 0 and "0 new vs baseline" in out
    # an unrelated edit above the finding moves its line: still known
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# moved\n" + WARNING)
    rc, _, _ = _run(capsys, ["--baseline", baseline, path])
    assert rc == 0
    # a new violation: exit 3, and only the new finding is printed
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(WARNING + ERROR)
    rc, out, _ = _run(capsys, ["--baseline", baseline, path])
    assert rc == 3 and "1 new vs baseline" in out
    assert "MX101" in out and "MX306" not in out.splitlines()[0]


def test_json_symbol_file(tmp_path, capsys):
    """A symbol .json goes through the port's graph.verify_json_file: the
    unreachable node of the JAX package's fixture is MX405."""
    import mxnet_tpu_torch as mt

    data = mt.sym.Variable("data")
    net = mt.symbol.FullyConnected(data=data, num_hidden=4, name="fc1")
    graph = json.loads(net.tojson())
    graph["nodes"].append({"op": "null", "name": "orphan", "inputs": []})
    path = _write(tmp_path, "net.json", json.dumps(graph))
    rc, out, _ = _run(capsys, [path])
    assert rc == 0 and "MX405" in out
    assert jmain([path]) == rc
    jout = capsys.readouterr()[0]
    assert "MX405" in jout


def test_list_rules_matches_the_jax_package(capsys):
    def rows(main):
        assert main(["--list-rules"]) == 0
        out = capsys.readouterr()[0]
        return [tuple(ln.split("]")[0].replace("[", "").split())
                for ln in out.splitlines()]

    t, j = rows(tmain), rows(jmain)
    assert t == j and len(t) == 41
    assert ("MX101", "error") in t and ("MX805", "warning") in t


def test_default_target_is_the_port(capsys):
    rc, out, _ = _run(capsys, ["--quiet"])
    n = sum(1 for _ in __import__(
        "mxnet_tpu_torch.analysis.source_lint", fromlist=["x"]
    ).iter_python_files([os.path.join(REPO, "mxnet_tpu_torch")]))
    assert rc == 0
    assert out.splitlines() == [
        f"mxlint: checked {n} file(s): 0 error(s), 0 warning(s)"]


def test_dedup_across_passes(tmp_path, capsys):
    """The concurrency pass re-reports nothing the source pass reported
    (MX100 once), and a finding is one row."""
    path = _write(tmp_path, "broken.py", "def broken(:\n")
    rc, out, _ = _run(capsys, ["--concurrency", path])
    assert rc == 1 and out.count("MX100") == 1


def test_shardcheck_over_eight_cpu_replicas(capsys):
    """The port's dp-8 full-stack step (int8 + overlap + comm kernels +
    health + guards) over eight CPU replicas reconciles against its comm
    plan: 0 findings, exit 0, nothing else linted."""
    rc, out, err = _run(capsys, ["--shardcheck"])
    assert rc == 0, out + err
    assert "dp-8 full-stack step reconciles against its comm plan " \
        "(0 findings)" in out
    assert out.splitlines()[-1] == \
        "mxlint: checked 0 file(s): 0 error(s), 0 warning(s)"


# -- the module itself, in subprocesses ----------------------------------------

_IMPORTS = (
    "import sys\n"
    "import mxnet_tpu_torch.analysis.source_lint, "
    "mxnet_tpu_torch.analysis.concurrency\n"
    "bad = sorted(m for m in sys.modules\n"
    "             if m.split('.')[0] in ('jax', 'jaxlib', 'mxnet_tpu'))\n"
    "print(bad)\n")


@pytest.fixture(scope="module")
def subprocess_runs(tmp_path_factory):
    seeded = tmp_path_factory.mktemp("cli") / "seeded.py"
    seeded.write_text(ERROR)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    cmds = {
        "self_lint": [sys.executable, "-m", "mxnet_tpu_torch.analysis",
                      "mxnet_tpu_torch", "--concurrency"],
        "seeded": [sys.executable, "-m", "mxnet_tpu_torch.analysis",
                   str(seeded)],
        "imports": [sys.executable, "-c", _IMPORTS],
    }
    procs = {k: subprocess.Popen(c, cwd=REPO, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    out = {}
    for k, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=240)
        finally:
            p.kill()
        out[k] = (p.returncode, stdout, stderr)
    return out


def test_self_lint_exits_0(subprocess_runs):
    """``python -m mxnet_tpu_torch.analysis mxnet_tpu_torch --concurrency``
    exits 0: the tier-1 gate of the port's own tree."""
    rc, out, err = subprocess_runs["self_lint"]
    assert rc == 0, out + err
    assert ": 0 error(s), 0 warning(s)" in out.splitlines()[-1]


def test_seeded_violation_exits_1(subprocess_runs):
    rc, out, _ = subprocess_runs["seeded"]
    assert rc == 1 and "MX101" in out


def test_passes_import_no_jax(subprocess_runs):
    rc, out, err = subprocess_runs["imports"]
    assert rc == 0, err
    assert out.strip() == "[]"
