"""The port's telemetry hub, exporters, timeline, distributed tracing,
flight recorder, run ledger and CLI against the JAX package's.

The same calls on both packages' hubs give the same snapshot and the same
Prometheus text; each package reads the JSONL, flight dumps and ledger
records the other writes; the two CLIs print the same text on the same
files (the JAX one as ``python -m mxnet_tpu.telemetry`` in a subprocess);
``merge_traces`` and ``detect_stragglers`` give the same result on the
per-rank streams of two gloo ranks fitting with telemetry on. Timestamps,
run ids and pids differ between two processes and are left out of the
comparisons that would read them."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import telemetry as jt
from mxnet_tpu.utils import compile as jcompile
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.telemetry.__main__ import main as port_cli
from mxnet_tpu_torch.utils import compile as tcompile

from torch_ranks import run_ranks, telemetry_fit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOLATILE = ("ts", "wall_ts", "run_id", "pid", "trace_id", "span_id",
            "start", "host", "path", "log_dir")


def _strip(value):
    """``value`` without the keys that name a process or a moment."""
    if isinstance(value, dict):
        return {k: _strip(v) for k, v in value.items() if k not in VOLATILE}
    if isinstance(value, list):
        return [_strip(v) for v in value]
    return value


def _fresh_hubs():
    for pkg_t, comp, comm in ((jt, jcompile, mx.comm),
                              (tt, tcompile, mt.comm)):
        comp.reset_compile_stats()
        comm.reset_comm_stats()
        pkg_t.reset()


def _drive(t, rng):
    """The same hub calls, drawn from ``rng``."""
    for i in range(5):
        t.counter("pushes_total", float(rng.randint(1, 4)), key=f"w{i % 2}")
        t.gauge("queue_depth", float(rng.randint(0, 9)))
        t.observe("push_ms", float(rng.rand() * 10), key="w1")
    t.emit("retry", op="push", attempt=2)
    with t.timed("stage"):
        pass


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hub_snapshot_and_prom_dump_match(seed):
    _fresh_hubs()
    _drive(jt, np.random.RandomState(seed))
    _drive(tt, np.random.RandomState(seed))
    js, ts = jt.hub().snapshot(), tt.hub().snapshot()
    for section in ("counters", "gauges", "collected"):
        assert ts[section] == js[section], section
    jh = {k: v for k, v in js["histograms"].items() if "stage" not in k}
    th = {k: v for k, v in ts["histograms"].items() if "stage" not in k}
    assert th == jh
    assert ts["events"] == js["events"]
    drop = ("stage_seconds",)
    assert [l for l in tt.prom_dump().splitlines() if not any(
        d in l for d in drop)] == [l for l in jt.prom_dump().splitlines()
                                   if not any(d in l for d in drop)]


def test_golden_keys_and_schema_are_the_jax_packages():
    assert tt.SCHEMA_VERSION == jt.SCHEMA_VERSION
    assert tt.EVENT_GOLDEN_KEYS == jt.EVENT_GOLDEN_KEYS
    assert tt.DEFAULT_COUNTERS == jt.DEFAULT_COUNTERS


@pytest.mark.parametrize("writer,reader", [(tt, jt), (jt, tt)])
def test_jsonl_read_across_packages(tmp_path, writer, reader):
    _fresh_hubs()
    path = str(tmp_path / "run.jsonl")
    sink = writer.hub().add_sink(writer.JsonlWriter(path))
    _drive(writer, np.random.RandomState(3))
    writer.emit("checkpoint", step=1, seconds=0.5, tier="t2")
    writer.hub().remove_sink(sink)
    sink.close()
    mine = writer.read_events(path)
    theirs = reader.read_events(path)
    assert theirs == mine and len(mine) >= 2
    for e in theirs:
        assert set(reader.EVENT_GOLDEN_KEYS.get(e["kind"], ())) <= set(e)


@pytest.mark.parametrize("env,expected", [
    ({}, None), ({"MXNET_TPU_TELEMETRY": "1"}, True),
    ({"MXNET_TPU_TELEMETRY": "off"}, None),
    ({"MXNET_TPU_TELEMETRY": "/x/run.jsonl"}, "/x/run.jsonl")])
def test_telemetry_config_resolves_as_jax(monkeypatch, env, expected):
    monkeypatch.delenv("MXNET_TPU_TELEMETRY", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for pkg in (jt, tt):
        cfg = pkg.TelemetryConfig.resolve(None)
        if expected is None:
            assert cfg is None
        elif expected is True:
            assert cfg.timeline and cfg.jsonl is None
        else:
            assert cfg.jsonl == expected
    assert repr(tt.TelemetryConfig()) == repr(jt.TelemetryConfig())


def test_timeline_phases_and_chrome_trace():
    tl = tt.StepTimeline()
    tl.note_data_wait(0.001)
    with tl.begin_step(0, 0) as span:
        span.mark("dispatch")
        with tt.phase("kvstore_push"):
            pass
        span.mark("device")
        span.mark("host")
    names = [n for n, _, _ in tl.spans[0].phases()]
    assert names == ["data_wait", "dispatch", "device", "host"]
    assert tl.spans[0].subs[0][0] == "kvstore_push"
    trace = tl.to_chrome_trace()
    assert {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"} >= {
        "step[0]", "dispatch", "device", "host"}


def test_fit_timeline_device_phase_and_mfu(tmp_path):
    """A CPU fit with telemetry on: one span a step with the JAX
    package's phases, the MFU accountant's FLOPs, and the JSONL stream
    with every event's golden keys."""
    _fresh_hubs()
    rng = np.random.RandomState(0)
    X = rng.randn(40, 64).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    path = str(tmp_path / "fit.jsonl")
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=2,
                           learning_rate=0.1)
    model.fit(X, y, batch_size=10,
              telemetry=tt.TelemetryConfig(jsonl=path))
    spans = model.telemetry.steps()
    assert len(spans) == 8
    assert [n for n, _, _ in spans[0].phases()][1:] == \
        ["dispatch", "device", "host"]
    assert model.mfu.flops_per_step > model.mfu.contraction_flops > 0
    events = jt.read_events(path)
    kinds = {e["kind"] for e in events}
    assert {"span", "epoch_summary"} <= kinds
    for e in events:
        assert set(jt.EVENT_GOLDEN_KEYS.get(e["kind"], ())) <= set(e), e
    report = model.telemetry.spans[-1].to_dict()
    assert report["rank"] == 0 and report["name"] == "step"


# -- flight recorder and ledger across packages -------------------------------

@pytest.mark.parametrize("writer,reader", [(tt, jt), (jt, tt)])
def test_flight_dump_validates_across_packages(tmp_path, writer, reader):
    _fresh_hubs()
    writer.flight.reset()
    writer.flight.note_step(0, 3)
    writer.emit("retry", op="push", attempt=1)
    path = str(tmp_path / "flight.json")
    writer.flight.dump(path, reason="unit")
    ok, payload = reader.validate_flight(path)
    assert ok, payload
    ok2, payload2 = writer.validate_flight(path)
    assert ok2 and _strip(payload2) == _strip(payload)
    data = json.load(open(path))
    data["payload"]["reason"] = "tampered"
    json.dump(data, open(path, "w"))
    assert not reader.validate_flight(path)[0]


@pytest.mark.parametrize("writer,reader", [(tt, jt), (jt, tt)])
def test_ledger_records_read_across_packages(tmp_path, writer, reader):
    _fresh_hubs()
    d = str(tmp_path / "ledger")
    h = writer.hub()
    t0 = h.now()
    for i in range(5):
        h.emit("span", name="step", epoch=0, step=i, dur_ms=10.0 + i)
    rec = writer.ledger.distill("fit", fingerprint="fp-1", world_size=2,
                                knobs={"compression": "int8"}, since_ts=t0)
    path = writer.ledger.append_record(rec, directory=d)
    assert os.path.exists(path + ".crc32")
    rows = reader.read_ledger(d)
    assert len(rows) == 1 and rows[0]["record_id"] == rec["record_id"]
    assert rows[0]["outcomes"]["step_ms_p50"] == 12.0
    assert _strip(writer.read_ledger(d)) == _strip(rows)
    with open(path, "a") as f:  # torn: the sidecar no longer matches
        f.write(" ")
    assert reader.read_ledger(d) == []


def test_publish_bench_full_and_smoke(tmp_path, monkeypatch):
    """tests/test_ledger.py::test_publish_bench_full_and_smoke over the
    port's ledger."""
    d = str(tmp_path / "ledger")
    bench_dir = str(tmp_path / "bench")
    os.makedirs(bench_dir)
    monkeypatch.setenv("MXNET_TPU_LEDGER_DIR", d)
    result = {"metric": "widget_bench_ms", "value": 3.5, "unit": "ms",
              "vs_baseline": 1.2, "detail": {"x": 1}}
    out = tt.ledger.publish_bench(result, filename="BENCH_WIDGET_r99.json",
                                  bench_dir=bench_dir)
    assert json.load(open(out["bench_path"]))["value"] == 3.5
    assert out["record"]["kind"] == "bench"
    assert out["record"]["outcomes"]["metric"] == "widget_bench_ms"
    assert out["ledger_path"] is not None
    combined = json.load(open(out["bench_ledger_path"]))
    assert os.path.dirname(out["bench_ledger_path"]) == bench_dir
    assert os.path.basename(out["bench_ledger_path"]) == \
        jt.ledger.BENCH_LEDGER_NAME
    assert combined["records"][-1]["outcomes"]["value"] == 3.5

    # smoke: no per-bench artifact; the trajectory regenerates into the
    # ledger dir (so CI gating can still read it) and marks the record
    out2 = tt.ledger.publish_bench({"metric": "widget_bench_ms",
                                    "value": 4.0, "unit": "ms"},
                                   filename="BENCH_WIDGET_r99.json",
                                   bench_dir=bench_dir, smoke=True)
    assert out2["bench_path"] is None
    assert os.path.dirname(out2["bench_ledger_path"]) == d
    assert out2["record"]["outcomes"]["smoke"] is True
    rows = [r for r in tt.ledger.read_ledger(d) if r["kind"] == "bench"]
    assert len(rows) == 2


_IDS_AND_TIMES = ("record_id", "run_id", "trace_id", "wall_ts")


@pytest.mark.parametrize("smoke", [False, True])
def test_publish_bench_writes_what_jax_writes(tmp_path, monkeypatch, smoke):
    """The same headline through both packages' ``publish_bench``: the same
    files (per-bench JSON and trajectory, by name and content) and the same
    record, field by field, apart from its ids and times."""
    result = {"metric": "widget_bench_ms", "value": 3.5, "unit": "ms",
              "vs_baseline": 1.2, "world": 2, "detail": {"x": [1, 2]}}
    outs, files = {}, {}
    for name, pkg in (("jax", jt), ("port", tt)):
        root = tmp_path / name
        (root / "bench").mkdir(parents=True)
        monkeypatch.setenv("MXNET_TPU_LEDGER_DIR", str(root / "ledger"))
        outs[name] = pkg.ledger.publish_bench(
            result, filename="BENCH_WIDGET_r99.json",
            bench_dir=str(root / "bench"), smoke=smoke)
        files[name] = {
            os.path.relpath(os.path.join(dp, f), root)
            for dp, _, fs in os.walk(root) for f in fs
            if not f.startswith("run-")}
    jrec, trec = outs["jax"]["record"], outs["port"]["record"]
    assert sorted(jrec) == sorted(trec)
    for key in jrec:
        if key not in _IDS_AND_TIMES:
            assert trec[key] == jrec[key], key
    assert files["port"] == files["jax"]
    assert (outs["port"]["bench_path"] is None) == smoke
    if not smoke:
        with open(outs["port"]["bench_path"]) as f, \
                open(outs["jax"]["bench_path"]) as g:
            assert f.read() == g.read()
    trail = [json.load(open(outs[n]["bench_ledger_path"]))
             for n in ("jax", "port")]
    assert [_strip_ids(r) for r in trail[1]["records"]] == \
        [_strip_ids(r) for r in trail[0]["records"]]
    assert trail[1]["ledger_schema"] == trail[0]["ledger_schema"]


def _strip_ids(record):
    """A trajectory row without its ids, times and the path ``read_ledger``
    read it from."""
    return {k: v for k, v in record.items()
            if k not in _IDS_AND_TIMES and k != "_path"}


def test_fit_and_predict_land_ledger_records(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_LEDGER_DIR", str(tmp_path / "ledger"))
    rng = np.random.RandomState(1)
    X = rng.randn(20, 64).astype(np.float32)
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=1)
    model.fit(X, (X[:, 0] > 0).astype(np.float32), batch_size=10,
              health=True)
    model.predict(X, batch_size=10, telemetry=True)
    rows = jt.read_ledger(str(tmp_path / "ledger"))
    assert [r["kind"] for r in rows] == ["fit", "predict"]
    assert rows[0]["knobs"]["health"] is True
    assert rows[0]["completed"] is True


# -- the CLIs -----------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A port fit's JSONL (telemetry, health, profile on), a second one
    for ``diff``, a flight dump and a ledger: the CLIs' inputs."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(2)
    X = rng.randn(48, 64).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    os.environ["MXNET_TPU_LEDGER_DIR"] = str(d / "ledger")
    try:
        for name in ("a", "b"):
            model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=2,
                                   learning_rate=0.1)
            model.fit(X, y, batch_size=8,
                      telemetry=tt.TelemetryConfig(jsonl=str(d / f"{name}.jsonl")),
                      health=True,
                      profile=tt.ProfileConfig(steps=2, warmup=1))
    finally:
        del os.environ["MXNET_TPU_LEDGER_DIR"]
    tt.flight.dump(str(d / "flight.json"), reason="unit")
    return d


CLI_CASES = [
    ["summarize", "{d}/a.jsonl"],
    ["tail", "{d}/a.jsonl", "-n", "7"],
    ["tail", "{d}/a.jsonl", "--kind", "health", "-n", "3"],
    ["health", "{d}/a.jsonl"],
    ["profile", "{d}/a.jsonl"],
    ["mem", "{d}/a.jsonl"],
    ["diff", "{d}/a.jsonl", "{d}/b.jsonl", "--threshold", "1000"],
    ["flight", "validate", "{d}/flight.json"],
    ["ledger", "list", "--dir", "{d}/ledger"],
]


@pytest.fixture(scope="module")
def jax_cli_outputs(cli_files):
    """Every case through ``python -m mxnet_tpu.telemetry``, the
    subprocesses started together."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu.telemetry",
         *[a.format(d=cli_files) for a in case]], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for case in CLI_CASES]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=240)
        out.append((p.returncode, stdout, stderr))
    return out


@pytest.mark.parametrize("index", range(len(CLI_CASES)),
                         ids=[" ".join(c[:2]).replace("{d}/", "")
                              for c in CLI_CASES])
def test_cli_prints_what_the_jax_cli_prints(cli_files, jax_cli_outputs,
                                            index, capsys):
    args = [a.format(d=cli_files) for a in CLI_CASES[index]]
    rc = port_cli(args)
    out = capsys.readouterr().out
    jrc, jout, jerr = jax_cli_outputs[index]
    assert (rc or 0) == jrc, jerr
    assert out == jout
    assert out.strip()


# -- distributed tracing over two gloo ranks ---------------------------------

@pytest.fixture(scope="module")
def rank_streams(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    rng = np.random.RandomState(4)
    X = rng.randn(48, 20).astype(np.float32)
    Y = rng.randint(0, 10, 48).astype(np.float32)
    return run_ranks(telemetry_fit, 2, d, X, Y, str(d / "rank{}.jsonl"), 4)


def test_merge_traces_matches_jax(rank_streams, tmp_path):
    tj, rj = jt.merge_traces(rank_streams, out=str(tmp_path / "j.json"))
    tp, rp = tt.merge_traces(rank_streams, out=str(tmp_path / "t.json"))
    assert rp == rj
    assert tp == tj
    assert sorted(rp["ranks"]) == [0, 1]
    assert rp["trace_ids"]


def test_detect_stragglers_matches_jax(rank_streams):
    sj = jt.detect_stragglers(jt.load_rank_streams(rank_streams),
                              publish=False)
    sp = tt.detect_stragglers(tt.load_rank_streams(rank_streams),
                              publish=False)
    assert sp == sj
    assert set(sp) >= {"stragglers", "skew_seconds"}


def test_rank_streams_carry_rank_identity(rank_streams):
    for r, path in enumerate(rank_streams):
        events = tt.read_events(path)
        spans = [e for e in events if e["kind"] == "span"]
        assert len(spans) == 4
        assert {e["rank"] for e in events} == {r}
        assert {e["world_size"] for e in events} == {2}


def test_streaming_straggler_detector_and_comm_ratio(rank_streams):
    """The live detector fed the ranks' span events, and the comm:compute
    sensor over them, as the JAX package's."""
    streams = tt.load_rank_streams(rank_streams)
    dets = [jt.StreamingStragglerDetector(), tt.StreamingStragglerDetector()]
    for rank in sorted(streams):
        for e in streams[rank]:
            for det in dets:
                det.write_event(e)
    assert dets[1].report() == dets[0].report()
    assert tt.comm_compute_ratio(streams) == \
        jt.comm_compute_ratio(jt.load_rank_streams(rank_streams))
