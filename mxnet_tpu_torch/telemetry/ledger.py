"""Cross-run telemetry ledger: persistent RunRecords, trend gates, knob
attribution.

Every observability layer before this one dies with the process: the hub
ring is in-memory, the JSONL sink ends where the stream was cut, and
``telemetry diff`` is pairwise — two files, one comparison, no history.
ROADMAP item 4 (profile-guided auto-tuning) needs measured winners
"persisted keyed by (model fingerprint, world, backend)" and had nothing
to persist into. This module is that store:

  **RunRecord** — at the end of every ``fit``/``predict``/bench run,
  :func:`distill` folds the run's event stream into ONE compact,
  schema-versioned dict: identity (``run_id``/``trace_id``, the
  ``graph_fingerprint`` of the trained symbol, world size, backend, and
  the knob vector — compression tier, overlap byte-cap, comm-kernels
  flag, fused-Adam, pad policy, health/profile/guard gates, checkpoint
  cadence) plus outcomes (step p50/p90/p99, modeled + measured MFU,
  goodput and the badput buckets, top-K per-layer device ms, comm wire
  bytes vs the fp32 plan, the peak live-array watermark, anomaly/
  incident/resize counts). Host-side distillation over the hub ring —
  no device work, no jit-cache keys touched.

  **append-only store** — :func:`append_record` writes one file per
  record (``run-<ms>-<pid>-<id>.json``) through
  ``utils.checkpoint.atomic_write`` — tmp + rename with a CRC32 sidecar,
  the exact discipline the checkpoint plane uses — into the directory
  named by ``MXNET_TPU_LEDGER_DIR`` (unset = the ledger is off; a
  library must not scatter files by default). One-file-per-record makes
  concurrent appends from N processes trivially safe: no shared file, no
  lock, no torn lines. :func:`read_ledger` CRC-checks every record and
  SKIPS corrupt ones with a warning — one bad byte must not take the
  history down.

  **gates + attribution** — ``python -m mxnet_tpu_torch.telemetry ledger
  list|show|trend|compare|regress``. ``trend`` gates the newest
  matching-fingerprint record against the median of its N predecessors
  (exit 3 on regression: the N-run successor to pairwise ``diff``);
  ``regress`` is the pairwise newest-vs-previous form. ``compare`` finds
  record pairs that differ in EXACTLY ONE knob and attributes their
  step-time/wire-byte delta to that knob — measurement-driven tuning
  needs to know which knob bought what.

  **warm start** — :func:`warm_start_tier` is the read-only
  FleetController sensor: the historically best completed fit for
  (fingerprint, world, backend) seeds the controller's tier cache, so
  retier starts from the measured winner instead of exploring blind
  (the seed of ROADMAP item 4's offline store).

  **bench integration** — :func:`publish_bench` is the one writer of a
  benchmark's headline: its per-bench JSON file (full runs only), a
  ``kind="bench"`` RunRecord, and :data:`BENCH_LEDGER_NAME`, every bench
  record the ledger holds in one file.

Every write lands here or nowhere.
"""

from __future__ import annotations

import collections
import json
import logging
import os

from ..analysis.lockwatch import named_lock

__all__ = ["LEDGER_SCHEMA", "ledger_dir", "distill", "append_record",
           "record_run", "read_ledger", "match", "metric_direction",
           "trend_gate", "knob_attribution", "best_record",
           "warm_start_tier", "publish_bench", "BENCH_LEDGER_NAME"]

LEDGER_SCHEMA = 1

# the per-bench headline aggregation: the trajectory as ONE
# machine-readable file instead of N ad-hoc JSONs
BENCH_LEDGER_NAME = "BENCH_LEDGER_r20.json"

# knob vector keys every fit record carries (absent knobs read as None so
# compare() can pair records across versions)
KNOB_KEYS = ("compression", "overlap_bytes", "comm_kernels", "fused_adam",
             "pad_policy", "health", "profile", "guards", "ckpt_every")

# gateable outcome -> higher-is-worse (the diff-gate convention)
_METRIC_WORSE_UP = {
    "step_ms_p50": True, "step_ms_p90": True, "step_ms_p99": True,
    "wall_seconds": True, "wire_bytes": True, "peak_mem_bytes": True,
    "value": True,            # bench headline (latency-style by default)
    "mfu_pct": False, "measured_mfu_pct": False, "goodput_pct": False,
}

_LOCK = named_lock("telemetry.ledger.store")
_SEQ = collections.defaultdict(int)  # run_id -> records appended


def ledger_dir(directory=None):
    """The ledger store directory: an explicit argument wins, else
    ``MXNET_TPU_LEDGER_DIR``; None = the ledger is disabled."""
    if directory:
        return os.fspath(directory)
    d = os.environ.get("MXNET_TPU_LEDGER_DIR", "").strip()
    return d or None


def metric_direction(name):
    """True when a larger value is a regression (step time, bytes);
    False for the higher-is-better family (MFU, goodput)."""
    return _METRIC_WORSE_UP.get(name, True)


# -- distillation --------------------------------------------------------------

def _pctl(sorted_vals, q):
    """Linear-interpolated percentile — the same math the hub Histogram
    and ``telemetry diff`` use, without importing numpy (the ledger is
    stdlib-only)."""
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    rank = (float(q) / 100.0) * (len(sorted_vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


def _median(vals):
    vals = sorted(vals)
    return _pctl(vals, 50) if vals else None


def distill(kind, fingerprint=None, world_size=None, backend=None,
            knobs=None, completed=True, since_ts=None, span_name="step",
            events=None, comm_start=None, wall_seconds=None,
            extra_outcomes=None):
    """Fold one run's event stream into a RunRecord dict (no I/O).

    ``since_ts`` bounds the window to this run (the hub ring survives
    across fits in one process — tests run many); ``events`` overrides
    the ring (offline distillation of a JSONL file). ``comm_start`` is a
    ``comm.registry().stats()`` taken at run start, so wire bytes are
    this run's delta, not process totals — priced per program at the
    CURRENT plan (a later fit with a different tier overwrites the plan
    under the same ``train_step:<fp>`` label, so whole-total snapshot
    deltas retroactively reprice earlier runs and can even go negative;
    per-label step deltas x this run's plan are exact for this run)."""
    from .distributed import trace_id as _trace_id, world_size as _world
    from .flight import INCIDENT_KINDS
    from .hub import hub as _hub

    h = _hub()
    if events is None:
        events = h.events()
    if since_ts is not None:
        events = [e for e in events if e.get("ts", 0.0) >= since_ts]

    durs = sorted(float(e.get("dur_ms", 0.0)) for e in events
                  if e.get("kind") == "span"
                  and e.get("name", "step") == span_name)
    epoch_rows = [e for e in events if e.get("kind") == "epoch_summary"]
    mfu = [float(e["mfu_pct"]) for e in epoch_rows
           if isinstance(e.get("mfu_pct"), (int, float))]
    goodput = [float(e["goodput_pct"]) for e in epoch_rows
               if isinstance(e.get("goodput_pct"), (int, float))]
    badput = collections.Counter()
    for e in epoch_rows:
        for k, v in e.items():
            if k.startswith("badput_") and k.endswith("_seconds") and \
                    isinstance(v, (int, float)):
                badput[k[len("badput_"):-len("_seconds")]] += float(v)

    prof = None
    for e in events:  # newest attributed capture wins
        if e.get("kind") == "profile" and \
                e.get("phase", "summary") == "summary":
            prof = e
    top_layers = {}
    measured_mfu = None
    if prof is not None:
        layers = prof.get("layers") or {}
        for name, ms in sorted(layers.items(),
                               key=lambda kv: -float(kv[1]))[:8]:
            top_layers[name] = round(float(ms), 4)
        pm = (prof.get("mfu") or {}).get("measured_mfu_pct")
        if isinstance(pm, (int, float)):
            measured_mfu = float(pm)

    peaks = [float(e.get("watermark_bytes", 0.0)) for e in events
             if e.get("kind") == "memory_watermark"]
    incidents = sum(1 for e in events if e.get("kind") in INCIDENT_KINDS)

    wire = fp32_wire = None
    if comm_start is not None:
        try:
            from .. import comm as comm_mod

            now = comm_mod.registry().stats()
            then = comm_start.get("per_program", {})
            wire = fp32_wire = 0.0
            for label, prog in now.get("per_program", {}).items():
                dsteps = max(0, int(prog.get("steps", 0)) -
                             int(then.get(label, {}).get("steps", 0)))
                wire += dsteps * float(prog.get("wire_bytes", 0.0))
                fp32_wire += dsteps * float(prog.get("fp32_wire_bytes", 0.0))
            then_host = comm_start.get("host_bytes", {})
            now_host = now.get("host_bytes", {})
            wire += max(0.0, sum(float(v) for v in now_host.values()) -
                        sum(float(v) for v in then_host.values()))
        except Exception:  # comm layer absent/reset mid-run: no bytes row
            wire = fp32_wire = None

    outcomes = {
        "steps": len(durs),
        "epochs": len(epoch_rows),
        "step_ms_p50": _pctl(durs, 50),
        "step_ms_p90": _pctl(durs, 90),
        "step_ms_p99": _pctl(durs, 99),
        "mfu_pct": (sum(mfu) / len(mfu)) if mfu else None,
        "measured_mfu_pct": measured_mfu,
        "goodput_pct": (sum(goodput) / len(goodput)) if goodput else None,
        "badput": dict(badput),
        "top_layers_ms": top_layers,
        "wire_bytes": wire,
        "fp32_wire_bytes": fp32_wire,
        "peak_mem_bytes": max(peaks) if peaks else None,
        "anomalies": sum(1 for e in events
                         if e.get("kind") == "health_anomaly"),
        "incidents": incidents,
        "resizes": sum(1 for e in events if e.get("kind") == "resize"),
        "wall_seconds": wall_seconds,
    }
    if extra_outcomes:
        outcomes.update(extra_outcomes)

    knob_row = {k: None for k in KNOB_KEYS}
    if knobs:
        knob_row.update(knobs)
    run_id = getattr(h, "run_id", None)
    with _LOCK:
        _SEQ[run_id] += 1
        seq = _SEQ[run_id]
    return {
        "ledger_schema": LEDGER_SCHEMA,
        "record_id": f"{run_id}-{seq:03d}",
        "run_id": run_id,
        "trace_id": _trace_id(),
        "kind": str(kind),
        "fingerprint": None if fingerprint is None else str(fingerprint),
        "world_size": int(world_size) if world_size else _world(),
        "backend": str(backend or _default_backend()),
        "pid": os.getpid(),
        "wall_ts": h.now(),
        "completed": bool(completed),
        "knobs": knob_row,
        "outcomes": outcomes,
    }


def _default_backend():
    try:
        import torch

        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:  # distilling without torch (CLI tooling)
        return "unknown"


# -- the one writer ------------------------------------------------------------

def append_record(record, directory=None, logger=None):
    """Atomically append one RunRecord to the ledger directory (tmp +
    rename + CRC32 sidecar via the checkpoint writer). Returns the
    record path, or None when no directory is configured — recording
    must be a no-op, never an error, on unconfigured rigs."""
    directory = ledger_dir(directory)
    if directory is None:
        return None
    from ..utils.checkpoint import atomic_write
    from .hub import hub as _hub

    os.makedirs(directory, exist_ok=True)
    name = (f"run-{int(float(record.get('wall_ts', 0.0)) * 1000):013d}"
            f"-{record.get('pid', os.getpid())}"
            f"-{record.get('record_id', 'anon')}.json")
    path = os.path.join(directory, name)

    def _write(tmp):
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(record, f, sort_keys=True, indent=1, default=str)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())

    atomic_write(path, _write)
    _hub().emit("run_summary", run_id=record.get("run_id"),
                fingerprint=record.get("fingerprint"),
                backend=record.get("backend"),
                source=record.get("kind"),
                record_id=record.get("record_id"), path=path)
    (logger or logging).info("ledger: recorded %s run %s -> %s",
                             record.get("kind"),
                             record.get("record_id"), path)
    return path


def record_run(kind, directory=None, logger=None, **distill_kwargs):
    """distill + append in one call — THE end-of-run hook fit/predict/
    bench use. Fast no-op (no distillation) when the ledger is off."""
    directory = ledger_dir(directory)
    if directory is None:
        return None
    record = distill(kind, **distill_kwargs)
    append_record(record, directory=directory, logger=logger)
    return record


# -- reading -------------------------------------------------------------------

def read_ledger(directory=None, logger=None):
    """All readable records, oldest first. A record whose CRC sidecar
    fails is SKIPPED with a warning (skipped-not-fatal: one torn file
    must not take the run history down); sidecar-less files are legacy-
    accepted like the checkpoint loader does."""
    directory = ledger_dir(directory)
    if directory is None or not os.path.isdir(directory):
        return []
    from ..utils.checkpoint import check_sidecar

    out = []
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("run-") and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        if check_sidecar(path) is False:
            (logger or logging).warning(
                "ledger: %s failed its CRC sidecar — skipping the record "
                "(torn or corrupt; the rest of the history stands)", path)
            continue
        try:
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError) as e:
            (logger or logging).warning("ledger: unreadable record %s: %s",
                                        path, e)
            continue
        if isinstance(rec, dict):
            rec.setdefault("knobs", {})
            rec.setdefault("outcomes", {})
            rec["_path"] = path
            out.append(rec)
    out.sort(key=lambda r: float(r.get("wall_ts", 0.0)))
    return out


def match(records, fingerprint=None, world=None, backend=None, kind=None,
          bench_metric=None, completed=None):
    """Filter records on identity — trend/compare/warm-start must only
    reason across runs of the SAME program shape."""
    out = []
    for r in records:
        if fingerprint is not None and r.get("fingerprint") != fingerprint:
            continue
        if world is not None and int(r.get("world_size", 0)) != int(world):
            continue
        if backend is not None and r.get("backend") != backend:
            continue
        if kind is not None and r.get("kind") != kind:
            continue
        if bench_metric is not None and \
                r.get("outcomes", {}).get("metric") != bench_metric:
            continue
        if completed is not None and \
                bool(r.get("completed", True)) != bool(completed):
            continue
        out.append(r)
    return out


def _metric_of(record, name):
    v = record.get("outcomes", {}).get(name)
    return float(v) if isinstance(v, (int, float)) else None


# -- gates ---------------------------------------------------------------------

def trend_gate(records, metric="step_ms_p50", n=8, threshold=10.0):
    """Gate the NEWEST record against the median of its (up to) n-1
    predecessors carrying the metric. Returns a report dict with
    ``regressed`` set when the delta breaches ``threshold`` percent in
    the metric's worse direction — the N-run successor to pairwise
    ``telemetry diff`` (and the same exit-3 CI contract)."""
    rows = [(r, _metric_of(r, metric)) for r in records]
    rows = [(r, v) for r, v in rows if v is not None]
    if len(rows) < 2:
        return {"metric": metric, "n": len(rows), "regressed": False,
                "reason": f"need >= 2 records with {metric!r}, have "
                          f"{len(rows)}"}
    window = rows[-int(n):]
    latest_rec, latest = window[-1]
    baseline = _median([v for _, v in window[:-1]])
    if baseline == 0:
        return {"metric": metric, "n": len(window), "baseline": baseline,
                "latest": latest, "regressed": False,
                "reason": "zero baseline, not gated"}
    delta_pct = (latest - baseline) / abs(baseline) * 100.0
    regression = delta_pct if metric_direction(metric) else -delta_pct
    return {"metric": metric, "n": len(window), "baseline": baseline,
            "latest": latest, "latest_record": latest_rec.get("record_id"),
            "delta_pct": delta_pct, "threshold": float(threshold),
            "regressed": regression > float(threshold)}


def knob_attribution(records, metrics=("step_ms_p50", "wire_bytes"),
                     max_records=64):
    """Pairs of records that differ in EXACTLY ONE knob, with the metric
    deltas attributed to that knob. Records are grouped on identity
    first (fingerprint, world, backend, kind) — a knob only explains a
    delta when everything else matched."""
    groups = collections.defaultdict(list)
    for r in records:
        groups[(r.get("fingerprint"), int(r.get("world_size", 0)),
                r.get("backend"), r.get("kind"))].append(r)
    rows = []
    for ident, group in groups.items():
        group = group[-int(max_records):]
        for i, a in enumerate(group):
            for b in group[i + 1:]:
                ka, kb = a.get("knobs", {}), b.get("knobs", {})
                diff = [k for k in set(ka) | set(kb)
                        if ka.get(k) != kb.get(k)]
                if len(diff) != 1:
                    continue
                knob = diff[0]
                deltas = {}
                for m in metrics:
                    va, vb = _metric_of(a, m), _metric_of(b, m)
                    if va is None or vb is None or va == 0:
                        continue
                    deltas[m] = {"a": va, "b": vb,
                                 "delta_pct": (vb - va) / abs(va) * 100.0}
                if not deltas:
                    continue
                rows.append({
                    "knob": knob,
                    "a_value": ka.get(knob), "b_value": kb.get(knob),
                    "a_record": a.get("record_id"),
                    "b_record": b.get("record_id"),
                    "fingerprint": ident[0], "world_size": ident[1],
                    "deltas": deltas,
                })
    return rows


def best_record(records, metric="step_ms_p50"):
    """The completed record with the best metric value (direction-aware);
    None when nothing carries it."""
    rows = [(r, _metric_of(r, metric)) for r in records
            if r.get("completed", True)]
    rows = [(r, v) for r, v in rows if v is not None]
    if not rows:
        return None
    worse_up = metric_direction(metric)
    return min(rows, key=lambda rv: rv[1] if worse_up else -rv[1])[0]


def warm_start_tier(fingerprint, world, backend=None, directory=None,
                    metric="step_ms_p50"):
    """Read-only controller sensor: the measured winner's comm knobs for
    (fingerprint, world, backend) from ledger history, or None. The
    caller (FleetController.bind) seeds its tier cache with it — this
    function never actuates anything."""
    directory = ledger_dir(directory)
    if directory is None:
        return None
    recs = match(read_ledger(directory), fingerprint=str(fingerprint),
                 world=world, backend=backend, kind="fit", completed=True)
    best = best_record(recs, metric=metric)
    if best is None:
        return None
    knobs = best.get("knobs", {})
    if not knobs.get("compression"):
        return None
    return {"mode": knobs["compression"],
            "bucket_bytes": knobs.get("overlap_bytes"),
            "record_id": best.get("record_id"),
            "runs": len(recs),
            metric: _metric_of(best, metric)}


# -- bench integration ---------------------------------------------------------

def publish_bench(result, filename=None, bench_dir=None, smoke=False,
                  fingerprint=None, logger=None):
    """The ONE writer a benchmark's headline flows through (no N ad-hoc
    JSON files with no history).

    - writes the per-bench JSON file (``filename`` under ``bench_dir``;
      full runs only — smoke keeps CI file-free),
    - appends a ``kind="bench"`` RunRecord to the ledger when
      ``MXNET_TPU_LEDGER_DIR`` is configured,
    - regenerates :data:`BENCH_LEDGER_NAME` — every bench record the
      ledger holds, one machine-readable trajectory (full runs write it
      next to the per-bench file; smoke runs write it into the ledger
      dir when one is configured, so gating tests can assert on it).

    Returns {"bench_path", "record", "ledger_path", "bench_ledger_path"}.
    """
    out = {"bench_path": None, "record": None, "ledger_path": None,
           "bench_ledger_path": None}
    if filename and bench_dir and not smoke:
        path = os.path.join(bench_dir, filename)
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
        out["bench_path"] = path

    headline = {k: result.get(k) for k in
                ("metric", "value", "unit", "vs_baseline")
                if k in result}
    record = distill(
        "bench", fingerprint=fingerprint,
        world_size=result.get("world"),
        completed=True, since_ts=float("inf"),  # no ring events: the
        # headline row IS the outcome (bench functions own their numbers)
        knobs={}, extra_outcomes=headline)
    record["outcomes"]["smoke"] = bool(smoke)
    out["record"] = record

    directory = ledger_dir()
    if directory is not None:
        out["ledger_path"] = append_record(record, directory=directory,
                                           logger=logger)

    bench_rows = [r for r in read_ledger(directory)
                  if r.get("kind") == "bench"] if directory else [record]
    target_dir = bench_dir if (bench_dir and not smoke) else directory
    if target_dir:
        bl_path = os.path.join(target_dir, BENCH_LEDGER_NAME)
        with open(bl_path, "w") as f:
            json.dump({"ledger_schema": LEDGER_SCHEMA,
                       "records": bench_rows}, f, indent=1, default=str)
            f.write("\n")
        out["bench_ledger_path"] = bl_path
    return out
