"""CLI over exported telemetry JSONL logs and flight dumps.

    python -m mxnet_tpu_torch.telemetry tail run.jsonl [-n 20] [--kind span]
    python -m mxnet_tpu_torch.telemetry summarize run.jsonl
    python -m mxnet_tpu_torch.telemetry merge r0.jsonl r1.jsonl ... -o fleet.json
    python -m mxnet_tpu_torch.telemetry diff A.jsonl B.jsonl [--threshold 10]
    python -m mxnet_tpu_torch.telemetry mem run.jsonl
    python -m mxnet_tpu_torch.telemetry health run.jsonl [-n 20]
    python -m mxnet_tpu_torch.telemetry profile run.jsonl [-n 20]
    python -m mxnet_tpu_torch.telemetry flight show dump.json [-n 10]
    python -m mxnet_tpu_torch.telemetry flight validate dump.json
    python -m mxnet_tpu_torch.telemetry ledger list [--dir D] [--fingerprint F]
    python -m mxnet_tpu_torch.telemetry ledger show <record-id>
    python -m mxnet_tpu_torch.telemetry ledger trend [--fingerprint F] [-n 8]
    python -m mxnet_tpu_torch.telemetry ledger compare [--fingerprint F]
    python -m mxnet_tpu_torch.telemetry ledger regress [--fingerprint F]

``tail`` prints the last N events; ``summarize`` digests one file (events
per kind, span/phase time totals, badput buckets, MFU/goodput lines).
``merge`` joins N per-rank streams on (trace_id, rank, step) into one
clock-aligned fleet Chrome trace, prints the join report, and runs the
straggler detector (``--no-stragglers`` to skip). ``diff`` compares
step-time/MFU/goodput percentiles AND the peak live-array watermark
between two runs and exits nonzero on a regression beyond the threshold
— a CI perf gate. ``mem`` renders the memory-observability view of a run:
the per-program HBM plan table (``--jaxpr-table`` style), per-epoch
watermarks, and any leak/preflight incidents. ``health`` renders the
training-health view: the per-layer statistics table (last/max gradient
norm, update:weight ratio, nonfinite totals from the in-graph stats
engine) and the anomaly timeline the streaming detectors raised.
``profile`` renders the measured device-time view: the last
capture's hotspot table, per-layer attribution coverage, measured
roofline rows (``source: "measured"``), and the measured-vs-modeled MFU
reconciliation; ``diff`` additionally gates the last capture's top per-op
times, so a hotspot regression fails CI like a step-time regression.
``flight`` renders and CRC-validates flight-recorder dumps (including the
memory snapshot and last-profile sections). ``ledger`` reads the
cross-run store under ``MXNET_TPU_LEDGER_DIR``: ``trend``
gates the newest matching-fingerprint record against the median of its
last-N predecessors (exit 3 on regression — the N-run successor to
pairwise ``diff``), ``regress`` is the pairwise newest-vs-previous form,
and ``compare`` pairs records that differ in exactly one knob and
attributes the step-time/wire-byte delta to that knob. All readers take
schema v1 (before distributed tracing) and v2 files; v1 rows read as
rank 0 of world 1.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys

from .exporters import read_events


def _fmt_event(e):
    kind = e.get("kind", "?")
    ts = e.get("ts", 0.0)
    skip = {"kind", "ts", "v", "phases", "subs", "events"}
    fields = " ".join(f"{k}={e[k]}" for k in sorted(e) if k not in skip)
    if kind == "span":
        phases = " ".join(f"{p['name']}={p['dur_ms']:.2f}ms"
                          for p in e.get("phases", ()))
        fields += (" | " + phases) if phases else ""
    return f"[{ts:.6f}] {kind:<14s} {fields}"


def cmd_tail(args):
    events = read_events(args.path)
    if args.kind:
        events = [e for e in events if e.get("kind") == args.kind]
    for e in events[-args.n:]:
        print(_fmt_event(e))
    return 0


def cmd_summarize(args):
    events = read_events(args.path)
    if not events:
        print(f"{args.path}: no events")
        return 1
    by_kind = collections.Counter(e.get("kind", "?") for e in events)
    ranks = sorted({e.get("rank", 0) for e in events})
    print(f"{args.path}: {len(events)} events "
          f"(schema v{events[0].get('v', '?')}, "
          f"rank{'s' if len(ranks) > 1 else ''} "
          f"{','.join(str(r) for r in ranks)})")
    for kind, n in by_kind.most_common():
        print(f"  {kind:<16s} {n}")

    spans = [e for e in events if e.get("kind") == "span"]
    if spans:
        total = sum(s.get("dur_ms", 0.0) for s in spans)
        phase_ms = collections.Counter()
        for s in spans:
            for p in s.get("phases", ()):
                phase_ms[p["name"]] += p.get("dur_ms", 0.0)
        print(f"spans: {len(spans)}, {total:.1f} ms total, "
              f"{total / len(spans):.2f} ms mean")
        for name, ms in phase_ms.most_common():
            print(f"  phase {name:<12s} {ms:10.1f} ms "
                  f"({100.0 * ms / total if total else 0:.1f}%)")

    badput = collections.Counter()
    for e in events:
        if e.get("kind") == "badput":
            badput[e.get("reason", "?")] += float(e.get("seconds", 0.0))
    if badput:
        print("badput:")
        for reason, s in badput.most_common():
            print(f"  {reason:<12s} {s:.2f} s")

    for e in events:
        if e.get("kind") == "epoch_summary":
            mfu = e.get("mfu_pct")
            print(f"epoch {e.get('epoch')}: {e.get('steps')} steps in "
                  f"{float(e.get('seconds', 0.0)):.2f}s, "
                  f"goodput {float(e.get('goodput_pct', 0.0)):.1f}%, "
                  + (f"MFU {mfu:.1f}%" if isinstance(mfu, (int, float))
                     else "MFU n/a"))
    return 0


def cmd_merge(args):
    from .distributed import detect_stragglers, load_rank_streams, \
        merge_traces

    by_rank = load_rank_streams(args.paths)
    trace, report = merge_traces(by_rank, out=args.out)
    print(f"merged {len(args.paths)} stream(s): "
          f"ranks {report['ranks']}, {report['spans']} spans, "
          f"{report['server_spans']} server spans "
          f"({report['orphan_server_spans']} orphaned), "
          f"trace ids {report['trace_ids'] or ['<none>']}")
    if report.get("clock_offsets"):
        offs = ", ".join(f"r{r}={o * 1e3:+.3f}ms"
                         for r, o in sorted(report["clock_offsets"].items()))
        print(f"clock offsets vs server: {offs}")
    if args.out:
        print(f"wrote {args.out} ({len(trace['traceEvents'])} trace events)")
    if not args.no_stragglers:
        srep = detect_stragglers(by_rank, mad_k=args.mad_k, publish=False)
        print(f"skew: {srep['skew_seconds'] * 1e3:.3f} ms "
              f"(slowest rank's median step vs fleet median)")
        if srep["stragglers"]:
            for s in srep["stragglers"]:
                print(f"STRAGGLER rank {s['rank']}: blame={s['blame']} "
                      f"({s['flagged_steps']}/{s['steps']} steps outside "
                      f"the envelope, {s['excess_seconds'] * 1e3:.1f} ms "
                      f"excess)")
        else:
            print("no stragglers flagged")
    return 0


def cmd_mem(args):
    """The bytes view of one run's JSONL stream: program plans, epoch
    watermarks, leak + preflight incidents."""
    from .memory import plan_table

    events = read_events(args.path)
    plan_rows = {}
    for e in events:
        if e.get("kind") == "memory_plan":
            plan_rows[e.get("program", "?")] = e  # latest plan wins
    watermarks = [e for e in events if e.get("kind") == "memory_watermark"]
    leaks = [e for e in events if e.get("kind") == "memory_leak"]
    preflights = [e for e in events if e.get("kind") == "memory_preflight"]
    if not (plan_rows or watermarks or leaks or preflights):
        print(f"{args.path}: no memory events (run fit with telemetry on, "
              f"or precompile() to register program plans)")
        return 1
    if plan_rows:
        print("per-program memory plans:")
        print(plan_table(plan_rows))
    if watermarks:
        print("live-array watermarks:")
        for e in watermarks:
            print(f"  epoch {e.get('epoch')}: watermark "
                  f"{float(e.get('watermark_bytes', 0)) / (1 << 20):.2f} MB "
                  f"({e.get('live_count', '?')} live arrays, "
                  f"{float(e.get('live_bytes', 0)) / (1 << 20):.2f} MB live "
                  f"at mark)")
    for e in leaks:
        print(f"MEMORY LEAK flagged at epoch {e.get('epoch')}: watermark "
              f"drifted up {e.get('epochs')} consecutive epoch(s) "
              f"(+{float(e.get('drift_bytes', 0)) / (1 << 20):.2f} MB last)")
    for e in preflights:
        verdict = "ok" if e.get("fits") else "OVER BUDGET"
        budget = e.get("budget_bytes")
        print(f"preflight ({e.get('what')}): "
              f"{float(e.get('total_bytes', 0)) / (1 << 20):.2f} MB needed, "
              + (f"budget {float(budget) / (1 << 20):.2f} MB — {verdict}"
                 if budget else "no budget configured"))
    return 0


def cmd_health(args):
    """The model-health view of one run's JSONL stream: per-layer stats
    table + the anomaly timeline."""
    from .health import aggregate_events

    events = read_events(args.path)
    health = [e for e in events if e.get("kind") == "health"]
    anomalies = [e for e in events if e.get("kind") == "health_anomaly"]
    if not health and not anomalies:
        print(f"{args.path}: no health events (run fit with health=True "
              f"or MXNET_TPU_HEALTH=1 and a JSONL telemetry sink)")
        return 1
    layers = aggregate_events(events)
    print(f"{args.path}: {len(health)} health step(s), "
          f"{len(anomalies)} anomal"
          f"{'y' if len(anomalies) == 1 else 'ies'}")
    if layers:
        print(f"{'layer':<20s} {'grad_norm':>12s} {'max':>12s} "
              f"{'weight_norm':>12s} {'upd:w':>10s} {'nonfinite':>9s} "
              f"{'anomalies':>9s}")
        for layer, agg in sorted(layers.items()):
            print(f"{layer:<20s} {agg['grad_norm']:>12.4g} "
                  f"{agg['max_grad_norm']:>12.4g} "
                  f"{agg['weight_norm']:>12.4g} "
                  f"{agg['update_ratio']:>10.3g} {agg['nonfinite']:>9d} "
                  f"{agg['anomalies']:>9d}")
    if health:
        last = health[-1]
        print(f"last step: epoch {last.get('epoch')} step "
              f"{last.get('step')} loss {float(last.get('loss', 0.0)):.6g}")
    if anomalies:
        print(f"anomaly timeline (last {min(args.n, len(anomalies))} of "
              f"{len(anomalies)}):")
        for e in anomalies[-args.n:]:
            where = f" layer={e['layer']}" if e.get("layer") else ""
            print(f"  [e{e.get('epoch')} s{e.get('step')}] "
                  f"{e.get('reason')}{where} value={e.get('value')} "
                  f"threshold={e.get('threshold')}")
    else:
        print("no anomalies flagged")
    return 0


def _last_profile_summary(events):
    """The newest attributed capture summary in a stream, or None."""
    out = None
    for e in events:
        if e.get("kind") == "profile" and \
                e.get("phase", "summary") == "summary":
            out = e
    return out


def _render_profile_summary(e, n=20):
    """Shared hotspot rendering (CLI ``profile`` + ``flight show``)."""
    cov = e.get("coverage_pct")
    print(f"device profile: {float(e.get('device_ms', 0.0)):.2f} ms over "
          f"{e.get('steps')} step(s), window "
          f"{float(e.get('window_seconds', 0.0)):.3f}s, coverage "
          + (f"{cov:.1f}%" if isinstance(cov, (int, float)) else "n/a")
          + f" (unattributed {float(e.get('unattributed_ms', 0.0)):.2f} ms)")
    top = e.get("top") or []
    if top:
        print(f"{'ms':>10s} {'%dev':>6s}  {'layer':<22s} op")
        for row in top[:n]:
            print(f"{float(row.get('us', 0.0)) / 1e3:>10.3f} "
                  f"{float(row.get('pct', 0.0)):>6.1f}  "
                  f"{(row.get('layer') or '<unattributed>'):<22s} "
                  f"{row.get('op')}")
    layers = e.get("layers") or {}
    if layers:
        print("per-layer device ms: "
              + "  ".join(f"{k}={float(v):.3f}"
                          for k, v in list(layers.items())[:n]))
    roof = e.get("roofline") or []
    if roof:
        print(f"measured roofline ({len(roof)} row(s), source=measured):")
        print(f"{'op':<28s} {'ms/step':>9s} {'GFLOP/s':>9s} "
              f"{'%peak':>7s} bound")
        for row in roof[:n]:
            pk = row.get("pct_of_peak")
            print(f"{row.get('op', '?'):<28s} "
                  f"{float(row.get('measured_ms_per_step', 0.0)):>9.4f} "
                  f"{float(row.get('achieved_gflops_s', 0.0)):>9.3f} "
                  + (f"{pk:>7.2f}" if isinstance(pk, (int, float))
                     else f"{'n/a':>7s}")
                  + f" {row.get('bound', '?')}")
    mfu = e.get("mfu") or {}
    if isinstance(mfu.get("measured_mfu_pct"), (int, float)):
        modeled = mfu.get("modeled_mfu_pct")
        print(f"MFU: measured {mfu['measured_mfu_pct']:.2f}% (device clock)"
              + (f" vs modeled {modeled:.2f}% (wall clock), "
                 f"delta {mfu.get('delta_pct', 0.0):+.2f}%"
                 if isinstance(modeled, (int, float)) else ""))


def cmd_profile(args):
    """The measured-device-time view of one run's JSONL stream: the last
    capture's hotspot table, per-layer attribution, measured roofline
    rows, and the measured-vs-modeled MFU reconciliation."""
    events = read_events(args.path)
    captures = [e for e in events if e.get("kind") == "profile"]
    summary = _last_profile_summary(events)
    if summary is None:
        print(f"{args.path}: no profile summary (run fit/predict with "
              f"profile=True or MXNET_TPU_PROFILE=1 and a JSONL telemetry "
              f"sink)"
              + (f"; {len(captures)} capture event(s) without attribution"
                 if captures else ""))
        return 1
    _render_profile_summary(summary, n=args.n)
    return 0


# diff metrics: (label, extractor over events, higher_is_worse)
def _span_dur_ms(events):
    return sorted(float(e.get("dur_ms", 0.0)) for e in events
                  if e.get("kind") == "span"
                  and e.get("name", "step") == "step")


def _pctl(sorted_vals, q):
    """numpy's linear-interpolated percentile — the SAME math the hub's
    Histogram reports, so the diff gate's p99 matches the live p99."""
    if not sorted_vals:
        return None
    import numpy as np

    return float(np.percentile(sorted_vals, q))


def _run_metrics(events):
    """The comparable health profile of one run's JSONL stream."""
    durs = _span_dur_ms(events)
    out = {}
    for q in (50, 90, 99):
        v = _pctl(durs, q)
        if v is not None:
            out[f"step_ms_p{q}"] = (v, True)   # higher = worse
    mfu, goodput = [], []
    for e in events:
        if e.get("kind") == "epoch_summary":
            if isinstance(e.get("mfu_pct"), (int, float)):
                mfu.append(float(e["mfu_pct"]))
            if isinstance(e.get("goodput_pct"), (int, float)):
                goodput.append(float(e["goodput_pct"]))
    if mfu:
        out["mfu_pct"] = (sum(mfu) / len(mfu), False)  # lower = worse
    if goodput:
        out["goodput_pct"] = (sum(goodput) / len(goodput), False)
    # peak-memory regression gate: the run's highest live-array
    # watermark, comparable whenever both runs tracked memory
    peaks = [float(e.get("watermark_bytes", 0.0)) for e in events
             if e.get("kind") == "memory_watermark"]
    if peaks:
        out["peak_mem_mb"] = (max(peaks) / (1 << 20), True)  # higher=worse
    # per-program measured op-time rows: the last capture's top
    # hotspots become gated metrics, so a hotspot that regresses beyond
    # the threshold fails the same CI gate as a step-time regression
    prof = _last_profile_summary(events)
    if prof is not None:
        steps = max(int(prof.get("steps", 1) or 1), 1)
        for row in (prof.get("top") or [])[:8]:
            op = row.get("op")
            if not op:
                continue
            name = f"op_ms[{row.get('layer') or 'unattributed'}/{op}]"
            out[name] = (float(row.get("us", 0.0)) / 1e3 / steps, True)
        cov = prof.get("coverage_pct")
        if isinstance(cov, (int, float)):
            out["profile_coverage_pct"] = (float(cov), False)  # lower=worse
    return out


def cmd_diff(args):
    a = _run_metrics(read_events(args.a))
    b = _run_metrics(read_events(args.b))
    if not a or not b:
        print(f"error: no comparable metrics "
              f"({args.a}: {sorted(a)}, {args.b}: {sorted(b)})",
              file=sys.stderr)
        return 2
    breaches = 0
    print(f"{'metric':<14s} {'A':>10s} {'B':>10s} {'delta':>9s}")
    for name in sorted(set(a) & set(b)):
        va, worse_up = a[name]
        vb, _ = b[name]
        if va == 0:
            # no relative delta against a zero baseline — but a gate that
            # drops a metric silently is a gate that lies; show the row
            print(f"{name:<14s} {va:>10.3f} {vb:>10.3f} {'n/a':>9s}"
                  f"  (zero baseline, not gated)")
            continue
        delta_pct = (vb - va) / abs(va) * 100.0
        regression = delta_pct if worse_up else -delta_pct
        flag = ""
        if regression > args.threshold:
            breaches += 1
            flag = f"  REGRESSION (> {args.threshold:g}%)"
        print(f"{name:<14s} {va:>10.3f} {vb:>10.3f} {delta_pct:>+8.1f}%"
              f"{flag}")
    only = sorted(set(a) ^ set(b))
    if only:
        print(f"(not comparable, present in one run only: {only})")
    if breaches:
        print(f"{breaches} regression(s) beyond {args.threshold:g}% "
              f"threshold", file=sys.stderr)
        return 3
    return 0


def cmd_flight(args):
    from .flight import validate_flight

    ok, payload = validate_flight(args.path)
    if not ok:
        print(f"INVALID flight dump {args.path}: {payload}",
              file=sys.stderr)
        return 3
    if args.action == "validate":
        print(f"{args.path}: CRC OK (format {payload.get('format')}, "
              f"{len(payload.get('steps', []))} steps, "
              f"{len(payload.get('incidents', []))} incidents)")
        return 0
    # show: the post-mortem rendering
    print(f"flight dump {args.path}")
    print(f"  reason={payload.get('reason')} rank={payload.get('rank')}/"
          f"{payload.get('world_size')} run={payload.get('run_id')} "
          f"trace={payload.get('trace_id')} pid={payload.get('pid')}")
    steps = payload.get("steps", [])
    print(f"last {min(args.n, len(steps))} of {len(steps)} recorded steps:")
    for s in steps[-args.n:]:
        if s.get("kind") == "step_lite":
            print(f"  [e{s.get('epoch')} s{s.get('step')}] "
                  f"{s.get('name', 'step')} (lite) "
                  f"span={s.get('span_id')}")
        else:
            phases = " ".join(f"{p['name']}={p['dur_ms']:.2f}ms"
                              for p in s.get("phases", ()))
            print(f"  [e{s.get('epoch')} s{s.get('step')}] "
                  f"{s.get('name', 'step')} {s.get('dur_ms', 0.0):.2f}ms "
                  f"| {phases}")
            for ev in s.get("events", ()):
                print(f"      ! {ev.get('name')} "
                      + " ".join(f"{k}={v}" for k, v in sorted(ev.items())
                                 if k not in ("name", "ts")))
    incidents = payload.get("incidents", [])
    if incidents:
        print(f"incidents ({len(incidents)}):")
        for e in incidents[-args.n:]:
            print("  " + _fmt_event(e))
    counters = payload.get("counters", {})
    if counters:
        print("non-zero counters:")
        for k, v in sorted(counters.items()):
            print(f"  {k}: {v:g}")
    mem = payload.get("memory")
    if isinstance(mem, dict):  # absent on older dumps; torn/odd
        # sections render best-effort (the CRC already proved integrity)
        led = mem.get("ledger") or {}
        if led:
            print(f"memory: {float(led.get('live_bytes', 0)) / (1 << 20):.2f}"
                  f" MB live in {led.get('live_count', 0)} arrays "
                  f"(watermark "
                  f"{float(led.get('watermark_bytes', 0)) / (1 << 20):.2f} "
                  f"MB, tracking={'on' if mem.get('tracking') else 'off'})")
        for row in (mem.get("top_arrays") or [])[:args.n]:
            if isinstance(row, dict):
                print(f"  {float(row.get('bytes', 0)) / (1 << 20):9.3f} MB  "
                      f"{row.get('dtype')}{tuple(row.get('shape', ()))} "
                      f"@{row.get('platform')}")
        plans_sec = mem.get("plans") or {}
        if isinstance(plans_sec, dict) and plans_sec:
            print(f"largest program plans ({len(plans_sec)}):")
            for label, plan in plans_sec.items():
                if isinstance(plan, dict):
                    print(f"  {float(plan.get('total_bytes', 0)) / (1 << 20):9.3f}"
                          f" MB  {label}")
        alloc = mem.get("allocator") or {}
        for dev, row in sorted(alloc.items()) if isinstance(alloc, dict) \
                else []:
            if isinstance(row, dict) and row.get("bytes_in_use"):
                print(f"  allocator {dev}: "
                      f"{float(row['bytes_in_use']) / (1 << 20):.2f} MB in "
                      f"use, peak "
                      f"{float(row.get('peak_bytes_in_use', 0)) / (1 << 20):.2f}"
                      f" MB")
    prof = payload.get("profile")
    if isinstance(prof, dict):  # absent on dumps from un-profiled runs
        print("last device-profile capture:")
        _render_profile_summary(prof, n=args.n)
    return 0


def _ledger_records(args):
    """(records, directory) for the ledger subcommands, identity-filtered
    by the common --fingerprint/--world/--backend/--kind flags."""
    from . import ledger as ledger_mod

    directory = ledger_mod.ledger_dir(args.dir)
    if directory is None:
        print("error: no ledger directory (pass --dir or set "
              "MXNET_TPU_LEDGER_DIR)", file=sys.stderr)
        return None, None
    records = ledger_mod.read_ledger(directory)
    records = ledger_mod.match(
        records, fingerprint=args.fingerprint, kind=args.kind,
        world=args.world, backend=args.backend)
    return records, directory


def _fmt_record(r):
    o = r.get("outcomes", {})
    p50 = o.get("step_ms_p50")
    mfu = o.get("mfu_pct")
    knobs = r.get("knobs", {})
    return (f"{r.get('record_id', '?'):<18s} {r.get('kind', '?'):<8s} "
            f"fp={str(r.get('fingerprint'))[:12]:<12s} "
            f"w={r.get('world_size', '?'):<3} "
            f"{r.get('backend', '?'):<5s} "
            f"tier={str(knobs.get('compression')):<6s} "
            + (f"p50={p50:8.2f}ms " if isinstance(p50, (int, float))
               else f"{'':14s}")
            + (f"mfu={mfu:5.1f}% " if isinstance(mfu, (int, float))
               else "")
            + ("" if r.get("completed", True) else " INCOMPLETE"))


def cmd_ledger(args):
    from . import ledger as ledger_mod

    records, directory = _ledger_records(args)
    if records is None:
        return 2
    if args.action == "list":
        if not records:
            print(f"{directory}: no matching ledger records")
            return 1
        for r in records[-args.n:]:
            print(_fmt_record(r))
        print(f"{len(records)} record(s) in {directory}")
        return 0
    if args.action == "show":
        if not args.record:
            print("error: ledger show needs a record id", file=sys.stderr)
            return 2
        hits = [r for r in records
                if str(r.get("record_id", "")).startswith(args.record)
                or str(r.get("run_id", "")).startswith(args.record)]
        if not hits:
            print(f"error: no record matching {args.record!r} in "
                  f"{directory}", file=sys.stderr)
            return 1
        for r in hits:
            r = dict(r)
            r.pop("_path", None)
            print(json.dumps(r, indent=2, sort_keys=True, default=str))
        return 0
    if args.action in ("trend", "regress"):
        window = 2 if args.action == "regress" else args.n
        report = ledger_mod.trend_gate(records, metric=args.metric,
                                       n=window, threshold=args.threshold)
        if "reason" in report:
            print(f"{args.metric}: not gated ({report['reason']})")
            return 0
        worse = "higher" if ledger_mod.metric_direction(args.metric) \
            else "lower"
        print(f"{args.metric} over last {report['n']} matching record(s) "
              f"({worse} is worse):")
        for r in records[-window:]:
            print("  " + _fmt_record(r))
        print(f"baseline (median of prior) = {report['baseline']:.3f}, "
              f"latest = {report['latest']:.3f}, "
              f"delta = {report['delta_pct']:+.1f}%")
        if report["regressed"]:
            print(f"REGRESSION: {args.metric} moved "
                  f"{report['delta_pct']:+.1f}% (> {args.threshold:g}% "
                  f"threshold) on record {report['latest_record']}",
                  file=sys.stderr)
            return 3
        return 0
    # compare: knob attribution over single-knob-delta record pairs
    rows = ledger_mod.knob_attribution(records)
    if not rows:
        print("no record pairs differing in exactly one knob "
              f"({len(records)} matching record(s))")
        return 1
    for row in rows:
        deltas = "  ".join(
            f"{m}: {d['a']:.3f} -> {d['b']:.3f} ({d['delta_pct']:+.1f}%)"
            for m, d in sorted(row["deltas"].items()))
        print(f"knob {row['knob']}: {row['a_value']!r} -> "
              f"{row['b_value']!r}  [{row['a_record']} vs "
              f"{row['b_record']}]")
        print(f"  {deltas}")
    print(f"{len(rows)} single-knob pair(s); the delta is attributable "
          f"to the named knob (identity and every other knob matched)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.telemetry",
                                 description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("tail", help="print the last N events")
    t.add_argument("path")
    t.add_argument("-n", type=int, default=20)
    t.add_argument("--kind", default=None)
    t.set_defaults(fn=cmd_tail)
    s = sub.add_parser("summarize", help="digest an event log")
    s.add_argument("path")
    s.set_defaults(fn=cmd_summarize)
    m = sub.add_parser("merge", help="join per-rank streams into one "
                                     "fleet Chrome trace + straggler "
                                     "report")
    m.add_argument("paths", nargs="+")
    m.add_argument("-o", "--out", default=None,
                   help="write the merged Chrome trace JSON here")
    m.add_argument("--no-stragglers", action="store_true")
    m.add_argument("--mad-k", type=float, default=3.5,
                   help="straggler envelope: median + K * MAD")
    m.set_defaults(fn=cmd_merge)
    d = sub.add_parser("diff", help="compare two runs; nonzero exit on "
                                    "regression (CI perf gate)")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--threshold", type=float, default=10.0,
                   help="regression threshold in percent (default 10)")
    d.set_defaults(fn=cmd_diff)
    mm = sub.add_parser("mem", help="memory view: program plan table, "
                                    "epoch watermarks, leak/preflight "
                                    "incidents")
    mm.add_argument("path")
    mm.set_defaults(fn=cmd_mem)
    hh = sub.add_parser("health", help="training-health view: per-layer "
                                       "stats table + anomaly timeline")
    hh.add_argument("path")
    hh.add_argument("-n", type=int, default=20)
    hh.set_defaults(fn=cmd_health)
    pp = sub.add_parser("profile", help="measured device-time view: "
                                        "hotspot table, per-layer "
                                        "attribution, measured roofline, "
                                        "measured-vs-modeled MFU")
    pp.add_argument("path")
    pp.add_argument("-n", type=int, default=20)
    pp.set_defaults(fn=cmd_profile)
    f = sub.add_parser("flight", help="render / CRC-validate a flight "
                                      "recorder dump")
    f.add_argument("action", choices=("show", "validate"))
    f.add_argument("path")
    f.add_argument("-n", type=int, default=10)
    f.set_defaults(fn=cmd_flight)
    lg = sub.add_parser("ledger", help="cross-run store: list/show "
                                       "records, N-run trend gate (exit "
                                       "3 on regression), single-knob "
                                       "delta attribution")
    lg.add_argument("action", choices=("list", "show", "trend", "compare",
                                       "regress"))
    lg.add_argument("record", nargs="?", default=None,
                    help="record/run id prefix (show)")
    lg.add_argument("--dir", default=None,
                    help="ledger directory (default: MXNET_TPU_LEDGER_DIR)")
    lg.add_argument("--fingerprint", default=None,
                    help="gate/compare only records of this graph "
                         "fingerprint")
    lg.add_argument("--kind", default=None,
                    choices=("fit", "predict", "bench"))
    lg.add_argument("--world", type=int, default=None)
    lg.add_argument("--backend", default=None)
    lg.add_argument("--metric", default="step_ms_p50",
                    help="gated outcome (default step_ms_p50)")
    lg.add_argument("-n", type=int, default=8,
                    help="trend window / list tail length")
    lg.add_argument("--threshold", type=float, default=10.0,
                    help="regression threshold in percent (default 10)")
    lg.set_defaults(fn=cmd_ledger)
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except json.JSONDecodeError as e:
        print(f"error: invalid JSON input: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
