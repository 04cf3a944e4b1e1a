"""The analysis CLI: ``python -m mxnet_tpu_torch.analysis [paths...]``.

Counterpart of ``python -m mxnet_tpu.analysis``, with the same flags and
exit codes. Paths may be .py files, directories (recursively linted, Pass
1), or serialized symbol .json files (graph-verified, Pass 2 + the
unreachable-node check); with none it lints the port's own tree.
``--concurrency`` adds Pass 4, ``--shardcheck`` runs Pass 5 (the port's
dp-8 full-stack step over eight CPU replicas, ``sharding.selfcheck_report``)
and ``--all`` runs every pass with findings deduped into one report.

Exit codes: 0 clean, 1 when any error-severity finding survives filtering
(or any warning under ``--warnings-as-errors``), 2 on a bad path, and 3
when ``--baseline`` names an existing baseline and NEW violations appeared
against it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .rules import RULES
from .source_lint import iter_python_files, lint_file

_SHARDCHECK_DP = 8


def _parser():
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis",
        description="mxlint: static analysis for mxnet_tpu_torch "
                    "(imports, captured-code hazards, graph verification, "
                    "concurrency, sharding audit)")
    p.add_argument("paths", nargs="*", default=[],
                   help=".py files, directories, or symbol .json files "
                        "(default: the installed mxnet_tpu_torch package "
                        "tree)")
    p.add_argument("--concurrency", action="store_true",
                   help="additionally run the whole-package concurrency "
                        "pass (MX701-MX705: shared-state races, "
                        "lock-order cycles, bare cv.wait, leaked "
                        "threads, fresh-lock locking)")
    p.add_argument("--shardcheck", action="store_true",
                   help="run Pass 5 (MX802, MX804): train the port's own "
                        "dp-8 full-stack step (compression + overlap + "
                        "comm kernels + health + guards) over eight CPU "
                        "replicas, profile one step and reconcile its "
                        "collectives against the closed-form comm plan "
                        "(MX805, the source-level placement rule, rides "
                        "with the ordinary path lint)")
    p.add_argument("--all", action="store_true",
                   help="run every pass (source lint + concurrency + "
                        "shardcheck), findings deduped, one combined "
                        "exit code")
    p.add_argument("--select", default="",
                   help="comma-separated rule ids to report (default: all)")
    p.add_argument("--ignore", default="",
                   help="comma-separated rule ids to drop")
    p.add_argument("--warnings-as-errors", action="store_true",
                   help="exit 1 on warnings too")
    p.add_argument("--quiet", action="store_true",
                   help="print only the summary line")
    p.add_argument("--ci", action="store_true",
                   help="emit findings as structured tab-separated rows "
                        "(rule, severity, path, line, col, message)")
    p.add_argument("--baseline", default="",
                   help="JSON baseline of accepted findings: when the "
                        "file exists, only NEW findings fail (exit 3); "
                        "when it does not, the current findings are "
                        "written to it")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def _ensure_shardcheck_devices():
    """Arm eight CPU replicas: a ``cpu(i)`` of the port resolves among the
    host devices ``--xla_force_host_platform_device_count`` in
    ``XLA_FLAGS`` declares, read at each call
    (``context.host_device_count``), so setting it here works whenever it
    runs. A process that already declares a count keeps it
    (``selfcheck_report`` raises a clear RuntimeError if that is too
    few)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{_SHARDCHECK_DP}").strip()


def _finding_key(f):
    # line/col excluded: the baseline must survive unrelated edits above
    # the finding; node covers graph/program findings that carry no path
    return f"{f.rule.id}|{f.path}|{f.node}|{f.message}"


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES.values(), key=lambda r: r.id):
            print(f"{rule.id}  [{rule.severity:7s}] {rule.summary}")
        return 0

    run_concurrency = args.concurrency or args.all
    run_shardcheck = args.shardcheck or args.all
    if run_shardcheck:
        _ensure_shardcheck_devices()

    select = {s.strip() for s in args.select.split(",") if s.strip()}
    ignore = {s.strip() for s in args.ignore.split(",") if s.strip()}

    # default target: the package tree itself, wherever it is installed
    paths = args.paths or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        for p in missing:
            print(f"mxlint: no such path: {p}", file=sys.stderr)
        return 2

    findings = []
    n_files = 0
    py_paths = []
    # --shardcheck alone audits the profiled step only; any other
    # invocation (default, --all) lints the given paths too
    lint_sources = not args.shardcheck or args.all or bool(args.paths)
    if lint_sources:
        for path in paths:
            if path.endswith(".json"):
                from .graph import verify_json_file

                n_files += 1
                findings.extend(verify_json_file(path))
                continue
            for f in iter_python_files([path]):
                n_files += 1
                py_paths.append(f)
                findings.extend(lint_file(f))
    if run_concurrency and py_paths:
        from . import concurrency

        # Pass 1 already reported MX100 for unparsable files; the
        # concurrency pass would re-report them
        findings.extend(f for f in concurrency.lint_paths(py_paths)
                        if f.rule.id != "MX100")
    if run_shardcheck:
        from .sharding import selfcheck_report

        try:
            report = selfcheck_report(dp=_SHARDCHECK_DP)
        except RuntimeError as e:
            print(f"mxlint: shardcheck skipped: {e}", file=sys.stderr)
        else:
            findings.extend(report.findings)
            if not args.quiet and not report.findings:
                print(f"shardcheck: dp-{_SHARDCHECK_DP} full-stack step "
                      f"reconciles against its comm plan (0 findings)")

    # dedup (passes overlap on shared files; one finding, one row)
    seen = set()
    deduped = []
    for f in findings:
        key = (f.path, f.line, f.col, f.rule.id, f.node, f.message)
        if key in seen:
            continue
        seen.add(key)
        deduped.append(f)
    findings = deduped

    if select:
        findings = [f for f in findings if f.rule.id in select]
    if ignore:
        findings = [f for f in findings if f.rule.id not in ignore]

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule.id))
    errors = [f for f in findings if f.is_error]
    warnings = [f for f in findings if f.rule.severity == "warning"]

    new_findings = None
    seeded = False
    if args.baseline:
        if os.path.exists(args.baseline):
            with open(args.baseline, encoding="utf-8") as fh:
                known = set(json.load(fh))
            new_findings = [f for f in findings
                            if _finding_key(f) not in known]
        else:
            # seeding run: record the current findings and exit clean —
            # the gate only ever fails on findings NEWER than its baseline
            seeded = True
            with open(args.baseline, "w", encoding="utf-8") as fh:
                json.dump(sorted(_finding_key(f) for f in findings), fh,
                          indent=0)
            print(f"mxlint: baseline written: {args.baseline} "
                  f"({len(findings)} finding(s))")

    if not args.quiet:
        rows = new_findings if new_findings is not None else findings
        for f in rows:
            if args.ci:
                print("\t".join([f.rule.id, f.rule.severity, f.path,
                                 str(f.line), str(f.col), f.message]))
            else:
                print(f.format())
    print(f"mxlint: checked {n_files} file(s): "
          f"{len(errors)} error(s), {len(warnings)} warning(s)"
          + (f", {len(new_findings)} new vs baseline"
             if new_findings is not None else ""))
    if seeded:
        return 0
    if new_findings is not None:
        return 3 if new_findings else 0
    if errors or (args.warnings_as_errors and warnings):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
