"""CLI: ``python -m dat_replication_protocol_tpu_torch.analysis [paths...]``.

Exits 0 when clean, 1 on findings, 2 on usage errors — shaped so the
tier-1 suite (tests/test_datlint_repo_clean.py) and any pre-merge hook
can gate on it directly.

Structured surfaces:

* ``--format json|sarif`` — machine-readable output.  ``json`` is one
  document with ``findings`` (each ``{rule, path, line, message,
  chains}``), counts, and (with ``--stats``) per-rule wall seconds;
  ``--json`` remains as an alias for ``--format json``.  ``sarif`` is
  SARIF 2.1.0 (one run, one result per new finding, evidence chains
  under ``properties.chains``) for CI surfaces that ingest SARIF
  natively.
* ``--baseline FILE`` — accept-list: findings whose stable key (rule +
  trailing path + first message sentence, no line numbers) appears in
  FILE are reported as ``accepted`` and do not fail the run; only NEW
  findings exit 1.  ``--write-baseline FILE`` records the current
  findings as that accept-list.
* ``--stats`` — per-rule wall time (the tier-1 budget gate's input:
  a whole-program pass must not blow the suite's runtime budget).
* ``--lock-graph PATH`` — write the machine-readable lock-acquisition
  graph (deterministic, byte-stable on an unchanged tree) so the
  event-loop refactor (ROADMAP item 2) can diff the thread web it
  inherits; ``artifacts/torch/lock_graph.json`` is the checked-in copy.
* ``--write-artifacts DIR`` — regenerate EVERY checked-in analysis
  artifact (``lock_graph.json`` + ``event_loop_surface.json``) into
  DIR, byte-stably: sorted keys, fixed indent, no timestamps, paths
  project-relative.  The tier-1 suite asserts the ``artifacts/torch/``
  copies match a fresh regeneration of the port's package, so
  "regenerate on change" is enforced, not aspirational:
  ``python -m dat_replication_protocol_tpu_torch.analysis
  --write-artifacts artifacts/torch``.

One difference from the JAX package's CLI: the program name and the
artifacts' ``generator`` strings name this module.  ``artifacts/*.json``
at the top of ``artifacts/`` are the JAX package's certificates and are
never written from here unless a caller points ``--write-artifacts`` or
``--lock-graph`` at them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import Project, run_project
from .rules import ALL_RULES, rule_by_name


def write_lock_graph(project: Project, out_path: str | Path) -> dict:
    """Render and write the lock graph for ``project``; returns the
    document.  Sorted keys + fixed indent + trailing newline: the
    bytes are a pure function of the analyzed tree."""
    from .concurrency import ProgramIndex, render_lock_graph

    doc = render_lock_graph(ProgramIndex.get(project))
    text = json.dumps(doc, indent=2, sort_keys=True) + "\n"
    Path(out_path).write_text(text, encoding="utf-8")
    return doc


def write_event_loop_surface(project: Project,
                             out_path: str | Path) -> dict:
    """Render and write the event-loop readiness certificate; same
    byte-stability contract as :func:`write_lock_graph`."""
    from .concurrency import ReadinessIndex, render_event_loop_surface

    doc = render_event_loop_surface(ReadinessIndex.get(project))
    text = json.dumps(doc, indent=2, sort_keys=True) + "\n"
    Path(out_path).write_text(text, encoding="utf-8")
    return doc


def write_artifacts(project: Project, out_dir: str | Path) -> list:
    """Regenerate every checked-in analysis artifact into ``out_dir``;
    returns the written paths (sorted)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_lock_graph(project, out_dir / "lock_graph.json")
    write_event_loop_surface(project,
                             out_dir / "event_loop_surface.json")
    return sorted([out_dir / "event_loop_surface.json",
                   out_dir / "lock_graph.json"])


def to_sarif(new: list, accepted: list, rules, n_files: int) -> dict:
    """SARIF 2.1.0: one run; baseline-accepted findings are carried as
    suppressed results (SARIF's native accept-list shape) so ingesting
    CI sees them without failing on them."""
    def result(f, suppressed: bool) -> dict:
        r = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": f.line},
                },
            }],
            "properties": {"chains": [list(c) for c in f.chains]},
        }
        if suppressed:
            r["suppressions"] = [{"kind": "external",
                                  "justification": "baseline accept-list"}]
        return r

    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "datlint",
                "informationUri":
                    "https://github.com/mafintosh/dat-replication-protocol",
                "rules": [{"id": r.name,
                           "shortDescription": {"text": r.description}}
                          for r in rules],
            }},
            "results": [result(f, False) for f in new]
            + [result(f, True) for f in accepted],
            "properties": {"files": n_files},
        }],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dat_replication_protocol_tpu_torch.analysis",
        description="datlint: protocol-invariant static analysis "
                    "(rules and incidents: ANALYSIS.md)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to analyze (default: this package)")
    parser.add_argument(
        "--rule", action="append", default=None, metavar="NAME",
        help="run only this rule (repeatable)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule names and one-line descriptions, then exit")
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default=None,
        help="output format (default text); sarif is SARIF 2.1.0")
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="alias for --format json (kept for older callers)")
    parser.add_argument(
        "--baseline", metavar="FILE",
        help="accept-list of known findings (see --write-baseline); "
             "only findings NOT in it fail the run")
    parser.add_argument(
        "--write-baseline", metavar="FILE",
        help="write the current findings' keys as a baseline "
             "accept-list, then exit 0")
    parser.add_argument(
        "--stats", action="store_true",
        help="report per-rule wall time")
    parser.add_argument(
        "--lock-graph", metavar="PATH",
        help="also write the machine-readable lock-acquisition graph "
             "(artifacts/torch/lock_graph.json is the checked-in copy)")
    parser.add_argument(
        "--write-artifacts", metavar="DIR",
        help="regenerate every checked-in analysis artifact "
             "(lock_graph.json + event_loop_surface.json) into DIR, "
             "byte-stably")
    args = parser.parse_args(argv)
    if args.format is None:
        args.format = "json" if args.as_json else "text"
    elif args.as_json and args.format != "json":
        print("datlint: --json contradicts --format "
              f"{args.format}", file=sys.stderr)
        return 2
    args.as_json = args.format == "json"

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name}: {rule.description}")
        return 0

    rules = ALL_RULES
    if args.rule:
        try:
            rules = [rule_by_name(name) for name in args.rule]
        except KeyError as e:
            print(f"datlint: unknown rule {e.args[0]!r} "
                  f"(--list-rules shows the registry)", file=sys.stderr)
            return 2

    paths = args.paths or [Path(__file__).resolve().parent.parent]
    missing = [p for p in paths if not Path(p).exists()]
    if missing:
        print(f"datlint: no such path: {', '.join(map(str, missing))}",
              file=sys.stderr)
        return 2

    baseline: set[str] = set()
    if args.baseline:
        try:
            doc = json.loads(Path(args.baseline).read_text("utf-8"))
            baseline = set(doc["accept"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            # a broken baseline must fail LOUDLY: silently accepting
            # nothing (or everything) would flip the gate's meaning
            print(f"datlint: unreadable baseline {args.baseline!r}: {e}",
                  file=sys.stderr)
            return 2

    project = Project.from_paths(paths)
    stats: dict = {}
    findings = run_project(project, rules, stats if args.stats else None)
    if args.lock_graph:
        write_lock_graph(project, args.lock_graph)
    if args.write_artifacts:
        write_artifacts(project, args.write_artifacts)

    n_files = len(project.sources)

    def print_stats() -> None:
        total = sum(stats.values())
        for name, secs in sorted(stats.items(), key=lambda kv: -kv[1]):
            print(f"datlint: stats: {name}: {secs * 1e3:.1f} ms")
        print(f"datlint: stats: TOTAL: {total * 1e3:.1f} ms "
              f"({n_files} files)")

    if args.write_baseline:
        doc = {"version": 1,
               "accept": sorted({f.key() for f in findings})}
        Path(args.write_baseline).write_text(
            json.dumps(doc, indent=2) + "\n", encoding="utf-8")
        if args.as_json:
            # --json callers parse stdout as ONE document on every
            # invocation, the baseline-refresh run included
            out = {"version": 1, "files": n_files,
                   "wrote_baseline": args.write_baseline,
                   "accepted_keys": len(doc["accept"])}
            if args.stats:
                out["stats_s"] = {k: round(v, 4)
                                  for k, v in sorted(stats.items())}
            print(json.dumps(out, indent=2))
            return 0
        if args.stats:
            print_stats()
        print(f"datlint: wrote {len(doc['accept'])} accepted key(s) to "
              f"{args.write_baseline}")
        return 0

    new = [f for f in findings if f.key() not in baseline]
    accepted = [f for f in findings if f.key() in baseline]

    if args.format == "sarif":
        print(json.dumps(to_sarif(new, accepted, rules, n_files),
                         indent=2))
        return 1 if new else 0

    if args.as_json:
        doc = {
            "version": 1,
            "files": n_files,
            "rules": [r.name for r in rules],
            "findings": [f.to_json() for f in new],
            "accepted": [f.to_json() for f in accepted],
        }
        if args.stats:
            doc["stats_s"] = {k: round(v, 4)
                              for k, v in sorted(stats.items())}
        print(json.dumps(doc, indent=2))
        return 1 if new else 0

    for f in new:
        print(f.render())
    if args.stats:
        print_stats()
    if accepted:
        print(f"datlint: {len(accepted)} baseline-accepted finding(s) "
              f"not shown")
    if new:
        print(f"datlint: {len(new)} finding(s) in {n_files} file(s)")
        return 1
    print(f"datlint: clean ({n_files} files, {len(rules)} rules)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
