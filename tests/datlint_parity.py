"""Hold the port's datlint to the JAX package's on the same files.

The port's ``analysis/`` is a copy of the JAX package's with five stated
differences (see their module docstrings).  None of them shows on the
analyzer test fixtures, so every fixture must give both analyzers the
same findings.  :func:`run_paths` and :func:`datlint_main` are the
port's entry points with that check in front: they run both analyzers
over the same paths and rules and compare the ``(path relative to the
root given, line, rule, message)`` lists.  The one normalization is the
CLI's module name inside messages.
"""

from __future__ import annotations

from pathlib import Path

from dat_replication_protocol_tpu.analysis import run_paths as _ref_run_paths
from dat_replication_protocol_tpu.analysis.rules import \
    rule_by_name as _ref_rule
from dat_replication_protocol_tpu_torch.analysis import \
    run_paths as _port_run_paths
from dat_replication_protocol_tpu_torch.analysis.__main__ import \
    main as _port_main
from dat_replication_protocol_tpu_torch.analysis.rules import \
    rule_by_name as _port_rule

PORT_CLI = "dat_replication_protocol_tpu_torch.analysis"
REF_CLI = "dat_replication_protocol_tpu.analysis"

# CLI options that take a value (the value is not a path to analyze)
_VALUE_OPTS = {"--rule", "--format", "--baseline", "--write-baseline",
               "--lock-graph", "--write-artifacts"}


def rows(findings, roots) -> list:
    """``(relative path, line, rule, message)`` for each finding; a path
    is made relative to the first root (or a file root's folder) that
    holds it."""
    bases = [Path(r) if Path(r).is_dir() else Path(r).parent
             for r in roots]
    out = []
    for f in findings:
        path = Path(f.path)
        rel = path.as_posix()
        for base in bases:
            try:
                rel = path.relative_to(base).as_posix()
                break
            except ValueError:
                continue
        out.append((rel, f.line, f.rule,
                    f.message.replace(PORT_CLI, REF_CLI)))
    return out


def reference_findings(paths, rules=None) -> list:
    """The JAX package's findings over ``paths`` with the rules of the
    same names as ``rules`` (all of them when None)."""
    ref_rules = None if rules is None else [_ref_rule(r.name)
                                            for r in rules]
    return _ref_run_paths(list(paths), ref_rules)


def run_paths(paths, rules=None) -> list:
    """The port's findings over ``paths``, after asserting that the JAX
    package's analyzer gives the same list on the same files."""
    paths = list(paths)
    port = _port_run_paths(paths, rules)
    ref = reference_findings(paths, rules)
    assert rows(port, paths) == rows(ref, paths), (
        "the port's datlint and the JAX package's disagree:\n"
        f"port: {rows(port, paths)}\nreference: {rows(ref, paths)}")
    return port


def datlint_main(argv) -> int:
    """The port's CLI; the paths and rules it names first go through
    :func:`run_paths` (skipped when a path is missing, which the CLI
    refuses, or when no path is named: the default trees differ)."""
    paths, rule_names, i = [], [], 0
    argv = list(argv)
    while i < len(argv):
        arg = argv[i]
        if arg in _VALUE_OPTS:
            if arg == "--rule" and i + 1 < len(argv):
                rule_names.append(argv[i + 1])
            i += 2
            continue
        if not arg.startswith("-"):
            paths.append(arg)
        i += 1
    if paths and all(Path(p).exists() for p in paths):
        try:
            rules = [_port_rule(n) for n in rule_names] or None
        except KeyError:
            rules = False   # the CLI refuses an unknown rule
        if rules is not False:
            run_paths(paths, rules)
    return _port_main(argv)
