"""datlint — protocol-invariant static analysis for this package.

The test suite exercises *behavior*; this package checks *structure*:
cross-path invariants that a reader can verify on any one diff but
that silently rot as the same protocol logic is duplicated across the
pure-Python, C, and device fast paths (the bulk-cursor desync of
ADVICE.md is the type specimen — see ANALYSIS.md for each
rule's motivating incident).

Usage::

    python -m dat_replication_protocol_tpu_torch.analysis [paths...]

or programmatically::

    from dat_replication_protocol_tpu_torch.analysis import run_paths
    findings = run_paths(["dat_replication_protocol_tpu_torch"])

Findings are suppressible per line with ``# datlint: disable=<rule>``
(``// datlint: disable=<rule>`` in C sources) and per file with
``# datlint: disable-file=<rule>``; every suppression should carry a
trailing justification.
"""

from __future__ import annotations

from .engine import Finding, Project, run_paths, run_project
from .rules import ALL_RULES, rule_by_name

__all__ = [
    "ALL_RULES",
    "Finding",
    "Project",
    "rule_by_name",
    "run_paths",
    "run_project",
]
