"""The datlint rule registry.

Each rule is distilled from a real incident in this repo (ANALYSIS.md
links each to its ADVICE.md finding); adding a rule means adding a
module here plus a known-bad/known-good fixture pair in
``tests/test_datlint.py``.
"""

from __future__ import annotations

from ..concurrency import BlockingReachability, BlockingUnderLock, \
    CallbackEscape, GuardedState, LockOrder
from ..engine import StaleSuppression
from .bounded_wait import BoundedWait
from .cursor_coherence import CursorCoherence
from .env_cache import EnvCachePolicy
from .fanout_hot_path import FanoutHotPath
from .hub_isolation import HubIsolation
from .jit_purity import JitPurity
from .obs_discipline import ObsDiscipline
from .structured_errors import StructuredErrorParity
from .unbounded_join import UnboundedJoin
from .wire_constants import WireConstantParity
from .wire_dispatch import WireDispatchParity

ALL_RULES = (
    CursorCoherence(),
    EnvCachePolicy(),
    UnboundedJoin(),
    BoundedWait(),
    JitPurity(),
    WireConstantParity(),
    WireDispatchParity(),
    ObsDiscipline(),
    HubIsolation(),
    FanoutHotPath(),
    StructuredErrorParity(),
    # whole-program concurrency pass (analysis/concurrency/): these
    # three share one ProgramIndex per run — keep them adjacent so the
    # --stats attribution reads sensibly (the first of them pays the
    # index build)
    LockOrder(),
    BlockingUnderLock(),
    GuardedState(),
    # event-loop readiness certifier: shares the same
    # ProgramIndex, adds its own ReadinessIndex on top
    BlockingReachability(),
    CallbackEscape(),
    # engine post-pass: must run with the full registry to judge
    # staleness, so it lives last (position is cosmetic — run_project
    # audits after ALL rules regardless)
    StaleSuppression(),
)


def rule_by_name(name: str):
    for rule in ALL_RULES:
        if rule.name == name:
            return rule
    raise KeyError(name)
