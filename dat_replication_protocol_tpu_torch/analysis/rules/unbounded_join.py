"""unbounded-join: blocking waits in daemon/server code need deadlines.

Motivating incident (ADVICE.md, low): ``sidecar.run_session``'s
healthy path ended with a bare ``sender.join()`` — a client that
finished sending but never read its reply parked the reply thread in a
blocked write and the session thread in ``join()`` forever: a
per-connection thread/memory leak in ``--tcp`` mode, a permanent hang
in ``--stdio`` mode.

Flagged shapes:

* ``x.join()`` with no arguments.  A ``Thread.join`` without a timeout
  can block forever; ``str.join`` / ``os.path.join`` / ``Path.join``
  always take an argument, so the zero-arg form is reliably the
  blocking one.  Pass a timeout (looping if needed, so stall detection
  stays possible) or suppress with a justification.
* ``sock.settimeout(None)`` — explicitly switching a socket back to
  unbounded blocking mode.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import Finding, Project


class UnboundedJoin:
    name = "unbounded-join"
    description = (
        "zero-argument .join() and settimeout(None) block forever; "
        "give daemon waits a deadline"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.py_sources:
            tree = src.tree
            if tree is None:
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call) or \
                        not isinstance(node.func, ast.Attribute):
                    continue
                attr = node.func.attr
                if attr == "join" and not node.args and not node.keywords:
                    yield Finding(
                        path=str(src.path),
                        line=node.lineno,
                        rule=self.name,
                        message=(
                            ".join() with no timeout can block this thread "
                            "forever on a stalled peer; join in a bounded "
                            "loop and act on the stall"
                        ),
                    )
                elif attr == "settimeout" and len(node.args) == 1 and \
                        isinstance(node.args[0], ast.Constant) and \
                        node.args[0].value is None:
                    yield Finding(
                        path=str(src.path),
                        line=node.lineno,
                        rule=self.name,
                        message=(
                            "settimeout(None) makes every subsequent socket "
                            "op block unboundedly; use a finite timeout"
                        ),
                    )
