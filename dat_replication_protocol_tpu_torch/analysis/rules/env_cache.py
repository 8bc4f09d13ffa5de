"""env-cache-policy: never freeze an environment decision into a cache.

Motivating incident (ADVICE.md, low): ``wire/change_codec`` and
``session/decoder`` each grew a private ``_fastpath_mod`` cache.  One
cached the ``DAT_FASTPATH_DISABLE`` decision forever, the other re-read
it per call — so flipping the env var mid-process disabled the dispatch
loop while silently leaving the C codec active.  Tests that set the
variable to force the pure-Python path were exercising half of it.
The sanctioned policy lives in ``runtime.fastpath.get()`` /
``runtime.native.get_lib()``: re-read the gating variable on every
call, cache only the expensive import/build.

The rule flags the two shapes that freeze an environment read:

* a function that both assigns a ``global``-declared name (a module
  cache) and reads the environment (``os``'s mapping or getter) — the
  decision ends
  up inside the cache;
* a module-level assignment whose right-hand side reads the
  environment — frozen at first import, invisible to later ``setenv``.

Reading the environment fresh per call, or caching state that is not
derived from an environment read, is fine.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import ENVIRON, GETENV, OS_ENVIRON, OS_GETENV, Finding, \
    Project, assign_targets, dotted_name, walk_function_body


def _env_reads(node: ast.AST) -> Iterator[ast.AST]:
    """Environment read sites (mapping or getter) lexically under ``node``
    (not descending into nested defs)."""
    for child in walk_function_body(node):
        if isinstance(child, ast.Attribute) and \
                dotted_name(child) in (OS_ENVIRON, ENVIRON):
            yield child
        elif isinstance(child, ast.Call) and \
                dotted_name(child.func) in (OS_GETENV, GETENV):
            yield child


class EnvCachePolicy:
    name = "env-cache-policy"
    description = (
        f"{OS_ENVIRON} reads must not be frozen into module-level caches; "
        "route gating through the shared runtime helpers"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.py_sources:
            tree = src.tree
            if tree is None:
                continue
            # module-level: RHS of a top-level assignment reads the env
            for stmt in tree.body:
                if not list(assign_targets(stmt)):
                    continue
                value = getattr(stmt, "value", None)
                if value is None:
                    continue
                holder = ast.Module(body=[ast.Expr(value=value)],
                                    type_ignores=[])
                for read in _env_reads(holder):
                    yield Finding(
                        path=str(src.path),
                        line=stmt.lineno,
                        rule=self.name,
                        message=(
                            "environment read frozen into a module-level "
                            "value at import time; later setenv calls are "
                            "silently ignored — read it inside the using "
                            "function instead"
                        ),
                    )
                    break
            # function-level: global cache assigned + env read in one body
            for node in ast.walk(tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                yield from self._check_function(src, node)

    def _check_function(self, src, fn: ast.AST) -> Iterator[Finding]:
        global_names: set[str] = set()
        for child in walk_function_body(fn):
            if isinstance(child, ast.Global):
                global_names.update(child.names)
        if not global_names:
            return
        caches_global = any(
            isinstance(t, ast.Name) and t.id in global_names
            for child in walk_function_body(fn)
            for t in assign_targets(child)
        )
        if not caches_global:
            return
        for read in _env_reads(fn):
            yield Finding(
                path=str(src.path),
                line=read.lineno,
                rule=self.name,
                message=(
                    f"{fn.name} reads {OS_ENVIRON} while populating a module "
                    f"cache ({', '.join(sorted(global_names))}): the env "
                    f"decision gets frozen into the cache (split-brain when "
                    f"set mid-process).  Cache only the import; re-read the "
                    f"variable per call (see runtime.fastpath.get)"
                ),
            )
            return  # one finding per function is enough
