"""jit-purity: no host effects inside traced function bodies.

Motivating pattern (PERF.md rounds 3-5): a ``jax.jit`` / Pallas body
executes at trace time, then replays as compiled XLA.  Host-side
effects inside one are at best silent no-ops after the first call and
at worst synchronization points that stall the dispatch pipeline:

* environment reads — traced once, frozen into the compiled
  program; the env-var toggle "works" until the cache warms, then
  never again (the same split-brain class env-cache-policy catches on
  the host side);
* host syncs — ``.block_until_ready()``, ``jax.device_get`` or
  ``np.asarray``/``np.array``/``np.frombuffer`` applied to a traced
  parameter force a device round-trip per call inside what should be
  one fused dispatch;
* Python-side mutation — ``global``/``nonlocal`` rebinding inside a
  traced body runs once at trace time, not per execution.

A function counts as traced when decorated with ``jit`` /
``jax.jit`` / ``functools.partial(jax.jit, ...)``, passed by name to
``jax.jit(...)`` / ``pl.pallas_call(...)``, or nested inside one that
is.  Helpers called *from* traced code are deliberately out of scope
(no call-graph analysis): the rule polices the bodies where tracing
demonstrably begins.

The rule stays in the registry so this analyzer gives the JAX
package's findings on any tree; the port's own package traces nothing,
so there it finds nothing.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import ENVIRON, GETENV, OS_ENVIRON, OS_GETENV, Finding, \
    Project, dotted_name, walk_function_body

_JIT_TAILS = ("jit",)
_TRACER_CALL_TAILS = ("jit", "pallas_call")
_SYNC_CALL_TAILS = ("block_until_ready", "device_get")
_HOST_MATERIALIZERS = ("asarray", "array", "frombuffer")


def _ends_with(name: str | None, tails: tuple[str, ...]) -> bool:
    return name is not None and name.rsplit(".", 1)[-1] in tails


def _is_jit_decorator(dec: ast.expr) -> bool:
    name = dotted_name(dec)
    if _ends_with(name, _JIT_TAILS):
        return True
    if isinstance(dec, ast.Call):
        fname = dotted_name(dec.func)
        if _ends_with(fname, _JIT_TAILS + ("pallas_call",)):
            return True
        # functools.partial(jax.jit, ...): the first argument is the tracer
        if _ends_with(fname, ("partial",)) and dec.args:
            return _ends_with(dotted_name(dec.args[0]), _JIT_TAILS)
    return False


def _traced_function_names(tree: ast.Module) -> set[str]:
    """Names of functions handed to jax.jit(...) / pl.pallas_call(...)
    as call arguments anywhere in the module."""
    named: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not _ends_with(dotted_name(node.func), _TRACER_CALL_TAILS):
            continue
        for arg in node.args[:1]:  # the traced callable is the first arg
            if isinstance(arg, ast.Name):
                named.add(arg.id)
    return named


class JitPurity:
    name = "jit-purity"
    description = (
        "no environment reads, host syncs, or Python-side mutation "
        "inside jit/Pallas-traced function bodies"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.py_sources:
            tree = src.tree
            if tree is None:
                continue
            by_call = _traced_function_names(tree)
            # walk with an explicit stack so nesting inside a traced
            # function marks the whole subtree as traced
            stack: list[tuple[ast.AST, bool]] = [(tree, False)]
            while stack:
                node, in_traced = stack.pop()
                for child in ast.iter_child_nodes(node):
                    traced_here = in_traced
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        traced_here = (
                            in_traced
                            or child.name in by_call
                            or any(_is_jit_decorator(d)
                                   for d in child.decorator_list)
                        )
                        if traced_here:
                            yield from self._check_body(src, child)
                            continue  # _check_body covered the subtree
                    stack.append((child, traced_here))

    def _check_body(self, src, fn: ast.AST) -> Iterator[Finding]:
        params = {a.arg for a in list(fn.args.args)
                  + list(fn.args.posonlyargs) + list(fn.args.kwonlyargs)}

        def _visit(scope: ast.AST) -> Iterator[Finding]:
            for node in walk_function_body(scope):
                yield from self._check_node(src, fn, node, params)
                # nested defs inside a traced body are traced too
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield from _visit(node)
        yield from _visit(fn)

    def _check_node(self, src, fn, node: ast.AST,
                    params: set[str]) -> Iterator[Finding]:
        def finding(msg: str) -> Finding:
            return Finding(path=str(src.path), line=node.lineno,
                           rule=self.name,
                           message=f"in traced function {fn.name}: {msg}")

        if isinstance(node, ast.Attribute) and \
                dotted_name(node) in (OS_ENVIRON, ENVIRON):
            yield finding(
                f"{OS_ENVIRON} read is evaluated once at trace time and "
                "frozen into the compiled program")
        elif isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if _ends_with(name, (GETENV,)) and (name or "").startswith(
                    ("os.", GETENV)):
                yield finding(
                    f"{OS_GETENV} is evaluated once at trace time and frozen "
                    "into the compiled program")
            elif _ends_with(name, _SYNC_CALL_TAILS):
                yield finding(
                    f"{(name or '').rsplit('.', 1)[-1]}() is a host "
                    f"synchronization point inside a traced body")
            elif (name is not None and "." in name
                  and name.rsplit(".", 1)[0] in ("np", "numpy")
                  and _ends_with(name, _HOST_MATERIALIZERS)
                  and node.args
                  and isinstance(node.args[0], ast.Name)
                  and node.args[0].id in params):
                yield finding(
                    f"{name}() on a traced argument forces a device->host "
                    f"transfer every call; use jnp or hoist it out of the "
                    f"traced body")
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            kind = "global" if isinstance(node, ast.Global) else "nonlocal"
            yield finding(
                f"{kind} rebinding executes at trace time only — the "
                f"mutation will not happen on later compiled calls")
