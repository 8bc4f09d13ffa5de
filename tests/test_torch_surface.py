"""The JAX package's public surface, held against the port's.

Each module of the JAX package and its counterpart in the port (the same
relative path, or the one ``COUNTERPARTS`` names) are parsed with
``ast``; neither package is imported.  A module's surface is its public
top-level functions and classes, the public methods of those classes
(the port's inherited ones count, through bases in the same package),
its upper-case constants and its ``__all__``.  Every name of the JAX
package's surface must be on the port's, or be listed in ``NOT_PORTED``
or ``RENAMED``; every module must have a counterpart or be listed in
``MODULES_NOT_PORTED``.  Each entry gives one line of reason of a kind
in ``KINDS``.  ROADMAP.md's "Not to be ported" list says the same.
"""

from __future__ import annotations

import ast
from functools import lru_cache
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "dat_replication_protocol_tpu"
PORT = ROOT / "dat_replication_protocol_tpu_torch"

KINDS = ("one device path", "no env switch", "JAX-only", "host engine",
         "renamed", "item 2")

# the JAX module -> its counterpart in the port, where the paths differ
COUNTERPARTS = {"backend/tpu_backend.py": "backend/cuda_backend.py"}

MODULES_NOT_PORTED = {
    "native/__init__.py": (
        "renamed", "the C sources' package marker: the port's native/ "
        "holds the sources alone, built by runtime/native.py"),
    "obs/perf.py": (
        "item 2", "the benchmark's ledger (PERF_LEDGER.jsonl) gates the "
        "port, which has no budgets"),
    "ops/blake2b_pallas.py": (
        "renamed", "B1 in csrc/blake2b.cu, bound by ops/blake2b_cuda.py"),
    "ops/merkle_pallas.py": (
        "renamed", "B2 in csrc/merkle_level.cu, bound by ops/merkle_cuda.py"),
    "ops/rabin_pallas.py": (
        "renamed", "B3-B5 in csrc/gear_*.cu, bound by ops/rabin_cuda.py"),
    "ops/fused_cdc_hash_pallas.py": (
        "renamed", "B6 and the single-residency route in "
        "csrc/gear_window_first_checked.cu and ops/fused_cdc_hash.py"),
    "ops/u64.py": (
        "JAX-only", "64-bit words as u32 pairs for a TPU without 64-bit "
        "lanes; CUDA has them and the plain versions use int64"),
    "utils/cache.py": ("JAX-only", "the XLA compile cache"),
    "utils/jax_compat.py": ("JAX-only", "shims over JAX versions"),
    "utils/num.py": ("JAX-only", "next_pow2, inlined in ops/merkle.py"),
    "utils/routing.py": (
        "one device path", "the host-or-device engine choice; device= "
        "names the device"),
}

# (JAX module, name) -> the port's name for it in the counterpart module
RENAMED = {
    ("backend/tpu_backend.py", "TpuDecoder"): "CudaDecoder",
    ("backend/tpu_backend.py", "TpuEncoder"): "CudaEncoder",
    ("obs/device.py", "JitSentinel"): "KernelSentinel",
    ("obs/device.py", "jit_site"): "kernel_site",
    ("utils/chiplock.py", "DEFAULT_LOCK_PATH"): "lock_path",
}

# (JAX module, name) -> why the port lacks it
NOT_PORTED = {
    ("obs/__main__.py", "cmd_perf_check"): (
        "item 2", "perf-check went with obs/perf.py: the benchmark's "
        "ledger gates the port"),
    ("obs/wirecost.py", "OBS"): (
        "renamed", "obs.metrics.OBS: the port's sites import the gate "
        "from its owner"),
    ("ops/blake2b.py", "compress_soa"): (
        "JAX-only", "the XLA scan's compression; B1 replaces it"),
    ("ops/blake2b.py", "donation_supported"): (
        "JAX-only", "XLA buffer donation"),
    ("ops/rabin.py", "effective_route"): (
        "no env switch", "DAT_CDC_FIRST_KERNEL; route= is the keyword"),
    ("ops/rabin.py", "pallas_active"): (
        "no env switch", "the Pallas route's switches; one device path"),
    ("parallel/mesh.py", "batch_sharding"): (
        "JAX-only", "a jax.sharding layout; the mesh runs on "
        "torch.distributed"),
    ("parallel/mesh.py", "replicated"): (
        "JAX-only", "a jax.sharding layout; the mesh runs on "
        "torch.distributed"),
    ("runtime/content.py", "resolve_cdc_route"): (
        "no env switch", "DAT_CDC_ROUTE; route= is the keyword"),
    ("runtime/fastpath.py", "reset_for_tests"): (
        "no env switch", "re-reads DAT_FASTPATH_DISABLE; native= is the "
        "keyword"),
    ("runtime/native.py", "available"): (
        "one device path", "a failed build raises; nothing asks whether "
        "to fall back"),
    ("runtime/native.py", "reset_for_tests"): (
        "no env switch", "re-reads DAT_NATIVE_DISABLE; native= is the "
        "keyword"),
    ("runtime/native.py", "hash_many"): (
        "host engine", "B1 through DigestPipeline and feed.hash_extents"),
    ("runtime/native.py", "hash_many_fallback"): (
        "host engine", "B1 through DigestPipeline and feed.hash_extents"),
    ("runtime/native.py", "hash_many_list"): (
        "host engine", "B1 through DigestPipeline and feed.hash_extents"),
    ("runtime/native.py", "sketch"): (
        "host engine", "the device LogSummary's scatter-add"),
    ("runtime/native.py", "rateless_build"): (
        "host engine", "rateless.build_symbols_device"),
    ("runtime/native.py", "rateless_build_w"): (
        "host engine", "rateless.build_symbols_device"),
    ("runtime/native.py", "gear_candidates"): (
        "host engine", "B3-B6"),
    ("runtime/native.py", "cdc_hash"): (
        "host engine", "B3-B6 with B1 (content_begin)"),
}

# what the last bring-up slice added, so that dropping it fails by name
THIS_SLICE = {
    "hub/engine.py": {"HubSession.submit_many"},
    "session/encoder.py": {"Encoder.buffered_bytes"},
    "wire/varint.py": {"uvarint_length"},
    "wire/__init__.py": {"uvarint_length"},
    "utils/chiplock.py": {"chip_lock", "ChipLease", "ChipLease.as_fields",
                          "ChipLease.uncontended", "lock_path"},
}


def _modules(pkg: Path) -> list[str]:
    return sorted(p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py"))


@lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text("utf-8"), filename=str(path))


def _top(body):
    """Top-level statements, looking into ``if`` and ``try`` blocks."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _top(node.body)
            yield from _top(node.orelse)
            for h in getattr(node, "handlers", ()):
                yield from _top(h.body)
            yield from _top(getattr(node, "finalbody", ()))
        else:
            yield node


def _public(name: str) -> bool:
    return not name.startswith("_")


def _methods(cls: ast.ClassDef) -> set[str]:
    return {m.name for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
            and _public(m.name)}


def _classes(path: Path) -> dict[str, ast.ClassDef]:
    return {n.name: n for n in _top(_tree(path).body)
            if isinstance(n, ast.ClassDef)}


def _imported(path: Path, pkg: Path) -> dict[str, tuple[Path, str]]:
    """Names bound by relative imports from modules of ``pkg``."""
    out = {}
    for n in _top(_tree(path).body):
        if isinstance(n, ast.ImportFrom) and n.level:
            base = path.parent
            for _ in range(n.level - 1):
                base = base.parent
            target = base.joinpath(*(n.module or "").split("."))
            src = target.with_suffix(".py") if target.with_suffix(
                ".py").exists() else target / "__init__.py"
            for a in n.names:
                out[a.asname or a.name] = (src, a.name)
    return out


def _all_methods(path: Path, name: str, pkg: Path, seen=()) -> set[str]:
    """Public methods of class ``name`` in ``path``, with those of its
    bases that are defined in the same package."""
    if (path, name) in seen or not path.exists():
        return set()
    seen = seen + ((path, name),)
    classes = _classes(path)
    if name not in classes:
        src = _imported(path, pkg).get(name)
        return _all_methods(*src, pkg, seen) if src else set()
    cls = classes[name]
    out = _methods(cls)
    for b in cls.bases:
        if isinstance(b, ast.Name):
            out |= _all_methods(path, b.id, pkg, seen)
    return out


def _dunder_all(tree: ast.Module) -> set[str]:
    for n in _top(tree.body):
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in n.targets):
            return {e.value for e in getattr(n.value, "elts", ())
                    if isinstance(e, ast.Constant)}
    return set()


def surface(path: Path, pkg: Path, inherited: bool = False) -> set[str]:
    """Public functions, classes (``Class``), their public methods
    (``Class.method``), upper-case constants and ``__all__`` of a module;
    with ``inherited``, also methods from bases in ``pkg`` and the names
    bound by imports."""
    tree = _tree(path)
    out = set(_dunder_all(tree))
    for n in _top(tree.body):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(n.name):
                out.add(n.name)
        elif isinstance(n, ast.ClassDef) and _public(n.name):
            out.add(n.name)
            methods = (_all_methods(path, n.name, pkg) if inherited
                       else _methods(n))
            out |= {f"{n.name}.{m}" for m in methods}
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                for e in ([t] if isinstance(t, ast.Name)
                          else getattr(t, "elts", [])):
                    if isinstance(e, ast.Name) and _public(e.id) and \
                            e.id.isupper():
                        out.add(e.id)
        elif inherited and isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


def _counterpart(rel: str) -> Path:
    return PORT / COUNTERPARTS.get(rel, rel)


def _origin(rel: str, name: str) -> tuple[str, str]:
    """Where the JAX package defines ``name`` of module ``rel``: a name a
    module binds by a relative import (a package's re-export) is judged
    where it is defined."""
    head, _, method = name.partition(".")
    src = _imported(JAX / rel, JAX).get(head)
    if src is None or not src[0].exists():
        return rel, name
    origin = src[0].relative_to(JAX).as_posix()
    return origin, f"{src[1]}.{method}" if method else src[1]


def _as_port_name(rel: str, name: str) -> str:
    origin, oname = _origin(rel, name)
    head, _, method = name.partition(".")
    new = RENAMED.get((rel, head)) or RENAMED.get(
        (origin, oname.partition(".")[0]))
    head = new or head
    return f"{head}.{method}" if method else head


def _excused(rel: str, name: str) -> bool:
    origin, oname = _origin(rel, name)
    return (origin in MODULES_NOT_PORTED
            or any(key in NOT_PORTED for key in (
                (rel, name), (rel, name.partition(".")[0]),
                (origin, oname), (origin, oname.partition(".")[0]))))


def _missing(rel: str) -> list[str]:
    port = surface(_counterpart(rel), PORT, inherited=True)
    return sorted(name for name in surface(JAX / rel, JAX)
                  if not _excused(rel, name)
                  and _as_port_name(rel, name) not in port)


JAX_MODULES = _modules(JAX)
PORTED = [m for m in JAX_MODULES if m not in MODULES_NOT_PORTED]


def test_every_jax_module_has_a_counterpart_or_a_reason():
    missing = [m for m in PORTED if not _counterpart(m).exists()]
    assert missing == [], (
        f"JAX modules with no counterpart in the port and no line in "
        f"MODULES_NOT_PORTED: {missing}")


@pytest.mark.parametrize("rel", PORTED)
def test_the_port_has_the_jax_modules_public_surface(rel):
    assert _counterpart(rel).exists(), rel
    missing = _missing(rel)
    assert missing == [], (
        f"the port's {COUNTERPARTS.get(rel, rel)} lacks {missing}, public "
        f"names of the JAX package's {rel}; port them or give each a line "
        f"in NOT_PORTED / RENAMED")


def test_every_table_entry_is_live():
    # a stale line would hide a later omission of the same name
    for rel in MODULES_NOT_PORTED:
        assert (JAX / rel).exists(), rel
        assert rel in COUNTERPARTS or not (PORT / rel).exists(), rel
    for rel, name in NOT_PORTED:
        assert name in surface(JAX / rel, JAX), (rel, name)
        assert name not in surface(_counterpart(rel), PORT, inherited=True), (
            f"{rel}:{name} is in the port: take its NOT_PORTED line out")
    for (rel, name), new in RENAMED.items():
        assert name in surface(JAX / rel, JAX), (rel, name)
        assert new in surface(_counterpart(rel), PORT, inherited=True), (
            rel, new)
    for rel, new in COUNTERPARTS.items():
        assert (JAX / rel).exists() and (PORT / new).exists(), rel


def test_every_reason_is_one_line_of_a_known_kind():
    for key, (kind, why) in {**MODULES_NOT_PORTED, **NOT_PORTED}.items():
        assert kind in KINDS, key
        assert why and "\n" not in why, key


@pytest.mark.parametrize("rel", sorted(THIS_SLICE))
def test_the_last_slices_names_are_on_both_surfaces(rel):
    names = THIS_SLICE[rel]
    assert names <= surface(JAX / rel, JAX)
    assert names <= surface(PORT / rel, PORT, inherited=True)


def test_the_scan_sees_renames_and_inherited_methods():
    # the port's CudaDecoder takes on_digest from a private base
    # (_DigestTaps), and rateless's decoders add_symbols from _Decoder
    port = surface(PORT / "backend/cuda_backend.py", PORT, inherited=True)
    assert {"CudaDecoder.on_digest", "CudaDecoder.digest_pipeline",
            "CudaDecoder.write", "DIGEST_SIZE"} <= port
    assert "CudaDecoder.on_digest" not in surface(
        PORT / "backend/cuda_backend.py", PORT)
    assert "PeelDecoder.add_symbols" in surface(PORT / "ops/rateless.py",
                                                PORT, inherited=True)
    assert _missing("backend/tpu_backend.py") == []
