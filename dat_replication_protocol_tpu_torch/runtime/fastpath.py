"""Build and import the ``dat_fastpath`` CPython extension.

Unlike :mod:`.native` (a plain C ABI loaded with ``ctypes``), the
decoder's dispatch loop creates Python objects and calls handlers, so
``native/dat_fastpath.cpp`` is a real extension module, compiled at
first use against this interpreter's headers
(``sysconfig.get_paths()["include"]``) into ``build/torch_host/``.  The
build is keyed by the source and ``sys.version``: an extension built for
one CPython is never loaded into another.

As in :mod:`.native`, a failed build or import raises ``RuntimeError``
naming the source; the Python route is chosen only explicitly
(``native=False``), never as a fallback.  Consumers reach this module
through :func:`.._fastpath_gate.fastpath_mod`, the one lazy binding the
codec and the decoder share.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import sys
import sysconfig
import threading
from pathlib import Path

from .native import BUILD_DIR, compile_library

SOURCE = Path(__file__).resolve().parent.parent / "native" / "dat_fastpath.cpp"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_mod = None


def _include() -> str:
    include = sysconfig.get_paths().get("include")
    if not include or not os.path.isfile(os.path.join(include, "Python.h")):
        raise RuntimeError(f"dat_fastpath build of {SOURCE}: no Python.h "
                           f"under {include!r}")
    return include


def library_path() -> Path:
    """Where the extension builds to: keyed by its source, flags and the
    interpreter (``sys.version``)."""
    h = hashlib.blake2b(SOURCE.read_bytes(), digest_size=8)
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(sys.version.encode())
    return BUILD_DIR / f"dat_fastpath-{h.hexdigest()}.so"


def build() -> dict:
    """Compile the extension unless it is built: ``{"seconds": s}`` when
    this call compiled it, ``{}`` otherwise; raises ``RuntimeError`` on
    any failure."""
    out = library_path()
    if out.exists():
        return {}
    flags = (*GXX_FLAGS, f"-I{_include()}")
    return {"seconds": compile_library(SOURCE, out, flags, "dat_fastpath")}


def get():
    """The imported extension module, built and imported once per
    process."""
    mod = _mod
    if mod is not None:  # lock-free after the first import
        return mod
    return _load_once()


def _load_once():
    global _mod
    with _lock:
        if _mod is None:
            # the one-time build runs under the load lock by design:
            # every caller needs its result, and g++ is bounded by
            # BUILD_TIMEOUT_S  # datlint: allow-blocking-under-lock
            build()
            so = library_path()
            try:
                # its own module name: the JAX package's extension is
                # dat_fastpath, and one process may hold both
                spec = importlib.util.spec_from_file_location(
                    "dat_torch_fastpath", str(so))
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            except Exception as e:
                raise RuntimeError(f"dat_fastpath import of {so} (built "
                                   f"from {SOURCE}) failed: {e}") from e
            _mod = mod
        return _mod
