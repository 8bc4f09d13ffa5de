"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``build/torch_kernels/`` beside the package, and bound with ``ctypes``:
no PyTorch headers are compiled, so a build takes seconds.  The library
name carries a hash of the sources and flags, so an edited kernel is
rebuilt and a stale one is never loaded.

Every pointer and the stream cross as ``ctypes.c_void_p``; every C entry
returns ``cudaGetLastError()``, which the wrappers check.  A failed build
raises: nothing here falls back to the plain versions.

``SIGNATURES`` maps each source's name to the C entry points it holds and
their argument types; loading a source binds all of them (B1's
``blake2b.cu`` holds the one-shot hash and the chained update).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and argument types of each kernel library
SIGNATURES = {
    "blake2b": {
        "dat_blake2b_packed": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        # state, counter, message, lengths and last flags in; state and
        # counter out; batch, nblocks, lanes
        "dat_blake2b_update": (_P,) * 12 + (_I, _I, _I, _P),
    },
    # a latency probe for chip_smoke.py's chain bound, not a port kernel
    "chain_latency": {"dat_chain_latency": (_P, _P, _I, _I, _P)},
    "merkle_level": {"dat_merkle_level": (_P, _P, _P, _P, _I, _P)},
    "gear_candidates": {"dat_gear_candidates": (_P, _P, _I, _I, _I, _P)},
    # the staged B4 also takes its launch geometry: CTAs, spans
    "gear_first": {"dat_gear_first": (_P, _P, _I, _I, _I, _I, _I, _P)},
    "gear_window_first": {
        "dat_gear_window_first": (_P, _P, _I, _I, _I, _I, _P)},
    "gear_window_first_checked": {
        "dat_gear_window_first_checked": (_P, _P, _P, _I, _I, _I, _I, _P)},
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where source ``name`` builds to: keyed by sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, dict]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{source:
    {"seconds": s, "log": ptxas report}}`` for the libraries compiled by
    this call; raises ``RuntimeError`` with the compiler's output on any
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The bound library of source ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
