"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``build/torch_kernels/`` beside the package, and bound with ``ctypes``:
no PyTorch headers are compiled, so a build takes seconds.  The library
name carries a hash of the sources and flags, so an edited kernel is
rebuilt and a stale one is never loaded.

Every pointer and the stream cross as ``ctypes.c_void_p``; every C entry
returns ``cudaGetLastError()``, which the wrappers check.  A failed build
raises: nothing here falls back to the plain versions.  Each ``nvcc`` is
bounded by :data:`BUILD_TIMEOUT_S`: one that runs past it is killed and
the build raises, so a first launch never waits without end (it may sit
on a dispatch loop's path, as the edge's snapshot admission does).

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")
# seconds one nvcc may take before it is killed; all seven sources build
# together in about 7 s on an H100 host
BUILD_TIMEOUT_S = 120.0

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


def _compile(nvcc: str, name: str):
    """One ``nvcc`` for source ``name``, bounded by
    :data:`BUILD_TIMEOUT_S`.  Returns ``(error or None, report)``."""
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        tmp.unlink(missing_ok=True)
        return (f"{name}: nvcc ran past {BUILD_TIMEOUT_S} s and was "
                f"killed"), None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{name}: nvcc exited {proc.returncode}\n{proc.stdout}", None
    os.replace(tmp, out)
    return None, {"seconds": time.perf_counter() - t0, "log": proc.stdout}


def build(names=tuple(SIGNATURES)) -> dict[str, dict]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together (the first in the calling thread).
    Returns ``{source: {"seconds": s, "log": ptxas report}}`` for the
    libraries compiled by this call; raises ``RuntimeError`` with the
    compiler's output on any failure, or naming the source whose
    ``nvcc`` ran past :data:`BUILD_TIMEOUT_S`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    with ThreadPoolExecutor(max_workers=max(1, len(todo) - 1)) as pool:
        rest = [pool.submit(_compile, nvcc, name) for name in todo[1:]]
        results = [_compile(nvcc, todo[0])] + [f.result() for f in rest]
    report, failed = {}, []
    for name, (error, rep) in zip(todo, results):
        if error is not None:
            failed.append(error)
        else:
            report[name] = rep
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
