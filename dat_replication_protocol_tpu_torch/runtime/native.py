"""Build, load and bind the port's host codec library.

``native/dat_native.cpp`` (the port's trimmed copy of the JAX package's
``native/dat_native.cpp``) is a plain C ABI, compiled at first use with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into ``build/torch_host/``
beside the package and loaded with ``ctypes``.  The library's name
carries a hash of the source and flags, so an edited source is rebuilt
and a stale build never loaded; the compiler writes a temporary file
that is renamed into place, so builders racing in two processes both
end with a whole library.

A failed build or load raises ``RuntimeError`` naming the source:
nothing here falls back to the Python route.  The Python route of each
entry point that uses this library is its plain version, chosen only by
an explicit ``native=False`` at that entry point.  ``g++`` is bounded by
:data:`BUILD_TIMEOUT_S` (the first load may sit on the edge loop's
path, through the decoder), and killed past it.

Entry points (the JAX package's ``runtime/native.py``, the codec and
pump halves): :func:`split_frames`, :func:`greedy_select`,
:func:`decode_changes`, :func:`encode_changes`,
:func:`encode_change_batch`, and the wire pump's :func:`pump_probe`,
:func:`pump_recv_scan` and :func:`pump_send_spans`.  The threaded
entries run on the hardware's count of threads, as the JAX package's do
with ``DAT_NTHREADS`` unset; :func:`decode_changes_serial` is the serial
decode the session decoder runs on its own thread.  The pump's wrappers
are thin: the route, the decoder feeding, flow control and telemetry
live in ``session/pump.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..wire.framing import MAX_HEADER_LEN

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "dat_native.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_host"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# seconds one g++ may take before it is killed; dat_native builds in
# about 2 s and dat_fastpath in about 2.5 s on an H100 host
BUILD_TIMEOUT_S = 120.0

# the C side's error codes (native/dat_native.cpp DAT_ERR_*)
ERR_TRUNCATED = -1
ERR_CAPACITY = -2
ERR_BAD_VARINT = -3
ERR_BAD_RECORD = -4
ERR_NOMEM = -5

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_U32P = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64
_I64REF = ctypes.POINTER(ctypes.c_int64)
_COLS = (_U32P, _U32P, _U32P) + (_I64P,) * 6  # change/from/to + 3 extents

# C entry points and their (restype, argtypes)
SIGNATURES = {
    "dat_split_frames": (_I64, [_U8P, _I64, _I64P, _I64P, _U8P, _I64,
                                _I64REF, _I64REF]),
    "dat_greedy_select": (_I64, [_I64P, _I64, _I64, _I64, _I64, _I64P,
                                 _I64]),
    "dat_decode_changes": (_I64, [_U8P, _I64P, _I64P, _I64, *_COLS,
                                  _I64REF]),
    "dat_decode_changes_mt": (_I64, [_U8P, _I64P, _I64P, _I64, *_COLS,
                                     _I64REF, _I64]),
    "dat_encode_changes": (_I64, [_U8P, _I64, *_COLS, _U8P, _I64]),
    "dat_encode_changes_mt": (_I64, [_U8P, _I64, *_COLS, _U8P, _I64,
                                     _I64]),
    "dat_encode_change_batch": (_I64, [_U8P, _I64, *_COLS, _U8P, _I64]),
    "dat_pump_probe": (_I64, []),
    "dat_pump_recv_scan": (_I64, [_I64, _U8P, _I64, _I64, _I64P, _I64P,
                                  _U8P, _I64, _I64REF, _I64REF, _I64REF,
                                  _I64P]),
    "dat_pump_send": (_I64, [_I64P, _I64P, _I64, _I64, _I64P]),
    "dat_pump_send_nb": (_I64, [_I64P, _I64P, _I64, _I64, _I64P]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(f"g++ not found: {SOURCE} cannot be built")
    return found


def compile_library(source: Path, out: Path, flags, what: str) -> float:
    """One bounded ``g++`` of ``source`` into ``out`` (written to a
    temporary name, then renamed into place).  Returns the seconds it
    took; raises ``RuntimeError`` naming ``source`` when the compiler
    fails, is missing or runs past :data:`BUILD_TIMEOUT_S`."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp")
    cmd = [_gxx(), *flags, str(source), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} build of {source}: g++ ran past "
                           f"{BUILD_TIMEOUT_S} s and was killed") from None
    except OSError as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} build of {source}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} build of {source}: g++ exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def library_path() -> Path:
    """Where the library builds to: keyed by its source and flags."""
    h = hashlib.blake2b(SOURCE.read_bytes(), digest_size=8)
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"dat_native-{h.hexdigest()}.so"


def build() -> dict:
    """Compile the library unless it is built.  Returns ``{"seconds":
    s}`` when this call compiled it, ``{}`` when it was built already;
    raises ``RuntimeError`` on any failure."""
    out = library_path()
    if out.exists():
        return {}
    return {"seconds": compile_library(SOURCE, out, GXX_FLAGS, "dat_native")}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def get_lib() -> ctypes.CDLL:
    """The bound library, built and loaded once per process."""
    lib = _lib
    if lib is not None:  # lock-free after the first load
        return lib
    return _load_once()


def _load_once() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            # the one-time build runs under the load lock by design:
            # every caller needs its result, and g++ is bounded by
            # BUILD_TIMEOUT_S  # datlint: allow-blocking-under-lock
            build()
            try:
                lib = ctypes.CDLL(str(library_path()))
            except OSError as e:
                raise RuntimeError(
                    f"dat_native load of {library_path()} (built from "
                    f"{SOURCE}) failed: {e}") from e
            _lib = _bind(lib)
        return _lib


def split_frames(buf: np.ndarray):
    """Index every complete frame of ``buf`` (uint8): ``(n, starts,
    lens, ids, consumed, err)``, the arrays over-allocated (only
    ``[:n]`` is the index).  A malformed header stops the scan there:
    ``err`` is then :data:`ERR_BAD_VARINT` or :data:`ERR_BAD_RECORD` and
    ``consumed`` the offset of the bad frame."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    cap = len(buf) // 2 + 1  # a frame is at least 2 bytes
    starts = np.empty(cap, dtype=np.int64)
    lens = np.empty(cap, dtype=np.int64)
    ids = np.empty(cap, dtype=np.uint8)
    consumed = ctypes.c_int64(0)
    err = ctypes.c_int64(0)
    n = get_lib().dat_split_frames(buf, len(buf), starts, lens, ids, cap,
                                   ctypes.byref(consumed), ctypes.byref(err))
    if n < 0:  # the capacity holds every frame of len(buf) bytes
        raise RuntimeError(f"dat_split_frames failed (code {n})")
    return n, starts, lens, ids, int(consumed.value), int(err.value)


def greedy_select(candidates, length: int, min_size: int,
                  max_size: int) -> np.ndarray:
    """The CDC min/max cut pass over sorted candidate offsets: chunk
    end-offsets (int64), ending with ``length``."""
    cands = np.ascontiguousarray(candidates, dtype=np.int64)
    step = max(min(min_size, max_size), 1)  # each cut advances this much
    cap = length // step + 2
    out = np.empty(cap, dtype=np.int64)
    n = get_lib().dat_greedy_select(cands, len(cands), length, min_size,
                                    max_size, out, cap)
    if n < 0:
        raise RuntimeError(f"dat_greedy_select failed (code {n})")
    return out[:n]


def columns(cols, sub_len=None, val_len=None) -> tuple:
    """The nine column arrays of ``cols`` (a ``ChangeColumns`` or anything
    with its fields) in the C codec's argument order and dtypes, the
    subset and value lengths replaced when given.  Arrays already of the
    right dtype and contiguous are passed through, so the C side writes
    into them."""
    c = np.ascontiguousarray
    return (c(cols.change, np.uint32), c(cols.from_, np.uint32),
            c(cols.to, np.uint32), c(cols.key_off, np.int64),
            c(cols.key_len, np.int64), c(cols.sub_off, np.int64),
            c(cols.sub_len if sub_len is None else sub_len, np.int64),
            c(cols.val_off, np.int64),
            c(cols.val_len if val_len is None else val_len, np.int64))


def decode_changes(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                   cols) -> int:
    """Decode the ``Change`` payloads at ``starts``/``lens`` of ``buf``
    into ``cols`` (nine preallocated arrays: change, from, to as uint32;
    key, subset, value offsets and lengths as int64, -1 = absent), on
    the hardware's count of threads.  Returns -1, or the index of the
    first record the per-record codec rejects."""
    err = ctypes.c_int64(-1)
    rc = get_lib().dat_decode_changes_mt(buf, starts, lens, len(starts),
                                         *cols, ctypes.byref(err), 0)
    return _decoded(rc, err)


def decode_changes_serial(buf: np.ndarray, starts: np.ndarray,
                          lens: np.ndarray, cols) -> int:
    """:func:`decode_changes` on the calling thread alone."""
    err = ctypes.c_int64(-1)
    rc = get_lib().dat_decode_changes(buf, starts, lens, len(starts), *cols,
                                      ctypes.byref(err))
    return _decoded(rc, err)


def _decoded(rc: int, err: ctypes.c_int64) -> int:
    if rc == 0:
        return -1
    if rc != ERR_BAD_RECORD:
        raise RuntimeError(f"dat_decode_changes failed (code {rc})")
    return int(err.value)


def encode_changes(src: np.ndarray, n: int, cols):
    """Frame ``n`` columnar records over ``src`` as per-record ``Change``
    frames (``cols``: change, from, to, key/subset/value offsets and
    lengths, -1 = absent optional), on the hardware's count of threads.
    Returns the wire as a uint8 array."""
    chg, frm, tov, koff, klen, soff, slen, voff, vlen = cols
    heap = (int(klen.sum()) + int(np.maximum(slen, 0).sum())
            + int(np.maximum(vlen, 0).sum()))
    # per record: a header of at most 11 bytes and six tags with varints
    # of at most 10 bytes each
    cap = heap + 80 * n + 16
    dst = np.empty(cap, np.uint8)
    w = get_lib().dat_encode_changes_mt(src, n, *cols, dst, cap, 0)
    if w == ERR_NOMEM:
        raise MemoryError("dat_encode_changes: out of memory")
    if w < 0:
        raise RuntimeError(f"dat_encode_changes failed (code {w})")
    return dst[:w]


def encode_change_batch(src: np.ndarray, n: int, cols) -> bytes:
    """One columnar ``ChangeBatch`` payload of ``n`` records over
    ``src`` (the ChangeColumns layout; -1 lengths = absent optionals).
    The C pass owns the dictionary dedup, the one per-row step numpy
    cannot vectorize."""
    chg, frm, tov, koff, klen, soff, slen, voff, vlen = cols
    heap = (int(klen.sum()) + int(np.maximum(slen, 0).sum())
            + int(np.maximum(vlen, 0).sum()))
    # header + worst-case dictionaries (every span unique) + fixed
    # columns at their widest + the value heap
    cap = 64 + 32 * n + heap
    dst = np.empty(cap, np.uint8)
    w = get_lib().dat_encode_change_batch(src, n, *cols, dst, cap)
    if w == ERR_BAD_RECORD:
        # the Python tier's _pick_width raise, same class
        raise ValueError("value exceeds ChangeBatch width ladder")
    if w == ERR_NOMEM:
        raise MemoryError("dat_encode_change_batch: out of memory")
    if w < 0:
        raise RuntimeError(f"dat_encode_change_batch failed (code {w})")
    return dst[:w].tobytes()


# -- the wire pump ------------------------------------------------------------


def pump_probe() -> int:
    """Bitmask of the batched syscalls this kernel serves (bit 0
    ``recvmmsg``, bit 1 ``sendmmsg``).  The pump degrades per call on an
    fd that cannot take them (a pipe: plain ``read``/``writev``
    batches); the probe only reports."""
    return int(get_lib().dat_pump_probe())


def pump_recv_scan(fd: int, buf: np.ndarray, slice_bytes: int,
                   starts: np.ndarray, lens: np.ndarray, ids: np.ndarray,
                   stats: np.ndarray) -> tuple:
    """One batched receive into ``buf`` (uint8) and a frame index of the
    received prefix (``dat_pump_recv_scan``): ``(nbytes, nframes,
    consumed, err)``, ``nbytes`` 0 at EOF and ``-errno`` on a transport
    error; ``nframes`` and ``consumed`` are :func:`split_frames`'s over
    the prefix, written into ``starts``/``lens``/``ids`` (as many as
    they hold).  ``stats`` (int64[2]) gets [syscalls, messages]."""
    if len(buf) < MAX_HEADER_LEN or slice_bytes < 1:
        # the C side's DAT_ERR_CAPACITY, which would read as -ENOENT
        raise ValueError(f"dat_pump_recv_scan: a {len(buf)} B buffer in "
                         f"{slice_bytes} B slices cannot take a frame "
                         f"header")
    nf = ctypes.c_int64(0)
    consumed = ctypes.c_int64(0)
    err = ctypes.c_int64(0)
    n = get_lib().dat_pump_recv_scan(
        fd, buf, len(buf), slice_bytes, starts, lens, ids, len(starts),
        ctypes.byref(nf), ctypes.byref(consumed), ctypes.byref(err), stats)
    return int(n), int(nf.value), int(consumed.value), int(err.value)


def pump_send_spans(fd: int, addrs: np.ndarray, lens: np.ndarray, n: int,
                    stats: np.ndarray, nonblocking: bool = False) -> int:
    """Gather-send ``n`` (address, length) spans (``dat_pump_send``, or
    ``dat_pump_send_nb`` with ``nonblocking``): the bytes the kernel
    accepted (all of them on a blocking fd; up to the first would-block
    with ``nonblocking``) or ``-errno``.  A blocking send whose fd's
    ``SO_SNDTIMEO`` ran out is ``-EAGAIN``.  The caller keeps every
    span's buffer alive across the call."""
    lib = get_lib()
    fn = lib.dat_pump_send_nb if nonblocking else lib.dat_pump_send
    return int(fn(addrs, lens, n, fd, stats))
