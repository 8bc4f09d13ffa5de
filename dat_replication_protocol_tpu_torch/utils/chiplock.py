"""The card mutex: one ``flock(2)`` lock a process takes before it drives
a CUDA card.

The counterpart of ``dat_replication_protocol_tpu/utils/chiplock.py``.
Two processes measuring on the same card pollute each other's numbers,
so every device-touching entry point (``chip_smoke.py``, a benchmark's
device legs) takes this lock before it creates a CUDA context and holds
it for the whole run.  ``flock`` is released by the kernel when its
holder dies, so a crashed process never leaves the card locked.

Record contract: device legs record ``uncontended: bool``, True iff this
process took the lock without waiting and holds it for the whole leg.
A wait means another cooperating process was just on the card; running
lockless after ``max_wait`` records False, never silence.  Running
lockless is no device fallback: the block still runs on the card.

The lock scopes one card, not a checkout: the default path is named
after the UUID of the process's first visible card (read with
``nvidia-smi``, which creates no CUDA context), so two processes that
drive that card whatever their ``CUDA_VISIBLE_DEVICES`` name the same
file.  It lives in the process's temporary directory
(``tempfile.gettempdir()``, which follows ``TMPDIR``), so the lock
excludes only processes that share a temporary directory: callers on
one card with different ``TMPDIR``s must pass a common ``path=``, which
overrides the default.
"""

from __future__ import annotations

import errno
import fcntl
import os
import subprocess
import tempfile
import time
from contextlib import contextmanager

from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram

# the contention story in the registry: every acquisition's wait lands in
# the histogram, beside the per-leg ``waited_s`` field
_M_WAIT = _histogram("device.chiplock.wait")
_M_ACQUIRES = _counter("device.chiplock.acquires")
_M_CONTENDED = _counter("device.chiplock.contended")
_M_LOCKLESS = _counter("device.chiplock.lockless")

LOCK_PREFIX = "dat_torch_chip"


def card_uuid() -> str | None:
    """The UUID of the card this process sees as CUDA device 0, or None
    when ``nvidia-smi`` is missing or names no such card.

    The visible cards are ``CUDA_VISIBLE_DEVICES`` as PyTorch parses it:
    indices, read in ``nvidia-smi``'s order (CUDA's on a host of
    identical cards), or UUIDs and their prefixes.  Neither read creates
    a CUDA context."""
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,uuid", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    uuids = [u for _, u in sorted(
        (int(i), u.strip()) for i, u in
        (line.split(",", 1) for line in out.splitlines() if "," in line))]
    visible = torch.cuda._parse_visible_devices()
    if not visible:
        return None
    want = visible[0]
    if isinstance(want, int):
        return uuids[want] if 0 <= want < len(uuids) else None
    named = [u for u in uuids if u.startswith(want)]
    return named[0] if len(named) == 1 else None


def lock_path() -> str:
    """The default lock file: one per UUID of the first visible card, or
    one for the host when the card cannot be named."""
    uuid = card_uuid()
    name = f"{LOCK_PREFIX}-{uuid}.lock" if uuid else f"{LOCK_PREFIX}.lock"
    return os.path.join(tempfile.gettempdir(), name)


class ChipLease:
    """What :func:`chip_lock` yields: did we get it, and did we wait."""

    def __init__(self, held: bool, waited_s: float, path: str) -> None:
        self.held = held
        self.waited_s = waited_s
        self.path = path

    @property
    def uncontended(self) -> bool:
        """True iff the card was free the moment we asked for it."""
        return self.held and self.waited_s == 0.0

    def as_fields(self) -> dict:
        """The record form, merged into a device leg's result.

        While the lock is held the flock certifies the whole leg, so the
        values frozen at acquisition stay valid.  When it is not held,
        the lock is probed again, so each record says whether a peer is
        on the card at the moment it is stamped (``peer_active``)."""
        contended_now = False
        if not self.held:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o666)
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    fcntl.flock(fd, fcntl.LOCK_UN)
                except OSError:
                    contended_now = True
                finally:
                    os.close(fd)
            except OSError:
                pass
        return {
            "uncontended": self.uncontended and not contended_now,
            "chip_lock": {
                "held": self.held,
                "waited_s": round(self.waited_s, 1),
                **({"peer_active": contended_now} if not self.held else {}),
            },
        }


def _try_lock(fd: int) -> bool:
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        return True
    except OSError as e:
        if e.errno not in (errno.EAGAIN, errno.EACCES):
            raise
        return False


@contextmanager
def chip_lock(max_wait: float | None = None, poll_s: float = 2.0, *,
              path: str | None = None):
    """Hold the card's mutex for the block; take it before the first CUDA
    call.

    * taken at once: ``lease.uncontended`` is True;
    * taken after a wait: ``held`` True, ``uncontended`` False;
    * still contended after ``max_wait`` seconds: the block runs without
      the lock (``held`` False), so a stuck peer cannot blank a run, and
      the record says so.  ``max_wait=None`` waits for ever.

    ``path`` overrides the default lock file (:func:`lock_path`).  A
    lock file that cannot be opened runs the block lockless and counts it
    in ``device.chiplock.lockless``."""
    if path is None:
        path = lock_path()
    try:
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o666)
    except OSError:
        # e.g. the file belongs to another user and umask stripped 0o666
        if _OBS.on:
            _M_LOCKLESS.inc()
        yield ChipLease(False, 0.0, path)
        return
    held = False
    waited = 0.0
    try:
        held = _try_lock(fd)
        if not held:
            t0 = time.monotonic()
            while max_wait is None or time.monotonic() - t0 < max_wait:
                time.sleep(poll_s if max_wait is None
                           else min(poll_s, max_wait / 10 + 0.01))
                if _try_lock(fd):
                    held = True
                    break
            waited = time.monotonic() - t0
        if _OBS.on:
            _M_WAIT.observe(waited)
            (_M_ACQUIRES if held else _M_LOCKLESS).inc()
            if waited > 0.0:
                _M_CONTENDED.inc()
        if held:
            # a breadcrumb for a human looking at a contended card; a
            # read-only file system must not break the lock
            try:
                os.ftruncate(fd, 0)
                os.write(fd, f"pid={os.getpid()}\n".encode())
            except OSError:
                pass
        yield ChipLease(held, waited, path)
    finally:
        try:
            if held:
                fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)
