"""Exponential backoff with full jitter, the retry wrapper, and the
resumable receive driver.

The port's copy of ``dat_replication_protocol_tpu/session/reconnect.py``:
:class:`BackoffPolicy`, :func:`retrying` (which the sidecar's TCP
listener binds and accepts through) and :func:`run_resumable`.

Attempt ``k`` (1-based) sleeps ``uniform(0, min(cap, base * 2**k))``,
the "full jitter" variant that keeps many peers losing one link from
reconnecting in step.  Attempts are bounded: past ``max_retries`` faults
the wrapper gives up with ONE structured
:class:`~..wire.framing.ProtocolError` wrapping the last cause.

:func:`run_resumable` pulls bytes from a reconnectable source into a
decoder, exporting a checkpoint at every fault and asking the source for
a fresh connection that resumes from it.  The decoder object outlives
every connection, so its parser state and (on ``CudaDecoder``) its digest
pipeline and sequence counters carry across: digests still in flight on
the card when a fault hits arrive once, in submit order.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from ..obs.events import emit as _emit
from ..obs.flight import FLIGHT as _FLIGHT
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..obs.tracing import trace_span as _trace_span
from ..wire.framing import ProtocolError
from .decoder import Decoder, DecoderDestroyedError
from .faults import TransportFault
from .resume import SessionCheckpoint
from .transport import DEFAULT_CHUNK

__all__ = ["BackoffPolicy", "retrying", "run_resumable"]

# run_resumable's stats dict and these counters must agree exactly
_M_ATTEMPTS = _counter("reconnect.attempts")
_M_FAULTS = _counter("reconnect.faults")
_M_BACKOFFS = _counter("reconnect.backoffs")
_H_BACKOFF = _histogram("reconnect.backoff.seconds")


class BackoffPolicy:
    """Exponential backoff with full jitter, bounded attempts.

    ``seed`` pins the jitter for reproducible tests; ``sleep`` is
    injectable for the same reason.  ``max_retries`` counts *faults
    absorbed*: the first failure is retried while ``faults <=
    max_retries``, so ``max_retries=0`` means fail on the first fault.
    """

    def __init__(self, base: float = 0.05, cap: float = 5.0,
                 max_retries: int = 5, seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if base < 0 or cap < 0:
            raise ValueError("backoff base/cap must be >= 0")
        self.base = base
        self.cap = cap
        self.max_retries = max_retries
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delay(self, attempt: int) -> float:
        """Full-jitter delay before retry ``attempt`` (1-based)."""
        ceiling = min(self.cap, self.base * (2 ** max(0, attempt)))
        return self._rng.uniform(0.0, ceiling)

    def sleep_before(self, attempt: int) -> float:
        d = self.delay(attempt)
        if _OBS.on:
            # every backoff in the stack sleeps here
            _M_BACKOFFS.inc()
            _H_BACKOFF.observe(d)
            _emit("reconnect.backoff", attempt=attempt, seconds=d)
        if d > 0:
            self._sleep(d)
        return d


def retrying(fn: Callable[[], object], policy: BackoffPolicy,
             retry_on: tuple = (OSError,), describe: str = "operation"):
    """Run ``fn`` with the policy's backoff until it returns or the
    attempts are exhausted; the terminal failure is one structured
    ProtocolError wrapping the last cause."""
    failures = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            failures += 1
            if failures > policy.max_retries:
                err = ProtocolError(
                    f"{describe} failed after {failures} attempt(s)",
                    cause=e,
                )
                if _FLIGHT.armed:  # retry exhaustion is a post-mortem
                    _FLIGHT.dump("retry-exhausted", error=err)
                raise err from e
            policy.sleep_before(failures)


def _wire_error(errors: list, ckpt: SessionCheckpoint) -> ProtocolError:
    """The decoder destroyed itself: surface its error as ONE structured
    ProtocolError (wrapping non-protocol causes) with session context."""
    err = errors[-1] if errors else None
    if isinstance(err, ProtocolError):
        return err
    return ProtocolError(
        "session destroyed mid-stream",
        frame=ckpt.frame, offset=ckpt.wire_offset, cause=err,
    )


def run_resumable(
    source: Callable[[SessionCheckpoint, int], object],
    decoder: Decoder,
    policy: BackoffPolicy,
    chunk_size: int = DEFAULT_CHUNK,
    expected_total: Optional[int] = None,
    stall_timeout: Optional[float] = None,
    wait_step: float = 0.5,
) -> dict:
    """Drive a resumable receive session to completion.

    ``source(checkpoint, failures)`` opens a connection delivering wire
    bytes from ``checkpoint.wire_offset`` onward, as an object with
    ``read(n) -> bytes`` (``b''`` at EOF).  Connection death — opening
    or reading — may surface as :class:`TransportFault` or as any plain
    ``OSError`` (what a real socket raises: ``ConnectionResetError``,
    ``ETIMEDOUT``, ...); both take the reconnect path.

    Termination is trichotomous, never silent:

    * the decoder finishes with the complete session (returns stats);
    * ONE structured ProtocolError is raised — wire corruption, resume
      window lost, app stall past ``stall_timeout``, or attempts
      exhausted, each with frame/byte/cause context;
    * (there is no third option: every wait is bounded.)

    ``expected_total``, when the sender's produced length is known
    out-of-band, turns silent truncation (a clean EOF short of the
    declared length) into a reconnect instead of a quietly short
    session: an EOF-terminated wire format cannot tell the two apart
    in band.
    """
    stats = {"attempts": 0, "reconnects": 0, "faults": []}
    errors: list = []
    err_cb = errors.append
    decoder.on_error(err_cb)
    wake = threading.Event()
    decoder._add_drain_watcher(wake.set)
    failures = 0
    try:
        while True:
            ckpt = decoder.checkpoint()
            stats["attempts"] += 1
            if _OBS.on:
                _M_ATTEMPTS.inc()
                _emit("session.connect", attempt=stats["attempts"],
                      wire_offset=ckpt.wire_offset,
                      resumed=stats["attempts"] > 1)
            # The fault catches wrap ONLY the transport calls (source()
            # and reader.read) — catching OSError around decoder.write
            # would misclassify an app handler's own OSError (e.g.
            # ENOSPC while materializing a blob) as a transport fault
            # and "resume" a stream the failed delivery desynchronized.
            # OSError, not just TransportFault: a real socket surfaces
            # peer death as ConnectionResetError / ETIMEDOUT etc.
            # (TransportFault is itself a ConnectionError), and all of
            # it must land in the reconnect path, never escape raw.
            fault: Optional[OSError] = None
            # the attempt span brackets one connection's lifetime (open
            # -> EOF/fault), keyed on the wire offset it resumed from —
            # the exported trace shows each reconnect as its own span
            with _trace_span("reconnect.attempt",
                             attempt=stats["attempts"],
                             offset=ckpt.wire_offset):
                try:
                    reader = source(ckpt, failures)
                except OSError as e:
                    fault = e
                while fault is None:
                    try:
                        data = reader.read(chunk_size)
                    except OSError as e:
                        fault = e
                        break
                    if not data:
                        if (expected_total is not None
                                and decoder.bytes < expected_total):
                            # silent truncation: the connection closed
                            # cleanly short of the sender's declared
                            # length — same recovery path as a drop
                            if _OBS.on:
                                _emit("session.truncated",
                                      at=decoder.bytes,
                                      expected=expected_total)
                            fault = TransportFault(
                                f"truncated: clean EOF at byte "
                                f"{decoder.bytes} of {expected_total}",
                                offset=decoder.bytes)
                        break
                    wake.clear()
                    try:
                        consumed = decoder.write(data)
                    except DecoderDestroyedError:
                        raise _wire_error(errors, decoder.checkpoint())
                    if decoder.destroyed:
                        raise _wire_error(errors, decoder.checkpoint())
                    if not consumed:
                        _wait_writable(decoder, wake, wait_step,
                                       stall_timeout)
            if fault is not None:
                failures += 1
                stats["faults"].append(str(fault))
                if _OBS.on:
                    _M_FAULTS.inc()
                    _emit("reconnect.fault", failures=failures,
                          offset=decoder.bytes, cause=str(fault))
                if failures > policy.max_retries:
                    last = decoder.checkpoint()
                    if _OBS.on:
                        _emit("session.failed", failures=failures,
                              frame=last.frame, offset=last.wire_offset)
                    raise ProtocolError(
                        f"session lost after {failures} transport fault(s)",
                        frame=last.frame, offset=last.wire_offset,
                        cause=fault,
                    ) from fault
                stats["reconnects"] += 1
                policy.sleep_before(failures)
                continue
            # clean EOF this attempt
            if decoder.destroyed:
                raise _wire_error(errors, decoder.checkpoint())
            if not decoder.finished:
                decoder.end()
                if decoder.destroyed:  # e.g. EOF mid-frame
                    raise _wire_error(errors, decoder.checkpoint())
            if _OBS.on:
                _emit("session.complete", bytes=decoder.bytes,
                      reconnects=stats["reconnects"],
                      attempts=stats["attempts"])
            if stats["faults"] and _FLIGHT.armed:
                # the session survived its turbulence, but the faults
                # still deserve a post-mortem: an armed recorder keeps
                # a bundle per recovered incident, so chaos coordinates
                # stay attributable offline even when nothing failed.
                # routine=True: recovered dumps draw from the half of
                # the budget NOT reserved for genuine failures
                _FLIGHT.dump(
                    "recovered",
                    checkpoint=decoder.checkpoint(emit_event=False),
                    extra={"stats": dict(stats)}, routine=True)
            return stats
    except ProtocolError as e:
        # terminal failure (exhaustion, stall, wire error, resume-window
        # miss): ONE bundle for the incident — the decoder's own wire
        # errors were already dumped with this very object, and the
        # recorder dedups on error identity, so this cannot double-dump
        if _FLIGHT.armed:
            _FLIGHT.dump("session-failed", error=e,
                         checkpoint=decoder.checkpoint(emit_event=False))
        raise
    finally:
        decoder._remove_drain_watcher(wake.set)
        # symmetric cleanup: a long-lived decoder driven through this
        # function repeatedly must not accumulate stale error hooks
        try:
            decoder._error_cbs.remove(err_cb)
        except ValueError:
            pass


def _wait_writable(decoder: Decoder, wake: threading.Event,
                   wait_step: float, stall_timeout: Optional[float]) -> None:
    """Bounded wait for the app to drain the decoder: the drain watcher
    wakes us immediately on cross-thread acks; ``stall_timeout`` (when
    set) converts an app that never acks into a structured error
    instead of a parked-forever driver."""
    deadline = (None if stall_timeout is None
                else time.monotonic() + stall_timeout)
    while not (decoder.writable() or decoder.destroyed or decoder.finished):
        if deadline is not None and time.monotonic() > deadline:
            ckpt = decoder.checkpoint()
            if _OBS.on:
                _emit("session.stall", kind="app-ack",
                      seconds=stall_timeout, frame=ckpt.frame,
                      offset=ckpt.wire_offset)
            err = ProtocolError(
                f"app stalled: no ack for {stall_timeout}s",
                frame=ckpt.frame, offset=ckpt.wire_offset,
            )
            decoder.destroy(err)
            raise err
        wake.wait(wait_step)
        wake.clear()
