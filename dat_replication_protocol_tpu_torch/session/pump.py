"""Wire pump route selection, trimmed to the plain route, the receive
side's broadcast tap, the edge loop's non-blocking step functions, and
the pump's transport notes for the wire cost ledger.

The JAX package's ``session/pump.py`` routes the transport's byte loops
through a batched-syscall C extension (``recvmmsg``/``sendmmsg``) when
it can load one.  The port carries the selector's surface on the plain
route only: :func:`effective_pump_route` is always ``"python"`` and
:func:`io_for_socket` binds the socket's own ``recv`` and ``sendall``,
the portable pumps of :mod:`.transport`.  Both routes put the same
bytes on the wire; the batched route is host work still to come.

:func:`_tapped_reader` is the plain route's tap: the fan-out source's
``FanoutServer.publish`` observes every received chunk as the exact
bytes object the decoder is fed (the JAX package's ``recv_pump(tap=)``).

:class:`EdgePump`, :func:`recv_step` and :func:`send_step` are the
event-driven edge's byte movers (:mod:`..edge.loop`): one bounded,
non-blocking receive or send turn on a session's fd per call, instead of
a thread-owned loop.  The JAX package's steps have a batched-syscall arm
beside the Python one; the port carries the Python arm (``os.read`` /
``os.write`` until ``EAGAIN``), the one route it has.

The pump is the transport, so it reports the bytes it moves to the wire
cost ledger (:mod:`..obs.wirecost`) as the ground truth the per-frame
ledger is audited against: :func:`_metered_reader` on the receive side,
:func:`_lit_tx` after each send, and the step functions once a turn on
their byte totals.  All run only with the obs gate on.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from ..obs import wirecost as _wirecost
from ..obs.metrics import OBS as _OBS
from .decoder import DecoderDestroyedError
from .encoder import EncoderDestroyedError

# the edge's turn geometry: one receive turn reads at most ``cap`` bytes
# (PUMP_BUF by default) in os.read calls of PUMP_SLICE; one send turn
# pulls the encoder PUMP_SEND_CHUNK at a time
PUMP_BUF = 2 << 20
PUMP_SLICE = 1 << 20
PUMP_SEND_CHUNK = 1 << 20


def effective_pump_route() -> str:
    """The pump route that runs: the plain Python route."""
    return "python"


def probe_caps() -> dict:
    """What the sidecar's stats records carry about the pump: the route
    that runs and the syscall tier (none batched on the plain route)."""
    return {"route": effective_pump_route(), "native_available": False,
            "recvmmsg": False, "sendmmsg": False}


def io_for_socket(conn) -> tuple:
    """``(read_bytes, write_bytes)`` for a connected socket: the
    blocking byte pair the reconcile and snapshot drivers run over."""
    return conn.recv, conn.sendall


def _lit_rx(decoder, nbytes: int) -> None:
    """Received transport bytes of ``decoder``'s link (callers hold the
    ``_OBS.on`` gate)."""
    _wirecost.note_transport(
        getattr(decoder, "cost_link", "session"), "rx", nbytes)


def _lit_tx(encoder, nbytes: int) -> None:
    """Sent transport bytes of ``encoder``'s link (callers hold the
    ``_OBS.on`` gate)."""
    _wirecost.note_transport(
        getattr(encoder, "cost_link", "session"), "tx", nbytes)


def _metered_reader(decoder, read_bytes):
    """``read_bytes`` that reports each read to the ledger as
    ``decoder``'s received transport bytes (one gate check a read)."""
    def metered(n: int) -> bytes:
        data = read_bytes(n)
        if data and _OBS.on:
            _lit_rx(decoder, len(data))
        return data

    return metered


def _tapped_reader(read_bytes: Callable[[int], bytes],
                   tap: Optional[Callable[[bytes], None]]
                   ) -> Callable[[int], bytes]:
    """``read_bytes`` that hands every non-empty read to ``tap`` before
    returning it (the broadcast tee: an append and an O(1) mark, never a
    block)."""
    if tap is None:
        return read_bytes

    def tapped(n: int) -> bytes:
        data = read_bytes(n)
        if data:
            tap(data)
        return data

    return tapped



class EdgePump:
    """Per-session pump state for the event-driven edge: one bounded
    non-blocking turn per call instead of a thread-owned loop.

    ``fd`` MUST be non-blocking: the edge loop sets ``O_NONBLOCK`` at
    admission and never clears it, so every kernel call below returns at
    once on would-block.  The port has one pump route, so the state is
    the turn's receive cap and the unsent reply tail only (the JAX
    package's pump also holds its batched-syscall buffers here)."""

    __slots__ = ("fd", "cap", "pending")

    def __init__(self, fd: int, cap: int = PUMP_BUF):
        self.fd = fd
        self.cap = cap
        self.pending: Optional[memoryview] = None  # unsent reply tail


def recv_step(pump: EdgePump, decoder, tap=None) -> tuple:
    """ONE bounded receive turn: drain what the kernel already buffered
    on ``pump.fd`` into ``decoder``, never waiting.  Returns ``(nbytes,
    eof)``; ``(0, False)`` means would-block (wait for the selector's
    next READ event).  ``os.read`` runs until ``EAGAIN``, EOF, a decoder
    stall or ``pump.cap`` bytes, never more, so a faulted neighbour costs
    this session at most one slab of latency a turn.  ``tap`` (the fan-out's
    ``publish``) sees every chunk before the decoder does."""
    res = _recv_step_py(pump, decoder, tap)
    if _OBS.on and res[0]:
        _lit_rx(decoder, res[0])
    return res


def _recv_step_py(pump: EdgePump, decoder, tap=None) -> tuple:
    """The engine of :func:`recv_step`; split out so the transport note
    forks ONCE on the turn's byte total instead of at every return."""
    total = 0
    while total < pump.cap:
        try:
            # bounded: pump.fd is O_NONBLOCK by the EdgePump contract, so
            # a silent peer surfaces as BlockingIOError, never a sleep;
            # the read size keeps the turn within pump.cap (the JAX
            # package's reads a whole slice and may pass it)
            # datlint: allow-blocking-reachable(os-io)
            data = os.read(pump.fd, min(PUMP_SLICE, pump.cap - total))
        except BlockingIOError:
            return (total, False)
        except InterruptedError:
            continue
        if not data:
            return (total, True)
        total += len(data)
        if tap is not None:
            # the broadcast tee (FanoutServer.publish): an append and an
            # O(1) mark under the server lock, never blocks
            # datlint: allow-callback-escape
            tap(data)
        try:
            ok = decoder.write(data)
        except DecoderDestroyedError:
            return (total, False)
        if not ok:
            return (total, False)  # decoder stall: the loop gates reads
    return (total, False)


# one send turn pushes at most this many pulls: the encoder's high-water
# mark bounds what it can buffer, this bounds the turn even against a
# producer that never stops
_SEND_TURN_PULLS = 8


def send_step(pump: EdgePump, encoder) -> tuple:
    """ONE bounded send turn: push encoder output to ``pump.fd`` until
    would-block, the encoder runs dry, or the turn budget.  Returns
    ``(accepted, finished, blocked)``: ``finished`` means the encoder is
    finalized AND drained (the loop may shut the write half down);
    ``blocked`` means the kernel refused bytes still held in
    ``pump.pending`` (watch ``EVENT_WRITE``)."""
    res = _send_step_impl(pump, encoder)
    if _OBS.on and res[0]:
        _lit_tx(encoder, res[0])
    return res


def _send_step_impl(pump: EdgePump, encoder) -> tuple:
    """The engine of :func:`send_step`; split out so the transport note
    forks ONCE on the turn's accepted-byte total."""
    accepted = 0
    for _ in range(_SEND_TURN_PULLS):
        if pump.pending is None:
            try:
                data = encoder.read(PUMP_SEND_CHUNK)
            except EncoderDestroyedError:
                return (accepted, True, False)
            if data is None:  # finalized and drained
                return (accepted, True, False)
            if not data:  # nothing ready (the producer still appends)
                return (accepted, False, False)
            pump.pending = memoryview(data) if not isinstance(
                data, memoryview) else data
        view = pump.pending
        try:
            # bounded: pump.fd is O_NONBLOCK by the EdgePump contract, so
            # would-block is an exception, not a sleep
            # datlint: allow-blocking-reachable(os-io)
            w = os.write(pump.fd, view)
        except (BlockingIOError, InterruptedError):
            w = 0
        accepted += w
        if w < len(view):
            pump.pending = view[w:] if w else view
            return (accepted, False, True)
        pump.pending = None
    return (accepted, False, False)
