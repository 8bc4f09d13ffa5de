"""Wire pump route selection, trimmed to the plain route, the receive
side's broadcast tap, and the pump's transport notes for the wire cost
ledger.

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

The pump is the transport, so it reports the bytes it moves to the wire
cost ledger (:mod:`..obs.wirecost`) as the ground truth the per-frame
ledger is audited against: :func:`_metered_reader` on the receive side,
:func:`_lit_tx` after each send.  Both run only with the obs gate on.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..obs import wirecost as _wirecost
from ..obs.metrics import OBS as _OBS


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

