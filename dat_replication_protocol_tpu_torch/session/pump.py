"""Wire pump route selection, trimmed to the plain route.

The JAX package's ``session/pump.py`` routes the transport's byte loops
through a batched-syscall C extension (``recvmmsg``/``sendmmsg``) when
it can load one.  The port carries the selector's surface on the plain
route only: :func:`effective_pump_route` is always ``"python"`` and
:func:`io_for_socket` binds the socket's own ``recv`` and ``sendall``,
the portable pumps of :mod:`.transport`.  Both routes put the same
bytes on the wire; the batched route is host work still to come.
"""

from __future__ import annotations


def effective_pump_route() -> str:
    """The pump route that runs: the plain Python route."""
    return "python"


def io_for_socket(conn) -> tuple:
    """``(read_bytes, write_bytes)`` for a connected socket: the
    blocking byte pair the reconcile and snapshot drivers run over."""
    return conn.recv, conn.sendall
