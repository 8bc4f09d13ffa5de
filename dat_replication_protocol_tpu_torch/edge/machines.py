"""Per-session protocol machines for the event-driven edge.

The port of ``dat_replication_protocol_tpu/edge/machines.py``.  Each
machine is a threaded sidecar leg with its threads removed: the same
encoder/decoder wiring, the same hub and driver calls, the same
session records, field for field.  Only the byte movement moved out:
the loop steps :func:`~..session.pump.recv_step` / ``send_step`` once
a selector turn where the threaded legs ran blocking pumps.  Nothing
here blocks: the hooks only flip encoder/decoder state or note flags
the loop polls.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..obs.watermarks import WATERMARKS as _WATERMARKS
from ..sidecar import DIGEST_SUBSET_BLOB, DIGEST_SUBSET_CHANGE

__all__ = ["HubMachine", "ResponderMachine", "hub_machine",
           "reconcile_machine", "replica_machine", "snapshot_machine"]


class HubMachine:
    """State for one edge hub session (the ``run_session`` leg): the
    ``backend="cuda"`` decoder rides a ``nowait`` hub registration,
    digests route back through :meth:`HubSession.poll` on the loop
    thread, and the flush-before-finalize barrier is the LOOP's
    (``rx_finalized`` and ``HubSession.drained`` gate
    ``enc.finalize``)."""

    __slots__ = ("enc", "dec", "hub_session", "wm_link", "digests",
                 "rx_finalized")

    def __init__(self, enc, dec, hub_session, wm_link: str):
        self.enc = enc
        self.dec = dec
        self.hub_session = hub_session
        self.wm_link = wm_link
        self.digests = 0
        self.rx_finalized = False

    def record(self, tx_done: bool) -> dict:
        """The ``sidecar.session`` record, field for field the threaded
        ``run_session``'s (``tx_done`` stands for "the sender thread
        exited": the reply fully drained)."""
        enc, dec = self.enc, self.dec
        out = {
            "changes": dec.changes,
            "blobs": dec.blobs,
            "bytes": dec.bytes,
            "digests": self.digests,
            "ok": (dec.finished and not dec.destroyed
                   and not enc.destroyed and tx_done),
        }
        if self.hub_session is not None:
            out["session"] = self.hub_session.key
            out["shed"] = self.hub_session.shed_reason
            # the hub slot goes last, as in the threaded leg: queued work
            # drops, in-flight completions are discarded
            self.hub_session.close()
        _WATERMARKS.untrack(self.wm_link)
        return out


def hub_machine(encode: Callable, decode: Callable, hub, session_key: str,
                weight: float = 1.0) -> HubMachine:
    """Build one edge hub session.  ``encode``/``decode`` are the package
    factories (passed in, so this module never imports the package root),
    ``hub`` the shared :class:`~..hub.ReplicationHub`.  Raises
    :class:`~..hub.HubBusy` through: admission is the HUB's decision,
    and the loop answers it with the threaded leg's rejection record."""
    hub_session = hub.register(session_key, weight, nowait=True)
    # the package factories themselves: constructors, not user hooks;
    # they allocate an Encoder/Decoder and return (no I/O, no waits)
    # datlint: allow-callback-escape
    enc = encode()  # the reply: a plain host encoder (digest payloads)
    # datlint: allow-callback-escape
    dec = decode(backend="cuda", pipeline=hub_session)
    m = HubMachine(enc, dec, hub_session, session_key)
    dec.watermark(session_key)

    def on_digest(kind: str, seq: int, digest: bytes) -> None:
        # the threaded leg's Change verbatim, without its flushed.wait:
        # reply backpressure is the loop's poll gate (while
        # enc.writable() is False completions park in the hub, parked
        # bytes grow and the window gate stops reads)
        m.digests += 1
        enc.change({
            "key": f"{kind}-{seq}",
            "change": seq,
            "from": 0,
            "to": 1,
            "value": digest,
            "subset": DIGEST_SUBSET_CHANGE if kind == "change"
            else DIGEST_SUBSET_BLOB,
        })

    # runs on the LOOP thread (inside HubSession.poll): enc.change only
    # appends to the reply queue, never blocks
    # datlint: allow-callback-escape
    dec.on_digest(on_digest)

    def _note_finalized(done) -> None:
        # the decoder's flush-before-finalize flush does not wait on a
        # nowait session: note the request finalized and let the LOOP
        # hold the barrier (enc.finalize waits for HubSession.drained)
        m.rx_finalized = True
        done()

    dec.finalize(_note_finalized)
    # error hooks, not user code: destroy() flips state and wakes
    # watchers, never blocks the loop
    # datlint: allow-callback-escape
    dec.on_error(lambda _e: enc.destroy())
    # datlint: allow-callback-escape
    enc.on_error(lambda _e: None if dec.destroyed else dec.destroy())
    return m


class ResponderMachine:
    """State for one edge responder session (reconcile or snapshot): it
    wraps the driver machine's ``(enc, dec, finish)`` and renders the
    threaded leg's record at teardown."""

    __slots__ = ("enc", "dec", "_finish", "_shape", "peer")

    def __init__(self, enc, dec, finish, shape: Callable, peer: str):
        self.enc = enc
        self.dec = dec
        self._finish = finish
        self._shape = shape
        self.peer = peer

    def record(self, error: Optional[BaseException] = None) -> dict:
        """Finish the driver machine and render the session record: the
        threaded legs' ``except (ProtocolError, OSError)``, with
        ``error`` standing for a transport exception the loop already
        saw."""
        from ..wire.framing import ProtocolError

        if error is None:
            try:
                return self._shape(self._finish())
            except (ProtocolError, OSError) as e:
                error = e
        return self._shape(None, error)


def reconcile_machine(replica, peer: str) -> ResponderMachine:
    """The ``--reconcile`` leg (``run_reconcile_session``'s record)."""
    from ..runtime.reconcile_driver import responder_machine

    enc, dec, finish = responder_machine(replica)

    def shape(stats, error=None) -> dict:
        if stats is None:
            return {"reconcile": True, "ok": False, "peer": peer,
                    "error": f"{type(error).__name__}: {error}"}
        return {"reconcile": True, "ok": stats["ok"],
                "symbols": stats["symbols"], "rounds": stats["rounds"],
                "records_sent": stats["records_sent"],
                "records_received": len(stats["received"])}

    return ResponderMachine(enc, dec, finish, shape, peer)


def replica_machine(node, peer: str) -> ResponderMachine:
    """The ``--replica`` gossip leg (``run_replica_session``'s record):
    a responder against the node's current replica, whose received
    records are absorbed into the LIVE node when the session
    completes."""
    from ..cluster.live import absorb_responder_stats
    from ..runtime.reconcile_driver import responder_machine

    enc, dec, finish = responder_machine(node.replica)

    def shape(stats, error=None) -> dict:
        if stats is None:
            return {"replica": node.key, "ok": False, "peer": peer,
                    "error": f"{type(error).__name__}: {error}"}
        stats = absorb_responder_stats(node, stats)
        return {"replica": node.key, "ok": stats["ok"],
                "symbols": stats["symbols"], "rounds": stats["rounds"],
                "records_sent": stats["records_sent"],
                "applied": stats["applied"]}

    return ResponderMachine(enc, dec, finish, shape, peer)


def snapshot_machine(source, peer: str,
                     link: Optional[str] = None) -> ResponderMachine:
    """The ``--snapshot`` bootstrap leg (``run_snapshot_session``'s
    record), BEGIN already queued on the encoder."""
    from ..runtime.snapshot_driver import snapshot_responder_machine

    enc, dec, finish = snapshot_responder_machine(source, link=link)

    def shape(stats, error=None) -> dict:
        if stats is None:
            return {"snapshot": True, "ok": False, "peer": peer,
                    "error": f"{type(error).__name__}: {error}"}
        return {"snapshot": True, "ok": stats["ok"],
                "cold": stats["cold"], "chunks_sent": stats["chunks_sent"],
                "chunk_bytes_sent": stats["chunk_bytes_sent"],
                "symbols": stats["symbols"], "rounds": stats["rounds"]}

    return ResponderMachine(enc, dec, finish, shape, peer)
