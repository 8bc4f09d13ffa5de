"""The sidecar: a daemon foreign clients pipe wire bytes to.

The port of ``dat_replication_protocol_tpu/sidecar.py``'s digest reply
(:121-393), its TCP accept loop (:741-926), its anti-entropy modes
(:517-643), its hub mode, its fan-out mode with the snapshot redirect
(:394-515, :645-712), its gossip replica mode (:82-104, :549-589,
:842-855, :1230-1250), its stats and scrape endpoints (:927-1141) and
its event-driven edge (:87-97, :1091-1111, :1466-1483)::

    python -m dat_replication_protocol_tpu_torch.sidecar --stdio
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp 127.0.0.1:7531
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp HOST:PORT \
        --hub [--hub-max-sessions N] [--hub-parked-budget BYTES] \
        [--stats-fd FD] [--obs-http PORT]
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp HOST:PORT \
        --reconcile LOGFILE
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp HOST:PORT \
        --snapshot DATAFILE [--snapshot-offset BYTES]
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp HOST:PORT \
        --fanout [--hub] [--fanout-retention BYTES] [--fanout-window BYTES] \
        [--fanout-stall-timeout SECONDS]
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp HOST:PORT \
        --fanout --snapshot DATAFILE [--snapshot-port PORT]
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp HOST:PORT \
        --replica LOGFILE [--replica-key K] [--gossip-peers H:P,...] \
        [--gossip-interval S] [--edge]
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp HOST:PORT \
        --edge [--hub*] [--fanout*] [--reconcile F] [--snapshot F]

**Digest reply** (the default mode).  A client pipes a session (changes
+ blobs) in; the sidecar decodes it with ``decode(backend='cuda')``,
hashing every change payload and blob on the card, and streams a reply
session back:

* one ``Change`` per digest, in submit order;
* ``key`` = ``"change-<seq>"`` or ``"blob-<seq>"`` (the 0-based arrival
  index of that kind), ``change`` = <seq>, ``from`` = 0, ``to`` = 1;
* ``subset`` = ``"digest:change"`` / ``"digest:blob"``;
* ``value`` = the 32-byte BLAKE2b-256 digest.

Every digest is encoded onto the reply before the reply finalizes
(flush-before-finalize).  A protocol error destroys both directions, so
a malformed client observes EOF rather than a hang; a client that never
reads its reply is released after ``--drain-timeout`` seconds without
reply progress.

**Anti-entropy modes.**  ``--reconcile LOGFILE`` serves every
connection as a rateless-reconciliation responder over the change log
in LOGFILE (its canonical digests hashed once by B1);
``--snapshot DATAFILE`` materializes DATAFILE once as content-addressed
chunks (B6 for the cuts, B1 for the chunk digests) and serves every
connection as a snapshot responder.  Connecting to such a sidecar is
the out-of-band capability advertisement.  Both run on ``--stdio`` and
``--tcp``; each session logs its stats record on stderr.

``--tcp HOST:PORT`` serves one thread per connection and prints
``sidecar: listening on HOST:PORT`` (the bound port, for port 0) on
stderr; bind and accept retry under ``--max-retries``/``--backoff-base``.

**Hub mode.**  ``--hub`` (``--tcp`` only) registers every accepted
digest session with one shared :class:`~.hub.ReplicationHub` under the
key ``c<n>:<host>:<port>``: their digest work is batched across
sessions onto kernel B1, with admission (``--hub-max-sessions``,
``--hub-parked-budget``), per-session windows and shedding.  A rejected
connection sees EOF and logs a ``rejected`` record; a shed session or
an engine failure tears down that session only; ``--drain-timeout``
runs per session.  ``--hub-mesh auto|N`` shards each batch over the
process group a launcher set up (``env://``: ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); rank 0 serves and every
other rank runs :func:`~.hub.mesh_follower`.  If rank 0's hub fails,
rank 0 exits 1 (a follower may be inside a batch's collectives, which
end only with rank 0's process) and the followers exit 1 as their
collectives raise.  Without such a group the sidecar exits with the
error.

**Stats.**  ``--stats-fd FD`` turns telemetry on and writes one
self-contained snapshot line every ``--stats-interval`` seconds (JSON
with ``emit_seq``, the hub's aggregate and per-session breakdown, the
``wirecost`` ledger and ``healthz``; or with ``--stats-format prom``
Prometheus text); SIGUSR1 forces a dump.  ``--obs-http PORT`` serves
``/metrics``, ``/snapshot``, ``/healthz`` and ``/events`` on
127.0.0.1 (:mod:`.obs.http`).

**Replica mode.**  ``--replica LOGFILE`` (``--tcp`` only; not with
``--hub``, ``--fanout``, ``--reconcile`` or ``--snapshot``) loads
LOGFILE (an absent file is a cold, empty replica) into one live
:class:`~.cluster.ReplicaNode` named ``--replica-key``, its record
digests hashed by B1 on ``--device``.  Every connection is served as a
reconcile responder against the node's current log, and the records the
initiator ships are absorbed into it.  With ``--gossip-peers
H:P,...`` a :class:`~.cluster.GossipDriver` dials one of those peers
every ``--gossip-interval`` seconds on average (jittered) as the
initiator, so N such sidecars converge from any divergence.  The stats
records gain the node's ``gossip`` section and, once an exchange or a
frontier was recorded, the ``propagation`` section.  With ``--edge`` the
responder sessions are served from the edge's loop.

**Fan-out mode.**  ``--fanout`` (``--tcp`` only) runs one shared
:class:`~.fanout.FanoutServer`.  The first connection to claim the
source slot is the broadcast source: it is served as a digest session
(its digests on B1, or on the hub with ``--hub``) and every wire byte it
sends is also published into the broadcast log; its EOF seals the log.
A claimant that closes without publishing a byte gives the claim back.
Every other connection is a subscriber streamed the source's raw wire
bytes by the fan-out's ``os.writev`` dispatcher (it never hashes).  A
subscriber gets one JSON line and EOF instead of the stream when it
asks below what the log retains (``{"snapshot_needed": true,
"retained": [start, end]}``), when the fan-out is full (``"rejected"``)
or when it sends bytes (``"not_source"``).  With ``--snapshot
DATAFILE`` the bootstrap is served on its own port (``--snapshot-port``,
printed on stderr as ``snapshot bootstrap on HOST:PORT``), and the
snapshot-needed record carries ``"hint": {"port", "cap"}`` naming it.
The stats records gain the fan-out's ``fanout`` and per-peer ``peers``
sections.

**Edge mode.**  ``--edge`` (``--tcp`` only) serves every connection from
ONE selector loop (:class:`~.edge.EdgeLoop`) instead of a thread each:
hub sessions, ``--fanout`` sources and subscribers, ``--reconcile`` and
``--snapshot`` responders, with the same records and the same overload
ladder (hub admission, the hub window as a read gate, shedding).
``--edge`` implies ``--hub`` for the digest sessions it serves (hub
sessions and a broadcast source), and prints ``sidecar: edge listening
on :PORT`` on stderr.  The stats
records gain an ``edge`` section (sessions by QoS class and by kind,
admission tallies, the loop's turns and lag), ``/healthz`` reads the
edge's admission and the loop's ``loop_lag`` stage.

Telemetry, as the reference's flags give it (:1303-1328):
``--flight-dir DIR`` arms the flight recorder (a protocol error dumps a
bundle into DIR) and turns telemetry on; ``--trace-jsonl PATH`` turns
it on and mirrors every event and span as JSONL into PATH.  The request
is consumed inside a ``sidecar.session.recv`` span.

Every record that a session, listener or gossip thread logs on stderr
is written by :func:`log_line` as one whole line: ``print`` writes the
text and the newline apart, and two sessions ending together would
share a line.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time

from . import decode, encode
from .obs import device as obs_device
from .obs import events as obs_events
from .obs import flight as obs_flight
from .obs import http as obs_http
from .obs import metrics as obs_metrics
from .obs import tracing as obs_tracing
from .obs.events import emit as _emit
from .obs.metrics import OBS as _OBS
from .obs.metrics import counter as _counter
from .obs.propagation import PROPAGATION as _PROPAGATION
from .obs.watermarks import WATERMARKS as _WATERMARKS
from .obs.wirecost import WIRECOST as _WIRECOST
from .session import pump as session_pump
from .session.transport import once
from .session.transport import write_all as _write_all

DIGEST_SUBSET_CHANGE = "digest:change"
DIGEST_SUBSET_BLOB = "digest:blob"
DEFAULT_CHUNK = 64 * 1024
_WAKE = 0.5  # bound on every wait; wakeups are event-driven

# reply-drain default: a client that finished sending but never reads
# its reply must not park a session thread forever
DEFAULT_DRAIN_TIMEOUT = 600.0
_DRAIN_POLL = 0.25

DEFAULT_STATS_INTERVAL = 5.0

_M_SESSIONS = _counter("sidecar.sessions")
_M_STALLS = _counter("sidecar.stalls")

# hub mode: the one hub every accepted connection shares; its aggregate
# and per-session breakdown ride the stats records
_ACTIVE_HUB = None
# fan-out mode: the one fan-out server, whose per-peer breakdown rides
# the stats records
_ACTIVE_FANOUT = None
# edge mode: the EdgeLoop whose table aggregate rides the stats records
# and whose admission stage fronts /healthz (it composes the hub's)
_ACTIVE_EDGE = None
# replica mode: the gossip driver (or the bare node) whose snapshot()
# rides the stats records as the `gossip` section
_ACTIVE_GOSSIP = None

# one writer at a time on the session log: a record and its newline go
# out in ONE write under this lock
_LOG_LOCK = threading.Lock()


def log_line(text: str, stream=None) -> None:
    """Write ``text`` as one whole line on ``stream`` (default: stderr)
    and flush: one ``write`` of the text and its newline together, under
    a module lock, so records that threads log at the same moment never
    share or split a line."""
    out = sys.stderr if stream is None else stream
    with _LOG_LOCK:
        out.write(text + "\n")
        out.flush()


def set_active_hub(hub) -> None:
    """Install the hub whose breakdown ``--stats-fd`` records and
    ``/healthz`` carry (None detaches)."""
    global _ACTIVE_HUB
    _ACTIVE_HUB = hub


def set_active_fanout(server) -> None:
    """Install the fan-out server whose per-peer breakdown
    ``--stats-fd`` records carry (None detaches)."""
    global _ACTIVE_FANOUT
    _ACTIVE_FANOUT = server


def set_active_gossip(driver) -> None:
    """Install the gossip driver or node whose ``snapshot()`` record
    ``--stats-fd`` records carry (None detaches)."""
    global _ACTIVE_GOSSIP
    _ACTIVE_GOSSIP = driver


def set_active_edge(loop) -> None:
    """Install the :class:`~.edge.EdgeLoop` whose table aggregate
    ``--stats-fd`` records carry (None detaches)."""
    global _ACTIVE_EDGE
    _ACTIVE_EDGE = loop


def run_session(read_bytes, write_bytes, close_write=None, device="cuda",
                chunk_size: int = DEFAULT_CHUNK,
                drain_timeout: float | None = DEFAULT_DRAIN_TIMEOUT,
                hub=None, session_key: str | None = None,
                publish=None) -> dict:
    """Serve one wire session over a blocking byte pair.

    ``read_bytes(n)`` returns up to n bytes (``b''`` at EOF);
    ``write_bytes(data)`` blocks on congestion.  The reply is written by
    a sender thread so that a client which reads its reply only after
    sending cannot deadlock the session.

    ``drain_timeout`` bounds every reply-stall wait: when the reply
    makes no write progress for that many seconds, in the digest-flush
    backpressure wait or in the end-of-session drain, the reply encoder
    is destroyed and ``close_write`` invoked so the session tears down
    instead of parking its thread; ``None`` waits forever.  Each session
    keeps its own clock, so in hub mode one session's deadline neither
    extends nor cuts another's.  Returns ``{"changes", "blobs", "bytes",
    "digests", "ok"}``.

    ``hub`` (a :class:`~.hub.ReplicationHub`) puts the session's digest
    work on the shared engine under ``session_key``, and the record
    gains ``session`` and ``shed``.  A :class:`~.hub.HubBusy` rejection
    consumes no wire byte: it closes the write side and returns
    ``{"ok": False, "rejected": True, "sessions", "parked_bytes"}``.  A
    :class:`~.hub.SessionShed` or :class:`~.hub.HubError` raised by the
    decoder's submits tears this session down as any session-fatal
    error does.

    ``publish`` (the fan-out's ``FanoutServer.publish``) observes every
    received chunk before the decoder takes it: the broadcast source.

    The decoder's wire cursors (``accepted``, ``parsed``,
    ``checkpoint``) are on the fleet plane under the link ``session_key``
    (``"stdio"`` without one) while the session runs; with telemetry on,
    the wire cost ledger gets the session's frames and transport bytes on
    the same link.
    """
    hub_session = None
    if hub is not None:
        from .hub import HubBusy

        try:
            hub_session = hub.register(session_key)
        except HubBusy as e:
            out = {"changes": 0, "blobs": 0, "bytes": 0, "digests": 0,
                   "ok": False, "rejected": True,
                   "sessions": e.sessions, "parked_bytes": e.parked_bytes}
            if close_write is not None:
                try:
                    close_write()
                except OSError:
                    pass
            if _OBS.on:
                _emit("sidecar.session", **out)
            return out
    enc = encode()  # the reply: plain host encoder
    if hub_session is not None:
        dec = decode(backend="cuda", pipeline=hub_session)
    else:
        dec = decode(backend="cuda", device=device)
    link = session_key if session_key else "stdio"
    enc.cost_link = dec.cost_link = link
    dec.watermark(link)
    read_bytes = session_pump._metered_reader(
        dec, session_pump._tapped_reader(read_bytes, publish))
    lock = threading.Lock()  # the encoder is shared by both threads
    readable = threading.Event()
    enc._attach_readable(readable.set)
    stats = {"digests": 0}
    close_once = once(close_write) if close_write is not None else None
    # reply write progress, refreshed each time reply bytes reach the
    # transport: the clock every stall check reads
    progress = {"t": time.monotonic()}

    def stalled() -> bool:
        return (drain_timeout is not None
                and time.monotonic() - progress["t"] > drain_timeout)

    def destroy_enc(err=None) -> None:
        with lock:
            enc.destroy(err)
        readable.set()

    def teardown_stalled() -> None:
        # the client stopped reading its reply: record the stall, tear
        # the reply down and shut the write side, which wakes a sender
        # parked in a socket write
        if _OBS.on:
            _M_STALLS.inc()
            _emit("sidecar.stall", kind="reply-drain",
                  seconds=drain_timeout, reply_bytes=enc.bytes)
        destroy_enc(TimeoutError(
            f"reply stream stalled for {drain_timeout}s"))
        if close_once is not None:
            try:
                close_once()
            except OSError:
                pass

    def on_digest(kind: str, seq: int, digest: bytes) -> None:
        stats["digests"] += 1
        flushed = threading.Event()
        with lock:
            if enc.destroyed:
                return
            below = enc.change({
                "key": f"{kind}-{seq}", "change": seq, "from": 0, "to": 1,
                "value": digest,
                "subset": (DIGEST_SUBSET_CHANGE if kind == "change"
                           else DIGEST_SUBSET_BLOB),
            }, on_flush=flushed.set)
        if below:
            return
        # reply backpressure: stall request consumption until the reply
        # drains below its high-water mark, measured from here (a quiet
        # stretch before this wait is not the client's fault)
        progress["t"] = time.monotonic()
        while not (flushed.wait(0.1) or enc.destroyed):
            if stalled():
                teardown_stalled()
                break

    def on_finalize(done) -> None:
        with lock:
            if not enc.destroyed:
                enc.finalize()
        done()

    dec.on_digest(on_digest)
    dec.finalize(on_finalize)
    dec.on_error(destroy_enc)

    def send() -> None:
        try:
            while True:
                with lock:
                    data = None if enc.destroyed else enc.read(chunk_size)
                if data is None:
                    break
                if not data:
                    readable.wait(_WAKE)
                    readable.clear()
                    continue
                write_bytes(data)
                if _OBS.on:
                    session_pump._lit_tx(enc, len(data))
                progress["t"] = time.monotonic()
        except OSError as e:  # the client went away
            destroy_enc(e)
            if not dec.destroyed:
                dec.destroy(e)
        finally:
            if close_once is not None:
                try:
                    close_once()
                except OSError:
                    pass

    sender = threading.Thread(target=send, name="sidecar-send", daemon=True)
    sender.start()
    wake = threading.Event()
    dec._add_drain_watcher(wake.set)
    try:
        with obs_tracing.trace_span("sidecar.session.recv"):
            while not dec.destroyed:
                data = read_bytes(chunk_size)
                if not data:
                    if not dec.finished:
                        dec.end()
                    break
                wake.clear()
                if not dec.write(data):
                    while not (dec.writable() or dec.destroyed
                               or dec.finished):
                        wake.wait(_WAKE)
                        wake.clear()
    except Exception as e:  # noqa: BLE001 — session-fatal either way
        # the transport died mid-read, or (in hub mode) a SessionShed or
        # HubError rose from the decoder's digest submits
        if not dec.destroyed:
            dec.destroy(e)
    finally:
        dec._remove_drain_watcher(wake.set)
        if dec.destroyed and not enc.destroyed:
            destroy_enc()
    if enc.destroyed:
        # the sender may sit in a write to a dead peer; the caller's
        # close unblocks it
        sender.join(timeout=5)
    else:
        # the reply is still draining: join in bounded steps and tear
        # the session down once it makes no progress for drain_timeout
        progress["t"] = time.monotonic()
        while True:
            sender.join(timeout=_DRAIN_POLL)
            if not sender.is_alive():
                break
            if stalled():
                teardown_stalled()
                sender.join(timeout=5)
                break
    out = {"changes": dec.changes, "blobs": dec.blobs, "bytes": dec.bytes,
           "digests": stats["digests"],
           "ok": (dec.finished and not dec.destroyed and not enc.destroyed
                  and not sender.is_alive())}
    if hub_session is not None:
        out["session"] = hub_session.key
        out["shed"] = hub_session.shed_reason
        # the hub slot goes last: queued work is dropped and in-flight
        # completions are discarded, so nothing stays parked
        hub_session.close()
    _WATERMARKS.untrack(link)
    if _OBS.on:
        _M_SESSIONS.inc()
        _emit("sidecar.session", **out)
    return out


# a refusal goes to a peer about to be dropped: the send is bounded so a
# receiver that stopped draining cannot park the session thread (a
# healthy peer's kernel buffer takes the short record at once)
_REFUSAL_SEND_TIMEOUT = 5.0


def _send_refusal(conn: socket.socket, out: dict) -> dict:
    """Write one structured refusal line and shut the write side, under
    ``_REFUSAL_SEND_TIMEOUT``; a refused, reset or wedged receiver is
    given up on (``socket.timeout`` is an ``OSError``).  The record is
    the session's: it is emitted and returned."""
    try:
        conn.settimeout(_REFUSAL_SEND_TIMEOUT)
        # bounded by the settimeout above (a socket mode, which the call
        # shape does not show)
        # datlint: allow-blocking-reachable(socket)
        conn.sendall((json.dumps(out) + "\n").encode())
        conn.shutdown(socket.SHUT_WR)
    except OSError:
        pass
    if _OBS.on:
        _emit("sidecar.session", **out)
    return out


def run_subscriber(conn: socket.socket, fanout, key: str) -> dict:
    """Serve one fan-out subscriber connection: attach the socket as a
    downstream peer of the shared broadcast log and stream it until the
    sealed log is fully delivered or the peer is shed.  The subscriber
    never decodes and never hashes: the digest work happened once, on
    the source session.

    A subscriber needs the stream from byte 0.  Once the log has
    trimmed past it, the subscriber gets one ``{"snapshot_needed": true,
    "retained": [start, end]}`` record and EOF, with ``"hint"`` naming
    the snapshot bootstrap port when the deployment serves one.  At
    capacity it gets ``{"rejected": true}``.  A subscriber that sends
    bytes is a misrouted source (it raced the connection holding the
    source claim): it gets ``{"not_source": true}`` rather than having
    its session silently dropped."""
    from .fanout import FanoutBusy, SnapshotNeeded

    try:
        peer = fanout.attach_peer(key, fd=conn.fileno(), offset=0)
    except SnapshotNeeded as e:
        out = {"fanout_peer": key, "ok": False, "snapshot_needed": True,
               "retained": list(e.retained)}
        if e.hint is not None:
            out["hint"] = dict(e.hint)
        return _send_refusal(conn, out)
    except FanoutBusy as e:
        # the record is the rejection: a bare EOF would read as an empty
        # sealed broadcast
        return _send_refusal(conn, {
            "fanout_peer": key, "ok": False, "rejected": True,
            "peers": e.peers, "max_peers": e.max_peers})
    try:
        # bounded waits with an EOF probe between them: a subscriber
        # that leaves while the broadcast is idle surfaces no EPIPE (no
        # bytes are in flight to it), and its slot would leak
        done = False
        not_source = False
        while True:
            if peer.wait_done(timeout=0.5):
                done = True
                break
            if peer.shed_reason is not None:
                break
            try:
                # the fd is O_NONBLOCK (the fan-out's dup shares the
                # open file description): a silent subscriber answers
                # EAGAIN at once
                probe = conn.recv(4096)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                break
            if probe == b"":
                break  # the client went away: release the slot
            not_source = True
            break
        stats = peer.stats()
    finally:
        peer.close()
    if not_source:
        return _send_refusal(conn, {
            "fanout_peer": key, "ok": False, "not_source": True,
            "detail": "subscriber connections must not send data; the "
                      "broadcast source slot was already claimed — "
                      "reconnect to retry as source"})
    try:
        conn.shutdown(socket.SHUT_WR)  # the subscriber reads a clean EOF
    except OSError:
        pass
    out = {"fanout_peer": key, "sent_bytes": stats["sent_bytes"],
           "shed": stats["shed"], "ok": done and stats["shed"] is None}
    if _OBS.on:
        _M_SESSIONS.inc()
        _emit("sidecar.session", **out)
    return out


def run_reconcile_session(conn_read, conn_write, close_write,
                          replica, peer: str = "?") -> dict:
    """Serve one anti-entropy session: the client is the reconcile
    *initiator* streaming coded-symbol frames; this side responds from
    ``replica`` (the ``--reconcile LOGFILE`` change log) and the two
    exchange exactly the differing records.  Both directions speak
    ``CAP_RECONCILE | CAP_CHANGE_BATCH``.  A failed decode surfaces as
    the driver's ONE structured ProtocolError, logged as ``ok: False``;
    the client observes the FAIL frame and EOF, never a hang."""
    from .runtime.reconcile_driver import run_responder
    from .wire.framing import ProtocolError

    try:
        stats = run_responder(replica, conn_read, conn_write,
                              close_write=close_write)
        out = {"reconcile": True, "ok": stats["ok"],
               "symbols": stats["symbols"], "rounds": stats["rounds"],
               "records_sent": stats["records_sent"],
               "records_received": len(stats["received"])}
    except (ProtocolError, OSError) as e:
        out = {"reconcile": True, "ok": False, "peer": peer,
               "error": f"{type(e).__name__}: {e}"}
    if _OBS.on:
        _M_SESSIONS.inc()
        _emit("sidecar.session", **out)
    return out


def load_reconcile_replica(path: str, device="cuda"):
    """Build the sidecar's replica from a change-log wire file
    (per-record and/or ChangeBatch frames, ``replay.replay_log``'s
    input); its canonical digests are hashed on ``device``."""
    from .runtime.reconcile_driver import RatelessReplica

    with open(path, "rb") as f:
        return RatelessReplica(f.read(), device=device)


def run_replica_session(conn_read, conn_write, close_write,
                        node, peer: str = "?") -> dict:
    """Serve one gossip responder session: like ``--reconcile``, but
    against the LIVE :class:`~.cluster.ReplicaNode`, whose log absorbs
    the records the initiator ships, so every inbound session advances
    convergence."""
    from .cluster import serve_responder_session
    from .wire.framing import ProtocolError

    try:
        stats = serve_responder_session(node, conn_read, conn_write,
                                        close_write=close_write)
        out = {"replica": node.key, "ok": stats["ok"],
               "symbols": stats["symbols"], "rounds": stats["rounds"],
               "records_sent": stats["records_sent"],
               "applied": stats["applied"]}
    except (ProtocolError, OSError) as e:
        out = {"replica": node.key, "ok": False, "peer": peer,
               "error": f"{type(e).__name__}: {e}"}
    if _OBS.on:
        _M_SESSIONS.inc()
        _emit("sidecar.session", **out)
    return out


def load_replica_node(path: str, key: str, device="cuda"):
    """Build the ``--replica`` gossip node from a change-log wire file
    (``--reconcile``'s input; an absent or empty file is a cold replica
    that converges entirely from its peers).  Its replica is built at
    once, its digests hashed by B1 on ``device``, so a CUDA device
    without a card raises here, as :func:`load_reconcile_replica` does.
    The node keeps the delivered form (absent optionals as ''/b''), the
    form every decoder delivery produces, so shipped records keep their
    digests and the mesh reaches diff 0."""
    from .cluster import ReplicaNode

    wire = b""
    if os.path.exists(path):
        with open(path, "rb") as f:
            wire = f.read()
    node = ReplicaNode(key, wire, device=device, delivered_form=True)
    node.replica  # the first build: B1 over every record on `device`
    return node


def run_snapshot_session(conn_read, conn_write, close_write,
                         source, peer: str = "?") -> dict:
    """Serve one snapshot bootstrap session: the client is a *joiner*
    that receives the manifest, reconciles its chunk set (or WANTs
    everything when cold) and is streamed exactly the chunks it is
    missing from the shared ``source`` (hashed ONCE, however many
    joiners connect).  Both directions speak ``CAP_SNAPSHOT``.  A failed
    session surfaces as the driver's ONE structured ProtocolError,
    logged as ``ok: False``."""
    from .runtime.snapshot_driver import run_snapshot_responder
    from .wire.framing import ProtocolError

    try:
        stats = run_snapshot_responder(source, conn_read, conn_write,
                                       close_write=close_write)
        out = {"snapshot": True, "ok": stats["ok"],
               "cold": stats["cold"], "chunks_sent": stats["chunks_sent"],
               "chunk_bytes_sent": stats["chunk_bytes_sent"],
               "symbols": stats["symbols"], "rounds": stats["rounds"]}
    except (ProtocolError, OSError) as e:
        out = {"snapshot": True, "ok": False, "peer": peer,
               "error": f"{type(e).__name__}: {e}"}
    if _OBS.on:
        _M_SESSIONS.inc()
        _emit("sidecar.session", **out)
    return out


def load_snapshot_source(path: str, wire_offset: int = 0, device="cuda"):
    """Materialize the ``--snapshot DATAFILE`` dataset once on
    ``device``: CDC cuts, chunk digests and the manifest, shared by
    every responder session."""
    from .runtime.snapshot_driver import SnapshotSource

    with open(path, "rb") as f:
        return SnapshotSource(f.read(), wire_offset=wire_offset,
                              device=device)


class SnapshotListener:
    """The snapshot bootstrap's own port in the ``--fanout --snapshot``
    composition: an accept loop serving each connection as one responder
    session off the shared source.  The bound ``port`` goes into the
    fan-out's ``snapshot_hint``, so the snapshot-needed record a
    trimmed-past subscriber gets names where to bootstrap.  A port that
    cannot be bound raises ``OSError`` from the constructor."""

    def __init__(self, source, host: str, port: int = 0):
        self.source = source
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._srv.bind((host, port))
            self._srv.listen(8)
        except OSError:
            self._srv.close()
            raise
        # a bounded accept: the timeout re-checks for close
        self._srv.settimeout(1.0)
        self.port = self._srv.getsockname()[1]
        self._served = 0
        self._thread = threading.Thread(
            target=self._loop, name="sidecar-snapshot", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            try:
                conn, peer = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # closed: the daemon is shutting down
            self._served += 1

            def _one(conn=conn, peer=peer):
                try:
                    rd, wr = session_pump.io_for_socket(conn)
                    stats = run_snapshot_session(
                        rd, wr, lambda: conn.shutdown(socket.SHUT_WR),
                        self.source, peer=f"{peer[0]}:{peer[1]}")
                    log_line(f"sidecar: snapshot {peer} {stats}")
                finally:
                    conn.close()

            threading.Thread(target=_one, name=f"sidecar-snap-{self._served}",
                             daemon=True).start()

    def close(self) -> None:
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=5)


def _swap_stdout_for_devnull() -> None:
    """Release the stdout pipe (the reader sees EOF) while keeping fd 1
    occupied, so a late retried write lands in /dev/null rather than in
    a descriptor some other thread was just handed."""
    devnull = os.open(os.devnull, os.O_WRONLY)
    os.dup2(devnull, 1)
    os.close(devnull)


def serve_stdio(device="cuda",
                drain_timeout: float | None = DEFAULT_DRAIN_TIMEOUT,
                reconcile_replica=None, snapshot_source=None) -> dict:
    """One session over stdin/stdout (logs go to stderr only)."""
    rd = lambda n: os.read(0, n)  # noqa: E731
    wr = lambda d: _write_all(1, d)  # noqa: E731
    close = once(_swap_stdout_for_devnull)
    if snapshot_source is not None:
        stats = run_snapshot_session(rd, wr, close, snapshot_source,
                                     peer="stdio")
    elif reconcile_replica is not None:
        stats = run_reconcile_session(rd, wr, close, reconcile_replica,
                                      peer="stdio")
    else:
        stats = run_session(rd, wr, close_write=close, device=device,
                            drain_timeout=drain_timeout)
    log_line(f"sidecar: stdio session {stats}")
    return stats


def serve_tcp(host: str, port: int, max_sessions: int | None = None,
              ready_cb=None, device="cuda",
              drain_timeout: float | None = DEFAULT_DRAIN_TIMEOUT,
              retry_policy=None, reconcile_replica=None,
              snapshot_source=None, hub=None, fanout=None,
              replica_node=None) -> None:
    """Accept loop: one concurrent session per connection.

    ``max_sessions`` bounds the loop (tests); ``ready_cb(port)`` fires
    once the socket is bound and listening.  With ``snapshot_source``
    every connection is one snapshot joiner served off the shared source;
    with ``replica_node`` (a :class:`~.cluster.ReplicaNode`) one gossip
    initiator against the live node, whose log absorbs what it ships;
    with ``reconcile_replica`` one reconcile initiator against the shared
    replica (read-only after construction, so sessions never step
    on each other); otherwise a digest session on ``device``, or with
    ``hub`` on the shared hub under the key ``c<n>:<host>:<port>``.

    ``fanout`` (a :class:`~.fanout.FanoutServer`): the first connection
    to claim the source slot is the broadcast source, a digest session
    (on ``hub`` when given) whose received bytes are also published into
    the fan-out; its end seals the log, and a claimant that published
    nothing gives the claim back.  Every other connection is a
    subscriber (:func:`run_subscriber`), keyed ``p<n>:<host>:<port>``.

    ``retry_policy`` (a :class:`~.session.reconnect.BackoffPolicy`)
    retries the bind through a lingering ``EADDRINUSE`` and rides out
    bursts of accept failures; sustained failure surfaces as one
    structured ProtocolError.  The loop returns after ``max_sessions``
    connections, with their session threads still running.
    """
    from .session.reconnect import BackoffPolicy, retrying

    policy = retry_policy if retry_policy is not None else BackoffPolicy()

    def _bind() -> socket.socket:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, port))
            s.listen(8)
        except OSError:
            s.close()
            raise
        return s

    srv = retrying(_bind, policy, retry_on=(OSError,),
                   describe=f"bind {host}:{port}")
    # the fan-out's source slot is claimed, not "connection #1": a stray
    # first connection that closes without publishing (a health check, a
    # port scan) must not seal an empty log for the daemon's lifetime
    src_claim = {"taken": False}
    src_lock = threading.Lock()

    def _fanout_connection(conn, name: str, n: int) -> dict:
        is_source = False
        if not fanout.log.sealed:
            with src_lock:
                if not src_claim["taken"]:
                    src_claim["taken"] = True
                    is_source = True
        if not is_source:
            return run_subscriber(conn, fanout, key=f"p{n}:{name}")
        try:
            return run_session(
                conn.recv, conn.sendall,
                close_write=lambda: conn.shutdown(socket.SHUT_WR),
                device=device, drain_timeout=drain_timeout, hub=hub,
                session_key=f"c{n}:{name}", publish=fanout.publish)
        finally:
            if fanout.log.end > fanout.log.start:
                fanout.seal()
            else:
                # nothing published: a probe, not the feed
                with src_lock:
                    src_claim["taken"] = False

    bound = srv.getsockname()[1]
    log_line(f"sidecar: listening on {host}:{bound}")
    if ready_cb is not None:
        ready_cb(bound)
    served = 0
    try:
        while max_sessions is None or served < max_sessions:
            # each retrying() call is a fresh consecutive-failure budget
            conn, peer = retrying(srv.accept, policy, retry_on=(OSError,),
                                  describe="accept")
            served += 1

            def _one(conn=conn, peer=peer, n=served):
                name = f"{peer[0]}:{peer[1]}"

                def close_write() -> None:
                    conn.shutdown(socket.SHUT_WR)

                try:
                    if snapshot_source is not None:
                        rd, wr = session_pump.io_for_socket(conn)
                        stats = run_snapshot_session(
                            rd, wr, close_write, snapshot_source, peer=name)
                    elif replica_node is not None:
                        rd, wr = session_pump.io_for_socket(conn)
                        stats = run_replica_session(
                            rd, wr, close_write, replica_node, peer=name)
                    elif reconcile_replica is not None:
                        rd, wr = session_pump.io_for_socket(conn)
                        stats = run_reconcile_session(
                            rd, wr, close_write, reconcile_replica,
                            peer=name)
                    elif fanout is not None:
                        stats = _fanout_connection(conn, name, n)
                    else:
                        stats = run_session(
                            conn.recv, conn.sendall, close_write=close_write,
                            device=device, drain_timeout=drain_timeout,
                            hub=hub, session_key=f"c{n}:{name}")
                    log_line(f"sidecar: {peer} {stats}")
                finally:
                    conn.close()

            threading.Thread(target=_one, name=f"sidecar-{peer}",
                             daemon=True).start()
    finally:
        srv.close()


class StatsEmitter:
    """Periodic stats snapshots on a file descriptor (``--stats-fd``).

    A daemon thread writes one record every ``interval`` seconds;
    :meth:`kick` forces one now (the SIGUSR1 handler only sets an
    event).  ``fmt="json"`` writes one self-contained JSON object a line
    with a per-emitter ``emit_seq`` (every attempt takes a number, so a
    skipped or lost line shows as a gap); ``fmt="prom"`` writes one
    Prometheus text block a record.  The fd is made non-blocking: a
    record is written whole or skipped when the pipe is full before its
    first byte, and a record torn by a pipe that stays full latches the
    emitter dead, so no later record is appended to a torn line.
    """

    def __init__(self, fd: int, interval: float = DEFAULT_STATS_INTERVAL,
                 fmt: str = "json"):
        if fmt not in ("json", "prom"):
            raise ValueError(f"unknown stats format {fmt!r}")
        self._fd = fd
        try:
            os.set_blocking(fd, False)
        except OSError:
            pass  # a closed fd surfaces at the first write
        self._fmt = fmt
        self._interval = interval
        self._wake = threading.Event()
        self._stopped = False
        self._dead = False  # the fd failed or a line tore
        self._emit_seq = 0
        self._thread = threading.Thread(
            target=self._run, name="sidecar-stats", daemon=True)

    def start(self) -> "StatsEmitter":
        self._thread.start()
        return self

    def kick(self) -> None:
        """Ask for a dump now (only sets an event: signal-safe)."""
        self._wake.set()

    def stop(self) -> bool:
        """Stop the thread; True once it has exited.  False means it is
        still blocked, and the caller must not write the fd itself."""
        self._stopped = True
        self._wake.set()
        self._thread.join(timeout=5)
        return not self._thread.is_alive()

    def dump_once(self) -> bool:
        """Write one record now; False when the fd is dead or stayed
        full past the grace period."""
        import errno

        if self._dead:
            return False
        seq = self._emit_seq
        self._emit_seq += 1
        if self._fmt == "prom":
            body = snapshot_stats_prom()
        else:
            snap = snapshot_stats()
            snap["emit_seq"] = seq
            body = json.dumps(snap) + "\n"
        line = body.encode("utf-8")
        view = memoryview(line)
        deadline = time.monotonic() + 2.0
        while view:
            try:
                view = view[os.write(self._fd, view):]
            except OSError as e:
                # a full pipe is retried briefly to finish the record;
                # a tick with nothing written yet is skipped whole
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    if time.monotonic() < deadline:
                        time.sleep(0.01)
                        continue
                    if len(view) == len(line):
                        return True
                self._dead = True  # torn line or hard error
                return False
        return True

    def _run(self) -> None:
        while not self._stopped:
            self._wake.wait(self._interval)
            self._wake.clear()
            if self._stopped:
                return
            if not self.dump_once():
                return


def snapshot_stats() -> dict:
    """One self-describing stats record: the metrics registry, the event
    ring's drops, the kernel sentinel's sites, the watermarks and the
    pump; in hub mode the hub's aggregate (``hub``) and per-session
    breakdown (``sessions``); in fan-out mode the server's aggregate
    (``fanout``) and per-peer breakdown (``peers``); in replica mode the
    node's ``gossip`` record and, once the board holds a link or a
    frontier, the convergence plane (``propagation``); the wire cost
    ledger (``wirecost``) once it holds a link; in edge mode the session
    table's aggregate (``edge``); and the staged health (``healthz``).
    JSON-able."""
    out = {
        "ts": time.time(),
        "monotonic": time.monotonic(),
        "metrics": obs_metrics.snapshot(),
        "events_dropped": obs_events.EVENTS.dropped,
        "jit_sites": obs_device.SENTINEL.snapshot(),
        "watermarks": _WATERMARKS.snapshot(),
        "pump": session_pump.probe_caps(),
    }
    if _ACTIVE_HUB is not None:
        out["hub"] = _ACTIVE_HUB.snapshot()
        out["sessions"] = _ACTIVE_HUB.sessions_snapshot()
    if _ACTIVE_FANOUT is not None:
        out["fanout"] = _ACTIVE_FANOUT.snapshot()
        out["peers"] = _ACTIVE_FANOUT.peers_snapshot()
    if _ACTIVE_GOSSIP is not None:
        out["gossip"] = _ACTIVE_GOSSIP.snapshot()
        # an empty board (plane dark, or no exchange yet) is left out, so
        # a reader can tell "plane off" from "no exchanges yet"
        prop = _PROPAGATION.snapshot()
        if prop["links"] or prop["frontier"]:
            out["propagation"] = prop
    wc = _WIRECOST.snapshot()
    if wc["links"] or wc["amplification"]:
        out["wirecost"] = wc
    if _ACTIVE_EDGE is not None:
        out["edge"] = _ACTIVE_EDGE.snapshot()
    out["healthz"] = obs_http.default_healthz(_active_admission_fn())
    return out


def _active_admission_fn():
    """The lock-free admission view of the shared engine: the edge's
    when an edge loop runs (it composes the hub's verdict with its own
    table), else the hub's when a hub runs (the fan-out composes with it
    as the broadcast layer), else the fan-out's."""
    if _ACTIVE_EDGE is not None:
        return _ACTIVE_EDGE.admission_state
    if _ACTIVE_HUB is not None:
        return _ACTIVE_HUB.admission_state
    if _ACTIVE_FANOUT is not None:
        return _ACTIVE_FANOUT.admission_state
    return None


def snapshot_stats_prom() -> str:
    """The stats record as Prometheus text: the registry and the rings'
    health."""
    extra = (
        "# TYPE dat_obs_events_dropped gauge\n"
        f"dat_obs_events_dropped {obs_events.EVENTS.dropped}\n"
        "# TYPE dat_obs_spans_dropped gauge\n"
        f"dat_obs_spans_dropped {obs_tracing.SPANS.dropped}\n"
        "# TYPE dat_obs_scrape_ts gauge\n"
        f"dat_obs_scrape_ts {time.time()}\n"
    )
    return obs_metrics.to_prom_text() + extra


def _install_sigusr1(emitter: StatsEmitter) -> bool:
    """SIGUSR1 -> one dump; False off the main thread, where a handler
    cannot be installed."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return False
    signal.signal(signal.SIGUSR1, lambda _sig, _frm: emitter.kick())
    return True


def _hub_mesh(spec: str, device):
    """The mesh ``--hub-mesh auto|N`` asks for, over the process group
    its launcher describes (``env://``), one process a card (the rank
    picks it).  Raises when there is no such group."""
    import torch
    import torch.distributed as dist

    from .parallel import make_mesh
    from .utils.device import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return make_mesh(None if spec == "auto" else int(spec), device=dev)


def _end_on_mesh_failure(hub) -> threading.Event:
    """Rank 0 of a ``--hub-mesh`` of several ranks: a failed engine may
    leave the followers inside a batch's collectives, and those end only
    with this process (or at the group's timeout).  On a failure, stop
    the main thread as SIGINT does; the returned event marks the exit
    as the hub's failure."""
    import signal

    failed = threading.Event()

    def watch() -> None:
        err = hub.wait_failed()
        if err is not None:
            log_line(f"sidecar: the mesh hub failed ({err!r}); ending rank "
                     f"0 so that the followers' collectives raise")
            failed.set()
            signal.pthread_kill(threading.main_thread().ident, signal.SIGINT)

    threading.Thread(target=watch, name="hub-mesh-watch",
                     daemon=True).start()
    return failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dat_replication_protocol_tpu_torch.sidecar",
        description="Serve digest, reconcile, snapshot, fan-out or gossip "
                    "replica sessions over stdin/stdout or TCP.")
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--stdio", action="store_true",
                      help="serve one session on stdin, reply on stdout")
    mode.add_argument("--tcp", metavar="HOST:PORT",
                      help="listen on HOST:PORT (port 0 binds an ephemeral "
                           "port, printed on stderr) and serve every "
                           "connection on its own thread (or, with --edge, "
                           "from one event loop)")
    parser.add_argument("--device", default="cuda",
                        help="torch device for the digests and the "
                             "anti-entropy state (default: cuda)")
    parser.add_argument("--drain-timeout", type=float,
                        default=DEFAULT_DRAIN_TIMEOUT, metavar="SECONDS",
                        help="tear a digest session down when its reply "
                             "makes no progress for this long (a client "
                             "that never reads); 0 waits forever "
                             f"(default: {DEFAULT_DRAIN_TIMEOUT:.0f})")
    parser.add_argument("--reconcile", metavar="LOGFILE", default=None,
                        help="serve every session as a rateless "
                             "reconciliation responder against the "
                             "change-log wire file LOGFILE")
    parser.add_argument("--replica", metavar="LOGFILE", default=None,
                        help="gossip replica mode (--tcp only): load the "
                             "change-log wire file LOGFILE (absent: a cold "
                             "replica) into one live replica, serve every "
                             "session as an anti-entropy responder whose "
                             "received records are absorbed, and with "
                             "--gossip-peers dial out on a jittered timer")
    parser.add_argument("--replica-key", default="replica", metavar="KEY",
                        help="this replica's name in gossip telemetry "
                             "(default: replica)")
    parser.add_argument("--gossip-peers", default=None,
                        metavar="HOST:PORT,...",
                        help="comma list of peer --replica sidecars to "
                             "gossip with (requires --replica)")
    parser.add_argument("--gossip-interval", type=float, default=1.0,
                        metavar="SECONDS",
                        help="mean seconds between gossip dials (jittered; "
                             "rounds that all fail back off; default: 1)")
    parser.add_argument("--snapshot", metavar="DATAFILE", default=None,
                        help="materialize DATAFILE once as content-"
                             "addressed chunks and serve every session "
                             "as a snapshot bootstrap responder")
    parser.add_argument("--snapshot-port", type=int, default=0,
                        metavar="PORT",
                        help="the snapshot bootstrap's own port in the "
                             "--fanout --snapshot composition (default: 0, "
                             "an ephemeral port; the bound port rides the "
                             "snapshot-needed record's hint)")
    parser.add_argument("--snapshot-offset", type=int, default=0,
                        metavar="BYTES",
                        help="live-log wire offset the --snapshot dataset "
                             "materializes (default: 0)")
    parser.add_argument("--edge", action="store_true",
                        help="event-driven edge (--tcp only): serve every "
                             "connection (hub sessions, --fanout peers, "
                             "--reconcile/--snapshot responders) from ONE "
                             "selector session table instead of a thread "
                             "each, with the same overload ladder; implies "
                             "--hub for digest sessions")
    parser.add_argument("--hub", action="store_true",
                        help="multiplex every accepted digest session onto "
                             "one shared engine (--tcp only): batching "
                             "across sessions, admission, per-session "
                             "windows, shedding")
    parser.add_argument("--fanout", action="store_true",
                        help="broadcast mode (--tcp only): the first "
                             "connection is the source session, decoded and "
                             "hashed once; every other connection is a "
                             "subscriber streamed the source's wire bytes")
    parser.add_argument("--fanout-retention", type=int, default=64 << 20,
                        metavar="BYTES",
                        help="how much broadcast wire stays servable to "
                             "late joiners and laggards; a subscriber "
                             "trimmed past gets a snapshot-needed record "
                             "(default: 64 MiB)")
    parser.add_argument("--fanout-window", type=int, default=1 << 20,
                        metavar="BYTES",
                        help="per-subscriber flow-control window, bytes in "
                             "flight (default: 1 MiB)")
    parser.add_argument("--fanout-stall-timeout", type=float, default=30.0,
                        metavar="SECONDS",
                        help="shed a subscriber that makes no delivery "
                             "progress for this long (default: 30)")
    parser.add_argument("--hub-max-sessions", type=int, default=1024,
                        metavar="N",
                        help="hub admission bound on concurrent sessions "
                             "(default: 1024)")
    parser.add_argument("--hub-parked-budget", type=int, default=256 << 20,
                        metavar="BYTES",
                        help="hub admission and shedding bound on parked "
                             "bytes: queued, in flight and undelivered "
                             "(default: 256 MiB)")
    parser.add_argument("--hub-mesh", default=None, metavar="N|auto",
                        help="shard the hub's batches over the process "
                             "group a launcher set up (env://): 'auto' "
                             "takes the whole group, N pins its size; "
                             "rank 0 serves, the other ranks follow")
    parser.add_argument("--stats-fd", type=int, default=None, metavar="FD",
                        help="enable telemetry and write one snapshot "
                             "record to this fd every --stats-interval "
                             "seconds; SIGUSR1 forces one")
    parser.add_argument("--stats-interval", type=float,
                        default=DEFAULT_STATS_INTERVAL, metavar="SECONDS",
                        help="period between --stats-fd records "
                             f"(default: {DEFAULT_STATS_INTERVAL:.0f})")
    parser.add_argument("--stats-format", choices=("json", "prom"),
                        default="json",
                        help="--stats-fd records as JSON lines (default) "
                             "or Prometheus text blocks")
    parser.add_argument("--obs-http", type=int, default=None,
                        metavar="PORT",
                        help="enable telemetry and serve /metrics, "
                             "/snapshot, /healthz and /events on "
                             "127.0.0.1:PORT (0: an ephemeral port, printed "
                             "on stderr)")
    parser.add_argument("--max-retries", type=int, default=5, metavar="N",
                        help="bind/accept errors are retried with backoff "
                             "at most N times (default: 5)")
    parser.add_argument("--backoff-base", type=float, default=0.05,
                        metavar="SECONDS",
                        help="base of the full-jitter backoff: attempt k "
                             "sleeps uniform(0, min(cap, base * 2^k)) "
                             "(default: 0.05)")
    parser.add_argument("--flight-dir", metavar="DIR", default=None,
                        help="arm the flight recorder: on a protocol error, "
                             "dump a post-mortem bundle (event and span "
                             "rings, metrics) into DIR; enables telemetry")
    parser.add_argument("--trace-jsonl", metavar="PATH", default=None,
                        help="enable telemetry and mirror every event and "
                             "wire-offset span as JSONL into PATH")
    args = parser.parse_args(argv)
    if args.reconcile and args.snapshot:
        parser.error("--reconcile and --snapshot are separate session "
                     "modes; pick one")
    if args.hub and args.stdio:
        parser.error("--hub multiplexes many connections; it needs --tcp")
    if args.hub and (args.reconcile or args.snapshot):
        parser.error("--hub serves digest sessions; it cannot combine with "
                     "--reconcile/--snapshot")
    if args.hub_mesh is not None and not args.hub:
        parser.error("--hub-mesh requires --hub")
    if args.fanout and args.stdio:
        parser.error("--fanout broadcasts to many connections; it needs "
                     "--tcp")
    if args.fanout and args.reconcile:
        parser.error("--reconcile is its own session mode; it cannot "
                     "combine with --hub/--fanout")
    if args.replica and (args.hub or args.fanout or args.reconcile
                         or args.snapshot):
        parser.error("--replica is its own session mode; it cannot combine "
                     "with --hub/--fanout/--reconcile/--snapshot")
    if args.replica and args.stdio:
        parser.error("--replica gossips with many peers; it needs --tcp")
    if args.gossip_peers and not args.replica:
        parser.error("--gossip-peers requires --replica")
    if args.edge and args.stdio:
        parser.error("--edge is the event-driven TCP front; it needs --tcp")
    if args.edge and not args.hub and (
            args.fanout
            or not (args.reconcile or args.snapshot or args.replica)):
        # --edge implies --hub for digest sessions (a broadcast source is
        # one): the table's hub sessions ride the shared engine's
        # admission/window/shed ladder
        args.hub = True
    drain = args.drain_timeout if args.drain_timeout > 0 else None
    from .session.reconnect import BackoffPolicy

    policy = BackoffPolicy(base=args.backoff_base,
                           max_retries=args.max_retries)
    trace_sink = None
    emitter = None
    hub = None
    mesh = None
    mesh_failed = None
    obs_srv = None
    fanout = None
    snap_listener = None
    replica_node = None
    gossip_driver = None
    if args.flight_dir:
        # arming enables telemetry: a dark ring has nothing to dump
        obs_flight.FLIGHT.arm(args.flight_dir)
    if args.trace_jsonl:
        obs_metrics.enable()
        trace_sink = obs_tracing.attach_jsonl_sink(args.trace_jsonl)
    if args.stats_fd is not None:
        obs_metrics.enable()  # the stats need metrics
        emitter = StatsEmitter(args.stats_fd, args.stats_interval,
                               fmt=args.stats_format).start()
        _install_sigusr1(emitter)
    try:
        if args.hub:
            from .hub import ReplicationHub, mesh_follower

            if args.hub_mesh is not None:
                try:
                    mesh = _hub_mesh(args.hub_mesh, args.device)
                except (ValueError, RuntimeError) as e:
                    print(f"sidecar: --hub-mesh needs the process group "
                          f"of a launcher (env://): {e}", file=sys.stderr,
                          flush=True)
                    return 2
                if mesh.rank != 0:
                    try:
                        batches = mesh_follower(mesh)
                    except RuntimeError as e:
                        # rank 0's hub failed and tore the group down
                        print(f"sidecar: rank {mesh.rank}: the hub's group "
                              f"failed: {e}", file=sys.stderr, flush=True)
                        return 1
                    print(f"sidecar: rank {mesh.rank} followed {batches} "
                          f"hub batches", file=sys.stderr, flush=True)
                    return 0
            hub = ReplicationHub(mesh=mesh, device=args.device,
                                 max_sessions=args.hub_max_sessions,
                                 parked_budget=args.hub_parked_budget)
            set_active_hub(hub)
            if mesh is not None and mesh.size > 1:
                mesh_failed = _end_on_mesh_failure(hub)
        if args.fanout:
            from .fanout import FanoutServer

            fanout = FanoutServer(
                retention_budget=args.fanout_retention,
                window_bytes=args.fanout_window,
                stall_timeout=args.fanout_stall_timeout)
            set_active_fanout(fanout)
        if args.obs_http is not None:
            obs_metrics.enable()  # a dark endpoint would serve zeros
            obs_srv = obs_http.ObsHttpServer(
                args.obs_http, snapshot_fn=snapshot_stats,
                admission_fn=_active_admission_fn()).start()
            print(f"sidecar: obs endpoint on {obs_srv.url}",
                  file=sys.stderr, flush=True)
        replica = (load_reconcile_replica(args.reconcile, args.device)
                   if args.reconcile else None)
        source = (load_snapshot_source(args.snapshot, args.snapshot_offset,
                                       args.device)
                  if args.snapshot else None)
        if args.replica:
            replica_node = load_replica_node(args.replica, args.replica_key,
                                             args.device)
            if args.gossip_peers:
                from .cluster import GossipDriver

                gossip_driver = GossipDriver(
                    replica_node,
                    [p.strip() for p in args.gossip_peers.split(",")],
                    interval=args.gossip_interval).start()
                set_active_gossip(gossip_driver)
            else:
                set_active_gossip(replica_node)
        if args.stdio:
            out = serve_stdio(device=args.device, drain_timeout=drain,
                              reconcile_replica=replica,
                              snapshot_source=source)
            print(json.dumps(out), file=sys.stderr)
            return 0 if out["ok"] else 1
        host, _, port = args.tcp.rpartition(":")
        host = host or "127.0.0.1"
        if fanout is not None and source is not None:
            # the composition: snapshot sessions get their own port, and
            # the broadcast's snapshot-needed refusals name it
            from .wire.framing import CAP_SNAPSHOT

            try:
                snap_listener = SnapshotListener(source, host,
                                                 args.snapshot_port)
            except OSError as e:
                print(f"sidecar: cannot serve the snapshot bootstrap on "
                      f"{host}:{args.snapshot_port}: {e}", file=sys.stderr,
                      flush=True)
                return 1
            fanout.snapshot_hint = {"port": snap_listener.port,
                                    "cap": CAP_SNAPSHOT}
            print(f"sidecar: snapshot bootstrap on "
                  f"{host}:{snap_listener.port}", file=sys.stderr, flush=True)
            source = None  # the main loop keeps broadcasting
        if args.edge:
            from .edge import EdgeLoop

            edge_loop = EdgeLoop(
                hub, fanouts={"main": fanout} if fanout else None,
                reconcile_replica=replica, snapshot_source=source,
                replica_node=replica_node, drain_timeout=drain,
                # a stable loop label a process: edge.loop.lag{loop=}
                name=f"edge:{host}:{int(port)}")
            set_active_edge(edge_loop)
            try:
                edge_loop.bind(host, int(port))
                edge_loop.serve()
            finally:
                set_active_edge(None)
            return 0
        serve_tcp(host, int(port), device=args.device,
                  drain_timeout=drain, retry_policy=policy,
                  reconcile_replica=replica, snapshot_source=source,
                  hub=hub, fanout=fanout, replica_node=replica_node)
        return 0
    except KeyboardInterrupt:
        if mesh_failed is not None and mesh_failed.is_set():
            return 1
        raise
    finally:
        if gossip_driver is not None:
            gossip_driver.close()
        if replica_node is not None:
            set_active_gossip(None)
        if snap_listener is not None:
            snap_listener.close()
        if obs_srv is not None:
            obs_srv.close()
        if fanout is not None:
            set_active_fanout(None)
            fanout.close()
        if hub is not None:
            set_active_hub(None)
            hub.close()  # on a mesh, this sends the followers their stop
        if args.hub_mesh is not None:
            # the group's threads must not outlive the interpreter
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        if emitter is not None and emitter.stop():
            # the last record, once the periodic thread has exited: two
            # writers on one fd could tear a line
            emitter.dump_once()
        if trace_sink is not None:
            obs_events.EVENTS.detach_sink()
            obs_tracing.SPANS.detach_sink()
            trace_sink.close()


if __name__ == "__main__":
    sys.exit(main())
