"""The sidecar: a daemon foreign clients pipe wire bytes to.

The port of ``dat_replication_protocol_tpu/sidecar.py``'s digest reply
(:121-393), its TCP accept loop (:741-926) and its anti-entropy modes
(:517-643)::

    python -m dat_replication_protocol_tpu_torch.sidecar --stdio
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp 127.0.0.1:7531
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp HOST:PORT \
        --reconcile LOGFILE
    python -m dat_replication_protocol_tpu_torch.sidecar --tcp HOST:PORT \
        --snapshot DATAFILE [--snapshot-offset BYTES]

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
The hub, fan-out, edge and replica modes of the reference sidecar are
not ported, nor ``--stats-fd`` and ``--obs-http``.

Telemetry, as the reference's flags give it (:1303-1328):
``--flight-dir DIR`` arms the flight recorder (a protocol error dumps a
bundle into DIR) and turns telemetry on; ``--trace-jsonl PATH`` turns
it on and mirrors every event and span as JSONL into PATH.  The request
is consumed inside a ``sidecar.session.recv`` span.
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
from .obs import events as obs_events
from .obs import flight as obs_flight
from .obs import metrics as obs_metrics
from .obs import tracing as obs_tracing
from .obs.events import emit as _emit
from .obs.metrics import OBS as _OBS
from .obs.metrics import counter as _counter
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

_M_SESSIONS = _counter("sidecar.sessions")
_M_STALLS = _counter("sidecar.stalls")


def run_session(read_bytes, write_bytes, close_write=None, device="cuda",
                chunk_size: int = DEFAULT_CHUNK,
                drain_timeout: float | None = DEFAULT_DRAIN_TIMEOUT) -> dict:
    """Serve one wire session over a blocking byte pair.

    ``read_bytes(n)`` returns up to n bytes (``b''`` at EOF);
    ``write_bytes(data)`` blocks on congestion.  The reply is written by
    a sender thread so that a client which reads its reply only after
    sending cannot deadlock the session.

    ``drain_timeout`` bounds every reply-stall wait: when the reply
    makes no write progress for that many seconds, in the digest-flush
    backpressure wait or in the end-of-session drain, the reply encoder
    is destroyed and ``close_write`` invoked so the session tears down
    instead of parking its thread; ``None`` waits forever.  Returns
    ``{"changes", "blobs", "bytes", "digests", "ok"}``.
    """
    enc = encode()  # the reply: plain host encoder
    dec = decode(backend="cuda", device=device)
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
    except OSError as e:  # the transport died mid-read
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
    print(f"sidecar: stdio session {stats}", file=sys.stderr, flush=True)
    return stats


def serve_tcp(host: str, port: int, max_sessions: int | None = None,
              ready_cb=None, device="cuda",
              drain_timeout: float | None = DEFAULT_DRAIN_TIMEOUT,
              retry_policy=None, reconcile_replica=None,
              snapshot_source=None) -> None:
    """Accept loop: one concurrent session per connection.

    ``max_sessions`` bounds the loop (tests); ``ready_cb(port)`` fires
    once the socket is bound and listening.  With ``snapshot_source``
    every connection is one snapshot joiner served off the shared source;
    with ``reconcile_replica`` one reconcile initiator against the shared
    replica (both read-only after construction, so sessions never step
    on each other); otherwise a digest session on ``device``.

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
    bound = srv.getsockname()[1]
    print(f"sidecar: listening on {host}:{bound}", file=sys.stderr,
          flush=True)
    if ready_cb is not None:
        ready_cb(bound)
    served = 0
    try:
        while max_sessions is None or served < max_sessions:
            # each retrying() call is a fresh consecutive-failure budget
            conn, peer = retrying(srv.accept, policy, retry_on=(OSError,),
                                  describe="accept")
            served += 1

            def _one(conn=conn, peer=peer):
                name = f"{peer[0]}:{peer[1]}"

                def close_write() -> None:
                    conn.shutdown(socket.SHUT_WR)

                try:
                    if snapshot_source is not None:
                        rd, wr = session_pump.io_for_socket(conn)
                        stats = run_snapshot_session(
                            rd, wr, close_write, snapshot_source, peer=name)
                    elif reconcile_replica is not None:
                        rd, wr = session_pump.io_for_socket(conn)
                        stats = run_reconcile_session(
                            rd, wr, close_write, reconcile_replica,
                            peer=name)
                    else:
                        stats = run_session(
                            conn.recv, conn.sendall, close_write=close_write,
                            device=device, drain_timeout=drain_timeout)
                    print(f"sidecar: {peer} {stats}", file=sys.stderr,
                          flush=True)
                finally:
                    conn.close()

            threading.Thread(target=_one, name=f"sidecar-{peer}",
                             daemon=True).start()
    finally:
        srv.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dat_replication_protocol_tpu_torch.sidecar",
        description="Serve digest, reconcile or snapshot sessions over "
                    "stdin/stdout or TCP.")
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--stdio", action="store_true",
                      help="serve one session on stdin, reply on stdout")
    mode.add_argument("--tcp", metavar="HOST:PORT",
                      help="listen on HOST:PORT (port 0 binds an ephemeral "
                           "port, printed on stderr) and serve every "
                           "connection on its own thread")
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
    parser.add_argument("--snapshot", metavar="DATAFILE", default=None,
                        help="materialize DATAFILE once as content-"
                             "addressed chunks and serve every session "
                             "as a snapshot bootstrap responder")
    parser.add_argument("--snapshot-offset", type=int, default=0,
                        metavar="BYTES",
                        help="live-log wire offset the --snapshot dataset "
                             "materializes (default: 0)")
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
    drain = args.drain_timeout if args.drain_timeout > 0 else None
    from .session.reconnect import BackoffPolicy

    policy = BackoffPolicy(base=args.backoff_base,
                           max_retries=args.max_retries)
    trace_sink = None
    if args.flight_dir:
        # arming enables telemetry: a dark ring has nothing to dump
        obs_flight.FLIGHT.arm(args.flight_dir)
    if args.trace_jsonl:
        obs_metrics.enable()
        trace_sink = obs_tracing.attach_jsonl_sink(args.trace_jsonl)
    try:
        replica = (load_reconcile_replica(args.reconcile, args.device)
                   if args.reconcile else None)
        source = (load_snapshot_source(args.snapshot, args.snapshot_offset,
                                       args.device)
                  if args.snapshot else None)
        if args.stdio:
            out = serve_stdio(device=args.device, drain_timeout=drain,
                              reconcile_replica=replica,
                              snapshot_source=source)
            print(json.dumps(out), file=sys.stderr)
            return 0 if out["ok"] else 1
        host, _, port = args.tcp.rpartition(":")
        serve_tcp(host or "127.0.0.1", int(port), device=args.device,
                  drain_timeout=drain, retry_policy=policy,
                  reconcile_replica=replica, snapshot_source=source)
        return 0
    finally:
        if trace_sink is not None:
            obs_events.EVENTS.detach_sink()
            obs_tracing.SPANS.detach_sink()
            trace_sink.close()


if __name__ == "__main__":
    sys.exit(main())
