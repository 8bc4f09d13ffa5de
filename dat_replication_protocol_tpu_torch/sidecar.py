"""The digest sidecar: a process foreign clients pipe wire bytes to.

The digest-reply core of ``dat_replication_protocol_tpu/sidecar.py``
(:121-260)::

    python -m dat_replication_protocol_tpu_torch.sidecar --stdio

A client pipes a session (changes + blobs) in; the sidecar decodes it
with ``decode(backend='cuda')``, hashing every change payload and blob on
the card, and streams a reply session back:

* one ``Change`` per digest, in submit order;
* ``key`` = ``"change-<seq>"`` or ``"blob-<seq>"`` (the 0-based arrival
  index of that kind), ``change`` = <seq>, ``from`` = 0, ``to`` = 1;
* ``subset`` = ``"digest:change"`` / ``"digest:blob"``;
* ``value`` = the 32-byte BLAKE2b-256 digest.

Every digest is encoded onto the reply before the reply finalizes
(flush-before-finalize).  A protocol error destroys both directions, so
a malformed client observes EOF rather than a hang.  The TCP, hub and
fan-out modes of the reference sidecar are not part of this slice.

Telemetry, as the reference's flags give it (:1303-1328):
``--flight-dir DIR`` arms the flight recorder (a protocol error dumps a
bundle into DIR) and turns telemetry on; ``--trace-jsonl PATH`` turns
it on and mirrors every event and span as JSONL into PATH.  The request
is consumed inside a ``sidecar.session.recv`` span, so PATH carries both
directions' frame tags.  ``--stats-fd`` and ``--obs-http`` are not
ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

from . import decode, encode
from .obs import flight as obs_flight
from .obs import metrics as obs_metrics
from .obs import tracing as obs_tracing

DIGEST_SUBSET_CHANGE = "digest:change"
DIGEST_SUBSET_BLOB = "digest:blob"
DEFAULT_CHUNK = 64 * 1024
_WAKE = 0.5  # bound on every wait; wakeups are event-driven


def run_session(read_bytes, write_bytes, close_write=None, device="cuda",
                chunk_size: int = DEFAULT_CHUNK) -> dict:
    """Serve one wire session over a blocking byte pair.

    ``read_bytes(n)`` returns up to n bytes (``b''`` at EOF);
    ``write_bytes(data)`` blocks on congestion.  The reply is written by
    a sender thread so that a client which reads its reply only after
    sending cannot deadlock the session.  Returns ``{"changes", "blobs",
    "bytes", "digests", "ok"}``.
    """
    enc = encode()  # the reply: plain host encoder
    dec = decode(backend="cuda", device=device)
    lock = threading.Lock()  # the encoder is shared by both threads
    readable = threading.Event()
    enc._attach_readable(readable.set)
    stats = {"digests": 0}

    def destroy_enc(err=None) -> None:
        with lock:
            enc.destroy(err)
        readable.set()

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
        # reply backpressure: stall request consumption until the reply
        # drains below its high-water mark
        while not below and not (flushed.wait(_WAKE) or enc.destroyed):
            pass

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
        except OSError as e:  # the client went away
            destroy_enc(e)
            if not dec.destroyed:
                dec.destroy(e)
        finally:
            if close_write is not None:
                close_write()

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
        sender.join()
    return {"changes": dec.changes, "blobs": dec.blobs, "bytes": dec.bytes,
            "digests": stats["digests"],
            "ok": dec.finished and not dec.destroyed and not enc.destroyed}


def _write_all(fd: int, data) -> None:
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dat_replication_protocol_tpu_torch.sidecar",
        description="Serve one digest session over stdin/stdout.")
    parser.add_argument("--stdio", action="store_true", required=True,
                        help="read the session on stdin, reply on stdout")
    parser.add_argument("--device", default="cuda",
                        help="torch device for the digests (default: cuda)")
    parser.add_argument("--flight-dir", metavar="DIR", default=None,
                        help="arm the flight recorder: on a protocol error, "
                             "dump a post-mortem bundle (event and span "
                             "rings, metrics) into DIR; enables telemetry")
    parser.add_argument("--trace-jsonl", metavar="PATH", default=None,
                        help="enable telemetry and mirror every event and "
                             "wire-offset span as JSONL into PATH")
    args = parser.parse_args(argv)
    trace_sink = None
    if args.flight_dir:
        # arming enables telemetry: a dark ring has nothing to dump
        obs_flight.FLIGHT.arm(args.flight_dir)
    if args.trace_jsonl:
        obs_metrics.enable()
        trace_sink = obs_tracing.attach_jsonl_sink(args.trace_jsonl)
    try:
        out = run_session(lambda n: os.read(0, n),
                          lambda data: _write_all(1, data),
                          close_write=lambda: os.close(1),
                          device=args.device)
    finally:
        if trace_sink is not None:
            obs_tracing.EVENTS.detach_sink()
            obs_tracing.SPANS.detach_sink()
            trace_sink.close()
    print(json.dumps(out), file=sys.stderr)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
