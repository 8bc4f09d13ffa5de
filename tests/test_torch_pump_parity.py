"""The port's two pump routes and the JAX package's decoder, byte for byte.

The port's copy of ``tests/test_pump_parity.py``.  For the same wire
bytes, including streams a ``FaultPlan`` has already mangled, the port's
batched pump (``recv_pump``: ``dat_pump_recv_scan`` and
``Decoder.write_indexed``), its Python pump (``transport.recv_over`` on
``sock.recv``) and the JAX package's digest decoder (its own
``recv_over``) give the same session: deliveries (changes, blob
contents), digest streams (the port's on ``device="cpu"``), checkpoints
and structured errors (type, frame, offset, message, cause).  The
20-seed sweep is tier 1, the 80 further seeds of the soak carry the
reference's ``slow`` mark; then a flipped byte, a truncation, a resume
through the batched reader, and a re-segmentation across batch frames.

Faults are materialized ONCE per seed (the port's ``FaultyReader`` over
the wire, its stalls and latency zeroed: a kernel stream erases segment
timing anyway), and the same segments then go to all three over real
socketpairs, so any divergence is a pump's, not the injector's clock.

The wire is the reference's shape (per-record change runs, negotiated
``ChangeBatch`` frames on odd seeds, a blob, a tail change) with the
blob cut from 30,000 + 13 x seed bytes to 2,000 + 13 x seed and the rows
raised by 300: the port's digests run B1's plain version here, a few ms
a 128-byte block.
"""

from __future__ import annotations

import io
import random
import socket
import threading

import pytest

import dat_replication_protocol_tpu as jax_protocol
from dat_replication_protocol_tpu.session import transport as jax_transport
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch.session import pump, transport
from dat_replication_protocol_tpu_torch.session.faults import (
    FaultPlan,
    FaultyReader,
    TransportFault,
)
from dat_replication_protocol_tpu_torch.wire.framing import CAP_CHANGE_BATCH

SWEEP_SEEDS = 20
SOAK_SEEDS = 100
ROUTES = ("native", "python", "jax")


def _build_wire(seed: int) -> bytes:
    """A mixed session wire: per-record change runs, columnar batch
    frames on odd seeds (negotiated), a blob and a tail change."""
    caps = CAP_CHANGE_BATCH if seed % 2 else 0
    e = protocol.encode(peer_caps=caps) if caps else protocol.encode()
    rows = 700 + (seed * 37) % 300
    e.change_many([
        {"key": f"k{seed}-{j:05d}", "change": j, "from": j, "to": j + 1,
         "value": bytes([j % 251]) * (j % 90)}
        for j in range(rows)
    ])
    b = e.blob(2_000 + seed * 13)
    b.write(bytes(2_000 + seed * 13))
    b.end()
    e.change({"key": f"tail-{seed}", "change": 1, "from": 0, "to": 1})
    e.finalize()
    return b"".join(iter(lambda: e.read(1 << 20), None))


def _materialize_faulted(wire: bytes, plan: FaultPlan) -> list:
    """The segments the fault injector delivers for ``wire``, once,
    coalesced into 256 KiB sends (send boundaries are invisible to a
    stream receiver)."""
    plan.stall_s = 0.0
    plan.latency_prob = 0.0
    src = io.BytesIO(wire)
    fr = FaultyReader(lambda n: src.read(n), plan)
    segments = []
    while True:
        try:
            d = fr.read(65536)
        except TransportFault:
            break
        if not d:
            break
        segments.append(d)
    whole = b"".join(segments)
    return [whole[i:i + (256 << 10)]
            for i in range(0, len(whole), 256 << 10)]


def _decoder(route: str):
    if route == "jax":
        return jax_protocol.decode(backend="tpu")
    return protocol.decode(backend="cuda", device="cpu")


def _pump_into(route: str, dec, sock: socket.socket) -> None:
    if route == "native":
        pump.recv_pump(dec, sock.fileno())
    elif route == "python":
        transport.recv_over(dec, sock.recv)
    else:
        jax_transport.recv_over(dec, sock.recv)


def _observe(dec) -> dict:
    out = {"changes": [], "blobs": [], "digests": [], "errors": []}
    dec.change(lambda c, done: (out["changes"].append(
        (c.key, c.change, c.from_, c.to, bytes(c.value or b""),
         c.subset)), done()))
    dec.blob(lambda blob, done: blob.collect(
        lambda data: (out["blobs"].append(bytes(data)), done())))
    dec.on_digest(lambda kind, seq, dig:
                  out["digests"].append((kind, seq, bytes(dig))))
    dec.on_error(lambda err: out["errors"].append(err))
    return out


def _finish(dec, out: dict) -> dict:
    ck = dec.checkpoint(emit_event=False)
    out["final"] = (dec.finished, dec.destroyed, dec.bytes, dec.changes,
                    dec.blobs)
    out["checkpoint"] = (ck.wire_offset, ck.frame, ck.row, ck.blob_offset)
    out["errors"] = [
        (type(err).__name__, getattr(err, "frame", None),
         getattr(err, "offset", None), str(err),
         type(getattr(err, "cause", None)).__name__)
        for err in out["errors"]
    ]
    return out


def _run_route(route: str, segments) -> dict:
    """One digest session over a socketpair on ``route``: every
    observable of it."""
    a, b = socket.socketpair()
    try:
        dec = _decoder(route)
        out = _observe(dec)

        def feed() -> None:
            try:
                for seg in segments:
                    a.sendall(seg)
            except OSError:
                pass  # the decoder died mid-stream: the receiver closed
            try:
                a.shutdown(socket.SHUT_WR)
            except OSError:
                pass

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        try:
            _pump_into(route, dec, b)
        except OSError:
            pass  # the transport died under the pump
        b.close()  # unblock a feeder parked on a full socket
        t.join(30)
        return _finish(dec, out)
    finally:
        a.close()
        b.close()


FIELDS = ("changes", "blobs", "digests", "errors", "final", "checkpoint")


def _assert_routes_identical(seed: int, segments) -> dict:
    runs = {route: _run_route(route, segments) for route in ROUTES}
    for route in ("python", "jax"):
        for field in FIELDS:
            assert runs["native"][field] == runs[route][field], (
                f"seed {seed}: native and {route} diverge on {field}: "
                f"{runs['native'][field]!r:.300} against "
                f"{runs[route][field]!r:.300}")
    return runs["native"]


def _sweep(seed: int) -> None:
    wire = _build_wire(seed)
    plan = FaultPlan.for_sweep(seed, len(wire))
    _assert_routes_identical(seed, _materialize_faulted(wire, plan))


@pytest.mark.parametrize("seed", range(SWEEP_SEEDS))
def test_pump_parity_under_faults(seed):
    _sweep(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(SWEEP_SEEDS, SOAK_SEEDS))
def test_pump_parity_soak(seed):
    _sweep(seed)


def test_pump_parity_flip_is_one_structured_error():
    """A flipped byte fails STRUCTURED: one ProtocolError at the same
    frame and offset on every route, never a hang, and the content
    before it delivered alike."""
    wire = _build_wire(3)
    plan = FaultPlan(seed=9, flip_at=len(wire) // 3, flip_mask=0x40,
                     max_segment=1024)
    got = _assert_routes_identical(3, _materialize_faulted(wire, plan))
    assert len(got["errors"]) == 1 and got["errors"][0][0] == "ProtocolError"


def test_pump_parity_truncation_checkpoint():
    """A truncated stream ends every route at the same checkpoint (the
    resume point a reconnect pays back to), with the same mid-frame
    error."""
    wire = _build_wire(5)
    plan = FaultPlan(seed=2, truncate_at=(len(wire) * 2) // 3)
    got = _assert_routes_identical(5, _materialize_faulted(wire, plan))
    assert got["final"][1] and got["checkpoint"][0] < len(wire)


def test_pump_parity_resume_exactly_once():
    """Truncate mid-wire, then resume from the checkpoint through the
    batched reader: the reassembled session equals an unfaulted Python
    pump run and the JAX package's, every change, blob byte and digest
    once."""
    wire = _build_wire(7)
    clean = _run_route("python", [wire])
    assert clean["final"][0] and not clean["final"][1]
    assert _run_route("jax", [wire])["digests"] == clean["digests"]

    cut = (len(wire) * 3) // 5
    dec = _decoder("native")
    out = _observe(dec)

    def feed_conn(payload: bytes) -> None:
        a, b = socket.socketpair()
        try:
            t = threading.Thread(
                target=lambda: (a.sendall(payload),
                                a.shutdown(socket.SHUT_WR)),
                daemon=True)
            t.start()
            # a reconnecting transport: EOF here is a lost connection,
            # not the session's end (the caller, not the pump, ends it)
            rd = pump.pump_reader(b.fileno())
            while True:
                d = rd(65536)
                if not d:
                    break
                dec.write(d)
            t.join(10)
        finally:
            a.close()
            b.close()

    feed_conn(wire[:cut])
    ck = dec.checkpoint(emit_event=False)
    assert 0 < ck.wire_offset <= cut
    feed_conn(wire[ck.wire_offset:])  # the sender replays from there
    dec.end()
    assert dec.finished and not dec.destroyed
    for field in ("changes", "blobs", "digests"):
        assert out[field] == clean[field], field


def test_pump_parity_resegmented_batch_frames():
    """Re-segmentation across columnar batch frames: the same wire split
    at adversarial edges (a 1-byte tail, mid-header, mid-column) gives
    one session on every route."""
    wire = _build_wire(9)  # odd seed: ChangeBatch frames
    for trial in range(6):
        rng = random.Random(trial)
        segments = []
        i = 0
        while i < len(wire):
            step = rng.choice([1, 2, 3, 17, 1024, 65536, 1 << 20])
            segments.append(wire[i:i + step])
            i += step
        _assert_routes_identical(900 + trial, segments)
