"""The port's resumable receive driver against the JAX package's.

``run_resumable`` drives the port's CPU ``Decoder`` and the JAX
``Decoder`` (its streaming scanner, ``DAT_NATIVE_DISABLE=1``) over the
same journaled wire under the same ``FaultPlan.for_sweep`` plans: both
must make the same attempts and reconnects and deliver the same rows and
blobs, or raise the same structured error (message, frame, offset and
cause type) on a flipped header byte, on retries exhausted, on an app
stall and on a checkpoint behind the journal.  The port's CPU
``CudaDecoder`` must deliver ``hashlib``'s digests in order, once each,
across reconnects, and an application handler's own ``OSError`` must end
the session rather than be resumed.
"""

import hashlib

import numpy as np
import pytest

import dat_replication_protocol_tpu as jax_protocol
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu.session import faults as jfaults
from dat_replication_protocol_tpu.session import reconnect as jreconnect
from dat_replication_protocol_tpu.session import resume as jresume
from dat_replication_protocol_tpu.wire import framing as jframing
from dat_replication_protocol_tpu_torch.session import faults as pfaults
from dat_replication_protocol_tpu_torch.session import reconnect as preconnect
from dat_replication_protocol_tpu_torch.session import resume as presume
from dat_replication_protocol_tpu_torch.wire import framing as pframing
from dat_replication_protocol_tpu_torch.wire.framing import iter_frames

SIDES = {
    "port": (protocol, pfaults, preconnect, presume, pframing),
    "jax": (jax_protocol, jfaults, jreconnect, jresume, jframing),
}


@pytest.fixture(autouse=True)
def _streaming_scanner(monkeypatch):
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")


def _wire(seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    e = protocol.encode()
    for i in range(60):
        e.change({"key": f"k{i:03d}", "change": i, "from": 0, "to": 1,
                  "value": rng.bytes(int(rng.integers(1, 80)))})
        if i % 20 == 7:
            e.blob(1500).end(rng.bytes(1500))
    e.finalize()
    out = bytearray()
    while (c := e.read(4096)) is not None:
        out += c
    return bytes(out)


WIRE = _wire()


def _plan_kw(seed: int, attempt: int) -> dict:
    plan = pfaults.FaultPlan.for_sweep(seed, len(WIRE), attempt)
    return {f: getattr(plan, f) for f in plan.__dataclass_fields__}


def _drive(side: str, plans, *, decoder=None, policy_kw=None, journal=None,
           hold=False, stall_timeout=None, handler=None):
    """One ``run_resumable`` over ``WIRE`` (or ``journal``) with
    ``plans(attempt) -> FaultPlan kwargs``; returns the outcome."""
    p, faults, reconnect, resume, framing = SIDES[side]
    if journal is None:
        journal = resume.WireJournal()
        journal.append(WIRE)
    dec = decoder if decoder is not None else p.decode()
    got = []

    def on_change(c, done):
        if handler is not None:
            handler(c)
        got.append(("change", c.key, c.change, bytes(c.value)))
        if not hold:
            done()

    def on_blob(b, done):
        b.collect(lambda data: (got.append(("blob", bytes(data))), done()))

    dec.change(on_change)
    dec.blob(on_blob)

    def source(ckpt, failures):
        plan = faults.FaultPlan(**plans(failures))
        return faults.FaultyReader(
            faults.bytes_reader(journal.read_from(ckpt.wire_offset)), plan,
            sleep=lambda s: None)

    policy = reconnect.BackoffPolicy(**{"base": 0.0, "seed": 1,
                                        **(policy_kw or {})})
    try:
        stats = reconnect.run_resumable(
            source, dec, policy, expected_total=len(WIRE),
            stall_timeout=stall_timeout, wait_step=0.02)
    except framing.ProtocolError as e:
        return {"error": (type(e).__name__, str(e), e.frame, e.offset,
                          type(e.cause).__name__), "got": got}
    return {"stats": {k: stats[k] for k in ("attempts", "reconnects")},
            "faults": len(stats["faults"]), "got": got,
            "finished": dec.finished}


def _clean():
    return _drive("port", lambda a: {})["got"]


@pytest.mark.parametrize("seed", range(24))
def test_sweep_plans_deliver_the_same_session(seed):
    out = _drive("port", lambda a: _plan_kw(seed, a))
    assert out == _drive("jax", lambda a: _plan_kw(seed, a))
    assert out["finished"] and out["got"] == _clean()
    assert out["stats"]["reconnects"] == out["faults"]


def _type_byte(k: int) -> int:
    """The wire offset of frame ``k``'s type-id byte."""
    for i, (start, _tid, p0, _end) in enumerate(iter_frames(WIRE)):
        if i == k:
            return p0 - 1
    raise AssertionError(k)


@pytest.mark.parametrize("k", [0, 9, 40])
def test_flip_ends_in_the_same_structured_error(k):
    at = _type_byte(k)
    plans = lambda a: {"flip_at": at, "flip_mask": 0x40,  # noqa: E731
                       "max_segment": 64, "seed": k}
    out = _drive("port", plans)
    assert out == _drive("jax", plans)
    name, msg, frame, offset, _cause = out["error"]
    assert name == "ProtocolError" and "unknown type" in msg
    # the error is raised at the write that held the byte: its offset is
    # the bytes accepted so far, within one segment of the flip
    assert frame == k and at < offset <= at + 64
    # nothing past the flipped frame was delivered
    assert out["got"] == _clean()[:len(out["got"])]


def test_retries_exhausted_is_the_same_error():
    plans = lambda a: {"drop_at": 100, "seed": a}  # noqa: E731
    out = _drive("port", plans, policy_kw={"max_retries": 2})
    assert out == _drive("jax", plans, policy_kw={"max_retries": 2})
    name, msg, _frame, offset, cause = out["error"]
    assert msg.startswith("session lost after 3 transport fault(s)")
    assert cause == "TransportFault" and offset == 300


def test_app_stall_is_the_same_error():
    out = _drive("port", lambda a: {}, hold=True, stall_timeout=0.1)
    assert out == _drive("jax", lambda a: {}, hold=True, stall_timeout=0.1)
    assert out["error"][1].startswith("app stalled: no ack for 0.1s")
    assert len(out["got"]) == 1


def test_checkpoint_behind_the_journal_is_the_same_error():
    outs = {}
    for side in SIDES:
        journal = SIDES[side][3].WireJournal()
        journal.append(WIRE)

        def plans(attempt, j=journal):
            if attempt == 1:
                j.ack(800)  # the sender trimmed past the receiver
            return {"drop_at": 500} if attempt == 0 else {}

        outs[side] = _drive(side, plans, journal=journal)
    assert outs["port"] == outs["jax"]
    name, msg, _frame, offset, _cause = outs["port"]["error"]
    assert name == "ResumeError" and offset == 500
    assert "[800, " in msg


@pytest.mark.parametrize("seed", range(8))
def test_cuda_decoder_digests_across_reconnects_equal_hashlib(seed):
    want = []
    seqs = {"change": 0, "blob": 0}
    mv = memoryview(WIRE)
    for _s, tid, p0, end in iter_frames(WIRE):
        kind = "change" if tid == pframing.TYPE_CHANGE else "blob"
        want.append((kind, seqs[kind],
                     hashlib.blake2b(mv[p0:end], digest_size=32).digest()))
        seqs[kind] += 1
    dec = protocol.decode(backend="cuda", device="cpu")
    digests = []
    dec.on_digest(lambda kind, seq, d: digests.append((kind, seq, d)))
    out = _drive("port", lambda a: _plan_kw(seed, a), decoder=dec)
    assert out["finished"] and out["got"] == _clean()
    assert digests == want
    assert dec.checkpoint().digest == {"change_seq": 60, "blob_seq": 3}


def test_app_handler_oserror_is_not_resumed():
    calls = []

    def handler(c):
        calls.append(c.key)
        if len(calls) == 5:
            raise OSError(28, "No space left on device")

    for side in SIDES:
        calls.clear()
        with pytest.raises(OSError, match="No space left"):
            _drive(side, lambda a: {"max_segment": 50}, handler=handler)
        assert len(calls) == 5  # one attempt, no reconnect re-delivery


# -- the reconcile initiator's journal -------------------------------------------


def _initiator_session(side: str, journal) -> bytes:
    """One initiator session against a responder of the same package
    over a socketpair, the initiator's outgoing bytes counted; returns
    them."""
    import socket
    import threading

    from dat_replication_protocol_tpu.runtime import reconcile_driver as J
    from dat_replication_protocol_tpu_torch.runtime import (
        reconcile_driver as P)

    recs = [{"key": f"r{i:04d}", "change": i, "from": 0, "to": 1,
             "value": bytes([i % 251]) * 20} for i in range(300)]
    drv = P if side == "port" else J
    kw = {"device": "cpu"} if side == "port" else {}
    a = drv.RatelessReplica(recs[:290], **kw)
    b = drv.RatelessReplica(recs[5:], **kw)
    s1, s2 = socket.socketpair()
    s1.settimeout(30)
    s2.settimeout(30)
    t = threading.Thread(target=lambda: drv.run_responder(
        b, s2.recv, s2.sendall, lambda: s2.shutdown(socket.SHUT_WR)),
        daemon=True)
    t.start()
    sent = bytearray()

    def wr(d):
        sent.extend(d)
        s1.sendall(d)

    ikw = {} if side == "port" else {"engine": "host"}
    res = drv.run_initiator(a, s1.recv, wr,
                            lambda: s1.shutdown(socket.SHUT_WR),
                            journal=journal, **ikw)
    t.join(30)
    assert not t.is_alive() and res["ok"]
    s1.close()
    s2.close()
    return bytes(sent)


def test_run_initiator_journal_holds_the_outgoing_wire():
    journals = {side: SIDES[side][3].WireJournal() for side in SIDES}
    sent = {side: _initiator_session(side, journals[side])
            for side in SIDES}
    for side in SIDES:
        j = journals[side]
        assert (j.start, j.end) == (0, len(sent[side]))
        assert j.read_from(0) == sent[side]
    # the symbol stream is the same in both packages (the record frames
    # that follow differ by the encoding of absent optionals)
    frames = {side: [(tid, sent[side][p0:end])
                     for _s, tid, p0, end in iter_frames(sent[side])
                     if tid == pframing.TYPE_RECONCILE]
              for side in SIDES}
    assert frames["port"] == frames["jax"] and len(frames["port"]) >= 2


@pytest.mark.parametrize("seed", range(4))
def test_journaled_symbol_stream_resumes_into_a_fresh_decoder(seed):
    wire = _initiator_session("port", presume.WireJournal())
    journal = presume.WireJournal()
    journal.append(wire)
    frames = []
    dec = protocol.Decoder()
    dec.reconcile(lambda msg, done: (frames.append(msg.kind), done()))
    stats = preconnect.run_resumable(
        lambda ck, f: pfaults.FaultyReader(
            pfaults.bytes_reader(journal.read_from(ck.wire_offset)),
            pfaults.FaultPlan.for_sweep(seed, len(wire), f),
            sleep=lambda s: None),
        dec, preconnect.BackoffPolicy(base=0.0, seed=seed),
        expected_total=len(wire))
    assert dec.finished and dec.bytes == len(wire)
    want = [tid for _s, tid, _p, _e in iter_frames(wire)
            if tid == pframing.TYPE_RECONCILE]
    assert len(frames) == len(want)
    assert stats["attempts"] == 1 + stats["reconnects"]


def test_a_flip_never_delivers_a_wrong_digest():
    """A flipped type byte ends a ``CudaDecoder`` session in one
    ``ProtocolError``; with a one-item pipeline the digests delivered
    before it are ``hashlib``'s, in order: a prefix, none wrong."""
    from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
        DigestPipeline)

    want = []
    seqs = {"change": 0, "blob": 0}
    for _s, tid, p0, end in iter_frames(WIRE):
        kind = "change" if tid == pframing.TYPE_CHANGE else "blob"
        want.append((kind, seqs[kind],
                     hashlib.blake2b(WIRE[p0:end], digest_size=32).digest()))
        seqs[kind] += 1
    at = _type_byte(40)
    dec = protocol.decode(backend="cuda", pipeline=DigestPipeline(
        device="cpu", max_batch=1, max_inflight=1))
    got = []
    dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
    out = _drive("port", lambda a: {"flip_at": at, "flip_mask": 0x40},
                 decoder=dec)
    assert out["error"][0] == "ProtocolError" and out["error"][2] == 40
    assert 30 <= len(got) < 40 and got == want[:len(got)]
