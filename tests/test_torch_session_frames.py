"""Reconcile and snapshot frames through the port's session layer,
against the JAX package's.

``Encoder.reconcile_frame``/``snapshot_frame`` must give the JAX
encoder's wire with the capability bit, and raise without it (leaving the
reference wire byte for byte); the port's decoder must deliver the JAX
wire's messages to its ``reconcile``/``snapshot`` handlers, count each as
one frame, and drop them without a handler, as the JAX decoder does.
"""

import numpy as np
import pytest

from dat_replication_protocol_tpu.session.decoder import Decoder as JaxDecoder
from dat_replication_protocol_tpu.session.encoder import Encoder as JaxEncoder
from dat_replication_protocol_tpu.wire import reconcile_codec as jrc
from dat_replication_protocol_tpu_torch.session.decoder import Decoder
from dat_replication_protocol_tpu_torch.session.encoder import (
    Encoder, EncoderDestroyedError)
from dat_replication_protocol_tpu_torch.wire import reconcile_codec as rc
from dat_replication_protocol_tpu_torch.wire import snapshot_codec as sn
from dat_replication_protocol_tpu_torch.wire.framing import (
    CAP_CHANGE_BATCH, CAP_RECONCILE, CAP_SNAPSHOT, TYPE_RECONCILE,
    TYPE_SNAPSHOT, ProtocolError, frame, iter_frames)

ALL = CAP_CHANGE_BATCH | CAP_RECONCILE | CAP_SNAPSHOT


def _change(i):
    return {"key": f"k{i}", "change": i, "from": 0, "to": 1,
            "value": bytes([i % 256]) * (i % 9), "subset": None}


def _payloads():
    rng = np.random.default_rng(7)
    cells = rng.integers(0, 1 << 32, (3, 11), dtype=np.uint64).astype(
        np.uint32)
    wcells = rng.integers(0, 1 << 32, (2, 12), dtype=np.uint64).astype(
        np.uint32)
    return {
        "rc": [rc.encode_begin(1000), rc.encode_symbols(0, cells),
               rc.encode_more(3), rc.encode_fail(3, "x")],
        "sn": [sn.encode_want_all(), sn.encode_symbols(0, wcells),
               sn.encode_chunks([(bytes(32), b"abc" * 500)]),
               sn.encode_done(2, np.arange(5))],
    }


def _script(enc, caps_ok=True):
    """The same submissions on either package's encoder."""
    p = _payloads()
    enc.change(_change(0))
    enc.reconcile_frame(p["rc"][0])
    enc.change_many([_change(i) for i in range(1, 6)])
    for x in p["rc"][1:]:
        enc.reconcile_frame(x)
    b = enc.blob(4)
    b.end(b"blob")
    for x in p["sn"]:
        enc.snapshot_frame(x)
    enc.change(_change(9))
    enc.finalize()


def _drain(enc) -> bytes:
    out = bytearray()
    while (chunk := enc.read()) is not None:
        out += chunk
    return bytes(out)


def test_negotiated_frames_give_the_jax_wire():
    port, jax = Encoder(peer_caps=ALL), JaxEncoder(peer_caps=ALL)
    _script(port)
    _script(jax)
    wire = _drain(port)
    assert wire == _drain(jax)
    types = [t for _s, t, _p, _e in iter_frames(wire)]
    assert types.count(TYPE_RECONCILE) == 4
    assert types.count(TYPE_SNAPSHOT) == 4


@pytest.mark.parametrize("method,cap", [("reconcile_frame", CAP_RECONCILE),
                                        ("snapshot_frame", CAP_SNAPSHOT)])
@pytest.mark.parametrize("caps", [0, CAP_CHANGE_BATCH])
def test_without_the_cap_bit_nothing_reaches_the_wire(method, cap, caps):
    encs = [Encoder(peer_caps=caps), JaxEncoder(peer_caps=caps)]
    for enc in encs:
        enc.change(_change(1))
        with pytest.raises(ValueError, match="did not advertise"):
            getattr(enc, method)(b"\x03\x00")
        enc.change(_change(2))
        enc.finalize()
    port, jax = (_drain(e) for e in encs)
    assert port == jax
    assert TYPE_RECONCILE not in [t for _s, t, _p, _e in iter_frames(port)]


@pytest.mark.parametrize("method", ["reconcile_frame", "snapshot_frame"])
def test_control_frames_refuse_an_open_blob_and_a_closed_encoder(method):
    enc = Encoder(peer_caps=ALL)
    enc.blob(3)
    with pytest.raises(ValueError, match="blob open"):
        getattr(enc, method)(b"\x03\x00")
    done = Encoder(peer_caps=ALL)
    done.finalize()
    with pytest.raises(EncoderDestroyedError, match="after finalize"):
        getattr(done, method)(b"\x03\x00")
    gone = Encoder(peer_caps=ALL)
    gone.destroy()
    with pytest.raises(EncoderDestroyedError, match="after destroy"):
        getattr(gone, method)(b"\x03\x00")


def _jax_wire():
    enc = JaxEncoder(peer_caps=ALL)
    _script(enc)
    return _drain(enc)


def _collect(dec, handlers=True):
    got = []
    if handlers:
        dec.reconcile(lambda m, done: (got.append(("rc", m.kind, m.n)),
                                       done()))
        dec.snapshot(lambda m, done: (got.append(("sn", m.kind, m.mode,
                                                  m.n)), done()))
    dec.change(lambda c, done: (got.append(("ch", c.key)), done()))
    dec.blob(lambda b, done: b.collect(lambda d: (got.append(("blob", d)),
                                                  done())))
    return got


@pytest.mark.parametrize("step", [None, 1, 7, 4096])
@pytest.mark.parametrize("handlers", [True, False])
def test_the_decoder_delivers_and_counts_the_jax_wire(step, handlers):
    wire = _jax_wire()
    port, jax = Decoder(), JaxDecoder()
    got, want = _collect(port, handlers), _collect(jax, handlers)
    for dec in (port, jax):
        if step is None:
            dec.write(wire)
        else:
            for at in range(0, len(wire), step):
                dec.write(wire[at:at + step])
        dec.end()
        assert dec.finished and not dec.destroyed
    assert got == want
    assert port._frames_delivered() == jax._frames_delivered() \
        == len(list(iter_frames(wire)))
    assert (port.reconcile_frames, port.snapshot_frames) \
        == (jax.reconcile_frames, jax.snapshot_frames) == (4, 4)
    if not handlers:
        assert all(g[0] in ("ch", "blob") for g in got)


def test_an_async_done_holds_the_next_frame():
    wire = frame(TYPE_RECONCILE, rc.encode_more(1)) + frame(
        TYPE_RECONCILE, rc.encode_more(2))
    dec = Decoder()
    held = []
    dec.reconcile(lambda m, done: held.append((m.n, done)))
    assert dec.write(wire) is False
    assert [n for n, _ in held] == [1]
    held[0][1]()
    assert [n for n, _ in held] == [1, 2]


def test_a_corrupt_frame_after_good_ones_names_its_frame_as_jax_does():
    good = _jax_wire()
    bad = frame(TYPE_RECONCILE, b"\x09")  # unknown subtype
    errs = {}
    for name, cls in (("port", Decoder), ("jax", JaxDecoder)):
        dec = cls()
        errs[name] = []
        dec.on_error(errs[name].append)
        dec.write(good)
        dec.write(bad)
    (p,), (j,) = errs["port"], errs["jax"]
    assert isinstance(p, ProtocolError)
    assert (p.frame, p.offset, str(p)) == (j.frame, j.offset, str(j))
    assert isinstance(p.cause, ValueError)
    assert jrc.decode_reconcile(rc.encode_more(1)).n == 1
