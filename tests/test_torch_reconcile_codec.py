"""The port's TYPE_RECONCILE payload codec against the JAX package's.

Every message kind, made from a numpy seed, must encode to the JAX
encoder's bytes and decode, in both packages, to equal messages; every
truncation of a valid payload and a seeded set of bit flips must give
the same outcome in both decoders (the same ValueError message, or
equal messages), and through a session decoder the same
``ProtocolError``.  Byte-exact throughout.
"""

import numpy as np
import pytest

from dat_replication_protocol_tpu.session.decoder import Decoder as JaxDecoder
from dat_replication_protocol_tpu.wire import reconcile_codec as jrc
from dat_replication_protocol_tpu_torch.session.decoder import Decoder
from dat_replication_protocol_tpu_torch.wire import reconcile_codec as rc
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_RECONCILE, ProtocolError, frame)


def _cells(k, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (k, rc.SYMBOL_WORDS), dtype=np.uint64
                        ).astype(np.uint32)


def _digests(k, seed):
    return np.random.default_rng(seed).integers(0, 256, (k, 32),
                                                dtype=np.uint8)


MESSAGES = {
    "begin-0": lambda m: m.encode_begin(0),
    "begin-127": lambda m: m.encode_begin(127),
    "begin-128": lambda m: m.encode_begin(128),
    "begin-2^40": lambda m: m.encode_begin(1 << 40),
    "symbols-empty": lambda m: m.encode_symbols(0, _cells(0, 1)),
    "symbols-1": lambda m: m.encode_symbols(0, _cells(1, 2)),
    "symbols-5-at-300": lambda m: m.encode_symbols(300, _cells(5, 3)),
    "done-none": lambda m: m.encode_done(128, _digests(0, 4)),
    "done-3": lambda m: m.encode_done(1 << 20, _digests(3, 5)),
    "more": lambda m: m.encode_more(4096),
    "fail": lambda m: m.encode_fail(77, "no decode — après 77"),
    "fail-empty": lambda m: m.encode_fail(0, ""),
}


def _fields(msg) -> tuple:
    arr = lambda a: None if a is None else (a.shape, a.tobytes())  # noqa: E731
    return (msg.kind, msg.kind_name, msg.n, msg.start, arr(msg.cells),
            arr(msg.digests), msg.reason)


def _outcome(decode, payload):
    try:
        return ("ok", _fields(decode(payload)))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_every_message_encodes_to_the_jax_bytes_and_decodes_alike(name):
    payload = MESSAGES[name](rc)
    assert payload == MESSAGES[name](jrc)
    got, want = rc.decode_reconcile(payload), jrc.decode_reconcile(payload)
    assert _fields(got) == _fields(want)
    # and the decode round-trips
    assert _fields(rc.decode_reconcile(payload)) == _fields(got)


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_every_truncation_fails_where_jax_fails(name):
    payload = MESSAGES[name](rc)
    for cut in range(len(payload)):
        assert _outcome(rc.decode_reconcile, payload[:cut]) \
            == _outcome(jrc.decode_reconcile, payload[:cut]), cut


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_bit_flips_fail_where_jax_fails(name):
    payload = MESSAGES[name](rc)
    rng = np.random.default_rng(len(payload))
    for at in rng.integers(0, len(payload), 24).tolist() + [0]:
        for bit in (0, 3, 7):
            bad = bytearray(payload)
            bad[at] ^= 1 << bit
            assert _outcome(rc.decode_reconcile, bytes(bad)) \
                == _outcome(jrc.decode_reconcile, bytes(bad)), (at, bit)


def test_encoders_refuse_malformed_arrays_as_jax_does():
    for mod in (rc, jrc):
        with pytest.raises(ValueError, match="cells must be"):
            mod.encode_symbols(0, np.zeros((2, 10), np.uint32))
        with pytest.raises(ValueError, match="digests must be"):
            mod.encode_done(0, np.zeros((2, 31), np.uint8))


def _session_error(dec_cls, wire):
    dec = dec_cls()
    errs = []
    dec.reconcile(lambda msg, done: done())
    dec.on_error(errs.append)
    dec.write(wire)
    return errs


@pytest.mark.parametrize("name", ["begin-128", "symbols-5-at-300", "done-3",
                                  "fail"])
def test_a_torn_payload_is_one_protocol_error_in_both_decoders(name):
    payload = MESSAGES[name](rc)
    good = frame(TYPE_RECONCILE, MESSAGES["more"](rc))
    for cut in (1, len(payload) // 2, len(payload) - 1):
        bad = payload[:cut] if name != "fail" else b"\x04\x80"
        wire = good + frame(TYPE_RECONCILE, bad)
        got = _session_error(Decoder, wire)
        want = _session_error(JaxDecoder, wire)
        assert len(got) == len(want) == 1
        assert isinstance(got[0], ProtocolError)
        assert (got[0].frame, got[0].offset) == (want[0].frame,
                                                  want[0].offset) == (1, len(wire))
        assert str(got[0]) == str(want[0])
