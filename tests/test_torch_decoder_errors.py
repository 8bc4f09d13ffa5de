"""The port's decoder errors carry their cause, as the JAX decoder's do.

A change payload that does not decode, a ChangeBatch payload that does
not decode and a frame header whose varint runs past 64 bits each
destroy the session with a ``ProtocolError`` whose ``cause`` is the
``ValueError`` underneath, and whose message ends in ``cause=ValueError:
...``.  Each wire goes through the JAX ``Decoder`` (its Python path,
``DAT_NATIVE_DISABLE=1``) and the port's CPU ``Decoder`` with an
``on_error`` handler, at write sizes 1, 3 and whole; message, cause
type, frame and byte offset must agree.
"""

import pytest

from dat_replication_protocol_tpu.session.decoder import Decoder as JaxDecoder
from dat_replication_protocol_tpu_torch.session.decoder import Decoder

WIRES = {
    # a change frame whose payload uses protobuf wire type 4
    "change-wire-type": bytes([0x02, 0x01, 0x0C]),
    # a ChangeBatch frame with a short batch header
    "short-batch": bytes([0x03, 0x03, 0x01, 0x01]),
    # a header varint over 64 bits
    "varint-64": bytes([0xFF] * 9 + [0x7F, 0x01]),
}


def _feed(dec, wire: bytes, step: int) -> list:
    errors = []
    dec.on_error(errors.append)
    for off in range(0, len(wire), step):
        if dec.destroyed:
            break
        dec.write(wire[off:off + step])
    if not dec.destroyed:
        dec.end()
    return errors


@pytest.mark.parametrize("step", [1, 3, None], ids=["1", "3", "whole"])
@pytest.mark.parametrize("name", list(WIRES))
def test_errors_carry_the_cause_as_the_jax_decoder(name, step, monkeypatch):
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    wire = WIRES[name]
    step = step or len(wire)
    want = _feed(JaxDecoder(), wire, step)
    got = _feed(Decoder(), wire, step)
    assert len(want) == len(got) == 1
    w, g = want[0], got[0]
    assert str(g) == str(w)
    assert "cause=ValueError: " in str(g)
    assert type(g.cause) is type(w.cause) is ValueError
    assert str(g.cause) == str(w.cause)
    assert (g.frame, g.offset) == (w.frame, w.offset)
