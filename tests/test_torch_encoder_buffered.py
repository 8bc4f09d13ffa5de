"""``Encoder.buffered_bytes`` and ``wire.uvarint_length`` against the JAX
package's.

One seeded script of writes (changes, blobs written in pieces, changes
parked behind an open blob, a finalize) and reads of random sizes runs
on both packages' encoders with a 512-byte high-water mark, so the
buffer crosses the mark both ways; ``buffered_bytes``, ``writable()``
and the bytes read must be equal after every step.  ``uvarint_length``
must equal the JAX function's at every 7-bit boundary +- 1 from 0 to
2^64 - 1.  All comparisons are exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from dat_replication_protocol_tpu import session as jax_session
from dat_replication_protocol_tpu import wire as jax_wire
from dat_replication_protocol_tpu.wire import varint as jax_varint
from dat_replication_protocol_tpu_torch import session, wire
from dat_replication_protocol_tpu_torch.wire import varint

HIGH_WATER = 512


def _script(seed: int) -> list[tuple]:
    """Steps: ("change", n), ("blob", [pieces]), ("read", n), ("finalize",)."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(60):
        r = rng.random()
        if r < 0.45:
            steps.append(("change", int(rng.integers(0, 300))))
        elif r < 0.6:
            pieces = [int(x) for x in rng.integers(1, 400,
                                                   int(rng.integers(1, 4)))]
            steps.append(("blob", pieces))
        else:
            steps.append(("read", int(rng.integers(1, 700))))
    steps.append(("finalize",))
    steps.append(("read", -1))
    return steps


def _play(enc, steps) -> list[tuple]:
    """Run ``steps`` on ``enc``; after each, what a producer sees."""
    seen = []
    blob = None
    for i, step in enumerate(steps):
        kind = step[0]
        if kind == "change":
            enc.change({"key": f"k{i}", "change": i, "from": 0, "to": 1,
                        "value": bytes([i & 255]) * step[1]})
        elif kind == "blob":
            pieces = step[1]
            blob = enc.blob(sum(pieces))
            for k, n in enumerate(pieces):
                blob.write(bytes([k]) * n)
                # a change written while the blob is open parks behind it
                enc.change({"key": f"p{i}.{k}", "change": k, "from": 0,
                            "to": 1, "value": b"x" * 40})
                seen.append(("piece", enc.buffered_bytes, enc.writable()))
            blob.end()
        elif kind == "read":
            data = enc.read(step[1])
            seen.append(("read", None if data is None else bytes(data)))
        else:
            enc.finalize()
        seen.append((kind, enc.buffered_bytes, enc.writable()))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_buffered_bytes_follows_the_jax_encoder(seed):
    steps = _script(seed)
    want = _play(jax_session.Encoder(high_water=HIGH_WATER), steps)
    got = _play(session.Encoder(high_water=HIGH_WATER), steps)
    assert got == want
    levels = [s[1] for s in got if s[0] != "read"]
    # the script crosses the mark both ways and drains to nothing
    assert max(levels) >= HIGH_WATER and min(levels) < HIGH_WATER
    assert got[-1][1] == 0


def _boundaries() -> list[int]:
    out = set()
    for k in range(0, 65, 7):
        for v in ((1 << k) - 1, 1 << k, (1 << k) + 1):
            if 0 <= v < 1 << 64:
                out.add(v)
    return sorted(out | {0, 1, (1 << 64) - 1})


def test_uvarint_length_equals_the_jax_function_at_every_boundary():
    values = _boundaries()
    assert values[0] == 0 and values[-1] == (1 << 64) - 1
    for v in values:
        n = varint.uvarint_length(v)
        assert n == jax_varint.uvarint_length(v), v
        assert n == len(varint.encode_uvarint(v)), v


def test_uvarint_length_is_exported_from_wire_as_in_the_jax_package():
    assert wire.uvarint_length is varint.uvarint_length
    assert "uvarint_length" in wire.__all__
    assert "uvarint_length" in jax_wire.__all__
