"""The port's ``ChangeBatch`` codec against the JAX package's.

The codec cases of ``tests/test_change_batch.py`` as parametrised cases,
each fed numpy-seeded rows: ``encode_rows`` and ``encode_columns`` must
give the JAX package's payload bytes, and ``decode_change_batch`` its
columns, field by field (``weights.columns_to_numpy``) — exact equality,
no tolerance.  Every structural corruption must raise the same error
class with the same message in both packages.
"""

import numpy as np
import pytest

from dat_replication_protocol_tpu.runtime import replay as jax_replay
from dat_replication_protocol_tpu.wire import batch_codec as jax_codec
from dat_replication_protocol_tpu.wire.varint import encode_uvarint
from dat_replication_protocol_tpu_torch import weights
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.wire import batch_codec
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    encode_change,
)
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_CHANGE,
    frame,
)


def _rows(n, seed, keyspace=16, value_max=13, key_pad=0, absent=True):
    """Prepared row tuples: keys from a keyspace, optional values and
    subsets absent, present-empty or present."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = int(rng.integers(0, keyspace))
        value = rng.bytes(int(rng.integers(0, value_max + 1)))
        sub = (b"s%d" % (i % 3)) if i % 4 else b""
        rows.append((b"key-%05d" % k + b"x" * key_pad,
                     int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1000)),
                     int(rng.integers(0, 1 << 20)),
                     None if absent and i % 5 == 0 else value,
                     None if absent and i % 3 == 0 else sub))
    return rows


def _columns_equal(got, want):
    a, b = weights.columns_to_numpy(got), weights.columns_to_numpy(want)
    for name in a:
        assert np.array_equal(a[name], b[name]), name


CASES = {
    "rows": lambda: _rows(500, 1),
    "absent-vs-present-empty": lambda: [
        (b"a", 1, 0, 1, None, None), (b"a", 2, 1, 2, b"", b"")],
    "no-optionals": lambda: [(b"k%d" % i, i, 0, 1, None, None)
                             for i in range(40)],
    "all-present": lambda: _rows(40, 2, absent=False),
    "key-index-2-bytes": lambda: _rows(300, 3, keyspace=300),
    "key-index-at-255": lambda: [(b"k%03d" % i, i, 0, 1, None, None)
                                 for i in range(255)],
    "key-index-at-256": lambda: [(b"k%03d" % i, i, 0, 1, None, None)
                                 for i in range(256)],
    "key-index-4-bytes": lambda: [(b"k%05d" % i, i, 0, 1, b"v", None)
                                  for i in range(65536)],
    "value-length-2-bytes": lambda: _rows(20, 4, value_max=300),
    "value-length-at-254": lambda: [(b"k", 1, 0, 1, b"x" * 254, None)],
    "value-length-at-255": lambda: [(b"k", 1, 0, 1, b"x" * 255, None)],
    "value-length-4-bytes": lambda: [(b"k", 1, 0, 1, b"x" * 70000, b"s")],
    "dict-length-2-bytes": lambda: _rows(30, 5, key_pad=300),
    "multibyte-utf8": lambda: [(("clé-%d" % i).encode(), i, 0, 1, b"v",
                                "ß".encode()) for i in range(3)],
    "empty": lambda: [],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_rows_and_decode_match_jax(case):
    rows = CASES[case]()
    payload = batch_codec.encode_rows(rows)
    assert payload == jax_codec.encode_rows(rows)
    got = batch_codec.decode_change_batch(payload)
    _columns_equal(got, jax_codec.decode_change_batch(payload))
    assert len(got) == len(rows)
    for i in range(0, len(rows), max(1, len(rows) // 50)):
        key, cg, fr, to, val, sub = rows[i]
        c = got.row(i)
        assert (c.key.encode(), c.change, c.from_, c.to, c.value,
                c.subset.encode()) == (key, cg, fr, to, val or b"", sub or b"")
        assert (got.val_len[i] < 0) == (val is None)
        assert (got.sub_len[i] < 0) == (sub is None)


def test_width_ladder_edges_pick_the_jax_widths():
    cases = {"key-index-at-255": 1, "key-index-at-256": 2,
             "key-index-4-bytes": 4}
    for case, kw in cases.items():
        assert batch_codec.encode_rows(CASES[case]())[1] == kw, case
    assert batch_codec.encode_rows(CASES["value-length-at-254"]())[3] == 1
    assert batch_codec.encode_rows(CASES["value-length-at-255"]())[3] == 2
    assert batch_codec.encode_rows(CASES["value-length-4-bytes"]())[3] == 4
    assert batch_codec.encode_rows(CASES["dict-length-2-bytes"]())[4] == 2
    assert batch_codec.encode_rows(CASES["no-optionals"]())[2:4] == b"\0\0"


@pytest.mark.parametrize("seed,keyspace", [(10, 4), (11, 40), (12, 3000)])
def test_encode_columns_matches_jax_and_encode_rows(seed, keyspace):
    """The bulk path over replayed columns: the JAX package's bytes (its
    native encoder), and those of ``encode_rows`` of the same rows."""
    rows = _rows(700, seed, keyspace=keyspace, value_max=40)
    wire = b"".join(frame(TYPE_CHANGE, encode_change({
        "key": k.decode(), "change": c, "from": f, "to": t, "value": v,
        "subset": None if s is None else s.decode()}))
        for k, c, f, t, v, s in rows)
    buf = np.frombuffer(wire, np.uint8)
    cols, _ = replay.replay_log(buf)
    jcols, _ = jax_replay.replay_log(buf)
    payload = batch_codec.encode_columns(cols)
    assert payload == jax_codec.encode_columns(jcols)
    assert payload == batch_codec.encode_rows(rows)
    # a row range of the shared buffer, as encode_batch_frames slices it
    part = replay._slice_columns(cols, 123, 456)
    assert batch_codec.encode_columns(part) \
        == jax_codec.encode_columns(jax_replay._slice_columns(jcols, 123, 456))


@pytest.mark.parametrize("base", [0, 17])
def test_decode_with_base_addresses_the_enclosing_buffer(base):
    payload = batch_codec.encode_rows(_rows(60, 6))
    log = np.frombuffer(bytes(range(base)) + payload, np.uint8)
    got = batch_codec.decode_change_batch(log[base:], base=base, buf=log)
    want = jax_codec.decode_change_batch(log[base:], base=base, buf=log)
    _columns_equal(got, want)
    assert got.buf is log


def _corrupt(name):
    rows = _rows(40, 7)
    payload = bytearray(batch_codec.encode_rows(rows))
    one = bytearray(batch_codec.encode_rows([(b"only", 1, 0, 1, None, None)]))
    if name == "version":
        payload[0] = 99
    elif name == "key-width":
        payload[1] = 3
    elif name == "subset-width":
        payload[2] = 5
    elif name == "dict-width":
        payload[4] = 0
    elif name == "truncated":
        del payload[-3:]
    elif name == "trailing":
        payload += b"xx"
    elif name == "short-header":
        del payload[8:]
    elif name == "header-varint":
        payload = bytearray(payload[:5] + b"\xff" * 9)
    elif name == "key-index-range":
        one[-1] = 7  # the single row's key index (1 key -> must be 0)
        payload = one
    elif name == "subset-index-range":
        two = bytearray(batch_codec.encode_rows(
            [(b"k", 1, 0, 1, None, b"s"), (b"k", 2, 0, 1, None, None)]))
        two[-2] = 5  # row 0's subset index (1 subset)
        payload = two
    elif name == "no-keys":
        payload = bytearray(batch_codec.encode_rows([]))
        payload[5] = 1  # one row, no dictionary
    elif name == "heap-mismatch":
        rows = [(b"k", 1, 0, 1, b"abc", None)]
        payload = bytearray(batch_codec.encode_rows(rows))
        payload[8] = 2  # header's value heap length
    elif name == "non-utf8-key":
        payload = bytearray(batch_codec.encode_rows(
            [(b"ab", 1, 0, 1, None, None)]))
        payload[bytes(payload).index(b"ab")] = 0xFF
    elif name == "split-multibyte-key":
        payload = bytearray(batch_codec.encode_rows(
            [(b"a\xc3", 1, 0, 1, None, None), (b"\xa9b", 2, 1, 2, None,
                                                None)]))
    elif name == "split-multibyte-subset":
        payload = bytearray(batch_codec.encode_rows(
            [(b"k", 1, 0, 1, None, b"a\xc3"), (b"k", 2, 1, 2, None,
                                                b"\xa9b")]))
    elif name == "non-utf8-subset":
        payload = bytearray(batch_codec.encode_rows(
            [(b"k", 1, 0, 1, None, b"\xed\xa0\x80")]))
    return bytes(payload)


@pytest.mark.parametrize("name", [
    "version", "key-width", "subset-width", "dict-width", "truncated",
    "trailing", "short-header", "header-varint", "key-index-range",
    "subset-index-range", "no-keys", "heap-mismatch", "non-utf8-key",
    "split-multibyte-key", "split-multibyte-subset", "non-utf8-subset"])
def test_structural_corruption_raises_as_jax(name):
    payload = _corrupt(name)
    with pytest.raises(ValueError) as want:
        jax_codec.decode_change_batch(payload)
    with pytest.raises(ValueError) as got:
        batch_codec.decode_change_batch(payload)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(4))
def test_flipped_bytes_decode_or_fail_as_jax(seed):
    rng = np.random.default_rng(100 + seed)
    payload = bytearray(batch_codec.encode_rows(_rows(80, seed, value_max=30)))
    for _ in range(60):
        bad = bytearray(payload)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        try:
            want = jax_codec.decode_change_batch(bytes(bad))
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                batch_codec.decode_change_batch(bytes(bad))
            assert str(got.value) == str(e)
            continue
        _columns_equal(batch_codec.decode_change_batch(bytes(bad)), want)


def test_estimate_per_record_bytes_matches_jax_and_the_wire():
    rows = _rows(300, 8, value_max=200)
    cols = batch_codec.decode_change_batch(batch_codec.encode_rows(rows))
    args = (cols.key_len, cols.sub_len, cols.val_len, cols.change,
            cols.from_, cols.to)
    per_record = replay.encode_change_columns(cols)
    assert batch_codec.estimate_per_record_bytes(*args) == len(per_record)
    assert jax_codec.estimate_per_record_bytes(*args) == len(per_record)
    sizes = np.array([0, 1, 127, 128, 16383, 16384, (1 << 32) - 1,
                      (1 << 63), (1 << 64) - 1], dtype=np.uint64)
    want = [len(encode_uvarint(int(v))) for v in sizes]
    assert batch_codec.uvarint_sizes(sizes).tolist() == want


def test_ragged_copy_moves_extents_across_steps(monkeypatch):
    rng = np.random.default_rng(9)
    src = rng.integers(0, 256, 5000, dtype=np.uint8)
    lens = rng.integers(0, 60, 200)
    offs = rng.integers(0, 5000 - 60, 200)
    want = b"".join(src[o:o + n].tobytes() for o, n in zip(offs, lens))
    for chunk in (1, 7, 1 << 23):
        monkeypatch.setattr(batch_codec, "_GATHER_CHUNK", chunk)
        assert batch_codec.ragged_gather(src, offs, lens).tobytes() == want
