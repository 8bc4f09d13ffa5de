"""The port's change-log replay against the JAX package's.

Numpy-seeded change logs go through both packages' ``runtime.replay``:
the frame index, the decoded columns (field by field through
``weights.columns_to_numpy``) and every encoder's bytes must be equal —
exact equality, no tolerance.  Per-record, batch and mixed wires all
replay to the same rows.  Corrupt logs must fail with the same
``ProtocolError`` message as the JAX package's pure-Python path (its
native engine skips the key UTF-8 check the per-record codec makes, so
the corrupt cases run it with ``DAT_NATIVE_DISABLE=1``), on the port's
field walk and on its per-record decode alike.
"""

import numpy as np
import pytest

from dat_replication_protocol_tpu.runtime import replay as jax_replay
from dat_replication_protocol_tpu_torch import weights
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.wire import batch_codec
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    Change,
    encode_change,
)
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_BLOB,
    TYPE_CHANGE,
    TYPE_CHANGE_BATCH,
    ProtocolError,
    frame,
)


def _records(n, seed, keyspace=64):
    """Seeded Change dicts: keys from a keyspace (some multibyte), uint32
    fields over their whole range, values and subsets absent,
    present-empty or present."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, keyspace))
        out.append({
            "key": f"key-{k:05d}" + ("é" if k % 7 == 0 else ""),
            "change": int(rng.integers(0, 1 << 32)),
            "from": int(rng.integers(0, 1 << 14)),
            "to": int(rng.integers(0, 1 << 32)),
            "value": (None if i % 5 == 0
                      else rng.bytes(int(rng.integers(0, 300)))),
            "subset": (None if i % 3 == 0
                       else "" if i % 11 == 0 else f"s{i % 4}"),
        })
    return out


def _wire(records) -> bytes:
    return b"".join(frame(TYPE_CHANGE, encode_change(r)) for r in records)


def _columns_equal(got, want):
    a, b = weights.columns_to_numpy(got), weights.columns_to_numpy(want)
    for name in a:
        assert np.array_equal(a[name], b[name]), name


def _index_equal(got, want):
    for name in ("starts", "lens", "ids"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.consumed == want.consumed


def _outcome(fn):
    """``("ok", result)`` or ``(error class name, message)``."""
    try:
        return "ok", fn()
    except ProtocolError as e:
        return type(e).__name__, str(e)
    except Exception as e:  # noqa: BLE001 - the JAX package's own classes
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", ["whole", "two-byte-headers", "empty",
                                  "truncated-tail", "zero-length",
                                  "long-varint", "ten-byte-varint"])
def test_split_frames_matches_jax(case, monkeypatch):
    # messages as the JAX package's Python splitter words them
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    wire = _wire(_records(40, 1)) + frame(TYPE_BLOB, b"x" * 300)
    data = {
        "whole": wire,
        "two-byte-headers": frame(TYPE_BLOB, b"y" * 5000) + wire,
        "empty": b"",
        "truncated-tail": wire + frame(TYPE_CHANGE, b"abcdef")[:-2],
        "zero-length": wire + b"\x00\x01",
        "long-varint": wire + b"\xff" * 12,
        "ten-byte-varint": wire + b"\xff" * 9 + b"\x02\x01",
    }[case]
    buf = np.frombuffer(data, np.uint8)
    for partial in (False, True):
        got = _outcome(lambda: replay.split_frames(buf, partial))
        want = _outcome(lambda: jax_replay.split_frames(buf, partial))
        assert got[0] == want[0]
        if got[0] == "ok":
            _index_equal(got[1], want[1])
        else:
            assert got == want


def test_truncated_tail_is_left_for_the_next_write():
    wire = _wire(_records(10, 2))
    idx = replay.split_frames(
        np.frombuffer(wire + b"\x05\x01ab", np.uint8), allow_partial_tail=True)
    assert len(idx) == 10 and idx.consumed == len(wire)
    with pytest.raises(ProtocolError, match="truncated frame at byte"):
        replay.split_frames(np.frombuffer(wire + b"\x05\x01ab", np.uint8))


@pytest.mark.parametrize("seed,n,walk_min", [(3, 2000, 64), (4, 500, 1),
                                             (5, 40, 64)])
def test_replay_per_record_wire_matches_jax(seed, n, walk_min, monkeypatch):
    monkeypatch.setattr(replay, "_WALK_MIN", walk_min)
    records = _records(n, seed)
    wire = _wire(records)
    buf = np.frombuffer(wire, np.uint8)
    cols, frames = replay.replay_log(buf)
    jcols, jframes = jax_replay.replay_log(buf)
    _columns_equal(cols, jcols)
    _index_equal(frames, jframes)
    for i in range(0, n, max(1, n // 40)):
        assert cols.row(i).to_dict() == jcols.row(i).to_dict()
    assert replay.encode_change_columns(cols) == wire \
        == jax_replay.encode_change_columns(jcols)


@pytest.mark.parametrize("rows_per_batch", [1, 100, 1024, 65536])
def test_replay_batch_wire_matches_jax(rows_per_batch):
    records = _records(3000, 6, keyspace=128)
    wire = _wire(records)
    cols, _ = replay.replay_log(np.frombuffer(wire, np.uint8))
    jcols, _ = jax_replay.replay_log(np.frombuffer(wire, np.uint8))
    bwire = replay.encode_batch_frames(cols, rows_per_batch)
    assert bwire == jax_replay.encode_batch_frames(jcols, rows_per_batch)
    if rows_per_batch > 1:
        assert len(bwire) < len(wire)  # the dictionary earns its bytes
    bcols, bframes = replay.replay_log(np.frombuffer(bwire, np.uint8))
    jbcols, _ = jax_replay.replay_log(np.frombuffer(bwire, np.uint8))
    _columns_equal(bcols, jbcols)
    assert int((bframes.ids == TYPE_CHANGE_BATCH).sum()) \
        == -(-3000 // rows_per_batch)
    # the per-record re-encode of batch rows is the per-record wire
    assert replay.encode_change_columns(bcols) == wire


def test_replay_mixed_wire_keeps_wire_order_as_jax():
    records = _records(90, 7)
    cols_mid, _ = replay.replay_log(np.frombuffer(_wire(records[30:60]),
                                                  np.uint8))
    mixed = (_wire(records[:30]) + frame(TYPE_BLOB, b"BLOB")
             + replay.encode_batch_frames(cols_mid, 8)
             + _wire(records[60:75]) + frame(TYPE_BLOB, b"")
             + replay.encode_batch_frames(
                 replay._slice_columns(cols_mid, 0, 5))
             + _wire(records[75:]))
    buf = np.frombuffer(mixed, np.uint8)
    cols, frames = replay.replay_log(buf)
    jcols, jframes = jax_replay.replay_log(buf)
    _columns_equal(cols, jcols)
    _index_equal(frames, jframes)
    want = records[:75] + records[30:35] + records[75:]
    assert [cols.row(i).to_dict() for i in range(len(cols))] == [
        Change.from_dict({**r, "value": r["value"] or b"",
                          "subset": r["subset"] or ""}).to_dict()
        for r in want]


def test_unknown_type_id_raises_protocol_error():
    wire = _wire(_records(5, 8)) + frame(4, b"reconcile") + frame(9, b"")
    buf = np.frombuffer(wire, np.uint8)
    with pytest.raises(ProtocolError) as got:
        replay.replay_log(buf)
    with pytest.raises(Exception) as want:
        jax_replay.replay_log(buf)
    assert str(got.value) == str(want.value) \
        == "Protocol error, unknown type: 4"


def test_corrupt_batch_frame_in_a_log_raises_protocol_error():
    cols, _ = replay.replay_log(np.frombuffer(_wire(_records(20, 9)),
                                              np.uint8))
    payload = bytearray(batch_codec.encode_columns(cols))
    payload[1] = 0xEE  # the key-index width
    wire = _wire(_records(3, 10)) + frame(TYPE_CHANGE_BATCH, bytes(payload))
    with pytest.raises(ProtocolError, match="bad ChangeBatch widths"):
        replay.replay_log(np.frombuffer(wire, np.uint8))


@pytest.mark.parametrize("walk_min", [1, 64])
@pytest.mark.parametrize("seed", range(3))
def test_corrupt_records_fail_as_jax_python_path(seed, walk_min, monkeypatch):
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    monkeypatch.setattr(replay, "_WALK_MIN", walk_min)
    rng = np.random.default_rng(50 + seed)
    wire = _wire(_records(300, seed))
    outcomes = set()
    for _ in range(40):
        bad = bytearray(wire)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        buf = np.frombuffer(bytes(bad), np.uint8)
        got = _outcome(lambda: replay.replay_log(buf)[0])
        want = _outcome(lambda: jax_replay.replay_log(buf)[0])
        assert got[0] == want[0], (got, want)
        if got[0] == "ok":
            _columns_equal(got[1], want[1])
        else:
            assert got[1] == want[1]
        outcomes.add(got[0])
    assert outcomes == {"ok", "ProtocolError"}


@pytest.mark.parametrize("payload", [
    b"\x12\x01a\x18\x01\x20\x01",  # no `to`
    b"\x18\x01\x20\x01\x28\x01",  # no key
    b"\x12\x02\xc3\x28\x18\x01\x20\x01\x28\x01",  # key not UTF-8
    b"\x0a\x01\xff\x12\x01a\x18\x01\x20\x01\x28\x01",  # subset not UTF-8
    b"\x12\x05ab",  # truncated key
    b"\x12\x01a\x18" + b"\x80" * 10 + b"\x01",  # varint over 10 bytes
    b"\x12\x01a\x18" + b"\xff" * 9 + b"\x02",  # varint over 64 bits
    b"\x12\x01a\x1b\x18\x01\x20\x01\x28\x01",  # wire type 3
    b"\x12\x01a\x1d\x01\x02",  # truncated fixed32
    b"",  # empty record
])
@pytest.mark.parametrize("walk_min", [1, 64])
def test_each_record_fault_fails_at_its_index(payload, walk_min, monkeypatch):
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    monkeypatch.setattr(replay, "_WALK_MIN", walk_min)
    good = _records(100, 10)
    wire = _wire(good[:70]) + frame(TYPE_CHANGE, payload) + _wire(good[70:])
    buf = np.frombuffer(wire, np.uint8)
    with pytest.raises(ProtocolError) as got:
        replay.replay_log(buf)
    with pytest.raises(Exception) as want:
        jax_replay.replay_log(buf)
    assert str(got.value) == str(want.value) \
        == "corrupt Change record at index 70"


@pytest.mark.parametrize("walk_min", [1, 64])
def test_unknown_fields_repeats_and_wide_varints_decode_as_jax(walk_min,
                                                               monkeypatch):
    """proto2 rules: unknown fields skipped (every wire type the codec
    skips), the last occurrence of a field wins, varints wider than 32
    bits truncate, non-canonical varints decode."""
    monkeypatch.setattr(replay, "_WALK_MIN", walk_min)
    odd = [
        b"\x12\x01a\x12\x02bc\x18\x05\x18\x06\x20\x01\x28\x01\x32\x01v"
        b"\x32\x00",
        b"\x38\x07\x3d\x01\x02\x03\x04\x39" + bytes(8)
        + b"\x42\x03xyz\x12\x01k\x18\x81\x80\x80\x80\x10\x20\x80\x00\x28\x01",
        b"\x0a\x00\x12\x00\x18\x00\x20\x00\x28\x00\x0a\x02s2",
    ]
    records = _records(150, 11)
    wire = b"".join(
        frame(TYPE_CHANGE, odd[i % 3]) if i % 10 == 0
        else frame(TYPE_CHANGE, encode_change(r))
        for i, r in enumerate(records))
    buf = np.frombuffer(wire, np.uint8)
    cols, _ = replay.replay_log(buf)
    jcols, _ = jax_replay.replay_log(buf)
    _columns_equal(cols, jcols)
    assert cols.row(0).key == "bc" and cols.row(0).change == 6
    assert cols.row(10).change == 1 and cols.row(20).subset == "s2"


@pytest.mark.parametrize("seed", [12, 13])
def test_encoders_and_canonical_extents_match_jax(seed):
    records = _records(400, seed)
    wire = _wire(records)
    assert replay.encode_change_log(records) == wire \
        == jax_replay.encode_change_log(records)
    cols, _ = replay.replay_log(np.frombuffer(wire, np.uint8))
    jcols, _ = jax_replay.replay_log(np.frombuffer(wire, np.uint8))
    bcols, _ = replay.replay_log(np.frombuffer(
        replay.encode_batch_frames(cols, 64), np.uint8))
    for c in (cols, bcols):
        got = replay.canonical_change_extents(c)
        want = jax_replay.canonical_change_extents(jcols)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        assert replay.canonical_change_payloads(c) \
            == jax_replay.canonical_change_payloads(jcols) \
            == [encode_change(r) for r in records]
    assert replay.encode_change_columns(replay._slice_columns(cols, 5, 5)) \
        == b""


def test_columns_cross_packages_through_numpy():
    wire = _wire(_records(50, 14))
    jcols, _ = jax_replay.replay_log(np.frombuffer(wire, np.uint8))
    d = weights.columns_to_numpy(jcols)
    cols = weights.columns_from_numpy(d)
    assert isinstance(cols, replay.ChangeColumns)
    _columns_equal(cols, jcols)
    assert replay.encode_change_columns(cols) == wire
    assert cols.row(3).to_dict() == jcols.row(3).to_dict()
    with pytest.raises(KeyError):
        weights.columns_from_numpy({k: v for k, v in d.items()
                                    if k != "to"})
    with pytest.raises(ValueError):
        weights.columns_from_numpy({**d, "to": d["to"][:-1]})
