"""The port's native codec route against its Python route and the JAX
package.

Each entry with a native route (``encode_change``/``decode_change``,
``split_frames``, ``decode_change_columns``, ``encode_change_columns``,
``encode_change_log``, ``encode_columns``, ``replay_log``,
``_greedy_select``) runs on seeded inputs on the port's native route,
its Python route (``native=False``) and the JAX package's default and
Python routes (``DAT_NATIVE_DISABLE=1`` / ``DAT_FASTPATH_DISABLE=1``,
set on the JAX package only).  Results are exactly equal, errors equal
in type, message and cause.  The one stated difference: a key that is
not UTF-8 is a corrupt record on both of the port's routes, while the
JAX package's C columnar decoder accepts it (pinned below).
"""

import array
import random

import numpy as np
import pytest

from dat_replication_protocol_tpu.ops import rabin as jax_rabin
from dat_replication_protocol_tpu.runtime import replay as jax_replay
from dat_replication_protocol_tpu.wire import batch_codec as jax_batch
from dat_replication_protocol_tpu.wire import change_codec as jax_codec
from dat_replication_protocol_tpu_torch import _fastpath_gate, weights
from dat_replication_protocol_tpu_torch.ops import rabin
from dat_replication_protocol_tpu_torch.runtime import fastpath, native, replay
from dat_replication_protocol_tpu_torch.session import decoder
from dat_replication_protocol_tpu_torch.wire import batch_codec, change_codec
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    Change,
    decode_change,
    encode_change,
)
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_BLOB,
    TYPE_CHANGE,
    TYPE_CHANGE_BATCH,
    ProtocolError,
    frame,
)
from dat_replication_protocol_tpu_torch.wire.varint import encode_uvarint

EDGE = [0, 1, 127, 128, 16383, 16384, (1 << 21) - 1, 1 << 21,
        (1 << 28) - 1, 1 << 28, 0xFFFFFFFF]


@pytest.fixture(params=["jax-native", "jax-python"])
def jax_route(request, monkeypatch):
    if request.param == "jax-python":
        monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
        monkeypatch.setenv("DAT_FASTPATH_DISABLE", "1")
    else:
        monkeypatch.delenv("DAT_NATIVE_DISABLE", raising=False)
        monkeypatch.delenv("DAT_FASTPATH_DISABLE", raising=False)
    return request.param


@pytest.fixture
def jax_python(monkeypatch):
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    monkeypatch.setenv("DAT_FASTPATH_DISABLE", "1")


def _outcome(fn, *args, **kw):
    """(result, None) or (None, (type, message, cause type, cause
    message)) of one call."""
    try:
        return fn(*args, **kw), None
    except Exception as e:  # noqa: BLE001 — the error is the result
        c = e.__cause__
        return None, (type(e).__name__, str(e),
                      type(c).__name__ if c is not None else None,
                      str(c) if c is not None else None)


# -- the per-record codec -----------------------------------------------------

def test_c_encoder_byte_identical_fuzz():
    rng = random.Random(7)
    for i in range(500):
        key = "".join(rng.choice("abÅ→€z0") for _ in range(rng.randrange(0, 40)))
        subset = rng.choice([None, "", "s", "ünïcode·" * rng.randrange(1, 4)])
        value = rng.choice([None, b"", bytes(rng.randrange(0, 200)),
                            bytearray(b"ba"), memoryview(b"mv")])
        ch = Change(key=key, change=rng.choice(EDGE), from_=rng.choice(EDGE),
                    to=rng.choice(EDGE), value=value, subset=subset)
        got = encode_change(ch)
        assert got == encode_change(ch, native=False), i
        assert got == jax_codec._encode_change_py(jax_codec.Change(
            key=key, change=ch.change, from_=ch.from_, to=ch.to,
            value=value, subset=subset)), i
        assert decode_change(got) == decode_change(got, native=False)


BAD_RECORDS = [
    Change(key="k", change=-1, from_=0, to=1),
    Change(key="k", change=1 << 32, from_=0, to=1),
    Change(key="k", change=1, from_=1.5, to=1),
    Change(key="k", change=1, from_=0, to="1"),
    Change(key=None, change=1, from_=0, to=1),
    Change(key=b"k", change=1, from_=0, to=1),
    Change(key="\ud800", change=1, from_=0, to=1),
    Change(key="k", change=1, from_=0, to=1, subset="\udfff"),
    Change(key="k", change=1, from_=0, to=1, value="text"),
    {"key": "k", "change": 1, "to": 1},
    {"change": 1, "from": 0, "to": 1},
    {"key": "k", "from_": 0, "to": 1},
]


@pytest.mark.parametrize("i", range(len(BAD_RECORDS)))
def test_c_encoder_errors_are_the_python_encoders(i):
    rec = BAD_RECORDS[i]
    got = _outcome(encode_change, rec)
    assert got[1] is not None
    assert got == _outcome(encode_change, rec, native=False)


def test_bools_are_uint32_on_both_routes():
    ch = Change(key="k", change=True, from_=False, to=1)
    assert encode_change(ch) == encode_change(ch, native=False)


def _payloads(rng, n):
    for i in range(n):
        ch = Change(
            key="".join(rng.choice("abÅ€z") for _ in range(rng.randrange(0, 20))),
            change=rng.choice(EDGE), from_=rng.choice(EDGE),
            to=rng.choice(EDGE),
            value=rng.choice([None, b"", bytes(rng.randrange(0, 60))]),
            subset=rng.choice([None, "", "sü" * rng.randrange(1, 3)]))
        wire = encode_change(ch)
        yield wire
        if len(wire) > 1:
            yield wire[:rng.randrange(1, len(wire))]
        mut = bytearray(wire)
        mut[rng.randrange(len(mut))] ^= 1 << rng.randrange(8)
        yield bytes(mut)
        yield bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
        big = (1 << 34) | rng.choice(EDGE)
        yield (bytes([0x12, 0x01]) + b"k" + bytes([0x18])
               + encode_uvarint(big) + bytes([0x20, 0x00, 0x28, 0x01]))
    # varint edges: 64-bit overflow, ten continuation bytes, truncation
    for body in ([0xFF] * 9 + [0x7F], [0xFF] * 9 + [0x01], [0x80] * 10,
                 [0x80] * 9, [0xFF] * 11):
        yield bytes([0x18] + body)
        yield bytes(body)
        yield bytes([0x12] + body)


def test_c_decoder_differential_fuzz(jax_python):
    """decode_change_c against the Python parser on round-trips,
    truncations, bit flips, garbage and varint edges: the same record,
    or the same error class AND message; and the JAX package's Python
    parser agrees."""
    rng = random.Random(11)
    for k, payload in enumerate(_payloads(rng, 400)):
        got = _outcome(decode_change, payload)
        want = _outcome(decode_change, payload, native=False)
        assert got == want, (k, payload)
        ref = _outcome(jax_codec.decode_change, payload)
        if want[1] is None:
            assert ref[1] is None and ref[0].to_dict() == want[0].to_dict()
        else:
            assert ref[1][:2] == want[1][:2], (k, payload)


def test_exotic_buffer_values_keep_parity():
    strided = memoryview(b"abcdef")[::2]
    multi = memoryview(array.array("I", [1, 2]))
    for value in (strided, multi, memoryview(b"plain"), bytearray(b"ba")):
        ch = Change(key="k", change=1, from_=0, to=1, value=value)
        wire = encode_change(ch)
        assert wire == encode_change(ch, native=False)
        back = decode_change(wire)
        assert back.value == bytes(value)
        assert back == decode_change(wire, native=False)
    payload = encode_change(Change(key="kk", change=7, from_=0, to=1))
    doubled = bytes(b for byte in payload for b in (byte, 0))
    assert decode_change(memoryview(doubled)[::2]) == decode_change(payload)


def test_decode_exotic_buffers_keep_python_semantics():
    payload = encode_change(Change(key="kk", change=7, from_=0, to=1,
                                   value=b"xy"))
    doubled = np.frombuffer(
        bytes(b for byte in payload for b in (byte, 0)), dtype=np.uint8)
    assert decode_change(doubled[::2]) == decode_change(doubled[::2],
                                                        native=False)
    arr = np.frombuffer(payload, dtype=np.uint8)
    assert decode_change(arr) == decode_change(payload, native=False)
    a = array.array("I", [0x12, 1, ord("k"), 0x18, 1, 0x20, 0, 0x28, 1])
    mv = memoryview(a)
    assert decode_change(mv) == decode_change(mv, native=False)


def test_one_gate_for_the_codec_and_the_decoder():
    """The codec and the decoder reach the extension through the one
    lazy binding, which holds the module ``runtime.fastpath`` built."""
    assert change_codec._fastpath_mod is _fastpath_gate.fastpath_mod
    assert decoder._fastpath_mod is _fastpath_gate.fastpath_mod
    assert _fastpath_gate.fastpath_mod() is fastpath.get()
    assert _fastpath_gate._get is fastpath.get


# -- replay ---------------------------------------------------------------------

def _records(n, seed, keyspace=64):
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


def _cols(cols):
    return {k: np.asarray(v) for k, v in
            weights.columns_to_numpy(cols).items()}


def _same_cols(a, b):
    x, y = _cols(a), _cols(b)
    assert x.keys() == y.keys()
    for k in x:
        assert np.array_equal(x[k], y[k]), k


def _same_index(a, b):
    for f in ("starts", "lens", "ids"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert a.consumed == b.consumed


@pytest.mark.parametrize("n", [0, 1, 300, 9000])
def test_replay_routes_agree_with_each_other_and_the_jax_package(n,
                                                                 jax_route):
    recs = _records(n, seed=n)
    wire = replay.encode_change_log(recs)
    assert wire == replay.encode_change_log(recs, native=False)
    assert wire == jax_replay.encode_change_log(recs)
    cols, idx = replay.replay_log(wire)
    pcols, pidx = replay.replay_log(wire, native=False)
    jcols, jidx = jax_replay.replay_log(wire)
    _same_index(idx, pidx)
    _same_index(idx, jidx)
    _same_cols(cols, pcols)
    _same_cols(cols, jcols)
    assert replay.encode_change_columns(cols) == wire
    assert replay.encode_change_columns(cols, native=False) == wire
    batch = replay.encode_batch_frames(cols, rows_per_batch=4096)
    assert batch == replay.encode_batch_frames(cols, 4096, native=False)
    assert batch == jax_replay.encode_batch_frames(jcols, 4096)
    for native in (True, False):
        buf, offs, lens = replay.canonical_change_extents(cols, native)
        jbuf, joffs, jlens = jax_replay.canonical_change_extents(jcols)
        assert np.array_equal(np.asarray(offs), np.asarray(joffs))
        assert np.array_equal(np.asarray(lens), np.asarray(jlens))
        assert bytes(np.asarray(buf)) == bytes(np.asarray(jbuf))


def test_mixed_wire_replays_alike(jax_route):
    recs = _records(600, seed=3)
    cols, _ = replay.replay_log(replay.encode_change_log(recs))
    parts = []
    for lo in range(0, 600, 100):
        sl = replay._slice_columns(cols, lo, lo + 100)
        if (lo // 100) % 2:
            parts.append(frame(TYPE_CHANGE_BATCH,
                               batch_codec.encode_columns(sl)))
        else:
            parts.append(replay.encode_change_columns(sl))
        parts.append(frame(TYPE_BLOB, b"b" * lo))
    wire = b"".join(parts)
    got, idx = replay.replay_log(wire)
    want, pidx = replay.replay_log(wire, native=False)
    jwant, jidx = jax_replay.replay_log(wire)
    _same_index(idx, pidx)
    _same_index(idx, jidx)
    _same_cols(got, want)
    _same_cols(got, jwant)
    for r in (0, 150, 599):
        assert got.row(r) == want.row(r)


def _col_arrays(m):
    return (np.empty(m, np.uint32), np.empty(m, np.uint32),
            np.empty(m, np.uint32), *(np.empty(m, np.int64)
                                      for _ in range(6)))


def test_threaded_and_serial_decode_agree():
    """The serial C entries (the session decoder's decode) give what the
    threaded ones (replay's) give, on a log past their per-thread
    minimum."""
    recs = _records(20000, seed=5, keyspace=5000)
    wire = replay.encode_change_log(recs)
    idx = replay.split_frames(wire)
    buf = np.ascontiguousarray(idx.buf, np.uint8)
    starts = np.ascontiguousarray(idx.starts, np.int64)
    lens = np.ascontiguousarray(idx.lens, np.int64)
    one, many = _col_arrays(len(starts)), _col_arrays(len(starts))
    assert native.decode_changes_serial(buf, starts, lens, one) < 0
    assert native.decode_changes(buf, starts, lens, many) < 0
    for a, b in zip(one, many):
        assert np.array_equal(a, b)
    cols = replay.decode_change_columns(buf, starts, lens)
    src = np.ascontiguousarray(cols.buf, np.uint8)
    args = native.columns(cols)
    threaded = native.encode_changes(src, len(cols.change), args)
    dst = np.empty(len(threaded) + 16, np.uint8)
    w = native.get_lib().dat_encode_changes(src, len(cols.change), *args,
                                            dst, len(dst))
    assert bytes(dst[:w]) == bytes(threaded) == wire


def _hostile_logs():
    rng = np.random.default_rng(23)
    good = replay.encode_change_log(_records(40, seed=9))
    out = {f"garbage-{i}": rng.bytes(int(rng.integers(1, 3000)))
           for i in range(12)}
    out.update({
        "zero-length": good + bytes([0x00, 0x01]) + good,
        "varint-64": good + bytes([0xFF] * 9 + [0x7F, 0x01]),
        "varint-long": good + bytes([0x80] * 10 + [0x01]),
        "truncated": good + bytes([0x90, 0x01, 0x01]),
        "partial-header": good + bytes([0x80]),
    })
    return out


@pytest.mark.parametrize("name", sorted(_hostile_logs()))
def test_split_errors_agree(name, jax_python):
    data = _hostile_logs()[name]
    for partial in (False, True):
        got = _outcome(replay.split_frames, data, partial)
        want = _outcome(replay.split_frames, data, partial, native=False)
        ref = _outcome(jax_replay.split_frames, data, partial)
        assert (got[1] is None) == (want[1] is None) == (ref[1] is None)
        if got[1] is None:
            _same_index(got[0], want[0])
            _same_index(got[0], ref[0])
        else:
            assert got[1] == want[1] == ref[1]


def _corrupt_logs():
    recs = _records(120, seed=13)
    payloads = [encode_change(r) for r in recs]
    bad = {
        "wire-type": bytes([0x12, 0x01, 0x6B, 0x0C]),
        "missing": bytes([0x12, 0x01, 0x6B]),
        "truncated": bytes([0x12, 0x09, 0x6B]),
        "varint-64": bytes([0x18] + [0xFF] * 9 + [0x7F]),
        "key-not-utf8": bytes([0x12, 0x02, 0xFF, 0xFE, 0x18, 0x01, 0x20,
                               0x00, 0x28, 0x01]),
        "subset-not-utf8": bytes([0x0A, 0x01, 0xC3, 0x12, 0x01, 0x6B, 0x18,
                                  0x01, 0x20, 0x00, 0x28, 0x01]),
        "first-key-not-utf8": bytes([0x12, 0x01, 0xFF, 0x12, 0x01, 0x6B,
                                     0x18, 0x01, 0x20, 0x00, 0x28, 0x01]),
    }
    out = {}
    for name, p in bad.items():
        for at in (0, 77, 119):
            ps = list(payloads)
            ps[at] = p
            out[f"{name}-{at}"] = b"".join(frame(TYPE_CHANGE, x) for x in ps)
    return out


@pytest.mark.parametrize("name", sorted(_corrupt_logs()))
def test_decode_errors_agree(name, jax_python):
    """The first corrupt record raises ``corrupt Change record at index
    r`` with the per-record codec's error as its cause, on both routes
    and on the JAX package's Python route."""
    wire = _corrupt_logs()[name]
    got = _outcome(replay.replay_log, wire)
    assert got[1] is not None and got[1][0] == "ProtocolError"
    assert got == _outcome(replay.replay_log, wire, native=False)
    assert got[1] == _outcome(jax_replay.replay_log, wire)[1]


def test_non_utf8_key_is_corrupt_in_the_port_only(monkeypatch):
    """The JAX package's C columnar decoder skips the key UTF-8 check its
    per-record codec makes (a fault of the reference the port does not
    copy): its default route accepts the record, its Python route and
    both of the port's routes reject it."""
    wire = _corrupt_logs()["key-not-utf8-77"]
    monkeypatch.delenv("DAT_NATIVE_DISABLE", raising=False)
    cols, _ = jax_replay.replay_log(wire)
    assert len(cols) == 120 and bytes(cols.buf[cols.key_off[77]:
                                               cols.key_off[77] + 2]) \
        == b"\xff\xfe"
    for native in (True, False):
        with pytest.raises(ProtocolError,
                           match="corrupt Change record at index 77") as e:
            replay.replay_log(wire, native=native)
        assert isinstance(e.value.__cause__, UnicodeDecodeError)


# -- the batch codec and the greedy pass ------------------------------------------

@pytest.mark.parametrize("shape", ["narrow", "wide"])
def test_batch_encoder_routes_agree(shape, jax_route):
    if shape == "narrow":
        recs = _records(500, seed=17)
    else:  # past one-byte indices and two-byte lengths
        recs = _records(700, seed=19, keyspace=100000)
        recs[3]["value"] = bytes(70000)
        recs[5]["subset"] = "x" * 300
    cols, _ = replay.replay_log(replay.encode_change_log(recs))
    got = batch_codec.encode_columns(cols)
    assert got == batch_codec.encode_columns(cols, native=False)
    assert got == jax_batch.encode_columns(cols)
    assert got == batch_codec.encode_rows([
        (r["key"].encode(), r["change"], r["from"], r["to"], r["value"],
         None if r["subset"] is None else r["subset"].encode())
        for r in recs])


@pytest.mark.parametrize("case", range(8))
def test_greedy_select_routes_agree(case):
    rng = np.random.default_rng(case)
    length = int(rng.integers(0, 3_000_000)) if case else 0
    min_size, max_size = [(2048, 32768), (2048, 32768), (1, 1), (64, 64),
                          (4096, 8192), (100, 99), (2048, 32768),
                          (1 << 20, 1 << 22)][case]
    if max_size <= 64:
        length //= 20  # a cut every few bytes: keep the Python loops short
    k = int(rng.integers(0, 5000))
    cands = np.unique(rng.integers(0, max(length, 1), k))
    got = rabin._greedy_select(cands, length, min_size, max_size)
    assert isinstance(got, list)
    assert got == rabin._greedy_select(cands, length, min_size, max_size,
                                       native=False)
    assert got == jax_rabin._greedy_select(cands, length, min_size,
                                           max_size)
    assert got == jax_rabin._greedy_select_py(cands, length, min_size,
                                              max_size)
