"""The ``dat_fastpath`` extension's dispatch loop and acks, driven
directly.

``dispatch_changes`` must leave both cursor halves in ``st`` on every
exit, stop at a non-change frame, an armed ack, a pause, pending work or
a destroy, count ``changes`` before each handler call, hand the digest
tap every dispatched payload, and report a payload that fails UTF-8 as
status 2 with the ``UnicodeDecodeError`` itself in ``st`` (never as a
raised exception, so a handler's own ``ValueError`` is never read as a
wire error).  ``FastAck`` is one-shot across threads, and its release
that empties the ``AckBoard`` resumes the decoder.  The loop's
deliveries equal the JAX package's extension's on the same columns.
"""

import threading

import numpy as np
import pytest

from dat_replication_protocol_tpu.runtime import fastpath as jax_fastpath
from dat_replication_protocol_tpu.wire.change_codec import Change as JaxChange
from dat_replication_protocol_tpu_torch.runtime import fastpath, native
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    Change,
    encode_change,
)
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_BLOB,
    TYPE_CHANGE,
    frame,
)


@pytest.fixture(scope="module")
def fp():
    return fastpath.get()


class FakeDecoder:
    """The attributes the C loop reads and writes by name."""

    def __init__(self):
        self._pending = 0
        self._paused_readers = 0
        self.destroyed = False
        self.changes = 0
        self.resumes = 0

    def _resume(self):
        self.resumes += 1


def _index(records, blob_at=()):
    parts = []
    for i, r in enumerate(records):
        if i in blob_at:
            parts.append(frame(TYPE_BLOB, b"B" * 9))
        parts.append(frame(TYPE_CHANGE, encode_change(r)))
    wire = np.frombuffer(b"".join(parts), np.uint8)
    n, starts, lens, ids, consumed, err = native.split_frames(wire)
    assert err == 0 and consumed == len(wire)
    sel = np.nonzero(ids[:n] == TYPE_CHANGE)[0]
    m = len(sel)
    cols = (np.empty(m, np.uint32), np.empty(m, np.uint32),
            np.empty(m, np.uint32), *(np.empty(m, np.int64)
                                      for _ in range(6)))
    assert native.decode_changes(wire, np.ascontiguousarray(starts[sel]),
                                 np.ascontiguousarray(lens[sel]), cols) < 0
    return (wire, np.ascontiguousarray(ids[:n]), cols,
            np.ascontiguousarray(starts[:n]), np.ascontiguousarray(lens[:n]),
            n)


def _records(n):
    return [{"key": f"k{i}", "change": i, "from": 1, "to": 2,
             "value": b"v" * i, "subset": None if i % 2 else "s"}
            for i in range(n)]


def _run(mod, dec, board, cb, idx, f=0, row=0, sink=None, cls=Change):
    wire, ids, cols, starts, lens, n = idx
    st = {}
    out = mod.dispatch_changes(dec, board, cb, cls, wire, ids, *cols, f,
                               row, n, st, starts, lens, sink)
    return out, st


def test_runs_to_a_non_change_frame_and_counts_before_each_call(fp):
    idx = _index(_records(10), blob_at=(6,))
    dec = FakeDecoder()
    board = fp.AckBoard()
    seen = []
    sink = []
    out, st = _run(fp, dec, board, lambda ch, done: (
        seen.append((ch.key, dec.changes)), done()), idx, sink=sink)
    assert out == (6, 6, 0) and (st["f"], st["row"]) == (6, 6)
    assert seen == [(f"k{i}", i + 1) for i in range(6)]
    assert sink == [encode_change(r) for r in _records(6)]
    assert dec.changes == 6 and board.outstanding == 0
    # the next run starts past the blob frame, at row 6
    out, st = _run(fp, dec, board, lambda ch, done: done(), idx, f=7, row=6)
    assert out == (11, 10, 0)


def test_an_armed_ack_parks_and_its_release_resumes(fp):
    idx = _index(_records(5))
    dec = FakeDecoder()
    board = fp.AckBoard()
    held = []
    out, st = _run(fp, dec, board, lambda ch, done: held.append(done), idx)
    assert out == (1, 1, 1) and board.outstanding == 1
    held[0]()
    assert board.outstanding == 0 and dec.resumes == 1
    held[0]()  # one-shot: a second ack changes nothing
    assert board.outstanding == 0 and dec.resumes == 1


@pytest.mark.parametrize("stop", ["pending", "paused", "destroyed"])
def test_the_loop_stops_on_decoder_state(fp, stop):
    idx = _index(_records(5))
    dec = FakeDecoder()

    def cb(ch, done):
        done()
        if stop == "pending":
            dec._pending = 1
        elif stop == "paused":
            dec._paused_readers = 1
        else:
            dec.destroyed = True

    out, st = _run(fp, dec, fp.AckBoard(), cb, idx)
    assert out == (1, 1, 1) and (st["f"], st["row"]) == (1, 1)


def test_a_raising_handler_leaves_both_cursors_advanced(fp):
    idx = _index(_records(5))
    dec = FakeDecoder()

    def cb(ch, done):
        done()
        if ch.change == 2:
            raise ValueError("app bug")

    with pytest.raises(ValueError, match="app bug"):
        _run(fp, dec, fp.AckBoard(), cb, idx)
    st = {}
    wire, ids, cols, starts, lens, n = idx
    with pytest.raises(ValueError):
        fp.dispatch_changes(dec, fp.AckBoard(), cb, Change, wire, ids, *cols,
                            0, 0, n, st)
    assert (st["f"], st["row"]) == (3, 3)


def test_utf8_failure_is_status_2_with_the_error_in_st(fp):
    idx = _index(_records(4))
    wire, ids, cols, starts, lens, n = idx
    wire = wire.copy()
    wire[cols[3][2]] = 0xFF  # row 2's key: no longer UTF-8
    seen = []
    st = {}
    out = fp.dispatch_changes(FakeDecoder(), fp.AckBoard(),
                              lambda ch, done: (seen.append(ch.key), done()),
                              Change, wire, ids, *cols, 0, 0, n, st)
    assert out == (2, 2, 2) and seen == ["k0", "k1"]
    err = st["decode_error"]
    assert isinstance(err, UnicodeDecodeError)
    with pytest.raises(UnicodeDecodeError) as want:
        bytes(wire[cols[3][2]:cols[3][2] + cols[4][2]]).decode("utf-8")
    assert str(err) == str(want.value)


def test_no_handler_drops_changes_and_still_counts(fp):
    idx = _index(_records(7))
    dec = FakeDecoder()
    out, _ = _run(fp, dec, fp.AckBoard(), None, idx)
    assert out == (7, 7, 0) and dec.changes == 7


def test_deliveries_equal_the_jax_packages_extension(fp, monkeypatch):
    monkeypatch.delenv("DAT_FASTPATH_DISABLE", raising=False)
    jfp = jax_fastpath.get()
    idx = _index(_records(40), blob_at=(13, 30))
    got, want = [], []
    for mod, cls, out in ((fp, Change, got), (jfp, JaxChange, want)):
        dec = FakeDecoder()
        f, row = 0, 0
        while f < idx[5]:
            (f, row, _), _ = _run(mod, dec, mod.AckBoard(),
                                  lambda ch, done: (out.append(
                                      (ch.key, ch.change, ch.from_, ch.to,
                                       ch.value, ch.subset)), done()),
                                  idx, f=f, row=row, cls=cls)
            if f < idx[5] and idx[1][f] != TYPE_CHANGE:
                f += 1  # step over the blob frame
    assert got == want and len(got) == 40


def test_cross_thread_acks_never_lose_or_double_count(fp):
    """Acks land from other threads while the loop arms them: the board
    returns to 0 and every armed release resumes exactly once."""
    idx = _index(_records(300))
    for _ in range(10):
        dec = FakeDecoder()
        board = fp.AckBoard()
        threads = []
        f = row = 0
        while f < idx[5]:
            def cb(ch, done):
                t = threading.Thread(target=done)
                t.start()
                threads.append(t)

            (f, row, status), _ = _run(fp, dec, board, cb, idx, f=f, row=row)
            if status == 1:
                for t in threads:
                    t.join(timeout=5)
        for t in threads:
            t.join(timeout=5)
        assert board.outstanding == 0
        assert dec.changes == 300


def test_fast_ack_release_propagates_resume_errors(fp):
    idx = _index(_records(2))
    dec = FakeDecoder()

    def boom():
        raise RuntimeError("resume failed")

    dec._resume = boom
    held = []
    _run(fp, dec, fp.AckBoard(), lambda ch, done: held.append(done), idx)
    with pytest.raises(RuntimeError, match="resume failed"):
        held[0]()


def test_bad_arguments_raise(fp):
    idx = _index(_records(2))
    wire, ids, cols, starts, lens, n = idx
    with pytest.raises(TypeError, match="AckBoard"):
        fp.dispatch_changes(FakeDecoder(), object(), None, Change, wire, ids,
                            *cols, 0, 0, n, {})
    with pytest.raises(TypeError, match="sink"):
        fp.dispatch_changes(FakeDecoder(), fp.AckBoard(), None, Change, wire,
                            ids, *cols, 0, 0, n, {}, None, None, [])


def test_the_jax_packages_extension_cannot_overwrite_the_ports(fp,
                                                               monkeypatch):
    # both are single-phase extensions, which hold a sys.modules slot by
    # name: under one name, the JAX package's reload (its reset hook)
    # copied its two-argument decode_change_c into the port's module
    from dat_replication_protocol_tpu_torch.wire.varint import NeedMoreData

    monkeypatch.delenv("DAT_FASTPATH_DISABLE", raising=False)
    jax_fastpath.get()
    jax_fastpath.reset_for_tests()
    jm = jax_fastpath.get()
    assert (fp.__name__, jm.__name__) == ("dat_torch_fastpath", "dat_fastpath")
    assert fp.decode_change_c is not jm.decode_change_c
    payload = encode_change(_records(1)[0])
    assert fp.decode_change_c(Change, payload, NeedMoreData).key == "k0"
    assert fastpath.get() is fp
