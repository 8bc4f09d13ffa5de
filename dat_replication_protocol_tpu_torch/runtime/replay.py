"""Change-log replay: framed wire bytes -> columnar change records.

The port's copy of ``dat_replication_protocol_tpu/runtime/replay.py``
without its native C engine.  A whole log buffer is replayed at once:

* :func:`split_frames` indexes every frame (the reference's Python
  splitter);
* per-record ``Change`` frames decode to columns by a numpy walk over
  the fields of all records at once, one field a step; records the walk
  leaves (corrupt ones, or a tail of records with many fields) take the
  reference's per-record decode, which raises at the first corrupt
  record with the reference's message;
* ``ChangeBatch`` frames decode with ``wire.batch_codec``;
* the encoders run the other way, per-record frames built by numpy
  scatters byte for byte as the reference's per-record codec writes
  them.

Columns are zero-copy: uint32 ``change/from/to`` and (offset, length)
views into the one log buffer for ``key/subset/value``, the ragged
layout ``batch.feed`` hashes from.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..obs.device import note_engine as _note_engine
from ..obs.metrics import OBS as _OBS
from ..wire.batch_codec import ragged_copy, ragged_gather, uvarint_sizes
from ..wire.change_codec import Change, decode_change, encode_change
from ..wire.framing import (TYPE_BLOB, TYPE_CHANGE, TYPE_CHANGE_BATCH,
                            ProtocolError, frame)
from ..wire.varint import NeedMoreData, decode_uvarint

# the field walk hands its last records to the per-record decode once
# fewer than this many are still being walked
_WALK_MIN = 64

_U32 = np.uint64(0xFFFFFFFF)
# proto2 tags of the Change fields (wire/change_codec.py)
_TAG_SUBSET, _TAG_KEY, _TAG_VALUE = 0x0A, 0x12, 0x32
_TAG_CHANGE, _TAG_FROM, _TAG_TO = 0x18, 0x20, 0x28


@dataclasses.dataclass
class FrameIndex:
    """All complete frames of a log buffer (zero-copy offsets)."""

    buf: np.ndarray  # uint8 view of the log
    starts: np.ndarray  # int64 payload offsets
    lens: np.ndarray  # int64 payload lengths
    ids: np.ndarray  # uint8 type ids
    consumed: int  # bytes covered by complete frames (tail may be partial)

    def __len__(self) -> int:
        return len(self.starts)


@dataclasses.dataclass
class ChangeColumns:
    """Columnar decoded Change records over a shared log buffer.

    String/bytes fields are (offset, len) views; ``len == -1`` marks an
    absent optional (decoded as ``''``/``b''``, matching the reference's
    observed defaults, reference: test/basic.js:16).
    """

    buf: np.ndarray
    change: np.ndarray  # uint32
    from_: np.ndarray  # uint32
    to: np.ndarray  # uint32
    key_off: np.ndarray
    key_len: np.ndarray
    sub_off: np.ndarray
    sub_len: np.ndarray
    val_off: np.ndarray
    val_len: np.ndarray

    def __len__(self) -> int:
        return len(self.change)

    def _text(self, off: int, ln: int) -> str:
        return bytes(self.buf[off: off + ln]).decode("utf-8")

    def row(self, i: int) -> Change:
        """Materialize record ``i`` as a Change object (lazy, per row)."""
        vo, vl = int(self.val_off[i]), int(self.val_len[i])
        return Change(
            key=self._text(self.key_off[i], self.key_len[i]),
            change=int(self.change[i]),
            from_=int(self.from_[i]),
            to=int(self.to[i]),
            value=b"" if vl < 0 else bytes(self.buf[vo: vo + vl]),
            subset=("" if self.sub_len[i] < 0
                    else self._text(self.sub_off[i], self.sub_len[i])),
        )


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8)
    return np.frombuffer(data, dtype=np.uint8)


def split_frames(data, allow_partial_tail: bool = False) -> FrameIndex:
    """Index every complete frame of a multibuffer stream.

    Raises ProtocolError on malformed varints or empty framed lengths;
    with ``allow_partial_tail=False`` a trailing incomplete frame is also
    an error (a *replay* log should be whole; streaming callers pass
    True and re-feed the tail).
    """
    buf = _as_u8(data)
    if _OBS.on:
        # the reference's name for its Python splitter, the port's only
        _note_engine("replay.split", "python")
    starts, lens, ids, consumed = _split_python(buf)
    if not allow_partial_tail and consumed != len(buf):
        raise ProtocolError(
            f"truncated frame at byte {consumed} of {len(buf)}")
    return FrameIndex(buf, np.asarray(starts, dtype=np.int64),
                      np.asarray(lens, dtype=np.int64),
                      np.asarray(ids, dtype=np.uint8), consumed)


def _split_python(buf: np.ndarray):
    """The reference's splitter loop, with a one-byte-varint fast path."""
    data = buf.tobytes()
    starts, lens, ids = [], [], []
    i, n = 0, len(data)
    consumed = 0
    while i < n:
        framed = data[i]
        used = 1
        if framed & 0x80:
            try:
                framed, used = decode_uvarint(data, i)
            except NeedMoreData:
                break
            except ValueError as e:
                raise ProtocolError(str(e)) from e
        if framed == 0:
            raise ProtocolError("framed length 0 (must include the id byte)")
        end = i + used + framed
        if end > n:
            break
        ids.append(data[i + used])
        starts.append(i + used + 1)
        lens.append(framed - 1)
        i = end
        consumed = i
    return starts, lens, ids, consumed


def _empty_columns(buf: np.ndarray, n: int) -> ChangeColumns:
    return ChangeColumns(
        buf=buf,
        change=np.zeros(n, dtype=np.uint32),
        from_=np.zeros(n, dtype=np.uint32),
        to=np.zeros(n, dtype=np.uint32),
        key_off=np.zeros(n, dtype=np.int64),
        key_len=np.full(n, -1, dtype=np.int64),
        sub_off=np.zeros(n, dtype=np.int64),
        sub_len=np.full(n, -1, dtype=np.int64),
        val_off=np.zeros(n, dtype=np.int64),
        val_len=np.full(n, -1, dtype=np.int64),
    )


def decode_change_columns(buf: np.ndarray, starts: np.ndarray,
                          lens: np.ndarray) -> ChangeColumns:
    """Decode the given record extents as Change rows, columnar.

    Raises ProtocolError ``corrupt Change record at index r`` for the
    first record the per-record codec rejects."""
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    cols = _empty_columns(buf, n)
    if n == 0:
        return cols
    rest = np.nonzero(~_walk_fields(cols, buf, starts, lens))[0]
    if len(rest):
        _decode_records(cols, buf, starts, lens, rest)
    return cols


def _uvarints(buf: np.ndarray, pos: np.ndarray, end: np.ndarray):
    """The varint at each ``pos`` (ending before ``end``): ``(value
    uint64, bytes used, good)``; ``good`` is False where
    ``decode_uvarint`` would raise (truncated, over 10 bytes or 64
    bits)."""
    m = len(pos)
    val = np.zeros(m, np.uint64)
    used = np.zeros(m, np.int64)
    good = np.zeros(m, bool)
    live = np.arange(m)
    for k in range(10):
        at = pos[live] + k
        inside = at < end[live]
        live = live[inside]
        if not len(live):
            break
        b = buf[at[inside]].astype(np.uint64)
        val[live] |= (b & np.uint64(0x7F)) << np.uint64(7 * k)
        last = (b & np.uint64(0x80)) == 0
        # the tenth byte may carry one bit: more is past 64 bits
        fin = live[last & (b <= 1)] if k == 9 else live[last]
        good[fin] = True
        used[fin] = k + 1
        live = live[~last]
    return val, used, good


def _walk_fields(cols: ChangeColumns, buf: np.ndarray, starts: np.ndarray,
                 lens: np.ndarray) -> np.ndarray:
    """Decode every record's fields, one field of all live records a
    step, into ``cols``; returns the mask of records decoded whole.

    The rules are the per-record codec's: unknown fields are skipped,
    the last occurrence of a field wins, every subset and key occurrence
    must be UTF-8, and key, change, from and to are required."""
    n = len(starts)
    end = np.minimum(starts + lens, len(buf))
    pos = starts.copy()
    done = np.ones(n, bool)
    have = np.zeros((3, n), bool)  # change, from, to seen
    texts: list[tuple[np.ndarray, np.ndarray]] = []  # subset/key extents
    live = np.nonzero(pos < end)[0]
    while len(live) >= _WALK_MIN:
        p, e = pos[live], end[live]
        tag, used, ok = _uvarints(buf, p, e)
        p = p + used
        wt = tag & np.uint64(7)
        m = np.nonzero(ok & (wt == 0))[0]
        if len(m):
            v, used, good = _uvarints(buf, p[m], e[m])
            ok[m[~good]] = False
            p[m] += used
            rows, t = live[m], tag[m]
            for k, (want, col) in enumerate(((_TAG_CHANGE, cols.change),
                                             (_TAG_FROM, cols.from_),
                                             (_TAG_TO, cols.to))):
                s = good & (t == want)
                col[rows[s]] = (v[s] & _U32).astype(np.uint32)
                have[k, rows[s]] = True
        m = np.nonzero(ok & (wt == 2))[0]
        if len(m):
            ln, used, good = _uvarints(buf, p[m], e[m])
            at = p[m] + used
            good &= ln <= (e[m] - at).astype(np.uint64)
            ok[m[~good]] = False
            ln = np.where(good, ln, 0).astype(np.int64)
            rows, t = live[m], tag[m]
            for want, off, size in ((_TAG_SUBSET, cols.sub_off, cols.sub_len),
                                    (_TAG_KEY, cols.key_off, cols.key_len),
                                    (_TAG_VALUE, cols.val_off, cols.val_len)):
                s = good & (t == want)
                off[rows[s]] = at[s]
                size[rows[s]] = ln[s]
                if want != _TAG_VALUE:
                    texts.append((at[s], ln[s]))
            p[m] = at + ln
        for want, width in ((5, 4), (1, 8)):  # fixed32 / fixed64 skips
            m = np.nonzero(ok & (wt == want))[0]
            ok[m[p[m] + width > e[m]]] = False
            p[m] += width
        ok &= (wt == 0) | (wt == 1) | (wt == 2) | (wt == 5)
        done[live[~ok]] = False
        pos[live] = p
        live = live[ok & (p < e)]
    done[live] = False
    done &= (cols.key_len >= 0) & have.all(axis=0)
    if texts:
        offs = np.concatenate([o for o, _ in texts])
        sizes = np.concatenate([s for _, s in texts])
        if not _all_utf8(buf, offs, sizes):
            done[:] = False  # the per-record decode finds the record
    return done


def _all_utf8(buf: np.ndarray, offs: np.ndarray, sizes: np.ndarray) -> bool:
    """Whether every extent is UTF-8: the concatenation decodes and no
    extent starts on a continuation byte."""
    heap = ragged_gather(buf, offs, sizes)
    try:
        heap.tobytes().decode("utf-8")
    except UnicodeDecodeError:
        return False
    starts = np.cumsum(sizes) - sizes
    inner = starts[(starts > 0) & (starts < len(heap))]
    return not bool(((heap[inner] & 0xC0) == 0x80).any())


def _decode_records(cols: ChangeColumns, buf: np.ndarray, starts, lens,
                    rows) -> None:
    """The reference's per-record decode of ``rows`` (in order): the
    scalar codec per record, then its extents by a second tag scan."""
    view = memoryview(np.ascontiguousarray(buf, dtype=np.uint8))
    for r in rows.tolist():
        i, ln = int(starts[r]), int(lens[r])
        try:
            ch = decode_change(view[i: i + ln])
        except ValueError as e:
            raise ProtocolError(f"corrupt Change record at index {r}") from e
        cols.change[r] = ch.change
        cols.from_[r] = ch.from_
        cols.to[r] = ch.to
        _fallback_locate(cols, r, buf, i, ln)


def _fallback_locate(cols: ChangeColumns, r: int, buf, start: int,
                     ln: int) -> None:
    """Populate (off, len) views for the per-record path by re-scanning
    tags."""
    view = memoryview(buf)[start: start + ln]
    i, n = 0, ln
    while i < n:
        tag, used = decode_uvarint(view, i)
        i += used
        wt = tag & 7
        if wt == 0:
            _, used = decode_uvarint(view, i)
            i += used
        elif wt == 2:
            fl, used = decode_uvarint(view, i)
            i += used
            fno = tag >> 3
            if fno == 1:
                cols.sub_off[r], cols.sub_len[r] = start + i, fl
            elif fno == 2:
                cols.key_off[r], cols.key_len[r] = start + i, fl
            elif fno == 6:
                cols.val_off[r], cols.val_len[r] = start + i, fl
            i += fl
        elif wt == 5:
            i += 4
        else:
            i += 8


def _put_uvarints(out: np.ndarray, at: np.ndarray, values) -> None:
    """Write the varint of each ``values[i]`` at ``out[at[i]:]``."""
    v = np.asarray(values).astype(np.uint64)
    at = at.copy()
    idx = np.arange(len(v))
    while len(idx):
        more = v[idx] > 0x7F
        out[at[idx]] = ((v[idx] & np.uint64(0x7F))
                        | (more.astype(np.uint64) << np.uint64(7)))
        v[idx] >>= np.uint64(7)
        at[idx] += 1
        idx = idx[more]


def _encode_per_record(buf: np.ndarray, change, from_, to, key_off, key_len,
                       sub_off, sub_len, val_off, val_len):
    """Frame each row as a per-record ``Change`` frame, as
    ``frame(TYPE_CHANGE, encode_change(row))`` writes it (negative
    subset/value lengths mean absent): ``(wire uint8, payload starts,
    payload lengths)``."""
    vsz = uvarint_sizes
    kl = np.asarray(key_len, dtype=np.int64)
    sl = np.asarray(sub_len, dtype=np.int64)
    vl = np.asarray(val_len, dtype=np.int64)
    has_sub, has_val = sl >= 0, vl >= 0
    sl0, vl0 = np.maximum(sl, 0), np.maximum(vl, 0)
    fields = [  # (tag, varint value or None, extent, present) in order
        (_TAG_SUBSET, sl0, (sub_off, sl0), has_sub),
        (_TAG_KEY, kl, (key_off, kl), None),
        (_TAG_CHANGE, change, None, None),
        (_TAG_FROM, from_, None, None),
        (_TAG_TO, to, None, None),
        (_TAG_VALUE, vl0, (val_off, vl0), has_val),
    ]
    sizes = []
    for _, value, extent, present in fields:
        size = 1 + vsz(value) + (extent[1] if extent is not None else 0)
        sizes.append(size if present is None else np.where(present, size, 0))
    plen = sum(sizes)
    head = vsz(plen + 1) + 1
    flen = head + plen
    fstart = np.cumsum(flen) - flen
    out = np.empty(int(flen.sum()), dtype=np.uint8)
    _put_uvarints(out, fstart, plen + 1)
    out[fstart + head - 1] = TYPE_CHANGE
    at = fstart + head
    payload_at = at
    for (tag, value, extent, present), size in zip(fields, sizes):
        rows = slice(None) if present is None else present
        p = at[rows]
        out[p] = tag
        val = np.asarray(value)[rows]
        _put_uvarints(out, p + 1, val)
        if extent is not None:
            ragged_copy(out, p + 1 + vsz(val), buf,
                        np.asarray(extent[0])[rows], extent[1][rows])
        at = at + size
    return out, payload_at, plen


def _encode_columns_per_record(cols: ChangeColumns, present_empty=False):
    """:func:`_encode_per_record` of ``cols``; with ``present_empty``
    absent optionals are written present-empty, as ``cols.row(i)``
    materializes them."""
    sl, vl = np.asarray(cols.sub_len), np.asarray(cols.val_len)
    if present_empty:
        sl, vl = np.maximum(sl, 0), np.maximum(vl, 0)
    return _encode_per_record(
        np.ascontiguousarray(cols.buf, dtype=np.uint8), cols.change,
        cols.from_, cols.to, cols.key_off, cols.key_len, cols.sub_off, sl,
        cols.val_off, vl)


def encode_change_columns(cols: ChangeColumns) -> bytes:
    """Frame decoded columns straight back to per-record wire bytes: the
    true inverse of :func:`replay_log` for change frames, byte for byte
    the per-record codec (absent optionals stay absent).  Blob frames
    are not part of the columns; a mixed log re-encodes as its change
    frames only."""
    if len(cols) == 0:
        return b""
    return _encode_columns_per_record(cols)[0].tobytes()


def encode_change_log(records: list[Change | dict]) -> bytes:
    """Encode Change records as a framed wire log (replay_log's
    inverse)."""
    return b"".join(frame(TYPE_CHANGE, encode_change(r)) for r in records)


def replay_log(data) -> tuple[ChangeColumns, FrameIndex]:
    """Replay a whole change-log buffer: BASELINE configs[1]'s engine.

    Returns the decoded change columns plus the full frame index (blob
    frames stay as extents in the index for the blob pipelines).
    Handles per-record ``Change`` frames, negotiated columnar
    ``ChangeBatch`` frames, and any interleaving of the two — rows come
    back in wire order either way, with every string/bytes extent
    addressing the ONE log buffer (batch extents are decoded with their
    payload's absolute base offset).  Unknown frame type ids raise
    ProtocolError, mirroring the decoder's fail-fast
    (reference: decode.js:159-161).
    """
    frames = split_frames(data)
    known = ((frames.ids == TYPE_CHANGE) | (frames.ids == TYPE_BLOB)
             | (frames.ids == TYPE_CHANGE_BATCH))
    if not bool(known.all()):
        bad = int(frames.ids[~known][0])
        raise ProtocolError(f"Protocol error, unknown type: {bad}")
    sel = frames.ids == TYPE_CHANGE
    bsel = frames.ids == TYPE_CHANGE_BATCH
    if not bool(bsel.any()):
        cols = decode_change_columns(
            frames.buf, frames.starts[sel], frames.lens[sel])
        return cols, frames
    return _replay_with_batches(frames, sel, bsel), frames


def _replay_with_batches(frames: FrameIndex, sel: np.ndarray,
                         bsel: np.ndarray) -> ChangeColumns:
    """Stitch per-record and batch-frame rows back into wire order: the
    per-record rows decode in one pass and slice into the output as the
    runs between batch frames."""
    from ..wire.batch_codec import decode_change_batch

    cols_pr = decode_change_columns(
        frames.buf, frames.starts[sel], frames.lens[sel])
    # frames contributing rows, in wire order; change-frame runs between
    # batch frames map to consecutive cols_pr row ranges
    row_frames = np.nonzero(sel | bsel)[0]
    is_batch = bsel[row_frames]
    batch_at = np.nonzero(is_batch)[0]
    parts: list[tuple] = []  # (cols-like, lo, hi)
    pr_done = 0
    prev = 0
    for k in batch_at.tolist():
        run = k - prev  # change frames before this batch frame
        if run:
            parts.append((cols_pr, pr_done, pr_done + run))
            pr_done += run
        fi = int(row_frames[k])
        start = int(frames.starts[fi])
        flen = int(frames.lens[fi])
        try:
            bc = decode_change_batch(
                frames.buf[start:start + flen], base=start, buf=frames.buf)
        except ValueError as e:
            raise ProtocolError(str(e)) from e
        parts.append((bc, 0, len(bc.change)))
        prev = k + 1
    tail = len(row_frames) - prev
    if tail:
        parts.append((cols_pr, pr_done, pr_done + tail))

    def cat(field: str, dtype) -> np.ndarray:
        if not parts:
            return np.zeros(0, dtype)
        return np.concatenate(
            [np.asarray(getattr(c, field)[lo:hi]) for c, lo, hi in parts]
        ).astype(dtype, copy=False)

    return ChangeColumns(
        buf=frames.buf,
        change=cat("change", np.uint32),
        from_=cat("from_", np.uint32),
        to=cat("to", np.uint32),
        key_off=cat("key_off", np.int64),
        key_len=cat("key_len", np.int64),
        sub_off=cat("sub_off", np.int64),
        sub_len=cat("sub_len", np.int64),
        val_off=cat("val_off", np.int64),
        val_len=cat("val_len", np.int64),
    )


def _slice_columns(cols: ChangeColumns, lo: int, hi: int) -> ChangeColumns:
    """Row-range view of decoded columns (numpy slices, shared buf)."""
    return ChangeColumns(
        buf=cols.buf,
        change=cols.change[lo:hi], from_=cols.from_[lo:hi],
        to=cols.to[lo:hi],
        key_off=cols.key_off[lo:hi], key_len=cols.key_len[lo:hi],
        sub_off=cols.sub_off[lo:hi], sub_len=cols.sub_len[lo:hi],
        val_off=cols.val_off[lo:hi], val_len=cols.val_len[lo:hi],
    )


def encode_batch_frames(cols: ChangeColumns,
                        rows_per_batch: int = 65536) -> bytes:
    """Frame decoded columns as ``TYPE_CHANGE_BATCH`` wire bytes — the
    columnar counterpart of :func:`encode_change_columns`.  One frame
    per ``rows_per_batch`` rows: bigger batches amortize the dictionary
    further but hold more memory per frame on the receiver."""
    from ..wire.batch_codec import encode_columns

    n = len(cols)
    out = []
    for lo in range(0, n, rows_per_batch):
        payload = encode_columns(_slice_columns(cols, lo,
                                                min(n, lo + rows_per_batch)))
        out.append(frame(TYPE_CHANGE_BATCH, payload))
    return b"".join(out)


def canonical_change_extents(cols: ChangeColumns):
    """Canonical per-record payload extents for decoded columns:
    ``(buf, offs, lens)`` where ``buf[offs[i]:offs[i]+lens[i]]`` is row
    i's per-record protobuf encoding.  The digest/merkle contract is
    framing-independent — batch-framed rows hash the SAME bytes a
    per-record peer put on the wire — so consumers re-encode and index
    the result (the encoder's own layout, the extents
    ``split_frames`` would find)."""
    return _encode_columns_per_record(cols)


def canonical_change_payloads(cols: ChangeColumns) -> list[bytes]:
    """Row-order list of canonical per-record payload bytes (the digest
    pipeline's submit unit) for decoded columns."""
    buf, offs, lens = canonical_change_extents(cols)
    data = buf.tobytes()
    return [data[o:o + ln] for o, ln in zip(offs.tolist(), lens.tolist())]
