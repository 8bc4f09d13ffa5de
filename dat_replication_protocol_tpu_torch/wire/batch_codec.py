"""Columnar ``ChangeBatch`` payload codec (frame type ``TYPE_CHANGE_BATCH``).

The port's copy of ``dat_replication_protocol_tpu/wire/batch_codec.py``
without its native C encoder.  N change records travel as ONE frame:
column-major fixed-width arrays with dictionary-coded keys and subsets,
so a replay decodes with array reinterpretation and a handful of header
varints, and the wire stops re-spelling hot keys on every row.  The
frame is negotiated: an encoder emits it only to a peer that advertised
``CAP_CHANGE_BATCH``.

Payload layout (version 1; all integers little-endian)::

    u8      version                  (= BATCH_VERSION)
    u8      kw   key-index width     (1 | 2 | 4)
    u8      sw   subset-index width  (0 | 1 | 2 | 4; 0 = batch has none)
    u8      vw   value-length width  (0 | 1 | 2 | 4; 0 = batch has none)
    u8      dw   dict-length width   (1 | 2 | 4)
    varint  nrows
    varint  nkeys                    key-dictionary entry count
    varint  nsubs                    subset-dictionary entry count
    varint  val_heap_len             total bytes of present values
    nkeys x dw    key dict entry lengths
    [key heap]                       concatenated key bytes
    nsubs x dw    subset dict entry lengths
    [subset heap]                    concatenated subset bytes
    nrows x u32   change
    nrows x u32   from
    nrows x u32   to
    nrows x kw    key dict index
    nrows x sw    subset dict index    (all-ones sentinel = absent)
    nrows x vw    value length         (all-ones sentinel = absent)
    [value heap]                     present values, row order

An absent optional is the all-ones sentinel, a present-empty one a real
dictionary entry or a length of 0, so absent and present-empty survive
the roundtrip as in the per-record codec.  Each width is the smallest
whose all-ones value exceeds the largest value it must hold, so the
sentinel never collides with a valid index or length.
"""

from __future__ import annotations

import numpy as np

from .varint import NeedMoreData, decode_uvarint, encode_uvarint

BATCH_VERSION = 1

# the one place the width ladder is written down (encode + decode agree)
_WIDTH_DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32}

# bytes moved per step of ragged_copy: bounds its index arrays
_GATHER_CHUNK = 1 << 23


def _pick_width(max_value: int) -> int:
    """Smallest width whose ALL-ONES value strictly exceeds ``max_value``
    (so the sentinel stays unambiguous)."""
    for w in (1, 2, 4):
        if max_value < (1 << (8 * w)) - 1:
            return w
    raise ValueError(f"value {max_value} exceeds ChangeBatch width ladder")


def _sentinel(width: int) -> int:
    return (1 << (8 * width)) - 1


class _Writer:
    __slots__ = ("parts",)

    def __init__(self) -> None:
        self.parts: list[bytes] = []

    def u8(self, v: int) -> None:
        self.parts.append(bytes((v,)))

    def varint(self, v: int) -> None:
        self.parts.append(encode_uvarint(v))

    def array(self, arr: np.ndarray) -> None:
        self.parts.append(arr.tobytes())

    def raw(self, b) -> None:
        self.parts.append(bytes(b))

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def ragged_copy(dst: np.ndarray, dst_offs, src: np.ndarray, src_offs,
                lens) -> None:
    """``dst[dst_offs[i]:+lens[i]] = src[src_offs[i]:+lens[i]]`` for
    every extent (lengths >= 0), as numpy gathers in steps of at most
    ``_GATHER_CHUNK`` bytes."""
    dst_offs = np.asarray(dst_offs, dtype=np.int64)
    src_offs = np.asarray(src_offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    ends = np.cumsum(lens)
    lo = 0
    while lo < len(lens):
        base = int(ends[lo - 1]) if lo else 0
        hi = max(lo + 1, int(np.searchsorted(ends, base + _GATHER_CHUNK,
                                             side="right")))
        seg = lens[lo:hi]
        # each byte's rank within its extent
        rank = np.arange(base, int(ends[hi - 1]), dtype=np.int64) \
            - np.repeat(ends[lo:hi] - seg, seg)
        dst[np.repeat(dst_offs[lo:hi], seg) + rank] = \
            src[np.repeat(src_offs[lo:hi], seg) + rank]
        lo = hi


def ragged_gather(src: np.ndarray, offs, lens) -> np.ndarray:
    """The extents ``src[offs[i]:offs[i] + lens[i]]`` (lengths >= 0)
    concatenated in order, as one uint8 array."""
    lens = np.asarray(lens, dtype=np.int64)
    out = np.empty(int(lens.sum()), dtype=np.uint8)
    ragged_copy(out, np.cumsum(lens) - lens, src, offs, lens)
    return out


def encode_rows(rows) -> bytes:
    """Encode prepared row tuples as one ChangeBatch payload.

    ``rows`` is a sequence of ``(key: bytes, change: int, from_: int,
    to: int, value: bytes | None, subset: bytes | None)`` — the
    pre-validated shape the session encoder accumulates (uint32 ranges
    checked at submit time, strings already UTF-8).  The dictionary
    build is a Python dict loop (O(rows), the session-encoder tier);
    bulk replay goes through :func:`encode_columns` instead.
    """
    n = len(rows)
    key_dict: dict[bytes, int] = {}
    sub_dict: dict[bytes, int] = {}
    kidx, sidx, vlen = [], [], []
    vals: list[bytes] = []
    for key, _, _, _, val, sub in rows:
        kidx.append(key_dict.setdefault(key, len(key_dict)))
        sidx.append(-1 if sub is None
                    else sub_dict.setdefault(sub, len(sub_dict)))
        if val is None:
            vlen.append(-1)
        else:
            vlen.append(len(val))
            vals.append(val)
    return _encode_sections(
        n, list(key_dict), list(sub_dict), np.array(kidx, np.int64),
        np.array(sidx, np.int64), np.array(vlen, np.int64),
        np.array([r[1] for r in rows], np.uint32),
        np.array([r[2] for r in rows], np.uint32),
        np.array([r[3] for r in rows], np.uint32), b"".join(vals),
    )


def _dictionary(buf: np.ndarray, offs, lens) -> tuple[list[bytes], list[int]]:
    """Entries in first-occurrence order and each extent's entry index,
    as :func:`encode_rows` numbers them."""
    lens = np.asarray(lens, dtype=np.int64)
    heap = ragged_gather(buf, offs, lens).tobytes()
    ends = np.cumsum(lens).tolist()
    starts = (np.cumsum(lens) - lens).tolist()
    entries: dict[bytes, int] = {}
    index = [entries.setdefault(heap[s:e], len(entries))
             for s, e in zip(starts, ends)]
    return list(entries), index


def encode_columns(cols) -> bytes:
    """Encode decoded change columns (a ``runtime.replay.ChangeColumns``
    or anything with its fields) as one ChangeBatch payload — the bulk
    replay encode path.  Byte for byte :func:`encode_rows` of the same
    rows: the dictionaries are built by one dict pass over the gathered
    key and subset bytes, every other column and the value heap by numpy
    gathers."""
    n = len(cols.change)
    buf = np.ascontiguousarray(cols.buf, dtype=np.uint8)
    key_len = np.asarray(cols.key_len, dtype=np.int64)
    sub_len = np.asarray(cols.sub_len, dtype=np.int64)
    val_len = np.asarray(cols.val_len, dtype=np.int64)
    keys, kidx = _dictionary(buf, cols.key_off, key_len)
    present = sub_len >= 0
    subs, at = _dictionary(buf, np.asarray(cols.sub_off)[present],
                           sub_len[present])
    sidx = np.full(n, -1, np.int64)
    sidx[present] = at
    has_val = val_len >= 0
    heap = ragged_gather(buf, np.asarray(cols.val_off)[has_val],
                         val_len[has_val])
    return _encode_sections(
        n, keys, subs, np.asarray(kidx, dtype=np.int64), sidx,
        np.where(has_val, val_len, -1),
        np.asarray(cols.change, dtype=np.uint32),
        np.asarray(cols.from_, dtype=np.uint32),
        np.asarray(cols.to, dtype=np.uint32), heap.tobytes(),
    )


def _encode_sections(n, keys: list[bytes], subs: list[bytes],
                     kidx: np.ndarray, sidx: np.ndarray, vlen: np.ndarray,
                     chg: np.ndarray, frm: np.ndarray, tov: np.ndarray,
                     val_heap: bytes) -> bytes:
    """Assemble the payload from dictionary lists + index/len columns
    (sidx/vlen use -1 for absent; widths and sentinels chosen here)."""
    nkeys, nsubs = len(keys), len(subs)
    kw = _pick_width(max(nkeys - 1, 0))
    sw = 0 if nsubs == 0 else _pick_width(nsubs - 1)
    max_vlen = int(vlen.max()) if n else -1
    vw = 0 if max_vlen < 0 else _pick_width(max_vlen)
    all_lens = [len(k) for k in keys] + [len(s) for s in subs]
    dw = _pick_width(max(all_lens) if all_lens else 0)
    w = _Writer()
    w.u8(BATCH_VERSION)
    w.u8(kw)
    w.u8(sw)
    w.u8(vw)
    w.u8(dw)
    w.varint(n)
    w.varint(nkeys)
    w.varint(nsubs)
    w.varint(len(val_heap))
    ddt = _WIDTH_DTYPES[dw]
    w.array(np.asarray([len(k) for k in keys], dtype=ddt))
    w.raw(b"".join(keys))
    w.array(np.asarray([len(s) for s in subs], dtype=ddt))
    w.raw(b"".join(subs))
    w.array(np.ascontiguousarray(chg, dtype="<u4"))
    w.array(np.ascontiguousarray(frm, dtype="<u4"))
    w.array(np.ascontiguousarray(tov, dtype="<u4"))
    w.array(kidx.astype(_WIDTH_DTYPES[kw]))
    if sw:
        s = np.where(sidx < 0, _sentinel(sw), sidx)
        w.array(s.astype(_WIDTH_DTYPES[sw]))
    if vw:
        v = np.where(vlen < 0, _sentinel(vw), vlen)
        w.array(v.astype(_WIDTH_DTYPES[vw]))
    w.raw(val_heap)
    return w.getvalue()


def uvarint_sizes(a) -> np.ndarray:
    """Bytes of the unsigned LEB128 varint of each element (int64)."""
    a = np.asarray(a, dtype=np.uint64)
    size = np.ones(a.shape, np.int64)
    x = a >> np.uint64(7)
    while True:
        nz = x > 0
        if not nz.any():
            return size
        size += nz
        x = x >> np.uint64(7)


def estimate_per_record_bytes(key_lens: np.ndarray, sub_lens: np.ndarray,
                              val_lens: np.ndarray,
                              chg: np.ndarray, frm: np.ndarray,
                              tov: np.ndarray) -> int:
    """Exact total wire bytes the same rows would cost as per-record
    ``Change`` frames.  Vectorized uvarint-size arithmetic; -1 lens mean
    absent optionals, matching the codec."""
    vsz = uvarint_sizes
    kl = key_lens.astype(np.int64)
    sl = sub_lens.astype(np.int64)
    vl = val_lens.astype(np.int64)
    payload = 1 + vsz(kl) + kl
    payload = payload + np.where(sl >= 0, 1 + vsz(np.maximum(sl, 0)) + sl, 0)
    payload = payload + 1 + vsz(chg) + 1 + vsz(frm) + 1 + vsz(tov)
    payload = payload + np.where(vl >= 0, 1 + vsz(np.maximum(vl, 0)) + vl, 0)
    return int((payload + vsz(payload + 1) + 1).sum())


def decode_change_batch(payload, base: int = 0, buf=None):
    """Decode one ChangeBatch payload into change columns.

    Returns a :class:`..runtime.replay.ChangeColumns` whose ``buf`` is
    the payload itself (as uint8) and whose string/bytes extents point
    at the dictionary heaps / value heap inside it.  Callers replaying a
    whole log pass ``base`` (the payload's absolute offset) together
    with ``buf`` (the enclosing log buffer) so the extents address the
    log buffer directly — ``base`` without ``buf`` would return extents
    that overrun the payload.  Pure numpy: the only per-row work is
    ``np.take`` over the dictionaries.  Raises ``ValueError`` on any
    structural corruption (bad version/width, truncated section,
    out-of-range index, heap-length mismatch, invalid dictionary UTF-8).
    """
    from ..runtime.replay import ChangeColumns

    if isinstance(payload, np.ndarray):
        arr = np.ascontiguousarray(payload, dtype=np.uint8)
        data = arr.tobytes() if len(arr) < 64 else None
    else:
        arr = np.frombuffer(payload, dtype=np.uint8)
        data = None
    total = len(arr)
    head = bytes(arr[: min(64, total)]) if data is None else data
    try:
        if total < 9:
            raise NeedMoreData("short batch header")
        version = head[0]
        if version != BATCH_VERSION:
            raise ValueError(f"unsupported ChangeBatch version {version}")
        kw, sw, vw, dw = head[1], head[2], head[3], head[4]
        if kw not in (1, 2, 4) or dw not in (1, 2, 4) \
                or sw not in (0, 1, 2, 4) or vw not in (0, 1, 2, 4):
            raise ValueError(
                f"bad ChangeBatch widths kw={kw} sw={sw} vw={vw} dw={dw}")
        i = 5
        nrows, used = decode_uvarint(head, i)
        i += used
        nkeys, used = decode_uvarint(head, i)
        i += used
        nsubs, used = decode_uvarint(head, i)
        i += used
        vheap_len, used = decode_uvarint(head, i)
        i += used
    except NeedMoreData as e:
        raise ValueError(f"corrupt ChangeBatch payload: {e}") from e
    if nrows and nkeys == 0:
        raise ValueError("ChangeBatch has rows but an empty key dictionary")

    def take(nbytes: int, what: str) -> slice:
        nonlocal i
        if i + nbytes > total:
            raise ValueError(
                f"truncated ChangeBatch: {what} needs {nbytes} byte(s) "
                f"at offset {i} of {total}")
        s = slice(i, i + nbytes)
        i += nbytes
        return s

    def column(count: int, width: int, what: str) -> np.ndarray:
        s = take(count * width, what)
        return arr[s].view(f"<u{width}").astype(np.int64)

    klens = column(nkeys, dw, "key dict lengths")
    if (klens < 0).any():
        raise ValueError("negative key dict length")
    kheap_at = i
    kheap = take(int(klens.sum()), "key heap")
    koffs = np.concatenate(([0], np.cumsum(klens)[:-1])) + kheap_at \
        if nkeys else np.zeros(0, np.int64)
    slens = column(nsubs, dw, "subset dict lengths")
    sheap_at = i
    sheap = take(int(slens.sum()), "subset heap")
    soffs = np.concatenate(([0], np.cumsum(slens)[:-1])) + sheap_at \
        if nsubs else np.zeros(0, np.int64)
    chg = arr[take(4 * nrows, "change column")].view("<u4")
    frm = arr[take(4 * nrows, "from column")].view("<u4")
    tov = arr[take(4 * nrows, "to column")].view("<u4")
    kidx = column(nrows, kw, "key index column")
    if nrows and int(kidx.max(initial=0)) >= nkeys:
        raise ValueError("ChangeBatch key index out of dictionary range")
    if sw:
        sidx = column(nrows, sw, "subset index column")
        sent = _sentinel(sw)
        s_absent = sidx == sent
        if nrows and int(np.where(s_absent, 0, sidx).max(initial=0)) >= nsubs \
                and not bool(s_absent.all()):
            raise ValueError("ChangeBatch subset index out of range")
    else:
        sidx = np.zeros(nrows, np.int64)
        s_absent = np.ones(nrows, bool)
    if vw:
        vl = column(nrows, vw, "value length column")
        sent = _sentinel(vw)
        v_absent = vl == sent
        vl = np.where(v_absent, 0, vl)
    else:
        vl = np.zeros(nrows, np.int64)
        v_absent = np.ones(nrows, bool)
    if int(vl.sum()) != vheap_len:
        raise ValueError(
            f"ChangeBatch value heap mismatch: lengths sum to "
            f"{int(vl.sum())}, header says {vheap_len}")
    vheap_at = i
    take(vheap_len, "value heap")
    if i != total:
        raise ValueError(
            f"ChangeBatch payload has {total - i} trailing byte(s)")
    # dictionary UTF-8, validated vectorized: the whole heap decodes
    # once, and no entry may START on a continuation byte — together
    # that proves every single entry is valid UTF-8 (a concatenation of
    # valid strings is valid; aligned boundaries make each segment a
    # whole number of characters)
    _check_heap_utf8(arr, kheap, koffs - kheap_at, "key")
    _check_heap_utf8(arr, sheap, soffs - sheap_at, "subset")

    voffs = (np.concatenate(([0], np.cumsum(vl)[:-1])) + vheap_at
             if nrows else np.zeros(0, np.int64))
    b = np.int64(base)
    if nsubs and nrows:
        sidx_c = np.where(s_absent, 0, sidx)
        sub_off = np.where(s_absent, 0, np.take(soffs, sidx_c) + b)
        sub_len = np.where(s_absent, -1, np.take(slens, sidx_c))
    else:
        sub_off = np.zeros(nrows, np.int64)
        sub_len = np.full(nrows, -1, np.int64)
    return ChangeColumns(
        buf=arr if buf is None else buf,
        change=np.ascontiguousarray(chg),
        from_=np.ascontiguousarray(frm),
        to=np.ascontiguousarray(tov),
        key_off=(np.take(koffs, kidx) + b if nrows
                 else np.zeros(0, np.int64)),
        key_len=(np.take(klens, kidx) if nrows else np.zeros(0, np.int64)),
        sub_off=sub_off,
        sub_len=sub_len,
        val_off=np.where(v_absent, 0, voffs + b),
        val_len=np.where(v_absent, -1, vl),
    )


def _check_heap_utf8(arr: np.ndarray, heap: slice, starts_rel: np.ndarray,
                     what: str) -> None:
    """Validate a dictionary heap's UTF-8 (see decode): one whole-heap
    decode plus a vectorized entry-boundary alignment check."""
    heap_arr = arr[heap]
    if not len(heap_arr):
        return
    try:
        heap_arr.tobytes().decode("utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(
            f"ChangeBatch {what} dictionary is not UTF-8: {e}") from e
    inner = starts_rel[(starts_rel > 0) & (starts_rel < len(heap_arr))]
    if len(inner) and bool(((heap_arr[inner] & 0xC0) == 0x80).any()):
        raise ValueError(
            f"ChangeBatch {what} dictionary entry splits a multibyte "
            f"UTF-8 character")
