"""Rateless coded-symbol set reconciliation.

The counterpart of ``dat_replication_protocol_tpu/ops/rateless.py``.
Coded symbols cost O(k) wire for a k-element symmetric difference, with
no prior estimate of k ("Practical Rateless Set Reconciliation").

* An element is a 32-byte record digest.  It participates in coded
  symbol 0, then at gaps drawn so the participation probability at index
  i decays as ``1/(1 + i/2)``: given participation at i and a uniform
  ``u = (r+1)/2**32``, the next index is
  ``i + ceil((i + 1.5) * (2**16/sqrt(r+1) - 1))``.  The draws are
  splitmix64 seeded by the digest's first 8 bytes (LE), so the mapping
  is recomputable from a recovered element alone.
* A coded symbol is 11 u32 words ``[count | checksum lo | checksum hi |
  sum[0..8)]``: word-wise wrapping-u32 sums of the participating
  elements' rows, so the build is a plain scatter-add.
* The receiver subtracts its own symbols for the same indices and peels:
  a cell with count +-1 whose checksum matches its sum is pure, and the
  sum is an element held only by the sender (+1) or only by the receiver
  (-1).  Peeling subtracts recovered elements from their other cells
  until every cell is zero.

The index mapping (:class:`IndexCursor`) stays host numpy in float64:
one owner of the float math, so no route forks the mapping.  The
scatter-add build runs on the device (:func:`build_symbols_device`, a
torch gather plus ``index_add_``, as the reference leaves it to XLA);
:func:`build_symbols_host` is the numpy reference.  Peeling is host
numpy.  Elements are a SET: dedupe first (:func:`dedupe_digests`).

The weighted variant (cells of 12 words, the last the element's byte
length; gaps divided by ``weight_class + 1``) reconciles (digest, length)
elements, such as the chunk sets of a snapshot.

Telemetry: each prefix extension is a ``reconcile.build`` span and counts
its new cells in ``reconcile.symbols``; each peel is a
``reconcile.peel`` span and counts its recovered elements in
``reconcile.peeled``; the device build is the kernel-sentinel site
``ops.rateless.build``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..obs.device import kernel_site, rows_key
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..utils.device import resolve_device
from ..utils.trace import span
from .reconcile import scatter_add_words

# coded symbols built and elements peeled (OBSERVABILITY.md catalog)
_M_SYMBOLS = _counter("reconcile.symbols")
_M_PEELED = _counter("reconcile.peeled")

DIGEST_BYTES = 32
DIGEST_WORDS = 8
SYMBOL_WORDS = 11  # count + 2 checksum words + 8 sum words
SYMBOL_BYTES = SYMBOL_WORDS * 4
WSYMBOL_WORDS = 12  # count + 2 checksum words + 8 sum words + length
WSYMBOL_BYTES = WSYMBOL_WORDS * 4

# splitmix64 (Steele, Lea and Flood): the golden-ratio increment and the
# two multipliers of its finalizer
RATELESS_GAMMA = 0x9E3779B97F4A7C15
RATELESS_MIX1 = 0xBF58476D1CE4E5B9
RATELESS_MIX2 = 0x94D049BB133111EB

# weighted participation: weight class ``min(W_CAP, bit_length(len >>
# W_SHIFT))``, index gaps divided by ``class + 1``
RATELESS_W_SHIFT = 12
RATELESS_W_CAP = 8

_GAMMA = np.uint64(RATELESS_GAMMA)
_MIX1 = np.uint64(RATELESS_MIX1)
_MIX2 = np.uint64(RATELESS_MIX2)


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: the one bit-mixing primitive here (PRNG
    draws and checksums both ride it)."""
    z = z.astype(np.uint64, copy=True)
    z ^= z >> np.uint64(30)
    z *= _MIX1
    z ^= z >> np.uint64(27)
    z *= _MIX2
    z ^= z >> np.uint64(31)
    return z


def _digest_words(digests: np.ndarray) -> np.ndarray:
    """(n, 32) u8 digests -> (n, 8) u32 LE words (zero-copy view)."""
    d = np.ascontiguousarray(digests, dtype=np.uint8)
    if d.ndim != 2 or d.shape[1] != DIGEST_BYTES:
        raise ValueError(f"digests must be (n, {DIGEST_BYTES}) bytes")
    return d.view("<u4")


def _checksum_lanes(sum_words: np.ndarray) -> np.ndarray:
    """The four u64 lanes of each digest row chained through
    :func:`_mix64`."""
    lanes = np.ascontiguousarray(sum_words, dtype=np.uint32).view("<u8")
    acc = _mix64(lanes[:, 0] + _GAMMA)
    for k in range(1, 4):
        acc = _mix64(acc ^ lanes[:, k])
    return acc


def _split_u64(acc: np.ndarray) -> np.ndarray:
    out = np.empty((len(acc), 2), dtype=np.uint32)
    out[:, 0] = (acc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 1] = (acc >> np.uint64(32)).astype(np.uint32)
    return out


def checksum_words(sum_words: np.ndarray) -> np.ndarray:
    """64-bit checksum of each digest row, as (n, 2) u32 words, from the
    8 sum words alone (recomputable from a recovered value)."""
    return _split_u64(_checksum_lanes(sum_words))


def element_rows(digests: np.ndarray) -> np.ndarray:
    """(n, 32) u8 digests -> (n, 11) u32 symbol rows (count=1)."""
    words = _digest_words(digests)
    rows = np.empty((len(words), SYMBOL_WORDS), dtype=np.uint32)
    rows[:, 0] = 1
    rows[:, 1:3] = checksum_words(words)
    rows[:, 3:] = words
    return rows


def dedupe_digests(digests: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unique digest rows (first-occurrence order) + their source rows:
    ``(unique (m, 32) u8, first_index (m,) int64)``.

    Sorts by the first u64 word and resolves only the colliding runs
    against the full rows, so distinct digests sharing a first word are
    never merged."""
    d = np.ascontiguousarray(digests, dtype=np.uint8)
    n = len(d)
    if n == 0:
        return d.reshape(0, DIGEST_BYTES), np.empty(0, np.int64)
    k0 = d.view("<u8")[:, 0]
    order = np.argsort(k0, kind="stable").astype(np.int64)
    sk = k0[order]
    bounds = np.nonzero(np.concatenate(([True], sk[1:] != sk[:-1])))[0]
    if len(bounds) == n:  # every first word unique: nothing to resolve
        return d, np.arange(n, dtype=np.int64)
    keep = np.ones(n, dtype=bool)
    bounds = np.append(bounds, n)
    for ri in np.nonzero(np.diff(bounds) > 1)[0]:
        run = order[bounds[ri]:bounds[ri + 1]]  # ascending (stable sort)
        seen: set[bytes] = set()
        for i in run:
            b = d[i].tobytes()
            if b in seen:
                keep[i] = False
            else:
                seen.add(b)
    first = np.nonzero(keep)[0].astype(np.int64)
    return d[first], first


def _advance(state: np.ndarray, nxt: np.ndarray, bound: int,
             div: np.ndarray | None = None):
    """Every participation with index < ``bound``, advancing the cursor
    arrays in place: ``(element_rows, symbol_indices)`` int64.  ``div``
    (per element) divides each gap, for the weighted cursor."""
    out_e: list[np.ndarray] = []
    out_i: list[np.ndarray] = []
    b = np.uint64(bound)
    active = np.nonzero(nxt < b)[0]
    while active.size:
        idx = nxt[active]
        out_e.append(active.astype(np.int64))
        out_i.append(idx.astype(np.int64))
        # splitmix64 step per active element; the draw's top 32 bits are
        # the uniform r of the gap formula
        st = state[active] + _GAMMA
        state[active] = st
        r = (_mix64(st) >> np.uint64(32)).astype(np.float64)
        cur = idx.astype(np.float64)
        # inverse-CDF gap for marginal density 1/(1 + i/2):
        # P(next > j | at i) = ((i+1.5)/(j+1.5))^2, u = (r+1)/2^32
        gap = np.ceil(
            (cur + 1.5) * (np.float64(1 << 16) / np.sqrt(r + 1.0) - 1.0))
        gap_u = np.maximum(gap, 1.0).astype(np.uint64)
        if div is not None:
            gap_u = np.maximum(gap_u // div[active], np.uint64(1))
        nxt[active] = idx + gap_u
        active = active[nxt[active] < b]
    if not out_e:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(out_e), np.concatenate(out_i)


class IndexCursor:
    """Per-element cursor along the coded-symbol index line.

    Every element first participates at index 0.  :meth:`advance` yields
    all (element, index) participations below a bound and leaves each
    cursor at its first index >= the bound, so growing bounds enumerate
    each participation exactly once."""

    def __init__(self, digests: np.ndarray):
        words = _digest_words(digests)
        self._state = words.view("<u8")[:, 0].astype(np.uint64, copy=True)
        self._next = np.zeros(len(words), dtype=np.uint64)

    def advance(self, bound: int) -> tuple[np.ndarray, np.ndarray]:
        """All pending participations with index < ``bound``:
        ``(element_rows, symbol_indices)`` as int64 arrays."""
        return _advance(self._state, self._next, bound)


def build_symbols_host(rows: np.ndarray, elems: np.ndarray,
                       idxs: np.ndarray, m: int,
                       base: int = 0) -> np.ndarray:
    """The numpy reference build: scatter-add ``rows[elems]`` into an
    ``(m - base, W)`` u32 cell block at ``idxs - base``."""
    cells = np.zeros((m - base, rows.shape[1]), dtype=np.uint32)
    np.add.at(cells, idxs - base, rows[elems])
    return cells


def build_symbols_device(rows, elems: np.ndarray, idxs: np.ndarray, m: int,
                         base: int = 0, device="cuda") -> np.ndarray:
    """The device build: gather ``rows[elems]`` and scatter-add them into
    an ``(m - base, W)`` cell block at ``idxs - base`` on ``device``
    (:func:`.reconcile.scatter_add_words`); returns u32 numpy.

    ``rows``: (n, W) u32 numpy, or an int32 tensor of the same bits
    already on ``device`` (callers that build repeatedly keep it there).
    """
    dev = resolve_device(device)
    width = rows.shape[1] if rows.ndim == 2 else SYMBOL_WORDS
    if len(elems) == 0 or len(rows) == 0:
        return np.zeros((m - base, width), dtype=np.uint32)
    idxs = np.asarray(idxs, dtype=np.int64)
    if idxs.min() < base or idxs.max() >= m:
        raise IndexError(f"symbol indices must lie in [{base}, {m})")
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(
            np.ascontiguousarray(rows, dtype=np.uint32).view(np.int32))
    rows = rows.to(dev)
    at = torch.from_numpy(np.asarray(elems, dtype=np.int64)).to(dev)
    cells = scatter_add_words(m - base, torch.from_numpy(idxs - base).to(dev),
                              rows.index_select(0, at))
    return cells.cpu().numpy().view(np.uint32)


# keyed on the rows' width: element and symbol counts only size the
# scatter
build_symbols_device = kernel_site("ops.rateless.build",
                                   build_symbols_device, key=rows_key(0))


class _Prefix:
    """An incrementally extended coded-symbol prefix: the cursor, the
    element rows (host and, once built, on the device) and the cells so
    far.  ``extend(m)`` pays only the new participations and returns the
    whole (m, W) u32 prefix."""

    def __init__(self, cursor, width: int, device):
        self._dev = resolve_device(device)
        self._cursor = cursor
        self._rows = None
        self._rows_dev = None
        self._cells = np.zeros((0, width), dtype=np.uint32)

    def _element_rows(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def rows(self) -> np.ndarray:
        if self._rows is None:
            self._rows = self._element_rows()
        return self._rows

    def _extend(self, m: int) -> np.ndarray:
        have = len(self._cells)
        if m <= have:
            return self._cells[:m]
        with span("reconcile.build"):
            if self._rows_dev is None:
                self._rows_dev = torch.from_numpy(
                    self.rows.view(np.int32)).to(self._dev)
            elems, idxs = self._cursor.advance(m)
            block = build_symbols_device(self._rows_dev, elems, idxs, m,
                                         have, device=self._dev)
        self._cells = np.concatenate([self._cells, block]) if have else block
        if _OBS.on:
            _M_SYMBOLS.inc(m - have)
        return self._cells


class CodedSymbols(_Prefix):
    """One replica's incrementally extended coded-symbol prefix over a
    digest set, built on ``device``."""

    def __init__(self, digests: np.ndarray, device="cuda"):
        self.digests = np.ascontiguousarray(digests, dtype=np.uint8)
        self.n = len(self.digests)
        super().__init__(IndexCursor(self.digests), SYMBOL_WORDS, device)

    def _element_rows(self) -> np.ndarray:
        return element_rows(self.digests)

    def extend(self, m: int) -> np.ndarray:
        """The (m, 11) u32 prefix (cumulative: cells [0, m))."""
        return self._extend(m)


def _neg(cells: np.ndarray) -> np.ndarray:
    """Word-wise negation mod 2**32."""
    return (np.uint32(0) - cells).astype(np.uint32)


def _counts_i32(cells: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(cells[:, 0]).view(np.int32)


def peel(work: np.ndarray, max_rounds: int = 1 << 20,
         ) -> tuple[np.ndarray, np.ndarray, bool]:
    """Peel a combined (remote - local) cell block IN PLACE.

    Returns ``(digests (k, 32) u8, signs (k,) int8, complete)``: sign +1
    for an element held only by the remote (symbol-sending) side, -1 only
    by the local side; ``complete`` iff every cell is zero afterwards."""
    with span("reconcile.peel"):
        out = _peel(work, max_rounds)
    if _OBS.on and len(out[0]):
        _M_PEELED.inc(len(out[0]))
    return out


def _peel(work: np.ndarray, max_rounds: int):
    m = len(work)
    rec_digests: list[np.ndarray] = []
    rec_signs: list[np.ndarray] = []
    for _ in range(max_rounds):
        cnt = _counts_i32(work)
        cand = np.nonzero((cnt == 1) | (cnt == -1))[0]
        if not cand.size:
            break
        signs = np.where(cnt[cand] == 1, 1, -1).astype(np.int8)
        sums = work[cand, 3:]
        css = work[cand, 1:3]
        negm = signs == -1
        if negm.any():
            sums = sums.copy()
            css = css.copy()
            sums[negm] = _neg(sums[negm])
            css[negm] = _neg(css[negm])
        ok = (checksum_words(sums) == css).all(axis=1)
        if not ok.any():
            break
        vals = np.ascontiguousarray(sums[ok], dtype=np.uint32)
        signs = signs[ok]
        digests = vals.view(np.uint8).reshape(-1, DIGEST_BYTES)
        # the same element is often pure in several cells at once
        digests, first = dedupe_digests(digests)
        signs = signs[first]
        rows = element_rows(digests)
        srows = rows.copy()
        if (signs == -1).any():
            srows[signs == -1] = _neg(rows[signs == -1])
        elems, idxs = IndexCursor(digests).advance(m)
        np.subtract.at(work, idxs, srows[elems])
        rec_digests.append(digests)
        rec_signs.append(signs)
    if rec_digests:
        digests = np.concatenate(rec_digests)
        signs = np.concatenate(rec_signs)
    else:
        digests = np.empty((0, DIGEST_BYTES), np.uint8)
        signs = np.empty(0, np.int8)
    return digests, signs, not work.any()


class _Decoder:
    """Accumulates the remote side's coded-symbol runs, which must arrive
    contiguously from index 0, beside the matching local prefix."""

    _width = SYMBOL_WORDS

    def __init__(self):
        self._remote = np.zeros((0, self._width), dtype=np.uint32)
        self.symbols_seen = 0

    def add_symbols(self, start: int, cells: np.ndarray) -> None:
        cells = np.ascontiguousarray(cells, dtype=np.uint32)
        if cells.ndim != 2 or cells.shape[1] != self._width:
            raise ValueError(f"cells must be (k, {self._width}) u32")
        if start != self.symbols_seen:
            raise ValueError(
                f"symbol run starts at {start}, expected {self.symbols_seen}")
        self._remote = np.concatenate([self._remote, cells]) \
            if self.symbols_seen else cells
        self.symbols_seen = len(self._remote)

    def _work(self):
        """remote - local over the symbols seen, or None before any."""
        m = self.symbols_seen
        if m == 0:
            return None
        return (self._remote - self.local.extend(m)).astype(np.uint32)


class PeelDecoder(_Decoder):
    """The receiving half of a rateless reconciliation: the local prefix
    is built on ``device``; :meth:`try_decode` peels remote - local."""

    def __init__(self, local_digests: np.ndarray, device="cuda",
                 assume_unique: bool = False):
        digests = np.ascontiguousarray(local_digests, dtype=np.uint8)
        if not assume_unique:
            digests, _ = dedupe_digests(digests)
        self.local = CodedSymbols(digests, device=device)
        super().__init__()

    def try_decode(self):
        """``None`` when more symbols are needed; otherwise ``(digests,
        signs)``: sign +1 remote-only, -1 local-only."""
        work = self._work()
        if work is None:
            return None
        digests, signs, complete = peel(work)
        return (digests, signs) if complete else None


# -- weighted (variable-size element) extension ------------------------------


def weight_classes(lens) -> np.ndarray:
    """Weight class per element: ``min(RATELESS_W_CAP,
    bit_length(len >> RATELESS_W_SHIFT))`` as uint64."""
    v = np.asarray(lens, dtype=np.uint64) >> np.uint64(RATELESS_W_SHIFT)
    c = np.zeros(len(v), dtype=np.uint64)
    for _ in range(RATELESS_W_CAP):
        nz = v > 0
        if not nz.any():
            break
        c[nz] += np.uint64(1)
        v = v >> np.uint64(1)
    return c


def _as_len_words(lens) -> np.ndarray:
    arr = np.asarray(lens).astype(np.int64, copy=False)
    if len(arr) and (arr < 0).any():
        raise ValueError("element lengths must be >= 0")
    if len(arr) and (arr >> 32).any():
        raise ValueError("element lengths must fit in u32")
    return arr.astype(np.uint32)


def weighted_checksum_words(sum_words: np.ndarray,
                            len_words: np.ndarray) -> np.ndarray:
    """64-bit checksum of each (digest, length) row as (n, 2) u32 words:
    :func:`checksum_words`' chain extended by one mix over the length."""
    acc = _checksum_lanes(sum_words)
    acc = _mix64(acc ^ np.asarray(len_words, np.uint32).astype(np.uint64))
    return _split_u64(acc)


def weighted_element_rows(digests: np.ndarray, lens) -> np.ndarray:
    """(n, 32) u8 digests + lengths -> (n, 12) u32 weighted symbol rows
    (count=1)."""
    words = _digest_words(digests)
    lw = _as_len_words(lens)
    if len(lw) != len(words):
        raise ValueError("digests and lens must align")
    rows = np.empty((len(words), WSYMBOL_WORDS), dtype=np.uint32)
    rows[:, 0] = 1
    rows[:, 1:3] = weighted_checksum_words(words, lw)
    rows[:, 3:11] = words
    rows[:, 11] = lw
    return rows


class WeightedIndexCursor:
    """:class:`IndexCursor` for (digest, length) elements: the same draw
    stream and gap formula, each gap divided (integer division, clamped
    to >= 1) by ``weight_class + 1``."""

    def __init__(self, digests: np.ndarray, lens):
        words = _digest_words(digests)
        lw = _as_len_words(lens)
        if len(lw) != len(words):
            raise ValueError("digests and lens must align")
        self._state = words.view("<u8")[:, 0].astype(np.uint64, copy=True)
        self._next = np.zeros(len(words), dtype=np.uint64)
        self._div = weight_classes(lw) + np.uint64(1)

    def advance(self, bound: int) -> tuple[np.ndarray, np.ndarray]:
        return _advance(self._state, self._next, bound, self._div)


class WeightedSymbols(_Prefix):
    """One replica's weighted coded-symbol prefix over a chunk set, built
    on ``device``.  A prefix may be shared by concurrent responders, so
    :meth:`extend` (a read-modify-write of the cursor) is serialized."""

    def __init__(self, digests: np.ndarray, lens, device="cuda"):
        self.digests = np.ascontiguousarray(digests, dtype=np.uint8)
        self.lens = np.ascontiguousarray(np.asarray(lens, dtype=np.int64))
        self.n = len(self.digests)
        super().__init__(WeightedIndexCursor(self.digests, self.lens),
                         WSYMBOL_WORDS, device)
        self._lock = threading.Lock()

    def _element_rows(self) -> np.ndarray:
        return weighted_element_rows(self.digests, self.lens)

    def extend(self, m: int) -> np.ndarray:
        """The (m, 12) u32 prefix (cumulative: cells [0, m))."""
        with self._lock:
            return self._extend(m)


def peel_weighted(work: np.ndarray, max_rounds: int = 1 << 20,
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """:func:`peel` for weighted cells, IN PLACE: ``(digests (k, 32) u8,
    lens (k,) int64, signs (k,) int8, complete)``."""
    with span("reconcile.peel"):
        out = _peel_weighted(work, max_rounds)
    if _OBS.on and len(out[0]):
        _M_PEELED.inc(len(out[0]))
    return out


def _peel_weighted(work: np.ndarray, max_rounds: int):
    m = len(work)
    rec_digests: list[np.ndarray] = []
    rec_lens: list[np.ndarray] = []
    rec_signs: list[np.ndarray] = []
    for _ in range(max_rounds):
        cnt = _counts_i32(work)
        cand = np.nonzero((cnt == 1) | (cnt == -1))[0]
        if not cand.size:
            break
        signs = np.where(cnt[cand] == 1, 1, -1).astype(np.int8)
        sums = work[cand, 3:11]
        lenw = work[cand, 11]
        css = work[cand, 1:3]
        negm = signs == -1
        if negm.any():
            sums = sums.copy()
            css = css.copy()
            lenw = lenw.copy()
            sums[negm] = _neg(sums[negm])
            css[negm] = _neg(css[negm])
            lenw[negm] = _neg(lenw[negm])
        ok = (weighted_checksum_words(sums, lenw) == css).all(axis=1)
        if not ok.any():
            break
        vals = np.ascontiguousarray(sums[ok], dtype=np.uint32)
        signs = signs[ok]
        lens = lenw[ok].astype(np.int64)
        digests = vals.view(np.uint8).reshape(-1, DIGEST_BYTES)
        digests, first = dedupe_digests(digests)
        signs = signs[first]
        lens = lens[first]
        rows = weighted_element_rows(digests, lens)
        srows = rows.copy()
        if (signs == -1).any():
            srows[signs == -1] = _neg(rows[signs == -1])
        elems, idxs = WeightedIndexCursor(digests, lens).advance(m)
        np.subtract.at(work, idxs, srows[elems])
        rec_digests.append(digests)
        rec_lens.append(lens)
        rec_signs.append(signs)
    if rec_digests:
        digests = np.concatenate(rec_digests)
        lens = np.concatenate(rec_lens)
        signs = np.concatenate(rec_signs)
    else:
        digests = np.empty((0, DIGEST_BYTES), np.uint8)
        lens = np.empty(0, np.int64)
        signs = np.empty(0, np.int8)
    return digests, lens, signs, not work.any()


class WeightedPeelDecoder(_Decoder):
    """:class:`PeelDecoder` over (digest, length) elements."""

    _width = WSYMBOL_WORDS

    def __init__(self, local_digests: np.ndarray, local_lens, device="cuda",
                 assume_unique: bool = False):
        digests = np.ascontiguousarray(local_digests, dtype=np.uint8)
        lens = np.ascontiguousarray(np.asarray(local_lens, dtype=np.int64))
        if not assume_unique:
            digests, first = dedupe_digests(digests)
            lens = lens[first]
        self.local = WeightedSymbols(digests, lens, device=device)
        super().__init__()

    def try_decode(self):
        """``None`` when more symbols are needed; otherwise ``(digests,
        lens, signs)``: sign +1 remote-only (what this side is missing),
        -1 local-only."""
        work = self._work()
        if work is None:
            return None
        digests, lens, signs, complete = peel_weighted(work)
        return (digests, lens, signs) if complete else None
