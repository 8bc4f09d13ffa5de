"""Content-addressed snapshot transfer.

The port's counterpart of ``dat_replication_protocol_tpu/runtime/snapshot_driver.py``.
A late joiner trimmed past the BroadcastLog retention window used to
get a structured :class:`~..fanout.log.SnapshotNeeded` refusal and was
stranded — the one scenario where the stack refused to replicate.
This module is the bootstrap path that answers it:

* the **responder** materializes its dataset as CDC chunks addressed by
  their fused1p digests (:func:`..runtime.content.content_digests` on
  ``device``: one upload, B6 for the cuts, B1 for every chunk) and
  serves them
  over negotiated ``TYPE_SNAPSHOT`` frames;
* the **joiner** reconciles its chunk *set* against the source first —
  the weighted (variable-size element) rateless extension of
  :mod:`..ops.rateless` streams O(diff) coded symbols, so a 2% stale
  joiner moves ~2% of the bytes; a cold joiner short-circuits to the
  plain full-manifest ``WANT all`` fallback;
* chunk ORDER ships as the ``DONE`` assembly plan: ranks into the
  lexicographically sorted unique digest set, an order both sides
  compute locally — ~log2(n)/7 bytes per chunk slot instead of 32;
* a flash crowd of cold joiners shares ONE hash+read+encode pass: the
  full chunk stream is framed once into a per-manifest
  :class:`~..fanout.log.BroadcastLog` (:meth:`SnapshotSource.cold_log`)
  and every cold session is answered with zero-copy slices of it
  (hash-once economics, proven by counters exactly like fan-out).

Layering (the reconcile-driver doctrine):

* :class:`SnapshotSource` — the shared per-manifest state (chunks,
  digests, ranks, the cold log).  Build it once, serve N sessions.
* :class:`SnapshotResponder` / :class:`SnapshotJoiner` — transport-free
  protocol cores: feed decoded
  :class:`~..wire.snapshot_codec.SnapshotMsg` messages, collect reply
  payloads; the live drivers wrap them.
* :func:`snapshot_local` — both sides in one process with exact wire
  metering; the bench's A/B harness.
* :func:`run_snapshot_responder` / :func:`run_snapshot_joiner` — live
  duplex drivers over blocking byte pairs (the
  :mod:`..session.transport` contract).  The sidecar serves the
  responder under ``--snapshot``.

Failure contract (ROBUSTNESS.md): the joiner verifies EVERY chunk
digest on receipt, and a session either assembles the byte-exact
dataset (root + length verified against the manifest) or raises ONE
structured :class:`~..wire.framing.ProtocolError`.  The joiner's
verified-chunk set absorbs any frame a transport re-delivers: a
verified chunk is never verified (or counted) twice.  The root is
``merkle.root_host``, as in the reference.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable

import numpy as np

from ..obs.events import emit as _emit
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.metrics import gauge as _gauge
from ..obs.watermarks import WATERMARKS as _WATERMARKS
from ..ops import rateless
from ..session.decoder import Decoder
from ..session.encoder import Encoder
from ..session.transport import recv_over, start_sender
from ..utils.device import resolve_device
from ..utils.trace import span
from ..wire import snapshot_codec as sn
from ..wire.framing import CAP_SNAPSHOT, ProtocolError, TYPE_SNAPSHOT, \
    frame_header, frame_wire_len, iter_frames

__all__ = ["SnapshotSource", "SnapshotResponder", "SnapshotJoiner",
           "LogSlice", "snapshot_local", "run_snapshot_responder",
           "snapshot_responder_machine", "run_snapshot_joiner",
           "symbol_cap", "DEFAULT_SYMBOL_BATCH0", "DEFAULT_MAX_SYMBOLS"]

# first symbol batch; each round doubles (the reconcile-driver schedule)
DEFAULT_SYMBOL_BATCH0 = 64

# absolute per-session symbol budget (the reconcile doctrine: the cap
# scaled off claimed set sizes is advisory, this bound is this
# process's memory).  1M weighted symbols = 48 MiB of cells.
DEFAULT_MAX_SYMBOLS = 1 << 20

# one CHUNKS payload stays below this (frame granularity: resume
# checkpoints land between frames, so smaller frames = finer resume)
DEFAULT_CHUNK_PAYLOAD = 1 << 20

# snapshot telemetry (OBSERVABILITY.md "snapshot.*")
_M_SESSIONS = _counter("snapshot.sessions")
_M_CHUNKS_SENT = _counter("snapshot.chunks.sent")
_M_BYTES_SENT = _counter("snapshot.chunks.sent_bytes")
_M_COLD_BYTES = _counter("snapshot.cold.bytes")  # served from the shared log
_M_CHUNKS_VERIFIED = _counter("snapshot.chunks.verified")
_M_CHUNKS_REUSED = _counter("snapshot.chunks.reused")
_M_CHUNKS_DUP = _counter("snapshot.chunks.duplicate")  # absorbed re-delivery
_G_SYMBOLS = _gauge("snapshot.symbols.seen")
_G_MISSING = _gauge("snapshot.decoded.missing")


def symbol_cap(n_chunks: int,
               max_symbols: int = DEFAULT_MAX_SYMBOLS) -> int:
    """Per-session symbol budget, computed from the manifest by BOTH
    sides: a healthy chunk-set decode needs ~1.35-2.2x the diff, which
    is <= n_chunks + the joiner's set; the absolute ``max_symbols``
    budget wins.  The joiner mirrors this bound so its full-manifest
    degrade fires BEFORE the responder would refuse the next batch —
    the two sides must agree on ``max_symbols`` (the default does) or
    a heavily divergent joiner is stranded by the responder's FAIL."""
    return min(max(4 * n_chunks + 256, 512), max_symbols)


def _as_u8(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)
    ) else np.ascontiguousarray(data, dtype=np.uint8)


def _lex_order(digests: np.ndarray) -> np.ndarray:
    """Indices sorting digest rows lexicographically (byte order).

    The big-endian u64 view of each 8-byte quarter compares exactly
    like the bytes it covers, so a 4-key lexsort is the whole 32-byte
    comparison — no 'S32' flexible dtype (numpy strips trailing NULs
    there, silently merging digests that differ only in a trailing
    zero byte)."""
    d = np.ascontiguousarray(digests, dtype=np.uint8)
    if len(d) == 0:
        return np.empty(0, np.int64)
    w = d.view(">u8")
    return np.lexsort((w[:, 3], w[:, 2], w[:, 1], w[:, 0])).astype(np.int64)


class LogSlice:
    """Reply directive: write ``log[start:end)`` — PRE-FRAMED snapshot
    frames from the shared per-manifest broadcast log — to the peer
    verbatim.  Drivers stream it in bounded zero-copy slices."""

    __slots__ = ("log", "start", "end")

    def __init__(self, log, start: int, end: int):
        self.log = log
        self.start = start
        self.end = end

    def __len__(self) -> int:
        return self.end - self.start


class SnapshotSource:
    """One materialized dataset, shared by every responder session.

    Chunks the dataset ONCE (``content_digests`` on ``device``, the
    fused single-residency route: one upload, B6 for the cuts, B1 for
    every chunk), computes the
    Merkle root over the position digests, the unique-chunk set, and
    the ``DONE`` assembly ranks.  ``wire_offset`` is the live-log
    offset this dataset materializes — the joiner attaches its live
    session there after assembly (0 for a standalone dataset).
    """

    def __init__(self, data, *, avg_bits: int = 13,
                 min_size: int | None = None, max_size: int | None = None,
                 wire_offset: int = 0, device="cuda"):
        from .content import content_digests

        self.device = resolve_device(device)
        self._buf = _as_u8(data)
        if min_size is None:
            min_size = 1 << (avg_bits - 2)
        if max_size is None:
            max_size = 1 << (avg_bits + 2)
        with span("snapshot.materialize"):
            cuts, digests = content_digests(
                self._buf, avg_bits, min_size, max_size, device=self.device)
        self._adopt(cuts, digests, avg_bits, min_size, max_size,
                    wire_offset)

    @classmethod
    def from_digests(cls, data, cuts, digests, *, avg_bits: int = 13,
                     min_size: int | None = None,
                     max_size: int | None = None, wire_offset: int = 0,
                     device="cuda") -> "SnapshotSource":
        """A source over ``data`` whose chunk ``cuts`` (end offsets) and
        per-chunk ``digests`` are already known: nothing is chunked or
        hashed again."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self._buf = _as_u8(data)
        if min_size is None:
            min_size = 1 << (avg_bits - 2)
        if max_size is None:
            max_size = 1 << (avg_bits + 2)
        digests = np.ascontiguousarray(digests, dtype=np.uint8)
        if digests.ndim != 2 or digests.shape[1] != rateless.DIGEST_BYTES \
                or len(digests) != len(cuts):
            raise ValueError("digests must be (len(cuts), 32) u8")
        self._adopt(cuts, digests, avg_bits, min_size, max_size,
                    wire_offset)
        return self

    def _adopt(self, cuts, digests, avg_bits: int, min_size: int,
               max_size: int, wire_offset: int) -> None:
        from ..ops import merkle

        ends = np.asarray(cuts, dtype=np.int64)
        self.offs = np.concatenate([np.zeros(1, np.int64), ends[:-1]])
        self.lens = ends - self.offs
        self.digests = np.ascontiguousarray(digests, dtype=np.uint8)
        root = merkle.root_host(self.digests) if len(ends) else b"\0" * 32
        # unique chunk set (manifest positions may repeat a digest; the
        # wire ships each unique chunk at most once) + the assembly
        # ranks: position i holds the chunk at sorted-set rank[i]
        uniq, first = rateless.dedupe_digests(self.digests)
        self.uniq_digests = uniq
        self.uniq_offs = self.offs[first]
        self.uniq_lens = self.lens[first]
        # position -> lex rank of its chunk, fully vectorized: np.unique
        # over the void view compares byte-lexicographically (memcmp),
        # so its inverse IS each position's rank in the sorted unique
        # set — the same order :func:`_lex_order` computes (equality
        # pinned by test), with no per-position Python work on the
        # materialize path
        if len(self.digests):
            void = self.digests.view([("v", "V32")]).ravel()
            self.ranks = np.unique(void, return_inverse=True)[1].astype(
                np.int64, copy=False).reshape(-1)
        else:
            self.ranks = np.empty(0, np.int64)
        self._uniq_index = {uniq[i].tobytes(): i for i in range(len(uniq))}
        self.manifest = sn.SnapshotManifest(
            n_positions=len(self.digests), n_chunks=len(uniq),
            total_bytes=int(self._buf.size), root=root,
            wire_offset=int(wire_offset), avg_bits=avg_bits,
            min_size=min_size, max_size=max_size)
        self._lock = threading.Lock()
        self._cold_log = None
        self._symbol_cache: rateless.WeightedSymbols | None = None
        self._symbol_cache_lock = threading.Lock()
        self._done_tail: bytes | None = None
        self._done_tail_lock = threading.Lock()

    # -- chunk access --------------------------------------------------------

    def chunk_view(self, uidx: int) -> memoryview:
        """Unique chunk ``uidx``'s bytes as a zero-copy view over the
        dataset (the responder's read path: slices, never copies,
        until the wire codec assembles a payload)."""
        o = int(self.uniq_offs[uidx])
        ln = int(self.uniq_lens[uidx])
        return memoryview(self._buf)[o:o + ln].cast("B")

    def uniq_rows_for(self, digests: np.ndarray) -> np.ndarray:
        """Unique-chunk indices for digest queries; -1 where unknown
        (a WANT naming a chunk outside the manifest is byzantine)."""
        q = np.ascontiguousarray(digests, dtype=np.uint8)
        out = np.empty(len(q), dtype=np.int64)
        idx = self._uniq_index
        for i in range(len(q)):
            out[i] = idx.get(q[i].tobytes(), -1)
        return out

    def weighted_symbols(self) -> rateless.WeightedSymbols:
        """The SHARED weighted coded-symbol prefix over the unique
        chunk set: symbol batches are computed once per manifest and
        every session's stream is a slice of the same prefix (the
        hash-once doctrine applied to symbol work)."""
        with self._symbol_cache_lock:
            if self._symbol_cache is None:
                self._symbol_cache = rateless.WeightedSymbols(
                    self.uniq_digests, self.uniq_lens, device=self.device)
            return self._symbol_cache

    def done_payload(self, symbols_used: int) -> bytes:
        # the ranks section is constant per manifest: encode it once
        # and prepend the per-session prefix — a flash crowd must not
        # redo ~n_positions Python varint encodes per session
        with self._done_tail_lock:
            if self._done_tail is None:
                self._done_tail = sn.encode_done_tail(self.ranks)
            tail = self._done_tail
        return sn.encode_done(symbols_used, tail=tail)

    def chunk_payloads(self, uidxs, max_payload: int):
        """Yield CHUNKS payloads covering unique-chunk indices
        ``uidxs`` in order, each grouping at most ``max_payload`` chunk
        bytes (frame granularity = resume granularity).  The ONE owner
        of the grouping rule — the per-session WANT answer and the
        cold-log framing must never diverge."""
        group: list = []
        group_bytes = 0
        for uidx in uidxs:
            ln = int(self.uniq_lens[uidx])
            if group and group_bytes + ln > max_payload:
                yield sn.encode_chunks(group)
                group, group_bytes = [], 0
            group.append((self.uniq_digests[uidx].tobytes(),
                          self.chunk_view(uidx)))
            group_bytes += ln
        if group:
            yield sn.encode_chunks(group)

    # -- the shared cold stream ---------------------------------------------

    def cold_log(self, max_payload: int = DEFAULT_CHUNK_PAYLOAD):
        """The full-manifest answer, framed ONCE into a sealed
        :class:`~..fanout.log.BroadcastLog`: every unique chunk (in
        dataset order — sequential reads) grouped into CHUNKS frames,
        then the DONE frame.  N cold joiners are served slices of this
        log — one hash+read+encode pass however large the flash crowd
        (``snapshot.cold.bytes`` counts the bytes leaving; the digest
        counters stay flat, which is the bench's hash-once proof)."""
        from ..fanout.log import BroadcastLog

        with self._lock:
            if self._cold_log is None:
                log = BroadcastLog(
                    retention_budget=max(
                        1, int(self.manifest.total_bytes) * 2 + (64 << 20)))
                order = np.argsort(self.uniq_offs, kind="stable")
                for payload in self.chunk_payloads(order.tolist(),
                                                   max_payload):
                    log.append(frame_header(len(payload),
                                            TYPE_SNAPSHOT) + payload)
                payload = self.done_payload(0)
                log.append(frame_header(len(payload),
                                        TYPE_SNAPSHOT) + payload)
                log.seal()
                self._cold_log = log
            return self._cold_log


class SnapshotResponder:
    """Transport-free responder core for ONE joiner session.

    :meth:`begin_payloads` opens the session (the manifest travels
    first); :meth:`handle` consumes each decoded joiner message and
    returns replies — payload ``bytes`` to be framed, or a
    :class:`LogSlice` of the shared cold stream.  ``chunk_budget``
    bounds the total chunk bytes one session may pull (the per-session
    FAIL arm: past it the session fails STRUCTURED, never grows).
    """

    def __init__(self, source: SnapshotSource, *,
                 batch0: int = DEFAULT_SYMBOL_BATCH0,
                 max_symbols: int = DEFAULT_MAX_SYMBOLS,
                 chunk_budget: int | None = None,
                 max_payload: int = DEFAULT_CHUNK_PAYLOAD):
        self.source = source
        self.batch0 = batch0
        self.max_symbols = max_symbols
        self.chunk_budget = chunk_budget
        self.max_payload = max_payload
        self.symbols_sent = 0
        self.rounds = 0
        self.chunks_sent = 0
        self.chunk_bytes_sent = 0
        self.cold = False
        self.finished = False
        self.failed: ProtocolError | None = None

    def begin_payloads(self) -> list:
        if _OBS.on:
            _M_SESSIONS.inc()
            _emit("snapshot.begin",
                  chunks=self.source.manifest.n_chunks,
                  total_bytes=self.source.manifest.total_bytes)
        return [sn.encode_begin(self.source.manifest)]

    def _fail(self, message: str) -> list:
        self.failed = ProtocolError(message, offset=self.symbols_sent)
        if _OBS.on:
            _emit("snapshot.fail", symbols=self.symbols_sent,
                  chunks=self.chunks_sent, message=message)
        return [sn.encode_fail(self.chunks_sent, message)]

    def _symbol_cap(self) -> int:
        return symbol_cap(self.source.manifest.n_chunks, self.max_symbols)

    def _chunks_replies(self, uidxs: np.ndarray) -> list:
        src = self.source
        out = list(src.chunk_payloads(uidxs.tolist(), self.max_payload))
        self.chunks_sent += len(uidxs)
        sent = int(src.uniq_lens[uidxs].sum()) if len(uidxs) else 0
        self.chunk_bytes_sent += sent
        if _OBS.on:
            _M_CHUNKS_SENT.inc(len(uidxs))
            _M_BYTES_SENT.inc(sent)
        return out

    def handle(self, msg: sn.SnapshotMsg) -> list:
        if self.failed is not None or self.finished:
            return []
        if msg.kind == sn.SN_WANT and msg.mode == sn.WANT_MORE:
            if msg.n > self.symbols_sent:
                return self._fail(
                    f"joiner claims {msg.n} symbols, {self.symbols_sent} "
                    "sent")
            if self.symbols_sent >= self._symbol_cap():
                return self._fail(
                    f"no decode after {self.symbols_sent} symbols "
                    f"({self.source.manifest.n_chunks} chunks)")
            m = self.batch0 if self.symbols_sent == 0 \
                else self.symbols_sent * 2
            m = min(m, self.max_symbols)
            cells = self.source.weighted_symbols().extend(m)[
                self.symbols_sent:]
            reply = sn.encode_symbols(self.symbols_sent, cells)
            self.symbols_sent = m
            self.rounds += 1
            return [reply]
        if msg.kind == sn.SN_WANT and msg.mode == sn.WANT_DIGESTS:
            want = msg.digests if msg.digests is not None \
                else np.empty((0, 32), np.uint8)
            uidxs = self.source.uniq_rows_for(want)
            if (uidxs < 0).any():
                return self._fail(
                    "joiner requested a chunk outside the manifest")
            # the WANT set is semantically a SET: dedupe before billing
            # or serving, so a byzantine joiner repeating one digest k
            # times cannot amplify the reply past one copy per chunk
            uidxs = np.unique(uidxs)
            need = int(self.source.uniq_lens[uidxs].sum()) \
                if len(uidxs) else 0
            if self.chunk_budget is not None and \
                    self.chunk_bytes_sent + need > self.chunk_budget:
                return self._fail(
                    f"chunk budget exceeded: {need} requested bytes "
                    f"(+{self.chunk_bytes_sent} sent) over "
                    f"{self.chunk_budget}")
            replies = self._chunks_replies(uidxs)
            replies.append(self.source.done_payload(self.symbols_sent))
            self.finished = True
            if _OBS.on:
                _emit("snapshot.done", chunks=self.chunks_sent,
                      bytes=self.chunk_bytes_sent,
                      symbols=self.symbols_sent)
            return replies
        if msg.kind == sn.SN_WANT and msg.mode == sn.WANT_ALL:
            # the cold log ships each UNIQUE chunk once; total_bytes
            # sums positions and would over-bill duplicated content
            total = int(self.source.uniq_lens.sum())
            if self.chunk_budget is not None and \
                    self.chunk_bytes_sent + total > self.chunk_budget:
                return self._fail(
                    f"chunk budget exceeded: full manifest is {total} "
                    f"bytes over {self.chunk_budget}")
            log = self.source.cold_log(self.max_payload)
            self.cold = True
            self.finished = True
            self.chunks_sent += self.source.manifest.n_chunks
            self.chunk_bytes_sent += total
            if _OBS.on:
                _M_CHUNKS_SENT.inc(self.source.manifest.n_chunks)
                _M_BYTES_SENT.inc(total)
                _M_COLD_BYTES.inc(log.end - log.start)
                _emit("snapshot.done", chunks=self.chunks_sent,
                      bytes=total, symbols=self.symbols_sent, cold=True)
            return [LogSlice(log, log.start, log.end)]
        if msg.kind == sn.SN_FAIL:
            self.failed = ProtocolError(
                f"snapshot failed at joiner: {msg.reason}",
                offset=self.symbols_sent)
            return []
        # BEGIN/SYMBOLS/CHUNKS/DONE are joiner-bound
        return self._fail(
            f"unexpected snapshot message {msg.kind_name!r} at responder")


class SnapshotJoiner:
    """Transport-free joiner core: decide cold vs reconcile, peel the
    weighted symbol stream, verify every chunk on receipt, assemble.

    ``have`` is the joiner's stale dataset (bytes-like / uint8 array,
    or ``None``/empty for a cold join); its chunks are cut with the
    manifest's own CDC parameters on ``device`` so shared content
    shares digests.
    :meth:`result` is the failure-contract choke point: the assembled
    byte-exact dataset, or ONE structured ProtocolError."""

    def __init__(self, have=None, *, device="cuda",
                 max_symbols: int = DEFAULT_MAX_SYMBOLS,
                 fallback_all: bool = True):
        self._have = have
        self.device = resolve_device(device)
        self.max_symbols = max_symbols
        self._cap = max_symbols  # tightened from the manifest at BEGIN
        self.fallback_all = fallback_all
        self.manifest: sn.SnapshotManifest | None = None
        self.peeler: rateless.WeightedPeelDecoder | None = None
        # local unique chunks: digest -> (offset, length) into _have_buf
        self._have_buf: np.ndarray | None = None
        self._local: dict[bytes, tuple[int, int]] = {}
        self._local_only: set[bytes] = set()  # sign -1: not at responder
        self._wanted: dict[bytes, int] | None = None  # None = cold (all)
        self._verified: dict[bytes, bytes] = {}
        self.chunks_verified = 0
        self.chunk_bytes_verified = 0
        self.chunks_reused = 0
        self.symbols_seen = 0
        self.rounds = 0
        self.ranks: np.ndarray | None = None
        self.data: bytes | None = None
        self.assembled = False
        self.failed: ProtocolError | None = None

    # -- failure choke point -------------------------------------------------

    def _fail(self, message: str) -> list:
        self.failed = ProtocolError(message, offset=self.symbols_seen)
        if _OBS.on:
            _emit("snapshot.fail", symbols=self.symbols_seen,
                  chunks=self.chunks_verified, message=message)
        return [sn.encode_fail(self.chunks_verified, message)]

    # -- protocol ------------------------------------------------------------

    def _on_begin(self, man: sn.SnapshotManifest) -> list:
        if self.manifest is not None:
            return self._fail("duplicate snapshot begin")
        self.manifest = man
        have = self._have
        if have is not None:
            buf = _as_u8(have)
            if buf.size:
                from .content import content_digests

                cuts, digests = content_digests(
                    buf, man.avg_bits, man.min_size, man.max_size,
                    device=self.device)
                ends = np.asarray(cuts, dtype=np.int64)
                offs = np.concatenate([np.zeros(1, np.int64), ends[:-1]])
                lens = ends - offs
                uniq, first = rateless.dedupe_digests(
                    np.ascontiguousarray(digests, np.uint8))
                self._have_buf = buf
                self._local = {
                    uniq[i].tobytes(): (int(offs[first[i]]),
                                        int(lens[first[i]]))
                    for i in range(len(uniq))}
        if not self._local or man.n_chunks == 0:
            # cold joiner (or empty manifest): the plain full-manifest
            # fallback — no symbol stream, every chunk wanted
            self._wanted = None
            return [sn.encode_want_all()]
        # mirror the responder's per-session symbol budget: the degrade
        # below must fire before the responder refuses a WANT_MORE, or
        # its FAIL strands the session with the fallback still unused
        self._cap = symbol_cap(man.n_chunks, self.max_symbols)
        local_digests = np.frombuffer(
            b"".join(self._local.keys()), np.uint8).reshape(-1, 32)
        local_lens = np.array([ln for _, ln in self._local.values()],
                              dtype=np.int64)
        self.peeler = rateless.WeightedPeelDecoder(
            local_digests, local_lens, device=self.device,
            assume_unique=True)
        return [sn.encode_want_more(0)]

    def _on_symbols(self, msg: sn.SnapshotMsg) -> list:
        if self.manifest is None:
            return self._fail("snapshot symbols before begin")
        if self.peeler is None:
            return []  # cold path never asked for symbols: stray frame
        if self._wanted is not None:
            return []  # late batch after decode: ignorable
        try:
            self.peeler.add_symbols(msg.start, msg.cells)
        except ValueError as e:
            return self._fail(str(e))
        self.symbols_seen = self.peeler.symbols_seen
        self.rounds += 1
        if _OBS.on:
            _G_SYMBOLS.set(self.symbols_seen)
        out = self.peeler.try_decode()
        if out is None:
            if self.symbols_seen >= self._cap:
                if self.fallback_all:
                    # decode exhausted: degrade to the full-manifest
                    # fetch instead of stranding the joiner (correct,
                    # just without the dedup savings)
                    self._wanted = None
                    return [sn.encode_want_all()]
                return self._fail(
                    f"no decode after {self.symbols_seen} symbols")
            return [sn.encode_want_more(self.symbols_seen)]
        digests, lens, signs = out
        plus = signs == 1
        missing = digests[plus]
        self._wanted = {missing[i].tobytes(): int(lens[plus][i])
                        for i in range(len(missing))}
        self._local_only = {bytes(d) for d in digests[signs == -1]}
        if _OBS.on:
            _G_MISSING.set(len(missing))
            _emit("snapshot.decoded", missing=len(missing),
                  local_only=int((signs == -1).sum()),
                  symbols=self.symbols_seen)
        return [sn.encode_want_digests(missing)]

    def _on_chunks(self, msg: sn.SnapshotMsg) -> list:
        if self.manifest is None:
            return self._fail("snapshot chunks before begin")
        for digest, data in msg.chunks:
            digest = bytes(digest)
            if digest in self._verified:
                # exactly-once resume: a replayed frame re-delivers a
                # chunk the journal already carried past us — absorb,
                # never re-verify or double-count
                if _OBS.on:
                    _M_CHUNKS_DUP.inc()
                continue
            if self._wanted is not None and digest not in self._wanted:
                return self._fail(
                    "unsolicited chunk (digest outside the WANT set)")
            if hashlib.blake2b(data, digest_size=32).digest() != digest:
                return self._fail(
                    f"chunk digest mismatch at chunk {self.chunks_verified}"
                )
            self._verified[digest] = data
            self.chunks_verified += 1
            self.chunk_bytes_verified += len(data)
            if _OBS.on:
                _M_CHUNKS_VERIFIED.inc()
        return []

    def _on_done(self, msg: sn.SnapshotMsg) -> list:
        man = self.manifest
        if man is None:
            return self._fail("snapshot done before begin")
        if self.assembled:
            return []
        if self._wanted is not None:
            got = set(self._verified)
            miss = [d for d in self._wanted if d not in got]
            if miss:
                return self._fail(
                    f"done with {len(miss)} wanted chunks undelivered")
        if len(msg.ranks) != man.n_positions:
            return self._fail(
                f"done names {len(msg.ranks)} positions, manifest has "
                f"{man.n_positions}")
        # the responder's unique set, reconstructed locally: received
        # chunks + the local chunks the reconcile proved SHARED (every
        # local chunk except the sign -1 local-only ones — those are
        # not at the responder and must not enter the sorted order).
        # On the cold/fallback path (_wanted is None) the received
        # chunks ARE the exact set.
        entries: list[tuple[bytes, object]] = list(self._verified.items())
        if self._wanted is not None and self._local:
            hb = self._have_buf
            for digest, (off, ln) in self._local.items():
                if digest in self._local_only or digest in self._verified:
                    continue
                entries.append((digest, memoryview(hb)[off:off + ln]))
                self.chunks_reused += 1
        if len(entries) != man.n_chunks:
            return self._fail(
                f"assembled set has {len(entries)} chunks, manifest "
                f"names {man.n_chunks}")
        digests_arr = np.frombuffer(
            b"".join(d for d, _ in entries), np.uint8).reshape(-1, 32)
        order = _lex_order(digests_arr)
        ranks = np.ascontiguousarray(msg.ranks, dtype=np.int64)
        if len(ranks) and (ranks.max() >= len(entries)):
            return self._fail("done rank outside the chunk set")
        # verify the manifest root over the per-position digests BEFORE
        # exporting a single byte: the plan itself is untrusted
        from ..ops import merkle

        pos_digests = digests_arr[order][ranks] if len(ranks) \
            else np.empty((0, 32), np.uint8)
        root = merkle.root_host(pos_digests) if len(ranks) else b"\0" * 32
        if root != man.root:
            return self._fail("assembled root does not match manifest")
        out = bytearray()
        chunk_at = [entries[i][1] for i in order.tolist()]
        for r in ranks.tolist():
            out += chunk_at[r]
        if len(out) != man.total_bytes:
            return self._fail(
                f"assembled {len(out)} bytes, manifest says "
                f"{man.total_bytes}")
        self.data = bytes(out)
        self.assembled = True
        if _OBS.on:
            _M_CHUNKS_REUSED.inc(self.chunks_reused)
            _emit("snapshot.assembled", bytes=len(self.data),
                  received=self.chunks_verified,
                  reused=self.chunks_reused,
                  wire_offset=man.wire_offset)
        return []

    def handle(self, msg: sn.SnapshotMsg) -> list:
        """Consume one decoded snapshot message; returns reply payloads
        (joiner replies are always plain payload bytes)."""
        if self.failed is not None:
            return []
        if msg.kind == sn.SN_BEGIN:
            return self._on_begin(msg.manifest)
        if msg.kind == sn.SN_SYMBOLS:
            return self._on_symbols(msg)
        if msg.kind == sn.SN_CHUNKS:
            return self._on_chunks(msg)
        if msg.kind == sn.SN_DONE:
            return self._on_done(msg)
        if msg.kind == sn.SN_FAIL:
            self.failed = ProtocolError(
                f"snapshot failed at responder: {msg.reason}",
                offset=self.symbols_seen)
            return []
        # WANT is responder-bound
        return self._fail(
            f"unexpected snapshot message {msg.kind_name!r} at joiner")

    @property
    def done(self) -> bool:
        return self.assembled or self.failed is not None

    def result(self) -> dict:
        """The assembled dataset + session stats; raises the session's
        ONE structured ProtocolError when the stream failed or ended
        before assembly completed."""
        if self.failed is not None:
            raise self.failed
        if not self.assembled:
            raise ProtocolError(
                "snapshot stream ended before assembly completed",
                offset=self.symbols_seen)
        return {
            "ok": True,
            "data": self.data,
            "wire_offset": self.manifest.wire_offset,
            "chunks_received": self.chunks_verified,
            "chunks_reused": self.chunks_reused,
            "bytes_received": self.chunk_bytes_verified,
            "symbols": self.symbols_seen,
            "rounds": self.rounds,
        }


# -- in-memory harness -------------------------------------------------------


def snapshot_local(source, have=None, *, device="cuda",
                   batch0: int = DEFAULT_SYMBOL_BATCH0,
                   chunk_budget: int | None = None) -> dict:
    """Run the full protocol between an in-memory responder and joiner
    with exact wire metering — every message round-trips the real
    payload codec and is billed at its framed wire length; cold-log
    slices are billed at their raw (pre-framed) byte length.

    ``source`` is a :class:`SnapshotSource` (share it across calls to
    model a flash crowd), or raw data materialized on ``device``; the
    joiner cuts ``have`` on ``device``.  Returns the joiner's :meth:`result` dict
    plus ``wire_s2j`` / ``wire_j2s`` / ``wire_bytes`` and the
    responder's stats; raises the structured ProtocolError on
    failure."""
    if not isinstance(source, SnapshotSource):
        source = SnapshotSource(source, device=device)
    resp = SnapshotResponder(source, batch0=batch0,
                             chunk_budget=chunk_budget)
    joiner = SnapshotJoiner(have, device=device)
    wire = {"s2j": 0, "j2s": 0}
    pending = list(resp.begin_payloads())
    guard = 0
    while pending and not joiner.done:
        replies: list = []
        for item in pending:
            if isinstance(item, LogSlice):
                wire["s2j"] += len(item)
                # decode the pre-framed stream through the real codec
                raw = item.log.read_from(item.start)
                for _start, _tid, p0, end in iter_frames(raw):
                    replies.extend(joiner.handle(
                        sn.decode_snapshot(raw[p0:end])))
            else:
                wire["s2j"] += frame_wire_len(len(item))
                replies.extend(joiner.handle(sn.decode_snapshot(item)))
        pending = []
        for r in replies:
            wire["j2s"] += frame_wire_len(len(r))
            pending.extend(resp.handle(sn.decode_snapshot(r)))
        guard += 1
        if guard > 10_000:
            raise ProtocolError("snapshot_local failed to converge")
    out = joiner.result()
    out.update({
        "wire_s2j": wire["s2j"],
        "wire_j2s": wire["j2s"],
        "wire_bytes": wire["s2j"] + wire["j2s"],
        "chunks_sent": resp.chunks_sent,
        "cold": resp.cold,
        "responder_symbols": resp.symbols_sent,
    })
    return out


# -- live duplex drivers -----------------------------------------------------


def _send_replies(enc: Encoder, replies, chunk_size: int,
                  on_done: Callable[[], None] | None = None) -> None:
    """Queue responder/joiner replies on the session encoder, in
    order: payload bytes ride :meth:`Encoder.snapshot_frame`; a
    :class:`LogSlice` is PRE-FRAMED shared-log wire, pushed verbatim in
    bounded zero-copy slices (same queue, so frame order is reply
    order; the journal tee sees every byte either way).

    LogSlice pushes are PACED by the encoder's high-water mark: each
    ``_push`` materializes its view (the queue owns bytes), so queueing
    a whole cold dataset at once would buffer it all in memory — the
    flash-crowd economics this module exists for.  Past the mark the
    pump parks and resumes via :meth:`Encoder.on_drain` (fired from the
    sender's ``read``), keeping the queue near ``high_water`` while the
    log itself stays the single shared copy.  ``on_done`` fires once
    every reply is fully queued — callers must defer ``finalize()``
    into it or a parked slice would be truncated at the EOF marker."""
    replies = list(replies)

    def pump(idx: int = 0, at: int | None = None) -> None:
        while idx < len(replies):
            if enc.destroyed:
                return  # peer went away mid-slice; nothing to finish
            item = replies[idx]
            if isinstance(item, LogSlice):
                if at is None:
                    at = item.start
                while at < item.end:
                    views = item.log.read_slices(
                        at, min(chunk_size, item.end - at))
                    if not views:
                        break
                    writable = True
                    for v in views:
                        writable = enc._push(v, None)
                        at += len(v)
                    if not writable and at < item.end:
                        # one-shot resume hook fired from the sender's
                        # read: it only re-queues bounded slices
                        enc.on_drain(lambda i=idx, a=at: pump(i, a))
                        return
                at = None
            else:
                enc.snapshot_frame(item)
            idx += 1
        if on_done is not None:
            # completion hook: the callers' _finish only finalizes
            on_done()

    pump()


def snapshot_responder_machine(source, *, device="cuda",
                               batch0: int = DEFAULT_SYMBOL_BATCH0,
                               chunk_budget: int | None = None,
                               link: str | None = None,
                               chunk_size: int = 64 * 1024) -> tuple:
    """The snapshot responder's protocol machine, factored off its
    threads: encoder/decoder pair with BEGIN already queued and the
    WANT/DONE/FAIL exchange wired, returned as ``(enc, dec, finish)``.
    The caller owns byte movement (:func:`run_snapshot_responder` pumps
    them); LogSlice pacing rides :meth:`Encoder.on_drain`, fired from
    whichever side drains the queue.  ``source`` is a
    :class:`SnapshotSource` or raw data materialized on ``device``.
    ``finish()`` is idempotent:
    tears down a half-open encoder, releases the watermark link,
    raises ``resp.failed`` if the session failed, and returns the
    stats record both callers emit."""
    if not isinstance(source, SnapshotSource):
        source = SnapshotSource(source, device=device)
    resp = SnapshotResponder(source, batch0=batch0,
                             chunk_budget=chunk_budget)
    enc = Encoder(peer_caps=CAP_SNAPSHOT)
    dec = Decoder()

    def on_snapshot(msg, done) -> None:
        replies = resp.handle(msg)

        def _finish() -> None:
            if (resp.finished or resp.failed is not None) \
                    and not enc.finalized and not enc.destroyed:
                enc.finalize()

        _send_replies(enc, replies, chunk_size, on_done=_finish)
        done()

    dec.snapshot(on_snapshot)
    # error hook, not user code: destroy() only flips state and wakes
    # watchers — it never blocks the registering loop
    # datlint: allow-callback-escape
    dec.on_error(lambda _e: None if enc.destroyed else enc.destroy())
    if link is not None:
        _WATERMARKS.track("snapshot.chunks.sent", link,
                          lambda: resp.chunk_bytes_sent)
    _send_replies(enc, resp.begin_payloads(), chunk_size)

    def finish() -> dict:
        if not enc.destroyed and not enc.finalized:
            # joiner went away before the session completed: release
            # the reply pump / drop the reply tail
            enc.destroy()
        if link is not None:
            _WATERMARKS.untrack(link)  # idempotent (dict pop)
        if resp.failed is not None:
            raise resp.failed
        return {"ok": resp.finished, "chunks_sent": resp.chunks_sent,
                "chunk_bytes_sent": resp.chunk_bytes_sent,
                "symbols": resp.symbols_sent, "rounds": resp.rounds,
                "cold": resp.cold}

    return enc, dec, finish


def run_snapshot_responder(source, read_bytes, write_bytes,
                           close_write=None, *, device="cuda",
                           batch0: int = DEFAULT_SYMBOL_BATCH0,
                           chunk_budget: int | None = None,
                           link: str | None = None,
                           chunk_size: int = 64 * 1024) -> dict:
    """Serve one snapshot session as the responder over a duplex byte
    pair (the :mod:`..session.transport` contract).  Sends BEGIN, then
    answers the joiner's WANTs until DONE/FAIL; finalizes after the
    last word.  ``link`` registers the ``snapshot.chunks.sent``
    watermark role on the fleet plane for live scrapes."""
    enc, dec, finish = snapshot_responder_machine(
        source, device=device, batch0=batch0, chunk_budget=chunk_budget, link=link,
        chunk_size=chunk_size)

    sender = start_sender(enc, write_bytes, close_write, chunk_size,
                          name="snapshot-resp-send")
    try:
        recv_over(dec, read_bytes, chunk_size=chunk_size)
    except Exception as e:
        if not dec.destroyed:
            dec.destroy(e)
        if not enc.destroyed:
            enc.destroy(e)
        raise
    finally:
        if not enc.destroyed and not enc.finalized:
            # joiner went away before the session completed: release
            # the reply pump so the thread does not park forever
            enc.destroy()
        sender.join(timeout=30)
    return finish()


def run_snapshot_joiner(read_bytes, write_bytes, close_write=None, *,
                        have=None, device="cuda",
                        max_symbols: int = DEFAULT_MAX_SYMBOLS,
                        link: str | None = None,
                        chunk_size: int = 64 * 1024) -> dict:
    """Fetch one snapshot as the joiner over a duplex byte pair:
    receive the manifest, reconcile (or WANT all when cold), verify
    every chunk on receipt, assemble, and return :meth:`result` —
    ``result["wire_offset"]`` is where the caller attaches its live
    session next.  ``link`` registers the ``snapshot.chunks.verified``
    watermark role on the fleet plane.  Raises the session's ONE
    structured ProtocolError on failure."""
    joiner = SnapshotJoiner(have, device=device, max_symbols=max_symbols)
    enc = Encoder(peer_caps=CAP_SNAPSHOT)
    dec = Decoder()

    def on_snapshot(msg, done) -> None:
        replies = joiner.handle(msg)
        for r in replies:
            enc.snapshot_frame(r)
        if joiner.done and not enc.finalized and not enc.destroyed:
            enc.finalize()
        done()

    dec.snapshot(on_snapshot)
    dec.on_error(lambda _e: None if enc.destroyed else enc.destroy())
    if link is not None:
        _WATERMARKS.track("snapshot.chunks.verified", link,
                          lambda: joiner.chunk_bytes_verified)

    sender = start_sender(enc, write_bytes, close_write, chunk_size,
                          name="snapshot-join-send")
    try:
        recv_over(dec, read_bytes, chunk_size=chunk_size)
    except Exception as e:
        if not dec.destroyed:
            dec.destroy(e)
        if not enc.destroyed:
            enc.destroy(e)
        raise
    finally:
        if not enc.destroyed and not enc.finalized:
            enc.destroy()
        sender.join(timeout=30)
        if link is not None:
            _WATERMARKS.untrack(link)
    return joiner.result()
