"""Streaming rateless reconciliation driver.

The port's counterpart of ``dat_replication_protocol_tpu/runtime/reconcile_driver.py``.
Two long-lived replicas that diverged during a partition converge by
exchanging O(diff) wire bytes: the *initiator* streams coded-symbol
batches (:mod:`..ops.rateless`) over ``TYPE_RECONCILE`` frames until
the *responder*'s peeling decoder completes, then both sides exchange
exactly the differing records over the existing ``ChangeBatch`` bulk
frames.  No table exchange, no tree walk, no prior estimate of the
diff size.

Layering:

* :class:`RatelessReplica` — one replica's reconciliation state over a
  change log (columnar decode, canonical per-record digests hashed by
  B1 on ``device`` through :func:`..batch.feed.hash_extents`, the
  digest -> row index).  The coded-symbol build runs on the same
  device; the peel stays on the host, as in the reference.
* :class:`ResponderState` — the transport-free protocol core: feed it
  decoded :class:`~..wire.reconcile_codec.ReconcileMsg` messages, it
  returns reply payloads and accumulates the decoded diff; the live
  drivers wrap it.
* :func:`reconcile_local` — both sides in one process with exact wire
  metering (every message round-trips the real codec); the bench's A/B
  harness and the property suite's workhorse.
* :func:`run_initiator` / :func:`run_responder` — the live duplex
  drivers over blocking byte pairs (the :mod:`..session.transport`
  contract); ``run_initiator(journal=)`` tees the outgoing wire into a
  resume journal.
* The sidecar serves :func:`run_responder` under ``--reconcile`` (the
  mode IS the out-of-band capability advertisement; WIRE.md).

Failure contract (the chaos arm's oracle): a reconcile session either
completes with the exact symmetric difference or raises ONE structured
:class:`~..wire.framing.ProtocolError` — a torn/flipped/truncated
symbol stream can never deliver a wrong diff (wrong-element recovery
needs a 64-bit checksum collision; everything structural is validated
at decode).
"""

from __future__ import annotations


import numpy as np

from ..obs.events import emit as _emit
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.metrics import gauge as _gauge
from ..ops import rateless
from ..session.decoder import Decoder
from ..session.encoder import Encoder
from ..session.transport import recv_over, start_sender
from ..utils.device import resolve_device
from ..utils.trace import span
from ..wire import reconcile_codec as rc
from ..wire.framing import CAP_CHANGE_BATCH, CAP_RECONCILE, ProtocolError, \
    frame_wire_len

__all__ = ["RatelessReplica", "ResponderState", "reconcile_local",
           "run_initiator", "run_responder", "responder_machine",
           "DEFAULT_BATCH0"]

# first symbol batch; each round doubles (the classic rateless
# schedule: total streamed <= 2x the decode point, log2(k) rounds)
DEFAULT_BATCH0 = 128

# decode-failure bound, in symbols per element of the two sets: a
# healthy decode needs ~1.35-2.2x the DIFF, which is <= n_a + n_b, so
# overshooting this cap means corruption, not bad luck
DEFAULT_OVERHEAD_CAP = 4.0

# absolute responder-side symbol budget, independent of the remote
# peer's CLAIMED set size (the overhead cap scales with BEGIN's
# n_elements, which is unverifiable — without this bound a byzantine
# initiator claiming 2**50 elements could stream symbols forever and
# grow the responder's cell/cursor state without limit; the three-stage
# overload doctrine of the hub/fanout modes, restated for anti-entropy:
# past the budget the session fails STRUCTURED, never grows).  4M
# symbols = ~176 MiB of remote cells, enough to bootstrap an empty
# replica against ~2M records; raise per-deployment via max_symbols=.
DEFAULT_MAX_SYMBOLS = 4 << 20

_M_ROUNDS = _counter("reconcile.rounds")
_M_RECORDS = _counter("reconcile.records")
# fleet-plane convergence watermarks: the aggregator reads
# these to track anti-entropy progress — symbols streamed so far (the
# wire cost cursor) and the decoded symmetric-difference size (0 means
# the replicas proved identical; >0 names how far apart they were when
# the decode landed)
_G_SYMBOLS = _gauge("reconcile.symbols.seen")
_G_DIFF = _gauge("reconcile.decoded.diff")


def _select_rows(cols, rows: np.ndarray):
    """Arbitrary-row-subset view of decoded columns (shared buffer)."""
    from . import replay

    rows = np.ascontiguousarray(rows, dtype=np.int64)
    return replay.ChangeColumns(
        buf=cols.buf,
        change=np.ascontiguousarray(cols.change[rows]),
        from_=np.ascontiguousarray(cols.from_[rows]),
        to=np.ascontiguousarray(cols.to[rows]),
        key_off=np.ascontiguousarray(cols.key_off[rows]),
        key_len=np.ascontiguousarray(cols.key_len[rows]),
        sub_off=np.ascontiguousarray(cols.sub_off[rows]),
        sub_len=np.ascontiguousarray(cols.sub_len[rows]),
        val_off=np.ascontiguousarray(cols.val_off[rows]),
        val_len=np.ascontiguousarray(cols.val_len[rows]),
    )


class RatelessReplica:
    """One replica's reconciliation state over a change log.

    ``source`` is decoded columns (:class:`~.replay.ChangeColumns`),
    raw change-log wire bytes (``bytes`` / uint8 array — per-record
    and/or batch frames), or a list of Change records/dicts.  Elements
    are the canonical per-record payload digests (framing-independent,
    the digest-pipeline contract), deduplicated — reconciliation is
    over the SET of record states.  The digests are B1's on ``device``
    (the plain version on the CPU); the coded symbols build there too.
    """

    def __init__(self, source, device="cuda"):
        from ..batch.feed import hash_extents
        from . import replay

        self.device = resolve_device(device)
        if isinstance(source, replay.ChangeColumns):
            cols = source
        elif isinstance(source, (bytes, bytearray, memoryview, np.ndarray)):
            cols, _ = replay.replay_log(
                np.frombuffer(bytes(source), np.uint8)
                if not isinstance(source, np.ndarray) else source)
        else:
            wire = replay.encode_change_log(list(source))
            cols, _ = replay.replay_log(np.frombuffer(wire, np.uint8))
        self.cols = cols
        with span("reconcile.digest"):
            buf, offs, lens = replay.canonical_change_extents(cols)
            digests = np.ascontiguousarray(
                hash_extents(buf, offs, lens, device=self.device))
        self._index(digests)

    @classmethod
    def from_digests(cls, cols, digests: np.ndarray, rows=None,
                     device="cuda") -> "RatelessReplica":
        """A replica over decoded ``cols`` whose canonical digests are
        already known: ``digests`` one per row (deduplicated here), or
        with ``rows`` the element set and each element's log row."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.cols = cols
        digests = np.ascontiguousarray(digests, dtype=np.uint8)
        if digests.ndim != 2 or digests.shape[1] != rateless.DIGEST_BYTES:
            raise ValueError("digests must be (n, 32) u8")
        if rows is None:
            if len(digests) != len(cols):
                raise ValueError(
                    f"{len(digests)} digests for {len(cols)} rows; pass "
                    "rows= with a deduplicated element set")
            self._index(digests)
        else:
            rows = np.ascontiguousarray(rows, dtype=np.int64)
            if rows.shape != (len(digests),):
                raise ValueError("rows must give one log row per digest")
            self._set_digests(digests, rows)
        return self

    def _index(self, digests: np.ndarray) -> None:
        """Dedupe per-row ``digests`` and build the digest -> row lookup.
        Both share ONE argsort on the common path, all first words
        distinct; colliding or duplicate runs take the exact slow path."""
        k0 = digests.view("<u8")[:, 0]
        order = np.argsort(k0, kind="stable").astype(np.int64)
        sk = k0[order]
        if len(sk) == 0 or not (sk[1:] == sk[:-1]).any():
            self.digests = digests
            self._digest_rows = np.arange(len(digests), dtype=np.int64)
            self._order = order
            self._sorted_k0 = sk
        else:
            self._set_digests(*rateless.dedupe_digests(digests))

    def _set_digests(self, digests: np.ndarray, rows: np.ndarray) -> None:
        """Adopt the deduplicated element set and its log ``rows``, and
        build the sorted-first-word lookup."""
        self.digests = digests
        self._digest_rows = rows
        uk = digests.view("<u8")[:, 0]
        self._order = np.argsort(uk, kind="stable").astype(np.int64)
        self._sorted_k0 = uk[self._order]

    @property
    def n(self) -> int:
        return len(self.digests)

    def coded_symbols(self) -> rateless.CodedSymbols:
        return rateless.CodedSymbols(self.digests, device=self.device)

    def peel_decoder(self) -> rateless.PeelDecoder:
        return rateless.PeelDecoder(self.digests, device=self.device,
                                    assume_unique=True)

    def rows_for_digests(self, digests: np.ndarray) -> np.ndarray:
        """Log rows for digest queries; -1 where the digest is unknown
        (the reconcile protocol treats that as corruption — a decoded
        element the supposed owner does not hold)."""
        q = np.ascontiguousarray(digests, dtype=np.uint8)
        if q.ndim != 2 or q.shape[1] != rateless.DIGEST_BYTES:
            raise ValueError("digest queries must be (k, 32) u8")
        out = np.full(len(q), -1, dtype=np.int64)
        if not len(q) or not self.n:
            return out
        qk = q.view("<u8")[:, 0]
        pos = np.searchsorted(self._sorted_k0, qk)
        ok = pos < len(self._sorted_k0)
        ok[ok] &= self._sorted_k0[pos[ok]] == qk[ok]
        cand = np.nonzero(ok)[0]
        uni = self._order[pos[cand]]
        exact = (self.digests[uni] == q[cand]).all(axis=1)
        out[cand[exact]] = self._digest_rows[uni[exact]]
        # first-word match but row mismatch: a collision run — resolve
        # against every member of the run (astronomically rare)
        for qi in cand[~exact].tolist():
            at = pos[qi]
            while at < len(self._sorted_k0) \
                    and self._sorted_k0[at] == qk[qi]:
                u = self._order[at]
                if (self.digests[u] == q[qi]).all():
                    out[qi] = self._digest_rows[u]
                    break
                at += 1
        return out

    def columns_for_rows(self, rows: np.ndarray):
        return _select_rows(self.cols, rows)

    def records_for_rows(self, rows: np.ndarray) -> list:
        """The log's records at ``rows``, absent optionals kept absent
        (``None``), so the ChangeBatch frames that ship them carry the
        log's own bytes and equal :func:`_batch_wire_len`'s metering.
        (The JAX driver ships ``cols.row``'s present-empty form, one
        flags byte a frame longer than it meters when a record lacks an
        optional; the receiving decoder delivers both forms alike.)"""
        cols = self.cols
        out = []
        for i in map(int, rows):
            rec = cols.row(i)
            if cols.val_len[i] < 0:
                rec.value = None
            if cols.sub_len[i] < 0:
                rec.subset = None
            out.append(rec)
        return out


class ResponderState:
    """Transport-free responder core: one reconcile session's decode
    state.  :meth:`handle` consumes a decoded message and returns reply
    payloads (reconcile-codec bytes); record frames from the remote are
    fed through :meth:`note_remote_record`.  :meth:`result` is the
    failure-contract choke point: the exact diff, or ONE structured
    ProtocolError."""

    def __init__(self, replica: RatelessReplica,
                 overhead_cap: float = DEFAULT_OVERHEAD_CAP,
                 max_symbols: int = DEFAULT_MAX_SYMBOLS):
        self.replica = replica
        self.peeler = replica.peel_decoder()
        self.overhead_cap = overhead_cap
        self.max_symbols = max_symbols
        self.begun = False
        self.n_remote: int | None = None
        self.decoded = None  # (digests, signs) on completion
        self.failed: ProtocolError | None = None
        self.remote_records: list = []
        self.rounds = 0

    # -- protocol ------------------------------------------------------------

    def _fail(self, message: str) -> list[bytes]:
        self.failed = ProtocolError(message, offset=self.peeler.symbols_seen)
        if _OBS.on:
            _emit("reconcile.fail", symbols=self.peeler.symbols_seen,
                  message=message)
        return [rc.encode_fail(self.peeler.symbols_seen, message)]

    def _symbol_cap(self) -> int:
        n_remote = self.n_remote if self.n_remote is not None else 0
        claim_cap = int(self.overhead_cap
                        * max(n_remote + self.replica.n, 64)) + 256
        # the absolute budget WINS over the claim-scaled cap: the claim
        # is the remote's word, the budget is this process's memory
        return min(claim_cap, self.max_symbols)

    def handle(self, msg: rc.ReconcileMsg) -> list[bytes]:
        if self.failed is not None:
            return []
        if msg.kind == rc.RC_BEGIN:
            if self.begun:
                return self._fail("duplicate reconcile begin")
            self.begun = True
            self.n_remote = msg.n
            return []
        if msg.kind == rc.RC_SYMBOLS:
            if not self.begun:
                return self._fail("reconcile symbols before begin")
            if self.decoded is not None:
                return []  # late batch after completion: ignorable
            try:
                self.peeler.add_symbols(msg.start, msg.cells)
            except ValueError as e:
                return self._fail(str(e))
            self.rounds += 1
            if _OBS.on:
                _M_ROUNDS.inc()
                _G_SYMBOLS.set(self.peeler.symbols_seen)
            out = self.peeler.try_decode()
            if out is not None:
                self.decoded = out
                digests, signs = out
                if _OBS.on:
                    _G_DIFF.set(len(digests))
                    _emit("reconcile.decoded", diff=len(digests),
                          symbols=self.peeler.symbols_seen,
                          rounds=self.rounds)
                # sanity: every remote-only element must be unknown to
                # us, every local-only element known — a violation is a
                # decode gone wrong (checksum-collision grade), caught
                # here rather than shipped
                rows = self.replica.rows_for_digests(digests)
                if ((signs == 1) & (rows >= 0)).any() \
                        or ((signs == -1) & (rows < 0)).any():
                    return self._fail(
                        "reconcile decode produced inconsistent elements")
                return [rc.encode_done(self.peeler.symbols_seen,
                                       digests[signs == 1])]
            if self.peeler.symbols_seen > self._symbol_cap():
                return self._fail(
                    f"no decode after {self.peeler.symbols_seen} symbols "
                    f"(sets of {self.n_remote}+{self.replica.n})")
            return [rc.encode_more(self.peeler.symbols_seen)]
        # DONE/MORE/FAIL are initiator-bound; receiving one here is a
        # misrouted peer
        return self._fail(
            f"unexpected reconcile message {msg.kind_name!r} at responder")

    # -- record exchange ------------------------------------------------------

    def note_remote_record(self, change) -> None:
        self.remote_records.append(change)
        if _OBS.on:
            _M_RECORDS.inc()

    def local_only_rows(self) -> np.ndarray:
        """Rows of THIS replica's log the remote is missing (decoded
        sign −1), to be sent over ChangeBatch frames."""
        if self.decoded is None:
            return np.empty(0, np.int64)
        digests, signs = self.decoded
        return self.replica.rows_for_digests(digests[signs == -1])

    # -- outcome --------------------------------------------------------------

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        """The decoded diff ``(digests, signs)``; raises the session's
        ONE structured ProtocolError when the stream failed or ended
        before decode completed."""
        if self.failed is not None:
            raise self.failed
        if self.decoded is None:
            raise ProtocolError(
                "reconcile stream ended before decode completed",
                offset=self.peeler.symbols_seen)
        return self.decoded


def _batch_wire_len(cols) -> int:
    """Exact ChangeBatch wire bytes for a column subset (metering)."""
    from . import replay

    return len(replay.encode_batch_frames(cols)) if len(cols) else 0


def reconcile_local(replica_a: RatelessReplica, replica_b: RatelessReplica,
                    batch0: int = DEFAULT_BATCH0,
                    overhead_cap: float = DEFAULT_OVERHEAD_CAP) -> dict:
    """Run the full protocol between two in-memory replicas with exact
    wire metering — every message round-trips the real payload codec
    and is billed at its framed wire length, record exchange included.

    Returns ``{"symbols", "rounds", "wire_a2b", "wire_b2a",
    "wire_bytes", "a_rows", "b_rows", "a_cols", "b_cols"}`` where
    ``a_rows`` are A-log rows B was missing (shipped A->B... A->B is
    the symbol direction; records travel both ways) and ``a_cols`` /
    ``b_cols`` the exchanged column subsets (apply = replay them)."""
    state = ResponderState(replica_b, overhead_cap=overhead_cap)
    syms = replica_a.coded_symbols()
    wire = {"a2b": 0, "b2a": 0}

    def a2b(payload: bytes) -> list[bytes]:
        wire["a2b"] += frame_wire_len(len(payload))
        replies = state.handle(rc.decode_reconcile(payload))
        for r in replies:
            wire["b2a"] += frame_wire_len(len(r))
        return replies

    replies = a2b(rc.encode_begin(replica_a.n))
    sent = 0
    m = 0
    rounds = 0
    final = None
    while final is None:
        if replies and (final := rc.decode_reconcile(replies[-1])).kind \
                in (rc.RC_DONE, rc.RC_FAIL):
            break
        final = None
        m = batch0 if m == 0 else m * 2
        cells = syms.extend(m)[sent:]
        payload = rc.encode_symbols(sent, cells)
        sent = m
        rounds += 1
        replies = a2b(payload)
    if final.kind == rc.RC_FAIL:
        state.result()  # raises the structured error
    # record exchange: A ships the rows B requested, B ships its
    # local-only rows — both metered at real ChangeBatch wire size
    a_rows = replica_a.rows_for_digests(final.digests)
    if (a_rows < 0).any():
        raise ProtocolError(
            "peer requested records this replica does not hold",
            offset=wire["a2b"])
    b_rows = state.local_only_rows()
    a_cols = replica_a.columns_for_rows(a_rows)
    b_cols = replica_b.columns_for_rows(b_rows)
    wire["a2b"] += _batch_wire_len(a_cols)
    wire["b2a"] += _batch_wire_len(b_cols)
    return {
        "symbols": sent,
        "rounds": rounds,
        "wire_a2b": wire["a2b"],
        "wire_b2a": wire["b2a"],
        "wire_bytes": wire["a2b"] + wire["b2a"],
        "a_rows": a_rows,
        "b_rows": b_rows,
        "a_cols": a_cols,
        "b_cols": b_cols,
    }


# -- live duplex drivers -----------------------------------------------------


def run_initiator(replica: RatelessReplica, read_bytes, write_bytes,
                  close_write=None, batch0: int = DEFAULT_BATCH0,
                  journal=None, chunk_size: int = 64 * 1024) -> dict:
    """Drive one reconciliation as the initiator over a duplex byte
    pair (the :mod:`..session.transport` contract: blocking
    ``read_bytes(n)`` / ``write_bytes(data)``).

    Streams BEGIN + doubling symbol batches, answers the responder's
    MORE/DONE/FAIL, ships the requested records as ChangeBatch frames,
    and collects the responder's differing records.  ``journal`` (a
    :class:`~..session.resume.WireJournal`) tees the outgoing wire for
    resume after a reconnect.  Returns
    ``{"ok", "symbols", "rounds", "records_sent", "received"}``;
    raises the session's structured ProtocolError on failure."""
    enc = Encoder(peer_caps=CAP_RECONCILE | CAP_CHANGE_BATCH)
    if journal is not None:
        enc.attach_journal(journal)
    dec = Decoder()
    syms = replica.coded_symbols()
    received: list = []
    stats = {"sent": 0, "rounds": 0, "records_sent": 0}
    err: list[ProtocolError] = []

    def send_next() -> None:
        m = batch0 if stats["sent"] == 0 else stats["sent"] * 2
        cells = syms.extend(m)[stats["sent"]:]
        enc.reconcile_frame(rc.encode_symbols(stats["sent"], cells))
        stats["sent"] = m
        stats["rounds"] += 1
        if _OBS.on:
            _M_ROUNDS.inc()
            _G_SYMBOLS.set(m)

    def on_reconcile(msg, done) -> None:
        if msg.kind == rc.RC_MORE:
            send_next()
        elif msg.kind == rc.RC_DONE:
            rows = replica.rows_for_digests(msg.digests)
            if (rows < 0).any():
                e = ProtocolError(
                    "peer requested records this replica does not hold",
                    frame=dec._frames_delivered(), offset=dec.bytes)
                err.append(e)
                done()
                dec.destroy(e)
                return
            recs = replica.records_for_rows(rows)
            if recs:
                enc.change_many(recs)
            stats["records_sent"] = len(recs)
            if _OBS.on and recs:
                _M_RECORDS.inc(len(recs))
            enc.finalize()
        elif msg.kind == rc.RC_FAIL:
            e = ProtocolError(
                f"reconcile failed at peer: {msg.reason}",
                frame=dec._frames_delivered(), offset=dec.bytes)
            err.append(e)
            done()
            dec.destroy(e)
            return
        else:
            e = ProtocolError(
                f"unexpected reconcile message {msg.kind_name!r} at "
                "initiator", frame=dec._frames_delivered(),
                offset=dec.bytes)
            err.append(e)
            done()
            dec.destroy(e)
            return
        done()

    dec.reconcile(on_reconcile)
    dec.change(lambda c, done_cb: (received.append(c), done_cb()))
    # error hook, not user code: destroy() only flips state and wakes
    # watchers — it never blocks the registering loop
    dec.on_error(lambda _e: None if enc.destroyed else enc.destroy())

    enc.reconcile_frame(rc.encode_begin(replica.n))
    send_next()

    sender = start_sender(enc, write_bytes, close_write, chunk_size,
                          name="reconcile-init-send")
    try:
        recv_over(dec, read_bytes, chunk_size=chunk_size)
    except Exception as e:
        if not dec.destroyed:
            dec.destroy(e)
        if not enc.destroyed:
            enc.destroy(e)
        raise
    finally:
        if dec.destroyed and not enc.destroyed:
            enc.destroy()
        sender.join(timeout=30)
    if err:
        raise err[0]
    if not dec.finished or enc.destroyed:
        raise ProtocolError("reconcile session ended unexpectedly",
                            offset=dec.bytes)
    return {"ok": True, "symbols": stats["sent"],
            "rounds": stats["rounds"],
            "records_sent": stats["records_sent"], "received": received}


def responder_machine(replica: RatelessReplica, *,
                      overhead_cap: float = DEFAULT_OVERHEAD_CAP,
                      max_symbols: int = DEFAULT_MAX_SYMBOLS) -> tuple:
    """The responder's protocol machine, factored off its threads:
    the encoder/decoder pair with the full MORE/DONE/FAIL
    + record exchange wired, returned as ``(enc, dec, finish)``.  The
    caller owns byte movement — the threaded :func:`run_responder`
    pumps them with a sender thread + blocking recv loop, the
    event-driven edge steps them from ONE selector turn with the same
    frames on the wire.  ``finish()`` is idempotent: tears down a
    half-open encoder, raises the session's structured ProtocolError
    if the decode failed, and returns the stats record both callers
    emit (``{"ok", "symbols", "rounds", "records_sent",
    "received"}``)."""
    enc = Encoder(peer_caps=CAP_RECONCILE | CAP_CHANGE_BATCH)
    dec = Decoder()
    state = ResponderState(replica, overhead_cap=overhead_cap,
                           max_symbols=max_symbols)
    sent_records = {"n": 0}

    def on_reconcile(msg, done) -> None:
        replies = state.handle(msg)
        done_now = state.decoded is not None and replies
        for r in replies:
            enc.reconcile_frame(r)
        if done_now:
            rows = state.local_only_rows()
            recs = replica.records_for_rows(rows)
            if recs:
                enc.change_many(recs)
            sent_records["n"] = len(recs)
            if _OBS.on and recs:
                _M_RECORDS.inc(len(recs))
            enc.finalize()
        elif state.failed is not None:
            enc.finalize()  # the FAIL frame is the last word
        done()

    dec.reconcile(on_reconcile)
    dec.change(lambda c, done_cb: (state.note_remote_record(c), done_cb()))
    # error hook, not user code: destroy() only flips state and wakes
    # watchers — it never blocks the registering loop
    # datlint: allow-callback-escape
    dec.on_error(lambda _e: None if enc.destroyed else enc.destroy())

    def finish() -> dict:
        if not enc.destroyed and not enc.finalized:
            # peer went away before decode completed: release the
            # reply pump / drop the reply tail
            enc.destroy()
        state.result()  # raises the structured error on a failed session
        return {"ok": dec.finished and not dec.destroyed,
                "symbols": state.peeler.symbols_seen,
                "rounds": state.rounds,
                "records_sent": sent_records["n"],
                "received": state.remote_records}

    return enc, dec, finish


def run_responder(replica: RatelessReplica, read_bytes, write_bytes,
                  close_write=None,
                  overhead_cap: float = DEFAULT_OVERHEAD_CAP,
                  max_symbols: int = DEFAULT_MAX_SYMBOLS,
                  chunk_size: int = 64 * 1024) -> dict:
    """Serve one reconciliation as the responder over a duplex byte
    pair: decode the initiator's symbol stream, answer MORE/DONE/FAIL,
    ship this replica's differing records, collect the initiator's.
    Returns ``{"ok", "symbols", "rounds", "records_sent",
    "received"}``; raises the session's structured ProtocolError on a
    failed decode (after tearing both directions down)."""
    enc, dec, finish = responder_machine(replica,
                                         overhead_cap=overhead_cap,
                                         max_symbols=max_symbols)
    sender = start_sender(enc, write_bytes, close_write, chunk_size,
                          name="reconcile-resp-send")
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
            # initiator went away before decode completed: release the
            # reply pump so the thread does not park forever
            enc.destroy()
        sender.join(timeout=30)
    return finish()
