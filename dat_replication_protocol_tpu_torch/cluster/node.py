"""One gossip replica: a change log, rateless anti-entropy and an optional
fan-out group behind one small state machine.

A trimmed copy of ``dat_replication_protocol_tpu/cluster/node.py``.  A
:class:`ReplicaNode` composes the pairwise and one-to-many pieces into
the N-replica epidemic shape, convergence from any divergence with no
distinguished source:

* the **log** is change-log wire bytes; records are the set elements and
  a record's identity is its canonical digest, hashed by kernel B1 on
  the node's ``device`` (:class:`~..runtime.reconcile_driver.RatelessReplica`);
* **anti-entropy** is rateless reconciliation: :func:`gossip_exchange`
  runs the real codec payloads through the chaos transport, so flips,
  truncations and drops land at real wire offsets;
* the **fan-out leg** is a :class:`~..fanout.log.BroadcastLog`: applied
  repairs are published once and every group follower drains them, with
  the retention budget and its ``SnapshotNeeded`` -> snapshot bootstrap
  arm (B6 for the cuts, B1 for the chunk digests);
* the gossip round, repair and quarantine counters ride the registry
  (``gossip.*``) and the sidecar's ``--replica`` stats.

Failure contract:

* a transport-class failure (drop, truncation, a partitioned link)
  changes NO replica state: the exchange did not happen;
* a corruption-class failure surfaces as ONE structured
  :class:`~..wire.framing.ProtocolError` an exchange: never a wrong
  diff, never a partial apply;
* a peer whose exchanges were corrupt ``byzantine_after`` times in all
  is **quarantined** with a structured :class:`ByzantineDivergence`;
  gossip goes on around it.

Every build of the node's replica (after each absorb), every repair
verification and every bootstrap runs on ``device`` (default
``"cuda"``): there is no other path, and a CUDA device without a card
raises at the first build.
"""

from __future__ import annotations

import hashlib
import random
import threading
import time
from typing import Optional

import numpy as np

from ..fanout.log import BroadcastLog
from ..obs import propagation as _propagation
from ..obs import wirecost as _wirecost
from ..obs.events import emit as _emit
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..runtime import replay
from ..runtime.reconcile_driver import (
    DEFAULT_BATCH0,
    DEFAULT_OVERHEAD_CAP,
    RatelessReplica,
    ResponderState,
)
from ..session.faults import FaultPlan, FaultyReader, TransportFault
from ..wire import reconcile_codec as rc
from ..wire.change_codec import Change
from ..wire.framing import ProtocolError, frame_wire_len
from ..wire.framing import header_len as _header_len

__all__ = [
    "ByzantineDivergence",
    "PeerQuarantined",
    "ReplicaNode",
    "ByzantineReplicaNode",
    "gossip_exchange",
    "classify_error",
    "STATES",
    "DEFAULT_BYZANTINE_AFTER",
]

# the one replica state machine: idle between rounds, gossiping during an
# exchange, draining its group feeds, bootstrapping over the snapshot
# protocol, or crashed (churn)
STATES = ("idle", "gossip", "fanout", "bootstrap", "crashed")

# corrupt exchanges with one peer before it is quarantined: one can be
# the wire (a flipped byte on a chaotic link), a repeat offender is a
# liar.  Suspicion is cumulative per peer, so a replica that lies only
# when its content is requested cannot launder its record with clean
# exchanges in between.
DEFAULT_BYZANTINE_AFTER = 2

_M_ROUNDS = _counter("gossip.rounds")
_M_EXCHANGES = _counter("gossip.exchanges")
_M_REPAIRS_IN = _counter("gossip.repairs.applied")
_M_REPAIRS_OUT = _counter("gossip.repairs.sent")
_M_QUARANTINES = _counter("gossip.quarantines")
_M_TRANSPORT = _counter("gossip.transport.failures")
_M_CORRUPT = _counter("gossip.corrupt.exchanges")
_M_BOOTSTRAPS = _counter("gossip.bootstraps")

_BAD_LABEL_CHARS = '{},="\n\r'


def _check_key(value: str) -> str:
    # replica keys ride label sets and JSON breakdowns
    if not isinstance(value, str) or not value or any(
            c in value for c in _BAD_LABEL_CHARS):
        raise ValueError(
            f"replica key {value!r} must be a non-empty string "
            'containing none of {},=" or newlines')
    return value


class ByzantineDivergence(ProtocolError):
    """A peer's wire provably diverged from its claims: coded symbols
    that cannot come from a real set, repair records that do not hash to
    the digests they answer, or a fan-out ack that regresses.  Beside
    the wire coordinates (``frame``, ``offset``), ``peer`` names the
    quarantined replica and ``arm`` the detection arm
    (``wrong-symbol`` / ``wrong-chunk-digest`` / ``ack-regression`` /
    ``feed-corrupt``)."""

    def __init__(self, message: str, *, peer: str,
                 arm: Optional[str] = None, frame: Optional[int] = None,
                 offset: Optional[int] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(message, frame=frame, offset=offset, cause=cause)
        self.peer = peer
        self.arm = arm


class PeerQuarantined(ProtocolError):
    """Refusal to gossip with a quarantined peer: ``peer``, and the
    refusing side's round as ``offset``, so a refused dialer can tell it
    apart from a dead link."""

    def __init__(self, message: str, *, peer: str,
                 frame: Optional[int] = None,
                 offset: Optional[int] = None):
        super().__init__(message, frame=frame, offset=offset)
        self.peer = peer


def classify_error(err: BaseException) -> str:
    """``transport`` (retryable, no state changed: drops, truncations,
    dead links) or ``corruption`` (a structured protocol failure:
    suspicion accrues toward quarantine)."""
    if isinstance(err, TransportFault):
        return "transport"
    if isinstance(err, ProtocolError):
        return "corruption"
    return "corruption" if isinstance(err, ValueError) else "transport"


def _content_digest(digests: np.ndarray) -> bytes:
    """The replica content digest: BLAKE2b-256 over the SORTED unique
    canonical record digests, so two replicas holding the same record set
    hash alike however their logs interleaved."""
    if len(digests) == 0:
        return hashlib.blake2b(b"", digest_size=32).digest()
    view = np.ascontiguousarray(digests).view("<u8").reshape(len(digests), 4)
    order = np.lexsort(tuple(view[:, i] for i in range(3, -1, -1)))
    return hashlib.blake2b(
        np.ascontiguousarray(digests[order]).tobytes(),
        digest_size=32).digest()


class _ChaosLink:
    """One direction of a gossip link: payloads stream through the fault
    state, so a plan's flip/truncate/drop coordinates land at real
    accumulated wire offsets across the round's messages."""

    __slots__ = ("_buf", "_reader", "_plan")

    def __init__(self, plan: Optional[FaultPlan]):
        self._plan = plan
        self._buf = bytearray()
        self._reader = None if plan is None else FaultyReader(
            self._pull, plan)

    def _pull(self, n: int) -> bytes:
        take = bytes(self._buf[:max(1, n)])
        del self._buf[:max(1, n)]
        return take

    @property
    def offset(self) -> int:
        return 0 if self._reader is None else self._reader.offset

    def send(self, payload: bytes) -> bytes:
        """Deliver ``payload`` through the link.  Raises
        :class:`TransportFault` on a drop or a truncation (a short
        delivery is a dead connection); flips arrive as corrupted bytes
        for the codec to refuse."""
        if self._reader is None:
            return payload
        self._buf += payload
        out = bytearray()
        while len(out) < len(payload):
            chunk = self._reader.read(len(payload) - len(out))
            if not chunk:
                raise TransportFault(
                    f"gossip link truncated at byte {self._reader.offset}",
                    offset=self._reader.offset)
            out += chunk
        return bytes(out)


class ReplicaNode:
    """See the module docstring.  Thread-safe: the live sidecar drives one
    node from a gossip timer thread AND inbound responder sessions; the
    simulator drives it from one thread."""

    def __init__(self, key: str, records=(), *, seed: int = 0,
                 device="cuda",
                 byzantine_after: int = DEFAULT_BYZANTINE_AFTER,
                 fanout_retention: Optional[int] = None,
                 delivered_form: bool = False):
        self.key = _check_key(key)
        # delivered_form (the live mesh, load_replica_node): the log is
        # normalized to the per-record DELIVERED form (absent optionals
        # as ''/b''), the form every decoder delivery produces; a live
        # replica that kept absent-form digests would re-reconcile those
        # records against its peers forever.  The simulator keeps the
        # byte-exact wire form.
        self.delivered_form = bool(delivered_form)
        self.device = device
        self._lock = threading.Lock()
        # the log is WIRE BYTES: repairs arrive as framed batch or record
        # bytes and are absorbed verbatim, so absent and present-empty
        # optionals (and so the canonical digests) survive byte-exactly.
        # Guarded by self._lock: _wire, _replica, _wire_ver.
        self._wire = bytearray(self._as_wire(records))
        self._replica: Optional[RatelessReplica] = None
        self._wire_ver = 0
        self.state = "idle"
        self.round = 0
        self.byzantine_after = max(1, int(byzantine_after))
        self.quarantined: dict[str, ByzantineDivergence] = {}
        self._suspect: dict[str, int] = {}
        self._rng = random.Random(seed)
        self.stats = {
            "rounds": 0, "sampled": 0, "exchanges_ok": 0,
            "transport_failures": 0, "corrupt_exchanges": 0,
            "refusals": 0, "repairs_applied": 0, "repairs_sent": 0,
            "quarantines": 0, "bootstraps": 0, "wire_bytes": 0,
        }
        # the fan-out leg: applied repairs are published ONCE into this
        # log; group followers drain it.  log_gen lets a follower detect
        # a restarted owner (fresh log, fresh offsets).
        self.log: Optional[BroadcastLog] = (
            BroadcastLog(retention_budget=fanout_retention)
            if fanout_retention else None)
        self.log_gen = 0
        # follower side: owner key -> (owner log_gen, offset)
        self._feed_pos: dict[str, tuple] = {}
        # owner side: follower key -> acked offset (monotonic and at most
        # log.end; a violation is the ack-regression arm)
        self._follower_acks: dict[str, int] = {}

    # -- log ------------------------------------------------------------------

    def _as_wire(self, records) -> bytes:
        """Records (Change objects or dicts) or framed wire bytes, as wire
        bytes (in the delivered form in ``delivered_form`` mode)."""
        if isinstance(records, (bytes, bytearray, memoryview)):
            wire = bytes(records)
            if not self.delivered_form or not wire:
                return wire
            cols, _ = replay.replay_log(np.frombuffer(wire, np.uint8))
            records = [cols.row(i) for i in range(len(cols))]
        records = [Change.from_dict(r) if isinstance(r, dict) else r
                   for r in records]
        if self.delivered_form:
            records = [Change(key=r.key, change=r.change, from_=r.from_,
                              to=r.to, value=r.value or b"",
                              subset=r.subset or "") for r in records]
        return replay.encode_change_log(records) if records else b""

    @property
    def replica(self) -> RatelessReplica:
        """The node's reconciliation state, rebuilt lazily after the log
        changed (a B1 launch over every record on ``device``).  The build
        runs OUTSIDE the node lock, with a version guard: a build that a
        concurrent absorb made stale is returned to its caller but not
        cached."""
        with self._lock:
            rep = self._replica
            if rep is not None:
                return rep
            wire = bytes(self._wire)
            ver = self._wire_ver
        rep = RatelessReplica(wire, device=self.device)
        with self._lock:
            if self._replica is None and self._wire_ver == ver:
                self._replica = rep
            return self._replica if self._replica is not None else rep

    @property
    def record_count(self) -> int:
        """Distinct record states held (the log may carry duplicate
        frames; identity is the canonical digest set)."""
        return self.replica.n

    def content_digest(self) -> bytes:
        """Equal across replicas holding the same record set: the
        convergence invariant."""
        return _content_digest(self.replica.digests)

    def canonical_wire(self) -> bytes:
        """The log as framed wire bytes (the snapshot-bootstrap dataset
        and the checkpoint payload)."""
        with self._lock:
            return bytes(self._wire)

    def absorb(self, repairs, count: Optional[int] = None,
               peer: Optional[str] = None) -> int:
        """Append repair wire (or records) to the log verbatim (duplicates
        are harmless).  Returns the records absorbed (``count`` when the
        caller already decoded them)."""
        wire = self._as_wire(repairs)
        if not wire:
            return 0
        with self._lock:
            self._wire += wire
            self._replica = None
            self._wire_ver += 1
        n = count if count is not None else len(
            replay.replay_log(np.frombuffer(wire, np.uint8))[0])
        self.stats["repairs_applied"] += n
        if _OBS.on:
            _M_REPAIRS_IN.inc(n)
        return n

    # -- byzantine hooks (overridden by ByzantineReplicaNode) ----------------

    def coded_symbols_out(self):
        return self.replica.coded_symbols()

    def ship_wire(self, rows: np.ndarray) -> bytes:
        """Rows as byte-preserving ChangeBatch frames (absent optionals
        keep their sentinels, so canonical digests survive the trip)."""
        return replay.encode_batch_frames(
            self.replica.columns_for_rows(rows))

    def feed_ack_for(self, owner_key: str, offset: int) -> int:
        return offset

    def publish_wire(self, wire: bytes) -> bytes:
        return wire

    # -- sampling / quarantine ------------------------------------------------

    def begin_round(self, rnd: Optional[int] = None) -> None:
        """One timer tick: advance the round counter."""
        self.round = self.round + 1 if rnd is None else rnd
        self.stats["rounds"] += 1
        if _OBS.on:
            _M_ROUNDS.inc()

    def sample_peer(self, peers) -> Optional[str]:
        """This round's partner: uniform over the known peers minus self
        and the quarantined set."""
        live = [p for p in peers
                if p != self.key and p not in self.quarantined]
        if not live:
            return None
        self.stats["sampled"] += 1
        return self._rng.choice(live)

    def is_quarantined(self, peer: str) -> bool:
        return peer in self.quarantined

    def refuse_if_quarantined(self, peer: str) -> None:
        if peer in self.quarantined:
            raise PeerQuarantined(
                f"replica {self.key!r} refuses {peer!r}: quarantined "
                f"({self.quarantined[peer].arm})",
                peer=peer, offset=self.round)

    def note_success(self, peer: str) -> None:
        # clears no suspicion: it is cumulative per peer
        self.stats["exchanges_ok"] += 1
        if _OBS.on:
            _M_EXCHANGES.inc()

    def note_transport_failure(self, peer: str) -> None:
        self.stats["transport_failures"] += 1
        if _OBS.on:
            _M_TRANSPORT.inc()

    def note_corruption(self, peer: str,
                        err: BaseException) -> Optional[ByzantineDivergence]:
        """A corruption-class failure with ``peer``: suspicion accrues; at
        ``byzantine_after`` corrupt exchanges in all the peer is
        quarantined and the structured divergence returned."""
        self.stats["corrupt_exchanges"] += 1
        if _OBS.on:
            _M_CORRUPT.inc()
        n = self._suspect.get(peer, 0) + 1
        self._suspect[peer] = n
        if n < self.byzantine_after or peer in self.quarantined:
            return None
        return self.quarantine(peer, err)

    def quarantine(self, peer: str,
                   err: BaseException) -> ByzantineDivergence:
        """Quarantine ``peer`` with a structured divergence record: sampling
        skips it, inbound exchanges are refused with
        :class:`PeerQuarantined`."""
        if isinstance(err, ByzantineDivergence) and err.peer == peer:
            div = err
        else:
            div = ByzantineDivergence(
                f"replica {peer!r} quarantined by {self.key!r}: {err}",
                peer=peer,
                arm=getattr(err, "arm", None) or "wrong-symbol",
                frame=getattr(err, "frame", None),
                offset=getattr(err, "offset", None), cause=err)
        self.quarantined[peer] = div
        self._suspect.pop(peer, None)
        self.stats["quarantines"] += 1
        if _OBS.on:
            _M_QUARANTINES.inc()
            _emit("gossip.quarantine", replica=self.key, peer=peer,
                  arm=div.arm or "?", offset=div.offset or 0)
        return div

    # -- fan-out leg ----------------------------------------------------------

    def publish_repairs(self, wire: bytes) -> int:
        """Publish applied repair WIRE into the broadcast log verbatim:
        nothing is re-encoded or re-hashed here."""
        if self.log is None or not wire:
            return 0
        wire = self.publish_wire(bytes(wire))
        self.log.append(wire)
        return len(wire)

    def note_follower_ack(self, follower: str, offset: int) -> None:
        """Owner-side ack validation: an ack that regresses or claims
        bytes never produced is a liar, not flow control."""
        if self.log is None:
            return
        last = self._follower_acks.get(follower, 0)
        if offset < last or offset > self.log.end:
            div = ByzantineDivergence(
                f"byzantine ack from {follower!r}: offset {offset} "
                f"outside [{last}, {self.log.end}]",
                peer=follower, arm="ack-regression", offset=offset)
            self.quarantine(follower, div)
            raise div
        self._follower_acks[follower] = offset

    def drain_feed(self, owner: "ReplicaNode") -> int:
        """Follower-side group drain: pull the owner's new broadcast
        bytes, decode, absorb.  Raises :class:`SnapshotNeeded` when the
        retention budget trimmed past this follower (the caller runs the
        bootstrap), :class:`ByzantineDivergence` on a feed that does not
        parse."""
        if owner.log is None or self.is_quarantined(owner.key):
            return 0
        self.state = "fanout"
        try:
            gen, off = self._feed_pos.get(owner.key, (owner.log_gen, 0))
            if gen != owner.log_gen:
                # the owner restarted: fresh log, fresh offsets; re-attach
                # at the start of its retained window
                gen, off = owner.log_gen, owner.log.start
            data = owner.log.read_from(off)  # raises SnapshotNeeded
            if not data:
                self._feed_pos[owner.key] = (gen, off)
                return 0
            try:
                cols, _ = replay.replay_log(
                    np.frombuffer(data, np.uint8))
            except (ValueError, ProtocolError) as e:
                div = ByzantineDivergence(
                    f"broadcast feed from {owner.key!r} does not parse "
                    f"at byte {off}: {e}",
                    peer=owner.key, arm="feed-corrupt", offset=off,
                    cause=e)
                self.quarantine(owner.key, div)
                raise div from e
            self.absorb(data, count=len(cols), peer=owner.key)
            new_off = off + len(data)
            self._feed_pos[owner.key] = (gen, new_off)
            owner.note_follower_ack(
                self.key, self.feed_ack_for(owner.key, new_off))
            return len(cols)
        finally:
            self.state = "idle"

    # -- bootstrap ------------------------------------------------------------

    def bootstrap_from(self, owner: "ReplicaNode") -> dict:
        """Churn or flash-crowd recovery over the content-addressed
        snapshot protocol: materialize the owner's dataset (B6 for the
        cuts, B1 for the chunk digests, on this node's ``device``), fetch
        what this node lacks as verified chunks, merge, and re-attach the
        feed cursor at the owner's live window."""
        from ..runtime.snapshot_driver import SnapshotSource, snapshot_local

        self.state = "bootstrap"
        try:
            have = self.canonical_wire() or None
            res = snapshot_local(
                SnapshotSource(owner.canonical_wire(), device=self.device),
                have=have, device=self.device)
            self.absorb(res["data"], peer=owner.key)
            if owner.log is not None:
                self._feed_pos[owner.key] = (owner.log_gen, owner.log.end)
            self.stats["bootstraps"] += 1
            self.stats["wire_bytes"] += res["wire_bytes"]
            if _OBS.on:
                _M_BOOTSTRAPS.inc()
                _emit("gossip.bootstrap", replica=self.key,
                      owner=owner.key, wire_bytes=res["wire_bytes"])
            return res
        finally:
            self.state = "idle"

    # -- churn ----------------------------------------------------------------

    def checkpoint(self) -> dict:
        """Restartable state: the log as wire bytes and the cursors a
        resumed node needs (round, feed positions, log window).  Plain
        Python, the reference's keys: either package loads the other's."""
        with self._lock:
            wire = bytes(self._wire)
        return {
            "key": self.key,
            "round": self.round,
            "wire": wire,
            "feeds": dict(self._feed_pos),
            "log_end": None if self.log is None else self.log.end,
            "delivered_form": self.delivered_form,
        }

    @classmethod
    def from_checkpoint(cls, ckpt: dict, **kw) -> "ReplicaNode":
        """Churn restart from :meth:`checkpoint`.  The broadcast log
        restarts EMPTY on a fresh generation; followers detect it and
        re-attach."""
        kw.setdefault("delivered_form", ckpt.get("delivered_form", False))
        node = cls(ckpt["key"], ckpt["wire"], **kw)
        node.round = ckpt["round"]
        node._feed_pos = dict(ckpt["feeds"])
        node.log_gen = 1  # a restart is a new feed generation
        return node

    def crash(self) -> None:
        self.state = "crashed"

    # -- telemetry ------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``gossip`` record of the sidecar's ``--stats-fd`` and
        ``/snapshot``."""
        return {
            "replica": self.key,
            "state": self.state,
            "round": self.round,
            "records": self.record_count,
            "digest": self.content_digest().hex(),
            "quarantined": sorted(self.quarantined),
            # which arm caught each quarantined peer, and where
            "quarantine": {
                peer: {"arm": err.arm, "frame": err.frame,
                       "offset": err.offset}
                for peer, err in sorted(self.quarantined.items())
            },
            "suspicion": {k: v for k, v in sorted(self._suspect.items())},
            **{k: v for k, v in self.stats.items()},
        }


class ByzantineReplicaNode(ReplicaNode):
    """A replica that lies on one arm of the protocol (the tests know
    what it corrupts, so every quarantine can be checked).  ``arm``:

    * ``wrong-symbol``: coded symbols XOR-corrupted after the build (a
      digest word of every cell), so no checksum verifies and the
      responder fails structurally at its symbol cap;
    * ``wrong-chunk``: repair records shipped with corrupted content, so
      the receiver's digest check refuses the apply
      (``wrong-chunk-digest``);
    * ``ack-regression``: fan-out feed acks regress, so the owner
      quarantines the follower;
    * ``feed-corrupt``: published broadcast wire is corrupted, so the
      follower's decode refuses the feed.
    """

    ARMS = ("wrong-symbol", "wrong-chunk", "ack-regression",
            "feed-corrupt")

    def __init__(self, key: str, records=(), *, arm: str = "wrong-symbol",
                 **kw):
        if arm not in self.ARMS:
            raise ValueError(f"unknown byzantine arm {arm!r}")
        super().__init__(key, records, **kw)
        self.arm = arm
        self._evil_rng = random.Random(0xBAD)
        self._ack_memo: dict[str, int] = {}

    def coded_symbols_out(self):
        syms = super().coded_symbols_out()
        if self.arm != "wrong-symbol":
            return syms
        outer = self

        class _Corrupt:
            def extend(self, m: int) -> np.ndarray:
                cells = np.array(syms.extend(m), copy=True)
                if len(cells):
                    # column 3 is the first word of the digest sum: the
                    # 64-bit checksums cannot verify, no cell peels
                    cells[:, 3] ^= np.uint32(
                        outer._evil_rng.randrange(1, 1 << 30))
                return cells

        return _Corrupt()

    def ship_wire(self, rows: np.ndarray) -> bytes:
        if self.arm != "wrong-chunk":
            return super().ship_wire(rows)
        # structurally valid records whose content no longer hashes to
        # the digests they answer
        out = []
        for r in self.replica.records_for_rows(rows):
            v = bytearray(r.value or b"\x00")
            v[0] ^= 0xFF
            out.append(Change(key=r.key, change=r.change, from_=r.from_,
                              to=r.to, value=bytes(v), subset=r.subset))
        return replay.encode_change_log(out)

    def feed_ack_for(self, owner_key: str, offset: int) -> int:
        if self.arm != "ack-regression":
            return offset
        prev = self._ack_memo.get(owner_key)
        self._ack_memo[owner_key] = offset
        if prev is None:
            return offset  # the first ack is honest: a frontier...
        # ...then regress behind it, whatever the real drain did
        return max(0, prev - 1 - self._evil_rng.randrange(4))

    def publish_wire(self, wire: bytes) -> bytes:
        if self.arm != "feed-corrupt" or len(wire) < 2:
            return wire
        b = bytearray(wire)
        b[0] ^= 0x80  # a torn frame header: followers cannot parse
        return bytes(b)


# -- the exchange engine ------------------------------------------------------


def gossip_exchange(initiator: ReplicaNode, responder: ReplicaNode, *,
                    plan_out: Optional[FaultPlan] = None,
                    plan_back: Optional[FaultPlan] = None,
                    batch0: int = DEFAULT_BATCH0,
                    overhead_cap: float = DEFAULT_OVERHEAD_CAP) -> dict:
    """One anti-entropy exchange between two nodes, metered like
    :func:`~..runtime.reconcile_driver.reconcile_local` but with every
    payload streamed through the chaos transport (:class:`_ChaosLink` a
    direction).

    On success both nodes absorbed exactly the symmetric difference and
    the stats dict reports wire, symbol and repair counts.  Failure is
    :func:`classify_error`'s taxonomy: a transport fault left both logs
    untouched; corruption raised ONE structured ProtocolError (a
    :class:`ByzantineDivergence` when the content was provably wrong)."""
    responder.refuse_if_quarantined(initiator.key)
    initiator.refuse_if_quarantined(responder.key)
    initiator.state = responder.state = "gossip"
    # the lit/dark fork: the dark twin _exchange names no symbol of the
    # propagation plane, so its disabled cost is this one attribute load
    try:
        if _OBS.on:
            return _exchange_lit(initiator, responder, plan_out,
                                 plan_back, batch0, overhead_cap)
        return _exchange(initiator, responder, plan_out, plan_back,
                         batch0, overhead_cap)
    finally:
        initiator.state = responder.state = "idle"


def _exchange(initiator, responder, plan_out, plan_back, batch0,
              overhead_cap) -> dict:
    rep_a = initiator.replica
    rep_b = responder.replica
    state = ResponderState(rep_b, overhead_cap=overhead_cap)
    out_link = _ChaosLink(plan_out)
    back_link = _ChaosLink(plan_back)
    # per-direction byte meter; the *_framing/*_msgs halves are what the
    # lit twin turns into the wire cost ledger's payload/framing split
    wire = {"a2b": 0, "b2a": 0, "a2b_framing": 0, "b2a_framing": 0,
            "a2b_msgs": 0, "b2a_msgs": 0}
    msg_i = {"n": 0}

    def corrupt(side: str, e: Exception) -> ProtocolError:
        return ProtocolError(
            f"corrupt gossip payload ({side}): {e}",
            frame=msg_i["n"], offset=wire["a2b"] + wire["b2a"], cause=e)

    def a2b(payload: bytes) -> list:
        """One initiator->responder message; the decoded replies that
        survived the back link."""
        msg_i["n"] += 1
        wire["a2b"] += frame_wire_len(len(payload))
        wire["a2b_framing"] += _header_len(len(payload))
        wire["a2b_msgs"] += 1
        got = out_link.send(payload)
        try:
            msg = rc.decode_reconcile(got)
        except ValueError as e:
            raise corrupt("initiator->responder", e) from e
        replies = state.handle(msg)
        out = []
        for r in replies:
            wire["b2a"] += frame_wire_len(len(r))
            wire["b2a_framing"] += _header_len(len(r))
            wire["b2a_msgs"] += 1
            got_r = back_link.send(r)
            try:
                out.append(rc.decode_reconcile(got_r))
            except ValueError as e:
                raise corrupt("responder->initiator", e) from e
        return out

    syms = initiator.coded_symbols_out()
    replies = a2b(rc.encode_begin(rep_a.n))
    sent = 0
    rounds = 0
    final = None
    while final is None:
        if replies and replies[-1].kind in (rc.RC_DONE, rc.RC_FAIL):
            final = replies[-1]
            break
        m = batch0 if sent == 0 else sent * 2
        cells = syms.extend(m)[sent:]
        payload = rc.encode_symbols(sent, cells)
        sent = m
        rounds += 1
        replies = a2b(payload)
    if final.kind == rc.RC_FAIL:
        state.result()  # raises the responder's structured error
    # record exchange: both directions cross the chaos links and are
    # verified, and NOTHING is absorbed until every crossing succeeded
    wants = final.digests
    rows = rep_a.rows_for_digests(wants)
    if (rows < 0).any():
        raise ProtocolError(
            "peer requested records this replica does not hold",
            frame=msg_i["n"], offset=wire["a2b"] + wire["b2a"])
    for_responder = for_initiator = None
    n_for_b = n_for_a = 0
    if len(rows):
        batch = initiator.ship_wire(rows)
        wire["a2b"] += len(batch)
        got = out_link.send(batch)
        n_for_b = _verify_repairs(got, wants, corrupt,
                                  "initiator->responder",
                                  initiator.key, msg_i["n"],
                                  wire["a2b"] + wire["b2a"],
                                  responder.device)
        for_responder = got
    b_rows = state.local_only_rows()
    if len(b_rows):
        batch = responder.ship_wire(b_rows)
        wire["b2a"] += len(batch)
        got = back_link.send(batch)
        # structure only in this direction: the initiator has no digest
        # expectation for the responder's local-only set (the protocol's
        # asymmetry); identity is derived from the bytes themselves
        n_for_a = _decoded_rows(got, corrupt, "responder->initiator")
        for_initiator = got
    # -- commit point ---------------------------------------------------------
    applied_b = applied_a = 0
    if for_responder:
        applied_b = responder.absorb(for_responder, count=n_for_b,
                                     peer=initiator.key)
        initiator.stats["repairs_sent"] += len(rows)
        if _OBS.on:
            _M_REPAIRS_OUT.inc(len(rows))
    if for_initiator:
        applied_a = initiator.absorb(for_initiator, count=n_for_a,
                                     peer=responder.key)
        responder.stats["repairs_sent"] += len(b_rows)
        if _OBS.on:
            _M_REPAIRS_OUT.inc(len(b_rows))
    total = wire["a2b"] + wire["b2a"]
    initiator.stats["wire_bytes"] += total
    responder.stats["wire_bytes"] += total
    return {
        "ok": True,
        "wire_bytes": total,
        "wire_a2b": wire["a2b"],
        "wire_b2a": wire["b2a"],
        "framing_a2b": wire["a2b_framing"],
        "framing_b2a": wire["b2a_framing"],
        "msgs_a2b": wire["a2b_msgs"],
        "msgs_b2a": wire["b2a_msgs"],
        "symbols": sent,
        "rounds": rounds,
        "diff": int(len(wants) + len(b_rows)),
        "applied_initiator": applied_a,
        "applied_responder": applied_b,
        "wire_initiator": for_initiator or b"",
        "wire_responder": for_responder or b"",
        "want_digests": wants,
    }


def _exchange_lit(initiator, responder, plan_out, plan_back, batch0,
                  overhead_cap) -> dict:
    """The lit twin of :func:`_exchange`: the same engine, plus one
    ``gossip.exchange`` record a direction, the divergence and frontier
    watermarks, and the wire cost ledger.  Reached only through the
    ``_OBS.on`` fork in :func:`gossip_exchange`."""
    rnd = max(initiator.round, responder.round)
    t0 = time.monotonic()
    try:
        res = _exchange(initiator, responder, plan_out, plan_back,
                        batch0, overhead_cap)
    except Exception as e:
        seconds = time.monotonic() - t0
        outcome = classify_error(e)
        err = f"{type(e).__name__}: {e}"
        for a, b, role in ((initiator, responder, "initiator"),
                           (responder, initiator, "responder")):
            _propagation.record_exchange(
                a.key, b.key, role=role, rnd=rnd, outcome=outcome,
                seconds=seconds, t0=t0, error=err)
            # a faulted exchange leaves every cost watermark where it
            # was: only the failure counter moves
            _wirecost.note_failure(f"{a.key}->{b.key}", "tx", err)
        raise
    seconds = time.monotonic() - t0
    outcome = "converged" if res["diff"] == 0 else "progress"
    deliv_i = deliv_r = ()
    if res["wire_responder"]:
        deliv_r = _propagation.digest_prefixes(res["want_digests"])
    if res["wire_initiator"]:
        deliv_i = _propagation.digest_prefixes(RatelessReplica(
            np.frombuffer(res["wire_initiator"], np.uint8),
            device=initiator.device).digests)
    repair = len(res["wire_initiator"]) + len(res["wire_responder"])
    _propagation.record_exchange(
        initiator.key, responder.key, role="initiator", rnd=rnd,
        outcome=outcome, seconds=seconds, diff=res["diff"],
        wire_bytes=res["wire_bytes"], repair_bytes=repair,
        delivered=deliv_i, delivered_peer=deliv_r, t0=t0)
    _propagation.record_exchange(
        responder.key, initiator.key, role="responder", rnd=rnd,
        outcome=outcome, seconds=seconds, diff=res["diff"],
        wire_bytes=res["wire_bytes"], repair_bytes=repair,
        delivered=deliv_r, delivered_peer=deliv_i, t0=t0)
    for node in (initiator, responder):
        _propagation.note_frontier(node.key, node.content_digest().hex(),
                                   node.record_count, rnd)
    # the wire cost ledger: symbol and control traffic is class
    # `reconcile` (payload vs framing from the dark twin's arithmetic),
    # shipped repair batches are class `change_batch`, and the direction
    # total is the transport ground truth.  Link names are the
    # propagation board's (`replica->peer`).
    rep_r = len(res["wire_responder"])  # repair bytes a->b
    rep_i = len(res["wire_initiator"])  # repair bytes b->a
    for link, wire_total, framing, msgs, rep in (
            (f"{initiator.key}->{responder.key}", res["wire_a2b"],
             res["framing_a2b"], res["msgs_a2b"], rep_r),
            (f"{responder.key}->{initiator.key}", res["wire_b2a"],
             res["framing_b2a"], res["msgs_b2a"], rep_i)):
        _wirecost.account("reconcile", link, "tx",
                          wire_total - framing - rep, framing, msgs)
        if rep:
            _wirecost.account("change_batch", link, "tx", rep, 0)
            _wirecost.note_diff(link, "tx", rep)
        _wirecost.note_transport(link, "tx", wire_total)
    return res


def _decoded_rows(data: bytes, corrupt, side: str) -> int:
    """Structural validation of a repair batch: its row count, or the
    exchange's ONE structured error."""
    try:
        cols, _ = replay.replay_log(np.frombuffer(data, np.uint8))
        return len(cols)
    except (ValueError, ProtocolError) as e:
        raise corrupt(side, e) from e


def _verify_repairs(data: bytes, wants: np.ndarray, corrupt, side: str,
                    peer: str, frame: int, offset: int, device) -> int:
    """The check at apply time: the records shipped to answer a want list
    must hash (B1 on ``device``) EXACTLY to the wanted digest set; wrong
    content, extra or missing records refuse the whole apply with a
    structured divergence.  Returns the row count."""
    try:
        got_rep = RatelessReplica(np.frombuffer(data, np.uint8),
                                  device=device)
    except (ValueError, ProtocolError) as e:
        raise corrupt(side, e) from e
    got = got_rep.digests
    want = np.ascontiguousarray(wants)
    if len(got) == len(want):
        if {bytes(d) for d in got} == {bytes(d) for d in want}:
            return len(got_rep.cols)
    raise ByzantineDivergence(
        f"repair records from {peer!r} do not hash to the requested "
        f"digest set ({len(got)} distinct received, {len(want)} "
        f"requested)", peer=peer, arm="wrong-chunk-digest", frame=frame,
        offset=offset)
