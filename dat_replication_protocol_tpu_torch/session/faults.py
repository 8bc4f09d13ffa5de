"""Deterministic fault injection for session transports: the chaos harness.

The port's copy of ``dat_replication_protocol_tpu/session/faults.py``,
for the threaded transport contract (``read_bytes(n) -> bytes`` /
``write_bytes(data)``, :mod:`.transport`).  A seed-driven
:class:`FaultPlan` can:

* **re-segment**: deliver reads in arbitrary-size pieces (down to one
  byte), exercising every header/payload straddle the parser has;
* **truncate**: fake a clean EOF mid-stream (the silent-truncation
  fault, indistinguishable in-band from a finished session, which is why
  the resume layer checks the sender's declared length);
* **drop**: raise :class:`TransportFault` once a chosen byte offset has
  been delivered (the mid-session disconnect);
* **flip**: XOR one byte at a chosen offset (wire corruption: a flipped
  header byte surfaces as a structured ProtocolError, a flipped payload
  byte is undetectable at the wire layer by design, and the digest is
  the end-to-end integrity answer);
* **stall / latency**: inject one long pause at a chosen offset and/or
  small per-read delays, exercising every bounded-wait path.

Everything is derived from ``random.Random(seed)``: the same plan over
the same bytes produces the same faults, so a failing seed is a
reproducer, not a flake.  The scenario generators (:meth:`FaultPlan.for_sweep`
and its session, partition and link axes) give field-for-field the JAX
package's plans for the same arguments.  :class:`AsyncFaultyReader` is
:class:`FaultyReader`'s twin for the asyncio transport (:mod:`.aio`).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

from ..obs.events import emit as _emit
from ..obs.flight import FLIGHT as _FLIGHT
from ..obs.metrics import OBS as _OBS, counter as _counter

# Ground-truth telemetry: the injector records every fault it actually
# fires, so a conformance sweep can hold the session layers' own
# metrics and events against what chaos really did.
_M_INJ_DROP = _counter("fault.injected.drop")
_M_INJ_TRUNCATE = _counter("fault.injected.truncate")
_M_INJ_FLIP = _counter("fault.injected.flip")
_M_INJ_STALL = _counter("fault.injected.stall")
_M_INJ_RESEG = _counter("fault.injected.reseg_segments")

__all__ = [
    "TransportFault",
    "FaultPlan",
    "FaultyReader",
    "AsyncFaultyReader",
    "FaultyWriter",
    "bytes_reader",
]


class TransportFault(ConnectionError):
    """An injected (or detected) connection-level failure.

    Distinct from :class:`~..wire.framing.ProtocolError`: a transport
    fault says nothing about the bytes that *did* arrive — the session
    is resumable from the receiver's checkpoint.  ``offset`` is the
    number of bytes this connection delivered before dying.
    """

    def __init__(self, message: str, *, offset: int | None = None):
        super().__init__(message)
        self.offset = offset


@dataclasses.dataclass
class FaultPlan:
    """What one connection will do to the bytes passing through it.

    All offsets are relative to this connection's first delivered byte
    (a resumed connection starts its own plan at 0).  ``None`` disables
    a fault.  The plan is pure data — the wrapper classes below own the
    clock and the randomness (seeded from ``seed``).
    """

    seed: int = 0
    max_segment: Optional[int] = None    # re-segment reads into [1, max_segment]
    drop_at: Optional[int] = None        # raise TransportFault at this offset
    truncate_at: Optional[int] = None    # fake clean EOF at this offset
    flip_at: Optional[int] = None        # XOR one byte at this offset
    flip_mask: int = 0xFF                # never 0 (a 0-mask flips nothing)
    stall_at: Optional[int] = None       # one long pause before this offset
    stall_s: float = 0.0
    latency_prob: float = 0.0            # per-read chance of a small sleep
    latency_s: float = 0.0

    # the disconnect-class scenarios: faults a correct resume layer must
    # absorb without changing the decoded session (corruption is a
    # different class — it must ERROR, and gets targeted tests)
    SWEEP_SCENARIOS = ("drop", "truncate", "stall", "reseg")
    # the multi-session (hub) scenario axis: what the ONE faulty
    # co-resident session does while its neighbors stay healthy.  Flip
    # joins here — isolation must hold even when the faulty session's
    # wire is corrupt (it errors or delivers corrupt content; the
    # neighbors must not care either way), which the 1:1 resume sweep
    # deliberately excludes (flip is not resumable by design).
    SESSION_SCENARIOS = ("stall", "truncate", "flip")
    # the cluster (gossip-mesh) link axis: what one sampled
    # gossip link does to ONE exchange, on top of the scheduled
    # partition.  "clean" is deliberately over-weighted — most links in
    # a round behave — and every fault class the 1:1 and per-session
    # axes know reappears here so the convergence contract is proven
    # against the same chaos vocabulary.
    LINK_SCENARIOS = ("clean", "clean", "clean", "reseg", "drop",
                      "stall", "flip")

    @classmethod
    def partition_scenario(cls, seed: int, n_replicas: int) -> dict:
        """Deterministic cluster-partition ground truth for
        ``(seed, n_replicas)`` — the link-set cut the gossip sweep and
        its oracle both key off (mirrors the per-session axis:
        the generator IS the ground truth, so tests never guess).

        Returns ``{"groups": (frozenset, frozenset), "cut_round": c,
        "heal_round": h}``: from gossip round ``c`` (inclusive) to
        ``h`` (exclusive) every link crossing the two groups is dead
        (an immediate drop); at ``h`` the cut heals and convergence
        must complete within the sweep's bounded rounds.  The two
        groups partition ``range(n_replicas)``; with fewer than two
        replicas there is nothing to cut and the minority group is
        empty.
        """
        rng = random.Random(seed * 2_654_435_761 + n_replicas)
        cut = rng.randrange(1, 4)
        heal = cut + rng.randrange(2, 6)
        idx = list(range(n_replicas))
        rng.shuffle(idx)
        k = rng.randrange(1, n_replicas) if n_replicas > 1 else 0
        return {
            "groups": (frozenset(idx[:k]), frozenset(idx[k:])),
            "cut_round": cut,
            "heal_round": heal,
        }

    @classmethod
    def partitioned(cls, seed: int, n_replicas: int,
                    link: tuple[int, int], gossip_round: int) -> bool:
        """Whether ``link`` (a replica-index pair) crosses the seeded
        cut during ``gossip_round`` — the oracle-side view of the
        partition axis."""
        sc = cls.partition_scenario(seed, n_replicas)
        if not sc["cut_round"] <= gossip_round < sc["heal_round"]:
            return False
        a, b = link
        minority = sc["groups"][0]
        return (a in minority) != (b in minority)

    @classmethod
    def link_scenario(cls, seed: int, n_replicas: int,
                      link: tuple[int, int]) -> tuple[str, int]:
        """The (scenario, fire_round) ground truth for one undirected
        gossip link: which :data:`LINK_SCENARIOS` arm the link draws
        and the single gossip round it fires in.  Deterministic, so
        the chaos oracle can predict exactly which exchanges were
        corrupted vs merely dropped."""
        a, b = sorted(link)
        rng = random.Random(
            (seed * 5_851 + n_replicas) * 1_000_003 + a * 8_191 + b)
        return rng.choice(cls.LINK_SCENARIOS), rng.randrange(1, 8)

    @classmethod
    def faulty_session(cls, seed: int, n_sessions: int) -> int:
        """Which session index carries the fault for this seed —
        deterministic, so the chaos oracle can predict ground truth."""
        return random.Random(seed * 7_368_787 + n_sessions).randrange(
            max(1, n_sessions))

    @classmethod
    def for_sweep(cls, seed: int, wire_len: int, attempt: int = 0,
                  session: int = 0, n_sessions: int = 1,
                  link: Optional[tuple] = None, n_replicas: int = 1,
                  gossip_round: int = 0) -> "FaultPlan":
        """The conformance-sweep scenario for ``(seed, attempt)``.

        Attempt 0 carries the seed's primary fault, attempt 1 has a 50%
        chance of a second fault (a reconnect that dies too), attempts
        >= 2 are clean apart from aggressive re-segmentation — so every
        seed converges within a bounded number of reconnects while still
        exercising double faults.  Deterministic: same (seed, attempt,
        wire_len) -> same plan.

        **Per-session axis**: with ``n_sessions > 1`` this is
        the shared generator for N concurrent plans, one keyed per
        ``session`` index.  Exactly one session — :meth:`faulty_session`
        — draws its primary fault from :data:`SESSION_SCENARIOS`
        (stall / truncate / flip); every other session gets a benign
        plan (re-segmentation and small latency only), so hub chaos
        tests and future fan-out tests can assert the isolation
        contract against known ground truth.  The default
        ``(session=0, n_sessions=1)`` path is byte-identical to the
        pre-axis generator — existing sweeps reproduce unchanged.

        **Partition/link axis**: with ``link=(a, b)`` and
        ``n_replicas > 1`` this is the shared generator for a gossip
        mesh's per-exchange plans.  A link crossing the seeded
        partition cut (:meth:`partition_scenario`) during
        ``gossip_round`` is dead — an immediate drop, healing at the
        scenario's ``heal_round``; every other link draws its one
        scenario from :data:`LINK_SCENARIOS` at a seeded round
        (:meth:`link_scenario`) and is otherwise benign delivery
        jitter.  The default ``(link=None, n_replicas=1)`` path is
        byte-identical to the pre-axis generator (golden test).
        """
        if link is not None and n_replicas > 1:
            return cls._for_cluster_sweep(seed, wire_len, link,
                                          n_replicas, gossip_round)
        if n_sessions > 1:
            return cls._for_session_sweep(seed, wire_len, attempt,
                                          session, n_sessions)
        rng = random.Random(seed * 1_000_003 + attempt)
        span = max(1, wire_len)
        plan = cls(
            seed=rng.randrange(1 << 30),
            max_segment=rng.choice([1, 3, 7, 64, 1024, None]),
            latency_prob=rng.choice([0.0, 0.0, 0.05]),
            latency_s=0.001,
        )
        if attempt >= 2 or (attempt == 1 and rng.random() < 0.5):
            return plan
        scenario = rng.choice(cls.SWEEP_SCENARIOS)
        at = rng.randrange(span)
        if scenario == "drop":
            plan.drop_at = at
        elif scenario == "truncate":
            plan.truncate_at = at
        elif scenario == "stall":
            plan.stall_at = at
            plan.stall_s = 0.02
        # "reseg": byte-at-a-time delivery IS the fault
        if scenario == "reseg":
            plan.max_segment = 1
        return plan

    @classmethod
    def session_scenario(cls, seed: int, n_sessions: int) -> str:
        """The faulty session's scenario for this (seed, n_sessions) —
        exposed so the oracle can check telemetry against ground truth."""
        rng = random.Random(seed * 2_246_822_519 + n_sessions)
        return rng.choice(cls.SESSION_SCENARIOS)

    @classmethod
    def _for_session_sweep(cls, seed: int, wire_len: int, attempt: int,
                           session: int, n_sessions: int) -> "FaultPlan":
        rng = random.Random((seed * 1_000_003 + attempt) * 1_789 + session)
        span = max(1, wire_len)
        plan = cls(
            seed=rng.randrange(1 << 30),
            max_segment=rng.choice([3, 7, 64, 1024, None]),
            latency_prob=rng.choice([0.0, 0.0, 0.05]),
            latency_s=0.0005,
        )
        if session != cls.faulty_session(seed, n_sessions):
            return plan  # healthy co-resident: benign delivery jitter only
        if attempt >= 1:
            return plan  # the faulty session's reconnect runs clean
        scenario = cls.session_scenario(seed, n_sessions)
        at = rng.randrange(span)
        if scenario == "truncate":
            plan.truncate_at = at
        elif scenario == "stall":
            plan.stall_at = at
            plan.stall_s = 0.05
        elif scenario == "flip":
            plan.flip_at = at
            plan.flip_mask = rng.choice([0x01, 0x40, 0x80])
        return plan

    @classmethod
    def _for_cluster_sweep(cls, seed: int, wire_len: int,
                           link: tuple, n_replicas: int,
                           gossip_round: int) -> "FaultPlan":
        # the link is ORDERED (sender -> receiver): the two directions
        # of one exchange draw distinct jitter and fault coordinates,
        # while the scheduled scenario and the partition cut are
        # properties of the UNDIRECTED pair (sorted inside the
        # scenario lookups) — one link, one story, two wires
        a, b = link
        rng = random.Random(
            ((seed * 5_851 + n_replicas) * 1_000_003 + a * 8_191 + b)
            * 131 + gossip_round)
        span = max(1, wire_len)
        # gossip exchanges are many and small: segments never drop to
        # byte-at-a-time (that is the 1:1 sweep's job) and latency is
        # token, so a 64-replica sweep stays inside the tier-1 budget
        plan = cls(
            seed=rng.randrange(1 << 30),
            max_segment=rng.choice([64, 256, 1024, None]),
            latency_prob=rng.choice([0.0, 0.0, 0.02]),
            latency_s=0.0002,
        )
        if cls.partitioned(seed, n_replicas, (a, b), gossip_round):
            plan.drop_at = 0  # the cut: the dial itself fails
            return plan
        scenario, fire_round = cls.link_scenario(seed, n_replicas, (a, b))
        if gossip_round != fire_round or scenario == "clean":
            return plan
        at = rng.randrange(span)
        if scenario == "drop":
            plan.drop_at = at
        elif scenario == "stall":
            plan.stall_at = at
            plan.stall_s = 0.01
        elif scenario == "flip":
            plan.flip_at = at
            plan.flip_mask = rng.choice([0x01, 0x40, 0x80])
        elif scenario == "reseg":
            plan.max_segment = 64
        return plan


class _FaultState:
    """Plan execution shared by the sync and async wrappers: decides the
    next segment size (or EOF / fault), applies the byte flip, and keeps
    the delivered-byte offset — everything except the actual pull and
    the actual sleep, which differ between the thread and event-loop
    worlds."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.offset = 0  # bytes delivered downstream on THIS connection
        self._rng = random.Random(plan.seed)
        self._stalled = False
        self._dead = False
        self._truncated = False
        # chaos ground truth rides in every post-mortem bundle: an armed
        # flight recorder notes the plan (seed + fault coordinates) the
        # moment a faulty connection comes up (no-op while disarmed)
        _FLIGHT.note_plan(plan)

    def pre_read(self, n: int) -> tuple[Optional[int], float]:
        """(segment limit, sleep seconds) for the next read; limit None
        means injected clean EOF.  Raises on an injected drop."""
        p = self.plan
        if self._dead:
            raise TransportFault(
                f"connection already dropped at byte {self.offset}",
                offset=self.offset)
        if p.drop_at is not None and self.offset >= p.drop_at:
            self._dead = True
            if _OBS.on:
                _M_INJ_DROP.inc()
                _emit("fault.drop", offset=self.offset)
            raise TransportFault(
                f"injected disconnect at byte {self.offset}",
                offset=self.offset)
        if p.truncate_at is not None and self.offset >= p.truncate_at:
            if not self._truncated:
                self._truncated = True
                if _OBS.on:
                    _M_INJ_TRUNCATE.inc()
                    _emit("fault.truncate", offset=self.offset)
            return None, 0.0
        limit = max(1, n)
        if p.max_segment:
            limit = self._rng.randint(1, max(1, min(limit, p.max_segment)))
            if _OBS.on:
                _M_INJ_RESEG.inc()
        if p.drop_at is not None:
            limit = min(limit, p.drop_at - self.offset)
        if p.truncate_at is not None:
            limit = min(limit, p.truncate_at - self.offset)
        sleep_s = 0.0
        if (p.stall_at is not None and not self._stalled
                and self.offset >= p.stall_at):
            self._stalled = True
            if _OBS.on:
                _M_INJ_STALL.inc()
                _emit("fault.stall", offset=self.offset, seconds=p.stall_s)
            sleep_s += p.stall_s
        if p.latency_prob and self._rng.random() < p.latency_prob:
            sleep_s += p.latency_s
        return limit, sleep_s

    def deliver(self, chunk: bytes) -> bytes:
        """Apply the byte flip (if it lands in this chunk) and advance."""
        p = self.plan
        if (p.flip_at is not None
                and self.offset <= p.flip_at < self.offset + len(chunk)):
            i = p.flip_at - self.offset
            mask = p.flip_mask or 0xFF
            chunk = chunk[:i] + bytes((chunk[i] ^ mask,)) + chunk[i + 1:]
            if _OBS.on:
                _M_INJ_FLIP.inc()
                _emit("fault.flip", offset=p.flip_at, mask=mask)
        self.offset += len(chunk)
        return chunk


class FaultyReader:
    """Pull-side wrapper for the threaded transport contract.

    ``read(n)`` returns up to ``n`` bytes, ``b''`` at (real or injected)
    EOF, and raises :class:`TransportFault` on an injected drop —
    exactly the ``read_bytes`` shape :func:`.transport.recv_over` and
    the reconnect driver consume.
    """

    def __init__(self, read_bytes: Callable[[int], bytes], plan: FaultPlan,
                 sleep: Callable[[float], None] = time.sleep):
        self._read = read_bytes
        self._state = _FaultState(plan)
        self._sleep = sleep
        self._pending = bytearray()  # pulled upstream, not yet delivered

    @property
    def offset(self) -> int:
        return self._state.offset

    def read(self, n: int) -> bytes:
        limit, sleep_s = self._state.pre_read(n)
        if sleep_s:
            self._sleep(sleep_s)
        if limit is None:
            return b""  # injected truncation: a clean-looking EOF
        while not self._pending:
            data = self._read(n)
            if not data:
                return b""  # upstream EOF
            self._pending += data
        take = min(limit, len(self._pending))
        out = bytes(self._pending[:take])
        del self._pending[:take]
        return self._state.deliver(out)


class AsyncFaultyReader:
    """The asyncio twin of :class:`FaultyReader`: wraps any object with
    ``async read(n)`` (an ``asyncio.StreamReader``, say) and delivers,
    byte for byte, what :class:`FaultyReader` delivers for the same
    plan."""

    def __init__(self, reader, plan: FaultPlan):
        self._reader = reader
        self._state = _FaultState(plan)
        self._pending = bytearray()

    @property
    def offset(self) -> int:
        return self._state.offset

    async def read(self, n: int) -> bytes:
        import asyncio

        limit, sleep_s = self._state.pre_read(n)
        if sleep_s:
            await asyncio.sleep(sleep_s)
        if limit is None:
            return b""  # injected truncation: a clean-looking EOF
        while not self._pending:
            data = await self._reader.read(n)
            if not data:
                return b""  # upstream EOF
            self._pending += data
        take = min(limit, len(self._pending))
        out = bytes(self._pending[:take])
        del self._pending[:take]
        return self._state.deliver(out)


class FaultyWriter:
    """Push-side wrapper: re-segments, delays, flips, and drops writes.

    Wraps a ``write_bytes(data)`` callable (the :func:`.transport.send_over`
    sink).  A drop surfaces as :class:`TransportFault` from ``write``,
    which the sending pump treats like any transport error.
    """

    def __init__(self, write_bytes: Callable[[bytes], None], plan: FaultPlan,
                 sleep: Callable[[float], None] = time.sleep):
        self._write = write_bytes
        self._state = _FaultState(plan)
        self._sleep = sleep

    @property
    def offset(self) -> int:
        return self._state.offset

    def write(self, data) -> None:
        view = memoryview(data)
        while len(view):
            limit, sleep_s = self._state.pre_read(len(view))
            if sleep_s:
                self._sleep(sleep_s)
            if limit is None:
                return  # truncated: silently swallow the tail
            chunk = self._state.deliver(bytes(view[:limit]))
            self._write(chunk)
            view = view[limit:]


def bytes_reader(data: bytes) -> Callable[[int], bytes]:
    """A ``read_bytes``-shaped source over an in-memory byte string —
    the journal-replay / test-harness building block."""
    view = memoryview(data)
    pos = [0]

    def read(n: int) -> bytes:
        i = pos[0]
        j = min(len(view), i + max(1, n))
        pos[0] = j
        return bytes(view[i:j])

    return read
