"""Session checkpoints and wire journals: resume instead of destroy.

The port's copy of ``dat_replication_protocol_tpu/session/resume.py``.
The decoder exports a :class:`SessionCheckpoint` at any instant, and a
sender that kept its produced wire bytes in a :class:`WireJournal` can
replay exactly the bytes past the checkpoint over a fresh connection.

Why a byte-offset checkpoint works: the decoder object survives a
transport failure untouched (its parser state: mid-header bytes,
mid-frame payload cursor, unparsed overflow), so the only thing a
reconnect needs is *the next wire byte*.  ``wire_offset`` is
``decoder.bytes``, the count of wire bytes the decoder has accepted; the
journal hands back everything from that offset on.  No frame is ever
re-delivered and none is skipped.

The other checkpoint fields (``frame``, ``row``, ``blob_offset`` and the
backend's ``digest`` state) are exported for observability and for the
structured :class:`~..wire.framing.ProtocolError` context when recovery
fails.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..obs.events import emit as _emit
from ..obs.metrics import OBS as _OBS, counter as _counter
from ..obs.watermarks import WATERMARKS as _WATERMARKS
from ..wire.framing import ProtocolError

__all__ = ["SessionCheckpoint", "WireJournal", "ResumeError"]

# Journal telemetry: replayed bytes are the resume
# cost a reconnect actually pays on the wire; acked bytes are the
# duplicate-suppressed history a resume can never re-deliver (trimmed,
# so a checkpoint below them is a structured ResumeError, not a silent
# replay from the wrong place).
_M_J_APPEND = _counter("journal.append.bytes")
_M_J_REPLAY = _counter("journal.replay.bytes")
_M_J_ACKED = _counter("journal.acked.bytes")


class ResumeError(ProtocolError):
    """A checkpoint that cannot be honored (e.g. the journal already
    trimmed past it).  Carries the standard structured context."""


@dataclasses.dataclass(frozen=True)
class SessionCheckpoint:
    """One instant of session progress, exported by ``Decoder.checkpoint()``.

    * ``wire_offset`` — wire bytes accepted by the decoder; the resume
      point (the sender replays from exactly here).
    * ``frame`` — frames fully delivered (changes + blobs).
    * ``row`` — change-row cursor (changes delivered so far).
    * ``blob_offset`` — payload bytes already delivered of the blob open
      at checkpoint time (0 at a frame boundary).
    * ``digest`` — backend digest-state (the CUDA decoder records its
      emitted change/blob digest sequence counters so a resumed session
      continues numbering without gaps or repeats).
    """

    wire_offset: int
    frame: int = 0
    row: int = 0
    blob_offset: int = 0
    digest: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict[str, Any]:
        """JSON-able form (the out-of-band resume handshake payload)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SessionCheckpoint":
        return cls(
            wire_offset=int(d["wire_offset"]),
            frame=int(d.get("frame", 0)),
            row=int(d.get("row", 0)),
            blob_offset=int(d.get("blob_offset", 0)),
            digest=dict(d.get("digest", {})),
        )


class WireJournal:
    """Sender-side retention of produced wire bytes, replayable by offset.

    Attach to an encoder (``encoder.attach_journal(journal)``) and every
    byte ``read()`` hands to the transport is also recorded here.  On
    reconnect, ``read_from(checkpoint.wire_offset)`` returns the bytes
    the old connection lost.  ``ack(offset)`` trims delivered history
    once the receiver has confirmed it, bounding memory; resuming below
    the trimmed start raises :class:`ResumeError` (the session is then
    unrecoverable and must restart from scratch — the structured error
    says so instead of silently replaying from the wrong place).
    """

    def __init__(self):
        self._buf = bytearray()
        self._start = 0  # wire offset of _buf[0]
        # multi-reader acks: with readers attached, ack() trims only
        # past the MINIMUM acked offset across them, so a second
        # reader's unread window is never dropped
        self._readers: dict[str, int] = {}
        # fleet-plane link name: set by watermark(); while
        # set, appends note a monotonic mark so lag-in-seconds is
        # derivable entirely on this sender's clock
        self._wm_link: str | None = None

    @property
    def start(self) -> int:
        return self._start

    @property
    def end(self) -> int:
        return self._start + len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def append(self, data) -> None:
        self._buf += data
        if _OBS.on:
            _M_J_APPEND.inc(len(data))
            if self._wm_link is not None:
                _WATERMARKS.mark(self._wm_link, self.end)

    def watermark(self, link: str) -> None:
        """Export this journal's cursors on the fleet plane:
        ``append`` (bytes produced) and ``acked`` (trim floor) under
        ``link``, plus an append-time mark per journaled write so the
        aggregator can answer "how old is the oldest unreplicated byte"
        without any clock sync.
        Call :func:`~..obs.watermarks.WATERMARKS.untrack` with the same
        link when the session ends."""
        _WATERMARKS.track("append", link, lambda: self.end)
        _WATERMARKS.track("acked", link, lambda: self.start)
        self._wm_link = link

    def seek(self, offset: int) -> None:
        """Align an EMPTY journal's window to an absolute wire offset —
        used when attaching to an encoder that already emitted bytes
        (those bytes are unrecoverable; the window starts after them)."""
        if self._buf:
            raise ValueError("seek on a non-empty journal")
        self._start = offset

    def attach_reader(self, key: str, offset: int | None = None) -> str:
        """Register a named reader cursor at ``offset`` (default: the
        journal's retained start).  With any readers attached,
        :meth:`ack` becomes min-offset-aware: bytes trim only once
        EVERY reader has acked past them — the multi-reader contract
        the broadcast log builds on.

        Attaching below the retained window raises a structured
        :class:`ResumeError` naming the retained range — never a
        silent short read from the wrong place."""
        off = self._start if offset is None else int(offset)
        if off < self._start:
            if _OBS.on:
                _emit("journal.replay_miss", offset=off,
                      start=self._start)
            raise ResumeError(
                f"reader {key!r} asked for byte {off} below the "
                f"retained range [{self._start}, {self.end})",
                offset=off,
            )
        if off > self.end:
            raise ResumeError(
                f"reader {key!r} asked for byte {off} ahead of "
                f"everything produced (retained range "
                f"[{self._start}, {self.end}))",
                offset=off,
            )
        if key in self._readers:
            raise ValueError(f"reader {key!r} already attached")
        self._readers[key] = off
        return key

    def detach_reader(self, key: str) -> None:
        """Remove a reader cursor; its ack stops constraining the trim
        (re-ack with the remaining floor to release its window)."""
        self._readers.pop(key, None)

    def ack(self, offset: int, reader: str | None = None) -> None:
        """The receiver confirmed bytes below ``offset``: trim them.

        With reader cursors attached (:meth:`attach_reader`) the trim
        is min-offset-aware: a per-reader ack records that reader's
        progress and the journal trims only past the minimum across
        ALL readers; a bare ``ack(offset)`` is likewise floored by the
        slowest reader instead of silently dropping its window."""
        # an ack beyond production is a caller bug on EVERY path — the
        # reader-floor below must not silently mask it
        if offset > self.end:
            raise ValueError(
                f"ack({offset}) beyond journal end {self.end}")
        if reader is not None:
            if reader not in self._readers:
                raise ValueError(f"unknown reader {reader!r}")
            self._readers[reader] = max(self._readers[reader], offset)
            offset = min(self._readers.values())
        elif self._readers:
            offset = min([offset, *self._readers.values()])
        if offset <= self._start:
            return
        if _OBS.on:
            _M_J_ACKED.inc(offset - self._start)
        del self._buf[: offset - self._start]
        self._start = offset

    def read_from(self, offset: int) -> bytes:
        """Every journaled byte at ``offset`` and beyond (a copy: the
        journal may keep growing while the replay is in flight)."""
        if offset < self._start:
            if _OBS.on:
                _emit("journal.replay_miss", offset=offset,
                      start=self._start)
            raise ResumeError(
                "checkpoint predates the journal's retained window "
                f"(asked for byte {offset}, retained range "
                f"[{self._start}, {self.end}))",
                offset=offset,
            )
        if offset > self.end:
            if _OBS.on:
                _emit("journal.replay_miss", offset=offset, end=self.end)
            raise ResumeError(
                f"checkpoint is ahead of everything produced (byte {offset}, "
                f"journal ends at {self.end})",
                offset=offset,
            )
        out = bytes(self._buf[offset - self._start:])
        if _OBS.on:
            _M_J_REPLAY.inc(len(out))
            _emit("journal.replay", offset=offset, bytes=len(out))
        return out
