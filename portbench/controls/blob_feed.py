"""The ``blob-feed`` control: a digest decoder made of the reference,
which runs the finalize hook before it delivers its last batches.

It stands where ``decode(backend="cuda")`` stands.  It reads the writes'
byte count against the wire's own item table, hashes each item with
``hashlib`` once its last byte has arrived, and delivers digests in
batches of ``BATCH`` items with two batches in flight, as the port's
pipeline does.  At ``end()`` it runs the finalize hook first and
delivers what it still holds after: the configuration's guarantee that
every digest arrives before the finalize hook is what it breaks, the
shortcut that a change buying latency with a lazier flush would take.
"""

from __future__ import annotations

import hashlib
import types

BATCH = 1024
INFLIGHT = 2


class LateFinalizeDecoder:
    def __init__(self, state):
        w = state.wire
        self._buf = w.buf
        self._items = list(zip(w.kinds.tolist(), w.seqs.tolist(),
                               w.starts.tolist(), w.ends.tolist()))
        self._next = 0
        self._bytes = 0
        self._queued: list = []
        self._inflight: list = []
        self._digest_cbs = []
        self._finalize = None
        self.finished = False
        self.destroyed = False
        self.digest_pipeline = types.SimpleNamespace(dispatches=0)

    def on_digest(self, cb):
        self._digest_cbs.append(cb)
        return self

    def change(self, cb):
        return self

    def finalize(self, cb):
        self._finalize = cb
        return self

    def write(self, data) -> bool:
        self._bytes += len(data)
        items = self._items
        while self._next < len(items) and items[self._next][3] <= self._bytes:
            self._queued.append(items[self._next])
            self._next += 1
            if len(self._queued) >= BATCH:
                self._dispatch()
        return True

    def _dispatch(self) -> None:
        if not self._queued:
            return
        batch, self._queued = self._queued, []
        self.digest_pipeline.dispatches += 1
        mv = memoryview(self._buf)
        self._inflight.append([
            ("blob" if kind else "change", seq,
             hashlib.blake2b(mv[s:e], digest_size=32).digest())
            for kind, seq, s, e in batch])
        while len(self._inflight) > INFLIGHT:
            self._deliver()

    def _deliver(self) -> None:
        for kind, seq, digest in self._inflight.pop(0):
            for cb in self._digest_cbs:
                cb(kind, seq, digest)

    def end(self) -> None:
        self._dispatch()
        done = []
        if self._finalize is not None:
            self._finalize(lambda: done.append(True))
        while self._inflight:  # after the hook: the broken guarantee
            self._deliver()
        self.finished = bool(done) or self._finalize is None


SYSTEMS = {"late-finalize": LateFinalizeDecoder}
