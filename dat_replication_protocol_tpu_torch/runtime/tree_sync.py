"""Interactive Merkle descent: find differing leaves across a network.

The counterpart of ``dat_replication_protocol_tpu/runtime/tree_sync.py``.
Two replicas that each hold a built tree (``ops.merkle.build_tree``,
every level on kernel B2) walk it top-down in rounds, descending only
into subtrees whose digests differ: O(diff * log n) bytes in log n round
trips.  Messages are opaque byte strings, byte for byte the reference's:

* round request (initiator -> responder): the initiator's digests of the
  frontier's children, 64 bytes per frontier node;
* round response: one bit per child, set where the digests differ,
  packed LSB first; the set bits are the next frontier.

Both trees must have equal power-of-two width (``ops.merkle.pad_leaves``
on both sides).  A round's frontier digests are gathered on the device
and cross to the host in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..ops import merkle

# frontier digests read back to go on the wire
_M_D2H = _counter("device.d2h.bytes")

_DIGEST = 32


class TreeSyncSession:
    """One replica's side of the descent over its built tree levels."""

    def __init__(self, levels_hh, levels_hl):
        self._hh = levels_hh
        self._hl = levels_hl
        self.nlevels = len(levels_hh)
        self.width = levels_hh[0].shape[0]

    def root(self) -> bytes:
        (d,) = merkle.digests_from_device(self._hh[-1], self._hl[-1])
        return d

    def _digests(self, level: int, idxs: list[int]) -> list[bytes]:
        if not idxs:
            return []
        if _OBS.on:
            _M_D2H.inc(32 * len(idxs))
        hh, hl = self._hh[level], self._hl[level]
        at = torch.as_tensor(idxs, dtype=torch.int64).to(hh.device)
        return merkle.digests_from_device(hh[at], hl[at])

    # -- initiator side ------------------------------------------------------

    def request(self, level: int, frontier: list[int]) -> bytes:
        """Round message: our digests of the frontier nodes' children."""
        kids = [c for i in frontier for c in (2 * i, 2 * i + 1)]
        return b"".join(self._digests(level, kids))

    def next_frontier(self, frontier: list[int], reply: bytes) -> list[int]:
        """Decode the responder's differ-bitmap into child indices."""
        kids = [c for i in frontier for c in (2 * i, 2 * i + 1)]
        # a truncated bitmap would otherwise report its dropped tail as
        # in sync
        if len(reply) != (len(kids) + 7) // 8:
            raise ValueError(
                f"differ-bitmap holds {len(reply)} bytes; frontier of "
                f"{len(frontier)} nodes needs {(len(kids) + 7) // 8}")
        bits = np.unpackbits(np.frombuffer(reply, np.uint8),
                             bitorder="little")[:len(kids)]
        return [k for k, b in zip(kids, bits) if b]

    # -- responder side ------------------------------------------------------

    def respond(self, level: int, frontier: list[int],
                request: bytes) -> bytes:
        """Compare the initiator's child digests with ours; packed bits."""
        kids = [c for i in frontier for c in (2 * i, 2 * i + 1)]
        if len(request) != _DIGEST * len(kids):
            raise ValueError(
                f"round message holds {len(request)} bytes; frontier of "
                f"{len(frontier)} nodes needs {_DIGEST * len(kids)}")
        mine = self._digests(level, kids)
        theirs = [request[k * _DIGEST:(k + 1) * _DIGEST]
                  for k in range(len(kids))]
        bits = np.array([a != b for a, b in zip(theirs, mine)],
                        dtype=np.uint8)
        return np.packbits(bits, bitorder="little").tobytes()


def sync(a: TreeSyncSession, b: TreeSyncSession,
         transcript: list | None = None) -> list[int]:
    """Run the full descent between two in-memory parties; the differing
    leaf indices, ascending.  ``transcript``, if given, receives
    ``(direction, nbytes)`` for every message."""
    if a.width != b.width or a.nlevels != b.nlevels:
        raise ValueError("trees must have equal (padded) width")

    def note(direction: str, payload: bytes) -> bytes:
        if transcript is not None:
            transcript.append((direction, len(payload)))
        return payload

    # root handshake: a ships its root, b replies one differ byte
    ra = note("a->b", a.root())
    differs = note("b->a", b"\x01" if b.root() != ra else b"\x00")
    if differs == b"\x00":
        return []
    frontier = [0]
    for level in range(a.nlevels - 2, -1, -1):
        req = note("a->b", a.request(level, frontier))
        reply = note("b->a", b.respond(level, frontier, req))
        frontier = a.next_frontier(frontier, reply)
        if not frontier:
            return []
    return frontier
