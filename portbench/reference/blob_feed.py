"""The digests a receiving peer owes for one session's wire: the
BLAKE2b-256 of every change payload and every blob, per kind in seq
order."""

from __future__ import annotations

from ..gen.wire import KIND_BLOB, KIND_CHANGE, Wire
from .digests import blake2b_extents


def expected_digests(wire: Wire) -> dict[str, list[bytes]]:
    out = {}
    for name, kind in (("change", KIND_CHANGE), ("blob", KIND_BLOB)):
        starts, ends = wire.of_kind(kind)
        out[name] = blake2b_extents(wire.buf, starts, ends)
    return out
