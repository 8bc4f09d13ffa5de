"""The work of the gear scan over a stream (the ``content-import``
chunking's candidate test).

Each byte is read once.  Per byte the rule ``h = (h << 1) + g(b)`` and
the test ``(h >> 32) & mask == 0`` take, in the fewest 32-bit integer
operations: ``h + h + g`` as two three-input adds (low half, high half
with the carry) and the masked test as one logic operation that sets a
predicate; ``g(b)`` is a table read, not counted.  The bytes bound the
scan on an H100: 3 operations a byte at the INT32 rate take 58% of the
time the byte takes at the HBM rate.
"""

from __future__ import annotations

OPS_PER_BYTE = 3


def work(nbytes: int) -> dict:
    return {"bytes": int(nbytes), "ops": OPS_PER_BYTE * int(nbytes)}
