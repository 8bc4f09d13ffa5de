"""Key-addressed set reconciliation of divergent change logs.

The counterpart of ``dat_replication_protocol_tpu/ops/reconcile.py``.
A replica's sketch is a table of ``2**log2_slots`` cells; record r lands
in cell ``key_digest(r)``'s first u32 word masked to the table, so the
cell is stable under insertion, deletion and reordering of other
records.  A cell holds the word-wise wrapping-u32 sum of its records'
BLAKE2b-256 digests.  Two replicas' sketches differ in exactly the cells
that own a differing, inserted or deleted record.

:class:`LogSummary` hashes records and keys with kernel B1
(``batch/feed.hash_extents_device``) and scatter-adds the record digests
into the table on the same device.  The scatter-add is a torch op, as
the reference leaves it to XLA.  Tables are (nslots, 8) int32 tensors
holding the u32 words, in the host digest byte order ([lo k, hi k]).
:func:`table_leaves` turns a table into Merkle leaves, so two replicas
can find their differing cells remotely (``runtime/tree_sync``).

Telemetry: the reference's ``reconcile.hash`` (B1 over records and
keys), ``reconcile.sketch`` (the scatter-add) and ``reconcile.diff``
spans.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.trace import span

DIGEST_WORDS = 8  # 32-byte digests as 8 uint32 words
_MASK32 = 0xFFFFFFFF


def scatter_add_sums(nrows: int, index, words):
    """(nrows, W) int64 table of word-wise sums of the words' unsigned
    values: row ``index[j]`` gets ``words[j]`` added, repeated indices
    accumulating (``index_add_`` does; ``t[idx] += v`` would not)."""
    acc = torch.zeros((nrows, words.shape[1]), dtype=torch.int64,
                      device=words.device)
    acc.index_add_(0, index, words.to(torch.int64) & _MASK32)
    return acc


def scatter_add_words(nrows: int, index, words):
    """(nrows, W) int32 table of word-wise wrapping-u32 sums: the low 32
    bits of :func:`scatter_add_sums`, so the table equals ``np.add.at`` on
    ``uint32``."""
    return scatter_add_sums(nrows, index, words).to(torch.int32)


def table_leaves(table):
    """Sketch-table cells as Merkle leaf digest halves ``(hh, hl)``, each
    (nslots, 4) contiguous: a cell is digest-shaped, so a table is a leaf
    level (word 2k is word k's low half)."""
    return table[:, 1::2].contiguous(), table[:, 0::2].contiguous()


def diff_sketches(table_a, table_b) -> np.ndarray:
    """Differing slot indices between two local sketches (ascending
    int64): one elementwise compare on the tables' device."""
    n = table_a.shape[0]
    if table_b.shape[0] != n:
        raise ValueError("sketches must have equal slot counts")
    with span("reconcile.diff"):
        dense = (table_a != table_b).any(dim=1)
        return torch.nonzero(dense).flatten().cpu().numpy()


def key_slots(key_hl, log2_slots: int):
    """Slot per key: the key digest's first low word masked to the table,
    taken on the int32 bits before any widening, so a word with its top
    bit set stays a non-negative index (``log2_slots`` <= 31)."""
    return key_hl[:, 0] & ((1 << log2_slots) - 1)


def sketch_sums(rec_hh, rec_hl, slots, nslots: int):
    """(B, 4) record digest halves + (B,) cell indices -> (nslots, 8)
    int64 table of the words' unsigned sums, words interleaved [lo k,
    hi k]: tables built apart add up exactly before they are cut to u32.

    Slots are masked to the table width here, so an out-of-range value
    can neither alias nor be dropped."""
    words = torch.stack([rec_hl, rec_hh], dim=2).reshape(-1, DIGEST_WORDS)
    slots = (slots & (nslots - 1)).to(torch.int64)
    return scatter_add_sums(nslots, slots, words)


def sketch_table(rec_hh, rec_hl, slots, nslots: int):
    """The (nslots, 8) int32 sketch table of wrapping-u32 sums: the low 32
    bits of :func:`sketch_sums`."""
    return sketch_sums(rec_hh, rec_hl, slots, nslots).to(torch.int32)


def _summarize(all_hh, all_hl, n: int, log2_slots: int):
    """Record digests (rows [0, n)) -> sketch table; key digests (rows
    [n, 2n)) -> slots."""
    slots = key_slots(all_hl[n:], log2_slots)
    return (sketch_table(all_hh[:n], all_hl[:n], slots, 1 << log2_slots),
            slots)


class LogSummary:
    """One replica's reconciliation state: ``table`` ((nslots, 8) int32 on
    ``device``), ``slots`` ((n,) int64 numpy, each record's cell) and
    ``keys``.

    Records and keys are hashed by B1 on ``device``, then summarized
    there; only the slot vector crosses to the host."""

    def __init__(self, records: list[bytes], keys: list[bytes],
                 log2_slots: int, device="cuda"):
        from ..batch.feed import hash_extents_device

        if len(records) != len(keys):
            raise ValueError("records and keys must align")
        if not 0 < log2_slots <= 31:
            raise ValueError("log2_slots must be in [1, 31]")
        dev = resolve_device(device)
        n = len(records)
        self.keys = keys
        if n == 0:  # a fresh replica reconciling against a populated one
            self.slots = np.empty((0,), dtype=np.int64)
            self.table = torch.zeros((1 << log2_slots, DIGEST_WORDS),
                                     dtype=torch.int32, device=dev)
            return
        buf = np.frombuffer(b"".join(records) + b"".join(keys), np.uint8)
        lens = np.array([len(r) for r in records] + [len(k) for k in keys],
                        dtype=np.int64)
        offs = np.cumsum(lens) - lens
        with span("reconcile.hash"):
            all_hh, all_hl = hash_extents_device(buf, offs, lens,
                                                 device=dev)
        with span("reconcile.sketch"):
            self.table, slots = _summarize(all_hh, all_hl, n, log2_slots)
            self.slots = slots.cpu().numpy().astype(np.int64)


def reconcile(a: LogSummary, b: LogSummary) -> dict:
    """Keys each side must exchange to converge:
    ``{"slots": differing_slots, "a_keys": [...], "b_keys": [...]}``.
    Every differing, inserted or deleted record's key is included; the
    other keys of a differing cell come along."""
    slots = diff_sketches(a.table, b.table)
    a_keys = [a.keys[i] for i in np.nonzero(np.isin(a.slots, slots))[0]]
    b_keys = [b.keys[i] for i in np.nonzero(np.isin(b.slots, slots))[0]]
    return {"slots": slots, "a_keys": a_keys, "b_keys": b_keys}
