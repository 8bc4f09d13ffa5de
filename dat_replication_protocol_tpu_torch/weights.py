"""State carried across between the JAX package and the port.

The system has no model weights; the state that lives on the device is
leaf digest matrices and built tree levels, and the state two peers
exchange is a blob's content summary.  These helpers turn the JAX
package's ``build_tree`` output, as numpy ``uint32`` arrays, into the
port's int32 tensors and back, and a summary's fields into the port's
``ContentSummary`` and back, bit for bit, so that both sides can be
handed the same tree and a peer on either package can read the other's
summary.  Reconciliation state crosses the same way: a sketch table
((nslots, 8) u32) or a coded-symbol block ((m, 11) or (m, 12) u32), and
a whole ``LogSummary`` built on them.  Replayed change records cross as
a dict of a ``ChangeColumns``' numpy arrays (the log buffer and its
columns), so either package's replay can be held field by field against
the other's.  The anti-entropy drivers' state crosses without being
recomputed: a reconcile replica as its columns and canonical digests,
a snapshot source as its dataset, chunk cuts and chunk digests, so the
port's responder can serve exactly the JAX side's state.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.device import resolve_device


def levels_from_numpy(levels_hh, levels_hl, device="cuda"):
    """Per-level (n, 4) ``uint32`` arrays -> tuples of int32 tensors on
    ``device`` holding the same bits."""
    dev = resolve_device(device)

    def conv(level):
        arr = np.ascontiguousarray(level, dtype=np.uint32)
        return torch.from_numpy(arr.view(np.int32).copy()).to(dev)

    return (tuple(conv(x) for x in levels_hh),
            tuple(conv(x) for x in levels_hl))


def levels_to_numpy(levels_hh, levels_hl):
    """Tuples of int32 tensors -> per-level ``uint32`` numpy arrays."""

    def conv(level):
        return level.detach().cpu().numpy().view(np.uint32)

    return (tuple(conv(x) for x in levels_hh),
            tuple(conv(x) for x in levels_hl))


def summary_from_numpy(length, cuts, digests, root):
    """A content summary's fields (as the JAX package's ``ContentSummary``
    holds them) -> the port's ``ContentSummary``."""
    from .runtime.content import ContentSummary

    digests = np.ascontiguousarray(digests, dtype=np.uint8).reshape(-1, 32)
    cuts = [int(c) for c in cuts]
    if len(cuts) != digests.shape[0] or len(bytes(root)) != 32:
        raise ValueError("a summary needs one 32-byte digest per cut and a "
                         "32-byte root")
    return ContentSummary(int(length), cuts, digests.copy(), bytes(root))


def summary_to_numpy(summary):
    """The port's ``ContentSummary`` -> ``(length, cuts, digests, root)``:
    int, list of int, (nchunks, 32) uint8 array, 32 bytes."""
    return (int(summary.length), list(summary.cuts),
            np.array(summary.digests, dtype=np.uint8), bytes(summary.root))


_TABLE_WIDTHS = (8, 11, 12)  # sketch cells, coded symbols, weighted ones


def table_from_numpy(table, device="cuda"):
    """A (rows, 8|11|12) ``uint32`` sketch table or coded-symbol block ->
    an int32 tensor on ``device`` holding the same bits."""
    arr = np.ascontiguousarray(table, dtype=np.uint32)
    if arr.ndim != 2 or arr.shape[1] not in _TABLE_WIDTHS:
        raise ValueError(f"expected (rows, 8|11|12) words, got {arr.shape}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(
        resolve_device(device))


def table_to_numpy(table) -> np.ndarray:
    """An int32 table tensor -> the ``uint32`` numpy array of its bits."""
    return table.detach().cpu().numpy().view(np.uint32)


def log_summary_from_numpy(table, slots, keys, device="cuda"):
    """A reconciliation summary's fields (as the JAX package's
    ``LogSummary`` holds them: the table, each record's slot, the keys)
    -> the port's ``LogSummary`` on ``device``."""
    from .ops.reconcile import LogSummary

    slots = np.asarray(slots, dtype=np.int64)
    if len(slots) != len(keys) or np.shape(table)[1:] != (8,):
        raise ValueError("a summary needs an (nslots, 8) table and one slot "
                         "per key")
    summary = LogSummary.__new__(LogSummary)
    summary.table = table_from_numpy(table, device)
    summary.slots = slots.copy()
    summary.keys = list(keys)
    return summary


# ChangeColumns fields and their dtypes, in the dataclass's order
_COLUMNS = (("buf", np.uint8), ("change", np.uint32), ("from_", np.uint32),
            ("to", np.uint32), ("key_off", np.int64), ("key_len", np.int64),
            ("sub_off", np.int64), ("sub_len", np.int64),
            ("val_off", np.int64), ("val_len", np.int64))


def columns_from_numpy(d: dict):
    """A dict of change-column arrays (the fields of either package's
    ``ChangeColumns``) -> the port's ``ChangeColumns`` over copies."""
    from .runtime.replay import ChangeColumns

    missing = [name for name, _ in _COLUMNS if name not in d]
    if missing:
        raise KeyError(f"change columns lack {missing}")
    cols = {name: np.array(d[name], dtype=dt) for name, dt in _COLUMNS}
    n = len(cols["change"])
    if any(len(cols[name]) != n for name, _ in _COLUMNS[1:]):
        raise ValueError("change columns differ in length")
    return ChangeColumns(**cols)


def columns_to_numpy(cols) -> dict:
    """Either package's ``ChangeColumns`` -> a dict of its arrays, each
    in its field's dtype."""
    return {name: np.asarray(getattr(cols, name), dtype=dt)
            for name, dt in _COLUMNS}


def replica_from_numpy(columns, digests, rows=None, device="cuda"):
    """A reconcile replica's state (change columns, as either package's
    ``ChangeColumns`` or a dict of their arrays, and its canonical
    record digests as (n, 32) ``uint8``) -> the port's
    ``RatelessReplica`` on ``device``, with no record hashed again.
    ``digests`` is one per row, or, with ``rows``, the deduplicated
    element set and each element's log row (the JAX replica's
    ``digests`` and ``_digest_rows``)."""
    from .runtime.reconcile_driver import RatelessReplica

    if not isinstance(columns, dict):
        columns = columns_to_numpy(columns)
    return RatelessReplica.from_digests(columns_from_numpy(columns),
                                        digests, rows=rows, device=device)


def snapshot_source_from_numpy(data, cuts, digests, wire_offset: int = 0,
                               avg_bits: int = 13,
                               min_size: int | None = None,
                               max_size: int | None = None, device="cuda"):
    """A snapshot source's state (the dataset bytes, its chunk end
    offsets and the (nchunks, 32) ``uint8`` chunk digests, as the JAX
    ``SnapshotSource`` holds them in ``offs + lens`` and ``digests``) ->
    the port's ``SnapshotSource``, with nothing chunked or hashed
    again."""
    from .runtime.snapshot_driver import SnapshotSource

    return SnapshotSource.from_digests(
        data, [int(c) for c in cuts], digests, avg_bits=avg_bits,
        min_size=min_size, max_size=max_size, wire_offset=int(wire_offset),
        device=device)
