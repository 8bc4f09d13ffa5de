"""Batching feed: ragged extents of one host buffer -> B1 batches.

The counterpart of ``dat_replication_protocol_tpu/batch/feed.py``
(``pack_ragged`` :51, ``bucketed_extents`` :104, ``hash_extents`` /
``hash_extents_device`` :115-244, ``DeviceChangeBatch`` /
``decode_batch_device`` :248-297, ``leaves_from_change_columns`` /
``leaves_from_columns`` :300-344).  ``hash_extents`` uploads the
buffer in windows, staged in pinned host memory and copied without
blocking on CUDA, and packs every bucket for kernel B1 on the device,
where the reference packs on the host; there is no item floor and no
buffer donation.  ``pack_ragged`` is the reference's host pack, on no
hash path.  Replayed change records become Merkle leaves here: a leaf
is the BLAKE2b-256 of the record's per-record payload, whatever framing
carried it.

Telemetry: each B1 chunk's pack and launch is a ``device.dispatch`` span
(field ``site``), ``hash_extents``' staging of a window an
``extents.window`` span and its digest readback an ``extents.collect``
span; ``extents.windows`` counts the windows, ``device.h2d.bytes``
their staged words, ``device.h2d.overlap`` those staged after the
call's first window (copied while earlier windows upload or hash),
``device.d2h.bytes`` the digests read back; ``decode_batch_device``
counts its columns' H2D bytes and notes the ``feed.decode_batch``
engine.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..obs.device import note_engine as _note_engine
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.tracing import trace_span as _trace_span
from ..ops import blake2b
from ..utils.device import resolve_device
from ..utils.trace import span
from ..wire.batch_codec import ragged_copy

BLOCK_BYTES = blake2b.BLOCK_BYTES
PIPELINE_BYTES = 64 << 20  # padded message bytes per B1 launch, at most
WINDOW_BYTES = 256 << 20  # buffer bytes uploaded at a time, at most

# host <-> device traffic (OBSERVABILITY.md catalog)
_M_H2D = _counter("device.h2d.bytes")
_M_D2H = _counter("device.d2h.bytes")
_M_H2D_OVERLAP = _counter("device.h2d.overlap")
_M_WINDOWS = _counter("extents.windows")


def pack_ragged(buf: np.ndarray, offs, lens, nblocks: int | None = None):
    """Pack extents of ``buf`` into zero-padded (B, nblocks, 16) hi/lo
    uint32 words plus (B,) uint32 lengths (numpy), as
    ``blake2b.pack_payloads`` would pack the extents' bytes."""
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    B = len(offs)
    need = max(1, -(-(int(lens.max()) if B else 0) // BLOCK_BYTES))
    if nblocks is None:
        nblocks = need
    elif nblocks < need:
        raise ValueError(f"nblocks={nblocks} < required {need}")
    width = nblocks * BLOCK_BYTES
    out = np.zeros((B, width), dtype=np.uint8)
    total = int(lens.sum())
    if total and B <= 4096:
        # few items: one memcpy each
        for i in range(B):
            out[i, :lens[i]] = buf[offs[i]:offs[i] + lens[i]]
    elif total:
        ragged_copy(out.reshape(-1), np.arange(B, dtype=np.int64) * width,
                    buf, offs, lens)
    words = out.view("<u4").reshape(B, nblocks, 32)
    return (np.ascontiguousarray(words[:, :, 1::2]),
            np.ascontiguousarray(words[:, :, 0::2]),
            lens.astype(np.uint32))


def bucketed_extents(lens) -> dict[int, np.ndarray]:
    """Extent indices grouped by power-of-two padded block count."""
    lens = np.asarray(lens, dtype=np.int64)
    blocks = np.maximum(1, -(-lens // BLOCK_BYTES))
    nb = 1 << np.ceil(np.log2(blocks)).astype(np.int64)
    return {int(b): np.nonzero(nb == b)[0] for b in np.unique(nb)}


def hash_extents_device(buf: np.ndarray, offs, lens, device="cuda",
                        pipeline_bytes: int = PIPELINE_BYTES):
    """BLAKE2b-256 of extents of a host buffer, as ``(hh, hl)`` tensors
    on ``device``, each (N, 4) int32, in extent order.

    The extents, in offset order, are grouped into windows of the buffer
    of at most ``WINDOW_BYTES`` that end where an extent ends (an extent
    longer than that gets a window of its own).  Each window's bytes,
    with any gaps between its extents, are staged once in pinned memory
    and copied without blocking on CUDA; torch's caching host allocator
    rounds a pinned request up to a power of two, so every full window
    reuses one cached block.  The window's extents are gathered into
    B1's padded rows on the device (``pack_extents_device``) and hashed
    bucket by bucket, in chunks of at most ``pipeline_bytes`` of padded
    messages.  Window k+1 is staged before window k is hashed.  An
    extent over 1 GiB is refused: its padded row would pass the gather's
    int32 positions.
    """
    from ..ops.fused_cdc_hash import pack_extents_device
    from ..ops.rabin import stage_words

    dev = resolve_device(device)
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    n = len(offs)
    out_hh = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    out_hl = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    if not n:
        return out_hh, out_hl
    order = np.argsort(offs, kind="stable")
    starts = offs[order]
    # the window of extents order[i:j] spans starts[i] .. reach[j - 1]
    reach = np.maximum.accumulate(starts + lens[order])
    firsts = [0]
    while firsts[-1] < n:
        i = firsts[-1]
        j = int(np.searchsorted(reach, starts[i] + WINDOW_BYTES, "right"))
        firsts.append(max(j, i + 1))

    def stage(k: int) -> torch.Tensor:
        w0, w1 = int(starts[firsts[k]]), int(reach[firsts[k + 1] - 1])
        with span("extents.window"):
            words = stage_words(buf[w0:w1], max(1, -(-(w1 - w0) // 4)), dev)
        if _OBS.on:
            _M_WINDOWS.inc()
            _M_H2D.inc(words.nbytes)
            if k:
                _M_H2D_OVERLAP.inc(words.nbytes)
        return words

    nwin = len(firsts) - 1
    ahead = stage(0)
    for k in range(nwin):
        data = ahead.view(torch.uint8)
        if k + 1 < nwin:
            ahead = stage(k + 1)
        i, j = firsts[k], firsts[k + 1]
        w_offs, w_lens = starts[i:j] - starts[i], lens[order[i:j]]
        hh, hl = _hash_buckets(
            w_lens, dev, pipeline_bytes,
            lambda idx, nb: pack_extents_device(data, w_offs[idx],
                                                w_lens[idx], nb))
        at = torch.as_tensor(order[i:j], device=dev)
        out_hh[at] = hh
        out_hl[at] = hl
    return out_hh, out_hl


def _hash_buckets(lens: np.ndarray, dev: torch.device, pipeline_bytes: int,
                  pack, site: str = "feed.hash_extents"):
    """Shared bucket loop of the two chunk-hash paths: ``pack(idx, nb)``
    gives (mh, ml, lengths) on ``dev`` for extents ``idx`` at ``nb``
    blocks; every chunk goes to B1; digests land in extent order.  Each
    chunk's pack and launch is one ``device.dispatch`` span with field
    ``site``."""
    from ..ops.blake2b_cuda import blake2b_packed_kernel, variant_name

    n = len(lens)
    out_hh = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    out_hl = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    for nb, idx in bucketed_extents(lens).items():
        chunk_b = max(1, pipeline_bytes // (nb * BLOCK_BYTES))
        if _OBS.on:
            # keyed per bucket, as the blake2b batch edge
            _note_engine(site, variant_name(min(chunk_b, len(idx)), dev),
                         key=nb, items=len(idx), nblocks=nb)
        for c0 in range(0, len(idx), chunk_b):
            sub = idx[c0:c0 + chunk_b]
            with _trace_span("device.dispatch", site=site, items=len(sub),
                             nblocks=nb):
                # pack is the device gather of a window's extents or of
                # resident chunks, passed in by the two callers: it packs
                # the chunk's padded messages and returns, no user code
                # datlint: allow-callback-escape
                hh, hl = blake2b_packed_kernel(*pack(sub, nb))
            at = torch.as_tensor(sub, device=dev)
            out_hh[at] = hh[:, :4]
            out_hl[at] = hl[:, :4]
    return out_hh, out_hl


def hash_extents(buf: np.ndarray, offs, lens, device="cuda",
                 pipeline_bytes: int = PIPELINE_BYTES) -> np.ndarray:
    """BLAKE2b-256 digests of extents of ``buf``, (N, 32) uint8 numpy."""
    from ..ops.merkle import digest_matrix

    if not len(offs):
        return np.empty((0, 32), dtype=np.uint8)
    hh, hl = hash_extents_device(buf, offs, lens, device, pipeline_bytes)
    if _OBS.on:
        _M_D2H.inc(32 * len(offs))  # (N, 4) hi + lo halves read back
    with span("extents.collect"):
        return digest_matrix(hh, hl)


@dataclasses.dataclass
class DeviceChangeBatch:
    """A decoded ``ChangeBatch`` resident on a device.

    ``change`` / ``from_`` / ``to`` are (n,) int64 tensors holding the
    wire's uint32 values; ``buf`` is the payload as a uint8 tensor, with
    ``val_off`` / ``val_len`` (int64; -1 = absent) addressing the value
    heap inside it.  Key and subset dictionaries stay in ``buf``: kernels
    address bytes, not strings.
    """

    change: torch.Tensor
    from_: torch.Tensor
    to: torch.Tensor
    buf: torch.Tensor
    val_off: torch.Tensor
    val_len: torch.Tensor

    def __len__(self) -> int:
        return int(self.change.shape[0])


def decode_batch_device(payload, base: int = 0,
                        device="cuda") -> DeviceChangeBatch:
    """Decode one ChangeBatch payload straight into tensors on
    ``device``.

    The wire's columns are already the device layout: each column goes
    over in one copy from a zero-copy numpy view, the uint32 ones as
    int32 bits widened on the device.  Structural corruption raises
    ``ValueError``, as :func:`..wire.batch_codec.decode_change_batch`
    does.
    """
    from ..wire.batch_codec import decode_change_batch

    dev = resolve_device(device)
    cols = decode_change_batch(payload, base=base)
    n = len(cols.change)
    if _OBS.on:
        _note_engine("feed.decode_batch", dev.type)

    def put(arr):
        # the payload's views are read-only: nothing writes through the
        # tensor before it is copied
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "The given NumPy array")
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(dev) if dev.type == "cuda" else t.clone()

    def words(col):
        return put(np.ascontiguousarray(col).view(np.int32)).to(
            torch.int64) & 0xFFFFFFFF

    with _trace_span("device.dispatch", site="feed.decode_batch", items=n):
        if _OBS.on:
            # the heap, three u32 columns, two int64 value columns
            _M_H2D.inc(cols.buf.nbytes + 12 * n + 16 * n)
        return DeviceChangeBatch(
            change=words(cols.change), from_=words(cols.from_),
            to=words(cols.to), buf=put(cols.buf), val_off=put(cols.val_off),
            val_len=put(cols.val_len))


def leaves_from_change_columns(cols, device="cuda") -> np.ndarray:
    """Merkle leaf digests for decoded change columns WITHOUT a matching
    per-record frame index — the batch-framed replay path.

    The leaf contract is framing-independent: a row's leaf is the
    BLAKE2b-256 of its canonical per-record payload encoding, so a
    batch-framed log and a per-record log of the same rows produce
    identical trees.  Rows are re-encoded canonically by numpy and the
    payload extents hashed on B1."""
    from ..runtime.replay import canonical_change_extents

    dev = resolve_device(device)
    buf, offs, lens = canonical_change_extents(cols)
    return hash_extents(buf, offs, lens, dev)


def leaves_from_columns(cols, frames=None, device="cuda") -> np.ndarray:
    """Merkle leaf digests for replayed change records, in log order,
    as (N, 32) uint8.

    A leaf is the BLAKE2b-256 of the record's serialized payload bytes.
    ``cols`` is a :class:`..runtime.replay.ChangeColumns`; if ``frames``
    (the matching FrameIndex) is given and holds one ``Change`` frame per
    row, the raw framed payload extents are hashed directly, else (batch
    frames present) the canonical re-encoding.  Without ``frames`` each
    row is re-encoded as ``cols.row(i)`` materializes it, absent
    optionals as present-empty (the reference's behavior), and hashed
    with ``blake2b_batch``.
    """
    dev = resolve_device(device)
    if frames is not None:
        from ..wire.framing import TYPE_CHANGE

        sel = frames.ids == TYPE_CHANGE
        if int(sel.sum()) == len(cols):
            return hash_extents(frames.buf, frames.starts[sel],
                                frames.lens[sel], dev)
        # batch frames carry rows the per-record extents don't cover:
        # hash the canonical re-encoding (identical digests either way)
        return leaves_from_change_columns(cols, dev)
    from ..runtime.replay import _encode_columns_per_record

    buf, offs, lens = _encode_columns_per_record(cols, present_empty=True)
    data = buf.tobytes()
    payloads = [data[o:o + n] for o, n in zip(offs.tolist(), lens.tolist())]
    return np.frombuffer(
        b"".join(blake2b.blake2b_batch(payloads, device=dev)),
        dtype=np.uint8).reshape(len(payloads), 32)
