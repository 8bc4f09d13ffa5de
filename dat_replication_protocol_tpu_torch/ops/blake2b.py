"""Batched and streaming BLAKE2b: the plain PyTorch formulation, the
batch API and the chaining hasher.

The counterpart of ``dat_replication_protocol_tpu/ops/blake2b.py``
(``compress``/``initial_state``/``blake2b_packed``, :231-343,
``blake2b_update`` and ``Blake2bStream``, :383-526, and the host edge with
``blake2b_batch_begin``, :529-677).  Byte-exact RFC 7693.  The
reference's ``donation_supported`` (:367) is not ported: buffer donation
is a JAX notion, and the port's wrappers allocate their own outputs.

* The public layout is the reference's: message words as ``(B, nblocks,
  16)`` hi/lo uint32 halves, digests as ``(B, 8)`` hi/lo halves.  PyTorch
  has no uint32 arithmetic, so the halves travel in ``torch.int32``
  tensors holding the same bits, which is also what the CUDA kernel reads
  through ``data_ptr()``.
* :func:`blake2b_packed` is the plain version of kernel B1.  It joins the
  halves into whole 64-bit words in ``torch.int64``: addition wraps in
  two's complement, and the logical right shift of a rotate is an
  arithmetic shift with the sign bits masked off.  The state is a
  ``(16, B)`` tensor and the four column (then diagonal) mixes of a round
  run as one op over four rows.
* :func:`blake2b_batch_begin` buckets payloads by power-of-two block
  count and batch size, stages each bucket and hands it to kernel B1's
  wrapper (:mod:`.blake2b_cuda`).  On a CUDA device every bucket goes to
  the kernel: unlike the reference's ``_PALLAS_MIN_ITEMS`` floor there is
  no second device path.  On the CPU the wrapper takes this module's
  plain version.
* :func:`blake2b_update` is the plain version of B1's chained entry: it
  advances per-item chaining states and 64-bit byte counters over one
  segment each.  :class:`Blake2bStream` hashes one stream of any length
  through that entry in bounded segments.

Per-item payloads of the batch API are limited to < 2 GiB (byte counters
in 32 bits); a stream's counter has 64 bits.

Telemetry: the batch API counts ``device.h2d.bytes`` (each bucket's
padded message words and lengths) and ``device.d2h.bytes`` (64 bytes of
digest halves an item) and notes the ``blake2b.batch`` engine per
block-count bucket: B1's ``quad`` or ``thread`` variant, or ``plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.device import note_engine as _note_engine
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..utils.device import resolve_device

DIGEST_SIZE = 32  # BLAKE2b-256, dat's content-hash size
BLOCK_BYTES = 128

# RFC 7693 section 2.6
_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)
# RFC 7693 section 2.7; rounds 10 and 11 reuse rows 0 and 1
_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
_ROUND_SIGMA = [_SIGMA[r % 10] for r in range(12)]
# message-word order of one block for all 12 rounds: per round the x and
# y words of the four column mixes, then of the four diagonal mixes
_SCHEDULE = [
    i
    for s in _ROUND_SIGMA
    for i in (s[0:8:2] + s[1:8:2] + s[8:16:2] + s[9:16:2])
]

_MASK32 = 0xFFFFFFFF

# host <-> device traffic of the batch API (OBSERVABILITY.md catalog)
_M_H2D = _counter("device.h2d.bytes")
_M_D2H = _counter("device.d2h.bytes")


def _s64(x: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


_IV_S64 = [_s64(w) for w in _IV]


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate int64 words right by a constant ``n`` in [1, 63]."""
    return ((x >> n) & ((1 << (64 - n)) - 1)) | (x << (64 - n))


def join_words(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """hi/lo uint32 halves (any integer dtype) -> int64 64-bit words."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & _MASK32)


def split_words(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 64-bit words -> (hi, lo) halves as int32 bit patterns."""
    return (w >> 32).to(torch.int32), w.to(torch.int32)


_CONSTANTS: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The IV and the message schedule as tensors on ``device``, made once:
    a compression then copies nothing from the host, so a CUDA graph can
    capture it."""
    if device not in _CONSTANTS:
        _CONSTANTS[device] = (
            torch.tensor(_IV_S64, dtype=torch.int64, device=device),
            torch.tensor(_SCHEDULE, dtype=torch.int64, device=device))
    return _CONSTANTS[device]


def _compress_words(h, m, t, final):
    """One compression on whole words: ``h`` (8, B) int64 state, ``m``
    (16, B) int64 block, ``t`` (B,) int64 byte counter after this block,
    ``final`` (B,) bool.  Returns the new (8, B) state."""
    B = h.shape[1]
    iv, schedule = _constants(h.device)
    a, b = h[0:4], h[4:8]
    c = iv[0:4, None].expand(4, B)
    zero = torch.zeros_like(t)
    flag = torch.where(final, torch.full_like(t, -1), zero)
    d = iv[4:8, None] ^ torch.stack([t, zero, flag, zero])
    sched = m[schedule].view(12, 4, 4, B)
    for r in range(12):
        for half in (0, 1):
            x, y = sched[r, 2 * half], sched[r, 2 * half + 1]
            a = a + b + x
            d = _rotr(d ^ a, 32)
            c = c + d
            b = _rotr(b ^ c, 24)
            a = a + b + y
            d = _rotr(d ^ a, 16)
            c = c + d
            b = _rotr(b ^ c, 63)
            # diagonalize after the column mixes, undo after the diagonals
            shift = -1 if half == 0 else 1
            b = b.roll(shift, 0)
            c = c.roll(2 * shift, 0)
            d = d.roll(3 * shift, 0)
    return h ^ torch.cat([a, b]) ^ torch.cat([c, d])


def initial_state(batch: int, digest_size: int = DIGEST_SIZE,
                  device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """h0 = IV ^ parameter block (sequential mode, no key), as (B, 8)
    hi/lo int32 halves on ``device``."""
    h = torch.tensor(_IV_S64, dtype=torch.int64,
                     device=resolve_device(device))
    h[0] ^= 0x01010000 ^ digest_size
    hh, hl = split_words(h)
    return hh.expand(batch, 8).contiguous(), hl.expand(batch, 8).contiguous()


def compress(hh, hl, mh, ml, t_lo, is_final):
    """One compression in the reference's array-of-struct layout: state
    (B, 8) hi/lo, block (B, 16) hi/lo, ``t_lo`` (B,) byte counter,
    ``is_final`` (B,) bool.  Returns the new (B, 8) hi/lo state."""
    h = join_words(hh, hl).T
    m = join_words(mh, ml).T
    t = t_lo.to(torch.int64) & _MASK32
    nh = _compress_words(h, m, t, is_final.to(torch.bool))
    hh2, hl2 = split_words(nh.T.contiguous())
    return hh2, hl2


def blake2b_packed(mh, ml, lengths, digest_size: int = DIGEST_SIZE):
    """Hash a padded batch — the plain version of kernel B1.

    ``mh``/``ml``: (B, nblocks, 16) hi/lo message words; ``lengths``:
    (B,) byte lengths.  Padding bytes past each length MUST be zero (the
    packers guarantee it).  Returns digest words ``(hh, hl)``, each
    (B, 8) int32.  An item's blocks past ceil(len/128) (at least one) are
    not compressed, as the reference's active mask leaves them.
    """
    B, nblocks, _ = mh.shape
    dev = mh.device
    lengths = lengths.to(torch.int64) & _MASK32
    item_blocks = torch.clamp_min((lengths + 127) >> 7, 1)
    hh, hl = initial_state(B, digest_size, dev)
    h = join_words(hh, hl).T.contiguous()
    if B == 0:
        return hh, hl
    steps = min(nblocks, int(item_blocks.max()))
    for k in range(steps):
        m = join_words(mh[:, k, :], ml[:, k, :]).T
        t = torch.clamp_max(lengths, (k + 1) * BLOCK_BYTES)
        nh = _compress_words(h, m, t, item_blocks == k + 1)
        h = torch.where(item_blocks > k, nh, h)
    return split_words(h.T.contiguous())


def blake2b_update(hh, hl, t_hi, t_lo, mh, ml, seg_lengths, is_last):
    """Advance chaining states over one packed segment per item — the
    plain version of B1's chained entry (the reference's
    ``blake2b_update``, :383).

    ``hh``/``hl``: (B, 8) chaining state; ``t_hi``/``t_lo``: (B,) halves
    of the 64-bit count of bytes already compressed; ``mh``/``ml``: (B,
    nblocks, 16) segment words; ``seg_lengths``: (B,) bytes in this
    segment (whole blocks unless the segment is the last); ``is_last``:
    (B,) bool.  Block k's counter is ``t + min(seg_len, (k+1)*128)``, the
    final flag goes on the last block of a last segment, and the empty
    message (a zero-length last segment at t = 0) compresses one zero
    block; blocks past a segment's end are not compressed.  Returns
    ``(hh, hl, t_hi, t_lo)`` advanced past the segment, all int32.

    Every block position is stepped, masked where inactive, as the
    reference's scan steps them: nothing is read back to the host, so a
    CUDA graph can capture a call on the card.
    """
    nblocks = mh.shape[1]
    seg = seg_lengths.to(torch.int64) & _MASK32
    last = is_last.to(torch.bool)
    t = join_words(t_hi, t_lo)
    raw = (seg + 127) >> 7
    item_blocks = torch.where(last & (raw == 0) & (t == 0), 1, raw)
    h = join_words(hh, hl).T.contiguous()
    for k in range(nblocks):
        m = join_words(mh[:, k, :], ml[:, k, :]).T
        bt = t + torch.clamp_max(seg, (k + 1) * BLOCK_BYTES)
        nh = _compress_words(h, m, bt, last & (item_blocks == k + 1))
        h = torch.where(item_blocks > k, nh, h)
    hh, hl = split_words(h.T.contiguous())
    t_hi, t_lo = split_words(t + seg)
    return hh, hl, t_hi, t_lo


# ---------------------------------------------------------------------------
# host edge: bytes <-> padded batches
# ---------------------------------------------------------------------------


def _need_blocks(n: int) -> int:
    return max(1, -(-n // BLOCK_BYTES))


def _bucket_nblocks(n: int) -> int:
    """Round a count up to a power of two (block counts and batch sizes)."""
    return 1 << max(0, int(n) - 1).bit_length()


def _stage_bytes(payloads, nblocks: int, pin: bool):
    """Zero-padded ``(B, nblocks*128)`` uint8 rows plus (B,) int32
    lengths, in pinned host memory when ``pin``."""
    B = len(payloads)
    raw = torch.zeros((B, nblocks * BLOCK_BYTES), dtype=torch.uint8,
                      pin_memory=pin)
    lengths = torch.empty((B,), dtype=torch.int32, pin_memory=pin)
    arr = raw.numpy()
    lens = lengths.numpy()
    for i, p in enumerate(payloads):
        n = len(p)
        if n >= 1 << 31:
            raise ValueError("per-item payload limit is < 2 GiB; chunk first")
        if n:
            arr[i, :n] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = n
    return raw, lengths


def _split_halves(raw: torch.Tensor, nblocks: int):
    """(B, nblocks*128) little-endian bytes -> (B, nblocks, 16) hi/lo
    halves: u32 word 2k is 64-bit word k's low half, 2k+1 its high half."""
    words = raw.view(torch.int32).view(raw.shape[0], nblocks, 32)
    return words[:, :, 1::2].contiguous(), words[:, :, 0::2].contiguous()


def pack_payloads(payloads, nblocks: int | None = None):
    """Pack byte strings into padded (B, nblocks, 16) hi/lo int32 CPU
    tensors plus (B,) int32 lengths (the reference's ``pack_payloads``)."""
    need = _need_blocks(max((len(p) for p in payloads), default=0))
    if nblocks is None:
        nblocks = need
    elif nblocks < need:
        raise ValueError(f"nblocks={nblocks} < required {need}")
    raw, lengths = _stage_bytes(payloads, nblocks, pin=False)
    mh, ml = _split_halves(raw, nblocks)
    return mh, ml, lengths


def digests_to_bytes(hh, hl, digest_size: int = DIGEST_SIZE) -> list[bytes]:
    """Interleave (B, 8) hi/lo word halves into little-endian digests."""
    hh = np.asarray(hh).view(np.uint32)
    hl = np.asarray(hl).view(np.uint32)
    B = hh.shape[0]
    out = np.empty((B, 16), dtype="<u4")
    out[:, 0::2] = hl
    out[:, 1::2] = hh
    raw = out.view(np.uint8).reshape(B, 64)
    return [raw[i, :digest_size].tobytes() for i in range(B)]


def blake2b_batch_begin(payloads, digest_size: int = DIGEST_SIZE,
                        device="cuda"):
    """Dispatch batched hashing on ``device``; return ``collect()``.

    Items are grouped into power-of-two block-count buckets, each padded
    to a power-of-two batch with empty payloads (their digests are
    dropped).  On CUDA each bucket is staged in pinned host memory,
    copied without blocking, split into hi/lo halves on the card and
    hashed by kernel B1, all on the current stream, so the host returns
    to parsing while the card works.  ``collect.start_d2h()`` starts the
    digest readback into pinned memory without blocking; ``collect()``
    waits for it and returns digests in submit order.
    """
    from .blake2b_cuda import blake2b_packed_kernel, variant_name

    dev = resolve_device(device)
    handles = []
    for nb, idxs in bucket_by_blocks(payloads).items():
        batch = [payloads[i] for i in idxs]
        batch += [b""] * (_bucket_nblocks(len(batch)) - len(batch))
        if _OBS.on:
            # keyed per bucket: the variant is chosen per bucket
            _note_engine("blake2b.batch", variant_name(len(batch), dev),
                         key=nb, items=len(idxs), nblocks=nb)
        mh, ml, lengths = stage_batch(batch, nb, dev)
        if _OBS.on:
            _M_H2D.inc(mh.nbytes + ml.nbytes + lengths.nbytes)
        hh, hl = blake2b_packed_kernel(mh, ml, lengths, digest_size)
        handles.append((idxs, hh[: len(idxs)], hl[: len(idxs)]))
    return digest_collector(len(payloads), handles, digest_size, dev)


def bucket_by_blocks(payloads) -> dict[int, list[int]]:
    """Payload indices by power-of-two block count, in first-seen order."""
    buckets: dict[int, list[int]] = {}
    for i, p in enumerate(payloads):
        buckets.setdefault(_bucket_nblocks(_need_blocks(len(p))), []).append(i)
    return buckets


def stage_batch(payloads, nblocks: int, dev: torch.device):
    """``(mh, ml, lengths)`` of ``payloads`` at ``nblocks`` on ``dev``: on
    CUDA staged in pinned host memory, copied without blocking and split
    into hi/lo halves on the card."""
    on_cuda = dev.type == "cuda"
    raw, lengths = _stage_bytes(payloads, nblocks, pin=on_cuda)
    if on_cuda:
        raw = raw.to(dev, non_blocking=True)
        lengths = lengths.to(dev, non_blocking=True)
    mh, ml = _split_halves(raw, nblocks)
    return mh, ml, lengths


def digest_collector(n: int, handles, digest_size: int, dev: torch.device):
    """``collect()`` over per-bucket ``(idxs, hh, hl)`` digest words of
    ``n`` payloads, with ``collect.start_d2h``: the readback contract of
    :func:`blake2b_batch_begin`."""
    on_cuda = dev.type == "cuda"
    readback: list = []

    def start_d2h() -> None:
        # idempotent; the DigestPipeline calls it once a newer batch is
        # dispatched, so this readback rides under that batch's compute
        if readback or not on_cuda:
            return
        for idxs, hh, hl in handles:
            hosts = []
            for words in (hh, hl):
                host = torch.empty(words.shape, dtype=words.dtype,
                                   pin_memory=True)
                host.copy_(words, non_blocking=True)
                hosts.append(host)
            readback.append((idxs, *hosts))
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        readback.append(done)

    def collect() -> list[bytes]:
        if on_cuda:
            start_d2h()
            readback[-1].synchronize()
            ready = readback[:-1]
        else:
            ready = handles
        out: list[bytes | None] = [None] * n
        for idxs, hh, hl in ready:
            if _OBS.on:
                # two (B, 8) u32 halves per bucket: 64 bytes an item
                _M_D2H.inc(64 * len(idxs))
            for i, d in zip(idxs, digests_to_bytes(hh, hl, digest_size)):
                out[i] = d
        return out  # type: ignore[return-value]

    collect.start_d2h = start_d2h  # type: ignore[attr-defined]
    return collect


def blake2b_batch(payloads, digest_size: int = DIGEST_SIZE,
                  device="cuda") -> list[bytes]:
    """Hash a list of byte strings on ``device``; digests in submit order."""
    if not payloads:
        return []
    return blake2b_batch_begin(payloads, digest_size, device)()


class Blake2bStream:
    """Incremental BLAKE2b of one stream in bounded segments — the
    counterpart of the reference's ``Blake2bStream`` (:442).

    ``update(data)`` buffers until it holds more than one segment and
    sends each full segment through B1's chained entry
    (:func:`.blake2b_cuda.blake2b_update_kernel`), which advances the
    chaining state and 64-bit byte counter on ``device``; ``digest()``
    sends the rest with the final flag.  A segment that lands exactly on
    the boundary is held for ``digest()``, since the final block must
    carry the flag.  Middle segments share one padded shape; the tail is
    padded to a power of two of blocks, which are not compressed.

    On CUDA each segment is staged in pinned host memory and copied
    without blocking, and a CUDA event marks its launch.  Host memory in
    flight stays bounded: once ``max_inflight`` segments are queued the
    stream waits on the oldest one's event, never the newest, so the
    next segment's upload is not held behind the whole queue.
    ``update()`` after ``digest()`` raises.
    """

    def __init__(self, digest_size: int = DIGEST_SIZE,
                 segment_bytes: int = 1 << 22, max_inflight: int = 2,
                 device="cuda"):
        if segment_bytes <= 0 or segment_bytes % BLOCK_BYTES:
            raise ValueError(f"segment_bytes must be a positive multiple of "
                             f"{BLOCK_BYTES}")
        self._dev = resolve_device(device)
        self._digest_size = digest_size
        self._seg = segment_bytes
        self._max_inflight = max(1, max_inflight)
        self._fences: list = []  # oldest first: one CUDA event a segment
        hh, hl = initial_state(1, digest_size, self._dev)
        zero = torch.zeros(1, dtype=torch.int32, device=self._dev)
        self._state = (hh, hl, zero, zero)
        self._flags = {last: torch.tensor([last], device=self._dev)
                       for last in (False, True)}
        self._pending = bytearray()
        self._digest: bytes | None = None
        self.length = 0

    def update(self, data) -> "Blake2bStream":
        if self._digest is not None:
            raise RuntimeError("update() after digest()")
        data = memoryview(data)
        self._pending += data
        self.length += data.nbytes
        # strictly more than a segment: the last byte stays for digest()
        k = max(0, len(self._pending) - 1) // self._seg
        with memoryview(self._pending) as view:
            for j in range(k):
                self._advance(view[j * self._seg:(j + 1) * self._seg]
                              .tobytes(), last=False)
        del self._pending[:k * self._seg]
        return self

    def _advance(self, seg, last: bool) -> None:
        from .blake2b_cuda import blake2b_update_kernel

        nblocks = _need_blocks(len(seg))
        if last:
            nblocks = _bucket_nblocks(nblocks)
        mh, ml, lengths = stage_batch([seg], nblocks, self._dev)
        self._state = blake2b_update_kernel(*self._state, mh, ml, lengths,
                                            self._flags[last])
        if self._dev.type != "cuda":
            return
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self._dev))
        self._fences.append(done)
        while len(self._fences) >= self._max_inflight:
            self._fences.pop(0).synchronize()

    def digest(self) -> bytes:
        if self._digest is None:
            self._advance(self._pending, last=True)
            self._pending.clear()
            self._fences.clear()
            hh, hl, _, _ = self._state
            self._digest = digests_to_bytes(hh.cpu(), hl.cpu(),
                                            self._digest_size)[0]
        return self._digest
