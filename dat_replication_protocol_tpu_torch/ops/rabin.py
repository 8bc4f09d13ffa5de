"""Content-defined chunking: the gear rolling hash over tiled streams.

The counterpart of ``dat_replication_protocol_tpu/ops/rabin.py``.  The
algorithm is the reference's, retyped from its definition:

* a gear rolling hash ``h_i = (h_{i-1} << 1) + g(b_i) mod 2^64`` with
  ``g(b) = ((b+1)·C1 mod 2^32) | ((b+1)·C2 mod 2^32) << 32``; a byte's
  contribution leaves the state after 64 positions, so the hash at any
  position depends only on the 64 bytes that end there;
* the stream is seeded with 64 zero bytes: position 0's state is the
  state after 64 zero bytes;
* position j is a candidate boundary when ``(h_j >> 32) & (2^avg_bits -
  1) == 0``;
* at most the first candidate of each aligned ``2^thin_bits``-byte
  window survives (chunkers pass ``thin_bits = log2(min_size)``), and a
  sequential greedy pass applies the min/max chunk sizes.

Streams are cut into rows of ``_PREFIX`` context bytes plus ``stride``
payload bytes (:func:`_build_rows`); the hash starts from zero at each
row start, and the first 256-byte group of a row is warm-up that never
counts.  The four scans over such rows are kernels B3-B6 on the card
(:mod:`.rabin_cuda`, :mod:`.fused_cdc_hash`); their plain PyTorch
versions live here and run on CPU tensors.  The extraction route is an
argument (``route=``), never an environment variable.

Rows and words are int32 tensors holding the u32 bits of the reference's
layout (byte j of a row is byte ``j % 4`` of word ``j // 4``, little
endian).

Telemetry: the scan's dispatch, collect and greedy pass run inside the
reference's ``cdc.dispatch`` / ``cdc.collect`` / ``cdc.greedy`` spans,
and ``chunk_stream`` stages each slab inside a ``cdc.stage`` span;
a refused ``fused1p`` extraction counts in
``cdc.fused.crosscheck.refused``; ``chunk_stream`` notes its route as
the ``cdc.chunk`` engine; the two extraction functions are
kernel-sentinel sites.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.device import kernel_site
from ..obs.device import note_engine as _note_engine
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..utils.device import resolve_device
from ..utils.trace import span
from .merkle import unpack_mask

WINDOW = 64  # bytes: contributions shift out of the 64-bit state after this
_GEAR_C1 = 0x9E3779B1
_GEAR_C2 = 0x85EBCA77
PACK = 32  # candidate bits per packed u32 word
GROUP = 256  # bytes per scan group
_PREFIX = GROUP  # context bytes in front of every row's payload
_PREFIX_WORDS = _PREFIX // 4
NO_HIT = GROUP  # first-hit-per-group sentinel: no candidate in the group
_SENT_OFF = 1 << 30  # first-hit-per-window sentinel: an empty window
ROUTES = ("bitmask", "first", "fused", "fused1p")
TILE_BYTES = 1 << 17  # payload bytes per scan row

_M32 = 0xFFFFFFFF

# fused1p extractions refused by their on-chip cross-check
_M_FUSED_REFUSED = _counter("cdc.fused.crosscheck.refused")


def _s64(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def _gear_g(b: int) -> int:
    v = b + 1
    return ((v * _GEAR_C1) & _M32) | (((v * _GEAR_C2) & _M32) << 32)


# g(b) for every byte value, as the int64 with the same bits
_GEAR_TABLE = [_s64(_gear_g(b)) for b in range(256)]


def check_route(route: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"unknown CDC route {route!r}; expected one of "
                         f"{ROUTES}")


def default_sizes(avg_bits: int, min_size: int | None,
                  max_size: int | None) -> tuple[int, int]:
    """Chunk size limits, by default a quarter and four times the
    average chunk of ``2^avg_bits`` bytes."""
    return (1 << (avg_bits - 2) if min_size is None else min_size,
            1 << (avg_bits + 2) if max_size is None else max_size)


# ---------------------------------------------------------------------------
# plain versions of kernels B3-B6
# ---------------------------------------------------------------------------


def gear_hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """The gear state after every byte of every row, as (T, S) int64.

    The state starts from zero at each row start.  Instead of the
    kernels' serial chain along the row, every position is computed from
    its own window by the closed form

        h_i = sum_{k=0}^{min(i, 63)} g(b_{i-k}) << k   (mod 2^64),

    which holds because ``h_i = (h_{i-1} << 1) + g(b_i)`` from ``h = 0``
    and ``<< 64`` clears a word.  It is evaluated by Horner's rule over
    the 64 window offsets, with the row padded by 63 zero contributions
    on the left (no byte before the row start), so 64 shift-and-add
    passes over the whole (T, S) tensor give every state exactly.
    """
    T, nwords = rows.shape
    S = nwords * 4
    data = rows.contiguous().view(torch.uint8).view(T, S).to(torch.int64)
    table = torch.tensor(_GEAR_TABLE, dtype=torch.int64, device=rows.device)
    g = torch.zeros((T, S + WINDOW - 1), dtype=torch.int64,
                    device=rows.device)
    g[:, WINDOW - 1:] = table[data]
    h = torch.zeros((T, S), dtype=torch.int64, device=rows.device)
    for j in range(WINDOW):
        h <<= 1
        h += g[:, j:j + S]
    return h


def _hits(rows: torch.Tensor, avg_bits: int) -> torch.Tensor:
    """(T, S) bool: candidate positions of every row."""
    return ((gear_hash_rows(rows) >> 32) & ((1 << avg_bits) - 1)) == 0


def _pack_bits(hits: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., n/32) int32 words, bit j%32 of word j//32."""
    shifts = torch.arange(PACK, dtype=torch.int64, device=hits.device)
    grouped = hits.reshape(*hits.shape[:-1], -1, PACK).to(torch.int64)
    return (grouped << shifts).sum(-1).to(torch.int32)


def gear_candidates_tiled(rows: torch.Tensor, avg_bits: int = 13):
    """Packed candidate bitmask of every row: (T, S/4) int32 words in,
    (T, S/32) int32 words out — the plain version of kernel B3."""
    if (rows.shape[1] * 4) % GROUP:
        raise ValueError(f"row bytes must be a multiple of {GROUP}")
    return _pack_bits(_hits(rows, avg_bits))


def gear_first_tiled(rows: torch.Tensor, avg_bits: int = 13):
    """First candidate offset of every 256-byte group, or ``NO_HIT``:
    (T, S/4) in, (T, S/256) int32 out — the plain version of kernel B4."""
    T, nwords = rows.shape
    if (nwords * 4) % GROUP:
        raise ValueError(f"row bytes must be a multiple of {GROUP}")
    hits = _hits(rows, avg_bits).view(T, -1, GROUP)
    pos = torch.arange(GROUP, dtype=torch.int32, device=rows.device)
    return torch.where(hits, pos, NO_HIT).amin(-1).to(torch.int32)


def _window_hits(rows: torch.Tensor, avg_bits: int, thin_bits: int):
    """(T, nwpt, W) bool over the payload (group 0 dropped)."""
    T, nwords = rows.shape
    W = 1 << thin_bits
    payload = nwords * 4 - GROUP
    if W < GROUP or payload % W:
        raise ValueError(f"window of 2**{thin_bits} B needs payload bytes "
                         f"{payload} divisible by it and >= {GROUP}")
    return _hits(rows, avg_bits)[:, GROUP:].reshape(T, payload // W, W)


def gear_window_first(rows: torch.Tensor, avg_bits: int, thin_bits: int):
    """First candidate offset in every ``2^thin_bits``-byte window of the
    payload, in stream order: (T * nwin_per_row,) int32, ``1 << 30`` for
    an empty window — the plain version of kernel B5."""
    hits = _window_hits(rows, avg_bits, thin_bits)
    pos = torch.arange(hits.shape[-1], dtype=torch.int32, device=rows.device)
    return torch.where(hits, pos, _SENT_OFF).amin(-1).reshape(-1).to(
        torch.int32)


def gear_window_first_checked(rows: torch.Tensor, avg_bits: int,
                              thin_bits: int):
    """B5's output plus ``viol``, the count of windows where an
    independent occupancy fold (any packed word nonzero) disagrees with
    the first-hit reduction — the plain version of kernel B6.  Returns
    ``(first, viol)``, ``viol`` a 0-d int64 tensor."""
    hits = _window_hits(rows, avg_bits, thin_bits)
    pos = torch.arange(hits.shape[-1], dtype=torch.int32, device=rows.device)
    first = torch.where(hits, pos, _SENT_OFF).amin(-1).reshape(-1).to(
        torch.int32)
    occ = (_pack_bits(hits) != 0).any(-1).reshape(-1)
    return first, (occ != (first != _SENT_OFF)).sum()


# ---------------------------------------------------------------------------
# device-resident candidate extraction
# ---------------------------------------------------------------------------


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of the low 32 bits of int64 lanes (SWAR)."""
    x = x & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _first_bit_per_window(wins: torch.Tensor) -> torch.Tensor:
    """First set-bit offset of every row of packed int32 words, or
    ``1 << 30`` for an empty row."""
    wnz = wins != 0
    first_w = wnz.to(torch.int8).argmax(1)
    wval = wins.gather(1, first_w[:, None])[:, 0].to(torch.int64) & _M32
    lsb = wval & -wval
    bitpos = _popcount32(lsb - 1)
    out = first_w * PACK + bitpos
    return torch.where(wnz.any(1), out, _SENT_OFF).to(torch.int32)


def _build_rows(words_padded: torch.Tensor, pre_row: torch.Tensor, T: int,
                stride: int) -> torch.Tensor:
    """[context GROUP | payload] rows, (T, _PREFIX_WORDS + stride/4).

    Row t covers stream bytes [t*stride - _PREFIX, (t+1)*stride): a
    warm-up group whose last WINDOW bytes are the real preceding context
    (``pre_row`` for the first row: zeros at the stream head), then the
    payload.  The valid bytes of every row start on a group boundary.
    """
    payload = words_padded.reshape(T, stride // 4)
    ctx = torch.cat([pre_row[None, :], payload[:-1, -_PREFIX_WORDS:]], 0)
    return torch.cat([ctx, payload], 1)


def _compact(mask: torch.Tensor, values: torch.Tensor, cap: int):
    """The first ``cap`` of ``values[mask]`` in order, zero-filled, and
    the count of ``mask`` — without a device-to-host round trip."""
    rank = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (rank < cap), rank, cap)
    out = torch.zeros(cap + 1, dtype=values.dtype, device=values.device)
    out.scatter_(0, slot, values)
    return out[:cap], mask.sum()


def _window_first(rows, avg_bits: int, thin_bits: int, route: str):
    """Per-window first-candidate offsets by ``route``'s kernel; returns
    ``(first, viol)`` with ``viol`` None except on ``fused1p``."""
    from .fused_cdc_hash import gear_window_first_checked_kernel
    from .rabin_cuda import (gear_candidates_kernel, gear_first_kernel,
                             gear_window_first_kernel)

    if route == "fused1p":
        return gear_window_first_checked_kernel(rows, avg_bits, thin_bits)
    if route == "fused":
        return gear_window_first_kernel(rows, avg_bits, thin_bits), None
    if route == "first":
        vg = gear_first_kernel(rows, avg_bits)[:, 1:]  # drop warm-up group
        gpw = (1 << thin_bits) // GROUP
        wins = vg.reshape(-1, gpw)
        gidx = torch.arange(gpw, dtype=torch.int32, device=rows.device)
        hitpos = torch.where(wins < NO_HIT, wins + gidx * GROUP, _SENT_OFF)
        return hitpos.amin(1).to(torch.int32), None
    vw = gear_candidates_kernel(rows, avg_bits)[:, _PREFIX // PACK:]
    wpw = (1 << thin_bits) // PACK  # packed words per window
    return _first_bit_per_window(vw.reshape(-1, wpw)), None


def _extract_first_occ(words_padded, pre_row, T: int, stride: int,
                       avg_bits: int, cap2: int, thin_bits: int,
                       route: str = "bitmask"):
    """Thinned candidate extraction: occupancy bitmap plus in-window
    offsets (thin_bits >= 8).

    Four equivalent routes give identical candidates: ``bitmask`` (B3 +
    a first-set-bit reduction per window), ``first`` (B4 + a min over a
    window's groups), ``fused`` (B5) and ``fused1p`` (B6, which also
    returns ``viol``).  Returns device tensors ``(occ, offs[, viol])``:
    ``occ`` (ceil(nwin/32),) int32, bit w set iff window w holds a
    candidate; ``offs`` (cap2,) int16 holding the u16 in-window offsets
    of the occupied windows in window order.  The host derives the count
    from ``occ``, so nothing is read back before the transfer.
    """
    rows = _build_rows(words_padded, pre_row, T, stride)
    first, viol = _window_first(rows, avg_bits, thin_bits, route)
    has = first < _SENT_OFF
    pad = -has.shape[0] % PACK
    occ = _pack_bits(torch.nn.functional.pad(has, (0, pad)))
    offs, _ = _compact(has, first, cap2)
    offs = offs.to(torch.int16)
    return (occ, offs) if viol is None else (occ, offs, viol)


_extract_first_occ = kernel_site("ops.rabin.extract_first_occ",
                                 _extract_first_occ)


def _extract_candidates(words_padded, pre_row, T: int, stride: int,
                        avg_bits: int, cap: int,
                        thin_bits: int | None = None):
    """Candidate positions through B3 (thin_bits None or < 8).

    ``thin_bits=None``: every candidate; otherwise the first candidate
    of every ``2^thin_bits``-byte window.  Returns device tensors
    ``(positions, ncand)``: ``positions`` (cap,) int64 absolute byte
    positions, the first ``ncand`` valid and ascending.
    """
    from .rabin_cuda import gear_candidates_kernel

    rows = _build_rows(words_padded, pre_row, T, stride)
    bits = gear_candidates_kernel(rows, avg_bits)
    flat = bits[:, _PREFIX // PACK:_PREFIX // PACK + stride // PACK]
    flat = flat.reshape(-1)
    if thin_bits is not None:
        W = 1 << thin_bits
        inwin = _first_bit_per_window(flat.reshape(-1, W // PACK))
        has = inwin < _SENT_OFF
        pos = torch.arange(has.shape[0], dtype=torch.int64,
                           device=has.device) * W + inwin
        return _compact(has, pos, cap)
    shifts = torch.arange(PACK, dtype=torch.int32, device=flat.device)
    hit = ((flat[:, None] >> shifts) & 1).reshape(-1) != 0
    pos = torch.arange(hit.shape[0], dtype=torch.int64, device=hit.device)
    return _compact(hit, pos, cap)


_extract_candidates = kernel_site("ops.rabin.extract_candidates",
                                  _extract_candidates)


def _clamp_thin_bits(thin_bits: int | None, stride: int) -> int | None:
    """The thinning-policy clamps, shared by every route: no thinning
    below 32-byte windows; the window must divide the tile (stride's
    largest power-of-two divisor) and fit a u16 offset (<= 2^16)."""
    if thin_bits is None or thin_bits < 5:
        return None
    tz = (stride & -stride).bit_length() - 1
    thin_bits = min(thin_bits, tz, 16)
    return thin_bits if thin_bits >= 5 else None


def _start_d2h(tensors):
    """Start copying ``tensors`` to the host without blocking.  Returns
    ``wait()``, which gives their numpy arrays once the copies are done:
    pinned buffers and an event on the current stream on CUDA."""
    if tensors[0].device.type == "cpu":
        return lambda: [t.numpy() for t in tensors]
    hosts = []
    for t in tensors:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        hosts.append(host)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))

    def wait():
        done.synchronize()
        return [h.numpy() for h in hosts]

    return wait


def candidates_begin(words: torch.Tensor, nbytes: int, avg_bits: int = 13,
                     tile_bytes: int = TILE_BYTES, prefix=None,
                     thin_bits: int | None = None, route: str = "bitmask"):
    """Start the candidate scan of a word buffer; returns ``collect()``.

    ``words``: flat int32 tensor (on the card or the CPU) of the stream
    bytes, little endian, zero past ``nbytes``; it may already hold the
    padding to whole tiles.  ``prefix``: the WINDOW bytes before this
    buffer in the stream (None = the stream head's zero seed).
    ``route`` picks the kernel when ``thin_bits >= 8`` (see
    :func:`_extract_first_occ`).  ``collect()`` returns the sorted
    absolute candidate positions (int64 numpy, < nbytes).  The scan and
    the readback of its occupancy and offsets are queued here; only
    ``collect()`` waits.

    A ``fused1p`` extraction whose ``viol`` is nonzero is refused and
    recomputed on ``bitmask`` at the same cap; each refusal adds one to
    ``candidates_begin.refusals``.
    """
    check_route(route)
    if nbytes == 0:
        return lambda: np.empty((0,), dtype=np.int64)
    if nbytes > 1 << 31:
        raise ValueError("per-call limit is 2 GiB; slab your stream")
    if tile_bytes % GROUP:
        raise ValueError(f"tile_bytes must be a multiple of {GROUP}")
    stride = tile_bytes
    T = -(-nbytes // stride)
    words = words.reshape(-1)
    need = -(-nbytes // 4)
    if words.shape[0] not in (need, T * stride // 4):
        raise ValueError(f"word buffer holds {words.shape[0] * 4} bytes; "
                         f"nbytes={nbytes} needs {need} words (or the "
                         f"padded {T * stride // 4})")
    dev = words.device
    pre = torch.zeros(_PREFIX_WORDS, dtype=torch.int32, device=dev)
    if prefix is not None:
        ctx = torch.from_numpy(np.array(prefix, dtype="<u4").view(np.int32))
        if ctx.numel() != WINDOW // 4:
            raise ValueError(f"prefix must be {WINDOW} bytes")
        pre[-(WINDOW // 4):] = ctx.to(dev)
    pad = T * stride // 4 - words.shape[0]
    if pad:
        words = torch.cat([words, torch.zeros(pad, dtype=torch.int32,
                                              device=dev)])
    thin_bits = _clamp_thin_bits(thin_bits, stride)
    cap0 = max(256, (T * stride) >> max(avg_bits - 2, 0))
    if thin_bits is not None:
        cap0 = min(cap0, (T * stride) >> thin_bits)

    if thin_bits is not None and thin_bits >= 8:
        def extract(rt, cap):
            return _start_d2h(_extract_first_occ(
                words, pre, T, stride, avg_bits, cap, thin_bits, rt))

        with span("cdc.dispatch"):
            pending = extract(route, cap0)

        def checked(wait, rt, cap):
            ext = wait()
            if len(ext) == 3 and int(ext[2]) != 0:
                candidates_begin.refusals += 1
                if _OBS.on:
                    _M_FUSED_REFUSED.inc()
                rt = "bitmask"
                ext = extract(rt, cap)()
            return ext, rt

        def collect() -> np.ndarray:
            with span("cdc.collect"):
                ext, rt = checked(pending, route, cap0)
                occ, offs = ext[0], ext[1]
                winidx = np.nonzero(unpack_mask(occ.view(np.uint32),
                                                T * stride >> thin_bits))[0]
                cap = cap0
                while len(winidx) > cap:
                    cap *= 4
                    ext, rt = checked(extract(rt, cap), rt, cap)
                    offs = ext[1]
                off = offs.view(np.uint16)[:len(winidx)].astype(np.int64)
                out = (winidx.astype(np.int64) << thin_bits) + off
                return out[out < nbytes]

        return collect

    def extract_all(cap):
        return _start_d2h(_extract_candidates(words, pre, T, stride,
                                              avg_bits, cap, thin_bits))

    with span("cdc.dispatch"):
        pending = extract_all(cap0)

    def collect() -> np.ndarray:
        with span("cdc.collect"):
            positions, ncand = pending()
            cap = cap0
            while int(ncand) > cap:
                cap *= 4
                positions, ncand = extract_all(cap)()
            out = positions[:int(ncand)].astype(np.int64)
            return out[out < nbytes]

    return collect


candidates_begin.refusals = 0


def candidates_words(words, nbytes: int, avg_bits: int = 13,
                     tile_bytes: int = TILE_BYTES, prefix=None,
                     thin_bits: int | None = None,
                     route: str = "bitmask") -> np.ndarray:
    """Synchronous :func:`candidates_begin`."""
    return candidates_begin(words, nbytes, avg_bits, tile_bytes, prefix,
                            thin_bits, route)()


# ---------------------------------------------------------------------------
# host edge
# ---------------------------------------------------------------------------


def _greedy_select(candidates, length: int, min_size: int,
                   max_size: int, native: bool = True) -> list[int]:
    """Sequential min/max pass over sorted candidate offsets.

    Returns chunk end-offsets (exclusive), ending with ``length``: a cut
    at the first candidate at least ``min_size`` past the previous cut,
    or a forced cut ``max_size`` past it when none lands by then.  The
    pass is sequential (each cut moves the horizon), so the native route
    runs it as one C loop (``dat_greedy_select``, ``runtime/native.py``);
    ``native=False`` runs :func:`_greedy_select_py`, its plain version.
    """
    if not native:
        return _greedy_select_py(candidates, length, min_size, max_size)
    from ..runtime import native as _native

    with span("cdc.greedy"):
        cuts = _native.greedy_select(candidates, length, min_size, max_size)
    return cuts.tolist()


def _greedy_select_py(candidates, length: int, min_size: int,
                      max_size: int) -> list[int]:
    """The Python loop of :func:`_greedy_select`."""
    with span("cdc.greedy"):
        cands = np.asarray(candidates, dtype=np.int64).tolist()
        out: list[int] = []
        start = 0
        i = 0
        n = len(cands)
        while length - start > max_size:
            lo = start + min_size
            hi = start + max_size
            while i < n and cands[i] < lo:
                i += 1
            if i < n and cands[i] <= hi:
                cut = cands[i]
                i += 1
            else:
                cut = hi
            out.append(cut)
            start = cut
        out.append(length)
    return out


def host_candidates(data: bytes, avg_bits: int = 13) -> list[int]:
    """Pure-Python reference scan of the seeded stream (tests)."""
    mask = (1 << avg_bits) - 1
    h = 0
    g0 = _gear_g(0)
    for _ in range(WINDOW):
        h = ((h << 1) + g0) & 0xFFFFFFFFFFFFFFFF
    out = []
    for j, b in enumerate(data):
        h = ((h << 1) + _gear_g(b)) & 0xFFFFFFFFFFFFFFFF
        if (h >> 32) & mask == 0:
            out.append(j)
    return out


def host_thin(candidates, thin_bits: int) -> list[int]:
    """First candidate of every aligned window (host reference)."""
    out: list[int] = []
    last_win = -1
    for p in candidates:
        win = p >> thin_bits
        if win != last_win:
            out.append(int(p))
            last_win = win
    return out


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def stage_words(buf: np.ndarray, nwords: int, dev: torch.device):
    """``buf`` as a zero-padded flat int32 word tensor of ``nwords`` on
    ``dev``: staged in pinned memory and copied without blocking on
    CUDA."""
    on_cuda = dev.type == "cuda"
    staged = torch.empty(nwords, dtype=torch.int32, pin_memory=on_cuda)
    raw = staged.numpy().view(np.uint8)
    raw[:len(buf)] = buf
    raw[len(buf):] = 0
    return staged.to(dev, non_blocking=True) if on_cuda else staged


def chunk_stream(data, avg_bits: int = 13, min_size: int | None = None,
                 max_size: int | None = None, tile_bytes: int = TILE_BYTES,
                 slab_tiles: int = 8192, route: str = "bitmask",
                 device="cuda") -> list[int]:
    """Content-defined chunk end-offsets for a byte stream.

    ``data``: bytes or a uint8 array, held on the host.  It is scanned
    in slabs of ``slab_tiles`` tiles of ``tile_bytes`` (1 GiB by
    default) on ``device``; each slab is staged in pinned memory and
    copied without blocking, and slab N's readback overlaps slab N+1's
    scan (depth 2).  ``route`` picks the extraction kernel.
    """
    check_route(route)
    dev = resolve_device(device)
    min_size, max_size = default_sizes(avg_bits, min_size, max_size)
    buf = _as_u8(data)
    length = len(buf)
    if length == 0:
        return []
    thin_bits = max(min_size, 1).bit_length() - 1  # floor log2: W <= min
    if _OBS.on:
        _note_engine("cdc.chunk", f"{route}-{dev.type}", bytes=length)
    candidates = _device_candidates(buf, avg_bits, tile_bytes, slab_tiles,
                                    thin_bits, route, dev)
    return _greedy_select(candidates, length, min_size, max_size)


def _device_candidates(buf: np.ndarray, avg_bits: int, tile_bytes: int,
                       slab_tiles: int, thin_bits: int | None, route: str,
                       dev: torch.device) -> np.ndarray:
    """All candidate positions (sorted, absolute), slab by slab."""
    length = len(buf)
    slab_bytes = tile_bytes * slab_tiles
    out: list[np.ndarray] = []
    pending: list[tuple] = []

    def drain() -> None:
        collect, base = pending.pop(0)
        out.append(collect() + base)

    for begin in range(0, length, slab_bytes):
        end = min(begin + slab_bytes, length)
        nb = end - begin
        T = -(-nb // tile_bytes)
        with span("cdc.stage"):
            words = stage_words(buf[begin:end], T * tile_bytes // 4, dev)
        prefix = None
        if begin:
            prefix = np.ascontiguousarray(buf[begin - WINDOW:begin]).view(
                "<u4")
        pending.append((candidates_begin(words, nb, avg_bits, tile_bytes,
                                         prefix, thin_bits, route), begin))
        if len(pending) >= 2:
            drain()
    while pending:
        drain()
    if not out:
        return np.empty((0,), dtype=np.int64)
    return np.concatenate(out)
